"""Process groups, the (dp, mp) mesh, sharded solvers and the sweep engines.

The sharded solvers and the sweep engines load on first use, so a module
that needs only the mesh and its collectives (geometry's sharded pose
graphs and MVBA) does not pull in the models and stores behind them.
"""
import importlib

from .distributed import distributed_init, host_info, is_primary
from .mesh import make_mesh, data_axis, model_axis

_LAZY = {
    "distance_sharding": "sharding",
    "replicated": "sharding",
    "shard_distance_matrix": "sharding",
    "pr_train_chunk_sharded": "sharding",
    "pj_train_chunk_sharded": "sharding",
    "ring_distances_sharded": "sharding",
    "run_pr_sweep": "sweep",
    "run_pj_sweep": "sweep",
}

__all__ = [
    "distributed_init", "host_info", "is_primary",
    "make_mesh",
    "data_axis",
    "model_axis",
    *_LAZY,
]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
