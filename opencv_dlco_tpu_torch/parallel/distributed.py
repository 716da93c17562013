"""Multi-process runtime: one ``torch.distributed`` process group.

Port of ``opencv_dlco_tpu/parallel/distributed.py``. The reference is
single-process (its sweep scales by running more processes by hand); here
one process per device joins a process group, and a (dp, mp) mesh of
ranks (parallel/mesh.make_mesh) carries the sharded programs' collectives.

Launch contract (2-process example; the same variables on every process):

    DLCO_COORDINATOR=host0:8476 DLCO_NUM_PROCESSES=2 DLCO_PROCESS_ID=0 \\
        python -m opencv_dlco_tpu_torch.cli ...
    DLCO_COORDINATOR=host0:8476 DLCO_NUM_PROCESSES=2 DLCO_PROCESS_ID=1 \\
        python -m opencv_dlco_tpu_torch.cli ...

``MASTER_ADDR``/``MASTER_PORT`` stand in for ``DLCO_COORDINATOR`` when it
is unset. With ``--distributed`` (``detect=True``) a launcher's own
variables are read too: torchrun's ``WORLD_SIZE``/``RANK``/``LOCAL_RANK``
stand in for ``DLCO_NUM_PROCESSES``/``DLCO_PROCESS_ID`` and pick each
rank's card, so ``torchrun --nproc-per-node N -m opencv_dlco_tpu_torch.cli
--distributed ...`` needs no DLCO_* variable (the counterpart of the JAX
package's pod auto-detection). ``DLCO_SHUTDOWN_TIMEOUT`` (seconds, default
300) is the group's timeout for every collective and the rendezvous. The
backend follows the device: ``nccl`` for ``cuda``, ``gloo`` for ``cpu``; a
caller may name one (``gloo`` carries CUDA tensors through host memory,
the way to run several ranks on one card, where NCCL refuses two ranks on
one GPU). A backend that fails to start raises: nothing moves to another
backend or device. A single process (no variables, or one process) is a
no-op, so every entry point may call ``distributed_init`` unconditionally;
only a caller that names the backend and the coordinator starts a world
of one.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def _coordinator() -> Optional[str]:
    if os.environ.get("DLCO_COORDINATOR"):
        return os.environ["DLCO_COORDINATOR"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if is_initialized() else 0


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: str = "cuda", detect: bool = False) -> bool:
    """Join the process group from the arguments or the DLCO_* variables
    (with ``detect``, torchrun's WORLD_SIZE/RANK/LOCAL_RANK where those are
    unset).

    Returns True when a multi-process group is (or already was) up, False
    otherwise. Idempotent. One process is the no-op, unless the caller
    names both ``backend`` and ``coordinator``: then a world of one starts
    (False is returned all the same). ``backend`` defaults to ``nccl`` on
    ``cuda`` and ``gloo`` on ``cpu``; with ``nccl`` each rank takes the card
    LOCAL_RANK (with ``detect``) or ``process_id % torch.cuda.device_count()``.
    """
    if is_initialized():
        return dist.get_world_size() > 1
    explicit = backend is not None and coordinator is not None
    coordinator = coordinator or _coordinator()
    if num_processes is None:
        num_processes = _env_int("DLCO_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("DLCO_PROCESS_ID")
    local_rank = None
    if detect:
        if num_processes is None:
            num_processes = _env_int("WORLD_SIZE")
        if process_id is None:
            process_id = _env_int("RANK")
        local_rank = _env_int("LOCAL_RANK")
    if num_processes is None or num_processes < 1 or (
            num_processes == 1 and not explicit):
        return False
    if coordinator is None or process_id is None:
        raise ValueError(
            f"distributed_init: {num_processes} processes need a coordinator "
            f"address (DLCO_COORDINATOR or MASTER_ADDR/MASTER_PORT) and this "
            f"process's id (DLCO_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_init: backend nccl needs CUDA")
        card = local_rank if local_rank is not None else process_id
        kw["device_id"] = torch.device(
            "cuda", card % torch.cuda.device_count())
        torch.cuda.set_device(kw["device_id"])
    timeout = datetime.timedelta(
        seconds=int(os.environ.get("DLCO_SHUTDOWN_TIMEOUT", "300")))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout, **kw)
    return dist.get_world_size() > 1


def host_info(device: str = "cuda") -> dict:
    """Topology snapshot for logs: the JAX package's keys. One rank drives
    one device, so the global device count is the rank count; ``backend``
    is the process group's backend, or the device type without a group."""
    dev = torch.device(device)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_device_count": local,
        "global_device_count": process_count(),
        "backend": dist.get_backend() if is_initialized() else dev.type,
    }


def is_primary() -> bool:
    """True on the process that writes artifacts and logs (rank 0)."""
    return process_index() == 0
