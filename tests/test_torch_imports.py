"""The port stands alone: no module of opencv_dlco_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "opencv_dlco_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "opencv_dlco_tpu")
#: modules of stages 7-11 and the evaluation; the walk below must find them
SLICE_2 = ("ops/hinge.py", "ops/knn.py", "ops/knn_fused.py",
           "models/pj_rda.py", "models/select.py", "models/vgg.py",
           "parallel/sweep.py", "pipeline/stages.py", "pipeline/export.py",
           "pipeline/e2e.py", "pipeline/eval.py", "data/hpatches.py",
           "utils/checkpoint.py", "utils/configs.py", "cli.py")
#: modules of the SLAM slice
SLICE_3 = ("geometry/se3.py", "geometry/triangulate.py",
           "geometry/epipolar.py", "geometry/ba.py", "geometry/mvba.py",
           "geometry/posegraph.py", "geometry/jacobian.py", "ops/detect.py",
           "pipeline/slam.py", "data/kitti.py", "data/synthetic.py")
#: modules of the bench slice
SLICE_8 = ("bench.py", "utils/profiling.py", "ops/hinge.py",
           "models/select.py", "cli.py")
#: modules of the slice with the pair generator, SIFT, SfM, the native
#: binding, the log parser and the SLAM study tool
SLICE_9 = ("data/synthetic.py", "data/__init__.py", "pipeline/e2e.py",
           "ops/sift.py", "native.py", "data/brown.py", "data/kitti.py",
           "pipeline/sfm.py", "cli.py", "data/reference_logs.py",
           "tools/__init__.py", "tools/slam_study.py")

#: modules of the multi-device slice
SLICE_10 = ("parallel/__init__.py", "parallel/distributed.py",
            "parallel/mesh.py", "parallel/sharding.py", "parallel/sweep.py",
            "parallel/dryrun.py", "data/shard_store.py",
            "utils/checkpoint.py", "geometry/__init__.py",
            "geometry/posegraph.py", "geometry/mvba.py",
            "pipeline/stages.py", "pipeline/slam.py", "cli.py")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_walk_covers_every_slice_module():
    found = {os.path.relpath(p, PKG) for p in _port_files()}
    missing = [m for m in SLICE_2 + SLICE_3 + SLICE_8 + SLICE_9 + SLICE_10
               if m not in found]
    assert not missing, missing


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_package_imports_with_jax_blocked():
    """Every module imports in a process where jax and the JAX package
    cannot be imported at all."""
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'opencv_dlco_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
