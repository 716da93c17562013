"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Names are compared by their
top-level part whole: opencv_dlco_tpu_torch begins with the JAX
package's name and is not it."""

import ast
import os
import subprocess
import sys

from benchmark.harness import env, spec

REF_DIR = os.path.join(spec.BENCH_DIR, "reference")


def _files(root):
    for d, _, names in os.walk(root):
        yield from (os.path.join(d, n) for n in names if n.endswith(".py"))


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_compares_top_level_names_whole():
    mods = {"opencv_dlco_tpu_torch": 1, "opencv_dlco_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert env.forbidden_loaded(mods) == []
    mods.update({"jax.numpy": 1, "opencv_dlco_tpu.ops": 1, "flax": 1})
    assert env.forbidden_loaded(mods) == ["flax", "jax.numpy",
                                          "opencv_dlco_tpu.ops"]


def test_no_source_imports_jax():
    for path in _files(spec.BENCH_DIR):
        for name in _imports(path):
            assert name.split(".")[0] not in env.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _files(REF_DIR):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "math", "typing",
                                          "numpy", "torch"), (path, name)


def test_a_run_loads_no_forbidden_module():
    """Every module a whole toy run of each cell loads, walked after the
    run in a fresh interpreter."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests.conftest import toy\n"
        "from benchmark.harness import env, spec\n"
        "from benchmark.harness.cell import run_cell\n"
        "for w in spec.benchmark_json()['workloads']:\n"
        "    run_cell(w['name'], 3, 0.0, True, 'cpu', cell=toy(w['name']))\n"
        "print(sorted(m for m in sys.modules "
        "if m.startswith('opencv_dlco_tpu_torch'))[:1])\n"
        "print('BAD', env.forbidden_loaded())\n" % spec.ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "['opencv_dlco_tpu_torch" in proc.stdout   # the program ran
    assert "BAD []" in proc.stdout, proc.stdout
