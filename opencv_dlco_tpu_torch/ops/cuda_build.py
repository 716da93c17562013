"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. Libraries
are built at first use into ``_build/`` beside the package (listed in
``.gitignore``), named by a hash of their sources and flags so an edited
source rebuilds. ``build_all`` starts one ``nvcc`` per source at once.
A failed build raises ``RuntimeError`` with the compiler's output.

Nothing here runs at import: the CPU tests import every module, and this
host may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: library name -> CUDA source; every source may include the headers
#: (``*.cuh``) beside it
SOURCES = {
    "ring_dist": "ring_dist.cu",      # kernel A
    "rda_wide": "rda_wide.cu",        # kernel B
    "rda_narrow": "rda_narrow.cu",    # kernels C and D
    "hinge": "hinge.cu",              # kernel E
    "knn_topk": "knn_topk.cu",        # kernels F and H (wgmma)
    "knn_batched": "knn_batched.cu",  # kernel G
}

NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C entry points of each library: {symbol: (argtypes, restype)}
SIGNATURES = {
    "ring_dist": {"ring_dist_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _P],
                                       _I),
                  "ring_split_bank_launch": ([_P, _P, _L, _P], _I),
                  "ring_dist_f32_launch": ([_P, _P, _P, _P, _P, _I, _I, _I,
                                            _P], _I)},
    "rda_wide": {"rda_wide_train": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _P], _I)},
    "rda_narrow": {"rda_narrow_run": ([_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _I, _I, _I, _I, _I, _I, _P],
                                      _I)},
    "hinge": {"hinge_slices": ([_I, _I], _I),
              "hinge_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
                               _I)},
    "knn_topk": {
        "knn_topk_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "knn_topk_f32_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _P], _I),
        "knn_topk_f32_scratch_bytes": ([_I, _I, _I, _I], _L)},
    "knn_batched": {"knn2_batched_launch": ([_P, _P, _P, _I, _I, _I, _I, _L,
                                             _L, _L, _L, _P], _I)},
}

_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each library this
#: process built or found built (kept beside the library)
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fn in (SOURCES[name], *headers):
        with open(os.path.join(CSRC, fn), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every library not yet built, one nvcc per source, all at once.

    Returns {name: library path}; raises RuntimeError naming each failed
    build with the compiler's output."""
    names = list(names or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    paths = {n: _lib_path(n) for n in names}
    for n in names:
        if os.path.exists(paths[n]):
            log = paths[n] + ".ptxas.txt"
            if n not in BUILD_LOGS and os.path.exists(log):
                with open(log) as fh:
                    BUILD_LOGS[n] = fh.read()
            continue
        tmp = paths[n] + f".{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[n] = out
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        with open(paths[n] + ".ptxas.txt", "w") as fh:
            fh.write(out)
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(path)
        for symbol, (argtypes, restype) in SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
