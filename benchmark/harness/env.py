"""The run's surroundings: cache directories, the card, forbidden modules.

Every build and kernel cache the program or torch may use sits at a fixed
path inside the checkout (``.bench_cache/``, listed in .gitignore), so a
second run of a cell finds what the first one built. Scratch data (the
stage-3 workspace) goes under ``TMPDIR``, which each side of a check has
to itself, and is removed when the run ends.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import List

from .spec import ROOT

CACHE_DIR = os.path.join(ROOT, ".bench_cache")

#: top-level module names that must never be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "opencv_dlco_tpu")


def set_cache_dirs(environ=os.environ) -> bool:
    """Point every compile cache at a fixed directory in the checkout.
    Must run before torch is imported. Returns whether this is the first
    run in the checkout (the caches were not there yet), whose set-up
    is recorded apart."""
    first = not os.path.isdir(CACHE_DIR)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        path = os.path.join(CACHE_DIR, sub)
        os.makedirs(path, exist_ok=True)
        environ[var] = path
    # a library that would load JAX by itself is kept from doing so
    environ["USE_FLAX"] = "0"
    environ["USE_JAX"] = "0"
    return first


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in list(modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name, power limit and SM clock, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"
