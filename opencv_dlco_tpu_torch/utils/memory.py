"""Device-memory budgeting for the learners.

The learners keep the training splits resident on the device and the full
distance matrix off it (models/select.compute_pr_stats_splits evaluates
full-dataset statistics from the splits). Every learner checks its planned
residency against the device's capacity before uploading, so an impossible
configuration fails at once with a sizing breakdown instead of running out
of memory mid-run. On a CUDA device the capacity is what
``torch.cuda.mem_get_info`` reports; on the CPU it is the host's RAM.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

# fraction of device memory the data arrays may claim; the rest is
# headroom for solver state, validation sort scratch and temporaries
_HEADROOM = 0.80


def device_memory_bytes(device="cuda") -> int:
    """Total memory of ``device``: the card's, or the host's RAM for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def check_device_budget(parts: Dict[str, int], what: str,
                        device="cuda", headroom: float = _HEADROOM) -> int:
    """Raise MemoryError when the named byte sizes exceed ``headroom`` of
    the device's memory; returns the total."""
    total = sum(parts.values())
    limit = device_memory_bytes(device)
    budget = int(limit * headroom)
    if total > budget:
        detail = ", ".join(
            f"{k}={v / 1024**3:.2f}GiB" for k, v in parts.items())
        raise MemoryError(
            f"{what}: planned device residency {total / 1024**3:.2f} GiB "
            f"exceeds {headroom:.0%} of the {limit / 1024**3:.1f} GiB "
            f"device limit ({detail}). Reduce the resident split sizes "
            f"(train_frac / subsampling).")
    return total


def nbytes(*arrays) -> int:
    """Total bytes of numpy arrays (pre-upload planning helper)."""
    return sum(int(a.size) * a.dtype.itemsize for a in arrays)
