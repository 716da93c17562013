"""Deterministic segment sums: the port's form of JAX's ``.at[idx].add``.

CUDA ``index_add`` (and ``index_put_`` with ``accumulate=True``) adds with
float atomics, in an order that changes from one run to the next, so a
solver built on it does not reproduce itself on the card. Here the
positions of each index value are grouped once, in input order, into a
padded (n, L) gather table; a sum over its slot axis has a fixed order on
every device and in every run. The solvers' index arrays do not change
across their Levenberg-Marquardt iterations, so each table is built once
per solve (on the host) and reused.
"""

from __future__ import annotations

import torch


def segment_table(index, n: int, device=None) -> torch.Tensor:
    """(n, L) int64 positions of ``index`` grouped by value, each segment in
    input order, padded with ``len(index)`` (the zero row ``segment_sum``
    appends); entries outside [0, n) are dropped. L >= 1. Built on the
    host; returned on ``device`` (default: the index's device)."""
    if device is None:
        device = index.device if isinstance(index, torch.Tensor) else "cpu"
    idx = torch.as_tensor(index).reshape(-1).to("cpu", torch.int64)
    pos = torch.nonzero((idx >= 0) & (idx < n))[:, 0]
    sidx, order = torch.sort(idx[pos], stable=True)
    counts = torch.bincount(sidx, minlength=n)
    width = max(int(counts.max()) if n else 0, 1)
    slot = torch.arange(sidx.numel()) - (torch.cumsum(counts, 0)
                                         - counts)[sidx]
    table = torch.full((n, width), idx.numel(), dtype=torch.int64)
    table[sidx, slot] = pos[order]
    return table.to(device)


def segment_sum(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[s] = the sum of values[table[s, l]] over l, in slot order:
    (n, *values.shape[1:]). ``table`` comes from ``segment_table`` on an
    index of len(values) entries."""
    pad = values.new_zeros((1,) + values.shape[1:])
    return torch.cat([values, pad])[table].sum(1)
