"""A (dp, mp) mesh of ranks and its collectives.

Port of ``opencv_dlco_tpu/parallel/mesh.py``. The workload maps onto a 2-D
logical mesh of processes, one device each:

- ``dp`` ("pairs"): shards the pair/sample dimension — distance-matrix rows,
  RDA minibatches, validation sets, pose-graph edges, BA landmarks.
  Collective: ``psum`` (an all-reduce) of subgradients and normal systems.
- ``mp`` ("rings"): shards the candidate-ring/feature dimension — filter-bank
  rows, distance-matrix columns, the w vector. Collective: ``psum`` of
  partial dot products.

Ranks are ordered by (host, local index) before the row-major (dp, mp)
reshape, so an mp group lies inside one host and dp tiles across hosts.

The sharded functions follow torch's SPMD idiom: every rank calls them
with its own shard and the mesh; the mesh's per-axis process groups carry
``psum`` (all_reduce SUM) and ``all_gather`` (all_gather, then cat), the
collectives NCCL and gloo both carry for CUDA tensors. Without a process
group the mesh is (1, 1) and both are the identity.

``torch.distributed.device_mesh.DeviceMesh`` is not used: its constructor
initialises a default group by itself when there is none and sets each
rank's CUDA device, and the (host, local index) layout and a fake layout
for tests need the arrangement to be computed here anyway. The groups are
plain ``dist.new_group`` calls, made by every rank in one order.
"""

from __future__ import annotations

import hashlib
import socket
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import is_initialized

data_axis = "dp"
model_axis = "mp"


class RankSlot(NamedTuple):
    """Where one rank runs: its host's index and its index on that host."""

    rank: int
    host: int
    local_id: int


def rank_layout(device="cuda") -> list:
    """RankSlot of every rank of the process group, from one all_gather of
    each rank's hostname hash (hosts numbered in order of their lowest
    rank, local indices in rank order). [RankSlot(0, 0, 0)] without one."""
    if not is_initialized():
        return [RankSlot(0, 0, 0)]
    digest = hashlib.sha1(socket.gethostname().encode()).digest()
    mine = torch.tensor([int.from_bytes(digest[:7], "little")],
                        dtype=torch.int64, device=device)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    hashes = [int(h.item()) for h in every]
    hosts, seen, slots = {}, {}, []
    for rank, h in enumerate(hashes):
        host = hosts.setdefault(h, len(hosts))
        slots.append(RankSlot(rank, host, seen.get(host, 0)))
        seen[host] = seen.get(host, 0) + 1
    return slots


class Mesh:
    """The (dp, mp) arrangement of ranks, this rank's place in it, the
    device its collectives run on and one process group per mesh row and
    column (None without a process group)."""

    def __init__(self, ranks: np.ndarray, device, rank: int = 0,
                 groups: Optional[dict] = None):
        self.ranks = np.asarray(ranks, np.int64)
        self.device = torch.device(device)
        self.rank = rank
        dp_idx, mp_idx = np.argwhere(self.ranks == rank)[0]
        self.coords = {data_axis: int(dp_idx), model_axis: int(mp_idx)}
        self.groups = groups or {}

    @property
    def shape(self) -> dict:
        dp, mp = self.ranks.shape
        return {data_axis: dp, model_axis: mp}

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def members(self, axis: str) -> list:
        """The global ranks of this rank's group along ``axis``, in axis
        order (this rank's mesh column for dp, its row for mp)."""
        if axis == data_axis:
            return self.ranks[:, self.coords[model_axis]].tolist()
        return self.ranks[self.coords[data_axis], :].tolist()

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` over the ranks of ``axis`` (all_reduce SUM)."""
        group = self.groups.get(axis)
        if group is None:
            return x
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The shards of ``x`` over ``axis`` concatenated along ``dim`` in
        axis order (JAX's all_gather(tiled=True)). Every rank's shard has
        the same shape."""
        group = self.groups.get(axis)
        if group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=group)
        # parts come in group-rank order, which is ascending global rank
        # (new_group sorts its members), not necessarily the axis order
        members = self.members(axis)
        by_rank = dict(zip(sorted(members), parts))
        return torch.cat([by_rank[r] for r in members], dim)


def psum_packed(mesh: Optional[Mesh], axis: str, *parts):
    """``parts`` summed over ``axis`` in ONE all_reduce (packed flat, then
    unpacked); without a mesh, ``parts`` as they are."""
    if mesh is None:
        return parts
    flat = mesh.psum(torch.cat([p.reshape(-1) for p in parts]), axis)
    out, o = [], 0
    for p in parts:
        out.append(flat[o:o + p.numel()].reshape(p.shape))
        o += p.numel()
    return out


def make_mesh(dp: Optional[int] = None, mp: int = 1,
              devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """Build a (dp, mp) mesh over the process group's ranks; dp defaults to
    n_ranks // mp. ``devices``: a layout of RankSlot-like entries (rank,
    host, local_id) in place of the group's own (tests hand a fake one;
    with a process group up, the mesh's groups follow that layout, which
    must then name every rank once). mp must divide every host's rank
    count, or an mp group would straddle hosts: that is rejected."""
    fake = devices is not None
    slots = list(devices) if fake else rank_layout(device)
    slots = sorted(slots, key=lambda s: (s.host, s.local_id))
    n = len(slots)
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} ranks")
    if mp > 1:
        per_host: dict = {}
        for s in slots:
            per_host[s.host] = per_host.get(s.host, 0) + 1
        for host, cnt in per_host.items():
            if cnt % mp:
                raise ValueError(
                    f"mp={mp} does not divide host {host}'s {cnt} local "
                    f"ranks; an mp group would cross hosts")
    ranks = np.asarray([s.rank for s in slots], np.int64).reshape(dp, mp)
    if not is_initialized():
        return Mesh(ranks, device, rank=int(ranks.flat[0]))
    if fake and sorted(ranks.flat) != list(range(dist.get_world_size())):
        raise ValueError(f"layout ranks {sorted(ranks.flat)} are not the "
                         f"group's {dist.get_world_size()} ranks")
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in one order
    for j in range(mp):
        g = dist.new_group(ranks[:, j].tolist())
        if rank in ranks[:, j]:
            groups[data_axis] = g
    for i in range(dp):
        g = dist.new_group(ranks[i, :].tolist())
        if rank in ranks[i, :]:
            groups[model_axis] = g
    return Mesh(ranks, device, rank=rank, groups=groups)
