"""Stage 3 (compdist) on the port: ``Workspace._dist_rows`` over blocks of
``pair_block`` pairs into a real ``Distance`` artifact, the bank from
``Workspace.genpr``, the route the configuration's descriptor precision
picks (``Workspace._stage3_bank``).

The artifact has the m50 dataset's rows; the pairs drawn from the seed
are ``unique_pairs`` of them and the rest of the index table cycles over
those, so a faster route never runs out of rows within a window. The
bank has no seed: ``genpr`` builds it into a workspace in the checkout's
cache directory once, and later runs find it there, as stage 3 of a
user's second dataset does. Set-up writes ``warm_blocks`` blocks through
the same call. The window is one
call from the next block on: its first ``bar.update`` (after a block,
and after the call's load of the bank) opens the window, and the first
update ``--seconds`` later closes it and stops the call. The check reads
a sample of the rows the call wrote back from the artifact and holds
them against the plain reference (reference/stage3.py).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..harness import spec
from ..harness.trace import Window
from ..inputs import patch_pairs
from ..inputs.patch_pairs import seed_of
from ..reference import stage3 as reference

#: the key of the configuration's ``peak_of`` that holds this entry's peak
PEAK_OF = "stage3"


class TimedStore:
    """The stage's artifact with a span around each ``write_rows``."""

    def __init__(self, store, rec):
        self.store = store
        self.rec = rec

    def write_rows(self, name, start, rows):
        with self.rec.span("write_rows"):
            self.store.write_rows(name, start, rows)


class WindowClosed(Exception):
    """Raised from the bar to end the window's call at a block boundary."""


class BlockBar:
    """Receives ``update`` after every block the window's call writes."""

    def __init__(self, rec, seconds: float):
        self.win = Window(rec)
        self.seconds = seconds
        self.blocks = 0
        self.updates = 0
        self.times = []

    def update(self, frac: float) -> None:
        self.updates += 1
        self.times.append(time.perf_counter())
        if self.win.t0 is None:
            self.win.__enter__()
            return
        self.blocks += 1
        if time.perf_counter() - self.win.t0 >= self.seconds:
            self.win.__exit__(None, None, None)
            raise WindowClosed


def run(ctx) -> dict:
    from opencv_dlco_tpu_torch.data.store import ArtifactStore
    from opencv_dlco_tpu_torch.pipeline.stages import Workspace
    from opencv_dlco_tpu_torch.utils.configs import (DescriptorConfig,
                                                     PoolRegionConfig)

    cfg, tr, dev, rec = ctx.config, ctx.traffic, ctx.device, ctx.rec
    n_pairs, uniq, blk = tr["n_pairs"], tr["unique_pairs"], cfg["pair_block"]
    patches, idx = patch_pairs.make(uniq, ctx.seed, tr["draw_chunk"], dev)
    indices = idx[np.arange(n_pairs) % uniq]
    pool = cfg["pool_regions"]
    bank_dir = os.path.join(ctx.cache_dir, "bank_p{patch_size}_{nr}x{nphi}x"
                            "{nsigma}x{n_symmetries}".format(**pool))
    ws = Workspace(root=bank_dir, pair_block=blk, progress=False,
                   device=str(dev),
                   desc_cfg=DescriptorConfig(**cfg["descriptor"]),
                   pool_cfg=PoolRegionConfig(**pool),
                   dist_compression=cfg["dist_compression"])
    ws.genpr()
    store = ArtifactStore(os.path.join(ctx.workdir, "bench-dist.h5"), "w")
    try:
        store.create("Distance", (n_pairs, cfg["n_rings"]), np.float32,
                     compression=ws.dist_compression)
        st = TimedStore(store, rec)
        lo = tr["warm_blocks"] * blk
        ws._dist_rows(st, indices, patches, 0, lo)
        ctx.setup_done()

        bar = BlockBar(rec, ctx.seconds)
        try:
            ws._dist_rows(st, indices, patches, lo, n_pairs, bar)
        except WindowClosed:
            pass
        if bar.win.t1 is None:
            raise RuntimeError(
                f"the window's call ran out of rows after {bar.updates} "
                f"blocks before {ctx.seconds} s: raise n_pairs")
        win = bar.win
        ctx.window_done(win)
        hi = lo + bar.updates * blk
        rng = np.random.default_rng(seed_of(ctx.seed, 4))
        sample = np.sort(rng.choice(np.arange(lo, hi), tr["sample_pairs"],
                                    replace=False))
        got = np.stack([store.read("Distance", int(i), int(i) + 1)[0]
                        for i in sample])
    finally:
        store.close()
    del ws
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    pairs = bar.blocks * blk
    ring = spec.load_module("counts", "ring_distance")
    shape = dict(n_filters=cfg["n_filters"], n_pixels=cfg["n_pixels"])
    work = {"flops": ring.flops(pairs, n_bins=cfg["descriptor"][
        "n_angle_bins"], **shape),
        "bytes": ring.bytes_moved(pairs, n_rings=cfg["n_rings"], **shape)}
    info = {"blocks": bar.blocks, "pairs": pairs, "rows_written": hi - lo,
            "write_rows_calls": len(rec.spans["write_rows"]),
            "block_s": np.diff(bar.times).tolist(),
            "write_rows_s": [e - s for s, e in rec.spans["write_rows"]]}
    return {"e2e": {"stage3_pairs_per_s": pairs / win.seconds},
            "attempted": pairs, "failed": 0, "work": work, "info": info,
            "window": win, "judge": lambda control=False: judge(
                ctx, patches, indices, sample, got, control)}


def numbers(got: np.ndarray, ref: np.ndarray) -> dict:
    """The worst sampled row's relative error, L2 over its rings."""
    got = got.astype(np.float64)
    ref = ref.astype(np.float64)
    err = np.linalg.norm(got - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-30)
    if not np.all(np.isfinite(got)):
        return {"row_err": float("inf")}
    return {"row_err": float(err.max())}


def judge(ctx, patches, indices, sample, got, control=False) -> dict:
    """{"program": numbers} of the sampled rows against the reference;
    with ``control`` also the reference in TF32 in the program's place."""
    def rows(tf32):
        return reference.rows(ctx.config, patches, indices, sample,
                              ctx.device, tf32=tf32).cpu().numpy()

    ref = rows(False)
    out = {"program": numbers(got, ref)}
    if control:
        out["control"] = numbers(rows(True), ref)
    return out
