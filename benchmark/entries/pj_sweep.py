"""The PJ grid (stage 8) on the port, as ``parallel/sweep.run_pj_sweep``
runs it: all sweep entries train together through
``models/pj_rda.pj_train_chunk_batch`` in chunks of ``log_step`` steps,
and after each chunk ``pj_validate`` and the best-iterate update. The
sweep's checkpoint (every 10 log periods) is left out.

Set-up draws the splits from the seed and drives the solver state through
its first steps by the window's own call (chunks of ``first_chunks``
steps, each validated: 1, 2, then a chunk long enough that the
Newton-Schulz projections steer most entries' violations); the window
continues that same state. The check
follows those first steps with the plain reference (reference/pj.py),
and works out again the validation objective of the window's last state.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import spec
from ..harness.trace import Window
from ..inputs import pj_splits
from ..inputs.patch_pairs import seed_of
from ..reference import pj as reference

#: the key of the configuration's ``peak_of`` that holds this entry's peak
PEAK_OF = "pj"


def _combos(cfg):
    return [(m, g) for m in cfg["pj"]["mus"] for g in cfg["pj"]["gammas"]]


def run(ctx) -> dict:
    from opencv_dlco_tpu_torch.models import pj_rda

    cfg, tr, dev, rec = ctx.config, ctx.traffic, ctx.device, ctx.rec
    pj = cfg["pj"]
    f = cfg["pj_n_feat"]
    combos = _combos(cfg)
    s = len(combos)
    splits = pj_splits.make(f, tr["n_trn"], tr["n_val"], tr["pos_std"],
                            tr["neg_std"], ctx.seed, dev)
    mus = torch.tensor([c[0] for c in combos], dtype=torch.float32,
                       device=dev)
    gammas = torch.tensor([c[1] for c in combos], dtype=torch.float32,
                          device=dev)
    gen = torch.Generator().manual_seed(seed_of(ctx.seed, 3))
    kw = dict(batch=pj["batch"], eigh_mode=pj["eigh_mode"],
              ns_iters=pj["ns_iters"])
    pos_trn, neg_trn = splits["pos_trn"], splits["neg_trn"]
    pos_val, neg_val = splits["pos_val"], splits["neg_val"]

    # set-up: the first steps, through the window's own call and feed
    states = pj_rda.pj_init_batch(f, s, None, device=dev)
    first = []
    for n in tr["first_chunks"]:
        states = pj_rda.pj_train_chunk_batch(pos_trn, neg_trn, mus, gammas,
                                             states, gen, n_steps=n, **kw)
        obj = pj_rda.pj_validate(pos_val, neg_val, mus, states)[2]
        first.append({"t": states.t, "df_avg": states.df_avg.cpu(),
                      "a": states.a.cpu(), "obj": obj.cpu()})
    best_obj = obj.clone()
    best_w, best_a = states.w.clone(), states.a.clone()
    ctx.setup_done()

    steps = chunks = 0
    ends = []
    with Window(rec) as win:
        while True:
            with rec.span("pj_chunk", sync=True):
                states = pj_rda.pj_train_chunk_batch(
                    pos_trn, neg_trn, mus, gammas, states, gen,
                    n_steps=pj["log_step"], **kw)
            with rec.span("pj_validate", sync=True):
                obj = pj_rda.pj_validate(pos_val, neg_val, mus,
                                         states)[2]
            improved = obj < best_obj
            best_obj = torch.where(improved, obj, best_obj)
            best_w = torch.where(improved[:, None, None], states.w, best_w)
            best_a = torch.where(improved[:, None, None], states.a, best_a)
            objs = obj.cpu().numpy()        # the sweep's host read a chunk
            if not np.all(np.isfinite(objs)):
                raise FloatingPointError(
                    f"PJ objective not finite at step {states.t}")
            ends.append(time.perf_counter())
            steps += pj["log_step"]
            chunks += 1
            if ends[-1] - win.t0 >= ctx.seconds:
                break
    ctx.window_done(win)
    last = {"w": states.w.cpu(), "obj": obj.cpu()}
    del states, best_w, best_a, best_obj

    step = spec.load_module("counts", "pj_step")
    val = spec.load_module("counts", "pj_validate")
    work = {
        "ns_flops": steps * step.ns_flops(s, f, pj["ns_iters"]),
        "flops": (steps * step.flops(s, f, pj["ns_iters"], pj["batch"])
                  + chunks * val.flops(s, f, tr["n_val"], tr["n_val"])),
    }
    info = {"steps": steps, "chunks": chunks, "sweep": s, "n_feat": f,
            "t_end": int(first[-1]["t"]) + steps,
            "chunk_s": np.diff([win.t0] + ends).tolist()}
    return {"e2e": {"pj_steps_per_s": steps / win.seconds},
            "attempted": steps, "failed": 0, "work": work, "info": info,
            "window": win, "judge": lambda control=False: judge(
                ctx, splits, combos, first, last, control)}


def _rel(prog: torch.Tensor, ref: torch.Tensor, diff: bool):
    """Each sweep entry's gap of norms (or, with ``diff``, norm of the
    difference), over the larger of its reference norm and the median
    entry's."""
    p = prog.double().flatten(1)
    r = ref.double().flatten(1)
    rn = r.norm(dim=1)
    scale = torch.clamp(rn, min=float(rn.median()))
    gap = (p - r).norm(dim=1) if diff else (p.norm(dim=1) - rn).abs()
    return gap / scale


def _gap(prog: torch.Tensor, ref: torch.Tensor, diff: bool) -> float:
    """The worst sweep entry's ``_rel``."""
    return float(_rel(prog, ref, diff).max())


def _obj_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    p, r = prog.double(), ref.double()
    scale = torch.clamp(r.abs(), min=float(r.abs().median()))
    return float(((p - r).abs() / scale).max())


#: a sweep entry whose running average departs from the reference's by
#: more than this (over its scale) has had a violation decided otherwise:
#: after 43 steps rounding alone reads about 7e-7, one decision 8e-5 or more
DEPARTED = 1e-5


def numbers(prog: list, ref: list, win: torch.Tensor,
            win_ref: torch.Tensor) -> dict:
    """What the check compares. By the worst sweep entry: the gap of norms
    of the first step's subgradient (the optimizer's running average
    after one step, ``grad1``), of the metric A after three steps (its
    change from zero, ``change3``), and of the validation objective after
    the first step (``obj_t1``); the upper quartile of the entries'
    differences of the running average after all the first chunks
    (``gavg_q75``), which the Newton-Schulz projections steer through
    each later step's violations; and the gap of the window's last
    validation objective from the reference's, on the window's last
    state (``obj_win``). The first two chunks are of 1 and 2 steps.
    Printed beside them, not compared: the objective after three steps,
    the worst entry's difference of the running average after three
    steps, which a single violation decided otherwise by rounding moves
    (PERF.md), and the number of entries that departed by the end of
    the first chunks."""
    gavg = _rel(prog[-1]["df_avg"], ref[-1]["df_avg"], True)
    return {"grad1": _gap(prog[0]["df_avg"], ref[0]["df_avg"], False),
            "change3": _gap(prog[1]["a"], ref[1]["a"], False),
            "obj_t1": _obj_gap(prog[0]["obj"], ref[0]["obj"]),
            "gavg_q75": float(torch.quantile(gavg, 0.75)),
            "obj_win": _obj_gap(win, win_ref),
            "obj_t3": _obj_gap(prog[1]["obj"], ref[1]["obj"]),
            "gavg3_diff": _gap(prog[1]["df_avg"], ref[1]["df_avg"], True),
            "departed": int((gavg > DEPARTED).sum())}


def judge(ctx, splits, combos, first, last, control=False) -> dict:
    """{"program": numbers, "entries": ...}: the reference follows the
    first steps on the same splits and row draws, and validates the
    window's last state. With ``control``, also {"control": numbers} of
    the reference in TF32 put in the program's place. ``entries`` holds
    each sweep entry's difference of the running average after the first
    chunks, for the readings."""
    pj = ctx.config["pj"]

    def follow(tf32):
        gen = torch.Generator().manual_seed(seed_of(ctx.seed, 3))
        return reference.follow(splits, combos, gen,
                                ctx.traffic["first_chunks"], pj["batch"],
                                pj["ns_iters"], tf32=tf32)

    ref = follow(False)
    win_ref = reference.window_objective(splits, combos, last["w"])
    out = {"program": numbers(first, ref, last["obj"], win_ref),
           "entries": {"program": _rel(first[-1]["df_avg"],
                                       ref[-1]["df_avg"], True).tolist()}}
    if control:
        low = follow(True)
        out["control"] = numbers(
            low, ref, reference.window_objective(splits, combos, last["w"],
                                                 tf32=True), win_ref)
        out["entries"]["control"] = _rel(low[-1]["df_avg"],
                                         ref[-1]["df_avg"], True).tolist()
    return out
