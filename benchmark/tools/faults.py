"""Faults planted in the program, for the check's own tests and readings.

Each is a context manager that breaks the timed path underneath the
harness, by replacing a function of the program while it is active:

- ``pj_unchanged``: a PJ step returns its state unchanged (but its
  counter);
- ``pj_half_batch``: a PJ step leaves out half of its sampled rows and
  averages over the rest;
- ``stage3_altered``: stage 3 alters one row (one answer) of every block
  where it is produced;
- ``stage3_half_batch``: stage 3 leaves out the second half of every
  block (its rows stay zero).

``PRECISION`` holds the step a later change would be tempted to take on
the PJ grid's hot path, read on the card beside the control (the whole
reference in TF32): the Newton-Schulz products alone in TF32
(``pj_ns_tf32``) or in bfloat16 (``pj_ns_bf16``), the rest of the step in
float32. TF32 has no meaning on the CPU, so the fault tests leave them
out.

The look for a card is the runner's (run.py), so a test drives
``harness.cell.run_cell`` under a fault on any device.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, new):
    old = getattr(module, name)
    setattr(module, name, new)
    try:
        yield
    finally:
        setattr(module, name, old)


def pj_unchanged():
    from opencv_dlco_tpu_torch.models import pj_rda

    def step(pos, neg, mu, gamma, batch, state, ip, ineg, *args):
        return state._replace(t=state.t + 1)

    return _patched(pj_rda, "_pj_step", step)


def pj_half_batch():
    from opencv_dlco_tpu_torch.models import pj_rda

    orig = pj_rda._pj_step

    def step(pos, neg, mu, gamma, batch, state, ip, ineg, *args):
        h = batch // 2
        return orig(pos, neg, mu, gamma, h, state, ip[:, :h], ineg[:, :h],
                    *args)

    return _patched(pj_rda, "_pj_step", step)


def stage3_altered():
    from opencv_dlco_tpu_torch.pipeline import stages

    orig = stages.ring_distances

    def ring_distances(filters, pt1, pt2, *args, **kw):
        d = orig(filters, pt1, pt2, *args, **kw)
        d[-1] = d[-1] * 1.01
        return d

    return _patched(stages, "ring_distances", ring_distances)


def stage3_half_batch():
    from opencv_dlco_tpu_torch.pipeline import stages

    orig = stages.ring_distances

    def ring_distances(filters, pt1, pt2, *args, **kw):
        h = pt1.shape[0] // 2
        d = orig(filters, pt1[:h], pt2[:h], *args, **kw)
        out = d.new_zeros((pt1.shape[0],) + d.shape[1:])
        out[:h] = d
        return out

    return _patched(stages, "ring_distances", ring_distances)


def pj_ns_tf32():
    import torch
    from opencv_dlco_tpu_torch.models import pj_rda

    orig = pj_rda._psd_newton_schulz

    def ns(a, n_iters):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return orig(a, n_iters)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    return _patched(pj_rda, "_psd_newton_schulz", ns)


def pj_ns_bf16():
    import torch
    from opencv_dlco_tpu_torch.models import pj_rda

    def ns(a, n_iters):
        c = torch.linalg.matrix_norm(a, ord="fro") + 1e-30
        y = a / c[..., None, None]
        for _ in range(n_iters):
            yb = y.to(torch.bfloat16)
            y = 1.5 * y - 0.5 * torch.matmul(torch.matmul(yb, yb), yb).float()
        a_psd = 0.5 * (a + torch.matmul(y.to(torch.bfloat16),
                                        a.to(torch.bfloat16)).float())
        return 0.5 * (a_psd + a_psd.mT)

    return _patched(pj_rda, "_psd_newton_schulz", ns)


FAULTS = {"pj_sweep": {"unchanged": pj_unchanged,
                       "half_batch": pj_half_batch},
          "stage3": {"altered": stage3_altered,
                     "half_batch": stage3_half_batch}}

PRECISION = {"pj_sweep": {"ns_tf32": pj_ns_tf32, "ns_bf16": pj_ns_bf16}}
