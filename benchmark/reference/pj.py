"""Plain reference of the PJ grid's first steps and its validation.

The projection learner (src/pj-learn.cpp:305-589) in its ``psd_ns`` form,
written plainly in float32 with TF32 off, one sweep entry at a time:

    dP, dN     rows drawn with replacement (B each side)
    d(x)       = x^T A x
    M_ij       = [d(dP_i) + 1 > d(dN_j)]
    G          = (dP^T diag(rowsum M) dP - dN^T diag(colsum M) dN) / B^2
    Gavg      <- (t Gavg + G) / (t + 1)
    A         <- psd(sym(-sqrt(t + 1) / gamma (Gavg + mu I)))

where psd() is the cubic Newton-Schulz sign iteration inside a chunk and,
at a chunk's end, the exact projection by eigendecomposition that also
gives W = diag(sqrt(l+)) V^T. The validation objective is the all-pairs
hinge of ||W x||^2 over the validation rows (summed in float64) over
|P||N|, plus mu trace(A).

The rows a step samples come from the generator the program was handed:
a CPU ``torch.Generator`` drawing (S, n_steps, B) positive then negative
indices a chunk. The reference is handed a generator seeded alike and
draws the same way. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import set_tf32


def _sign_ns(a: torch.Tensor, iters: int) -> torch.Tensor:
    y = a / (torch.linalg.matrix_norm(a) + 1e-30)
    for _ in range(iters):
        y = 1.5 * y - 0.5 * (y @ y) @ y
    return y


def _psd_ns(a: torch.Tensor, iters: int) -> torch.Tensor:
    p = 0.5 * (a + _sign_ns(a, iters) @ a)
    return 0.5 * (p + p.T)


def _psd_eigh(a: torch.Tensor):
    lam, v = torch.linalg.eigh(a)
    lam = torch.clamp(lam, min=0.0)
    return torch.sqrt(lam)[:, None] * v.T, (v * lam) @ v.T


def _metric(a: torch.Tensor, g: torch.Tensor, t: int, mu: float,
            gamma: float) -> torch.Tensor:
    f = g.shape[0]
    eye = torch.eye(f, dtype=torch.float32, device=g.device)
    a_new = -(torch.sqrt(torch.tensor(float(t + 1))).item() / gamma) * (
        g + mu * eye)
    return 0.5 * (a_new + a_new.T)


def follow(splits: Dict[str, torch.Tensor], combos: Sequence, gen,
           chunks: Sequence[int], batch: int, ns_iters: int,
           tf32: bool = False) -> List[dict]:
    """The state and validation after each chunk of ``chunks`` steps,
    from zero: [{"t", "df_avg", "a", "w", "loss", "regul", "obj"}], each
    tensor stacked over the sweep entries, on the CPU."""
    set_tf32(tf32)
    try:
        return _follow(splits, combos, gen, chunks, batch, ns_iters)
    finally:
        set_tf32(False)


def _follow(splits, combos, gen, chunks, batch, ns_iters):
    pos, neg = splits["pos_trn"], splits["neg_trn"]
    dev = pos.device
    s, f = len(combos), pos.shape[1]
    g_avg = [torch.zeros((f, f), dtype=torch.float32, device=dev)
             for _ in range(s)]
    a = [torch.zeros((f, f), dtype=torch.float32, device=dev)
         for _ in range(s)]
    w = [None] * s
    t = 0
    out = []
    for n_steps in chunks:
        ip = torch.randint(0, pos.shape[0], (s, n_steps, batch), generator=gen)
        ineg = torch.randint(0, neg.shape[0], (s, n_steps, batch),
                             generator=gen)
        for k in range(n_steps):
            for i, (mu, gamma) in enumerate(combos):
                dp = pos[ip[i, k].to(dev)]
                dn = neg[ineg[i, k].to(dev)]
                pd = ((dp @ a[i]) * dp).sum(1)
                nd = ((dn @ a[i]) * dn).sum(1)
                m = (pd[:, None] + 1.0 > nd[None, :]).float()
                grad = ((dp.T * m.sum(1)) @ dp - (dn.T * m.sum(0)) @ dn
                        ) / float(batch * batch)
                g_avg[i] = (t * g_avg[i] + grad) / (t + 1.0)
                a[i] = _psd_ns(_metric(a[i], g_avg[i], t, mu, gamma),
                               ns_iters)
            t += 1
        # the chunk's end: the exact projection of the iterate rebuilt
        # from the running average (its last step used t - 1)
        for i, (mu, gamma) in enumerate(combos):
            w[i], a[i] = _psd_eigh(_metric(a[i], g_avg[i], t - 1, mu, gamma))
        out.append(_snapshot(splits, combos, t, g_avg, a, w))
    return out


def hinge_sum(pd: torch.Tensor, nd: torch.Tensor) -> torch.Tensor:
    """sum_ij max(0, pd_i + 1 - nd_j) in float64, by sorting."""
    pd, nd = pd.double(), torch.sort(nd.double()).values
    prefix = torch.cat([nd.new_zeros(1), torch.cumsum(nd, 0)])
    k = torch.searchsorted(nd, pd + 1.0)
    return ((pd + 1.0) * k - prefix[k]).sum()


def _losses(splits, w) -> torch.Tensor:
    """Each sweep entry's all-pairs hinge of ||W x||^2 over the
    validation rows, over |P||N|."""
    pv, nv = splits["pos_val"], splits["neg_val"]
    loss = []
    for wi in w:
        wi = wi.to(pv.device)
        pd = ((pv @ wi.T) ** 2).sum(1)
        nd = ((nv @ wi.T) ** 2).sum(1)
        loss.append(hinge_sum(pd, nd) / (pv.shape[0] * nv.shape[0]))
    return torch.stack(loss).cpu()


def window_objective(splits: Dict[str, torch.Tensor], combos: Sequence,
                     w: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """The validation objective of the program's projections w (S, K, F),
    as the reference works it out: the hinge, plus mu trace(A) with
    trace(A) = ||W||_F^2 since A = W^T W."""
    set_tf32(tf32)
    try:
        loss = _losses(splits, w)
    finally:
        set_tf32(False)
    mus = torch.tensor([c[0] for c in combos], dtype=torch.float64)
    return loss + mus * (w.double() ** 2).sum(dim=(1, 2))


def _snapshot(splits, combos, t, g_avg, a, w) -> dict:
    loss = _losses(splits, w)
    regul = torch.stack([mu * torch.diagonal(a[i]).double().sum()
                         for i, (mu, _) in enumerate(combos)]).cpu()
    return {"t": t, "df_avg": torch.stack(g_avg).cpu(),
            "a": torch.stack(a).cpu(), "w": torch.stack(w).cpu(),
            "loss": loss, "regul": regul, "obj": loss + regul}
