"""One step of the PJ grid (psd_ns), counted from shapes.

Per sweep entry: the Newton-Schulz projection's 2 ns_iters + 1 products
of F x F matrices (2 F^3 each), and the batch terms: x^T A x for the B
positive and B negative rows (2 B F^2 each side) and the two weighted
Gram products of the subgradient (2 B F^2 each). Elementwise work, the
row gathers and the chunk boundary's eigendecomposition are not counted,
so the count is a floor of the work.
"""


def ns_flops(n_sweep: int, n_feat: int, ns_iters: int) -> float:
    return n_sweep * (2 * ns_iters + 1) * 2.0 * n_feat ** 3


def batch_flops(n_sweep: int, n_feat: int, batch: int) -> float:
    return n_sweep * 4 * 2.0 * batch * n_feat ** 2


def flops(n_sweep: int, n_feat: int, ns_iters: int, batch: int) -> float:
    return (ns_flops(n_sweep, n_feat, ns_iters)
            + batch_flops(n_sweep, n_feat, batch))
