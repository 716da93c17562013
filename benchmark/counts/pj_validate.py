"""One validation of the PJ grid, counted from shapes.

Per sweep entry: ||W x||^2 for every validation row, a product of
(n_val x F) by (F x K) with K = F (2 n_val F^2), for the positives and
the negatives. The sort-based hinge is not counted.
"""


def flops(n_sweep: int, n_feat: int, n_pos: int, n_neg: int) -> float:
    return n_sweep * 2.0 * (n_pos + n_neg) * n_feat ** 2
