"""Forward-mode Jacobians of functions batched over leading axes.

The JAX package takes its BA, MVBA and pose-graph Jacobian blocks as
``vmap(jacfwd(residual))``. Here the residuals are written batched, and one
``torch.func.jvp`` pass pushes all n tangent directions at once, stacked on
a new leading axis of the input: the same forward-mode derivatives, without
``vmap`` (whose forward-AD rule for a batched ``torch.linalg.solve`` — on
the path through ``se3_log`` — returned wrong blocks for every batch
element after the first in the torch build the tests were written on).
"""

from __future__ import annotations

import torch
from torch.func import jvp


def jac_fwd(f, x: torch.Tensor, *args):
    """f(x (..., n), *args) -> (..., m), batched over the leading axes and
    broadcasting ``args`` against them. Returns (f(x), J (..., m, n))."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    xs = x.expand((n,) + x.shape).contiguous()
    ts = eye.reshape((n,) + (1,) * (x.ndim - 1) + (n,)).expand(
        xs.shape).contiguous()
    out, tan = jvp(lambda v: f(v, *args), (xs,), (ts,))
    return out[0], tan.movedim(0, -1)
