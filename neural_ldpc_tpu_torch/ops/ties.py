"""Differentiable building blocks with the JAX package's gradient conventions
at ties.

PyTorch and JAX agree on values but not on the gradient where an operation
has a kink and its input sits exactly on it:

====================================  =====================  ==================
op at a tie                           torch                  JAX (this module)
====================================  =====================  ==================
``torch.clamp`` / ``jnp.clip``        1 at either bound      0.5 at either bound
``torch.abs`` / ``jnp.abs`` at 0      0                      +1
``clamp_min(x, 0)`` / ``maximum``     1 at 0                 0.5 at 0
``min(dim)`` with tied values         all to the first one   split evenly
====================================  =====================  ==================

QMS messages live on a 0.5 grid and saturate at exactly +-7.5, and its APP
is often exactly 0, so QMS training lands on these ties all the time.  The
plain decoder and the loss build their differentiated operations from this
module, so their gradients are the JAX package's (the CUDA backward kernel
states the same conventions in its own masks).
"""

from __future__ import annotations

import torch


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full((), v, dtype=x.dtype, device=x.device)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``; gradient 1 inside, 0.5
    at either bound (``torch.maximum``/``minimum`` split ties evenly), 0
    outside."""
    return torch.minimum(torch.maximum(x, _const(x, lo)), _const(x, hi))


def relu0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: gradient 0.5 at 0."""
    return torch.maximum(x, _const(x, 0.0))


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``: the value of ``torch.abs``, gradient +1 at 0 (JAX's
    ``select(x >= 0, g, -g)``)."""
    return _Abs.apply(x)


def two_min(gmat: torch.Tensor, big: float):
    """min, second min and first-occurrence argmin over the last axis, as
    the JAX flat path's ``_two_min``: ``amin`` splits a tied minimum's
    gradient evenly; the argmin carries no gradient; the second minimum is
    taken with the argmin slot masked to ``big``."""
    m1 = gmat.amin(dim=-1)
    am = gmat.argmin(dim=-1)  # first minimal index
    slot = torch.arange(gmat.shape[-1], device=gmat.device)
    m2 = torch.where(slot == am[..., None], big, gmat).amin(dim=-1)
    return m1, m2, am
