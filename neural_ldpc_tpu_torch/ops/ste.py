"""Straight-through surrogate functions (reference Functions.py:5-26)."""

from __future__ import annotations

import torch


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def proxy_sign(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -1.0, 1.0)


def inv_exp(x: torch.Tensor) -> torch.Tensor:
    """2*sigmoid(x) - 1 == tanh(x/2), the smooth sign surrogate."""
    return 2.0 / (1.0 + torch.exp(-x)) - 1.0


def round_through(x: torch.Tensor) -> torch.Tensor:
    """Forward round, backward hard-sigmoid gradient (reference Functions.py:18-20)."""
    approx = hard_sigmoid(x)
    return approx + (torch.round(x) - approx).detach()


def sign_through(x: torch.Tensor) -> torch.Tensor:
    """Forward sign, backward 2*sigmoid(x)-1 gradient (reference Functions.py:23-26).
    Used by the FER loss."""
    approx = inv_exp(x)
    return approx + (torch.sign(x) - approx).detach()
