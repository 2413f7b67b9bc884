"""Multi-iteration weighted decoder loss.

Port of ``neural_ldpc_tpu/training/loss.py``: per-iteration losses weighted
by eta**coeff, accumulated from the last iteration down to the first and
normalised by the weight sum.  Three loss types:

* BCE: sigmoid cross-entropy of the APP "logits" against the bit labels,
  composed as ``maximum(l, 0) - l*y + log1p(exp(-|l|))`` from ``ops/ties.py``
  (at l = 0 its gradient is -y, as JAX's; torch's fused
  ``binary_cross_entropy_with_logits`` gives 0.5 - y there).
* SoftBEROnAllZero: mean sigmoid of the APP (expected bit-1 probability).
* FEROnAllZero: 0.5 * (1 - sign_through(min over bits)) per frame, the
  minimum by ``amin`` (a tied minimum splits its gradient evenly).

Under the STANDARD convention the logit for bit = 1 is -output.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from ..ops import ties
from ..ops.ste import sign_through
from ..structs import Convention, LossType


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy, mean over all elements."""
    return torch.mean(ties.relu0(logits) - logits * labels
                      + torch.log1p(torch.exp(-ties.abs_(logits))))


def multi_iteration_loss(
    outputs: torch.Tensor,
    expected: torch.Tensor,
    loss_type: LossType = LossType.BCE,
    etha: float = 1.0,
    coeff: Union[int, Sequence[int], None] = 1,
    convention: Convention = Convention.STANDARD,
) -> torch.Tensor:
    """outputs: [I, B, NZ] (or [B, NZ] for a single iteration); expected:
    [B, NZ] bit labels (or [I, B, NZ] per-iteration labels).  ``coeff``:
    per-iteration exponent(s) of the eta weighting; a scalar broadcasts."""
    if outputs.dim() == 2:
        outputs = outputs[None]
    n_iters = outputs.shape[0]
    if expected.dim() == 2:
        expected = expected[None].expand(outputs.shape)
    expected = expected.to(outputs.dtype)

    if coeff is None:
        coeffs = [1] * n_iters
    elif isinstance(coeff, int):
        coeffs = [coeff] * n_iters
    else:
        coeffs = list(coeff)
        if len(coeffs) != n_iters:
            raise ValueError(f"coeff length {len(coeffs)} != iterations {n_iters}")

    flip = convention == Convention.STANDARD  # logits for bit=1 are -output

    total = 0.0
    weight_sum = 0.0
    for i in range(n_iters - 1, -1, -1):
        w = etha ** coeffs[i]
        out_i = outputs[i]
        logits = -out_i if flip else out_i
        if loss_type == LossType.BCE:
            term = _bce_with_logits(logits, expected[i])
        elif loss_type == LossType.SoftBEROnAllZero:
            term = torch.mean(1.0 / (1.0 + torch.exp(-logits)))  # P(bit=1)
        elif loss_type == LossType.FEROnAllZero:
            # a frame errs iff some bit decides 1 <=> min over bits of -logits < 0
            term = torch.mean(0.5 * (1.0 - sign_through(torch.amin(-logits, dim=1))))
        else:
            raise ValueError(f"unknown loss type {loss_type}")
        total = total + w * term
        weight_sum = weight_sum + w

    return total / weight_sum if weight_sum > 0 else total
