"""Fake-quantization with straight-through estimators (STE).

Parity targets: reference src/boosted_neural_ldpc_decoder/Functions.py:29-83
(``qms_clipping_torch`` / ``cal_msa_q_torch`` / ``Cal_MSA_Q``) and the inline
copy in BoostedNeuralLDPCDecoder._quantize_message (:187-214).

Forward value is the quantized message; the gradient is that of the clipped
identity (``detach`` carries the quantization residual), 0.5 at either bound
as ``jnp.clip``'s (``ops/ties.py``).  ``torch.round``
rounds half-to-even, like ``numpy.round``: under ``q_bit=5`` x*2 lands on .5
all the time, so round-half-away would change the messages.
"""

from __future__ import annotations

import numpy as np
import torch

from .ties import clip

# q_bit -> (clip_lo, clip_hi, scale); quantized value = clip(round(x * scale) / scale).
# The q_bit=-5 entry is the reference's "5-bit, integer step" mode.
_QMS_TABLE = {
    6: (-15.5, 15.5, 1.0),
    5: (-7.5, 7.5, 2.0),
    -5: (-15.0, 15.0, 1.0),
    4: (-7.0, 7.0, 1.0),
    3: (-6.0, 6.0, 0.5),
}


def qms_clip(x: torch.Tensor, q_bit: int) -> torch.Tensor:
    """Clip to the q_bit range without quantizing (reference Functions.py:29-40)."""
    if q_bit not in _QMS_TABLE:
        return x
    lo, hi, _ = _QMS_TABLE[q_bit]
    return torch.clamp(x, lo, hi)


def qms_quantize_value(x, q_bit: int):
    """Pure quantized value, no STE (reference Functions.Cal_MSA_Q, :70-83).
    Works on numpy arrays or tensors."""
    if q_bit not in _QMS_TABLE:
        return x
    lo, hi, scale = _QMS_TABLE[q_bit]
    if isinstance(x, torch.Tensor):
        return torch.clamp(torch.round(x * scale) / scale, lo, hi)
    return np.clip(np.round(x * scale) / scale, lo, hi)


def qms_quantize_ste(x: torch.Tensor, q_bit: int) -> torch.Tensor:
    """Straight-through fake-quant: forward = quantized, backward = clipped
    identity (reference Functions.cal_msa_q_torch, :43-67)."""
    if q_bit not in _QMS_TABLE:
        return x
    lo, hi, scale = _QMS_TABLE[q_bit]
    q = torch.clamp(torch.round(x * scale) / scale, lo, hi)
    clipped = clip(x, lo, hi)
    return clipped + (q - clipped).detach()
