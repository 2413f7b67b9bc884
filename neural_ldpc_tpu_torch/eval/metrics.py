"""BER / FER evaluation (reference src/boosted_neural_ldpc_decoder/
Functions.evaluate_ber_fer, :86-102).

Hard decision under the STANDARD convention: bit = (LLR < 0).  Under the
REFERENCE convention the consistent decision is bit = (LLR > 0); pass
``emulate_reference_decision=True`` to reproduce the reference evaluator's
(LLR < 0) quirk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..structs import Convention


class ErrorCounts(NamedTuple):
    bit_errors: torch.Tensor  # [I] per-iteration bit error counts
    total_bits: torch.Tensor  # scalar
    frame_errors: torch.Tensor  # [I]
    total_frames: torch.Tensor  # scalar


def hard_decision(
    outputs: torch.Tensor,
    convention: Convention = Convention.STANDARD,
    emulate_reference_decision: bool = False,
) -> torch.Tensor:
    if convention == Convention.REFERENCE and not emulate_reference_decision:
        return (outputs > 0).to(torch.int32)
    return (outputs < 0).to(torch.int32)


def count_errors(
    expected: torch.Tensor,
    outputs: torch.Tensor,
    convention: Convention = Convention.STANDARD,
    emulate_reference_decision: bool = False,
) -> ErrorCounts:
    """expected [B, NZ] bits; outputs [I, B, NZ] (or [B, NZ]).  Returns raw
    counts (float32 tensors on the outputs' device) so callers can sum them
    across batches or ranks before normalizing."""
    if outputs.dim() == 2:
        outputs = outputs[None]
    decided = hard_decision(outputs, convention, emulate_reference_decision)
    errs = (decided != expected[None].to(torch.int32)).to(torch.float32)
    bit_errors = errs.sum(dim=(1, 2))  # [I]
    frame_errors = (errs.sum(dim=2) > 0).to(torch.float32).sum(dim=1)  # [I]
    return ErrorCounts(
        bit_errors=bit_errors,
        total_bits=torch.tensor(float(expected.numel()), device=outputs.device),
        frame_errors=frame_errors,
        total_frames=torch.tensor(float(expected.shape[0]), device=outputs.device),
    )


def evaluate_ber_fer(
    expected,
    outputs,
    convention: Convention = Convention.STANDARD,
    emulate_reference_decision: bool = False,
):
    """Reference-shaped convenience wrapper (Functions.py:86-102): returns
    ((per-iter bit errors, total bits), (per-iter frame errors, total frames))
    as host Python values."""
    c = count_errors(torch.as_tensor(expected), torch.as_tensor(outputs), convention,
                     emulate_reference_decision)
    return (
        ([float(v) for v in c.bit_errors], int(c.total_bits)),
        ([float(v) for v in c.frame_errors], int(c.total_frames)),
    )
