"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference computes from the same inputs."""

from __future__ import annotations

import statistics

import torch

# a leaf whose reference gradient is below this share of the median leaf's
# moves by round-off alone and is left out of the change
STILL_LEAF = 1e-3


def relative(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def leaf_gap(got: dict, ref: dict, leaves=None) -> float:
    """The worst leaf's gap between the two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    median = statistics.median(norms.values())
    gaps = [abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k])
            / max(norms[k], median, 1e-30) for k in (leaves or list(ref))]
    return max(gaps)


def moving_leaves(first_grad: dict) -> list:
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in first_grad.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= STILL_LEAF * median]


def training(prog: dict, ref: dict) -> dict:
    """loss_gap: the worst step's relative loss gap; grad_gap: the first
    gradient's worst leaf; change_gap: the worst moving leaf's change."""
    change = {k: prog["end"][k].float() - prog["start"][k].float() for k in prog["end"]}
    ref_change = {k: ref["end"][k].float() - ref["start"][k].float() for k in ref["end"]}
    return {
        "loss_gap": max(relative(a, b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": leaf_gap(prog["first_grad"], ref["first_grad"]),
        "change_gap": leaf_gap(change, ref_change, moving_leaves(ref["first_grad"])),
    }
