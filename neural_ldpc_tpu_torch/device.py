"""Device selection for the port's entry points.

Entry points default to ``"cuda"``.  A machine without CUDA raises instead of
quietly decoding on the CPU; tests and CPU users pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        # the card a tensor made with device="cuda" lands on, so that
        # device checks compare equal devices as equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_same_device(t: torch.Tensor, device: torch.device, name: str) -> None:
    """Raise unless ``t`` lies on ``device``: the decode entry points never
    move a batch between the host and the card behind the caller's back."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, the decoder on {device}; "
                         "build the decoder on the tensor's device or move the tensor")
