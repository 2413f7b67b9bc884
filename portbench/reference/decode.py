"""Final-iteration APP of a decode, in plain PyTorch, block by block."""

from __future__ import annotations

import torch

from . import decoder as D
from .graph import Tables


@torch.no_grad()
def app(t: Tables, dec: dict, cn_w, vn_w, llr, dtype=torch.float32, block: int = 1 << 15):
    """The clipped final APP [B, N*Z] (float32) of ``llr`` [B, N*Z]."""
    cn = None if cn_w is None else cn_w.to(dtype)
    vn = None if vn_w is None else vn_w.to(dtype)
    out = torch.empty(llr.shape, dtype=torch.float32, device=llr.device)
    for b0 in range(0, llr.shape[0], block):
        chunk = llr[b0:b0 + block].to(dtype)
        out[b0:b0 + block] = D.decode(t, dec, chunk, cn, vn)[-1].to(torch.float32)
    return out
