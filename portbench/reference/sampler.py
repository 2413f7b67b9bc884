"""The campaign's channel, regenerated from (seed, word index).

A frozen copy of the arithmetic of the port's in-kernel AWGN sampler for
all-zero words: a counter hash (two lowbias32 rounds) gives two 24-bit
uniforms a pair of bits, Box-Muller turns them into the pair's noise, and
the LLR is 2/s^2 + (2/s) * noise.  The stream tile is the sampler's rule
for the code (128 words where E * Zp <= 2500, else 256).  Also the
campaign's per-batch keys: one 63-bit key a batch from a CPU
``torch.Generator`` seeded once, whose low 32 bits seed the sampler.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF


def next_key(gen: torch.Generator) -> int:
    return int(torch.randint(0, (1 << 63) - 1, (), generator=gen, dtype=torch.int64))


def kernel_seed(key: int) -> int:
    return ((key & M32) ^ 0x80000000) - 0x80000000


def round8(x: int) -> int:
    return -(-x // 8) * 8


def stream_tile(E: int, Z: int) -> int:
    return 128 if E * round8(Z) <= 2500 else 256


def _mix32(h):
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & M32
    return h ^ (h >> 16)


def _uniform(i, draw: int, key):
    h = _mix32(((i * 2 + draw) & M32) ^ key)
    h = _mix32(h ^ ((key * 0x9E3779B9) & M32))
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def channel(seed: int, sigma: float, words: torch.Tensor, N: int, Z: int, bt: int):
    """LLRs [B, N*Z] float32 of the all-zero words at batch indices
    ``words`` [B] under the int32 ``seed``, on ``words``' device."""
    dev, Zp = words.device, round8(Z)
    w = words.to(torch.int64) & M32
    key = ((int(seed) & M32) ^ (((w // bt) * 2654435761) & M32))[:, None]
    half = round8(-(-(N * Zp) // 2))
    i = (torch.arange(half, device=dev)[None, :] * bt + (w % bt)[:, None]) & M32
    u1 = _uniform(i, 0, key)
    u2 = _uniform(i, 1, key)
    del i, key
    r = torch.sqrt(-2.0 * torch.log(1.0 - u1))
    theta = (2.0 * math.pi) * u2
    del u1, u2
    # padded row r of [N*Zp] (bit (n, z) at r = n*Zp + z): rows below
    # ``half`` take pair r's cosine, the others pair r - half's sine
    rg = torch.cat([r * torch.cos(theta), r * torch.sin(theta)], dim=1)
    q = torch.arange(N * Z, device=dev)
    s = np.float32(sigma)
    base, scale = float(np.float32(2.0) / (s * s)), float(np.float32(2.0) / s)
    return base + scale * rg[:, (q // Z) * Zp + q % Z]
