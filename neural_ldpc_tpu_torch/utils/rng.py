"""Per-batch random keys for host-side loops.

A campaign draws one key per batch from a CPU ``torch.Generator`` seeded
once: drawing touches no device, so a dispatch loop never waits on the card.
Each key yields the int32 seed of the in-kernel sampler and the seed of the
channel's device generator for batches sampled outside the kernel.
"""

from __future__ import annotations

import torch

_MASK63 = (1 << 63) - 1


def next_key(gen: torch.Generator) -> int:
    """The next per-batch key, a non-negative 63-bit integer."""
    return int(torch.randint(0, _MASK63, (), generator=gen, dtype=torch.int64))


def kernel_seed(key: int) -> int:
    """The key's low 32 bits as an int32: the in-kernel sampler's seed."""
    return ((key & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def channel_seed(key: int) -> int:
    """The seed of the channel's device generator for this batch."""
    return key & _MASK63
