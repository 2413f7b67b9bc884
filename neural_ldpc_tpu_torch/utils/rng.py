"""Per-batch random keys for host-side loops.

A campaign draws one key per batch from a CPU ``torch.Generator`` seeded
once: drawing touches no device, so a dispatch loop never waits on the card.
Each key yields the int32 seed of the in-kernel sampler and the seed of the
channel's device generator for batches sampled outside the kernel.  Under a
mesh each rank folds its rank into the batch's key (``fold_in``).
"""

from __future__ import annotations

import torch

_MASK63 = (1 << 63) - 1
_MASK64 = (1 << 64) - 1


def next_key(gen: torch.Generator) -> int:
    """The next per-batch key, a non-negative 63-bit integer."""
    return int(torch.randint(0, _MASK63, (), generator=gen, dtype=torch.int64))


def kernel_seed(key: int) -> int:
    """The key's low 32 bits as an int32: the in-kernel sampler's seed."""
    return ((key & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def channel_seed(key: int) -> int:
    """The seed of the channel's device generator for this batch."""
    return key & _MASK63


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A key of its own for ``data`` (a rank) within the batch ``key``: the
    counterpart of ``jax.random.fold_in(key, axis_index)``.  The two are
    mixed, not added: ``key + rank`` could be the next batch's key."""
    return _splitmix64(_splitmix64(key) ^ data) & _MASK63
