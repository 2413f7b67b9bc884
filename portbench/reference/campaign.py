"""Error counts of an early-exit Monte-Carlo campaign, in plain PyTorch.

The configured algorithm on all-zero words: each word's channel comes from
the frozen sampler; every word is decoded with the first-stage iterations,
and a word whose decisions satisfy every check is counted from that stage
(bit errors = decisions 1, a frame error where any); every other word is an
escalation, decoded again from its channel with the full unroll and counted
from that.
"""

from __future__ import annotations

import torch

from . import decoder as D
from . import sampler
from .graph import Tables


@torch.no_grad()
def counts(t: Tables, dec: dict, cn_w, sigma: float, seeds, batch: int, first_iterations: int,
           dtype=torch.float32, block: int = 1 << 17):
    """(bit errors, frame errors, escalations) over the batches whose
    sampler seeds are ``seeds``."""
    s = t.shape
    bt = sampler.stream_tile(s.E, s.Z)
    device = t.route.device
    cn = None if cn_w is None else cn_w.to(dtype)
    be = fe = esc = 0
    for seed in seeds:
        failed = []
        for w0 in range(0, batch, block):
            words = torch.arange(w0, min(batch, w0 + block), device=device)
            llr = sampler.channel(seed, sigma, words, s.N, s.Z, bt).to(dtype)
            app = D.decode(t, dec, llr, cn, iterations=first_iterations)[-1]
            ok = D.syndrome_ok(app, t)
            ones = (app < 0).sum(dim=1)
            be += int(ones[ok].sum())
            fe += int((ones[ok] > 0).sum())
            failed.append(words[~ok])
        failed = torch.cat(failed)
        esc += failed.numel()
        for k0 in range(0, failed.numel(), block):
            words = failed[k0:k0 + block]
            llr = sampler.channel(seed, sigma, words, s.N, s.Z, bt).to(dtype)
            ones = (D.decode(t, dec, llr, cn)[-1] < 0).sum(dim=1)
            be += int(ones.sum())
            fe += int((ones > 0).sum())
    return be, fe, esc
