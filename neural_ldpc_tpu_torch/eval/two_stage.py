"""Two-stage decoding: base decoder + post decoder on base failures only.

Port of ``neural_ldpc_tpu/eval/two_stage.py``.  This is the operational mode
the Kwak error-floor machinery exists for (arXiv:2310.07194): the post
decoder never sees the general word distribution — it is invoked ONLY for
words whose base decode fails the syndrome check, so its aggressive
failure-distribution training cannot hurt easy words.  System FER =
P(base fails AND post fails).

Escalation uses the true syndrome (per-word parity of the hard decisions
against the lifted H), so it works on real data, not just known codewords:
a decode whose output satisfies every check is accepted from stage 1.  The
syndrome is plain PyTorch on the flat layout (``ops/flat.py``); the two
decode callables are typically ``FusedMinsumDecoder``s, which run the
forward kernel (K1a) on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..codes.tanner import TannerGraph
from ..device import DeviceLike, resolve_device
from ..ops import flat


_SYNDROME_ROWS = 1 << 16  # words a pass: bounds the [rows, M, D, Z] view


def make_syndrome_ok(graph: TannerGraph, device: DeviceLike = "cuda"):
    """[B, N*Z] APP -> [B] bool: True when every lifted check is satisfied
    by the hard decisions (STANDARD convention, LLR < 0 -> bit 1; an APP of
    exactly 0 decides bit 0).  The APP lies on ``device``.

    JAX multiplies the decisions' signs over each check; this counts the
    bit-1 decisions modulo 2 instead (the same parity), on bools, a chunk
    of words at a time."""
    fa = flat.FlatGraphArrays.from_graph(graph, resolve_device(device))

    @torch.no_grad()
    def ok(app: torch.Tensor) -> torch.Tensor:
        out = torch.empty(app.shape[0], dtype=torch.bool, device=app.device)
        for s in range(0, app.shape[0], _SYNDROME_ROWS):
            ones_e = flat.route_to_edges(app[s:s + _SYNDROME_ROWS] < 0, fa)
            view = flat._padded_check_view(ones_e, fa, False)  # [b, M, D, Z]
            odd = view.sum(dim=2, dtype=torch.uint8) % 2
            out[s:s + _SYNDROME_ROWS] = (odd == 0).flatten(1).all(dim=1)
        return out

    return ok


class TwoStageDecoder:
    """Wraps two decode callables (APP [B, N*Z] each) with syndrome routing.

    ``base_decode`` / ``post_decode``: chan_llr [B, N, Z] -> final APP
    [B, N*Z] (e.g. FusedMinsumDecoder instances, or a decoder's
    ``apply(...)[-1]``), on ``device``.  ``__call__`` runs both on the full
    batch; ``decode_sparse`` runs the post decoder only on the escalated
    rows.
    """

    def __init__(self, graph: TannerGraph, base_decode, post_decode,
                 device: DeviceLike = "cuda"):
        # decode callables must produce STANDARD-convention APPs (LLR < 0 ->
        # bit 1); the port's decoders implement no other convention
        self.graph = graph
        self.base_decode = base_decode
        self.post_decode = post_decode
        self.device = resolve_device(device)
        self._syndrome_ok = make_syndrome_ok(graph, self.device)

    @torch.no_grad()
    def __call__(self, chan_llr: torch.Tensor):
        """Returns (app [B, N*Z], used_post [B] bool)."""
        app1 = self.base_decode(chan_llr)
        ok1 = self._syndrome_ok(app1)
        app2 = self.post_decode(chan_llr)
        app = torch.where(ok1[:, None], app1, app2)
        return app, ~ok1

    @torch.no_grad()
    def decode_sparse(self, chan_llr: torch.Tensor, min_post_batch: int = 256):
        """Serving-shaped two-stage decode: the post decoder runs ONLY on the
        escalated rows.

        The failed rows are gathered on the device, padded up to a
        power-of-two bucket of at least ``min_post_batch`` (row 0 repeated),
        decoded, and scattered back.  Each word decodes alone, so the bucket
        never changes a result.  Cost per word approaches pure base decode as
        the failure rate vanishes.  Returns (app [B, N*Z], used_post [B]
        bool)."""
        app1 = self.base_decode(chan_llr)
        fail = ~self._syndrome_ok(app1)
        idx = torch.nonzero(fail).squeeze(1)
        n = int(idx.numel())
        if n == 0:
            return app1, fail
        bucket = max(min_post_batch, 1 << (n - 1).bit_length())
        pad_idx = torch.zeros(bucket, dtype=idx.dtype, device=idx.device)
        pad_idx[:n] = idx
        sel = chan_llr.index_select(0, pad_idx)
        app2 = self.post_decode(sel)[:n]
        return app1.index_copy(0, idx, app2), fail

    @torch.no_grad()
    def decode_with_fallback_stats(self, chan_llr,
                                   expected_bits: Optional[torch.Tensor] = None):
        """Decode and count stage statistics (host values).

        expected_bits [B, N*Z] (0/1) or None for all-zero."""
        app1 = self.base_decode(chan_llr)
        ok1 = self._syndrome_ok(app1)
        app2 = self.post_decode(chan_llr)
        app = torch.where(ok1[:, None], app1, app2)
        bits = (app < 0).to(torch.int32)
        exp = (torch.zeros_like(bits) if expected_bits is None
               else expected_bits.to(torch.int32))
        frame_err = (bits != exp).any(dim=1)
        base_bits = (app1 < 0).to(torch.int32)
        base_err = (base_bits != exp).any(dim=1)
        return {
            "frames": int(chan_llr.shape[0]),
            "escalated": int(torch.sum(~ok1)),
            "base_frame_errors": int(torch.sum(base_err)),
            "system_frame_errors": int(torch.sum(frame_err)),
        }
