"""Flat-layout BP ops with index-gather routing — the plain PyTorch decoder.

Message layout is a single flat CN-form axis q = e*Z + z (edge-major, z = the
check copy's lifted index), so a batch of messages is [B, E*Z] and the channel
/ APP side is [B, N*Z] with flat bit index p = n*Z + z (the framework's
codeword bit order).  The lifting roll is folded into one precomputed index
table per direction:

    route_idx[e*Z + zc] = vn(e)*Z + (zc + shift_e) % Z

so VN -> edge routing is one gather, and edge -> VN accumulation is a padded
gather over each VN copy's incoming edges summed slot by slot in a fixed order
(no scatter-add, whose order is not fixed on a GPU).  The check update is an
O(E * max_deg) padded reduction over a [B, M, D, Z] view, as in the
reference's [B, Z, E, E] tile (src/boosted_neural_ldpc_decoder/
BoostedNeuralLDPCDecoder.py:394-423) without its O(E^2) cost.

Everything is differentiable through autograd, with the JAX package's
gradient conventions at ties (``ops/ties.py``): clips give 0.5 at a bound,
``abs`` +1 at 0, and a tied minimum splits its gradient evenly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..codes.tanner import TannerGraph
from . import ties

_BIG = 10000.0  # masking magnitude for min-reductions
_SP_EPS = 1e-7  # atanh clamp (reference BoostedNeuralLDPCDecoder.py:406-408)


@dataclasses.dataclass(frozen=True)
class FlatGraphArrays:
    """Index tables for the flat path, as long tensors on one device."""

    M: int
    N: int
    Z: int
    E: int
    D: int  # max check degree

    route_idx: torch.Tensor  # [E*Z] VN-copy index feeding each flat edge
    vn_gather: torch.Tensor  # [N*Z, max_vn_degree] flat edge ids, E*Z = pad
    cn_gather: torch.Tensor  # [M*D] edge ids, E = pad sentinel
    cn_of_edge: torch.Tensor  # [E]
    slot_index: torch.Tensor  # [E] cn_of_edge * D + slot_of_edge

    @staticmethod
    def from_graph(g: TannerGraph, device="cpu") -> "FlatGraphArrays":
        Z, E, N, M, D = g.Z, g.E, g.N, g.M, g.max_cn_degree
        zc = np.arange(Z)[None, :]
        route = g.vn_of_edge[:, None] * Z + (zc + g.shift_of_edge[:, None]) % Z
        # VN copy (n, zv) receives edge e (of VN n) from check copy
        # zc = (zv - shift_e) % Z; slots in canonical edge order
        zv = np.arange(Z)
        vn_gather = np.full((N, Z, g.max_vn_degree), E * Z, np.int64)
        for n in range(N):
            for k, e in enumerate(g.vn_edges[n]):
                if e < E:
                    vn_gather[n, :, k] = e * Z + (zv - g.shift_of_edge[e]) % Z

        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        return FlatGraphArrays(
            M=M, N=N, Z=Z, E=E, D=D,
            route_idx=t(route.reshape(-1)),
            vn_gather=t(vn_gather.reshape(N * Z, -1)),
            cn_gather=t(np.minimum(g.cn_edges, E).reshape(-1)),
            cn_of_edge=t(g.cn_of_edge),
            slot_index=t(g.cn_of_edge.astype(np.int64) * D + g.slot_of_edge),
        )

    def edge_weights_to_flat(self, w: torch.Tensor) -> torch.Tensor:
        """[..., E] per-edge weights -> [..., E*Z] (constant across lift copies)."""
        return torch.repeat_interleave(w, self.Z, dim=-1)

    def vn_weights_to_flat(self, w: torch.Tensor) -> torch.Tensor:
        """[..., N] per-VN weights -> [..., N*Z]."""
        return torch.repeat_interleave(w, self.Z, dim=-1)


def route_to_edges(x_nz: torch.Tensor, fa: FlatGraphArrays) -> torch.Tensor:
    """[B, N*Z] VN-copy values -> [B, E*Z] CN-form edges (lift roll included).

    Replaces the reference's ``xa @ W_skipconn2even`` + ``llr @ W_odd2even`` +
    ``x @ lifting_matrix_1.T`` chain (:376-384) with one gather."""
    return x_nz[:, fa.route_idx]


def gather_sum(msg: torch.Tensor, gather: torch.Tensor) -> torch.Tensor:
    """[B, E*Z] messages -> [B, R] sums of the flat edges listed in each row
    of ``gather`` [R, S] (index E*Z pads).  Slots are added one at a time in
    column order, so the sum order is fixed."""
    padded = torch.cat([msg, msg.new_zeros(msg.shape[0], 1)], dim=1)
    g = padded[:, gather]  # [B, R, S]
    acc = g[:, :, 0]
    for k in range(1, g.shape[2]):
        acc = acc + g[:, :, k]
    return acc


def route_to_vns(msg: torch.Tensor, fa: FlatGraphArrays) -> torch.Tensor:
    """[B, E*Z] CN-form messages -> per-VN-copy sums [B, N*Z] (marginal
    accumulation; replaces ``llr @ W_output`` + inverse lift, :425-429,513)."""
    return gather_sum(msg, fa.vn_gather)


def _padded_check_view(msg: torch.Tensor, fa: FlatGraphArrays, fill: float) -> torch.Tensor:
    """[B, E*Z] -> [B, M, D, Z] via one gather on the edge axis."""
    B = msg.shape[0]
    me = msg.reshape(B, fa.E, fa.Z)
    mp = torch.cat([me, me.new_full((B, 1, fa.Z), fill)], dim=1)
    return mp[:, fa.cn_gather, :].reshape(B, fa.M, fa.D, fa.Z)


def cn_minsum_flat(v2c: torch.Tensor, fa: FlatGraphArrays) -> torch.Tensor:
    """Extrinsic min-sum check update on flat messages: [B, E*Z] -> [B, E*Z].

    Two-min trick over the padded per-check view; the extrinsic minimum of
    the first-occurrence argmin slot is the second minimum."""
    B = v2c.shape[0]
    s = torch.where(v2c >= 0, 1.0, -1.0).to(v2c.dtype)
    gmat = _padded_check_view(ties.abs_(v2c), fa, _BIG).transpose(2, 3)  # [B, M, Z, D]
    m1, m2, am = ties.two_min(gmat, _BIG)
    sp = _padded_check_view(s, fa, 1.0).prod(dim=2)  # [B, M, Z]
    slot = fa.slot_index - fa.cn_of_edge * fa.D  # [E] slot of each edge
    m1e = m1[:, fa.cn_of_edge, :]
    m2e = m2[:, fa.cn_of_edge, :]
    ame = am[:, fa.cn_of_edge, :]
    mag = torch.where(slot[None, :, None] == ame, m2e, m1e)
    sgn = sp[:, fa.cn_of_edge, :] * s.reshape(B, fa.E, fa.Z)
    return (mag * sgn).reshape(B, fa.E * fa.Z)


def cn_sumproduct_flat(v2c: torch.Tensor, fa: FlatGraphArrays) -> torch.Tensor:
    """Extrinsic sum-product (tanh domain) check update on flat messages.

    Prefix/suffix products over the padded per-check view give the
    exclude-self product in O(D) (reference does it with the E x E tile,
    :400-408)."""
    B = v2c.shape[0]
    t = _padded_check_view(torch.tanh(0.5 * v2c), fa, 1.0)  # [B, M, D, Z]
    prefix = torch.cumprod(t, dim=2)
    suffix = torch.cumprod(t.flip(2), dim=2).flip(2)
    ones = torch.ones_like(t[:, :, :1, :])
    pre = torch.cat([ones, prefix[:, :, :-1, :]], dim=2)
    suf = torch.cat([suffix[:, :, 1:, :], ones], dim=2)
    ext = pre * suf  # [B, M, D, Z] extrinsic product per slot
    ext_e = ext.reshape(B, fa.M * fa.D, fa.Z)[:, fa.slot_index, :]
    ext_e = ties.clip(ext_e, -1.0 + _SP_EPS, 1.0 - _SP_EPS)
    return (2.0 * torch.atanh(ext_e)).reshape(B, fa.E * fa.Z)


def check_parity_flat(app_nz: torch.Tensor, fa: FlatGraphArrays) -> torch.Tensor:
    """Per-edge unsatisfied-check indicator from APP [B, N*Z] -> [B, E*Z].

    UCN detection (reference :339-368): hard-decide each VN copy, route the
    decision signs through the graph (lift included), and mark every edge of
    each odd-parity lifted check."""
    sign = torch.where(app_nz < 0, -1.0, 1.0).to(app_nz.dtype)
    parity = _padded_check_view(route_to_edges(sign, fa), fa, 1.0).prod(dim=2)
    ucn = (parity < 0).to(app_nz.dtype)  # [B, M, Z]
    B = app_nz.shape[0]
    return ucn[:, fa.cn_of_edge, :].reshape(B, fa.E * fa.Z)
