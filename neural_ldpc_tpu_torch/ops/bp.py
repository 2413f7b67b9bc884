"""Core belief-propagation message-update primitives on edge tables — the
edge path, plain PyTorch.

Port of ``neural_ldpc_tpu/ops/bp.py``, function for function.  It replaces
the reference's dense formulation
(src/boosted_neural_ldpc_decoder/BoostedNeuralLDPCDecoder.py:376-429): the
[B, Z, E, E] tiled check-node update becomes a padded per-check masked
reduction (O(E * max_deg) work), the (EZ) x (EZ) lifting matmuls become
per-edge cyclic-shift gathers, and the one-hot routing matmuls become index
gathers and padded sums.  Message tensors are laid out [B, Z, E] with E in
CN-order (edges grouped by check).

Two numerical modes:
  * standard: clean textbook updates (sign of 0 treated as +).
  * parity (``parity_with_reference=True``): reproduce the reference
    bit for bit — the +1e-4 zero-avoidance before the CN min, the -1e-4
    removal after it (BoostedNeuralLDPCDecoder.py:391-393,416), and the
    per-check (-1)^deg sign factor that the reference's tile formulation
    carries (net effect of :417-423; ``structs.Convention``).

The differentiated operations come from ``ops/ties.py``, so gradients at
ties are the JAX package's: a tied minimum splits its gradient evenly,
``abs`` gives +1 at 0 and a clip 0.5 at a bound.  Sums over a node's slots
are added one slot at a time in a fixed order, with no scatter-add.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..codes.tanner import TannerGraph
from . import ties

_BIG = 10000.0  # masking magnitude for min-reductions (reference :411-414)
_ZERO_EPS = 1e-4  # zero-avoidance epsilon (reference :391-393)
_SP_EPS = 1e-7  # atanh clamp (reference :406-408)


@dataclasses.dataclass(frozen=True)
class GraphArrays:
    """A TannerGraph's index tables as tensors on one device."""

    M: int
    N: int
    Z: int
    E: int
    max_cn_degree: int
    max_vn_degree: int

    cn_of_edge: torch.Tensor  # [E] int64
    vn_of_edge: torch.Tensor  # [E] int64
    slot_of_edge: torch.Tensor  # [E] int64
    cn_edges_flat: torch.Tensor  # [M * Dc] int64 (E = pad sentinel)
    vn_edges_flat: torch.Tensor  # [N * Dv] int64 (E = pad sentinel)
    vn_edges_by_slot: torch.Tensor  # [Dv * N] the same, slot-major, for the sums
    z_roll_in: torch.Tensor  # [1, Z, E] int64
    z_roll_out: torch.Tensor  # [1, Z, E] int64
    deg_sign: torch.Tensor  # [E] float32, (-1)^deg of the edge's check (parity mode)
    cn_deg_sign: torch.Tensor  # [M] float32

    @staticmethod
    def from_graph(g: TannerGraph, device="cpu") -> "GraphArrays":
        deg_sign_cn = np.where(g.cn_degree % 2 == 0, 1.0, -1.0).astype(np.float32)

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        return GraphArrays(
            M=g.M, N=g.N, Z=g.Z, E=g.E,
            max_cn_degree=g.max_cn_degree, max_vn_degree=g.max_vn_degree,
            cn_of_edge=t(g.cn_of_edge),
            vn_of_edge=t(g.vn_of_edge),
            slot_of_edge=t(g.slot_of_edge),
            cn_edges_flat=t(g.cn_edges.reshape(-1)),
            vn_edges_flat=t(g.vn_edges.reshape(-1)),
            vn_edges_by_slot=t(g.vn_edges.T.reshape(-1)),
            z_roll_in=t(g.z_roll_in)[None],
            z_roll_out=t(g.z_roll_out)[None],
            deg_sign=t(deg_sign_cn[g.cn_of_edge], torch.float32),
            cn_deg_sign=t(deg_sign_cn, torch.float32),
        )


def _pad_edges(msg: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Append a sentinel slot (index E) along the edge axis so padded gathers
    pick up ``fill``."""
    return torch.cat([msg, msg.new_full(msg.shape[:-1] + (1,), fill)], dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` for a 1-D index, as one ``torch.gather`` on the last
    axis (advanced indexing and ``index_select`` there are about 3x slower on
    the CPU)."""
    return torch.gather(x, -1, idx.expand(x.shape[:-1] + idx.shape))


def _check_view(x: torch.Tensor, ga: GraphArrays, fill: float) -> torch.Tensor:
    """[..., E] -> [..., M, Dc], padded slots ``fill``."""
    g = _take(_pad_edges(x, fill), ga.cn_edges_flat)
    return g.reshape(x.shape[:-1] + (ga.M, ga.max_cn_degree))


def _roll(msg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(msg, 1, idx.expand(msg.shape[0], -1, -1))


def lift_roll_in(msg: torch.Tensor, ga: GraphArrays) -> torch.Tensor:
    """VN-copy z-index -> CN-copy z-index: out[b, z, e] = msg[b, (z+shift_e)%Z, e].

    Equivalent to the reference's ``x @ lifting_matrix_1.T`` applied per edge
    block (BoostedNeuralLDPCDecoder.py:380-384).
    """
    return _roll(msg, ga.z_roll_in)


def lift_roll_out(msg: torch.Tensor, ga: GraphArrays) -> torch.Tensor:
    """Inverse roll (reference ``x @ lifting_matrix_2``, :425-429)."""
    return _roll(msg, ga.z_roll_out)


def vn_marginal_sums(msg_c2v: torch.Tensor, ga: GraphArrays) -> torch.Tensor:
    """Sum CN->VN messages per variable node: [B, Z, E] -> [B, Z, N].

    Replaces the reference's ``llr @ W_output`` one-hot matmul (:513); the
    slots are added one at a time, so the sum order is fixed."""
    g = _take(_pad_edges(msg_c2v), ga.vn_edges_by_slot)  # [B, Z, Dv*N]
    g = g.reshape(msg_c2v.shape[:-1] + (ga.max_vn_degree, ga.N))
    acc = g[..., 0, :]
    for k in range(1, ga.max_vn_degree):
        acc = acc + g[..., k, :]
    return acc


def chan_to_edges(chan: torch.Tensor, ga: GraphArrays) -> torch.Tensor:
    """Broadcast per-VN values to edges: [B, Z, N] -> [B, Z, E]
    (replaces ``xa @ W_skipconn2even``, reference :376)."""
    return _take(chan, ga.vn_of_edge)


def cn_to_edges(per_cn: torch.Tensor, ga: GraphArrays) -> torch.Tensor:
    """Broadcast per-CN values to edges: [..., M] -> [..., E]
    (replaces ``w @ W_skipconn2odd``, reference :447-497)."""
    return _take(per_cn, ga.cn_of_edge)


def vn_update_extrinsic(
    chan_edge: torch.Tensor,
    msg_c2v: torch.Tensor,
    vn_sums: torch.Tensor,
    ga: GraphArrays,
) -> torch.Tensor:
    """VN->CN messages: channel LLR + extrinsic sum of incoming CN messages.

    Uses total-minus-self (vn_sums already holds the per-VN totals), the O(E)
    equivalent of the reference's ``llr @ W_odd2even`` extrinsic matmul
    (:377).
    """
    return chan_edge + _take(vn_sums, ga.vn_of_edge) - msg_c2v


def cn_update_minsum(
    v2c: torch.Tensor,
    ga: GraphArrays,
    parity_with_reference: bool = False,
    zero_handling: str = "standard",
) -> torch.Tensor:
    """Check-node min-sum update, extrinsic per edge.  [B, Z, E] -> [B, Z, E]
    with z = CN-copy index on both sides.

    Replaces the reference's [B, Z, E, E] tile + masked min + masked
    sign-product (BoostedNeuralLDPCDecoder.py:394-423) with the two-min trick
    over the padded per-check layout.

    zero_handling (only meaningful with ``parity_with_reference``):
      * "standard": exact zeros participate normally (sign +1, magnitude 0).
      * "eps": boosted-reference behavior — add +1e-4 to exact zeros before
        the min and strip it after (BoostedNeuralLDPCDecoder.py:391-393,416).
      * "exclude": Dai-reference behavior — exact zeros are masked out of the
        min like non-edges (NeuralLDPCDecoder.py:74, which has no epsilon
        pass, so ``|x| + 1e4*(x==0)`` also swallows true zeros).
    """
    if parity_with_reference and zero_handling == "eps":
        # zero-avoidance so sign(0) cases match the reference (:391-393)
        v2c = v2c + _ZERO_EPS * (v2c == 0.0).to(v2c.dtype)

    abs_v = ties.abs_(v2c)
    if parity_with_reference and zero_handling == "exclude":
        abs_v = torch.where(v2c == 0.0, _BIG, abs_v)
    m1, m2, am = ties.two_min(_check_view(abs_v, ga, _BIG), _BIG)  # [B, Z, M]

    # per-edge extrinsic min: m2 where this edge is the (first) argmin, else m1
    m1_e = _take(m1, ga.cn_of_edge)
    m2_e = _take(m2, ga.cn_of_edge)
    am_e = _take(am, ga.cn_of_edge)
    extr_min = torch.where(ga.slot_of_edge == am_e, m2_e, m1_e)

    if parity_with_reference and zero_handling == "eps":
        # reference removes the epsilon after the min (:416)
        extr_min = extr_min - _ZERO_EPS * (extr_min <= _ZERO_EPS).to(extr_min.dtype)

    # sign: product over the check's other edges = total product * own sign
    sgn = torch.where(v2c >= 0, 1.0, -1.0).to(v2c.dtype)
    total_sign = _check_view(sgn, ga, 1.0).prod(dim=-1)  # [B, Z, M]
    extr_sign = _take(total_sign, ga.cn_of_edge) * sgn

    if parity_with_reference:
        extr_sign = extr_sign * ga.deg_sign

    return extr_min * extr_sign


def cn_update_sumproduct(
    v2c: torch.Tensor,
    ga: GraphArrays,
    parity_with_reference: bool = False,
) -> torch.Tensor:
    """Check-node sum-product (tanh domain) update, extrinsic per edge.

    Replaces reference :400-408.  The extrinsic product excluding self is
    computed with a [B, Z, M, D, D] masked tile over max check degree D, as
    the JAX edge path keeps it: it reproduces the reference's product
    structure for parity testing (the O(D) prefix/suffix form is the flat
    path's, ``ops/flat.cn_sumproduct_flat``).  The tile holds B*Z*M*D*D
    floats: 269 KB a BG2 word.
    """
    batch_shape = v2c.shape[:-1]
    g = _check_view(torch.tanh(0.5 * v2c), ga, 1.0)  # [B, Z, M, D]

    D = ga.max_cn_degree
    not_self = ~torch.eye(D, dtype=torch.bool, device=v2c.device)  # [D_out, D_in]
    tile = torch.where(not_self, g[..., None, :], 1.0)  # [B, Z, M, D, D]
    ext_prod = tile.prod(dim=-1)  # [B, Z, M, D]

    ext_e = _take(ext_prod.reshape(batch_shape + (ga.M * D,)),
                  ga.cn_of_edge * D + ga.slot_of_edge)
    ext_e = ties.clip(ext_e, -1.0 + _SP_EPS, 1.0 - _SP_EPS)
    msg = 2.0 * torch.atanh(ext_e)
    if parity_with_reference:
        msg = msg * ga.deg_sign
    return msg


def check_parity_indicator(
    app: torch.Tensor,
    ga: GraphArrays,
    parity_with_reference: bool = False,
) -> torch.Tensor:
    """Per-edge unsatisfied-check indicator from an APP vector [B, Z, N].

    Mirrors the reference's UCN detection pass
    (BoostedNeuralLDPCDecoder.py:339-368): hard-decide each VN copy, compute
    every lifted check's parity (product of decision signs over ALL of its
    edges, self included), and broadcast the result back to edges in VN-copy
    z-indexing.  Returns 1.0 where the edge's check is unsatisfied, else 0.0.

    In reference mode the decision sign matches ``(-APP > 0) - (-APP <= 0)``
    (:346-347); in standard convention APP > 0 means bit 0, so the decision
    sign is the sign of APP itself — both reduce to a parity of the same bits,
    differing only on exact zeros, which reference mode resolves like the
    reference.
    """
    if parity_with_reference:
        sign = torch.where(-app > 0, 1.0, -1.0).to(app.dtype)
    else:
        # bit = (app < 0); parity over bits == product of signs
        sign = torch.where(app < 0, -1.0, 1.0).to(app.dtype)

    sign_edge = lift_roll_in(chan_to_edges(sign, ga), ga)  # CN-copy z
    check_sign = _check_view(sign_edge, ga, 1.0).prod(dim=-1)  # [B, Z, M]; -1 => unsatisfied
    ucn_edge = _take((check_sign < 0).to(app.dtype), ga.cn_of_edge)
    return lift_roll_out(ucn_edge, ga)  # back to VN-copy z (reference :360-364)
