"""Fused BP on the GPU: the hand-written CUDA kernels ``csrc/fused_fwd.cu``
(forward, four modes) and ``csrc/fused_bwd.cu`` (backward), which keep a
word's state on chip, and ``csrc/fused_fwd_dm.cu`` / ``csrc/fused_bwd_dm.cu``,
which keep it in device memory for codes too big for that; their plain
PyTorch versions, the ``torch.autograd.Function`` that joins them, and the
host-side wrapper ``FusedTrainDecoder``.

The on-chip forward kernel replaces ``neural_ldpc_tpu/ops/pallas/
fused_train.py::_fwd_kernel``, the on-chip backward kernel its
``_bwd_kernel``:

- ``fused_fwd_k1a``: final-APP decode (ROADMAP kernel "K1a");
- ``fused_fwd_k1b``: the stats and syndrome epilogues ("K1b"): per word, ok
  (every lifted check satisfied), bit errors (APP < 0 for all-zero words)
  and frame error, with or without the APP;
- ``fused_fwd_k1c``: in-kernel AWGN sampling for all-zero words ("K1c"),
  feeding the stats epilogue; optionally exports the sampled channel, or
  re-samples words at given original batch indices;
- ``fused_fwd_k1d``: the training forward ("K1d", ``stream_outputs`` and
  ``store_msgs``): the pre-clip APP of every iteration and, for the
  backward, the message state entering every iteration;
- ``fused_bwd_k2``: the reverse-iteration adjoint ("K2"): weight, channel
  and quantized-channel gradients from the stored state and the outputs'
  cotangents.  ``FusedTrainFn`` runs K1d forward and K2 backward.

The same two sources, instantiated with a routing template parameter, are
K6, the matmul branches of ``_fwd_kernel`` and ``_bwd_kernel``
(``routing="matmul"``): the VN <-> edge routing goes through the one-hot
operand on the tensor cores (``csrc/mm_route.cuh``), int8 for QMS or the
exact split-3 bf16 otherwise:

- ``fused_fwd_k6``: every mode of K1 (final APP, stats, syndrome, sampling,
  stream + store) with matmul routing;
- ``fused_bwd_k6``: K2 with matmul routing, the int8 mode's cotangents
  rounded to ``routing_dtype`` and its saturation fix.  ``FusedTrainFn``
  runs K6 forward and backward on a layout whose ``routing`` is "int8" or
  "split3".

The device-memory kernels replace ``_fwd_kernel_hbm`` and
``_bwd_kernel_hbm``, for codes whose lifted checks outnumber a block's
threads or whose state outgrows shared memory (``on_chip_ok``; the BG1-like
code above Z = 22):

- ``fused_fwd_k3``: K3, every mode of the TPU kernel (final APP, stats,
  syndrome, stream + store, where the store is the carry);
- ``fused_bwd_k4``: K4, its adjoint.  ``FusedTrainFn`` runs K3 and K4 on a
  layout built with ``hbm_store``.

Like the TPU kernels they order checks by degree (``build_layout``) and route
messages by per-edge cyclic shifts.  The TPU kernels' VMEM tiling, chunked
bounce buffers, weight-stream layouts
and ``[NZp, B]`` transpose have no GPU counterpart: the wrapper keeps the
batch-major ``[B, N*Z]`` layout and picks the words per block from thread and
shared-memory limits.  Two TPU quantities survive because they fix which
random numbers a sampled word gets: the padded lift ``Zp`` and the logical
stream tile ``bt`` (``FwdLayout``).

Bound on the H100: K1a moves 2 * N*Z * 4 bytes per word (channel in, APP
out), K1b N*Z*4 + 12, K1c 12, K1d with its store (1 + I) * N*Z*4 + I *
E*Z*4 and K2 reads the store, the outputs' cotangents (and, with UCN, the
outputs); K3 as K1a / K1b, or (1 + I) * N*Z*4 + (I - 1) * E*Z*4 with its
store, and K4 as K2 with I - 1 store slots; all do E*Z*I edge updates per
word.  ``chip_smoke.py`` counts the
operations per word from the kernel sources and reports the larger of the
byte and operation bounds next to the measured time.

Only the nine wrappers launch the kernels, and only for CUDA tensors; for
CPU tensors they run the plain versions ``fused_fwd_plain``,
``stats_plain``, ``sample_channel_plain``, ``fused_fwd_train_plain``,
``fused_bwd_plain``, ``fused_fwd_dm_plain`` and ``fused_bwd_dm_plain``,
which follow the kernels' own algorithms
(degree-sorted checks, roll as an index permutation, per-class
prefix/suffix reductions, the kernel's VN sum order, the sampler's uint32
stream; the backward's step-by-step reverse pass, not autograd; the
layout's routing, ``route_to_edges`` / ``route_to_vns``).  Each
wrapper counts its calls that launched in ``<wrapper>.launches`` and the
CUDA kernels they launched, as the C entry points count them, in
``<wrapper>.cuda_launches``, and no other wrapper's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ...codes.tanner import TannerGraph
from ...device import DeviceLike, check_same_device, resolve_device
from ...utils.rng import kernel_seed
from .. import ties
from ..flat import _BIG, _SP_EPS, gather_sum
from ..quantize import _QMS_TABLE, qms_quantize_ste, qms_quantize_value

# kernel flag bits (csrc/fused_fwd.cu)
_F_QMS, _F_SP, _F_CNW, _F_UCN, _F_VNW = 1, 2, 4, 8, 16
_F_STATS, _F_SYNDROME, _F_SAMPLE, _F_EMIT_CHAN, _F_AT_IDX = 32, 64, 128, 256, 512
_F_STREAM, _F_STORE = 1024, 2048
_F_ROUTE_INT8, _F_ROUTE_SPLIT3, _F_GRAD_F32 = 4096, 8192, 16384  # K6 (csrc/mm_route.cuh)
_M32 = 0xFFFFFFFF
_MAX_THREADS = 1024  # one thread per lifted check of a block's words
_TARGET_THREADS = 512
_SMEM_LIMIT = 227 * 1024
_MAX_CHECK_DEGREE = 32  # the kernel's largest per-thread message array


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _fwd_smem_per_word(M: int, N: int, Z: int, E: int) -> int:
    """csrc/fused_fwd.cu: channel, sums, messages, two stats integers."""
    return 4 * (2 * N * Z + E * Z + 2)


def _bwd_smem_per_word(M: int, N: int, Z: int, E: int) -> int:
    """csrc/fused_bwd.cu: channel, sums, sums carry, two channel-gradient
    accumulators, message carry, scatter buffer, a UCN flag per check."""
    return 4 * (5 * N * Z + 2 * E * Z + M * Z)


def _words_per_block(mz: int, per_word: int) -> int:
    """Whole words per block: as many as fit ~512 threads (one per lifted
    check) and the shared memory."""
    return max(1, min(_TARGET_THREADS // mz, _SMEM_LIMIT // per_word))


def _fits_on_chip(M: int, N: int, Z: int, E: int, max_degree: int) -> bool:
    """Whether the on-chip kernels (K1, K2) take a code: one thread per
    lifted check of a word fits one block, a word's state fits shared memory
    in the forward and the backward kernel, and no check has more than 32
    edges."""
    return (M * Z <= _MAX_THREADS and max_degree <= _MAX_CHECK_DEGREE
            and max(_fwd_smem_per_word(M, N, Z, E), _bwd_smem_per_word(M, N, Z, E))
            <= _SMEM_LIMIT)


def _max_check_degree(graph: TannerGraph) -> int:
    return int(np.diff(graph.row_ptr).max())


def on_chip_ok(graph: TannerGraph) -> bool:
    """Whether the on-chip kernels take this code (``store_space="vmem"``);
    the device-memory kernels (K3, K4) take the others."""
    return _fits_on_chip(graph.M, graph.N, graph.Z, graph.E, _max_check_degree(graph))


def fused_capacity_ok(graph: TannerGraph) -> bool:
    """Whether either kernel family takes this code, by JAX's rule
    (``fused_train.py:231-256``): no check has more than 32 edges (the
    kernels' largest per-thread message array), and either the on-chip
    kernels hold it, at any E (routed by K6 beyond the roll routing's 1024
    edges), or E <= 1024 for the device-memory kernels, which route by roll
    only."""
    return _max_check_degree(graph) <= _MAX_CHECK_DEGREE and (
        on_chip_ok(graph) or graph.E <= 1024)


def build_layout(graph: TannerGraph, natural: bool = False):
    """Degree-sorted check order: (edge_perm [E] new->old, deg_classes
    ((degree, n_checks), ...)).  Checks are sorted by degree (stable), and
    each check's edges stay contiguous in the permuted order.  With
    ``natural`` the checks keep their row_ptr order (the legacy engine's):
    the identity permutation, each run of equal degrees a class."""
    degs = np.diff(graph.row_ptr)
    if degs.min() < 2:
        raise ValueError("degree-1 checks unsupported (extrinsic min undefined)")
    order = np.arange(len(degs)) if natural else np.argsort(degs, kind="stable")
    edge_perm = np.concatenate(
        [np.arange(graph.row_ptr[m], graph.row_ptr[m + 1]) for m in order]
    ).astype(np.int32)
    deg_classes = []
    for d in degs[order]:
        if deg_classes and deg_classes[-1][0] == d:
            deg_classes[-1][1] += 1
        else:
            deg_classes.append([int(d), 1])
    return edge_perm, tuple((d, n) for d, n in deg_classes)


@dataclasses.dataclass(frozen=True)
class FwdLayout:
    """Static decode configuration plus the graph tables on one device, in
    the permuted (degree-sorted) edge order."""

    M: int
    N: int
    Z: int
    Zp: int  # Z rounded up to 8: the sampler's row layout n*Zp + z
    bt: int  # logical stream tile: word w is sampled in tile w // bt, column w % bt
    E: int
    n_iterations: int
    deg_classes: tuple[tuple[int, int], ...]
    clip_lo: float
    clip_hi: float
    qms_qbit: Optional[int]
    sum_product: bool
    has_cn_w: bool
    has_vn_w: bool
    has_ucn: bool
    hbm_store: bool  # True: the device-memory kernels (K3, K4); False: on-chip (K1, K2)
    # VN <-> edge routing: "roll" (K1-K4, exact index routing); K6's "int8"
    # (QMS) and "split3" (exact bf16 parts); an engine with routings of its
    # own (legacy.py) names them here and routes in its own plain version
    routing: str
    grad_f32: bool  # "int8": cotangents routed in f32 (routing_dtype float32), not bf16
    edge_perm: np.ndarray  # [E] new -> old
    route_idx: torch.Tensor  # [E*Z] VN copy feeding permuted flat edge k*Z + zc
    vn_gather: torch.Tensor  # [N*Z, max_vn_degree] flat edges in sum order, E*Z = pad
    tables: torch.Tensor  # int32 kernel tables (see csrc/fused_fwd.cu, csrc/fused_bwd.cu)

    @property
    def max_degree(self) -> int:
        return max(d for d, _ in self.deg_classes)

    @property
    def slots(self) -> int:
        """Store slots of the device-memory training forward: slot i-1 holds
        the state entering iteration i (``_fwd_run_hbm``'s ``max(I-1, 1)``)."""
        return max(self.n_iterations - 1, 1)

    @property
    def words_per_block(self) -> int:
        """Whole words per block of the forward kernel."""
        return _words_per_block(self.M * self.Z, _fwd_smem_per_word(self.M, self.N, self.Z, self.E))

    @property
    def bwd_words_per_block(self) -> int:
        """Whole words per block of the backward kernel (its larger shared
        state per word; one thread per lifted check as in the forward)."""
        return _words_per_block(self.M * self.Z, _bwd_smem_per_word(self.M, self.N, self.Z, self.E))

    @staticmethod
    def build(graph: TannerGraph, n_iterations: int, clip, qms_qbit,
              sum_product: bool, has_cn_w: bool, has_vn_w: bool, has_ucn: bool,
              device, bt: Optional[int] = None, hbm_store: bool = False,
              routing: str = "roll", grad_f32: bool = False,
              natural: bool = False) -> "FwdLayout":
        if routing not in _ROUTINGS:
            raise ValueError(f"unknown routing {routing!r}")
        edge_perm, deg_classes = build_layout(graph, natural=natural)
        Z, E, N, M = graph.Z, graph.E, graph.N, graph.M
        Zp = _round8(Z)
        if bt is None:
            # the JAX wrapper's decode rule (fused_train.py:2089)
            bt = 128 if E * Zp <= 2500 else 256
        if bt <= 0:
            raise ValueError(f"bt must be positive, got {bt}")
        vn_p = graph.vn_of_edge[edge_perm].astype(np.int64)
        sh_p = graph.shift_of_edge[edge_perm].astype(np.int64)
        zc = np.arange(Z)
        route = vn_p[:, None] * Z + (zc[None, :] + sh_p[:, None]) % Z
        # per VN: its permuted edges in increasing original edge id, the plain
        # decoder's sum order (``ops/flat.py``), so that the kernels' float
        # sums equal the plain engine's term for term
        vn_lists = [ks[np.argsort(edge_perm[ks], kind="stable")]
                    for ks in (np.nonzero(vn_p == n)[0] for n in range(N))]
        vn_ptr = np.zeros(N + 1, np.int64)
        np.cumsum([len(v) for v in vn_lists], out=vn_ptr[1:])
        maxdv = max(1, max(len(v) for v in vn_lists))
        vn_gather = np.full((N, Z, maxdv), E * Z, np.int64)
        for n, ks in enumerate(vn_lists):
            for j, k in enumerate(ks):
                vn_gather[n, :, j] = k * Z + (zc - sh_p[k]) % Z
        degs = np.concatenate([[d] * n for d, n in deg_classes]).astype(np.int64)
        chk_off = np.concatenate([[0], np.cumsum(degs)[:-1]])
        e_chk = np.repeat(np.arange(len(degs)), degs)  # sorted check of each edge
        tables = np.concatenate([
            chk_off, degs, vn_p, sh_p, vn_ptr,
            np.concatenate(vn_lists) if E else np.zeros(0, np.int64), e_chk,
        ]).astype(np.int32)
        return FwdLayout(
            M=M, N=N, Z=Z, Zp=Zp, bt=int(bt), E=E, n_iterations=n_iterations,
            deg_classes=deg_classes,
            clip_lo=float(clip[0]), clip_hi=float(clip[1]),
            qms_qbit=qms_qbit, sum_product=sum_product,
            has_cn_w=has_cn_w, has_vn_w=has_vn_w, has_ucn=has_ucn, hbm_store=hbm_store,
            routing=routing, grad_f32=bool(grad_f32), edge_perm=edge_perm,
            route_idx=torch.as_tensor(route.reshape(-1), device=device),
            vn_gather=torch.as_tensor(vn_gather.reshape(N * Z, maxdv), device=device),
            tables=torch.as_tensor(tables, device=device),
        )


_ROUTINGS = ("roll", "int8", "split3")


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel
# ---------------------------------------------------------------------------
def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split3(x: torch.Tensor):
    """x = hi + mid + lo exactly, each a bf16 value (``_split3_bf16``)."""
    hi = _bf16(x)
    r1 = x - hi
    mid = _bf16(r1)
    return hi, mid, _bf16(r1 - mid)


def _bf16_cotangents(lay: FwdLayout) -> bool:
    return lay.routing == "int8" and not lay.grad_f32


def int8_to_edges(x: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """The int8 routing product VN -> edges: rint(clip(x, +-2 q_hi) * scale)
    routed exactly, scaled back by the f32 reciprocal 1/scale."""
    _, q_hi, scale = _QMS_TABLE[lay.qms_qbit]
    t = 2.0 * q_hi
    return torch.round(torch.clamp(x, -t, t) * scale)[:, lay.route_idx] * (1.0 / scale)


def int8_to_vns(m: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """The int8 routing product edges -> VNs: rint(m * scale) summed exactly
    per VN copy, scaled back by 1/scale."""
    scale = _QMS_TABLE[lay.qms_qbit][2]
    return gather_sum(torch.round(m * scale), lay.vn_gather) * (1.0 / scale)


def _own_routing(lay: FwdLayout) -> None:
    if lay.routing not in _ROUTINGS:
        raise ValueError(f"routing {lay.routing!r} is routed by its own engine's plain version")


def route_to_edges(x: torch.Tensor, lay: FwdLayout, grad: bool = False) -> torch.Tensor:
    """VN-side values [B, N*Z] -> edge copies [B, E*Z] as the layout's
    routing product computes them (``_route_e_rows``): exact for roll and
    split-3; int8 routing quantizes values (``int8_to_edges``), its
    cotangents (``grad``) round to bf16 unless ``grad_f32``."""
    _own_routing(lay)
    if lay.routing == "int8" and not grad:
        return int8_to_edges(x, lay)
    if grad and _bf16_cotangents(lay):
        x = _bf16(x)
    return x[:, lay.route_idx]


def route_to_vns(m: torch.Tensor, lay: FwdLayout, grad: bool = False) -> torch.Tensor:
    """Edge copies [B, E*Z] -> per-VN-copy sums [B, N*Z] as the layout's
    routing product computes them (``_route_n_from_e``), each VN copy's
    terms added in the kernels' order: int8 routing sums exactly
    (``int8_to_vns``; cotangents: bf16 terms unless ``grad_f32``); split-3
    sums each bf16 part, (S_hi + S_mid) + S_lo; roll the terms as they are."""
    _own_routing(lay)
    if lay.routing == "int8" and not grad:
        return int8_to_vns(m, lay)
    if lay.routing == "split3":
        hi, mid, lo = (gather_sum(part, lay.vn_gather) for part in _split3(m))
        return (hi + mid) + lo
    if grad and _bf16_cotangents(lay):
        m = _bf16(m)
    return gather_sum(m, lay.vn_gather)


def _routed_negative(app: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """Per edge copy, whether the routed decision sign of ``app`` is
    negative.  K6's int8 routing routes the sign as a value (+-1 * scale,
    rounded: ``_ucn_mask_from_app``); every other routing routes it
    exactly."""
    dsign = torch.where(app < 0, -1.0, 1.0)
    if lay.routing == "int8":
        return route_to_edges(dsign, lay) < 0
    return dsign[:, lay.route_idx] < 0


def _clip_or_quant(x: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    if lay.qms_qbit is not None:
        return qms_quantize_value(x, lay.qms_qbit)
    return torch.clamp(x, lay.clip_lo, lay.clip_hi)


def _class_ranges(lay: FwdLayout):
    """(first message column, degree, n_checks) per degree class."""
    base = 0
    for d, n in lay.deg_classes:
        yield base, d, n
        base += d * n * lay.Z


def _prefix_suffix(xs, op, init):
    """Exclusive prefix and suffix folds over a list, left to right and
    right to left, as the kernel computes them."""
    d = len(xs)
    pre, suf = [None] * d, [None] * d
    acc = init
    for j in range(d):
        pre[j] = acc
        acc = op(acc, xs[j])
    acc = init
    for j in reversed(range(d)):
        suf[j] = acc
        acc = op(acc, xs[j])
    return pre, suf


def _check_update(seg: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """One degree class [B, n, d, Z] of v2c -> extrinsic c2v (same shape)."""
    d = seg.shape[2]
    cols = [seg[:, :, j] for j in range(d)]
    if lay.sum_product:
        t = [torch.tanh(0.5 * c) for c in cols]
        pre, suf = _prefix_suffix(t, torch.mul, torch.ones_like(t[0]))
        rows = []
        for j in range(d):
            ext = torch.clamp(pre[j] * suf[j], -1.0 + _SP_EPS, 1.0 - _SP_EPS)
            rows.append(torch.log((1.0 + ext) / (1.0 - ext)))
        return torch.stack(rows, dim=2)
    mag = [c.abs() for c in cols]
    sgn = [torch.where(c >= 0, 1.0, -1.0) for c in cols]
    pre, suf = _prefix_suffix(mag, torch.minimum, torch.full_like(mag[0], _BIG))
    total = sgn[0]
    for j in range(1, d):
        total = total * sgn[j]
    return torch.stack(
        [torch.minimum(pre[j], suf[j]) * (total * sgn[j]) for j in range(d)], dim=2)


def _ucn_mask(app: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """Per permuted flat edge: 1 where the lifted check's routed decision
    signs have odd parity."""
    B = app.shape[0]
    s = torch.where(_routed_negative(app, lay), -1.0, 1.0)
    parts = []
    for base, d, n in _class_ranges(lay):
        seg = s[:, base:base + d * n * lay.Z].reshape(B, n, d, lay.Z)
        parity = seg[:, :, 0]
        for j in range(1, d):
            parity = parity * seg[:, :, j]
        u = torch.where(parity < 0, 1.0, 0.0)
        parts.append(u[:, :, None, :].expand(B, n, d, lay.Z).reshape(B, -1))
    return torch.cat(parts, dim=1)


def _chan_out(chan: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """The APP's channel term: the QMS-quantized channel, or the channel."""
    return qms_quantize_value(chan, lay.qms_qbit) if lay.qms_qbit is not None else chan


def _fwd_iteration(chan, chan_out, lay: FwdLayout, cnw, ucnw, vnw, i: int, msg, sums,
                   route=None):
    """Iteration ``i`` of the forward, as both kernel families compute it:
    from the message state [B, E*Z] and VN sums [B, N*Z] entering it (zeros
    at i = 0), the ones it leaves.  ``route`` is the (VN -> edges, edges ->
    VNs) pair, ``route_to_edges`` / ``route_to_vns`` by default."""
    to_edges, to_vns = route or (route_to_edges, route_to_vns)
    B, Z = chan.shape[0], lay.Z
    if vnw is not None:
        xa = chan * torch.repeat_interleave(vnw[i], Z)[None]
        xa_q = qms_quantize_value(xa, lay.qms_qbit) if lay.qms_qbit is not None else xa
    else:
        xa_q = chan_out
    if lay.has_ucn:
        app = xa_q if i == 0 else torch.clamp(chan_out + sums, lay.clip_lo, lay.clip_hi)
        u = _ucn_mask(app, lay)
    v2c = _clip_or_quant(to_edges(xa_q + sums, lay) - msg, lay)
    parts = []
    for base, d, n in _class_ranges(lay):
        seg = v2c[:, base:base + d * n * Z].reshape(B, n, d, Z)
        parts.append(_check_update(seg, lay).reshape(B, -1))
    c2v = torch.cat(parts, dim=1)
    w_mag = c2v.abs()
    if lay.has_ucn:
        cw = torch.repeat_interleave(cnw[i], Z)[None]
        uw = torch.repeat_interleave(ucnw[i], Z)[None]
        w_mag = w_mag * (cw * (1.0 - u) + uw * u)
    elif lay.has_cn_w:
        w_mag = w_mag * torch.repeat_interleave(cnw[i], Z)[None]
    w_mag = _clip_or_quant(torch.clamp_min(w_mag, 0.0), lay)
    msg = w_mag * torch.sign(c2v)
    return msg, to_vns(msg, lay)  # the kernels' VN sum order


def _fwd_plain(chan: torch.Tensor, lay: FwdLayout, cnw, ucnw, vnw, stream: bool, store: bool,
               route=None):
    """The on-chip forward kernel's algorithm, the state carried in
    registers: (pre-clip APP [B, N*Z] of the last iteration, or of every
    iteration [I, B, N*Z] with ``stream``; with ``store`` the message state
    entering every iteration [I, B, E*Z]).  ``route`` as ``_fwd_iteration``."""
    B, Z = chan.shape[0], lay.Z
    chan_out = _chan_out(chan, lay)
    msg = chan.new_zeros(B, lay.E * Z)
    sums = chan.new_zeros(B, lay.N * Z)
    outs, stored = [], []
    for i in range(lay.n_iterations):
        if store:
            stored.append(msg)
        msg, sums = _fwd_iteration(chan, chan_out, lay, cnw, ucnw, vnw, i, msg, sums, route)
        if stream:
            outs.append(chan_out + sums)
    out = torch.stack(outs) if stream else chan_out + sums
    return out, (torch.stack(stored) if store else None)


def fused_fwd_dm_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                       ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                       stream: bool = False, store: bool = False):
    """Plain version of K3 (``csrc/fused_fwd_dm.cu``), the state carried
    through device-memory slots: with ``store`` (training, needs ``stream``)
    ``lay.slots`` = max(I-1, 1) slots, slot i-1 holding the state entering
    iteration i and iteration 0 reading zeros; the last iteration's messages
    are never stored.  Without ``store``, one slot read and rewritten every
    iteration.  Returns (pre-clip APP [B, N*Z] of the last iteration, or of
    every iteration [I, B, N*Z] with ``stream``; the slots [max(I-1, 1), B,
    E*Z] with ``store``, else None)."""
    if store and not stream:
        raise ValueError("the store is the training forward's: it needs the stream")
    B, I, EZ = chan.shape[0], lay.n_iterations, lay.E * lay.Z
    chan_out = _chan_out(chan, lay)
    slots = chan.new_zeros(lay.slots if store else 1, B, EZ)
    sums = chan.new_zeros(B, lay.N * lay.Z)
    outs = []
    for i in range(I):
        entering = chan.new_zeros(B, EZ) if i == 0 else slots[i - 1 if store else 0]
        msg, sums = _fwd_iteration(chan, chan_out, lay, cnw, ucnw, vnw, i, entering, sums)
        if not store:
            slots[0] = msg
        elif i < I - 1:
            slots[i] = msg
        if stream:
            outs.append(chan_out + sums)
    out = torch.stack(outs) if stream else chan_out + sums
    return out, (slots if store else None)


def fused_fwd_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                    ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel: chan [B, N*Z] -> pre-clip final
    APP [B, N*Z].  Weights are [I, E] in permuted edge order and [I, N]."""
    return _fwd_plain(chan, lay, cnw, ucnw, vnw, stream=False, store=False)[0]


def fused_fwd_train_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                          ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                          store: bool = True):
    """Plain version of K1d: (pre-clip APP of every iteration [I, B, N*Z],
    the message state entering every iteration [I, B, E*Z] in the permuted
    flat-edge order ``k*Z + zc``, slot 0 zeros; None without ``store``)."""
    return _fwd_plain(chan, lay, cnw, ucnw, vnw, stream=True, store=store)


def _msg_range(lay: FwdLayout):
    """The range the messages are clipped or quantized to."""
    if lay.qms_qbit is not None:
        lo, hi, _ = _QMS_TABLE[lay.qms_qbit]
        return lo, hi
    return lay.clip_lo, lay.clip_hi


def _clip_mask(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Gradient of ``min(max(x, lo), hi)`` with JAX's ties: 1 inside, 0.5 at
    either bound, 0 outside (``_clip_grad_mask``)."""
    gmax = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
    y = torch.clamp_min(x, lo)
    gmin = torch.where(y < hi, 1.0, torch.where(y == hi, 0.5, 0.0))
    return gmax * gmin


def _relu_mask(x: torch.Tensor) -> torch.Tensor:
    """Gradient of ``max(x, 0)``: 0.5 at 0."""
    return torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0))


def _minsum_adjoint(seg: torch.Tensor, post):
    """One degree class [B, n, d, Z] of v2c: recompute the extrinsic two-min
    and backpropagate through it (``_cn_minsum_fwd_bwd_one``).  ``post(c2v)``
    is the post-chain adjoint and returns the cotangent of |c2v|; the result
    is the cotangent of v2c."""
    d = seg.shape[2]
    mag = [seg[:, :, j].abs() for j in range(d)]
    sgn = [torch.where(seg[:, :, j] >= 0, 1.0, -1.0) for j in range(d)]
    pre, suf = _prefix_suffix(mag, torch.minimum, torch.full_like(mag[0], _BIG))
    m1 = torch.minimum(pre[d - 1], mag[d - 1])
    total = sgn[0]
    for j in range(1, d):
        total = total * sgn[j]
    # first-occurrence argmin, then the second minimum over the others
    f = [(mag[j] == m1) & (pre[j] > m1) for j in range(d)]
    masked = [torch.where(f[j], _BIG, mag[j]) for j in range(d)]
    m2 = masked[0]
    for j in range(1, d):
        m2 = torch.minimum(m2, masked[j])
    c2v = torch.stack([torch.where(f[j], m2, torch.minimum(pre[j], suf[j])) * (total * sgn[j])
                       for j in range(d)], dim=2)
    ge = post(c2v)
    g_m1 = torch.zeros_like(m1)
    g_m2 = torch.zeros_like(m1)
    c1 = torch.zeros_like(m1)
    c2 = torch.zeros_like(m1)
    for j in range(d):
        g_m1 = g_m1 + torch.where(f[j], 0.0, ge[:, :, j])
        g_m2 = g_m2 + torch.where(f[j], ge[:, :, j], 0.0)
        c1 = c1 + (mag[j] == m1).to(m1.dtype)
        c2 = c2 + (masked[j] == m2).to(m1.dtype)
    g1 = g_m1 / c1
    g2 = g_m2 / torch.clamp_min(c2, 1.0)
    rows = []
    for j in range(d):
        g_mag = torch.where(mag[j] == m1, g1, 0.0) + torch.where(masked[j] == m2, g2, 0.0)
        rows.append(g_mag * torch.where(mag[j] == 0, 1.0, sgn[j]))  # |v| has gradient +1 at 0
    return torch.stack(rows, dim=2)


def _sumproduct_adjoint(seg: torch.Tensor, post):
    """One degree class of v2c through the sum-product check update and
    back (``_cn_sumproduct_fwd_bwd_one``): 2/(1 - extc^2), the clip mask at
    +-(1 - 1e-7), then the prefix and suffix chains in reverse."""
    d = seg.shape[2]
    t = [torch.tanh(0.5 * seg[:, :, j]) for j in range(d)]
    pre, suf = _prefix_suffix(t, torch.mul, torch.ones_like(t[0]))
    lo_c, hi_c = -1.0 + _SP_EPS, 1.0 - _SP_EPS
    ext = [pre[j] * suf[j] for j in range(d)]
    extc = [torch.clamp(e, lo_c, hi_c) for e in ext]
    out = torch.stack([torch.log((1.0 + e) / (1.0 - e)) for e in extc], dim=2)
    ge = post(out)
    g_pre, g_suf = [None] * d, [None] * d
    for j in range(d):
        o = out[:, :, j]
        g_out = ge[:, :, j] * torch.where(o == 0, 1.0, torch.sign(o))
        g_ext = g_out * 2.0 / (1.0 - extc[j] * extc[j]) * _clip_mask(ext[j], lo_c, hi_c)
        g_pre[j] = g_ext * suf[j]
        g_suf[j] = g_ext * pre[j]
    g_t = [torch.zeros_like(t[0]) for _ in range(d)]
    c = g_pre[d - 1]
    for j in range(d - 1, 0, -1):  # pre[j] = pre[j-1] * t[j-1]
        g_t[j - 1] = g_t[j - 1] + c * pre[j - 1]
        c = g_pre[j - 1] + c * t[j - 1]
    c = g_suf[0]
    for j in range(d - 1):  # suf[j] = suf[j+1] * t[j+1]
        g_t[j + 1] = g_t[j + 1] + c * suf[j + 1]
        c = g_suf[j + 1] + c * t[j + 1]
    return torch.stack([g_t[j] * 0.5 * (1.0 - t[j] * t[j]) for j in range(d)], dim=2)


def fused_bwd_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                    ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                    store: torch.Tensor, outs: torch.Tensor, g_outs: torch.Tensor):
    """Plain version of K2, the kernel's own reverse pass step by step (not
    autograd).  chan [B, N*Z]; store [I, B, E*Z] from K1d; outs and g_outs
    [I, B, N*Z] (the pre-clip APP and its cotangent).  Returns (g_cnw [I, E]
    permuted order, g_vnw [I, N], g_ucnw [I, E], g_chan [B, N*Z], g_chanq
    [B, N*Z]); each weight gradient is None where the layout has no such
    weight, g_chanq None without QMS (its terms then land in g_chan)."""
    return _bwd_plain(chan, lay, cnw, ucnw, vnw, lambda i: store[i], outs, g_outs)


def fused_bwd_dm_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                       ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                       store: torch.Tensor, outs: torch.Tensor, g_outs: torch.Tensor):
    """Plain version of K4 (``csrc/fused_bwd_dm.cu``): K2's reverse pass on
    K3's store [max(I-1, 1), B, E*Z], whose slot i-1 holds the state
    entering iteration i (zeros at i = 0).  Per iteration, pass 1 rebuilds
    sums_{i-1} from that slot in the forward's order and pass 2 recomputes
    the forward and takes its adjoint, the message cotangent carried in a
    [B, E*Z] tensor.  Returns what ``fused_bwd_plain`` returns."""
    zeros = chan.new_zeros(chan.shape[0], lay.E * lay.Z)
    return _bwd_plain(chan, lay, cnw, ucnw, vnw,
                      lambda i: zeros if i == 0 else store[i - 1], outs, g_outs)


def _bwd_plain(chan, lay: FwdLayout, cnw, ucnw, vnw, entering, outs, g_outs):
    """The reverse pass of both kernel families; ``entering(i)`` is the
    message state entering iteration i."""
    B, Z, I, E, N = chan.shape[0], lay.Z, lay.n_iterations, lay.E, lay.N
    qms = lay.qms_qbit is not None
    chan_out = _chan_out(chan, lay)
    lo_m, hi_m = _msg_range(lay)
    weighted = lay.has_cn_w or lay.has_ucn
    g_cnw = chan.new_zeros(I, E) if weighted else None
    g_ucnw = chan.new_zeros(I, E) if lay.has_ucn else None
    g_vnw = chan.new_zeros(I, N) if vnw is not None else None
    g_chan = torch.zeros_like(chan)
    g_chanq = torch.zeros_like(chan) if qms else None
    gq = g_chanq if qms else g_chan  # the cotangent of chan_out
    g_msg = chan.new_zeros(B, E * Z)
    g_sums = torch.zeros_like(chan)
    for i in reversed(range(I)):
        msg_prev = entering(i)
        sums_prev = route_to_vns(msg_prev, lay)  # the forward's phase-B order
        if vnw is not None:
            vw = torch.repeat_interleave(vnw[i], Z)[None]
            xa = chan * vw
            xa_q = qms_quantize_value(xa, lay.qms_qbit) if qms else xa
        else:
            xa_q = chan_out
        if lay.has_ucn:
            # the pre-clip APP of iteration i-1, clipped here; xa_q at i = 0
            app = xa_q if i == 0 else torch.clamp(outs[i - 1], lay.clip_lo, lay.clip_hi)
            u = _ucn_mask(app, lay)
        g_sums_total = g_sums + g_outs[i]  # out_i = chan_out + sums_i
        g_msg_all = g_msg + route_to_edges(g_sums_total, lay, grad=True)  # sums_i = R msg_i
        vn_total = xa_q + sums_prev
        v2c_pre = route_to_edges(vn_total, lay) - msg_prev
        v2c = _clip_or_quant(v2c_pre, lay)
        mask_v2c = _clip_mask(v2c_pre, lo_m, hi_m)
        if lay.routing == "int8":
            # the routed total was pre-clipped at +-2 q_hi: a saturated one sits
            # on the quantizer's bound, where the true clip mask is 0 (:1392-1439)
            t = 2.0 * _QMS_TABLE[lay.qms_qbit][1]
            sat = (torch.where(vn_total > t, 1.0, 0.0)
                   - torch.where(vn_total < -t, 1.0, 0.0))[:, lay.route_idx]
            mask_v2c = torch.where(((sat > 0) & (v2c_pre == hi_m)) | ((sat < 0) & (v2c_pre == lo_m)),
                                   0.0, mask_v2c)
        parts = []
        for base, d, n in _class_ranges(lay):
            sl = slice(base, base + d * n * Z)
            e0, ne = base // Z, d * n
            gm = g_msg_all[:, sl].reshape(B, n, d, Z)
            if weighted:
                w_cn = cnw[i, e0:e0 + ne].reshape(1, n, d, 1)
            if lay.has_ucn:
                uc = u[:, sl].reshape(B, n, d, Z)
                w_eff = w_cn * (1.0 - uc) + ucnw[i, e0:e0 + ne].reshape(1, n, d, 1) * uc

            def post(c2v, gm=gm, e0=e0, ne=ne):
                # msg = Q(relu(|c2v| * w)) * sign(c2v); sign() has no gradient
                mag = c2v.abs()
                we = w_eff if lay.has_ucn else (w_cn if weighted else None)
                wm_pre = mag * we if we is not None else mag
                g_wm_q = gm * torch.sign(c2v)
                g_wm_pre = (g_wm_q * _clip_mask(torch.clamp_min(wm_pre, 0.0), lo_m, hi_m)
                            * _relu_mask(wm_pre))
                g_w = g_wm_pre * mag
                if lay.has_ucn:
                    g_cnw[i, e0:e0 + ne] = (g_w * (1.0 - uc)).sum(dim=(0, 3)).reshape(-1)
                    g_ucnw[i, e0:e0 + ne] = (g_w * uc).sum(dim=(0, 3)).reshape(-1)
                elif weighted:
                    g_cnw[i, e0:e0 + ne] = g_w.sum(dim=(0, 3)).reshape(-1)
                return g_wm_pre * we if we is not None else g_wm_pre

            seg = v2c[:, sl].reshape(B, n, d, Z)
            adjoint = _sumproduct_adjoint if lay.sum_product else _minsum_adjoint
            parts.append(adjoint(seg, post).reshape(B, -1))
        g_v2c_pre = torch.cat(parts, dim=1) * mask_v2c
        g_msg = -g_v2c_pre  # v2c_pre = routed - msg_{i-1}
        g_sums = route_to_vns(g_v2c_pre, lay, grad=True)  # g_T: the cotangent of sums_{i-1}
        gq += g_outs[i]
        if vnw is not None:
            g_xa = g_sums * _clip_mask(xa, *_QMS_TABLE[lay.qms_qbit][:2]) if qms else g_sums
            g_vnw[i] = (g_xa * chan).reshape(B, N, Z).sum(dim=(0, 2))
            g_chan += g_xa * vw
        else:
            gq += g_sums  # xa_q is chan_out
    return g_cnw, g_vnw, g_ucnw, g_chan, g_chanq


def syndrome_ok_plain(app: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """Plain version of the K1b syndrome: per word [B] bool, True where
    every lifted check has an even number of routed decisions APP < 0
    (``_syndrome_ok_lanes``)."""
    B, Z = app.shape[0], lay.Z
    neg = _routed_negative(app, lay).to(torch.int32)
    ok = torch.ones(B, dtype=torch.bool, device=app.device)
    for base, d, n in _class_ranges(lay):
        seg = neg[:, base:base + d * n * Z].reshape(B, n, d, Z)
        ok &= (seg.sum(dim=2) % 2 == 0).reshape(B, -1).all(dim=1)
    return ok


def stats_plain(app: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """Plain version of the K1b stats epilogue: pre-clip APP [B, N*Z] ->
    int32 [B, 3] (ok, bit errors = APP < 0, frame error) per all-zero word
    (``_stats_rows``)."""
    bit_errors = (app < 0).sum(dim=1, dtype=torch.int32)
    return torch.stack([syndrome_ok_plain(app, lay).to(torch.int32), bit_errors,
                        (bit_errors > 0).to(torch.int32)], dim=1)


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """lowbias32 on uint32 values held in int64 (``fused_train.py:912-917``).
    A product of two 32-bit values may wrap modulo 2^64, which keeps its low
    32 bits right."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _M32
    return h ^ (h >> 16)


def unit_uniforms(i: torch.Tensor, draw: int, key: torch.Tensor) -> torch.Tensor:
    """The sampler's 24-bit uniforms in [0, 1) of counters ``i`` under
    ``key`` (int64 tensors holding uint32 values; ``fused_train.py:919-925``)."""
    h = _mix32(((i * 2 + draw) & _M32) ^ key)
    h = _mix32(h ^ ((key * 0x9E3779B9) & _M32))
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def sample_channel_plain(lay: FwdLayout, seed: int, sigma: float, words: torch.Tensor,
                         bt: Optional[int] = None) -> torch.Tensor:
    """Plain version of the K1c sampler: the channel LLRs [B, N*Z] of the
    all-zero words at original batch indices ``words`` [B] under the int32
    ``seed``, noise std ``sigma`` and stream tile ``bt`` (default
    ``lay.bt``), on ``words``' device."""
    bt = lay.bt if bt is None else int(bt)
    dev, Z, Zp = words.device, lay.Z, lay.Zp
    w = words.to(torch.int64) & _M32
    key = (int(seed) & _M32) ^ (((w // bt) * 2654435761) & _M32)
    q = torch.arange(lay.N * Z, device=dev)
    row = (q // Z) * Zp + q % Z
    half = _round8(-(-(lay.N * Zp) // 2))
    second = row >= half
    pair = torch.where(second, row - half, row)
    i = (pair[None, :] * bt + (w % bt)[:, None]) & _M32
    u1 = unit_uniforms(i, 0, key[:, None])
    u2 = unit_uniforms(i, 1, key[:, None])
    r = torch.sqrt(-2.0 * torch.log(1.0 - u1))
    theta = (2.0 * math.pi) * u2
    g = torch.where(second[None, :], torch.sin(theta), torch.cos(theta))
    s = np.float32(sigma)
    base, scale = float(np.float32(2.0) / (s * s)), float(np.float32(2.0) / s)
    return base + scale * (r * g)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
# source name -> (C entry point, pointer, int and float arguments before the
# stream; after the stream each takes an int* to which it adds the CUDA
# kernels it launched)
_ENTRY_POINTS = {
    "fused_fwd": ("fused_fwd_launch", 10, 12, 6),
    "fused_bwd": ("fused_bwd_launch", 13, 9, 5),
    "fused_fwd_dm": ("fused_fwd_dm_launch", 10, 8, 5),
    "fused_bwd_dm": ("fused_bwd_dm_launch", 18, 9, 5),
    "fused_legacy": ("fused_legacy_launch", 6, 10, 5),
    "sol_probe": ("sol_launch", 2, 1, 0),
}


def _kernel_fn(source: str):
    """The C entry point of ``csrc/<source>.cu``, built at first use."""
    from . import _build

    symbol, n_ptr, n_int, n_float = _ENTRY_POINTS[source]
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = ([vp] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float] * n_float
                       + [vp, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    return fn


def _call_kernel(source: str, what: str, *args) -> int:
    """Calls the C entry point of ``csrc/<source>.cu`` with ``args`` (the
    stream last); raises if it fails.  Returns the number of CUDA kernels
    the entry point launched, as it counted them."""
    launched = ctypes.c_int(0)
    err = _kernel_fn(source)(*args, ctypes.byref(launched))
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")
    return launched.value


def _check_f32(t, shape, device, name):
    """``t`` made contiguous, or None for None; raises unless it is float32
    of ``shape`` on ``device``."""
    if t is None:
        return None
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected float32 {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _check_weights(lay: FwdLayout, dev, cnw, ucnw, vnw):
    I = lay.n_iterations
    cnw = _check_f32(cnw, (I, lay.E), dev, "cnw")
    ucnw = _check_f32(ucnw, (I, lay.E), dev, "ucnw")
    vnw = _check_f32(vnw, (I, lay.N), dev, "vnw")
    if (lay.has_cn_w or lay.has_ucn) and cnw is None:
        raise ValueError("cnw is required for CN/UCN weighting")
    if lay.has_ucn and ucnw is None:
        raise ValueError("ucnw is required for UCN weighting")
    if lay.has_vn_w and vnw is None:
        raise ValueError("vnw is required for VN weighting")
    return cnw, ucnw, vnw


def _check_chan(chan: torch.Tensor, lay: FwdLayout) -> None:
    NZ = lay.N * lay.Z
    if chan.dim() != 2 or chan.shape[1] != NZ or chan.dtype != torch.float32:
        raise ValueError(f"chan: expected float32 [B, {NZ}], got {chan.dtype} {tuple(chan.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _mode_flags(lay: FwdLayout) -> int:
    return ((_F_QMS if lay.qms_qbit is not None else 0)
            | (_F_SP if lay.sum_product else 0)
            | (_F_CNW if lay.has_cn_w or lay.has_ucn else 0)
            | (_F_UCN if lay.has_ucn else 0)
            | (_F_VNW if lay.has_vn_w else 0))


def _check_launchable(lay: FwdLayout, dev, on_chip: bool = True, matmul: bool = False) -> None:
    """Raises unless the on-chip kernels (``on_chip``) or the device-memory
    kernels can run ``lay`` on the CUDA device ``dev``, with roll routing
    (K1-K4) or, with ``matmul``, K6's."""
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if (lay.routing in ("int8", "split3")) != matmul:
        raise ValueError(f"a layout with {lay.routing!r} routing does not run on "
                         f"{'K6' if matmul else 'the roll-routed kernels'}")
    if lay.tables.device != dev:
        raise ValueError(f"layout tables live on {lay.tables.device}, the batch on {dev}")
    if lay.max_degree > _MAX_CHECK_DEGREE:
        raise ValueError(f"check degree {lay.max_degree} exceeds the kernels' limit of "
                         f"{_MAX_CHECK_DEGREE}")
    if on_chip and not _fits_on_chip(lay.M, lay.N, lay.Z, lay.E, lay.max_degree):
        raise ValueError(
            f"the code (M*Z = {lay.M * lay.Z} lifted checks) does not fit the on-chip "
            "kernels; build the decoder with store_space='hbm' or 'auto' for the "
            "device-memory kernels (K3, K4)")


def _qms_args(lay: FwdLayout):
    return _QMS_TABLE[lay.qms_qbit] if lay.qms_qbit is not None else (0.0, 0.0, 1.0)


def _route_flags(lay: FwdLayout) -> int:
    """K6's routing bits of the on-chip kernels' flags."""
    return {"int8": _F_ROUTE_INT8 | (_F_GRAD_F32 if lay.grad_f32 else 0),
            "split3": _F_ROUTE_SPLIT3}.get(lay.routing, 0)


def _launch(lay: FwdLayout, dev, B: int, weights, flags: int, *, chan=None, out=None,
            store=None, stats=None, chan_emit=None, widx=None, seed=0, sigma=1.0,
            bt=0, matmul=False) -> int:
    """One launch of ``csrc/fused_fwd.cu`` on CUDA tensors (K1, or K6 with
    ``matmul``); raises if the kernel cannot take the configuration or the
    launch fails.  Returns the CUDA launches made (one)."""
    _check_launchable(lay, dev, matmul=matmul)
    flags |= _mode_flags(lay) | _route_flags(lay)
    q_lo, q_hi, q_scale = _qms_args(lay)
    ptr = _ptr
    return _call_kernel(
        "fused_fwd", f"fused_fwd launch (flags {flags})",
        ptr(chan), ptr(out), ptr(store), ptr(stats), ptr(chan_emit), ptr(widx), ptr(lay.tables),
        *(ptr(w) for w in weights),
        B, lay.N, lay.M, lay.Z, lay.E, lay.n_iterations, lay.max_degree,
        lay.words_per_block, flags, lay.Zp, bt, kernel_seed(int(seed)), float(sigma),
        lay.clip_lo, lay.clip_hi, q_lo, q_hi, q_scale,
        torch.cuda.current_stream(dev).cuda_stream,
    )


def fused_fwd_k1a(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
                  ucnw: Optional[torch.Tensor] = None,
                  vnw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final-iteration pre-clip APP [B, N*Z] from channel LLRs [B, N*Z].

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs ``fused_fwd_plain``.  ``fused_fwd_k1a.launches`` counts
    kernel launches."""
    _check_chan(chan, lay)
    w = _check_weights(lay, chan.device, cnw, ucnw, vnw)
    if chan.device.type == "cpu":
        return fused_fwd_plain(chan, lay, *w)
    chan = chan.contiguous()
    out = torch.empty_like(chan)
    fused_fwd_k1a.cuda_launches += _launch(lay, chan.device, chan.shape[0], w, 0, chan=chan,
                                           out=out)
    fused_fwd_k1a.launches += 1
    return out


def fused_fwd_k1b(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
                  ucnw: Optional[torch.Tensor] = None, vnw: Optional[torch.Tensor] = None,
                  emit_app: bool = False):
    """Per-word stats int32 [B, 3] (ok, bit errors, frame error; all-zero
    words) from channel LLRs [B, N*Z]; with ``emit_app`` the syndrome mode,
    ``(pre-clip APP [B, N*Z], stats)``.

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs ``fused_fwd_plain`` and ``stats_plain``.
    ``fused_fwd_k1b.launches`` counts kernel launches."""
    _check_chan(chan, lay)
    w = _check_weights(lay, chan.device, cnw, ucnw, vnw)
    if chan.device.type == "cpu":
        app = fused_fwd_plain(chan, lay, *w)
        st = stats_plain(app, lay)
        return (app, st) if emit_app else st
    chan = chan.contiguous()
    stats = torch.empty(chan.shape[0], 3, dtype=torch.int32, device=chan.device)
    out = torch.empty_like(chan) if emit_app else None
    fused_fwd_k1b.cuda_launches += _launch(
        lay, chan.device, chan.shape[0], w, _F_SYNDROME if emit_app else _F_STATS,
        chan=chan, out=out, stats=stats)
    fused_fwd_k1b.launches += 1
    return (out, stats) if emit_app else stats


def fused_fwd_k1c(lay: FwdLayout, cnw: Optional[torch.Tensor], ucnw: Optional[torch.Tensor],
                  vnw: Optional[torch.Tensor], seed: int, sigma: float, *,
                  batch: Optional[int] = None, widx: Optional[torch.Tensor] = None,
                  stream_bt: Optional[int] = None, emit_chan: bool = False):
    """Per-word stats int32 [B, 3] of all-zero words whose channel the
    kernel samples: the ``batch`` words 0..B-1, or the words at original
    batch indices ``widx`` [B] int32.  ``seed`` is the int32 stream key,
    ``stream_bt`` the stream tile (default ``lay.bt``; a power of two with
    ``widx``).  With ``emit_chan`` also the sampled channel:
    ``(stats, chan [B, N*Z])``.

    Runs on the layout's device: CUDA launches the kernel (and raises if it
    cannot); the CPU runs ``sample_channel_plain``, ``fused_fwd_plain`` and
    ``stats_plain``.  ``fused_fwd_k1c.launches`` counts kernel launches."""
    dev, B, bt = _sampling_batch(lay, batch, widx, stream_bt, emit_chan)
    w = _check_weights(lay, dev, cnw, ucnw, vnw)
    if dev.type == "cpu":
        return _sampled_plain(lay, w, seed, sigma, B, widx, bt, emit_chan)
    stats, chan_emit, n = _sampled_launch(lay, w, seed, sigma, B, widx, bt, emit_chan, False)
    fused_fwd_k1c.cuda_launches += n
    fused_fwd_k1c.launches += 1
    return (stats, chan_emit) if emit_chan else stats


def _sampling_batch(lay: FwdLayout, batch, widx, stream_bt, emit_chan):
    """(device, words, stream tile) of a sampling launch; raises on
    arguments the sampler does not take."""
    dev = lay.tables.device
    bt = lay.bt if stream_bt is None else int(stream_bt)
    if (batch is None) == (widx is None):
        raise ValueError("give exactly one of batch and widx")
    if widx is None:
        return dev, int(batch), bt
    if emit_chan:
        raise ValueError("sample_at_idx and emit_chan are exclusive")
    if bt <= 0 or bt & (bt - 1):
        raise ValueError(f"index mode needs a power-of-two stream tile, got {bt}")
    if widx.dim() != 1 or widx.dtype != torch.int32:
        raise ValueError(f"widx: expected int32 [K], got {widx.dtype} {tuple(widx.shape)}")
    check_same_device(widx, dev, "widx")
    return dev, widx.shape[0], bt


def _sampled_plain(lay: FwdLayout, w, seed, sigma, B, widx, bt, emit_chan):
    words = torch.arange(B) if widx is None else widx
    chan = sample_channel_plain(lay, seed, sigma, words, bt)
    st = stats_plain(fused_fwd_plain(chan, lay, *w), lay)
    return (st, chan) if emit_chan else st


def _sampled_launch(lay: FwdLayout, w, seed, sigma, B, widx, bt, emit_chan, matmul):
    """One sampling launch (K1c, or K6 with ``matmul``): (stats, sampled
    channel or None, CUDA launches made)."""
    dev = lay.tables.device
    stats = torch.empty(B, 3, dtype=torch.int32, device=dev)
    chan_emit = torch.empty(B, lay.N * lay.Z, device=dev) if emit_chan else None
    flags = (_F_STATS | _F_SAMPLE | (_F_EMIT_CHAN if emit_chan else 0)
             | (_F_AT_IDX if widx is not None else 0))
    n = _launch(lay, dev, B, w, flags, stats=stats, chan_emit=chan_emit,
                widx=None if widx is None else widx.contiguous(), seed=seed, sigma=sigma, bt=bt,
                matmul=matmul)
    return stats, chan_emit, n


def fused_fwd_k1d(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
                  ucnw: Optional[torch.Tensor] = None, vnw: Optional[torch.Tensor] = None,
                  store: bool = True):
    """The training forward: ``(outs [I, B, N*Z], store [I, B, E*Z] or
    None)``, the pre-clip APP of every iteration and, with ``store``, the
    message state entering every iteration (slot 0 zeros) in the permuted
    flat-edge order ``k*Z + zc``.

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs ``fused_fwd_train_plain``.  ``fused_fwd_k1d.launches``
    counts kernel launches."""
    _check_chan(chan, lay)
    w = _check_weights(lay, chan.device, cnw, ucnw, vnw)
    if chan.device.type == "cpu":
        return fused_fwd_train_plain(chan, lay, *w, store=store)
    chan = chan.contiguous()
    B, I = chan.shape[0], lay.n_iterations
    outs = torch.empty(I, B, lay.N * lay.Z, device=chan.device)
    st = torch.empty(I, B, lay.E * lay.Z, device=chan.device) if store else None
    fused_fwd_k1d.cuda_launches += _launch(lay, chan.device, B, w,
                                           _F_STREAM | (_F_STORE if store else 0),
                                           chan=chan, out=outs, store=st)
    fused_fwd_k1d.launches += 1
    return outs, st


def fused_bwd_k2(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                 ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                 store: torch.Tensor, outs: torch.Tensor, g_outs: torch.Tensor):
    """The reverse-iteration adjoint of ``fused_fwd_k1d``: from the channel
    [B, N*Z], the store [I, B, E*Z], the pre-clip outputs and their
    cotangents [I, B, N*Z], ``(g_cnw [I, E] in permuted order, g_vnw [I, N],
    g_ucnw [I, E], g_chan [B, N*Z], g_chanq [B, N*Z])``; a weight gradient is
    None where the layout has no such weight, and g_chanq None without QMS
    (its terms then land in g_chan).  The quantized channel ``chan_out`` is
    recomputed from ``chan``, as the forward kernel computes it.

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs ``fused_bwd_plain``.  ``fused_bwd_k2.launches`` counts
    kernel launches.  The kernel writes one weight-gradient partial per
    block and the partials are summed here, in a fixed order."""
    _check_chan(chan, lay)
    dev, (B, NZ), I = chan.device, chan.shape, lay.n_iterations
    w = _check_weights(lay, dev, cnw, ucnw, vnw)
    store = _check_f32(store, (I, B, lay.E * lay.Z), dev, "store")
    outs = _check_f32(outs, (I, B, NZ), dev, "outs")
    g_outs = _check_f32(g_outs, (I, B, NZ), dev, "g_outs")
    if dev.type == "cpu":
        return fused_bwd_plain(chan, lay, *w, store, outs, g_outs)
    grads, n = _bwd_launch(chan, lay, w, store, outs, g_outs, matmul=False)
    fused_bwd_k2.cuda_launches += n
    fused_bwd_k2.launches += 1
    return grads


def _bwd_launch(chan, lay: FwdLayout, w, store, outs, g_outs, matmul: bool):
    """One launch of ``csrc/fused_bwd.cu`` (K2, or K6 with ``matmul``) on
    CUDA tensors: (the gradients, CUDA launches made)."""
    dev, B = chan.device, chan.shape[0]
    _check_launchable(lay, dev, matmul=matmul)
    chan = chan.contiguous()
    wpb = lay.bwd_words_per_block
    g_chan = torch.empty_like(chan)
    g_chanq = torch.empty_like(chan) if lay.qms_qbit is not None else None
    part = _weight_partials(lay, -(-B // wpb), dev)
    n = _call_kernel(
        "fused_bwd", "fused_bwd launch",
        _ptr(chan), _ptr(store), _ptr(outs), _ptr(g_outs), _ptr(lay.tables),
        *(_ptr(t) for t in w), _ptr(g_chan), _ptr(g_chanq),
        _ptr(part["cn"]), _ptr(part["ucn"]), _ptr(part["vn"]),
        B, lay.N, lay.M, lay.Z, lay.E, lay.n_iterations, lay.max_degree, wpb,
        _mode_flags(lay) | _route_flags(lay),
        lay.clip_lo, lay.clip_hi, *_qms_args(lay),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return _sum_partials(part, g_chan, g_chanq), n


def _weight_partials(lay: FwdLayout, n: int, dev):
    """Per-block (or per-chunk) weight-gradient partials [n, I, width]; None
    for a weight the layout lacks."""
    weighted = lay.has_cn_w or lay.has_ucn
    return {k: torch.empty(n, lay.n_iterations, width, device=dev) if on else None
            for k, width, on in (("cn", lay.E, weighted), ("ucn", lay.E, lay.has_ucn),
                                 ("vn", lay.N, lay.has_vn_w))}


def _sum_partials(part, g_chan, g_chanq):
    """The backward wrappers' result: the partials summed over their first
    axis in a fixed order (no float atomics), then the channel gradients."""
    g_cnw, g_ucnw, g_vnw = (None if t is None else t.sum(dim=0)
                            for t in (part["cn"], part["ucn"], part["vn"]))
    return g_cnw, g_vnw, g_ucnw, g_chan, g_chanq


# ---------------------------------------------------------------------------
# Device-memory kernels (K3, K4): codes the on-chip kernels cannot hold
# ---------------------------------------------------------------------------
_K3_MODES = {"app": 0, "stats": _F_STATS, "syndrome": _F_SYNDROME, "stream": _F_STREAM}
_K4_CHUNK = 64  # words per weight-gradient partial of csrc/fused_bwd_dm.cu


def fused_fwd_k3(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
                 ucnw: Optional[torch.Tensor] = None, vnw: Optional[torch.Tensor] = None,
                 mode: str = "app", store: bool = True):
    """The forward with the message state in device memory (K3,
    ``csrc/fused_fwd_dm.cu``) in one of ``_fwd_kernel_hbm``'s modes:
    ``"app"`` the pre-clip final APP [B, N*Z]; ``"stats"`` int32 [B, 3]
    (ok, bit errors, frame error of all-zero words); ``"syndrome"`` (APP,
    stats); ``"stream"`` ``(outs [I, B, N*Z], store [max(I-1, 1), B, E*Z] or
    None)``, the pre-clip APP of every iteration and, with ``store``, the
    state entering iteration i in slot i-1 (K1d's ``store[1:]``), in the
    permuted flat-edge order ``k*Z + zc``.

    A CUDA tensor launches the kernels (2 * I launches, plus one epilogue in
    the stats and syndrome modes) and raises if they cannot run; a CPU
    tensor runs ``fused_fwd_dm_plain`` (and ``stats_plain``).
    ``fused_fwd_k3.launches`` counts calls, ``fused_fwd_k3.cuda_launches``
    the CUDA launches they made."""
    if mode not in _K3_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check_chan(chan, lay)
    dev, B = chan.device, chan.shape[0]
    w = _check_weights(lay, dev, cnw, ucnw, vnw)
    stream = mode == "stream"
    store = store and stream
    if dev.type == "cpu":
        out, st = fused_fwd_dm_plain(chan, lay, *w, stream=stream, store=store)
        if mode == "stats":
            return stats_plain(out, lay)
        if mode == "syndrome":
            return out, stats_plain(out, lay)
        return (out, st) if stream else out
    _check_launchable(lay, dev, on_chip=False)
    chan = chan.contiguous()
    I, NZ, EZ = lay.n_iterations, lay.N * lay.Z, lay.E * lay.Z
    out = (torch.empty(I, B, NZ, device=dev) if stream
           else None if mode == "stats" else torch.empty_like(chan))
    # a single slot at I = 1 is never written: zeros, as the plain version's
    st = (torch.zeros if I == 1 else torch.empty)(lay.slots, B, EZ, device=dev) if store else None
    stats = torch.empty(B, 3, dtype=torch.int32, device=dev) if mode in ("stats", "syndrome") else None
    msg, sums = torch.empty(B, EZ, device=dev), torch.empty(B, NZ, device=dev)
    flags = _mode_flags(lay) | _K3_MODES[mode] | (_F_STORE if store else 0)
    fused_fwd_k3.cuda_launches += _call_kernel(
        "fused_fwd_dm", f"fused_fwd_dm launch (flags {flags})",
        _ptr(chan), _ptr(out), _ptr(st), _ptr(msg), _ptr(sums), _ptr(stats), _ptr(lay.tables),
        *(_ptr(t) for t in w),
        B, lay.N, lay.M, lay.Z, lay.E, I, lay.max_degree, flags,
        lay.clip_lo, lay.clip_hi, *_qms_args(lay),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    fused_fwd_k3.launches += 1
    if mode == "stats":
        return stats
    if mode == "syndrome":
        return out, stats
    return (out, st) if stream else out


def fused_bwd_k4(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                 ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                 store: torch.Tensor, outs: torch.Tensor, g_outs: torch.Tensor):
    """The adjoint of ``fused_fwd_k3``'s training forward (K4,
    ``csrc/fused_bwd_dm.cu``): from the channel [B, N*Z], K3's store
    [max(I-1, 1), B, E*Z], the pre-clip outputs and their cotangents
    [I, B, N*Z], what ``fused_bwd_k2`` returns.

    A CUDA tensor launches the kernels (3 to 5 launches per iteration) and
    raises if they cannot run; a CPU tensor runs ``fused_bwd_dm_plain``.
    ``fused_bwd_k4.launches`` counts calls, ``.cuda_launches`` the CUDA
    launches they made.  The kernels write one
    weight-gradient partial per chunk of 64 words; they are summed here in a
    fixed order."""
    _check_chan(chan, lay)
    dev, (B, NZ), I = chan.device, chan.shape, lay.n_iterations
    w = _check_weights(lay, dev, cnw, ucnw, vnw)
    store = _check_f32(store, (lay.slots, B, lay.E * lay.Z), dev, "store")
    outs = _check_f32(outs, (I, B, NZ), dev, "outs")
    g_outs = _check_f32(g_outs, (I, B, NZ), dev, "g_outs")
    if dev.type == "cpu":
        return fused_bwd_dm_plain(chan, lay, *w, store, outs, g_outs)
    _check_launchable(lay, dev, on_chip=False)
    chan = chan.contiguous()
    EZ = lay.E * lay.Z
    g_chan = torch.zeros_like(chan)
    g_chanq = torch.zeros_like(chan) if lay.qms_qbit is not None else None
    gsums, gmsg = torch.zeros_like(chan), torch.zeros(B, EZ, device=dev)
    sums, gw = torch.empty_like(chan), torch.empty(B, EZ, device=dev)
    ucn = torch.empty(B, lay.M * lay.Z, dtype=torch.uint8, device=dev) if lay.has_ucn else None
    part = _weight_partials(lay, -(-B // _K4_CHUNK), dev)
    fused_bwd_k4.cuda_launches += _call_kernel(
        "fused_bwd_dm", "fused_bwd_dm launch",
        _ptr(chan), _ptr(store), _ptr(outs), _ptr(g_outs), _ptr(lay.tables),
        *(_ptr(t) for t in w), _ptr(g_chan), _ptr(g_chanq), _ptr(gsums), _ptr(gmsg),
        _ptr(sums), _ptr(gw), _ptr(ucn), _ptr(part["cn"]), _ptr(part["ucn"]), _ptr(part["vn"]),
        B, lay.N, lay.M, lay.Z, lay.E, I, lay.max_degree, _mode_flags(lay), _K4_CHUNK,
        lay.clip_lo, lay.clip_hi, *_qms_args(lay),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    fused_bwd_k4.launches += 1
    return _sum_partials(part, g_chan, g_chanq)


# ---------------------------------------------------------------------------
# Matmul routing (K6): the on-chip kernels with the routing on the tensor cores
# ---------------------------------------------------------------------------
_K6_MODES = {"app": 0, "stats": _F_STATS, "syndrome": _F_SYNDROME, "stream": _F_STREAM}


def fused_fwd_k6(chan: Optional[torch.Tensor], lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
                 ucnw: Optional[torch.Tensor] = None, vnw: Optional[torch.Tensor] = None,
                 mode: str = "app", store: bool = True, *, seed: int = 0, sigma: float = 1.0,
                 batch: Optional[int] = None, widx: Optional[torch.Tensor] = None,
                 stream_bt: Optional[int] = None, emit_chan: bool = False):
    """The on-chip forward with matmul routing (K6, ``csrc/fused_fwd.cu``
    instantiated for the layout's "int8" or "split3" routing) in every mode
    of K1: ``"app"`` the pre-clip final APP [B, N*Z]; ``"stats"`` int32
    [B, 3]; ``"syndrome"`` (APP, stats); ``"stream"`` ``(outs [I, B, N*Z],
    store [I, B, E*Z] or None)`` as K1d; ``"sample"`` (``chan`` None) the
    stats of all-zero words sampled in the kernel, as ``fused_fwd_k1c``
    takes them (``seed``, ``sigma``, ``batch`` or ``widx``, ``stream_bt``,
    ``emit_chan``).

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs the plain versions, which follow the layout's routing.
    ``fused_fwd_k6.launches`` counts kernel launches."""
    if mode == "sample":
        dev, B, bt = _sampling_batch(lay, batch, widx, stream_bt, emit_chan)
        w = _check_weights(lay, dev, cnw, ucnw, vnw)
        if dev.type == "cpu":
            return _sampled_plain(lay, w, seed, sigma, B, widx, bt, emit_chan)
        stats, chan_emit, n = _sampled_launch(lay, w, seed, sigma, B, widx, bt, emit_chan, True)
        fused_fwd_k6.cuda_launches += n
        fused_fwd_k6.launches += 1
        return (stats, chan_emit) if emit_chan else stats
    if mode not in _K6_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check_chan(chan, lay)
    w = _check_weights(lay, chan.device, cnw, ucnw, vnw)
    stream = mode == "stream"
    store = store and stream
    if chan.device.type == "cpu":
        if stream:
            return fused_fwd_train_plain(chan, lay, *w, store=store)
        out = fused_fwd_plain(chan, lay, *w)
        if mode == "stats":
            return stats_plain(out, lay)
        return (out, stats_plain(out, lay)) if mode == "syndrome" else out
    chan = chan.contiguous()
    dev, B, I = chan.device, chan.shape[0], lay.n_iterations
    out = (torch.empty(I, B, lay.N * lay.Z, device=dev) if stream
           else None if mode == "stats" else torch.empty_like(chan))
    st = torch.empty(I, B, lay.E * lay.Z, device=dev) if store else None
    stats = torch.empty(B, 3, dtype=torch.int32, device=dev) if mode in ("stats", "syndrome") else None
    fused_fwd_k6.cuda_launches += _launch(
        lay, dev, B, w, _K6_MODES[mode] | (_F_STORE if store else 0), chan=chan, out=out,
        store=st, stats=stats, matmul=True)
    fused_fwd_k6.launches += 1
    if mode == "stats":
        return stats
    if mode == "syndrome":
        return out, stats
    return (out, st) if stream else out


def fused_bwd_k6(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                 ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                 store: torch.Tensor, outs: torch.Tensor, g_outs: torch.Tensor):
    """The adjoint of ``fused_fwd_k6``'s training forward (K6,
    ``csrc/fused_bwd.cu`` instantiated for the layout's routing): what
    ``fused_bwd_k2`` returns, from K6's store and outputs.

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs ``fused_bwd_plain``, which follows the layout's routing.
    ``fused_bwd_k6.launches`` counts kernel launches."""
    _check_chan(chan, lay)
    dev, (B, NZ), I = chan.device, chan.shape, lay.n_iterations
    w = _check_weights(lay, dev, cnw, ucnw, vnw)
    store = _check_f32(store, (I, B, lay.E * lay.Z), dev, "store")
    outs = _check_f32(outs, (I, B, NZ), dev, "outs")
    g_outs = _check_f32(g_outs, (I, B, NZ), dev, "g_outs")
    if dev.type == "cpu":
        return fused_bwd_plain(chan, lay, *w, store, outs, g_outs)
    grads, n = _bwd_launch(chan, lay, w, store, outs, g_outs, matmul=True)
    fused_bwd_k6.cuda_launches += n
    fused_bwd_k6.launches += 1
    return grads


for _wrapper in (fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c, fused_fwd_k1d, fused_bwd_k2,
                 fused_fwd_k3, fused_bwd_k4, fused_fwd_k6, fused_bwd_k6):
    _wrapper.launches = 0  # calls that launched
    _wrapper.cuda_launches = 0  # CUDA kernels they launched, as the C entry points count them
del _wrapper


def _fwd_k1(chan: Optional[torch.Tensor], lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
            ucnw: Optional[torch.Tensor] = None, vnw: Optional[torch.Tensor] = None,
            mode: str = "app", store: bool = True, *, seed: int = 0, sigma: float = 1.0,
            batch: Optional[int] = None, widx: Optional[torch.Tensor] = None,
            stream_bt: Optional[int] = None, emit_chan: bool = False):
    """K1's modes behind ``fused_fwd_k6``'s arguments: "app" K1a, "stats"
    and "syndrome" K1b, "stream" K1d, "sample" K1c."""
    if mode == "sample":
        return fused_fwd_k1c(lay, cnw, ucnw, vnw, seed, sigma, batch=batch, widx=widx,
                             stream_bt=stream_bt, emit_chan=emit_chan)
    if mode == "stream":
        return fused_fwd_k1d(chan, lay, cnw, ucnw, vnw, store=store)
    if mode in ("stats", "syndrome"):
        return fused_fwd_k1b(chan, lay, cnw, ucnw, vnw, emit_app=mode == "syndrome")
    if mode != "app":
        raise ValueError(f"unknown mode {mode!r}")
    return fused_fwd_k1a(chan, lay, cnw, ucnw, vnw)


def kernel_family(lay: FwdLayout):
    """The (forward, backward) wrappers that run the layout, as JAX's
    ``_fwd_any`` / ``_vjp_bwd`` pick them: K3 / K4 for a device-memory
    layout, K6 for a matmul-routed one, K1 / K2 otherwise.  The forward
    takes ``fused_fwd_k6``'s mode arguments."""
    if lay.hbm_store:
        return fused_fwd_k3, fused_bwd_k4
    if lay.routing != "roll":
        return fused_fwd_k6, fused_bwd_k6
    return _fwd_k1, fused_bwd_k2


class FusedTrainFn(torch.autograd.Function):
    """The training forward and its adjoint, K1d and K2 on an on-chip
    layout, K3 and K4 on a device-memory one (``lay.hbm_store``, as JAX's
    ``_fwd_any`` and ``_vjp_bwd`` pick), K6 on a matmul-routed one:
    ``apply(cnw, vnw, ucnw, chan,
    chanq, lay, store)`` -> the pre-clip APP of every iteration [I, B, N*Z]
    (the custom VJP of the JAX wrapper).  Weights are packed (permuted edge
    order); an absent one is None.  ``chanq`` is the channel after the QMS
    input quantizer (None without QMS): the kernels recompute its value from
    ``chan``, and it is an input only so that its cotangent reaches the
    quantizer's STE outside.  Without ``store`` the backward raises."""

    @staticmethod
    def forward(ctx, cnw, vnw, ucnw, chan, chanq, lay, store):
        fwd, _ = kernel_family(lay)
        outs, st = fwd(chan, lay, cnw, ucnw, vnw, mode="stream", store=store)
        ctx.lay = lay
        ctx.stored = st is not None
        if st is not None:
            ctx.save_for_backward(cnw, vnw, ucnw, chan, st, outs)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        if not ctx.stored:
            raise ValueError(
                "backward requires store_msgs=True (streaming decode mode has "
                "no message checkpoints)")
        cnw, vnw, ucnw, chan, st, outs = ctx.saved_tensors
        # the backward computes every gradient, as the TPU kernels do;
        # autograd takes the ones it asked for
        _, bwd = kernel_family(ctx.lay)
        g_cnw, g_vnw, g_ucnw, g_chan, g_chanq = bwd(
            chan, ctx.lay, cnw, ucnw, vnw, st, outs, g_outs.contiguous())
        need = ctx.needs_input_grad
        return (g_cnw if need[0] else None, g_vnw if need[1] else None,
                g_ucnw if need[2] else None, g_chan if need[3] else None,
                g_chanq if need[4] else None, None, None)


def split_stats(stats: torch.Tensor):
    """int32 [B, 3] kernel stats -> (ok [B] bool, bit_errors [B] int32,
    frame_error [B] bool), the JAX wrapper's return triple."""
    return stats[:, 0] > 0, stats[:, 1], stats[:, 2] > 0


# ---------------------------------------------------------------------------
# Host-side wrapper (the JAX FusedTrainDecoder)
# ---------------------------------------------------------------------------
class FusedTrainDecoder:
    """Fused decoder.  ``apply(cn_w, ucn_w, vn_w, chan)`` returns, with the
    defaults (``store_msgs=True``, ``stream_outputs`` = ``store_msgs``), the
    clipped APP of every iteration [I, B, N*Z], differentiable with respect
    to the weights and the channel through ``FusedTrainFn``.  Decode modes
    (``store_msgs=False``): the final-iteration APP [1, B, N*Z]; with
    ``emit_syndrome`` ``(APP, ok [B])``; with ``emit_stats`` ``(ok,
    bit_errors, frame_error)`` per all-zero word; with ``sample_channel``
    the kernel samples the channel itself (``apply_sampled``,
    ``apply_sampled_at``).  CUDA tensors go through the kernels.

    ``store_space`` keeps JAX's names: ``"vmem"`` runs the on-chip kernels
    (K1, K2), ``"hbm"`` the device-memory ones (K3, K4), ``"auto"`` the
    on-chip ones wherever they take the code (``on_chip_ok``).  ``routing``
    as JAX's: ``"roll"`` (index routing), ``"matmul"`` (the one-hot operand
    on the tensor cores: K6, on-chip only) or ``"auto"``, roll up to 1024
    edges and matmul beyond.  Matmul routing is int8 for QMS unless
    ``int8_routing=False`` (None: on for QMS), with the cotangents rounded
    to ``routing_dtype`` (torch.bfloat16 or torch.float32); without int8 it
    is the exact split-3 bf16 routing."""

    def __init__(
        self,
        graph: TannerGraph,
        n_iterations: int,
        clip: tuple[float, float] = (-20.0, 20.0),
        qms_qbit: Optional[int] = None,
        has_cn_w: bool = True,
        has_vn_w: bool = False,
        has_ucn: bool = False,
        sum_product: bool = False,
        store_msgs: bool = True,  # False = decode only (no backward)
        routing: str = "auto",  # "roll" | "matmul" (K6) | "auto": roll for E <= 1024
        stream_outputs: Optional[bool] = None,  # None = store_msgs
        bt: Optional[int] = None,
        routing_dtype: torch.dtype = torch.bfloat16,  # matmul routing's cotangents (int8 mode)
        int8_routing: Optional[bool] = None,  # None: on for QMS (matmul routing only)
        store_space: str = "auto",
        emit_syndrome: bool = False,
        emit_stats: bool = False,
        sample_channel: bool = False,
        emit_chan: bool = False,
        sample_at_idx: int = 0,
        device: DeviceLike = "cuda",
    ):
        if routing == "auto":
            routing = "roll" if graph.E <= 1024 else "matmul"  # JAX's rule (:1993)
        if routing not in ("matmul", "roll"):
            raise ValueError(f"unknown routing {routing!r}")
        if routing == "roll":
            int8_routing = False  # rolls are exact f32; no products to quantize
        if stream_outputs is None:
            stream_outputs = store_msgs
        if store_msgs and not stream_outputs:
            raise ValueError("training (store_msgs) needs the full output stream")
        if store_space not in ("auto", "vmem", "hbm"):
            raise ValueError(f"unknown store_space {store_space!r}")
        if qms_qbit is not None and qms_qbit not in _QMS_TABLE:
            raise ValueError(f"unsupported qms_qbit {qms_qbit}")
        if int8_routing is None:
            int8_routing = qms_qbit is not None
        if int8_routing and qms_qbit is None:
            raise ValueError("int8 routing needs QMS quantization")
        if routing_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"routing_dtype: torch.bfloat16 or torch.float32, got {routing_dtype}")
        if routing == "matmul" and not int8_routing:
            routing_dtype = torch.bfloat16  # the split-3 operand (0/1 exact)
        if has_ucn and not has_cn_w:
            raise ValueError("UCN weighting requires CN weights")
        if sum_product and qms_qbit is not None:
            raise ValueError("SP and QMS are mutually exclusive decoder types")
        if emit_syndrome and (store_msgs or stream_outputs):
            raise ValueError("emit_syndrome is a final-APP decode epilogue; "
                             "use store_msgs=False, stream_outputs=False")
        if emit_stats and (store_msgs or stream_outputs or emit_syndrome):
            raise ValueError("emit_stats is a stats-only decode mode; use "
                             "store_msgs=False, stream_outputs=False and not "
                             "emit_syndrome (stats row 0 IS the syndrome)")
        if sample_channel and not emit_stats:
            raise ValueError("sample_channel is a stats-only campaign mode "
                             "(all-zero words); set emit_stats=True")
        if emit_chan and not sample_channel:
            raise ValueError("emit_chan re-exports the IN-KERNEL sampled llr; "
                             "set sample_channel=True")
        if sample_at_idx:
            if not sample_channel:
                raise ValueError("sample_at_idx re-samples IN KERNEL; set "
                                 "sample_channel=True")
            if emit_chan:
                raise ValueError("sample_at_idx and emit_chan are exclusive "
                                 "(index mode exists to avoid the llr export)")
            if sample_at_idx & (sample_at_idx - 1):
                raise ValueError("sample_at_idx must be the phase-1 batch "
                                 "tile width, a power of two")
        on_chip = on_chip_ok(graph)
        if store_space == "auto":
            store_space = "vmem" if on_chip else "hbm"
        if store_space == "hbm":
            if sample_channel:
                raise ValueError("sample_channel is VMEM-resident only "
                                 "(big codes keep the XLA channel sampler)")
            if routing != "roll":
                raise ValueError(
                    "store_space='hbm' requires roll routing (one-hot matmul "
                    "operands at this scale dwarf VMEM)")
        elif not on_chip:
            smem = max(_fwd_smem_per_word(graph.M, graph.N, graph.Z, graph.E),
                       _bwd_smem_per_word(graph.M, graph.N, graph.Z, graph.E))
            raise ValueError(
                f"code too large for VMEM-resident messages (E*Zp = "
                f"{graph.E * _round8(graph.Z)}; M*Z = {graph.M * graph.Z} lifted checks for "
                f"{_MAX_THREADS} threads, {smem} B of shared memory per word for "
                f"{_SMEM_LIMIT}); retry with store_space='hbm' (device-memory messages) or "
                "the plain engine")
        self.graph = graph
        self.device = resolve_device(device)
        self.layout = FwdLayout.build(
            graph, n_iterations, clip, qms_qbit, sum_product,
            has_cn_w, has_vn_w, has_ucn, self.device, bt=bt, hbm_store=store_space == "hbm",
            routing="roll" if routing == "roll" else "int8" if int8_routing else "split3",
            grad_f32=routing_dtype == torch.float32,
        )
        self.routing = routing
        self.routing_dtype = routing_dtype
        self.int8_routing = bool(int8_routing)
        self.bt = self.layout.bt
        self.store_msgs = store_msgs
        self.stream_outputs = stream_outputs
        self.emit_syndrome = emit_syndrome
        self.emit_stats = emit_stats
        self.sample_channel = sample_channel
        self.emit_chan = emit_chan
        self.sample_at_idx = int(sample_at_idx)
        self.edge_perm = self.layout.edge_perm
        self._perm = torch.as_tensor(self.edge_perm.astype(np.int64), device=self.device)

    @staticmethod
    def from_decoder(decoder, **kw) -> "FusedTrainDecoder":
        """Static-config construction from a BoostedNeuralDecoder (weights
        arrive per call via ``apply``)."""
        from ...structs import DecoderType, SharingMode

        cfg = decoder.config
        kw.setdefault("device", decoder.device)
        return FusedTrainDecoder(
            decoder.graph,
            n_iterations=cfg.n_iterations,
            clip=(cfg.allowed_llr_range.start, cfg.allowed_llr_range.end),
            qms_qbit=cfg.qms_qbit if cfg.decoder_type == DecoderType.QMS else None,
            has_cn_w=cfg.sharing.cn != SharingMode.NONE,
            has_vn_w=cfg.sharing.vn != SharingMode.NONE,
            has_ucn=cfg.sharing.ucn != SharingMode.NONE,
            sum_product=cfg.decoder_type == DecoderType.SP,
            **kw,
        )

    def pack_weights(self, cn_w, ucn_w, vn_w):
        """[I, E] original-order edge weights -> permuted order; absent
        weights become all-ones where the configuration needs them."""
        lay = self.layout
        I = lay.n_iterations

        def as_t(w, width):
            if w is None:
                return torch.ones(I, width, dtype=torch.float32, device=self.device)
            return torch.as_tensor(w, dtype=torch.float32, device=self.device)

        cnw = as_t(cn_w, lay.E)[:, self._perm].contiguous() if (lay.has_cn_w or lay.has_ucn) else None
        ucnw = as_t(ucn_w, lay.E)[:, self._perm].contiguous() if lay.has_ucn else None
        vnw = as_t(vn_w, lay.N).contiguous() if lay.has_vn_w else None
        return cnw, ucnw, vnw

    def decode_packed(self, w, chan_llr: torch.Tensor):
        """The forward of ``apply`` on weights already packed by
        ``pack_weights``: with ``stream_outputs`` the clipped APP of every
        iteration [I, B, N*Z] (differentiable through ``FusedTrainFn``);
        else the final APP [B, N*Z] (clipped); with ``emit_syndrome`` ``(APP,
        ok [B])``; with ``emit_stats`` ``(ok, bit_errors, frame_error)``."""
        lay = self.layout
        if self.sample_channel:
            raise ValueError("a sample_channel decoder samples its own channel: "
                             "use the sampled-stats calls")
        check_same_device(chan_llr, self.device, "chan_llr")
        B = chan_llr.shape[0]
        chan = chan_llr.reshape(B, lay.N * lay.Z).to(dtype=torch.float32)
        if self.stream_outputs:
            # the QMS channel STE and the final clip stay outside the
            # Function: autograd differentiates them with JAX's ties
            chanq = qms_quantize_ste(chan, lay.qms_qbit) if lay.qms_qbit is not None else None
            # without autograd the store has no reader: skip writing it
            store = self.store_msgs and torch.is_grad_enabled()
            outs = FusedTrainFn.apply(w[0], w[2], w[1], chan, chanq, lay, store)
            return ties.clip(outs, lay.clip_lo, lay.clip_hi)
        fwd, _ = kernel_family(lay)
        if self.emit_stats:
            return split_stats(fwd(chan, lay, *w, mode="stats"))
        if self.emit_syndrome:
            out, st = fwd(chan, lay, *w, mode="syndrome")
            return out.clamp_(lay.clip_lo, lay.clip_hi), st[:, 0] > 0
        return fwd(chan, lay, *w).clamp_(lay.clip_lo, lay.clip_hi)

    def sample_packed(self, w, seed: int, sigma: float, batch: int):
        """``apply_sampled`` on packed weights."""
        if not self.sample_channel:
            raise ValueError("construct with sample_channel=True")
        lay = self.layout
        fwd, _ = kernel_family(lay)
        res = fwd(None, lay, *w, mode="sample", seed=seed, sigma=sigma, batch=batch,
                  emit_chan=self.emit_chan)
        if not self.emit_chan:
            return split_stats(res)
        st, chan = res
        return split_stats(st), chan.reshape(batch, lay.N, lay.Z)

    def sample_at_packed(self, w, seed: int, sigma: float, widx: torch.Tensor):
        """``apply_sampled_at`` on packed weights."""
        if not self.sample_at_idx:
            raise ValueError("construct with sample_at_idx=<phase-1 bt>")
        fwd, _ = kernel_family(self.layout)
        return split_stats(fwd(None, self.layout, *w, mode="sample", seed=seed, sigma=sigma,
                               widx=widx, stream_bt=self.sample_at_idx))

    def apply(self, cn_w, ucn_w, vn_w, chan_llr: torch.Tensor):
        """cn_w/ucn_w [I, E] or None, vn_w [I, N] or None (original edge
        order, as produced by BoostedNeuralDecoder._expanded_weights);
        chan_llr [B, N, Z] or [B, N*Z].  Returns the clipped APP of every
        iteration [I, B, N*Z] (``stream_outputs``), differentiable with
        respect to the weights and the channel when ``store_msgs``; else the
        final APP [1, B, N*Z]; with ``emit_syndrome`` ``(APP, ok [B])``;
        with ``emit_stats`` ``(ok, bit_errors, frame_error)``."""
        res = self.decode_packed(self.pack_weights(cn_w, ucn_w, vn_w), chan_llr)
        if self.emit_stats or self.stream_outputs:
            return res
        if self.emit_syndrome:
            return res[0][None], res[1]
        return res[None]

    def apply_sampled(self, cn_w, ucn_w, vn_w, seed: int, sigma: float, batch: int):
        """Stats-only decode of ``batch`` all-zero words whose channel the
        kernel samples from the int32 ``seed`` at noise std ``sigma``:
        ``(ok, bit_errors, frame_error)``; with ``emit_chan`` also the
        sampled LLRs [B, N, Z]: ``(stats triple, llr)``."""
        return self.sample_packed(self.pack_weights(cn_w, ucn_w, vn_w), seed, sigma, batch)

    def apply_sampled_at(self, cn_w, ucn_w, vn_w, seed: int, sigma: float, widx: torch.Tensor):
        """Stats-only decode of the words at original batch indices ``widx``
        [K] int32, re-sampling their channel in the kernel from the stream
        of a phase-1 sampler whose tile was ``sample_at_idx``."""
        return self.sample_at_packed(self.pack_weights(cn_w, ucn_w, vn_w), seed, sigma, widx)
