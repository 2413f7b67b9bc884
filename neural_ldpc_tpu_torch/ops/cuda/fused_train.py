"""Fused forward BP decode on the GPU: the hand-written CUDA kernel
``csrc/fused_fwd.cu`` (final-APP mode, ROADMAP kernel "K1a"), its plain
PyTorch version, and the host-side wrapper ``FusedTrainDecoder``.

The kernel replaces ``neural_ldpc_tpu/ops/pallas/fused_train.py::_fwd_kernel``
in its decode mode (``store_msgs=False, stream_outputs=False``).  Like the
TPU kernel it keeps each word's whole message state on chip for all
iterations, orders checks by degree (``build_layout``) and routes messages by
per-edge cyclic shifts.  The TPU kernel's tile machinery (batch tile ``bt``,
VMEM budgets, weight-stream layouts, Zp sublane padding, the ``[NZp, B]``
transpose) has no GPU counterpart: the wrapper keeps the batch-major
``[B, N*Z]`` layout and picks the words per block from thread and shared
memory limits.

Bound on the H100: the kernel moves 2 * N*Z * 4 bytes per word (channel in,
APP out) and does E*Z*I edge updates per word; ``chip_smoke.py`` counts the
fp32 operations per word from the kernel source (``ops_per_word``) and
reports the larger of the byte and operation bounds next to the measured
time.  Both shipped configurations are bound by operations.

Only ``fused_fwd_k1a`` launches the kernel, and it does so only for CUDA
tensors; for CPU tensors it runs ``fused_fwd_plain``, which follows the
kernel's own algorithm (degree-sorted checks, roll as an index permutation,
per-class prefix/suffix reductions, the kernel's VN sum order).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ...codes.tanner import TannerGraph
from ...device import DeviceLike, check_same_device, resolve_device
from ..flat import _BIG, _SP_EPS, gather_sum
from ..quantize import _QMS_TABLE, qms_quantize_value

# kernel flag bits (csrc/fused_fwd.cu)
_F_QMS, _F_SP, _F_CNW, _F_UCN, _F_VNW = 1, 2, 4, 8, 16
_MAX_THREADS = 1024  # one thread per lifted check of a block's words
_TARGET_THREADS = 512
_SMEM_LIMIT = 227 * 1024


def build_layout(graph: TannerGraph):
    """Degree-sorted check order: (edge_perm [E] new->old, deg_classes
    ((degree, n_checks), ...)).  Checks are sorted by degree (stable), and
    each check's edges stay contiguous in the permuted order."""
    degs = np.diff(graph.row_ptr)
    if degs.min() < 2:
        raise ValueError("degree-1 checks unsupported (extrinsic min undefined)")
    order = np.argsort(degs, kind="stable")
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
    edge_perm: np.ndarray  # [E] new -> old
    route_idx: torch.Tensor  # [E*Z] VN copy feeding permuted flat edge k*Z + zc
    vn_gather: torch.Tensor  # [N*Z, max_vn_degree] flat edges in sum order, E*Z = pad
    tables: torch.Tensor  # int32 kernel tables (see csrc/fused_fwd.cu)

    @property
    def max_degree(self) -> int:
        return max(d for d, _ in self.deg_classes)

    @property
    def words_per_block(self) -> int:
        """Whole words per CUDA block: as many as fit ~512 threads (one per
        lifted check) and the shared memory (channel, sums, messages)."""
        mz = self.M * self.Z
        per_word = 4 * (2 * self.N * self.Z + self.E * self.Z)
        return max(1, min(_TARGET_THREADS // mz, _MAX_THREADS // mz, _SMEM_LIMIT // per_word))

    @staticmethod
    def build(graph: TannerGraph, n_iterations: int, clip, qms_qbit,
              sum_product: bool, has_cn_w: bool, has_vn_w: bool, has_ucn: bool,
              device) -> "FwdLayout":
        edge_perm, deg_classes = build_layout(graph)
        Z, E, N, M = graph.Z, graph.E, graph.N, graph.M
        vn_p = graph.vn_of_edge[edge_perm].astype(np.int64)
        sh_p = graph.shift_of_edge[edge_perm].astype(np.int64)
        zc = np.arange(Z)
        route = vn_p[:, None] * Z + (zc[None, :] + sh_p[:, None]) % Z
        # per VN: its permuted edges in increasing order (the TPU kernel's
        # accumulation order, fused_train.py:1012-1016)
        vn_lists = [np.nonzero(vn_p == n)[0] for n in range(N)]
        vn_ptr = np.zeros(N + 1, np.int64)
        np.cumsum([len(v) for v in vn_lists], out=vn_ptr[1:])
        maxdv = max(1, max(len(v) for v in vn_lists))
        vn_gather = np.full((N, Z, maxdv), E * Z, np.int64)
        for n, ks in enumerate(vn_lists):
            for j, k in enumerate(ks):
                vn_gather[n, :, j] = k * Z + (zc - sh_p[k]) % Z
        degs = np.concatenate([[d] * n for d, n in deg_classes]).astype(np.int64)
        chk_off = np.concatenate([[0], np.cumsum(degs)[:-1]])
        tables = np.concatenate([
            chk_off, degs, vn_p, sh_p, vn_ptr,
            np.concatenate(vn_lists) if E else np.zeros(0, np.int64),
        ]).astype(np.int32)
        return FwdLayout(
            M=M, N=N, Z=Z, E=E, n_iterations=n_iterations,
            deg_classes=deg_classes,
            clip_lo=float(clip[0]), clip_hi=float(clip[1]),
            qms_qbit=qms_qbit, sum_product=sum_product,
            has_cn_w=has_cn_w, has_vn_w=has_vn_w, has_ucn=has_ucn,
            edge_perm=edge_perm,
            route_idx=torch.as_tensor(route.reshape(-1), device=device),
            vn_gather=torch.as_tensor(vn_gather.reshape(N * Z, maxdv), device=device),
            tables=torch.as_tensor(tables, device=device),
        )


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel
# ---------------------------------------------------------------------------
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
    s = torch.where(app < 0, -1.0, 1.0)[:, lay.route_idx]
    parts = []
    for base, d, n in _class_ranges(lay):
        seg = s[:, base:base + d * n * lay.Z].reshape(B, n, d, lay.Z)
        parity = seg[:, :, 0]
        for j in range(1, d):
            parity = parity * seg[:, :, j]
        u = torch.where(parity < 0, 1.0, 0.0)
        parts.append(u[:, :, None, :].expand(B, n, d, lay.Z).reshape(B, -1))
    return torch.cat(parts, dim=1)


def fused_fwd_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                    ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel: chan [B, N*Z] -> pre-clip final
    APP [B, N*Z].  Weights are [I, E] in permuted edge order and [I, N]."""
    B, Z = chan.shape[0], lay.Z
    qms = lay.qms_qbit is not None
    chan_out = qms_quantize_value(chan, lay.qms_qbit) if qms else chan
    msg = chan.new_zeros(B, lay.E * Z)
    sums = chan.new_zeros(B, lay.N * Z)
    for i in range(lay.n_iterations):
        if vnw is not None:
            xa = chan * torch.repeat_interleave(vnw[i], Z)[None]
            xa_q = qms_quantize_value(xa, lay.qms_qbit) if qms else xa
        else:
            xa_q = chan_out
        if lay.has_ucn:
            app = xa_q if i == 0 else torch.clamp(chan_out + sums, lay.clip_lo, lay.clip_hi)
            u = _ucn_mask(app, lay)
        v2c = _clip_or_quant((xa_q + sums)[:, lay.route_idx] - msg, lay)
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
        sums = gather_sum(msg, lay.vn_gather)  # the kernel's VN sum order
    return chan_out + sums


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------
def _kernel_lib():
    from . import _build

    lib = _build.load("fused_fwd")
    fn = lib.fused_fwd_k1a_launch
    if fn.argtypes is None:
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, vp] + [i32] * 9 + [f32] * 5 + [vp]
        fn.restype = ctypes.c_int
    return fn


def _check_weight(w, shape, device, name):
    if w is None:
        return None
    if w.device != device or w.dtype != torch.float32 or tuple(w.shape) != shape:
        raise ValueError(f"{name}: expected float32 {shape} on {device}, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    return w.contiguous()


def fused_fwd_k1a(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
                  ucnw: Optional[torch.Tensor] = None,
                  vnw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final-iteration pre-clip APP [B, N*Z] from channel LLRs [B, N*Z].

    A CUDA tensor launches the kernel (and raises if it cannot); a CPU
    tensor runs ``fused_fwd_plain``.  ``fused_fwd_k1a.launches`` counts
    kernel launches."""
    I, NZ = lay.n_iterations, lay.N * lay.Z
    if chan.dim() != 2 or chan.shape[1] != NZ or chan.dtype != torch.float32:
        raise ValueError(f"chan: expected float32 [B, {NZ}], got {chan.dtype} {tuple(chan.shape)}")
    dev = chan.device
    cnw = _check_weight(cnw, (I, lay.E), dev, "cnw")
    ucnw = _check_weight(ucnw, (I, lay.E), dev, "ucnw")
    vnw = _check_weight(vnw, (I, lay.N), dev, "vnw")
    if (lay.has_cn_w or lay.has_ucn) and cnw is None:
        raise ValueError("cnw is required for CN/UCN weighting")
    if lay.has_ucn and ucnw is None:
        raise ValueError("ucnw is required for UCN weighting")
    if lay.has_vn_w and vnw is None:
        raise ValueError("vnw is required for VN weighting")
    if dev.type == "cpu":
        return fused_fwd_plain(chan, lay, cnw, ucnw, vnw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if lay.tables.device != dev:
        raise ValueError(f"layout tables live on {lay.tables.device}, chan on {dev}")
    if lay.M * lay.Z > _MAX_THREADS:
        raise NotImplementedError(
            f"M*Z = {lay.M * lay.Z} lifted checks exceed one block; big codes "
            "need the device-memory-streamed kernel (ROADMAP kernel K3)")
    chan = chan.contiguous()
    out = torch.empty_like(chan)
    flags = ((_F_QMS if lay.qms_qbit is not None else 0)
             | (_F_SP if lay.sum_product else 0)
             | (_F_CNW if lay.has_cn_w or lay.has_ucn else 0)
             | (_F_UCN if lay.has_ucn else 0)
             | (_F_VNW if lay.has_vn_w else 0))
    q_lo, q_hi, q_scale = _QMS_TABLE[lay.qms_qbit] if lay.qms_qbit is not None else (0.0, 0.0, 1.0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _kernel_lib()(
        ptr(chan), ptr(out), ptr(lay.tables), ptr(cnw), ptr(ucnw), ptr(vnw),
        chan.shape[0], lay.N, lay.M, lay.Z, lay.E, I, lay.max_degree,
        lay.words_per_block, flags, lay.clip_lo, lay.clip_hi, q_lo, q_hi, q_scale,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_fwd_k1a launch failed: CUDA error {err}")
    fused_fwd_k1a.launches += 1
    return out


fused_fwd_k1a.launches = 0


# ---------------------------------------------------------------------------
# Host-side wrapper (decode subset of the JAX FusedTrainDecoder)
# ---------------------------------------------------------------------------
_UNPORTED = {
    "store_msgs": "training forward, ROADMAP kernel K1d",
    "stream_outputs": "per-iteration output stream, ROADMAP kernel K1d",
    "emit_syndrome": "syndrome epilogue, ROADMAP kernel K1b",
    "emit_stats": "stats epilogue, ROADMAP kernel K1b",
    "sample_channel": "in-kernel AWGN, ROADMAP kernel K1c",
    "emit_chan": "in-kernel AWGN export, ROADMAP kernel K1c",
    "sample_at_idx": "in-kernel AWGN by word index, ROADMAP kernel K1c",
}


class FusedTrainDecoder:
    """Fused final-APP decoder: ``apply(cn_w, ucn_w, vn_w, chan)`` returns the
    final-iteration APP [1, B, N*Z] (clipped), through the CUDA kernel for
    CUDA tensors.  Port of the decode subset of the JAX wrapper
    (``store_msgs=False, stream_outputs=False``); other modes raise
    ``NotImplementedError`` naming their ROADMAP item."""

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
        store_msgs: bool = False,
        routing: str = "auto",
        stream_outputs: bool = False,
        store_space: str = "auto",
        emit_syndrome: bool = False,
        emit_stats: bool = False,
        sample_channel: bool = False,
        emit_chan: bool = False,
        sample_at_idx: int = 0,
        device: DeviceLike = "cuda",
    ):
        for name, value in (("store_msgs", store_msgs), ("stream_outputs", stream_outputs),
                            ("emit_syndrome", emit_syndrome), ("emit_stats", emit_stats),
                            ("sample_channel", sample_channel), ("emit_chan", emit_chan),
                            ("sample_at_idx", sample_at_idx)):
            if value:
                raise NotImplementedError(f"{name}: not ported yet ({_UNPORTED[name]})")
        if routing == "matmul":
            raise NotImplementedError("routing='matmul': not ported yet (ROADMAP kernel K6)")
        if routing not in ("auto", "roll"):
            raise ValueError(f"unknown routing {routing!r}")
        if store_space == "hbm":
            raise NotImplementedError(
                "store_space='hbm': not ported yet (ROADMAP kernel K3)")
        if store_space not in ("auto", "vmem"):
            raise ValueError(f"unknown store_space {store_space!r}")
        if qms_qbit is not None and qms_qbit not in _QMS_TABLE:
            raise ValueError(f"unsupported qms_qbit {qms_qbit}")
        if has_ucn and not has_cn_w:
            raise ValueError("UCN weighting requires CN weights")
        if sum_product and qms_qbit is not None:
            raise ValueError("SP and QMS are mutually exclusive decoder types")
        self.graph = graph
        self.device = resolve_device(device)
        self.layout = FwdLayout.build(
            graph, n_iterations, clip, qms_qbit, sum_product,
            has_cn_w, has_vn_w, has_ucn, self.device,
        )
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

    def apply(self, cn_w, ucn_w, vn_w, chan_llr: torch.Tensor) -> torch.Tensor:
        """cn_w/ucn_w [I, E] or None, vn_w [I, N] or None (original edge
        order, as produced by BoostedNeuralDecoder._expanded_weights);
        chan_llr [B, N, Z] or [B, N*Z].  Returns the final APP [1, B, N*Z]."""
        lay = self.layout
        check_same_device(chan_llr, self.device, "chan_llr")
        B = chan_llr.shape[0]
        chan = chan_llr.reshape(B, lay.N * lay.Z).to(dtype=torch.float32)
        out = fused_fwd_k1a(chan, lay, *self.pack_weights(cn_w, ucn_w, vn_w))
        return torch.clamp(out, lay.clip_lo, lay.clip_hi)[None]
