"""Fused forward BP decode on the GPU: the hand-written CUDA kernel
``csrc/fused_fwd.cu`` in its three decode modes, their plain PyTorch
versions, and the host-side wrapper ``FusedTrainDecoder``.

The kernel replaces ``neural_ldpc_tpu/ops/pallas/fused_train.py::_fwd_kernel``
in its decode modes (``store_msgs=False, stream_outputs=False``):

- ``fused_fwd_k1a``: final-APP decode (ROADMAP kernel "K1a");
- ``fused_fwd_k1b``: the stats and syndrome epilogues ("K1b"): per word, ok
  (every lifted check satisfied), bit errors (APP < 0 for all-zero words)
  and frame error, with or without the APP;
- ``fused_fwd_k1c``: in-kernel AWGN sampling for all-zero words ("K1c"),
  feeding the stats epilogue; optionally exports the sampled channel, or
  re-samples words at given original batch indices.

Like the TPU kernel it keeps each word's whole message state on chip for all
iterations, orders checks by degree (``build_layout``) and routes messages by
per-edge cyclic shifts.  The TPU kernel's VMEM tiling, weight-stream layouts
and ``[NZp, B]`` transpose have no GPU counterpart: the wrapper keeps the
batch-major ``[B, N*Z]`` layout and picks the words per block from thread and
shared-memory limits.  Two TPU quantities survive because they fix which
random numbers a sampled word gets: the padded lift ``Zp`` and the logical
stream tile ``bt`` (``FwdLayout``).

Bound on the H100: K1a moves 2 * N*Z * 4 bytes per word (channel in, APP
out), K1b N*Z*4 + 12 and K1c 12; all do E*Z*I edge updates per word.
``chip_smoke.py`` counts the operations per word from the kernel source
(``ops_per_word``) and reports the larger of the byte and operation bounds
next to the measured time.  Both shipped configurations are bound by
operations in every mode.

Only the three wrappers launch the kernel, and only for CUDA tensors; for
CPU tensors they run the plain versions ``fused_fwd_plain``, ``stats_plain``
and ``sample_channel_plain``, which follow the kernel's own algorithm
(degree-sorted checks, roll as an index permutation, per-class
prefix/suffix reductions, the kernel's VN sum order, the sampler's uint32
stream).  Each wrapper counts the launches it makes in
``<wrapper>.launches``, and no other wrapper's.
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
from ..flat import _BIG, _SP_EPS, gather_sum
from ..quantize import _QMS_TABLE, qms_quantize_value

# kernel flag bits (csrc/fused_fwd.cu)
_F_QMS, _F_SP, _F_CNW, _F_UCN, _F_VNW = 1, 2, 4, 8, 16
_F_STATS, _F_SYNDROME, _F_SAMPLE, _F_EMIT_CHAN, _F_AT_IDX = 32, 64, 128, 256, 512
_M32 = 0xFFFFFFFF
_MAX_THREADS = 1024  # one thread per lifted check of a block's words
_TARGET_THREADS = 512
_SMEM_LIMIT = 227 * 1024
_MAX_CHECK_DEGREE = 32  # the kernel's largest per-thread message array


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _fits(M: int, N: int, Z: int, E: int, max_degree: int) -> bool:
    return (M * Z <= _MAX_THREADS and max_degree <= _MAX_CHECK_DEGREE
            and 4 * (2 * N * Z + E * Z + 2) <= _SMEM_LIMIT)


def fused_capacity_ok(graph: TannerGraph) -> bool:
    """Whether the on-chip kernel takes this code: one thread per lifted
    check of a word fits one block, a word's channel, sums and messages fit
    shared memory, and no check has more than 32 edges.  Other codes need the
    device-memory-streamed kernel (ROADMAP kernel K3)."""
    return _fits(graph.M, graph.N, graph.Z, graph.E, int(np.diff(graph.row_ptr).max()))


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
        per_word = 4 * (2 * self.N * self.Z + self.E * self.Z + 2)
        return max(1, min(_TARGET_THREADS // mz, _MAX_THREADS // mz, _SMEM_LIMIT // per_word))

    @staticmethod
    def build(graph: TannerGraph, n_iterations: int, clip, qms_qbit,
              sum_product: bool, has_cn_w: bool, has_vn_w: bool, has_ucn: bool,
              device, bt: Optional[int] = None) -> "FwdLayout":
        edge_perm, deg_classes = build_layout(graph)
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
            M=M, N=N, Z=Z, Zp=Zp, bt=int(bt), E=E, n_iterations=n_iterations,
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


def syndrome_ok_plain(app: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """Plain version of the K1b syndrome: per word [B] bool, True where
    every lifted check has an even number of routed decisions APP < 0
    (``_syndrome_ok_lanes``)."""
    B, Z = app.shape[0], lay.Z
    neg = (app < 0)[:, lay.route_idx].to(torch.int32)
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
def _kernel_lib():
    from . import _build

    lib = _build.load("fused_fwd")
    fn = lib.fused_fwd_launch
    if fn.argtypes is None:
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 9 + [i32] * 12 + [f32] * 6 + [vp]
        fn.restype = ctypes.c_int
    return fn


def _check_weight(w, shape, device, name):
    if w is None:
        return None
    if w.device != device or w.dtype != torch.float32 or tuple(w.shape) != shape:
        raise ValueError(f"{name}: expected float32 {shape} on {device}, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    return w.contiguous()


def _check_weights(lay: FwdLayout, dev, cnw, ucnw, vnw):
    I = lay.n_iterations
    cnw = _check_weight(cnw, (I, lay.E), dev, "cnw")
    ucnw = _check_weight(ucnw, (I, lay.E), dev, "ucnw")
    vnw = _check_weight(vnw, (I, lay.N), dev, "vnw")
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


def _launch(lay: FwdLayout, dev, B: int, weights, flags: int, *, chan=None, out=None,
            stats=None, chan_emit=None, widx=None, seed=0, sigma=1.0, bt=0) -> None:
    """One launch of ``csrc/fused_fwd.cu`` on CUDA tensors; raises if the
    kernel cannot take the configuration or the launch fails."""
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if lay.tables.device != dev:
        raise ValueError(f"layout tables live on {lay.tables.device}, the batch on {dev}")
    if not _fits(lay.M, lay.N, lay.Z, lay.E, lay.max_degree):
        raise NotImplementedError(
            f"the code (M*Z = {lay.M * lay.Z} lifted checks, check degree {lay.max_degree}) "
            "does not fit the on-chip kernel; big codes need the device-memory-streamed "
            "kernel (ROADMAP kernel K3)")
    flags |= ((_F_QMS if lay.qms_qbit is not None else 0)
              | (_F_SP if lay.sum_product else 0)
              | (_F_CNW if lay.has_cn_w or lay.has_ucn else 0)
              | (_F_UCN if lay.has_ucn else 0)
              | (_F_VNW if lay.has_vn_w else 0))
    q_lo, q_hi, q_scale = _QMS_TABLE[lay.qms_qbit] if lay.qms_qbit is not None else (0.0, 0.0, 1.0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _kernel_lib()(
        ptr(chan), ptr(out), ptr(stats), ptr(chan_emit), ptr(widx), ptr(lay.tables),
        *(ptr(w) for w in weights),
        B, lay.N, lay.M, lay.Z, lay.E, lay.n_iterations, lay.max_degree,
        lay.words_per_block, flags, lay.Zp, bt, kernel_seed(int(seed)), float(sigma),
        lay.clip_lo, lay.clip_hi, q_lo, q_hi, q_scale,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_fwd launch (flags {flags}) failed: CUDA error {err}")


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
    _launch(lay, chan.device, chan.shape[0], w, 0, chan=chan, out=out)
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
    _launch(lay, chan.device, chan.shape[0], w, _F_SYNDROME if emit_app else _F_STATS,
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
    dev = lay.tables.device
    bt = lay.bt if stream_bt is None else int(stream_bt)
    if (batch is None) == (widx is None):
        raise ValueError("give exactly one of batch and widx")
    if widx is not None:
        if emit_chan:
            raise ValueError("sample_at_idx and emit_chan are exclusive")
        if bt <= 0 or bt & (bt - 1):
            raise ValueError(f"index mode needs a power-of-two stream tile, got {bt}")
        if widx.dim() != 1 or widx.dtype != torch.int32:
            raise ValueError(f"widx: expected int32 [K], got {widx.dtype} {tuple(widx.shape)}")
        check_same_device(widx, dev, "widx")
        B = widx.shape[0]
    else:
        B = int(batch)
    w = _check_weights(lay, dev, cnw, ucnw, vnw)
    if dev.type == "cpu":
        words = torch.arange(B) if widx is None else widx
        chan = sample_channel_plain(lay, seed, sigma, words, bt)
        st = stats_plain(fused_fwd_plain(chan, lay, *w), lay)
        return (st, chan) if emit_chan else st
    stats = torch.empty(B, 3, dtype=torch.int32, device=dev)
    chan_emit = torch.empty(B, lay.N * lay.Z, device=dev) if emit_chan else None
    flags = (_F_STATS | _F_SAMPLE | (_F_EMIT_CHAN if emit_chan else 0)
             | (_F_AT_IDX if widx is not None else 0))
    _launch(lay, dev, B, w, flags, stats=stats, chan_emit=chan_emit,
            widx=None if widx is None else widx.contiguous(), seed=seed, sigma=sigma, bt=bt)
    fused_fwd_k1c.launches += 1
    return (stats, chan_emit) if emit_chan else stats


fused_fwd_k1a.launches = 0
fused_fwd_k1b.launches = 0
fused_fwd_k1c.launches = 0


def split_stats(stats: torch.Tensor):
    """int32 [B, 3] kernel stats -> (ok [B] bool, bit_errors [B] int32,
    frame_error [B] bool), the JAX wrapper's return triple."""
    return stats[:, 0] > 0, stats[:, 1], stats[:, 2] > 0


# ---------------------------------------------------------------------------
# Host-side wrapper (decode subset of the JAX FusedTrainDecoder)
# ---------------------------------------------------------------------------
class FusedTrainDecoder:
    """Fused decoder: ``apply(cn_w, ucn_w, vn_w, chan)`` returns the
    final-iteration APP [1, B, N*Z] (clipped); with ``emit_syndrome``
    ``(APP, ok [B])``; with ``emit_stats`` ``(ok, bit_errors, frame_error)``
    per all-zero word.  With ``sample_channel`` the kernel samples the
    channel itself (``apply_sampled``, ``apply_sampled_at``).  CUDA tensors
    go through the kernel.  Port of the decode modes of the JAX wrapper
    (``store_msgs=False, stream_outputs=False``); the training and big-code
    modes raise ``NotImplementedError`` naming their ROADMAP item."""

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
        bt: Optional[int] = None,
        store_space: str = "auto",
        emit_syndrome: bool = False,
        emit_stats: bool = False,
        sample_channel: bool = False,
        emit_chan: bool = False,
        sample_at_idx: int = 0,
        device: DeviceLike = "cuda",
    ):
        if store_msgs:
            raise NotImplementedError(
                "store_msgs: not ported yet (training forward, ROADMAP kernel K1d)")
        if stream_outputs:
            raise NotImplementedError(
                "stream_outputs: not ported yet (per-iteration output stream, ROADMAP kernel K1d)")
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
        if emit_stats and emit_syndrome:
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
        self.graph = graph
        self.device = resolve_device(device)
        self.layout = FwdLayout.build(
            graph, n_iterations, clip, qms_qbit, sum_product,
            has_cn_w, has_vn_w, has_ucn, self.device, bt=bt,
        )
        self.bt = self.layout.bt
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
        """The decode of ``apply`` on weights already packed by
        ``pack_weights``: the final APP [B, N*Z] (clipped); with
        ``emit_syndrome`` ``(APP, ok [B])``; with ``emit_stats`` ``(ok,
        bit_errors, frame_error)``."""
        lay = self.layout
        if self.sample_channel:
            raise ValueError("a sample_channel decoder samples its own channel: "
                             "use the sampled-stats calls")
        check_same_device(chan_llr, self.device, "chan_llr")
        B = chan_llr.shape[0]
        chan = chan_llr.reshape(B, lay.N * lay.Z).to(dtype=torch.float32)
        if self.emit_stats:
            return split_stats(fused_fwd_k1b(chan, lay, *w))
        if self.emit_syndrome:
            out, st = fused_fwd_k1b(chan, lay, *w, emit_app=True)
            return out.clamp_(lay.clip_lo, lay.clip_hi), st[:, 0] > 0
        return fused_fwd_k1a(chan, lay, *w).clamp_(lay.clip_lo, lay.clip_hi)

    def sample_packed(self, w, seed: int, sigma: float, batch: int):
        """``apply_sampled`` on packed weights."""
        if not self.sample_channel:
            raise ValueError("construct with sample_channel=True")
        lay = self.layout
        res = fused_fwd_k1c(lay, *w, seed, sigma, batch=batch, emit_chan=self.emit_chan)
        if not self.emit_chan:
            return split_stats(res)
        st, chan = res
        return split_stats(st), chan.reshape(batch, lay.N, lay.Z)

    def sample_at_packed(self, w, seed: int, sigma: float, widx: torch.Tensor):
        """``apply_sampled_at`` on packed weights."""
        if not self.sample_at_idx:
            raise ValueError("construct with sample_at_idx=<phase-1 bt>")
        return split_stats(fused_fwd_k1c(self.layout, *w, seed, sigma, widx=widx,
                                         stream_bt=self.sample_at_idx))

    def apply(self, cn_w, ucn_w, vn_w, chan_llr: torch.Tensor):
        """cn_w/ucn_w [I, E] or None, vn_w [I, N] or None (original edge
        order, as produced by BoostedNeuralDecoder._expanded_weights);
        chan_llr [B, N, Z] or [B, N*Z].  Returns the final APP [1, B, N*Z];
        with ``emit_syndrome`` ``(APP, ok [B])``; with ``emit_stats``
        ``(ok, bit_errors, frame_error)``."""
        res = self.decode_packed(self.pack_weights(cn_w, ucn_w, vn_w), chan_llr)
        if self.emit_stats:
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
