"""Fused BP on the GPU: the hand-written CUDA kernels ``csrc/fused_fwd.cu``
(forward, four modes) and ``csrc/fused_bwd.cu`` (backward), which keep a
word's state in one block, and, for codes too big for that, the forward
``csrc/fused_fwd_cl.cu`` (a word's state in a thread-block cluster's
distributed shared memory; ``csrc/fused_fwd_dm.cu`` in device memory where
no cluster holds it) and the backward ``csrc/fused_bwd_cl.cu`` (the same
for the adjoint; ``csrc/fused_bwd_dm.cu``); their plain
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
  backward, the message state entering every iteration; in its loss mode
  (the fused BCE step without UCN) the BCE head's gradient in place of the
  APP, and the loss;
- ``fused_bwd_k2``: the reverse-iteration adjoint ("K2"): weight, channel
  and quantized-channel gradients from the stored state and the outputs'
  cotangents.  ``FusedTrainFn`` runs K1d forward and K2 backward;
- ``fused_bce_head``: the fused BCE train step's loss head, at the end of
  ``csrc/fused_bwd.cu`` (it replaces no TPU kernel: XLA fuses the JAX
  package's loss): the final clip, the multi-iteration BCE and its gradient
  with respect to the pre-clip outputs in one pass.  ``FusedBceLossFn``
  runs it after the training forward, and the backward kernel on the
  gradient it wrote; where K1d's loss mode runs the layout
  (``k1d_loss_ok``), K1d has written both and the head does not run.

K6 is the routing of a layout, which the K1 and K2 wrappers launch: the
matmul branches of ``_fwd_kernel`` and ``_bwd_kernel`` (``routing="matmul"``;
the layout's ``routing`` "int8" for QMS, or the exact split-3 bf16
otherwise) are the same two sources instantiated with a routing template
parameter.  They run K1's and K2's own loops and route by index, with the
routing products' roundings (``route_to_edges``, ``route_to_vns``,
``_routed_negative``; in the backward the int8 mode's cotangents rounded to
``routing_dtype`` and its saturation fix) where a value is routed, so every
mode of K1 and the adjoint take a layout of any of the three routings
(``_ROUTINGS``).

The legacy engine K5 (``legacy.py``) is the forward kernel too, on a
natural-order layout with the legacy routings' roundings.

The big-code kernels replace ``_fwd_kernel_hbm`` and
``_bwd_kernel_hbm``, for codes whose lifted checks outnumber a block's
threads or whose state outgrows shared memory (``on_chip_ok``; the BG1-like
code above Z = 22):

- ``fused_fwd_k3``: K3, every mode of the TPU kernel (final APP, stats,
  syndrome, stream + store), one launch of a cluster per word where a
  cluster of at most 8 CTAs holds the word (``cluster_plan``: the BG1-like
  code up to Z = 384 and beyond), else the two-pass device-memory kernel;
- ``fused_bwd_k4``: K4, its adjoint, one launch of a cluster per word
  where a cluster of at most 8 CTAs holds the word's backward
  (``bwd_cluster_plan``: the BG1-like code at Z = 256 takes 6 CTAs, 7 with
  UCN; none holds it at Z = 384), else the device-memory kernel.  ``FusedTrainFn`` runs K3 and K4 on
  a layout built with ``hbm_store``.

Like the TPU kernels they order checks by degree (``build_layout``) and route
messages by per-edge cyclic shifts.  The TPU kernels' VMEM tiling, chunked
bounce buffers, weight-stream layouts
and ``[NZp, B]`` transpose have no GPU counterpart: the wrapper keeps the
batch-major ``[B, N*Z]`` layout.  The forward kernel's block (``k1_plan``)
holds as many whole words as let several blocks of 256 threads share an
SM's shared memory, their messages in the VN's frame and a table the block
loads once; ``fused_fwd_block_plain`` decodes through that layout on the
CPU.  The backward kernel's block (``k2_plan``) holds W whole words too,
their store rows and message cotangent carry in the VN's frame (one word
a block of up to 1,024 threads at a small batch); ``fused_bwd_block_plain``
is its twin.  Both take checks of any degree: a check above 32 edges runs
a looped code.  Two TPU
quantities survive because they fix which random numbers a sampled word
gets: the padded lift ``Zp`` and the logical stream tile ``bt``
(``FwdLayout``).

Bound on the H100: K1a moves 2 * N*Z * 4 bytes per word (channel in, APP
out), K1b N*Z*4 + 12, K1c 12, K1d with its store (1 + I) * N*Z*4 + I *
E*Z*4 and K2 reads the store, the outputs' cotangents (and, with UCN, the
outputs); K3 as K1a / K1b, or (1 + I) * N*Z*4 + (I - 1) * E*Z*4 with its
store, and K4 as K2 with I - 1 store slots; all do E*Z*I edge updates per
word.  ``chip_smoke.py`` counts the
operations per word from the kernel sources and reports the larger of the
byte and operation bounds next to the measured time.

Only the eight wrappers launch the kernels, and only for CUDA tensors; for
CPU tensors they run the plain versions ``fused_fwd_plain``,
``stats_plain``, ``sample_channel_plain``, ``fused_fwd_train_plain``,
``fused_bwd_plain``, ``fused_fwd_cl_plain``, ``fused_fwd_dm_plain``,
``fused_bwd_dm_plain`` (``fused_bwd_cl_plain`` is the cluster K4's twin) and
``fused_bce_head_plain``,
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
import functools
import math
from typing import NamedTuple, Optional

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
_F_LOSS = 65536  # K1d's loss epilogue (kLoss)
_F_ROUTE_INT8, _F_ROUTE_SPLIT3, _F_GRAD_F32 = 4096, 8192, 16384  # K6 (csrc/bp_common.cuh)
_F_ROUTE_LEGACY = 32768  # K5: bf16, or int8 with _F_ROUTE_INT8
_M32 = 0xFFFFFFFF
# lifted checks of a word the on-chip family takes: the backward kernel's
# first design ran one thread per lifted check of a block's words, and the
# bound stays so that no code changes kernel family (ROADMAP.md, Queue 2)
_MAX_THREADS = 1024
_SMEM_LIMIT = 227 * 1024


def _round8(x: int) -> int:
    return -(-x // 8) * 8


# the forward kernel's block (csrc/fused_fwd.cu, ``k1_plan``)
_K1_THREADS = 256  # kThreads: threads a block at most
_SM_SMEM = 233472  # shared memory of an H100 SM that blocks can take
_BLOCK_RESERVED = 1024  # shared memory the card keeps per block


def _k1_blocks_target(max_degree: int) -> int:
    """Blocks an SM the forward kernel is built for (its launch bound: 80
    registers a thread at 3 blocks of 256 threads, 128 at 2, for checks of
    more than 16 edges)."""
    return 3 if max_degree <= 16 else 2


def _k1_word_floats(N: int, Z: int, E: int, ucn: bool) -> int:
    """csrc/fused_fwd.cu: a word's region, channel, totals, (UCN) app and
    messages, padded so that S mod 32 is Z mod 32 rounded down to a multiple
    of 4 (two words' lanes in one warp fall in other banks)."""
    nz4 = -(-N * Z // 4) * 4
    raw = (3 if ucn else 2) * nz4 + E * Z
    return raw + ((Z % 32 & ~3) - raw) % 32


def _k1_table_ints(N: int, M: int, E: int) -> int:
    """The forward kernel's table: vn[N] int4, chk[M] int2, edge[E] int2,
    row[E], padded to a multiple of 4."""
    return -(-(4 * N + 2 * M + 3 * E) // 4) * 4


def _fwd_smem_per_word(M: int, N: int, Z: int, E: int) -> int:
    """csrc/fused_fwd.cu: one word a block with UCN: the table, the word's
    region and its two stats integers."""
    return 4 * (_k1_table_ints(N, M, E) + _k1_word_floats(N, Z, E, True) + 2)


def _bwd_smem_per_word(M: int, N: int, Z: int, E: int) -> int:
    """csrc/fused_bwd.cu: one word a block with UCN and QMS (its largest
    footprint): the table, the weight rows and the word's region."""
    return 4 * (_k2_table_ints(N, M, E) + _k2_weight_floats(E, True, True)
                + _k2_word_layout(N, M, Z, E, True, True)[0])


def _fits_on_chip(M: int, N: int, Z: int, E: int) -> bool:
    """Whether the on-chip kernels (K1, K2) take a code: at most
    ``_MAX_THREADS`` lifted checks a word, and a word's state in one
    block's shared memory in the forward and the backward kernel.  Checks
    of any degree: a check above 32 edges runs the kernels' looped code."""
    return (M * Z <= _MAX_THREADS
            and max(_fwd_smem_per_word(M, N, Z, E), _bwd_smem_per_word(M, N, Z, E))
            <= _SMEM_LIMIT)


def _max_check_degree(graph: TannerGraph) -> int:
    return int(np.diff(graph.row_ptr).max())


def on_chip_ok(graph: TannerGraph) -> bool:
    """Whether the on-chip kernels take this code (``store_space="vmem"``);
    the device-memory kernels (K3, K4) take the others."""
    return _fits_on_chip(graph.M, graph.N, graph.Z, graph.E)


def fused_capacity_ok(graph: TannerGraph) -> bool:
    """Whether either kernel family takes this code, by JAX's rule
    (``fused_train.py:231-256``): the on-chip kernels hold it, at any E
    (routed by K6 beyond the roll routing's 1024 edges), or E <= 1024 for
    the device-memory kernels, which route by roll only.  No check degree
    is refused."""
    return on_chip_ok(graph) or graph.E <= 1024


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
    # (QMS) and "split3" (exact bf16 parts); the legacy engine's (legacy.py)
    # "legacy_bf16", "legacy_f32" and "legacy_int8", which its own plain
    # version routes (``_K1_ROUNDING``: the forward kernel's hooks)
    routing: str
    grad_f32: bool  # "int8": cotangents routed in f32 (routing_dtype float32), not bf16
    edge_perm: np.ndarray  # [E] new -> old
    route_idx: torch.Tensor  # [E*Z] VN copy feeding permuted flat edge k*Z + zc
    vn_gather: torch.Tensor  # [N*Z, max_vn_degree] flat edges in sum order, E*Z = pad
    tables: torch.Tensor  # int32 kernel tables (see csrc/fused_fwd.cu, csrc/fused_bwd.cu)
    # the device-memory family's forward (K3): the cluster split where a
    # cluster holds a word's state (``cluster_plan``), else None
    cluster: Optional["ClusterSplit"] = None
    # its backward (K4): the split where a cluster holds a word's backward
    # (``bwd_cluster_plan``), else None
    bwd_cluster: Optional["BwdClusterSplit"] = None

    @property
    def k3_kernel(self) -> str:
        """Which K3 runs the layout: "cluster" (``csrc/fused_fwd_cl.cu``) or
        "two-pass" (``csrc/fused_fwd_dm.cu``, a word state no cluster holds)."""
        return "cluster" if self.cluster is not None else "two-pass"

    @property
    def k4_kernel(self) -> str:
        """Which K4 runs the layout: "cluster" (``csrc/fused_bwd_cl.cu``) or
        "device-memory" (``csrc/fused_bwd_dm.cu``, a word's backward no
        cluster holds)."""
        return "cluster" if self.bwd_cluster is not None else "device-memory"

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
        """Whole words per block of the forward kernel (``k1_plan``)."""
        return self.k1.W

    @functools.cached_property
    def k1(self) -> "K1Plan":
        """The forward kernel's block shape and table (``k1_plan``), built at
        first use."""
        return k1_plan(self)

    @functools.cached_property
    def k2_base(self) -> "K2Plan":
        """What the backward kernel's block at any batch shares (its table,
        a word's region, the words a block at most), built at first use;
        ``k2_plan(lay, batch)`` gives the block at a batch."""
        return _k2_base(self)

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
        lay = FwdLayout(
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
        if not hbm_store:
            return lay
        return dataclasses.replace(lay, cluster=cluster_plan(lay), bwd_cluster=bwd_cluster_plan(lay))


_ROUTINGS = ("roll", "int8", "split3")
# the forward kernel's rounding of a routed value (its ROUTE) for every
# layout routing: K6's int8 quantizes the decision signs too, the legacy
# engine's int8 routes them exactly; the legacy engine's float32 is roll
_K1_ROUNDING = {"roll": "exact", "int8": "int8", "split3": "split3",
                "legacy_f32": "exact", "legacy_bf16": "bf16", "legacy_int8": "int8"}


# ---------------------------------------------------------------------------
# The forward kernel's block (csrc/fused_fwd.cu)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class K1Plan:
    """How the on-chip forward kernel (K1a-K1d, K6's forward) lays out a
    block: ``W`` whole words a block of ``threads`` threads, each word a
    region of ``S`` floats in shared memory (channel at 0, totals at
    ``nz4``, with UCN the app at 2 ``nz4``, messages in the VN's frame at
    ``msg``), after ``table``, ``TAB`` int32: per VN slot (VNs sorted by
    degree, stable) (n*Z, first entry, end entry, n); per sorted check
    (first permuted edge, degree); per permuted edge k with VN n and shift s
    ((n*Z + s) | (k*Z + s) << 16, Z - s); per VN entry in slot order, each
    VN's edges in increasing original edge id, its message row k*Z.  W is as
    many words as let ``blocks_target`` blocks share an SM's shared memory,
    at least one; ``loss_W`` the same for K1d's loss mode, whose block also
    holds its words' labels and a double a thread."""

    W: int
    threads: int
    S: int
    nz4: int
    msg: int
    TAB: int
    blocks_target: int
    table: torch.Tensor
    loss_W: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the table, the words, two stats
        integers a word."""
        return _k1_smem(self.TAB, self.S, self.W)

    @property
    def loss_smem_bytes(self) -> int:
        """The same in K1d's loss mode (``loss_W`` words): the words' labels
        at a 16-byte boundary after the stats integers, then a double a
        thread."""
        return _k1_loss_smem(self.TAB, self.S, self.loss_W, self.nz4, self.threads)


def _k1_smem(TAB: int, S: int, W: int) -> int:
    return 4 * TAB + 4 * W * S + 8 * W


def _k1_loss_smem(TAB: int, S: int, W: int, nz4: int, threads: int) -> int:
    return -(-_k1_smem(TAB, S, W) // 16) * 16 + 4 * W * nz4 + 8 * threads


def _k1_table(lay: "FwdLayout") -> np.ndarray:
    M, N, E, Z = lay.M, lay.N, lay.E, lay.Z
    t = lay.tables.cpu().numpy().astype(np.int64)
    chk_off, degs = t[:M], t[M:2 * M]
    vn_p, sh_p = t[2 * M:2 * M + E], t[2 * M + E:2 * M + 2 * E]
    vn_ptr = t[2 * M + 2 * E:2 * M + 2 * E + N + 1]
    vn_list = t[2 * M + 2 * E + N + 1:2 * M + 3 * E + N + 1]
    order = np.argsort(np.diff(vn_ptr), kind="stable")  # VN slots by degree
    rows, vn = [], np.zeros((N, 4), np.int64)
    for i, n in enumerate(order):
        ks = vn_list[vn_ptr[n]:vn_ptr[n + 1]]
        vn[i] = (n * Z, len(rows), len(rows) + len(ks), n)
        rows.extend(ks * Z)
    k = np.arange(E)
    edge = np.stack([(vn_p * Z + sh_p) | ((k * Z + sh_p) << 16), Z - sh_p], axis=1)
    tab = np.concatenate([vn.reshape(-1), np.stack([chk_off, degs], 1).reshape(-1),
                          edge.reshape(-1), np.asarray(rows, np.int64)])
    out = np.zeros(_k1_table_ints(N, M, E), np.int64)
    out[:len(tab)] = tab
    return out.astype(np.uint32).view(np.int32)


def k1_plan(lay: "FwdLayout") -> K1Plan:
    """The forward kernel's block on ``lay`` (see ``K1Plan``); raises if a
    word's offsets do not fit the table's 16-bit fields."""
    M, N, E, Z = lay.M, lay.N, lay.E, lay.Z
    if N * Z > 0xFFFF or E * Z > 0xFFFF:
        raise ValueError(f"N*Z = {N * Z} or E*Z = {E * Z} exceeds the forward kernel's "
                         "16-bit offsets")
    S = _k1_word_floats(N, Z, E, lay.has_ucn)
    TAB = _k1_table_ints(N, M, E)
    target = _k1_blocks_target(lay.max_degree)
    per_word = 4 * S + 8
    budget = _SM_SMEM // target - _BLOCK_RESERVED - 4 * TAB
    W = max(1, min(budget // per_word, (_SMEM_OPTIN - 4 * TAB) // per_word))
    vec = 4 if Z % 4 == 0 else 1
    items = W * max(M * Z, N * Z // vec)
    threads = min(_K1_THREADS, -(-items // 32) * 32)
    nz4 = -(-N * Z // 4) * 4
    loss_W = W
    while loss_W > 1 and _k1_loss_smem(TAB, S, loss_W, nz4, threads) > min(
            _SM_SMEM // target - _BLOCK_RESERVED, _SMEM_OPTIN):
        loss_W -= 1
    return K1Plan(W=int(W), threads=int(threads), S=S, nz4=nz4,
                  msg=(3 if lay.has_ucn else 2) * nz4, TAB=TAB, blocks_target=target,
                  table=torch.as_tensor(_k1_table(lay), device=lay.tables.device),
                  loss_W=int(loss_W))


# ---------------------------------------------------------------------------
# The backward kernel's block (csrc/fused_bwd.cu)
# ---------------------------------------------------------------------------
_K2_THREADS = 512  # threads a block where the batch fills the card
_K2_MAX_THREADS = 1024  # kMaxThreads: a block an SM, where it does not
_K2_BLOCKS_TARGET = 2  # blocks an SM the words a block leave room for
_SMS = 132  # the H100's SMs: a batch of fewer blocks leaves SMs idle


def _k2_table_ints(N: int, M: int, E: int) -> int:
    """The backward kernel's table: the forward's (vn[N] int4, chk[M] int2,
    edge[E] int2, row[E]) and each edge's sorted check, e_chk[E], padded to
    a multiple of 4."""
    return -(-(4 * N + 2 * M + 4 * E) // 4) * 4


def _k2_weight_floats(E: int, weighted: bool, ucn: bool) -> int:
    """The iteration's CN (and UCN) weight rows a block stages."""
    return -(-E * (int(weighted) + int(ucn)) // 4) * 4


_K2_ARRAYS = ("tot", "gsums", "gchan", "gchanq", "app", "st", "gmsg", "ucn")


def _k2_word_layout(N: int, M: int, Z: int, E: int, qms: bool, ucn: bool):
    """(S, offsets) of a word's region in csrc/fused_bwd.cu, in floats: the
    channel at 0, then tot, gsums, gchan, with QMS gchanq and with UCN app
    (N*Z rounded up to 4 each), st and gmsg (E*Z rounded up to 4 each), with
    UCN a flag byte per lifted check; -1 for an array the configuration
    lacks.  S mod 32 is Z mod 32 rounded down to a multiple of 4, as the
    forward's (two words' lanes in one warp fall in other banks)."""
    nz4, ez4 = -(-N * Z // 4) * 4, -(-E * Z // 4) * 4
    sizes = {"tot": nz4, "gsums": nz4, "gchan": nz4, "gchanq": nz4 if qms else 0,
             "app": nz4 if ucn else 0, "st": ez4, "gmsg": ez4,
             "ucn": -(-M * Z // 4) if ucn else 0}
    off, o = {}, nz4
    for name in _K2_ARRAYS:
        off[name] = o if sizes[name] else -1
        o += sizes[name]
    return o + ((Z % 32 & ~3) - o) % 32, off


@dataclasses.dataclass(frozen=True)
class K2Plan:
    """How the on-chip backward kernel (K2, K6's backward) lays out a block
    at a batch: ``W`` whole words a block of ``threads`` threads, each word
    a region of ``S`` floats (``offsets``: ``_k2_word_layout``), after the
    table (``TAB`` int32: ``_k1_table``'s, then e_chk[E]) and ``WT`` floats
    of the iteration's weight rows.  ``W_max`` words a block fill the
    shared memory of ``_K2_BLOCKS_TARGET`` blocks an SM; a batch that
    fills fewer blocks than the card's SMs gets fewer words a block and up
    to 1,024 threads."""

    W: int
    threads: int
    S: int
    TAB: int
    WT: int
    W_max: int
    offsets: dict
    table: torch.Tensor

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block."""
        return 4 * (self.TAB + self.WT + self.W * self.S)


def _k2_table(lay: "FwdLayout") -> np.ndarray:
    M, N, E = lay.M, lay.N, lay.E
    t = lay.tables.cpu().numpy().astype(np.int64)
    e_chk = t[2 * M + 3 * E + N + 1:2 * M + 4 * E + N + 1]
    out = np.zeros(_k2_table_ints(N, M, E), np.int64)
    k1 = _k1_table(lay).view(np.uint32).astype(np.int64)[:4 * N + 2 * M + 3 * E]
    out[:len(k1)] = k1
    out[len(k1):len(k1) + E] = e_chk
    return out.astype(np.uint32).view(np.int32)


def _k2_base(lay: "FwdLayout") -> K2Plan:
    """The backward kernel's block with ``W = W_max`` and no thread count:
    what every batch's plan shares."""
    M, N, E, Z = lay.M, lay.N, lay.E, lay.Z
    if N * Z > 0xFFFF or E * Z > 0xFFFF:
        raise ValueError(f"N*Z = {N * Z} or E*Z = {E * Z} exceeds the backward kernel's "
                         "16-bit offsets")
    S, off = _k2_word_layout(N, M, Z, E, lay.qms_qbit is not None, lay.has_ucn)
    TAB = _k2_table_ints(N, M, E)
    WT = _k2_weight_floats(E, lay.has_cn_w or lay.has_ucn, lay.has_ucn)
    fixed = 4 * (TAB + WT)
    budget = _SM_SMEM // _K2_BLOCKS_TARGET - _BLOCK_RESERVED - fixed
    W_max = max(1, min(budget // (4 * S), (_SMEM_OPTIN - fixed) // (4 * S)))
    return K2Plan(W=int(W_max), threads=0, S=S, TAB=TAB, WT=WT, W_max=int(W_max), offsets=off,
                  table=torch.as_tensor(_k2_table(lay), device=lay.tables.device))


def k2_plan(lay: "FwdLayout", batch: int, W: Optional[int] = None,
            threads: Optional[int] = None) -> K2Plan:
    """The backward kernel's block on ``lay`` at ``batch`` words (see
    ``K2Plan``): W_max words where the batch fills ``_K2_BLOCKS_TARGET``
    blocks an SM, else fewer (one word a block at the reference's batch of
    20); threads enough for a block's items (its lifted checks, or its VN
    items of 4 lifts), at most 512, or 1,024 where a block has an SM to
    itself (the blocks are no more than the SMs, or one word fills half an
    SM's shared memory).  ``W`` and ``threads`` force a shape.  Raises if a word's
    offsets do not fit the table's 16-bit fields."""
    base = lay.k2_base
    if W is None:
        W = max(1, min(base.W_max, int(batch) // (_SMS * _K2_BLOCKS_TARGET)))
    plan = dataclasses.replace(base, W=int(W))
    if threads is None:
        vec = 4 if lay.Z % 4 == 0 else 1
        items = W * max(lay.M * lay.Z, lay.N * lay.Z // vec)
        alone = (-(-int(batch) // W) <= _SMS
                 or _SM_SMEM // (plan.smem_bytes + _BLOCK_RESERVED) < _K2_BLOCKS_TARGET)
        threads = min(_K2_MAX_THREADS if alone else _K2_THREADS, -(-items // 32) * 32)
    return dataclasses.replace(plan, threads=int(threads))


# ---------------------------------------------------------------------------
# The cluster split of K3 (csrc/fused_fwd_cl.cu)
# ---------------------------------------------------------------------------
_CLUSTER_MAX = 8  # the portable thread-block cluster size
_SMEM_OPTIN = 232448  # dynamic shared memory a block can opt into on the H100
_CL_THREADS = 1024  # threads per CTA of the cluster kernel (kThreads)
_CLUSTER_MAX_DEGREE = 32  # the cluster kernels' largest check code (slots)
# the kernel's check_one instantiations (slots) and a lifted check's cost in
# each, in SM cycles a 1,024-thread CTA spends on it (H100, per-rank clock64
# stamps of the cluster kernel on the BG1-like code at Z = 384: 4, 6, 8 and
# 20 slots measured, the others between)
_CL_BUCKETS = {4: 71, 6: 77, 8: 98, 12: 150, 16: 205, 20: 262, 24: 320, 32: 440}
# the same for the backward's phase A (csrc/fused_bwd_cl.cu), cycles a
# 1,024-thread CTA spends on 100 lifted checks (H100, per-rank clock64 stamps
# of the cluster K4's first version on the BG1-like code at Z = 256, MS x10,
# split by the forward's costs: 4, 6, 8 and 20 slots fitted, the others
# between)
_CL_BWD_BUCKETS = {4: 717, 6: 948, 8: 1445, 12: 2300, 16: 3500, 20: 5014, 24: 6200, 32: 9000}


@dataclasses.dataclass(frozen=True)
class ClusterSplit:
    """How the cluster kernel spreads one word over ``C`` CTAs.  Rank r owns
    the sorted base checks [chk_b[r], chk_b[r+1]) and keeps their edges'
    messages in the VN's frame (edge k's message from lifted check zc at
    (k - k_lo) * Z + (zc + shift_k) % Z, ``MZ`` words), a replica of
    chan_in + sums of every VN its checks touch (``RZ`` words from ``MZ``;
    with UCN a second one of the clipped APP), the table (``TAB`` ints) and
    two stats counters; its threads do the VN phase of the base VNs
    [wv_b[r], wv_b[r+1]).  ``table`` is the int32 table of
    ``csrc/fused_fwd_cl.cu``: chk_b, wv_b, rep_ptr [C+1] each, chk_k0[M],
    chk_d[M], e_at[E] ((replica offset of edge k's VN on k's rank, MZ
    included, + shift) | (its message row's offset + shift) << 16), e_wrap[E]
    (Z - shift), vn_ptr[N+1], l_loc[E] (the message row of vn_list entry e),
    need_ptr[N+1], need_loc[NN] (VN n's replica slots on the ranks that need
    it), rep_vn[NN] (each rank's replica VNs in slot order); l_loc and
    need_loc are packed owner << 24 | offset."""

    C: int
    chk_b: tuple[int, ...]
    wv_b: tuple[int, ...]
    MZ: int
    RZ: int
    NN: int
    TAB: int
    ucn: bool
    table: torch.Tensor

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of each CTA."""
        return 4 * (self.MZ + (2 if self.ucn else 1) * self.RZ + self.TAB + 2)


def _minmax_bounds(weights, C: int) -> tuple[int, ...]:
    """Boundaries 0 = b[0] <= ... <= b[C] = n of the contiguous split of
    ``weights`` into C parts whose largest sum is least (greedy under the
    least feasible cap; trailing parts may be empty)."""
    w = np.asarray(weights, np.int64)

    def greedy(cap):
        bounds, acc = [0], 0
        for i, x in enumerate(w):
            if acc + x > cap:
                bounds.append(i)
                acc = 0
            acc += x
        return bounds

    lo, hi = int(w.max(initial=0)), int(w.sum())
    while lo < hi:
        mid = (lo + hi) // 2
        if len(greedy(mid)) <= C:
            hi = mid
        else:
            lo = mid + 1
    b = greedy(lo)
    return tuple(b + [len(w)] * (C + 1 - len(b)))


def _check_cost(d: int, buckets=_CL_BUCKETS) -> int:
    """A lifted check's cost in the check phase: that of the instantiation
    it runs, the smallest of ``buckets`` that holds degree d."""
    return next(c for D, c in buckets.items() if d <= D)


def cluster_split(lay: "FwdLayout", C: int) -> ClusterSplit:
    """The split of ``lay``'s word over a cluster of ``C`` CTAs: the checks
    by their cost in the check phase where that split fits the shared
    memory, else by edges (each rank's messages as even as whole base
    checks allow); VN work by 5 a message read + 1 a push + 7 a VN (about
    the VN phase's cycles); each rank's replica holds the VNs its checks
    touch, in increasing VN order."""
    by_cost = _cluster_split(lay, C, by_cost=True)
    if by_cost.smem_bytes <= _SMEM_OPTIN:
        return by_cost
    return _cluster_split(lay, C, by_cost=False)


@dataclasses.dataclass(frozen=True)
class _Ranges:
    """What both cluster kernels' splits of a word over C ranks share: the
    layout's tables decoded (chk_off, degs, vn_p, sh_p, vn_ptr, vn_list),
    each rank's sorted base checks [chk_b[r], chk_b[r+1]) and permuted edges
    [k_b[r], k_b[r+1]), the VNs its checks touch (``reps``, increasing) and
    its base VNs of VN work [wv_b[r], wv_b[r+1])."""

    chk_off: np.ndarray
    degs: np.ndarray
    vn_p: np.ndarray
    sh_p: np.ndarray
    vn_ptr: np.ndarray
    vn_list: np.ndarray
    chk_b: tuple[int, ...]
    k_b: list
    reps: list
    wv_b: tuple[int, ...]


def _split_ranges(lay: "FwdLayout", C: int, by_cost: bool, buckets=_CL_BUCKETS) -> _Ranges:
    M, N, E = lay.M, lay.N, lay.E
    t = lay.tables.cpu().numpy().astype(np.int64)
    chk_off, degs = t[:M], t[M:2 * M]
    vn_p, sh_p = t[2 * M:2 * M + E], t[2 * M + E:2 * M + 2 * E]
    vn_ptr = t[2 * M + 2 * E:2 * M + 2 * E + N + 1]
    vn_list = t[2 * M + 2 * E + N + 1:2 * M + 3 * E + N + 1]
    chk_b = _minmax_bounds([_check_cost(d, buckets) for d in degs] if by_cost else degs, C)
    k_b = [int(chk_off[c]) if c < M else E for c in chk_b]
    reps = [np.unique(vn_p[k_b[r]:k_b[r + 1]]) for r in range(C)]
    pushes = np.zeros(N, np.int64)
    for v in reps:
        pushes[v] += 1
    wv_b = _minmax_bounds(5 * np.diff(vn_ptr) + pushes + 7, C)
    return _Ranges(chk_off, degs, vn_p, sh_p, vn_ptr, vn_list, chk_b, k_b, reps, wv_b)


def _cluster_split(lay: "FwdLayout", C: int, by_cost: bool) -> ClusterSplit:
    N, E, Z = lay.N, lay.E, lay.Z
    s = _split_ranges(lay, C, by_cost)
    chk_off, degs, vn_p, sh_p = s.chk_off, s.degs, s.vn_p, s.sh_p
    vn_ptr, vn_list, chk_b, k_b, reps, wv_b = s.vn_ptr, s.vn_list, s.chk_b, s.k_b, s.reps, s.wv_b
    MZ = max(b - a for a, b in zip(k_b, k_b[1:])) * Z
    RZ = max(len(v) for v in reps) * Z
    k_owner = np.searchsorted(k_b, np.arange(E), side="right") - 1
    row = (np.arange(E) - np.asarray(k_b)[k_owner]) * Z  # edge k's message row on its rank
    l_loc = (k_owner << 24) | row
    slot = [dict((int(n), i) for i, n in enumerate(v)) for v in reps]
    e_slot = np.array([MZ + slot[k_owner[k]][int(vn_p[k])] * Z for k in range(E)], np.int64)
    e_at = (e_slot + sh_p) | ((row + sh_p) << 16)
    needs = [[(r << 24) | (MZ + slot[r][n] * Z) for r in range(C) if n in slot[r]]
             for n in range(N)]
    need_ptr = np.concatenate([[0], np.cumsum([len(x) for x in needs])])
    rep_ptr = np.concatenate([[0], np.cumsum([len(v) for v in reps])])
    table = np.concatenate([chk_b, wv_b, rep_ptr, chk_off, degs, e_at, Z - sh_p, vn_ptr,
                            l_loc[vn_list], need_ptr, np.asarray(sum(needs, []), np.int64),
                            np.concatenate(reps)]).astype(np.int32)
    return ClusterSplit(C=C, chk_b=chk_b, wv_b=wv_b, MZ=MZ, RZ=RZ, NN=int(need_ptr[-1]),
                        TAB=len(table), ucn=lay.has_ucn,
                        table=torch.as_tensor(table, device=lay.tables.device))


def cluster_plan(lay: "FwdLayout") -> Optional[ClusterSplit]:
    """The split over the smallest cluster (at most ``_CLUSTER_MAX`` CTAs)
    whose every CTA's shared memory (at most ``_SMEM_OPTIN`` bytes) holds
    its part of the word, or None: then no cluster holds the word and K3 is
    the two-pass kernel.  Whether the card can place that cluster is its
    own answer at launch (``cluster_occupancy``).  A code with a check of
    more than 32 edges takes the two-pass kernel: the cluster kernel's check
    codes stop at 32 slots."""
    if lay.max_degree > _CLUSTER_MAX_DEGREE:
        return None
    for C in range(1, _CLUSTER_MAX + 1):
        split = cluster_split(lay, C)
        if split.smem_bytes <= _SMEM_OPTIN:
            return split
    return None


# ---------------------------------------------------------------------------
# The cluster split of K4 (csrc/fused_bwd_cl.cu)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BwdClusterSplit:
    """How the cluster K4 spreads one word's backward over ``C`` CTAs, on
    the ranges of K3's split rule (``_split_ranges``).  Rank r owns the
    sorted base checks [chk_b[r], chk_b[r+1]), i.e. the permuted edges
    [k_b[r], k_b[r+1]), and keeps, in 4-byte words: their rows in the VN's
    frame (edge k's value of lifted check zc at (k - k_b[r]) * Z + (zc +
    shift_k) % Z; ``MZ`` words), once for the store slot (then the weight
    terms) and once for the message cotangent carry; replicas (``RZ`` words
    each, from 2 ``MZ``) of chan_in + sums and of the sums cotangent at the
    VNs its checks touch, with UCN a third of the clipped APP; for its work
    VNs [wv_b[r], wv_b[r+1]) (``WZ`` words a region) the cotangent of
    chan_out, under QMS with VN weights also g_chan, with VN weights the
    VN-weight terms; with UCN a flag byte per lifted check (``FZ`` bytes);
    the table (``TAB`` ints).  ``table`` is the int32 table of
    ``csrc/fused_bwd_cl.cu``: chk_b, wv_b, k_b [C+1] each, chk_k0[M],
    chk_d[M], e_at[E] ((replica offset of edge k's VN on k's rank, 2 MZ
    included, + shift) | (its row's offset + shift) << 16), e_wrap[E] (Z -
    shift), e_chk[E] (its sorted check), vn_ptr[N+1], l_loc[E] (the row of
    vn_list entry e), need_ptr[N+1], need_loc[NN] (VN n's replica slots on
    the ranks that need it); l_loc and need_loc are packed owner << 24 |
    offset."""

    C: int
    chk_b: tuple[int, ...]
    wv_b: tuple[int, ...]
    k_b: tuple[int, ...]
    MZ: int
    RZ: int
    WZ: int
    FZ: int
    NN: int
    TAB: int
    ucn: bool
    qms: bool
    vnw: bool
    table: torch.Tensor

    @property
    def accumulators(self) -> int:
        """Accumulator regions of WZ words a rank."""
        return 1 + int(self.qms and self.vnw) + int(self.vnw)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of each CTA."""
        flags = -(-self.FZ // 4) if self.ucn else 0
        return 4 * (2 * self.MZ + (3 if self.ucn else 2) * self.RZ
                    + self.accumulators * self.WZ + flags + self.TAB)


def bwd_cluster_split(lay: "FwdLayout", C: int) -> BwdClusterSplit:
    """The split of ``lay``'s backward over a cluster of ``C`` CTAs: K3's
    ranges, by phase A's check cost (``_CL_BWD_BUCKETS``) where they fit the
    shared memory, else by edges."""
    by_cost = _bwd_cluster_split(lay, C, by_cost=True)
    if by_cost.smem_bytes <= _SMEM_OPTIN:
        return by_cost
    return _bwd_cluster_split(lay, C, by_cost=False)


def _bwd_cluster_split(lay: "FwdLayout", C: int, by_cost: bool) -> BwdClusterSplit:
    M, N, E, Z = lay.M, lay.N, lay.E, lay.Z
    s = _split_ranges(lay, C, by_cost, _CL_BWD_BUCKETS)
    k_b = s.k_b
    MZ = max(b - a for a, b in zip(k_b, k_b[1:])) * Z
    RZ = max(len(v) for v in s.reps) * Z
    WZ = max(b - a for a, b in zip(s.wv_b, s.wv_b[1:])) * Z
    FZ = max(b - a for a, b in zip(s.chk_b, s.chk_b[1:])) * Z
    k_owner = np.searchsorted(k_b, np.arange(E), side="right") - 1
    row = (np.arange(E) - np.asarray(k_b)[k_owner]) * Z  # edge k's row on its rank
    slot = [dict((int(n), i) for i, n in enumerate(v)) for v in s.reps]
    e_slot = np.array([2 * MZ + slot[k_owner[k]][int(s.vn_p[k])] * Z for k in range(E)], np.int64)
    e_at = (e_slot + s.sh_p) | ((row + s.sh_p) << 16)
    e_chk = np.repeat(np.arange(M), s.degs)
    needs = [[(r << 24) | (2 * MZ + slot[r][n] * Z) for r in range(C) if n in slot[r]]
             for n in range(N)]
    need_ptr = np.concatenate([[0], np.cumsum([len(x) for x in needs])])
    table = np.concatenate([s.chk_b, s.wv_b, k_b, s.chk_off, s.degs, e_at, Z - s.sh_p, e_chk,
                            s.vn_ptr, ((k_owner << 24) | row)[s.vn_list], need_ptr,
                            np.asarray(sum(needs, []), np.int64)]).astype(np.int32)
    return BwdClusterSplit(C=C, chk_b=s.chk_b, wv_b=s.wv_b, k_b=tuple(k_b), MZ=MZ, RZ=RZ, WZ=WZ,
                           FZ=FZ, NN=int(need_ptr[-1]), TAB=len(table), ucn=lay.has_ucn,
                           qms=lay.qms_qbit is not None, vnw=lay.has_vn_w,
                           table=torch.as_tensor(table, device=lay.tables.device))


def bwd_cluster_plan(lay: "FwdLayout") -> Optional[BwdClusterSplit]:
    """The backward's split over the smallest cluster (at most
    ``_CLUSTER_MAX`` CTAs) whose every CTA's shared memory (at most
    ``_SMEM_OPTIN`` bytes) holds its part of the word's backward, or None:
    then K4 is the device-memory kernel.  K3's split (``cluster_plan``) holds
    less a rank and is not shared.  Whether the card can place the cluster
    is its own answer at launch (``bwd_cluster_occupancy``).  A code with a
    check of more than 32 edges takes the device-memory kernel, as in
    ``cluster_plan``."""
    if lay.max_degree > _CLUSTER_MAX_DEGREE:
        return None
    for C in range(1, _CLUSTER_MAX + 1):
        split = bwd_cluster_split(lay, C)
        if split.smem_bytes <= _SMEM_OPTIN:
            return split
    return None


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


def _xa_q(chan, chan_out, lay: FwdLayout, vnw, i: int) -> torch.Tensor:
    """The weighted (and quantized) channel feeding the VN update of
    iteration ``i``: Q(chan * vn_w[i]) under QMS, chan * vn_w[i], or
    ``chan_out`` without VN weights."""
    if vnw is None:
        return chan_out
    xa = chan * torch.repeat_interleave(vnw[i], lay.Z)[None]
    return qms_quantize_value(xa, lay.qms_qbit) if lay.qms_qbit is not None else xa


def _fwd_iteration(chan, chan_out, lay: FwdLayout, cnw, ucnw, vnw, i: int, msg, sums,
                   route=None):
    """Iteration ``i`` of the forward, as both kernel families compute it:
    from the message state [B, E*Z] and VN sums [B, N*Z] entering it (zeros
    at i = 0), the ones it leaves.  ``route`` is the (VN -> edges, edges ->
    VNs) pair, ``route_to_edges`` / ``route_to_vns`` by default."""
    to_edges, to_vns = route or (route_to_edges, route_to_vns)
    B, Z = chan.shape[0], lay.Z
    xa_q = _xa_q(chan, chan_out, lay, vnw, i)
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


def _cluster_addresses(lay: FwdLayout, split: ClusterSplit, dev):
    """The cluster kernel's addresses as flat indices into the cluster's
    shared memory [C * S] (S = MZ + RZ, + RZ with UCN, words a rank),
    decoded from the split's table: (message index of each permuted flat
    edge k*Z + zc, its total's index in its rank's replica, [N*Z, max VN
    degree] message indices of each VN copy's entries in vn_list order with
    -1 past its degree, (VN copy, replica index) pairs of every replica
    slot)."""
    M, N, E, Z, C = lay.M, lay.N, lay.E, lay.Z, split.C
    S = split.MZ + (2 if split.ucn else 1) * split.RZ
    t = split.table.cpu().numpy().astype(np.int64)
    o = 3 * (C + 1)
    chk_off = t[o:o + M]
    o += 2 * M
    e_at, e_shift = t[o:o + E] & 0xFFFFFFFF, Z - t[o + E:o + 2 * E]
    e_slot = (e_at & 0xFFFF) - e_shift
    o += 2 * E
    vn_ptr, l_loc = t[o:o + N + 1], t[o + N + 1:o + N + 1 + E]
    o += N + 1 + E
    need_ptr = t[o:o + N + 1]
    need_loc = t[o + N + 1:o + N + 1 + split.NN]

    def flat(loc):
        return (loc >> 24) * S + (loc & 0xFFFFFF)

    zc = np.arange(Z)
    k_b = [int(chk_off[c]) if c < M else E for c in split.chk_b]
    k_owner = np.searchsorted(k_b, np.arange(E), side="right") - 1
    zv = (zc[None, :] + e_shift[:, None]) % Z  # the VN frame
    mloc = (k_owner * S + (np.arange(E) - np.asarray(k_b)[k_owner]) * Z)[:, None] + zv
    rloc = (k_owner * S + e_slot)[:, None] + zv
    deg = np.diff(vn_ptr)
    vidx = np.full((N, Z, max(1, int(deg.max()))), -1, np.int64)
    for n in range(N):
        for j, e in enumerate(range(vn_ptr[n], vn_ptr[n + 1])):
            vidx[n, :, j] = flat(l_loc[e]) + zc
    nvn = np.repeat(np.arange(N), np.diff(need_ptr))
    need_q = (nvn[:, None] * Z + zc).reshape(-1)
    need_dst = (flat(need_loc)[:, None] + zc).reshape(-1)
    return tuple(torch.as_tensor(a, device=dev) for a in (
        mloc.reshape(-1), rloc.reshape(-1), vidx.reshape(N * Z, -1), need_q, need_dst))


def fused_fwd_cl_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                       ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                       mode: str = "app", store: bool = False,
                       split: Optional[ClusterSplit] = None):
    """Plain version of the cluster K3 (``csrc/fused_fwd_cl.cu``) on its own
    layout: the cluster's shared memory is a tensor [B, C * S] whose rank
    regions hold what the split gives each rank (messages in the VN frame,
    the replica of chan_in + sums, with UCN of the clipped APP); the edges
    reach their replica slots and the VN copies their messages and replica
    slots through the split's table, in the kernel's phase order (check
    phase, then VN phase, every iteration) and its VN sum order.  ``split``
    defaults to ``lay.cluster``.  Returns (pre-clip APP [B, N*Z], or of
    every iteration [I, B, N*Z] with mode "stream", None with "stats"; the
    store [max(I-1, 1), B, E*Z] with "stream" and ``store``, else None;
    int32 stats [B, 3] (ok, bit errors, frame error) with "stats" and
    "syndrome", else None)."""
    split = lay.cluster if split is None else split
    B, Z, I, EZ = chan.shape[0], lay.Z, lay.n_iterations, lay.E * lay.Z
    S = split.MZ + (2 if split.ucn else 1) * split.RZ
    mloc, rloc, vidx, need_q, need_dst = _cluster_addresses(lay, split, chan.device)
    stream, store = mode == "stream", store and mode == "stream"
    stats = mode in ("stats", "syndrome")

    def chan_in(i):  # xa_q of iteration i at every VN copy
        if vnw is None:
            return _chan_out(chan, lay)
        x = chan * torch.repeat_interleave(vnw[i], Z)[None]
        return qms_quantize_value(x, lay.qms_qbit) if lay.qms_qbit is not None else x

    sm = chan.new_zeros(B, split.C * S)
    x0 = chan_in(0)
    sm[:, need_dst] = (x0 + 0.0)[:, need_q]  # the replicas, once per word
    if split.ucn:
        sm[:, need_dst + split.RZ] = x0[:, need_q]
    slots = chan.new_zeros(lay.slots, B, EZ) if store else None
    outs = []
    for i in range(I):
        # check phase: every rank's lifted checks, from its own memory
        if lay.has_ucn:
            u = _edge_parity(sm[:, rloc + split.RZ] < 0, lay).to(chan.dtype)
        old = sm[:, mloc] if i > 0 else chan.new_zeros(B, EZ)
        v2c = _clip_or_quant(sm[:, rloc] - old, lay)
        c2v = torch.cat([_check_update(v2c[:, b:b + d * n * Z].reshape(B, n, d, Z), lay)
                         .reshape(B, -1) for b, d, n in _class_ranges(lay)], dim=1)
        w_mag = c2v.abs()
        if lay.has_ucn:
            cw = torch.repeat_interleave(cnw[i], Z)[None]
            uw = torch.repeat_interleave(ucnw[i], Z)[None]
            w_mag = w_mag * (cw * (1.0 - u) + uw * u)
        elif lay.has_cn_w:
            w_mag = w_mag * torch.repeat_interleave(cnw[i], Z)[None]
        msg = _clip_or_quant(torch.clamp_min(w_mag, 0.0), lay) * torch.sign(c2v)
        sm[:, mloc] = msg
        if store and i < I - 1:
            slots[i] = msg
        # VN phase: each VN copy's messages in vn_list order; the APP, and
        # next iteration's totals (the last APP for the syndrome) pushed to
        # the replicas
        acc = torch.where((vidx[:, 0] >= 0)[None], sm[:, vidx[:, 0].clamp_min(0)], 0.0)
        for j in range(1, vidx.shape[1]):
            live = vidx[:, j] >= 0
            acc = torch.where(live[None], acc + sm[:, vidx[:, j].clamp_min(0)], acc)
        app = _chan_out(chan, lay) + acc
        if stream or i == I - 1:
            outs.append(app)
        if i < I - 1:
            sm[:, need_dst] = (chan_in(i + 1) + acc)[:, need_q]
            if split.ucn:
                sm[:, need_dst + split.RZ] = torch.clamp(app, lay.clip_lo, lay.clip_hi)[:, need_q]
        elif stats:
            sm[:, need_dst] = app[:, need_q]
    out = torch.stack(outs) if stream else outs[-1]
    st = None
    if stats:
        # bit errors over the VN copies, the syndrome over the lifted checks
        berr = (out < 0).sum(dim=1, dtype=torch.int32)
        ok = ~_edge_parity(sm[:, rloc] < 0, lay).any(1)
        st = torch.stack([ok.to(torch.int32), berr, (berr > 0).to(torch.int32)], dim=1)
    return (None if mode == "stats" else out), slots, st


def _edge_parity(neg: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """Per permuted flat edge [B, E*Z]: True where its lifted check has an
    odd number of ``neg`` edges (bool [B, E*Z] in the same order)."""
    B, Z, parts = neg.shape[0], lay.Z, []
    for base, d, n in _class_ranges(lay):
        odd = neg[:, base:base + d * n * Z].reshape(B, n, d, Z).sum(dim=2) % 2 == 1
        parts.append(odd[:, :, None, :].expand(B, n, d, Z).reshape(B, -1))
    return torch.cat(parts, dim=1)


def _block_addresses(lay: FwdLayout, plan: K1Plan, dev):
    """The forward kernel's addresses in a word's region, decoded from the
    plan's table: (its degree classes as (first permuted flat edge, degree,
    checks), from the runs of the checks' (first edge, degree); the total's
    and the message's index of each permuted flat edge k*Z + zc; [N*Z, max VN
    degree] message indices of each VN copy's entries in sum order, -1 past
    its degree; the VN of each VN copy)."""
    M, N, E, Z = lay.M, lay.N, lay.E, lay.Z
    t = plan.table.cpu().numpy().view(np.uint32).astype(np.int64)
    vn = t[:4 * N].reshape(N, 4)
    chk = t[4 * N:4 * N + 2 * M].reshape(M, 2)
    edge = t[4 * N + 2 * M:4 * N + 2 * M + 2 * E].reshape(E, 2)
    row = t[4 * N + 2 * M + 2 * E:4 * N + 2 * M + 3 * E]
    classes = []  # [first edge, degree, checks]
    for k0, d in chk:
        last = classes[-1] if classes else None
        if last and last[1] == d and last[0] + d * last[2] == k0:
            last[2] += 1
        else:
            classes.append([int(k0), int(d), 1])
    if classes[0][0] != 0 or sum(d * n for _, d, n in classes) != E:
        raise ValueError("the checks' edges do not tile the permuted edges")
    zc = np.arange(Z)
    z = zc[None, :] - np.where(zc[None, :] >= edge[:, 1:2], Z, 0)
    tot_idx = ((edge[:, 0] & 0xFFFF)[:, None] + z).reshape(-1)
    msg_idx = ((edge[:, 0] >> 16)[:, None] + z).reshape(-1)
    deg = vn[:, 2] - vn[:, 1]
    vidx = np.full((N * Z, max(1, int(deg.max()))), -1, np.int64)
    vn_of = np.zeros(N * Z, np.int64)
    for q0, e0, e1, n in vn:
        vn_of[q0 + zc] = n
        for j, e in enumerate(range(e0, e1)):
            vidx[q0 + zc, j] = row[e] + zc
    return ([(k0 * Z, d, n) for k0, d, n in classes],
            *(torch.as_tensor(a, device=dev) for a in (tot_idx, msg_idx, vidx, vn_of)))


def _routed_sums(x: torch.Tensor, vidx: torch.Tensor, rounding: str,
                 lay: FwdLayout) -> torch.Tensor:
    """Per VN copy, the sum of ``x`` [B, *] at its entries ``vidx`` [N*Z,
    max degree] (-1 past its degree) in column order from the first term, as
    the kernels' VN sums add them, with a routing's rounding: "exact";
    "int8" rint(x * scale) summed, then * (1 / scale); "bf16" each term
    rounded to bf16; "split3" one sum per bf16 part, (S_hi + S_mid) + S_lo."""
    live = [(vidx[:, j] >= 0)[None] for j in range(vidx.shape[1])]
    terms = [x[:, vidx[:, j].clamp_min(0)] for j in range(vidx.shape[1])]
    if rounding == "split3":
        parts = list(zip(*(_split3(t) for t in terms)))
    elif rounding == "int8":
        scale = _QMS_TABLE[lay.qms_qbit][2]
        parts = [[torch.round(t * scale) for t in terms]]
    elif rounding == "bf16":
        parts = [[_bf16(t) for t in terms]]
    else:
        parts = [terms]
    sums = []
    for ts in parts:
        acc = torch.where(live[0], ts[0], 0.0)
        for j in range(1, len(ts)):
            acc = torch.where(live[j], acc + ts[j], acc)
        sums.append(acc)
    if rounding == "split3":
        return (sums[0] + sums[1]) + sums[2]
    if rounding == "int8":
        return sums[0] * (1.0 / _QMS_TABLE[lay.qms_qbit][2])
    return sums[0]


def _int8_routed(x: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """K6's int8 rounding of a routed value: rint(clamp(x, +-2 q_hi) *
    scale) * (1 / scale)."""
    _, q_hi, scale = _QMS_TABLE[lay.qms_qbit]
    t = 2.0 * q_hi
    return torch.round(torch.clamp(x, -t, t) * scale) * (1.0 / scale)


def fused_fwd_block_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                          ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                          mode: str = "app", store: bool = False,
                          plan: Optional[K1Plan] = None):
    """Plain version of the forward kernel (``csrc/fused_fwd.cu``) on its own
    block layout: the shared memory of the blocks is a tensor [blocks * W,
    S] (the batch padded with zero words to whole blocks, as the kernel's
    last block holds them), each word's region laid out as ``K1Plan`` says
    (channel, totals, with UCN the app, messages in the VN's frame); the
    checks reach their totals and messages and the VN copies their message
    rows through the plan's table, in the kernel's phase order and its VN
    sum order, with the layout's routing (K6's int8 / split-3 roundings, the
    legacy engine's bf16 / int8, ``_K1_ROUNDING``).
    ``plan`` defaults to ``lay.k1``.  Returns (pre-clip APP [B, N*Z], or of
    every iteration [I, B, N*Z] with mode "stream", None with "stats"; the
    entering messages [I, B, E*Z] in the permuted flat-edge order with
    "stream" and ``store``, else None; int32 stats [B, 3] (ok, bit errors,
    frame error) with "stats" and "syndrome", else None)."""
    plan = lay.k1 if plan is None else plan
    B, Z, I, NZ = chan.shape[0], lay.Z, lay.n_iterations, lay.N * lay.Z
    classes, tot_idx, msg_idx, vidx, vn_of = _block_addresses(lay, plan, chan.device)
    stream, store = mode == "stream", store and mode == "stream"
    stats = mode in ("stats", "syndrome")
    rounding = _K1_ROUNDING[lay.routing]

    def routed(t):  # a VN total on its way to the edges
        if rounding == "int8":
            return _int8_routed(t, lay)
        return _bf16(t) if rounding == "bf16" else t

    Bp = -(-B // plan.W) * plan.W
    sm = chan.new_zeros(Bp, plan.S)
    tot = slice(plan.nz4, plan.nz4 + NZ)
    app_r = slice(2 * plan.nz4, 2 * plan.nz4 + NZ)
    msg = slice(plan.msg, plan.msg + lay.E * Z)
    sm[:B, :NZ] = chan

    def chan_in(i):  # xa_q of iteration i at every VN copy
        c = sm[:, :NZ]
        if vnw is None:
            return _chan_out(c, lay)
        x = c * vnw[i][vn_of][None]
        return qms_quantize_value(x, lay.qms_qbit) if lay.qms_qbit is not None else x

    def neg(a):  # the routed decision signs < 0
        if lay.routing == "int8":
            return _int8_routed(torch.where(a < 0, -1.0, 1.0), lay) < 0
        return a < 0

    def parity(bits):  # per permuted flat edge: its lifted check's parity of ``bits``
        parts = []
        for base, d, n in classes:
            odd = bits[:, base:base + d * n * Z].reshape(Bp, n, d, Z).sum(dim=2) % 2 == 1
            parts.append(odd[:, :, None, :].expand(Bp, n, d, Z).reshape(Bp, -1))
        return torch.cat(parts, dim=1)

    x0 = chan_in(0)
    sm[:, tot] = routed(x0 + 0.0)
    if lay.has_ucn:
        sm[:, app_r] = x0
    outs, stored = [], []
    for i in range(I):
        # check phase: every lifted check of every word, from its region
        if lay.has_ucn:
            u = parity(neg(sm[:, app_r][:, tot_idx])).to(chan.dtype)
        old = sm[:, msg][:, msg_idx] if i > 0 else chan.new_zeros(Bp, lay.E * Z)
        if store:
            stored.append(old[:B])
        v2c = _clip_or_quant(sm[:, tot][:, tot_idx] - old, lay)
        c2v = torch.cat([_check_update(v2c[:, b:b + d * n * Z].reshape(Bp, n, d, Z), lay)
                         .reshape(Bp, -1) for b, d, n in classes], dim=1)
        w_mag = c2v.abs()
        if lay.has_ucn:
            cw = torch.repeat_interleave(cnw[i], Z)[None]
            uw = torch.repeat_interleave(ucnw[i], Z)[None]
            w_mag = w_mag * (cw * (1.0 - u) + uw * u)
        elif lay.has_cn_w:
            w_mag = w_mag * torch.repeat_interleave(cnw[i], Z)[None]
        m = _clip_or_quant(torch.clamp_min(w_mag, 0.0), lay) * torch.sign(c2v)
        sm[:, plan.msg + msg_idx] = m
        # VN phase: each VN copy's message rows in sum order, the routing's
        # roundings; the APP, and the next iteration's totals
        acc = _routed_sums(sm[:, msg], vidx, rounding, lay)
        app = _chan_out(sm[:, :NZ], lay) + acc
        if stream or i == I - 1:
            outs.append(app[:B])
        if i < I - 1:
            sm[:, tot] = routed(chan_in(i + 1) + acc)
            if lay.has_ucn:
                sm[:, app_r] = torch.clamp(app, lay.clip_lo, lay.clip_hi)
        elif stats:
            sm[:, tot] = app
    out = torch.stack(outs) if stream else outs[-1]
    st = None
    if stats:
        berr = (out < 0).sum(dim=1, dtype=torch.int32)
        ok = ~parity(neg(sm[:, tot][:, tot_idx]))[:B].any(1)
        st = torch.stack([ok.to(torch.int32), berr, (berr > 0).to(torch.int32)], dim=1)
    return (None if mode == "stats" else out), (torch.stack(stored) if store else None), st


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


def _bwd_cluster_addresses(lay: FwdLayout, split: BwdClusterSplit, dev):
    """The cluster K4's addresses as flat indices into the cluster's rows
    and replicas [C * S] (S = 2 MZ + 2 RZ, + RZ with UCN, words a rank; the
    carry at + MZ, the sums cotangent at + RZ, the APP at + 2 RZ), decoded
    from the split's table: (row index of each permuted flat edge k*Z + zc,
    its totals index in its rank's replica, [N*Z, max VN degree] row indices
    of each VN copy's entries in vn_list order with -1 past its degree, (VN
    copy, replica index) pairs of every replica slot)."""
    M, N, E, Z, C = lay.M, lay.N, lay.E, lay.Z, split.C
    S = 2 * split.MZ + (3 if split.ucn else 2) * split.RZ
    t = split.table.cpu().numpy().astype(np.int64)
    k_b = t[2 * (C + 1):3 * (C + 1)]
    o = 3 * (C + 1) + 2 * M
    e_at, e_shift = t[o:o + E] & 0xFFFFFFFF, Z - t[o + E:o + 2 * E]
    o += 3 * E
    vn_ptr, l_loc = t[o:o + N + 1], t[o + N + 1:o + N + 1 + E]
    o += N + 1 + E
    need_ptr = t[o:o + N + 1]
    need_loc = t[o + N + 1:o + N + 1 + split.NN]

    def flat(loc):
        return (loc >> 24) * S + (loc & 0xFFFFFF)

    zc = np.arange(Z)
    owner = np.searchsorted(k_b, np.arange(E), side="right") - 1
    zv = (zc[None, :] + e_shift[:, None]) % Z  # the VN frame
    mloc = (owner * S + (e_at >> 16) - e_shift)[:, None] + zv
    rloc = (owner * S + (e_at & 0xFFFF) - e_shift)[:, None] + zv
    vidx = np.full((N, Z, max(1, int(np.diff(vn_ptr).max()))), -1, np.int64)
    for n in range(N):
        for j, e in enumerate(range(vn_ptr[n], vn_ptr[n + 1])):
            vidx[n, :, j] = flat(l_loc[e]) + zc
    nvn = np.repeat(np.arange(N), np.diff(need_ptr))
    need_q = (nvn[:, None] * Z + zc).reshape(-1)
    need_dst = (flat(need_loc)[:, None] + zc).reshape(-1)
    return tuple(torch.as_tensor(a, device=dev) for a in (
        mloc.reshape(-1), rloc.reshape(-1), vidx.reshape(N * Z, -1), need_q, need_dst))


def fused_bwd_cl_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                       ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                       store: torch.Tensor, outs: torch.Tensor, g_outs: torch.Tensor,
                       split: Optional[BwdClusterSplit] = None):
    """Plain twin of the cluster K4 (``csrc/fused_bwd_cl.cu``) in its own
    layout: the cluster's rows and replicas are a tensor [B, C * S] whose
    rank regions hold what the split gives each rank (store slot i-1, then
    the weight terms, and the message cotangent carry in the VN's frame; the
    replicas of chan_in + sums, of the sums cotangent and, with UCN, of the
    clipped APP); the edges reach them and the VN copies their rows and
    replica slots through the split's table, in the kernel's phase order
    (a VN phase for B0 of iteration I-1, then per iteration phase A and a VN
    phase running B1 of it and B0 of the next) and its sum orders; the
    weight gradients are per-word partials [B, I, E] / [B, I, N] summed over
    words as the wrapper sums the kernel's.  ``split`` defaults to
    ``lay.bwd_cluster``.  Takes and returns what ``fused_bwd_dm_plain``
    does; its channel gradients equal it bit for bit."""
    split = lay.bwd_cluster if split is None else split
    if split is None:
        raise ValueError("no cluster holds this layout's backward: K4 is the device-memory kernel")
    B, Z, I, N, E = chan.shape[0], lay.Z, lay.n_iterations, lay.N, lay.E
    MZ, RZ = split.MZ, split.RZ
    mloc, rloc, vidx, need_q, need_dst = _bwd_cluster_addresses(lay, split, chan.device)
    lo_m, hi_m = _msg_range(lay)
    chan_out = _chan_out(chan, lay)
    weighted = lay.has_cn_w or lay.has_ucn
    part = {"cn": chan.new_zeros(B, I, E) if weighted else None,
            "ucn": chan.new_zeros(B, I, E) if lay.has_ucn else None,
            "vn": chan.new_zeros(B, I, N) if vnw is not None else None}
    g_chan = torch.zeros_like(chan)
    g_chanq = torch.zeros_like(chan) if lay.qms_qbit is not None else None
    gq = g_chan if g_chanq is None else g_chanq  # the cotangent of chan_out
    sm = chan.new_zeros(B, split.C * (2 * MZ + (3 if split.ucn else 2) * RZ))

    def row_sum(off):  # every VN copy's rows at ``off`` in vn_list order
        acc = torch.where((vidx[:, 0] >= 0)[None], sm[:, vidx[:, 0].clamp_min(0) + off], 0.0)
        for j in range(1, vidx.shape[1]):
            live = vidx[:, j] >= 0
            acc = torch.where(live[None], acc + sm[:, vidx[:, j].clamp_min(0) + off], acc)
        return acc

    def b0(i, g_t):  # B0 of iteration i: the replicas it reads
        g = g_outs[i]
        gs = g_t + g  # the sums cotangent: out_i = chan_out + sums_i
        gq.copy_(gq + g)
        sums = row_sum(0) if i >= 1 else torch.zeros_like(chan)
        sm[:, need_dst] = (_xa_q(chan, chan_out, lay, vnw, i) + sums)[:, need_q]
        sm[:, need_dst + RZ] = gs[:, need_q]
        if lay.has_ucn:
            app = (_xa_q(chan, chan_out, lay, vnw, 0) if i == 0
                   else torch.clamp(outs[i - 1], lay.clip_lo, lay.clip_hi))
            sm[:, need_dst + 2 * RZ] = app[:, need_q]

    if I >= 2:
        sm[:, mloc] = store[I - 2]
    b0(I - 1, torch.zeros_like(chan))
    for i in reversed(range(I)):
        # phase A: every rank's lifted checks, from its own memory
        v = sm[:, rloc] - (sm[:, mloc] if i >= 1 else 0.0)
        u = (_edge_parity(sm[:, rloc + 2 * RZ] < 0, lay).to(chan.dtype) if lay.has_ucn
             else None)
        g_v2c_pre = _check_adjoints(lay, i, _clip_or_quant(v, lay),
                                    sm[:, mloc + MZ] + sm[:, rloc + RZ], cnw, ucnw, u,
                                    part["cn"], part["ucn"], per_word=True)
        sm[:, mloc + MZ] = -(g_v2c_pre * _clip_mask(v, lo_m, hi_m))
        if i >= 2:
            sm[:, mloc] = store[i - 2]
        # VN phase: B1 of iteration i, g_T = -(the carry rows' sum), then B0
        # of iteration i - 1
        g_t = -row_sum(MZ)
        if vnw is None:
            gq.copy_(gq + g_t)
        else:
            vw = torch.repeat_interleave(vnw[i], Z)[None]
            g_xa = (g_t * _clip_mask(chan * vw, *_QMS_TABLE[lay.qms_qbit][:2])
                    if lay.qms_qbit is not None else g_t)
            part["vn"][:, i] = (g_xa * chan).reshape(B, N, Z).sum(dim=2)
            g_chan.copy_(g_chan + g_xa * vw)
        if i >= 1:
            b0(i - 1, g_t)
    return _sum_partials(part, g_chan, g_chanq)


def _check_adjoints(lay: FwdLayout, i: int, v2c, g_msg_all, cnw, ucnw, u, g_cnw, g_ucnw,
                    per_word: bool = False):
    """Phase A of the backward at iteration ``i``, every degree class: the
    adjoint of the post chain and of the check update from v2c and the
    messages' cotangent [B, E*Z]; writes row ``i`` of the weight gradients
    ``g_cnw`` / ``g_ucnw`` (``u``: the UCN mask, or None; with ``per_word``
    they are per-word partials [B, I, E], summed over the lifts only) and
    returns the cotangent of v2c (before its clip mask)."""
    B, Z = v2c.shape[0], lay.Z
    dims, at = ((3,), (slice(None), i)) if per_word else ((0, 3), (i,))
    lo_m, hi_m = _msg_range(lay)
    weighted = lay.has_cn_w or lay.has_ucn
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
            cols = (*at, slice(e0, e0 + ne))
            if lay.has_ucn:
                g_cnw[cols] = (g_w * (1.0 - uc)).sum(dim=dims).reshape(g_cnw[cols].shape)
                g_ucnw[cols] = (g_w * uc).sum(dim=dims).reshape(g_ucnw[cols].shape)
            elif weighted:
                g_cnw[cols] = g_w.sum(dim=dims).reshape(g_cnw[cols].shape)
            return g_wm_pre * we if we is not None else g_wm_pre

        seg = v2c[:, sl].reshape(B, n, d, Z)
        adjoint = _sumproduct_adjoint if lay.sum_product else _minsum_adjoint
        parts.append(adjoint(seg, post).reshape(B, -1))
    return torch.cat(parts, dim=1)


def _grad_buffers(chan, lay: FwdLayout, vnw):
    """A backward's zeroed results (g_cnw [I, E], g_vnw [I, N], g_ucnw [I, E],
    g_chan, g_chanq), None where the layout has no such weight and g_chanq
    None without QMS, and the one the cotangent of chan_out lands in."""
    I, E = lay.n_iterations, lay.E
    grads = (chan.new_zeros(I, E) if lay.has_cn_w or lay.has_ucn else None,
             chan.new_zeros(I, lay.N) if vnw is not None else None,
             chan.new_zeros(I, E) if lay.has_ucn else None,
             torch.zeros_like(chan),
             torch.zeros_like(chan) if lay.qms_qbit is not None else None)
    return grads, grads[4] if grads[4] is not None else grads[3]


def _bwd_plain(chan, lay: FwdLayout, cnw, ucnw, vnw, entering, outs, g_outs):
    """The reverse pass of both kernel families; ``entering(i)`` is the
    message state entering iteration i."""
    chan_out = _chan_out(chan, lay)
    lo_m, hi_m = _msg_range(lay)
    grads, gq = _grad_buffers(chan, lay, vnw)
    g_cnw, g_vnw, g_ucnw, g_chan, _ = grads
    g_msg = chan.new_zeros(chan.shape[0], lay.E * lay.Z)
    g_sums = torch.zeros_like(chan)
    for i in reversed(range(lay.n_iterations)):
        msg_prev = entering(i)
        sums_prev = route_to_vns(msg_prev, lay)  # the forward's phase-B order
        xa_q = _xa_q(chan, chan_out, lay, vnw, i)
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
        g_v2c_pre = _check_adjoints(lay, i, v2c, g_msg_all, cnw, ucnw,
                                    u if lay.has_ucn else None, g_cnw, g_ucnw) * mask_v2c
        g_msg = -g_v2c_pre  # v2c_pre = routed - msg_{i-1}
        g_sums = route_to_vns(g_v2c_pre, lay, grad=True)  # g_T: the cotangent of sums_{i-1}
        gq += g_outs[i]
        _channel_grads(lay, i, chan, vnw, g_sums, gq, g_chan, g_vnw)
    return grads


def _channel_grads(lay: FwdLayout, i: int, chan, vnw, g_sums, gq, g_chan, g_vnw) -> None:
    """Iteration ``i``'s channel-side gradients from g_T (``g_sums``, the
    cotangent of xa_q + sums): through the VN weight and the QMS input
    quantizer into ``g_chan`` and row ``i`` of ``g_vnw``, or, without VN
    weights, into ``gq`` (xa_q is chan_out)."""
    if vnw is None:
        gq += g_sums
        return
    B, N, Z = chan.shape[0], lay.N, lay.Z
    vw = torch.repeat_interleave(vnw[i], Z)[None]
    xa = chan * vw
    qms = lay.qms_qbit is not None
    g_xa = g_sums * _clip_mask(xa, *_QMS_TABLE[lay.qms_qbit][:2]) if qms else g_sums
    g_vnw[i] = (g_xa * chan).reshape(B, N, Z).sum(dim=(0, 2))
    g_chan += g_xa * vw


def fused_bwd_block_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                          ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                          store: torch.Tensor, outs: torch.Tensor, g_outs: torch.Tensor,
                          plan: Optional[K2Plan] = None):
    """Plain twin of the backward kernel (``csrc/fused_bwd.cu``: K2, and K6
    with its routing hooks) on its own block layout: the shared memory of
    the blocks is a tensor [blocks * W, S] (the batch padded with zero words
    to whole blocks), each word's region laid out as ``K2Plan.offsets``
    says (channel, totals, carries, accumulators, with UCN the app, store
    rows and message carry in the VN's frame); the checks reach their
    totals, entries and carries and the VN copies their rows through the
    plan's table, per iteration in the kernel's phase order (L, B0, phase
    A, B1) and sum orders, K6's roundings where the kernel applies them.
    The weight gradients are per-block partials (each the sum of its live
    words' per-word terms) summed over the blocks.  ``plan`` defaults to
    ``k2_plan(lay, B)``.  Takes and returns what ``fused_bwd_plain`` does;
    its channel gradients equal it bit for bit."""
    B, Z, I, NZ, EZ = chan.shape[0], lay.Z, lay.n_iterations, lay.N * lay.Z, lay.E * lay.Z
    plan = k2_plan(lay, B) if plan is None else plan
    _, tot_idx, msg_idx, vidx, vn_of = _block_addresses(lay, plan, chan.device)
    int8 = lay.routing == "int8"
    values = {"int8": "int8", "split3": "split3"}.get(lay.routing, "exact")
    cots = "bf16" if _bf16_cotangents(lay) else "split3" if lay.routing == "split3" else "exact"
    lo_m, hi_m = _msg_range(lay)
    qms = lay.qms_qbit is not None
    W = plan.W
    Bp = -(-B // W) * W
    off = {k: v for k, v in plan.offsets.items()}
    sm = chan.new_zeros(Bp, plan.S)

    def arr(name, width=NZ):  # a word array's columns
        return slice(off[name], off[name] + width)

    def pad(t):  # [B, *] -> [Bp, *], zero words past the batch
        return torch.cat([t, t.new_zeros(Bp - B, t.shape[1])]) if Bp > B else t

    st, gmsg = arr("st", EZ), arr("gmsg", EZ)
    gq = arr("gchanq") if qms else arr("gchan")
    sm[:, :NZ] = pad(chan)
    chan_p = sm[:, :NZ]
    chan_out = _chan_out(chan_p, lay)
    weighted = lay.has_cn_w or lay.has_ucn
    part = {"cn": chan.new_zeros(Bp, I, lay.E) if weighted else None,
            "ucn": chan.new_zeros(Bp, I, lay.E) if lay.has_ucn else None,
            "vn": chan.new_zeros(Bp, I, lay.N) if vnw is not None else None}
    for i in reversed(range(I)):
        # L: store[i] into the VN frame
        sm[:, off["st"] + msg_idx] = pad(store[i])
        # B0: sums_{i-1} from the rows; g_out joins the carries; the app
        x = _xa_q(chan_p, chan_out, lay, vnw, i)
        sm[:, arr("tot")] = x + _routed_sums(sm[:, st], vidx, values, lay)
        g = pad(g_outs[i])
        gs = sm[:, arr("gsums")] + g
        sm[:, arr("gsums")] = _bf16(gs) if cots == "bf16" else gs
        sm[:, gq] = sm[:, gq] + g
        u = None
        if lay.has_ucn:
            sm[:, arr("app")] = x if i == 0 else torch.clamp(pad(outs[i - 1]), lay.clip_lo,
                                                             lay.clip_hi)
            a = sm[:, arr("app")][:, tot_idx]
            sign = torch.where(a < 0, -1.0, 1.0)
            u = _edge_parity((_int8_routed(sign, lay) if int8 else sign) < 0, lay).to(chan.dtype)
        # phase A: every lifted check from its word's region
        vt = sm[:, arr("tot")][:, tot_idx]
        sv = sm[:, st][:, msg_idx]
        if int8:
            t = 2.0 * _QMS_TABLE[lay.qms_qbit][1]
            v = _int8_routed(vt, lay) - sv
            v = torch.where((vt > t) & (v == hi_m), hi_m + 1.0,
                            torch.where((vt < -t) & (v == lo_m), lo_m - 1.0, v))
        else:
            v = vt - sv
        gin = sm[:, gmsg][:, msg_idx] + sm[:, arr("gsums")][:, tot_idx]
        g_v2c_pre = _check_adjoints(lay, i, _clip_or_quant(v, lay), gin, cnw, ucnw, u,
                                    part["cn"], part["ucn"], per_word=True)
        sm[:, off["gmsg"] + msg_idx] = -(g_v2c_pre * _clip_mask(v, lo_m, hi_m))
        # B1: g_T, the channel-side gradients
        g_t = -_routed_sums(sm[:, gmsg], vidx, cots, lay)
        if vnw is None:
            sm[:, gq] = sm[:, gq] + g_t
        else:
            vw = vnw[i][vn_of][None]
            g_xa = g_t * _clip_mask(chan_p * vw, *_QMS_TABLE[lay.qms_qbit][:2]) if qms else g_t
            part["vn"][:, i] = (g_xa * chan_p).reshape(Bp, lay.N, Z).sum(dim=2)
            sm[:, arr("gchan")] = sm[:, arr("gchan")] + g_xa * vw
        sm[:, arr("gsums")] = g_t
    # per-block partials of the live words, then summed over the blocks
    grads = []
    for k in ("cn", "vn", "ucn"):
        t = part[k]
        if t is not None:
            t = t[:B]
            t = torch.cat([t, t.new_zeros(Bp - B, *t.shape[1:])]).reshape(-1, W, *t.shape[1:])
            t = t.sum(dim=1).sum(dim=0)
        grads.append(t)
    return (*grads, sm[:B, arr("gchan")].clone(), sm[:B, gq].clone() if qms else None)


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
# entry -> (source name, C entry point, pointer, int and float arguments
# before the stream; after the stream each takes an int* to which it adds
# the CUDA kernels it launched)
_ENTRY_POINTS = {
    "fused_fwd": ("fused_fwd", "fused_fwd_launch", 14, 17, 6),
    "fused_bwd": ("fused_bwd", "fused_bwd_launch", 14, 21, 5),
    "loss_head": ("fused_bwd", "loss_head_launch", 6, 6, 2),
    "fused_fwd_dm": ("fused_fwd_dm", "fused_fwd_dm_launch", 10, 8, 5),
    "fused_fwd_cl": ("fused_fwd_cl", "fused_fwd_cl_launch", 9, 13, 5),
    "fused_bwd_dm": ("fused_bwd_dm", "fused_bwd_dm_launch", 19, 9, 5),
    "fused_bwd_cl": ("fused_bwd_cl", "fused_bwd_cl_launch", 14, 15, 5),
    "sol_probe": ("sol_probe", "sol_launch", 2, 1, 0),
}


def _kernel_fn(entry: str):
    """The C entry point ``entry`` (``_ENTRY_POINTS``), its source built at
    first use."""
    from . import _build

    source, symbol, n_ptr, n_int, n_float = _ENTRY_POINTS[entry]
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = ([vp] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float] * n_float
                       + [vp, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    return fn


def _call_kernel(entry: str, what: str, *args) -> int:
    """Calls the C entry point ``entry`` with ``args`` (the stream last);
    raises if it fails.  Returns the number of CUDA kernels the entry point
    launched, as it counted them."""
    launched = ctypes.c_int(0)
    err = _kernel_fn(entry)(*args, ctypes.byref(launched))
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


def _check_launchable(lay: FwdLayout, dev, routings: tuple = _ROUTINGS,
                      on_chip: bool = True) -> None:
    """Raises unless a kernel that takes the layout routings ``routings``
    can run ``lay`` on the CUDA device ``dev``: the on-chip kernels K1 and
    K2 take ``_ROUTINGS``, the device-memory kernels K3 and K4 roll alone,
    the legacy engine K5 its own.  ``on_chip``: also the on-chip kernels'
    fit test (K5 has its own, ``legacy.legacy_fits``)."""
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if lay.routing not in routings:
        raise ValueError(f"a layout with {lay.routing!r} routing does not run on a kernel "
                         f"that takes {routings}")
    if lay.tables.device != dev:
        raise ValueError(f"layout tables live on {lay.tables.device}, the batch on {dev}")
    if on_chip and not _fits_on_chip(lay.M, lay.N, lay.Z, lay.E):
        raise ValueError(
            f"the code (M*Z = {lay.M * lay.Z} lifted checks) does not fit the on-chip "
            "kernels; build the decoder with store_space='hbm' or 'auto' for the "
            "device-memory kernels (K3, K4)")


def _qms_args(lay: FwdLayout):
    return _QMS_TABLE[lay.qms_qbit] if lay.qms_qbit is not None else (0.0, 0.0, 1.0)


def _route_flags(lay: FwdLayout) -> int:
    """The routing bits of the on-chip kernels' flags (0 for roll)."""
    return {"int8": _F_ROUTE_INT8 | (_F_GRAD_F32 if lay.grad_f32 else 0),
            "split3": _F_ROUTE_SPLIT3, "legacy_bf16": _F_ROUTE_LEGACY,
            "legacy_int8": _F_ROUTE_LEGACY | _F_ROUTE_INT8}.get(lay.routing, 0)


def _launch(lay: FwdLayout, dev, B: int, weights, flags: int, *, chan=None, out=None,
            store=None, stats=None, chan_emit=None, widx=None, seed=0, sigma=1.0,
            bt=0, routings: tuple = _ROUTINGS, on_chip: bool = True, loss=None) -> int:
    """One launch of ``csrc/fused_fwd.cu`` on CUDA tensors in the layout's
    routing (K1; K5 with ``routings``, ``on_chip`` as ``_check_launchable``
    takes them); raises if the kernel cannot take the configuration or the
    launch fails.  ``loss``: K1d's loss epilogue, ``(bits, partials,
    loss [], i0, i1, weights)`` (the weights a host array), in blocks of
    the plan's ``loss_W`` words.  Returns the
    CUDA launches made (one; two with ``loss``)."""
    _check_launchable(lay, dev, routings, on_chip)
    flags |= _mode_flags(lay) | _route_flags(lay)
    q_lo, q_hi, q_scale = _qms_args(lay)
    plan = lay.k1
    if chan is not None and chan.data_ptr() % 16:  # the kernel reads rows 16 bytes at a time
        chan = chan.clone()
    ptr = _ptr
    bits, partials, loss_out, i0, i1, loss_w = loss or (None, None, None, 0, 0, None)
    return _call_kernel(
        "fused_fwd", f"fused_fwd launch (flags {flags})",
        ptr(chan), ptr(out), ptr(store), ptr(stats), ptr(chan_emit), ptr(widx), ptr(plan.table),
        *(ptr(w) for w in weights), ptr(bits), ptr(partials), ptr(loss_out),
        None if loss_w is None else ctypes.addressof(loss_w),
        B, lay.N, lay.M, lay.Z, lay.E, lay.n_iterations, lay.max_degree,
        plan.loss_W if loss else plan.W, plan.threads, plan.S, plan.TAB, flags, lay.Zp, bt,
        kernel_seed(int(seed)), i0, i1,
        float(sigma), lay.clip_lo, lay.clip_hi, q_lo, q_hi, q_scale,
        torch.cuda.current_stream(dev).cuda_stream,
    )


_block_answers: dict = {}  # (source, device index, max degree, flags, threads, smem) -> answer


def _block_answer(source: str, lay: FwdLayout, dev, threads: int, smem_bytes: int,
                  mode: int = 0) -> dict:
    """The card's answer for the instantiation of ``lay`` of the block
    kernel of ``csrc/<source>.cu`` (K1 or K2; ``mode``: flags that pick
    another kernel, K1d's ``_F_LOSS``) on the CUDA device ``dev`` at
    ``threads`` and ``smem_bytes`` a block: how many of its blocks an SM
    holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and
    its registers and local (spill) bytes per thread."""
    flags = _mode_flags(lay) | _route_flags(lay) | mode
    key = (source, dev.index, lay.max_degree, flags, threads, smem_bytes)
    if key not in _block_answers:
        from . import _build

        fn = getattr(_build.load(source), f"{source}_query")
        ci = ctypes.c_int
        fn.argtypes = [ci] * 4 + [ctypes.POINTER(ci)] * 3
        fn.restype = ci
        blocks, regs, local = ci(0), ci(0), ci(0)
        with torch.cuda.device(dev):
            err = fn(lay.max_degree, flags, threads, smem_bytes,
                     ctypes.byref(blocks), ctypes.byref(regs), ctypes.byref(local))
        if err != 0:
            raise RuntimeError(f"{source} query failed: CUDA error {err}")
        _block_answers[key] = dict(blocks_per_sm=blocks.value, registers=regs.value,
                                   local_bytes=local.value)
    return _block_answers[key]


def k1_occupancy(lay: FwdLayout, dev, loss: bool = False) -> dict:
    """The card's answer for ``lay``'s forward kernel (K1, in any routing)
    on the CUDA device ``dev`` (``_block_answer``), beside the plan's block
    shape; ``loss``: K1d's loss-mode kernel at its block."""
    plan = lay.k1
    W, smem = (plan.loss_W, plan.loss_smem_bytes) if loss else (plan.W, plan.smem_bytes)
    ans = _block_answer("fused_fwd", lay, dev, plan.threads, smem, _F_LOSS if loss else 0)
    return dict(ans, words_per_block=W, threads=plan.threads, smem_bytes=smem,
                blocks_target=plan.blocks_target, words_per_sm=ans["blocks_per_sm"] * W)


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
        chan = sample_channel_plain(lay, seed, sigma, torch.arange(B) if widx is None else widx, bt)
        st = stats_plain(fused_fwd_plain(chan, lay, *w), lay)
        return (st, chan) if emit_chan else st
    stats = torch.empty(B, 3, dtype=torch.int32, device=dev)
    chan_emit = torch.empty(B, lay.N * lay.Z, device=dev) if emit_chan else None
    flags = (_F_STATS | _F_SAMPLE | (_F_EMIT_CHAN if emit_chan else 0)
             | (_F_AT_IDX if widx is not None else 0))
    fused_fwd_k1c.cuda_launches += _launch(
        lay, dev, B, w, flags, stats=stats, chan_emit=chan_emit,
        widx=None if widx is None else widx.contiguous(), seed=seed, sigma=sigma, bt=bt)
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


_LOSS_MAX_ITERS = 32  # kLossMaxIters of csrc/fused_fwd.cu: the iterations a K1d loss window holds
_LOSS_MAX_ITEMS = 31  # kLossMaxItems: the VN items a thread of K1d's loss mode takes a phase


def k1d_loss_ok(lay: FwdLayout) -> bool:
    """Whether K1d's loss mode runs ``lay``: the on-chip family (K1, K2) in
    any routing, without UCN (the backward reads the outputs then), checks
    of at most 32 edges (the loss kernel's instantiations), where a block of
    ``loss_W`` words holds the labels and a thread takes at most
    ``_LOSS_MAX_ITEMS`` VN items a phase."""
    if lay.hbm_store or lay.has_ucn or lay.routing not in _ROUTINGS or lay.max_degree > 32:
        return False
    plan = lay.k1
    items = lay.N * plan.loss_W * (lay.Z // 4 if lay.Z % 4 == 0 else lay.Z)
    return (plan.loss_smem_bytes <= _SMEM_OPTIN
            and -(-items // plan.threads) <= _LOSS_MAX_ITEMS)


def fused_fwd_loss_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                         ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                         bits: torch.Tensor, i0: int, i1: int, etha: float, coeffs):
    """Plain version of K1d's loss mode: ``(g_outs [I, B, N*Z], store
    [I, B, E*Z], loss [])``, ``fused_fwd_train_plain``'s stream, then the
    loss head's arithmetic on it (``fused_bce_head_plain``)."""
    outs, st = fused_fwd_train_plain(chan, lay, cnw, ucnw, vnw)
    loss, g_outs = fused_bce_head_plain(outs, bits, lay.clip_lo, lay.clip_hi, i0, i1, etha,
                                        coeffs)
    return g_outs, st, loss


def fused_fwd_k1d(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
                  ucnw: Optional[torch.Tensor] = None, vnw: Optional[torch.Tensor] = None,
                  store: bool = True, loss=None):
    """The training forward: ``(outs [I, B, N*Z], store [I, B, E*Z] or
    None)``, the pre-clip APP of every iteration and, with ``store``, the
    message state entering every iteration (slot 0 zeros) in the permuted
    flat-edge order ``k*Z + zc``.

    ``loss``: the loss mode, ``(bits [B, N*Z], i0, i1, etha, coeffs)``, on
    a layout ``k1d_loss_ok`` takes, with ``store``: returns ``(g_outs,
    store, loss [])``, the loss head's gradient in place of the outputs and
    its loss (``fused_bce_head`` states both); ``outs`` is never made.

    A CUDA tensor launches the kernel (and raises if it cannot; the loss
    mode adds a launch that sums the blocks' partials); a CPU tensor runs
    ``fused_fwd_train_plain`` (``fused_fwd_loss_plain``).
    ``fused_fwd_k1d.launches`` counts kernel launches, ``.loss_launches``
    those in the loss mode."""
    _check_chan(chan, lay)
    dev = chan.device
    w = _check_weights(lay, dev, cnw, ucnw, vnw)
    B, I, NZ = chan.shape[0], lay.n_iterations, lay.N * lay.Z
    if loss is not None:
        bits, i0, i1, etha, coeffs = loss
        coeffs = list(coeffs)
        if not store or not k1d_loss_ok(lay):
            raise ValueError("K1d's loss mode needs the store and an on-chip layout without UCN "
                             "whose labels fit the block (k1d_loss_ok)")
        if not 0 <= i0 < i1 <= I or len(coeffs) != i1 - i0 or i1 - i0 > _LOSS_MAX_ITERS:
            raise ValueError(f"window [{i0}, {i1}) with {len(coeffs)} coeffs over {I} "
                             f"iterations (K1d's loss mode holds at most {_LOSS_MAX_ITERS})")
        bits = _check_f32(bits.to(torch.float32), (B, NZ), dev, "bits")
        if dev.type == "cpu":
            return fused_fwd_loss_plain(chan, lay, *w, bits, i0, i1, etha, coeffs)
    elif dev.type == "cpu":
        return fused_fwd_train_plain(chan, lay, *w, store=store)
    chan = chan.contiguous()
    out = torch.empty(I, B, NZ, device=dev)  # the outputs, or the loss's gradient
    st = torch.empty(I, B, lay.E * lay.Z, device=dev) if store else None
    flags = _F_STREAM | (_F_STORE if store else 0)
    extra = None
    if loss is not None:
        if bits.data_ptr() % 16:  # the labels are read 16 bytes at a time
            bits = bits.clone()
        value = torch.empty((), device=dev)
        weights = (ctypes.c_float * len(coeffs))(*_head_weights(etha, coeffs))
        extra = (bits, torch.empty(-(-B // lay.k1.loss_W), dtype=torch.float64, device=dev), value,
                 i0, i1, weights)
        flags |= _F_LOSS
    fused_fwd_k1d.cuda_launches += _launch(lay, dev, B, w, flags, chan=chan, out=out, store=st,
                                           loss=extra)
    fused_fwd_k1d.launches += 1
    if loss is None:
        return out, st
    fused_fwd_k1d.loss_launches += 1
    return out, st, value


def fused_bwd_k2(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                 ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                 store: torch.Tensor, outs: torch.Tensor, g_outs: torch.Tensor):
    """The reverse-iteration adjoint of ``fused_fwd_k1d``: from the channel
    [B, N*Z], the store [I, B, E*Z], the pre-clip outputs and their
    cotangents [I, B, N*Z], ``(g_cnw [I, E] in permuted order, g_vnw [I, N],
    g_ucnw [I, E], g_chan [B, N*Z], g_chanq [B, N*Z])``; a weight gradient is
    None where the layout has no such weight, and g_chanq None without QMS
    (its terms then land in g_chan).  The quantized channel ``chan_out`` is
    recomputed from ``chan``, as the forward kernel computes it.  Only UCN
    reads ``outs``: without it ``outs`` may be None (K1d's loss mode makes
    none).

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
    if lay.has_ucn and outs is None:
        raise ValueError("outs is required with UCN weighting")
    if dev.type == "cpu":
        return fused_bwd_plain(chan, lay, *w, store, outs, g_outs)
    _check_launchable(lay, dev)
    plan = k2_plan(lay, B)
    if plan.table.device != dev:
        raise ValueError(f"the backward table lives on {plan.table.device}, the batch on {dev}")
    # the VN phases and the store load read rows 16 bytes at a time
    chan, store, outs, g_outs = (t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                                 for t in (chan.contiguous(), store, outs, g_outs))
    g_chan = torch.empty_like(chan)
    g_chanq = torch.empty_like(chan) if lay.qms_qbit is not None else None
    blocks = -(-B // plan.W)
    part = _weight_partials(lay, blocks, dev)
    # SP's looped code (a check above 32 edges) keeps three floats an edge copy
    spx = (torch.empty(3, blocks * plan.W, lay.E * lay.Z, device=dev)
           if lay.sum_product and lay.max_degree > 32 else None)
    off = plan.offsets
    fused_bwd_k2.cuda_launches += _call_kernel(
        "fused_bwd", f"fused_bwd launch ({plan.W} words, {plan.threads} threads a block)",
        _ptr(chan), _ptr(store), _ptr(outs), _ptr(g_outs), _ptr(plan.table),
        *(_ptr(t) for t in w), _ptr(g_chan), _ptr(g_chanq),
        _ptr(part["cn"]), _ptr(part["ucn"]), _ptr(part["vn"]), _ptr(spx),
        B, lay.N, lay.M, lay.Z, lay.E, lay.n_iterations, lay.max_degree, plan.W, plan.threads,
        plan.S, plan.TAB, plan.WT, *(off[k] for k in _K2_ARRAYS),
        _mode_flags(lay) | _route_flags(lay),
        lay.clip_lo, lay.clip_hi, *_qms_args(lay),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    fused_bwd_k2.launches += 1
    return _sum_partials(part, g_chan, g_chanq)


def k2_occupancy(lay: FwdLayout, dev, batch: int) -> dict:
    """The card's answer for ``lay``'s backward kernel (K2, in any routing)
    on the CUDA device ``dev`` at ``batch`` words (``_block_answer``),
    beside the plan's block shape."""
    plan = k2_plan(lay, batch)
    ans = _block_answer("fused_bwd", lay, dev, plan.threads, plan.smem_bytes)
    return dict(ans, batch=int(batch), words_per_block=plan.W, threads=plan.threads,
                smem_bytes=plan.smem_bytes, W_max=plan.W_max,
                words_per_sm=ans["blocks_per_sm"] * plan.W)


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


_cluster_answers: dict = {}  # (device index, QMS, C, smem) -> the card's answer (K3)
_bwd_cluster_answers: dict = {}  # (device index, mode flags, C, smem) -> K4's


def _cluster_answer(source: str, kernel: str, answers: dict, mode: int, split, dev) -> dict:
    """The card's answer for the instantiation ``mode`` of the cluster
    kernel of ``csrc/<source>.cu`` on ``split``; raises if it cannot place
    one cluster."""
    key = (dev.index, mode, split.C, split.smem_bytes)
    if key not in answers:
        from . import _build

        fn = getattr(_build.load(source), f"{source}_query")
        ci = ctypes.c_int
        fn.argtypes = [ci] * 3 + [ctypes.POINTER(ci)] * 3
        fn.restype = ci
        clusters, regs, local = ci(0), ci(0), ci(0)
        with torch.cuda.device(dev):
            err = fn(int(mode), split.C, split.smem_bytes,
                     ctypes.byref(clusters), ctypes.byref(regs), ctypes.byref(local))
        if err != 0:
            raise RuntimeError(f"{source} query failed: CUDA error {err}")
        answers[key] = dict(clusters=clusters.value, registers=regs.value,
                            local_bytes=local.value, C=split.C,
                            smem_bytes=split.smem_bytes, threads=_CL_THREADS,
                            sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    ans = answers[key]
    if ans["clusters"] < 1:
        raise RuntimeError(
            f"the card cannot place a cluster of {split.C} CTAs with {split.smem_bytes} B of "
            f"shared memory each, which {kernel} needs for this code")
    return ans


def cluster_occupancy(lay: FwdLayout, dev) -> dict:
    """The card's answer for ``lay``'s cluster K3 on the CUDA device
    ``dev``: how many clusters of ``lay.cluster.C`` CTAs it holds at once
    (``cudaOccupancyMaxActiveClusters``), the instantiation's registers
    and local (spill) bytes per thread, and the card's SMs (``sms``).
    Raises if it cannot place one."""
    return _cluster_answer("fused_fwd_cl", "K3", _cluster_answers, lay.qms_qbit is not None,
                           lay.cluster, dev)


def bwd_cluster_occupancy(lay: FwdLayout, dev) -> dict:
    """The same answer for ``lay``'s cluster K4 (``lay.bwd_cluster``):
    clusters the card holds at once, registers and local bytes a thread.
    Raises if it cannot place one; K4 never falls back to the other
    kernel."""
    return _cluster_answer("fused_bwd_cl", "K4", _bwd_cluster_answers, _mode_flags(lay),
                           lay.bwd_cluster, dev)


def _k3_cluster_launch(chan, lay: FwdLayout, w, flags: int, out, st, stats, prof=None) -> int:
    """One launch of the cluster K3 on CUDA tensors (``prof``: None, or an
    int64 [C, 4 I + 2] tensor for word 0's clock64 stamps); raises if the
    card cannot place the cluster or the launch fails.  Returns the CUDA
    launches made (one)."""
    dev, split = chan.device, lay.cluster
    if split.table.device != dev:
        raise ValueError(f"the cluster table lives on {split.table.device}, the batch on {dev}")
    if chan.data_ptr() % 16:  # the VN phase reads the channel 16 bytes at a time
        chan = chan.clone()
    cluster_occupancy(lay, dev)
    return _call_kernel(
        "fused_fwd_cl", f"fused_fwd_cl launch (flags {flags}, cluster of {split.C})",
        _ptr(chan), _ptr(out), _ptr(st), _ptr(stats), _ptr(split.table),
        *(_ptr(t) for t in w), _ptr(prof),
        chan.shape[0], lay.N, lay.M, lay.Z, lay.E, lay.n_iterations, lay.max_degree, flags,
        split.C, split.MZ, split.RZ, split.NN, split.TAB, lay.clip_lo, lay.clip_hi, *_qms_args(lay), torch.cuda.current_stream(dev).cuda_stream)


def fused_fwd_k3(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
                 ucnw: Optional[torch.Tensor] = None, vnw: Optional[torch.Tensor] = None,
                 mode: str = "app", store: bool = True):
    """K3, the big codes' forward, in one of ``_fwd_kernel_hbm``'s modes:
    ``"app"`` the pre-clip final APP [B, N*Z]; ``"stats"`` int32 [B, 3]
    (ok, bit errors, frame error of all-zero words); ``"syndrome"`` (APP,
    stats); ``"stream"`` ``(outs [I, B, N*Z], store [max(I-1, 1), B, E*Z] or
    None)``, the pre-clip APP of every iteration and, with ``store``, the
    state entering iteration i in slot i-1 (K1d's ``store[1:]``), in the
    permuted flat-edge order ``k*Z + zc``.

    Where a thread-block cluster holds a word's state (``lay.cluster``,
    ``lay.k3_kernel == "cluster"``), a CUDA tensor launches
    ``csrc/fused_fwd_cl.cu`` once, a cluster per word, with no state scratch
    in device memory, and raises if the card cannot place the cluster; a CPU
    tensor runs ``fused_fwd_cl_plain``.  Only a word no cluster holds takes
    ``csrc/fused_fwd_dm.cu``, the state in device memory (a check pass and
    a VN pass each iteration, and an epilogue in the stats and syndrome
    modes), or ``fused_fwd_dm_plain`` (and ``stats_plain``) on the CPU.  ``fused_fwd_k3.launches`` counts calls,
    ``fused_fwd_k3.cuda_launches`` the CUDA launches they made.  Each
    cluster launch adds the card's answer (``cluster_occupancy``) to two
    more counters: ``.resident_ctas``, the CTAs of the clusters the card
    holds at once, and ``.sm_slots``, the card's SMs; their quotient is the
    share of the SMs that hold a cluster."""
    if mode not in _K3_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _check_chan(chan, lay)
    dev, B = chan.device, chan.shape[0]
    w = _check_weights(lay, dev, cnw, ucnw, vnw)
    stream = mode == "stream"
    store = store and stream
    if dev.type == "cpu":
        if lay.cluster is not None:
            out, st, stats = fused_fwd_cl_plain(chan, lay, *w, mode=mode, store=store)
        else:
            out, st = fused_fwd_dm_plain(chan, lay, *w, stream=stream, store=store)
            stats = stats_plain(out, lay) if mode in ("stats", "syndrome") else None
        if mode == "stats":
            return stats
        if mode == "syndrome":
            return out, stats
        return (out, st) if stream else out
    _check_launchable(lay, dev, ("roll",), on_chip=False)
    chan = chan.contiguous()
    I, NZ, EZ = lay.n_iterations, lay.N * lay.Z, lay.E * lay.Z
    out = (torch.empty(I, B, NZ, device=dev) if stream
           else None if mode == "stats" else torch.empty_like(chan))
    # a single slot at I = 1 is never written: zeros, as the plain version's
    st = (torch.zeros if I == 1 else torch.empty)(lay.slots, B, EZ, device=dev) if store else None
    stats = torch.empty(B, 3, dtype=torch.int32, device=dev) if mode in ("stats", "syndrome") else None
    flags = _mode_flags(lay) | _K3_MODES[mode] | (_F_STORE if store else 0)
    qms, stream_ptr = _qms_args(lay), torch.cuda.current_stream(dev).cuda_stream
    if lay.cluster is not None:
        fused_fwd_k3.cuda_launches += _k3_cluster_launch(chan, lay, w, flags, out, st, stats)
        ans = cluster_occupancy(lay, dev)
        fused_fwd_k3.resident_ctas += ans["clusters"] * ans["C"]
        fused_fwd_k3.sm_slots += ans["sms"]
    else:
        msg, sums = torch.empty(B, EZ, device=dev), torch.empty(B, NZ, device=dev)
        fused_fwd_k3.cuda_launches += _call_kernel(
            "fused_fwd_dm", f"fused_fwd_dm launch (flags {flags})",
            _ptr(chan), _ptr(out), _ptr(st), _ptr(msg), _ptr(sums), _ptr(stats),
            _ptr(lay.tables), *(_ptr(t) for t in w),
            B, lay.N, lay.M, lay.Z, lay.E, I, lay.max_degree, flags,
            lay.clip_lo, lay.clip_hi, *qms, stream_ptr)
    fused_fwd_k3.launches += 1
    if mode == "stats":
        return stats
    if mode == "syndrome":
        return out, stats
    return (out, st) if stream else out


def _k4_cluster_launch(chan, lay: FwdLayout, w, store, outs, g_outs, prof=None):
    """One launch of the cluster K4 on CUDA tensors (``prof``: None, or an
    int64 [C, 5 I + 2] tensor for word 0's clock64 stamps): (the gradients,
    CUDA launches made); raises if the card cannot place the cluster or the
    launch fails."""
    dev, split, B = chan.device, lay.bwd_cluster, chan.shape[0]
    if split.table.device != dev:
        raise ValueError(f"the cluster table lives on {split.table.device}, the batch on {dev}")
    # the VN phase and the store load read rows 16 bytes at a time
    chan, store, outs, g_outs = (t if t.data_ptr() % 16 == 0 else t.clone()
                                 for t in (chan, store, outs, g_outs))
    bwd_cluster_occupancy(lay, dev)
    qms = lay.qms_qbit is not None
    g_chanq = torch.empty_like(chan) if qms else None
    # under QMS without VN weights every channel term lands in g_chanq
    g_chan = (torch.zeros_like if qms and not lay.has_vn_w else torch.empty_like)(chan)
    part = _weight_partials(lay, B, dev)
    n = _call_kernel(
        "fused_bwd_cl", f"fused_bwd_cl launch (cluster of {split.C})",
        _ptr(chan), _ptr(store), _ptr(outs), _ptr(g_outs), _ptr(split.table),
        *(_ptr(t) for t in w), _ptr(g_chan), _ptr(g_chanq),
        _ptr(part["cn"]), _ptr(part["ucn"]), _ptr(part["vn"]), _ptr(prof),
        B, lay.N, lay.M, lay.Z, lay.E, lay.n_iterations, lay.max_degree, _mode_flags(lay),
        split.C, split.MZ, split.RZ, split.WZ, split.FZ, split.NN, split.TAB,
        lay.clip_lo, lay.clip_hi, *_qms_args(lay), torch.cuda.current_stream(dev).cuda_stream)
    return _sum_partials(part, g_chan, g_chanq), n


def fused_bwd_k4(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                 ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor],
                 store: torch.Tensor, outs: torch.Tensor, g_outs: torch.Tensor):
    """The adjoint of ``fused_fwd_k3``'s training forward (K4): from the
    channel [B, N*Z], K3's store [max(I-1, 1), B, E*Z], the pre-clip
    outputs and their cotangents [I, B, N*Z], what ``fused_bwd_k2``
    returns.

    Where a thread-block cluster holds a word's backward (``lay.bwd_cluster``,
    ``lay.k4_kernel == "cluster"``), a CUDA tensor launches
    ``csrc/fused_bwd_cl.cu`` once, a cluster per word, its carries in the
    cluster's shared memory, and raises if the card cannot place the
    cluster; elsewhere ``csrc/fused_bwd_dm.cu`` (3 to 5 launches per
    iteration, the carries in device memory).  A CPU tensor runs
    ``fused_bwd_dm_plain``.  ``fused_bwd_k4.launches`` counts calls,
    ``.cuda_launches`` the CUDA launches they made.  The kernels write
    weight-gradient partials, one per word (cluster) or per chunk of 64
    words (device memory); they are summed here in a fixed order."""
    _check_chan(chan, lay)
    dev, (B, NZ), I = chan.device, chan.shape, lay.n_iterations
    w = _check_weights(lay, dev, cnw, ucnw, vnw)
    store = _check_f32(store, (lay.slots, B, lay.E * lay.Z), dev, "store")
    outs = _check_f32(outs, (I, B, NZ), dev, "outs")
    g_outs = _check_f32(g_outs, (I, B, NZ), dev, "g_outs")
    if dev.type == "cpu":
        return fused_bwd_dm_plain(chan, lay, *w, store, outs, g_outs)
    _check_launchable(lay, dev, ("roll",), on_chip=False)
    chan = chan.contiguous()
    if lay.bwd_cluster is not None:
        grads, n = _k4_cluster_launch(chan, lay, w, store, outs, g_outs)
        fused_bwd_k4.cuda_launches += n
        fused_bwd_k4.launches += 1
        return grads
    EZ = lay.E * lay.Z
    g_chan = torch.zeros_like(chan)
    g_chanq = torch.zeros_like(chan) if lay.qms_qbit is not None else None
    gsums, gmsg = torch.zeros_like(chan), torch.zeros(B, EZ, device=dev)
    sums, gw = torch.empty_like(chan), torch.empty(B, EZ, device=dev)
    ucn = torch.empty(B, lay.M * lay.Z, dtype=torch.uint8, device=dev) if lay.has_ucn else None
    # SP's looped code (a check above 32 edges) keeps three floats an edge copy
    spx = torch.empty(3, B, EZ, device=dev) if lay.sum_product and lay.max_degree > 32 else None
    part = _weight_partials(lay, -(-B // _K4_CHUNK), dev)
    fused_bwd_k4.cuda_launches += _call_kernel(
        "fused_bwd_dm", "fused_bwd_dm launch",
        _ptr(chan), _ptr(store), _ptr(outs), _ptr(g_outs), _ptr(lay.tables),
        *(_ptr(t) for t in w), _ptr(g_chan), _ptr(g_chanq), _ptr(gsums), _ptr(gmsg),
        _ptr(sums), _ptr(gw), _ptr(ucn), _ptr(spx), _ptr(part["cn"]), _ptr(part["ucn"]),
        _ptr(part["vn"]),
        B, lay.N, lay.M, lay.Z, lay.E, I, lay.max_degree, _mode_flags(lay), _K4_CHUNK,
        lay.clip_lo, lay.clip_hi, *_qms_args(lay),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    fused_bwd_k4.launches += 1
    return _sum_partials(part, g_chan, g_chanq)


# ---------------------------------------------------------------------------
# The loss head of the fused BCE train step
# ---------------------------------------------------------------------------
_HEAD_THREADS = 256  # kHeadThreads of csrc/fused_bwd.cu
_HEAD_MAX_ITERS = 256  # kHeadMaxIters: the iterations a loss window may hold


def _head_weights(etha: float, coeffs) -> list:
    """The window's weights etha ** coeff, as ``multi_iteration_loss`` takes
    them (Python floats; the kernel holds them in float32)."""
    return [float(etha) ** c for c in coeffs]


def fused_bce_head_plain(outs: torch.Tensor, bits: torch.Tensor, clip_lo: float, clip_hi: float,
                         i0: int, i1: int, etha: float, coeffs):
    """Plain PyTorch version of the loss head, the kernel's arithmetic
    written out: ``(loss [], g_outs [I, B, N*Z])`` from the pre-clip outputs
    ``outs`` [I, B, N*Z] and the labels ``bits`` [B, N*Z].  The loss is
    ``multi_iteration_loss(ties.clip(outs, lo, hi)[i0:i1], bits, BCE, etha,
    coeffs)`` under STANDARD (the logit is the negated output; the fused
    engine runs no other convention), ``g_outs`` its gradient with respect
    to ``outs`` with JAX's ties, 0 outside the window.  Sums: the weighted
    terms in float64, times 1 / (sum of the weights * B*N*Z)."""
    count = bits.numel()
    dev = outs.device
    w = torch.tensor(_head_weights(etha, coeffs), dtype=torch.float32)
    wsum = 0.0
    for v in reversed(w.tolist()):  # from the last iteration down, as the kernel
        wsum += v
    scale = 1.0 / (wsum * count)
    gc = (w.double() * -scale).float()  # d l / d c = -1
    w, gc = w.to(dev).view(-1, 1, 1), gc.to(dev).view(-1, 1, 1)
    x, y = outs[i0:i1], bits.to(torch.float32)
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (clip_lo, clip_hi))
    c = torch.minimum(torch.maximum(x, lo), hi)
    dclip = torch.where((x > lo) & (x < hi), 1.0, torch.where((x == lo) | (x == hi), 0.5, 0.0))
    l = -c
    e = torch.exp(-torch.abs(l))
    term = (torch.clamp_min(l, 0.0) - l * y) + torch.log1p(e)
    loss = ((term * w).sum(dtype=torch.float64) * scale).to(torch.float32)
    s = e / (1.0 + e)
    drelu = torch.where(l > 0, 1.0, torch.where(l == 0, 0.5, 0.0))
    dl = (drelu - y) - torch.where(l >= 0, s, -s)
    g = torch.zeros_like(outs)
    g[i0:i1] = gc * dl * dclip
    return loss, g


def fused_bce_head(outs: torch.Tensor, bits: torch.Tensor, clip_lo: float, clip_hi: float,
                   i0: int, i1: int, etha: float = 1.0, coeffs=None):
    """The fused BCE step's loss head: ``(loss [], g_outs [I, B, N*Z])``,
    the loss over the window [i0, i1) of the clipped outputs and its
    gradient with respect to the pre-clip ``outs`` (``fused_bce_head_plain``
    states the function); ``coeffs`` default ``range(i1 - i0)``.

    A CUDA tensor launches the kernel of ``csrc/fused_bwd.cu`` (and raises
    if it cannot): one pass that writes ``g_outs`` and one partial sum a
    block, and a second launch that sums the partials; a CPU tensor runs
    ``fused_bce_head_plain``.  ``fused_bce_head.launches`` counts kernel
    launches, ``.cuda_launches`` the CUDA kernels they launched (two a
    call)."""
    if outs.dim() != 3:
        raise ValueError(f"outs: expected [I, B, N*Z], got {tuple(outs.shape)}")
    I, B, NZ = outs.shape
    coeffs = list(range(i1 - i0)) if coeffs is None else list(coeffs)
    if not 0 <= i0 < i1 <= I or len(coeffs) != i1 - i0:
        raise ValueError(f"window [{i0}, {i1}) with {len(coeffs)} coeffs over {I} iterations")
    if i1 - i0 > _HEAD_MAX_ITERS:
        raise ValueError(f"the loss head holds at most {_HEAD_MAX_ITERS} iterations, got {i1 - i0}")
    dev = outs.device
    outs = _check_f32(outs, (I, B, NZ), dev, "outs")
    bits = _check_f32(bits.to(torch.float32), (B, NZ), dev, "bits")
    if dev.type == "cpu":
        return fused_bce_head_plain(outs, bits, clip_lo, clip_hi, i0, i1, etha, coeffs)
    vec = 4 if B * NZ % 4 == 0 else 1  # 16-byte loads and stores where a slice splits into fours
    outs, bits = (t if vec == 1 or t.data_ptr() % 16 == 0 else t.clone() for t in (outs, bits))
    g_outs = torch.empty_like(outs)
    blocks = -(-(B * NZ // vec) // _HEAD_THREADS)
    partials = torch.empty(blocks, device=dev)
    loss = torch.empty((), device=dev)
    w = (ctypes.c_float * len(coeffs))(*_head_weights(etha, coeffs))  # copied into the launch
    fused_bce_head.cuda_launches += _call_kernel(
        "loss_head", f"loss head launch ({blocks} blocks)",
        _ptr(outs), _ptr(bits), _ptr(g_outs), _ptr(partials), _ptr(loss), ctypes.addressof(w),
        B, NZ, I, i0, i1, blocks, float(clip_lo), float(clip_hi),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    fused_bce_head.launches += 1
    return loss, g_outs


for _wrapper in (fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c, fused_fwd_k1d, fused_bwd_k2,
                 fused_fwd_k3, fused_bwd_k4, fused_bce_head):
    _wrapper.launches = 0  # calls that launched
    _wrapper.cuda_launches = 0  # CUDA kernels they launched, as the C entry points count them
del _wrapper
fused_fwd_k1d.loss_launches = 0  # launches in the loss mode
fused_fwd_k3.resident_ctas = 0  # over cluster launches: the card's clusters at once x C
fused_fwd_k3.sm_slots = 0  # over the same launches: the card's SMs


def _fwd_k1(chan: Optional[torch.Tensor], lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
            ucnw: Optional[torch.Tensor] = None, vnw: Optional[torch.Tensor] = None,
            mode: str = "app", store: bool = True, *, seed: int = 0, sigma: float = 1.0,
            batch: Optional[int] = None, widx: Optional[torch.Tensor] = None,
            stream_bt: Optional[int] = None, emit_chan: bool = False):
    """K1's modes behind one signature, ``fused_fwd_k3``'s: "app" K1a,
    "stats" and "syndrome" K1b, "stream" K1d, "sample" K1c (``chan`` None,
    the keywords as ``fused_fwd_k1c`` takes them), in the layout's routing."""
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
    layout, K1 / K2 (in the layout's routing) for an on-chip one.  The
    forward takes ``_fwd_k1``'s mode arguments."""
    if lay.hbm_store:
        return fused_fwd_k3, fused_bwd_k4
    return _fwd_k1, fused_bwd_k2


class FusedTrainFn(torch.autograd.Function):
    """The training forward and its adjoint, K1d and K2 on an on-chip
    layout in its routing (K6 where it is matmul), K3 and K4 on a
    device-memory one (``lay.hbm_store``, as JAX's ``_fwd_any`` and
    ``_vjp_bwd`` pick): ``apply(cnw, vnw, ucnw, chan, chanq, lay, store)``
    -> the pre-clip APP of every iteration [I, B, N*Z] (the custom VJP of
    the JAX wrapper).  Weights are packed (permuted edge
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


class FusedBceLossFn(torch.autograd.Function):
    """The fused BCE step's loss: ``apply(cnw, vnw, ucnw, chan, chanq, fwd,
    lay)`` -> the loss [], from ``FusedTrainDecoder.train_forward``'s result
    ``fwd`` (its store, labels [B, N*Z] and window ``(i0, i1, etha,
    coeffs)``; the forward was launched outside autograd).  Where K1d's loss
    mode ran, ``fwd`` holds the loss and its gradient with respect to the
    pre-clip outputs; else the forward runs the loss head on ``fwd.outs``,
    which writes both.  The backward runs the layout's backward kernel (K2
    or K4) on the gradient.  That kernel is linear in its cotangent, so the
    loss's cotangent scales its small outputs (the weight gradients, and the
    channel's where asked for), not the [I, B, N*Z] gradient.  Nothing
    clipped is kept: the head's gradient holds the clip's slope."""

    @staticmethod
    def forward(ctx, cnw, vnw, ucnw, chan, chanq, fwd, lay):
        loss, g_outs = fwd.loss, fwd.g_outs
        if g_outs is None:
            i0, i1, etha, coeffs = fwd.window
            loss, g_outs = fused_bce_head(fwd.outs, fwd.bits, lay.clip_lo, lay.clip_hi, i0, i1,
                                          etha, coeffs)
        ctx.lay = lay
        ctx.save_for_backward(cnw, vnw, ucnw, chan, fwd.store, fwd.outs, g_outs)
        return loss

    @staticmethod
    def backward(ctx, g):
        cnw, vnw, ucnw, chan, st, outs, g_outs = ctx.saved_tensors
        _, bwd = kernel_family(ctx.lay)
        grads = bwd(chan, ctx.lay, cnw, ucnw, vnw, st, outs, g_outs)
        return (*(t * g if t is not None and need else None
                  for t, need in zip(grads, ctx.needs_input_grad[:5])), None, None)


class TrainForward(NamedTuple):
    """``FusedTrainDecoder.train_forward``'s result: the packed weights
    (cnw, ucnw, vnw), the channel [B, N*Z] and its QMS-quantized copy (or
    None), the pre-clip outputs [I, B, N*Z], the store, the labels
    [B, N*Z] and the loss window ``(i0, i1, etha, coeffs)``; where K1d's
    loss mode ran, no outputs but the loss and its gradient with respect to
    them."""

    w: tuple
    chan: torch.Tensor
    chanq: Optional[torch.Tensor]
    outs: Optional[torch.Tensor]
    store: torch.Tensor
    bits: torch.Tensor
    window: tuple
    loss: Optional[torch.Tensor] = None
    g_outs: Optional[torch.Tensor] = None


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
    as JAX's: ``"roll"`` (index routing), ``"matmul"`` (the one-hot
    operand's roundings: K6, on-chip only) or ``"auto"``, roll up to 1024
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
        arrive per call via ``apply``).  A REFERENCE decoder raises."""
        from ...structs import Convention, DecoderType, SharingMode

        cfg = decoder.config
        if cfg.convention == Convention.REFERENCE:
            raise ValueError("fused training implements the STANDARD convention")
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
            chanq = self._quantized(chan)
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

    def _quantized(self, chan: torch.Tensor) -> Optional[torch.Tensor]:
        """The channel after the QMS input quantizer's STE, or None without
        QMS."""
        q = self.layout.qms_qbit
        return qms_quantize_ste(chan, q) if q is not None else None

    def train_forward(self, cn_w, ucn_w, vn_w, chan_llr: torch.Tensor, bits: torch.Tensor,
                      window: tuple) -> TrainForward:
        """The first half of the fused BCE step (``bce_loss`` the second):
        the weights packed (differentiable), the channel, and the training
        forward (K1d or K3) launched with its store, outside autograd:
        ``bce_loss`` owns its backward.  ``bits`` [B, N*Z] are the labels
        and ``window`` is ``(i0, i1, etha, coeffs)``, the loss's iterations
        and weights.  On a layout that K1d's loss mode runs
        (``k1d_loss_ok``, a window of at most ``_LOSS_MAX_ITERS``), K1d
        writes the loss and its gradient in place of the outputs."""
        if not self.store_msgs:
            raise ValueError("train_forward needs a training decoder (store_msgs)")
        lay = self.layout
        check_same_device(chan_llr, self.device, "chan_llr")
        w = self.pack_weights(cn_w, ucn_w, vn_w)
        B = chan_llr.shape[0]
        chan = chan_llr.reshape(B, lay.N * lay.Z).to(dtype=torch.float32)
        window = (*window[:3], tuple(window[3]))
        if k1d_loss_ok(lay) and window[1] - window[0] <= _LOSS_MAX_ITERS:
            with torch.no_grad():
                g_outs, st, loss = fused_fwd_k1d(chan, lay, *w, loss=(bits, *window))
            return TrainForward(w, chan, self._quantized(chan), None, st, bits, window, loss,
                                g_outs)
        fwd, _ = kernel_family(lay)
        with torch.no_grad():
            outs, st = fwd(chan, lay, *w, mode="stream", store=True)
        return TrainForward(w, chan, self._quantized(chan), outs, st, bits, window)

    def bce_loss(self, fwd: TrainForward) -> torch.Tensor:
        """The BCE of ``multi_iteration_loss`` over the window's iterations
        of the clipped outputs of ``fwd`` against its labels, through the
        loss head (``FusedBceLossFn``) or as K1d's loss mode wrote it:
        differentiable with respect to the weights ``train_forward`` packed
        and to the channel."""
        cnw, ucnw, vnw = fwd.w
        return FusedBceLossFn.apply(cnw, vnw, ucnw, fwd.chan, fwd.chanq, fwd, self.layout)

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
