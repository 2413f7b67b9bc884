"""Fused decoder: the user-facing decode entry point.

Port of ``neural_ldpc_tpu/ops/pallas/minsum.py::FusedMinsumDecoder`` with its
default stream engine, which delegates to ``FusedTrainDecoder`` (with
``store_msgs=False``, as the JAX one does); on CUDA tensors the decode runs
through the hand-written kernel ``csrc/fused_fwd.cu`` in its final-APP
(K1a), syndrome or stats (K1b), in-kernel sampling (K1c) and, with
``all_iterations``, per-iteration stream (K1d without the store) modes, or,
for codes the on-chip kernel cannot hold (``store_space``, as JAX's), through
K3 in the same modes but sampling: the cluster kernel
``csrc/fused_fwd_cl.cu`` (one thread-block cluster a word), and the
two-pass device-memory kernel ``csrc/fused_fwd_dm.cu`` only where no
cluster holds a word.  Where the routing is matmul (beyond 1024 edges, or
as ``routing_dtype`` / ``int8_routing`` ask of it) the layout's routing is
K6's, and the same K1 modes launch the forward instantiated with the matmul
routing's roundings.  ``engine="legacy"`` is the
round-1 single-launch engine, K5 (``legacy.py``: the forward kernel with the
legacy routings' roundings), final APP only: where it cannot run (Z % 8 != 0,
``all_iterations``) it warns and delegates to the stream engine, as JAX's
does.  ``stats_packed`` has no callers and no port.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from ...codes.tanner import TannerGraph
from ...device import DeviceLike, check_same_device, resolve_device
from ...utils.profiling import DECODE_CALL, span
from ..quantize import _QMS_TABLE
from .fused_train import FusedTrainDecoder
from .legacy import fused_legacy_k5, legacy_fits, legacy_layout


class FusedMinsumDecoder:
    """Builds the graph tables once and decodes ``chan_llr [B, N, Z]`` (or
    ``[B, N*Z]``) to the final-iteration APP ``[B, N*Z]``, clipped to
    ``clip`` (with ``all_iterations``, every iteration's: ``[I, B, N*Z]``);
    with ``emit_syndrome`` to ``(APP, ok [B])``; with
    ``emit_stats`` to ``(ok, bit_errors, frame_error)`` per all-zero word.
    With ``sample_channel`` the kernel samples the channel itself:
    ``sample_stats(seed, sigma, batch)`` and, with ``sample_at_idx``,
    ``stats_sampled_at(seed, sigma, widx)``.  Weights are per-iteration
    ``[I, E]`` (CN, UCN) and ``[I, N]`` (VN) in the original edge order.
    ``routing_dtype`` (torch.bfloat16 or torch.float32) and ``int8_routing``
    (None: on for QMS) set the legacy engine's routing and are forwarded to
    the stream engine's matmul routing."""

    def __init__(
        self,
        graph: TannerGraph,
        n_iterations: int,
        clip: tuple[float, float] = (-20.0, 20.0),
        qms_qbit: Optional[int] = None,
        cn_weights=None,  # [I, E]
        vn_weights=None,  # [I, N]
        ucn_weights=None,  # [I, E]; enables the UCN split
        sum_product: bool = False,
        all_iterations: bool = False,
        bt: Optional[int] = None,  # logical stream tile of the sampler; None = auto
        routing_dtype: torch.dtype = torch.bfloat16,
        int8_routing: Optional[bool] = None,  # None = auto: on for QMS
        engine: str = "stream",  # "stream" (K1/K3/K6) | "legacy" (K5)
        # forwarded to the stream engine: "vmem" | "hbm" | "auto" message store
        store_space: str = "auto",
        emit_syndrome: bool = False,
        emit_stats: bool = False,
        sample_channel: bool = False,
        emit_chan: bool = False,
        sample_at_idx: int = 0,
        device: DeviceLike = "cuda",
    ):
        if qms_qbit is not None and qms_qbit not in _QMS_TABLE:
            raise ValueError(f"unsupported qms_qbit {qms_qbit}")
        if emit_syndrome and engine != "stream":
            raise ValueError("emit_syndrome is a stream-engine epilogue")
        if emit_stats and engine != "stream":
            raise ValueError("emit_stats is a stream-engine, final-only mode")
        if sample_channel and not emit_stats:
            raise ValueError("sample_channel is a stats-only campaign mode")
        if engine not in ("stream", "legacy"):
            raise ValueError(f"unknown engine {engine!r}")
        self.graph = graph
        self.device = resolve_device(device)
        self.engine = engine
        if int8_routing is None:
            int8_routing = qms_qbit is not None
        if engine == "legacy" and (graph.Z % 8 == 0 and not all_iterations):
            self._init_legacy(n_iterations, clip, qms_qbit, cn_weights, vn_weights, ucn_weights,
                              sum_product, bt, routing_dtype, int8_routing)
            return
        if engine == "legacy":
            warnings.warn(
                "engine='legacy' requires Z % 8 == 0 and final-only output; "
                f"this config (Z={graph.Z}, all_iterations={all_iterations}) "
                "delegates to the stream kernel instead",
                stacklevel=2,
            )
            self.engine = "stream"
        self._delegate = FusedTrainDecoder(
            graph,
            n_iterations=n_iterations,
            clip=clip,
            qms_qbit=qms_qbit,
            has_cn_w=cn_weights is not None,
            has_vn_w=vn_weights is not None,
            has_ucn=ucn_weights is not None,
            sum_product=sum_product,
            store_msgs=False,
            stream_outputs=all_iterations,
            bt=bt,
            routing_dtype=routing_dtype,
            int8_routing=int8_routing,
            store_space=store_space,
            emit_syndrome=emit_syndrome,
            emit_stats=emit_stats,
            sample_channel=sample_channel,
            emit_chan=emit_chan,
            sample_at_idx=sample_at_idx,
            device=self.device,
        )
        self.layout = self._delegate.layout
        self.bt = self._delegate.bt
        self._w = self._delegate.pack_weights(cn_weights, ucn_weights, vn_weights)

    def _init_legacy(self, n_iterations, clip, qms_qbit, cn_weights, vn_weights, ucn_weights,
                     sum_product, bt, routing_dtype, int8_routing):
        """The legacy engine (K5): its natural-order layout and weights, with
        JAX's checks (``minsum.py:449-469``)."""
        if bt is None:  # JAX's legacy rule; the legacy engine never samples
            bt = 128 if ucn_weights is not None and self.graph.E * self.graph.Z > 2500 else 512
        self.bt = bt
        if int8_routing and qms_qbit is None:
            raise ValueError("int8 routing needs QMS quantization (grid messages)")
        if ucn_weights is not None and cn_weights is None:
            raise ValueError("UCN weighting requires CN weights (reference :433-503)")
        if sum_product and qms_qbit is not None:
            raise ValueError("SP and QMS are mutually exclusive decoder types")
        self._delegate = None
        self.layout = legacy_layout(
            self.graph, n_iterations, clip, qms_qbit, sum_product,
            has_cn_w=cn_weights is not None, has_vn_w=vn_weights is not None,
            has_ucn=ucn_weights is not None, device=self.device,
            routing_dtype=routing_dtype, int8_routing=int8_routing)
        if not legacy_fits(self.layout):
            raise ValueError("code too large for the legacy engine (one word's state exceeds "
                             "shared memory); use engine='stream'")

        def as_t(w):
            return None if w is None else torch.as_tensor(
                w, dtype=torch.float32, device=self.device).contiguous()

        self._w = (as_t(cn_weights), as_t(ucn_weights), as_t(vn_weights))

    @staticmethod
    def from_decoder(decoder, params, **kw) -> "FusedMinsumDecoder":
        """Build from a BoostedNeuralDecoder + its params (SP/MS/QMS, incl.
        UCN weighting — the full boosted decoder family).  The kernels
        implement the STANDARD convention only: a REFERENCE decoder raises."""
        from ...structs import Convention, DecoderType, SharingMode

        cfg = decoder.config
        if cfg.convention == Convention.REFERENCE:
            raise ValueError(
                "fused kernel implements STANDARD-convention semantics only; "
                "REFERENCE-parity decoding uses the edge path (ops/bp.py)"
            )
        with torch.no_grad():
            cn_w, ucn_w, vn_w = decoder._expanded_weights(params)
        if cfg.sharing.ucn == SharingMode.NONE:
            ucn_w = None
        kw.setdefault("device", decoder.device)
        return FusedMinsumDecoder(
            decoder.graph,
            n_iterations=cfg.n_iterations,
            clip=(cfg.allowed_llr_range.start, cfg.allowed_llr_range.end),
            qms_qbit=cfg.qms_qbit if cfg.decoder_type == DecoderType.QMS else None,
            cn_weights=cn_w,
            vn_weights=vn_w,
            ucn_weights=ucn_w,
            sum_product=cfg.decoder_type == DecoderType.SP,
            **kw,
        )

    @torch.no_grad()
    def __call__(self, chan_llr: torch.Tensor):
        """chan_llr [B, N, Z] (or [B, N*Z]) -> final APP [B, N*Z] (with
        ``all_iterations`` every iteration's, [I, B, N*Z]); with
        ``emit_syndrome`` ``(APP, ok)``; with ``emit_stats`` ``(ok,
        bit_errors, frame_error)``."""
        with span(DECODE_CALL):
            if self._delegate is not None:
                return self._delegate.decode_packed(self._w, chan_llr)
            check_same_device(chan_llr, self.device, "chan_llr")
            lay = self.layout
            chan = chan_llr.reshape(chan_llr.shape[0], lay.N * lay.Z).to(dtype=torch.float32)
            return fused_legacy_k5(chan, lay, *self._w).clamp_(lay.clip_lo, lay.clip_hi)

    @torch.no_grad()
    def sample_stats(self, seed: int, sigma: float, batch: int):
        """Stats-only decode with in-kernel channel sampling: ``(ok,
        bit_errors, frame_error)`` of ``batch`` all-zero words; with
        ``emit_chan`` also their sampled LLRs [B, N, Z].  ``seed`` is an
        int32 (vary it per batch), ``sigma`` the noise std."""
        if self._delegate is None:
            raise ValueError("construct with sample_channel=True")
        return self._delegate.sample_packed(self._w, seed, sigma, batch)

    @torch.no_grad()
    def stats_sampled_at(self, seed: int, sigma: float, widx: torch.Tensor):
        """Stats-only decode of the words at original batch indices ``widx``
        [K] int32, re-sampling their channel in the kernel from the stream of
        the phase-1 sampler (construct with sample_channel=True,
        sample_at_idx=<phase-1 bt>)."""
        if self._delegate is None:
            raise ValueError("construct with sample_at_idx=<phase-1 bt>")
        return self._delegate.sample_at_packed(self._w, seed, sigma, widx)
