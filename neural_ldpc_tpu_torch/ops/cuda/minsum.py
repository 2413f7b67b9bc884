"""Fused final-APP decoder: the user-facing decode entry point.

Port of ``neural_ldpc_tpu/ops/pallas/minsum.py::FusedMinsumDecoder`` with its
default stream engine, which delegates to ``FusedTrainDecoder`` in decode
mode; on CUDA tensors the decode runs through the hand-written kernel
``csrc/fused_fwd.cu``.  The legacy single-launch matmul engine (ROADMAP kernel
K5) and the per-iteration / syndrome / stats / sampling modes are not ported
yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...codes.tanner import TannerGraph
from ...device import DeviceLike, check_same_device, resolve_device
from ..quantize import _QMS_TABLE
from .fused_train import FusedTrainDecoder, fused_fwd_k1a


class FusedMinsumDecoder:
    """Builds the graph tables once and decodes ``chan_llr [B, N, Z]`` (or
    ``[B, N*Z]``) to the final-iteration APP ``[B, N*Z]``, clipped to
    ``clip``.  Weights are per-iteration ``[I, E]`` (CN, UCN) and ``[I, N]``
    (VN) in the original edge order."""

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
        engine: str = "stream",
        emit_syndrome: bool = False,
        emit_stats: bool = False,
        sample_channel: bool = False,
        emit_chan: bool = False,
        sample_at_idx: int = 0,
        device: DeviceLike = "cuda",
    ):
        if qms_qbit is not None and qms_qbit not in _QMS_TABLE:
            raise ValueError(f"unsupported qms_qbit {qms_qbit}")
        if engine == "legacy":
            raise NotImplementedError(
                "engine='legacy': not ported yet (ROADMAP kernel K5)")
        if engine != "stream":
            raise ValueError(f"unknown engine {engine!r}")
        if ucn_weights is not None and cn_weights is None:
            raise ValueError("UCN weighting requires CN weights (reference :433-503)")
        self.graph = graph
        self.device = resolve_device(device)
        self._delegate = FusedTrainDecoder(
            graph,
            n_iterations=n_iterations,
            clip=clip,
            qms_qbit=qms_qbit,
            has_cn_w=cn_weights is not None,
            has_vn_w=vn_weights is not None,
            has_ucn=ucn_weights is not None,
            sum_product=sum_product,
            stream_outputs=all_iterations,
            emit_syndrome=emit_syndrome,
            emit_stats=emit_stats,
            sample_channel=sample_channel,
            emit_chan=emit_chan,
            sample_at_idx=sample_at_idx,
            device=self.device,
        )
        self.layout = self._delegate.layout
        self._w = self._delegate.pack_weights(cn_weights, ucn_weights, vn_weights)

    @staticmethod
    def from_decoder(decoder, params, **kw) -> "FusedMinsumDecoder":
        """Build from a BoostedNeuralDecoder + its params (SP/MS/QMS, incl.
        UCN weighting — the full boosted decoder family)."""
        from ...structs import DecoderType, SharingMode

        cfg = decoder.config
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
    def __call__(self, chan_llr: torch.Tensor) -> torch.Tensor:
        """chan_llr [B, N, Z] (or [B, N*Z]) -> final APP [B, N*Z]."""
        lay = self.layout
        check_same_device(chan_llr, self.device, "chan_llr")
        B = chan_llr.shape[0]
        chan = chan_llr.reshape(B, lay.N * lay.Z).to(dtype=torch.float32)
        out = fused_fwd_k1a(chan, lay, *self._w)
        return out.clamp_(lay.clip_lo, lay.clip_hi)
