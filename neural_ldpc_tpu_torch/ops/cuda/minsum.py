"""Fused decoder: the user-facing decode entry point.

Port of ``neural_ldpc_tpu/ops/pallas/minsum.py::FusedMinsumDecoder`` with its
default stream engine, which delegates to ``FusedTrainDecoder`` (with
``store_msgs=False``, as the JAX one does); on CUDA tensors the decode runs
through the hand-written kernel ``csrc/fused_fwd.cu`` in its final-APP
(K1a), syndrome or stats (K1b), in-kernel sampling (K1c) and, with
``all_iterations``, per-iteration stream (K1d without the store) modes, or,
for codes the on-chip kernel cannot hold (``store_space``, as JAX's), through
the device-memory kernel ``csrc/fused_fwd_dm.cu`` (K3) in the same modes
but sampling.  The
legacy single-launch matmul engine (ROADMAP kernel K5) is not ported yet and
raises ``NotImplementedError``; ``stats_packed`` has no callers and no
port.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...codes.tanner import TannerGraph
from ...device import DeviceLike, resolve_device
from .fused_train import FusedTrainDecoder


class FusedMinsumDecoder:
    """Builds the graph tables once and decodes ``chan_llr [B, N, Z]`` (or
    ``[B, N*Z]``) to the final-iteration APP ``[B, N*Z]``, clipped to
    ``clip`` (with ``all_iterations``, every iteration's: ``[I, B, N*Z]``);
    with ``emit_syndrome`` to ``(APP, ok [B])``; with
    ``emit_stats`` to ``(ok, bit_errors, frame_error)`` per all-zero word.
    With ``sample_channel`` the kernel samples the channel itself:
    ``sample_stats(seed, sigma, batch)`` and, with ``sample_at_idx``,
    ``stats_sampled_at(seed, sigma, widx)``.  Weights are per-iteration
    ``[I, E]`` (CN, UCN) and ``[I, N]`` (VN) in the original edge order."""

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
        engine: str = "stream",
        # forwarded to the stream engine: "vmem" | "hbm" | "auto" message store
        store_space: str = "auto",
        emit_syndrome: bool = False,
        emit_stats: bool = False,
        sample_channel: bool = False,
        emit_chan: bool = False,
        sample_at_idx: int = 0,
        device: DeviceLike = "cuda",
    ):
        if engine == "legacy":
            raise NotImplementedError(
                "engine='legacy': not ported yet (ROADMAP kernel K5)")
        if engine != "stream":
            raise ValueError(f"unknown engine {engine!r}")
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
            store_msgs=False,
            stream_outputs=all_iterations,
            bt=bt,
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
    def __call__(self, chan_llr: torch.Tensor):
        """chan_llr [B, N, Z] (or [B, N*Z]) -> final APP [B, N*Z] (with
        ``all_iterations`` every iteration's, [I, B, N*Z]); with
        ``emit_syndrome`` ``(APP, ok)``; with ``emit_stats`` ``(ok,
        bit_errors, frame_error)``."""
        return self._delegate.decode_packed(self._w, chan_llr)

    @torch.no_grad()
    def sample_stats(self, seed: int, sigma: float, batch: int):
        """Stats-only decode with in-kernel channel sampling: ``(ok,
        bit_errors, frame_error)`` of ``batch`` all-zero words; with
        ``emit_chan`` also their sampled LLRs [B, N, Z].  ``seed`` is an
        int32 (vary it per batch), ``sigma`` the noise std."""
        return self._delegate.sample_packed(self._w, seed, sigma, batch)

    @torch.no_grad()
    def stats_sampled_at(self, seed: int, sigma: float, widx: torch.Tensor):
        """Stats-only decode of the words at original batch indices ``widx``
        [K] int32, re-sampling their channel in the kernel from the stream of
        the phase-1 sampler (construct with sample_channel=True,
        sample_at_idx=<phase-1 bt>)."""
        return self._delegate.sample_at_packed(self._w, seed, sigma, widx)
