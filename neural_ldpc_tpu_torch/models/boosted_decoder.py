"""Boosted neural LDPC decoder (Kwak et al., arXiv:2310.07194) — plain PyTorch.

The per-iteration loop runs over stacked per-iteration weights on the flat
[B, E*Z] message layout with index-gather routing (``ops/flat.py``).  This is
the port's CPU ground truth, its autograd engine, and the reference the CUDA
decode kernel (``ops/cuda``) is held against.

SP / MS / QMS variants (reference :400-423), node weight-sharing modes 0-6
per node type (:108-151,:216-236), UCN detection with separate UCN weights
(:339-374,:431-503), STE quantization (:187-214) and LLR clipping
(:386-393,:507-521) are supported under the STANDARD convention.  The
REFERENCE convention (the reference's epsilon hacks and CN sign factor) needs
the edge path, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..codes.tanner import TannerGraph
from ..device import DeviceLike, resolve_device
from ..ops import flat, ties
from ..ops.quantize import qms_quantize_ste
from ..structs import Clipping, Convention, DecoderType, NodeWeightSharingConfig, SharingMode
from .sharing import build_sharing_specs

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BoostedDecoderConfig:
    """Static decoder configuration (reference constructor kwargs, :15-49)."""

    n_iterations: int = 20
    decoder_type: DecoderType = DecoderType.QMS
    qms_qbit: int = 5
    sharing: NodeWeightSharingConfig = NodeWeightSharingConfig(
        cn=SharingMode.ITER, ucn=SharingMode.NONE, vn=SharingMode.NONE
    )
    fixed_iterative_nodes: tuple[int, ...] = ()
    fixed_iterative_nodes_init_weight: int = 0
    allowed_weight_range: Clipping = Clipping(start=0.0, end=2.0)
    allowed_bias_range: Clipping = Clipping(start=0.0, end=2.0)
    allowed_llr_range: Clipping = Clipping(start=-20.0, end=20.0)
    init_cn_weight: float = 1.0
    init_ucn_weight: float = 1.0
    init_vn_weight: float = 1.0
    convention: Convention = Convention.STANDARD


def params_from_numpy(arrays, device: DeviceLike = "cuda") -> Params:
    """Weights from numpy arrays (``weight_cn`` / ``weight_ucn`` /
    ``weight_vn``, the keys of ``trained/*.npz`` and ``init_params``) as
    float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {
        k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        for k, v in dict(arrays).items()
        if k.startswith("weight_")
    }


def load_params_npz(path: str, device: DeviceLike = "cuda") -> Params:
    """Load a trained-weights ``.npz`` (e.g. ``trained/bg2_qms20_ref500ep.npz``)."""
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files}, device)


class BoostedNeuralDecoder(nn.Module):
    """Holds static config + graph index tables; the weights travel in a
    params dict (``init_params`` / ``params_from_numpy``), as in the JAX
    package, so one decoder serves many weight sets."""

    def __init__(self, graph: TannerGraph,
                 config: BoostedDecoderConfig = BoostedDecoderConfig(),
                 device: DeviceLike = "cuda"):
        super().__init__()
        if config.convention == Convention.REFERENCE:
            raise NotImplementedError(
                "the REFERENCE convention needs the edge path (ops/bp.py), "
                "not ported yet: ROADMAP Queue 1 item 9"
            )
        if config.sharing.ucn != SharingMode.NONE and config.sharing.cn == SharingMode.NONE:
            raise ValueError("UCN weighting requires CN weighting (reference forward :433-503)")
        self.graph = graph
        self.config = config
        self.device = resolve_device(device)
        self.specs = build_sharing_specs(
            graph, config.sharing, config.n_iterations, config.fixed_iterative_nodes
        )
        self.fa = flat.FlatGraphArrays.from_graph(graph, self.device)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    def init_params(self) -> Params:
        init = {
            "cn": self.config.init_cn_weight,
            "ucn": self.config.init_ucn_weight,
            "vn": self.config.init_vn_weight,
        }
        params = {}
        for key, spec in self.specs.items():
            w = spec.init(init[key], device=self.device)
            if w is not None:
                params[f"weight_{key}"] = w
        return params

    def clamp_params(self, params: Params) -> Params:
        """Projection step after each optimizer update (reference
        _apply_constraints, :153-179)."""
        r = self.config.allowed_weight_range
        return {k: torch.clamp(v, r.start, r.end) for k, v in params.items()}

    def trainable_row_masks(self) -> dict[str, torch.Tensor]:
        """Per-weight row masks (1 = trainable) implementing
        ``fixed_iterative_nodes_init_weight`` freezing."""
        masks = {}
        for key, spec in self.specs.items():
            m = spec.trainable_row_mask(self.config.fixed_iterative_nodes_init_weight)
            if m is not None:
                masks[f"weight_{key}"] = torch.as_tensor(m, device=self.device)[:, None]
        return masks

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def _expanded_weights(
        self,
        params: Params,
        fixed_iter_weights: Optional[dict[str, dict[int, torch.Tensor]]] = None,
    ):
        """(cn [I, E] | None, ucn [I, E] | None, vn [I, N] | None)."""
        ov = fixed_iter_weights or {}
        node_of_edge = self.graph.cn_of_edge
        cn = self.specs["cn"].expand_to_edges(params.get("weight_cn"), node_of_edge, ov.get("cn"))
        ucn = self.specs["ucn"].expand_to_edges(params.get("weight_ucn"), node_of_edge, ov.get("ucn"))
        vn = self.specs["vn"].expand_to_nodes(params.get("weight_vn"), ov.get("vn"))
        return cn, ucn, vn

    def apply(
        self,
        params: Params,
        chan_llr: torch.Tensor,
        fixed_iter_weights: Optional[dict[str, dict[int, torch.Tensor]]] = None,
    ) -> torch.Tensor:
        """Run all iterations.  chan_llr: [B, N, Z] (flat bit n*Z+z order, as
        produced by the channel).  Returns per-iteration APP outputs
        [I, B, N*Z] (reference forward returns the same as a list, :533-538).
        """
        cfg = self.config
        fa = self.fa
        is_qms = cfg.decoder_type == DecoderType.QMS
        llr_lo, llr_hi = cfg.allowed_llr_range.start, cfg.allowed_llr_range.end

        B = chan_llr.shape[0]
        chan = chan_llr.to(torch.float32).reshape(B, fa.N * fa.Z)  # [B, NZ]
        chan_out = qms_quantize_ste(chan, cfg.qms_qbit) if is_qms else chan

        cn_w, ucn_w, vn_w = self._expanded_weights(params, fixed_iter_weights)
        use_ucn = cfg.sharing.ucn != SharingMode.NONE

        msg = chan.new_zeros(B, fa.E * fa.Z)
        vn_sums = chan.new_zeros(B, fa.N * fa.Z)
        prev_app = chan.new_zeros(B, fa.N * fa.Z)
        outs = []
        for i in range(cfg.n_iterations):
            # VN input weighting + quantization (reference :325-337)
            xa_w = chan * fa.vn_weights_to_flat(vn_w[i])[None] if vn_w is not None else chan
            xa_q = qms_quantize_ste(xa_w, cfg.qms_qbit) if is_qms else xa_w

            # UCN detection from previous APP (reference :339-374)
            if use_ucn:
                ucn_mask = flat.check_parity_flat(xa_q if i == 0 else prev_app, fa)
                scn_mask = 1.0 - ucn_mask

            # VN update, routing + lift in one gather (reference :376-384)
            v2c = flat.route_to_edges(xa_q + vn_sums, fa) - msg

            # pre-CN clip / quantize (reference :386-389)
            if is_qms:
                v2c = qms_quantize_ste(v2c, cfg.qms_qbit)
            else:
                v2c = ties.clip(v2c, llr_lo, llr_hi)

            # CN update (reference :391-423)
            if cfg.decoder_type == DecoderType.SP:
                c2v = flat.cn_sumproduct_flat(v2c, fa)
            else:
                c2v = flat.cn_minsum_flat(v2c, fa)

            # CN/UCN weighting on magnitudes (reference :431-503)
            mag = ties.abs_(c2v)
            if cn_w is None:
                w_mag = mag
            elif use_ucn:
                cw = fa.edge_weights_to_flat(cn_w[i])[None]
                uw = fa.edge_weights_to_flat(ucn_w[i])[None]
                w_mag = mag * cw * scn_mask + mag * uw * ucn_mask
            else:
                w_mag = mag * fa.edge_weights_to_flat(cn_w[i])[None]

            # ReLU + post clip/quantize, re-sign (reference :505-512)
            w_mag = ties.relu0(w_mag)
            if is_qms:
                w_mag = qms_quantize_ste(w_mag, cfg.qms_qbit)
            else:
                w_mag = ties.clip(w_mag, llr_lo, llr_hi)
            msg = w_mag * torch.sign(c2v)

            # marginal / APP output (reference :513-526)
            vn_sums = flat.route_to_vns(msg, fa)
            prev_app = ties.clip(chan_out + vn_sums, llr_lo, llr_hi)
            outs.append(prev_app)
        return torch.stack(outs)  # [I, B, N*Z], flat bit order n*Z+z

    def forward(
        self,
        params: Params,
        chan_llr: torch.Tensor,
        target_iter: Union[int, Sequence[int], None] = None,
        fixed_iter_weights: Optional[dict[str, dict[int, torch.Tensor]]] = None,
    ):
        """Reference-compatible entry point (forward :260-538): returns the
        selected iteration output(s); ``None`` returns all iterations
        [I, B, N*Z]."""
        outputs = self.apply(params, chan_llr, fixed_iter_weights)
        if target_iter is None:
            return outputs
        if isinstance(target_iter, int):
            return outputs[target_iter]
        return outputs[list(target_iter)]

    def named_parameter_rows(self, params: Params) -> dict:
        """Explode stacked params into reference-named per-iteration entries
        (``weight_CN_3`` etc., reference _param_name :105-106) for the
        hardware .txt export path."""
        named = {}
        for key, spec in self.specs.items():
            pk = f"weight_{key}"
            if pk not in params:
                continue
            arr = params[pk].detach().cpu().numpy()
            row_iters = spec.temporal_rows if spec.temporal_rows else range(spec.n_iterations)
            for r, it in enumerate(row_iters):
                named[f"weight_{key.upper()}_{it}"] = arr[r]
        return named

    def decode_hard(self, params: Params, chan_llr: torch.Tensor) -> torch.Tensor:
        """Final-iteration hard decisions [B, N*Z] (0/1, bit = LLR < 0)."""
        return (self.apply(params, chan_llr)[-1] < 0).to(torch.int32)
