"""Neural (weighted min-sum) LDPC decoder — Dai et al., arXiv:2102.03828.

Port of ``neural_ldpc_tpu/models/neural_decoder.py``, plain PyTorch: an
unrolled min-sum decoder with one learnable per-edge weight (init 0.5) and
bias (init 0) per iteration (reference src/neural_ldpc_decoder/
NeuralLDPCDecoder.py:35-42), applied as ``relu(|msg| * w_i + b_i)``
re-signed (:89-91).  No clipping, no quantization, no epsilon passes — the
Dai variant is the minimal neural decoder.  It runs the JAX package's two
paths: the flat [B, E*Z] layout (``ops/flat.py``), and the edge path on
[B, Z, E] messages (``ops/bp.py``), which the REFERENCE convention takes,
with JAX's gradient conventions at ties (``ops/ties.py``).  The JAX package
has no kernel for it, so neither has the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..codes.tanner import TannerGraph
from ..device import DeviceLike, resolve_device
from ..ops import bp, flat, ties
from ..structs import Convention

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class NeuralDecoderConfig:
    n_iterations: int = 25
    init_weight: float = 0.5
    init_bias: float = 0.0
    convention: Convention = Convention.STANDARD
    # same path selection as BoostedDecoderConfig: "auto" takes the flat
    # path under the STANDARD convention and the edge path under REFERENCE
    routing: str = "auto"
    # kept so that a JAX config loads; the port's flat path routes by index
    # gathers, which have no matmul precision, and ignores it
    matmul_precision: Optional[str] = None


def neural_params_from_numpy(arrays, device: DeviceLike = "cuda") -> Params:
    """The Dai decoder's params (``weights_var`` / ``biases_var`` [I, E])
    from numpy arrays, e.g. the JAX decoder's, as float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(arrays[k], np.float32), device=dev)
            for k in ("weights_var", "biases_var")}


class NeuralMinSumDecoder:
    """Holds the config and the graph's index tables; the weights travel in
    a params dict, as in the JAX package."""

    def __init__(self, graph: TannerGraph, config: NeuralDecoderConfig = NeuralDecoderConfig(),
                 device: DeviceLike = "cuda"):
        if config.routing not in ("auto", "flat", "edge"):
            raise ValueError(f"unknown routing {config.routing!r}")
        if config.routing == "flat" and config.convention == Convention.REFERENCE:
            raise ValueError("flat routing implements the STANDARD convention only")
        self.graph = graph
        self.config = config
        self.device = resolve_device(device)
        self.use_flat = config.routing == "flat" or (
            config.routing == "auto" and config.convention == Convention.STANDARD
        )
        self.fa = flat.FlatGraphArrays.from_graph(graph, self.device) if self.use_flat else None
        self.ga = None if self.use_flat else bp.GraphArrays.from_graph(graph, self.device)

    def init_params(self) -> Params:
        I, E = self.config.n_iterations, self.graph.E
        return {
            "weights_var": torch.full((I, E), self.config.init_weight, device=self.device),
            "biases_var": torch.full((I, E), self.config.init_bias, device=self.device),
        }

    def apply(self, params: Params, chan_llr: torch.Tensor) -> torch.Tensor:
        """chan_llr: [B, N, Z] -> per-iteration APP outputs [I, B, N*Z]
        (reference forward :44-100 returns the same as a list)."""
        if not self.use_flat:
            return self._apply_edge(params, chan_llr)
        fa = self.fa
        B = chan_llr.shape[0]
        chan = chan_llr.to(torch.float32).reshape(B, fa.N * fa.Z)
        msg = chan.new_zeros(B, fa.E * fa.Z)
        vn_sums = chan.new_zeros(B, fa.N * fa.Z)
        outs = []
        for w, b in zip(params["weights_var"], params["biases_var"]):
            v2c = flat.route_to_edges(chan + vn_sums, fa) - msg
            c2v = flat.cn_minsum_flat(v2c, fa)
            w_f = fa.edge_weights_to_flat(w)[None]
            b_f = fa.edge_weights_to_flat(b)[None]
            w_mag = ties.relu0(ties.abs_(c2v) * w_f + b_f)
            msg = w_mag * torch.sign(c2v)  # sign carries no gradient
            vn_sums = flat.route_to_vns(msg, fa)
            outs.append(chan + vn_sums)
        return torch.stack(outs)  # [I, B, N*Z]

    def _apply_edge(self, params: Params, chan_llr: torch.Tensor) -> torch.Tensor:
        """The edge path (``ops/bp.py``) on [B, Z, E] messages; under the
        REFERENCE convention the check update masks exact zeros out of the
        min and carries the reference's sign factor."""
        ga = self.ga
        parity = self.config.convention == Convention.REFERENCE
        B = chan_llr.shape[0]
        chan = chan_llr.to(torch.float32).transpose(1, 2)  # [B, Z, N]
        chan_edge = bp.chan_to_edges(chan, ga)
        msg = chan.new_zeros(B, ga.Z, ga.E)
        vn_sums = chan.new_zeros(B, ga.Z, ga.N)
        outs = []
        for w, b in zip(params["weights_var"], params["biases_var"]):
            v2c = bp.vn_update_extrinsic(chan_edge, msg, vn_sums, ga)  # ref :56-58
            v2c = bp.lift_roll_in(v2c, ga)  # ref :59-63
            c2v = bp.cn_update_minsum(
                v2c, ga, parity_with_reference=parity, zero_handling="exclude"
            )  # ref :66-80
            c2v = bp.lift_roll_out(c2v, ga)  # ref :82-86
            w_mag = ties.relu0(ties.abs_(c2v) * w + b)
            msg = w_mag * torch.sign(c2v)  # ref :89-91
            vn_sums = bp.vn_marginal_sums(msg, ga)
            outs.append(chan + vn_sums)  # ref :94-97 (no clipping)
        # [I, B, Z, N] -> [I, B, N*Z] (flat bit order n*Z+z)
        return torch.stack(outs).transpose(2, 3).reshape(len(outs), B, ga.N * ga.Z)

    def __call__(self, params: Params, chan_llr: torch.Tensor) -> torch.Tensor:
        return self.apply(params, chan_llr)

    def named_parameter_rows(self, params: Params) -> dict:
        """Per-iteration named entries (``weights_var_3`` / ``biases_var_3``,
        mirroring the reference's ParameterList naming) for txt export."""
        named = {}
        for pk in ("weights_var", "biases_var"):
            arr = params[pk].detach().cpu().numpy()
            for i in range(arr.shape[0]):
                named[f"{pk}_{i}"] = arr[i]
        return named

    def decode_hard(self, params: Params, chan_llr: torch.Tensor) -> torch.Tensor:
        """Final-iteration hard decisions [B, N*Z] (0/1) under the configured
        convention (REFERENCE: positive LLR favours bit 1)."""
        out = self.apply(params, chan_llr)[-1]
        if self.config.convention == Convention.REFERENCE:
            return (out > 0).to(torch.int32)
        return (out < 0).to(torch.int32)
