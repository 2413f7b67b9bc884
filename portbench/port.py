"""The system under test, built from a configuration: the port's decoder,
its weights and its kernels.  Drivers reach the port only through here and
through the entry point their window drives."""

from __future__ import annotations

import numpy as np
import torch

from .reference.graph import ROOT, read_basegraph

def build_kernels(sources, device) -> dict:
    """Build or load the kernel sources a driver's window launches
    (``csrc/<name>.cu``, its ``SOURCES``) through the port's own build
    (nvcc only where the library for this source is not yet in
    ``csrc/build/``); returns nvcc's seconds for each source it compiled."""
    if torch.device(device).type != "cuda":
        return {}
    from neural_ldpc_tpu_torch.ops.cuda import _build

    _build.load_all(sources)
    return {k: v for k, v in _build.build_seconds.items()}


def decoder(cfg: dict, device):
    """The port's decoder of the configuration, on the configuration's base
    graph as the benchmark read it."""
    from neural_ldpc_tpu_torch.codes import TannerGraph
    from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder
    from neural_ldpc_tpu_torch.structs import (
        Clipping, DecoderType, NodeWeightSharingConfig)

    code, dec = cfg["code"], cfg["decoder"]
    graph = TannerGraph.from_basegraph(read_basegraph(code["basegraph"]), code["Z"])
    init = dec.get("init_weights", {})
    lo, hi = dec.get("weight_clip", (0.0, 2.0))
    return BoostedNeuralDecoder(graph, BoostedDecoderConfig(
        n_iterations=dec["iterations"],
        decoder_type=DecoderType[dec["type"]],
        qms_qbit=dec.get("qms_qbit", 5),
        sharing=NodeWeightSharingConfig(**dec["sharing"]),
        allowed_weight_range=Clipping(lo, hi),
        allowed_llr_range=Clipping.of(abs=dec["llr_clip"]),
        init_cn_weight=init.get("cn", 1.0),
        init_ucn_weight=init.get("ucn", 1.0),
        init_vn_weight=init.get("vn", 1.0),
    ), device=device)


def weights(cfg: dict) -> dict:
    """The configuration's trained weights as numpy arrays (the same arrays
    go to the port and to the reference), or {} where it trains its own."""
    path = cfg["decoder"].get("weights")
    if path is None:
        return {}
    with np.load(f"{ROOT}/{path}") as data:
        return {k: np.asarray(data[k], np.float32) for k in data.files if k.startswith("weight_")}
