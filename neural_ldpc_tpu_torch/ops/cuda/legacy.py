"""The legacy decode engine (``FusedMinsumDecoder(engine="legacy")``, ROADMAP
kernel "K5"): the forward kernel ``csrc/fused_fwd.cu`` on this engine's
layout and routings, and its plain PyTorch version.

K5 replaces ``neural_ldpc_tpu/ops/pallas/minsum.py::_kernel``, the round-1
single-launch decode: all iterations in one launch, checks in their natural
``row_ptr`` order, the VN <-> edge routing as one-hot products on the TPU's
matrix unit, the final APP.  Each product is a permutation, so the port
routes by index through the forward kernel's own loop (the block of
``k1_plan``, messages in the VN's frame) and applies the products'
roundings where a value is routed, as compile-time hooks (ROUTE
``kBf16`` / ``kLegacyInt8``): ``routing_dtype`` bf16 (the default) routes
bf16(xa + sums) and sums bf16-rounded messages in f32, so legacy MS is
another function than the stream engine; float32 routes exactly (the roll
instantiation); int8 routing (the default for QMS) routes rint(clip(xa +
sums, +-2 q_hi) * scale) and rint(msg * scale) in integers, exact on the
QMS grid, and the UCN decision signs exactly.

The layout (``legacy_layout``) is ``FwdLayout`` in natural edge order with
this engine's routing "legacy_bf16", "legacy_f32" or "legacy_int8";
weights [I, E] in the original edge order.  ``fused_legacy_k5`` launches
the kernel for CUDA tensors and runs ``legacy_plain`` for CPU tensors;
``fused_legacy_k5.launches`` counts its calls that launched and
``.cuda_launches`` the CUDA kernels they launched.

Bound on the H100: 2 * N*Z * 4 bytes per word (channel in, APP out); the
check updates' fp32 work at 33.5e12 instructions per second is the larger
bound.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...codes.tanner import TannerGraph
from ..flat import gather_sum
from .fused_train import (
    _SMEM_OPTIN, FwdLayout, _bf16, _check_chan, _check_weights, _fwd_plain, _launch,
    int8_to_edges, int8_to_vns)

_ROUTINGS = ("legacy_bf16", "legacy_f32", "legacy_int8")


def legacy_routing(routing_dtype: torch.dtype, int8_routing: bool) -> str:
    """The layout routing of the legacy engine's options."""
    if int8_routing:
        return "legacy_int8"
    if routing_dtype == torch.bfloat16:
        return "legacy_bf16"
    if routing_dtype == torch.float32:
        return "legacy_f32"
    raise ValueError(f"routing_dtype: torch.bfloat16 or torch.float32, got {routing_dtype}")


def legacy_layout(graph: TannerGraph, n_iterations: int, clip, qms_qbit, sum_product: bool,
                  has_cn_w: bool, has_vn_w: bool, has_ucn: bool, device,
                  routing_dtype: torch.dtype, int8_routing: bool) -> FwdLayout:
    """The legacy engine's layout: checks in natural order, the routing of
    its options (``legacy_routing``)."""
    routing = legacy_routing(routing_dtype, int8_routing)
    lay = FwdLayout.build(graph, n_iterations, clip, qms_qbit, sum_product, has_cn_w, has_vn_w,
                          has_ucn, device, natural=True)
    return dataclasses.replace(lay, routing=routing)


def _to_edges(x: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """The legacy routing product VN -> edges: int8 as K6's, bf16(x), or
    exact (f32)."""
    if lay.routing == "legacy_int8":
        return int8_to_edges(x, lay)
    return (_bf16(x) if lay.routing == "legacy_bf16" else x)[:, lay.route_idx]


def _to_vns(m: torch.Tensor, lay: FwdLayout) -> torch.Tensor:
    """The legacy routing product edges -> VNs, each VN copy's terms in
    increasing edge id: int8 as K6's, bf16 terms summed in f32, or exact."""
    if lay.routing == "legacy_int8":
        return int8_to_vns(m, lay)
    return gather_sum(_bf16(m) if lay.routing == "legacy_bf16" else m, lay.vn_gather)


def legacy_fits(lay: FwdLayout) -> bool:
    """Whether K5 takes the layout: a block of the forward kernel
    (``lay.k1``, at least one word and the table) fits the shared memory a
    block can have, and a word's offsets fit the table's 16 bits."""
    try:
        return lay.k1.smem_bytes <= _SMEM_OPTIN
    except ValueError:  # k1_plan: N*Z or E*Z beyond 16-bit offsets
        return False


def legacy_plain(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor],
                 ucnw: Optional[torch.Tensor], vnw: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of K5: chan [B, N*Z] -> pre-clip final APP
    [B, N*Z], the legacy routing's roundings step by step (``_to_edges`` /
    ``_to_vns``; each VN copy's terms in increasing edge id, the kernel's
    order).  Weights [I, E] / [I, N], natural order."""
    if lay.routing not in _ROUTINGS:
        raise ValueError(f"K5 runs the legacy routings, not {lay.routing!r}")
    return _fwd_plain(chan, lay, cnw, ucnw, vnw, stream=False, store=False,
                      route=(_to_edges, _to_vns))[0]


def fused_legacy_k5(chan: torch.Tensor, lay: FwdLayout, cnw: Optional[torch.Tensor] = None,
                    ucnw: Optional[torch.Tensor] = None,
                    vnw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final-iteration pre-clip APP [B, N*Z] of the legacy engine from
    channel LLRs [B, N*Z].

    A CUDA tensor launches K5, the forward kernel with the layout's legacy
    routing (and raises if it cannot); a CPU tensor runs ``legacy_plain``."""
    if lay.routing not in _ROUTINGS:
        raise ValueError(f"K5 runs the legacy routings, not {lay.routing!r}")
    _check_chan(chan, lay)
    dev = chan.device
    w = _check_weights(lay, dev, cnw, ucnw, vnw)
    if dev.type == "cpu":
        return legacy_plain(chan, lay, *w)
    if not legacy_fits(lay):
        raise ValueError("one word's state does not fit the forward kernel's shared memory")
    chan = chan.contiguous()
    out = torch.empty_like(chan)
    fused_legacy_k5.cuda_launches += _launch(lay, dev, chan.shape[0], w, 0, chan=chan, out=out,
                                             routings=_ROUTINGS, on_chip=False)
    fused_legacy_k5.launches += 1
    return out


fused_legacy_k5.launches = 0  # calls that launched
fused_legacy_k5.cuda_launches = 0  # CUDA kernels they launched, as the C entry point counts them
