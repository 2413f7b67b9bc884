"""The port's edge path (neural_ldpc_tpu_torch.ops.bp and the decoders'
``routing="edge"``) against the JAX package's on identical numpy inputs.

Inputs sit on the 0.5 grid, so they hold exact zeros and tied minima, where
the three ``zero_handling`` modes and the reference's decision rule differ.
Bars: QMS exact; MS atol 2e-5; SP atol 5e-3 (the packages' tanh differ in
their last bits, and atanh near +-1 amplifies that); the gradients are in
``test_torch_edge_grad.py``.  Where the decoder has VN weights, XLA on the
CPU contracts ``chan * w + sums`` into one fused multiply-add while the port
rounds the product first, as the torch reference does: each iteration adds
an ulp or two, so those MS cases run 3 iterations.  Also the routing rules
and the guards that keep REFERENCE decoders off the STANDARD-only kernels."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.models import BoostedDecoderConfig as JaxConfig
from neural_ldpc_tpu.models import BoostedNeuralDecoder as JaxDecoder
from neural_ldpc_tpu.models import NeuralDecoderConfig as JaxNeuralConfig
from neural_ldpc_tpu.models import NeuralMinSumDecoder as JaxNeuralDecoder
from neural_ldpc_tpu.ops import bp as jbp
from neural_ldpc_tpu.structs import Convention as JaxConvention
from neural_ldpc_tpu.structs import DecoderType as JaxType
from neural_ldpc_tpu.structs import NodeWeightSharingConfig as JaxSharing
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.models import (
    BoostedDecoderConfig, BoostedNeuralDecoder, NeuralDecoderConfig, NeuralMinSumDecoder)
from neural_ldpc_tpu_torch.ops import bp
from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, FusedTrainDecoder
from neural_ldpc_tpu_torch.structs import Convention, DecoderType, NodeWeightSharingConfig
from neural_ldpc_tpu_torch.training.boosted_pipeline import uses_kernels

WMAN, BG2, SMALL = "wman_n576_r34_z24", "nr_bg2_set0_z16", "small"
# tests/test_decoders.py::small_code: a 3x6 base graph at Z = 4
SMALL_BG = np.array([[0, 1, -1, 2, 3, -1], [2, -1, 1, -1, 0, 3], [-1, 3, 0, 1, -1, 2]])
TOL = {"QMS": 0.0, "MS": 2e-5, "SP": 5e-3}


def graphs(code_name, z=None):
    """(port graph, JAX graph) of a shipped code (lifted at ``z``, default its
    own Z) or the small code."""
    if code_name == SMALL:
        return TannerGraph.from_basegraph(SMALL_BG, 4), JaxTannerGraph.from_basegraph(SMALL_BG, 4)
    code, jcode = get_code(code_name), jax_get_code(code_name)
    return (TannerGraph.from_basegraph(code.basegraph, z or code.Z),
            JaxTannerGraph.from_basegraph(jcode.basegraph, z or jcode.Z))


def grid(rng, shape, scale=3.0, offset=0.0):
    """Normal values rounded to the 0.5 grid: exact zeros and tied minima."""
    return (np.round((rng.normal(size=shape) * scale + offset) * 2) / 2).astype(np.float32)


def assert_close(kind, ours, theirs):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=TOL[kind])


# ---------------------------------------------------------------------------
# ops/bp.py, function for function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("code_name", [SMALL, BG2])
def test_graph_arrays_match_jax(code_name):
    g, jg = graphs(code_name)
    ga, jga = bp.GraphArrays.from_graph(g), jbp.GraphArrays.from_graph(jg)
    for f in dataclasses.fields(jga):
        a, b = getattr(ga, f.name), getattr(jga, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("code_name", [SMALL, BG2])
def test_routing_functions_match_jax(code_name):
    g, jg = graphs(code_name)
    ga, jga = bp.GraphArrays.from_graph(g), jbp.GraphArrays.from_graph(jg)
    rng = np.random.default_rng(1)
    msg = rng.normal(size=(3, g.Z, g.E)).astype(np.float32) * 5
    chan = rng.normal(size=(3, g.Z, g.N)).astype(np.float32) * 5
    sums = rng.normal(size=(3, g.Z, g.N)).astype(np.float32) * 5
    per_cn = rng.normal(size=(3, g.Z, g.M)).astype(np.float32)
    t = torch.tensor
    pairs = [
        (bp.lift_roll_in(t(msg), ga), jbp.lift_roll_in(jnp.asarray(msg), jga)),
        (bp.lift_roll_out(t(msg), ga), jbp.lift_roll_out(jnp.asarray(msg), jga)),
        (bp.vn_marginal_sums(t(msg), ga), jbp.vn_marginal_sums(jnp.asarray(msg), jga)),
        (bp.chan_to_edges(t(chan), ga), jbp.chan_to_edges(jnp.asarray(chan), jga)),
        (bp.cn_to_edges(t(per_cn), ga), jbp.cn_to_edges(jnp.asarray(per_cn), jga)),
        (bp.vn_update_extrinsic(bp.chan_to_edges(t(chan), ga), t(msg), t(sums), ga),
         jbp.vn_update_extrinsic(jbp.chan_to_edges(jnp.asarray(chan), jga), jnp.asarray(msg),
                                 jnp.asarray(sums), jga)),
    ]
    for ours, theirs in pairs:
        # gathers and slot-by-slot sums: bit for bit
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("code_name,parity,zero_handling", [
    (code, parity, mode) for code in (SMALL, BG2)
    for parity, mode in ((False, "standard"), (True, "standard"), (True, "eps"), (True, "exclude"))
] + [(SMALL, False, "eps"), (SMALL, False, "exclude")])  # modes act only with parity
def test_cn_update_minsum_matches_jax(code_name, parity, zero_handling):
    g, jg = graphs(code_name)
    ga, jga = bp.GraphArrays.from_graph(g), jbp.GraphArrays.from_graph(jg)
    v2c = grid(np.random.default_rng(2), (4, g.Z, g.E), scale=1.5)
    assert (v2c == 0).mean() > 0.1
    ours = bp.cn_update_minsum(torch.tensor(v2c), ga, parity, zero_handling)
    theirs = jbp.cn_update_minsum(jnp.asarray(v2c), jga, parity, zero_handling)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("code_name", [SMALL, WMAN])
@pytest.mark.parametrize("parity", [False, True])
def test_cn_update_sumproduct_matches_jax(code_name, parity):
    g, jg = graphs(code_name)
    ga, jga = bp.GraphArrays.from_graph(g), jbp.GraphArrays.from_graph(jg)
    v2c = grid(np.random.default_rng(3), (3, g.Z, g.E), scale=2.0)
    ours = bp.cn_update_sumproduct(torch.tensor(v2c), ga, parity)
    theirs = jbp.cn_update_sumproduct(jnp.asarray(v2c), jga, parity)
    assert_close("SP", ours, theirs)


@pytest.mark.parametrize("code_name", [SMALL, BG2])
@pytest.mark.parametrize("parity", [False, True])
def test_check_parity_indicator_matches_jax(code_name, parity):
    g, jg = graphs(code_name)
    ga, jga = bp.GraphArrays.from_graph(g), jbp.GraphArrays.from_graph(jg)
    app = grid(np.random.default_rng(4), (4, g.Z, g.N), scale=1.0)
    assert (app == 0).any()  # decided like the reference in parity mode
    ours = bp.check_parity_indicator(torch.tensor(app), ga, parity)
    theirs = jbp.check_parity_indicator(jnp.asarray(app), jga, parity)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


# ---------------------------------------------------------------------------
# the decoders' edge paths
# ---------------------------------------------------------------------------
def boosted_pair(code_name, decoder_type, sharing, n_iter, convention, routing="edge",
                 fixed=(), z=None):
    g, jg = graphs(code_name, z)
    kw = dict(n_iterations=n_iter, qms_qbit=5, fixed_iterative_nodes=fixed)
    dec = BoostedNeuralDecoder(g, BoostedDecoderConfig(
        decoder_type=DecoderType[decoder_type], sharing=NodeWeightSharingConfig(**sharing),
        convention=Convention(convention), routing=routing, **kw), device="cpu")
    jdec = JaxDecoder(jg, JaxConfig(
        decoder_type=JaxType[decoder_type], sharing=JaxSharing(**sharing),
        convention=JaxConvention(convention), routing=routing, **kw))
    return dec, jdec


def edge_inputs(dec, jdec, seed, batch=4, spread=0.2):
    rng = np.random.default_rng(seed)
    params = {k: (np.asarray(v) * (1 + spread * rng.normal(size=v.shape))).astype(np.float32)
              for k, v in jdec.init_params().items()}
    # REFERENCE maps bit 0 to -1: its all-zero channel leans negative
    offset = -1.5 if dec.config.convention == Convention.REFERENCE else 1.5
    g = dec.graph
    return params, grid(rng, (batch, g.N, g.Z), offset=offset)


# (code, type, sharing, iterations, convention, fixed_iterative_nodes)
EDGE_CASES = [
    (SMALL, "MS", dict(cn=3, vn=3), 3, "reference", ()),
    (SMALL, "SP", dict(cn=3, vn=3), 4, "reference", ()),
    (WMAN, "MS", dict(cn=3, ucn=2), 5, "reference", ()),
    (WMAN, "MS", dict(cn=2, ucn=2, vn=3), 3, "reference", ()),
    (WMAN, "QMS", dict(cn=5, ucn=4, vn=5), 5, "reference", (2,)),
    (WMAN, "SP", dict(cn=1, vn=2), 4, "reference", ()),
    (BG2, "QMS", dict(cn=3, vn=3), 5, "reference", ()),
    (BG2, "QMS", dict(cn=3, ucn=2, vn=3), 4, "reference", ()),
    (BG2, "MS", dict(cn=3, ucn=2, vn=3), 3, "reference", ()),
    (BG2, "QMS", dict(cn=3, ucn=2, vn=3), 4, "standard", ()),
    (WMAN, "MS", dict(cn=3, ucn=2), 5, "standard", ()),
]


@pytest.mark.parametrize(
    "code_name,decoder_type,sharing,n_iter,convention,fixed", EDGE_CASES,
    ids=[f"{c[0][:5]}-{c[1]}x{c[3]}-{'-'.join(f'{k}{v}' for k, v in c[2].items())}-{c[4]}"
         f"{'-fixed' if c[5] else ''}" for c in EDGE_CASES])
def test_boosted_edge_path_matches_jax(code_name, decoder_type, sharing, n_iter, convention,
                                       fixed):
    dec, jdec = boosted_pair(code_name, decoder_type, sharing, n_iter, convention, fixed=fixed)
    assert not dec.use_flat and not jdec.use_flat
    params, x = edge_inputs(dec, jdec, seed=len(sharing) + n_iter)
    assert (x == 0).any()
    ours = dec.apply({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x))
    theirs = jdec.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    assert_close(decoder_type, ours, theirs)
    # decode_hard decides by the convention: REFERENCE's bit 1 is out > 0
    hard = dec.decode_hard({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x))
    out = ours[-1]
    expect = (out > 0) if convention == "reference" else (out < 0)
    assert torch.equal(hard, expect.to(torch.int32))


def test_boosted_edge_path_fixed_iter_weights_match_jax():
    dec, jdec = boosted_pair(WMAN, "QMS", dict(cn=5, ucn=4, vn=5), 4, "reference", fixed=(1,))
    params, x = edge_inputs(dec, jdec, seed=9)
    rng = np.random.default_rng(10)
    g = dec.graph
    over = {"cn": {1: rng.uniform(0.5, 1.5, g.E).astype(np.float32)},
            "ucn": {1: rng.uniform(0.5, 1.5, g.E).astype(np.float32)},
            "vn": {1: rng.uniform(0.5, 1.5, g.N).astype(np.float32)}}
    ours = dec.apply({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x),
                     {k: {i: torch.tensor(w) for i, w in d.items()} for k, d in over.items()})
    theirs = jdec.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                        {k: {i: jnp.asarray(w) for i, w in d.items()} for k, d in over.items()})
    assert_close("QMS", ours, theirs)
    plain = dec.apply({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x))
    assert not torch.equal(ours, plain)


@pytest.mark.parametrize("code_name,decoder_type,sharing,fixed", [
    (WMAN, "MS", dict(cn=3), ()),
    (WMAN, "SP", dict(cn=1, vn=2), ()),
    (WMAN, "MS", dict(cn=5, ucn=4, vn=5), (2,)),
    (BG2, "MS", dict(cn=3, ucn=2, vn=3), ()),
    (BG2, "QMS", dict(cn=3, vn=3), ()),
])
def test_edge_path_matches_flat_path(code_name, decoder_type, sharing, fixed):
    """The port's two routings agree under STANDARD, as the JAX package's do
    (tests/test_decoders.py::test_flat_routing_matches_edge_routing)."""
    g, _ = graphs(code_name)
    kw = dict(n_iterations=4, decoder_type=DecoderType[decoder_type], qms_qbit=5,
              sharing=NodeWeightSharingConfig(**sharing), fixed_iterative_nodes=fixed)
    edge = BoostedNeuralDecoder(g, BoostedDecoderConfig(routing="edge", **kw), device="cpu")
    flat = BoostedNeuralDecoder(g, BoostedDecoderConfig(routing="flat", **kw), device="cpu")
    rng = np.random.default_rng(7)
    params = {k: v * (1 + 0.3 * torch.tensor(rng.normal(size=v.shape), dtype=torch.float32))
              for k, v in edge.init_params().items()}
    x = torch.tensor(rng.normal(size=(3, g.N, g.Z)).astype(np.float32) * 3)
    oe, of = edge.apply(params, x), flat.apply(params, x)
    atol = {"QMS": 0.0, "MS": 2e-5, "SP": 5e-4}[decoder_type]
    np.testing.assert_allclose(of.numpy(), oe.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("convention", ["standard", "reference"])
def test_neural_decoder_edge_path_matches_jax(convention):
    g, jg = graphs(WMAN)
    kw = dict(n_iterations=5, routing="edge")
    dec = NeuralMinSumDecoder(g, NeuralDecoderConfig(convention=Convention(convention), **kw),
                              device="cpu")
    jdec = JaxNeuralDecoder(jg, JaxNeuralConfig(convention=JaxConvention(convention), **kw))
    rng = np.random.default_rng(5)
    w = rng.uniform(0.2, 1.2, size=(5, g.E)).astype(np.float32)
    b = rng.uniform(-0.2, 0.2, size=(5, g.E)).astype(np.float32)
    # Dai's "exclude" masks exact zeros out of the min: the grid seeds them
    x = grid(rng, (4, g.N, g.Z), offset=-1.5 if convention == "reference" else 1.5)
    p = {"weights_var": torch.tensor(w), "biases_var": torch.tensor(b)}
    jp = {"weights_var": jnp.asarray(w), "biases_var": jnp.asarray(b)}
    ours = dec.apply(p, torch.tensor(x))
    assert_close("MS", ours, jdec.apply(jp, jnp.asarray(x)))
    np.testing.assert_array_equal(dec.decode_hard(p, torch.tensor(x)).numpy(),
                                  np.asarray(jdec.decode_hard(jp, jnp.asarray(x))))
    if convention == "standard":  # the port's two routings agree
        flat = NeuralMinSumDecoder(g, NeuralDecoderConfig(n_iterations=5), device="cpu")
        np.testing.assert_allclose(flat.apply(p, torch.tensor(x)).numpy(), ours.numpy(),
                                   rtol=0, atol=2e-4)


# ---------------------------------------------------------------------------
# configuration, routing rules and the guards
# ---------------------------------------------------------------------------
def test_config_fields_and_routing_rules_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(BoostedDecoderConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert set(ours) == set(theirs)
    assert [ours[k] for k in ("routing", "cn_reduce", "matmul_precision")] == \
        [theirs[k] for k in ("routing", "cn_reduce", "matmul_precision")]
    # a JAX-shaped config constructs
    BoostedDecoderConfig(routing="flat", cn_reduce="gather", matmul_precision="highest")
    g, jg = graphs(WMAN)
    for routing in ("auto", "flat", "edge", "dense"):
        for conv in ("standard", "reference"):
            cfg = dict(routing=routing)
            try:
                j = JaxDecoder(jg, JaxConfig(convention=JaxConvention(conv), **cfg)).use_flat
            except ValueError as exc:
                with pytest.raises(ValueError, match=str(exc)[:20]):
                    BoostedNeuralDecoder(g, BoostedDecoderConfig(
                        convention=Convention(conv), **cfg), device="cpu")
                continue
            dec = BoostedNeuralDecoder(g, BoostedDecoderConfig(convention=Convention(conv),
                                                               **cfg), device="cpu")
            assert dec.use_flat == j, (routing, conv)
            try:
                jn = JaxNeuralDecoder(jg, JaxNeuralConfig(convention=JaxConvention(conv),
                                                         **cfg)).use_flat
            except ValueError:
                continue
            assert NeuralMinSumDecoder(g, NeuralDecoderConfig(
                convention=Convention(conv), **cfg), device="cpu").use_flat == jn


def test_auto_keeps_flat_where_jax_switches_to_edge():
    """JAX's "auto" takes the edge path for a STANDARD code whose one-hot
    operand passes 64 MB; the port's index-gather flat path has no such
    operand and stays flat (a known departure)."""
    code, jcode = get_code("nr_bg1_like_z384"), jax_get_code("nr_bg1_like_z384")
    g = TannerGraph.from_basegraph(code.basegraph, 32)
    jg = JaxTannerGraph.from_basegraph(jcode.basegraph, 32)
    assert not JaxDecoder(jg, JaxConfig()).use_flat
    assert BoostedNeuralDecoder(g, BoostedDecoderConfig(), device="cpu").use_flat


def _reference_decoder(n_iter=3):
    code = get_code(BG2)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    return code, BoostedNeuralDecoder(g, BoostedDecoderConfig(
        n_iterations=n_iter, convention=Convention.REFERENCE,
        sharing=NodeWeightSharingConfig(cn=3, vn=3)), device="cpu")


def test_fused_wrappers_refuse_reference_decoders():
    _, dec = _reference_decoder()
    with pytest.raises(ValueError, match="STANDARD-convention semantics only"):
        FusedMinsumDecoder.from_decoder(dec, dec.init_params())
    with pytest.raises(ValueError, match="fused training implements the STANDARD convention"):
        FusedTrainDecoder.from_decoder(dec)


def test_reference_campaign_runs_the_plain_engine():
    code, dec = _reference_decoder()
    channel = AWGNChannel(code, ChannelConfig(snr_db=(3.0,), convention=Convention.REFERENCE),
                          device="cpu")
    cfg = CampaignConfig(batch_size=16, max_words_per_snr=32, min_frame_errors=0)
    camp = MonteCarloCampaign(dec, dec.init_params(), channel, cfg)
    assert not camp._fused_eligible() and not camp.fused
    # on the card "auto" takes the plain engine too: the guard, not the device
    camp.device = torch.device("cuda", 0)
    assert camp._resolve_engine() == "xla"
    with pytest.raises(ValueError, match="STANDARD convention"):
        MonteCarloCampaign(dec, dec.init_params(), channel,
                           dataclasses.replace(cfg, engine="fused"))
    camp.device = dec.device
    camp.run()
    res = camp.results()[3.0]
    # the plain engine's per-iteration counts; decoded BER below the channel's
    assert res["words"] == 32 and len(res["ber"]) == 3 and res["ber"][-1] < res["ber"][0]


def test_harvest_takes_the_plain_decoder_for_reference():
    _, ref = _reference_decoder()
    code = get_code(BG2)
    std = BoostedNeuralDecoder(TannerGraph.from_basegraph(code.basegraph, code.Z),
                               BoostedDecoderConfig(n_iterations=3), device="cpu")
    for dec in (ref, std):
        assert not uses_kernels(dec)  # CPU tensors: the plain decoder
        dec.device = torch.device("cuda", 0)  # as a decoder on the card
    assert uses_kernels(std) and not uses_kernels(ref)
