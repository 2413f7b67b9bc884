"""Matmul routing (K6) on the CPU, where ``FusedTrainDecoder(routing="matmul")``
runs the plain versions of the matmul-routed forward and backward: held
against JAX's ``FusedTrainDecoder(routing="matmul", interpret=True)``, whose
Pallas kernels route through the one-hot operand.  Also the routing rules
(``routing``, ``int8_routing``, ``routing_dtype``, ``store_space``), the
capacity rule and the campaign on a protograph with E > 1024.

Bars: QMS exact (int8 routing is value-exact); MS 2e-5 (split-3 sums its
three bf16 parts in another order than JAX's dot); gradients atol 1e-6 /
rtol 1e-4, loss 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.ops.pallas.fused_train import FusedTrainDecoder as JaxTrain
from neural_ldpc_tpu.ops.pallas.fused_train import _route_e_rows, _route_n_from_e
from neural_ldpc_tpu.training.loss import multi_iteration_loss as jax_loss
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.codes.protograph import dense_protograph
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, FusedTrainDecoder, FwdLayout, fused_bwd_block_plain, fused_bwd_k2,
    fused_bwd_plain, fused_capacity_ok, fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c,
    fused_fwd_k1d, fused_fwd_plain, fused_fwd_train_plain, on_chip_ok, stats_plain)
from neural_ldpc_tpu_torch.ops.cuda.fused_train import (
    _fwd_k1, _routed_negative, route_to_edges, route_to_vns)
from neural_ldpc_tpu_torch.ops.quantize import _QMS_TABLE, qms_quantize_value
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
from neural_ldpc_tpu_torch.training import multi_iteration_loss
from test_torch_decoder import assert_close
from test_torch_grad import BG2, GRAD_TOL, WMAN, build_grad_pair, grad_inputs
from test_torch_k1_layout import _inputs
from test_torch_k2_layout import assert_twin_matches


def _jax_decode(jdec, params, llr, int8, routing_dtype=jnp.bfloat16):
    jft = JaxTrain.from_decoder(jdec, interpret=True, routing="matmul", store_msgs=False,
                                int8_routing=int8, routing_dtype=routing_dtype)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return np.asarray(jft.apply(*jdec._expanded_weights(jp), jnp.asarray(llr)))[-1]


def _decode(dec, params, llr, **kw):
    ft = FusedTrainDecoder.from_decoder(dec, routing="matmul", store_msgs=False, **kw)
    p = {k: torch.tensor(v) for k, v in params.items()}
    return ft, ft.apply(*dec._expanded_weights(p), torch.tensor(llr))[-1].numpy()


def _check_decode(code_name, z, decoder_type, sharing, n_iter, int8):
    code, dec, jdec = build_grad_pair(code_name, z, decoder_type, sharing, n_iter)
    params, llr, _ = grad_inputs(code, dec, jdec, batch=8, sigma=0.8)
    ft, ours = _decode(dec, params, llr, int8_routing=int8)
    assert ft.layout.routing == ("int8" if int8 else "split3")
    assert_close(decoder_type, ours, _jax_decode(jdec, params, llr, int8))
    return dec, params, llr, ours


def test_int8_decode_matches_jax_interpret_and_roll():
    """BG2 QMS x3 in int8 routing: JAX's matmul kernel and the roll engine,
    bit for bit."""
    dec, params, llr, ours = _check_decode(BG2, None, "QMS", dict(cn=3, vn=3), 3, True)
    p = {k: torch.tensor(v) for k, v in params.items()}
    roll = FusedMinsumDecoder.from_decoder(dec, p)(torch.tensor(llr)).numpy()
    np.testing.assert_array_equal(ours, roll)


@pytest.mark.slow
@pytest.mark.parametrize("code_name,z,decoder_type,sharing,n_iter,int8", [
    (WMAN, 8, "MS", dict(cn=3, vn=2), 3, False),
    (BG2, None, "QMS", dict(cn=3, vn=3), 3, False),
    (BG2, None, "QMS", dict(cn=3, ucn=2, vn=3), 3, True),
    (WMAN, 8, "SP", dict(cn=3), 3, False),
], ids=["wman-z8-MS-split3", "bg2-QMS-split3", "bg2-QMS-ucn-int8", "wman-z8-SP-split3"])
def test_decode_matches_jax_interpret(code_name, z, decoder_type, sharing, n_iter, int8):
    _check_decode(code_name, z, decoder_type, sharing, n_iter, int8)


def _jax_rows(x, Z, Zp):
    """Port layout [B, R*Z] -> JAX's Zp-padded [R*Zp, B] (pad rows 0)."""
    B = x.shape[0]
    x = np.asarray(x).reshape(B, -1, Z)
    return np.pad(x, ((0, 0), (0, 0), (0, Zp - Z))).reshape(B, -1).T


def _port_cols(y, Z, Zp):
    """JAX's [R*Zp, B] -> the port's [B, R*Z] (pad rows dropped)."""
    y = np.asarray(y)
    return y.reshape(-1, Zp, y.shape[1])[:, :Z].reshape(-1, y.shape[1]).T


def _routing_inputs(rng, batch, n, q_hi, scale, kinds):
    """[batch, n] float32 from ``rng``, each entry one of ``kinds``: "grid"
    values k / scale within +-q_hi, "far" values beyond the int8 pre-clip
    +-2 q_hi, "zero" (both signs) or "off" the grid, over five decades."""
    pick = np.asarray(kinds)[rng.integers(0, len(kinds), (batch, n))]
    sign = np.sign(rng.standard_normal((batch, n)))
    x = np.select([pick == "grid", pick == "far", pick == "zero"], [
        rng.integers(-int(q_hi * scale), int(q_hi * scale) + 1, (batch, n)) / scale,
        sign * rng.uniform(2 * q_hi, 8 * q_hi, (batch, n)),
        sign * 0.0], sign * 10.0 ** rng.uniform(-3, 2, (batch, n)))
    return x.astype(np.float32)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "split3"])
@pytest.mark.parametrize("code_name,z", [(WMAN, 8), (BG2, None)], ids=["wman-z8", "bg2"])
def test_routing_identity_matches_jax_products(code_name, z, int8):
    """The identity K6's forward rests on: each one-hot routing product of
    JAX's matmul branch (``_route_e_rows``, ``_route_n_from_e`` with
    ``quantized`` messages, the routed decision signs of
    ``_ucn_mask_from_app``), called outside Pallas on the JAX decoder's own
    ``meta``, ``_rt`` and ``_r``, equals the port's index routing with its
    roundings (``route_to_edges``, ``route_to_vns``, ``_routed_negative``)
    bit for bit, on VN-side values on the grid, beyond the int8 pre-clip, at
    zero and off the grid, and on messages on the grid, beyond the pre-clip
    (split-3) and at zero."""
    code, dec, jdec = build_grad_pair(code_name, z, "QMS" if int8 else "MS", dict(cn=3), 2)
    jft = JaxTrain.from_decoder(jdec, interpret=True, routing="matmul", int8_routing=int8)
    ft = FusedTrainDecoder.from_decoder(dec, routing="matmul", int8_routing=int8)
    lay, meta = ft.layout, jft.meta
    assert lay.routing == ("int8" if int8 else "split3")
    np.testing.assert_array_equal(lay.edge_perm, jft.edge_perm)
    Z, Zp, rdt = lay.Z, meta.Zp, jft.routing_dtype
    _, q_hi, scale = _QMS_TABLE[5]
    rng = np.random.default_rng(11)
    x = _routing_inputs(rng, 16, lay.N * Z, q_hi, scale, ("grid", "far", "zero", "off"))
    # messages: on the grid within +-q_hi in int8 routing (``quantized``)
    m = _routing_inputs(rng, 16, lay.E * Z, q_hi, scale,
                        ("grid", "zero") if int8 else ("grid", "far", "zero"))
    jx, jm = jnp.asarray(_jax_rows(x, Z, Zp)), jnp.asarray(_jax_rows(m, Z, Zp))
    to_e = _port_cols(_route_e_rows(jx, jft._rt, meta, rdt, 0, meta.E), Z, Zp)
    to_n = _port_cols(_route_n_from_e(jm, jft._r, meta, rdt, quantized=True), Z, Zp)
    dsign = jnp.where(jx < 0, -1.0, 1.0)
    neg = _port_cols(_route_e_rows(dsign, jft._rt, meta, rdt, 0, meta.E) < 0, Z, Zp)
    tx, tm = torch.tensor(x), torch.tensor(m)
    np.testing.assert_array_equal(route_to_edges(tx, lay).numpy(), to_e)
    np.testing.assert_array_equal(route_to_vns(tm, lay).numpy(), to_n)
    np.testing.assert_array_equal(_routed_negative(tx, lay).numpy(), neg)
    if int8:  # some values lie beyond the pre-clip and saturate there
        assert np.abs(x).max() > 2 * q_hi and np.abs(to_e).max() == 2 * q_hi
    else:
        # off-grid messages over five decades: a part sum no longer fits 24
        # bits, and JAX's dot adds the terms in its own order, the port in
        # vn_list order, so the sums agree to their rounding, not bitwise
        m = _routing_inputs(rng, 16, lay.E * Z, q_hi, scale, ("far", "zero", "off"))
        to_n = _port_cols(_route_n_from_e(jnp.asarray(_jax_rows(m, Z, Zp)), jft._r, meta, rdt,
                                          quantized=True), Z, Zp)
        ours = route_to_vns(torch.tensor(m), lay).numpy()
        scale_of_sum = route_to_vns(torch.tensor(np.abs(m)), lay).numpy()
        assert np.all(np.abs(ours - to_n) <= 2.0 ** -22 * scale_of_sum)


def _saturating_case():
    """tests/test_fused_train.py:439-456: BG2 QMS x3 cn=3 vn=3, sigma 0.35,
    so that the VN totals saturate the int8 pre-clip at +-2 q_hi."""
    code, dec, jdec = build_grad_pair(BG2, None, "QMS", dict(cn=3, vn=3), 3)
    rng = np.random.default_rng(7)
    params = {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in jdec.init_params().items()}
    sigma = 0.35
    llr = (2 * (1.0 + sigma * rng.standard_normal((16, code.N, code.Z))) / sigma**2
           ).astype(np.float32)
    return code, dec, jdec, params, llr, np.zeros((16, code.N * code.Z), np.float32)


def _check_gradients(int8, routing_dtype):
    code, dec, jdec, params, llr, bits = _saturating_case()
    jdt = jnp.float32 if routing_dtype == torch.float32 else jnp.bfloat16
    jft = JaxTrain.from_decoder(jdec, interpret=True, routing="matmul", routing_dtype=jdt,
                                int8_routing=int8)

    def jloss(p, x):
        return jax_loss(jft.apply(*jdec._expanded_weights(p), x), jnp.asarray(bits),
                        coeff=[0, 1, 2])

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(llr))
    ft = FusedTrainDecoder.from_decoder(dec, routing="matmul", routing_dtype=routing_dtype,
                                        int8_routing=int8)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    x = torch.tensor(llr, requires_grad=True)
    outs = ft.apply(*dec._expanded_weights(p), x)
    loss = multi_iteration_loss(outs, torch.tensor(bits), coeff=[0, 1, 2])
    grads = torch.autograd.grad(loss, [*p.values(), x])
    np.testing.assert_array_equal(
        outs.detach().numpy(), np.asarray(jft.apply(*jdec._expanded_weights(jp), jnp.asarray(llr))))
    assert abs(loss.item() - float(jval)) < 1e-6
    for k, g in zip(p, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **GRAD_TOL)
    return ft, params, llr


def test_saturating_int8_gradients_match_jax_interpret():
    """The int8 backward's saturation fix: with totals beyond +-2 q_hi the
    clip masks at the quantizer's bound are 0, as JAX's kernel makes them."""
    ft, params, llr = _check_gradients(True, torch.float32)
    lay = ft.layout
    assert lay.routing == "int8" and lay.grad_f32
    # the case does saturate: some VN total lies beyond the pre-clip
    chan = torch.tensor(llr).reshape(16, -1)
    assert float(chan.abs().max()) > 2 * 15.0


@pytest.mark.slow
@pytest.mark.parametrize("int8,routing_dtype", [(False, torch.float32), (True, torch.bfloat16)],
                         ids=["split3", "int8-bf16-cotangents"])
def test_gradients_match_jax_interpret(int8, routing_dtype):
    _check_gradients(int8, routing_dtype)


@pytest.mark.parametrize("int8,routing_dtype", [
    (True, torch.bfloat16), (True, torch.float32), (False, torch.float32)],
    ids=["int8-bf16-cotangents", "int8-f32-cotangents", "split3"])
def test_backward_index_order_equals_plain(int8, routing_dtype):
    """K6's backward on the card runs K2's loop with the matmul branch's
    roundings as hooks; its plain twin on the kernel's own block layout
    (``fused_bwd_block_plain``: the tables as the kernel reads them, each
    edge's saturation indicator from the total it reads, the sums
    cotangent carried rounded) equals ``fused_bwd_plain`` on the saturating
    BG2 QMS x3 case, whose totals pass the int8 pre-clip: the channel
    gradients bit for bit, the weight gradients to the per-block partials'
    sum order (``assert_twin_matches``)."""
    code, dec, _, params, llr, _ = _saturating_case()
    ft = FusedTrainDecoder.from_decoder(dec, routing="matmul", routing_dtype=routing_dtype,
                                        int8_routing=int8)
    lay = ft.layout
    assert lay.routing == ("int8" if int8 else "split3") and lay.grad_f32 == (
        int8 and routing_dtype == torch.float32)
    w = ft.pack_weights(*dec._expanded_weights({k: torch.tensor(v) for k, v in params.items()}))
    chan = torch.tensor(llr).reshape(16, -1)
    outs, store = fused_fwd_train_plain(chan, lay, *w)
    # VN totals xa_q + sums beyond the pre-clip +-2 q_hi (|xa_q| <= q_hi): the
    # saturation fix runs
    sums = outs - qms_quantize_value(chan, 5)[None]
    assert (sums[:-1].abs() > 3 * _QMS_TABLE[5][1]).any()
    g = torch.randn(outs.shape, generator=torch.Generator().manual_seed(5))
    assert_twin_matches(fused_bwd_block_plain(chan, lay, *w, store, outs, g),
                        fused_bwd_plain(chan, lay, *w, store, outs, g))


@pytest.mark.parametrize("flags", [
    dict(qms=3, ucn=True, routing="int8", exact=True),
    dict(qms=5, ucn=True, vn=True, routing="int8", exact=True),
    dict(sp=True, ucn=True, routing="split3"), dict(ucn=True, vn=True)],
    ids=["int8-qbit3-ucn", "int8-ucn-vn", "split3-SP-ucn", "roll-ucn-vn"])
def test_backward_index_order_routes_the_ucn_signs(flags):
    """The twin with UCN weights: the decision signs routed as the forward
    routes them (K6's int8 quantizes +-1, which at qms_qbit 3 rounds to 0;
    split-3 and roll exactly), in each routing, equal to
    ``fused_bwd_plain`` as ``assert_twin_matches`` holds it; in int8
    routing every gradient bit for bit (``exact``)."""
    code = get_code(BG2)
    graph = TannerGraph.from_basegraph(code.basegraph, code.Z)
    lay = FwdLayout.build(graph, 3, (-20.0, 20.0), flags.get("qms"), flags.get("sp", False),
                          True, flags.get("vn", False), True, "cpu",
                          routing=flags.get("routing", "roll"))
    chan, w = _inputs(lay, 5, seed=13)
    outs, store = fused_fwd_train_plain(chan, lay, *w)
    g = torch.randn(outs.shape, generator=torch.Generator().manual_seed(6))
    got = fused_bwd_block_plain(chan, lay, *w, store, outs, g)
    ref = fused_bwd_plain(chan, lay, *w, store, outs, g)
    assert_twin_matches(got, ref)
    if flags.get("exact"):
        assert all(a is None or torch.equal(a, b) for a, b in zip(got, ref))


def test_k6_wrappers_run_their_plain_versions_on_the_cpu():
    """On a matmul layout every K1 mode wrapper and K2 equal the plain
    versions; QMS in int8 routing equals the roll layout bit for bit; no
    wrapper counts a launch on the CPU."""
    code, dec, jdec = build_grad_pair(BG2, None, "QMS", dict(cn=3, ucn=2, vn=3), 3)
    params, llr, _ = grad_inputs(code, dec, jdec, batch=6)
    p = {k: torch.tensor(v) for k, v in params.items()}
    mm = FusedTrainDecoder.from_decoder(dec, routing="matmul")
    roll = FusedTrainDecoder.from_decoder(dec, routing="roll")
    w = mm.pack_weights(*dec._expanded_weights(p))
    lay, chan = mm.layout, torch.tensor(llr).reshape(6, -1)
    wrappers = (fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c, fused_fwd_k1d, fused_bwd_k2)
    before = [f.launches for f in wrappers]
    app = fused_fwd_k1a(chan, lay, *w)
    assert torch.equal(app, fused_fwd_plain(chan, lay, *w))
    assert torch.equal(app, fused_fwd_k1a(chan, roll.layout, *w))
    assert torch.equal(fused_fwd_k1b(chan, lay, *w), stats_plain(app, lay))
    a2, st2 = fused_fwd_k1b(chan, lay, *w, emit_app=True)
    assert torch.equal(a2, app) and torch.equal(st2, stats_plain(app, lay))
    outs, store = fused_fwd_k1d(chan, lay, *w)
    r_outs, r_store = fused_fwd_train_plain(chan, lay, *w)
    assert torch.equal(outs, r_outs) and torch.equal(store, r_store)
    g = torch.randn(outs.shape, generator=torch.Generator().manual_seed(2))
    ours = fused_bwd_k2(chan, lay, *w, store, outs, g)
    for a, b in zip(ours, fused_bwd_plain(chan, lay, *w, store, outs, g)):
        assert (a is None and b is None) or torch.equal(a, b)
    # int8 routing is value-exact, but its cotangents go through bf16: close
    # to K2's in norm, not equal
    k2 = fused_bwd_k2(chan, roll.layout, *w, store, outs, g)[3]
    rel = float((ours[3] - k2).norm() / k2.norm())
    assert 0 < rel < 0.05, rel
    sampled = fused_fwd_k1c(lay, *w, 5, 0.8, batch=4)
    assert sampled.shape == (4, 3)
    assert [f.launches for f in wrappers] == before
    with pytest.raises(ValueError, match="unknown mode"):
        _fwd_k1(chan, lay, *w, mode="app_and_more")


def test_routing_rules_follow_jax():
    code = get_code(BG2)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    # auto: roll up to 1024 edges; roll forces int8 off
    d = FusedTrainDecoder(g, 2, qms_qbit=5, int8_routing=True, device="cpu")
    assert d.routing == "roll" and not d.int8_routing and d.layout.routing == "roll"
    # matmul: int8 for QMS by default, cotangents in routing_dtype
    d = FusedTrainDecoder(g, 2, qms_qbit=5, routing="matmul", device="cpu")
    assert d.int8_routing and d.layout.routing == "int8" and not d.layout.grad_f32
    d = FusedTrainDecoder(g, 2, qms_qbit=5, routing="matmul", routing_dtype=torch.float32,
                          device="cpu")
    assert d.layout.grad_f32
    # without int8 the split-3 routing, its operand in bf16
    d = FusedTrainDecoder(g, 2, qms_qbit=5, routing="matmul", int8_routing=False,
                          routing_dtype=torch.float32, device="cpu")
    assert d.layout.routing == "split3" and d.routing_dtype == torch.bfloat16
    assert FusedTrainDecoder(g, 2, routing="matmul", device="cpu").layout.routing == "split3"
    with pytest.raises(ValueError, match="int8 routing needs QMS quantization"):
        FusedTrainDecoder(g, 2, routing="matmul", int8_routing=True, device="cpu")
    with pytest.raises(ValueError, match="unknown routing"):
        FusedTrainDecoder(g, 2, routing="diagonal", device="cpu")
    with pytest.raises(ValueError, match="routing_dtype"):
        FusedTrainDecoder(g, 2, routing="matmul", routing_dtype=torch.float16, device="cpu")
    msg = "store_space='hbm' requires roll routing"
    with pytest.raises(ValueError, match=msg):
        FusedTrainDecoder(g, 2, routing="matmul", store_space="hbm", device="cpu")
    jg = JaxTannerGraph.from_basegraph(code.basegraph, code.Z)
    with pytest.raises(ValueError, match=msg):
        JaxTrain(jg, 2, routing="matmul", store_space="hbm", interpret=True)
    # the decode entry point forwards the options to its matmul routing
    f = FusedMinsumDecoder(g, 2, qms_qbit=5, int8_routing=False, device="cpu")
    assert f.layout.routing == "roll"


def test_auto_routing_and_capacity_beyond_1024_edges():
    """The E = 1100 protograph at Z = 16 (check degrees 23-24): on chip, so
    the fused kernels take it at any E; "auto" routes it by matmul; the
    campaign picks the fused engine and decodes through K6's plain
    version."""
    code = dense_protograph()
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    degs = np.diff(g.row_ptr)
    assert g.E == 1100 and degs.min() >= 23 and degs.max() <= 24
    assert on_chip_ok(g) and fused_capacity_ok(g)
    assert not fused_capacity_ok(TannerGraph.from_basegraph(code.basegraph, 64))  # off chip, E > 1024
    d = FusedTrainDecoder(g, 2, device="cpu")
    assert d.routing == "matmul" and d.layout.routing == "split3" and not d.layout.hbm_store
    assert FusedTrainDecoder(g, 2, qms_qbit=5, device="cpu").layout.routing == "int8"
    dec = BoostedNeuralDecoder(g, BoostedDecoderConfig(
        n_iterations=2, decoder_type=DecoderType.MS,
        sharing=NodeWeightSharingConfig(cn=3)), device="cpu")
    channel = AWGNChannel(code, ChannelConfig(snr_db=(2.0,)), device="cpu")
    camp = MonteCarloCampaign(dec, dec.init_params(), channel, CampaignConfig(
        engine="fused", batch_size=4, max_words_per_snr=4, min_frame_errors=0,
        early_exit_iters=1, early_exit_auto_guard=False, kernel_channel_sampling="on"))
    assert camp.fused and camp.kernel_sampling
    assert camp.decoders["full"].layout.routing == "split3"
    r = camp.run(verbose=False)[2.0]
    assert r["words"] == 4 and np.isfinite(r["ber"][0])
