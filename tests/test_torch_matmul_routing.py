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
from neural_ldpc_tpu.training.loss import multi_iteration_loss as jax_loss
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.codes.protograph import dense_protograph
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, FusedTrainDecoder, fused_bwd_k2, fused_bwd_k6, fused_bwd_plain,
    fused_capacity_ok, fused_fwd_k1a, fused_fwd_k6, fused_fwd_plain, fused_fwd_train_plain,
    on_chip_ok, stats_plain)
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
from neural_ldpc_tpu_torch.training import multi_iteration_loss
from test_torch_decoder import assert_close
from test_torch_grad import BG2, GRAD_TOL, WMAN, build_grad_pair, grad_inputs


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
], ids=["wman-z8-MS-split3", "bg2-QMS-split3", "bg2-QMS-ucn-int8"])
def test_decode_matches_jax_interpret(code_name, z, decoder_type, sharing, n_iter, int8):
    _check_decode(code_name, z, decoder_type, sharing, n_iter, int8)


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


def test_k6_wrappers_run_their_plain_versions_on_the_cpu():
    """Every K6 forward mode and the backward equal the plain versions on a
    matmul layout; QMS in int8 routing equals K1 (roll) bit for bit; neither
    wrapper counts a launch on the CPU; K1 wrappers refuse nothing there."""
    code, dec, jdec = build_grad_pair(BG2, None, "QMS", dict(cn=3, ucn=2, vn=3), 3)
    params, llr, _ = grad_inputs(code, dec, jdec, batch=6)
    p = {k: torch.tensor(v) for k, v in params.items()}
    mm = FusedTrainDecoder.from_decoder(dec, routing="matmul")
    roll = FusedTrainDecoder.from_decoder(dec, routing="roll")
    w = mm.pack_weights(*dec._expanded_weights(p))
    lay, chan = mm.layout, torch.tensor(llr).reshape(6, -1)
    before = (fused_fwd_k6.launches, fused_bwd_k6.launches)
    app = fused_fwd_k6(chan, lay, *w)
    assert torch.equal(app, fused_fwd_plain(chan, lay, *w))
    assert torch.equal(app, fused_fwd_k1a(chan, roll.layout, *w))
    assert torch.equal(fused_fwd_k6(chan, lay, *w, mode="stats"), stats_plain(app, lay))
    a2, st2 = fused_fwd_k6(chan, lay, *w, mode="syndrome")
    assert torch.equal(a2, app) and torch.equal(st2, stats_plain(app, lay))
    outs, store = fused_fwd_k6(chan, lay, *w, mode="stream")
    r_outs, r_store = fused_fwd_train_plain(chan, lay, *w)
    assert torch.equal(outs, r_outs) and torch.equal(store, r_store)
    g = torch.randn(outs.shape, generator=torch.Generator().manual_seed(2))
    ours = fused_bwd_k6(chan, lay, *w, store, outs, g)
    for a, b in zip(ours, fused_bwd_plain(chan, lay, *w, store, outs, g)):
        assert (a is None and b is None) or torch.equal(a, b)
    # int8 routing is value-exact, but its cotangents go through bf16: close
    # to K2's in norm, not equal
    k2 = fused_bwd_k2(chan, roll.layout, *w, store, outs, g)[3]
    rel = float((ours[3] - k2).norm() / k2.norm())
    assert 0 < rel < 0.05, rel
    sampled = fused_fwd_k6(None, lay, *w, mode="sample", seed=5, sigma=0.8, batch=4)
    assert sampled.shape == (4, 3)
    assert (fused_fwd_k6.launches, fused_bwd_k6.launches) == before
    with pytest.raises(ValueError, match="unknown mode"):
        fused_fwd_k6(chan, lay, *w, mode="app_and_more")


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
