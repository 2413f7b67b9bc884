"""Checks of any degree, as JAX takes them.  The port's kernel families take
a code by JAX's capacity rule (``fused_capacity_ok``: the on-chip kernels
hold it, or E <= 1024), with no check-degree term; a check above 32 edges
runs the kernels' looped code (``csrc/bp_common.cuh``'s
``check_update_loop`` / ``check_adjoint_loop``), which the plain versions
and the layout twins mirror.  The codes: ``codes.protograph.synth_dense(3,
M, N, target_e)`` lifted at Z = 16 (on chip) and Z = 96 (device memory),
with checks of 41, 73 and 86 edges.  Held against the JAX package on the
same numpy-seeded inputs and weights: decodes (MS 2e-5, QMS exact, SP
5e-3), the whole loss's gradients (atol 1e-6 / rtol 1e-4), the campaign's
counters, the capacity rule; one case through JAX's Pallas ``_fwd_kernel``
in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.models import BoostedDecoderConfig as JaxConfig
from neural_ldpc_tpu.models import BoostedNeuralDecoder as JaxDecoder
from neural_ldpc_tpu.ops.pallas.fused_train import fused_capacity_ok as jax_capacity_ok
from neural_ldpc_tpu.ops.pallas.minsum import FusedMinsumDecoder as JaxFused
from neural_ldpc_tpu.structs import DecoderType as JaxType
from neural_ldpc_tpu.structs import NodeWeightSharingConfig as JaxSharing
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.codes.protograph import (
    CodeSpec, available_codes, dense_protograph, synth_dense)
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.models import (
    BoostedDecoderConfig, BoostedNeuralDecoder, params_from_numpy)
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, FusedTrainDecoder, fused_bwd_block_plain, fused_bwd_dm_plain,
    fused_bwd_plain, fused_capacity_ok, fused_fwd_block_plain, fused_fwd_dm_plain,
    fused_fwd_plain, fused_fwd_train_plain, on_chip_ok, stats_plain)
from neural_ldpc_tpu_torch.ops.cuda import fused_train as ft
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
from test_torch_decoder import assert_close, channel, random_weights
from test_torch_fused_train import fused_value_and_grads
from test_torch_grad import assert_grads_match, grad_inputs, jax_value_and_grads
from test_torch_k2_layout import _train_inputs, assert_twin_matches

# (M, N, target_e) of synth_dense(3, ...): the largest check degree
HIGH = {41: (12, 60, 400), 73: (8, 80, 560), 86: (6, 90, 500)}


def _code(degree, Z=16):
    return CodeSpec(name=f"synth_dense_deg{degree}", basegraph=synth_dense(3, *HIGH[degree]),
                    Z=Z)


def _pair(degree, decoder_type, sharing, n_iter, Z=16):
    """(code, port decoder, JAX flat decoder at highest precision)."""
    code = _code(degree, Z)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, Z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)), device="cpu")
    jdec = JaxDecoder(
        JaxTannerGraph.from_basegraph(code.basegraph, Z),
        JaxConfig(n_iterations=n_iter, decoder_type=JaxType[decoder_type],
                  sharing=JaxSharing(**sharing), matmul_precision="highest"))
    return code, dec, jdec


@pytest.mark.parametrize("degree", sorted(HIGH))
@pytest.mark.parametrize("Z", [16, 96])
def test_capacity_rule_is_jaxs_on_checks_above_32_edges(degree, Z):
    """Both rules take the three codes at both lifts (on chip at Z = 16; at
    Z = 96 the device-memory kernels, E <= 1024)."""
    bg = synth_dense(3, *HIGH[degree])
    g, jg = TannerGraph.from_basegraph(bg, Z), JaxTannerGraph.from_basegraph(bg, Z)
    assert ft._max_check_degree(g) == degree
    assert on_chip_ok(g) == (Z == 16)
    for qms in (False, True):
        assert fused_capacity_ok(g) == jax_capacity_ok(jg, qms=qms) is True


@pytest.mark.parametrize("name", available_codes())
def test_capacity_rule_is_jaxs_on_the_shipped_codes(name):
    code, jcode = get_code(name), jax_get_code(name)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    jg = JaxTannerGraph.from_basegraph(jcode.basegraph, jcode.Z)
    # JAX's rule at its default (QMS's two more VMEM windows refuse the
    # BG1-like code at Z = 384 there; the port's rule has no decoder type)
    assert fused_capacity_ok(g) == jax_capacity_ok(jg) is True


def test_an_ineligible_code_raises_value_error():
    """The E = 1100 protograph at Z = 64: off chip and over the roll
    routing's 1024 edges.  A fused campaign raises ValueError, as JAX's."""
    code = dense_protograph(64)
    g = TannerGraph.from_basegraph(code.basegraph, 64)
    assert not on_chip_ok(g) and not fused_capacity_ok(g)
    dec = BoostedNeuralDecoder(g, BoostedDecoderConfig(
        n_iterations=2, decoder_type=DecoderType.MS,
        sharing=NodeWeightSharingConfig(cn=3)), device="cpu")
    ch = AWGNChannel(code, ChannelConfig(snr_db=(7.0,)), device="cpu")
    with pytest.raises(ValueError, match="not eligible"):
        MonteCarloCampaign(dec, dec.init_params(), ch, CampaignConfig(engine="fused"))


DECODE_CASES = [(41, "MS", dict(cn=3, ucn=3)), (41, "QMS", dict(cn=3, vn=3)),
                (41, "SP", dict(cn=1, vn=2)), (73, "MS", dict(cn=3, vn=3)),
                (73, "QMS", dict(cn=3, ucn=2, vn=3))]
DECODE_IDS = [f"deg{d}-{t}-{'-'.join(f'{k}{v}' for k, v in s.items())}"
              for d, t, s in DECODE_CASES]


@pytest.mark.parametrize("degree,decoder_type,sharing", DECODE_CASES, ids=DECODE_IDS)
def test_fused_decode_matches_jax_flat(degree, decoder_type, sharing):
    """The fused decode (the K1a plain version) against the JAX flat path;
    the forward kernel's block twin equals the plain version bit for bit in
    every mode, at a batch its words a block do not divide."""
    code, dec, jdec = _pair(degree, decoder_type, sharing, 3)
    w = random_weights(jdec, seed=degree)
    fused = FusedMinsumDecoder.from_decoder(dec, params_from_numpy(w, "cpu"))
    lay = fused.layout
    B = lay.k1.W + 1
    x = channel(code, B, seed=5)
    if decoder_type == "QMS":
        x = np.round(x * 2) / 2
    ours = fused(torch.tensor(x)).numpy()
    theirs = np.asarray(jdec.apply({k: jnp.asarray(v) for k, v in w.items()},
                                   jnp.asarray(x))[-1]).reshape(ours.shape)
    assert_close(decoder_type, ours, np.clip(theirs, -20.0, 20.0))
    chan = torch.tensor(x.reshape(B, -1))
    assert lay.k1.W > 1
    ref = fused_fwd_plain(chan, lay, *fused._w)
    app, _, _ = fused_fwd_block_plain(chan, lay, *fused._w)
    assert torch.equal(app, ref)
    outs, store, _ = fused_fwd_block_plain(chan, lay, *fused._w, mode="stream", store=True)
    ref_outs, ref_store = fused_fwd_train_plain(chan, lay, *fused._w)
    assert torch.equal(outs, ref_outs) and torch.equal(store, ref_store)
    _, _, st = fused_fwd_block_plain(chan, lay, *fused._w, mode="stats")
    assert torch.equal(st, stats_plain(ref, lay))


GRAD_CASES = [(41, "MS", dict(cn=3, ucn=2), 3), (41, "QMS", dict(cn=3, vn=3), 3),
              (73, "QMS", dict(cn=3, vn=3), 2), (73, "MS", dict(cn=1, vn=2), 2),
              (41, "SP", dict(cn=1, vn=2), 2)]


@pytest.mark.parametrize("twins", [False, True], ids=["plain", "twins"])
@pytest.mark.parametrize("degree,decoder_type,sharing,n_iter", GRAD_CASES,
                         ids=[f"deg{c[0]}-{c[1]}x{c[3]}-{'-'.join(f'{k}{v}' for k, v in c[2].items())}"
                              for c in GRAD_CASES])
def test_fused_train_gradients_match_jax_flat(degree, decoder_type, sharing, n_iter, twins,
                                              monkeypatch):
    """The whole loss through FusedTrainFn (K1d and K2's plain versions, or
    with ``twins`` the kernels' block twins) against JAX's flat path."""
    if twins:
        monkeypatch.setattr(ft, "fused_bwd_plain", fused_bwd_block_plain)
        monkeypatch.setattr(ft, "fused_fwd_train_plain", lambda chan, lay, *w, store=True: (
            fused_fwd_block_plain(chan, lay, *w, mode="stream", store=store)[:2]))
    code, dec, jdec = _pair(degree, decoder_type, sharing, n_iter)
    params, llr, bits = grad_inputs(code, dec, jdec, batch=6)
    _, loss, gp, gx = fused_value_and_grads(dec, params, llr, bits)
    assert_grads_match(loss, gp, gx, *jax_value_and_grads(jdec, params, llr, bits))


@pytest.mark.parametrize("degree,flags", [
    (41, dict(qms=5, vn=True, ucn=True)), (73, dict(ucn=True)), (86, dict(sp=True, vn=True)),
    (41, dict(qms=5, routing="int8")), (73, dict(vn=True, routing="split3"))])
def test_backward_twin_on_checks_above_32_edges(degree, flags):
    """K2's block twin (and K6's, through its routings) equals the plain
    version on the looped code's checks, at W_max + 1 words on the plan the
    card takes at a large batch."""
    lay = ft.FwdLayout.build(TannerGraph.from_basegraph(synth_dense(3, *HIGH[degree]), 16), 2,
                             (-20.0, 20.0), flags.get("qms"), flags.get("sp", False), True,
                             flags.get("vn", False), flags.get("ucn", False), "cpu",
                             routing=flags.get("routing", "roll"))
    assert lay.max_degree == degree
    plan = ft.k2_plan(lay, 16384)
    chan, w, store, outs, g = _train_inputs(lay, plan.W + 1, seed=degree)
    assert_twin_matches(fused_bwd_block_plain(chan, lay, *w, store, outs, g, plan=plan),
                        fused_bwd_plain(chan, lay, *w, store, outs, g))


@pytest.mark.parametrize("degree,flags", [(41, dict(qms=5, vn=True)), (73, dict(ucn=True)),
                                          (41, dict(sp=True, vn=True))])
def test_device_memory_plain_versions_equal_the_on_chip_ones(degree, flags):
    """The forced device-memory layout (store_space="hbm": no cluster holds
    a check above 32 edges, so K3 and K4 are the two-pass and device-memory
    kernels) decodes and differentiates as the on-chip one, bit for bit."""
    g = TannerGraph.from_basegraph(synth_dense(3, *HIGH[degree]), 16)
    args = (g, 3, (-20.0, 20.0), flags.get("qms"), flags.get("sp", False), True,
            flags.get("vn", False), flags.get("ucn", False), "cpu")
    lay, hlay = ft.FwdLayout.build(*args), ft.FwdLayout.build(*args, hbm_store=True)
    assert hlay.cluster is None and hlay.bwd_cluster is None
    assert hlay.k3_kernel == "two-pass" and hlay.k4_kernel == "device-memory"
    chan, w, store, outs, g_out = _train_inputs(lay, 3, seed=degree)
    assert torch.equal(fused_fwd_dm_plain(chan, hlay, *w)[0], fused_fwd_plain(chan, lay, *w))
    h_outs, h_store = fused_fwd_dm_plain(chan, hlay, *w, stream=True, store=True)
    assert torch.equal(h_outs, outs) and torch.equal(h_store, store[1:])
    got = fused_bwd_dm_plain(chan, hlay, *w, h_store, outs, g_out)
    ref = fused_bwd_plain(chan, lay, *w, store, outs, g_out)
    for a, b in zip(got[3:], ref[3:]):
        assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(got[:3], ref[:3]):
        assert (a is None and b is None) or torch.allclose(a, b, rtol=1e-5, atol=1e-6)


def _campaign(engine, qms, **kw):
    code = _code(41)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    dec = BoostedNeuralDecoder(g, BoostedDecoderConfig(
        n_iterations=4, decoder_type=DecoderType.QMS if qms else DecoderType.MS,
        sharing=NodeWeightSharingConfig(cn=3)), device="cpu")
    ch = AWGNChannel(code, ChannelConfig(snr_db=(3.5,), qms_qbit=5 if qms else None),
                     device="cpu")
    camp = MonteCarloCampaign(dec, dec.init_params(), ch, CampaignConfig(
        batch_size=32, max_words_per_snr=96, min_frame_errors=0, seed=7, engine=engine,
        early_exit_auto_guard=False, kernel_channel_sampling="off", **kw))
    return camp, camp.run(verbose=False)[3.5]


@pytest.mark.parametrize("qms", [True, False], ids=["QMS", "MS"])
def test_campaign_counts_equal_the_plain_engine(qms):
    """The fused campaign on a code with checks of 41 edges, the channel
    read from AWGNChannel: its final-iteration counters equal the plain
    engine's on the same words, and early exit (and every window redone)
    equals the full unroll."""
    fused, r_full = _campaign("fused", qms)
    assert fused.fused and not fused.kernel_sampling
    _, r_xla = _campaign("xla", qms)
    assert r_full["words"] == r_xla["words"] == 96
    assert r_full["ber"][0] == r_xla["ber"][-1] and r_full["fer"][0] == r_xla["fer"][-1]
    assert 0 < r_full["fer"][0] < 1
    _, r_ee = _campaign("fused", qms, early_exit_iters=2)
    _, r_of = _campaign("fused", qms, early_exit_iters=2, early_exit_capacity=1)
    assert r_ee == r_full == r_of


@pytest.mark.slow
def test_plain_kernel_matches_jax_interpret_on_checks_above_32_edges():
    """JAX's Pallas _fwd_kernel in interpret mode on the degree-41 code,
    QMS x2 with CN and VN weights: the same APP as the port's fused decode."""
    code, dec, jdec = _pair(41, "QMS", dict(cn=3, vn=3), 2)
    w = random_weights(jdec, seed=2)
    fused = FusedMinsumDecoder.from_decoder(dec, params_from_numpy(w, "cpu"))
    x = np.round(channel(code, 4, seed=6) * 2) / 2
    jf = JaxFused.from_decoder(jdec, {k: jnp.asarray(v) for k, v in w.items()},
                               routing_dtype=jnp.float32, interpret=True, bt=8)
    np.testing.assert_array_equal(fused(torch.tensor(x)).numpy(), np.asarray(jf(jnp.asarray(x))))


def test_k1_plan_takes_the_looped_codes_launch_bound():
    """A code with a check above 32 edges takes the forward's kAnyDegree
    instantiation, built for 2 blocks an SM like the 32-slot one."""
    lay = ft.FwdLayout.build(TannerGraph.from_basegraph(synth_dense(3, *HIGH[73]), 16), 2,
                             (-20.0, 20.0), None, False, True, False, False, "cpu")
    assert lay.k1.blocks_target == 2 and lay.k1.W >= 1
    assert ft.k2_plan(lay, 20).W == 1 and ft.k2_plan(lay, 16384).W == lay.k2_base.W_max
