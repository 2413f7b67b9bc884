"""The stats and syndrome epilogues of the fused decode (K1b) on the CPU,
where the wrappers run their plain versions: held against the JAX Pallas
``_fwd_kernel`` in interpret mode on the JAX tests' own inputs, and against
the JAX XLA syndrome of the port's APP.  Counters and flags are exact; the
APP meets the MS bar of 2e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.eval.two_stage import make_syndrome_ok
from neural_ldpc_tpu.ops.pallas.minsum import FusedMinsumDecoder as JaxFused
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, FusedTrainDecoder, fused_fwd_k1b, fused_fwd_plain, stats_plain,
    syndrome_ok_plain)
from test_torch_decoder import BG2, WMAN, build_pair, channel, random_weights


def _graphs(code_name, Z):
    code, jcode = get_code(code_name), jax_get_code(code_name)
    return (TannerGraph.from_basegraph(code.basegraph, Z),
            JaxTannerGraph.from_basegraph(jcode.basegraph, Z))


def _jax_test_llr(seed, N):
    """The JAX suite's mid-noise inputs (tests/test_fused_kernel.py:199-223)."""
    rng = np.random.default_rng(seed)
    return rng.normal(loc=5.0, scale=2.7, size=(32, N, 8)).astype(np.float32)


def _wman_z8_pair(**kw):
    """wman at Z = 8, MS x2 with unit CN weights (cn=3), both packages."""
    g, jg = _graphs(WMAN, 8)
    cw = np.ones((2, g.E), np.float32)
    ours = FusedMinsumDecoder(g, 2, cn_weights=cw, device="cpu", **kw)
    theirs = JaxFused(jg, 2, cn_weights=cw, interpret=True, bt=8, **kw)
    return g, jg, ours, theirs


@pytest.mark.parametrize("seed", [5, 6])
def test_emit_stats_matches_jax_interpret(seed):
    g, jg, ours, theirs = _wman_z8_pair(emit_stats=True)
    llr = _jax_test_llr(seed, g.N)
    ok, be, fe = ours(torch.tensor(llr))
    jok, jbe, jfe = (np.asarray(v) for v in theirs(jnp.asarray(llr)))
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(be.numpy(), jbe)
    np.testing.assert_array_equal(fe.numpy(), jfe)
    assert 0 < int(ok.sum()) < 32  # both populations present
    assert be.dtype == torch.int32 and ok.dtype == fe.dtype == torch.bool


def test_emit_syndrome_matches_jax_interpret():
    g, jg, ours, theirs = _wman_z8_pair(emit_syndrome=True)
    llr = _jax_test_llr(5, g.N)
    app, ok = ours(torch.tensor(llr))
    japp, jok = theirs(jnp.asarray(llr))
    np.testing.assert_allclose(app.numpy(), np.asarray(japp), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(make_syndrome_ok(jg)(japp)))
    # the syndrome decoder's APP is the plain decode's APP
    _, _, plain, _ = _wman_z8_pair()
    np.testing.assert_array_equal(app.numpy(), plain(torch.tensor(llr)).numpy())


def test_bg2_qms_stats_match_jax_interpret():
    code, dec, jdec = build_pair(BG2, "QMS", dict(cn=3, vn=3), 3)
    w = random_weights(jdec, seed=3)
    x = np.round(channel(code, 16, seed=9, scale=3.0, offset=3.0) * 2) / 2
    ours = FusedMinsumDecoder.from_decoder(
        dec, {k: torch.tensor(v) for k, v in w.items()}, emit_stats=True)
    theirs = JaxFused.from_decoder(jdec, {k: jnp.asarray(v) for k, v in w.items()},
                                   routing_dtype=jnp.float32, interpret=True, bt=8,
                                   emit_stats=True)
    for a, b in zip(ours(torch.tensor(x)), theirs(jnp.asarray(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# (code, type, sharing, iterations, channel mean): the mean puts some words
# on each side of the syndrome
UCN_SP_CASES = [
    (WMAN, "QMS", dict(cn=2, ucn=2, vn=3), 4, 5.0),
    (WMAN, "SP", dict(cn=1, vn=2), 4, 5.0),
    (BG2, "MS", dict(cn=3, ucn=3, vn=3), 3, 3.0),
    (BG2, "SP", dict(cn=3, ucn=3, vn=3), 3, 3.0),
]


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,mean", UCN_SP_CASES,
                         ids=["wman-QMS-ucn", "wman-SP", "bg2-MS-ucn", "bg2-SP-ucn"])
def test_stats_and_syndrome_modes_match_plain_composition(code_name, decoder_type, sharing,
                                                          n_iter, mean):
    """Every decoder type and weighting: the stats and syndrome modes equal
    the counts of the port's own APP, with the syndrome taken by the JAX XLA
    path."""
    code, dec, jdec = build_pair(code_name, decoder_type, sharing, n_iter)
    w = {k: torch.tensor(v) for k, v in random_weights(jdec, seed=4).items()}
    x = torch.tensor(channel(code, 12, seed=10, scale=2.7, offset=mean))
    app = FusedMinsumDecoder.from_decoder(dec, w)(x).numpy()
    ok, be, fe = FusedMinsumDecoder.from_decoder(dec, w, emit_stats=True)(x)
    app2, ok2 = FusedMinsumDecoder.from_decoder(dec, w, emit_syndrome=True)(x)
    ok_ref = np.asarray(make_syndrome_ok(jdec.graph)(jnp.asarray(app)))
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    np.testing.assert_array_equal(ok2.numpy(), ok_ref)
    np.testing.assert_array_equal(app2.numpy(), app)
    np.testing.assert_array_equal(be.numpy(), (app < 0).sum(axis=1))
    np.testing.assert_array_equal(fe.numpy(), (app < 0).any(axis=1))
    assert 0 < int(ok.sum()) < 12


def test_kernel_wrappers_and_train_decoder_agree():
    code, dec, jdec = build_pair(WMAN, "MS", dict(cn=3, vn=2), 3)
    w = {k: torch.tensor(v) for k, v in random_weights(jdec, seed=1).items()}
    x = torch.tensor(channel(code, 9, seed=2, scale=2.0, offset=2.5))
    fused = FusedMinsumDecoder.from_decoder(dec, w)
    lay, chan = fused.layout, x.reshape(9, -1)
    before = fused_fwd_k1b.launches
    st = fused_fwd_k1b(chan, lay, *fused._w)
    app, st2 = fused_fwd_k1b(chan, lay, *fused._w, emit_app=True)
    assert fused_fwd_k1b.launches == before  # CPU tensors run the plain versions
    plain = fused_fwd_plain(chan, lay, *fused._w)
    np.testing.assert_array_equal(app.numpy(), plain.numpy())
    np.testing.assert_array_equal(st.numpy(), stats_plain(plain, lay).numpy())
    np.testing.assert_array_equal(st2.numpy(), st.numpy())
    np.testing.assert_array_equal(st[:, 0].numpy() > 0, syndrome_ok_plain(plain, lay).numpy())
    ftd = FusedTrainDecoder.from_decoder(dec, emit_stats=True, store_msgs=False)
    cn_w, ucn_w, vn_w = dec._expanded_weights(w)
    ok, be, fe = ftd.apply(cn_w, ucn_w, vn_w, x)
    np.testing.assert_array_equal(be.numpy(), st[:, 1].numpy())
    out, ok3 = FusedTrainDecoder.from_decoder(dec, emit_syndrome=True, store_msgs=False).apply(
        cn_w, ucn_w, vn_w, x)
    assert out.shape == (1, 9, code.n_bits)
    np.testing.assert_array_equal(ok3.numpy(), ok.numpy())


@pytest.mark.parametrize("kw,match", [
    (dict(emit_stats=True, emit_syndrome=True), "stats row 0 IS the syndrome"),
    (dict(sample_channel=True), "set emit_stats=True"),
    (dict(emit_stats=True, emit_chan=True), "set sample_channel=True"),
    (dict(emit_stats=True, sample_at_idx=128), "set sample_channel=True"),
    (dict(emit_stats=True, sample_channel=True, emit_chan=True, sample_at_idx=128),
     "exclusive"),
    (dict(emit_stats=True, sample_channel=True, sample_at_idx=96), "power of two"),
])
def test_mode_validation_matches_jax_messages(kw, match):
    g, _ = _graphs(WMAN, 8)
    with pytest.raises(ValueError, match=match):
        FusedTrainDecoder(g, n_iterations=2, store_msgs=False, device="cpu", **kw)


def test_stats_decoder_refuses_channel_of_a_sampling_decoder():
    g, _ = _graphs(WMAN, 8)
    f = FusedMinsumDecoder(g, 2, emit_stats=True, sample_channel=True, device="cpu")
    with pytest.raises(ValueError, match="samples its own channel"):
        f(torch.zeros(2, g.N * g.Z))
    with pytest.raises(ValueError, match="sample_at_idx"):
        f.stats_sampled_at(1, 0.5, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="sample_channel=True"):
        FusedMinsumDecoder(g, 2, emit_stats=True, device="cpu").sample_stats(1, 0.5, 4)
