"""The port's native host tier (``neural_ldpc_tpu_torch.native``, its own copy
of ``ldpc_host.cc`` built into the port's package) and ``HostDatagen``
against the JAX package's, byte for byte; the port's numpy fallback against
its C++; and ``as_train_datagen`` feeding the port's ``Trainer``."""

import os

import numpy as np
import pytest
import torch

from neural_ldpc_tpu import native as jax_native
from neural_ldpc_tpu.channel import ChannelConfig as JaxChannelConfig
from neural_ldpc_tpu.channel import HostDatagen as JaxHostDatagen
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.structs import Convention as JaxConvention
from neural_ldpc_tpu_torch import native
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig, HostBatch, HostDatagen
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder
from neural_ldpc_tpu_torch.structs import (
    Convention, DecoderType, NodeWeightSharingConfig, Puncture, Shortening)
from neural_ldpc_tpu_torch.training import TrainConfig, Trainer

BG2 = "nr_bg2_set0_z16"


@pytest.fixture(scope="module")
def bg2():
    code = get_code(BG2)
    return code, TannerGraph.from_basegraph(code.basegraph, code.Z)


@pytest.fixture
def numpy_fallback():
    """Run the port's numpy paths: the loaded library is set aside."""
    lib, tried = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        yield
    finally:
        native._lib, native._tried = lib, tried


def test_port_builds_and_loads_its_own_library():
    assert native.available() and jax_native.available()
    pkg = os.path.dirname(os.path.abspath(native.__file__))
    assert native._LIB_PATH == os.path.join(pkg, "build", "libldpc_host.so")
    assert os.path.isfile(native._LIB_PATH) and native._LIB_PATH != jax_native._LIB_PATH
    with open(os.path.join(pkg, "src", "ldpc_host.cc")) as f:
        ours = f.read().split('#include <cstdint>', 1)[1]
    with open(os.path.join(os.path.dirname(jax_native.__file__), "src", "ldpc_host.cc")) as f:
        assert ours == f.read().split('#include <cstdint>', 1)[1]  # the same code


def _entry_points(mod, code, graph):
    """Every entry point of a native module on fixed inputs."""
    rng = np.random.default_rng(1)
    G = code.gen_matrix
    gp = mod.pack_rows(G)
    info = rng.integers(0, 2, size=(37, G.shape[0])).astype(np.uint8)
    cw = mod.gf2_encode(info, gp, G.shape[1])
    bad = cw.copy()
    bad[::3, 7] ^= 1
    hp = mod.pack_rows(graph.lifted_parity_check_matrix())
    sigma = np.linspace(0.5, 1.2, 37)
    llr = rng.normal(size=(37, code.n_bits)).astype(np.float32)
    return dict(
        gp=gp, hp=hp, cw=cw, ok=mod.gf2_syndrome_ok(bad, hp, code.n_bits),
        awgn_zero=mod.awgn_llr(None, sigma, code.n_bits, seed=123, word_offset=1000),
        awgn_std=mod.awgn_llr(cw, sigma, code.n_bits, seed=9, word_offset=5),
        awgn_ref=mod.awgn_llr(cw, sigma, code.n_bits, seed=9, word_offset=5, bit0_plus=False),
        awgn_odd=mod.awgn_llr(cw[:, :-1], sigma, code.n_bits - 1, seed=2**63 + 17),
        errors=mod.count_errors(llr, cw),
        errors_zero=mod.count_errors(llr),
    )


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], tuple):
            assert a[k][:2] == b[k][:2], k
            np.testing.assert_array_equal(a[k][2], b[k][2], err_msg=k)
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_library_matches_jax_native_byte_for_byte(bg2):
    code, graph = bg2
    ours = _entry_points(native, code, graph)
    theirs = _entry_points(jax_native, jax_get_code(BG2), graph)
    _assert_same(ours, theirs)
    assert not ours["ok"][::3].any() and ours["ok"][1::3].all()
    # the codewords are G's: info @ G mod 2
    rng = np.random.default_rng(1)
    info = rng.integers(0, 2, size=(37, code.gen_matrix.shape[0]))
    np.testing.assert_array_equal(ours["cw"], info @ code.gen_matrix % 2)


def test_numpy_fallback_matches_the_library(bg2, numpy_fallback):
    code, graph = bg2
    assert native._ensure_built() is None
    fallback = _entry_points(native, code, graph)
    native._tried = False  # load the library for the other side
    built = _entry_points(native, code, graph)
    assert native._lib is not None
    _assert_same(fallback, built)


HOST_CASES = [
    dict(convention="standard", all_zero=True, snr_index=None, cfg=dict(snr_db=(2.0, 4.0))),
    dict(convention="standard", all_zero=False, snr_index=1,
         cfg=dict(snr_db=(1.0, 3.0), qms_qbit=5, puncture=Puncture(1, 32),
                  shortening=Shortening(800, 808))),
    dict(convention="reference", all_zero=True, snr_index=None, cfg=dict(snr_db=(3.0,))),
    dict(convention="reference", all_zero=False, snr_index=None,
         cfg=dict(snr_db=(2.0, 3.0), qms_qbit=5, shortening=Shortening(800, 808))),
]


@pytest.mark.parametrize("case", HOST_CASES, ids=lambda c: f"{c['convention']}-"
                         f"{'zero' if c['all_zero'] else 'random'}-{len(c['cfg'])}")
def test_host_datagen_matches_jax_byte_for_byte(bg2, case):
    code, graph = bg2
    cfg = case["cfg"]
    ours = HostDatagen(code, ChannelConfig(convention=Convention(case["convention"]), **cfg),
                       seed=11)
    theirs = JaxHostDatagen(jax_get_code(BG2), JaxChannelConfig(
        convention=JaxConvention(case["convention"]), **cfg), seed=11)
    np.testing.assert_array_equal(ours.sigma, theirs.sigma)
    for offset, n in ((0, 6), (1000, 5)):
        b = ours.batch(offset, n, all_zero=case["all_zero"], snr_index=case["snr_index"])
        jb = theirs.batch(offset, n, all_zero=case["all_zero"], snr_index=case["snr_index"])
        assert isinstance(b, HostBatch) and b.llr.shape == (n, code.N, code.Z)
        assert b.llr.dtype == jb.llr.dtype == np.float32 and b.bits.dtype == jb.bits.dtype
        np.testing.assert_array_equal(b.llr, jb.llr)
        np.testing.assert_array_equal(b.bits, jb.bits)
        assert ours.verify_codewords(b.bits, graph).all()
    # offset invariance: words [o, o + n) are a slice of [o - k, o + n)
    big = ours.batch(996, 9, all_zero=case["all_zero"], snr_index=case["snr_index"])
    np.testing.assert_array_equal(big.llr[4:], b.llr)
    np.testing.assert_array_equal(big.bits[4:], b.bits)
    # the all-zero LLRs lean to +2/sigma^2 under STANDARD, to -2/sigma^2 under REFERENCE
    if case["all_zero"]:
        sign = 1.0 if case["convention"] == "standard" else -1.0
        assert sign * b.llr.mean() > 0


def test_host_datagen_fallback_equals_library(bg2, numpy_fallback):
    code, _ = bg2
    cfg = ChannelConfig(snr_db=(2.0, 3.0), convention=Convention.REFERENCE)
    fallback = HostDatagen(code, cfg, seed=3).batch(40, 4, all_zero=False)
    native._tried = False
    built = HostDatagen(code, cfg, seed=3).batch(40, 4, all_zero=False)
    np.testing.assert_array_equal(fallback.llr, built.llr)
    np.testing.assert_array_equal(fallback.bits, built.bits)


def test_host_datagen_feeds_trainer(bg2, tmp_path):
    """``as_train_datagen`` drives the port's training loop: numpy batches
    from successive word windows of the stream."""
    code, graph = bg2
    dg = HostDatagen(code, ChannelConfig(snr_db=(2.0, 4.0)), seed=5)
    feed = dg.as_train_datagen(all_zero=False, start_offset=10)
    x, y = feed(3)
    np.testing.assert_array_equal(x, dg.batch(10, 3, all_zero=False).llr)
    assert y.dtype == np.float32 and np.array_equal(feed(2)[1], dg.batch(13, 2,
                                                                        all_zero=False).bits)
    dec = BoostedNeuralDecoder(graph, BoostedDecoderConfig(
        n_iterations=3, decoder_type=DecoderType.MS,
        sharing=NodeWeightSharingConfig(cn=3)), device="cpu")
    cfg = TrainConfig(total_epochs=2, batch_size=8, train_words_per_epoch=16, validate_words=8,
                      validate_epoch_step=2, checkpoint_step=10**9, log_metrics_step=10**9,
                      progress_step=10**9, checkpoint_dir=str(tmp_path),
                      export_weights_txt=False, verbose=False, is_y_all_zero=False)
    channel = AWGNChannel(code, ChannelConfig(snr_db=(2.0, 4.0)), device="cpu")
    for engine in ("xla", "fused"):  # the fused engine through the kernels' plain versions
        trainer = Trainer(dec, channel, TrainConfig(**{**cfg.__dict__, "engine": engine}),
                          host_datagen=dg.as_train_datagen(all_zero=False))
        params, _, info = trainer.train()
        assert np.isfinite(info["best_loss"])
        assert float((params["weight_cn"] - 1.0).abs().max()) > 0
    assert isinstance(params["weight_cn"], torch.Tensor)
