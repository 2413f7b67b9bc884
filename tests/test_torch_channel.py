"""Port's AWGN channel and error counting (neural_ldpc_tpu_torch.channel / .eval).

A torch.Generator gives other numbers than jax.random, so the sampler is held
to its moments and to the code's parity checks; the metrics are held against
the JAX package on identical tensors."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from neural_ldpc_tpu.channel import AWGNChannel as JaxChannel
from neural_ldpc_tpu.channel import ChannelConfig as JaxChannelConfig
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.eval import count_errors as jax_count_errors
from neural_ldpc_tpu.eval import evaluate_ber_fer as jax_evaluate_ber_fer
from neural_ldpc_tpu.structs import Convention as JaxConvention
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.eval import count_errors, evaluate_ber_fer, hard_decision
from neural_ldpc_tpu_torch.structs import Convention, Puncture, Shortening


def test_llr_moments_and_sigma_match_jax():
    code = get_code("wman_n576_r34_z24")
    cfg = dict(snr_db=(1.0, 3.0))
    ch = AWGNChannel(code, ChannelConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(
        ch.sigma, JaxChannel(jax_get_code("wman_n576_r34_z24"), JaxChannelConfig(**cfg)).sigma)
    for i, sigma in enumerate(ch.sigma):
        llr, bits = ch.sample_at(ch.generator(i), 2000, i)
        assert llr.shape == (2000, code.N, code.Z) and not bits.any()
        x = llr.double()
        s2 = float(sigma) ** 2
        # 1.15M samples: mean within ~6 standard errors, variance within 2%
        assert abs(x.mean().item() - 2 / s2) < 6 * (4 / s2) ** 0.5 / x.numel() ** 0.5
        assert x.var().item() == pytest.approx(4 / s2, rel=0.02)


def test_generator_codewords_satisfy_parity_bg2():
    code = get_code("nr_bg2_set0_z16")
    ch = AWGNChannel(code, ChannelConfig(snr_db=(2.0,)), device="cpu")
    llr, bits = ch.sample_at(ch.generator(3), 64, 0, all_zero=False)
    H = TannerGraph.from_basegraph(code.basegraph, code.Z).lifted_parity_check_matrix()
    b = bits.numpy().astype(np.int64)
    assert 0.4 < b.mean() < 0.6
    assert not ((b @ H.T.astype(np.int64)) % 2).any()
    # BPSK bit0 -> +1: the LLR sign follows the codeword (channel BER ~0.21
    # at 2 dB for this rate-0.19 code)
    assert ((llr.reshape(64, -1) < 0).float() == bits).float().mean() > 0.75


def test_mixed_snr_quantize_puncture_shorten():
    code = get_code("wman_n576_r34_z24")
    cfg = ChannelConfig(snr_db=(0.0, 6.0), qms_qbit=5, puncture=Puncture(1, 24),
                        shortening=Shortening(25, 30))
    ch = AWGNChannel(code, cfg, device="cpu")
    jch = JaxChannel(jax_get_code("wman_n576_r34_z24"), JaxChannelConfig(
        snr_db=(0.0, 6.0), qms_qbit=5, puncture=Puncture(1, 24), shortening=Shortening(25, 30)))
    assert ch.rate == jch.rate
    llr, _ = ch.sample_mixed(ch.generator(0), 10)
    flat = llr.reshape(10, -1).numpy()
    assert (flat[:, :24] == 0).all()
    assert (flat[:, 24:30] == 20.0).all()
    # QMS grid: multiples of 0.5 within +-7.5 outside the pinned bits
    rest = flat[:, 30:]
    assert (rest * 2 == np.round(rest * 2)).all() and np.abs(rest).max() <= 7.5
    # word i at snr_db[i % 2]: the 6 dB words are cleaner
    assert (flat[1::2, 30:] < 0).mean() < (flat[0::2, 30:] < 0).mean()
    with pytest.raises(ValueError, match="generator"):
        ch.encode(torch.zeros(1, code.n_info_bits))
    # the REFERENCE convention: the reference's rate (K / (N - len(p) - len(s))
    # in base columns; the 24 punctured bits would make it negative), shortened
    # bits at -clip
    ref = AWGNChannel(code, dataclasses.replace(
        cfg, convention=Convention.REFERENCE, puncture=Puncture(0, 0)), device="cpu")
    jref = JaxChannel(jax_get_code("wman_n576_r34_z24"), JaxChannelConfig(
        convention=JaxConvention.REFERENCE, snr_db=(0.0, 6.0), qms_qbit=5,
        shortening=Shortening(25, 30)))
    assert ref.rate == jref.rate and ref.rate != ch.rate
    np.testing.assert_array_equal(ref.sigma, jref.sigma)
    llr, _ = ref.sample_mixed(ref.generator(0), 10)
    assert (llr.reshape(10, -1)[:, 24:30] == -20.0).all()


def test_count_errors_matches_jax():
    rng = np.random.default_rng(0)
    expected = (rng.random((7, 40)) < 0.5).astype(np.float32)
    outputs = rng.normal(size=(3, 7, 40)).astype(np.float32)
    outputs[:, 2] = np.where(expected[2] > 0, -1.0, 1.0)  # one error-free word
    for conv, emu in [(Convention.STANDARD, False), (Convention.REFERENCE, False),
                      (Convention.REFERENCE, True)]:
        ours = count_errors(torch.tensor(expected), torch.tensor(outputs), conv, emu)
        jconv = JaxConvention(conv.value)
        theirs = jax_count_errors(jnp.asarray(expected), jnp.asarray(outputs), jconv, emu)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert evaluate_ber_fer(expected, outputs[0], conv, emu) == jax_evaluate_ber_fer(
            expected, outputs[0], jconv, emu)
    np.testing.assert_array_equal(hard_decision(torch.tensor([-1.0, 0.0, 2.0])).numpy(), [1, 0, 0])
