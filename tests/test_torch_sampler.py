"""The in-kernel AWGN sampler of the fused decode (K1c) on the CPU, where the
wrapper runs its plain version: its integer stream against a numpy uint32
statement of the JAX kernel's hash, its LLRs against the JAX Pallas
``_fwd_kernel`` in interpret mode (within 1e-4: the transcendental functions
of the two packages differ by a few ulps, the 24-bit uniforms not at all),
its stats against the JAX stats kernel on the same LLRs (exact), and its
index mode against its tile mode."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.ops.pallas.fused_train import FusedTrainDecoder as JaxTrain
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, FusedTrainDecoder
from neural_ldpc_tpu_torch.ops.cuda.fused_train import unit_uniforms
from test_torch_decoder import BG2, WMAN

SEED, I = -123456, 2
INDICES = [3, 9, 15, 33]


def _np_unit_uniform(idx, draw, key):
    """``fused_train.py:912-925`` in numpy uint32 arithmetic."""
    def mix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x7FEB352D)
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x846CA68B)
        return h ^ (h >> np.uint32(16))

    h = mix((idx * np.uint32(2) + np.uint32(draw)) ^ key)
    h = mix(h ^ (key * np.uint32(0x9E3779B9)))
    return (h >> np.uint32(8)).astype(np.int32).astype(np.float32) * np.float32(1.0 / 16777216.0)


def test_uniforms_equal_the_jax_hash_bit_for_bit():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    key = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    for draw in (0, 1):
        ours = unit_uniforms(torch.tensor(idx.astype(np.int64)), draw,
                             torch.tensor(key.astype(np.int64))).numpy()
        np.testing.assert_array_equal(ours, _np_unit_uniform(idx, draw, key))
        assert ours.min() >= 0.0 and ours.max() < 1.0


def _graphs(code_name, Z):
    code, jcode = get_code(code_name), jax_get_code(code_name)
    return (TannerGraph.from_basegraph(code.basegraph, Z),
            JaxTannerGraph.from_basegraph(jcode.basegraph, Z))


# (code, Z, batch, bt, sigma): five stream tiles each; BG2 at Z = 16 and at
# the odd Z = 15, which has pad rows in the padded layout (Zp = 16); sigma
# puts words on both sides of the syndrome
CASES = [(WMAN, 24, 40, 8, 0.5), (BG2, 16, 40, 8, 0.65), (BG2, 15, 40, 8, 0.65)]
IDS = ["wman-z24-5tiles", "bg2-z16", "bg2-z15-pad-rows"]


@functools.lru_cache(maxsize=None)
def _run(code_name, Z, batch, bt, sigma):
    """The port's and the JAX kernel's sampled stats and LLRs, stats of the
    port's LLRs through the JAX stats kernel, and both index modes."""
    g, jg = _graphs(code_name, Z)
    cw = np.ones((I, g.E), np.float32)
    kw = dict(has_cn_w=True, emit_stats=True, sample_channel=True, store_msgs=False)
    ours = FusedTrainDecoder(g, I, emit_chan=True, bt=bt, device="cpu", **kw)
    (ok, be, fe), llr = ours.apply_sampled(torch.tensor(cw), None, None, SEED, sigma, batch)
    jk = dict(kw, store_msgs=False, stream_outputs=False, interpret=True)
    theirs = JaxTrain(jg, I, emit_chan=True, bt=bt, **jk)
    (jok, jbe, jfe), jllr = theirs.apply_sampled(jnp.asarray(cw), None, None, jnp.int32(SEED),
                                                 jnp.float32(sigma), batch)
    jstats = JaxTrain(jg, I, has_cn_w=True, emit_stats=True, store_msgs=False,
                      stream_outputs=False, interpret=True, bt=bt)
    on_ours = jstats.apply(jnp.asarray(cw), None, None, jnp.asarray(llr.numpy()))
    widx = np.asarray(INDICES, np.int32)
    at = FusedTrainDecoder(g, I, sample_at_idx=bt, device="cpu", **kw).apply_sampled_at(
        torch.tensor(cw), None, None, SEED, sigma, torch.tensor(widx))
    jat = JaxTrain(jg, I, sample_at_idx=bt, bt=bt, **jk).apply_sampled_at(
        jnp.asarray(cw), None, None, jnp.int32(SEED), jnp.float32(sigma), jnp.asarray(widx))
    to_np = lambda t: tuple(np.asarray(v) for v in t)  # noqa: E731
    return dict(ours=to_np((ok, be, fe)), llr=llr.numpy(), theirs=to_np((jok, jbe, jfe)),
                jllr=np.asarray(jllr), on_ours=to_np(on_ours), at=to_np(at), jat=to_np(jat))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sampled_llr_matches_jax_interpret(case):
    r = _run(*case)
    assert r["llr"].shape == r["jllr"].shape == (case[2], get_code(case[0]).N, case[1])
    np.testing.assert_allclose(r["llr"], r["jllr"], rtol=0, atol=1e-4)
    # the same words decode to the same stats in both packages
    for a, b in zip(r["ours"], r["theirs"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_jax_stats_of_the_ports_llr_equal_the_ports_sampled_stats(case):
    r = _run(*case)
    for a, b in zip(r["ours"], r["on_ours"]):
        np.testing.assert_array_equal(a, b)
    assert 0 < int(r["ours"][0].sum()) < case[2]  # both populations present


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_stats_sampled_at_reproduce_phase_one(case):
    r = _run(*case)
    for a, at, jat in zip(r["ours"], r["at"], r["jat"]):
        np.testing.assert_array_equal(at, a[INDICES])
        np.testing.assert_array_equal(at, jat)


def _wman_sampler(bt=8, **kw):
    g, _ = _graphs(WMAN, 24)
    cw = np.ones((5, g.E), np.float32)
    return FusedMinsumDecoder(g, 5, cn_weights=cw, emit_stats=True, sample_channel=True,
                              bt=bt, device="cpu", **kw)


def test_sampler_moments_determinism_and_seed_sensitivity():
    """As the JAX suite checks its own sampler (tests/test_fused_kernel.py:646-655)."""
    f = _wman_sampler(emit_chan=True)
    sigma = 0.5
    (ok, be, fe), llr = f.sample_stats(1234, sigma, 64)
    llr = llr.numpy().astype(np.float64)
    assert abs(llr.mean() - 2 / sigma**2) < 0.1  # E[llr] = 2/sigma^2
    assert abs(llr.std() - 2 / sigma) < 0.05  # std = 2/sigma
    n = (llr * sigma**2 / 2 - 1) / sigma  # implied noise
    assert abs(float(((n - n.mean()) ** 4).mean() / n.std() ** 4) - 3) < 0.15
    _, llr2 = f.sample_stats(1234, sigma, 64)
    assert np.array_equal(llr, llr2.numpy())  # deterministic
    _, llr3 = f.sample_stats(99, sigma, 64)
    assert not np.array_equal(llr, llr3.numpy())  # seed-sensitive
    # a word's noise depends on its index, not on the batch it rides in
    _, llr4 = f.sample_stats(1234, sigma, 24)
    np.testing.assert_array_equal(llr[:24], llr4.numpy())


def test_stream_tile_fixes_the_words():
    """Word w's noise comes from tile w // bt, column w % bt: another bt is
    another stream, and the index mode needs the phase-1 bt."""
    (_, be8, _), llr8 = _wman_sampler(bt=8, emit_chan=True).sample_stats(7, 0.6, 16)
    (_, _, _), llr16 = _wman_sampler(bt=16, emit_chan=True).sample_stats(7, 0.6, 16)
    assert not np.array_equal(llr8.numpy(), llr16.numpy())
    widx = torch.tensor([15, 0, 8], dtype=torch.int32)
    _, be_at, _ = _wman_sampler(bt=128, sample_at_idx=8).stats_sampled_at(7, 0.6, widx)
    np.testing.assert_array_equal(be_at.numpy(), be8.numpy()[[15, 0, 8]])
    assert _wman_sampler().bt == 8
    g, _ = _graphs(WMAN, 24)
    assert FusedMinsumDecoder(g, 2, device="cpu").bt == 128  # E*Zp = 2112 <= 2500
    g2, _ = _graphs(BG2, 16)
    assert FusedMinsumDecoder(g2, 2, device="cpu").bt == 256  # E*Zp = 3152
