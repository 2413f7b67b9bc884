"""The Monte-Carlo campaign of the port (``eval/montecarlo.py``) on the CPU,
where the fused engine runs the kernels' plain versions: early-exit and
overflow-redo counters equal the full unroll, the redone words are counted,
the auto-guard folds its probe words in, state saves and resumes exactly,
the early-exit steps emit their spans, and one step seeded as the JAX
campaign seeds it gives the JAX campaign's counters."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from neural_ldpc_tpu.channel import AWGNChannel as JaxChannel
from neural_ldpc_tpu.channel import ChannelConfig as JaxChannelConfig
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.eval.montecarlo import CampaignConfig as JaxCampaignConfig
from neural_ldpc_tpu.eval.montecarlo import MonteCarloCampaign as JaxCampaign
from neural_ldpc_tpu.utils.rng import split_async
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.codes.protograph import nr_bg1_like
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder
from neural_ldpc_tpu_torch.ops.cuda import fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c
from neural_ldpc_tpu_torch.parallel import Mesh
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
from neural_ldpc_tpu_torch.utils import CheckpointManager
from neural_ldpc_tpu_torch.utils.profiling import (CAMPAIGN_BATCH, CAMPAIGN_ESCALATION,
                                                   CAMPAIGN_FLUSH)
from test_torch_decoder import WMAN, build_pair

SNR = 3.0


def _wman(n_iter=4, code=None):
    code = code or get_code(WMAN)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, code.Z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType.MS,
                             sharing=NodeWeightSharingConfig(cn=3)), device="cpu")
    channel = AWGNChannel(code, ChannelConfig(snr_db=(SNR,)), device="cpu")
    return dec, dec.init_params(), channel


def _run(cfg, **kw):
    dec, params, channel = _wman(**kw)
    camp = MonteCarloCampaign(dec, params, channel, cfg)
    return camp, camp.run(verbose=False)[SNR]


BASE = dict(batch_size=64, max_words_per_snr=256, min_frame_errors=0, seed=11,
            engine="fused", early_exit_auto_guard=False)


@pytest.mark.parametrize("sampling", ["off", "on"])
def test_early_exit_counters_equal_the_full_unroll(sampling):
    """As the JAX suite pins its own campaign (tests/test_fused_kernel.py:226-272
    and :666-701): accepted words keep their phase-1 decisions, failures are
    re-decoded with the full unroll, and an overflowing window is redone."""
    kw = dict(BASE, kernel_channel_sampling=sampling)
    full, r_full = _run(CampaignConfig(**kw))
    assert full.kernel_sampling == (sampling == "on")
    assert r_full["words"] == 256 and r_full["final_iter_only"]
    assert 0 < r_full["fer"][-1] < 1
    ee, r_ee = _run(CampaignConfig(early_exit_iters=2, **kw))
    assert ee.ee and r_ee == r_full
    # capacity 1: every window overflows and is redone with the full unroll
    _, r_of = _run(CampaignConfig(early_exit_iters=2, early_exit_capacity=1, **kw))
    assert r_of == r_full


def test_early_exit_on_random_codewords_equals_the_full_unroll():
    """Not all-zero: the APP + count composition with the syndrome phase 1."""
    code = get_code(WMAN).with_derived_generator()
    kw = dict(BASE, all_zero=False)
    _, r_full = _run(CampaignConfig(**kw), code=code)
    _, r_ee = _run(CampaignConfig(early_exit_iters=2, **kw), code=code)
    _, r_of = _run(CampaignConfig(early_exit_iters=2, early_exit_capacity=1, **kw), code=code)
    assert r_ee == r_full == r_of and r_full["fer"][-1] > 0


def test_auto_guard_folds_the_probe_words_in():
    camp, r = _run(CampaignConfig(engine="fused", early_exit_iters=2, batch_size=64,
                                  max_words_per_snr=10 * 64, min_frame_errors=0, seed=11,
                                  early_exit_probe_batches=1, kernel_channel_sampling="auto"))
    assert 0 in camp._ee_choice and camp.kernel_sampling
    # 2 variants x (1 warm + 1 timed) probe batches, topped up to the budget
    assert r["words"] == 10 * 64
    _, r_full = _run(CampaignConfig(**dict(BASE, max_words_per_snr=10 * 64,
                                           kernel_channel_sampling="on")))
    assert r == r_full  # the probe changes which step runs, not which words


def test_rebuild_with_the_same_seed_repeats_the_counters():
    kw = dict(BASE, kernel_channel_sampling="on", early_exit_iters=2)
    _, a = _run(CampaignConfig(**kw))
    _, b = _run(CampaignConfig(**kw))
    _, c = _run(CampaignConfig(**dict(kw, seed=12)))
    assert a == b and a != c


def test_save_and_restore_resume_exactly(tmp_path):
    kw = dict(BASE, kernel_channel_sampling="on", max_words_per_snr=10**9)
    dec, params, channel = _wman()
    whole = MonteCarloCampaign(dec, params, channel, CampaignConfig(**kw))
    whole.run_snr_point(0, batches=5)
    first = MonteCarloCampaign(dec, params, channel, CampaignConfig(**kw))
    first.run_snr_point(0, batches=2)
    ckpt = CheckpointManager(str(tmp_path))
    first.save_state(ckpt)
    second = MonteCarloCampaign(dec, params, channel, CampaignConfig(**dict(kw, seed=999)))
    second.restore_state(ckpt)
    assert second.words[0] == 128
    second.run_snr_point(0, batches=3)
    assert second.results() == whole.results()


@pytest.mark.parametrize("capacity,redone", [(1, 5 * 64), (None, 0)])
def test_redone_words_count_the_windows_redone(tmp_path, capacity, redone):
    """At 1 dB a capacity of 1 overflows every window (2 + 2 + 1 batches),
    and each is redone; the default capacity (the batch) never overflows.
    The counter saves and restores with the others, and a state saved
    without it restores to zeros."""
    dec, params, _ = _wman()
    channel = AWGNChannel(get_code(WMAN), ChannelConfig(snr_db=(1.0,)), device="cpu")
    cfg = CampaignConfig(**dict(BASE, kernel_channel_sampling="on", early_exit_iters=2,
                                early_exit_capacity=capacity, sync_every_batches=2))
    camp = MonteCarloCampaign(dec, params, channel, cfg)
    camp.run_snr_point(0, batches=5)
    assert camp.words.tolist() == [5 * 64] and camp.redone_words.tolist() == [redone]
    ckpt = CheckpointManager(str(tmp_path))
    camp.save_state(ckpt)
    back = MonteCarloCampaign(dec, params, channel, cfg)
    back.restore_state(ckpt)
    assert back.redone_words.tolist() == [redone]
    with np.load(tmp_path / "mc_campaign.npz") as data:
        np.savez(tmp_path / "older.npz",
                 **{k: data[k] for k in data.files if k != "extra/redone_words"})
    back.restore_state(ckpt, "older")
    assert back.redone_words.tolist() == [0] and back.words.tolist() == [5 * 64]


@pytest.mark.parametrize("variant", ["sampling", "read", "codewords"])
def test_early_exit_campaign_emits_its_spans(variant):
    """Each of the three early-exit steps: a batch span a dispatch, an
    escalation span inside each, a flush span a window read."""
    code = get_code(WMAN).with_derived_generator() if variant == "codewords" else None
    kw = dict(BASE, early_exit_iters=2, sync_every_batches=2,
              kernel_channel_sampling="on" if variant == "sampling" else "off",
              all_zero=variant != "codewords")
    dec, params, channel = _wman(code=code)
    camp = MonteCarloCampaign(dec, params, channel, CampaignConfig(**kw))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        camp.run_snr_point(0, batches=3)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name in (CAMPAIGN_BATCH, CAMPAIGN_ESCALATION, CAMPAIGN_FLUSH))
    assert [n for _, _, n in spans] == 2 * [CAMPAIGN_BATCH, CAMPAIGN_ESCALATION] + [
        CAMPAIGN_FLUSH, CAMPAIGN_BATCH, CAMPAIGN_ESCALATION, CAMPAIGN_FLUSH]
    batches = [(a, b) for a, b, n in spans if n == CAMPAIGN_BATCH]
    escalations = [(a, b) for a, b, n in spans if n == CAMPAIGN_ESCALATION]
    assert all(a0 <= a1 and b1 <= b0 for (a0, b0), (a1, b1) in zip(batches, escalations))


def test_run_stops_at_the_frame_error_target_and_checkpoints(tmp_path):
    dec, params, channel = _wman()
    camp = MonteCarloCampaign(dec, params, channel, CampaignConfig(
        batch_size=32, max_words_per_snr=10**6, min_frame_errors=5, seed=3, engine="fused",
        checkpoint_dir=str(tmp_path), checkpoint_every_batches=1))
    r = camp.run(verbose=False)[SNR]
    assert camp.frame_errors[0, -1] >= 5 and r["words"] == 32
    assert (tmp_path / "mc_campaign.npz").exists()


def test_plain_engine_counts_every_iteration():
    _, r = _run(CampaignConfig(batch_size=64, max_words_per_snr=128, min_frame_errors=0,
                               seed=11, engine="xla"))
    assert len(r["ber"]) == 4 and not r["final_iter_only"]
    _, r_fused = _run(CampaignConfig(batch_size=64, max_words_per_snr=128, min_frame_errors=0,
                                     seed=11, engine="fused"))
    # the same words through the kernel's plain version
    assert abs(r["ber"][-1] - r_fused["ber"][0]) < 1e-4


def test_fused_all_iterations_counts_every_iteration():
    """The per-iteration fused campaign (the K1d stream without its store)
    counts every iteration; its last iteration's counts equal the final-only
    campaign's on the same seeds, and every iteration's the plain engine's."""
    camp, r_all = _run(CampaignConfig(fused_all_iterations=True, **BASE))
    assert camp.fused and not camp.kernel_sampling
    assert len(r_all["ber"]) == 4 and not r_all["final_iter_only"]
    _, r_final = _run(CampaignConfig(**BASE))
    assert r_final["final_iter_only"] and r_all["words"] == r_final["words"] == 256
    assert (r_all["ber"][-1], r_all["fer"][-1]) == (r_final["ber"][0], r_final["fer"][0])
    assert r_all["fer"][-1] > 0
    _, r_xla = _run(CampaignConfig(**dict(BASE, engine="xla")))
    np.testing.assert_allclose(r_all["ber"], r_xla["ber"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(r_all["fer"], r_xla["fer"], rtol=0, atol=1e-4)


def test_cpu_campaign_never_launches_a_kernel():
    before = (fused_fwd_k1a.launches, fused_fwd_k1b.launches, fused_fwd_k1c.launches)
    _run(CampaignConfig(**dict(BASE, kernel_channel_sampling="on", early_exit_iters=2)))
    assert (fused_fwd_k1a.launches, fused_fwd_k1b.launches, fused_fwd_k1c.launches) == before


def test_engine_choice_and_unported_options():
    dec, params, channel = _wman()
    assert not MonteCarloCampaign(dec, params, channel, CampaignConfig()).fused  # auto on CPU
    # item 11 (data parallelism) is ported: a mesh the batch does not divide
    # raises JAX's error before any collective runs
    mesh = Mesh("data", None, 0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="batch_size 1024 not divisible by 3 mesh devices"):
        MonteCarloCampaign(dec, params, channel, CampaignConfig(), mesh=mesh)
    with pytest.raises(ValueError, match="final-iteration stats only"):
        MonteCarloCampaign(dec, params, channel, CampaignConfig(
            engine="fused", fused_all_iterations=True, early_exit_iters=2))
    with pytest.raises(ValueError, match="stats mode"):
        MonteCarloCampaign(dec, params, channel, CampaignConfig(
            engine="fused", fused_all_iterations=True, kernel_channel_sampling="on"))
    with pytest.raises(ValueError, match="requires the fused engine"):
        MonteCarloCampaign(dec, params, channel, CampaignConfig(early_exit_iters=2))
    with pytest.raises(ValueError, match=r"in \(0, n_iterations\)"):
        MonteCarloCampaign(dec, params, channel,
                           CampaignConfig(engine="fused", early_exit_iters=4))
    with pytest.raises(ValueError, match="stats mode"):
        MonteCarloCampaign(dec, params, channel, CampaignConfig(
            engine="fused", all_zero=False, kernel_channel_sampling="on"))
    # a code the on-chip kernel cannot hold takes the device-memory kernel (K3)
    big = nr_bg1_like(64)
    bdec = BoostedNeuralDecoder(TannerGraph.from_basegraph(big.basegraph, big.Z),
                                BoostedDecoderConfig(n_iterations=2), device="cpu")
    bch = AWGNChannel(big, ChannelConfig(snr_db=(SNR,)), device="cpu")
    bcamp = MonteCarloCampaign(bdec, bdec.init_params(), bch, CampaignConfig(engine="fused"))
    assert bcamp.fused and bcamp.decoders["full"].layout.hbm_store


def test_jax_seeded_step_equals_the_jax_campaign_step():
    """The port's sampled stats step, handed the int32 seed the JAX campaign
    derives from its key (montecarlo.py:344-347), gives the JAX campaign's
    counters for the same batch."""
    code, dec, jdec = build_pair(WMAN, "MS", dict(cn=3), 2)
    jchannel = JaxChannel(jax_get_code(WMAN), JaxChannelConfig(snr_db=(SNR,)))
    kw = dict(batch_size=32, min_frame_errors=0, seed=5, engine="fused",
              kernel_channel_sampling="on")
    jcamp = JaxCampaign(jdec, jdec.init_params(), jchannel, JaxCampaignConfig(**kw))
    assert jcamp.kernel_sampling
    channel = AWGNChannel(code, ChannelConfig(snr_db=(SNR,)), device="cpu")
    camp = MonteCarloCampaign(dec, dec.init_params(), channel, CampaignConfig(**kw))
    sigma = jnp.float32(jchannel.sigma[0])
    assert float(sigma) == float(channel.sigma[0])
    key = jcamp.key
    for _ in range(2):
        key, sub = split_async(key)
        jc = jcamp._exact_step(sub, sigma)
        kseed = int(jax.random.bits(sub, dtype=jnp.uint32).astype(jnp.int32))
        ours = camp._exact_step(kseed, 0, float(sigma)).numpy()
        np.testing.assert_array_equal(ours[0], np.asarray(jc.bit_errors))
        np.testing.assert_array_equal(ours[1], np.asarray(jc.frame_errors))
    assert ours.dtype == np.int64 and ours[1, 0] > 0
