"""The CUDA kernels (the forward's K1a, K1b, K1c and K1d modes, the
backward K2, the device-memory K3 and K4 (cluster kernels and the
device-memory ones), the legacy engine K5, the matmul
routing K6 and the instruction-rate probe K7), the campaign and the fused
train step on the card, held against their plain PyTorch versions.

These tests need an NVIDIA GPU and skip elsewhere.  They import no JAX, so
they also run where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import os

import numpy as np
import pytest
import torch

from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.codes.protograph import dense_protograph, nr_bg1_like
from neural_ldpc_tpu_torch.models import (
    BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz, params_from_numpy)
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, FusedTrainDecoder, fused_bwd_k2, fused_bwd_plain, fused_fwd_block_plain,
    fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c, fused_fwd_k1d, fused_fwd_plain,
    fused_fwd_train_plain, sample_channel_plain, stats_plain)
from neural_ldpc_tpu_torch.ops.cuda import fused_train as fused_train_mod
from neural_ldpc_tpu_torch.ops.cuda import legacy as legacy_mod
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedTrainDecoder as _Train, fused_bwd_k6, fused_fwd_k6, fused_legacy_k5, legacy_plain,
    measure_sol, sol_k7, sol_plain)
from neural_ldpc_tpu_torch.ops.cuda.sol import sol_input
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig

pytestmark = pytest.mark.gpu
TRAINED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "trained")
BG1_Z16 = "nr_bg1_like_z16"  # check degrees up to 19: the kernel's MAXD = 32 instantiation


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _decoder(code_name, decoder_type, sharing, n_iter, device, weights=None, seed=0):
    code = nr_bg1_like(16) if code_name == BG1_Z16 else get_code(code_name)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, code.Z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)), device=device)
    if weights:
        params = load_params_npz(os.path.join(TRAINED, weights), device)
    else:
        rng = np.random.default_rng(seed)
        params = params_from_numpy({
            k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
            for k, v in dec.init_params().items()}, device)
    return code, dec, params


def _fused(*args, **kw):
    code, dec, params = _decoder(*args, **kw)
    return code, FusedMinsumDecoder.from_decoder(dec, params)


CASES = [
    ("wman_n576_r34_z24", "MS", dict(cn=3), 5, None, 2e-5),
    ("wman_n576_r34_z24", "MS", dict(cn=2, ucn=2, vn=3), 4, None, 2e-5),
    ("wman_n576_r34_z24", "SP", dict(cn=1, vn=2), 5, None, 5e-3),
    ("nr_bg2_set0_z16", "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 0.0),
    ("nr_bg2_set0_z16", "QMS", dict(cn=3, ucn=2, vn=3), 20, "bg2_qms20_base_ucn.npz", 0.0),
    ("nr_bg2_set0_z16", "MS", dict(cn=6, vn=6), 5, None, 2e-5),
    (BG1_Z16, "MS", dict(cn=3, vn=3), 5, None, 2e-5),
    (BG1_Z16, "QMS", dict(cn=3, ucn=2, vn=3), 10, None, 0.0),
]


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,weights,atol", CASES)
def test_kernel_matches_plain(cuda, code_name, decoder_type, sharing, n_iter, weights, atol):
    code, fused = _fused(code_name, decoder_type, sharing, n_iter, cuda, weights)
    rng = np.random.default_rng(1)
    batch = 257  # ragged for every words-per-block choice above 1
    x = rng.normal(size=(batch, code.N * code.Z)) * 2.5 + 1.0
    if decoder_type == "QMS":
        x = np.round(x * 2) / 2
    chan = torch.tensor(x.astype(np.float32), device=cuda)
    before = fused_fwd_k1a.launches
    out = fused(chan)
    torch.cuda.synchronize()
    assert fused_fwd_k1a.launches == before + 1
    lay = fused.layout
    ref = fused_fwd_plain(chan, lay, *fused._w).clamp(lay.clip_lo, lay.clip_hi)
    assert out.shape == (batch, code.n_bits) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= atol
    assert torch.equal(out < 0, ref < 0)


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,weights,atol", CASES)
def test_forward_block_kernel_in_every_mode(cuda, code_name, decoder_type, sharing, n_iter,
                                            weights, atol):
    """The forward kernel's block layout (``k1_plan``) on a batch its words
    per block do not divide, in every mode, against ``fused_fwd_plain`` and
    against ``fused_fwd_block_plain`` on the same inputs (QMS exactly, stats
    exactly): final APP, stats, syndrome, stream + store, and sampling with
    the channel exported and in index mode; the card holds its block."""
    code, fused = _fused(code_name, decoder_type, sharing, n_iter, cuda, weights)
    lay, w = fused.layout, fused._w
    occ = fused_train_mod.k1_occupancy(lay, cuda)
    assert occ["blocks_per_sm"] >= 1 and occ["words_per_block"] == lay.k1.W
    batch = 64 * lay.k1.W + 1
    rng = np.random.default_rng(4)
    x = rng.normal(size=(batch, code.N * code.Z)) * 2.5 + 1.5
    if decoder_type == "QMS":
        x = np.round(x * 2) / 2
    chan = torch.tensor(x.astype(np.float32), device=cuda)
    app = fused_fwd_k1a(chan, lay, *w)
    st = fused_fwd_k1b(chan, lay, *w)
    app_s, st_s = fused_fwd_k1b(chan, lay, *w, emit_app=True)
    outs, store = fused_fwd_k1d(chan, lay, *w)
    sampled, sampled_chan = fused_fwd_k1c(lay, *w, 11, 0.7, batch=batch, emit_chan=True)
    widx = torch.tensor([0, 5, batch - 2, batch - 1], dtype=torch.int32, device=cuda)
    at = fused_fwd_k1c(lay, *w, 11, 0.7, widx=widx, stream_bt=128)
    torch.cuda.synchronize()
    ref = fused_fwd_plain(chan, lay, *w)
    blk, _, blk_st = fused_fwd_block_plain(chan, lay, *w, mode="syndrome")
    ref_outs, ref_store = fused_fwd_train_plain(chan, lay, *w)
    for got, want in ((app, ref), (app, blk), (app_s, ref), (outs, ref_outs),
                      (store, ref_store)):
        assert (got - want).abs().max().item() <= atol
    assert torch.equal(outs[-1], app) and torch.equal(app_s, app)
    assert torch.equal(st, stats_plain(app, lay)) and torch.equal(st_s, st)
    if decoder_type == "QMS":
        assert torch.equal(app, ref) and torch.equal(st, blk_st)
        assert torch.equal(outs, ref_outs) and torch.equal(store, ref_store)
    assert torch.equal(sampled, stats_plain(fused_fwd_plain(sampled_chan, lay, *w), lay))
    at_all = fused_fwd_k1c(lay, *w, 11, 0.7, batch=batch, stream_bt=128)
    assert torch.equal(at, at_all[widx.long()])


@pytest.mark.parametrize("Z,decoder_type,sharing", [
    (22, "MS", dict(cn=3, vn=2)), (13, "QMS", dict(cn=3, ucn=2, vn=3))])
def test_forward_block_kernel_on_lifts_not_a_multiple_of_4(cuda, Z, decoder_type, sharing):
    """The forward kernel's one-lift-at-a-time VN phase (Z % 4 != 0: the
    BG1-like base graph at Z = 22, the largest lift the on-chip family
    takes, and at Z = 13) against ``fused_fwd_plain`` on a ragged batch:
    final APP, stats, stream + store and sampling."""
    code = nr_bg1_like(Z)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, Z),
        BoostedDecoderConfig(n_iterations=4, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)), device=cuda)
    rng = np.random.default_rng(Z)
    params = params_from_numpy({
        k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
        for k, v in dec.init_params().items()}, cuda)
    fused = FusedMinsumDecoder.from_decoder(dec, params)
    lay, w = fused.layout, fused._w
    assert not lay.hbm_store and lay.Z % 4
    batch = 16 * lay.k1.W + 1
    x = rng.normal(size=(batch, lay.N * Z)) * 2.5 + 1.5
    if decoder_type == "QMS":
        x = np.round(x * 2) / 2
    chan = torch.tensor(x.astype(np.float32), device=cuda)
    app = fused_fwd_k1a(chan, lay, *w)
    st = fused_fwd_k1b(chan, lay, *w)
    outs, store = fused_fwd_k1d(chan, lay, *w)
    sampled, sampled_chan = fused_fwd_k1c(lay, *w, 5, 0.8, batch=batch, emit_chan=True)
    torch.cuda.synchronize()
    ref = fused_fwd_plain(chan, lay, *w)
    ref_outs, ref_store = fused_fwd_train_plain(chan, lay, *w)
    atol = 0.0 if decoder_type == "QMS" else 2e-5
    assert (app - ref).abs().max().item() <= atol and torch.equal(app < 0, ref < 0)
    assert torch.equal(st, stats_plain(app, lay)) and torch.equal(outs[-1], app)
    assert (outs - ref_outs).abs().max().item() <= atol
    assert (store - ref_store).abs().max().item() <= atol
    assert torch.equal(sampled, stats_plain(fused_fwd_plain(sampled_chan, lay, *w), lay))


def test_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch):
    code, fused = _fused("wman_n576_r34_z24", "MS", dict(cn=3), 3, cuda)

    def forbidden(*args, **kwargs):
        raise AssertionError("plain path taken for a CUDA tensor")

    monkeypatch.setattr(fused_train_mod, "fused_fwd_plain", forbidden)
    out = fused(torch.zeros(5, code.n_bits, device=cuda))
    torch.cuda.synchronize()
    assert out.is_cuda and torch.isfinite(out).all()


def test_cpu_decoder_refuses_cuda_tensors(cuda, monkeypatch):
    code, fused = _fused("wman_n576_r34_z24", "MS", dict(cn=3), 3, "cpu")
    assert fused.device.type == "cpu"

    def forbidden(*args, **kwargs):
        raise AssertionError("a CUDA batch was decoded by a CPU-built decoder")

    monkeypatch.setattr(fused_train_mod, "fused_fwd_plain", forbidden)
    chan = torch.zeros(5, code.n_bits, device=cuda)
    with pytest.raises(ValueError, match="lies on cuda"):
        fused(chan)
    with pytest.raises(ValueError, match="lies on cuda"):
        fused._delegate.apply(None, None, None, chan)


def test_cuda_decoder_refuses_cpu_tensors(cuda):
    code, fused = _fused("wman_n576_r34_z24", "MS", dict(cn=3), 3, "cuda")
    assert fused.device == cuda  # "cuda" resolves to the current card
    with pytest.raises(ValueError, match="lies on cpu"):
        fused(torch.zeros(5, code.n_bits))


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,weights,atol", CASES)
def test_stats_and_syndrome_kernels_match_plain(cuda, code_name, decoder_type, sharing, n_iter,
                                                weights, atol):
    code, fused = _fused(code_name, decoder_type, sharing, n_iter, cuda, weights)
    rng = np.random.default_rng(2)
    batch = 257
    x = rng.normal(size=(batch, code.N * code.Z)) * 2.5 + 3.0
    if decoder_type == "QMS":
        x = np.round(x * 2) / 2
    chan = torch.tensor(x.astype(np.float32), device=cuda)
    lay = fused.layout
    before = fused_fwd_k1b.launches
    st = fused_fwd_k1b(chan, lay, *fused._w)
    app, st2 = fused_fwd_k1b(chan, lay, *fused._w, emit_app=True)
    torch.cuda.synchronize()
    assert fused_fwd_k1b.launches == before + 2
    ref_app = fused_fwd_plain(chan, lay, *fused._w)
    ref = stats_plain(ref_app, lay)
    assert torch.equal(st, ref) and torch.equal(st2, ref)
    assert (app - ref_app).abs().max().item() <= atol


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,weights", [
    ("wman_n576_r34_z24", "MS", dict(cn=3), 10, None),
    ("nr_bg2_set0_z16", "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz"),
    (BG1_Z16, "QMS", dict(cn=3, ucn=2, vn=3), 10, None),
])
def test_sampler_kernel_matches_plain(cuda, code_name, decoder_type, sharing, n_iter, weights):
    code, fused = _fused(code_name, decoder_type, sharing, n_iter, cuda, weights)
    lay, batch, sigma = fused.layout, 3 * 1024 + 5, 0.7
    before = fused_fwd_k1c.launches, fused_fwd_k1b.launches
    st, chan = fused_fwd_k1c(lay, *fused._w, -987654, sigma, batch=batch, emit_chan=True)
    ref = sample_channel_plain(lay, -987654, sigma, torch.arange(batch, device=cuda))
    torch.cuda.synchronize()
    # each wrapper counts only the launches it makes
    assert (fused_fwd_k1c.launches, fused_fwd_k1b.launches) == (before[0] + 1, before[1])
    assert ((chan - ref).abs() <= 1e-5 * (1 + ref.abs())).all()
    assert torch.equal(st, fused_fwd_k1b(chan, lay, *fused._w))
    widx = torch.tensor([0, 5, 127, 128, 2049, batch - 1], dtype=torch.int32, device=cuda)
    at = fused_fwd_k1c(lay, *fused._w, -987654, sigma, widx=widx)
    assert torch.equal(at, st[widx.long()])


def test_campaign_early_exit_equals_full_unroll_on_the_card(cuda):
    code, dec, params = _decoder("wman_n576_r34_z24", "MS", dict(cn=3), 10, cuda)
    channel = AWGNChannel(code, ChannelConfig(snr_db=(4.0,)), device=cuda)
    for sampling in ("on", "off"):
        kw = dict(batch_size=4096, max_words_per_snr=4 * 4096, min_frame_errors=0, seed=3,
                  engine="auto", early_exit_auto_guard=False, kernel_channel_sampling=sampling,
                  sync_every_batches=4)
        runs = []
        for extra in ({}, dict(early_exit_iters=2), dict(early_exit_iters=2,
                                                          early_exit_capacity=1)):
            camp = MonteCarloCampaign(dec, params, channel, CampaignConfig(**kw, **extra))
            assert camp.fused and camp.kernel_sampling == (sampling == "on")
            runs.append(camp.run(verbose=False)[4.0])
        assert runs[0]["fer"][0] > 0
        assert runs[0] == runs[1] == runs[2]


def _train_inputs(code, fused, decoder_type, cuda, batch=257):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(batch, code.N * code.Z)) * 2.5 + 1.0
    if decoder_type == "QMS":
        x = np.round(x * 2) / 2
    chan = torch.tensor(x.astype(np.float32), device=cuda)
    lay = fused.layout
    g = torch.randn(lay.n_iterations, batch, lay.N * lay.Z, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    return chan, lay, g


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,weights,atol", CASES)
def test_training_kernels_match_plain(cuda, code_name, decoder_type, sharing, n_iter, weights,
                                      atol):
    """K1d: outputs and store as the plain version (QMS exact), the last
    output K1a's APP exactly.  K2 on a random cotangent: the channel
    gradients within atol 1e-6 / rtol 1e-4, the weight gradients within
    1e-4 of max |g| (their sums over words run in another order)."""
    code, fused = _fused(code_name, decoder_type, sharing, n_iter, cuda, weights)
    chan, lay, g = _train_inputs(code, fused, decoder_type, cuda)
    before = (fused_fwd_k1d.launches, fused_bwd_k2.launches)
    outs, store = fused_fwd_k1d(chan, lay, *fused._w)
    grads = fused_bwd_k2(chan, lay, *fused._w, store, outs, g)
    torch.cuda.synchronize()
    assert (fused_fwd_k1d.launches, fused_bwd_k2.launches) == (before[0] + 1, before[1] + 1)
    ref_outs, ref_store = fused_fwd_train_plain(chan, lay, *fused._w)
    assert (outs - ref_outs).abs().max().item() <= atol
    assert (store - ref_store).abs().max().item() <= atol
    assert torch.equal(outs[-1], fused_fwd_k1a(chan, lay, *fused._w))
    ref = fused_bwd_plain(chan, lay, *fused._w, ref_store, ref_outs, g)
    for i, (a, b) in enumerate(zip(grads, ref)):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if i >= 3:  # per-word channel gradients
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)
        else:
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_training_path_never_takes_the_plain_versions(cuda, monkeypatch):
    code, dec, params = _decoder("nr_bg2_set0_z16", "QMS", dict(cn=3, ucn=2, vn=3), 4, cuda)

    def forbidden(*args, **kwargs):
        raise AssertionError("plain path taken for a CUDA tensor")

    monkeypatch.setattr(fused_train_mod, "fused_fwd_train_plain", forbidden)
    monkeypatch.setattr(fused_train_mod, "fused_bwd_plain", forbidden)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    chan = torch.randn(9, code.n_bits, device=cuda, requires_grad=True)
    outs = FusedTrainDecoder.from_decoder(dec).apply(*dec._expanded_weights(p), chan)
    outs.sum().backward()
    torch.cuda.synchronize()
    assert all(torch.isfinite(v.grad).all() for v in p.values()) and chan.grad.is_cuda


def test_fused_train_step_matches_the_plain_step_on_the_card(cuda):
    """One step of the bg2_qms_train preset's decoder (BG2 QMS x20, CN and
    VN weights, random codewords, batch 20) on each engine: loss within
    1e-6; params within 1e-6 where the plain engine's |g| > 1e-5 and within
    2 lr elsewhere."""
    from neural_ldpc_tpu_torch.training import TrainConfig, make_train_step, multi_iteration_loss
    from neural_ldpc_tpu_torch.utils.config import get_preset

    cfg = get_preset("bg2_qms_train")
    code, graph = cfg.build_graph()
    channel = cfg.build_channel(code, device=cuda)
    dec = BoostedNeuralDecoder(graph, cfg.build_decoder_config(), device=cuda)
    rng = np.random.default_rng(4)
    params = params_from_numpy({k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape)))
                                .astype(np.float32) for k, v in dec.init_params().items()}, cuda)
    llr, bits = channel.sample_mixed(channel.generator(5), 20, all_zero=False)
    lr, res = 1e-3, {}
    for engine in ("xla", "fused"):
        init, step = make_train_step(dec, TrainConfig(engine=engine))
        res[engine] = step(params, init(params), llr, bits, lr)
    assert abs(res["xla"][2].item() - res["fused"][2].item()) < 1e-6
    pg = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = multi_iteration_loss(dec.apply(pg, llr), bits, coeff=list(range(20)))
    grads = dict(zip(pg, torch.autograd.grad(loss, list(pg.values()))))
    for k in params:
        diff = (res["xla"][0][k] - res["fused"][0][k]).abs()
        big = grads[k].abs() > 1e-5
        assert diff[big].max().item() <= 1e-6 and diff.max().item() <= 2 * lr, k


# ---------------------------------------------------------------------------
# The device-memory kernels K3 and K4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,weights,atol", CASES)
def test_device_memory_kernels_match_the_on_chip_ones(cuda, code_name, decoder_type, sharing,
                                                      n_iter, weights, atol):
    """K3 forced on a code the on-chip kernels take equals K1 in every mode
    bit for bit (its store slots are K1d's store[1:]); K4's channel
    gradients equal K2's, its weight gradients within 1e-4 of max |g| (their
    sums over words run in another order); K4 is the cluster kernel, one
    CUDA launch a call."""
    from neural_ldpc_tpu_torch.ops.cuda import fused_bwd_k4, fused_fwd_k3

    code, dec, params = _decoder(code_name, decoder_type, sharing, n_iter, cuda, weights)
    vmem = FusedMinsumDecoder.from_decoder(dec, params, store_space="vmem")
    hbm = FusedMinsumDecoder.from_decoder(dec, params, store_space="hbm")
    assert hbm.layout.hbm_store and not vmem.layout.hbm_store
    chan, lay, g = _train_inputs(code, vmem, decoder_type, cuda)
    lh, w = hbm.layout, vmem._w
    before = (fused_fwd_k3.launches, fused_bwd_k4.launches, fused_bwd_k4.cuda_launches)
    app = hbm(chan)
    stats = fused_fwd_k3(chan, lh, *w, mode="stats")
    app_s, stats_s = fused_fwd_k3(chan, lh, *w, mode="syndrome")
    outs, store = fused_fwd_k3(chan, lh, *w, mode="stream")
    grads = fused_bwd_k4(chan, lh, *w, store, outs, g)
    torch.cuda.synchronize()
    # K4 is the cluster kernel here (a cluster of 1): one CUDA launch
    assert lh.k4_kernel == "cluster"
    assert (fused_fwd_k3.launches, fused_bwd_k4.launches, fused_bwd_k4.cuda_launches) == (
        before[0] + 4, before[1] + 1, before[2] + 1)
    assert torch.equal(app, vmem(chan))
    assert torch.equal(stats, fused_fwd_k1b(chan, lay, *w)) and torch.equal(stats_s, stats)
    assert torch.equal(app_s, fused_fwd_k1a(chan, lay, *w))
    outs1, store1 = fused_fwd_k1d(chan, lay, *w)
    assert torch.equal(outs, outs1) and torch.equal(store, store1[1:])
    ref = fused_bwd_k2(chan, lay, *w, store1, outs1, g)
    for i, (a, b) in enumerate(zip(grads, ref)):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if i >= 3:
            assert torch.equal(a, b)
        else:
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_big_code_decode_and_training_run_through_k3_and_k4(cuda, monkeypatch):
    """The BG1-like code at Z = 64 (above the on-chip limit), MS x5 with the
    cross-lift weights: the decode launches K3 once and equals its plain
    version; a fused training forward and backward launch K3 and K4 once
    each, take no plain version, and give the plain engine's gradients
    within atol 1e-6 / rtol 1e-4."""
    from neural_ldpc_tpu_torch.codes.protograph import nr_bg1_like
    from neural_ldpc_tpu_torch.ops.cuda import fused_bwd_k4, fused_fwd_dm_plain, fused_fwd_k3
    from neural_ldpc_tpu_torch.training import multi_iteration_loss

    code = nr_bg1_like(64)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, 64),
        BoostedDecoderConfig(n_iterations=5, decoder_type=DecoderType.MS,
                             sharing=NodeWeightSharingConfig(cn=3)), device=cuda)
    params = {k: v[:5] for k, v in
              load_params_npz(os.path.join(TRAINED, "bg1_ms10_z256_hi.npz"), cuda).items()}
    channel = AWGNChannel(code, ChannelConfig(snr_db=(2.0,)), device=cuda)
    llr, bits = channel.sample_at(channel.generator(3), 33, 0)
    fused = FusedMinsumDecoder.from_decoder(dec, params)
    assert fused.layout.hbm_store
    before = fused_fwd_k3.launches
    out = fused(llr)
    torch.cuda.synchronize()
    assert fused_fwd_k3.launches == before + 1
    ref = fused_fwd_dm_plain(llr.reshape(33, -1), fused.layout, *fused._w)[0]
    assert (out - ref.clamp(-20.0, 20.0)).abs().max().item() <= 2e-5

    grads = []
    for engine in ("plain", "fused"):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        x = llr.clone().requires_grad_(True)
        if engine == "fused":
            def forbidden(*args, **kwargs):
                raise AssertionError("plain path taken for a CUDA tensor")

            monkeypatch.setattr(fused_train_mod, "fused_fwd_dm_plain", forbidden)
            monkeypatch.setattr(fused_train_mod, "fused_fwd_cl_plain", forbidden)
            monkeypatch.setattr(fused_train_mod, "fused_bwd_dm_plain", forbidden)
            before = (fused_fwd_k3.launches, fused_bwd_k4.launches)
            o = FusedTrainDecoder.from_decoder(dec).apply(*dec._expanded_weights(p), x)
        else:
            o = dec.apply(p, x)
        loss = multi_iteration_loss(o, bits, coeff=list(range(5)))
        grads.append(torch.autograd.grad(loss, [*p.values(), x]))
    torch.cuda.synchronize()
    assert (fused_fwd_k3.launches, fused_bwd_k4.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-4)


# the cluster size by lift and decoder (UCN's second replica: QMS below)
_CLUSTER_C = {(23, "MS"): 1, (23, "QMS"): 1, (256, "MS"): 2, (256, "QMS"): 3, (384, "MS"): 4,
              (384, "QMS"): 5}


@pytest.mark.parametrize("Z", [23, 256, 384])
@pytest.mark.parametrize("decoder_type", ["MS", "QMS"])
def test_cluster_k3_equals_its_plain_version(cuda, Z, decoder_type):
    """The cluster K3 (``csrc/fused_fwd_cl.cu``) on the BG1-like code, one
    launch per call, equals its plain version under ``torch.equal`` in every
    mode (final APP, stats, syndrome, stream with and without the store);
    MS x5 cn=3 with the cross-lift weights, QMS x4 cn=3 ucn=2 vn=3 with
    random ones, 5 words.  K4 fed the new store meets K2's bars against its
    plain version: channel gradients atol 1e-6 / rtol 1e-4, weights within
    1e-4 of max |g|."""
    from neural_ldpc_tpu_torch.ops.cuda import (
        cluster_occupancy, fused_bwd_dm_plain, fused_bwd_k4, fused_fwd_cl_plain, fused_fwd_k3)

    code = nr_bg1_like(Z)
    qms = decoder_type == "QMS"
    sharing = dict(cn=3, ucn=2, vn=3) if qms else dict(cn=3)
    n_iter = 4 if qms else 5
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, Z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)), device=cuda)
    if qms:
        rng = np.random.default_rng(1)
        params = params_from_numpy({
            k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
            for k, v in dec.init_params().items()}, cuda)
    else:
        params = {k: v[:n_iter] for k, v in
                  load_params_npz(os.path.join(TRAINED, "bg1_ms10_z256_hi.npz"), cuda).items()}
    ft = FusedTrainDecoder.from_decoder(dec)
    lay, w = ft.layout, ft.pack_weights(*dec._expanded_weights(params))
    assert lay.k3_kernel == "cluster" and lay.cluster.C == _CLUSTER_C[Z, decoder_type]
    assert cluster_occupancy(lay, cuda)["clusters"] >= 1
    channel = AWGNChannel(code, ChannelConfig(snr_db=(2.0,), qms_qbit=5 if qms else None),
                          device=cuda)
    chan = channel.sample_at(channel.generator(Z), 5, 0)[0].reshape(5, -1)
    before = (fused_fwd_k3.launches, fused_fwd_k3.cuda_launches)
    app = fused_fwd_k3(chan, lay, *w)
    stats = fused_fwd_k3(chan, lay, *w, mode="stats")
    app_s, stats_s = fused_fwd_k3(chan, lay, *w, mode="syndrome")
    outs, store = fused_fwd_k3(chan, lay, *w, mode="stream")
    outs_n, none = fused_fwd_k3(chan, lay, *w, mode="stream", store=False)
    torch.cuda.synchronize()
    assert (fused_fwd_k3.launches, fused_fwd_k3.cuda_launches) == (before[0] + 5, before[1] + 5)
    assert torch.equal(app, fused_fwd_cl_plain(chan, lay, *w)[0])
    assert torch.equal(stats, fused_fwd_cl_plain(chan, lay, *w, mode="stats")[2])
    r_app, _, r_stats = fused_fwd_cl_plain(chan, lay, *w, mode="syndrome")
    assert torch.equal(app_s, r_app) and torch.equal(stats_s, r_stats)
    r_outs, r_store, _ = fused_fwd_cl_plain(chan, lay, *w, mode="stream", store=True)
    assert torch.equal(outs, r_outs) and torch.equal(store, r_store)
    assert none is None and torch.equal(outs_n, r_outs)
    g = torch.randn(outs.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(6))
    grads = fused_bwd_k4(chan, lay, *w, store, outs, g)
    ref = fused_bwd_dm_plain(chan, lay, *w, store, outs, g)
    for i, (a, b) in enumerate(zip(grads, ref)):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if i >= 3:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)
        else:
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


# the cluster K4 (csrc/fused_bwd_cl.cu): (Z, type, sharing, iterations, cluster
# size); Z = 23 runs one lift a thread (Z % 4 != 0)
K4_CLUSTER_CASES = [
    (23, "MS", dict(cn=3), 5, 1),
    (23, "QMS", dict(cn=3, ucn=2, vn=3), 4, 1),
    (64, "SP", dict(cn=1, vn=2), 3, 2),
    (256, "MS", dict(cn=3), 10, 6),
    (256, "QMS", dict(cn=3, ucn=2), 4, 7),
]


@pytest.mark.parametrize("Z,decoder_type,sharing,n_iter,C", K4_CLUSTER_CASES,
                         ids=[f"z{c[0]}-{c[1]}x{c[3]}" for c in K4_CLUSTER_CASES])
def test_cluster_k4_equals_its_twin_and_the_device_memory_kernel(cuda, Z, decoder_type, sharing,
                                                                 n_iter, C):
    """The cluster K4 on the BG1-like code, one CUDA launch a call, equals
    its plain twin ``fused_bwd_cl_plain`` and the device-memory K4 on the
    channel gradients under ``torch.equal``, on the weights within 1e-4 of
    max |g|, and itself on a second run bit for bit (no float atomics)."""
    import dataclasses

    from neural_ldpc_tpu_torch.ops.cuda import (
        bwd_cluster_occupancy, fused_bwd_cl_plain, fused_bwd_k4, fused_fwd_k3)

    code = nr_bg1_like(Z)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, Z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)), device=cuda)
    rng = np.random.default_rng(Z)
    params = params_from_numpy({
        k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
        for k, v in dec.init_params().items()}, cuda)
    ft = FusedTrainDecoder.from_decoder(dec)
    lay, w = ft.layout, ft.pack_weights(*dec._expanded_weights(params))
    assert lay.k4_kernel == "cluster" and lay.bwd_cluster.C == C
    assert bwd_cluster_occupancy(lay, cuda)["clusters"] >= 1
    channel = AWGNChannel(code, ChannelConfig(snr_db=(2.0,), qms_qbit=5 if decoder_type == "QMS"
                                              else None), device=cuda)
    chan = channel.sample_at(channel.generator(Z), 5, 0)[0].reshape(5, -1)
    outs, store = fused_fwd_k3(chan, lay, *w, mode="stream")
    g = torch.randn(outs.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(7))
    before = (fused_bwd_k4.launches, fused_bwd_k4.cuda_launches)
    grads = fused_bwd_k4(chan, lay, *w, store, outs, g)
    again = fused_bwd_k4(chan, lay, *w, store, outs, g)
    torch.cuda.synchronize()
    assert (fused_bwd_k4.launches, fused_bwd_k4.cuda_launches) == (before[0] + 2, before[1] + 2)
    dm = fused_bwd_k4(chan, dataclasses.replace(lay, bwd_cluster=None), *w, store, outs, g)
    twin = fused_bwd_cl_plain(chan, lay, *w, store, outs, g)
    for i, (a, b, c, t) in enumerate(zip(grads, again, dm, twin)):
        assert (a is None) == (c is None) == (t is None)
        if a is None:
            continue
        assert torch.equal(a, b)
        if i >= 3:
            assert torch.equal(a, t) and torch.equal(a, c)
        else:
            for ref in (t, c):
                assert (a - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_device_memory_k4_on_a_word_no_cluster_holds(cuda):
    """At Z = 384 no cluster of 8 CTAs holds a word's backward: K4 is
    ``csrc/fused_bwd_dm.cu`` (4 launches an iteration with CN weights) and
    meets K2's bars against its plain version."""
    from neural_ldpc_tpu_torch.ops.cuda import fused_bwd_dm_plain, fused_bwd_k4, fused_fwd_k3

    code = nr_bg1_like(384)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, 384),
        BoostedDecoderConfig(n_iterations=3, decoder_type=DecoderType.MS,
                             sharing=NodeWeightSharingConfig(cn=3)), device=cuda)
    params = {k: v[:3] for k, v in
              load_params_npz(os.path.join(TRAINED, "bg1_ms10_z256_hi.npz"), cuda).items()}
    ft = FusedTrainDecoder.from_decoder(dec)
    lay, w = ft.layout, ft.pack_weights(*dec._expanded_weights(params))
    assert lay.k4_kernel == "device-memory" and lay.k3_kernel == "cluster"
    channel = AWGNChannel(code, ChannelConfig(snr_db=(2.0,)), device=cuda)
    chan = channel.sample_at(channel.generator(8), 3, 0)[0].reshape(3, -1)
    outs, store = fused_fwd_k3(chan, lay, *w, mode="stream")
    g = torch.randn(outs.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(8))
    before = fused_bwd_k4.cuda_launches
    grads = fused_bwd_k4(chan, lay, *w, store, outs, g)
    torch.cuda.synchronize()
    assert fused_bwd_k4.cuda_launches == before + 4 * 3
    ref = fused_bwd_dm_plain(chan, lay, *w, store, outs, g)
    for i, (a, b) in enumerate(zip(grads, ref)):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if i >= 3:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)
        else:
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


_LEGACY_CASES = [(c, dt) for c in CASES for dt in (
    ("bf16", "f32", "int8") if c[1] == "QMS" else ("bf16", "f32"))]


@pytest.mark.parametrize("case,routing", _LEGACY_CASES,
                         ids=[f"{c[0][:4]}-{c[1]}-{'-'.join(map(str, c[2].values()))}-{dt}"
                              for c, dt in _LEGACY_CASES])
def test_legacy_kernel_matches_plain(cuda, case, routing):
    """K5 (the forward kernel with the legacy routing's hooks) against
    legacy_plain in bf16, f32 and int8 routing: MS and QMS bit for bit, SP
    within 5e-3 (the card's tanhf and logf), equal decisions; K1a's counter
    untouched."""
    code_name, decoder_type, sharing, n_iter, weights, atol = case
    code, dec, params = _decoder(code_name, decoder_type, sharing, n_iter, cuda, weights)
    fused = FusedMinsumDecoder.from_decoder(
        dec, params, engine="legacy", int8_routing=routing == "int8",
        routing_dtype=torch.float32 if routing == "f32" else torch.bfloat16)
    assert fused.layout.routing == f"legacy_{routing}"
    chan, lay, _ = _train_inputs(code, fused, decoder_type, cuda)
    before = (fused_legacy_k5.launches, fused_fwd_k1a.launches)
    out = fused(chan)
    torch.cuda.synchronize()
    assert (fused_legacy_k5.launches, fused_fwd_k1a.launches) == (before[0] + 1, before[1])
    ref = legacy_plain(chan, lay, *fused._w).clamp(lay.clip_lo, lay.clip_hi)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    if decoder_type == "SP":
        assert (out - ref).abs().max().item() <= 5e-3
    else:
        assert torch.equal(out, ref)
    assert torch.equal(out < 0, ref < 0)


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,weights,atol", CASES)
def test_matmul_routed_kernels_match_plain_and_roll(cuda, code_name, decoder_type, sharing,
                                                    n_iter, weights, atol):
    """K6 forward in every mode against its plain version, bit for bit, and
    against K1 (QMS in int8 routing bit for bit); K6 backward against its
    plain version and against K2, at K2's bars."""
    code, dec, params = _decoder(code_name, decoder_type, sharing, n_iter, cuda, weights)
    # int8 cotangents in f32, so that K2's gradients are a bar for K6's
    mm = _Train.from_decoder(dec, routing="matmul", routing_dtype=torch.float32)
    roll = FusedMinsumDecoder.from_decoder(dec, params)
    w = mm.pack_weights(*dec._expanded_weights(params))
    chan, lay, g = _train_inputs(code, roll, decoder_type, cuda)
    lay6 = mm.layout
    assert lay6.routing == ("int8" if decoder_type == "QMS" else "split3")
    before = (fused_fwd_k6.launches, fused_bwd_k6.launches)
    app = fused_fwd_k6(chan, lay6, *w)
    st = fused_fwd_k6(chan, lay6, *w, mode="stats")
    app_s, st_s = fused_fwd_k6(chan, lay6, *w, mode="syndrome")
    outs, store = fused_fwd_k6(chan, lay6, *w, mode="stream")
    sampled, sampled_chan = fused_fwd_k6(None, lay6, *w, mode="sample", seed=9, sigma=0.8,
                                         batch=257, emit_chan=True)
    grads = fused_bwd_k6(chan, lay6, *w, store, outs, g)
    torch.cuda.synchronize()
    assert (fused_fwd_k6.launches, fused_bwd_k6.launches) == (before[0] + 5, before[1] + 1)
    ref = fused_fwd_plain(chan, lay6, *w)
    assert torch.equal(app, ref)
    assert torch.equal(st, stats_plain(app, lay6)) and torch.equal(st_s, st)
    assert torch.equal(app_s, app) and torch.equal(outs[-1], app)
    ref_outs, ref_store = fused_fwd_train_plain(chan, lay6, *w)
    assert torch.equal(outs, ref_outs) and torch.equal(store, ref_store)
    assert torch.equal(sampled, stats_plain(fused_fwd_plain(sampled_chan, lay6, *w), lay6))
    k1 = fused_fwd_k1a(chan, roll.layout, *w)
    if decoder_type == "QMS":  # int8 routing is value-exact: K6 is K1, and K2 its bar
        assert torch.equal(app, k1)
        others = (fused_bwd_plain(chan, lay6, *w, ref_store, ref_outs, g),
                  fused_bwd_k2(chan, roll.layout, *w, store, outs, g))
    else:  # split-3's sums round otherwise than roll's, compounding over iterations
        bar = {"MS": 2e-4, "SP": 1e-1}[decoder_type]
        assert (app - k1).abs().max().item() <= bar
        assert not (((app < 0) != (k1 < 0)) & (k1.abs() > bar)).any()
        others = (fused_bwd_plain(chan, lay6, *w, ref_store, ref_outs, g),)
    for other in others:
        for i, (a, b) in enumerate(zip(grads, other)):
            assert (a is None) == (b is None)
            if a is None:
                continue
            if i >= 3:
                torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)
            else:
                assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def _dense_decoder(cuda, n_iter=4):
    """The E = 1100 protograph at Z = 16, MS cn=3 vn=2, seeded weights:
    (code, decoder, params, the generator that drew them)."""
    code = dense_protograph()
    dec = BoostedNeuralDecoder(TannerGraph.from_basegraph(code.basegraph, code.Z),
                               BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType.MS,
                                                    sharing=NodeWeightSharingConfig(cn=3, vn=2)),
                               device=cuda)
    rng = np.random.default_rng(5)
    params = params_from_numpy({
        k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
        for k, v in dec.init_params().items()}, cuda)
    return code, dec, params, rng


# K6's backward: (code, type, sharing, iterations, weights, routing_dtype);
# BG2 int8 with bf16 and f32 cotangents, wman and the E = 1100 protograph
# (check degrees 23-24, VN degrees up to 46) in split-3
K6_BWD_CASES = [
    ("nr_bg2_set0_z16", "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", torch.bfloat16),
    ("nr_bg2_set0_z16", "QMS", dict(cn=3, ucn=2, vn=3), 20, "bg2_qms20_base_ucn.npz",
     torch.float32),
    ("wman_n576_r34_z24", "MS", dict(cn=3), 5, None, torch.bfloat16),
    ("dense_e1100", "MS", dict(cn=3, vn=2), 4, None, torch.bfloat16),
]


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,weights,routing_dtype",
                         K6_BWD_CASES, ids=["bg2-int8-bf16", "bg2-ucn-int8-f32", "wman-split3",
                                            "e1100-split3"])
def test_matmul_routed_backward_matches_plain(cuda, code_name, decoder_type, sharing, n_iter,
                                              weights, routing_dtype):
    """K6's backward, K2's loop with the matmul branch's roundings as hooks,
    against ``fused_bwd_plain`` at K2's bars (channel gradients atol 1e-6 /
    rtol 1e-4, weights 1e-4 of max |g|), on its own training forward's
    outputs and store; one launch a call."""
    if code_name == "dense_e1100":
        code, dec, params, _ = _dense_decoder(cuda, n_iter)
        batch = 64
    else:
        code, dec, params = _decoder(code_name, decoder_type, sharing, n_iter, cuda, weights)
        batch = 257
    mm = _Train.from_decoder(dec, routing="matmul", routing_dtype=routing_dtype)
    lay, w = mm.layout, mm.pack_weights(*dec._expanded_weights(params))
    assert lay.routing == ("int8" if decoder_type == "QMS" else "split3")
    assert lay.grad_f32 == (lay.routing == "int8" and routing_dtype == torch.float32)
    chan, _, g = _train_inputs(code, mm, decoder_type, cuda, batch=batch)
    outs, store = fused_fwd_k6(chan, lay, *w, mode="stream")
    before = fused_bwd_k6.launches, fused_bwd_k6.cuda_launches
    grads = fused_bwd_k6(chan, lay, *w, store, outs, g)
    torch.cuda.synchronize()
    assert (fused_bwd_k6.launches, fused_bwd_k6.cuda_launches) == (before[0] + 1, before[1] + 1)
    for i, (a, b) in enumerate(zip(grads, fused_bwd_plain(chan, lay, *w, store, outs, g))):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert torch.isfinite(a).all()
        if i >= 3:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)
        else:
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_matmul_routed_forward_on_the_dense_protograph(cuda):
    """K6's forward on the E = 1100 protograph at Z = 16 (check degrees
    23-24: MAXD = 32, split-3 routing through "auto"), 64 words, in every
    mode, bit for bit against its plain version: final APP, stats,
    syndrome, stream + store, sampling with emit_chan and in index mode."""
    code, dec, params, rng = _dense_decoder(cuda)
    mm = FusedTrainDecoder.from_decoder(dec)
    lay, w = mm.layout, mm.pack_weights(*dec._expanded_weights(params))
    assert lay.routing == "split3" and lay.E == 1100 and lay.max_degree > 16
    chan = torch.tensor((rng.normal(size=(64, lay.N * lay.Z)) * 2.5 + 1.0).astype(np.float32),
                        device=cuda)
    before = fused_fwd_k6.launches
    app = fused_fwd_k6(chan, lay, *w)
    st = fused_fwd_k6(chan, lay, *w, mode="stats")
    app_s, st_s = fused_fwd_k6(chan, lay, *w, mode="syndrome")
    outs, store = fused_fwd_k6(chan, lay, *w, mode="stream")
    sampled, sampled_chan = fused_fwd_k6(None, lay, *w, mode="sample", seed=9, sigma=0.8,
                                         batch=64, emit_chan=True)
    widx = torch.tensor([3, 17, 40, 63], dtype=torch.int32, device=cuda)
    at = fused_fwd_k6(None, lay, *w, mode="sample", seed=9, sigma=0.8, widx=widx)
    torch.cuda.synchronize()
    assert fused_fwd_k6.launches == before + 6
    ref = fused_fwd_plain(chan, lay, *w)
    assert torch.isfinite(app).all() and torch.equal(app, ref)
    assert torch.equal(st, stats_plain(ref, lay)) and torch.equal(st_s, st)
    assert torch.equal(app_s, app) and torch.equal(outs[-1], app)
    ref_outs, ref_store = fused_fwd_train_plain(chan, lay, *w)
    assert torch.equal(outs, ref_outs) and torch.equal(store, ref_store)
    assert torch.equal(sampled, stats_plain(fused_fwd_plain(sampled_chan, lay, *w), lay))
    assert torch.equal(at, sampled[widx.long()])


def test_matmul_and_legacy_paths_never_take_the_plain_versions(cuda, monkeypatch):
    code, dec, params = _decoder("nr_bg2_set0_z16", "QMS", dict(cn=3, ucn=2, vn=3), 4, cuda)

    def forbidden(*args, **kwargs):
        raise AssertionError("plain path taken for a CUDA tensor")

    for name in ("fused_fwd_plain", "fused_fwd_train_plain", "fused_bwd_plain"):
        monkeypatch.setattr(fused_train_mod, name, forbidden)
    monkeypatch.setattr(legacy_mod, "legacy_plain", forbidden)
    chan = torch.zeros(5, code.n_bits, device=cuda)
    assert torch.isfinite(FusedMinsumDecoder.from_decoder(dec, params, engine="legacy")(chan)).all()
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    outs = _Train.from_decoder(dec, routing="matmul").apply(*dec._expanded_weights(p), chan)
    outs.sum().backward()
    torch.cuda.synchronize()
    assert all(torch.isfinite(v.grad).all() for v in p.values())


def test_sol_probe_matches_plain_and_measures_a_rate(cuda):
    x = sol_input(cuda, rows=1024)
    before = sol_k7.launches
    out = sol_k7(x)
    torch.cuda.synchronize()
    assert sol_k7.launches == before + 1
    assert torch.equal(out, sol_plain(x))
    res = measure_sol(cuda, reps=2)
    assert res["finite"] and res["instr_per_s"] > 1e12


def _grads_match(got, ref, exact_channel):
    """K2's bars against a reference: channel gradients bit for bit
    (``exact_channel``) or within atol 1e-6 / rtol 1e-4 (SP: the card's
    tanhf and logf), weights within 1e-4 of max |g|."""
    for i, (a, b) in enumerate(zip(got, ref)):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert torch.isfinite(a).all()
        if i >= 3:
            if exact_channel:
                assert torch.equal(a, b), (i, (a - b).abs().max().item())
            else:
                torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)
        else:
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,weights,atol", CASES)
@pytest.mark.parametrize("batch", [20, 4097])
def test_k2_block_equals_its_twin_and_the_plain_version(cuda, code_name, decoder_type, sharing,
                                                        n_iter, weights, atol, batch):
    """The backward kernel at the reference's batch of 20 (one word a block,
    a thread per lifted check) and at 4,097 words (W_max words a block, the
    last block partial): channel gradients equal its block twin's and the
    plain version's bit for bit (MS, QMS), weights within 1e-4 of max |g|;
    one CUDA launch a call; the card places its block."""
    code, fused = _fused(code_name, decoder_type, sharing, n_iter, cuda, weights)
    chan, lay, g = _train_inputs(code, fused, decoder_type, cuda, batch=batch)
    plan = fused_train_mod.k2_plan(lay, batch)
    assert plan.W == (1 if batch == 20 else plan.W_max)
    outs, store = fused_fwd_k1d(chan, lay, *fused._w)
    before = fused_bwd_k2.launches, fused_bwd_k2.cuda_launches
    grads = fused_bwd_k2(chan, lay, *fused._w, store, outs, g)
    torch.cuda.synchronize()
    assert (fused_bwd_k2.launches, fused_bwd_k2.cuda_launches) == (before[0] + 1, before[1] + 1)
    exact = decoder_type != "SP"
    _grads_match(grads, fused_bwd_plain(chan, lay, *fused._w, store, outs, g), exact)
    _grads_match(grads, fused_train_mod.fused_bwd_block_plain(chan, lay, *fused._w, store, outs,
                                                             g), exact)
    occ = fused_train_mod.k2_occupancy(lay, cuda, batch)
    assert occ["blocks_per_sm"] >= 1 and occ["words_per_block"] == plan.W


# codes with checks above 32 edges (synth_dense(3, M, N, target_e) lifted at
# Z; tests/test_torch_high_degree.py): the kernels' kAnyDegree instantiations
HIGH = {41: (12, 60, 400), 73: (8, 80, 560)}


def _high(degree, Z, decoder_type, sharing, n_iter, device, seed=1):
    from neural_ldpc_tpu_torch.codes.protograph import CodeSpec, synth_dense

    code = CodeSpec(name=f"synth_dense_deg{degree}", basegraph=synth_dense(3, *HIGH[degree]), Z=Z)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, Z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)), device=device)
    rng = np.random.default_rng(seed)
    params = params_from_numpy({
        k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
        for k, v in dec.init_params().items()}, device)
    return code, dec, params


HIGH_CASES = [(41, "MS", dict(cn=3, ucn=2, vn=3), 4), (41, "QMS", dict(cn=3, vn=3), 5),
              (41, "SP", dict(cn=1, vn=2), 3), (73, "QMS", dict(cn=3, ucn=2), 4),
              (73, "MS", dict(cn=3), 4)]


@pytest.mark.parametrize("degree,decoder_type,sharing,n_iter", HIGH_CASES,
                         ids=[f"deg{c[0]}-{c[1]}-{'-'.join(map(str, c[2].values()))}"
                              for c in HIGH_CASES])
def test_checks_above_32_edges_in_every_on_chip_family(cuda, degree, decoder_type, sharing,
                                                       n_iter):
    """At Z = 16: K1a, K1b (stats), K1d, K2, K6's forward and backward
    (routing="matmul": int8 for QMS, split-3 otherwise) and K5 (the legacy
    engine) against their plain versions at 257 words; QMS and MS bit for
    bit (K6 split-3 and K5 bf16 at their bars), SP within 5e-3 (forward) and
    at K2's bars (backward)."""
    code, dec, params = _high(degree, 16, decoder_type, sharing, n_iter, cuda)
    fused = FusedMinsumDecoder.from_decoder(dec, params)
    lay, w = fused.layout, fused._w
    assert lay.max_degree == degree and not lay.hbm_store
    chan, _, g = _train_inputs(code, fused, decoder_type, cuda)
    sp = decoder_type == "SP"
    app = fused_fwd_k1a(chan, lay, *w)
    ref = fused_fwd_plain(chan, lay, *w)
    assert (app - ref).abs().max().item() <= (5e-3 if sp else 0.0)
    stats = fused_fwd_k1b(chan, lay, *w)
    assert torch.equal(stats, stats_plain(app, lay))
    outs, store = fused_fwd_k1d(chan, lay, *w)
    ref_outs, ref_store = fused_fwd_train_plain(chan, lay, *w)
    assert max((outs - ref_outs).abs().max().item(),
               (store - ref_store).abs().max().item()) <= (5e-3 if sp else 0.0)
    grads = fused_bwd_k2(chan, lay, *w, store, outs, g)
    _grads_match(grads, fused_bwd_plain(chan, lay, *w, store, outs, g), not sp)
    torch.cuda.synchronize()
    # K6: the matmul branch's roundings on the looped code
    mm = _Train.from_decoder(dec, routing="matmul")
    mlay, mw = mm.layout, mm.pack_weights(*dec._expanded_weights(params))
    m_app = fused_fwd_k6(chan, mlay, *mw)
    m_ref = fused_fwd_plain(chan, mlay, *mw)
    assert (m_app - m_ref).abs().max().item() <= (5e-3 if sp else 0.0)
    m_outs, m_store = fused_fwd_k6(chan, mlay, *mw, mode="stream")
    _grads_match(fused_bwd_k6(chan, mlay, *mw, m_store, m_outs, g),
                 fused_bwd_plain(chan, mlay, *mw, m_store, m_outs, g), not sp)
    # K5: the legacy engine (int8 for QMS)
    leg = FusedMinsumDecoder.from_decoder(dec, params, engine="legacy",
                                          int8_routing=decoder_type == "QMS")
    out5 = fused_legacy_k5(chan, leg.layout, *leg._w)
    ref5 = legacy_plain(chan, leg.layout, *leg._w)
    assert (out5 - ref5).abs().max().item() <= (5e-3 if sp else 0.0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("Z", [16, 96])
@pytest.mark.parametrize("decoder_type,sharing", [("MS", dict(cn=3, ucn=2, vn=3)),
                                                  ("QMS", dict(cn=3, vn=3)),
                                                  ("SP", dict(cn=1, vn=2))])
def test_checks_above_32_edges_in_the_device_memory_kernels(cuda, Z, decoder_type, sharing):
    """The degree-41 code on the device-memory family (forced at Z = 16,
    its own at Z = 96): no cluster holds a check above 32 edges, so K3 is
    the two-pass kernel and K4 the device-memory one, held against their
    plain versions (MS and QMS bit for bit, SP within 5e-3 / K2's bars)."""
    code, dec, params = _high(41, Z, decoder_type, sharing, 3, cuda)
    fused = FusedTrainDecoder.from_decoder(dec, store_space="hbm")
    lay, w = fused.layout, fused.pack_weights(*dec._expanded_weights(params))
    assert lay.hbm_store and lay.k3_kernel == "two-pass" and lay.k4_kernel == "device-memory"
    chan, _, g = _train_inputs(code, fused, decoder_type, cuda, batch=33)
    sp = decoder_type == "SP"
    app = fused_train_mod.fused_fwd_k3(chan, lay, *w)
    assert (app - fused_train_mod.fused_fwd_dm_plain(chan, lay, *w)[0]).abs().max().item() <= (
        5e-3 if sp else 0.0)
    outs, store = fused_train_mod.fused_fwd_k3(chan, lay, *w, mode="stream")
    grads = fused_train_mod.fused_bwd_k4(chan, lay, *w, store, outs, g)
    _grads_match(grads, fused_train_mod.fused_bwd_dm_plain(chan, lay, *w, store, outs, g), not sp)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The training recipes and two-stage decoding on the card
# ---------------------------------------------------------------------------
def test_boosted_harvest_runs_k1a_and_every_word_fails_the_plain_decode(cuda):
    """The harvest decodes through K1a on the card; every harvested word
    fails the base decoder's plain version on the card."""
    from neural_ldpc_tpu_torch.training import TrainConfig
    from neural_ldpc_tpu_torch.training.boosted_pipeline import (
        BoostedPipeline, BoostedPipelineConfig)

    code = get_code("nr_bg2_set0_z16")
    pipe = BoostedPipeline(
        TannerGraph.from_basegraph(code.basegraph, code.Z),
        AWGNChannel(code, ChannelConfig(snr_db=(2.0,), qms_qbit=5), device=cuda),
        BoostedDecoderConfig(n_iterations=5, decoder_type=DecoderType.QMS,
                             sharing=NodeWeightSharingConfig(cn=3, vn=3)),
        TrainConfig(is_y_all_zero=True), TrainConfig(is_y_all_zero=True),
        BoostedPipelineConfig(base_iters=5, post_iters=2, collect_words=256,
                              collect_batch_size=4096, collect_snr_index=0))
    params = pipe.base_decoder.init_params()
    fused_fwd_k1a.launches = 0
    llr, bits = pipe.collect_uncorrected_words(params, verbose=False)
    assert fused_fwd_k1a.launches >= 1 and len(llr) == 256
    out = pipe.base_decoder.apply(params, torch.as_tensor(llr, device=cuda))[-1]
    assert ((out < 0).int().cpu().numpy() != bits.astype(np.int32)).any(axis=1).all()


def test_two_stage_sparse_equals_the_full_decode_on_the_card(cuda):
    """QMS base and UCN post decoders through K1a: ``decode_sparse`` equals
    ``__call__`` on every row (each word decodes alone), and the stats equal
    those of the plain decoders."""
    from neural_ldpc_tpu_torch.eval import TwoStageDecoder

    _, base, bp = _decoder("nr_bg2_set0_z16", "QMS", dict(cn=3, vn=3), 5, cuda, seed=1)
    code, post, pp = _decoder("nr_bg2_set0_z16", "QMS", dict(cn=3, ucn=2, vn=3), 7, cuda,
                              seed=2)
    ch = AWGNChannel(code, ChannelConfig(snr_db=(2.0,), qms_qbit=5), device=cuda)
    llr, _ = ch.sample_at(ch.generator(3), 5000, 0)
    two = TwoStageDecoder(post.graph, FusedMinsumDecoder.from_decoder(base, bp),
                          FusedMinsumDecoder.from_decoder(post, pp), device=cuda)
    app, used = two(llr)
    assert 0 < int(used.sum()) < 5000
    for bucket in (256, 8192):
        sparse, sused = two.decode_sparse(llr, bucket)
        assert torch.equal(sparse, app) and torch.equal(sused, used)
    with torch.no_grad():
        plain = TwoStageDecoder(post.graph, lambda x: base.apply(bp, x)[-1],
                                lambda x: post.apply(pp, x)[-1], device=cuda)
        assert plain.decode_with_fallback_stats(llr) == two.decode_with_fallback_stats(llr)


def test_profile_cli_launches_k1a_on_the_card(cuda, tmp_path, capsys):
    from neural_ldpc_tpu_torch.cli import profile

    assert profile.main(["--preset", "bg2_qms_train", "--batch-size", "1024", "--reps", "2",
                         "--trace-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "fused_fwd_k1a" in out.split("kernel launches:")[1]
    assert len(os.listdir(tmp_path)) == 3
