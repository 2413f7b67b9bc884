"""The CUDA decode kernel (K1a, K1b, K1c) and the campaign on the card,
held against their plain PyTorch versions.

These tests need an NVIDIA GPU and skip elsewhere.  They import no JAX, so
they also run where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import os

import numpy as np
import pytest
import torch

from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.codes.protograph import nr_bg1_like
from neural_ldpc_tpu_torch.models import (
    BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz, params_from_numpy)
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c, fused_fwd_plain,
    sample_channel_plain, stats_plain)
from neural_ldpc_tpu_torch.ops.cuda import fused_train as fused_train_mod
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
