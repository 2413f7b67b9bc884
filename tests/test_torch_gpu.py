"""The CUDA decode kernel against its plain PyTorch version on the card.

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
from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, fused_fwd_k1a, fused_fwd_plain
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


def _fused(code_name, decoder_type, sharing, n_iter, device, weights=None, seed=0):
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
