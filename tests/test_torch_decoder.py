"""Port's plain decoder (neural_ldpc_tpu_torch.models.BoostedNeuralDecoder)
against the JAX flat path on identical numpy inputs and weights.

Bars: QMS exact (messages live on the 1/scale grid, so sum order cannot
matter); MS atol 2e-5 (float sums in another order); SP atol 5e-3 with equal
hard decisions (atanh near +-1 amplifies product-order noise)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.models import BoostedDecoderConfig as JaxConfig
from neural_ldpc_tpu.models import BoostedNeuralDecoder as JaxDecoder
from neural_ldpc_tpu.structs import DecoderType as JaxType
from neural_ldpc_tpu.structs import NodeWeightSharingConfig as JaxSharing
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.models import (
    BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz, params_from_numpy)
from neural_ldpc_tpu_torch.structs import Convention, DecoderType, NodeWeightSharingConfig

TRAINED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "trained")
WMAN, BG2 = "wman_n576_r34_z24", "nr_bg2_set0_z16"


def build_pair(code_name, decoder_type, sharing, n_iterations, device="cpu"):
    code = get_code(code_name)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, code.Z),
        BoostedDecoderConfig(n_iterations=n_iterations, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)), device=device)
    jcode = jax_get_code(code_name)
    jdec = JaxDecoder(
        JaxTannerGraph.from_basegraph(jcode.basegraph, jcode.Z),
        JaxConfig(n_iterations=n_iterations, decoder_type=JaxType[decoder_type],
                  sharing=JaxSharing(**sharing), matmul_precision="highest"))
    return code, dec, jdec


def random_weights(jdec, seed, spread=0.2):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) * (1 + spread * rng.normal(size=v.shape))).astype(np.float32)
            for k, v in jdec.init_params().items()}


def channel(code, batch, seed, scale=3.0, offset=1.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, code.N, code.Z)) * scale + offset).astype(np.float32)


def assert_close(decoder_type, ours, theirs):
    if decoder_type == "QMS":
        np.testing.assert_array_equal(ours, theirs)
        return
    atol = 5e-3 if decoder_type == "SP" else 2e-5
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=atol)
    if decoder_type == "SP":
        np.testing.assert_array_equal(ours < 0, theirs < 0)


CASES = [
    (WMAN, "MS", dict(cn=3), 5),
    (WMAN, "MS", dict(cn=2, ucn=2, vn=3), 4),
    (WMAN, "QMS", dict(cn=2, vn=3), 4),
    (WMAN, "QMS", dict(cn=1, ucn=1, vn=2), 3),
    (WMAN, "SP", dict(cn=1, vn=2), 4),
    (BG2, "MS", dict(cn=1, vn=2), 3),
    (BG2, "MS", dict(cn=3, ucn=3, vn=0), 3),
    (BG2, "QMS", dict(cn=3, vn=3), 5),
    (BG2, "QMS", dict(cn=6, ucn=2, vn=6), 4),
    (BG2, "SP", dict(cn=2, vn=3), 3),
]


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter", CASES,
                         ids=[f"{c[0][:4]}-{c[1]}-{'-'.join(f'{k}{v}' for k, v in c[2].items())}"
                              for c in CASES])
def test_plain_decoder_matches_jax_flat(code_name, decoder_type, sharing, n_iter):
    code, dec, jdec = build_pair(code_name, decoder_type, sharing, n_iter)
    w = random_weights(jdec, seed=n_iter)
    # SP: large LLRs drive BG2's low-degree check products into the 1 - 1e-7
    # clamp, where atanh turns one ulp of product-order noise into ~0.1;
    # moderate LLRs keep the comparison well conditioned
    x = channel(code, 6, seed=3, scale=1.5, offset=0.5) if decoder_type == "SP" \
        else channel(code, 6, seed=3)
    ours = dec.apply(params_from_numpy(w, "cpu"), torch.tensor(x)).numpy()
    theirs = np.asarray(jdec.apply({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x)))
    assert ours.shape == (n_iter, 6, code.n_bits)
    assert_close(decoder_type, ours, theirs)


@pytest.mark.parametrize("weights,sharing", [
    ("bg2_qms20_ref500ep.npz", dict(cn=3, vn=3)),
    ("bg2_qms20_base_ucn.npz", dict(cn=3, ucn=2, vn=3)),
])
def test_trained_weights_match_jax(weights, sharing):
    code, dec, jdec = build_pair(BG2, "QMS", sharing, 20)
    params = load_params_npz(os.path.join(TRAINED, weights), "cpu")
    with np.load(os.path.join(TRAINED, weights)) as d:
        jparams = {k: jnp.asarray(d[k]) for k in d.files}
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: v.shape for k, v in jparams.items()}
    x = np.round(channel(code, 8, seed=5, scale=2.0, offset=1.0) * 2) / 2
    ours = dec.apply(params, torch.tensor(x)).numpy()
    theirs = np.asarray(jdec.apply(jparams, jnp.asarray(x)))
    np.testing.assert_array_equal(ours, theirs)


def test_decoder_api_matches_jax():
    code, dec, jdec = build_pair(WMAN, "MS", dict(cn=5, ucn=0, vn=2), 4)
    w = random_weights(jdec, seed=1)
    params = params_from_numpy(w, "cpu")
    x = channel(code, 3, seed=2)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    np.testing.assert_allclose(dec(params, torch.tensor(x), target_iter=2).numpy(),
                               np.asarray(jdec(jw, jnp.asarray(x), target_iter=2)), atol=2e-5)
    np.testing.assert_allclose(dec(params, torch.tensor(x), target_iter=[0, 3]).numpy(),
                               np.asarray(jdec(jw, jnp.asarray(x), target_iter=[0, 3])), atol=2e-5)
    np.testing.assert_array_equal(dec.decode_hard(params, torch.tensor(x)).numpy(),
                                  np.asarray(jdec.decode_hard(jw, jnp.asarray(x))))
    clamped = dec.clamp_params({k: v * 3 - 1 for k, v in params.items()})
    jclamped = jdec.clamp_params({k: v * 3 - 1 for k, v in jw.items()})
    for k in clamped:
        np.testing.assert_allclose(clamped[k].numpy(), np.asarray(jclamped[k]), rtol=1e-6)
    named, jnamed = dec.named_parameter_rows(params), jdec.named_parameter_rows(jw)
    assert named.keys() == jnamed.keys()
    for k in named:
        np.testing.assert_array_equal(named[k], jnamed[k])


def test_plain_decoder_is_differentiable():
    code, dec, _ = build_pair(BG2, "QMS", dict(cn=3, vn=3), 3)
    params = {k: v.requires_grad_() for k, v in dec.init_params().items()}
    out = dec.apply(params, torch.tensor(channel(code, 2, seed=9)))
    torch.sigmoid(-out).mean().backward()
    for v in params.values():
        assert v.grad is not None and torch.isfinite(v.grad).all()


def test_unsupported_configurations_raise():
    code = get_code(WMAN)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        BoostedNeuralDecoder(g, BoostedDecoderConfig(convention=Convention.REFERENCE), device="cpu")
    with pytest.raises(ValueError, match="UCN weighting requires CN"):
        BoostedNeuralDecoder(g, BoostedDecoderConfig(
            sharing=NodeWeightSharingConfig(cn=0, ucn=2)), device="cpu")


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = get_code(WMAN)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BoostedNeuralDecoder(g, BoostedDecoderConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"weight_cn": np.ones((2, 1), np.float32)})
