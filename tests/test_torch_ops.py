"""Port's ops (quantize, sharing expansion, flat index-gather ops) against the
JAX package on identical numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.models import BoostedDecoderConfig as JaxConfig
from neural_ldpc_tpu.models import BoostedNeuralDecoder as JaxDecoder
from neural_ldpc_tpu.ops import flat as jflat
from neural_ldpc_tpu.ops import quantize as jq
from neural_ldpc_tpu.structs import NodeWeightSharingConfig as JaxSharing
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder
from neural_ldpc_tpu_torch.ops import flat, qms_clip, qms_quantize_ste, qms_quantize_value
from neural_ldpc_tpu_torch.ops.quantize import _QMS_TABLE
from neural_ldpc_tpu_torch.ops.ste import round_through, sign_through
from neural_ldpc_tpu_torch.structs import NodeWeightSharingConfig


def _ties(qbit):
    """Values that land exactly on .5 after scaling, plus random ones."""
    lo, hi, scale = _QMS_TABLE[qbit]
    halves = (np.arange(-2 * int(hi) - 4, 2 * int(hi) + 5) + 0.5) / scale
    rng = np.random.default_rng(qbit + 10)
    return np.concatenate([halves, rng.normal(size=200) * hi]).astype(np.float32)


@pytest.mark.parametrize("qbit", sorted(_QMS_TABLE) + [7])
def test_qms_quantize_matches_jax(qbit):
    x = _ties(qbit if qbit in _QMS_TABLE else 5)
    want = np.asarray(jq.qms_quantize_ste(jnp.asarray(x), qbit))
    np.testing.assert_array_equal(qms_quantize_ste(torch.tensor(x), qbit).numpy(), want)
    np.testing.assert_array_equal(qms_quantize_value(torch.tensor(x), qbit).numpy(), want)
    np.testing.assert_array_equal(qms_quantize_value(x, qbit), jq.qms_quantize_value(x, qbit))
    np.testing.assert_array_equal(qms_clip(torch.tensor(x), qbit).numpy(),
                                  np.asarray(jq.qms_clip(jnp.asarray(x), qbit)))


def test_ste_gradients():
    x = torch.tensor([-9.0, -1.2, 0.3, 2.75, 8.0], requires_grad=True)
    qms_quantize_ste(x, 5).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0.0, 1.0, 1.0, 1.0, 0.0])
    y = torch.tensor([-0.4, 0.6, 1.7], requires_grad=True)
    r = round_through(y)
    np.testing.assert_array_equal(r.detach().numpy(), np.round(y.detach().numpy()))
    r.sum().backward()
    np.testing.assert_array_equal(y.grad.numpy(), [0.0, 1.0, 0.0])
    np.testing.assert_array_equal(sign_through(torch.tensor([-2.0, 0.0, 3.0])).numpy(),
                                  [-1.0, 0.0, 1.0])


SHARING = [dict(cn=m, ucn=u, vn=v) for m, u, v in [
    (0, 0, 0), (1, 1, 2), (2, 2, 3), (3, 0, 5), (4, 4, 2), (5, 5, 5), (6, 6, 6), (6, 0, 3),
]]


@pytest.mark.parametrize("sharing", SHARING, ids=lambda s: f"cn{s['cn']}ucn{s['ucn']}vn{s['vn']}")
@pytest.mark.parametrize("code_name", ["wman_n576_r34_z24", "nr_bg2_set0_z16"])
def test_expanded_weights_match_jax(code_name, sharing):
    fixed = (2, 4)
    code = get_code(code_name)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    cfg = dict(n_iterations=6, fixed_iterative_nodes=fixed)
    dec = BoostedNeuralDecoder(g, BoostedDecoderConfig(
        sharing=NodeWeightSharingConfig(**sharing), **cfg), device="cpu")
    jdec = JaxDecoder(JaxTannerGraph.from_basegraph(code.basegraph, code.Z), JaxConfig(
        sharing=JaxSharing(**sharing), **cfg))
    rng = np.random.default_rng(7)
    jparams = jdec.init_params()
    arrays = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in jparams.items()}
    assert {k: v.shape for k, v in dec.init_params().items()} == {
        k: v.shape for k, v in jparams.items()}
    over = {"cn": {1: np.float32(0.5)}} if sharing["cn"] else None
    ours = dec._expanded_weights({k: torch.tensor(v) for k, v in arrays.items()},
                                 {"cn": {1: 0.5}} if over else None)
    theirs = jdec._expanded_weights({k: jnp.asarray(v) for k, v in arrays.items()}, over)
    for a, b in zip(ours, theirs):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    masks = dec.trainable_row_masks()
    jmasks = jdec.trainable_row_masks()
    assert masks.keys() == jmasks.keys()
    for k in masks:
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(jmasks[k]))


@pytest.mark.parametrize("code_name", ["wman_n576_r34_z24", "nr_bg2_set0_z16"])
def test_flat_ops_match_jax(code_name):
    code = jax_get_code(code_name)
    jfa = jflat.FlatGraphArrays.from_graph(JaxTannerGraph.from_basegraph(code.basegraph, code.Z))
    fa = flat.FlatGraphArrays.from_graph(TannerGraph.from_basegraph(code.basegraph, code.Z))
    rng = np.random.default_rng(1)
    # quantized values make ties in the two-min common
    x_nz = (np.round(rng.normal(size=(4, fa.N * fa.Z)) * 3) / 2).astype(np.float32)
    v2c = (np.round(rng.normal(size=(4, fa.E * fa.Z)) * 3) / 2).astype(np.float32)
    hi = "highest"
    pairs = [
        (flat.route_to_edges(torch.tensor(x_nz), fa), jflat.route_to_edges(x_nz, jfa, hi), 0),
        (flat.route_to_vns(torch.tensor(v2c), fa), jflat.route_to_vns(v2c, jfa, hi), 1e-5),
        (flat.cn_minsum_flat(torch.tensor(v2c), fa), jflat.cn_minsum_flat(v2c, jfa, hi), 0),
        (flat.cn_sumproduct_flat(torch.tensor(v2c), fa),
         jflat.cn_sumproduct_flat(v2c, jfa, hi), 1e-4),
        (flat.check_parity_flat(torch.tensor(x_nz), fa),
         jflat.check_parity_flat(x_nz, jfa, hi), 0),
    ]
    for ours, theirs, atol in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=atol)
