"""The port's Dai neural min-sum decoder
(``neural_ldpc_tpu_torch.models.NeuralMinSumDecoder``) against the JAX
package's flat path on identical numpy inputs and weights.

Bars: APP within atol 2e-5 (float sums in another order); the loss within
atol 1e-6 / rtol 1e-5 and its gradients within atol 1e-6 / rtol 1e-4; hard
decisions, parameter rows and the config equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.models import NeuralDecoderConfig as JaxNeuralConfig
from neural_ldpc_tpu.models import NeuralMinSumDecoder as JaxNeuralDecoder
from neural_ldpc_tpu.training.loss import multi_iteration_loss as jax_loss
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.models import (
    NeuralDecoderConfig, NeuralMinSumDecoder, neural_params_from_numpy)
from neural_ldpc_tpu_torch.structs import Convention
from neural_ldpc_tpu_torch.training import multi_iteration_loss

WMAN, BG2 = "wman_n576_r34_z24", "nr_bg2_set0_z16"
APP_TOL = dict(rtol=0, atol=2e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)  # a float32 mean over B*N*Z terms in another order


def build_neural_pair(code_name, n_iter, z=None):
    """(code, port decoder on the CPU, JAX decoder at highest precision)."""
    code, jcode = get_code(code_name), jax_get_code(code_name)
    z = z or code.Z
    dec = NeuralMinSumDecoder(TannerGraph.from_basegraph(code.basegraph, z),
                              NeuralDecoderConfig(n_iterations=n_iter), device="cpu")
    jdec = JaxNeuralDecoder(JaxTannerGraph.from_basegraph(jcode.basegraph, z),
                            JaxNeuralConfig(n_iterations=n_iter, matmul_precision="highest"))
    return code, dec, jdec


def neural_inputs(dec, batch, seed, sigma=0.8, zeros=0.0, grid=None):
    """Random weights around 0.5 and biases around 0 for every iteration,
    and all-zero-word LLRs 2(1 + sigma n) / sigma^2, a share ``zeros`` of
    them set to exactly 0 (then every c2v of their checks is 0), rounded to
    multiples of ``grid`` if given (tied minimums in the first check
    update)."""
    rng = np.random.default_rng(seed)
    I, E = dec.config.n_iterations, dec.graph.E
    params = {"weights_var": (0.5 + 0.2 * rng.standard_normal((I, E))).astype(np.float32),
              "biases_var": (0.1 * rng.standard_normal((I, E))).astype(np.float32)}
    g = dec.graph
    llr = (2 * (1 + sigma * rng.standard_normal((batch, g.N, g.Z))) / sigma**2).astype(np.float32)
    llr[rng.random(llr.shape) < zeros] = 0.0
    if grid:
        llr = (np.round(llr / grid) * grid).astype(np.float32)
    return params, llr


@pytest.mark.parametrize("zeros", [0.0, 0.05], ids=["plain", "exact_zeros"])
def test_apply_matches_jax(zeros):
    _, dec, jdec = build_neural_pair(WMAN, 5)
    params, llr = neural_inputs(dec, 48, seed=1, zeros=zeros)
    ours = dec.apply(neural_params_from_numpy(params, "cpu"), torch.as_tensor(llr)).numpy()
    theirs = np.asarray(jdec.apply({k: jnp.asarray(v) for k, v in params.items()},
                                   jnp.asarray(llr)))
    assert ours.shape == theirs.shape == (5, 48, dec.graph.N * dec.graph.Z)
    np.testing.assert_allclose(ours, theirs, **APP_TOL)
    if zeros:
        # the exact zeros reach the c2v messages: 0 magnitudes there
        assert (ours == 0).any()
    hard = dec.decode_hard(neural_params_from_numpy(params, "cpu"), torch.as_tensor(llr))
    np.testing.assert_array_equal(hard.numpy(), np.asarray(
        jdec.decode_hard({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(llr))))


# the tied-minimum case runs 2 iterations: its ties come from the channel's
# grid in both packages alike, while later iterations' VN sums round in each
# package's own order (APPs 1 ulp apart), so that an exact tie in one can be
# a near tie in the other and send the gradient to another edge
@pytest.mark.parametrize("code_name,z,n_iter,zeros,grid", [
    (WMAN, 8, 4, 0.0, None), (WMAN, 8, 4, 0.05, None), (WMAN, 8, 2, 0.0, 2.0),
    (BG2, None, 4, 0.0, None)])
def test_gradients_match_jax_grad(code_name, z, n_iter, zeros, grid):
    code, dec, jdec = build_neural_pair(code_name, n_iter, z)
    params, llr = neural_inputs(dec, 24, seed=2, zeros=zeros, grid=grid)
    bits = np.zeros((24, dec.graph.N * dec.graph.Z), np.float32)
    coeff = list(range(n_iter))

    p = {k: v.requires_grad_(True) for k, v in neural_params_from_numpy(params, "cpu").items()}
    x = torch.as_tensor(llr).requires_grad_(True)
    loss = multi_iteration_loss(dec.apply(p, x), torch.as_tensor(bits), coeff=coeff)
    grads = torch.autograd.grad(loss, [p["weights_var"], p["biases_var"], x])

    def jloss(jp, jx):
        return jax_loss(jdec.apply(jp, jx), jnp.asarray(bits), coeff=coeff)

    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(llr))
    np.testing.assert_allclose(loss.item(), float(jval), **LOSS_TOL)
    for got, k in zip(grads[:2], ("weights_var", "biases_var")):
        np.testing.assert_allclose(got.numpy(), np.asarray(jgp[k]), err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(grads[2].numpy(), np.asarray(jgx), err_msg="llr", **GRAD_TOL)


def test_params_rows_and_config_match_jax():
    _, dec, jdec = build_neural_pair(WMAN, 3)
    ours, theirs = dec.init_params(), jdec.init_params()
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
    params, _ = neural_inputs(dec, 1, seed=3)
    named = dec.named_parameter_rows(neural_params_from_numpy(params, "cpu"))
    jnamed = jdec.named_parameter_rows({k: jnp.asarray(v) for k, v in params.items()})
    assert list(named) == list(jnamed)
    for k in named:
        np.testing.assert_array_equal(named[k], np.asarray(jnamed[k]))
    ours_cfg = {f.name: f.default for f in dataclasses.fields(NeuralDecoderConfig)}
    theirs_cfg = {f.name: f.default for f in dataclasses.fields(JaxNeuralConfig)}
    assert ours_cfg.keys() == theirs_cfg.keys()
    for k, v in theirs_cfg.items():
        assert (ours_cfg[k].value if k == "convention" else ours_cfg[k]) == \
            (v.value if k == "convention" else v), k


def test_unported_routes_and_jax_checks():
    code = get_code(WMAN)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    with pytest.raises(ValueError, match="unknown routing"):
        NeuralMinSumDecoder(g, NeuralDecoderConfig(routing="dense"), device="cpu")
    with pytest.raises(ValueError, match="STANDARD convention only"):
        NeuralMinSumDecoder(g, NeuralDecoderConfig(routing="flat",
                                                   convention=Convention.REFERENCE), device="cpu")
    for cfg in (NeuralDecoderConfig(routing="edge"),
                NeuralDecoderConfig(convention=Convention.REFERENCE)):
        with pytest.raises(NotImplementedError, match="item 9"):
            NeuralMinSumDecoder(g, cfg, device="cpu")
