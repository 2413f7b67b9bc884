"""Gradients of the port's plain engine against the JAX package's.

``ops/ties.py`` gives the plain decoder and the loss JAX's conventions where
an operation's input sits on its kink (clip bounds, |0|, ReLU at 0, tied
minima).  Each function is held against ``jax.grad`` of its JAX counterpart
on inputs that sit on those ties, and the plain decoder's loss and
gradients, for the weights and the LLRs, against ``jax.value_and_grad`` of
the JAX flat path at ``matmul_precision="highest"``.  Bars: loss 1e-6,
gradients atol 1e-6 / rtol 1e-4 (``tests/test_fused_train.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.models import BoostedDecoderConfig as JaxConfig
from neural_ldpc_tpu.models import BoostedNeuralDecoder as JaxDecoder
from neural_ldpc_tpu.ops.flat import _two_min as jax_two_min
from neural_ldpc_tpu.structs import DecoderType as JaxType
from neural_ldpc_tpu.structs import NodeWeightSharingConfig as JaxSharing
from neural_ldpc_tpu.training.loss import multi_iteration_loss as jax_loss
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder
from neural_ldpc_tpu_torch.ops import ties
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
from neural_ldpc_tpu_torch.training import multi_iteration_loss

WMAN, BG2 = "wman_n576_r34_z24", "nr_bg2_set0_z16"
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)

# values sitting on every tie of the table in ops/ties.py
_X = np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 0.5, 1.0, 2.0], np.float32)
_GMAT = np.array([[3.0, 1.0, 1.0, 2.0], [0.0, 0.0, 0.0, 5.0], [2.0, 2.0, 1.0, 1.0],
                  [4.0, 0.0, 4.0, 4.0]], np.float32)
TIE_CASES = {
    "clip": (_X, lambda x: ties.clip(x, -1.0, 1.0), lambda x: jnp.clip(x, -1.0, 1.0)),
    "relu0": (_X, ties.relu0, lambda x: jnp.maximum(x, 0.0)),
    "abs": (_X, ties.abs_, jnp.abs),
    "two_min": (_GMAT,
                lambda g: (lambda m1, m2, _: 3.0 * m1 + 5.0 * m2)(*ties.two_min(g, 10000.0)),
                lambda g: (lambda m1, m2, _: 3.0 * m1 + 5.0 * m2)(*jax_two_min(g))),
}


@pytest.mark.parametrize("name", sorted(TIE_CASES))
def test_ties_match_jax_grad(name):
    x, ours, theirs = TIE_CASES[name]
    xt = torch.tensor(x, requires_grad=True)
    y = ours(xt)
    (w,) = torch.autograd.grad((y * torch.arange(1, y.numel() + 1).reshape(y.shape)).sum(), xt)
    jw = jax.grad(lambda a: jnp.sum(theirs(a) * jnp.arange(1, y.numel() + 1).reshape(y.shape)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(theirs(jnp.asarray(x))))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_abs_value_is_torch_abs():
    x = torch.tensor([-0.0, 0.0, -3.0])
    assert torch.equal(torch.signbit(ties.abs_(x)), torch.signbit(torch.abs(x)))


def build_grad_pair(code_name, z, decoder_type, sharing, n_iter):
    """(port decoder, JAX flat decoder at highest precision) on the code
    lifted at ``z`` (``None`` = its own lift)."""
    code, jcode = get_code(code_name), jax_get_code(code_name)
    z = z or code.Z
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)), device="cpu")
    jdec = JaxDecoder(
        JaxTannerGraph.from_basegraph(jcode.basegraph, z),
        JaxConfig(n_iterations=n_iter, decoder_type=JaxType[decoder_type],
                  sharing=JaxSharing(**sharing), matmul_precision="highest"))
    return code, dec, jdec


def grad_inputs(code, dec, jdec, batch=32, sigma=0.7, seed=0, random_codewords=False):
    """Params (init + 0.1 N(0, 1)) and LLRs 2(x + sigma n) / sigma^2 from
    ``rng(seed)``, as ``tests/test_fused_train.py::_setup`` makes them; with
    ``random_codewords`` the words come from the code's generator matrix."""
    rng = np.random.default_rng(seed)
    params = {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in jdec.init_params().items()}
    g = dec.graph
    bits = np.zeros((batch, g.N * g.Z), np.float32)
    if random_codewords:
        info = rng.integers(0, 2, (batch, code.n_info_bits))
        bits = ((info @ code.gen_matrix) % 2).astype(np.float32)
    sym = (1.0 - 2.0 * bits).reshape(batch, g.N, g.Z)
    llr = (2 * (sym + sigma * rng.standard_normal((batch, g.N, g.Z))) / sigma**2).astype(np.float32)
    return params, llr, bits


def jax_value_and_grads(jdec, params, llr, bits):
    coeff = list(range(jdec.config.n_iterations))

    def loss(p, x):
        return jax_loss(jdec.apply(p, x), jnp.asarray(bits), coeff=coeff)

    val, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(llr))
    return float(val), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def assert_grads_match(loss, gp, gx, jloss, jgp, jgx):
    loss = float(loss.detach())
    assert abs(loss - jloss) < 1e-6, (loss, jloss)
    for k in jgp:
        np.testing.assert_allclose(gp[k], jgp[k], err_msg=f"grad {k}", **GRAD_TOL)
    np.testing.assert_allclose(gx, jgx, err_msg="grad llr", **GRAD_TOL)


# (code, relift Z or None, type, sharing, iterations, random codewords):
# tests/test_fused_train.py's CASES (wman relifted at Z = 8), an SP case, and
# the preset's random codewords on BG2 QMS, whose ties torch's own
# conventions got wrong by up to 1.34e-4
GRAD_CASES = [
    (WMAN, 8, "MS", dict(cn=3), 5, False),
    (WMAN, 8, "MS", dict(cn=1, vn=2), 4, False),
    (BG2, None, "QMS", dict(cn=3, vn=3), 4, False),
    (BG2, None, "QMS", dict(cn=3, ucn=2), 3, False),
    (WMAN, 8, "SP", dict(cn=1, vn=2), 3, False),
    (BG2, None, "QMS", dict(cn=3, vn=3), 4, True),
]


@pytest.mark.parametrize(
    "code_name,z,decoder_type,sharing,n_iter,random_cw", GRAD_CASES,
    ids=[f"{c[0][:4]}-{c[2]}x{c[4]}-{'-'.join(f'{k}{v}' for k, v in c[3].items())}"
         f"{'-randomcw' if c[5] else ''}" for c in GRAD_CASES])
def test_plain_engine_grads_match_jax_flat(code_name, z, decoder_type, sharing, n_iter,
                                           random_cw):
    code, dec, jdec = build_grad_pair(code_name, z, decoder_type, sharing, n_iter)
    params, llr, bits = grad_inputs(code, dec, jdec, random_codewords=random_cw)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    x = torch.tensor(llr, requires_grad=True)
    loss = multi_iteration_loss(dec.apply(p, x), torch.tensor(bits), coeff=list(range(n_iter)))
    grads = torch.autograd.grad(loss, [*p.values(), x])
    gp = {k: g.numpy() for k, g in zip(p, grads)}
    assert_grads_match(loss, gp, grads[-1].numpy(), *jax_value_and_grads(jdec, params, llr, bits))
