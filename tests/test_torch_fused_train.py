"""The training path of the fused decoder on the CPU: ``FusedTrainDecoder``
with JAX's defaults runs ``FusedTrainFn``, whose forward (K1d) and backward
(K2) run their plain versions on CPU tensors.  Held against the JAX flat
path (outputs, loss and gradients for the weights and the LLRs) and, on one
case, against JAX's own ``FusedTrainDecoder`` in interpret mode.  Bars: APP
2e-5 (MS, SP) or exact (QMS); loss 1e-6; gradients atol 1e-6 / rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.ops.pallas.fused_train import FusedTrainDecoder as JaxTrain
from neural_ldpc_tpu.training.loss import multi_iteration_loss as jax_loss
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, FusedTrainDecoder, fused_bwd_k2, fused_bwd_plain, fused_fwd_k1d,
    fused_fwd_plain)
from neural_ldpc_tpu_torch.training import multi_iteration_loss
from test_torch_decoder import assert_close
from test_torch_grad import (
    BG2, GRAD_CASES, GRAD_TOL, WMAN, assert_grads_match, build_grad_pair, grad_inputs,
    jax_value_and_grads)

IDS = [f"{c[0][:4]}-{c[2]}x{c[4]}-{'-'.join(f'{k}{v}' for k, v in c[3].items())}"
       f"{'-randomcw' if c[5] else ''}" for c in GRAD_CASES]


def fused_value_and_grads(dec, params, llr, bits):
    """Loss over all iterations through ``FusedTrainDecoder.apply`` and its
    gradients for the params and the LLRs, with the outputs."""
    ft = FusedTrainDecoder.from_decoder(dec)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    x = torch.tensor(llr, requires_grad=True)
    outs = ft.apply(*dec._expanded_weights(p), x)
    loss = multi_iteration_loss(outs, torch.tensor(bits), coeff=list(range(outs.shape[0])))
    grads = torch.autograd.grad(loss, [*p.values(), x])
    return outs.detach(), loss, {k: g.numpy() for k, g in zip(p, grads)}, grads[-1].numpy()


@pytest.mark.parametrize("code_name,z,decoder_type,sharing,n_iter,random_cw", GRAD_CASES,
                         ids=IDS)
def test_fused_train_matches_jax_flat(code_name, z, decoder_type, sharing, n_iter, random_cw):
    code, dec, jdec = build_grad_pair(code_name, z, decoder_type, sharing, n_iter)
    params, llr, bits = grad_inputs(code, dec, jdec, random_codewords=random_cw)
    outs, loss, gp, gx = fused_value_and_grads(dec, params, llr, bits)
    jouts = np.asarray(jdec.apply({k: jnp.asarray(v) for k, v in params.items()},
                                  jnp.asarray(llr)))
    assert outs.shape == jouts.shape
    assert_close(decoder_type, outs.numpy(), jouts)
    assert_grads_match(loss, gp, gx, *jax_value_and_grads(jdec, params, llr, bits))


def test_fused_train_matches_jax_interpret_kernel():
    """JAX's own FusedTrainDecoder (its _fwd_kernel / _bwd_kernel in
    interpret mode, roll routing, f32) on the inputs of
    tests/test_fused_train.py::test_fused_train_grad_parity_fast: wman
    relifted at Z = 8, MS x3, cn=3 vn=2, 8 words from rng(0)."""
    code, dec, jdec = build_grad_pair(WMAN, 8, "MS", dict(cn=3, vn=2), 3)
    rng = np.random.default_rng(0)
    params = {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in jdec.init_params().items()}
    g = dec.graph
    llr = (rng.normal(size=(8, g.N, 8)) * 4).astype(np.float32)
    bits = np.zeros((8, g.N * 8), np.float32)
    jft = JaxTrain.from_decoder(jdec, interpret=True, routing="roll", routing_dtype=jnp.float32)

    def jloss(p, x):
        return jax_loss(jft.apply(*jdec._expanded_weights(p), x), jnp.asarray(bits),
                        coeff=[0, 1, 2])

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(llr))
    jouts = np.asarray(jft.apply(*jdec._expanded_weights(jp), jnp.asarray(llr)))
    outs, loss, gp, gx = fused_value_and_grads(dec, params, llr, bits)
    np.testing.assert_allclose(outs.numpy(), jouts, rtol=0, atol=2e-5)
    assert_grads_match(loss, gp, gx, float(jval), {k: np.asarray(v) for k, v in jgp.items()},
                       np.asarray(jgx))


def _packed_case(code_name, decoder_type, sharing, n_iter, seed=1):
    """A decoder, its fused training decoder, and weights spread around 1."""
    code, dec, jdec = build_grad_pair(code_name, None, decoder_type, sharing, n_iter)
    rng = np.random.default_rng(seed)
    params = {k: torch.tensor((v.numpy() * (1 + 0.3 * rng.standard_normal(v.shape)))
                              .astype(np.float32)) for k, v in dec.init_params().items()}
    ft = FusedTrainDecoder.from_decoder(dec)
    return dec, ft, params


def test_backward_plain_equals_plain_engine_autograd_on_ties():
    """``fused_bwd_plain`` (the kernel's reverse pass written out) gives the
    gradients autograd takes through the plain decoder, on a QMS input
    sitting on the ties: half-grid channel values with many exact zeros
    and saturations at +-7.5, UCN and VN weights."""
    rng = np.random.default_rng(5)
    code = get_code(BG2)
    llr = np.clip(np.round(rng.normal(size=(12, code.N, code.Z)) * 8) / 2, -9, 9)
    llr[:, :, ::3] = 0.0
    llr = llr.astype(np.float32)
    dec, ft, params = _packed_case(BG2, "QMS", dict(cn=3, ucn=2, vn=3), 4)
    bits = torch.zeros(12, code.n_bits)
    grads = []
    for engine in ("plain", "fused"):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        x = torch.tensor(llr, requires_grad=True)
        outs = dec.apply(p, x) if engine == "plain" else ft.apply(*dec._expanded_weights(p), x)
        loss = multi_iteration_loss(outs, bits, coeff=list(range(4)))
        grads.append(torch.autograd.grad(loss, [*p.values(), x]))
    assert float((llr == 0).mean()) > 0.3 and float((np.abs(llr) >= 7.5).mean()) > 0.01
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **GRAD_TOL)


def test_k1d_and_k2_plain_versions():
    """K1d's last output is K1a's APP, its store starts at zeros and holds
    the state entering each iteration; K2's wrapper is its plain version on
    the CPU, and neither counts a launch there."""
    code, dec, jdec = build_grad_pair(WMAN, 8, "MS", dict(cn=3, ucn=2, vn=2), 3)
    params, llr, _ = grad_inputs(code, dec, jdec, batch=6)
    ft = FusedTrainDecoder.from_decoder(dec)
    w = ft.pack_weights(*dec._expanded_weights({k: torch.tensor(v) for k, v in params.items()}))
    lay, chan = ft.layout, torch.tensor(llr).reshape(6, -1)
    before = (fused_fwd_k1d.launches, fused_bwd_k2.launches)
    outs, store = fused_fwd_k1d(chan, lay, *w)
    assert outs.shape == (3, 6, lay.N * lay.Z) and store.shape == (3, 6, lay.E * lay.Z)
    assert torch.equal(outs[-1], fused_fwd_plain(chan, lay, *w))
    assert not store[0].any() and store[1].any()
    no_store = fused_fwd_k1d(chan, lay, *w, store=False)
    assert no_store[1] is None and torch.equal(no_store[0], outs)
    g = torch.randn(outs.shape, generator=torch.Generator().manual_seed(1))
    ours = fused_bwd_k2(chan, lay, *w, store, outs, g)
    ref = fused_bwd_plain(chan, lay, *w, store, outs, g)
    for a, b in zip(ours, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    assert ours[4] is None  # no QMS: the quantized channel's terms are in g_chan
    assert (fused_fwd_k1d.launches, fused_bwd_k2.launches) == before
    with pytest.raises(ValueError, match="store"):
        fused_bwd_k2(chan, lay, *w, store[:, :3], outs, g)


def test_all_iterations_decode_is_the_stream():
    code, dec, jdec = build_grad_pair(BG2, None, "QMS", dict(cn=3, vn=3), 4)
    params, llr, _ = grad_inputs(code, dec, jdec, batch=5)
    p = {k: torch.tensor(v) for k, v in params.items()}
    every = FusedMinsumDecoder.from_decoder(dec, p, all_iterations=True)(torch.tensor(llr))
    assert every.shape == (4, 5, code.n_bits)
    np.testing.assert_array_equal(every.numpy(), dec.apply(p, torch.tensor(llr)).numpy())
    final = FusedMinsumDecoder.from_decoder(dec, p)(torch.tensor(llr))
    np.testing.assert_array_equal(every[-1].numpy(), final.numpy())


def test_backward_without_the_store_raises_and_mode_checks_match_jax():
    code = get_code(WMAN)
    g = TannerGraph.from_basegraph(code.basegraph, 8)
    cw = torch.ones(2, g.E, requires_grad=True)
    f = FusedTrainDecoder(g, 2, store_msgs=False, stream_outputs=True, device="cpu")
    outs = f.apply(cw, None, None, torch.randn(3, g.N * 8))
    assert outs.shape == (2, 3, g.N * 8)
    with pytest.raises(ValueError, match="backward requires store_msgs=True"):
        outs.sum().backward()
    d = FusedTrainDecoder(g, 2, device="cpu")
    assert d.store_msgs and d.stream_outputs
    for kw, match in ((dict(stream_outputs=False), "needs the full output stream"),
                      (dict(emit_syndrome=True), "final-APP decode epilogue"),
                      (dict(emit_stats=True), "stats-only decode mode")):
        with pytest.raises(ValueError, match=match):
            FusedTrainDecoder(g, 2, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            JaxTrain(g, 2, interpret=True, **kw)
