"""The on-chip backward kernel's block layout (``ops/cuda/fused_train.py::
k2_plan``: several words a block, the store rows and the message cotangent
carry in shared memory in the VN's frame, a table the block loads once, a
check code per degree) on the CPU.  ``fused_bwd_block_plain`` runs the
reverse pass through the plan's table and word split, in the kernel's phase
and sum order, and must equal ``fused_bwd_plain`` (the kernel's ground truth
on the card): channel gradients bit for bit, weight gradients (per-block
partials, another summation order) within 1e-4 of their largest magnitude;
also through K6's int8 and split-3 hooks.  One case also goes through JAX's
Pallas ``_bwd_kernel`` in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.ops.pallas.fused_train import FusedTrainDecoder as JaxTrain
from neural_ldpc_tpu.training.loss import multi_iteration_loss as jax_loss
from neural_ldpc_tpu_torch.ops.cuda import (
    fused_bwd_block_plain, fused_bwd_plain, fused_fwd_train_plain, k2_plan)
from neural_ldpc_tpu_torch.ops.cuda import fused_train as ft
from test_torch_fused_train import fused_value_and_grads
from test_torch_grad import WMAN as GRAD_WMAN
from test_torch_grad import assert_grads_match, build_grad_pair
from test_torch_k1_layout import BG1_Z13, BG2, DENSE, WMAN, _code, _inputs, _layout

WEIGHT_BAR = 1e-4  # of the largest |g|: the per-block partials sum in another order


def _train_inputs(lay, batch, seed):
    """Seeded channel and weights, the training forward's outputs and store
    and a seeded cotangent of the outputs."""
    chan, w = _inputs(lay, batch, seed)
    outs, store = fused_fwd_train_plain(chan, lay, *w)
    g = torch.tensor(np.random.default_rng(seed + 1).normal(size=outs.shape).astype(np.float32))
    return chan, w, store, outs, g


def assert_twin_matches(got, ref):
    """Channel gradients bit for bit; weight gradients within WEIGHT_BAR of
    the largest |g| (``chip_smoke.py::_grad_diffs``'s bar)."""
    for i, (a, b) in enumerate(zip(got, ref)):
        assert (a is None) == (b is None), i
        if a is None:
            continue
        if i >= 3:
            assert torch.equal(a, b), (i, (a - b).abs().max().item())
        else:
            scale = max(b.abs().max().item(), 1e-30)
            assert (a - b).abs().max().item() <= WEIGHT_BAR * scale, i


# (code, iterations, layout flags): wman MS with CN and UCN weights (checks of
# 14-15 edges, the 16-slot code); the bg2_qms_train decoder (BG2 QMS, CN and VN
# weights; degrees 3-10); BG2 SP; the BG1-like code at Z = 13 (Z % 4 != 0: one
# lift a VN item); the E = 1100 protograph (degrees 23-24) through K6's int8
# routing with bf16 and f32 cotangents and its split-3 routing
CASES = [
    (WMAN, 3, dict(ucn=True)),
    (BG2, 3, dict(qms=5, vn=True)),
    (BG2, 2, dict(sp=True, vn=True)),
    (BG1_Z13, 2, dict(qms=5, vn=True, ucn=True)),
    (DENSE, 2, dict(qms=5, routing="int8")),
    (DENSE, 2, dict(qms=5, vn=True, routing="int8", grad_f32=True)),
    (DENSE, 2, dict(vn=True, routing="split3")),
]
IDS = [f"{c[0][:6]}-{'-'.join(f'{k}{v}' for k, v in c[2].items())}" for c in CASES]


def _lay(code_name, n_iter, flags):
    flags = dict(flags)
    grad_f32 = flags.pop("grad_f32", False)
    lay = _layout(code_name, n_iter, **flags)
    if grad_f32:
        lay = dataclasses.replace(lay, grad_f32=True)
    return lay


@pytest.mark.parametrize("code_name,n_iter,flags", CASES, ids=IDS)
@pytest.mark.parametrize("batch", [1, 20, "W+1"])
def test_block_twin_equals_fused_bwd_plain(code_name, n_iter, flags, batch):
    """At the plan of the batch (one word a block at 1 and 20), and at
    W_max + 1 words on the plan the card takes at a large batch (W_max words
    a block, the last block partial)."""
    lay = _lay(code_name, n_iter, flags)
    plan = None
    if batch == "W+1":
        plan = k2_plan(lay, 16384)
        batch = plan.W + 1
    chan, w, store, outs, g = _train_inputs(lay, batch, seed=len(code_name) + n_iter)
    ref = fused_bwd_plain(chan, lay, *w, store, outs, g)
    assert_twin_matches(fused_bwd_block_plain(chan, lay, *w, store, outs, g, plan=plan), ref)


@pytest.mark.parametrize("threads", [32, 96])
def test_block_twin_on_forced_shapes(threads):
    """Two words a block of few threads (the walks wrap many times) on the
    bg2_qms_train decoder with UCN weights: the same gradients."""
    lay = _layout(BG2, 2, qms=5, vn=True, ucn=True)
    chan, w, store, outs, g = _train_inputs(lay, 5, seed=9)
    plan = k2_plan(lay, 5, W=2, threads=threads)
    assert (plan.W, plan.threads) == (2, threads)
    assert_twin_matches(fused_bwd_block_plain(chan, lay, *w, store, outs, g, plan=plan),
                        fused_bwd_plain(chan, lay, *w, store, outs, g))


@pytest.mark.parametrize("code_name,flags,w_max", [
    (BG2, dict(qms=5, vn=True), 2), (WMAN, dict(ucn=True), 3), (DENSE, dict(), 1)])
def test_plan_block_shape(code_name, flags, w_max):
    """At the reference's batch of 20: one word a block, 20 blocks, every
    lifted check a thread of its own (up to 1,024); at 16,384 words: W_max
    words a block (two blocks an SM in its shared memory, up to 512 threads;
    the E = 1100 protograph's word fills more than half an SM: one block of
    up to 1,024).  A
    word's region is a multiple of 16 bytes whose stride puts two words of
    a warp in other banks; QMS and UCN arrays only where the layout has
    them."""
    lay = _layout(code_name, 2, **flags)
    M, N, Z = lay.M, lay.N, lay.Z
    small, big = k2_plan(lay, 20), k2_plan(lay, 16384)
    items = max(M * Z, N * Z // 4)  # a word's lifted checks, or its VN items of 4 lifts
    assert (small.W, small.threads) == (1, min(1024, -(-items // 32) * 32))
    # two blocks an SM where a word leaves room for them, else one of up to 1,024 threads
    per_sm = ft._K2_BLOCKS_TARGET if w_max > 1 else 1
    assert (big.W, big.W_max) == (w_max, w_max)
    assert big.threads == min(1024 // per_sm, -(-w_max * items // 32) * 32)
    assert per_sm * (big.smem_bytes + ft._BLOCK_RESERVED) <= ft._SM_SMEM
    assert big.S % 4 == 0 and big.S % 32 == (Z % 32) & ~3 and big.TAB % 4 == 0
    off = big.offsets
    assert (off["gchanq"] >= 0) == (lay.qms_qbit is not None)
    assert (off["app"] >= 0) == (off["ucn"] >= 0) == lay.has_ucn
    assert off["gmsg"] + lay.E * Z <= big.S and all(v % 4 == 0 for v in off.values() if v >= 0)
    # the table: the forward's, then each edge's sorted check
    t = big.table.numpy()
    E = lay.E
    assert np.array_equal(t[:4 * N + 2 * M + 3 * E], lay.k1.table.numpy()[:4 * N + 2 * M + 3 * E])
    assert np.array_equal(t[4 * N + 2 * M + 3 * E:4 * N + 2 * M + 4 * E],
                          np.repeat(np.arange(M), [d for d, n in lay.deg_classes for _ in range(n)]))


def test_backward_footprint_is_trimmed():
    """The QMS accumulator and the UCN arrays take shared memory only where
    the layout has them: bytes a word of the bg2_qms_train decoder, and with
    UCN, and of MS without either."""
    per_word = {k: k2_plan(_layout(BG2, 2, **f), 20).S * 4 for k, f in (
        ("qms_cn_vn", dict(qms=5, vn=True)), ("qms_ucn", dict(qms=5, vn=True, ucn=True)),
        ("ms_cn", dict()))}
    nz4, ez = 52 * 16, 197 * 16
    assert per_word["ms_cn"] >= 4 * (4 * nz4 + 2 * ez)
    assert per_word["qms_cn_vn"] - per_word["ms_cn"] == 4 * nz4
    assert per_word["qms_ucn"] > per_word["qms_cn_vn"] + 4 * nz4
    assert ft._bwd_smem_per_word(42, 52, 16, 197) >= per_word["qms_ucn"]


@pytest.mark.slow
def test_block_twin_matches_jax_interpret_kernel(monkeypatch):
    """JAX's own FusedTrainDecoder (its _fwd_kernel / _bwd_kernel in
    interpret mode) against FusedTrainFn with K2's block twin as its
    backward: wman relifted at Z = 8, MS x3, cn=3 vn=2, 8 words."""
    monkeypatch.setattr(ft, "fused_bwd_plain", fused_bwd_block_plain)
    code, dec, jdec = build_grad_pair(GRAD_WMAN, 8, "MS", dict(cn=3, vn=2), 3)
    rng = np.random.default_rng(0)
    params = {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in jdec.init_params().items()}
    llr = (rng.normal(size=(8, dec.graph.N, 8)) * 4).astype(np.float32)
    bits = np.zeros((8, dec.graph.N * 8), np.float32)
    jft = JaxTrain.from_decoder(jdec, interpret=True, routing="roll", routing_dtype=jnp.float32)

    def jloss(p, x):
        return jax_loss(jft.apply(*jdec._expanded_weights(p), x), jnp.asarray(bits),
                        coeff=[0, 1, 2])

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(llr))
    _, loss, gp, gx = fused_value_and_grads(dec, params, llr, bits)
    assert_grads_match(loss, gp, gx, float(jval), {k: np.asarray(v) for k, v in jgp.items()},
                       np.asarray(jgx))
