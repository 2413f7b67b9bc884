"""The training path of the fused decoder on the CPU: ``FusedTrainDecoder``
with JAX's defaults runs ``FusedTrainFn``, whose forward (K1d) and backward
(K2) run their plain versions on CPU tensors.  Held against the JAX flat
path (outputs, loss and gradients for the weights and the LLRs) and, on one
case, against JAX's own ``FusedTrainDecoder`` in interpret mode.  Bars: APP
2e-5 (MS, SP) or exact (QMS); loss 1e-6; gradients atol 1e-6 / rtol 1e-4.
The loss head of the fused BCE step (``fused_bce_head``, its plain version
here) against ``ties.clip`` + ``multi_iteration_loss`` under autograd and
against ``jax.value_and_grad`` of the JAX loss on ``jnp.clip``, and the train
step that takes it against the step that composes them; K1d's loss mode
(its plain twin here), which computes the head's arithmetic on the stream,
against the head, and the rules that route a step to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.ops.pallas.fused_train import FusedTrainDecoder as JaxTrain
from neural_ldpc_tpu.training.loss import multi_iteration_loss as jax_loss
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.codes.protograph import synth_dense
from neural_ldpc_tpu_torch.ops import ties
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, FusedTrainDecoder, fused_bce_head, fused_bce_head_plain, fused_bwd_k2,
    fused_bwd_plain, fused_fwd_k1d, fused_fwd_plain, fused_fwd_train_plain)
from neural_ldpc_tpu_torch.ops.cuda import fused_train as fused_train_mod
from neural_ldpc_tpu_torch.structs import LossType
from neural_ldpc_tpu_torch.training import (
    TrainConfig, make_eval_step, make_train_step, multi_iteration_loss)
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


# (name, iterations, window, etha, labels): outputs on the QMS 0.5 grid, a
# quarter of them exactly 0, some exactly at +-clip and beyond
HEAD_CASES = [
    ("ties", 4, (0, 4), 1.0, "random"),
    ("etha", 4, (0, 4), 0.7, "random"),
    ("window", 6, (2, 5), 0.9, "random"),
    ("labels_one", 3, (0, 3), 1.0, "ones"),
]


@pytest.fixture
def head_runs(monkeypatch):
    """The loss head's runs on CPU tensors, by a spy on its plain version
    (``fused_bce_head.launches`` counts launches on the card only)."""
    runs = []
    plain = fused_train_mod.fused_bce_head_plain

    def spy(*args):
        runs.append(args)
        return plain(*args)

    monkeypatch.setattr(fused_train_mod, "fused_bce_head_plain", spy)
    return runs


@pytest.fixture
def k1d_runs(monkeypatch):
    """K1d's loss-mode runs on CPU tensors, by a spy on its plain twin."""
    runs = []
    plain = fused_train_mod.fused_fwd_loss_plain

    def spy(*args):
        runs.append(args)
        return plain(*args)

    monkeypatch.setattr(fused_train_mod, "fused_fwd_loss_plain", spy)
    return runs


@pytest.mark.parametrize("name,n_iter,window,etha,labels", HEAD_CASES,
                         ids=[c[0] for c in HEAD_CASES])
def test_loss_head_matches_clip_and_loss_under_autograd(name, n_iter, window, etha, labels,
                                                        head_runs):
    """The head's loss and ``g_outs`` (CPU tensors: its plain version) are
    autograd's through ``ties.clip`` and ``multi_iteration_loss``, and
    ``jax.value_and_grad`` of the JAX package's loss on ``jnp.clip``: the
    loss within rtol 1e-6 (the head sums every term in float64, the
    compositions take per-iteration float32 means), the gradient within
    1e-6 of its largest entry; at the ties exactly the JAX slopes (0 beyond
    the clip, half at a bound, -y times the weight at logit 0) and 0 outside
    the window.  A CPU call launches nothing, so ``.launches`` stays put."""
    lo, hi = -7.5, 7.5
    gen = torch.Generator().manual_seed(3)
    B, NZ = 5, 48
    outs = torch.round(torch.randn(n_iter, B, NZ, generator=gen) * 12) / 2
    outs[:, :, ::4] = 0.0
    outs[:, 0, 1:4] = torch.tensor([lo, hi, hi + 0.5])
    bits = (torch.ones(B, NZ) if labels == "ones" else
            (torch.rand(B, NZ, generator=gen) < 0.5).float())
    i0, i1 = window
    coeffs = list(range(i1 - i0))
    x = outs.clone().requires_grad_(True)
    ref = multi_iteration_loss(ties.clip(x, lo, hi)[i0:i1], bits, LossType.BCE, etha, coeffs)
    (g_ref,) = torch.autograd.grad(ref, x)
    jval, jg = jax.value_and_grad(
        lambda o: jax_loss(jnp.clip(o, lo, hi)[i0:i1], jnp.asarray(bits.numpy()), etha=etha,
                           coeff=coeffs))(jnp.asarray(outs.numpy()))
    before = fused_bce_head.launches
    loss, g = fused_bce_head(outs, bits, lo, hi, i0, i1, etha, coeffs)
    assert fused_bce_head.launches == before and len(head_runs) == 1
    assert loss.shape == () and g.shape == outs.shape
    for ref_loss, ref_g in ((ref.detach(), g_ref),
                            (torch.tensor(float(jval)), torch.tensor(np.asarray(jg)))):
        torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=0.0)
        torch.testing.assert_close(g, ref_g, rtol=0.0, atol=1e-6 * ref_g.abs().max().item())
    assert not g[:i0].any() and not g[i1:].any()
    assert (outs.abs() > hi).any() and not g[outs.abs() > hi].any()
    w = etha ** coeffs[0] / (sum(etha ** c for c in coeffs) * B * NZ)
    zero = outs[i0] == 0
    torch.testing.assert_close(g[i0][zero], w * bits[zero], rtol=1e-6, atol=0.0)
    at_bound = outs[i0].abs() == hi
    assert at_bound.any()
    # a clip that holds the bound inside gives the same arithmetic at slope 1
    _, g_wide = fused_bce_head(outs, bits, lo - 1.0, hi + 1.0, i0, i1, etha, coeffs)
    assert torch.equal(g[i0][at_bound], 0.5 * g_wide[i0][at_bound])


@pytest.mark.parametrize("name,n_iter,window,etha,labels", HEAD_CASES,
                         ids=[c[0] for c in HEAD_CASES])
def test_k1d_loss_mode_is_the_head_on_the_stream(name, n_iter, window, etha, labels, head_runs,
                                                 k1d_runs):
    """K1d's loss mode on CPU tensors (its plain twin): g_outs equals
    ``fused_bce_head_plain`` on ``fused_fwd_train_plain``'s stream bit for
    bit, the store that stream's, and the loss is the clip and
    ``multi_iteration_loss``'s within rtol 1e-5.  BG2 QMS with CN and VN
    weights and the clip at 7.5: the outputs lie on the 0.5 grid, and the
    window holds some exactly at 0 and at either bound.  A CPU call launches
    nothing."""
    lo, hi = -7.5, 7.5
    graph = TannerGraph.from_basegraph(get_code(BG2).basegraph, 16)
    ft = FusedTrainDecoder(graph, n_iter, clip=(lo, hi), qms_qbit=5, has_vn_w=True, device="cpu")
    lay = ft.layout
    gen = torch.Generator().manual_seed(3)
    w = ft.pack_weights(0.5 + torch.rand(n_iter, graph.E, generator=gen), None,
                        0.5 + torch.rand(n_iter, graph.N, generator=gen))
    B, NZ = 6, lay.N * lay.Z
    chan = torch.round(torch.randn(B, NZ, generator=gen) * 12) / 2
    bits = (torch.ones(B, NZ) if labels == "ones" else
            (torch.rand(B, NZ, generator=gen) < 0.5).float())
    i0, i1 = window
    coeffs = list(range(i1 - i0))
    outs, store = fused_fwd_train_plain(chan, lay, *w)
    x = outs[i0:i1]
    assert (x == 0).any() and (x == lo).any() and (x == hi).any()
    want_loss, want_g = fused_bce_head_plain(outs, bits, lo, hi, i0, i1, etha, coeffs)
    before = (fused_fwd_k1d.launches, fused_fwd_k1d.loss_launches)
    g, st, loss = fused_fwd_k1d(chan, lay, *w, loss=(bits, i0, i1, etha, coeffs))
    assert (fused_fwd_k1d.launches, fused_fwd_k1d.loss_launches) == before
    assert len(k1d_runs) == 1 and len(head_runs) == 1  # the twin ran the head once
    assert torch.equal(g.view(torch.int32), want_g.view(torch.int32)) and torch.equal(st, store)
    ref = multi_iteration_loss(ties.clip(outs, lo, hi)[i0:i1], bits, LossType.BCE, etha, coeffs)
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0.0)


def test_k1d_loss_mode_keeps_the_plan_and_refuses_what_it_cannot_run():
    """K1d's loss mode keeps the forward kernel's blocks an SM: its block
    of ``loss_W`` words (the labels and a double a thread added) fits the
    shared memory of ``blocks_target`` blocks, and at BG2's Z = 16 (the
    benchmark's training cell) it keeps all 3 words.  A UCN layout, a
    device-memory one, a code with a check of more than 32 edges, a step
    without the store and a window beyond ``_LOSS_MAX_ITERS`` are
    refused."""
    per_sm = fused_train_mod._SM_SMEM
    for code_name, z, kw in ((BG2, 16, {}), (BG2, 8, {}), (WMAN, 24, {}), (WMAN, 8, {}),
                             (WMAN, 24, dict(has_ucn=True))):
        graph = TannerGraph.from_basegraph(get_code(code_name).basegraph, z)
        lay = FusedTrainDecoder(graph, 4, device="cpu", **kw).layout
        plan = lay.k1
        assert 1 <= plan.loss_W <= plan.W
        assert (per_sm // (plan.loss_smem_bytes + fused_train_mod._BLOCK_RESERVED)
                >= plan.blocks_target)
        assert fused_train_mod.k1d_loss_ok(lay) == (not kw)
    bg2 = TannerGraph.from_basegraph(get_code(BG2).basegraph, 16)
    lay = FusedTrainDecoder(bg2, 20, qms_qbit=5, has_vn_w=True, device="cpu").layout
    assert (lay.k1.W, lay.k1.loss_W, lay.k1.blocks_target) == (3, 3, 3)
    chan, bits = torch.zeros(2, lay.N * lay.Z), torch.zeros(2, lay.N * lay.Z)
    w = (torch.ones(20, lay.E), None, torch.ones(20, lay.N))
    with pytest.raises(ValueError, match="store"):
        fused_fwd_k1d(chan, lay, *w, store=False, loss=(bits, 0, 20, 1.0, range(20)))
    wide = FusedTrainDecoder(bg2, 40, device="cpu").layout
    with pytest.raises(ValueError, match="at most"):
        fused_fwd_k1d(chan, wide, torch.ones(40, wide.E), loss=(bits, 0, 40, 1.0, range(40)))
    ucn = FusedTrainDecoder(bg2, 4, has_ucn=True, device="cpu").layout
    with pytest.raises(ValueError, match="UCN"):
        fused_fwd_k1d(chan, ucn, torch.ones(4, ucn.E), torch.ones(4, ucn.E),
                      loss=(bits, 0, 4, 1.0, range(4)))
    hbm = FusedTrainDecoder(bg2, 4, store_space="hbm", device="cpu").layout
    assert not fused_train_mod.k1d_loss_ok(hbm)
    # a check of 41 edges: the forward's looped code, which has no loss instantiation
    dense = TannerGraph.from_basegraph(synth_dense(3, 12, 60, 400), 4)
    lay = FusedTrainDecoder(dense, 4, device="cpu").layout
    assert lay.max_degree > 32 and not lay.hbm_store and not fused_train_mod.k1d_loss_ok(lay)


# (code, decoder type, sharing, iterations, TrainConfig fields, whether K1d's
# loss mode may run: else it is refused, as a layout it cannot take refuses
# it, and the head runs on K1d's stream)
STEP_CASES = [
    (BG2, "QMS", dict(cn=3, vn=3), 4, dict(), False),
    (WMAN, "MS", dict(cn=3, ucn=2, vn=2), 4, dict(etha=0.8, training_iter_start=1,
                                                  training_iter_end=3), False),
    (BG2, "QMS", dict(cn=3, vn=3), 4, dict(), True),
    (BG2, "MS", dict(cn=3, vn=3), 4, dict(etha=0.8, training_iter_start=1,
                                          training_iter_end=3), True),
    (WMAN, "MS", dict(cn=3, vn=2), 4, dict(etha=0.9, training_iter_start=1), True),
]


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,fields,k1d", STEP_CASES,
                         ids=["bg2-qms", "wman-ms-ucn-window", "bg2-qms-k1d",
                              "bg2-ms-window-k1d", "wman-ms-window-k1d"])
def test_fused_bce_step_matches_the_composition(code_name, decoder_type, sharing, n_iter, fields,
                                                k1d, head_runs, k1d_runs, monkeypatch):
    """The loss head against the clip and ``multi_iteration_loss`` under
    autograd on the fused decoder.  (1) The loss within rtol 1e-6 and its
    gradients for the expanded weights [I, E] / [I, N] (one an edge or VN,
    before the sharing sums them) and the LLRs within 1e-6 of their largest
    entry: the head sums every term in one float64 sum and rounds each
    iteration's factor w_i / (sum w * B*N*Z) once, where autograd rounds it
    in three steps.  With ``k1d`` K1d's loss mode computes the loss and its
    gradient (the layouts take it), without it the head.  (2) Three train
    steps with one label a bit (the same path) against the same steps with the
    labels given per iteration (the composition): losses within rtol 1e-6,
    both Adam moments within 1e-3 of each leaf's largest entry, params within
    1e-5 (1% of lr).  A shared
    weight's gradient sums its edges' terms, which cancel to a few
    thousandths of their size: that magnifies (1)'s rounding about 300
    times."""
    code, dec, jdec = build_grad_pair(code_name, 8 if code_name == WMAN else None,
                                      decoder_type, sharing, n_iter)
    # random codewords where the generator matrix is the code's own lift
    params, llr, bits = grad_inputs(code, dec, jdec, batch=6, random_codewords=code_name == BG2)
    llr, bits = torch.tensor(llr), torch.tensor(bits)
    cfg = TrainConfig(engine="fused", **fields)
    i0, i1 = cfg.training_iter_start, cfg.training_iter_end or n_iter
    coeffs = list(range(i1 - i0))
    ft = FusedTrainDecoder.from_decoder(dec)
    expanded = [w if w is None else w.detach().requires_grad_(True) for w in
                dec._expanded_weights({k: torch.tensor(v) for k, v in params.items()})]
    x = llr.clone().requires_grad_(True)
    leaves = [w for w in expanded if w is not None] + [x]
    if not k1d:
        monkeypatch.setattr(fused_train_mod, "k1d_loss_ok", lambda lay: False)
    fwd = ft.train_forward(*expanded, x, bits, (i0, i1, cfg.etha, coeffs))
    assert (fwd.outs is None) == k1d and len(k1d_runs) == int(k1d)
    head = ft.bce_loss(fwd)
    comp = multi_iteration_loss(ft.apply(*expanded, x)[i0:i1], bits, LossType.BCE, cfg.etha,
                                coeffs)
    torch.testing.assert_close(head, comp, rtol=1e-6, atol=0.0)
    for a, b in zip(torch.autograd.grad(head, leaves), torch.autograd.grad(comp, leaves)):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-6 * b.abs().max().item())

    init, step = make_train_step(dec, cfg)
    runs = []
    k1d_before = len(k1d_runs)
    for labels in (bits, bits[None].expand(i1 - i0, *bits.shape)):
        before = len(head_runs)
        p = {k: torch.tensor(v) for k, v in params.items()}
        opt, out = init(p), []
        for _ in range(3):
            p, opt, loss = step(p, opt, llr, labels, 1e-3)
            out.append((p, opt, loss))
        runs.append((out, len(head_runs) - before))
    (head, n_head), (comp, n_comp) = runs
    assert (n_head, n_comp) == (3, 0)
    assert len(k1d_runs) - k1d_before == (3 if k1d else 0)
    for (p1, o1, l1), (p0, o0, l0) in zip(head, comp):
        torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0.0)
        for k in p0:
            torch.testing.assert_close(p1[k], p0[k], rtol=0.0, atol=1e-5)
            for a, b in ((o1.mu[k], o0.mu[k]), (o1.nu[k], o0.nu[k])):
                torch.testing.assert_close(a, b, rtol=0.0, atol=1e-3 * b.abs().max().item())
        assert torch.equal(o1.count, o0.count)


# (code, lift, sharing): the on-chip family without UCN, with UCN, and the
# BG1-like code at Z = 24, which only the device-memory kernels (K3, K4) hold
ROUTE_LAYOUTS = {"wman": (WMAN, 8, dict(cn=3)), "wman-ucn": (WMAN, 8, dict(cn=3, ucn=2)),
                 "bg1-k3": ("nr_bg1_like_z384", 24, dict(cn=3))}


@pytest.mark.parametrize("loss_type,engine,per_step,layout,k1d_per_step", [
    (LossType.BCE, "fused", 1, "wman", 1), (LossType.SoftBEROnAllZero, "fused", 0, "wman", 0),
    (LossType.FEROnAllZero, "fused", 0, "wman", 0), (LossType.BCE, "xla", 0, "wman", 0),
    (LossType.BCE, "eval", 0, "wman", 0), (LossType.BCE, "fused", 1, "wman-ucn", 0),
    (LossType.BCE, "fused", 1, "bg1-k3", 0), (LossType.BCE, "per-iteration", 0, "wman", 0)],
    ids=["bce-fused", "softber-fused", "fer-fused", "bce-xla", "bce-eval", "bce-fused-ucn",
         "bce-fused-k3", "bce-fused-per-iteration-labels"])
def test_loss_head_engages_only_on_the_fused_bce_step(loss_type, engine, per_step, layout,
                                                      k1d_per_step, head_runs, k1d_runs):
    """The head runs once a step on the fused BCE step (a spy on its plain
    version, which CPU tensors take) and never on the SoftBER and FER
    losses, the plain engine and the eval step, which keep the
    composition.  On the on-chip family without UCN K1d's loss mode
    computes it (a spy on its plain twin, which runs the head's arithmetic
    on the stream): with UCN, on the device-memory kernels and with labels
    given per iteration it does not (the head, or the composition)."""
    code_name, z, sharing = ROUTE_LAYOUTS[layout]
    code, dec, jdec = build_grad_pair(code_name, z, "MS", sharing, 3)
    params, llr, bits = grad_inputs(code, dec, jdec, batch=4)
    llr, bits = torch.tensor(llr), torch.tensor(bits)
    if engine == "per-iteration":
        engine, bits = "fused", bits[None].expand(3, *bits.shape)
    p = {k: torch.tensor(v) for k, v in params.items()}
    cfg = TrainConfig(engine="xla" if engine == "eval" else engine, loss_type=loss_type)
    if engine == "eval":
        step = make_eval_step(dec, cfg)
        for _ in range(2):
            loss, _ = step(p, llr, bits)
    else:
        init, step = make_train_step(dec, cfg)
        opt = init(p)
        for _ in range(2):
            p, opt, loss = step(p, opt, llr, bits, 1e-3)
    assert torch.isfinite(loss)
    assert len(head_runs) == 2 * per_step
    assert len(k1d_runs) == 2 * k1d_per_step
