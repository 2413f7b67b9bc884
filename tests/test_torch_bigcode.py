"""Big codes on the CPU: the device-memory kernels K3 (``fused_fwd_k3``) and
K4 (``fused_bwd_k4``) run their plain versions on CPU tensors.  Held against
JAX's ``store_space="hbm"`` ``FusedTrainDecoder`` in interpret mode (its
``_fwd_kernel_hbm`` / ``_bwd_kernel_hbm``), against the on-chip kernels'
plain versions bit for bit, and, on the BG1-like code above the on-chip
limit, against the JAX flat path, the campaign's full unroll and the plain
engine's train step.  Bars: APP 2e-5 (MS) or exact (QMS), SP 3e-5 as JAX's
own SP test; loss 1e-6; gradients atol 1e-6 / rtol 1e-4 (SP 2e-6 / 2e-4,
as ``tests/test_fused_train.py`` sets them)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes.protograph import nr_bg1_like as jax_nr_bg1_like
from neural_ldpc_tpu.models import BoostedDecoderConfig as JaxConfig
from neural_ldpc_tpu.models import BoostedNeuralDecoder as JaxDecoder
from neural_ldpc_tpu.ops.pallas.fused_train import FusedTrainDecoder as JaxTrain
from neural_ldpc_tpu.structs import DecoderType as JaxType
from neural_ldpc_tpu.structs import NodeWeightSharingConfig as JaxSharing
from neural_ldpc_tpu.training.loss import multi_iteration_loss as jax_loss
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.codes.protograph import nr_bg1_like
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.models import (
    BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz)
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, FusedTrainDecoder, fused_bwd_dm_plain, fused_bwd_k2, fused_bwd_k4,
    fused_capacity_ok, fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1d, fused_fwd_k3,
    on_chip_ok)
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
from neural_ldpc_tpu_torch.training import TrainConfig, make_train_step, multi_iteration_loss
from test_torch_decoder import TRAINED, assert_close
from test_torch_grad import BG2, GRAD_TOL, WMAN, build_grad_pair

SP_GRAD_TOL = dict(atol=2e-6, rtol=2e-4)


def _interpret_inputs(jdec, g, z, seed):
    """Params (init + 0.1 N(0, 1)) and 8 words of LLRs 4 N(0, 1) from
    ``rng(seed)``, as ``tests/test_fused_train.py`` makes them."""
    rng = np.random.default_rng(seed)
    params = {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in jdec.init_params().items()}
    llr = (rng.normal(size=(8, g.N, z)) * 4).astype(np.float32)
    if jdec.config.decoder_type == JaxType.QMS:
        llr = np.round(llr * 2) / 2  # the QMS channel grid: ties everywhere
    return params, llr, np.zeros((8, g.N * z), np.float32)


def _check_against_jax_hbm(code_name, decoder_type, sharing, n_iter, seed, tol):
    code, dec, jdec = build_grad_pair(code_name, 8, decoder_type, sharing, n_iter)
    params, llr, bits = _interpret_inputs(jdec, dec.graph, 8, seed)
    coeff = list(range(n_iter))
    jft = JaxTrain.from_decoder(jdec, interpret=True, routing="roll", store_space="hbm", bt=8)
    assert jft.meta.hbm_store

    def jloss(p, x):
        return jax_loss(jft.apply(*jdec._expanded_weights(p), x), jnp.asarray(bits), coeff=coeff)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(llr))
    jouts = np.asarray(jft.apply(*jdec._expanded_weights(jp), jnp.asarray(llr)))

    ft = FusedTrainDecoder.from_decoder(dec, store_space="hbm")
    assert ft.layout.hbm_store
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    x = torch.tensor(llr, requires_grad=True)
    before = (fused_fwd_k3.launches, fused_bwd_k4.launches)
    outs = ft.apply(*dec._expanded_weights(p), x)
    loss = multi_iteration_loss(outs, torch.tensor(bits), coeff=coeff)
    grads = torch.autograd.grad(loss, [*p.values(), x])
    assert (fused_fwd_k3.launches, fused_bwd_k4.launches) == before  # CPU: plain versions
    if decoder_type == "SP":
        np.testing.assert_allclose(outs.detach().numpy(), jouts, rtol=0, atol=3e-5)
    else:
        assert_close(decoder_type, outs.detach().numpy(), jouts)
    assert abs(float(loss.detach()) - float(jval)) < 1e-6
    for k, g in zip(p, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), err_msg=f"grad {k}", **tol)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), err_msg="grad llr", **tol)


HBM_CASES = [
    (WMAN, "MS", dict(cn=3, vn=2), 3, 0),
    (BG2, "QMS", dict(cn=3, ucn=2, vn=3), 3, 1),
]


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,seed", HBM_CASES,
                         ids=["wman-z8-MSx3-cn3-vn2", "bg2-z8-QMSx3-cn3-ucn2-vn3"])
def test_k3_k4_match_jax_interpret_hbm(code_name, decoder_type, sharing, n_iter, seed):
    _check_against_jax_hbm(code_name, decoder_type, sharing, n_iter, seed, GRAD_TOL)


@pytest.mark.slow
def test_k3_k4_match_jax_interpret_hbm_sum_product():
    _check_against_jax_hbm(WMAN, "SP", dict(cn=3), 3, 3, SP_GRAD_TOL)


# (code, type, sharing, iterations) of the forced small cases: every kernel
# mode on a code the on-chip kernels also take
FORCED = [
    (BG2, "MS", dict(cn=3, vn=3), 4),
    (BG2, "QMS", dict(cn=3, ucn=2, vn=3), 5),
]


def _forced_pair(code_name, decoder_type, sharing, n_iter, batch=7, seed=2):
    """The same decoder with the on-chip (vmem) and the device-memory (hbm)
    layout, packed weights spread around 1 and half-grid LLRs."""
    code = get_code(code_name)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, code.Z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)), device="cpu")
    rng = np.random.default_rng(seed)
    params = {k: torch.tensor((v.numpy() * (1 + 0.3 * rng.standard_normal(v.shape)))
                              .astype(np.float32)) for k, v in dec.init_params().items()}
    vmem = FusedTrainDecoder.from_decoder(dec, store_space="vmem")
    hbm = FusedTrainDecoder.from_decoder(dec, store_space="hbm")
    w = vmem.pack_weights(*dec._expanded_weights(params))
    chan = torch.tensor(np.round(rng.normal(size=(batch, code.n_bits)) * 6 + 2) / 2,
                        dtype=torch.float32)
    return vmem.layout, hbm.layout, w, chan


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter", FORCED, ids=["MS", "QMS"])
def test_k3_plain_equals_k1_plain(code_name, decoder_type, sharing, n_iter):
    """Final APP, stats, syndrome and stream of K3's plain version equal
    the on-chip kernel's bit for bit; its store slots are K1d's store[1:]."""
    lv, lh, w, chan = _forced_pair(code_name, decoder_type, sharing, n_iter)
    assert lh.hbm_store and not lv.hbm_store
    assert torch.equal(fused_fwd_k3(chan, lh, *w), fused_fwd_k1a(chan, lv, *w))
    st = fused_fwd_k1b(chan, lv, *w)
    assert torch.equal(fused_fwd_k3(chan, lh, *w, mode="stats"), st)
    app, st3 = fused_fwd_k3(chan, lh, *w, mode="syndrome")
    app1, st1 = fused_fwd_k1b(chan, lv, *w, emit_app=True)
    assert torch.equal(app, app1) and torch.equal(st3, st1) and torch.equal(st3, st)
    outs, store = fused_fwd_k3(chan, lh, *w, mode="stream")
    outs1, store1 = fused_fwd_k1d(chan, lv, *w)
    assert store.shape == (n_iter - 1, chan.shape[0], lh.E * lh.Z)
    assert torch.equal(outs, outs1) and torch.equal(store, store1[1:])
    no_store = fused_fwd_k3(chan, lh, *w, mode="stream", store=False)
    assert no_store[1] is None and torch.equal(no_store[0], outs)
    with pytest.raises(ValueError, match="unknown mode"):
        fused_fwd_k3(chan, lh, *w, mode="sampled")


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter", FORCED, ids=["MS", "QMS"])
def test_k4_plain_equals_k2_plain(code_name, decoder_type, sharing, n_iter):
    lv, lh, w, chan = _forced_pair(code_name, decoder_type, sharing, n_iter)
    outs, store = fused_fwd_k1d(chan, lv, *w)
    g = torch.randn(outs.shape, generator=torch.Generator().manual_seed(4))
    ours = fused_bwd_k4(chan, lh, *w, store[1:], outs, g)
    ref = fused_bwd_k2(chan, lv, *w, store, outs, g)
    for a, b in zip(ours, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    assert (ours[4] is None) == (decoder_type != "QMS")
    with pytest.raises(ValueError, match="store"):
        fused_bwd_k4(chan, lh, *w, store, outs, g)  # K1d's layout: one slot too many


def test_single_iteration_store_is_one_unwritten_slot():
    lv, lh, w, chan = _forced_pair(BG2, "MS", dict(cn=3), 1)
    outs, store = fused_fwd_k3(chan, lh, *w, mode="stream")
    assert store.shape == (1, chan.shape[0], lh.E * lh.Z) and not store.any()
    g = torch.randn(outs.shape, generator=torch.Generator().manual_seed(5))
    ref = fused_bwd_k2(chan, lv, *w, torch.zeros(1, *store.shape[1:]), outs, g)
    for a, b in zip(fused_bwd_dm_plain(chan, lh, *w, store, outs, g), ref):
        assert (a is None and b is None) or torch.equal(a, b)


# ---------------------------------------------------------------------------
# The BG1-like code above the on-chip limit
# ---------------------------------------------------------------------------
def _bg1(Z, n_iter=10, weights="bg1_ms10_z256_hi.npz", device="cpu"):
    """MS x n_iter, cn=3 on the BG1-like code at lift Z, with the Z = 256
    trained weights (or the first n_iter rows of them)."""
    code = nr_bg1_like(Z)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, Z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType.MS,
                             sharing=NodeWeightSharingConfig(cn=3)), device=device)
    params = load_params_npz(os.path.join(TRAINED, weights), device)
    return code, dec, {k: v[:n_iter] for k, v in params.items()}


def test_bg1_z32_auto_selects_k3_and_matches_jax_flat():
    code, dec, params = _bg1(32)
    fused = FusedMinsumDecoder.from_decoder(dec, params)
    assert fused.layout.hbm_store and not on_chip_ok(dec.graph)
    rng = np.random.default_rng(9)
    x = (2 * (1 + 0.8 * rng.standard_normal((4, code.N, 32))) / 0.64).astype(np.float32)
    ours = fused(torch.tensor(x)).numpy()
    jcode = jax_nr_bg1_like(32)
    jdec = JaxDecoder(JaxTannerGraph.from_basegraph(jcode.basegraph, 32),
                      JaxConfig(n_iterations=10, decoder_type=JaxType.MS,
                                sharing=JaxSharing(cn=3), matmul_precision="highest"))
    theirs = np.asarray(jdec.apply({k: jnp.asarray(v.numpy()) for k, v in params.items()},
                                   jnp.asarray(x))[-1])
    assert ours.shape == (4, code.n_bits)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-5)


def test_bg1_z32_campaign_early_exit_equals_full_unroll():
    code, dec, params = _bg1(32)
    channel = AWGNChannel(code, ChannelConfig(snr_db=(1.5,)), device="cpu")
    base = dict(batch_size=16, max_words_per_snr=32, min_frame_errors=0, seed=3,
                engine="fused", sync_every_batches=2, early_exit_auto_guard=False,
                kernel_channel_sampling="auto")
    runs, escalations = [], []
    for extra in ({}, dict(early_exit_iters=5, early_exit_capacity=12),
                  dict(early_exit_iters=5, early_exit_capacity=1)):
        camp = MonteCarloCampaign(dec, params, channel, CampaignConfig(**base, **extra))
        assert camp.fused and not camp.kernel_sampling  # the big code reads its channel
        assert camp.decoders["full"].layout.hbm_store
        runs.append(camp.run(verbose=False)[1.5])
        escalations.append(int(camp.escalations[0]))
    assert runs[0]["words"] == 32 and runs[0]["fer"][0] > 0 and escalations[1] > 0
    assert runs[0] == runs[1] == runs[2]


def test_bg1_z32_fused_train_step_equals_the_plain_step():
    """One step of the cross-lift recipe (MS x4, cn=3, all-zero words at 3.0
    / 3.5 dB, lr 2e-3) on each engine: loss within 1e-6; params within 1e-6
    where the plain engine's |g| > 1e-5 and within 2 lr elsewhere."""
    code, dec, params = _bg1(32, n_iter=4)
    channel = AWGNChannel(code, ChannelConfig(snr_db=(3.0, 3.5)), device="cpu")
    llr, bits = channel.sample_mixed(channel.generator(7), 6, all_zero=True)
    lr, res = 2e-3, {}
    for engine in ("xla", "fused"):
        init, step = make_train_step(dec, TrainConfig(engine=engine))
        res[engine] = step(params, init(params), llr, bits, lr)
    assert abs(res["xla"][2].item() - res["fused"][2].item()) < 1e-6
    pg = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = multi_iteration_loss(dec.apply(pg, llr), bits, coeff=list(range(4)))
    grads = dict(zip(pg, torch.autograd.grad(loss, list(pg.values()))))
    for k in params:
        diff = (res["xla"][0][k] - res["fused"][0][k]).abs()
        big = grads[k].abs() > 1e-5
        assert diff[big].max().item() <= 1e-6 and diff.max().item() <= 2 * lr, k


# ---------------------------------------------------------------------------
# Capacity and selection rules
# ---------------------------------------------------------------------------
def _bg1_graph(Z):
    return TannerGraph.from_basegraph(nr_bg1_like(Z).basegraph, Z)


@pytest.mark.parametrize("Z,on_chip", [(22, True), (23, False), (384, False)])
def test_store_space_follows_the_on_chip_limit(Z, on_chip):
    g = _bg1_graph(Z)
    assert on_chip_ok(g) == on_chip and fused_capacity_ok(g)
    assert FusedTrainDecoder(g, 2, device="cpu").layout.hbm_store == (not on_chip)
    assert FusedMinsumDecoder(g, 2, device="cpu").layout.hbm_store == (not on_chip)
    assert FusedTrainDecoder(g, 2, store_space="hbm", device="cpu").layout.hbm_store
    if on_chip:
        assert not FusedTrainDecoder(g, 2, store_space="vmem", device="cpu").layout.hbm_store
        return
    with pytest.raises(ValueError, match="too large for VMEM-resident messages"):
        FusedTrainDecoder(g, 2, store_space="vmem", device="cpu")
    with pytest.raises(ValueError, match="sample_channel is VMEM-resident only"):
        FusedMinsumDecoder(g, 2, emit_stats=True, sample_channel=True, device="cpu")


def test_big_code_paths_raise_no_missing_kernel():
    """The campaign on a big code takes the fused engine: in-kernel sampling
    falls back to the read channel under "auto" and raises under "on", as
    JAX's campaign does; matmul routing (K6) runs on chip only, so it refuses
    the device-memory kernels with JAX's message."""
    code = nr_bg1_like(64)
    dec = BoostedNeuralDecoder(TannerGraph.from_basegraph(code.basegraph, 64),
                               BoostedDecoderConfig(n_iterations=2), device="cpu")
    channel = AWGNChannel(code, ChannelConfig(snr_db=(2.0,)), device="cpu")
    camp = MonteCarloCampaign(dec, dec.init_params(), channel, CampaignConfig(
        engine="fused", kernel_channel_sampling="auto"))
    assert camp.fused and not camp.kernel_sampling
    with pytest.raises(ValueError, match="VMEM-resident only"):
        MonteCarloCampaign(dec, dec.init_params(), channel, CampaignConfig(
            engine="fused", kernel_channel_sampling="on"))
    with pytest.raises(ValueError, match="store_space='hbm' requires roll routing"):
        FusedTrainDecoder(_bg1_graph(64), 2, routing="matmul", device="cpu")
    with pytest.raises(ValueError, match="unknown store_space"):
        FusedTrainDecoder(_bg1_graph(64), 2, store_space="l2", device="cpu")
