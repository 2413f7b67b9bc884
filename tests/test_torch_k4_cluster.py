"""The cluster K4 (``csrc/fused_bwd_cl.cu``) on the CPU: its split, its rule
and its plain twin ``fused_bwd_cl_plain``, which runs the kernel's layout
(rank-local rows in the VN's frame, replicas, per-word weight partials) in
its phase order.  The twin is held to ``fused_bwd_dm_plain`` (the
device-memory K4's plain version, itself equal to K2's on-chip plain
version) bit for bit on the channel gradients and within 1e-4 of max |g| on
the weight gradients (their sums over lifts and words run in another
order), on every split size forced from 1 to 3 CTAs; and, through the
autograd join, to the JAX flat path's gradients on the BG1-like code at
Z = 32 at atol 1e-6 / rtol 1e-4 (``tests/test_fused_train.py``'s bars)."""

import dataclasses

import numpy as np
import pytest
import torch

from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes.protograph import nr_bg1_like as jax_nr_bg1_like
from neural_ldpc_tpu.models import BoostedDecoderConfig as JaxConfig
from neural_ldpc_tpu.models import BoostedNeuralDecoder as JaxDecoder
from neural_ldpc_tpu.structs import DecoderType as JaxType
from neural_ldpc_tpu.structs import NodeWeightSharingConfig as JaxSharing
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.codes.protograph import nr_bg1_like
from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedTrainDecoder, bwd_cluster_occupancy, bwd_cluster_split, fused_bwd_cl_plain,
    fused_bwd_dm_plain, fused_bwd_k4, fused_fwd_k3)
from neural_ldpc_tpu_torch.ops.cuda import fused_train as fused_train_mod
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
from neural_ldpc_tpu_torch.training import multi_iteration_loss
from test_torch_bigcode import _forced_pair
from test_torch_grad import BG2, WMAN, assert_grads_match, grad_inputs, jax_value_and_grads

SMEM_OPTIN = 232448  # dynamic shared memory a CTA can opt into on the H100


def _bg1_pair(Z, decoder_type, sharing, n_iter, batch=4, seed=3):
    """The BG1-like code at lift Z on the device-memory layout: (layout,
    packed weights spread around 1, LLRs on the half grid)."""
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(nr_bg1_like(Z).basegraph, Z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)), device="cpu")
    rng = np.random.default_rng(seed)
    params = {k: torch.tensor((v.numpy() * (1 + 0.3 * rng.standard_normal(v.shape)))
                              .astype(np.float32)) for k, v in dec.init_params().items()}
    ft = FusedTrainDecoder.from_decoder(dec)
    chan = torch.tensor(np.round(rng.normal(size=(batch, dec.graph.N * Z)) * 6 + 2) / 2,
                        dtype=torch.float32)
    return ft.layout, ft.pack_weights(*dec._expanded_weights(params)), chan


def _assert_twin_equals_dm_plain(lay, w, chan, split, seed=4):
    outs, store = fused_fwd_k3(chan, lay, *w, mode="stream")
    g = torch.randn(outs.shape, generator=torch.Generator().manual_seed(seed))
    ours = fused_bwd_cl_plain(chan, lay, *w, store, outs, g, split=split)
    ref = fused_bwd_dm_plain(chan, lay, *w, store, outs, g)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert (a is None) == (b is None), i
        if a is None:
            continue
        if i >= 3:  # g_chan, g_chanq
            assert torch.equal(a, b), i
        else:  # g_cnw, g_vnw, g_ucnw
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item(), i
    return ours


# (code, type, sharing, iterations): every decoder kind and weight kind on
# codes the on-chip kernels also take, forced to the device-memory layout
FORCED = [
    (BG2, "MS", dict(cn=3, vn=3), 4),
    (BG2, "QMS", dict(cn=3, ucn=2, vn=3), 5),
    (BG2, "SP", dict(cn=1, vn=2), 3),
    (WMAN, "MS", dict(cn=3, ucn=2), 3),
    (BG2, "MS", dict(cn=3), 1),
]


@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter", FORCED,
                         ids=["bg2-MS-cn-vn", "bg2-QMS-cn-ucn-vn", "bg2-SP-cn-vn", "wman-MS-cn-ucn",
                              "bg2-MS-I1"])
def test_twin_equals_device_memory_plain_on_forced_codes(code_name, decoder_type, sharing,
                                                         n_iter, C):
    _, lh, w, chan = _forced_pair(code_name, decoder_type, sharing, n_iter)
    assert lh.hbm_store and lh.k4_kernel == "cluster"
    _assert_twin_equals_dm_plain(lh, w, chan, bwd_cluster_split(lh, C))


# the BG1-like code at Z = 32, above the on-chip limit: MS with CN weights,
# QMS with CN, UCN and VN weights, SP with CN and VN weights
BG1_CASES = [("MS", dict(cn=3), 4), ("QMS", dict(cn=3, ucn=2, vn=3), 3),
             ("SP", dict(cn=1, vn=2), 3)]


@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("decoder_type,sharing,n_iter", BG1_CASES, ids=["MS", "QMS", "SP"])
def test_twin_equals_device_memory_plain_on_bg1_z32(decoder_type, sharing, n_iter, C):
    lay, w, chan = _bg1_pair(32, decoder_type, sharing, n_iter)
    assert lay.hbm_store and not fused_train_mod.on_chip_ok(
        TannerGraph.from_basegraph(nr_bg1_like(32).basegraph, 32))
    split = bwd_cluster_split(lay, C)
    assert split.C == C and len(split.chk_b) == C + 1
    _assert_twin_equals_dm_plain(lay, w, chan, split)


def test_twin_defaults_to_the_layout_split_and_refuses_a_layout_without_one():
    lay, w, chan = _bg1_pair(23, "MS", dict(cn=3), 3)
    assert lay.bwd_cluster is not None and lay.bwd_cluster.C == 1
    _assert_twin_equals_dm_plain(lay, w, chan, None)
    outs, store = fused_fwd_k3(chan, lay, *w, mode="stream")
    bare = dataclasses.replace(lay, bwd_cluster=None)
    assert bare.k4_kernel == "device-memory"
    with pytest.raises(ValueError, match="device-memory kernel"):
        fused_bwd_cl_plain(chan, bare, *w, store, outs, torch.zeros_like(outs))


# ---------------------------------------------------------------------------
# The split and the cluster rule
# ---------------------------------------------------------------------------
def _bg1_layout(Z, **kw):
    return FusedTrainDecoder(TannerGraph.from_basegraph(nr_bg1_like(Z).basegraph, Z), 10,
                             device="cpu", **kw).layout


@pytest.mark.parametrize("Z,ucn,C", [(23, False, 1), (32, False, 1), (256, False, 6),
                                     (256, True, 7), (384, False, None), (384, True, None)])
def test_k4_cluster_size_rule(Z, ucn, C):
    """C is the smallest cluster whose CTAs' shared memory (232,448 B each)
    holds its part of the word's backward: two rows of its edges (the store
    slot and the message cotangent carry), two replicas of its checks' VNs
    (three with UCN), the accumulators of its work VNs and the table.  At
    Z = 256 that is 6 CTAs (7 with UCN); at Z = 384 no cluster of 8 holds
    it and K4 is the device-memory kernel, while K3's cluster still holds
    the forward."""
    lay = _bg1_layout(Z, has_ucn=ucn)
    assert lay.hbm_store and lay.has_ucn == ucn
    if C is None:
        assert lay.bwd_cluster is None and lay.k4_kernel == "device-memory"
        assert bwd_cluster_split(lay, 8).smem_bytes > SMEM_OPTIN
        assert lay.k3_kernel == "cluster"
        return
    split = lay.bwd_cluster
    assert lay.k4_kernel == "cluster" and split.C == C
    assert split.smem_bytes <= SMEM_OPTIN
    assert C == 1 or bwd_cluster_split(lay, C - 1).smem_bytes > SMEM_OPTIN
    # the backward holds more a rank than the forward: K3's split is smaller
    assert lay.cluster.C < C or C == 1


def test_k4_split_regions_in_bytes():
    """The byte count is the kernel's: 2 MZ + 2 RZ (3 with UCN) + one to
    three accumulator regions of WZ + the UCN flag bytes + the table."""
    for kw, acc in ((dict(), 1), (dict(qms_qbit=5, has_vn_w=True), 3),
                    (dict(has_vn_w=True), 2), (dict(qms_qbit=5), 1)):
        split = bwd_cluster_split(_bg1_layout(32, **kw), 2)
        assert split.accumulators == acc
        assert split.smem_bytes == 4 * (2 * split.MZ + 2 * split.RZ + acc * split.WZ + split.TAB)
    split = bwd_cluster_split(_bg1_layout(32, has_ucn=True), 2)
    assert split.smem_bytes == 4 * (2 * split.MZ + 3 * split.RZ + split.WZ + split.TAB
                                    + -(-split.FZ // 4))


@pytest.mark.parametrize("case", ["bg2-C1", "bg2-C3", "wman-C5", "bg1z256", "bg1z256-ucn"])
def test_k4_split_covers_every_check_edge_and_vn_copy_once(case):
    """Every lifted check with its edges on exactly one rank (its rows and
    carry there), every VN's work on one rank, every edge copy reading the
    replica slot of its own VN copy on its own rank, and every replica slot
    filled by one push."""
    if case.startswith("bg1"):
        lay = _bg1_layout(256, has_ucn=case.endswith("ucn"))
        split = lay.bwd_cluster
    else:
        code = get_code(BG2 if case.startswith("bg2") else WMAN)
        g = TannerGraph.from_basegraph(code.basegraph, code.Z)
        lay = FusedTrainDecoder(g, 2, store_space="hbm", device="cpu").layout
        split = bwd_cluster_split(lay, int(case[-1]))
    M, N, E, Z, C = lay.M, lay.N, lay.E, lay.Z, split.C
    S = 2 * split.MZ + (3 if split.ucn else 2) * split.RZ
    for b, n in ((split.chk_b, M), (split.wv_b, N), (split.k_b, E)):
        assert len(b) == C + 1 and b[0] == 0 and b[-1] == n and list(b) == sorted(b)
    assert list(split.k_b) == [int(lay.tables[c]) if c < M else E for c in split.chk_b]
    mloc, rloc, vidx, need_q, need_dst = (a.numpy() for a in fused_train_mod._bwd_cluster_addresses(
        lay, split, "cpu"))
    owner = np.repeat(np.searchsorted(split.k_b, np.arange(E), side="right") - 1, Z)
    assert np.unique(mloc).size == E * Z and (mloc % S < split.MZ).all()
    assert (mloc // S == owner).all()  # each row on its check's rank
    live = vidx[vidx >= 0]
    assert live.size == E * Z and (np.sort(live) == np.sort(mloc)).all()
    assert (rloc // S == owner).all()
    assert ((rloc % S >= 2 * split.MZ) & (rloc % S < 2 * split.MZ + split.RZ)).all()
    filled = dict(zip(need_dst.tolist(), need_q.tolist()))
    assert len(filled) == need_dst.size
    assert [filled[i] for i in rloc.tolist()] == lay.route_idx.tolist()
    # the work VNs' accumulators fit WZ, the checks' flags FZ
    assert max(b - a for a, b in zip(split.wv_b, split.wv_b[1:])) * Z == split.WZ
    assert max(b - a for a, b in zip(split.chk_b, split.chk_b[1:])) * Z == split.FZ


def test_k4_cluster_the_card_cannot_place_raises(monkeypatch):
    """A cluster the card cannot place raises; K4 never falls back to the
    device-memory kernel."""
    lay = _bg1_layout(256)
    key = (None, fused_train_mod._mode_flags(lay), 6, lay.bwd_cluster.smem_bytes)
    monkeypatch.setitem(fused_train_mod._bwd_cluster_answers, key, dict(clusters=0))
    with pytest.raises(RuntimeError, match="cannot place a cluster of 6 CTAs.*K4"):
        bwd_cluster_occupancy(lay, torch.device("cpu"))


def test_cpu_k4_keeps_the_device_memory_plain_version(monkeypatch):
    """On CPU tensors ``fused_bwd_k4`` runs ``fused_bwd_dm_plain`` whichever
    kernel the layout selects, and launches nothing."""
    lay, w, chan = _bg1_pair(23, "MS", dict(cn=3), 2)
    outs, store = fused_fwd_k3(chan, lay, *w, mode="stream")
    calls = []
    monkeypatch.setattr(fused_train_mod, "fused_bwd_dm_plain",
                        lambda *a: calls.append(1) or fused_bwd_dm_plain(*a))
    before = (fused_bwd_k4.launches, fused_bwd_k4.cuda_launches)
    fused_bwd_k4(chan, lay, *w, store, outs, torch.ones_like(outs))
    assert calls == [1] and (fused_bwd_k4.launches, fused_bwd_k4.cuda_launches) == before


# ---------------------------------------------------------------------------
# Against JAX
# ---------------------------------------------------------------------------
def test_twin_gradients_match_jax_flat_on_bg1_z32(monkeypatch):
    """The whole loss's gradients through ``FusedTrainFn`` with the cluster
    K4's twin as the backward (K3's cluster twin forward) on the BG1-like
    code at Z = 32, MS x4 cn=3, against ``jax.value_and_grad`` of the JAX
    flat path: loss within 1e-6, gradients atol 1e-6 / rtol 1e-4."""
    Z, n_iter = 32, 4
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(nr_bg1_like(Z).basegraph, Z),
        BoostedDecoderConfig(n_iterations=n_iter, decoder_type=DecoderType.MS,
                             sharing=NodeWeightSharingConfig(cn=3)), device="cpu")
    jdec = JaxDecoder(JaxTannerGraph.from_basegraph(jax_nr_bg1_like(Z).basegraph, Z),
                      JaxConfig(n_iterations=n_iter, decoder_type=JaxType.MS,
                                sharing=JaxSharing(cn=3), matmul_precision="highest"))
    params, llr, bits = grad_inputs(None, dec, jdec, batch=6, sigma=0.8, seed=7)
    ft = FusedTrainDecoder.from_decoder(dec)
    assert ft.layout.hbm_store and ft.layout.k4_kernel == "cluster"
    calls = []

    def twin(*args):
        calls.append(1)
        return fused_bwd_cl_plain(*args)

    monkeypatch.setattr(fused_train_mod, "fused_bwd_dm_plain", twin)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    x = torch.tensor(llr, requires_grad=True)
    loss = multi_iteration_loss(ft.apply(*dec._expanded_weights(p), x), torch.tensor(bits),
                                coeff=list(range(n_iter)))
    grads = torch.autograd.grad(loss, [*p.values(), x])
    assert calls == [1]
    gp = {k: g.numpy() for k, g in zip(p, grads)}
    assert_grads_match(loss, gp, grads[-1].numpy(), *jax_value_and_grads(jdec, params, llr, bits))
