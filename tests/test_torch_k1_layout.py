"""The on-chip forward kernel's block layout (``ops/cuda/fused_train.py::
k1_plan``: several words a block, messages in shared memory in the VN's
frame, a table the block loads once) on the CPU.  ``fused_fwd_block_plain``
decodes through the plan's table and word split, in the kernel's phase and
sum order, and must equal ``fused_fwd_plain`` (the kernel's ground truth on
the card) bit for bit in every mode, and ``legacy_plain`` on the legacy
engine's layouts (K5); one case also goes through JAX's Pallas
``_fwd_kernel`` in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from neural_ldpc_tpu.ops.pallas.minsum import FusedMinsumDecoder as JaxFused
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.codes.protograph import dense_protograph, nr_bg1_like
from neural_ldpc_tpu_torch.models import params_from_numpy
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, FwdLayout, fused_fwd_block_plain, fused_fwd_plain,
    fused_fwd_train_plain, k1_plan, legacy_plain, stats_plain)
from neural_ldpc_tpu_torch.ops.cuda import fused_train as ft
from neural_ldpc_tpu_torch.ops.cuda.legacy import legacy_layout
from neural_ldpc_tpu_torch.ops.quantize import qms_quantize_value
from test_torch_decoder import WMAN, build_pair, channel, random_weights

BG2 = "nr_bg2_set0_z16"
DENSE = "dense_e1100"
BG1_Z16 = "bg1_like_z16"
BG1_Z13 = "bg1_like_z13"  # a lift not a multiple of 4: the kernel's one-lift VN phase


def _code(name):
    if name == DENSE:
        return dense_protograph()
    if name.startswith("bg1_like_z"):
        return nr_bg1_like(int(name[len("bg1_like_z"):]))
    return get_code(name)


def _layout(name, n_iter, qms=None, sp=False, cn=True, vn=False, ucn=False, routing="roll"):
    code = _code(name)
    graph = TannerGraph.from_basegraph(code.basegraph, code.Z)
    return FwdLayout.build(graph, n_iter, (-20.0, 20.0), qms, sp, cn, vn, ucn, "cpu",
                           routing=routing)


def _inputs(lay, batch, seed):
    """Seeded weights around 1 and channel LLRs (QMS: on the input grid)."""
    rng = np.random.default_rng(seed)
    I, E, N = lay.n_iterations, lay.E, lay.N

    def w(width, on):
        return (torch.tensor((1 + 0.2 * rng.normal(size=(I, width))).astype(np.float32))
                if on else None)

    cnw, ucnw, vnw = w(E, lay.has_cn_w or lay.has_ucn), w(E, lay.has_ucn), w(N, lay.has_vn_w)
    chan = torch.tensor((rng.normal(size=(batch, N * lay.Z)) * 2.5 + 1.5).astype(np.float32))
    if lay.qms_qbit is not None:
        chan = qms_quantize_value(chan, lay.qms_qbit)
    return chan, (cnw, ucnw, vnw)


# (code, iterations, layout flags): wman Z = 24 (degrees 14-15), BG2 Z = 16
# (degrees 3-10: every instantiation up to 12 slots), the BG1-like base graph
# at Z = 16 (degrees up to 20) and at Z = 13, and the E = 1100 protograph
# (degrees 23-24) through K6's int8 and split-3 hooks; MS, QMS, SP, CN / VN /
# UCN weights
CASES = [
    (WMAN, 4, dict()),
    (WMAN, 3, dict(sp=True, vn=True)),
    (WMAN, 3, dict(qms=5, vn=True, ucn=True)),
    (BG2, 5, dict(qms=5, vn=True)),
    (BG2, 4, dict(qms=5, vn=True, ucn=True)),
    (BG2, 3, dict(vn=True, routing="split3")),
    (BG1_Z16, 3, dict(vn=True, ucn=True)),
    (BG1_Z13, 3, dict(qms=5, vn=True)),
    (DENSE, 3, dict(qms=5, routing="int8")),
    (DENSE, 3, dict(vn=True, routing="split3")),
]
IDS = [f"{c[0][:6]}-{'-'.join(f'{k}{v}' for k, v in c[2].items()) or 'ms'}" for c in CASES]


@pytest.mark.parametrize("code_name,n_iter,flags", CASES, ids=IDS)
def test_block_plain_equals_fused_fwd_plain_in_every_mode(code_name, n_iter, flags):
    """A batch the words per block do not divide, in every mode: final APP,
    stats, syndrome, and the training forward's outputs and store (the
    entering messages in K2's permuted flat-edge order k*Z + zc)."""
    lay = _layout(code_name, n_iter, **flags)
    plan = lay.k1
    batch = plan.W + 1 if plan.W > 1 else 3
    chan, w = _inputs(lay, batch, seed=len(code_name) + n_iter)
    ref = fused_fwd_plain(chan, lay, *w)
    ref_outs, ref_store = fused_fwd_train_plain(chan, lay, *w)
    app, store, st = fused_fwd_block_plain(chan, lay, *w)
    assert store is None and st is None and torch.equal(app, ref)
    outs, store, _ = fused_fwd_block_plain(chan, lay, *w, mode="stream", store=True)
    assert torch.equal(outs, ref_outs) and torch.equal(store, ref_store)
    assert torch.equal(store[0], torch.zeros_like(store[0]))
    none, _, st = fused_fwd_block_plain(chan, lay, *w, mode="stats")
    assert none is None and torch.equal(st, stats_plain(ref, lay))
    app_s, _, st_s = fused_fwd_block_plain(chan, lay, *w, mode="syndrome")
    assert torch.equal(app_s, ref) and torch.equal(st_s, st)


# the legacy engine's layouts (natural check order, K5's routings; its lifts
# are multiples of 8): the BG1-like code at Z = 16 and the E = 1100
# protograph take the 32-slot instantiation
LEGACY_CASES = [
    (WMAN, 4, dict(), "bf16"),
    (WMAN, 3, dict(sp=True, vn=True), "f32"),
    (BG2, 4, dict(qms=5, vn=True, ucn=True), "int8"),
    (BG2, 3, dict(qms=5, vn=True), "bf16"),
    (BG1_Z16, 3, dict(vn=True, ucn=True), "bf16"),
    (BG1_Z16, 3, dict(qms=5, ucn=True), "int8"),
    (DENSE, 2, dict(vn=True), "bf16"),
]


@pytest.mark.parametrize("code_name,n_iter,flags,routing", LEGACY_CASES,
                         ids=[f"{c[0][:6]}-{'-'.join(f'{k}{v}' for k, v in c[2].items()) or 'ms'}"
                              f"-{c[3]}" for c in LEGACY_CASES])
def test_block_plain_equals_legacy_plain(code_name, n_iter, flags, routing):
    """K5 on the card is the forward kernel on the legacy layout with the
    legacy routing's hooks (bf16 totals and terms; int8 with exact decision
    signs; float32 as roll): its block plain version equals
    ``legacy_plain`` bit for bit, at a batch the words per block do not
    divide."""
    code = _code(code_name)
    graph = TannerGraph.from_basegraph(code.basegraph, code.Z)
    lay = legacy_layout(graph, n_iter, (-20.0, 20.0), flags.get("qms"), flags.get("sp", False),
                        True, flags.get("vn", False), flags.get("ucn", False), "cpu",
                        torch.float32 if routing == "f32" else torch.bfloat16, routing == "int8")
    assert lay.routing == f"legacy_{routing}"
    plan = lay.k1
    assert plan.blocks_target == (2 if lay.max_degree > 16 else 3)
    batch = plan.W + 1 if plan.W > 1 else 3
    chan, w = _inputs(lay, batch, seed=len(code_name) + n_iter)
    app, _, _ = fused_fwd_block_plain(chan, lay, *w)
    assert torch.equal(app, legacy_plain(chan, lay, *w))


@pytest.mark.parametrize("code_name", [WMAN, BG2, BG1_Z16, BG1_Z13, DENSE])
def test_table_routes_as_the_layout(code_name):
    """The plan's table, decoded: each permuted flat edge k*Z + zc reads the
    total of the VN copy the layout routes it from (``route_idx``) and keeps
    its message at k*Z + (zc + shift) mod Z, the VN's frame (a permutation
    of the word's message region); each VN copy reads its messages in the
    layout's sum order; VN slots run by degree."""
    lay = _layout(code_name, 2)
    plan = lay.k1
    Z, E, N = lay.Z, lay.E, lay.N
    classes, tot_idx, msg_idx, vidx, vn_of = ft._block_addresses(lay, plan, "cpu")
    assert torch.equal(tot_idx, lay.route_idx)
    shift = torch.as_tensor(TannerGraph.from_basegraph(_code(code_name).basegraph, Z)
                            .shift_of_edge[lay.edge_perm], dtype=torch.int64)
    zc = torch.arange(Z)
    expect = (torch.arange(E)[:, None] * Z + (zc[None] + shift[:, None]) % Z).reshape(-1)
    assert torch.equal(msg_idx, expect)
    assert torch.equal(torch.sort(msg_idx).values, torch.arange(E * Z))
    # the VN copy's entries: the message of each edge in the layout's gather,
    # which lists flat edges k*Z + zc in sum order (E*Z pads)
    gather = lay.vn_gather
    live = gather < E * Z
    k, zg = gather // Z, gather % Z
    in_frame = k * Z + (zg + shift[k.clamp(max=E - 1)]) % Z
    assert torch.equal(vidx >= 0, live)
    assert torch.equal(torch.where(live, vidx, -1), torch.where(live, in_frame, -1))
    assert torch.equal(vn_of, torch.arange(N * Z) // Z)
    t = plan.table.view(-1).numpy().view(np.uint32)[:4 * N].reshape(N, 4).astype(np.int64)
    assert (np.diff(t[:, 2] - t[:, 1]) >= 0).all()
    assert [(b // Z, d, n) for b, d, n in classes] == [
        (int(sum(dd * nn for dd, nn in lay.deg_classes[:i])), d, n)
        for i, (d, n) in enumerate(lay.deg_classes)]


@pytest.mark.parametrize("code_name,words,blocks", [
    (WMAN, 5, 3), (BG2, 3, 3), (BG1_Z16, 3, 2), (DENSE, 1, 2)])
def test_plan_block_shape(code_name, words, blocks):
    """Words a block from the shared memory, so that the blocks the launch
    bound allows an SM fit its 228 KB; 256 threads; a word's region a
    multiple of 16 bytes whose stride puts two words of a warp in other
    banks; the on-chip family still takes the code."""
    code = _code(code_name)
    graph = TannerGraph.from_basegraph(code.basegraph, code.Z)
    lay = _layout(code_name, 2)
    plan = k1_plan(lay)
    assert (plan.W, plan.blocks_target, plan.threads) == (words, blocks, 256)
    assert blocks * (plan.smem_bytes + ft._BLOCK_RESERVED) <= ft._SM_SMEM
    assert plan.S % 4 == 0 and plan.S % 32 == (lay.Z % 32) & ~3
    assert plan.msg + lay.E * lay.Z <= plan.S and plan.TAB % 4 == 0
    assert lay.words_per_block == plan.W and ft.on_chip_ok(graph)


def test_block_plain_matches_jax_interpret():
    """The slice end to end against the JAX package: the block layout's
    plain version and the JAX Pallas kernel in interpret mode decode the
    same seeded BG2 QMS x3 inputs to the same APP."""
    code, dec, jdec = build_pair(BG2, "QMS", dict(cn=3, vn=3), 3)
    w = random_weights(jdec, seed=3)
    fused = FusedMinsumDecoder.from_decoder(dec, params_from_numpy(w, "cpu"))
    x = np.round(channel(code, 5, seed=8, scale=2.0, offset=1.0) * 2) / 2
    lay = fused.layout
    app, _, _ = fused_fwd_block_plain(torch.tensor(x.reshape(5, -1)), lay, *fused._w)
    ours = app.clamp(lay.clip_lo, lay.clip_hi).numpy()
    jf = JaxFused.from_decoder(jdec, {k: jnp.asarray(v) for k, v in w.items()},
                               routing_dtype=jnp.float32, interpret=True, bt=8)
    np.testing.assert_array_equal(ours, np.asarray(jf(jnp.asarray(x))))
