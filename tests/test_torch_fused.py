"""The fused decode wrapper (neural_ldpc_tpu_torch.ops.cuda) on the CPU, where
it runs the CUDA kernel's plain PyTorch version: held against the JAX Pallas
``_fwd_kernel`` in interpret mode and against the JAX flat path."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from neural_ldpc_tpu.ops.pallas.minsum import FusedMinsumDecoder as JaxFused
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.models import load_params_npz, params_from_numpy
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, FusedTrainDecoder, fused_fwd_k1a, fused_fwd_plain)
from test_torch_decoder import (
    BG2, TRAINED, WMAN, assert_close, build_pair, channel, random_weights)


def _pair(code_name, decoder_type, sharing, n_iter, seed=0):
    code, dec, jdec = build_pair(code_name, decoder_type, sharing, n_iter)
    w = random_weights(jdec, seed=seed)
    fused = FusedMinsumDecoder.from_decoder(dec, params_from_numpy(w, "cpu"))
    return code, dec, jdec, w, fused


def _interpret(jdec, w, x):
    jf = JaxFused.from_decoder(jdec, {k: jnp.asarray(v) for k, v in w.items()},
                               routing_dtype=jnp.float32, interpret=True, bt=8)
    return np.asarray(jf(jnp.asarray(x)))


INTERPRET_FAST = [(WMAN, "MS", dict(cn=3), 5), (BG2, "QMS", dict(cn=3, vn=3), 3)]
INTERPRET_SLOW = [
    (WMAN, "QMS", dict(cn=2, ucn=2, vn=3), 3),
    (WMAN, "SP", dict(cn=1, vn=2), 4),
    (BG2, "MS", dict(cn=6, ucn=1, vn=6), 3),
    (BG2, "QMS", dict(cn=3, ucn=2, vn=3), 3),
]


def _check_against_interpret(code_name, decoder_type, sharing, n_iter):
    code, dec, jdec, w, fused = _pair(code_name, decoder_type, sharing, n_iter)
    x = channel(code, 8, seed=4)
    ours = fused(torch.tensor(x)).numpy()
    assert ours.shape == (8, code.n_bits)
    assert_close(decoder_type, ours, _interpret(jdec, w, x))


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter", INTERPRET_FAST,
                         ids=["wman-MSx5", "bg2-QMSx3"])
def test_plain_kernel_matches_jax_interpret(code_name, decoder_type, sharing, n_iter):
    _check_against_interpret(code_name, decoder_type, sharing, n_iter)


@pytest.mark.slow
@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter", INTERPRET_SLOW,
                         ids=["wman-QMS-ucn", "wman-SP", "bg2-MS-ucn-deg", "bg2-QMS-ucn"])
def test_plain_kernel_matches_jax_interpret_more_modes(code_name, decoder_type, sharing, n_iter):
    _check_against_interpret(code_name, decoder_type, sharing, n_iter)


FLAT_CASES = [
    (WMAN, "MS", dict(cn=0), 3),
    (WMAN, "MS", dict(cn=2, ucn=2, vn=3), 4),
    (WMAN, "QMS", dict(cn=1, ucn=1, vn=2), 4),
    (WMAN, "QMS", dict(cn=4, ucn=4, vn=5), 4),
    (WMAN, "SP", dict(cn=1, vn=2), 4),
    (BG2, "MS", dict(cn=1, vn=2), 3),
    (BG2, "QMS", dict(cn=6, ucn=6, vn=6), 4),
    (BG2, "SP", dict(cn=3, ucn=3, vn=3), 3),
]


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter", FLAT_CASES,
                         ids=[f"{c[0][:4]}-{c[1]}-{'-'.join(f'{k}{v}' for k, v in c[2].items())}"
                              for c in FLAT_CASES])
def test_plain_kernel_matches_jax_flat(code_name, decoder_type, sharing, n_iter):
    code, dec, jdec, w, fused = _pair(code_name, decoder_type, sharing, n_iter, seed=2)
    x = channel(code, 5, seed=6, scale=1.5, offset=0.5) if decoder_type == "SP" \
        else channel(code, 5, seed=6)
    ours = fused(torch.tensor(x)).numpy()
    theirs = np.asarray(jdec.apply({k: jnp.asarray(v) for k, v in w.items()},
                                   jnp.asarray(x))[-1])
    assert_close(decoder_type, ours, theirs)
    # the port's own plain decoder is the kernel's CPU ground truth too
    plain = dec.apply(params_from_numpy(w, "cpu"), torch.tensor(x))[-1].numpy()
    assert_close(decoder_type, ours, plain)


TRAINED_CASES = [
    ("bg2_qms20_ref500ep.npz", dict(cn=3, vn=3)),
    ("bg2_qms20_base_ucn.npz", dict(cn=3, ucn=2, vn=3)),
]


def _trained_pair(weights, sharing):
    """The flagship BG2 QMS x20 decoder with trained weights, both packages,
    and half-grid channel LLRs (the QMS channel grid at qbit 5)."""
    code, dec, jdec = build_pair(BG2, "QMS", sharing, 20)
    path = os.path.join(TRAINED, weights)
    fused = FusedMinsumDecoder.from_decoder(dec, load_params_npz(path, "cpu"))
    with np.load(path) as d:
        jparams = {k: jnp.asarray(d[k]) for k in d.files}
    x = np.round(channel(code, 8, seed=7, scale=2.0, offset=1.0) * 2) / 2
    return code, jdec, jparams, fused, x


@pytest.mark.parametrize("weights,sharing", TRAINED_CASES, ids=["ref500ep", "base-ucn"])
def test_plain_kernel_trained_weights_match_jax_flat(weights, sharing):
    code, jdec, jparams, fused, x = _trained_pair(weights, sharing)
    ours = fused(torch.tensor(x)).numpy()
    assert ours.shape == (8, code.n_bits)
    np.testing.assert_array_equal(ours, np.asarray(jdec.apply(jparams, jnp.asarray(x))[-1]))


@pytest.mark.slow
@pytest.mark.parametrize("weights,sharing", TRAINED_CASES, ids=["ref500ep", "base-ucn"])
def test_plain_kernel_trained_weights_match_jax_interpret(weights, sharing):
    code, jdec, jparams, fused, x = _trained_pair(weights, sharing)
    jf = JaxFused.from_decoder(jdec, jparams, routing_dtype=jnp.float32, interpret=True, bt=8)
    np.testing.assert_array_equal(fused(torch.tensor(x)).numpy(), np.asarray(jf(jnp.asarray(x))))


def test_ragged_batch_and_wrappers_agree():
    code, dec, jdec, w, fused = _pair(WMAN, "MS", dict(cn=3, vn=2), 3, seed=5)
    x = torch.tensor(channel(code, 11, seed=8))
    out = fused(x)
    assert out.shape == (11, code.n_bits)
    np.testing.assert_array_equal(fused(x[:8]).numpy(), out[:8].numpy())
    np.testing.assert_array_equal(fused(x.reshape(11, -1)).numpy(), out.numpy())
    cn_w, ucn_w, vn_w = dec._expanded_weights(params_from_numpy(w, "cpu"))
    res = FusedTrainDecoder.from_decoder(dec, store_msgs=False).apply(cn_w, ucn_w, vn_w, x)
    assert res.shape == (1, 11, code.n_bits)
    np.testing.assert_array_equal(res[0].numpy(), out.numpy())
    # JAX's defaults (store_msgs=True): every iteration, the last one the same
    with torch.no_grad():
        every = FusedTrainDecoder.from_decoder(dec).apply(cn_w, ucn_w, vn_w, x)
    assert every.shape == (3, 11, code.n_bits)
    np.testing.assert_array_equal(every[-1].numpy(), out.numpy())
    # the pre-clip kernel output, clipped, is the decoder output
    lay = fused.layout
    raw = fused_fwd_plain(x.reshape(11, -1), lay, *fused._w)
    np.testing.assert_array_equal(raw.clamp(lay.clip_lo, lay.clip_hi).numpy(), out.numpy())


def test_cpu_tensors_never_launch_the_kernel():
    code, dec, jdec, w, fused = _pair(BG2, "QMS", dict(cn=3, vn=3), 2)
    before = fused_fwd_k1a.launches
    fused(torch.tensor(channel(code, 3, seed=1)))
    assert fused_fwd_k1a.launches == before
    with pytest.raises(ValueError, match="chan"):
        fused_fwd_k1a(torch.zeros(2, 7), fused.layout, *fused._w)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_fwd_k1a(torch.zeros(2, code.n_bits, device="meta"), fused.layout,
                      *(None if t is None else t.to("meta") for t in fused._w))


def test_decoders_refuse_a_batch_on_another_device():
    code, dec, jdec, w, fused = _pair(WMAN, "MS", dict(cn=3), 2)
    chan = torch.zeros(2, code.n_bits, device="meta")
    with pytest.raises(ValueError, match="lies on meta, the decoder on cpu"):
        fused(chan)
    with pytest.raises(ValueError, match="lies on meta, the decoder on cpu"):
        FusedTrainDecoder.from_decoder(dec).apply(None, None, None, chan)


def test_cuda_requested_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = get_code(WMAN)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedMinsumDecoder(g, n_iterations=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedTrainDecoder(g, n_iterations=3)


# Every mode is ported now (K1b-K1d, K3, the legacy engine K5 and the
# matmul routing K6): with the flags each one needs beside it, they build
# instead of raising.
_PORTED = ("K1b", "K1c", "K1d", "K3", "K5", "K6")
_NEEDS = {"sample_channel": dict(emit_stats=True),
          "sample_at_idx": dict(emit_stats=True, sample_channel=True),
          "emit_chan": dict(emit_stats=True, sample_channel=True)}


def _with_companions(kw):
    out = dict(kw)
    for flag in kw:
        out.update(_NEEDS.get(flag, {}))
    return out


@pytest.mark.parametrize("kw,item", [
    (dict(engine="legacy"), "K5"),
    (dict(all_iterations=True), "K1d"),
    (dict(emit_syndrome=True), "K1b"),
    (dict(emit_stats=True), "K1b"),
    (dict(sample_channel=True), "K1c"),
    (dict(sample_at_idx=128), "K1c"),
])
def test_unported_modes_name_their_roadmap_item(kw, item):
    code = get_code(WMAN)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    if item in _PORTED:
        f = FusedMinsumDecoder(g, n_iterations=3, device="cpu", **_with_companions(kw))
        assert f.layout.n_iterations == 3
        if item == "K5":  # the legacy engine's own layout: natural order, bf16 routing
            assert f.engine == "legacy" and f.layout.routing == "legacy_bf16"
        return
    with pytest.raises(NotImplementedError, match=item):
        FusedMinsumDecoder(g, n_iterations=3, device="cpu", **kw)


@pytest.mark.parametrize("kw,item", [
    (dict(store_msgs=True), "K1d"),
    (dict(routing="matmul"), "K6"),
    (dict(store_space="hbm"), "K3"),
    (dict(emit_chan=True), "K1c"),
])
def test_unported_train_modes_name_their_roadmap_item(kw, item):
    code = get_code(BG2)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    if item in _PORTED:
        kw = _with_companions(kw)
        if item == "K1c":  # the decode modes leave JAX's training default
            kw.setdefault("store_msgs", False)
        f = FusedTrainDecoder(g, n_iterations=3, device="cpu", **kw)
        if item == "K3":  # the layout selects the device-memory kernels
            assert f.layout.hbm_store and f.store_msgs
        elif item == "K6":  # on chip, routed on the tensor cores (split-3 without QMS)
            assert not f.layout.hbm_store and f.layout.routing == "split3"
        else:
            assert not f.layout.hbm_store
            assert (f.store_msgs and f.stream_outputs) if item == "K1d" else (
                f.emit_chan and f.sample_channel)
        return
    with pytest.raises(NotImplementedError, match=item):
        FusedTrainDecoder(g, n_iterations=3, device="cpu", **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        FusedTrainDecoder(g, n_iterations=3, qms_qbit=5, sum_product=True, device="cpu")
