"""The legacy decode engine (``FusedMinsumDecoder(engine="legacy")``, K5) on
the CPU, where it runs the kernel's plain version ``legacy_plain``: held
against JAX's ``FusedMinsumDecoder(engine="legacy", interpret=True)``, whose
Pallas ``_kernel`` routes through one-hot products, in bf16 (the default),
float32 and int8 routing; and JAX's checks and delegation rules.

Bars: QMS in int8 routing exact; MS 2e-5 (the bf16 roundings are the same,
the f32 sums in another order); SP 5e-3."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.ops.pallas.minsum import FusedMinsumDecoder as JaxFused
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.models import params_from_numpy
from neural_ldpc_tpu_torch.ops.cuda import (
    FusedMinsumDecoder, fused_fwd_k1a, fused_legacy_k5, legacy_plain)
from neural_ldpc_tpu_torch.ops.cuda.legacy import legacy_words_per_block
from test_torch_decoder import BG2, WMAN, assert_close, build_pair, channel, random_weights

_DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def _legacy_pair(code_name, decoder_type, sharing, n_iter, dtype, int8=None, seed=0):
    """(code, port legacy decoder, JAX legacy decoder in interpret mode, port
    stream decoder) with the same random weights."""
    code, dec, jdec = build_pair(code_name, decoder_type, sharing, n_iter)
    w = random_weights(jdec, seed=seed)
    tdt, jdt = _DTYPES[dtype]
    p = params_from_numpy(w, "cpu")
    ours = FusedMinsumDecoder.from_decoder(dec, p, engine="legacy", routing_dtype=tdt,
                                           int8_routing=int8)
    theirs = JaxFused.from_decoder(jdec, {k: jnp.asarray(v) for k, v in w.items()},
                                   engine="legacy", interpret=True, bt=8, routing_dtype=jdt,
                                   int8_routing=int8)
    return code, ours, theirs, FusedMinsumDecoder.from_decoder(dec, p)


def _check(code_name, decoder_type, sharing, n_iter, dtype, int8=None, routing=None):
    code, ours, theirs, stream = _legacy_pair(code_name, decoder_type, sharing, n_iter, dtype, int8)
    assert ours.engine == "legacy" and ours.layout.routing == routing
    x = channel(code, 8, seed=4)
    if decoder_type == "QMS":
        x = np.round(x * 2) / 2
    out = ours(torch.tensor(x)).numpy()
    assert out.shape == (8, code.n_bits)
    assert_close(decoder_type, out, np.asarray(theirs(jnp.asarray(x))))
    return out, stream(torch.tensor(x)).numpy()


def test_bf16_ms_matches_jax_and_differs_from_the_stream_engine():
    """wman MS x5 cn=3 in the default bf16 routing: JAX's legacy kernel
    within 2e-5, and more than 1e-3 away from the stream engine, so the
    check cannot pass on roll numbers."""
    out, stream = _check(WMAN, "MS", dict(cn=3), 5, "bf16", routing="legacy_bf16")
    assert np.abs(out - stream).max() > 1e-3


def test_f32_ms_matches_jax_and_the_stream_engine():
    out, stream = _check(WMAN, "MS", dict(cn=3), 5, "f32", routing="legacy_f32")
    np.testing.assert_allclose(out, stream, rtol=0, atol=2e-5)


def test_int8_qms_matches_jax_exactly():
    """BG2 QMS x3 cn=3 vn=3: int8 routing, the default for QMS."""
    out, stream = _check(BG2, "QMS", dict(cn=3, vn=3), 3, "bf16", routing="legacy_int8")
    np.testing.assert_array_equal(out, stream)


@pytest.mark.slow
@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter,dtype,int8,routing", [
    (WMAN, "QMS", dict(cn=2, ucn=2, vn=3), 3, "bf16", None, "legacy_int8"),
    (WMAN, "SP", dict(cn=1, vn=2), 4, "bf16", None, "legacy_bf16"),
    (BG2, "MS", dict(cn=6, ucn=1, vn=6), 3, "bf16", None, "legacy_bf16"),
    (BG2, "QMS", dict(cn=3, vn=3), 3, "f32", False, "legacy_f32"),
], ids=["wman-QMS-ucn-int8", "wman-SP-bf16", "bg2-MS-ucn-bf16", "bg2-QMS-f32"])
def test_more_modes_match_jax(code_name, decoder_type, sharing, n_iter, dtype, int8, routing):
    _check(code_name, decoder_type, sharing, n_iter, dtype, int8, routing)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    code, ours, _, _ = _legacy_pair(WMAN, "MS", dict(cn=3, vn=2), 3, "bf16")
    x = torch.tensor(channel(code, 5, seed=2)).reshape(5, -1)
    lay = ours.layout
    before = (fused_legacy_k5.launches, fused_fwd_k1a.launches)
    raw = fused_legacy_k5(x, lay, *ours._w)
    assert torch.equal(raw, legacy_plain(x, lay, *ours._w))
    assert torch.equal(ours(x), raw.clamp(lay.clip_lo, lay.clip_hi))
    assert (fused_legacy_k5.launches, fused_fwd_k1a.launches) == before
    # natural edge order: the identity permutation, weights as given
    assert (lay.edge_perm == np.arange(lay.E)).all() and legacy_words_per_block(lay) == 8
    with pytest.raises(ValueError, match="K5 runs the legacy routings"):
        fused_legacy_k5(x, FusedMinsumDecoder(ours.graph, 3, device="cpu").layout)
    with pytest.raises(ValueError, match="construct with sample_channel=True"):
        ours.sample_stats(1, 0.8, 4)


def _graph(code_name, z=None):
    code = get_code(code_name)
    return TannerGraph.from_basegraph(code.basegraph, z or code.Z)


@pytest.mark.parametrize("kw,z", [(dict(), 12), (dict(all_iterations=True), None)],
                         ids=["z12", "all-iterations"])
def test_legacy_delegates_to_the_stream_engine_with_a_warning(kw, z):
    """Z % 8 != 0 or every iteration's output: JAX's legacy engine warns and
    decodes with the stream engine; so does the port, with the same result."""
    g = _graph(WMAN, z)
    rng = np.random.default_rng(3)
    cw = (1 + 0.2 * rng.standard_normal((3, g.E))).astype(np.float32)
    x = torch.tensor(rng.normal(size=(4, g.N * g.Z)).astype(np.float32) * 3 + 1)
    with pytest.warns(UserWarning, match="delegates to the stream kernel"):
        f = FusedMinsumDecoder(g, 3, cn_weights=cw, engine="legacy", device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        stream = FusedMinsumDecoder(g, 3, cn_weights=cw, device="cpu", **kw)
    assert f.engine == "stream"
    np.testing.assert_array_equal(f(x).numpy(), stream(x).numpy())


@pytest.mark.parametrize("kw,match", [
    (dict(emit_syndrome=True), "emit_syndrome is a stream-engine epilogue"),
    (dict(emit_stats=True), "emit_stats is a stream-engine, final-only mode"),
    (dict(int8_routing=True), "int8 routing needs QMS quantization"),
    (dict(ucn_weights=np.ones((2, 88), np.float32)), "UCN weighting requires CN weights"),
    (dict(sum_product=True, qms_qbit=5), "SP and QMS are mutually exclusive"),
])
def test_legacy_checks_match_jax(kw, match):
    """JAX's checks, with its wording; emit_syndrome and emit_stats are
    refused before any delegation (here at Z = 12, which would delegate)."""
    for z in (None, 12) if "syndrome" in match or "stats" in match else (None,):
        g = _graph(WMAN, z)
        with pytest.raises(ValueError, match=match):
            FusedMinsumDecoder(g, 2, engine="legacy", device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            JaxFused(g, 2, engine="legacy", interpret=True, **kw)
