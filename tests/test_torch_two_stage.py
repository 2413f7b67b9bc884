"""Two-stage decoding (``neural_ldpc_tpu_torch.eval.two_stage``) against the
JAX package's ``eval/two_stage.py`` on identical numpy inputs.

Everything here is exact: the syndrome on APPs that hold exact zeros, the
three entry points given decode callables that return the same fixed APPs,
and the whole two-stage decode through each package's plain QMS decoder on
the same weights (QMS messages live on a grid, so sum order cannot
matter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.eval.two_stage import TwoStageDecoder as JaxTwoStage
from neural_ldpc_tpu.eval.two_stage import make_syndrome_ok as jax_make_syndrome_ok
from neural_ldpc_tpu_torch.eval import TwoStageDecoder, two_stage
from neural_ldpc_tpu_torch.eval.two_stage import make_syndrome_ok
from test_torch_decoder import BG2, WMAN, build_pair, random_weights


def syndrome_apps(code, jdec, batch, seed):
    """APPs whose decisions satisfy every check in some rows: all-zero words
    (rows of positive values and exact zeros, which decide bit 0), random
    codewords where the code has a generator, and rows with a few flipped
    or zeroed bits."""
    rng = np.random.default_rng(seed)
    nz = code.N * code.Z
    mag = rng.uniform(0.5, 8.0, (batch, nz)).astype(np.float32)
    bits = np.zeros((batch, nz), np.int64)
    if code.gen_matrix is not None:
        info = rng.integers(0, 2, (batch // 2, code.n_info_bits))
        bits[: batch // 2] = (info @ code.gen_matrix) % 2
    app = np.where(bits == 1, -mag, mag).astype(np.float32)
    app[rng.random(app.shape) < 0.05] = 0.0  # 0 decides bit 0: only a bit-1 position flips
    flip = rng.random(batch) < 0.4
    for b in np.nonzero(flip)[0]:
        app[b, rng.integers(0, nz, 3)] *= -1.0
    return app


@pytest.mark.parametrize("rows", [None, 7], ids=["one_pass", "chunks_of_7"])
@pytest.mark.parametrize("code_name", [BG2, WMAN])
def test_syndrome_matches_jax_on_apps_with_exact_zeros(code_name, rows, monkeypatch):
    if rows:
        monkeypatch.setattr(two_stage, "_SYNDROME_ROWS", rows)
    code, dec, jdec = build_pair(code_name, "QMS", dict(cn=3), 2)
    app = syndrome_apps(code, jdec, 64, seed=1)
    ours = make_syndrome_ok(dec.graph, "cpu")(torch.as_tensor(app)).numpy()
    theirs = np.asarray(jax_make_syndrome_ok(jdec.graph)(jnp.asarray(app)))
    np.testing.assert_array_equal(ours, theirs)
    assert 0 < ours.sum() < len(ours)


def _lookup(table):
    """A decode callable returning ``table``'s row for each word, the row id
    carried in the word's first LLR."""
    def decode(x):
        if isinstance(x, torch.Tensor):
            return torch.as_tensor(table)[x[:, 0, 0].long()]
        return jnp.asarray(table)[x[:, 0, 0].astype(jnp.int32)]
    return decode


def test_entry_points_match_jax_on_fixed_apps():
    code, dec, jdec = build_pair(BG2, "QMS", dict(cn=3), 2)
    B = 300  # escalations past the 256 bucket of decode_sparse
    base = syndrome_apps(code, jdec, B, seed=2)
    post = syndrome_apps(code, jdec, B, seed=3)
    chan = np.zeros((B, code.N, code.Z), np.float32)
    chan[:, 0, 0] = np.arange(B)
    two = TwoStageDecoder(dec.graph, _lookup(base), _lookup(post), device="cpu")
    jtwo = JaxTwoStage(jdec.graph, _lookup(base), _lookup(post))
    x, jx = torch.as_tensor(chan), jnp.asarray(chan)
    for ours, theirs in ((two(x), jtwo(jx)), (two.decode_sparse(x, 64),
                                               jtwo.decode_sparse(jx, 64))):
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(theirs[0]))
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    bits = (base < 0).astype(np.float32)
    for exp in (None, bits):
        assert two.decode_with_fallback_stats(x, None if exp is None else torch.as_tensor(exp)) \
            == jtwo.decode_with_fallback_stats(jx, None if exp is None else jnp.asarray(exp))


def test_decode_sparse_without_escalations_returns_the_base_app():
    code, dec, _ = build_pair(BG2, "QMS", dict(cn=3), 2)
    ok_app = np.full((8, code.N * code.Z), 3.0, np.float32)
    chan = np.zeros((8, code.N, code.Z), np.float32)
    chan[:, 0, 0] = np.arange(8)
    two = TwoStageDecoder(dec.graph, _lookup(ok_app), _lookup(-ok_app), device="cpu")
    app, used = two.decode_sparse(torch.as_tensor(chan))
    assert torch.equal(app, torch.as_tensor(ok_app)) and not used.any()


@pytest.mark.parametrize("min_post_batch", [256, 4])
def test_two_stage_through_each_package_s_plain_decoder(min_post_batch):
    """Base QMS x5 and post QMS x7 with UCN weights on the same params,
    decoded by each package's plain decoder: equal APPs, escalations and
    stats, whatever the bucket of ``decode_sparse``."""
    code, bdec, jbdec = build_pair(BG2, "QMS", dict(cn=3, vn=3), 5)
    _, pdec, jpdec = build_pair(BG2, "QMS", dict(cn=3, ucn=2, vn=3), 7)
    bw, pw = random_weights(jbdec, seed=4), random_weights(jpdec, seed=5)
    rng = np.random.default_rng(6)
    sigma = 0.9
    llr = (2 * (1 + sigma * rng.standard_normal((96, code.N, code.Z))) / sigma**2)
    llr = np.clip(np.round(llr * 2) / 2, -7.5, 7.5).astype(np.float32)  # the QMS grid

    def port_dec(d, w):
        p = {k: torch.as_tensor(v) for k, v in w.items()}
        return lambda x: d.apply(p, x)[-1]

    def jax_dec(d, w):
        p = {k: jnp.asarray(v) for k, v in w.items()}
        return jax.jit(lambda x: d.apply(p, x)[-1])

    two = TwoStageDecoder(bdec.graph, port_dec(bdec, bw), port_dec(pdec, pw), device="cpu")
    jtwo = JaxTwoStage(jbdec.graph, jax_dec(jbdec, bw), jax_dec(jpdec, pw))
    x, jx = torch.as_tensor(llr), jnp.asarray(llr)
    app, used = two(x)
    japp, jused = jtwo(jx)
    np.testing.assert_array_equal(app.numpy(), np.asarray(japp))
    np.testing.assert_array_equal(used.numpy(), np.asarray(jused))
    assert 0 < int(used.sum()) < 96
    sparse, sused = two.decode_sparse(x, min_post_batch)
    assert torch.equal(sparse, app) and torch.equal(sused, used)
    jsparse, _ = jtwo.decode_sparse(jx, min_post_batch)
    np.testing.assert_array_equal(sparse.numpy(), np.asarray(jsparse))
    assert two.decode_with_fallback_stats(x) == jtwo.decode_with_fallback_stats(jx)
