"""Weight expansion's index tables: made once per device, then kept.

``BoostedNeuralDecoder._expanded_weights`` gathers with index tables (each
iteration's row, the degree classes, the edges' check nodes) and takes
override rows; both are made on the weights' device at the first call there
(``models/sharing.py::DeviceTables``).  A later call, and so every train step
after the first, makes none from host data.  The expanded weights, the
gradients through them and whole train steps equal bit for bit a
construction that makes every table afresh on each call."""

import numpy as np
import pytest
import torch

from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder, sharing
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig, SharingMode
from neural_ldpc_tpu_torch.training import TrainConfig, make_train_step

BG2 = "nr_bg2_set0_z16"
N_ITER, FIXED = 5, (2, 4)
# every mode on CN, UCN and VN (VN takes the node-wise ones); (3, 0, 3) is
# the bg2_qms_train preset's
SHARING = [dict(cn=c, ucn=u, vn=v) for c, u, v in [
    (0, 0, 0), (1, 1, 2), (2, 2, 3), (3, 3, 5), (4, 4, 2), (5, 5, 5), (6, 6, 6), (3, 0, 3)]]
SHARING_IDS = [f"cn{s['cn']}ucn{s['ucn']}vn{s['vn']}" for s in SHARING]


def _decoder(sharing_modes, decoder_type=DecoderType.QMS):
    code = get_code(BG2)
    return BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, code.Z),
        BoostedDecoderConfig(n_iterations=N_ITER, decoder_type=decoder_type,
                             sharing=NodeWeightSharingConfig(**sharing_modes),
                             fixed_iterative_nodes=FIXED), device="cpu")


def _params(dec, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.tensor((v.numpy() + 0.1 * rng.standard_normal(v.shape)).astype(np.float32))
            for k, v in dec.init_params().items()}


def per_call_expanded(dec, params, fixed_iter_weights=None):
    """The expansion with every index table and override row made afresh
    from host data on each call: (cn [I, E], ucn [I, E], vn [I, N])."""
    ov = fixed_iter_weights or {}

    def idx(ix, like):
        return torch.as_tensor(np.asarray(ix), dtype=torch.long, device=like.device)

    def expand(key):
        spec, raw = dec.specs[key], params.get(f"weight_{key}")
        if spec.mode == SharingMode.NONE:
            return None
        width = spec.n_nodes if key == "vn" else spec.n_edges
        rows = raw[idx(spec.row_of_iteration, raw)]
        if spec.mode in (SharingMode.NODE_ITER, SharingMode.NODE_TEMPORAL):
            w = rows if key == "vn" else rows[:, idx(dec.graph.cn_of_edge, raw)]
        elif spec.mode == SharingMode.DEGREE_ITER:
            w = rows[:, idx(spec.degree_class_of_node, raw)]
            w = w if key == "vn" else w[:, idx(dec.graph.cn_of_edge, raw)]
        elif spec.mode == SharingMode.ITER:
            w = rows.expand(spec.n_iterations, width)
        else:
            w = rows
        over = ov.get(key)
        if over:
            w = torch.stack([
                torch.as_tensor(over[i], dtype=raw.dtype, device=raw.device).expand(width)
                if i in over else w[i] for i in range(spec.n_iterations)])
        return w

    return tuple(expand(k) for k in ("cn", "ucn", "vn"))


def _bits(t):
    """A float32 tensor's bit pattern (``torch.equal`` takes -0.0 for 0.0)."""
    return t.detach().contiguous().view(torch.int32)


def _assert_bitwise(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), what


class _Spy:
    """Counts the tables and override rows ``models/sharing.py`` makes from
    host data."""

    def __init__(self, monkeypatch):
        self.made = 0
        for name in ("_idx", "_row"):
            real = getattr(sharing, name)
            monkeypatch.setattr(sharing, name, self._counting(real))

    def _counting(self, real):
        def made(*args, **kwargs):
            self.made += 1
            return real(*args, **kwargs)
        return made


def _fixed(dec):
    """Override rows of every kind a caller may give: a number, a numpy row
    [E] and a CPU tensor."""
    E = dec.graph.E
    return {"cn": {1: 0.5, 3: np.linspace(0.1, 1.0, E, dtype=np.float32)},
            "ucn": {0: np.float32(1.25)},
            "vn": {2: torch.tensor(0.75)}}


@pytest.mark.parametrize("with_fixed", [False, True], ids=["plain", "fixed_iter_weights"])
@pytest.mark.parametrize("modes", SHARING, ids=SHARING_IDS)
def test_expansion_makes_its_tables_once(monkeypatch, modes, with_fixed):
    """The second expansion makes no table or row from host data; both
    equal the per-call construction bit for bit, values and gradients."""
    dec = _decoder(modes)
    spy = _Spy(monkeypatch)
    fixed = _fixed(dec) if with_fixed else None
    rng = np.random.default_rng(1)
    for call in range(2):
        p = {k: v.clone().requires_grad_(True) for k, v in _params(dec).items()}
        q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        before = spy.made
        ours = dec._expanded_weights(p, fixed)
        if call == 1:
            assert spy.made == before, "a table was made from host data again"
        theirs = per_call_expanded(dec, q, fixed)
        for key, a, b in zip(("cn", "ucn", "vn"), ours, theirs):
            _assert_bitwise(a, b, key)
        if not p:
            continue
        # the same cotangent through both: the gradients equal bit for bit
        cot = [None if w is None else torch.tensor(rng.standard_normal(w.shape), dtype=w.dtype)
               for w in ours]
        loss_a = sum((w * c).sum() for w, c in zip(ours, cot) if w is not None)
        loss_b = sum((w * c).sum() for w, c in zip(theirs, cot) if w is not None)
        ga = torch.autograd.grad(loss_a, list(p.values()))
        gb = torch.autograd.grad(loss_b, list(q.values()))
        for key, a, b in zip(p, ga, gb):
            _assert_bitwise(a, b, f"grad {key}")
    # one set of tables, for the one device the weights lived on
    assert list(dec._device_tables) == ([torch.device("cpu")] if dec.init_params() else [])


@pytest.mark.parametrize("engine", ["xla", "fused"])
@pytest.mark.parametrize("modes", SHARING[1:], ids=SHARING_IDS[1:])  # a step needs weights
def test_train_step_makes_no_table_after_the_first(monkeypatch, modes, engine):
    """Two steps of ``make_train_step`` (the fused engine through its plain
    versions on the CPU): the second makes no table from host data, and the
    losses, weights and Adam moments of both steps equal bit for bit those of
    a decoder that expands with tables made afresh on each call."""
    results = []
    for per_call in (False, True):
        dec = _decoder(modes)
        if per_call:
            monkeypatch.setattr(dec, "_expanded_weights",
                                lambda params, fixed=None, d=dec: per_call_expanded(d, params, fixed))
        spy = _Spy(monkeypatch)
        init, step = make_train_step(dec, TrainConfig(engine=engine))
        params = _params(dec)
        opt = init(params)
        B, NZ = 4, dec.graph.N * dec.graph.Z
        rng = np.random.default_rng(2)
        made, losses = [], []
        for _ in range(2):
            llr = torch.tensor(rng.standard_normal((B, dec.graph.N, dec.graph.Z)) * 3,
                               dtype=torch.float32)
            bits = torch.tensor((rng.random((B, NZ)) < 0.5).astype(np.float32))
            before = spy.made
            params, opt, loss = step(params, opt, llr, bits, 1e-2)
            made.append(spy.made - before)
            losses.append(loss)
        if not per_call:
            assert made[1] == 0, f"the second step made {made[1]} tables from host data"
        results.append((losses, params, opt))
    (la, pa, oa), (lb, pb, ob) = results
    for a, b in zip(la, lb):
        _assert_bitwise(a, b, "loss")
    for k in pa:
        _assert_bitwise(pa[k], pb[k], k)
        _assert_bitwise(oa.mu[k], ob.mu[k], f"mu {k}")
        _assert_bitwise(oa.nu[k], ob.nu[k], f"nu {k}")
