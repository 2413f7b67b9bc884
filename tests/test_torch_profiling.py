"""The port's profiling harness (``utils/profiling.py``), its small CLIs
(``cli/profile.py``, ``cli/clear_checkpoint.py``) and torch-reference weight
import (``utils/checkpoint.py``, ``cli/evaluate.py --import-reference``),
against the JAX package's where it has the same function: the result's
fields and string, and imported params equal to JAX's bit for bit; and the
program's spans (``span``): a shared no-op with no profiler running, and
with one the train step's phases and the decode entry."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from neural_ldpc_tpu.cli import evaluate as jax_evaluate
from neural_ldpc_tpu.utils import checkpoint as jax_checkpoint
from neural_ldpc_tpu.utils.profiling import BenchResult as JaxBenchResult
from neural_ldpc_tpu_torch.cli import clear_checkpoint, evaluate, profile
from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder
from neural_ldpc_tpu_torch.training import TrainConfig, make_train_step
from neural_ldpc_tpu_torch.utils import BenchResult, benchmark, span, trace
from neural_ldpc_tpu_torch.utils import checkpoint
from neural_ldpc_tpu_torch.utils import profiling
from neural_ldpc_tpu_torch.utils.profiling import block_until_ready
from test_torch_decoder import BG2, WMAN, build_pair
from test_torch_neural_decoder import build_neural_pair


# ---------------------------------------------------------------------------
# Profiling harness
# ---------------------------------------------------------------------------
def _spans(prof):
    """(name, start, end) of the program's spans, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("nldpc.")), key=lambda t: t[1])


def _counting_record_function(monkeypatch):
    """Patch ``torch.profiler.record_function`` to note each name it makes."""
    made, real = [], torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    return made


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    made = _counting_record_function(monkeypatch)
    names = [v for k, v in vars(profiling).items() if k.isupper() and isinstance(v, str)]
    assert len(names) == 9 and all(n.startswith("nldpc.") for n in names)
    a, b = span(profiling.TRAIN_STEP), span(profiling.DECODE_CALL)
    with a, b:
        pass
    assert a is b and made == []
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with span(profiling.TRAIN_STEP):
            pass
    assert made == [profiling.TRAIN_STEP]
    assert [n for n, _, _ in _spans(prof)] == [profiling.TRAIN_STEP]


def test_train_step_spans_nest_in_order_and_change_nothing(monkeypatch):
    """The fused engine's step (the kernels' plain versions here): with a
    profiler each step is one ``nldpc.train.step`` holding forward, loss,
    backward and update in that order; params, Adam state and loss are
    bitwise those of the step run with no profiler, which makes no span."""
    made = _counting_record_function(monkeypatch)
    _, dec, _ = build_pair(WMAN, "QMS", dict(cn=3, vn=3), 2)
    g = dec.graph
    gen = torch.Generator().manual_seed(5)
    llr = 4.0 * torch.randn(4, g.N, g.Z, generator=gen)
    bits = torch.zeros(4, g.N * g.Z)
    init, step = make_train_step(dec, TrainConfig(engine="fused"))

    def two_steps():
        params = dec.init_params()
        opt = init(params)
        for _ in range(2):
            params, opt, loss = step(params, opt, llr, bits, 1e-3)
        return params, opt, loss

    plain = two_steps()
    assert made == []
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = two_steps()
    (p0, o0, l0), (p1, o1, l1) = plain, traced
    for a, b in ((p0, p1), (o0.mu, o1.mu), (o0.nu, o1.nu)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(o0.count, o1.count) and torch.equal(l0, l1)
    phases = [profiling.TRAIN_FORWARD, profiling.TRAIN_LOSS, profiling.TRAIN_BACKWARD,
              profiling.TRAIN_UPDATE]
    spans = _spans(prof)
    assert [n for n, _, _ in spans] == 2 * ([profiling.TRAIN_STEP] + phases)
    for k in (0, 5):
        (_, a, b), children = spans[k], spans[k + 1:k + 5]
        ends = [a] + [e for _, _, e in children]
        assert all(a <= s and e <= b for _, s, e in children)
        assert all(ends[i] <= children[i][1] for i in range(4))


@pytest.mark.parametrize("engine", ["stream", "legacy"])
def test_decode_call_emits_its_span(engine):
    _, dec, _ = build_pair(WMAN, "MS", dict(cn=3), 3)
    fused = FusedMinsumDecoder.from_decoder(dec, dec.init_params(), engine=engine)
    llr = 3.0 + torch.randn(4, dec.graph.N, dec.graph.Z, generator=torch.Generator().manual_seed(1))
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fused(llr)
    assert out.shape == (4, dec.graph.N * dec.graph.Z)
    assert [n for n, _, _ in _spans(prof)] == [profiling.DECODE_CALL]


def test_bench_result_fields_and_string_are_jax_s():
    assert [f.name for f in dataclasses.fields(BenchResult)] == \
        [f.name for f in dataclasses.fields(JaxBenchResult)]
    for items in (None, 123456.7):
        args = dict(compile_s=0.5, mean_s=0.0123, best_s=0.011, reps=7, items_per_s=items)
        assert str(BenchResult(**args)) == str(JaxBenchResult(**args))


def test_benchmark_separates_the_first_call():
    calls = []

    def f(x):
        calls.append(1)
        return {"sum": (x * 2 + 1).sum(), "rows": [x[0], (x[1],)]}

    res = benchmark(f, torch.ones(64, 64), reps=5, warmup=3, items_per_call=64)
    assert len(calls) == 1 + 2 + 5
    assert res.reps == 5 and res.best_s <= res.mean_s
    assert res.items_per_s and res.items_per_s > 0 and "mean" in str(res)
    tree = {"a": torch.zeros(2), "b": (torch.ones(1), [3])}
    assert block_until_ready(tree) is tree


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path / "t")):
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "t" / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_profile_cli_runs_on_the_cpu(tmp_path, capsys):
    rc = profile.main(["--preset", "wman_ms_plain", "--batch-size", "32",
                       "--train-batch-size", "8", "--reps", "2", "--device", "cpu",
                       "--trace-dir", str(tmp_path)])
    assert rc == 0
    rows = [l for l in capsys.readouterr().out.splitlines() if " compile " in l]
    assert [r.split()[0] for r in rows] == ["decode_xla", "decode_fused", "train"]
    assert len(os.listdir(tmp_path)) == 3


def test_clear_checkpoint_outcomes(tmp_path, monkeypatch, capsys):
    missing = tmp_path / "none"
    assert clear_checkpoint.main(["--dir", str(missing)]) == 0
    assert "nothing to clear" in capsys.readouterr().out
    d = tmp_path / "ck"
    (d / "sub").mkdir(parents=True)
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    assert clear_checkpoint.main(["--dir", str(d)]) == 1 and d.exists()
    monkeypatch.setattr("builtins.input", lambda prompt: "yes")
    assert clear_checkpoint.main(["--dir", str(d)]) == 0 and not d.exists()
    (d / "sub").mkdir(parents=True)
    assert clear_checkpoint.main(["--dir", str(d), "--yes"]) == 0 and not d.exists()


# ---------------------------------------------------------------------------
# Torch-reference weight import
# ---------------------------------------------------------------------------
def _boosted_reference(dec, seed):
    """A reference state_dict of per-iteration rows for ``dec`` (the names
    ``named_parameter_rows`` exports, temporal rows included)."""
    rng = np.random.default_rng(seed)
    params = {k: torch.as_tensor((v.numpy() * (1 + 0.2 * rng.standard_normal(v.shape)))
                                 .astype(np.float32)) for k, v in dec.init_params().items()}
    return {k: torch.as_tensor(np.atleast_1d(v))
            for k, v in dec.named_parameter_rows(params).items()}, params


def _dai_reference(dec, seed, sep="."):
    rng = np.random.default_rng(seed)
    I, E = dec.config.n_iterations, dec.graph.E
    return {f"{k}{sep}{i}": torch.as_tensor(rng.standard_normal(E).astype(np.float32))
            for k in ("weights_var", "biases_var") for i in range(I)}


def _write_txt(txt_dir, state):
    checkpoint.CheckpointManager(os.path.dirname(txt_dir)).save_weights(
        os.path.basename(txt_dir)[: -len("_weights_txt")],
        {k: v.numpy() for k, v in state.items()}, as_txt=True)


def _assert_equal(ours, theirs):
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=k)


@pytest.mark.parametrize("code_name,decoder_type,sharing,n_iter", [
    (BG2, "QMS", dict(cn=3, vn=3), 4), (WMAN, "MS", dict(cn=2, ucn=2, vn=1), 3),
    (BG2, "MS", dict(cn=4, vn=5), 6)])
@pytest.mark.parametrize("form", ["pth", "checkpoint_pth", "txt"])
def test_boosted_import_matches_jax(tmp_path, code_name, decoder_type, sharing, n_iter, form):
    _, dec, jdec = build_pair(code_name, decoder_type, sharing, n_iter)
    state, params = _boosted_reference(dec, seed=1)
    if form == "txt":
        path = str(tmp_path / "run_weights_txt")
        _write_txt(path, state)
    else:
        path = str(tmp_path / "model.pth")
        torch.save({"model_state_dict": state} if form == "checkpoint_pth" else state, path)
    ours = checkpoint.import_reference_weights(dec, path)
    _assert_equal(ours, jax_checkpoint.import_reference_weights(jdec, path))
    _assert_equal(ours, params)


@pytest.mark.parametrize("form,sep", [("pth", "."), ("pth", "_"), ("txt", "_")])
def test_dai_import_matches_jax(tmp_path, form, sep):
    _, dec, jdec = build_neural_pair(WMAN, 3)
    state = _dai_reference(dec, seed=2, sep=sep)
    if form == "txt":
        path = str(tmp_path / "dai_weights_txt")
        _write_txt(path, state)
    else:
        path = str(tmp_path / "dai.pth")
        torch.save(state, path)
    _assert_equal(checkpoint.import_reference_weights(dec, path),
                  jax_checkpoint.import_reference_weights(jdec, path))


def test_import_errors_are_jax_s(tmp_path):
    _, dec, jdec = build_pair(BG2, "QMS", dict(cn=3, vn=3), 4)
    state, _ = _boosted_reference(dec, seed=3)
    for name, drop in (("missing.pth", "weight_VN_2"), ("wide.pth", None)):
        bad = {k: v for k, v in state.items() if k != drop}
        if drop is None:
            bad["weight_CN_1"] = torch.ones(2)
        torch.save(bad, str(tmp_path / name))
        errs = []
        for mod, d in ((checkpoint, dec), (jax_checkpoint, jdec)):
            with pytest.raises((KeyError, ValueError)) as e:
                mod.import_reference_weights(d, str(tmp_path / name))
            errs.append((e.type, str(e.value)))
        assert errs[0] == errs[1]
    _, ndec, _ = build_neural_pair(WMAN, 3)
    torch.save(_dai_reference(ndec, seed=4), str(tmp_path / "dai.pth"))
    with pytest.raises(KeyError, match="weights_var.3"):
        checkpoint.import_reference_weights(build_neural_pair(WMAN, 4)[1],
                                            str(tmp_path / "dai.pth"))


class _Pickled:
    """An object that only full unpickling restores."""

    def __init__(self):
        self.note = "from a training script"


def test_unsafe_pth_needs_the_opt_in(tmp_path):
    _, dec, _ = build_pair(BG2, "QMS", dict(cn=3, vn=3), 4)
    state, params = _boosted_reference(dec, seed=5)
    path = str(tmp_path / "full.pth")
    torch.save({"model_state_dict": state, "extra": _Pickled()}, path)
    with pytest.raises(ValueError, match="import-reference-unsafe"):
        checkpoint.import_reference_weights(dec, path)
    with pytest.warns(UserWarning, match="UNSAFE LOAD"):
        got = checkpoint.import_reference_weights(dec, path, allow_unsafe=True)
    _assert_equal(got, params)


def test_evaluate_cli_import_reference(tmp_path):
    """tests/test_config_cli.py's --import-reference run in the port, on the
    CPU: a txt export of the default preset's decoder (QMS x20, cn=3 vn=3
    scalars) evaluated through the CLI, as JAX's CLI evaluates it."""
    txt_dir = tmp_path / "weights_txt"
    txt_dir.mkdir()
    rng = np.random.RandomState(0)
    lines = ["# header", "-" * 80, "Parameter_Name, Shape, Filename"]
    for nt in ("CN", "VN"):
        for i in range(20):
            name = f"weight_{nt}_{i}"
            np.savetxt(txt_dir / f"{name}.txt", np.atleast_1d(
                rng.uniform(0.5, 1.5, size=(1,)).astype(np.float32)))
            lines.append(f"{name}, [1], {name}.txt")
    (txt_dir / "index.txt").write_text("\n".join(lines) + "\n")
    args = ["--import-reference", str(txt_dir), "--snr", "3.0", "--batch-size", "64",
            "--max-words", "128", "--min-frame-errors", "0", "--engine", "xla"]
    assert evaluate.main(args + ["--device", "cpu", "--out", str(tmp_path / "res.json")]) == 0
    data = json.loads((tmp_path / "res.json").read_text())
    assert data["results"]["3.0"]["words"] == 128
    assert jax_evaluate.main(args + ["--out", str(tmp_path / "jax.json")]) == 0
    jdata = json.loads((tmp_path / "jax.json").read_text())
    assert {k: v for k, v in data.items() if k != "results"} == \
        {k: v for k, v in jdata.items() if k != "results"}
