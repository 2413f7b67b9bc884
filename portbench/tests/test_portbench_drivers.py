"""Each driver at a tiny size on the CPU (the port's kernels run their
plain versions there) through a whole run but the look for a card: it
agrees with the reference, its line has the contract's schema, and with
the timed path broken underneath ``correct`` comes out false.  ``run.py``
itself refuses to run with no card."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from portbench import cells, run
from portbench.tests.test_portbench_isolation import TINY

BENCH = cells.benchmark()
SEED = 2**31 + 977
FAULTS = {"bg2_qms20.train_b16k": ("frozen", "half", "stale"),
          "wman_ms10.campaign_5p5db": ("altered",),
          "wman_ms10.decode_b256k": ("altered",)}


def tiny_run(name, trace=False, fault=None, seconds=0.5):
    return run.run_cell(name, SEED, seconds, trace, device="cpu", fault=fault,
                        overrides=TINY[name], start=0.0)


def check_schema(r, name, trace):
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    assert isinstance(r["correct"], bool) and r["attempted"] > 0 and r["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        wanted = {m["name"] for m in cells.per_layer(BENCH, name)}
    else:
        wanted = {m["name"] for m in cells.end_to_end(BENCH, name)}
    # the per-layer metrics of the device trace are left out where the CPU ran
    assert set(r["metrics"]) <= wanted
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    limits = cells.workload(name)["limits"]
    assert set(r["checks"]) == set(limits)
    json.dumps(r)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", sorted(TINY))
def test_driver_agrees_with_reference(name, trace):
    r = tiny_run(name, trace)
    check_schema(r, name, trace)
    assert r["correct"], r["checks"]
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in cells.end_to_end(BENCH, name)}


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(FAULTS) for f in FAULTS[n]])
def test_broken_timed_path_is_not_correct(name, fault):
    r = tiny_run(name, fault=fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_the_limits(name):
    """The reference in bfloat16 in the program's place fails some limit
    (the decode at 2 dB, where a tiny batch still has unsaturated APPs)."""
    over = dict(TINY[name], **({"snr_db": 2.0} if "decode" in name else {}))
    ctx, cell = run.context(name, SEED, "cpu", overrides=over)
    got = cells.driver(cell["driver"]).control(ctx)
    assert any(v > cell["limits"][k] for k, v in got.items()), got


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "wman_ms10.decode_b256k", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=cells.ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
def test_cell_on_the_card(card, name):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                          str(SEED), "--seconds", "3", "--trace", "0"], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    check_schema(r, name, False)
    assert r["correct"] and r["device"]["platform"] == "gpu"
