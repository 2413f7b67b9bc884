"""The cell ``bg1z384_ms20.decode_b32k`` at a tiny size on the CPU (the
cluster K3 runs its plain version there) through a whole run but the look
for a card: its line has the contract's schema and agrees with the
reference, the answer altered in the timed path is not correct, and the
reference in bfloat16 in the program's place is over the limit."""

import pytest

from portbench import cells, run
from portbench.tests.test_portbench_drivers import SEED, check_schema

NAME = "bg1z384_ms20.decode_b32k"
TINY = dict(batch=2, llr_batches=2, warmup_units=1, checked_calls=2, checked_calls_from=3,
            slice_units=2, reference_block=2)


def tiny_run(trace=False, fault=None):
    return run.run_cell(NAME, SEED, 0.5, trace, device="cpu", fault=fault, overrides=TINY,
                        start=0.0)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_agrees_with_reference(trace):
    r = tiny_run(trace)
    check_schema(r, NAME, trace)
    assert r["correct"], r["checks"]
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in cells.end_to_end(cells.benchmark(), NAME)}


def test_altered_answer_is_not_correct():
    r = tiny_run(fault="altered")
    assert r["correct"] is False, r["checks"]


def test_control_fails_the_limit():
    ctx, cell = run.context(NAME, SEED, "cpu", overrides=TINY)
    got = cells.driver(cell["driver"]).control(ctx)
    assert got["app_gap"] > cell["limits"]["app_gap"], got


def test_k3_counters_read_as_the_share_of_sms():
    """The driver's counters carry K3's, and the reader takes their window
    deltas; with none (a program without them, or no cluster launched) it
    reads nothing."""
    read = cells.reader("decode.k3_sm_share")
    assert read({"window_counters": {"units": 3, "k3_resident_ctas": 3 * 128,
                                     "k3_sm_slots": 3 * 132}}) == pytest.approx(100 * 128 / 132)
    assert read({"window_counters": {"units": 3, "k3_resident_ctas": 0,
                                     "k3_sm_slots": 0}}) is None
    assert read({"window_counters": {"units": 3}}) is None
    ctx, cell = run.context(NAME, SEED, "cpu", overrides=TINY)
    drv = cells.driver(cell["driver"]).Driver(ctx)
    assert {"units", "words", "k3_resident_ctas", "k3_sm_slots"} <= set(drv.counters())


def test_work_by_hand():
    """46x68, E = 316 at Z = 384: an edge copy costs v2c 1 + clip 2, check
    7, |c2v| weight relu clip 2 sign 2 = 8, sum 1; a bit one add an
    iteration; the final APP and its clip 3 a bit.  Bytes: LLRs in, APP
    out."""
    from portbench import work
    from portbench.reference import graph as G

    cfg = cells.config("bg1z384_ms20")
    s = G.config_shape(cfg)
    assert (s.M, s.N, s.Z, s.E, max(s.cn_degrees), max(s.vn_degrees)) == (46, 68, 384, 316,
                                                                            20, 16)
    per_iter = 316 * 384 * 19 + 26112
    assert work.decodes(s, cfg["decoder"], 1) == (20 * per_iter + 3 * 26112, 2 * 26112 * 4)
    assert work.decodes(s, cfg["decoder"], 1)[0] == 46_711_296
