"""The program spans' attribution (``spans.attribute``) on a hand-made
event list, its readers on hand-made summaries, and ``phases.py`` through
each cell at a tiny size on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from portbench import phases, spans
from portbench import trace as T
from portbench.tests.test_portbench_isolation import TINY

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, cid=0, thread=1, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, id=cid, thread=thread,
                           is_user_annotation=annotation)


def step_events(program=True):
    """One traced train step (microseconds).  Kernels 101 and 102 launch in
    the forward, 103 from autograd's thread 2 inside the backward (an
    ``aten::`` op in the forward shares its id, as CPU ops and runtime calls
    number apart), 104 in the update, 105 after the step in the benchmark's
    span.  A stream synchronise in the forward leaves a gap there; the
    slice's closing sync leaves one outside every program span."""
    evs = [ev(T.SLICE_SPAN, 0, 1000), ev("portbench.train.step", 10, 900),
           ev("aten::mul", 40, 60, cid=7), ev("cudaLaunchKernel", 45, 55, cid=101),
           ev("k101", 100, 150, CUDA, cid=101),
           ev("aten::empty", 32, 35, cid=103),
           ev("cudaStreamSynchronize", 160, 230, cid=110),
           ev("cudaLaunchKernel", 235, 240, cid=102), ev("k102", 250, 380, CUDA, cid=102),
           ev("cudaLaunchKernel", 450, 455, cid=103, thread=2),
           ev("k103", 460, 600, CUDA, cid=103),
           ev("cudaLaunchKernel", 710, 712, cid=104), ev("k104", 720, 730, CUDA, cid=104),
           ev("cudaLaunchKernel", 885, 888, cid=105), ev("k105", 890, 900, CUDA, cid=105),
           ev(T.SYNC_SPAN, 905, 1000), ev("cudaDeviceSynchronize", 910, 998, cid=111)]
    if program:
        evs += [ev(spans.TRAIN_STEP, 20, 880), ev(spans.TRAIN_FORWARD, 30, 380),
                ev(spans.TRAIN_LOSS, 380, 400), ev(spans.TRAIN_BACKWARD, 400, 700),
                ev(spans.TRAIN_UPDATE, 700, 870),
                ev(spans.TRAIN_BACKWARD, 460, 600, CUDA, annotation=True)]
    return sorted(evs, key=lambda e: e.time_range.start)


def approx(d):
    return {k: pytest.approx(v) for k, v in d.items()}


def test_attribution_by_innermost_program_span():
    a = spans.attribute(step_events())
    assert a["spans"] == {spans.TRAIN_STEP: 1, spans.TRAIN_FORWARD: 1, spans.TRAIN_LOSS: 1,
                          spans.TRAIN_BACKWARD: 1, spans.TRAIN_UPDATE: 1}
    assert a["device_s"] == approx({spans.TRAIN_FORWARD: 180e-6, spans.TRAIN_BACKWARD: 140e-6,
                                    spans.TRAIN_UPDATE: 10e-6, "portbench.train.step": 10e-6})
    assert a["syncs"] == {spans.TRAIN_FORWARD: 1, T.SYNC_SPAN: 1}
    assert a["idle_s"] == approx({  # gaps split at the spans' edges
        "portbench.train.step": 30e-6, spans.TRAIN_STEP: 20e-6, spans.TRAIN_FORWARD: 170e-6,
        spans.TRAIN_LOSS: 20e-6, spans.TRAIN_BACKWARD: 160e-6, spans.TRAIN_UPDATE: 160e-6,
        T.SYNC_SPAN: 100e-6})
    step = "portbench.train.step/"
    assert dict(a["idle"]) == approx({
        step + spans.TRAIN_UPDATE: 160e-6, step + spans.TRAIN_BACKWARD: 200e-6,
        step + spans.TRAIN_FORWARD + "/cudaLaunchKernel": 100e-6,
        step + spans.TRAIN_FORWARD + "/cudaStreamSynchronize": 100e-6,
        T.SYNC_SPAN + "/cudaDeviceSynchronize": 100e-6})


def test_without_program_spans_the_idle_labels_are_the_slices():
    """A program without spans (the parent's) finds no span, puts every
    device operation down to the benchmark's spans, and labels each gap as
    ``trace.Slice.summary`` does."""
    evs = step_events(program=False)
    a = spans.attribute(evs)
    sl = T.Slice.__new__(T.Slice)
    sl.prof, sl.wall = SimpleNamespace(events=lambda: evs), 1e-3
    assert a["spans"] == {} and sorted(a["idle"]) == sorted(sl.summary()["idle"])
    assert set(a["device_s"]) == {"portbench.train.step"}
    s = dict(sl.summary(), units=1, window_counters={"units": 1}, **a)
    assert {k: f(s) for k, f in spans.READERS.items()} == dict.fromkeys(spans.READERS)


@pytest.mark.parametrize("reader,summary,value", [
    ("train.forward_ms", dict(units=4, spans={spans.TRAIN_FORWARD: 4, spans.TRAIN_LOSS: 4},
                              device_s={spans.TRAIN_FORWARD: 0.02, spans.TRAIN_LOSS: 0.004}), 6.0),
    ("train.backward_ms", dict(units=4, spans={spans.TRAIN_BACKWARD: 4},
                               device_s={spans.TRAIN_BACKWARD: 0.2}), 50.0),
    ("train.update_ms", dict(units=4, spans={spans.TRAIN_UPDATE: 4}, device_s={}), 0.0),
    ("train.update_ms", dict(units=4, spans={}, device_s={}), None),
    ("train.syncs_per_step", dict(units=4, spans={spans.TRAIN_STEP: 4},
                                  syncs={spans.TRAIN_FORWARD: 4, spans.TRAIN_UPDATE: 2,
                                         "portbench.sync": 1}), 1.5),
    ("train.syncs_per_step", dict(units=4, spans={}, syncs={"portbench.sync": 1}), None),
    ("campaign.escalation_busy", dict(busy_s=0.5, spans={spans.CAMPAIGN_ESCALATION: 32},
                                      device_s={spans.CAMPAIGN_ESCALATION: 0.05}), 10.0),
    ("campaign.escalation_busy", dict(busy_s=0.5, spans={}, device_s={}), None),
    ("campaign.redo_share", dict(window_counters={"words": 400, "redone_words": 100}), 25.0),
    ("campaign.redo_share", dict(window_counters={"words": 400}), None),
    ("decode.entry_idle_ms", dict(units=16, spans={spans.DECODE_CALL: 16},
                                  idle_s={spans.DECODE_CALL: 0.0016}), 0.1),
    ("decode.entry_idle_ms", dict(units=16, spans={}, idle_s={}), None),
])
def test_readers_on_hand_made_summaries(reader, summary, value):
    got = spans.READERS[reader](summary)
    assert got == (None if value is None else pytest.approx(value))


@pytest.mark.parametrize("name", sorted(TINY))
def test_phases_through_each_cell_on_the_cpu(name):
    r = phases.phases(name, 2**31 + 41, 0.5, device="cpu", overrides=TINY[name])
    assert r["units"] > 0 and r["device_ops"] == 0
    want = {"bg2_qms20.train_b16k": {spans.TRAIN_STEP, spans.TRAIN_FORWARD, spans.TRAIN_LOSS,
                                     spans.TRAIN_BACKWARD, spans.TRAIN_UPDATE},
            "wman_ms10.campaign_5p5db": {"nldpc.campaign.batch", spans.CAMPAIGN_ESCALATION,
                                         "nldpc.campaign.flush"},
            "wman_ms10.decode_b256k": {spans.DECODE_CALL}}[name]
    assert set(r["spans"]) == want
    if name.startswith("bg2"):
        assert r["spans"][spans.TRAIN_STEP] == r["units"]
        assert set(r["readings"]) == {"train.forward_ms", "train.backward_ms",
                                      "train.update_ms", "train.syncs_per_step"}
    elif "campaign" in name:
        assert r["readings"]["campaign.redo_share"] >= 0
    else:
        assert r["spans"][spans.DECODE_CALL] == r["units"]
