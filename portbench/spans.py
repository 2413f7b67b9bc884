"""The program's own spans in a profiled slice, and the readers that take
them.

The port marks its phases with ``record_function`` ranges named
``nldpc.*`` (``neural_ldpc_tpu_torch/utils/profiling.py``; the names are
copied here, so the yardstick reads a program without them as finding
nothing).  ``attribute`` takes the slice's profiler events and puts down to
the innermost program span that was running:

* each device operation, by the runtime call that launched it
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``...: the host event that shares
  the operation's correlation id), on any thread: autograd launches the
  backward from its own thread while the main thread waits inside
  ``nldpc.train.backward``.  A parent span gets only what no child holds;
* each runtime synchronisation, by its own start;
* each idle gap's seconds, split at the program spans' edges, each part to
  the span innermost over it; its label goes by its middle, as
  ``trace.Slice.summary`` labels gaps.

Where no program span holds the moment, the key is the innermost benchmark
span (``portbench.*``), as in the slice's idle labels.  An idle gap inside
a program span is labelled ``<benchmark span>/<program span>/<host op>``;
other gaps keep the slice's ``<benchmark span>/<host op>``.
"""

from __future__ import annotations

import bisect

import torch

from portbench.trace import SLICE_SPAN, _innermost, _label

PROGRAM = "nldpc."
TRAIN_STEP = "nldpc.train.step"
TRAIN_FORWARD = "nldpc.train.forward"
TRAIN_LOSS = "nldpc.train.loss"
TRAIN_BACKWARD = "nldpc.train.backward"
TRAIN_UPDATE = "nldpc.train.update"
CAMPAIGN_ESCALATION = "nldpc.campaign.escalation"
DECODE_CALL = "nldpc.decode.call"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def _add(d: dict, k: str, v) -> None:
    d[k] = d.get(k, 0) + v


def attribute(events) -> dict:
    """From the slice's profiler events (``prof.events()``): the count of
    each program span (``spans``), device seconds (``device_s``),
    synchronisations (``syncs``) and idle seconds (``idle_s``) by innermost
    span, and the 10 largest idle labels (``idle``)."""
    device, host, bench, program, launch = [], [], [], [], {}
    window = None
    for e in events:
        r, name = e.time_range, e.name
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False) or name.startswith("portbench.")
                    or name.startswith(PROGRAM)):
                device.append((r.start, r.end, e.id))
        elif name == SLICE_SPAN:
            window = (r.start, r.end)
        elif name.startswith("portbench."):
            bench.append((r.start, r.end, name))
        elif name.startswith(PROGRAM):
            program.append((r.start, r.end, name))
        else:
            host.append((r.start, r.end, name))
            if name.startswith("cu"):  # a runtime or driver call
                launch[e.id] = r.start
    out = {"spans": {}, "device_s": {}, "syncs": {}, "idle_s": {}, "idle": []}
    if window is None:
        return out
    for lst in (bench, program, host):
        lst.sort()
    starts = ([s[0] for s in bench], [s[0] for s in program], [h[0] for h in host])

    def owner(t):
        return (_innermost(t, program, starts[1]) or _innermost(t, bench, starts[0])
                or SLICE_SPAN)

    for _, _, name in program:
        _add(out["spans"], name, 1)
    for a, b, cid in device:
        t = launch.get(cid)
        _add(out["device_s"], owner(t) if t is not None else SLICE_SPAN, (b - a) * 1e-6)
    for a, _, name in host:
        if name in SYNCS:
            _add(out["syncs"], owner(a), 1)
    device.sort()
    merged = []
    for a, b, _ in device:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [window[0]] + [x for ab in merged for x in ab] + [window[1]]
    cuts = sorted({x for a, b, _ in program for x in (a, b)})
    idle = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        parts = [a] + cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)] + [b]
        for x, y in zip(parts, parts[1:]):
            _add(out["idle_s"], owner((x + y) / 2), (y - x) * 1e-6)
        t = (a + b) / 2
        span = _innermost(t, program, starts[1])
        if span is None:
            label = _label(t, bench, host, (starts[0], starts[2]))
        else:
            op = _innermost(t, host, starts[2])
            label = "/".join(x for x in (_innermost(t, bench, starts[0]) or SLICE_SPAN, span, op)
                             if x)
        _add(idle, label, (b - a) * 1e-6)
    out["idle"] = [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
    return out


# ---- readers: each takes the traced slice's summary (``readers.py``) with
# ``attribute``'s keys added, and returns None where it finds nothing ----

def _phase_ms(s: dict, *names):
    """Device milliseconds a unit in the program spans ``names``."""
    if not s.get("units") or not any(n in s.get("spans", {}) for n in names):
        return None
    return 1e3 * sum(s["device_s"].get(n, 0.0) for n in names) / s["units"]


def train_forward_ms(s: dict):
    return _phase_ms(s, TRAIN_FORWARD, TRAIN_LOSS)


def train_backward_ms(s: dict):
    return _phase_ms(s, TRAIN_BACKWARD)


def train_update_ms(s: dict):
    return _phase_ms(s, TRAIN_UPDATE)


def train_syncs_per_step(s: dict):
    """Runtime synchronisations inside ``nldpc.train.step`` (its phases
    included) a step."""
    if not s.get("units") or TRAIN_STEP not in s.get("spans", {}):
        return None
    inside = [n for n in s["syncs"] if n.startswith("nldpc.train.")]
    return sum(s["syncs"][n] for n in inside) / s["units"]


def campaign_escalation_busy(s: dict):
    """Percent of the slice's device busy time in the escalation."""
    if not s.get("busy_s") or CAMPAIGN_ESCALATION not in s.get("spans", {}):
        return None
    return 100.0 * s["device_s"].get(CAMPAIGN_ESCALATION, 0.0) / s["busy_s"]


def campaign_redo_share(s: dict):
    """Percent of the window's words in windows redone with the full
    unroll, from the campaign's own counter."""
    w = s.get("window_counters", {})
    if "redone_words" not in w or not w.get("words"):
        return None
    return 100.0 * w["redone_words"] / w["words"]


def decode_entry_idle_ms(s: dict):
    """Idle milliseconds a call while the decode entry's host code runs."""
    if not s.get("units") or DECODE_CALL not in s.get("spans", {}):
        return None
    return 1e3 * s["idle_s"].get(DECODE_CALL, 0.0) / s["units"]


READERS = {"train.forward_ms": train_forward_ms, "train.backward_ms": train_backward_ms,
           "train.update_ms": train_update_ms, "train.syncs_per_step": train_syncs_per_step,
           "campaign.escalation_busy": campaign_escalation_busy,
           "campaign.redo_share": campaign_redo_share,
           "decode.entry_idle_ms": decode_entry_idle_ms}
