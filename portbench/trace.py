"""A profiled slice of a window and what the per-layer readers take from it.

``torch.profiler`` records the slice's device operations and the
benchmark's own spans (``record_function``, named ``portbench.*``).  Busy
time is the union of the device operations' intervals; idle gaps are the
spaces between them, each put down to what the host was doing at its
middle: the innermost benchmark span and the innermost host operation
running then.
"""

from __future__ import annotations

import bisect
import time

import torch

SLICE_SPAN = "portbench.slice"
SYNC_SPAN = "portbench.sync"


def warm_profiler() -> None:
    """Load the profiler's device tracing once in set-up."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Slice:
    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.cuda = cuda
        self.prof = profile(activities=acts)
        self.span = None
        self.wall = 0.0

    def start(self):
        self.prof.__enter__()
        self.span = torch.profiler.record_function(SLICE_SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            with torch.profiler.record_function(SYNC_SPAN):
                torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """busy_s, window_s, device_ops, the device operations that took
        most time and the idle seconds by host activity (10 each)."""
        device, host, spans = [], [], []
        window = None
        for e in self.prof.events():
            r = e.time_range
            annotation = getattr(e, "is_user_annotation", False) or e.name.startswith("portbench.")
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not annotation:
                    device.append((r.start, r.end, e.name))
            elif e.name == SLICE_SPAN:
                window = (r.start, r.end)
            elif e.name.startswith("portbench."):
                spans.append((r.start, r.end, e.name))
            else:
                host.append((r.start, r.end, e.name))
        out = {"window_s": self.wall, "device_ops": len(device), "busy_s": 0.0,
               "top_ops": [], "idle": []}
        if not device or window is None:
            return out
        device.sort()
        merged = []
        for a, b, _ in device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged)
        by_name = {}
        for a, b, name in device:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        gaps = [(window[0], merged[0][0])] + [(merged[k][1], merged[k + 1][0])
                                              for k in range(len(merged) - 1)]
        gaps.append((merged[-1][1], window[1]))
        spans.sort()
        host.sort()
        starts = ([s[0] for s in spans], [h[0] for h in host])
        idle = {}
        for a, b in gaps:
            if b > a:
                label = _label((a + b) / 2, spans, host, starts)
                idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
        out["busy_s"] = busy * 1e-6
        out["top_ops"] = [[n[:160], s * 1e-6] for n, s in
                          sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
        out["idle"] = [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
        return out


def _innermost(t, events, starts):
    """The latest-starting event of ``events`` (sorted by start) running at
    ``t``."""
    k = bisect.bisect_right(starts, t)
    for j in range(k - 1, max(-1, k - 400), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def _label(t, spans, host, starts):
    span = _innermost(t, spans, starts[0]) or SLICE_SPAN
    op = _innermost(t, host, starts[1])
    return f"{span}/{op}" if op else span
