"""Profiling and timing harness.

Port of ``neural_ldpc_tpu/utils/profiling.py``.  Three tools:
  * ``trace(logdir)``: context manager around ``torch.profiler`` that
    records the host and, where a card is present, its kernels, and writes
    a Chrome/Perfetto trace (``*.pt.trace.json``, open it in
    ui.perfetto.dev or chrome://tracing) into ``logdir``.
  * ``benchmark(fn, *args)``: a timing loop that waits for the card after
    each call, with the first call (which builds the kernels) timed apart;
    reports that time, steady-state latency and derived throughput.
  * ``span(name)``: a named range of the program (the ``nldpc.*`` names
    below) that a running ``torch.profiler`` records beside the kernels, so
    a trace puts each kernel and each idle gap down to the phase that
    launched it; with no profiler running it costs one flag read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import torch

# Program spans: one prefix, one name per phase.
TRAIN_STEP = "nldpc.train.step"  # make_train_step's step, whole
TRAIN_FORWARD = "nldpc.train.forward"  # weight expansion and the forward kernel
TRAIN_LOSS = "nldpc.train.loss"  # the loss's forward
TRAIN_BACKWARD = "nldpc.train.backward"  # autograd's backward (the all-reduce under a mesh)
TRAIN_UPDATE = "nldpc.train.update"  # clip, row masks, Adam, the update, the clamp
CAMPAIGN_BATCH = "nldpc.campaign.batch"  # one batch's step, dispatched
CAMPAIGN_ESCALATION = "nldpc.campaign.escalation"  # re-decode of a batch's compacted failures
CAMPAIGN_FLUSH = "nldpc.campaign.flush"  # a window's read, counters and any exact redo
DECODE_CALL = "nldpc.decode.call"  # FusedMinsumDecoder.__call__

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager over one phase of the program: the profiler's
    ``record_function(name)`` while a profiler runs, else a shared no-op
    (no ``RecordFunction``, no dispatcher call)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: str):
    """Record a host (+ device, when CUDA is available) profiler trace of
    the block and write it into ``logdir`` as a Chrome/Perfetto JSON file."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in a tree of tuples, lists, dicts."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block_until_ready(tree):
    """Wait for the cards that hold the tensors of ``tree`` (the port's
    ``jax.block_until_ready``); returns ``tree``."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


@dataclasses.dataclass
class BenchResult:
    compile_s: float
    mean_s: float
    best_s: float
    reps: int
    items_per_s: Optional[float] = None

    def __str__(self):
        s = (f"compile {self.compile_s * 1e3:.1f} ms | "
             f"mean {self.mean_s * 1e3:.3f} ms | best {self.best_s * 1e3:.3f} ms "
             f"({self.reps} reps)")
        if self.items_per_s is not None:
            s += f" | {self.items_per_s:,.0f} items/s"
        return s


def benchmark(
    fn: Callable,
    *args,
    reps: int = 20,
    warmup: int = 2,
    items_per_call: Optional[int] = None,
    **kwargs,
) -> BenchResult:
    """Time ``fn(*args)`` with the first call (kernel build and first
    launch, reported as ``compile_s``) separated from steady state.

    ``fn`` may return any tree of tensors; each timed call ends when the
    cards holding them are done (``block_until_ready``), so asynchronous
    launches are measured correctly."""
    t0 = time.perf_counter()
    block_until_ready(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0

    for _ in range(max(warmup - 1, 0)):
        block_until_ready(fn(*args, **kwargs))

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    mean_s = sum(times) / len(times)
    best_s = min(times)
    return BenchResult(
        compile_s=compile_s,
        mean_s=mean_s,
        best_s=best_s,
        reps=reps,
        items_per_s=items_per_call / mean_s if items_per_call else None,
    )
