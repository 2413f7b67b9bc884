"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process: load the cell's files, build or load its kernels through the
port's own build, make its inputs on the device from the seed, warm up the
cell's shapes, then time a window of ``--seconds``.  With ``--trace 1`` a
bounded slice of the window runs under ``torch.profiler`` and the line
carries the cell's per-layer metrics; otherwise its end-to-end metrics.
After the window the program's state is freed and the plain reference
checks what the window produced.  The last line of standard output is one
JSON object; the last lines of standard error are the numbers compared,
each beside its limit.  Exits non-zero, printing no result, where there is
no card or too few, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            return max(0.0, float(f.read().split()[0]) - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


START = time.perf_counter() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

from portbench import cells, port, work  # noqa: E402
from portbench import trace as T  # noqa: E402
from portbench.reference import graph as G  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "neural_ldpc_tpu"}


@dataclasses.dataclass
class Context:
    cfg: dict
    params: dict
    seed: int
    device: torch.device
    shape: G.Shape
    fault: str | None = None


def context(name: str, seed: int, device, fault=None, overrides=None):
    """(the driver's Context, the cell's workload file) of cell ``name``."""
    cell = cells.workload(name)
    cfg = cells.config(cell["config"])
    return Context(cfg=cfg, params=dict(cell["params"], **(overrides or {})), seed=int(seed),
                   device=torch.device(device), shape=G.config_shape(cfg), fault=fault), cell


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str | None:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip() or None


def window(drv, span: str, seconds: float, trace: bool, slice_units: int, cuda: bool):
    """Time ``drv``'s units for ``seconds``, and on until the units the
    reference checks have run; with ``trace``, profile ``slice_units`` of
    them from 30% into the window.  Returns (wall seconds, counter deltas,
    the slice's summary or None)."""
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
    c0 = drv.counters()
    sl = summary = s0 = None
    left = slice_units
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and (not trace or summary is not None) and drv.checked_done():
            break
        if trace and sl is None and elapsed >= 0.3 * seconds:
            if cuda:
                torch.cuda.synchronize()
            traced_from = time.perf_counter()
            sl = T.Slice(cuda)
            s0 = drv.counters()
            sl.start()
        if sl is not None and summary is None:
            with torch.profiler.record_function(span):
                drv.unit()
            left -= 1
            if left == 0:
                sl.stop()
                s1 = drv.counters()
                summary = {"slice": sl, "delta": {k: s1[k] - s0[k] for k in s1},
                           "seconds": time.perf_counter() - traced_from}
        else:
            drv.unit()
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c1 = drv.counters()
    delta = {k: c1[k] - c0[k] for k in c1}
    if summary is not None:
        # a unit's seconds outside the slice, which the profiler slows
        rest = delta["units"] - summary["delta"]["units"]
        summary["unit_s"] = (seconds - summary["seconds"]) / rest if rest > 0 else None
    return seconds, delta, summary


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             fault: str | None = None, overrides: dict | None = None, start: float = START):
    """Run cell ``name`` and return its result line as a dict, the numbers
    compared last (None where a forbidden module was loaded).
    ``overrides`` replaces traffic parameters (the tests' tiny sizes);
    ``fault`` plants a fault in the timed path (the tests' checks of the
    comparison)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = cells.benchmark()
    ctx, cell = context(name, seed, device, fault, overrides)
    cuda = ctx.device.type == "cuda"
    params = ctx.params
    mod = cells.driver(cell["driver"])
    marks = [("imports", time.perf_counter())]
    built = port.build_kernels(mod.SOURCES, ctx.device)
    if built:
        print(f"[portbench] nvcc seconds (compile, part of set-up): {built}", file=sys.stderr)
    marks.append(("kernels", time.perf_counter()))
    drv = mod.Driver(ctx)
    if trace and cuda:
        T.warm_profiler()
    if cuda:
        torch.cuda.synchronize()
    marks.append(("driver", time.perf_counter()))
    setup_s = marks[-1][1] - start
    wall, delta, summary = window(drv, mod.SPAN, seconds, trace, params["slice_units"], cuda)
    memory_peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    result = {"correct": False, "attempted": delta["units"], "failed": 0, "metrics": {}}
    if trace:
        s = summary["slice"].summary()
        ops, nbytes = drv.work(summary["delta"])
        read = dict(s, units=summary["delta"]["units"], unit_s=summary["unit_s"], ops=ops,
                    bytes=nbytes, window_counters=delta, peak_ops_per_s=work.PEAK_OPS_PER_S,
                    least_s=work.least_seconds(ops, nbytes))
        for m in cells.per_layer(bench, name):
            v = cells.reader(m["name"])(read)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(drv.end_to_end(wall, delta), setup_s=setup_s)
        for m in cells.end_to_end(bench, name):
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
                        "count": cell.get("chips", 1), "memory_peak_bytes": memory_peak}
    if trace:
        result["device"].update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["top_ops"], "idle_gaps": s["idle"]}
    if cuda:
        line = card_line()
        if line:
            print(f"[portbench] card: {line}", file=sys.stderr)
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = drv.check()
    del drv
    parts = ", ".join(f"{k} {t - t0:.3f}" for (k, t), (_, t0) in
                      zip(marks, [("start", start)] + marks))
    print(f"[portbench] set-up {setup_s:.3f} s ({parts}), window {wall:.3f} s "
          f"({delta['units']} units), reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    limits = cell["limits"]
    result["correct"] = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] forbidden modules loaded: {bad}: no result", file=sys.stderr)
        return None
    for k, v in numbers.items():
        print(f"[portbench] check {k} = {v!r} (limit {limits[k]!r})", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = cells.workload(args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
