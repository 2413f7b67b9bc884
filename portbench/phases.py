"""Time by program phase in one cell, from the program's own spans.

    python3 portbench/phases.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``run.py --trace 1`` does (its driver's set-up, then a
window with a profiled slice from 30% in), then prints one JSON line: the
slice's units, traced seconds and busy seconds, ``spans.attribute``'s
device seconds, synchronisations and idle seconds by innermost span, the
idle labels, and the readings of ``spans.READERS`` that find something to
read.  It checks nothing against the reference; ``run.py`` does.  Where the
driver runs a campaign, its ``redone_words`` counter joins the window's
counters.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run  # noqa: E402  (first: it points the build caches into the checkout)
from portbench import cells, port, spans  # noqa: E402
from portbench import trace as T  # noqa: E402

import torch  # noqa: E402


def phases(name: str, seed: int, seconds: float, device="cuda", overrides=None) -> dict:
    """The cell's reading by phase (``overrides`` replaces traffic
    parameters, as in ``run.run_cell``)."""
    ctx, cell = run.context(name, seed, device, overrides=overrides)
    cuda = ctx.device.type == "cuda"
    mod = cells.driver(cell["driver"])
    port.build_kernels(mod.SOURCES, ctx.device)
    drv = mod.Driver(ctx)
    camp = getattr(drv, "camp", None)
    if camp is not None and hasattr(camp, "redone_words"):
        counters = drv.counters
        drv.counters = lambda: dict(counters(), redone_words=int(camp.redone_words.sum()))
    if cuda:
        T.warm_profiler()
    _, delta, summary = run.window(drv, mod.SPAN, seconds, True, ctx.params["slice_units"], cuda)
    sl = summary["slice"]
    s = dict(sl.summary(), units=summary["delta"]["units"], window_counters=delta)
    s.update(spans.attribute(sl.prof.events()))
    readings = {k: f(s) for k, f in spans.READERS.items()}
    return {"workload": name, "seed": seed, "torch": torch.__version__,
            "card": run.card_line() if cuda else "cpu", "units": s["units"],
            "traced_s_per_unit": s["window_s"] / s["units"], "busy_s": s["busy_s"],
            "device_ops": s["device_ops"],
            "readings": {k: v for k, v in readings.items() if v is not None},
            **{k: s[k] for k in ("spans", "device_s", "syncs", "idle_s", "idle")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[portbench] phases needs a CUDA device: no result", file=sys.stderr)
        return 2
    print(json.dumps(phases(args.workload, args.seed, args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
