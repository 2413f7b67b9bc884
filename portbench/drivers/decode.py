"""The decode entry: ``ops/cuda/minsum.py::FusedMinsumDecoder.__call__`` in
a closed loop, one caller with one call in flight, each call synchronised
before the next, on LLR batches made in set-up and fed in turn.  The
reference decodes the batches of calls drawn from the seed and is held to
their APP."""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench import port, traffic, work
from portbench.reference import decode as R
from portbench.reference import decoder as D
from portbench.reference import graph as G

SPAN = "portbench.decode.call"
SOURCES = ("fused_fwd",)


class Driver:
    def __init__(self, ctx):
        from neural_ldpc_tpu_torch.models.boosted_decoder import params_from_numpy
        from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder

        self.ctx, p = ctx, ctx.params
        self.weights = port.weights(ctx.cfg)
        dec = port.decoder(ctx.cfg, ctx.device)
        self.fused = FusedMinsumDecoder.from_decoder(
            dec, params_from_numpy(self.weights, ctx.device))
        if ctx.fault not in (None, "altered"):
            raise ValueError(f"no fault {ctx.fault!r} for this driver")
        self.batch = p["batch"]
        self.llrs = traffic.all_zero_batches(ctx.shape, p["snr_db"], self.batch,
                                             p["llr_batches"], ctx.seed, ctx.device)
        rng = random.Random(ctx.seed)
        self.checked_calls = set(rng.sample(range(p["checked_calls_from"]), p["checked_calls"]))
        self.kept = {}
        self.calls = 0
        self.latencies = []
        for k in range(p["warmup_units"]):
            self.fused(self.llrs[k % len(self.llrs)])
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def unit(self):
        k = self.calls
        t0 = time.perf_counter()
        out = self.fused(self.llrs[k % len(self.llrs)])
        if self.ctx.fault == "altered":
            out[0, 0] += 1.0
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        self.latencies.append(time.perf_counter() - t0)
        if k in self.checked_calls:
            self.kept[k] = out
        self.calls += 1

    def checked_done(self) -> bool:
        return len(self.kept) == len(self.checked_calls)

    def counters(self) -> dict:
        return {"units": self.calls, "words": self.calls * self.batch}

    def work(self, delta: dict):
        return work.decodes(self.ctx.shape, self.ctx.cfg["decoder"], delta["words"])

    def end_to_end(self, seconds: float, delta: dict) -> dict:
        return {"decode_words_per_s": delta["words"] / seconds,
                "decode_p95_ms": float(np.percentile(self.latencies, 95)) * 1e3}

    def release(self):
        del self.fused

    def check(self) -> dict:
        ctx = self.ctx
        if len(self.kept) < len(self.checked_calls):
            raise RuntimeError("the window ended before its checked calls")
        t = G.config_tables(ctx.cfg, ctx.device)
        cn, vn = D.iteration_weights(ctx.cfg["decoder"], self.weights, ctx.device)
        gap = 0.0
        for k, out in sorted(self.kept.items()):
            ref = R.app(t, ctx.cfg["decoder"], cn, vn, self.llrs[k % len(self.llrs)],
                        block=ctx.params["reference_block"])
            gap = max(gap, float((out - ref).abs().max()))
            del ref
        return {"app_gap": gap}


def control(ctx, fault: str | None = None) -> dict:
    """The numbers compared when the reference, computed in bfloat16, stands
    in the program's place, on the seed's first LLR batch."""
    if fault is not None:
        raise ValueError("the decode's control plants no fault")
    p = ctx.params
    llr = traffic.all_zero_batches(ctx.shape, p["snr_db"], p["batch"], 1, ctx.seed,
                                   ctx.device)[0]
    t = G.config_tables(ctx.cfg, ctx.device)
    cn, vn = D.iteration_weights(ctx.cfg["decoder"], port.weights(ctx.cfg), ctx.device)
    ref = R.app(t, ctx.cfg["decoder"], cn, vn, llr, block=p["reference_block"])
    got = R.app(t, ctx.cfg["decoder"], cn, vn, llr, dtype=torch.bfloat16,
                block=p["reference_block"])
    return {"app_gap": float((got - ref).abs().max())}
