"""The Monte-Carlo campaign: ``eval/montecarlo.py::MonteCarloCampaign``'s
``run_snr_point`` over one window of batches a call, at one SNR, on
all-zero words the kernel samples itself.  Set-up builds the campaign and
runs its first batches, in which the auto-guard probes early exit against
the full unroll.  The reference recounts one call of the window, drawn
from the seed: the sampler, the first stage, the compaction and
escalation, and the counters."""

from __future__ import annotations

import random

import torch

from portbench import port, traffic, work
from portbench.reference import campaign as R
from portbench.reference import decoder as D
from portbench.reference import graph as G
from portbench.reference import sampler

SPAN = "portbench.campaign.run_snr_point"
SOURCES = ("fused_fwd",)


class Driver:
    def __init__(self, ctx):
        from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
        from neural_ldpc_tpu_torch.codes import CodeSpec
        from neural_ldpc_tpu_torch.eval.montecarlo import CampaignConfig, MonteCarloCampaign
        from neural_ldpc_tpu_torch.models.boosted_decoder import params_from_numpy

        self.ctx, p = ctx, ctx.params
        self.weights = port.weights(ctx.cfg)
        dec = port.decoder(ctx.cfg, ctx.device)
        code = ctx.cfg["code"]
        channel = AWGNChannel(CodeSpec(code["name"], G.read_basegraph(code["basegraph"]),
                                       code["Z"]),
                              ChannelConfig(snr_db=(p["snr_db"],)), device=ctx.device)
        self.batch, self.per_call = p["batch"], p["sync_every_batches"]
        self.camp = MonteCarloCampaign(dec, params_from_numpy(self.weights, ctx.device), channel,
                                       CampaignConfig(
            batch_size=self.batch, max_words_per_snr=1 << 62, min_frame_errors=0,
            engine="fused", sync_every_batches=self.per_call, seed=ctx.seed,
            early_exit_iters=p["early_exit_iters"], early_exit_capacity=p["early_exit_capacity"],
            early_exit_probe_batches=p["early_exit_probe_batches"],
            early_exit_auto_guard=p["early_exit_auto_guard"],
            kernel_channel_sampling=p["kernel_channel_sampling"]))
        if ctx.fault == "altered":  # a bit and a frame error added to each batch's counts
            for name in ("_ee_step", "_exact_step"):
                setattr(self.camp, name, _altered(getattr(self.camp, name)))
        elif ctx.fault is not None:
            raise ValueError(f"no fault {ctx.fault!r} for this driver")
        self.camp.run_snr_point(0, batches=p["setup_batches"])
        self.calls = 0
        self.checked_call = random.Random(ctx.seed).randrange(p["checked_calls_from"])
        self.checked = None

    def unit(self):
        c = self.camp
        before = (int(c.words[0]), float(c.bit_errors[0, -1]), float(c.frame_errors[0, -1]),
                  int(c.escalations[0]))
        c.run_snr_point(0, batches=self.per_call)
        if self.calls == self.checked_call:
            self.checked = {"keys_before": before[0] // self.batch,
                            "bit_errors": float(c.bit_errors[0, -1]) - before[1],
                            "frame_errors": float(c.frame_errors[0, -1]) - before[2],
                            "escalations": int(c.escalations[0]) - before[3]}
        self.calls += 1

    def checked_done(self) -> bool:
        return self.checked is not None

    def counters(self) -> dict:
        return {"units": self.calls, "words": self.calls * self.per_call * self.batch,
                "escalations": int(self.camp.escalations[0])}

    def work(self, delta: dict):
        return work.campaign(self.ctx.shape, self.ctx.cfg["decoder"], delta["words"],
                             delta["escalations"], self.ctx.params["early_exit_iters"])

    def end_to_end(self, seconds: float, delta: dict) -> dict:
        return {"campaign_words_per_s": delta["words"] / seconds}

    def release(self):
        del self.camp

    def check(self) -> dict:
        ctx, p = self.ctx, self.ctx.params
        if self.checked is None:
            raise RuntimeError("the window ended before its checked call")
        gen = torch.Generator().manual_seed(ctx.seed)
        for _ in range(self.checked["keys_before"]):
            sampler.next_key(gen)
        seeds = [sampler.kernel_seed(sampler.next_key(gen)) for _ in range(self.per_call)]
        t = G.config_tables(ctx.cfg, ctx.device)
        cn, vn = D.iteration_weights(ctx.cfg["decoder"], self.weights, ctx.device)
        if vn is not None:
            raise ValueError("the campaign's reference takes CN weights only")
        sig = float(traffic.sigma([p["snr_db"]], ctx.shape.rate)[0])
        be, fe, esc = R.counts(t, ctx.cfg["decoder"], cn, sig, seeds, self.batch,
                               p["early_exit_iters"], block=p["reference_block"])
        return numbers(self.checked, {"bit_errors": be, "frame_errors": fe, "escalations": esc})


def numbers(got: dict, ref: dict) -> dict:
    """Count gaps of one call: bit and frame errors absolute, first-stage
    failures (escalations) relative."""
    return {"bit_error_gap": abs(got["bit_errors"] - ref["bit_errors"]),
            "frame_error_gap": abs(got["frame_errors"] - ref["frame_errors"]),
            "escalation_gap": abs(got["escalations"] - ref["escalations"])
            / max(ref["escalations"], 1)}


def _altered(step):
    def altered(*args):
        r = step(*args)
        if isinstance(r, tuple):
            counts, nf = r
            return counts + torch.tensor([[1], [1]], dtype=counts.dtype, device=counts.device), nf
        return r + torch.tensor([[1], [1]], dtype=r.dtype, device=r.device)
    return altered


def control(ctx, fault: str | None = None) -> dict:
    """The numbers compared when the reference, computed in bfloat16, stands
    in the program's place, over the seed's first call of batches."""
    if fault is not None:
        raise ValueError("the campaign's control plants no fault")
    p = ctx.params
    gen = torch.Generator().manual_seed(ctx.seed)
    seeds = [sampler.kernel_seed(sampler.next_key(gen)) for _ in range(p["sync_every_batches"])]
    t = G.config_tables(ctx.cfg, ctx.device)
    cn, _ = D.iteration_weights(ctx.cfg["decoder"], port.weights(ctx.cfg), ctx.device)
    sig = float(traffic.sigma([p["snr_db"]], ctx.shape.rate)[0])
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        be, fe, esc = R.counts(t, ctx.cfg["decoder"], cn, sig, seeds, p["batch"],
                               p["early_exit_iters"], dtype=dtype, block=p["reference_block"])
        out.append({"bit_errors": be, "frame_errors": fe, "escalations": esc})
    return numbers(out[1], out[0])
