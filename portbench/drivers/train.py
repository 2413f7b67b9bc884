"""The train step: ``training/train_loop.py::make_train_step``'s
``step(params, opt_state, llr, bits, lr)`` in a loop, as ``Trainer`` runs
it, on a pool of batches made in set-up.  Set-up builds the one step object,
drives it through its first steps on the pool's first batches, then warms
it up.  The reference checks two stretches of three steps once the window
has closed: the start, from the configuration's initial weights, and three
steps of the window from a step drawn from the seed, from the program's
weights and Adam moments just before it (forward, loss, backward, clip,
Adam and clamp; Adam's step count is the driver's own count of steps)."""

from __future__ import annotations

import random

import torch

from portbench import compare, port, traffic, work
from portbench.reference import graph as G
from portbench.reference import train as R

SPAN = "portbench.train.step"
SOURCES = ("fused_fwd", "fused_bwd")


class Driver:
    def __init__(self, ctx):
        from neural_ldpc_tpu_torch.training import LearningRate, TrainConfig, make_train_step

        self.ctx, p = ctx, ctx.params
        cfg, tr = ctx.cfg, ctx.cfg["training"]
        self.batch, self.lr = p["batch"], tr["learning_rate"]
        self.decoder = port.decoder(cfg, ctx.device)
        tc = TrainConfig(batch_size=self.batch, learning_rate=LearningRate(self.lr, 0.0, 0),
                         grad_clip_norm=tr["grad_clip_norm"], etha=tr["etha"], engine="fused")
        init, step = make_train_step(self.decoder, tc)
        self.step, self.faulty = step, _faulty(step, ctx.fault)
        self.pool = traffic.train_batches(cfg, ctx.shape, self.batch, p["pool_batches"],
                                          ctx.seed, ctx.device)
        self.params = self.decoder.init_params()
        self.opt = init(self.params)
        self.b1, self.checked = tr["adam"]["b1"], p["checked_steps"]
        # checked stretches start at step 0 and at the window's unit k
        k = random.Random(ctx.seed).randrange(p["checked_from"])
        self.window_from = self.checked + p["warmup_units"]
        self.firsts = (0, self.window_from + k)
        self.stretches, self.open, self.steps = [], None, 0
        for _ in range(self.checked + p["warmup_units"]):
            self.unit()

    def unit(self):
        n = self.steps
        if n in self.firsts:
            self.open = _stretch(self.params, self.opt, n)
            self.stretches.append(self.open)
        llr, bits = self.pool[n % len(self.pool)]
        step = self.faulty if n >= self.window_from else self.step
        self.params, self.opt, self.loss = step(self.params, self.opt, llr, bits, self.lr)
        self.steps += 1
        st = self.open
        if st is not None:
            st["loss"].append(self.loss.detach().clone())
            if len(st["loss"]) == 1:
                st["mu_after"] = _clone(self.opt.mu)
            if len(st["loss"]) == self.checked:
                st["end"] = _clone(self.params)
                self.open = None

    def checked_done(self) -> bool:
        return self.steps >= self.firsts[-1] + self.checked

    def counters(self) -> dict:
        return {"units": self.steps}

    def work(self, delta: dict):
        return work.train_steps(self.ctx.shape, self.ctx.cfg["decoder"], self.batch,
                                delta["units"])

    def end_to_end(self, seconds: float, delta: dict) -> dict:
        return {self.ctx.params["step_metric"]: seconds * 1e3 / delta["units"]}

    def release(self):
        size = len(self.pool)
        self.pool = {n: self.pool[n % size] for st in self.stretches
                     for n in range(st["count"], st["count"] + self.checked)}
        del self.decoder, self.step, self.faulty, self.params, self.opt, self.loss

    def check(self) -> dict:
        """The worst of the two stretches' gaps, number by number."""
        ctx, p = self.ctx, self.ctx.params
        t = G.config_tables(ctx.cfg, ctx.device)
        out = {}
        for st in self.stretches:
            n0 = st["count"]
            batches = [self.pool[n] for n in range(n0, n0 + self.checked)]
            ref = R.steps(ctx.cfg, t, batches, block=p["reference_block"],
                          state=st if n0 else None)
            got = {"loss": [float(v) for v in st["loss"]], "start": st["params"],
                   "end": st["end"], "first_grad": {
                       k: (st["mu_after"][k] - self.b1 * st["mu"][k]) / (1 - self.b1)
                       for k in st["mu"]}}
            for k, v in compare.training(got, ref).items():
                out[k] = max(out.get(k, 0.0), v)
        return out


def _clone(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def _stretch(params: dict, opt, count: int) -> dict:
    """The state a checked stretch starts from: the weights, Adam's moments
    and the steps made before it (the driver's count)."""
    return {"params": _clone(params), "mu": _clone(opt.mu), "nu": _clone(opt.nu),
            "count": count, "loss": []}


def _faulty(step, fault):
    """The step, or the step with a fault planted for the tests, which the
    driver runs from the window on: "frozen" returns the state it was
    given, "half" leaves out the second half of the batch, "stale" is fed
    the first batch it saw again and again."""
    if fault is None:
        return step
    if fault == "frozen":
        return lambda p, o, llr, bits, lr: (p, o, step(p, o, llr, bits, lr)[2])
    if fault == "half":
        return lambda p, o, llr, bits, lr: step(p, o, llr[:llr.shape[0] // 2],
                                                 bits[:bits.shape[0] // 2], lr)
    if fault == "stale":
        seen = []

        def stale(p, o, llr, bits, lr):
            seen[:] = seen or [(llr, bits)]
            return step(p, o, *seen[0], lr)
        return stale
    raise ValueError(f"no fault {fault!r} for this driver")


def control(ctx, fault: str | None = None) -> dict:
    """The numbers compared when the reference stands in the program's
    place over the start's stretch: computed in bfloat16 (the control), or
    in float32 with a planted ``fault``; the reference itself runs in
    float32 on the same batches.  A run's numbers are the worst of its two
    stretches, so this reading is the least the control would give."""
    p = ctx.params
    batches = traffic.train_batches(ctx.cfg, ctx.shape, p["batch"], p["checked_steps"],
                                    ctx.seed, ctx.device)
    t = G.config_tables(ctx.cfg, ctx.device)
    ref = R.steps(ctx.cfg, t, batches, block=p["reference_block"])
    dtype = torch.float32 if fault else torch.bfloat16
    got = R.steps(ctx.cfg, t, batches, dtype=dtype, block=p["reference_block"], fault=fault)
    return compare.training(got, ref)
