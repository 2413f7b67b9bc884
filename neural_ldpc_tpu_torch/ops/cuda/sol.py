"""Speed-of-light probe of the card's fp32 instruction rate: the
hand-written CUDA kernel ``csrc/sol_probe.cu`` (ROADMAP kernel "K7"), its
plain PyTorch version and ``measure_sol``.

K7 replaces ``scripts/mfu_r4.py::_sol_kernel`` (the "decode_mix" chain that
``measure_sol`` times there): per element a, NACC = 8 accumulators
a * (0.25 + 0.125 k) run CHAIN = 64 steps of ``min(|acc - a|, a + acc *
0.001)``, 5 counted operations a step, and the output is their sum * 0.0625.
The rate is counted as the TPU script counts it (``mfu_r4.py:81, 105``):
GRID * ROWS * COLS * CHAIN * NACC * 5 operations per launch, launches
chained so that each consumes the previous output.  It sits on no decode
path: it measures what the fp32 lanes execute, for comparison with the data
sheet's 33.5e12 instructions per second that the kernels' bounds use.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from .fused_train import _call_kernel, _ptr

ROWS, COLS, CHAIN, GRID, NACC = 256, 512, 64, 256, 8  # mfu_r4.py:56
OPS_PER_STEP = 5  # sub, abs, mul, add, min (mfu_r4.py:81)


def sol_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7, the TPU kernel's operations in order."""
    accs = [x * (0.25 + 0.125 * k) for k in range(NACC)]
    for _ in range(CHAIN):
        accs = [torch.minimum((acc - x).abs(), x + acc * 0.001) for acc in accs]
    total = accs[0]
    for acc in accs[1:]:
        total = total + acc
    return total * 0.0625


def sol_k7(x: torch.Tensor) -> torch.Tensor:
    """One pass of the probe over float32 ``x`` (any shape).  A CUDA tensor
    launches K7 (and raises if it cannot); a CPU tensor runs ``sol_plain``.
    ``sol_k7.launches`` counts kernel launches."""
    if x.dtype != torch.float32:
        raise ValueError(f"x: expected float32, got {x.dtype}")
    if x.device.type == "cpu":
        return sol_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.numel() >= 2**31:
        raise ValueError("the probe takes fewer than 2^31 elements")
    x = x.contiguous()
    out = torch.empty_like(x)
    sol_k7.cuda_launches += _call_kernel(
        "sol_probe", "sol_probe launch", _ptr(x), _ptr(out), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    sol_k7.launches += 1
    return out


sol_k7.launches = 0  # calls that launched
sol_k7.cuda_launches = 0  # CUDA kernels they launched, as the C entry point counts them


def sol_input(device: DeviceLike = "cuda", rows: int = GRID * ROWS, seed: int = 0) -> torch.Tensor:
    """The probe's input: uniform in [0.5, 1.5) from numpy's ``seed``, as
    ``mfu_r4.py:82-84`` makes it, [rows, COLS] float32."""
    x = np.random.default_rng(seed).uniform(0.5, 1.5, size=(rows, COLS)).astype(np.float32)
    return torch.as_tensor(x, device=resolve_device(device))


def measure_sol(device: DeviceLike = "cuda", reps: int = 10) -> dict:
    """The probe's measured rate on the card (``mfu_r4.py::measure_sol``):
    one warm-up launch, then ``reps`` chained launches timed by CUDA events.
    Refuses a device other than a GPU: the rate is a device metric."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_sol times the GPU kernel; got device {dev}")
    x = sol_k7(sol_input(dev))
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        x = sol_k7(x)  # chained: each launch consumes the previous output
    end.record()
    torch.cuda.synchronize(dev)
    launch_s = start.elapsed_time(end) / reps / 1e3
    total_ops = GRID * ROWS * COLS * CHAIN * NACC * OPS_PER_STEP
    return {"ops_per_launch": total_ops, "launch_ms": launch_s * 1e3, "n_acc": NACC,
            "finite": bool(torch.isfinite(x).all()), "instr_per_s": total_ops / launch_s}
