"""Profiling CLI (port of ``neural_ldpc_tpu.cli.profile``): time the
decode/train hot paths and optionally capture a trace.

  # steady-state decode/train latency + throughput table
  python -m neural_ldpc_tpu_torch.cli.profile --preset boosted_error_floor

  # capture a Chrome/Perfetto trace of the fused decode
  python -m neural_ldpc_tpu_torch.cli.profile --trace-dir traces --only decode_fused

The same flags as the JAX CLI plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch paths).  Jobs: ``decode_xla``, the plain decoder's
final APP (the name is the JAX job's); ``decode_fused``,
``FusedMinsumDecoder`` (the forward kernel, K1a, on the card); ``train``, one
``make_train_step`` step.  On the card it ends with each kernel wrapper's
launch count over the run.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="profile decode/train hot paths")
    p.add_argument("--preset", default="bg2_qms_train")
    p.add_argument("--config", help="ExperimentConfig JSON file")
    p.add_argument("--batch-size", type=int, default=16384, help="decode batch")
    p.add_argument("--train-batch-size", type=int, default=128)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--trace-dir", help="capture a torch.profiler trace here")
    p.add_argument("--only", choices=("decode_fused", "decode_xla", "train"),
                   help="profile a single path")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from neural_ldpc_tpu_torch.device import resolve_device
    from neural_ldpc_tpu_torch.models import BoostedNeuralDecoder
    from neural_ldpc_tpu_torch.ops.cuda import WRAPPERS, FusedMinsumDecoder
    from neural_ldpc_tpu_torch.training import TrainConfig, make_train_step
    from neural_ldpc_tpu_torch.utils.config import ExperimentConfig, get_preset
    from neural_ldpc_tpu_torch.utils.profiling import benchmark, block_until_ready, trace

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = get_preset(args.preset)

    device = resolve_device(args.device)
    code, graph = cfg.build_graph()
    channel = cfg.build_channel(code, device=device)
    decoder = BoostedNeuralDecoder(graph, cfg.build_decoder_config(), device=device)
    params = decoder.init_params()
    rng = np.random.default_rng(0)
    for w in WRAPPERS:
        w.launches = w.cuda_launches = 0

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})  code: {code.name}  "
          f"decoder: {cfg.decoder_type.name} x{cfg.n_iterations} iters")

    jobs = {}

    B = args.batch_size
    x = torch.as_tensor(rng.normal(size=(B, code.N, code.Z)).astype(np.float32) * 4,
                        device=device)

    @torch.no_grad()
    def decode_xla():
        return decoder.apply(params, x)[-1]

    jobs["decode_xla"] = (decode_xla, B)

    try:
        fused = FusedMinsumDecoder.from_decoder(decoder, params)
        jobs["decode_fused"] = (lambda: fused(x), B)
    except ValueError as e:  # a code the kernels do not take
        print(f"decode_fused: skipped ({e})")

    TB = args.train_batch_size
    tcfg = TrainConfig(batch_size=TB)
    init_opt, step = make_train_step(decoder, tcfg)
    opt_state = init_opt(params)
    llr, bits = channel.sample_mixed(channel.generator(0), TB, all_zero=cfg.y_all_zero)

    def train_once():
        return step(params, opt_state, llr, bits, 1e-3)

    jobs["train"] = (train_once, TB)

    selected = [args.only] if args.only else list(jobs)
    for job in selected:
        if job not in jobs:
            continue
        fn, items = jobs[job]
        res = benchmark(fn, reps=args.reps, items_per_call=items)
        print(f"{job:<14} {res}")
        if args.trace_dir:
            with trace(args.trace_dir):
                block_until_ready(fn())
            print(f"{job:<14} trace written to {args.trace_dir}")
    if device.type == "cuda":
        print("kernel launches: " + ", ".join(
            f"{w.__name__} {w.launches}" for w in WRAPPERS if w.launches))
    return 0


if __name__ == "__main__":
    sys.exit(main())
