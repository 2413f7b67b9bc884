#!/usr/bin/env python3
"""A/B timing of the on-chip kernels (K1a, and K1d and K2) of two checkouts on one GPU.

    python3 ab_k1a.py --parent DIR [--batch 1048576] [--reps 5]

``DIR`` holds another checkout of the repo (for example ``git archive`` of
the parent commit, unpacked into a git-ignored directory).  The script runs
one worker process per reading, in the order parent, this tree, this tree,
parent, so that drift of the card's clock or temperature shows up as a
difference between the two readings of one tree.  Each worker imports
``neural_ldpc_tpu_torch`` from its own tree (building that tree's kernels),
decodes the same channel LLRs through ``fused_fwd_k1a`` and reports the mean
time per launch by CUDA events after one warm-up, for wman MS x5 (cn=3,
random weights from seed 0) and BG2 QMS x20 (cn=3 vn=3, trained weights);
and, on the BG2 decoder at 16,384 words, the training forward
``fused_fwd_k1d`` and the backward ``fused_bwd_k2`` on a seeded cotangent.
Each reading carries a checksum of the kernel's output (the APP, the
outputs, the channel gradient) so that the two trees can be seen to compute
the same thing.  Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (name, code, decoder type, sharing, iterations, trained weights, snr_db)
CASES = [
    ("wman_ms5", "wman_n576_r34_z24", "MS", dict(cn=3), 5, None, 3.5),
    ("bg2_qms20", "nr_bg2_set0_z16", "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 2.0),
]
TRAIN_BATCH = 16384  # chip_smoke.py's timing batch of K1d and K2


def _timed(run, reps):
    """(mean ms of ``run`` by CUDA events after one warm-up, its result)."""
    import torch

    res = run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, res


def _reading(ms, t):
    return dict(ms=ms, sum=float(t.double().sum()), neg=int((t < 0).sum()))


def worker(tree: str, batch: int, reps: int) -> dict:
    """Time the kernels of the package in ``tree`` on every case."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import neural_ldpc_tpu_torch
    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz, params_from_numpy)
    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, fused_bwd_k2, fused_fwd_k1a, fused_fwd_k1d)
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig

    pkg = os.path.dirname(os.path.abspath(neural_ldpc_tpu_torch.__file__))
    if pkg != os.path.join(os.path.abspath(tree), "neural_ldpc_tpu_torch"):
        raise RuntimeError(f"imported the package from {pkg}, not from {tree}")
    device = torch.device("cuda", 0)
    out = {}
    for name, code_name, dt, sharing, iters, weights, snr in CASES:
        code = get_code(code_name)
        graph = TannerGraph.from_basegraph(code.basegraph, code.Z)
        dec = BoostedNeuralDecoder(graph, BoostedDecoderConfig(
            n_iterations=iters, decoder_type=DecoderType[dt], qms_qbit=5,
            sharing=NodeWeightSharingConfig(**sharing)), device=device)
        if weights:
            params = load_params_npz(os.path.join(tree, "trained", weights), device)
        else:
            rng = np.random.default_rng(0)
            params = params_from_numpy({
                k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
                for k, v in dec.init_params().items()}, device)
        fused = FusedMinsumDecoder.from_decoder(dec, params)
        ch = AWGNChannel(code, ChannelConfig(snr_db=(snr,), qms_qbit=5 if dt == "QMS" else None),
                         device=device)
        llr, _ = ch.sample_at(ch.generator(int(snr * 10)), batch, 0, all_zero=True)
        chan = llr.reshape(batch, -1)
        lay, w = fused.layout, fused._w
        out[name] = _reading(*_timed(lambda: fused_fwd_k1a(chan, lay, *w), reps))
        del llr, chan
        if name != "bg2_qms20":
            continue
        # the training kernels at chip_smoke.py's timing batch
        chan_t = ch.sample_at(ch.generator(7), TRAIN_BATCH, 0)[0].reshape(TRAIN_BATCH, -1)
        ms, (outs, st) = _timed(lambda: fused_fwd_k1d(chan_t, lay, *w), reps)
        out[f"{name}_k1d"] = _reading(ms, outs)
        g = torch.randn(outs.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(3))
        ms, grads = _timed(lambda: fused_bwd_k2(chan_t, lay, *w, st, outs, g), reps)
        out[f"{name}_k2"] = _reading(ms, grads[4])  # the quantized channel's gradient
        del chan_t, outs, st, g, grads
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="directory of the other checkout")
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.batch, args.reps)), flush=True)
        return 0
    parent = os.path.abspath(args.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    readings = []
    for label, tree in (("parent", parent), ("change", HERE), ("change", HERE),
                        ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--parent", parent,
                            "--batch", str(args.batch), "--reps", str(args.reps),
                            "--worker", tree], capture_output=True, text=True, cwd=tree)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(r.stdout.strip().splitlines()[-1])
        readings.append(dict(tree=label, **res))
        print(f"[ab] {label}: " + ", ".join(f"{k} {v['ms']:.3f} ms" for k, v in res.items()),
              flush=True)
    for name in readings[0]:
        if name != "tree" and len({(r[name]["sum"], r[name]["neg"]) for r in readings}) != 1:
            print(f"ab_k1a: FAIL: the trees' outputs differ on {name}", file=sys.stderr)
            return 1
    print(json.dumps({"batch": args.batch, "reps": args.reps, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
