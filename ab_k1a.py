#!/usr/bin/env python3
"""A/B timing of the forward and backward kernels (K1a, K1d, K2, K3 and K6's forward) of two checkouts on one GPU.

    python3 ab_k1a.py --parent DIR [--batch 1048576] [--reps 5] [--cases all|k3]

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
After all of these, the matmul-routed forward ``fused_fwd_k6`` (K6) decodes
the same inputs (int8 routing on BG2, split-3 on wman) and runs BG2's
training forward (stream + store) at 16,384 words; it also decodes the
E = 1100 protograph (``codes.protograph.dense_protograph``, MS x10 cn=3,
7 dB) at 262,144 words.  A tree without K6 skips its cases.  Each reading carries a checksum of the
kernel's output (the APP, the outputs, the channel gradient) so that the two
trees can be seen to compute the same thing; cases that a tree skips are
compared between the trees that ran them.  Last, ``cuobjdump -sass`` of
each tree's built forward and backward libraries counts the instructions in
which the roll instantiations (K1, K2: ROUTE = 0) of the two trees differ.
Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import difflib
import glob
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (name, code, decoder type, sharing, iterations, trained weights, snr_db)
CASES = [
    ("wman_ms5", "wman_n576_r34_z24", "MS", dict(cn=3), 5, None, 3.5),
    ("bg2_qms20", "nr_bg2_set0_z16", "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 2.0),
]
TRAIN_BATCH = 16384  # chip_smoke.py's timing batch of K1d and K2
DENSE_BATCH = 262144  # chip_smoke.py's path (f) decode batch
DENSE_SNR = 7.0
# K3 on the BG1-like code, chip_smoke.py's paths (a), (b) and (c):
# (name, Z, iterations, trained weights, snr_db, batch, mode)
K3_CASES = [
    ("bg1z384_ms20_k3_app", 384, 20, "bg1_ms20_z384_post.npz", 2.5, 32768, "app"),
    ("bg1z384_ms10i5_k3_stats", 384, 5, "bg1_ms10_z256_hi.npz", 2.5, 32768, "stats"),
    ("bg1z256_ms10_k3_stream", 256, 10, "bg1_ms10_z256_hi.npz", 3.0, 2048, "stream"),
]
K3_SOURCES = ("fused_fwd_dm", "fused_fwd_cl")  # K3's sources before and after its redesign


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


def _profile_kernels(run) -> dict:
    """{CUDA kernel name: calls, device ms, the profiler's estimate of its
    achieved occupancy in %} over one ``run()``, from a ``torch.profiler``
    trace."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        r = out.setdefault(e["name"][:120], dict(calls=0, ms=0.0, occupancy_pct=None))
        r["calls"] += 1
        r["ms"] += e.get("dur", 0) / 1e3
        occ = e.get("args", {}).get("est. achieved occupancy %")
        if occ is not None:
            r["occupancy_pct"] = occ
    return out


def _k3_cases(tree, device, reps, out) -> None:
    """Times ``fused_fwd_k3`` on K3_CASES into ``out``, profiles case (a)
    once and adds ptxas' lines of K3's kernels where this process built
    them."""
    import torch

    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.codes import TannerGraph
    from neural_ldpc_tpu_torch.codes.protograph import nr_bg1_like
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz)
    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, _build, fused_fwd_k3
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig

    for name, Z, iters, weights, snr, batch, mode in K3_CASES:
        code = nr_bg1_like(Z)
        dec = BoostedNeuralDecoder(
            TannerGraph.from_basegraph(code.basegraph, Z),
            BoostedDecoderConfig(n_iterations=iters, decoder_type=DecoderType.MS,
                                 sharing=NodeWeightSharingConfig(cn=3)), device=device)
        params = {k: v[:iters] for k, v in
                  load_params_npz(os.path.join(tree, "trained", weights), device).items()}
        fused = FusedMinsumDecoder.from_decoder(dec, params)
        lay, w = fused.layout, fused._w
        ch = AWGNChannel(code, ChannelConfig(snr_db=(snr,)), device=device)
        chan = ch.sample_at(ch.generator(int(snr * 10)), batch, 0, all_zero=True)[0].reshape(
            batch, -1)
        ms, res = _timed(lambda: fused_fwd_k3(chan, lay, *w, mode=mode), reps)
        if mode == "stream":
            outs, st = res
            r = _reading(ms, outs)
            r["store_sum"] = float(st.sum(dtype=torch.float64))
        else:
            r = _reading(ms, res)
        r["kernel"] = getattr(lay, "k3_kernel", "two-pass")
        out[name] = r
        if mode == "app":
            out[f"{name}_profile"] = _profile_kernels(lambda: fused_fwd_k3(chan, lay, *w))
        del chan, res
    for src in K3_SOURCES:
        lines = [ln.strip() for ln in _build.build_log.get(src, "").splitlines()
                 if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        if lines:
            out[f"{src}_ptxas"] = lines


def _random_params(dec, params_from_numpy, device):
    import numpy as np

    rng = np.random.default_rng(0)
    return params_from_numpy({
        k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
        for k, v in dec.init_params().items()}, device)


def worker(tree: str, batch: int, reps: int, cases: str = "all") -> dict:
    """Time the kernels of the package in ``tree`` on every case (``cases``
    "k3": K3's only)."""
    sys.path.insert(0, tree)
    import torch

    import neural_ldpc_tpu_torch
    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz, params_from_numpy)
    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, fused_bwd_k2, fused_fwd_k1a, fused_fwd_k1d)
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
    try:
        from neural_ldpc_tpu_torch.codes.protograph import dense_protograph
        from neural_ldpc_tpu_torch.ops.cuda import FusedTrainDecoder, fused_fwd_k6
    except ImportError:  # a tree before K6
        fused_fwd_k6 = None

    pkg = os.path.dirname(os.path.abspath(neural_ldpc_tpu_torch.__file__))
    if pkg != os.path.join(os.path.abspath(tree), "neural_ldpc_tpu_torch"):
        raise RuntimeError(f"imported the package from {pkg}, not from {tree}")
    device = torch.device("cuda", 0)
    out = {}
    if cases == "k3":
        _k3_cases(tree, device, reps, out)
        return out
    cases = {}
    for name, code_name, dt, sharing, iters, weights, snr in CASES:
        code = get_code(code_name)
        graph = TannerGraph.from_basegraph(code.basegraph, code.Z)
        dec = BoostedNeuralDecoder(graph, BoostedDecoderConfig(
            n_iterations=iters, decoder_type=DecoderType[dt], qms_qbit=5,
            sharing=NodeWeightSharingConfig(**sharing)), device=device)
        if weights:
            params = load_params_npz(os.path.join(tree, "trained", weights), device)
        else:
            params = _random_params(dec, params_from_numpy, device)
        fused = FusedMinsumDecoder.from_decoder(dec, params)
        ch = AWGNChannel(code, ChannelConfig(snr_db=(snr,), qms_qbit=5 if dt == "QMS" else None),
                         device=device)
        cases[name] = (dec, params, ch, snr)
        chan = ch.sample_at(ch.generator(int(snr * 10)), batch, 0, all_zero=True)[0].reshape(
            batch, -1)
        lay, w = fused.layout, fused._w
        out[name] = _reading(*_timed(lambda: fused_fwd_k1a(chan, lay, *w), reps))
        del chan
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
    # K3 after the roll kernels and before any K6 launch
    _k3_cases(tree, device, reps, out)
    if fused_fwd_k6 is None:
        return out
    # K6 after every roll kernel: its time differs between the trees, and the
    # roll readings must not follow different loads of the card
    for name, (dec, params, ch, snr) in cases.items():
        chan = ch.sample_at(ch.generator(int(snr * 10)), batch, 0, all_zero=True)[0].reshape(
            batch, -1)
        mm = FusedTrainDecoder.from_decoder(dec, routing="matmul", store_msgs=False)
        lay, w = mm.layout, mm.pack_weights(*dec._expanded_weights(params))
        # int8 routing for QMS, split-3 otherwise
        out[f"{name}_k6_{lay.routing}"] = _reading(
            *_timed(lambda: fused_fwd_k6(chan, lay, *w), reps))
        del chan
        if name != "bg2_qms20":
            continue
        chan_t = ch.sample_at(ch.generator(7), TRAIN_BATCH, 0)[0].reshape(TRAIN_BATCH, -1)
        tlay = FusedTrainDecoder.from_decoder(dec, routing="matmul").layout
        ms, (outs, st) = _timed(lambda: fused_fwd_k6(chan_t, tlay, *w, mode="stream"), reps)
        out[f"{name}_k6_{tlay.routing}_train"] = _reading(ms, outs)
        del chan_t, outs, st
    # path (f) of chip_smoke.py: "auto" routes E > 1024 by K6
    code = dense_protograph()
    dec = BoostedNeuralDecoder(TannerGraph.from_basegraph(code.basegraph, code.Z),
                               BoostedDecoderConfig(
                                   n_iterations=10, decoder_type=DecoderType.MS,
                                   sharing=NodeWeightSharingConfig(cn=3)), device=device)
    fused = FusedMinsumDecoder.from_decoder(dec, _random_params(dec, params_from_numpy, device))
    ch = AWGNChannel(code, ChannelConfig(snr_db=(DENSE_SNR,)), device=device)
    chan = ch.sample_at(ch.generator(41), DENSE_BATCH, 0, all_zero=True)[0].reshape(
        DENSE_BATCH, -1)
    lay, w = fused.layout, fused._w
    out[f"dense_e{lay.E}_k6_{lay.routing}"] = _reading(
        *_timed(lambda: fused_fwd_k6(chan, lay, *w), reps))
    return out


def roll_sass(tree: str) -> dict:
    """{"<kernel><MAXD, roll>": [instruction, ...]} of the roll
    instantiations (ROUTE = 0) in ``tree``'s built fused_fwd and fused_bwd
    libraries, each instruction without its address and encoding and with
    the targets of branches and calls, which move with the code before them,
    written as 0x*; {} where cuobjdump or a library is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in ("fused_fwd", "fused_bwd"):
        libs = sorted(glob.glob(os.path.join(tree, "neural_ldpc_tpu_torch", "csrc", "build",
                                             f"lib{name}-*.so")), key=os.path.getmtime)
        if not libs or not os.path.exists(tool):
            continue
        r = subprocess.run([tool, "-sass", libs[-1]], capture_output=True, text=True, timeout=300)
        for fn in re.split(r"\n\s*Function : ", r.stdout)[1:]:
            head, _, body = fn.partition("\n")
            m = re.search(r"(fused_(?:fwd|bwd)_kernel)ILi(\d+)ELi0E", head)
            if not m:
                continue
            ins = []
            for text in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body):
                text = " ".join(text.split())
                if re.search(r"\b(BRA|CALL|BSSY|JMP|BRX|JMX)\b", text):
                    text = re.sub(r"0x[0-9a-f]+\s*$", "0x*", text)
                ins.append(text)
            out[f"{m.group(1)}<{m.group(2)}, roll>"] = ins
    return out


def compare_roll_sass(tree: str, parent: str) -> dict:
    """{kernel: instructions of its roll instantiation in ``tree`` and in
    ``parent``, and how many differ (insertions, deletions and
    replacements)}; prints the first differing ones."""
    here, there = roll_sass(tree), roll_sass(parent)
    res = {}
    for k in sorted(set(here) & set(there)):
        a, b = here[k], there[k]
        ops = [op for op in difflib.SequenceMatcher(None, b, a, autojunk=False).get_opcodes()
               if op[0] != "equal"]
        n = sum(max(i2 - i1, j2 - j1) for _, i1, i2, j1, j2 in ops)
        res[k] = dict(instructions=len(a), parent_instructions=len(b), differing=n)
        if n:
            first = [(b[i1:i2][:2], a[j1:j2][:2]) for _, i1, i2, j1, j2 in ops[:4]]
            print(f"[ab] {k}: {n} of {len(a)} instructions differ from the parent's "
                  f"{len(b)}; the first (parent, this tree): {first}", flush=True)
    print(f"[ab] roll instantiations' SASS against the parent: {res}", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="directory of the other checkout")
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cases", choices=("all", "k3"), default="all",
                    help="k3: only K3's cases")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.batch, args.reps, args.cases)), flush=True)
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
                            "--cases", args.cases, "--worker", tree], capture_output=True, text=True, cwd=tree)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(r.stdout.strip().splitlines()[-1])
        readings.append(dict(tree=label, **res))
        print(f"[ab] {label}: " + ", ".join(f"{k} {v['ms']:.3f} ms" for k, v in res.items()
                                            if isinstance(v, dict) and "ms" in v and "sum" in v),
              flush=True)
    for name in {k for r in readings for k, v in r.items() if isinstance(v, dict) and "sum" in v}:
        if len({(r[name]["sum"], r[name]["neg"], r[name].get("store_sum"))
                for r in readings if name in r}) != 1:
            print(f"ab_k1a: FAIL: the trees' outputs differ on {name}", file=sys.stderr)
            return 1
    sass = compare_roll_sass(HERE, parent)
    print(json.dumps({"batch": args.batch, "reps": args.reps, "readings": readings,
                      "roll_sass": sass}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
