#!/usr/bin/env python3
"""A/B timing of the forward and backward kernels (K1a-K1d, K2, K3, K4, K5 and K6) of two checkouts on one GPU.

    python3 ab_k1a.py --parent DIR [--batch 1048576] [--reps 5] [--cases all|k2|k3|k4|sass]

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
After all of these, K6 (the forward on a matmul-routed layout, which K1's
mode wrappers launch) decodes the same inputs (int8 routing on BG2, split-3 on wman) and runs BG2's
training forward (stream + store) at 16,384 words; it also decodes the
E = 1100 protograph (``codes.protograph.dense_protograph``, MS x10 cn=3,
7 dB) at 262,144 words.  Then the legacy engine ``fused_legacy_k5`` (K5)
decodes the wman inputs in bf16 and f32 routing and the BG2 inputs in int8,
and K6's backward (``fused_bwd_k2`` on the matmul layout) runs on its
training forward's outputs
with a seeded cotangent: BG2 int8 with bf16 and with f32 cotangents and
wman split-3 at 16,384 words, the E = 1100 protograph at 256.  A tree
without K6 skips its cases.  Last, the big codes' backward ``fused_bwd_k4``
(K4) runs on path (c)'s decoder of ``chip_smoke.py`` (the BG1-like code at
Z = 256, MS x10 cn=3) at 64 and 2,048 words on K3's training forward's
outputs and a seeded cotangent, its channel gradient as checksum and its CN
weights' gradient compared within 1e-4 of its magnitude.  Each reading carries a checksum of the
kernel's output (the APP, the outputs, the channel gradient) so that the two
trees can be seen to compute the same thing; cases that a tree skips are
compared between the trees that ran them.  Between the roll kernels and K3,
the wman campaign's phase 1 (MS x10 trained, cut to I1 = 2 iterations,
5.5 dB) runs over the whole batch with the channel sampled in the kernel
(``fused_fwd_k1c``) and read (``fused_fwd_k1b``), with the stats as
checksum.  K2 also runs at the reference's batch of 20.  K4's and K6's
backward readings carry their CN weights' gradient sum, compared within
1e-4 of its magnitude (the trees sum the partials in another order).
Last, ``cuobjdump -sass`` of each tree's built forward and
backward libraries counts the instructions in which the instantiations of
the two trees differ (``SASS_GATED``): every forward instantiation for
checks of up to 16 or 32 edges (K1, K6's forward, K5) and the big-code
kernels (``fused_fwd_cl``, ``fused_fwd_dm``, ``fused_bwd_cl``,
``fused_bwd_dm``, which share ``csrc/bp_common.cuh``) must not differ; an
instantiation the parent lacks (for checks above 32 edges, MAXB 0 and the
device-memory kernels' ``check_pass_any`` / ``pass_a_any``) is reported
as new, the backward's (K2 and K6's backward) as redesigned.
Prints the card's name and power limit and one JSON line; exits 1 if the
trees' outputs or a gated kernel's SASS differ.

    python3 ab_k1a.py --probe DIR [--probe-kernels all|k1|k2]

builds a copy of DIR's forward kernel with clock64 stamps after each block
barrier and prints, per case, ptxas' registers and spills, the block shape,
the card's blocks an SM and block 0's cycles in setup, check phases, VN
phases and the rest; then the same for the backward kernel K2 on the
bg2_qms_train decoder at 16,384 and 20 words (block 0's cycles in L, B0,
phase A and B1 over the iterations) and, where DIR's package has
``k2_plan``, K2's time at other block shapes (``K2_SHAPES``).
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
DENSE_TRAIN_BATCH = 256  # chip_smoke.py's path (f) training batch
DENSE_SNR = 7.0
# K5 (chip_smoke.py's path (d)): (case of CASES whose inputs it decodes,
# routing_dtype, int8 routing)
K5_CASES = [("wman_ms5", "bfloat16", False), ("wman_ms5", "float32", False),
            ("bg2_qms20", "bfloat16", True)]
# K6's backward (chip_smoke.py's path (e)): (case of CASES, routing_dtype)
K6_BWD_CASES = [("bg2_qms20", "bfloat16"), ("bg2_qms20", "float32"), ("wman_ms5", "bfloat16")]
# K3 on the BG1-like code, chip_smoke.py's paths (a), (b) and (c):
# (name, Z, iterations, trained weights, snr_db, batch, mode)
K3_CASES = [
    ("bg1z384_ms20_k3_app", 384, 20, "bg1_ms20_z384_post.npz", 2.5, 32768, "app"),
    ("bg1z384_ms10i5_k3_stats", 384, 5, "bg1_ms10_z256_hi.npz", 2.5, 32768, "stats"),
    ("bg1z256_ms10_k3_stream", 256, 10, "bg1_ms10_z256_hi.npz", 3.0, 2048, "stream"),
]
K3_SOURCES = ("fused_fwd_dm", "fused_fwd_cl")  # K3's sources before and after its redesign
# K4 on chip_smoke.py's path (c) decoder (BG1-like Z = 256, MS x10 cn=3, the
# cross-lift weights) at its step's batch and at 2,048: (name, batch)
K4_CASES = [("bg1z256_ms10_k4_b64", 64), ("bg1z256_ms10_k4_b2048", 2048)]
K4_SOURCES = ("fused_bwd_dm", "fused_bwd_cl")  # K4's sources before and after its redesign
# the wman campaign's phase 1 (chip_smoke.py's CAMPAIGN_CASES[0]): MS x10
# trained, cut to its first I1 = 2 iterations, at 5.5 dB over the whole batch;
# K1c samples the channel in the kernel, K1b reads it
PHASE1 = ("wman_n576_r34_z24", "wman_ms10_base75ep.npz", 10, 2, 5.5)
PHASE1_SEED = 424242
# the cases the probe (``--probe``) stamps: (name, code, type, sharing,
# iterations, weights, mode)
PROBE_CASES = [
    ("wman_ms5", "wman_n576_r34_z24", "MS", dict(cn=3), 5, None, "app"),
    ("bg2_qms20", "nr_bg2_set0_z16", "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", "app"),
    ("wman_ms10_i2_k1c", "wman_n576_r34_z24", "MS", dict(cn=3), 2, "wman_ms10_base75ep.npz",
     "k1c"),
]
PROBE_BATCH = 65536
PROBE_CAP = 4096  # clock64 stamps block 0 keeps


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

    torch.cuda.empty_cache()  # each tree's K3 cases start from the same allocator state
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


def _k4_cases(tree, device, reps, out) -> None:
    """Times ``fused_bwd_k4`` on K4_CASES into ``out``, on K3's training
    forward's outputs and a seeded cotangent; each reading's checksum is that
    of the channel gradient (equal between the trees: the kernels add the same
    terms in the same order), with the CN weights' gradient sum and magnitude
    beside it (compared within 1e-4 of the magnitude: the trees sum over
    words in another order); adds which K4 ran, its CUDA launches a call and
    ptxas' lines of K4's kernels where this process built them."""
    import torch

    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.codes import TannerGraph
    from neural_ldpc_tpu_torch.codes.protograph import nr_bg1_like
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz)
    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedTrainDecoder, _build, fused_bwd_k4, fused_fwd_k3)
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig

    torch.cuda.empty_cache()
    code = nr_bg1_like(256)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, 256),
        BoostedDecoderConfig(n_iterations=10, decoder_type=DecoderType.MS,
                             sharing=NodeWeightSharingConfig(cn=3)), device=device)
    params = load_params_npz(os.path.join(tree, "trained", "bg1_ms10_z256_hi.npz"), device)
    ft = FusedTrainDecoder.from_decoder(dec)
    lay, w = ft.layout, ft.pack_weights(*dec._expanded_weights(params))
    ch = AWGNChannel(code, ChannelConfig(snr_db=(3.0,)), device=device)
    for name, batch in K4_CASES:
        chan = ch.sample_at(ch.generator(30), batch, 0, all_zero=True)[0].reshape(batch, -1)
        outs, st = fused_fwd_k3(chan, lay, *w, mode="stream")
        g = torch.randn(outs.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(11))
        before = (fused_bwd_k4.launches, fused_bwd_k4.cuda_launches)
        ms, grads = _timed(lambda: fused_bwd_k4(chan, lay, *w, st, outs, g), reps)
        calls = fused_bwd_k4.launches - before[0]
        r = _reading(ms, grads[3])
        r["weights_sum"] = float(grads[0].double().sum())
        r["weights_abs"] = float(grads[0].double().abs().sum())
        r["kernel"] = getattr(lay, "k4_kernel", "device-memory")
        r["cuda_launches_per_call"] = (fused_bwd_k4.cuda_launches - before[1]) / max(calls, 1)
        out[name] = r
        del chan, outs, st, g, grads
    for src in K4_SOURCES:
        lines = [ln.strip() for ln in _build.build_log.get(src, "").splitlines()
                 if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        if lines:
            out[f"{src}_ptxas"] = lines


def _phase1_cases(tree, device, batch, reps, out) -> None:
    """K1c (channel sampled in the kernel) and K1b (channel read) on the
    wman campaign's phase 1 (PHASE1) over ``batch`` words, into ``out``;
    each reading's checksum is that of the per-word stats."""
    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz)
    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, fused_fwd_k1b, fused_fwd_k1c
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig

    code_name, weights, _, i1, snr = PHASE1
    code = get_code(code_name)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, code.Z),
        BoostedDecoderConfig(n_iterations=i1, decoder_type=DecoderType.MS,
                             sharing=NodeWeightSharingConfig(cn=3)), device=device)
    params = {k: v[:i1] for k, v in
              load_params_npz(os.path.join(tree, "trained", weights), device).items()}
    fused = FusedMinsumDecoder.from_decoder(dec, params)
    lay, w = fused.layout, fused._w
    ch = AWGNChannel(code, ChannelConfig(snr_db=(snr,)), device=device)
    sigma = float(ch.sigma[0])
    out[f"wman_ms10_i{i1}_k1c"] = _reading(*_timed(
        lambda: fused_fwd_k1c(lay, *w, PHASE1_SEED, sigma, batch=batch), reps))
    chan = ch.sample_at(ch.generator(55), batch, 0, all_zero=True)[0].reshape(batch, -1)
    out[f"wman_ms10_i{i1}_k1b"] = _reading(*_timed(lambda: fused_fwd_k1b(chan, lay, *w), reps))


def _random_params(dec, params_from_numpy, device):
    import numpy as np

    rng = np.random.default_rng(0)
    return params_from_numpy({
        k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
        for k, v in dec.init_params().items()}, device)


def worker(tree: str, batch: int, reps: int, cases: str = "all") -> dict:
    """Time the kernels of the package in ``tree`` on every case (``cases``
    "k3" or "k4": K3's or K4's only)."""
    sys.path.insert(0, tree)
    import torch

    import neural_ldpc_tpu_torch
    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz, params_from_numpy)
    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, _build, fused_bwd_k2, fused_fwd_k1a, fused_fwd_k1d)
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
    try:
        from neural_ldpc_tpu_torch.codes.protograph import dense_protograph
        from neural_ldpc_tpu_torch.ops.cuda import FusedTrainDecoder, fused_legacy_k5
        from neural_ldpc_tpu_torch.ops.cuda import fused_train as ft
    except ImportError:  # a tree before K5 and K6
        ft = None
    else:  # K1's modes and K2 launch a matmul layout; an older tree has K6 wrappers of its own
        fwd6, bwd6 = ((ft.fused_fwd_k6, ft.fused_bwd_k6) if hasattr(ft, "fused_fwd_k6")
                      else (ft._fwd_k1, ft.fused_bwd_k2))

    pkg = os.path.dirname(os.path.abspath(neural_ldpc_tpu_torch.__file__))
    if pkg != os.path.join(os.path.abspath(tree), "neural_ldpc_tpu_torch"):
        raise RuntimeError(f"imported the package from {pkg}, not from {tree}")
    device = torch.device("cuda", 0)
    out = {}
    if cases == "sass":  # only the libraries the SASS comparison reads
        _build.load_all([n for n in SASS_LIBS if os.path.exists(
            os.path.join(tree, "neural_ldpc_tpu_torch", "csrc", f"{n}.cu"))])
        return out
    if cases in ("k3", "k4"):
        (_k3_cases if cases == "k3" else _k4_cases)(tree, device, reps, out)
        return out
    k2_only, cases = cases == "k2", {}
    for name, code_name, dt, sharing, iters, weights, snr in CASES:
        if k2_only and name != "bg2_qms20":
            continue
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
        if not k2_only:
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
        # K2 at the reference's batch of 20 (a train step's call)
        chan20 = ch.sample_at(ch.generator(11), 20, 0)[0].reshape(20, -1)
        outs, st = fused_fwd_k1d(chan20, lay, *w)
        g = torch.randn(outs.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(4))
        ms, grads = _timed(lambda: fused_bwd_k2(chan20, lay, *w, st, outs, g), reps)
        out[f"{name}_k2_b20"] = _reading(ms, grads[4])
        del chan20, outs, st, g, grads
    if k2_only:
        return out
    _phase1_cases(tree, device, batch, reps, out)
    # K3 after the roll kernels and before any K6 launch
    _k3_cases(tree, device, reps, out)
    if ft is None:
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
            *_timed(lambda: fwd6(chan, lay, *w), reps))
        del chan
        if name != "bg2_qms20":
            continue
        chan_t = ch.sample_at(ch.generator(7), TRAIN_BATCH, 0)[0].reshape(TRAIN_BATCH, -1)
        tlay = FusedTrainDecoder.from_decoder(dec, routing="matmul").layout
        ms, (outs, st) = _timed(lambda: fwd6(chan_t, tlay, *w, mode="stream"), reps)
        out[f"{name}_k6_{tlay.routing}_train"] = _reading(ms, outs)
        del chan_t, outs, st
    # path (f) of chip_smoke.py: "auto" routes E > 1024 by K6
    code = dense_protograph()
    dec = BoostedNeuralDecoder(TannerGraph.from_basegraph(code.basegraph, code.Z),
                               BoostedDecoderConfig(
                                   n_iterations=10, decoder_type=DecoderType.MS,
                                   sharing=NodeWeightSharingConfig(cn=3)), device=device)
    fused_params = _random_params(dec, params_from_numpy, device)
    fused = FusedMinsumDecoder.from_decoder(dec, fused_params)
    ch = AWGNChannel(code, ChannelConfig(snr_db=(DENSE_SNR,)), device=device)
    chan = ch.sample_at(ch.generator(41), DENSE_BATCH, 0, all_zero=True)[0].reshape(
        DENSE_BATCH, -1)
    lay, w = fused.layout, fused._w
    out[f"dense_e{lay.E}_k6_{lay.routing}"] = _reading(
        *_timed(lambda: fwd6(chan, lay, *w), reps))
    del chan
    # K6's backward on its training forward's outputs, a seeded cotangent;
    # the channel gradient and the CN weights' as checksums
    runs = [(f"{name}_k6_bwd_{rdt}", *cases[name][:2], rdt, cases[name][2], TRAIN_BATCH)
            for name, rdt in K6_BWD_CASES]
    runs.append((f"dense_e{lay.E}_k6_bwd", dec, fused_params, "bfloat16", ch, DENSE_TRAIN_BATCH))
    for label, dec_b, params, rdt, ch_b, b in runs:
        tdec = FusedTrainDecoder.from_decoder(dec_b, routing="matmul",
                                              routing_dtype=getattr(torch, rdt))
        tlay, w = tdec.layout, tdec.pack_weights(*dec_b._expanded_weights(params))
        chan_t = ch_b.sample_at(ch_b.generator(7), b, 0)[0].reshape(b, -1)
        outs, st = fwd6(chan_t, tlay, *w, mode="stream")
        g = torch.randn(outs.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(3))
        ms, grads = _timed(lambda: bwd6(chan_t, tlay, *w, st, outs, g), reps)
        r = _reading(ms, grads[3])
        # the CN weights' gradient, compared within 1e-4 of its magnitude: the
        # trees sum the blocks' partials in another order
        r["weights_sum"] = float(grads[0].double().sum())
        r["weights_abs"] = float(grads[0].double().abs().sum())
        r["routing"] = tlay.routing
        out[label] = r
        del chan_t, outs, st, g, grads
    # K5, the legacy engine, on the K1a cases' inputs
    for name, rdt, int8 in K5_CASES:
        dec_c, params, ch_c, snr = cases[name]
        leg = FusedMinsumDecoder.from_decoder(dec_c, params, engine="legacy",
                                              routing_dtype=getattr(torch, rdt), int8_routing=int8)
        chan = ch_c.sample_at(ch_c.generator(int(snr * 10)), batch, 0, all_zero=True)[0].reshape(
            batch, -1)
        out[f"{name}_k5_{leg.layout.routing}"] = _reading(
            *_timed(lambda: fused_legacy_k5(chan, leg.layout, *leg._w), reps))
        del chan
    # K4 last: its time differs between the trees by tens of milliseconds
    _k4_cases(tree, device, reps, out)
    # every library the SASS comparison reads, also one no case launched
    _build.load_all([n for n in SASS_LIBS if os.path.exists(
        os.path.join(tree, "neural_ldpc_tpu_torch", "csrc", f"{n}.cu"))])
    return out


# ROUTE names of the forward and backward kernels' instantiations
# (csrc/bp_common.cuh)
ROUTES = {0: "roll", 1: "int8", 2: "bf16", 3: "split3", 4: "legacy_int8"}


# the libraries whose kernels inline csrc/bp_common.cuh
SASS_LIBS = ("fused_fwd", "fused_bwd", "fused_fwd_cl", "fused_fwd_dm", "fused_bwd_dm",
             "fused_bwd_cl")


def roll_sass(tree: str) -> dict:
    """{"<kernel><MAXD, route[, qms]>": [instruction, ...]} of every
    instantiation in ``tree``'s built fused_fwd and fused_bwd libraries,
    and {"<library>:<mangled kernel name>": [...]} of the big-code
    libraries' kernels (K3, K4), each instruction without its address and
    encoding and with the targets of branches and calls, which move with
    the code before them, written as 0x*; a library that is missing or
    cuobjdump cannot read adds nothing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in SASS_LIBS:
        libs = sorted(glob.glob(os.path.join(tree, "neural_ldpc_tpu_torch", "csrc", "build",
                                             f"lib{name}-*.so")), key=os.path.getmtime)
        if not libs or not os.path.exists(tool):
            continue
        r = subprocess.run([tool, "-sass", libs[-1]], capture_output=True, text=True, timeout=300)
        for fn in re.split(r"\n\s*Function : ", r.stdout)[1:]:
            head, _, body = fn.partition("\n")
            if name in ("fused_fwd", "fused_bwd"):
                m = re.search(r"(fused_(?:fwd|bwd)_kernel)ILi(\d+)ELi(\d+)E(?:Lb([01])E)?", head)
                if not m:
                    continue
                # the bool parameter: the forward's QMS, the backward's sum-product
                flag = (", qms" if name == "fused_fwd" else ", sp") if m.group(4) == "1" else ""
                key = f"{m.group(1)}<{m.group(2)}, {ROUTES.get(int(m.group(3)), m.group(3))}{flag}>"
            else:  # the anonymous namespace's name carries hashes of the file
                key = name + ":" + re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "",
                                          head.split()[0])
            ins = []
            for text in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body):
                text = " ".join(text.split())
                if re.search(r"\b(BRA|CALL|BSSY|JMP|BRX|JMX)\b", text):
                    text = re.sub(r"0x[0-9a-f]+\s*$", "0x*", text)
                ins.append(text)
            out[key] = ins
    return out


# the instantiations whose SASS must equal the parent's: every forward
# instantiation of MAXB 16 and 32 (K1, K6's forward, K5), and the big-code kernels
# K3 and K4 (the kernels this tree's change to csrc/bp_common.cuh,
# csrc/block_common.cuh and csrc/fused_fwd.cu must leave alone); the others
# are only counted: the backward's (K2 and K6's backward), redesigned; an
# instantiation the parent lacks (the kAnyDegree ones, MAXB 0, and the
# device-memory kernels' check_pass_any / pass_a_any for checks above 32
# edges; the legacy routings' K5), new
SASS_GATED = ("fused_fwd_kernel<16,", "fused_fwd_kernel<32,",
              "fused_fwd_cl:", "fused_fwd_dm:", "fused_bwd_dm:", "fused_bwd_cl:")


def compare_roll_sass(tree: str, parent: str) -> dict:
    """{kernel: instructions of its instantiation in ``tree`` and in
    ``parent``, how many differ (insertions, deletions and replacements),
    and "gated" (SASS_GATED: must be 0), "redesigned" or "new" (not in the
    parent)}; prints the first differing ones."""
    here, there = roll_sass(tree), roll_sass(parent)
    res = {}
    for k in sorted(set(here) | set(there)):
        a, b = here.get(k, []), there.get(k, [])
        ops = [op for op in difflib.SequenceMatcher(None, b, a, autojunk=False).get_opcodes()
               if op[0] != "equal"]
        n = sum(max(i2 - i1, j2 - j1) for _, i1, i2, j1, j2 in ops)
        status = ("new" if not b else "gated" if k.startswith(SASS_GATED) else "redesigned")
        res[k] = dict(instructions=len(a), parent_instructions=len(b), differing=n, status=status)
        if n and status == "gated":
            first = [(b[i1:i2][:2], a[j1:j2][:2]) for _, i1, i2, j1, j2 in ops[:4]]
            print(f"[ab] {k}: {n} of {len(a)} instructions differ from the parent's "
                  f"{len(b)}; the first (parent, this tree): {first}", flush=True)
    print(f"[ab] instantiations' SASS against the parent: {res}", flush=True)
    return res


# the probe's additions to a copy of csrc/fused_fwd.cu: block 0's thread 0
# writes a clock64 stamp at the kernel's entry, after every block barrier of
# the kernel's body and at its end (K1_PROBE_STAMPS=1; 0 builds the kernel
# as it is), and the copy exports the stamps
PROBE_HEADER = r"""
__device__ long long k1_probe_t[%(cap)d];
__device__ int k1_probe_n;
#if K1_PROBE_STAMPS
#define K1_PROBE_STAMP()                                                        \
  do {                                                                          \
    if (blockIdx.x == 0 && threadIdx.x == 0 && k1_probe_n < %(cap)d) {          \
      k1_probe_t[k1_probe_n] = clock64();                                       \
      k1_probe_n = k1_probe_n + 1;                                              \
    }                                                                           \
  } while (0)
#else
#define K1_PROBE_STAMP() do {} while (0)
#endif
"""
PROBE_FOOTER = r"""
extern "C" int k1_probe_read(long long* dst, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, k1_probe_n, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(dst, k1_probe_t, sizeof(long long) * %(cap)d);
  return (int)e;
}
extern "C" int k1_probe_reset() {
  const int z = 0;
  return (int)cudaMemcpyToSymbol(k1_probe_n, &z, sizeof(int));
}
"""
# a tree whose fused_fwd.cu has no occupancy query (the design with one
# thread per lifted check, fused_fwd_kernel<MAXD, ROUTE>, MAXD 16 or 32)
PARENT_QUERY = r"""
extern "C" int fused_fwd_query(int max_deg, int flags, int threads, int smem, int* blocks,
                               int* registers, int* local_bytes) {
  auto ask = [&](auto kern) {
    cudaFuncAttributes fa = {};
    cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads, smem);
    *registers = fa.numRegs;
    *local_bytes = (int)fa.localSizeBytes;
    return (int)e;
  };
  const int route = (flags & (1 << 12)) ? 1 : (flags & (1 << 13)) ? 3 : 0;
  if (max_deg <= 16)
    return route == 1 ? ask(fused_fwd_kernel<16, 1>) : route == 3 ? ask(fused_fwd_kernel<16, 3>)
                                                     : ask(fused_fwd_kernel<16, 0>);
  return route == 1 ? ask(fused_fwd_kernel<32, 1>) : route == 3 ? ask(fused_fwd_kernel<32, 3>)
                                                   : ask(fused_fwd_kernel<32, 0>);
}
"""


# where the stamps go: the body of the forward kernel, and of the backward's
# loop over iterations (csrc/fused_bwd.cu's ``backward``, or the kernel of a
# tree whose backward loops in the kernel itself)
PROBE_BODIES = {
    "fused_fwd": (r"__global__ void[^{;]*\bfused_fwd_kernel\s*\(\s*Params p\s*\)\s*\{",),
    "fused_bwd": (r"__device__ __forceinline__ void backward\s*\([^)]*\)\s*\{",
                  r"__global__ void[^{;]*\bfused_bwd_kernel\s*\(\s*BwdParams p\s*\)\s*\{"),
}


def _probe_source(src: str, source: str = "fused_fwd") -> str:
    """``src`` (a tree's csrc/<source>.cu) with the probe's stamps after
    every block barrier of the body ``PROBE_BODIES`` names, and its
    exports."""
    m = next((m for pat in PROBE_BODIES[source] for m in [re.search(pat, src)] if m), None)
    if not m:
        raise RuntimeError(f"the probed body of {source}.cu not found")
    depth, i = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
    body = src[m.end():i - 1].replace("__syncthreads();", "__syncthreads();\n  K1_PROBE_STAMP();")
    src = src[:m.end()] + "\n  K1_PROBE_STAMP();" + body + "  K1_PROBE_STAMP();\n" + src[i - 1:]
    inc = '#include "bp_common.cuh"\n'
    src = src.replace(inc, inc + PROBE_HEADER % dict(cap=PROBE_CAP), 1)
    src += PROBE_FOOTER % dict(cap=PROBE_CAP)
    if source != "fused_fwd" or "fused_fwd_query" in src:
        return src
    return src + PARENT_QUERY


def _build_probe(tree: str, stamps: bool, source: str = "fused_fwd", max_threads=None):
    """(library, nvcc output) of the probe's copy of ``tree``'s
    csrc/<source>.cu, built into its git-ignored csrc/build/probe/; for the
    backward, ``max_threads`` rebuilds it for blocks of at most that many
    threads (its launch bound: more registers a thread)."""
    import ctypes

    from neural_ldpc_tpu_torch.ops.cuda import _build

    csrc = os.path.join(tree, "neural_ldpc_tpu_torch", "csrc")
    out_dir = os.path.join(csrc, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, f"{source}.cu")) as f:
        src = _probe_source(f.read(), source)
    tag = f"{source}_probe{int(stamps)}"
    if max_threads:
        bound = "constexpr int kMaxThreads = 1024;"
        if bound not in src:
            raise RuntimeError(f"{source}.cu has no launch bound {bound!r} to change")
        src = src.replace(bound, f"constexpr int kMaxThreads = {int(max_threads)};")
        tag += f"_t{int(max_threads)}"
    path = os.path.join(out_dir, f"{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{tag}.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-DK1_PROBE_STAMPS={int(stamps)}",
                        "-I", csrc, "-o", lib, path], capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"probe build failed:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(lib), r.stdout + r.stderr


def _launch_shape(ft, lay):
    """(threads a block, dynamic shared memory bytes, words a block) of the
    forward kernel of ``ft`` (a tree's ops/cuda/fused_train.py) on ``lay``."""
    if hasattr(ft, "k1_plan"):
        plan = ft.k1_plan(lay)
        return plan.threads, plan.smem_bytes, plan.W
    wpb = lay.words_per_block  # one thread per lifted check of the block's words
    return (-(-wpb * lay.M * lay.Z // 32) * 32,
            4 * wpb * (2 * lay.N * lay.Z + lay.E * lay.Z + 2), wpb)


def probe(tree: str, batch: int) -> dict:
    """The forward kernel of ``tree`` on PROBE_CASES: ptxas' registers and
    spills of every instantiation, the card's blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at the launch's block
    shape, and block 0's time between its barriers in one launch over
    ``batch`` words (clock64 stamps, SM cycles): setup (stamps up to the
    first iteration), the check and VN phases summed over the iterations,
    and the rest (epilogue and stores)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, tree)
    import torch

    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz, params_from_numpy)
    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, _build, fused_fwd_k1a, fused_fwd_k1c)
    from neural_ldpc_tpu_torch.ops.cuda import fused_train as ft
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig

    device = torch.device("cuda", 0)
    with ThreadPoolExecutor(2) as pool:
        (plain_lib, log), (stamp_lib, _) = pool.map(lambda s: _build_probe(tree, s),
                                                    (False, True))
    out = {"ptxas": [ln.strip() for ln in log.splitlines()
                     if "Compiling entry" in ln or "registers" in ln or "spill" in ln]}
    _build._libs["fused_fwd"] = stamp_lib  # the wrappers launch the stamped copy
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, code_name, dt, sharing, iters, weights, mode in PROBE_CASES:
        code = get_code(code_name)
        dec = BoostedNeuralDecoder(TannerGraph.from_basegraph(code.basegraph, code.Z),
                                   BoostedDecoderConfig(
                                       n_iterations=iters, decoder_type=DecoderType[dt],
                                       qms_qbit=5, sharing=NodeWeightSharingConfig(**sharing)),
                                   device=device)
        params = ({k: v[:iters] for k, v in load_params_npz(
            os.path.join(tree, "trained", weights), device).items()} if weights
                  else _random_params(dec, params_from_numpy, device))
        fused = FusedMinsumDecoder.from_decoder(dec, params)
        lay, w = fused.layout, fused._w
        threads, smem, wpb = _launch_shape(ft, lay)
        flags = ft._mode_flags(lay) | ft._route_flags(lay)
        blocks, regs, local = ci(0), ci(0), ci(0)
        q = plain_lib.fused_fwd_query
        q.argtypes = [ci, ci, ci, ci, vp, vp, vp]
        err = q(lay.max_degree, flags, threads, smem, ctypes.byref(blocks), ctypes.byref(regs),
                ctypes.byref(local))
        ch = AWGNChannel(code, ChannelConfig(snr_db=(5.5 if mode == "k1c" else 3.0,),
                                             qms_qbit=5 if dt == "QMS" else None),
                         device=device)
        if mode == "k1c":
            sigma = float(ch.sigma[0])

            def run():
                return fused_fwd_k1c(lay, *w, PHASE1_SEED, sigma, batch=batch)
        else:
            chan = ch.sample_at(ch.generator(30), batch, 0, all_zero=True)[0].reshape(batch, -1)

            def run():
                return fused_fwd_k1a(chan, lay, *w)
        run()
        torch.cuda.synchronize()
        stamp_lib.k1_probe_reset()
        run()
        torch.cuda.synchronize()
        t = (ctypes.c_longlong * PROBE_CAP)()
        n = ci(0)
        stamp_lib.k1_probe_read(t, ctypes.byref(n))
        t = list(t)[:n.value]
        d = [b - a for a, b in zip(t, t[1:])]
        n_epi = 1 if mode == "k1c" else 0  # the stats epilogue's barrier
        pre = len(d) - 2 * iters - n_epi - 1  # barriers before the first iteration
        it = d[pre:pre + 2 * iters]
        out[name] = dict(
            query_error=err, threads=threads, smem_bytes=smem, words_per_block=wpb,
            blocks_per_sm=blocks.value, registers=regs.value, local_bytes=local.value,
            words_per_sm=blocks.value * wpb, iterations=iters, mode=mode, batch=batch,
            block0_cycles=t[-1] - t[0] if t else None, setup_cycles=sum(d[:pre]),
            check_cycles=sum(it[0::2]), vn_cycles=sum(it[1::2]),
            rest_cycles=sum(d[pre + 2 * iters:]), stamps=len(t))
        print(f"[probe] {name}: {out[name]}", flush=True)
    return out


# the backward's probe (``--probe``): chip_smoke.py's timing decoder of K2
# (bg2_qms_train: BG2 QMS x20, cn=3 vn=3, trained weights) at these batches;
# block 0's stamps after every barrier of the iteration loop (L, B0, A, B1;
# the weight partials ride L and B1); and, where the tree has ``k2_plan``,
# K2's time at these (words a block, threads) shapes beside its plan's,
# built with the launch bound at each of K2_BOUNDS threads (64 registers a
# thread at 1,024, 128 at 512)
K2_PROBE_BATCHES = (16384, 20)
K2_SHAPES = ((1, 512), (2, 512), (2, 1024), (3, 1024), (4, 1024), (5, 1024))
K2_BOUNDS = (1024,)


def _k2_stamps(stamp_lib, run, iters, body_is_loop):
    """Block 0's cycles in one ``run()`` by phase, from the stamped copy."""
    import ctypes

    import torch

    run()
    torch.cuda.synchronize()
    stamp_lib.k1_probe_reset()
    run()
    torch.cuda.synchronize()
    t = (ctypes.c_longlong * PROBE_CAP)()
    n = ctypes.c_int(0)
    stamp_lib.k1_probe_read(t, ctypes.byref(n))
    t = list(t)[:n.value]
    d = [b - a for a, b in zip(t, t[1:])]
    post = 1 if body_is_loop else 2  # segments after the last iteration's B1
    pre = len(d) - 4 * iters - post
    it = d[pre:pre + 4 * iters]
    return dict(block0_cycles=t[-1] - t[0] if t else None, setup_cycles=sum(d[:pre]),
                L_cycles=sum(it[0::4]), B0_cycles=sum(it[1::4]), A_cycles=sum(it[2::4]),
                B1_cycles=sum(it[3::4]), rest_cycles=sum(d[pre + 4 * iters:]), stamps=len(t))


def probe_k2(tree: str, reps: int = 5) -> dict:
    """The backward kernel of ``tree`` on its probe decoder: ptxas' lines of
    each build, block 0's cycles by phase at each batch of
    K2_PROBE_BATCHES, and (a tree with ``k2_plan``) K2's time at its plan
    and at K2_SHAPES under each launch bound, with the card's blocks an SM,
    registers and local bytes of each."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, tree)
    import torch

    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz)
    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, _build, fused_bwd_k2, fused_fwd_k1d)
    from neural_ldpc_tpu_torch.ops.cuda import fused_train as ft
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig

    device = torch.device("cuda", 0)
    with open(os.path.join(tree, "neural_ldpc_tpu_torch", "csrc", "fused_bwd.cu")) as f:
        body_is_loop = re.search(PROBE_BODIES["fused_bwd"][0], f.read()) is not None
    planned = hasattr(ft, "k2_plan")
    builds = [(True, None)] + [(False, b) for b in (K2_BOUNDS if planned else (None,))]
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = list(pool.map(lambda a: _build_probe(tree, a[0], "fused_bwd", a[1]), builds))
    out = {"ptxas": {f"{'stamped' if s else 'plain'}_{b or 'default'}":
                     [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
                     for (s, b), (_, log) in zip(builds, libs)}}
    code = get_code("nr_bg2_set0_z16")
    dec = BoostedNeuralDecoder(TannerGraph.from_basegraph(code.basegraph, code.Z),
                               BoostedDecoderConfig(
                                   n_iterations=20, decoder_type=DecoderType.QMS, qms_qbit=5,
                                   sharing=NodeWeightSharingConfig(cn=3, vn=3)),
                               device=device)
    params = load_params_npz(os.path.join(tree, "trained", "bg2_qms20_ref500ep.npz"), device)
    fused = FusedMinsumDecoder.from_decoder(dec, params)
    lay, w = fused.layout, fused._w
    ch = AWGNChannel(code, ChannelConfig(snr_db=(2.0,), qms_qbit=5), device=device)
    stamp_lib = libs[0][0]
    orig_plan = getattr(ft, "k2_plan", None)
    for batch in K2_PROBE_BATCHES:
        chan = ch.sample_at(ch.generator(7), batch, 0)[0].reshape(batch, -1)
        outs, st = fused_fwd_k1d(chan, lay, *w)
        g = torch.randn(outs.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(3))

        def run():
            return fused_bwd_k2(chan, lay, *w, st, outs, g)

        _build._libs["fused_bwd"] = stamp_lib
        r = dict(batch=batch, **_k2_stamps(stamp_lib, run, lay.n_iterations, body_is_loop))
        if planned:
            plan = orig_plan(lay, batch)
            r["plan"] = dict(W=plan.W, threads=plan.threads, smem_bytes=plan.smem_bytes)
            shapes = {}
            for (_, bound), (lib, _) in zip(builds[1:], libs[1:]):
                _build._libs["fused_bwd"] = lib
                ref = None
                for W, T in ((plan.W, plan.threads),) + K2_SHAPES:
                    shape = orig_plan(lay, batch, W=W, threads=min(T, bound))
                    if shape.smem_bytes > ft._SMEM_OPTIN or (W, T) in shapes.get(bound, {}):
                        continue
                    ft.k2_plan = lambda lay_, b_, shape=shape, **kw: shape
                    try:
                        ms, grads = _timed(run, reps)
                    finally:
                        ft.k2_plan = orig_plan
                    total = float(grads[4].double().sum())
                    ref = total if ref is None else ref
                    blocks, regs, local = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
                    q = lib.fused_bwd_query
                    q.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                    q(lay.max_degree, ft._mode_flags(lay), shape.threads, shape.smem_bytes,
                      ctypes.byref(blocks), ctypes.byref(regs), ctypes.byref(local))
                    shapes.setdefault(bound, {})[(W, T)] = dict(
                        W=shape.W, threads=shape.threads, ms=ms, blocks_per_sm=blocks.value,
                        registers=regs.value, local_bytes=local.value, same_sum=total == ref)
            r["shapes"] = {str(b): list(v.values()) for b, v in shapes.items()}
        out[f"bg2_qms20_k2_b{batch}"] = r
        print(f"[probe-k2] batch {batch}: {r}", flush=True)
        del chan, outs, st, g
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="directory of the other checkout")
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cases", choices=("all", "k2", "k3", "k4", "sass"), default="all",
                    help="k2: only K1d and K2 (bg2_qms_train at 16,384 and 20 words); k3 / k4: "
                         "only K3's or K4's cases; sass: no readings, only the SASS gate")
    ap.add_argument("--probe", metavar="DIR",
                    help="only the probe of DIR's forward and backward kernels: registers, "
                         "blocks an SM, block 0's phase cycles")
    ap.add_argument("--probe-kernels", choices=("all", "k1", "k2"), default="all",
                    help="which kernels --probe stamps")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.probe:
        tree, res = os.path.abspath(args.probe), {}
        if args.probe_kernels in ("all", "k1"):
            res["k1"] = probe(tree, PROBE_BATCH)
        if args.probe_kernels in ("all", "k2"):
            res["k2"] = probe_k2(tree, args.reps)
        print(json.dumps(res), flush=True)
        return 0
    if args.worker:
        print(json.dumps(worker(args.worker, args.batch, args.reps, args.cases)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    parent = os.path.abspath(args.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    readings = []
    order = ((("parent", parent), ("change", HERE)) if args.cases == "sass" else
             (("parent", parent), ("change", HERE), ("change", HERE), ("parent", parent)))
    for label, tree in order:
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
    for name in {k for r in readings for k, v in r.items()
                 if isinstance(v, dict) and "weights_sum" in v}:
        sums = [r[name]["weights_sum"] for r in readings if name in r]
        scale = max(r[name]["weights_abs"] for r in readings if name in r)
        if max(sums) - min(sums) > 1e-4 * scale:
            print(f"ab_k1a: FAIL: the trees' weight gradients differ on {name} beyond 1e-4 of "
                  f"their magnitude", file=sys.stderr)
            return 1
    sass = compare_roll_sass(HERE, parent)
    print(json.dumps({"batch": args.batch, "reps": args.reps, "readings": readings,
                      "roll_sass": sass}), flush=True)
    gated = {k: v for k, v in sass.items() if v["status"] == "gated"}
    if args.cases in ("all", "sass") and (not gated or any(
            v["differing"] or not v["instructions"] for v in gated.values())):
        print(f"ab_k1a: FAIL: the gated kernels' SASS differs from the parent's or was not "
              f"read: {gated}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
