#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``neural_ldpc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (name and power limit from nvidia-smi).
2. Builds every CUDA kernel of the decode path from ``csrc/`` with nvcc.
3. Holds the kernel against its plain PyTorch version on the card, on
   channel LLRs from the port's AWGN channel at waterfall SNRs:
   (a) wman MS x5, cn=3; (b) BG2 QMS x20, cn=3 vn=3, trained weights;
   (c) BG2 QMS x20 with UCN weights, trained; (d) wman SP x5, cn=1 vn=2;
   (e) a batch that is not a multiple of the words per block;
   (f, g) the BG1-like base graph at Z = 16, MS x5 and QMS x10 with UCN,
   whose check degrees above 16 take the kernel's second instantiation.
   QMS must be exact, MS within 2e-5 and SP within 5e-3, with equal hard
   decisions.
4. Drives the main path at full width, with the launch counter set to 0
   before and read after: AWGNChannel -> BoostedNeuralDecoder ->
   FusedMinsumDecoder.from_decoder -> decode -> count_errors, at batch
   1,048,576, for wman MS x5 and BG2 QMS x20 (trained weights, all-zero
   words) and for BG2 on random codewords at 3 dB and 4 dB.  Decoded BER must
   fall below channel BER, and the kernel must have been launched.
5. Times wman MS x5 and BG2 QMS x20 at that batch with CUDA events after a
   warm-up: the kernel, the whole decode and the plain version; and holds
   the kernel against the plain version over that whole batch, at the
   tolerances of step 3.
6. Prints the kernel table as one JSON line and, last, the
   ``{"ok": true, "device": {...}}`` line.

Any failed build, launch or comparison exits nonzero.  Without CUDA, or
without the package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
MAIN_BATCH = 1 << 20
CHECK_BATCH = 4096
PLAIN_CHUNK = 65536  # the plain version's intermediates do not fit at MAIN_BATCH
REPS = 5  # timed launches per configuration
TPU_KERNEL = "neural_ldpc_tpu/ops/pallas/fused_train.py:843"  # _fwd_kernel
KERNEL_SOURCE = "neural_ldpc_tpu_torch/csrc/fused_fwd.cu"

WMAN = "wman_n576_r34_z24"
BG2 = "nr_bg2_set0_z16"
BG1_Z16 = "nr_bg1_like_z16"  # BG1-like base graph lifted at Z = 16 (M*Z = 736)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# Configurations
# ---------------------------------------------------------------------------
def make_decoder(code_name, decoder_type, sharing, n_iterations, weights, device, seed=0):
    """(code, decoder, params): trained weights from ``trained/<weights>``, or
    random weights around 1 made from ``seed``."""
    import numpy as np

    from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
    from neural_ldpc_tpu_torch.codes.protograph import nr_bg1_like
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz, params_from_numpy)
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig

    code = nr_bg1_like(16) if code_name == BG1_Z16 else get_code(code_name)
    graph = TannerGraph.from_basegraph(code.basegraph, code.Z)
    dec = BoostedNeuralDecoder(graph, BoostedDecoderConfig(
        n_iterations=n_iterations, decoder_type=DecoderType[decoder_type], qms_qbit=5,
        sharing=NodeWeightSharingConfig(**sharing)), device=device)
    if weights:
        params = load_params_npz(os.path.join(HERE, "trained", weights), device)
    else:
        rng = np.random.default_rng(seed)
        params = params_from_numpy({
            k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
            for k, v in dec.init_params().items()}, device)
    return code, dec, params


def channel_llr(code, snr_db, batch, seed, device, qms_qbit=None, all_zero=False):
    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig

    ch = AWGNChannel(code, ChannelConfig(snr_db=(snr_db,), qms_qbit=qms_qbit), device=device)
    if code.gen_matrix is None:
        all_zero = True
    return ch.sample_at(ch.generator(seed), batch, 0, all_zero=all_zero)


# (name, code, type, sharing, iterations, weights, snr_db, batch offset)
CHECK_CASES = [
    ("a_wman_ms5", WMAN, "MS", dict(cn=3), 5, None, 3.5, 0),
    ("b_bg2_qms20", BG2, "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 2.0, 0),
    ("c_bg2_qms20_ucn", BG2, "QMS", dict(cn=3, ucn=2, vn=3), 20, "bg2_qms20_base_ucn.npz", 2.0, 0),
    ("d_wman_sp5", WMAN, "SP", dict(cn=1, vn=2), 5, None, 3.5, 0),
    ("e_wman_ms5_ragged", WMAN, "MS", dict(cn=3), 5, None, 3.5, 1),
    # check degree up to 19: the kernel's second (MAXD = 32) instantiation
    ("f_bg1z16_ms5", BG1_Z16, "MS", dict(cn=3, vn=3), 5, None, 1.0, 0),
    ("g_bg1z16_qms10_ucn", BG1_Z16, "QMS", dict(cn=3, ucn=2, vn=3), 10, None, 1.0, 0),
]
TOLERANCE = {"MS": 2e-5, "SP": 5e-3, "QMS": 0.0}


def check_kernel(device, batch):
    """Kernel vs plain version on the same inputs; returns {case: max |diff|}."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, fused_fwd_k1a, fused_fwd_plain

    diffs = {}
    for name, code_name, dt, sharing, iters, weights, snr, extra in CHECK_CASES:
        code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        fused = FusedMinsumDecoder.from_decoder(dec, params)
        b = batch
        if extra:  # a batch the words per block do not divide
            wpb = fused.layout.words_per_block
            b = batch + 1
            if wpb > 1 and b % wpb == 0:
                b += 1
        llr, _ = channel_llr(code, snr, b, seed=11, device=device,
                             qms_qbit=5 if dt == "QMS" else None)
        chan = llr.reshape(b, -1)
        before = fused_fwd_k1a.launches
        out = fused(chan)
        if device.type == "cuda":
            torch.cuda.synchronize()
            if fused_fwd_k1a.launches != before + 1:
                fail(f"{name}: the kernel launch counter did not rise")
        lay = fused.layout
        ref = fused_fwd_plain(chan, lay, *fused._w).clamp(lay.clip_lo, lay.clip_hi)
        if out.shape != (b, code.n_bits) or not torch.isfinite(out).all():
            fail(f"{name}: output shape {tuple(out.shape)} or non-finite values")
        diffs[name] = compare(name, dt, b, out, ref)
    return diffs


def compare(name, decoder_type, batch, out, ref):
    """max |out - ref| of two clipped APPs; fails beyond the tolerance of
    ``decoder_type`` or on any differing hard decision."""
    import torch

    diff = (out - ref).abs().max().item()
    same = torch.equal(out < 0, ref < 0)
    print(f"[check] {name}: batch {batch}, max |kernel - plain| = {diff:.3g} "
          f"(tolerance {TOLERANCE[decoder_type]:g}), decisions equal: {same}", flush=True)
    if not diff <= TOLERANCE[decoder_type] or not same:
        fail(f"{name}: kernel disagrees with the plain version")
    return diff


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------
def ops_per_word(lay) -> int:
    """fp32 operations one word's decode needs, counted from the arithmetic
    of csrc/fused_fwd.cu (add, mul, min, max, compare or select, abs, rint
    each 1; tanhf and logf 1 each, which undercounts SP).  Work that depends
    only on a VN copy is counted once per VN copy, not once per edge as the
    kernel repeats it, so this stays a lower bound."""
    qms = lay.qms_qbit is not None
    quant = 5  # mul, rint, mul, max, min
    cq = quant if qms else 2  # clip_or_quant
    per_vn = 1  # vn total = xa_q + sums
    if lay.has_vn_w:
        per_vn += 1 + (quant if qms else 0)  # xa_q = Q(chan * vn_w)
    if lay.has_ucn:
        per_vn += 4  # app = clip(chan_out + sums), its sign
    per_edge = 1 + cq  # v2c = clip_or_quant(total - msg)
    per_edge += 11 if lay.sum_product else 7  # SP: 0.5*, tanh, 3 muls, clamp, 1+, 1-, div, log
    per_edge += 2 * int(lay.has_ucn)  # parity, weight select
    per_edge += 1 + int(lay.has_cn_w or lay.has_ucn) + 1 + cq + 2 + 1  # post chain
    per_edge += 1  # VN sum
    per_iteration = lay.E * lay.Z * per_edge + lay.N * lay.Z * per_vn
    return lay.n_iterations * per_iteration + lay.N * lay.Z  # + final APP add


def bound_ms(lay, batch):
    """(least time in ms, "bytes" or "operations") for one decode of ``batch``."""
    nz = lay.N * lay.Z
    I = lay.n_iterations
    weights = 4 * I * (lay.E * (int(lay.has_cn_w or lay.has_ucn) + int(lay.has_ucn))
                       + lay.N * int(lay.has_vn_w))
    nbytes = 2 * nz * 4 * batch + weights + lay.tables.numel() * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops_per_word(lay) * batch / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps, warmup=None):
    """Mean ms of ``fn`` over ``reps`` back-to-back calls, by CUDA events,
    after one call of ``warmup`` (default ``fn``)."""
    import torch

    (warmup or fn)()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_full(fused, chan):
    """The plain version over the whole batch, in chunks, timed once:
    (pre-clip APP [B, N*Z], ms).  The time includes the copy of each chunk
    into the full-batch output."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import fused_fwd_plain

    ref = torch.empty_like(chan)

    def run(n=chan.shape[0]):
        for s in range(0, n, PLAIN_CHUNK):
            ref[s:s + PLAIN_CHUNK] = fused_fwd_plain(chan[s:s + PLAIN_CHUNK], fused.layout,
                                                     *fused._w)

    ms = cuda_ms(run, 1, warmup=lambda: run(PLAIN_CHUNK))
    return ref, ms


# (name, code, type, sharing, iterations, weights, snr_db, all-zero words)
MAIN_CASES = [
    ("wman_ms5", WMAN, "MS", dict(cn=3), 5, None, 3.5, True),
    ("bg2_qms20", BG2, "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 2.0, True),
    ("bg2_qms20_3dB", BG2, "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 3.0, False),
    ("bg2_qms20_4dB", BG2, "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 4.0, False),
]
TIMED = ("wman_ms5", "bg2_qms20")


def main_path(device, batch):
    """Channel -> decode -> metrics at full width through the user entry
    points, one decode per case; returns {case: (result, decoder, llr)} and
    the kernel launches of this run."""
    import torch

    from neural_ldpc_tpu_torch.eval import count_errors
    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, fused_fwd_k1a

    def ber_fer(counts):
        return (counts.bit_errors[0].item() / counts.total_bits.item(),
                counts.frame_errors[0].item() / counts.total_frames.item())

    results = {}
    fused_fwd_k1a.launches = 0
    for name, code_name, dt, sharing, iters, weights, snr, all_zero in MAIN_CASES:
        code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        fused = FusedMinsumDecoder.from_decoder(dec, params)
        llr, bits = channel_llr(code, snr, batch, seed=int(snr * 10), device=device,
                                qms_qbit=5 if dt == "QMS" else None, all_zero=all_zero)
        out = fused(llr)
        torch.cuda.synchronize()
        if out.shape != (batch, code.n_bits) or not torch.isfinite(out).all():
            fail(f"{name}: main-path output shape {tuple(out.shape)} or non-finite values")
        channel_ber, _ = ber_fer(count_errors(bits, llr.reshape(batch, -1)))
        decoded_ber, decoded_fer = ber_fer(count_errors(bits, out))
        # decision ties: an APP of exactly 0 decides bit 0
        zero_app_errors = int(((out == 0) & (bits == 1)).sum().item())
        res = dict(batch=batch, decoder_type=dt, snr_db=snr, all_zero=all_zero,
                   channel_ber=channel_ber,
                   decoded_ber=decoded_ber, decoded_fer=decoded_fer,
                   bit_errors_at_zero_app=zero_app_errors)
        print(f"[main] {name}: batch {batch}, {'all-zero' if all_zero else 'random'} words "
              f"at {snr} dB: channel BER {channel_ber:.4g} -> decoded BER {decoded_ber:.4g}, "
              f"FER {decoded_fer:.4g}; bit errors at APP = 0: {zero_app_errors}", flush=True)
        if not decoded_ber < channel_ber:
            fail(f"{name}: decoded BER is not below channel BER")
        results[name] = (res, fused, llr if name in TIMED else None)
        del bits, out
    launches = fused_fwd_k1a.launches
    print(f"[main] fused_fwd_k1a launches in the main path: {launches} for "
          f"{len(MAIN_CASES)} decodes", flush=True)
    if launches == 0:
        fail("the main path never launched fused_fwd_k1a")
    return results, launches


def time_configs(results, batch, reps, diffs):
    """Kernel, decode and plain-version times of the timed configurations,
    and the kernel held against the plain version over the whole batch
    (into ``diffs``)."""
    from neural_ldpc_tpu_torch.ops.cuda import fused_fwd_k1a

    for name in TIMED:
        res, fused, llr = results[name]
        chan = llr.reshape(batch, -1)
        lay = fused.layout
        res["ms"] = cuda_ms(lambda: fused_fwd_k1a(chan, lay, *fused._w), reps)
        res["decode_ms"] = cuda_ms(lambda: fused(llr), reps)
        ref, res["plain_ms"] = plain_full(fused, chan)
        out = fused_fwd_k1a(chan, lay, *fused._w)
        diffs[f"{name}_full_batch"] = compare(
            f"{name} full batch", res["decoder_type"], batch,
            out.clamp_(lay.clip_lo, lay.clip_hi), ref.clamp_(lay.clip_lo, lay.clip_hi))
        del ref, out
        res["bound_ms"], res["bound_by"] = bound_ms(lay, batch)
        res["ops_per_word"] = ops_per_word(lay)
        res["roofline_share"] = res["bound_ms"] / res["ms"]
        res["words_per_s"] = batch / res["decode_ms"] * 1e3
        res["words_per_block"] = lay.words_per_block
        print(f"[time] {name}: batch {batch}, kernel {res['ms']:.3f} ms per launch, decode "
              f"{res['decode_ms']:.3f} ms = {res['words_per_s']:,.0f} words/s, bound "
              f"{res['bound_ms']:.3f} ms ({res['bound_by']}, {res['ops_per_word']:,} ops per "
              f"word), roofline share "
              f"{res['roofline_share']:.4f}; plain version {res['plain_ms']:.1f} ms "
              f"(chunks of {PLAIN_CHUNK})", flush=True)
        results[name] = (res, None, None)
        del fused, llr, chan


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import neural_ldpc_tpu_torch
        from neural_ldpc_tpu_torch.ops.cuda import _build
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing beside this script ({exc})",
              file=sys.stderr)
        return 3
    pkg_dir = os.path.dirname(os.path.abspath(neural_ldpc_tpu_torch.__file__))
    if pkg_dir != os.path.join(HERE, "neural_ldpc_tpu_torch"):
        print(f"chip_smoke: the port package is not beside this script ({pkg_dir})",
              file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"[card] {kind} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t_build = time.perf_counter()
    _build.load("fused_fwd")
    print(f"[build] fused_fwd.cu: {time.perf_counter() - t_build:.1f} s", flush=True)
    for line in _build.build_log.get("fused_fwd", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[build] {line.strip()}", flush=True)

    diffs = check_kernel(device, CHECK_BATCH)
    results, launches = main_path(device, MAIN_BATCH)
    time_configs(results, MAIN_BATCH, REPS, diffs)

    res = results["bg2_qms20"][0]
    kernels = {"kernels": [{
        "name": "fused_fwd_k1a",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max(diffs.values()),
        "max_abs_diff": diffs,
        "ms": res["ms"],
        "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": None,  # no PyTorch call computes a BP decode
        "shape": f"bg2_qms20, batch {MAIN_BATCH}",
        "configs": {name: r for name, (r, _, _) in results.items()},
    }]}
    print(json.dumps(kernels), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
