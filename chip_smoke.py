#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``neural_ldpc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (name and power limit from nvidia-smi).
2. Builds every CUDA kernel of the decode and campaign paths from ``csrc/``
   with nvcc.
3. Holds the final-APP kernel (K1a) against its plain PyTorch version on the
   card, on channel LLRs from the port's AWGN channel at waterfall SNRs:
   (a) wman MS x5, cn=3; (b) BG2 QMS x20, cn=3 vn=3, trained weights;
   (c) BG2 QMS x20 with UCN weights, trained; (d) wman SP x5, cn=1 vn=2;
   (e) a batch that is not a multiple of the words per block;
   (f, g) the BG1-like base graph at Z = 16, MS x5 and QMS x10 with UCN,
   whose check degrees above 16 take the kernel's second instantiation.
   QMS must be exact, MS within 2e-5 and SP within 5e-3, with equal hard
   decisions.  On the same inputs the stats and syndrome epilogues (K1b)
   must equal their plain version exactly.
4. Holds the in-kernel sampler (K1c) against its plain version on wman
   MS x10 and BG2 QMS x20 (trained) at a batch of many stream tiles: the
   exported LLRs within 1e-5 * (1 + |llr|), the sampled stats equal to the
   plain version's and to K1b's on the exported LLRs, and the index mode
   equal to the tile mode at scattered indices.
5. Runs the Monte-Carlo campaign at batch 65,536 x 4 batches for both codes
   and requires early-exit counters equal to the full unroll, with sampling
   on and off and with capacity 1 (every window redone).  Then holds each
   campaign of step 8's own phase-1 and escalation decoders against their
   plain versions, exactly, at the shapes that step launches: phase 1 over
   the whole batch at I1 iterations, the escalation at batch / 32 scattered
   words (K1c index mode, or K1b on gathered rows of a read channel).
6. Drives the decode path at full width, with the K1a launch counter set to
   0 before and read after: AWGNChannel -> BoostedNeuralDecoder ->
   FusedMinsumDecoder.from_decoder -> decode -> count_errors, at batch
   1,048,576, for wman MS x5 and BG2 QMS x20 (trained weights, all-zero
   words) and for BG2 on random codewords at 3 dB and 4 dB.  Decoded BER must
   fall below channel BER, and the kernel must have been launched.
7. Times wman MS x5 and BG2 QMS x20 at that batch with CUDA events after a
   warm-up: the kernel, the whole decode and the plain version; and holds
   the kernel against the plain version over that whole batch, at the
   tolerances of step 3.
8. Drives the campaign path at full width through
   ``MonteCarloCampaign.run_snr_point``, with every kernel's counter set to
   0 just before each campaign and read just after: wman MS x10 (trained)
   at 5.5 dB, batch 1,048,576, early exit after 2 iterations with capacity
   B/32 behind the auto-guard, in-kernel sampling, 2 batches off the clock
   and 16 timed; the same with the channel read from AWGNChannel (the
   evaluate CLI's path), 8 timed; and BG2 QMS x20 (trained) at 2.5 dB,
   batch 262,144, early exit after 5 iterations, 4 timed batches.  Prints
   words/s end to end; fails if a sampling campaign never launched K1c or
   the read-channel one never launched K1b.
9. Times K1b and K1c on wman MS x10 at batch 1,048,576 against their bounds
   and plain versions, and holds both against their plain versions over
   that batch.
10. Prints the kernel table as one JSON line and, last, the
    ``{"ok": true, "device": {...}}`` line.

Any failed build, launch or comparison exits nonzero.  Without CUDA, or
without the package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# Single instructions per second: 132 SMs x 128 fp32 lanes x 1.98 GHz.  The
# data sheet's 67 TFLOP/s counts an FMA as two operations; the kernels are
# built with -fmad=false, so every add, multiply, min, max or select they
# count is one instruction issue of its own.
H100_INSTR_PER_S = 33.5e12
MAIN_BATCH = 1 << 20
CHECK_BATCH = 4096
PLAIN_CHUNK = 65536  # the plain version's intermediates do not fit at MAIN_BATCH
REPS = 5  # timed launches per configuration
TPU_KERNEL = "neural_ldpc_tpu/ops/pallas/fused_train.py:843"  # _fwd_kernel
TPU_STATS = "neural_ldpc_tpu/ops/pallas/fused_train.py:1029"  # emit_stats branch (_stats_rows :815)
TPU_SAMPLER = "neural_ldpc_tpu/ops/pallas/fused_train.py:874"  # sample_channel branch
KERNEL_SOURCE = "neural_ldpc_tpu_torch/csrc/fused_fwd.cu"
SAMPLER_BATCH = 65536  # 512 stream tiles of 128 (wman), 256 of 256 (BG2)
CAMPAIGN_CHECK_BATCH = 65536

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
    """K1a and K1b against their plain versions on the same inputs; returns
    ({case: max |APP diff|}, {case: max |stats diff|})."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, fused_fwd_k1a, fused_fwd_k1b, fused_fwd_plain, stats_plain)

    diffs, stats_diffs = {}, {}
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
        before = fused_fwd_k1a.launches, fused_fwd_k1b.launches
        out = fused(chan)
        lay = fused.layout
        st = fused_fwd_k1b(chan, lay, *fused._w)
        app2, st2 = fused_fwd_k1b(chan, lay, *fused._w, emit_app=True)
        if device.type == "cuda":
            torch.cuda.synchronize()
            if (fused_fwd_k1a.launches, fused_fwd_k1b.launches) != (before[0] + 1, before[1] + 2):
                fail(f"{name}: a kernel launch counter did not rise")
        raw = fused_fwd_plain(chan, lay, *fused._w)
        ref = raw.clamp(lay.clip_lo, lay.clip_hi)
        if out.shape != (b, code.n_bits) or not torch.isfinite(out).all():
            fail(f"{name}: output shape {tuple(out.shape)} or non-finite values")
        diffs[name] = compare(name, dt, b, out, ref)
        ref_st = stats_plain(raw, lay)
        stats_diffs[name] = max((st - ref_st).abs().max().item(), (st2 - ref_st).abs().max().item())
        app_diff = (app2 - raw).abs().max().item()
        print(f"[check] {name}: K1b stats max |kernel - plain| = {stats_diffs[name]} "
              f"(syndrome mode too; APP {app_diff:.3g}); words with ok: "
              f"{int(st[:, 0].sum())} of {b}, bit errors {int(st[:, 1].sum())}", flush=True)
        if stats_diffs[name] != 0 or not app_diff <= TOLERANCE[dt]:
            fail(f"{name}: the stats or syndrome kernel disagrees with the plain version")
    return diffs, stats_diffs


# (name, code, type, sharing, iterations, weights, snr_db) of the sampler and
# campaign checks: SNRs at which early exit's phase 1 fails for some words
# but fewer than the checks' capacity of 3/4 of the batch
SAMPLER_CASES = [
    ("wman_ms10", WMAN, "MS", dict(cn=3), 10, "wman_ms10_base75ep.npz", 4.5),
    ("bg2_qms20", BG2, "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 3.0),
]


def sigma_of(code, snr_db):
    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig

    return float(AWGNChannel(code, ChannelConfig(snr_db=(snr_db,)), device="cpu").sigma[0])


def check_sampler(device, batch, seed=123457):
    """K1c against its plain version at a batch of many stream tiles;
    returns {case: max |LLR diff|}."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, fused_fwd_k1b, fused_fwd_k1c, fused_fwd_plain, sample_channel_plain,
        stats_plain)

    diffs = {}
    for name, code_name, dt, sharing, iters, weights, snr in SAMPLER_CASES:
        code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        fused = FusedMinsumDecoder.from_decoder(dec, params)
        lay, w, sigma = fused.layout, fused._w, sigma_of(code, snr)
        st, chan = fused_fwd_k1c(lay, *w, seed, sigma, batch=batch, emit_chan=True)
        ref_chan = sample_channel_plain(lay, seed, sigma, torch.arange(batch, device=device))
        delta = (chan - ref_chan).abs()
        within = bool((delta <= 1e-5 * (1 + ref_chan.abs())).all())
        diffs[name] = delta.max().item()
        ref_st = stats_plain(fused_fwd_plain(ref_chan, lay, *w), lay)
        st_b = fused_fwd_k1b(chan, lay, *w)
        widx = torch.randperm(batch, generator=torch.Generator().manual_seed(1))[:4096]
        widx = widx.to(device=device, dtype=torch.int32)
        at = fused_fwd_k1c(lay, *w, seed, sigma, widx=widx)
        if device.type == "cuda":
            torch.cuda.synchronize()
        eq_plain, eq_b = torch.equal(st, ref_st), torch.equal(st, st_b)
        eq_at = torch.equal(at, st[widx.long()])
        print(f"[check] {name} K1c: batch {batch} ({-(-batch // lay.bt)} stream tiles of "
              f"{lay.bt}) at {snr} dB: max |LLR kernel - plain| = {diffs[name]:.3g}, within "
              f"1e-5*(1+|llr|): {within}; stats = plain: {eq_plain}, = K1b on the exported "
              f"LLR: {eq_b}; index mode at {len(widx):,} scattered words = tile mode: {eq_at}; "
              f"words with ok {int(st[:, 0].sum())}, bit errors {int(st[:, 1].sum())}",
              flush=True)
        if not (within and eq_plain and eq_b and eq_at):
            fail(f"{name}: the sampling kernel disagrees with its plain version")
        del chan, ref_chan, delta
    return diffs


def campaign_channel(code, snr_db, decoder_type, device):
    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig

    return AWGNChannel(code, ChannelConfig(snr_db=(snr_db,),
                                           qms_qbit=5 if decoder_type == "QMS" else None),
                       device=device)


def check_campaigns(device, batch, n_batches=4):
    """Early-exit counters equal the full unroll's on the card, with
    in-kernel sampling on and off, and with capacity 1 (every window
    redone)."""
    from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign

    for (name, code_name, dt, sharing, iters, weights, snr), i1 in zip(SAMPLER_CASES, (2, 5)):
        code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        channel = campaign_channel(code, snr, dt, device)
        for sampling in ("on", "off"):
            base = dict(batch_size=batch, max_words_per_snr=n_batches * batch,
                        min_frame_errors=0, seed=7, engine="fused", sync_every_batches=n_batches,
                        early_exit_auto_guard=False, kernel_channel_sampling=sampling)
            runs = []
            for label, extra in (("full", {}),
                                 ("early exit", dict(early_exit_iters=i1,
                                                     early_exit_capacity=batch * 3 // 4)),
                                 ("capacity 1", dict(early_exit_iters=i1, early_exit_capacity=1))):
                camp = MonteCarloCampaign(dec, params, channel, CampaignConfig(**base, **extra))
                r = camp.run(verbose=False)[snr]
                runs.append(r)
                print(f"[campaign-check] {name} sampling {sampling}, {label}: {r['words']} words "
                      f"at {snr} dB, BER {r['ber'][0]:.6g}, FER {r['fer'][0]:.6g}, "
                      f"escalations {int(camp.escalations[0])}", flush=True)
            if not (runs[0] == runs[1] == runs[2]) or runs[0]["words"] != n_batches * batch:
                fail(f"{name}: early-exit counters differ from the full unroll "
                     f"(sampling {sampling})")


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


def epilogue_ops(lay) -> int:
    """K1b's work per word: a compare per bit (APP < 0) and a parity
    exclusive-or per edge copy; the integer count adds are data-dependent
    and left out."""
    return lay.N * lay.Z + lay.E * lay.Z


# per pair of uniforms: 2 x 23 integer and conversion instructions of the
# hash (2i + draw, ^key, two lowbias32 rounds of 8, ^(key * c), >> 8, cvt,
# * 2^-24), then 1 - u1, log, * -2, sqrt and 2 pi * u2; per bit cos or sin,
# r * g, * scale, + base.  logf, sqrtf, cosf and sinf are counted as one
# instruction each, the least their precise sequences take.
SAMPLER_OPS_PER_PAIR = 2 * 23 + 5
SAMPLER_OPS_PER_BIT = 4


def sampler_ops(lay) -> int:
    """K1c's sampler work per word (a pair of uniforms serves two bits)."""
    nz = lay.N * lay.Z
    return -(-nz // 2) * SAMPLER_OPS_PER_PAIR + nz * SAMPLER_OPS_PER_BIT


def bound_ms(lay, batch, mode="k1a"):
    """(least time in ms, "bytes" or "operations") for one launch over
    ``batch`` words in ``mode``: "k1a" (channel in, APP out), "k1b"
    (channel in, 12 bytes of stats out) or "k1c" (stats out only)."""
    nz = lay.N * lay.Z
    I = lay.n_iterations
    weights = 4 * I * (lay.E * (int(lay.has_cn_w or lay.has_ucn) + int(lay.has_ucn))
                       + lay.N * int(lay.has_vn_w))
    per_word = {"k1a": 2 * nz * 4, "k1b": nz * 4 + 12, "k1c": 12}[mode]
    nbytes = per_word * batch + weights + lay.tables.numel() * 4
    ops = ops_per_word(lay)
    if mode != "k1a":
        ops += epilogue_ops(lay)
    if mode == "k1c":
        ops += sampler_ops(lay)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops * batch / H100_INSTR_PER_S * 1e3
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


# (name, code, type, sharing, iterations, weights, snr_db, batch, early-exit
# iterations, warm-up batches, timed batches, in-kernel sampling):
# bench.py:145-174's campaign stage for wman, with the channel sampled in the
# kernel and, as the evaluate CLI runs it, read from the port's AWGN channel;
# and the BG2 flagship decoder in its waterfall
CAMPAIGN_CASES = [
    ("wman_ms10", WMAN, "MS", dict(cn=3), 10, "wman_ms10_base75ep.npz", 5.5, MAIN_BATCH, 2, 2, 16,
     "auto"),
    ("wman_ms10_read", WMAN, "MS", dict(cn=3), 10, "wman_ms10_base75ep.npz", 5.5, MAIN_BATCH, 2,
     2, 8, "off"),
    ("bg2_qms20", BG2, "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 2.5, 1 << 18, 5,
     2, 4, "auto"),
]


def make_campaign(case, device):
    """The MonteCarloCampaign of one CAMPAIGN_CASES entry, built through the
    user entry points."""
    from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign

    name, code_name, dt, sharing, iters, weights, snr, batch, i1, _, _, sampling = case
    code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
    camp = MonteCarloCampaign(dec, params, campaign_channel(code, snr, dt, device), CampaignConfig(
        batch_size=batch, min_frame_errors=0, max_words_per_snr=10**15, engine="fused",
        sync_every_batches=32, seed=1, early_exit_iters=i1, early_exit_capacity=batch // 32,
        early_exit_probe_batches=4, kernel_channel_sampling=sampling))
    if not camp.fused or camp.kernel_sampling != (sampling != "off"):
        fail(f"{name}: the campaign did not choose the fused engine with in-kernel sampling "
             f"{sampling}")
    return code, camp


def campaign_path(device):
    """The campaign at full width through ``MonteCarloCampaign.run_snr_point``,
    one run per case, with every kernel's launch counter set to 0 just before
    the run and read just after; returns ({case: result}, {case: {kernel:
    launches}})."""
    from neural_ldpc_tpu_torch.ops.cuda import fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c

    kernels = (fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c)
    results, launches = {}, {}
    for case in CAMPAIGN_CASES:
        name, snr, batch, i1, warm, timed = case[0], case[6], case[7], case[8], case[9], case[10]
        code, camp = make_campaign(case, device)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        camp.run_snr_point(0, batches=warm)  # auto-guard probe and warm-up, off the clock
        t_warm = time.perf_counter() - t0
        w0, e0 = int(camp.words[0]), int(camp.escalations[0])
        t0 = time.perf_counter()
        camp.run_snr_point(0, batches=timed)  # ends on the counter read
        dt_s = time.perf_counter() - t0
        launches[name] = {k.__name__: k.launches for k in kernels}
        r = camp.results()[snr]
        res = dict(batch=batch, snr_db=snr, early_exit_iters=i1, capacity=batch // 32,
                   kernel_sampling=camp.kernel_sampling, timed_batches=timed, timed_s=dt_s,
                   words_per_s=(int(camp.words[0]) - w0) / dt_s,
                   guard_keeps_early_exit=bool(camp._ee_choice.get(0)),
                   escalations_timed=int(camp.escalations[0]) - e0,
                   escalations_total=int(camp.escalations[0]), words=r["words"],
                   ber=r["ber"][0], fer=r["fer"][0], warmup_and_probe_s=t_warm,
                   launches=launches[name])
        print(f"[campaign] {name}: batch {batch} at {snr} dB, channel sampled "
              f"{'in the kernel' if camp.kernel_sampling else 'by AWGNChannel'}, {timed} timed "
              f"batches in {dt_s:.3f} s = {res['words_per_s']:,.0f} words/s end to end; "
              f"auto-guard keeps early exit: {res['guard_keeps_early_exit']}; escalations "
              f"{res['escalations_timed']} in the timed batches ({res['escalations_total']} in "
              f"all); {r['words']} words, decoded BER {r['ber'][0]:.4g}, FER {r['fer'][0]:.4g} "
              f"(probe and warm-up {t_warm:.2f} s); launches {launches[name]}", flush=True)
        if not r["words"] or not math.isfinite(r["ber"][0]):
            fail(f"{name}: the campaign counted nothing")
        kernel = "fused_fwd_k1c" if camp.kernel_sampling else "fused_fwd_k1b"
        if launches[name][kernel] == 0:
            fail(f"{name}: the campaign never launched {kernel}")
        results[name] = res
        del camp
    return results, launches


def check_campaign_shapes(device, reps=3):
    """Each campaign's own phase-1 and escalation decoders at the shapes the
    campaign path launches: phase 1 over the whole batch at I1 iterations,
    the escalation at K = batch // 32 scattered words (index mode when the
    kernel samples), each held exactly against its plain version, and timed.
    Returns {case: result}."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import fused_fwd_plain, sample_channel_plain, stats_plain

    out = {}
    for case in CAMPAIGN_CASES:
        name, snr, batch = case[0], case[6], case[7]
        code, camp = make_campaign(case, device)
        p1, esc = camp.decoders["phase1"], camp.decoders["escalation"]
        sigma, seed = float(camp.channel.sigma[0]), 97531
        idx = torch.randperm(batch, generator=torch.Generator().manual_seed(2))[:batch // 32]
        idx = idx.sort().values.to(device=device, dtype=torch.int32)
        # (label, decoder, kernel call, plain channel of the words s..e-1)
        if camp.kernel_sampling:
            words, esc_bt = torch.arange(batch, device=device), esc._delegate.sample_at_idx
            runs = (("phase1", p1, lambda: p1.sample_stats(seed, sigma, batch),
                     lambda s, e: sample_channel_plain(p1.layout, seed, sigma, words[s:e])),
                    ("escalation", esc, lambda: esc.stats_sampled_at(seed, sigma, idx),
                     lambda s, e: sample_channel_plain(esc.layout, seed, sigma, idx[s:e], esc_bt)))
        else:
            llr, _ = channel_llr(code, snr, batch, seed=seed, device=device)
            chan, rows = llr.reshape(batch, -1), idx.long()
            runs = (("phase1", p1, lambda: p1(chan), lambda s, e: chan[s:e]),
                    ("escalation", esc, lambda: esc(chan[rows]), lambda s, e: chan[rows[s:e]]))
        res = {}
        for label, dec, kernel, plain_chan in runs:
            ms = cuda_ms(kernel, reps)
            got = torch.stack([t.to(torch.int32) for t in kernel()], dim=1)
            n, lay = got.shape[0], dec.layout
            ref = torch.cat([stats_plain(fused_fwd_plain(plain_chan(s, min(s + PLAIN_CHUNK, n)),
                                                         lay, *dec._w), lay)
                             for s in range(0, n, PLAIN_CHUNK)])
            diff = (got - ref).abs().max().item()
            res[label] = dict(words=n, iterations=lay.n_iterations, ms=ms, max_abs_diff=diff,
                              failures=int((got[:, 0] == 0).sum()))
            mode = ("read channel" if not camp.kernel_sampling
                    else "index mode" if label == "escalation" else "tile mode")
            print(f"[campaign-shape] {name} {label}: {n:,} words at {lay.n_iterations} "
                  f"iterations ({mode}), {ms:.3f} ms per launch; max |kernel - plain| = {diff}; "
                  f"words failing the syndrome {res[label]['failures']:,}", flush=True)
            if diff != 0:
                fail(f"{name} {label}: the kernel disagrees with its plain version at the "
                     "campaign's shape")
            del got, ref
        out[name] = res
        del camp, runs
    return out


def time_campaign_kernels(device, batch, reps):
    """K1b (stats from a read channel) and K1c (sampled stats) on wman
    MS x10 at ``batch``: kernel time, plain-version time, bound, and both
    held against their plain versions over the whole batch.  Returns
    {kernel: result}."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, fused_fwd_k1b, fused_fwd_k1c, fused_fwd_plain, sample_channel_plain,
        stats_plain)

    name, code_name, dt, sharing, iters, weights, snr = CAMPAIGN_CASES[0][:7]
    code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
    fused = FusedMinsumDecoder.from_decoder(dec, params)
    lay, w, sigma, seed = fused.layout, fused._w, sigma_of(code, snr), 424242
    llr, _ = channel_llr(code, snr, batch, seed=55, device=device)
    chan = llr.reshape(batch, -1)
    out = {}
    runs = {
        "fused_fwd_k1b": (lambda: fused_fwd_k1b(chan, lay, *w),
                          lambda s, e: stats_plain(fused_fwd_plain(chan[s:e], lay, *w), lay)),
        "fused_fwd_k1c": (lambda: fused_fwd_k1c(lay, *w, seed, sigma, batch=batch),
                          lambda s, e: stats_plain(fused_fwd_plain(sample_channel_plain(
                              lay, seed, sigma, torch.arange(s, e, device=device)), lay, *w),
                              lay)),
    }
    for kname, (kernel, plain) in runs.items():
        ms = cuda_ms(kernel, reps)
        st = kernel()
        ref = torch.empty_like(st)

        def run_plain(n=batch):
            for s in range(0, n, PLAIN_CHUNK):
                ref[s:s + PLAIN_CHUNK] = plain(s, min(s + PLAIN_CHUNK, n))

        plain_ms = cuda_ms(run_plain, 1, warmup=lambda: run_plain(PLAIN_CHUNK))
        diff = (st - ref).abs().max().item()
        mode = "k1b" if kname == "fused_fwd_k1b" else "k1c"
        b_ms, b_by = bound_ms(lay, batch, mode)
        ops = ops_per_word(lay) + epilogue_ops(lay) + (sampler_ops(lay) if mode == "k1c" else 0)
        out[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          ops_per_word=ops, roofline_share=b_ms / ms, full_batch_diff=diff,
                          words_per_s=batch / ms * 1e3,
                          shape=f"{name} (MS x10, cn=3, trained), batch {batch}, {snr} dB")
        print(f"[time] {kname}: {name} batch {batch}, kernel {ms:.3f} ms per launch "
              f"({batch / ms * 1e3:,.0f} words/s), bound {b_ms:.3f} ms ({b_by}, {ops:,} ops "
              f"per word), roofline share {b_ms / ms:.4f}; plain version {plain_ms:.1f} ms; "
              f"max |kernel - plain| over the batch = {diff}; words with ok "
              f"{int(st[:, 0].sum())}, bit errors {int(st[:, 1].sum())}", flush=True)
        if diff != 0:
            fail(f"{kname}: kernel disagrees with its plain version over the whole batch")
        del st, ref
    return out


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

    diffs, stats_diffs = check_kernel(device, CHECK_BATCH)
    llr_diffs = check_sampler(device, SAMPLER_BATCH)
    check_campaigns(device, CAMPAIGN_CHECK_BATCH)
    shapes = check_campaign_shapes(device)
    results, launches = main_path(device, MAIN_BATCH)
    time_configs(results, MAIN_BATCH, REPS, diffs)
    camp_results, camp_launches = campaign_path(device)
    ktimes = time_campaign_kernels(device, MAIN_BATCH, REPS)

    res = results["bg2_qms20"][0]
    k1b, k1c = ktimes["fused_fwd_k1b"], ktimes["fused_fwd_k1c"]
    stats_diffs["wman_ms10_full_batch"] = k1b["full_batch_diff"]
    # K1b's launches are the read-channel campaign's (the evaluate CLI's
    # path), K1c's the sampling campaigns'; each run had its counters at 0
    sampled = [c[0] for c in CAMPAIGN_CASES if c[11] != "off"]
    read = [c[0] for c in CAMPAIGN_CASES if c[11] == "off"]
    shape_diffs = {f"{c}_{label}": r["max_abs_diff"] for c, rs in shapes.items()
                   for label, r in rs.items()}
    stats_diffs.update({k: v for k, v in shape_diffs.items() if k.startswith(tuple(read))})
    llr_diffs = dict(llr_diffs, **{k: v for k, v in shape_diffs.items()
                                   if k.startswith(tuple(sampled))})
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
    }, {
        "name": "fused_fwd_k1b",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_STATS,
        "launches": sum(camp_launches[c]["fused_fwd_k1b"] for c in read),
        "max_abs_err": max(stats_diffs.values()),
        "max_abs_diff": stats_diffs,
        "ms": k1b["ms"],
        "plain_ms": k1b["plain_ms"],
        "bound_ms": k1b["bound_ms"],
        "bound_by": k1b["bound_by"],
        "library_ms": None,  # no PyTorch call computes a stats BP decode
        "shape": k1b["shape"],
        "timing": k1b,
    }, {
        "name": "fused_fwd_k1c",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_SAMPLER,
        "launches": sum(camp_launches[c]["fused_fwd_k1c"] for c in sampled),
        "max_abs_err": max(max(llr_diffs.values()), k1c["full_batch_diff"]),
        "max_abs_diff": dict(llr_diffs, wman_ms10_stats_full_batch=k1c["full_batch_diff"]),
        "ms": k1c["ms"],
        "plain_ms": k1c["plain_ms"],
        "bound_ms": k1c["bound_ms"],
        "bound_by": k1c["bound_by"],
        "library_ms": None,  # no PyTorch call computes this sampler inside a decode
        "shape": k1c["shape"],
        "timing": k1c,
        "campaigns": camp_results,
        "campaign_launches": camp_launches,
        "campaign_shapes": shapes,
    }]}
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
