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
10. Holds the training kernels against their plain versions on the cases of
    step 3, at batch 4,096 and 4,097: the training forward (K1d) outputs and
    stored messages (QMS exact, MS 2e-5, SP 5e-3), its last output equal to
    K1a's APP and the ``all_iterations`` decode equal to its clipped stream;
    the backward (K2) on a seeded random cotangent (channel gradients within
    atol 1e-6 / rtol 1e-4, weight gradients within 1e-4 of max |g|); and
    the whole loss's gradients through ``FusedTrainFn`` against the plain
    engine's autograd on the card, at the same bars.
11. Drives the training path at full width with every counter set to 0
    just before each run and read just after: the ``bg2_qms_train`` preset
    (BG2 QMS x20, CN and VN weights, random codewords, batch 20, lr 1e-3)
    through ``Trainer`` with ``engine="fused"``, seed 2042, 3 epochs of
    2,000 words validated on 1,000 words and checkpointed every epoch; then
    resumes from the epoch-2 checkpoint for epoch 3 and requires params
    equal to the uninterrupted run bit for bit; then runs the train CLI for
    one epoch.  K1d and K2 must launch once per step.
12. One train step on each engine on the card, same params and data, batch
    20: loss within 1e-6; params within 1e-6 where the plain engine's |g| >
    1e-5 and within 2 lr elsewhere.
13. Times K1d and K2 per launch at 16,384 words of the preset's decoder
    against their bounds and plain versions (holding both against the plain
    versions over that batch), the same at the preset's batch of 20, and
    the whole fused train step at batch 20 and 16,384 (the plain engine's
    step at 20).
14. Prints the kernel table as one JSON line and, last, the
    ``{"ok": true, "device": {...}}`` line.

Any failed build, launch or comparison exits nonzero.  Without CUDA, or
without the package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
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
TPU_STREAM = "neural_ldpc_tpu/ops/pallas/fused_train.py:871"  # store_msgs / stream_outputs
TPU_BWD = "neural_ldpc_tpu/ops/pallas/fused_train.py:1334"  # _bwd_kernel
KERNEL_SOURCE = "neural_ldpc_tpu_torch/csrc/fused_fwd.cu"
BWD_SOURCE = "neural_ldpc_tpu_torch/csrc/fused_bwd.cu"
TRAIN_BATCH = 16384  # timing batch of the training kernels and the step
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


# ---------------------------------------------------------------------------
# Training: K1d and K2
# ---------------------------------------------------------------------------
def bwd_ops_per_word(lay) -> int:
    """fp32 operations of one word's backward (csrc/fused_bwd.cu), counted
    as ``ops_per_word`` counts the forward's (per-VN-copy work once per
    copy, transcendentals 1 each, a recompute counted once even where the
    kernel repeats it): the forward recompute, the post-chain adjoint
    (|c2v|, weight, ReLU, clip/quantize masks, re-sign), the check-update
    adjoint (two-min: tie counts and routing; SP: the chains), the two VN
    sums and the edge reduction."""
    qms = lay.qms_qbit is not None
    quant = 5
    cq = quant if qms else 2
    mask = 6  # clip_mask: 2 compares, 2 selects, max, mul
    per_vn = 1 + 2 + 2  # vn total; g_out into two carries; negate, carry add
    if lay.has_vn_w:
        per_vn += 1 + (quant if qms else 0)  # xa_q
        per_vn += 1 + (mask if qms else 0) + 1 + 2  # g_xa, VN-weight term, g_chan
    if lay.has_ucn:
        per_vn += 2  # clip of the previous APP
    per_edge = 1 + cq  # v2c = clip_or_quant(total - msg)
    per_edge += 11 if lay.sum_product else 7  # the check update's recompute
    per_edge += 2 + 1 + 1 + 1 + 2 + 1 + 1 + mask + 1 + 2 + 1 + 1 + 1  # post-chain adjoint
    per_edge += 26 if lay.sum_product else 15  # check-update adjoint
    per_edge += mask + 2  # clip mask of v2c, new carry
    per_edge += 2 * int(lay.has_ucn)  # parity, weight select
    per_edge += 3  # VN sums of the store and the carry, edge reduction
    return lay.n_iterations * (lay.E * lay.Z * per_edge + lay.N * lay.Z * per_vn)


def train_bound_ms(lay, batch, mode):
    """(least time in ms, "bytes" or "operations") of one K1d launch with
    its store or one K2 launch over ``batch`` words: each input read once,
    each output written once, weights and tables included."""
    nz, ez, I = lay.N * lay.Z, lay.E * lay.Z, lay.n_iterations
    qms = lay.qms_qbit is not None
    weights = 4 * I * (lay.E * (int(lay.has_cn_w or lay.has_ucn) + int(lay.has_ucn))
                       + lay.N * int(lay.has_vn_w))
    if mode == "k1d":  # channel in; every iteration's APP and entering messages out
        per_word, ops = (nz + I * nz + I * ez) * 4, ops_per_word(lay)
        out_w = 0
    else:  # channel, store, g_outs (outs with UCN) in; g_chan (g_chanq) out
        per_word = (nz + I * ez + I * nz * (1 + int(lay.has_ucn)) + nz * (1 + int(qms))) * 4
        ops, out_w = bwd_ops_per_word(lay), weights
    nbytes = per_word * batch + weights + out_w + lay.tables.numel() * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops * batch / H100_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _grad_diffs(got, ref):
    """Max |diff| of K2's outputs against reference gradients, failing
    beyond the bars: channel gradients atol 1e-6 / rtol 1e-4, weight
    gradients 1e-4 of max |g|.  Returns (max |diff| of the channel ones,
    max relative diff of the weight ones)."""
    ch, wrel = 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        if (a is None) != (b is None):
            fail("a gradient is missing on one side")
        if a is None:
            continue
        d = (a - b).abs()
        if i >= 3:
            if not bool((d <= 1e-6 + 1e-4 * b.abs()).all()):
                return None
            ch = max(ch, d.max().item())
        else:
            rel = d.max().item() / max(b.abs().max().item(), 1e-30)
            if not rel <= 1e-4:
                return None
            wrel = max(wrel, rel)
    return ch, wrel


def check_training_kernels(device, batch):
    """K1d, K2, the all_iterations decode and the whole loss's gradients on
    CHECK_CASES; returns ({case: max |K1d - plain|}, {case: K2 diffs})."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, FusedTrainDecoder, fused_bwd_k2, fused_bwd_plain, fused_fwd_k1a,
        fused_fwd_k1d, fused_fwd_train_plain)
    from neural_ldpc_tpu_torch.training import multi_iteration_loss

    k1d_diffs, k2_diffs = {}, {}
    for name, code_name, dt, sharing, iters, weights, snr, _ in CHECK_CASES:
        code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        fused = FusedMinsumDecoder.from_decoder(dec, params)
        every = FusedMinsumDecoder.from_decoder(dec, params, all_iterations=True)
        lay, w = fused.layout, fused._w
        worst, last, stream = 0.0, True, True
        for b in (batch, batch + 1):
            llr, bits = channel_llr(code, snr, b, seed=13, device=device,
                                    qms_qbit=5 if dt == "QMS" else None)
            chan = llr.reshape(b, -1)
            outs, st = fused_fwd_k1d(chan, lay, *w)
            ref_outs, ref_st = fused_fwd_train_plain(chan, lay, *w)
            torch.cuda.synchronize()
            d = max((outs - ref_outs).abs().max().item(), (st - ref_st).abs().max().item())
            last &= torch.equal(outs[-1], fused_fwd_k1a(chan, lay, *w))
            stream &= torch.equal(every(chan), outs.clamp(lay.clip_lo, lay.clip_hi))
            worst = max(worst, d)
            del ref_outs, ref_st
            if b == batch + 1:
                continue
            g = torch.randn(outs.shape, device=device,
                            generator=torch.Generator(device=device).manual_seed(3))
            k2 = _grad_diffs(fused_bwd_k2(chan, lay, *w, st, outs, g),
                             fused_bwd_plain(chan, lay, *w, st, outs, g))
            # the whole loss through FusedTrainFn against the plain engine's autograd
            grads = []
            for engine in ("plain", "fused"):
                p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
                x = llr.clone().requires_grad_(True)
                o = (dec.apply(p, x) if engine == "plain" else
                     FusedTrainDecoder.from_decoder(dec).apply(*dec._expanded_weights(p), x))
                loss = multi_iteration_loss(o, bits, coeff=list(range(iters)))
                grads.append((loss.item(), torch.autograd.grad(loss, [*p.values(), x])))
                del o, loss
            (l0, g0), (l1, g1) = grads
            pad = [None] * (3 - len(params))
            step = _grad_diffs((*g1[:-1], *pad, g1[-1], None), (*g0[:-1], *pad, g0[-1], None))
            k2_diffs[name] = dict(kernel_vs_plain=k2, step_vs_plain_engine=step,
                                  loss_diff=abs(l0 - l1))
            del outs, st, g, grads, g0, g1
        k1d_diffs[name] = worst
        print(f"[train-check] {name}: K1d outputs and store max |kernel - plain| = {worst:.3g} "
              f"(tolerance {TOLERANCE[dt]:g}) at {batch} and {batch + 1} words; last output = "
              f"K1a: {last}; all_iterations decode = clipped stream: {stream}; K2 vs plain "
              f"(channel max |diff|, weights max rel diff): {k2}; whole-loss gradients vs the "
              f"plain engine: {step}, loss diff {k2_diffs[name]['loss_diff']:.3g}", flush=True)
        if not (worst <= TOLERANCE[dt] and last and stream and k2 is not None and step is not None
                and k2_diffs[name]["loss_diff"] <= 1e-6):
            fail(f"{name}: a training kernel disagrees with its plain version")
    return k1d_diffs, k2_diffs


def preset_trainer(device, ckpt_dir, epochs, words=2000, validate=1000):
    """The bg2_qms_train preset with the fused engine, as a user builds it:
    (config, decoder, channel, TrainConfig)."""
    from neural_ldpc_tpu_torch.models import BoostedNeuralDecoder
    from neural_ldpc_tpu_torch.utils.config import get_preset

    cfg = get_preset("bg2_qms_train").override(
        engine="fused", total_epochs=epochs, train_words_per_epoch=words,
        validate_words=validate, validate_epoch_step=1, checkpoint_step=1,
        checkpoint_dir=ckpt_dir)
    code, graph = cfg.build_graph()
    channel = cfg.build_channel(code, device=device)
    dec = BoostedNeuralDecoder(graph, cfg.build_decoder_config(), device=device)
    return cfg, dec, channel, dataclasses.replace(cfg.build_train_config(), verbose=False)


def _zero_counters():
    from neural_ldpc_tpu_torch.ops.cuda import (
        fused_bwd_k2, fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c, fused_fwd_k1d)

    kernels = (fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c, fused_fwd_k1d, fused_bwd_k2)
    for k in kernels:
        k.launches = 0
    return lambda: {k.__name__: k.launches for k in kernels}


def training_path(device, words=2000, validate=1000):
    """bg2_qms_train through Trainer (fused engine) for 3 epochs of
    ``words`` words, validated on ``validate``, the resume from epoch 2, and
    the train CLI for one epoch, each with every counter set to 0 just
    before and read just after.  Returns a result dict."""
    import torch

    from neural_ldpc_tpu_torch.cli import train as train_cli
    from neural_ldpc_tpu_torch.training import Trainer

    epochs = 3
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg, dec, channel, tcfg = preset_trainer(device, os.path.join(tmp, "run"), epochs,
                                                 words, validate)
        steps_per_epoch = words // tcfg.batch_size
        read = _zero_counters()
        t0 = time.perf_counter()
        params, opt, summary = Trainer(dec, channel, tcfg).train()
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        out["launches"] = read()
        per_epoch = []
        for e in range(epochs + 1):
            with open(os.path.join(tcfg.checkpoint_dir, f"checkpoint_epoch_{e:04d}.json")) as f:
                # the metadata keeps numpy scalars as strings, as JAX's does
                per_epoch.append(dict(epoch=e, **{k: float(v) for k, v in
                                                  json.load(f)["metrics"].items()}))
        out["epochs"] = per_epoch
        for m in per_epoch:
            print(f"[train] epoch {m['epoch']}: validation loss {m['loss']:.6f}, last-iteration "
                  f"BER {m['ber_last_iter']:.6e}, FER {m['fer_last_iter']:.6f}", flush=True)
        steps = epochs * steps_per_epoch
        print(f"[train] bg2_qms_train, fused engine: {steps} steps of batch {tcfg.batch_size} "
              f"and {epochs + 1} validations of {validate:,} words in {out['train_s']:.2f} s; "
              f"launches "
              f"{out['launches']}", flush=True)
        if not all(math.isfinite(m["loss"]) for m in per_epoch):
            fail("the training run gave a non-finite validation loss")
        if (out["launches"]["fused_fwd_k1d"], out["launches"]["fused_bwd_k2"]) != (steps, steps):
            fail("K1d and K2 did not launch once per training step")

        read = _zero_counters()
        resumed, _, _ = Trainer(dec, channel, tcfg).resume("checkpoint_epoch_0002")
        torch.cuda.synchronize()
        out["resume_launches"] = read()
        out["resume_bitwise"] = all(torch.equal(params[k], resumed[k]) for k in params)
        print(f"[train] resumed from the epoch-2 checkpoint for epoch 3: params equal to the "
              f"uninterrupted run bit for bit: {out['resume_bitwise']}; launches "
              f"{out['resume_launches']}", flush=True)
        if not out["resume_bitwise"]:
            fail("the resumed run differs from the uninterrupted one")
        if out["resume_launches"]["fused_fwd_k1d"] != steps_per_epoch:
            fail("the resumed epoch did not launch K1d once per step")

        read = _zero_counters()
        argv = ["--preset", "bg2_qms_train", "--set", 'engine="fused"', "--epochs", "1",
                "--device", str(device),
                "--set", f"checkpoint_dir={os.path.join(tmp, 'cli')}",
                "--set", f"train_words_per_epoch={words}", "--set", f"validate_words={validate}",
                "--set", "validate_epoch_step=1", "--set", "checkpoint_step=1"]
        t0 = time.perf_counter()
        if train_cli.main(argv) != 0:
            fail("the train CLI failed")
        torch.cuda.synchronize()
        out["cli_s"] = time.perf_counter() - t0
        out["cli_launches"] = read()
        print(f"\n[train] cli.train.main(--preset bg2_qms_train --set engine=fused --epochs 1): "
              f"{out['cli_s']:.2f} s; launches {out['cli_launches']}", flush=True)
        if out["cli_launches"]["fused_bwd_k2"] != steps_per_epoch:
            fail("the train CLI did not launch K2 once per step")
    return out


def preset_params(dec, device, seed=4):
    """Random weights around 1 from ``seed``, for the preset's decoder."""
    import numpy as np

    from neural_ldpc_tpu_torch.models import params_from_numpy

    rng = np.random.default_rng(seed)
    return params_from_numpy({k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape)))
                              .astype(np.float32) for k, v in dec.init_params().items()}, device)


def check_engines(device, lr=1e-3):
    """One step on each engine, same params and data, batch 20."""
    import torch

    from neural_ldpc_tpu_torch.training import TrainConfig, make_train_step, multi_iteration_loss

    with tempfile.TemporaryDirectory() as tmp:
        cfg, dec, channel, _ = preset_trainer(device, tmp, 1)
    params = preset_params(dec, device)
    llr, bits = channel.sample_mixed(channel.generator(5), 20, all_zero=False)
    res = {}
    for engine in ("xla", "fused"):
        init, step = make_train_step(dec, TrainConfig(engine=engine))
        res[engine] = step(params, init(params), llr, bits, lr)
    pg = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = multi_iteration_loss(dec.apply(pg, llr), bits, coeff=list(range(20)))
    grads = dict(zip(pg, torch.autograd.grad(loss, list(pg.values()))))
    loss_diff = abs(res["xla"][2].item() - res["fused"][2].item())
    big_diff = small_diff = 0.0
    for k in params:
        diff = (res["xla"][0][k] - res["fused"][0][k]).abs()
        big = grads[k].abs() > 1e-5
        big_diff = max(big_diff, diff[big].max().item() if big.any() else 0.0)
        small_diff = max(small_diff, diff.max().item())
    print(f"[engines] one bg2_qms_train step, batch 20: loss plain {res['xla'][2].item():.8f} "
          f"fused {res['fused'][2].item():.8f} (|diff| {loss_diff:.3g}); params max |diff| "
          f"{big_diff:.3g} where |g| > 1e-5, {small_diff:.3g} elsewhere (bar 2 lr = {2 * lr:g})",
          flush=True)
    if not (loss_diff <= 1e-6 and big_diff <= 1e-6 and small_diff <= 2 * lr):
        fail("the fused train step disagrees with the plain one")
    return {"loss_diff": loss_diff, "params_diff_where_g_above_1e-5": big_diff,
            "params_diff_elsewhere": small_diff}


def time_training(device, batch, reps):
    """K1d and K2 at ``batch`` words of the preset's decoder: kernel time,
    bound, plain version's time, both held against the plain versions over
    the batch; and the whole train step at batch 20 (both engines) and at
    ``batch`` (fused).  Returns a result dict."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, fused_bwd_k2, fused_bwd_plain, fused_fwd_k1d, fused_fwd_train_plain)
    from neural_ldpc_tpu_torch.training import TrainConfig, make_train_step

    with tempfile.TemporaryDirectory() as tmp:
        cfg, dec, channel, _ = preset_trainer(device, tmp, 1)
    params = preset_params(dec, device)
    fused = FusedMinsumDecoder.from_decoder(dec, params)
    lay, w = fused.layout, fused._w
    llr, bits = channel.sample_mixed(channel.generator(9), batch, all_zero=False)
    chan = llr.reshape(batch, -1)
    res = {}
    ms = cuda_ms(lambda: fused_fwd_k1d(chan, lay, *w), reps)
    outs, st = fused_fwd_k1d(chan, lay, *w)
    plain_ms = cuda_ms(lambda: fused_fwd_train_plain(chan, lay, *w), 1)
    ref_outs, ref_st = fused_fwd_train_plain(chan, lay, *w)
    diff = max((outs - ref_outs).abs().max().item(), (st - ref_st).abs().max().item())
    del ref_outs, ref_st
    b_ms, b_by = train_bound_ms(lay, batch, "k1d")
    res["fused_fwd_k1d"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                roofline_share=b_ms / ms, full_batch_diff=diff,
                                ops_per_word=ops_per_word(lay),
                                bytes_per_word=(lay.N * lay.Z * (1 + lay.n_iterations)
                                                + lay.E * lay.Z * lay.n_iterations) * 4)
    g = torch.randn(outs.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(3))
    ms2 = cuda_ms(lambda: fused_bwd_k2(chan, lay, *w, st, outs, g), reps)
    plain_ms2 = cuda_ms(lambda: fused_bwd_plain(chan, lay, *w, st, outs, g), 1)
    k2 = _grad_diffs(fused_bwd_k2(chan, lay, *w, st, outs, g),
                     fused_bwd_plain(chan, lay, *w, st, outs, g))
    b2_ms, b2_by = train_bound_ms(lay, batch, "k2")
    res["fused_bwd_k2"] = dict(ms=ms2, plain_ms=plain_ms2, bound_ms=b2_ms, bound_by=b2_by,
                               roofline_share=b2_ms / ms2, full_batch_diff=k2,
                               ops_per_word=bwd_ops_per_word(lay),
                               words_per_block=lay.bwd_words_per_block)
    del outs, st, g
    for name, r in res.items():
        print(f"[time] {name}: bg2_qms_train decoder (BG2 QMS x20, cn vn), batch {batch}, "
              f"kernel {r['ms']:.3f} ms per launch, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}, {r['ops_per_word']:,} ops per word), roofline share "
              f"{r['roofline_share']:.4f}; plain version {r['plain_ms']:.1f} ms; over the batch "
              f"kernel vs plain: {r['full_batch_diff']}", flush=True)
    if not (diff == 0 and k2 is not None):
        fail("a training kernel disagrees with its plain version over the timed batch")

    # the preset's own batch: what one train step launches
    b = 20
    llr20, _ = channel.sample_mixed(channel.generator(11), b, all_zero=False)
    chan20 = llr20.reshape(b, -1)
    outs, st = fused_fwd_k1d(chan20, lay, *w)
    g = torch.randn(outs.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(4))
    for name, kernel, plain, mode in (
            ("fused_fwd_k1d", lambda: fused_fwd_k1d(chan20, lay, *w),
             lambda: fused_fwd_train_plain(chan20, lay, *w), "k1d"),
            ("fused_bwd_k2", lambda: fused_bwd_k2(chan20, lay, *w, st, outs, g),
             lambda: fused_bwd_plain(chan20, lay, *w, st, outs, g), "k2")):
        r = dict(ms=cuda_ms(kernel, reps), plain_ms=cuda_ms(plain, reps))
        r["bound_ms"], r["bound_by"] = train_bound_ms(lay, b, mode)
        res[name][f"batch_{b}"] = r
        print(f"[time] {name}: batch {b}, kernel {r['ms']:.3f} ms per launch, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain version {r['plain_ms']:.3f} ms",
              flush=True)
    del outs, st, g

    steps = {}
    for b, engines in ((20, ("fused", "xla")), (batch, ("fused",))):
        x, y = channel.sample_mixed(channel.generator(10), b, all_zero=False)
        for engine in engines:
            init, step = make_train_step(dec, TrainConfig(engine=engine))
            opt = init(params)
            t = cuda_ms(lambda: step(params, opt, x, y, 1e-3), reps)
            steps[f"{engine}_batch_{b}"] = dict(ms=t, words_per_s=b / t * 1e3)
            print(f"[time] train step, {engine} engine, batch {b}: {t:.3f} ms = "
                  f"{b / t * 1e3:,.0f} words/s", flush=True)
            if engine == "fused":
                steps[f"{engine}_batch_{b}"].update(profile_step(
                    lambda: step(params, opt, x, y, 1e-3), reps))
    res["steps"] = steps
    return res


def profile_step(fn, reps):
    """torch.profiler over ``reps`` calls of ``fn``: device kernels per call,
    their summed device time per call and its share of the wall time per
    call (the rest is host work and launch gaps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("[profile] the profiler recorded no device kernels: device time not measured",
              flush=True)
        return dict(profiled_wall_ms=wall_ms, device_ms_per_step=None)
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / reps
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.device_time_total / 1e3 / reps
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:4])
    out = dict(profiled_wall_ms=wall_ms, kernels_per_step=len(kernels) / reps,
               device_ms_per_step=device_ms, device_busy_share=device_ms / wall_ms,
               top_kernels_ms={k[:60]: v for k, v in top.items()})
    print(f"[profile] {len(kernels) / reps:.0f} device kernels per step, {device_ms:.3f} ms of "
          f"device time in a {wall_ms:.3f} ms step (busy share {device_ms / wall_ms:.3f}); "
          f"largest: {out['top_kernels_ms']}", flush=True)
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
    sources = ("fused_fwd", "fused_bwd")
    _build.load_all(sources)  # one nvcc per source, in parallel
    print(f"[build] {', '.join(f'{n}.cu' for n in sources)}: "
          f"{time.perf_counter() - t_build:.1f} s", flush=True)
    for name in sources:
        for line in _build.build_log.get(name, "").splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "Compiling entry" in line):
                print(f"[build] {name}: {line.strip()}", flush=True)

    diffs, stats_diffs = check_kernel(device, CHECK_BATCH)
    llr_diffs = check_sampler(device, SAMPLER_BATCH)
    check_campaigns(device, CAMPAIGN_CHECK_BATCH)
    shapes = check_campaign_shapes(device)
    results, launches = main_path(device, MAIN_BATCH)
    time_configs(results, MAIN_BATCH, REPS, diffs)
    camp_results, camp_launches = campaign_path(device)
    ktimes = time_campaign_kernels(device, MAIN_BATCH, REPS)
    k1d_diffs, k2_diffs = check_training_kernels(device, CHECK_BATCH)
    train = training_path(device)
    engines = check_engines(device)
    ttimes = time_training(device, TRAIN_BATCH, REPS)

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
    }, {
        "name": "fused_fwd_k1d",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_STREAM,
        "launches": train["launches"]["fused_fwd_k1d"],
        "max_abs_err": max(k1d_diffs.values()),
        "max_abs_diff": dict(k1d_diffs, bg2_qms_train_timed_batch=ttimes["fused_fwd_k1d"][
            "full_batch_diff"]),
        "ms": ttimes["fused_fwd_k1d"]["ms"],
        "plain_ms": ttimes["fused_fwd_k1d"]["plain_ms"],
        "bound_ms": ttimes["fused_fwd_k1d"]["bound_ms"],
        "bound_by": ttimes["fused_fwd_k1d"]["bound_by"],
        "library_ms": None,  # no PyTorch call computes a BP forward with stored state
        "shape": f"bg2_qms_train (BG2 QMS x20, cn vn), batch {TRAIN_BATCH}",
        "timing": ttimes["fused_fwd_k1d"],
        "training": train,
    }, {
        "name": "fused_bwd_k2",
        "route": "cuda",
        "source": BWD_SOURCE,
        "replaces": TPU_BWD,
        "launches": train["launches"]["fused_bwd_k2"],
        "max_abs_err": max(max(d["kernel_vs_plain"][0], d["step_vs_plain_engine"][0])
                           for d in k2_diffs.values()),
        "max_abs_diff": dict(k2_diffs, bg2_qms_train_timed_batch=ttimes["fused_bwd_k2"][
            "full_batch_diff"]),
        "ms": ttimes["fused_bwd_k2"]["ms"],
        "plain_ms": ttimes["fused_bwd_k2"]["plain_ms"],
        "bound_ms": ttimes["fused_bwd_k2"]["bound_ms"],
        "bound_by": ttimes["fused_bwd_k2"]["bound_by"],
        "library_ms": None,  # no PyTorch call computes the adjoint of a BP decode
        "shape": f"bg2_qms_train (BG2 QMS x20, cn vn), batch {TRAIN_BATCH}",
        "timing": ttimes["fused_bwd_k2"],
        "train_steps": ttimes["steps"],
        "engines": engines,
    }]}
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
