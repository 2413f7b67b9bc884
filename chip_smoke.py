#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``neural_ldpc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (name and power limit from nvidia-smi).
2. Builds every CUDA kernel from ``csrc/`` (seven sources, one nvcc each, in
   parallel) and prints ptxas' register and spill lines, and those of the
   forward's instantiations (K1, K6 and K5, by the largest slot count MAXB
   and routing), of the cluster K3's (by QMS) and of the cluster K4's (by
   QMS and sum-product) in one line each; then the
   forward's block on wman and BG2: words and threads a block, shared
   memory, and the card's blocks an SM
   (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
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
   words (K1c index mode, or K1b on gathered rows of a read channel), each
   timed and printed beside its bound.
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
14. Holds the device-memory kernels against the on-chip ones on the cases
    of step 3 at 4,096 and 4,097 words, ``store_space="hbm"`` against
    ``"vmem"`` (K3 and K4 the cluster kernels, a cluster of 1): K3 equal to
    K1 bit for bit in every mode (final APP, stats,
    syndrome, stream, its store slots equal to K1d's ``store[1:]``), K4's
    channel gradients equal to K2's and its twin's bit for bit, its weights
    within 1e-4 of max |g|, and at K2's bars against the device-memory
    plain version; then times each
    pair on the same inputs at 16,384 words (K3 against K1a and K1d, K4
    against K2).
15. Holds the cluster K3 against its plain version on the BG1-like code at
    Z = 384 (a cluster of 4) and Z = 256 (3) (MS with the trained weights
    of paths a and c, QMS x10 with UCN, SP x5) at 2,048 words, stats exact
    (the stream and store too at Z = 256); the two-pass K3 against its
    plain version where no cluster holds the word (the BG1-like code at
    Z = 1024, 64 words, every mode); the device-memory K4 where no cluster
    holds a word's backward (the cross-lift decoder trained at Z = 384, 16
    words), against its plain version, timed against its bound, its CUDA
    launches counted; and the whole loss's gradients through
    ``FusedTrainFn`` (K3, K4) against the plain engine's autograd at
    Z = 256, batch 64.
16. Path (a): the decode route at Z = 384 (MS x20 cn=3,
    ``bg1_ms20_z384_post.npz``) at batch 32,768 and 2.5 dB, all-zero words
    and random codewords of the QC generator, with the K3 counter at 0
    before and read after, and the decode's peak device memory; decoded BER
    below channel BER.  Times K3 there against its bound, its design's own
    traffic and its plain version over the whole batch (held against it,
    stats over 4,096 words exact), and prints which K3 ran, its cluster
    size, shared memory a CTA, registers, local bytes and the card's
    cudaOccupancyMaxActiveClusters.
17. Path (b): early-exit counters equal to the full unroll's at 8,192 x 4
    words; the campaign's own phase-1 and escalation decoders (K3 stats)
    held exactly against their plain versions at the shapes it launches, as
    in step 5; then ``MonteCarloCampaign.run_snr_point`` with the Z = 256-trained
    weights at Z = 384 (MS x10), 2.5 dB, batch 32,768, early exit after 5
    behind the auto-guard, the channel read from ``AWGNChannel`` (in-kernel
    sampling "auto" falls back), 2 batches off the clock and 4 timed.
18. Path (c), the cross-lift workflow: MS x10 at Z = 256 through ``Trainer``
    (fused engine, all-zero words at 3.0 / 3.5 dB, batch 64, lr 2e-3) for
    3 epochs of 10 steps, K3 and K4 once per step (the cluster K4: one CUDA
    launch a call), the resume from epoch 2 bitwise, then the trained
    params served at Z = 384 (decoded BER below channel BER).  Times K3's
    training forward, K4 and the fused step at batch 64 and 2,048, holds K4
    against its twin (channel gradients bit for bit) and the device-memory
    plain version over each batch, and prints the cluster K4's size, shared
    memory, registers, cudaOccupancyMaxActiveClusters and word 0's phase
    cycles (``k4_phases``) at 2,048, with K4's time there on the larger
    clusters the size rule passes over.
19. Holds the matmul-routed kernels against their plain versions: the
    legacy engine K5 (``fused_fwd.cu`` with the legacy routings' hooks) on
    the cases of step 3 in bf16 and f32 routing and int8 for QMS, MS and QMS
    bit for bit, SP within 5e-3; K6 (``fused_fwd.cu`` and
    ``fused_bwd.cu`` with matmul routing) in every forward mode, its final
    APP against K1a (int8 QMS bit for bit, split-3 within SPLIT3_VS_ROLL),
    its backward against its plain version and, in int8 routing with f32
    cotangents, against K2 at K2's bars, also on the saturating BG2 QMS x3
    case at sigma 0.35; K7 (``csrc/sol_probe.cu``) on 1,024 rows, exactly.
20. Path (d), the legacy engine: FusedMinsumDecoder(engine="legacy") on
    wman MS x5 (bf16 and f32 routing) and BG2 QMS x20 (trained, int8) at
    batch 1,048,576, counters at 0 before and read after each decode (K5
    launched, K1a not), decoded BER below channel BER; K5 timed per call
    against its bound and K1a on the same inputs.
21. Path (e), matmul routing on the shipped codes:
    FusedTrainDecoder.from_decoder(routing="matmul") for the bg2_qms_train
    decoder (int8, bf16 and f32 cotangents) and wman MS x5 (split-3): the
    final-APP decode at 1,048,576 words, the whole loss's gradients through
    FusedTrainFn against the plain engine at 4,096 words (bf16 cotangents
    within BF16_COTANGENT_GAP), and the training forward and backward at
    16,384, each timed against K1a, K1d and K2 on the same inputs.
22. Path (f), auto routing beyond 1024 edges: the E = 1100 protograph
    (``codes.protograph.dense_protograph``, the recipe of
    scripts/bg1_e2e_routing_r4.py's synth_dense, seed 3) at Z = 16, MS x10,
    at 7 dB through the normal entry points with routing="auto": a decode
    at 262,144 words, the fused campaign (stats, in-kernel sampling, early
    exit) at 262,144 x 4 timed batches after its phase-1 and escalation
    decoders are held against their plain versions at their shapes, one
    training batch of 256 through K6's training forward and backward
    against their plain versions at K2's bars (the backward timed per call
    against its bound), and Trainer for 3 epochs of 10 steps at batch 256
    with the resume from epoch 2 bitwise; K6 must have launched on each.
    The decode and the campaign's phase-1 and escalation decoders are timed
    against path (e)'s bound.
23. Path (g): measure_sol (K7) at its TPU shape [65,536, 512], the counted
    instruction rate (5 a step, as the TPU script counts) beside the data
    sheet's 33.5e12; the bound from the instructions issued per step, read
    from K7's SASS.
24. Path (h), checks above 32 edges (the kernels' kAnyDegree
    instantiations): ``codes.protograph.synth_dense(3, M, N, target_e)``
    with checks of 41 and 73 edges at Z = 16, MS x10 (CN, UCN, VN weights),
    QMS x10 and SP x5, at 2,048 words at 3 dB, through the entry points
    with every counter at 0 before and read after: the decode (K1a), one
    fused train step (K1d + K2), the whole loss through matmul routing (K6's
    forward and backward), the legacy engine (K5), the fused campaign of MS
    x10 with the channel sampled in the kernel (K1c) and read (K1b); the
    degree-41 code at Z = 96 (the two-pass K3, the device-memory K4) through
    a decode and the whole loss.  Then each kernel is held against its plain
    version at the path's shapes, the campaigns' counters against the full
    unroll and their own decoders exactly; fails if a kernel of the path
    never launched.  K2's block (words and threads a block, blocks an SM)
    is printed on every path that runs it (steps 11, 13, 21, 22 and this
    one).
25. Path (i), Kwak's boosted error-floor pipeline on the
    ``boosted_error_floor`` preset's decoder (BG2 QMS, cn / ucn / vn ITER,
    base 20 + post 5 iterations, post UCN NODE_ITER, all-zero words at
    3.5 / 4.0 / 4.5 dB, fused engine; each stage cut to 2 epochs of 400
    words), every counter at 0 before each step and read after:
    ``BoostedPipeline.run`` from init (K1d and K2 once a step of either
    stage, K1a in the harvest); the harvest alone at 65,536 words a batch
    for 2,048 words at 3.5 dB, every harvested word a failure of the base's
    plain decode on the card, harvested and decoded words/s; ``run`` from
    the stage-1 params (stage 2 alone, equal to the whole run bit for bit);
    after each run the frozen rows equal the transferred ones bit for bit,
    the post CN / VN rows exactly 1.0, the post UCN rows moved; one stage-2
    step on each engine; the train step of each stage and K1d / K2 of the
    extended decoder at batch 20, timed against their bounds and plain
    versions; ``TwoStageDecoder`` over the two stages' FusedMinsumDecoders
    at 1,048,576 words (``decode_sparse`` equal to ``__call__`` on every
    row, the stats equal to the plain decoders' over 65,536 words, words/s
    of the base decode, ``__call__`` and ``decode_sparse``); the train CLI
    in mode "boosted" (one epoch a stage), which must write
    ``boosted_final``.
26. Path (j): ``GreedyLayerTrainer`` on the ``wman_neural_train`` preset
    (wman, Dai's 20-layer neural min-sum decoder, batch 50, its SNR
    curriculum) for 2 epochs, losses finite, then one step on each layer,
    each moving its own rows alone, the step timed; the train CLI in mode
    "greedy" for one epoch; ``cli/profile.py --preset bg2_qms_train --reps
    5`` with a trace directory (three rows, K1a launched, three trace
    files); ``cli/evaluate.py --import-reference`` on a txt export this
    script writes (params equal to the exported ones, the fused campaign
    launched).
27. Prints the kernel table as one JSON line and, last, the
    ``{"ok": true, "device": {...}}`` line.  Each row's ``launches`` are the
    wrapper calls on its path and ``cuda_launches`` the CUDA kernels those
    calls launched, as the C entry points counted them (K3, K6: by path;
    K3's also which kernel ran); K4 has a row per kernel, the cluster one on
    path (c), the device-memory one on its forced case; K1a, K1d and K2
    carry path (i)'s calls as ``launches_i``, K1a the profile CLI's as
    ``launches_j``.

Any failed build, launch or comparison exits nonzero.  Without CUDA, or
without the package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
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
def load_code(name):
    """A registered code, the BG1-like base graph at the lift its name ends
    in (``nr_bg1_like_z<Z>``), or path (f)'s E = 1100 protograph at Z = 16."""
    from neural_ldpc_tpu_torch.codes import get_code
    from neural_ldpc_tpu_torch.codes.protograph import dense_protograph, nr_bg1_like

    if name == DENSE_CODE:
        return dense_protograph(DENSE_Z)
    lift = name[len("nr_bg1_like_z"):]
    return nr_bg1_like(int(lift)) if name.startswith("nr_bg1_like_z") and lift.isdigit() \
        else get_code(name)


def make_decoder(code_name, decoder_type, sharing, n_iterations, weights, device, seed=0):
    """(code, decoder, params): trained weights from ``trained/<weights>``, or
    random weights around 1 made from ``seed``."""
    import numpy as np

    from neural_ldpc_tpu_torch.codes import TannerGraph
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, load_params_npz, params_from_numpy)
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig

    code = load_code(code_name)
    graph = TannerGraph.from_basegraph(code.basegraph, code.Z)
    dec = BoostedNeuralDecoder(graph, BoostedDecoderConfig(
        n_iterations=n_iterations, decoder_type=DecoderType[decoder_type], qms_qbit=5,
        sharing=NodeWeightSharingConfig(**sharing)), device=device)
    if weights:
        # the first n_iterations rows: the cross-lift weights serve shorter unrolls too
        params = {k: v[:n_iterations] for k, v in load_params_npz(
            os.path.join(HERE, "trained", weights), device).items()}
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


def check_campaigns(device, batch, n_batches=4, cases=None, samplings=("on", "off")):
    """Early-exit counters equal the full unroll's on the card, for each
    sampling setting, and with capacity 1 (every window redone).  ``cases``
    are (SAMPLER_CASES entry, early-exit iterations) pairs."""
    from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign

    for (name, code_name, dt, sharing, iters, weights, snr), i1 in (
            cases or zip(SAMPLER_CASES, (2, 5))):
        code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        channel = campaign_channel(code, snr, dt, device)
        for sampling in samplings:
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
                print(f"[campaign-check] {name} sampling {sampling} (in the kernel: "
                      f"{camp.kernel_sampling}), {label}: {r['words']} words "
                      f"at {snr} dB, BER {r['ber'][0]:.6g}, FER {r['fer'][0]:.6g}, "
                      f"escalations {int(camp.escalations[0])}", flush=True)
            if not (runs[0] == runs[1] == runs[2]) or runs[0]["words"] != n_batches * batch:
                fail(f"{name}: early-exit counters differ from the full unroll "
                     f"(sampling {sampling})")


def compare(name, decoder_type, batch, out, ref, exact=False):
    """max |out - ref| of two clipped APPs; fails beyond the tolerance of
    ``decoder_type`` (with ``exact``, unless they are equal bit for bit) or
    on any differing hard decision."""
    import torch

    diff = (out - ref).abs().max().item()
    same = torch.equal(out < 0, ref < 0)
    bar = "bit for bit" if exact else f"tolerance {TOLERANCE[decoder_type]:g}"
    print(f"[check] {name}: batch {batch}, max |kernel - plain| = {diff:.3g} "
          f"({bar}), decisions equal: {same}", flush=True)
    ok = torch.equal(out, ref) if exact else diff <= TOLERANCE[decoder_type]
    if not ok or not same:
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


def k1_report(device) -> dict:
    """The forward kernel's block on the main path's codes: words and threads
    a block, shared memory, and the card's answer (blocks an SM, words an
    SM, registers and local bytes a thread of the instantiation it runs)."""
    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, k1_occupancy

    out = {}
    for name, code_name, dt, sharing, iters, weights, _, _ in MAIN_CASES[:2]:
        _, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        out[name] = k1_occupancy(FusedMinsumDecoder.from_decoder(dec, params).layout, device)
        r = out[name]
        print(f"[k1] {name}: {r['words_per_block']} words a block of {r['threads']} threads, "
              f"{r['smem_bytes']:,} B of shared memory; {r['blocks_per_sm']} blocks "
              f"({r['words_per_sm']} words) an SM (built for {r['blocks_target']}); "
              f"{r['registers']} registers, {r['local_bytes']} B local a thread", flush=True)
        if r["blocks_per_sm"] < 1:
            fail(f"{name}: the card cannot place a block of the forward kernel")
    return out


def main_path(device, batch):
    """Channel -> decode -> metrics at full width through the user entry
    points, one decode per case; returns {case: (result, decoder, llr)}, the
    K1a calls of this run and the CUDA launches they made."""
    import torch

    from neural_ldpc_tpu_torch.eval import count_errors
    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder

    def ber_fer(counts):
        return (counts.bit_errors[0].item() / counts.total_bits.item(),
                counts.frame_errors[0].item() / counts.total_frames.item())

    results = {}
    read = _zero_counters()
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
    launches, cuda = read()["fused_fwd_k1a"], read(cuda=True)["fused_fwd_k1a"]
    print(f"[main] fused_fwd_k1a launches in the main path: {launches} for "
          f"{len(MAIN_CASES)} decodes ({cuda} CUDA launches)", flush=True)
    if launches == 0:
        fail("the main path never launched fused_fwd_k1a")
    return results, launches, cuda


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


def make_campaign(case, device, capacity_div=32, probe_batches=4):
    """The MonteCarloCampaign of one CAMPAIGN_CASES entry, built through the
    user entry points, with ``batch // capacity_div`` escalation slots."""
    from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign

    name, code_name, dt, sharing, iters, weights, snr, batch, i1, _, _, sampling = case
    code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
    camp = MonteCarloCampaign(dec, params, campaign_channel(code, snr, dt, device), CampaignConfig(
        batch_size=batch, min_frame_errors=0, max_words_per_snr=10**15, engine="fused",
        sync_every_batches=32, seed=1, early_exit_iters=i1,
        early_exit_capacity=batch // capacity_div, early_exit_probe_batches=probe_batches,
        kernel_channel_sampling=sampling))
    # a code the on-chip kernel cannot hold reads its channel under "auto"
    sampled = sampling != "off" and not camp.decoders["full"].layout.hbm_store
    if not camp.fused or camp.kernel_sampling != sampled:
        fail(f"{name}: the campaign did not choose the fused engine with in-kernel sampling "
             f"{sampling}")
    return code, camp


def campaign_path(device, cases=CAMPAIGN_CASES):
    """The campaign at full width through ``MonteCarloCampaign.run_snr_point``,
    one run per case, with every kernel's launch counter set to 0 just before
    the run and read just after; returns ({case: result}, {case: {kernel:
    launches}})."""
    results, launches = {}, {}
    for case in cases:
        name, snr, batch, i1, warm, timed = case[0], case[6], case[7], case[8], case[9], case[10]
        code, camp = make_campaign(case, device)
        read = _zero_counters()
        t0 = time.perf_counter()
        camp.run_snr_point(0, batches=warm)  # auto-guard probe and warm-up, off the clock
        t_warm = time.perf_counter() - t0
        w0, e0 = int(camp.words[0]), int(camp.escalations[0])
        t0 = time.perf_counter()
        camp.run_snr_point(0, batches=timed)  # ends on the counter read
        dt_s = time.perf_counter() - t0
        launches[name] = read()
        cuda = read(cuda=True)
        r = camp.results()[snr]
        res = dict(batch=batch, snr_db=snr, early_exit_iters=i1, capacity=batch // 32,
                   kernel_sampling=camp.kernel_sampling, timed_batches=timed, timed_s=dt_s,
                   words_per_s=(int(camp.words[0]) - w0) / dt_s,
                   guard_keeps_early_exit=bool(camp._ee_choice.get(0)),
                   escalations_timed=int(camp.escalations[0]) - e0,
                   escalations_total=int(camp.escalations[0]), words=r["words"],
                   ber=r["ber"][0], fer=r["fer"][0], warmup_and_probe_s=t_warm,
                   launches=launches[name], cuda_launches=cuda)
        print(f"[campaign] {name}: batch {batch} at {snr} dB, channel sampled "
              f"{'in the kernel' if camp.kernel_sampling else 'by AWGNChannel'}, {timed} timed "
              f"batches in {dt_s:.3f} s = {res['words_per_s']:,.0f} words/s end to end; "
              f"auto-guard keeps early exit: {res['guard_keeps_early_exit']}; escalations "
              f"{res['escalations_timed']} in the timed batches ({res['escalations_total']} in "
              f"all); {r['words']} words, decoded BER {r['ber'][0]:.4g}, FER {r['fer'][0]:.4g} "
              f"(probe and warm-up {t_warm:.2f} s); launches {launches[name]}, CUDA launches "
              f"{cuda}", flush=True)
        if not r["words"] or not math.isfinite(r["ber"][0]):
            fail(f"{name}: the campaign counted nothing")
        kernel = ("fused_fwd_k3" if camp.decoders["full"].layout.hbm_store
                  else "fused_fwd_k1c" if camp.kernel_sampling else "fused_fwd_k1b")
        if launches[name][kernel] == 0:
            fail(f"{name}: the campaign never launched {kernel}")
        if kernel == "fused_fwd_k3":
            res["k3_kernel"] = sorted({d.layout.k3_kernel for d in camp.decoders.values()})
            res["k4_kernel"] = sorted({d.layout.k4_kernel for d in camp.decoders.values()})
        results[name] = res
        del camp
    return results, launches


def check_campaign_shapes(device, cases=CAMPAIGN_CASES, reps=3):
    """``check_campaign_decoders`` on each case's campaign.  Returns {case:
    result}."""
    out = {}
    for case in cases:
        code, camp = make_campaign(case, device)
        out[case[0]] = check_campaign_decoders(case[0], code, camp, case[6], device, reps)
        del camp
    return out


def check_campaign_decoders(name, code, camp, snr, device, reps, chunk=None):
    """A campaign's own phase-1 and escalation decoders at the shapes its
    run launches: phase 1 over the whole batch at I1 iterations, the
    escalation at its K slots of scattered words (index mode when the
    kernel samples), each held exactly against its plain version (in chunks
    of ``chunk`` words, by default PLAIN_CHUNK, BIG_PLAIN_CHUNK on a
    device-memory code), and timed.  Returns {decoder: result}."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import fused_fwd_plain, sample_channel_plain, stats_plain

    batch = camp.cfg.batch_size
    p1, esc = camp.decoders["phase1"], camp.decoders["escalation"]
    sigma, seed = float(camp.channel.sigma[0]), 97531
    idx = torch.randperm(batch, generator=torch.Generator().manual_seed(2))[:camp._ee_cap]
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
        # the roll kernels' bound (K6's is the routed one of its path)
        b_ms, b_by = (bound_ms(lay, n, "k1c" if camp.kernel_sampling else "k1b")
                      if lay.routing == "roll" else (None, None))
        step = chunk or (BIG_PLAIN_CHUNK if lay.hbm_store else PLAIN_CHUNK)
        if lay.hbm_store:  # K3's own plain version
            ref = torch.cat([k3_plain(plain_chan(s, min(s + step, n)), lay, dec._w, "stats")
                             for s in range(0, n, step)])
        else:
            ref = torch.cat([stats_plain(fused_fwd_plain(plain_chan(s, min(s + step, n)),
                                                         lay, *dec._w), lay)
                             for s in range(0, n, step)])
        diff = (got - ref).abs().max().item()
        res[label] = dict(words=n, iterations=lay.n_iterations, ms=ms, max_abs_diff=diff,
                          failures=int((got[:, 0] == 0).sum()), bound_ms=b_ms, bound_by=b_by)
        mode = ("read channel" if not camp.kernel_sampling
                else "index mode" if label == "escalation" else "tile mode")
        bound = f", bound {b_ms:.3f} ms ({b_by})" if b_ms is not None else ""
        print(f"[campaign-shape] {name} {label}: {n:,} words at {lay.n_iterations} "
              f"iterations ({mode}), {ms:.3f} ms per launch{bound}; max |kernel - plain| = "
              f"{diff}; words failing the syndrome {res[label]['failures']:,}", flush=True)
        if diff != 0:
            fail(f"{name} {label}: the kernel disagrees with its plain version at the "
                 "campaign's shape")
        del got, ref
    del runs
    return res


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
    """(least time in ms, "bytes" or "operations") of one training forward
    with its store ("k1d": I slots; "k3": I - 1) or one backward ("k2",
    "k4") over ``batch`` words: each input read once, each output written
    once, weights and tables included."""
    nz, ez, I = lay.N * lay.Z, lay.E * lay.Z, lay.n_iterations
    slots = I if mode in ("k1d", "k2") else I - 1
    qms = lay.qms_qbit is not None
    weights = 4 * I * (lay.E * (int(lay.has_cn_w or lay.has_ucn) + int(lay.has_ucn))
                       + lay.N * int(lay.has_vn_w))
    if mode in ("k1d", "k3"):  # channel in; every iteration's APP and stored messages out
        per_word, ops = (nz + I * nz + slots * ez) * 4, ops_per_word(lay)
        out_w = 0
    else:  # channel, store, g_outs (outs with UCN) in; g_chan (g_chanq) out
        per_word = (nz + slots * ez + I * nz * (1 + int(lay.has_ucn)) + nz * (1 + int(qms))) * 4
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


def k2_report(lay, device, batch, where):
    """The backward kernel's block at ``batch`` words of ``lay`` (K2, or K6's
    backward): words and threads a block, shared memory, the card's blocks
    an SM (``k2_occupancy``); printed and returned."""
    from neural_ldpc_tpu_torch.ops.cuda import k2_occupancy

    occ = k2_occupancy(lay, device, batch)
    print(f"[k2-block] {where}: batch {batch}: {occ['words_per_block']} words and "
          f"{occ['threads']} threads a block ({occ['smem_bytes']:,} B of shared memory, W_max "
          f"{occ['W_max']}), {occ['blocks_per_sm']} blocks an SM, {occ['registers']} registers, "
          f"{occ['local_bytes']} B local", flush=True)
    if occ["blocks_per_sm"] < 1:
        fail(f"{where}: the card cannot place the backward kernel's block")
    return occ


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
    """Sets every wrapper's counters to 0; returns the function that reads
    them all: the calls that launched, or with ``cuda=True`` the CUDA
    kernels those calls launched, as the C entry points counted them."""
    from neural_ldpc_tpu_torch.ops.cuda import WRAPPERS

    for k in WRAPPERS:
        k.launches = k.cuda_launches = 0
    return lambda cuda=False: {k.__name__: k.cuda_launches if cuda else k.launches
                               for k in WRAPPERS}


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
        out["launches"], out["cuda_launches"] = read(), read(cuda=True)
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
        from neural_ldpc_tpu_torch.ops.cuda import FusedTrainDecoder

        out["k2_block"] = k2_report(FusedTrainDecoder.from_decoder(dec).layout, device,
                                    tcfg.batch_size, "K2, the training path")

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
                               block=k2_report(lay, device, batch, "K2, bg2_qms_train"))
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
        if mode == "k2":
            r["block"] = k2_report(lay, device, b, "K2, bg2_qms_train")
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


# ---------------------------------------------------------------------------
# Big codes: K3 and K4
# ---------------------------------------------------------------------------
TPU_K3 = "neural_ldpc_tpu/ops/pallas/fused_train.py:1154"  # _fwd_kernel_hbm
TPU_K4 = "neural_ldpc_tpu/ops/pallas/fused_train.py:1634"  # _bwd_kernel_hbm
K3_SOURCE = "neural_ldpc_tpu_torch/csrc/fused_fwd_cl.cu"  # the cluster kernel
K3_TWO_PASS_SOURCE = "neural_ldpc_tpu_torch/csrc/fused_fwd_dm.cu"  # a word no cluster holds
K4_SOURCE = "neural_ldpc_tpu_torch/csrc/fused_bwd_cl.cu"  # the cluster kernel
K4_DM_SOURCE = "neural_ldpc_tpu_torch/csrc/fused_bwd_dm.cu"  # a backward no cluster holds
BG1_384 = "nr_bg1_like_z384"  # 17,664 lifted checks, 694 KB of forward state per word
BG1_256 = "nr_bg1_like_z256"
BIG_BATCH = 32768  # the decode and campaign batch at Z = 384
BIG_CHECK_BATCH = 2048
BIG_PLAIN_CHUNK = 2048
BIG_REPS = 2  # timed K3 decodes (~2 s each)
BIG_SNR = 2.5
# the decoders of the three paths: (code, type, sharing, iterations, weights)
DECODE_A = (BG1_384, "MS", dict(cn=3), 20, "bg1_ms20_z384_post.npz")
CROSS_LIFT = dict(decoder_type="MS", sharing=dict(cn=3), n_iterations=10,
                  weights="bg1_ms10_z256_hi.npz")  # trained at Z = 256, served at 384
TRAIN_SNRS = (3.0, 3.5)  # scripts/bg1_train_r5.py's "hi" mix
# (name, code, type, sharing, iterations, weights, snr_db) of the K3 checks
BIG_CHECKS = [
    ("a_bg1z384_ms20", *DECODE_A, BIG_SNR),
    ("c_bg1z256_ms10", BG1_256, "MS", dict(cn=3), 10, CROSS_LIFT["weights"], 3.0),
    ("bg1z384_qms10_ucn", BG1_384, "QMS", dict(cn=3, ucn=2, vn=3), 10, None, 2.0),
    ("bg1z256_sp5", BG1_256, "SP", dict(cn=1, vn=2), 5, None, 2.5),
]
# (b): the cross-lift decoder at Z = 384, the channel read from AWGNChannel
# (the on-chip kernel's sampler does not serve this code), early exit after 5
BIG_CAMPAIGN = ("b_bg1z384_ms10", BG1_384, "MS", dict(cn=3), 10, CROSS_LIFT["weights"], BIG_SNR,
                BIG_BATCH, 5, 2, 4, "auto")


# the two-pass K3 on a forced case: the BG1-like code at a lift whose word
# state (1.85 MB) no cluster of 8 CTAs holds
TWO_PASS_Z = 1024
TWO_PASS_BATCH = 64
# the device-memory K4 on a forced case: the cross-lift decoder trained at
# Z = 384, whose backward no cluster of 8 CTAs holds
K4_DM_Z = 384
K4_DM_BATCH = 16


def k3_design_bytes(lay, mode="app") -> int:
    """Device-memory bytes one word's K3 moves as designed.  The cluster
    kernel (csrc/fused_fwd_cl.cu) reads the channel I + 1 times (once to
    fill the replicas, once an iteration in the VN phase; after the first
    read from L2) and the split's table once a CTA, and writes its outputs
    once: the APP, 12 bytes of stats, or every iteration's APP and I - 1
    store slots ("stream"); its state never leaves the chip.  The two-pass kernel (csrc/fused_fwd_dm.cu)
    also moves its state: per iteration the check pass reads the entering
    messages and writes the new ones and reads the channel and the sums at
    every edge copy, the VN pass reads the messages again and writes the
    sums."""
    nz, ez, I = lay.N * lay.Z, lay.E * lay.Z, lay.n_iterations
    out = {"app": nz * 4, "stats": 12, "syndrome": nz * 4 + 12,
           "stream": (I * nz + (I - 1) * ez) * 4}[mode]
    if lay.cluster is None:
        return (5 * ez + nz) * 4 * I + out
    return (I + 1) * nz * 4 + lay.cluster.C * lay.cluster.TAB * 4 + out


def k3_plain(chan, lay, w, mode="app", store=True):
    """The plain version of the K3 that runs ``lay`` (``lay.k3_kernel``), in
    ``fused_fwd_k3``'s return form: the APP, the stats, (APP, stats) or
    (outs, store)."""
    from neural_ldpc_tpu_torch.ops.cuda import fused_fwd_cl_plain, fused_fwd_dm_plain, stats_plain

    if lay.cluster is not None:
        out, st, stats = fused_fwd_cl_plain(chan, lay, *w, mode=mode, store=store)
    else:
        out, st = fused_fwd_dm_plain(chan, lay, *w, stream=mode == "stream",
                                     store=store and mode == "stream")
        stats = stats_plain(out, lay) if mode in ("stats", "syndrome") else None
    return {"app": out, "stats": stats, "syndrome": (out, stats), "stream": (out, st)}[mode]


def k3_cluster_report(lay, device) -> dict:
    """Which K3 runs ``lay`` and, for the cluster kernel, its cluster size,
    dynamic shared memory a CTA, threads, registers and local (spill) bytes
    a thread, and the card's cudaOccupancyMaxActiveClusters."""
    from neural_ldpc_tpu_torch.ops.cuda import cluster_occupancy

    if lay.cluster is None:
        return dict(kernel=lay.k3_kernel)
    return dict(kernel=lay.k3_kernel, **cluster_occupancy(lay, device))


def k3_phases(lay, chan, w) -> dict:
    """The cluster K3's time by phase for word 0 of one final-APP launch,
    from the clock64 stamps its ranks write (``prof`` of
    csrc/fused_fwd_cl.cu): setup (table, replicas, first cluster sync), the
    check phases and the VN phases, each ending at its cluster sync, in SM
    cycles summed over the iterations (the slowest rank's), the check
    phases' share of the launch, and each rank's own work in each phase
    before it waits at the sync."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import fused_train as ft

    I, C = lay.n_iterations, lay.cluster.C
    prof = torch.zeros(C, 4 * I + 2, dtype=torch.int64, device=chan.device)
    ft._k3_cluster_launch(chan, lay, w, ft._mode_flags(lay), torch.empty_like(chan), None, None,
                          prof)
    torch.cuda.synchronize()
    t = prof.cpu()
    d = t[:, 1:] - t[:, :-1]  # setup, then per iteration: check work, wait, VN work, wait
    res = dict(setup_cycles=int(d[:, 0].max()), check_cycles=int((d[:, 1::4] + d[:, 2::4]).sum(1).max()),
               vn_cycles=int((d[:, 3::4] + d[:, 4::4]).sum(1).max()),
               word_cycles=int((t[:, -1] - t[:, 0]).max()),
               check_work_by_rank=d[:, 1::4].sum(1).tolist(),
               vn_work_by_rank=d[:, 3::4].sum(1).tolist())
    res["check_share"] = res["check_cycles"] / max(res["word_cycles"], 1)
    return res


def k4_vs_twin(got, twin):
    """The cluster K4 against its twin: (channel gradients equal, max
    relative diff of the weight gradients), or None beyond the bars
    (channel gradients bit for bit, weights 1e-4 of max |g|)."""
    import torch

    wrel = 0.0
    for i, (a, b) in enumerate(zip(got, twin)):
        if (a is None) != (b is None):
            return None
        if a is None:
            continue
        if i >= 3:
            if not torch.equal(a, b):
                return None
        else:
            wrel = max(wrel, (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30))
    return (True, wrel) if wrel <= 1e-4 else None


def k4_cluster_report(lay, device) -> dict:
    """Which K4 runs ``lay`` and, for the cluster kernel, its cluster size,
    dynamic shared memory a CTA, threads, registers and local (spill) bytes
    a thread, and the card's cudaOccupancyMaxActiveClusters."""
    from neural_ldpc_tpu_torch.ops.cuda import bwd_cluster_occupancy

    if lay.bwd_cluster is None:
        return dict(kernel=lay.k4_kernel)
    return dict(kernel=lay.k4_kernel, **bwd_cluster_occupancy(lay, device))


def k4_phases(lay, chan, w, st, outs, g) -> dict:
    """The cluster K4's time by phase for word 0 of one launch, from the
    clock64 stamps its ranks write (``prof`` of csrc/fused_bwd_cl.cu), in
    SM cycles summed over the iterations, per rank: setup (table, slot
    I-2, B0 of iteration I-1), phase A, the weight reduction, the slot load
    with its cluster sync, the VN phase (thread 0's work) and its cluster
    sync; and phase A's share of the word's cycles on the slowest rank."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import fused_train as ft

    I, C = lay.n_iterations, lay.bwd_cluster.C
    prof = torch.zeros(C, 5 * I + 2, dtype=torch.int64, device=chan.device)
    ft._k4_cluster_launch(chan, lay, w, st, outs, g, prof)
    torch.cuda.synchronize()
    t = prof.cpu()
    d = t[:, 1:] - t[:, :-1]
    res = dict(setup_cycles=d[:, 0].tolist(), word_cycles=int((t[:, -1] - t[:, 0]).max()))
    for j, name in enumerate(("a", "reduce", "load_sync", "vn", "vn_sync")):
        res[f"{name}_cycles_by_rank"] = d[:, 1 + j::5].sum(1).tolist()
    res["a_share"] = max(res["a_cycles_by_rank"]) / max(res["word_cycles"], 1)
    return res


def check_device_memory_k4(device, batch=K4_DM_BATCH, reps=3):
    """The device-memory K4 where no cluster holds a word's backward: the
    cross-lift decoder (MS x10 cn=3, the Z = 256 weights) trained at
    Z = K4_DM_Z, ``batch`` words at TRAIN_SNRS, with the counters at 0
    before K3's training forward and K4 and read after; K4 held against
    its plain version at K2's bars and timed against its bound.  Returns a
    result dict."""
    import torch

    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedTrainDecoder, fused_bwd_dm_plain, fused_bwd_k4, fused_fwd_k3)

    c = CROSS_LIFT
    code_name = f"nr_bg1_like_z{K4_DM_Z}"
    code, dec, params = make_decoder(code_name, c["decoder_type"], c["sharing"],
                                     c["n_iterations"], c["weights"], device)
    ft = FusedTrainDecoder.from_decoder(dec)
    lay, w = ft.layout, ft.pack_weights(*dec._expanded_weights(params))
    if lay.k4_kernel != "device-memory":
        fail(f"{code_name}: a cluster holds the backward; the device-memory K4 is not reached")
    channel = AWGNChannel(code, ChannelConfig(snr_db=TRAIN_SNRS), device=device)
    llr, _ = channel.sample_mixed(channel.generator(43), batch, all_zero=True)
    chan = llr.reshape(batch, -1)
    read = _zero_counters()
    outs, st = fused_fwd_k3(chan, lay, *w, mode="stream")
    g = torch.randn(outs.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(9))
    got = fused_bwd_k4(chan, lay, *w, st, outs, g)
    torch.cuda.synchronize()
    launches, cuda = read(), read(cuda=True)
    res = dict(code=code_name, batch=batch, kernel=lay.k4_kernel, k3_kernel=lay.k3_kernel,
               launches=launches["fused_bwd_k4"], cuda_launches=cuda["fused_bwd_k4"],
               diff=_grad_diffs(got, fused_bwd_dm_plain(chan, lay, *w, st, outs, g)))
    del got
    res["ms"] = cuda_ms(lambda: fused_bwd_k4(chan, lay, *w, st, outs, g), reps)
    res["plain_ms"] = cuda_ms(lambda: fused_bwd_dm_plain(chan, lay, *w, st, outs, g), 1)
    res["bound_ms"], res["bound_by"] = train_bound_ms(lay, batch, "k4")
    res["roofline_share"] = res["bound_ms"] / res["ms"]
    print(f"[big-check] device-memory K4 on a forced case, {code_name} MS x10 cn=3, batch {batch} "
          f"({lay.k4_kernel} K4, {lay.k3_kernel} K3): {res['launches']} call, {res['cuda_launches']} "
          f"CUDA launches; vs its plain version (channel max |diff|, weights max rel diff) "
          f"{res['diff']}; {res['ms']:.3f} ms per call, bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}), share {res['roofline_share']:.4f}; plain version "
          f"{res['plain_ms']:.1f} ms", flush=True)
    if res["diff"] is None or res["launches"] != 1 or not res["cuda_launches"]:
        fail("the device-memory K4 disagrees with its plain version or did not launch")
    return res


def check_two_pass(device, batch=TWO_PASS_BATCH):
    """The two-pass K3 where no cluster holds the word: the BG1-like code
    at Z = TWO_PASS_Z, MS x5 cn=3 with random weights, every mode held
    against its plain version (APP at TOLERANCE, stats and the stream and
    store exact).  Returns a result dict."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import FusedTrainDecoder, fused_fwd_k3

    code_name = f"nr_bg1_like_z{TWO_PASS_Z}"
    code, dec, params = make_decoder(code_name, "MS", dict(cn=3), 5, None, device)
    ft = FusedTrainDecoder.from_decoder(dec)
    lay, w = ft.layout, ft.pack_weights(*dec._expanded_weights(params))
    if lay.k3_kernel != "two-pass":
        fail(f"{code_name}: a cluster holds the word; the two-pass K3 is not reached")
    llr, _ = channel_llr(code, 2.0, batch, seed=29, device=device)
    chan = llr.reshape(batch, -1)
    before = fused_fwd_k3.cuda_launches
    app = fused_fwd_k3(chan, lay, *w)
    cuda_per_call = fused_fwd_k3.cuda_launches - before
    st = fused_fwd_k3(chan, lay, *w, mode="stats")
    app_s, st_s = fused_fwd_k3(chan, lay, *w, mode="syndrome")
    outs, store = fused_fwd_k3(chan, lay, *w, mode="stream")
    r_app, r_st = k3_plain(chan, lay, w, "syndrome")
    r_outs, r_store = k3_plain(chan, lay, w, "stream")
    torch.cuda.synchronize()
    d = max(compare(f"{code_name} two-pass K3", "MS", batch, app, r_app),
            (app_s - app).abs().max().item())
    exact = (torch.equal(st, r_st) and torch.equal(st_s, r_st) and torch.equal(outs, r_outs)
             and torch.equal(store, r_store))
    res = dict(code=code_name, batch=batch, kernel=lay.k3_kernel, max_abs_diff=d,
               stats_stream_store_equal=exact, cuda_launches_per_call=cuda_per_call,
               state_bytes_per_word=4 * (lay.E + 2 * lay.N) * lay.Z)
    print(f"[big-check] two-pass K3 on a forced case, {code_name} MS x5 ({res['state_bytes_per_word']:,} "
          f"B of state a word, more than 8 CTAs hold), batch {batch}: max |kernel - plain| = {d:.3g}; "
          f"stats, stream and store equal: {exact}; {cuda_per_call} CUDA launches per call",
          flush=True)
    if not exact or not d <= TOLERANCE["MS"]:
        fail("the two-pass K3 disagrees with its plain version")
    return res


def check_device_memory_kernels(device, batch, time_batch=TRAIN_BATCH, reps=3):
    """K3 forced (``store_space="hbm"``) against K1 on CHECK_CASES at
    ``batch`` and ``batch + 1`` words, bit for bit in every mode (final APP,
    stats, syndrome, stream, store = K1d's store[1:]); K4 against K2 and its
    plain version at K2's bars.  Then, at ``time_batch`` words, times each
    device-memory kernel against its on-chip counterpart on the same inputs
    (K3 final APP against K1a, K3 stream + store against K1d, K4 against
    K2).  Returns ({case: K3 equal}, {case: K4 diffs}, {case: {pair: ms}})."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, fused_bwd_cl_plain, fused_bwd_dm_plain, fused_bwd_k2, fused_bwd_k4,
        fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1d, fused_fwd_k3)

    k3_equal, k4_diffs, vs_on_chip = {}, {}, {}
    for name, code_name, dt, sharing, iters, weights, snr, _ in CHECK_CASES:
        code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        vmem = FusedMinsumDecoder.from_decoder(dec, params, store_space="vmem")
        hbm = FusedMinsumDecoder.from_decoder(dec, params, store_space="hbm")
        lv, lh, w = vmem.layout, hbm.layout, vmem._w
        if (not lh.hbm_store or lv.hbm_store or lh.k3_kernel != "cluster"
                or lh.k4_kernel != "cluster"):
            fail(f"{name}: store_space did not select the kernel family (the cluster K3 and K4)")
        same = True
        for b in (batch, batch + 1):
            llr, _ = channel_llr(code, snr, b, seed=17, device=device,
                                 qms_qbit=5 if dt == "QMS" else None)
            chan = llr.reshape(b, -1)
            st = fused_fwd_k3(chan, lh, *w, mode="stats")
            app_s, st_s = fused_fwd_k3(chan, lh, *w, mode="syndrome")
            outs, store = fused_fwd_k3(chan, lh, *w, mode="stream")
            outs1, store1 = fused_fwd_k1d(chan, lv, *w)
            same &= (torch.equal(hbm(chan), vmem(chan)) and torch.equal(app_s, outs1[-1])
                     and torch.equal(st, fused_fwd_k1b(chan, lv, *w)) and torch.equal(st_s, st)
                     and torch.equal(outs, outs1) and torch.equal(store, store1[1:]))
            if b == batch:
                g = torch.randn(outs.shape, device=device,
                                generator=torch.Generator(device=device).manual_seed(3))
                got = fused_bwd_k4(chan, lh, *w, store, outs, g)
                ref = fused_bwd_k2(chan, lv, *w, store1, outs1, g)
                vs_k2 = _grad_diffs(got, ref)
                # the channel gradients equal K2's bit for bit
                k4_same = all(a is None or torch.equal(a, b) for a, b in zip(got[3:], ref[3:]))
                vs_plain = _grad_diffs(got, fused_bwd_dm_plain(chan, lh, *w, store, outs, g))
                vs_twin = k4_vs_twin(got, fused_bwd_cl_plain(chan, lh, *w, store, outs, g))
                del got, g, ref
            del chan, outs, store, outs1, store1
        torch.cuda.synchronize()
        k3_equal[name] = bool(same)
        k4_diffs[name] = dict(vs_k2=vs_k2, vs_plain=vs_plain, vs_twin=vs_twin)
        print(f"[big-check] {name}: K3 (store_space='hbm', {lh.k3_kernel} kernel) = K1 bit for "
              f"bit in every mode at {batch} and {batch + 1} words: {bool(same)}; K4's channel "
              f"gradients = K2's bit for bit: {k4_same}; K4 ({lh.k4_kernel} kernel, a cluster of {lh.bwd_cluster.C}; channel "
              f"max |diff|, weights max rel diff) vs K2 {vs_k2}, vs the device-memory plain "
              f"version {vs_plain}, vs its twin (channel equal, weights) {vs_twin}", flush=True)
        if not same or not k4_same or vs_k2 is None or vs_plain is None or vs_twin is None:
            fail(f"{name}: a device-memory kernel disagrees with the on-chip one or its "
                 "plain version")

        llr, _ = channel_llr(code, snr, time_batch, seed=18, device=device,
                             qms_qbit=5 if dt == "QMS" else None)
        chan = llr.reshape(time_batch, -1)
        outs, store = fused_fwd_k3(chan, lh, *w, mode="stream")
        outs1, store1 = fused_fwd_k1d(chan, lv, *w)
        g = torch.randn(outs.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(4))
        t = {"k3_app": cuda_ms(lambda: fused_fwd_k3(chan, lh, *w), reps),
             "k1a": cuda_ms(lambda: fused_fwd_k1a(chan, lv, *w), reps),
             "k3_stream": cuda_ms(lambda: fused_fwd_k3(chan, lh, *w, mode="stream"), reps),
             "k1d": cuda_ms(lambda: fused_fwd_k1d(chan, lv, *w), reps),
             "k4": cuda_ms(lambda: fused_bwd_k4(chan, lh, *w, store, outs, g), reps),
             "k2": cuda_ms(lambda: fused_bwd_k2(chan, lv, *w, store1, outs1, g), reps)}
        t["ratios"] = {"k3/k1a": t["k3_app"] / t["k1a"], "k3/k1d": t["k3_stream"] / t["k1d"],
                       "k4/k2": t["k4"] / t["k2"]}
        vs_on_chip[name] = dict(batch=time_batch, **t)
        print(f"[big-time] {name}, batch {time_batch}: K3 final APP {t['k3_app']:.3f} ms vs K1a "
              f"{t['k1a']:.3f}; K3 stream + store {t['k3_stream']:.3f} vs K1d {t['k1d']:.3f}; K4 "
              f"{t['k4']:.3f} vs K2 {t['k2']:.3f}; ratios "
              f"{ {k: round(v, 3) for k, v in t['ratios'].items()} }", flush=True)
        del llr, chan, outs, store, outs1, store1, g
    return k3_equal, k4_diffs, vs_on_chip


def check_big_codes(device, batch):
    """K3 against its plain version on the BG1-like code at Z = 384 and 256
    (BIG_CHECKS) at ``batch`` words: APP at TOLERANCE with equal decisions,
    stats and syndrome exact; on the Z = 256 cases the training forward's
    stream and store too (512 words).  Returns {case: max |diff|}."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, fused_fwd_k3

    diffs = {}
    for name, code_name, dt, sharing, iters, weights, snr in BIG_CHECKS:
        code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        fused = FusedMinsumDecoder.from_decoder(dec, params)
        lay, w = fused.layout, fused._w
        if not lay.hbm_store or lay.k3_kernel != "cluster":
            fail(f"{name}: the big code did not select the cluster K3")
        llr, _ = channel_llr(code, snr, batch, seed=19, device=device,
                             qms_qbit=5 if dt == "QMS" else None)
        chan = llr.reshape(batch, -1)
        app = fused_fwd_k3(chan, lay, *w)
        st = fused_fwd_k3(chan, lay, *w, mode="stats")
        app_s, st_s = fused_fwd_k3(chan, lay, *w, mode="syndrome")
        ref, ref_st = k3_plain(chan, lay, w, "syndrome")
        torch.cuda.synchronize()
        stats_same = torch.equal(st, ref_st) and torch.equal(st_s, ref_st)
        d = compare(f"{name} K3", dt, batch, app.clamp(lay.clip_lo, lay.clip_hi),
                    ref.clamp(lay.clip_lo, lay.clip_hi))
        d = max(d, (app_s - app).abs().max().item())
        if code_name == BG1_256:
            n = 512
            outs, store = fused_fwd_k3(chan[:n], lay, *w, mode="stream")
            r_outs, r_store = k3_plain(chan[:n], lay, w, "stream")
            d = max(d, (outs - r_outs).abs().max().item(), (store - r_store).abs().max().item())
            del outs, store, r_outs, r_store
        diffs[name] = d
        print(f"[big-check] {name}: {code.N * code.Z:,}-bit words, K3 ({lay.k3_kernel}, cluster of "
              f"{lay.cluster.C}) max |kernel - plain| = "
              f"{d:.3g} (tolerance {TOLERANCE[dt]:g}; the stream and store too on Z = 256); "
              f"stats and syndrome = plain: {stats_same}; words with ok "
              f"{int(st[:, 0].sum())} of {batch}", flush=True)
        if not stats_same or not d <= TOLERANCE[dt]:
            fail(f"{name}: K3 disagrees with its plain version")
        del app, app_s, ref, chan, llr
    return diffs


def check_big_loss_gradients(device, batch=64):
    """The whole loss's gradients through ``FusedTrainFn`` (K3 forward, K4
    backward) against the plain engine's autograd on path (c)'s decoder at
    Z = 256, batch 64, at K2's bars; returns the diffs."""
    import torch

    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.ops.cuda import FusedTrainDecoder
    from neural_ldpc_tpu_torch.training import multi_iteration_loss

    c = CROSS_LIFT
    code, dec, params = make_decoder(BG1_256, c["decoder_type"], c["sharing"],
                                     c["n_iterations"], c["weights"], device)
    ft = FusedTrainDecoder.from_decoder(dec)
    if not ft.layout.hbm_store:
        fail("the Z = 256 training decoder did not select the device-memory kernels")
    channel = AWGNChannel(code, ChannelConfig(snr_db=TRAIN_SNRS), device=device)
    llr, bits = channel.sample_mixed(channel.generator(21), batch, all_zero=True)
    grads = []
    for engine in ("plain", "fused"):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        x = llr.clone().requires_grad_(True)
        o = dec.apply(p, x) if engine == "plain" else ft.apply(*dec._expanded_weights(p), x)
        loss = multi_iteration_loss(o, bits, coeff=list(range(c["n_iterations"])))
        grads.append((loss.item(), torch.autograd.grad(loss, [*p.values(), x])))
    (l0, g0), (l1, g1) = grads
    pad = [None] * (3 - len(params))
    step = _grad_diffs((*g1[:-1], *pad, g1[-1], None), (*g0[:-1], *pad, g0[-1], None))
    out = dict(step_vs_plain_engine=step, loss_diff=abs(l0 - l1), k3_kernel=ft.layout.k3_kernel,
               k4_kernel=ft.layout.k4_kernel)
    print(f"[big-check] c_bg1z256_ms10, batch {batch}: whole-loss gradients through K3 "
          f"({out['k3_kernel']}) and K4 ({out['k4_kernel']}) "
          f"vs the plain engine (channel max |diff|, weights max rel diff): {step}; loss diff "
          f"{abs(l0 - l1):.3g}", flush=True)
    if step is None or not abs(l0 - l1) <= 1e-6:
        fail("the big-code fused gradients disagree with the plain engine's")
    return out


def big_decode_path(device, batch):
    """Path (a): AWGNChannel -> BoostedNeuralDecoder ->
    FusedMinsumDecoder.from_decoder -> K3 final APP -> count_errors on the
    BG1-like code at Z = 384, MS x20 with its post-trained weights, at
    ``batch`` words and BIG_SNR, all-zero words and random codewords from
    the QC generator, with the K3 counter at 0 before and read after.
    Returns ({run: result}, calls, CUDA launches, (decoder, llr) of the
    all-zero run)."""
    import torch

    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.eval import count_errors
    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder

    code, dec, params = make_decoder(*DECODE_A, device)
    fused = FusedMinsumDecoder.from_decoder(dec, params)
    if not fused.layout.hbm_store or fused.layout.k3_kernel != "cluster":
        fail("path (a): the decoder did not select the cluster K3")
    gen_code = load_code("nr_bg1_like_z384_gen")  # the QC generator, expanded
    results, timed = {}, None
    read = _zero_counters()
    for all_zero in (True, False):
        ch = AWGNChannel(code if all_zero else gen_code, ChannelConfig(snr_db=(BIG_SNR,)),
                         device=device)
        llr, bits = ch.sample_at(ch.generator(25), batch, 0, all_zero=all_zero)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        out = fused(llr)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        if out.shape != (batch, code.n_bits) or not torch.isfinite(out).all():
            fail(f"path (a): output shape {tuple(out.shape)} or non-finite values")
        ch_c = count_errors(bits, llr.reshape(batch, -1))
        dc = count_errors(bits, out)
        res = dict(batch=batch, snr_db=BIG_SNR, all_zero=all_zero,
                   channel_ber=ch_c.bit_errors[0].item() / ch_c.total_bits.item(),
                   decoded_ber=dc.bit_errors[0].item() / dc.total_bits.item(),
                   decoded_fer=dc.frame_errors[0].item() / dc.total_frames.item(),
                   peak_memory_bytes=peak, decode_memory_bytes=peak - held,
                   k3_kernel=fused.layout.k3_kernel, k4_kernel=fused.layout.k4_kernel)
        label = "all_zero" if all_zero else "random_codewords"
        results[label] = res
        print(f"[big-main] (a) bg1z384 MS x20 post-trained, batch {batch}, {label} at {BIG_SNR} "
              f"dB: channel BER {res['channel_ber']:.4g} -> decoded BER {res['decoded_ber']:.4g}, "
              f"FER {res['decoded_fer']:.4g}; {res['k3_kernel']} K3; peak device memory "
              f"{peak / 2**30:.3f} GiB (max_memory_allocated), {(peak - held) / 2**30:.3f} GiB "
              f"above the inputs held", flush=True)
        if not res["decoded_ber"] < res["channel_ber"]:
            fail(f"path (a), {label}: decoded BER is not below channel BER")
        if all_zero:
            timed = (fused, llr)
        del ch, bits, out
    launches, cuda = read(), read(cuda=True)
    print(f"[big-main] (a) launches {launches}, CUDA launches {cuda}", flush=True)
    if launches["fused_fwd_k3"] == 0:
        fail("path (a) never launched fused_fwd_k3")
    return results, launches, cuda, timed


def time_big_decode(fused, llr, reps):
    """K3's decode time at path (a)'s shape against its bound and the plain
    version's time over the whole batch (in chunks), held against it over
    the whole batch and its stats over 4,096 words.  Returns a result
    dict."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import fused_fwd_k3

    batch = llr.shape[0]
    chan = llr.reshape(batch, -1)
    lay, w = fused.layout, fused._w
    res = dict(ms=cuda_ms(lambda: fused_fwd_k3(chan, lay, *w), reps),
               decode_ms=cuda_ms(lambda: fused(llr), reps))
    ref = torch.empty_like(chan)

    def run(n=batch):
        for s in range(0, n, BIG_PLAIN_CHUNK):
            ref[s:s + BIG_PLAIN_CHUNK] = k3_plain(chan[s:s + BIG_PLAIN_CHUNK], lay, w)

    res["plain_ms"] = cuda_ms(run, 1, warmup=lambda: run(BIG_PLAIN_CHUNK))
    res["full_batch_diff"] = compare("a_bg1z384_ms20 K3 full batch", "MS", batch,
                                     fused(llr), ref.clamp_(lay.clip_lo, lay.clip_hi))
    n = 4096
    st = fused_fwd_k3(chan[:n], lay, *w, mode="stats")
    res["stats_diff_4096"] = (st - k3_plain(chan[:n], lay, w, "stats")).abs().max().item()
    del ref
    res["bound_ms"], res["bound_by"] = bound_ms(lay, batch)
    res["ops_per_word"] = ops_per_word(lay)
    res["roofline_share"] = res["bound_ms"] / res["ms"]
    res.update(k3_cluster_report(lay, llr.device))
    res["phases"] = k3_phases(lay, chan, w)
    res["design_bytes_per_word"] = k3_design_bytes(lay)
    res["design_bytes_ms"] = k3_design_bytes(lay) * batch / H100_BYTES_PER_S * 1e3
    res["words_per_s"] = batch / res["decode_ms"] * 1e3
    print(f"[big-time] fused_fwd_k3 decode, bg1z384 MS x20, batch {batch}: {res['ms']:.3f} ms per "
          f"call, decode {res['decode_ms']:.3f} ms = "
          f"{res['words_per_s']:,.0f} words/s; bound {res['bound_ms']:.3f} ms ({res['bound_by']}, "
          f"{res['ops_per_word']:,} ops per word), share {res['roofline_share']:.4f}; {res['kernel']} "
          f"kernel: cluster of {res.get('C')} CTAs, {res.get('smem_bytes')} B of shared memory a CTA, "
          f"{res.get('threads')} threads, {res.get('registers')} registers, {res.get('local_bytes')} "
          f"B of local memory a thread, at most {res.get('clusters')} clusters at once "
          f"(cudaOccupancyMaxActiveClusters); word 0's phases in SM cycles {res['phases']}; "
          f"the design's "
          f"own traffic {res['design_bytes_per_word']:,} B per word = {res['design_bytes_ms']:.1f} "
          f"ms at 3.35 TB/s; plain version {res['plain_ms']:.1f} ms (chunks of {BIG_PLAIN_CHUNK}); "
          f"stats over {n} words max |diff| {res['stats_diff_4096']}", flush=True)
    if res["stats_diff_4096"] != 0:
        fail("K3's stats disagree with the plain version over the timed batch")
    return res


def big_training_path(device, steps_per_epoch=10, batch=64, validate=256, serve_batch=8192):
    """Path (c), the cross-lift workflow: MS x10 cn=3 on the BG1-like code at
    Z = 256, all-zero words at TRAIN_SNRS, batch 64, lr 2e-3, through
    ``Trainer`` with ``engine="fused"`` for 3 epochs of 640 words (30 steps),
    checkpointed every epoch; the resume from epoch 2 must give the same
    params bit for bit; then the trained params decode at Z = 384 through
    path (a)'s route.  Every counter is set to 0 before each run and read
    after.  Returns a result dict."""
    import torch

    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.eval import count_errors
    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, FusedTrainDecoder
    from neural_ldpc_tpu_torch.training import TrainConfig, Trainer
    from neural_ldpc_tpu_torch.training.lr_schedule import LearningRate

    c, epochs = CROSS_LIFT, 3
    steps = epochs * steps_per_epoch
    code, dec, _ = make_decoder(BG1_256, c["decoder_type"], c["sharing"], c["n_iterations"],
                                None, device)
    channel = AWGNChannel(code, ChannelConfig(snr_db=TRAIN_SNRS), device=device)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(total_epochs=epochs, batch_size=batch,
                           train_words_per_epoch=batch * steps_per_epoch, validate_words=validate,
                           engine="fused", is_y_all_zero=True,
                           learning_rate=LearningRate(2e-3, 0.0, 0), validate_epoch_step=1,
                           checkpoint_step=1, checkpoint_dir=tmp, export_weights_txt=False,
                           seed=2042, verbose=False)
        read = _zero_counters()
        t0 = time.perf_counter()
        params, _, _ = Trainer(dec, channel, tcfg).train()
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        out["launches"], out["cuda_launches"] = read(), read(cuda=True)
        out["epochs"] = []
        for e in range(epochs + 1):
            with open(os.path.join(tmp, f"checkpoint_epoch_{e:04d}.json")) as f:
                out["epochs"].append(dict(epoch=e, **{k: float(v) for k, v in
                                                      json.load(f)["metrics"].items()}))
        print(f"[big-train] (c) bg1z256 MS x10 cn=3, fused engine: {steps} steps of batch {batch} "
              f"and {epochs + 1} validations of {validate} words in {out['train_s']:.2f} s; "
              f"validation loss by epoch {[round(m['loss'], 6) for m in out['epochs']]}; "
              f"launches {out['launches']}, CUDA launches {out['cuda_launches']}", flush=True)
        if (out["launches"]["fused_fwd_k3"], out["launches"]["fused_bwd_k4"]) != (steps, steps):
            fail("path (c): K3 and K4 did not launch once per training step")
        if out["cuda_launches"]["fused_bwd_k4"] != steps:
            fail("path (c): the cluster K4 did not make one CUDA launch per call")
        if not all(math.isfinite(m["loss"]) for m in out["epochs"]):
            fail("path (c): a non-finite validation loss")
        read = _zero_counters()
        resumed, _, _ = Trainer(dec, channel, tcfg).resume("checkpoint_epoch_0002")
        torch.cuda.synchronize()
        out["resume_launches"] = read()
        out["resume_bitwise"] = all(torch.equal(params[k], resumed[k]) for k in params)
        print(f"[big-train] (c) resumed from the epoch-2 checkpoint: params equal to the "
              f"uninterrupted run bit for bit: {out['resume_bitwise']}; launches "
              f"{out['resume_launches']}", flush=True)
        if not out["resume_bitwise"]:
            fail("path (c): the resumed run differs from the uninterrupted one")
        if out["resume_launches"]["fused_bwd_k4"] != steps_per_epoch:
            fail("path (c): the resumed epoch did not launch K4 once per step")
    out["weight_cn"] = params["weight_cn"].flatten().tolist()
    lay = FusedTrainDecoder.from_decoder(dec).layout
    out["k3_kernel"], out["k4_kernel"] = lay.k3_kernel, lay.k4_kernel
    print(f"[big-train] (c) kernels: K3 {lay.k3_kernel}, K4 {lay.k4_kernel} (a cluster of "
          f"{lay.bwd_cluster.C if lay.bwd_cluster else '-'})", flush=True)

    # serve the Z = 256-trained params at the full lift through (a)'s route
    code384, dec384, _ = make_decoder(BG1_384, c["decoder_type"], c["sharing"],
                                      c["n_iterations"], None, device)
    ch = AWGNChannel(code384, ChannelConfig(snr_db=(BIG_SNR,)), device=device)
    llr, bits = ch.sample_at(ch.generator(31), serve_batch, 0)
    read = _zero_counters()
    served = {}
    for label, p in (("trained", params), ("untrained", dec384.init_params())):
        app = FusedMinsumDecoder.from_decoder(dec384, p)(llr)
        served[label] = count_errors(bits, app).bit_errors[0].item() / (serve_batch * code384.n_bits)
    torch.cuda.synchronize()
    out["serve_launches"], out["serve_cuda_launches"] = read(), read(cuda=True)
    chan_c = count_errors(bits, llr.reshape(serve_batch, -1))
    out["serve"] = dict(batch=serve_batch, snr_db=BIG_SNR,
                        channel_ber=chan_c.bit_errors[0].item() / chan_c.total_bits.item(),
                        decoded_ber=served["trained"], untrained_ber=served["untrained"])
    print(f"[big-train] (c) served at Z = 384, batch {serve_batch}, {BIG_SNR} dB: channel BER "
          f"{out['serve']['channel_ber']:.4g} -> decoded BER {served['trained']:.4g} (untrained "
          f"weights {served['untrained']:.4g}); launches {out['serve_launches']}, CUDA launches "
          f"{out['serve_cuda_launches']}", flush=True)
    if not served["trained"] < out["serve"]["channel_ber"]:
        fail("path (c): the served decode did not lower the BER")
    if not out["serve_launches"]["fused_fwd_k3"]:
        fail("path (c): the served decode never launched fused_fwd_k3")
    return out


def time_big_training(device, batches=(64, 2048), reps=REPS):
    """K3's training forward (stream + store) and K4 on path (c)'s decoder
    (Z = 256, MS x10, the cross-lift weights) at each batch: kernel time,
    bound, plain version's time, both held against the plain versions over
    the batch; and the whole fused train step (the plain engine's at the
    smaller batch).  Returns {batch: result}."""
    import torch

    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedTrainDecoder, bwd_cluster_occupancy, bwd_cluster_split, fused_bwd_cl_plain,
        fused_bwd_dm_plain, fused_bwd_k4, fused_fwd_k3)
    from neural_ldpc_tpu_torch.training import TrainConfig, make_train_step

    c = CROSS_LIFT
    code, dec, params = make_decoder(BG1_256, c["decoder_type"], c["sharing"],
                                     c["n_iterations"], c["weights"], device)
    ft = FusedTrainDecoder.from_decoder(dec)
    lay, w = ft.layout, ft.pack_weights(*dec._expanded_weights(params))
    channel = AWGNChannel(code, ChannelConfig(snr_db=TRAIN_SNRS), device=device)
    out = {}
    for b in batches:
        llr, bits = channel.sample_mixed(channel.generator(40 + b), b, all_zero=True)
        chan = llr.reshape(b, -1)
        res = {}
        k3 = dict(ms=cuda_ms(lambda: fused_fwd_k3(chan, lay, *w, mode="stream"), reps),
                  plain_ms=cuda_ms(lambda: k3_plain(chan, lay, w, "stream"), 1))
        outs, st = fused_fwd_k3(chan, lay, *w, mode="stream")
        r_outs, r_st = k3_plain(chan, lay, w, "stream")
        k3["full_batch_diff"] = max((outs - r_outs).abs().max().item(),
                                    (st - r_st).abs().max().item())
        del r_outs, r_st
        g = torch.randn(outs.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(5))
        if lay.k4_kernel != "cluster":
            fail("path (c)'s decoder did not select the cluster K4")
        before = fused_bwd_k4.cuda_launches
        got = fused_bwd_k4(chan, lay, *w, st, outs, g)
        k4 = dict(cuda_launches_per_call=fused_bwd_k4.cuda_launches - before,
                  full_batch_vs_twin=k4_vs_twin(got, fused_bwd_cl_plain(chan, lay, *w, st, outs, g)),
                  full_batch_diff=_grad_diffs(got, fused_bwd_dm_plain(chan, lay, *w, st, outs, g)))
        del got
        k4["ms"] = cuda_ms(lambda: fused_bwd_k4(chan, lay, *w, st, outs, g), reps)
        k4["plain_ms"] = cuda_ms(lambda: fused_bwd_cl_plain(chan, lay, *w, st, outs, g), 1)
        k4["dm_plain_ms"] = cuda_ms(lambda: fused_bwd_dm_plain(chan, lay, *w, st, outs, g), 1)
        k4.update(k4_cluster_report(lay, chan.device))
        if b == max(batches):
            k4["phases"] = k4_phases(lay, chan, w, st, outs, g)
            # the larger clusters the size rule passes over, forced: the
            # channel gradients must not change, the time may
            k4["forced_cluster_ms"] = {}
            for C in range(lay.bwd_cluster.C + 1, 9):
                forced = dataclasses.replace(lay, bwd_cluster=bwd_cluster_split(lay, C))
                got = fused_bwd_k4(chan, forced, *w, st, outs, g)
                if not torch.equal(got[3], fused_bwd_k4(chan, lay, *w, st, outs, g)[3]):
                    fail(f"the cluster K4 forced to {C} CTAs changed the channel gradients")
                k4["forced_cluster_ms"][C] = dict(
                    ms=cuda_ms(lambda: fused_bwd_k4(chan, forced, *w, st, outs, g), reps),
                    clusters=bwd_cluster_occupancy(forced, chan.device)["clusters"],
                    smem_bytes=forced.bwd_cluster.smem_bytes)
                del got
        del outs, st, g
        for r, mode, ops in ((k3, "k3", ops_per_word(lay)), (k4, "k4", bwd_ops_per_word(lay))):
            r["bound_ms"], r["bound_by"] = train_bound_ms(lay, b, mode)
            r["ops_per_word"], r["roofline_share"] = ops, r["bound_ms"] / r["ms"]
        res["fused_fwd_k3"], res["fused_bwd_k4"] = k3, k4
        engines = ("fused", "xla") if b == min(batches) else ("fused",)
        for engine in engines:
            init, step = make_train_step(dec, TrainConfig(engine=engine))
            opt = init(params)
            t = cuda_ms(lambda: step(params, opt, llr, bits, 2e-3), reps)
            res[f"{engine}_step"] = dict(ms=t, words_per_s=b / t * 1e3)
        out[b] = res
        for name, r in (("fused_fwd_k3 (stream + store)", k3), ("fused_bwd_k4", k4)):
            print(f"[big-time] {name}: bg1z256 MS x10, batch {b}, {r['ms']:.3f} ms per call, "
                  f"bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}, {r['ops_per_word']:,} ops per word), share "
                  f"{r['roofline_share']:.4f}; plain version {r['plain_ms']:.1f} ms; over the "
                  f"batch kernel vs plain: {r['full_batch_diff']}", flush=True)
        print(f"[big-time] fused_bwd_k4 at batch {b}: {k4['kernel']} kernel, a cluster of "
              f"{k4.get('C')} CTAs, {k4.get('smem_bytes')} B of shared memory a CTA, "
              f"{k4.get('threads')} threads, {k4.get('registers')} registers, "
              f"{k4.get('local_bytes')} B of local memory a thread, at most {k4.get('clusters')} "
              f"clusters at once (cudaOccupancyMaxActiveClusters); "
              f"{k4['cuda_launches_per_call']} CUDA launch a call; over the batch vs its twin "
              f"(channel equal, weights max rel diff) {k4['full_batch_vs_twin']}; the twin "
              f"{k4['plain_ms']:.1f} ms, the device-memory plain version {k4['dm_plain_ms']:.1f} ms"
              + (f"; word 0's phases in SM cycles {k4['phases']}; forced to larger clusters "
                 f"(CTAs: ms, clusters placed, shared memory a CTA) {k4['forced_cluster_ms']}"
                 if "phases" in k4 else ""),
              flush=True)
        print(f"[big-time] train step, batch {b}: " + ", ".join(
            f"{e} {res[f'{e}_step']['ms']:.3f} ms = {res[f'{e}_step']['words_per_s']:,.0f} words/s"
            for e in engines), flush=True)
        if not (k3["full_batch_diff"] == 0 and k4["full_batch_diff"] is not None
                and k4["full_batch_vs_twin"] is not None):
            fail("a device-memory training kernel disagrees with its plain version")
        if k4["cuda_launches_per_call"] != 1:
            fail("the cluster K4 made more than one CUDA launch a call")
    return out


# ---------------------------------------------------------------------------
# Matmul routing and the legacy engine: K5, K6, K7
# ---------------------------------------------------------------------------
TPU_K5 = "neural_ldpc_tpu/ops/pallas/minsum.py:191"  # _kernel (_run :290, call :297)
TPU_K6_FWD = "neural_ldpc_tpu/ops/pallas/fused_train.py:447"  # _route_e_rows / _route_n_from_e in _fwd_kernel
TPU_K6_BWD = "neural_ldpc_tpu/ops/pallas/fused_train.py:1392"  # int8 saturation mask, R product :1506
TPU_K7 = "scripts/mfu_r4.py:59"  # _sol_kernel (measure_sol :80, call :85)
K7_SOURCE = "neural_ldpc_tpu_torch/csrc/sol_probe.cu"
H100_BF16_OPS_PER_S = 989e12  # dense tensor-core rates, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12
LEGACY_ROUTINGS = {"bf16": dict(routing_dtype="bfloat16", int8_routing=False),
                   "f32": dict(routing_dtype="float32", int8_routing=False),
                   "int8": dict(routing_dtype="bfloat16", int8_routing=True)}
MM_TRAIN_BATCH = TRAIN_BATCH  # K6's training forward and backward
DENSE_CODE = "synth_dense_e1100"  # neural_ldpc_tpu_torch.codes.protograph.dense_protograph
DENSE_Z = 16
DENSE_SNR = 7.0  # decoded BER below channel BER; phase 1 (5 iterations) fails ~1 word in 7
DENSE_BATCH = 1 << 18
DENSE_DECODER = dict(decoder_type="MS", sharing=dict(cn=3), n_iterations=10)
# (f)'s campaign in CAMPAIGN_CASES' form: early exit after 5 with capacity
# batch / 4 (phase 1 fails ~1 word in 7), 2 warm-up and 4 timed batches
DENSE_CAMPAIGN = ("f_dense_ms10", DENSE_CODE, "MS", dict(cn=3), 10, None, DENSE_SNR, DENSE_BATCH,
                  5, 2, 4, "auto")
DENSE_CAPACITY_DIV = 4
DENSE_TRAIN_BATCH = 256
DENSE_PLAIN_CHUNK = 8192  # E*Z = 17,600 edges a word: ~7x BG2's at PLAIN_CHUNK
SOL_CHECK_ROWS = 1024
# K6's split-3 routing against roll (K1, K2): its sums (S_hi + S_mid) + S_lo
# round differently from roll's exact sums, and the decoder compounds the gap
# over iterations (JAX's own matmul and roll kernels differ by 5.8e-5 on the
# BG1-like code at Z = 16, MS x5, 6 words, in interpret mode on the CPU; SP's
# atanh near +-1 amplifies it: 0.046 on wman SP x5 at 4,096 words on the
# H100), so roll is held to these bounds, a decision differing only where
# roll's APP lies within the bound of 0, and not to TOLERANCE; int8 routing
# equals roll.
SPLIT3_VS_ROLL = {"MS": 2e-4, "SP": 1e-1}
# int8 routing's cotangents in bf16 (8 significant bits) against the plain
# engine's exact ones, relative to max |g|: 2.1e-2 on bg2_qms_train's decoder
# at 64 random codewords on the CPU (plain versions)
BF16_COTANGENT_GAP = 5e-2


def route_products(lay, kind):
    """(int8, bf16) tensor-core products of one word's pass of a matmul-
    routed kernel, each a one-hot block product over E Z x Z blocks:
    ``kind`` "fwd" (K5, K6 final APP or stream), "stats" (K6 with the
    syndrome epilogue) or "bwd" (K6's backward).  K5 and K6 route by index
    with the products' roundings; their bounds still count the products,
    the work of the TPU kernels they replace, so that shares stay
    comparable."""
    I, r = lay.n_iterations, lay.routing
    int8 = r in ("int8", "legacy_int8")
    parts = 3 if r in ("split3", "legacy_f32") else 1
    if kind in ("fwd", "stats"):
        n = I * (2 + int(lay.has_ucn)) * parts + (parts if kind == "stats" else 0)
        return (n, 0) if int8 else (0, n)
    # sums_{i-1}, the totals, the saturation indicator (int8) and the UCN
    # signs in the value routing; g_T and the sums cotangent in the cotangents'
    vals = I * (2 + int(lay.has_ucn) + int(int8)) * parts
    cots = I * 2 * (1 if int8 and not lay.grad_f32 else 3)
    return (vals, cots) if int8 else (0, vals + cots)


def tc_ops_per_word(lay, kind):
    """(int8, bf16) tensor-core operations one word's pass needs: 2 E Z^2
    per product (a multiply and an add per entry of the nonzero blocks)."""
    per = 2 * lay.E * lay.Z * lay.Z
    i8, bf = route_products(lay, kind)
    return i8 * per, bf * per


def routed_bound(lay, batch, nbytes_per_word, fp32_ops, kind):
    """(least ms, "bytes" or "operations", tensor-core ms, tensor-core ops
    per word) of one matmul-routed launch over ``batch`` words: the larger
    of the bytes at 3.35 TB/s, the fp32 operations at 33.5e12 and the
    routing products at the tensor cores' int8 / bf16 rates."""
    i8, bf = tc_ops_per_word(lay, kind)
    t_tc = (i8 / H100_INT8_OPS_PER_S + bf / H100_BF16_OPS_PER_S) * batch * 1e3
    t_bytes = (nbytes_per_word * batch + lay.tables.numel() * 4) / H100_BYTES_PER_S * 1e3
    t_ops = max(fp32_ops * batch / H100_INSTR_PER_S * 1e3, t_tc)
    b = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return b[0], b[1], t_tc, i8 + bf


def legacy_decoder(code_name, dt, sharing, iters, weights, device, routing):
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder

    code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
    kw = LEGACY_ROUTINGS[routing]
    fused = FusedMinsumDecoder.from_decoder(dec, params, engine="legacy",
                                            routing_dtype=getattr(torch, kw["routing_dtype"]),
                                            int8_routing=kw["int8_routing"])
    if fused.engine != "legacy" or fused.layout.routing != f"legacy_{routing}":
        fail(f"{code_name}: the legacy engine did not build with {routing} routing")
    return code, dec, params, fused


def check_legacy(device, batch):
    """K5 against its plain version on CHECK_CASES (every one has Z % 8 ==
    0) in bf16 and f32 routing, and int8 for QMS, at ``batch`` words: MS
    and QMS bit for bit, SP within TOLERANCE, with equal decisions.
    Returns {case: max |diff|}."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import fused_legacy_k5, legacy_plain

    diffs = {}
    for name, code_name, dt, sharing, iters, weights, snr, extra in CHECK_CASES:
        for routing in ("bf16", "f32", "int8") if dt == "QMS" else ("bf16", "f32"):
            code, dec, params, fused = legacy_decoder(code_name, dt, sharing, iters, weights,
                                                      device, routing)
            b = batch + extra
            llr, _ = channel_llr(code, snr, b, seed=11, device=device,
                                 qms_qbit=5 if dt == "QMS" else None)
            chan, lay = llr.reshape(b, -1), fused.layout
            before = fused_legacy_k5.launches
            out = fused(chan)
            torch.cuda.synchronize()
            if fused_legacy_k5.launches != before + 1:
                fail(f"{name}: K5's launch counter did not rise")
            ref = legacy_plain(chan, lay, *fused._w).clamp(lay.clip_lo, lay.clip_hi)
            diffs[f"{name}_{routing}"] = compare(f"{name} K5 {routing}", dt, b, out, ref,
                                                 exact=dt != "SP")
            del out, ref
    return diffs


def _grad_gap(got, ref):
    """(max |channel-gradient diff|, max weight-gradient diff relative to
    max |g|) of two backward results, with no bar."""
    ch = max((a - b).abs().max().item() for a, b in zip(got[3:], ref[3:]) if a is not None)
    w = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
         for a, b in zip(got[:3], ref[:3]) if a is not None]
    return ch, max(w, default=0.0)


def _stream_diff(outs, st, ref_outs, ref_st):
    return max((outs - ref_outs).abs().max().item(), (st - ref_st).abs().max().item())


def check_matmul_kernels(device, batch):
    """K6 on CHECK_CASES at ``batch`` words: the forward in every mode
    against its plain version (final APP, stats, syndrome, stream + store,
    sampling with emit_chan and in index mode) and its final APP against
    K1a (QMS in int8 routing bit for bit, split-3 within SPLIT3_VS_ROLL);
    the backward against its plain version at K2's bars, and against K2 at
    K2's bars in int8 routing with f32 cotangents (the same function as
    K2's; the split-3 gap to K2 is reported, the bf16-cotangent backward is
    held against its plain version only); then the saturating BG2 QMS x3
    case at sigma 0.35.  Returns ({case: forward max |diff|}, {case:
    backward diffs})."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, FusedTrainDecoder, fused_bwd_k2, fused_bwd_k6, fused_bwd_plain,
        fused_fwd_k1a, fused_fwd_k6, fused_fwd_plain, fused_fwd_train_plain,
        sample_channel_plain, stats_plain)

    def cases():
        yield from ((c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], None) for c in CHECK_CASES)
        # tests/test_fused_train.py:439-456: totals beyond the int8 pre-clip
        yield ("s_bg2_qms3_saturating", BG2, "QMS", dict(cn=3, vn=3), 3, None, None, 0, 0.35)

    fwd_diffs, bwd_diffs = {}, {}
    for name, code_name, dt, sharing, iters, weights, snr, extra, sigma in cases():
        code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        roll = FusedMinsumDecoder.from_decoder(dec, params)
        b = batch + extra
        if sigma is None:
            llr, _ = channel_llr(code, snr, b, seed=23, device=device,
                                 qms_qbit=5 if dt == "QMS" else None)
        else:
            g = torch.Generator(device=device).manual_seed(7)
            llr = 2 * (1.0 + sigma * torch.randn(b, code.N * code.Z, device=device, generator=g)
                       ) / sigma**2
        chan = llr.reshape(b, -1)
        gcot = torch.randn(iters, b, code.N * code.Z, device=device,
                           generator=torch.Generator(device=device).manual_seed(3))
        worst, bwd = 0.0, {}
        for rdt in (torch.float32, torch.bfloat16) if dt == "QMS" else (torch.bfloat16,):
            mm = FusedTrainDecoder.from_decoder(dec, routing="matmul", routing_dtype=rdt)
            lay, w = mm.layout, mm.pack_weights(*dec._expanded_weights(params))
            outs, st = fused_fwd_k6(chan, lay, *w, mode="stream")
            ref_outs, ref_st = fused_fwd_train_plain(chan, lay, *w)
            grads = fused_bwd_k6(chan, lay, *w, st, outs, gcot)
            bwd[f"{lay.routing}_{str(rdt)[6:]}_vs_plain"] = _grad_diffs(
                grads, fused_bwd_plain(chan, lay, *w, ref_st, ref_outs, gcot))
            k2 = fused_bwd_k2(chan, roll.layout, *w, st, outs, gcot)
            if lay.routing == "int8" and rdt == torch.float32:
                bwd["int8_float32_vs_k2"] = _grad_diffs(grads, k2)
            elif lay.routing == "split3":
                bwd["split3_gap_to_k2"] = _grad_gap(grads, k2)  # reported, no bar
            del k2
            if rdt != torch.bfloat16 and dt == "QMS":
                worst = max(worst, _stream_diff(outs, st, ref_outs, ref_st))
                del outs, st, ref_outs, ref_st, grads
                continue
            app = fused_fwd_k6(chan, lay, *w)
            ref = fused_fwd_plain(chan, lay, *w)
            stats = fused_fwd_k6(chan, lay, *w, mode="stats")
            app_s, st_s = fused_fwd_k6(chan, lay, *w, mode="syndrome")
            k1 = fused_fwd_k1a(chan, roll.layout, *w)
            seed, sig = 4321, sigma_of(code, 3.0)
            s_st, s_chan = fused_fwd_k6(None, lay, *w, mode="sample", seed=seed, sigma=sig,
                                        batch=b, emit_chan=True)
            words = torch.arange(b, device=device)
            widx = torch.randperm(b, generator=torch.Generator().manual_seed(1))[:b // 4]
            widx = widx.to(device=device, dtype=torch.int32)
            at = fused_fwd_k6(None, lay, *w, mode="sample", seed=seed, sigma=sig, widx=widx)
            torch.cuda.synchronize()
            ref_chan = sample_channel_plain(lay, seed, sig, words)
            chan_ok = bool(((s_chan - ref_chan).abs() <= 1e-5 * (1 + ref_chan.abs())).all())
            stats_ok = (torch.equal(stats, stats_plain(ref, lay)) and torch.equal(st_s, stats)
                        and torch.equal(app_s, app)
                        and torch.equal(s_st, stats_plain(fused_fwd_plain(s_chan, lay, *w), lay))
                        and torch.equal(at, s_st[widx.long()]))
            d = max((app - ref).abs().max().item(), _stream_diff(outs, st, ref_outs, ref_st),
                    0.0 if stats_ok and chan_ok else math.inf)
            same = torch.equal(app < 0, ref < 0)
            vs_k1 = (app - k1).abs().max().item()
            k1_bar = 0.0 if lay.routing == "int8" else SPLIT3_VS_ROLL[dt]
            flips = int(((app < 0) != (k1 < 0)).sum())
            far_flips = int((((app < 0) != (k1 < 0)) & (k1.abs() > k1_bar)).sum())
            worst = max(worst, d if same else math.inf)
            bwd[f"{lay.routing}_fwd_vs_k1a"] = (vs_k1, flips)
            print(f"[mm-check] {name} K6 {lay.routing}: every mode vs plain max |diff| {d:.3g} "
                  f"(stats, syndrome, sampling incl. emit_chan and index mode equal: "
                  f"{stats_ok and chan_ok}), decisions equal {same}; final APP vs K1a (roll) "
                  f"{vs_k1:.3g} (bar {k1_bar:g}), {flips} decisions differ (all where |K1's APP| "
                  f"is within the bar: {far_flips == 0})", flush=True)
            if not (d <= TOLERANCE[dt] and same):
                fail(f"{name}: the matmul-routed forward disagrees with its plain version")
            if not (vs_k1 <= k1_bar and far_flips == 0):
                fail(f"{name}: the matmul-routed forward is further from K1 than its routing's "
                     "rounding explains")
            del app, ref, stats, app_s, st_s, k1, s_st, s_chan, ref_chan, outs, st
        fwd_diffs[name], bwd_diffs[name] = worst, bwd
        print(f"[mm-check] {name} K6 backward (channel max |diff|, weights max rel diff): {bwd}",
              flush=True)
        if not worst <= TOLERANCE[dt] or any(v is None for v in bwd.values()):
            fail(f"{name}: the matmul-routed backward disagrees with its plain version or K2")
    return fwd_diffs, bwd_diffs


def check_sol(device):
    """K7 against its plain version on SOL_CHECK_ROWS rows: exact."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import sol_k7, sol_plain
    from neural_ldpc_tpu_torch.ops.cuda.sol import sol_input

    x = sol_input(device, rows=SOL_CHECK_ROWS)
    d = (sol_k7(x) - sol_plain(x)).abs().max().item()
    torch.cuda.synchronize()
    print(f"[sol-check] K7 on {SOL_CHECK_ROWS} rows: max |kernel - plain| = {d}", flush=True)
    if d != 0:
        fail("K7 disagrees with its plain version")
    return d


def ber(bits, app):
    from neural_ldpc_tpu_torch.eval import count_errors

    c = count_errors(bits, app)
    return c.bit_errors[0].item() / c.total_bits.item(), c.frame_errors[0].item() / c.total_frames.item()


# (name, code, type, sharing, iterations, weights, snr_db, routing) of path (d)
LEGACY_CASES = [
    ("wman_ms5_bf16", WMAN, "MS", dict(cn=3), 5, None, 3.5, "bf16"),
    ("wman_ms5_f32", WMAN, "MS", dict(cn=3), 5, None, 3.5, "f32"),
    ("bg2_qms20_int8", BG2, "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 2.0, "int8"),
]
LEGACY_TIMED = "wman_ms5_bf16"  # the K5 row's shape (bench.py's headline decoder)


def legacy_path(device, batch, reps=2):
    """Path (d): AWGNChannel -> BoostedNeuralDecoder ->
    FusedMinsumDecoder.from_decoder(engine="legacy") -> decode ->
    count_errors at ``batch`` all-zero words, every counter at 0 before the
    decodes and read after (K5 launched, K1a not); then K5 timed against K1a
    on the same inputs, and the headline case's plain version over the whole
    batch.  Returns ({case: result}, calls, CUDA launches)."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, fused_fwd_k1a, fused_legacy_k5, legacy_plain)

    runs, results = [], {}
    for name, code_name, dt, sharing, iters, weights, snr, routing in LEGACY_CASES:
        code, dec, params, fused = legacy_decoder(code_name, dt, sharing, iters, weights, device,
                                                  routing)
        llr, bits = channel_llr(code, snr, batch, seed=int(snr * 10), device=device,
                                qms_qbit=5 if dt == "QMS" else None, all_zero=True)
        runs.append((name, dt, snr, routing, dec, params, fused, llr, bits))
    calls = cuda = 0
    for name, dt, snr, routing, dec, params, fused, llr, bits in runs:
        read = _zero_counters()
        out = fused(llr)
        torch.cuda.synchronize()
        launches, cuda_launches = read(), read(cuda=True)
        if out.shape != (batch, llr.shape[1] * llr.shape[2]) or not torch.isfinite(out).all():
            fail(f"{name}: legacy output shape {tuple(out.shape)} or non-finite values")
        ch_ber, _ = ber(bits, llr.reshape(batch, -1))
        d_ber, d_fer = ber(bits, out)
        results[name] = dict(batch=batch, routing=routing, snr_db=snr, channel_ber=ch_ber,
                             decoded_ber=d_ber, decoded_fer=d_fer,
                             launches=launches["fused_legacy_k5"],
                             cuda_launches=cuda_launches["fused_legacy_k5"])
        calls += launches["fused_legacy_k5"]
        cuda += cuda_launches["fused_legacy_k5"]
        print(f"[legacy] (d) {name}: batch {batch}, all-zero words at {snr} dB, routing {routing}: "
              f"channel BER {ch_ber:.4g} -> decoded BER {d_ber:.4g}, FER {d_fer:.4g}; launches "
              f"{launches}, CUDA launches {cuda_launches}", flush=True)
        if not d_ber < ch_ber:
            fail(f"{name}: the legacy decode did not lower the BER")
        if launches["fused_legacy_k5"] != 1 or any(
                n for k, n in launches.items() if k != "fused_legacy_k5"):
            fail(f"{name}: path (d) did not go through K5 alone")
        del out
    for name, dt, snr, routing, dec, params, fused, llr, bits in runs:
        res, lay, chan = results[name], fused.layout, llr.reshape(batch, -1)
        stream = FusedMinsumDecoder.from_decoder(dec, params)
        res["ms"] = cuda_ms(lambda: fused_legacy_k5(chan, lay, *fused._w), reps)
        res["k1a_ms"] = cuda_ms(lambda: fused_fwd_k1a(chan, stream.layout, *stream._w), reps)
        res["k5_over_k1a"] = res["ms"] / res["k1a_ms"]
        nbytes = 2 * lay.N * lay.Z * 4
        (res["bound_ms"], res["bound_by"], res["tensor_core_ms"],
         res["tensor_core_ops_per_word"]) = routed_bound(lay, batch, nbytes, ops_per_word(lay), "fwd")
        res["ops_per_word"] = ops_per_word(lay)
        res["roofline_share"] = res["bound_ms"] / res["ms"]
        if name == LEGACY_TIMED:
            ref = torch.empty_like(chan)

            def run(n=batch):
                for s in range(0, n, PLAIN_CHUNK):
                    ref[s:s + PLAIN_CHUNK] = legacy_plain(chan[s:s + PLAIN_CHUNK], lay, *fused._w)

            res["plain_ms"] = cuda_ms(run, 1, warmup=lambda: run(PLAIN_CHUNK))
            out = fused_legacy_k5(chan, lay, *fused._w)
            res["full_batch_diff"] = compare(f"{name} K5 full batch", dt, batch,
                                             out.clamp_(lay.clip_lo, lay.clip_hi),
                                             ref.clamp_(lay.clip_lo, lay.clip_hi),
                                             exact=dt != "SP")
            del ref, out
        print(f"[legacy-time] {name}: K5 {res['ms']:.3f} ms per launch vs K1a {res['k1a_ms']:.3f} "
              f"(x{res['k5_over_k1a']:.2f}); bound {res['bound_ms']:.3f} ms ({res['bound_by']}; "
              f"routing products {res['tensor_core_ops_per_word']:,} tensor-core ops per word = "
              f"{res['tensor_core_ms']:.3f} ms), share {res['roofline_share']:.4f}"
              + (f"; plain version {res['plain_ms']:.1f} ms" if "plain_ms" in res else ""),
              flush=True)
    del runs
    return results, calls, cuda


def matmul_decoder(dec, routing_dtype="bfloat16", **kw):
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import FusedTrainDecoder

    return FusedTrainDecoder.from_decoder(dec, routing="matmul",
                                          routing_dtype=getattr(torch, routing_dtype), **kw)


def _whole_loss_grads(dec, params, llr, bits, iters, fused_decoder):
    """The whole loss's gradients through ``fused_decoder`` (FusedTrainFn)
    against the plain engine's autograd; returns (diffs at K2's bars, or
    None beyond them; the largest diff relative to max |g|; loss diff)."""
    import torch

    from neural_ldpc_tpu_torch.training import multi_iteration_loss

    grads = []
    for engine in ("plain", "fused"):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        x = llr.clone().requires_grad_(True)
        o = dec.apply(p, x) if engine == "plain" else fused_decoder.apply(*dec._expanded_weights(p), x)
        loss = multi_iteration_loss(o, bits, coeff=list(range(iters)))
        grads.append((loss.item(), torch.autograd.grad(loss, [*p.values(), x])))
        del o, loss
    (l0, g0), (l1, g1) = grads
    pad = [None] * (3 - len(params))
    rel = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) for a, b in zip(g1, g0))
    return (_grad_diffs((*g1[:-1], *pad, g1[-1], None), (*g0[:-1], *pad, g0[-1], None)), rel,
            abs(l0 - l1))


# (name, code, type, sharing, iterations, weights, snr_db, routing_dtype) of path (e)
MM_CASES = [
    ("bg2_qms_train_int8_bf16", BG2, "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 2.0,
     "bfloat16"),
    ("bg2_qms_train_int8_f32", BG2, "QMS", dict(cn=3, vn=3), 20, "bg2_qms20_ref500ep.npz", 2.0,
     "float32"),
    ("wman_ms5_split3", WMAN, "MS", dict(cn=3), 5, None, 3.5, "bfloat16"),
]


def matmul_path(device, batch, train_batch=MM_TRAIN_BATCH, check_batch=CHECK_BATCH, reps=2):
    """Path (e): ``FusedTrainDecoder.from_decoder(dec, routing="matmul")``
    on the shipped codes, each with every counter at 0 before and read
    after: the final-APP decode at ``batch`` all-zero words (BER below the
    channel's), the whole loss's gradients through FusedTrainFn against the
    plain engine at ``check_batch`` random codewords, and the training
    forward and backward at ``train_batch``.  Then each is timed against
    K1a / K1d / K2 on the same inputs.  Returns {case: result}."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedTrainDecoder, fused_bwd_k2, fused_bwd_k6, fused_bwd_plain, fused_fwd_k1a,
        fused_fwd_k1d, fused_fwd_k6, fused_fwd_plain, fused_fwd_train_plain)
    from neural_ldpc_tpu_torch.training import multi_iteration_loss

    out = {}
    for name, code_name, dt, sharing, iters, weights, snr, rdt in MM_CASES:
        code, dec, params = make_decoder(code_name, dt, sharing, iters, weights, device)
        res = dict(routing_dtype=rdt)
        llr, bits = channel_llr(code, snr, batch, seed=int(snr * 10), device=device,
                                qms_qbit=5 if dt == "QMS" else None, all_zero=True)
        read = _zero_counters()
        dec_mm = matmul_decoder(dec, rdt, store_msgs=False)
        app = dec_mm.apply(*dec._expanded_weights(params), llr)[0]
        torch.cuda.synchronize()
        res["decode_launches"] = read()["fused_fwd_k6"]
        res["decode_cuda_launches"] = read(cuda=True)["fused_fwd_k6"]
        res["channel_ber"], _ = ber(bits, llr.reshape(batch, -1))
        res["decoded_ber"], res["decoded_fer"] = ber(bits, app)
        lay = dec_mm.layout
        res["routing"] = lay.routing
        del app, bits

        ch = campaign_channel(code, snr, dt, device)
        x, y = ch.sample_mixed(ch.generator(12), check_batch, all_zero=code.gen_matrix is None)
        train_mm = matmul_decoder(dec, rdt)
        read = _zero_counters()
        step, rel, loss_diff = _whole_loss_grads(dec, params, x, y, iters, train_mm)
        torch.cuda.synchronize()
        res["loss_launches"], res["loss_cuda_launches"] = read(), read(cuda=True)
        res["whole_loss_vs_plain_engine"], res["loss_diff"] = step, loss_diff
        res["whole_loss_rel_gap"] = rel
        # int8 routing's default bf16 cotangents are JAX's lossy rounding: the
        # plain engine is exact, so they are held to BF16_COTANGENT_GAP of
        # max |g| instead (and to their plain version, exactly, above)
        bf16_cot = train_mm.layout.routing == "int8" and not train_mm.layout.grad_f32
        step_ok = rel <= BF16_COTANGENT_GAP if bf16_cot else step is not None
        print(f"[mm] (e) {name}: K6 {lay.routing} decode at {batch} words, {snr} dB: channel BER "
              f"{res['channel_ber']:.4g} -> decoded BER {res['decoded_ber']:.4g} "
              f"({res['decode_launches']} K6 launch); whole-loss gradients at {check_batch} words "
              f"vs the plain engine {step} (largest diff {rel:.3g} of max |g|"
              f"{f', bar {BF16_COTANGENT_GAP:g}: bf16 cotangents' if bf16_cot else ''}), loss diff "
              f"{loss_diff:.3g}; launches {res['loss_launches']}", flush=True)
        if not (res["decoded_ber"] < res["channel_ber"] and res["decode_launches"]
                and step_ok and loss_diff <= 1e-6
                and res["loss_launches"]["fused_fwd_k6"] and res["loss_launches"]["fused_bwd_k6"]
                and not res["loss_launches"]["fused_fwd_k1d"]):
            fail(f"{name}: the matmul-routed path failed its checks")
        del x, y

        # timings on the same inputs: K6 against K1a / K1d / K2
        roll = FusedTrainDecoder.from_decoder(dec, store_msgs=False)
        w = train_mm.pack_weights(*dec._expanded_weights(params))
        chan = llr.reshape(batch, -1)
        res["ms"] = cuda_ms(lambda: fused_fwd_k6(chan, lay, *w), reps)
        res["k1a_ms"] = cuda_ms(lambda: fused_fwd_k1a(chan, roll.layout, *w), reps)
        if name == "wman_ms5_split3":  # the K6-forward row's plain version over the whole batch
            ref = torch.empty_like(chan)

            def run(n=batch):
                for s in range(0, n, PLAIN_CHUNK):
                    ref[s:s + PLAIN_CHUNK] = fused_fwd_plain(chan[s:s + PLAIN_CHUNK], lay, *w)

            res["plain_ms"] = cuda_ms(run, 1, warmup=lambda: run(PLAIN_CHUNK))
            got = fused_fwd_k6(chan, lay, *w)
            res["full_batch_diff"] = compare(f"{name} K6 full batch", dt, batch,
                                             got.clamp_(lay.clip_lo, lay.clip_hi),
                                             ref.clamp_(lay.clip_lo, lay.clip_hi))
            del ref, got
        (res["bound_ms"], res["bound_by"], res["tensor_core_ms"],
         res["tensor_core_ops_per_word"]) = routed_bound(lay, batch, 2 * lay.N * lay.Z * 4,
                                                         ops_per_word(lay), "fwd")
        del llr, chan
        tlay = train_mm.layout
        x, y = ch.sample_mixed(ch.generator(13), train_batch, all_zero=code.gen_matrix is None)
        tchan = x.reshape(train_batch, -1)
        outs, st = fused_fwd_k6(tchan, tlay, *w, mode="stream")
        g = torch.randn(outs.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(3))
        res["train_fwd_ms"] = cuda_ms(lambda: fused_fwd_k6(tchan, tlay, *w, mode="stream"), reps)
        res["k1d_ms"] = cuda_ms(lambda: fused_fwd_k1d(tchan, roll.layout, *w), reps)
        res["bwd_ms"] = cuda_ms(lambda: fused_bwd_k6(tchan, tlay, *w, st, outs, g), reps)
        res["bwd_block"] = k2_report(tlay, device, train_batch, f"K6's backward, (e) {name}")
        outs1, st1 = fused_fwd_k1d(tchan, FusedTrainDecoder.from_decoder(dec).layout, *w)
        res["k2_ms"] = cuda_ms(lambda: fused_bwd_k2(tchan, roll.layout, *w, st1, outs1, g), reps)
        ref_outs, ref_st = fused_fwd_train_plain(tchan, tlay, *w)
        res["train_fwd_diff"] = _stream_diff(outs, st, ref_outs, ref_st)
        res["bwd_vs_plain"] = _grad_diffs(fused_bwd_k6(tchan, tlay, *w, st, outs, g),
                                          fused_bwd_plain(tchan, tlay, *w, ref_st, ref_outs, g))
        del ref_outs, ref_st
        if name == "bg2_qms_train_int8_bf16":  # the K6-backward row's plain time
            res["bwd_plain_ms"] = cuda_ms(lambda: fused_bwd_plain(tchan, tlay, *w, st, outs, g), 1)
        fb = (tlay.N * tlay.Z * (1 + iters) + tlay.E * tlay.Z * iters) * 4
        res["train_fwd_bound_ms"], res["train_fwd_bound_by"], _, _ = routed_bound(
            tlay, train_batch, fb, ops_per_word(tlay), "fwd")
        bb = (tlay.N * tlay.Z * (2 + iters + int(dt == "QMS")) + tlay.E * tlay.Z * iters) * 4
        (res["bwd_bound_ms"], res["bwd_bound_by"], res["bwd_tensor_core_ms"],
         res["bwd_tensor_core_ops_per_word"]) = routed_bound(tlay, train_batch, bb,
                                                             bwd_ops_per_word(tlay), "bwd")
        print(f"[mm-time] (e) {name}: decode at {batch} K6 {res['ms']:.3f} ms vs K1a "
              f"{res['k1a_ms']:.3f} (x{res['ms'] / res['k1a_ms']:.2f}), bound {res['bound_ms']:.3f} "
              f"({res['bound_by']}; routing {res['tensor_core_ops_per_word']:,} tensor-core ops "
              f"per word = {res['tensor_core_ms']:.3f} ms); at {train_batch} words the training "
              f"forward {res['train_fwd_ms']:.3f} vs K1d {res['k1d_ms']:.3f}, backward "
              f"{res['bwd_ms']:.3f} vs K2 {res['k2_ms']:.3f} (bound {res['bwd_bound_ms']:.3f} "
              f"{res['bwd_bound_by']}); vs plain: forward {res['train_fwd_diff']:.3g}, backward "
              f"{res['bwd_vs_plain']}", flush=True)
        if not res["train_fwd_diff"] <= TOLERANCE[dt] or res["bwd_vs_plain"] is None:
            fail(f"{name}: K6 disagrees with its plain version at the timed batch")
        out[name] = res
        del x, y, tchan, outs, st, g, outs1, st1
    return out


def dense_path(device, batch=DENSE_BATCH, steps_per_epoch=10, train_batch=DENSE_TRAIN_BATCH,
               reps=2, plain_chunk=DENSE_PLAIN_CHUNK):
    """Path (f): the E = 1100 protograph at Z = 16 through the normal entry
    points with routing="auto" (matmul, K6), every counter at 0 before each
    run and read after: a decode at ``batch`` words (K6 against its plain
    version on 512 of them), the campaign (fused, stats mode, in-kernel
    sampling, early exit after 5 with capacity batch / 4, 2 batches off the
    clock and 4 timed; its phase-1 and escalation decoders held against
    their plain versions at their shapes first), and Trainer (fused,
    all-zero words) for 3 epochs of ``steps_per_epoch`` steps at
    ``train_batch``, with the resume from epoch 2 bitwise; before it, one
    training batch through K6's training forward and backward against their
    plain versions at K2's bars.  Returns a result dict."""
    import torch

    from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, FusedTrainDecoder, fused_bwd_k6, fused_bwd_plain, fused_fwd_k6,
        fused_fwd_plain, fused_fwd_train_plain, fused_capacity_ok, on_chip_ok)
    from neural_ldpc_tpu_torch.training import TrainConfig, Trainer
    from neural_ldpc_tpu_torch.training.lr_schedule import LearningRate

    code, dec, params = make_decoder(DENSE_CODE, device=device, weights=None, **DENSE_DECODER)
    graph = dec.graph
    res = dict(E=graph.E, Z=graph.Z, snr_db=DENSE_SNR, on_chip_ok=on_chip_ok(graph),
               fused_capacity_ok=fused_capacity_ok(graph))
    fused = FusedMinsumDecoder.from_decoder(dec, params)
    lay = fused.layout
    if graph.E <= 1024 or lay.routing != "split3" or lay.hbm_store:
        fail("path (f): 'auto' did not route the E > 1024 code by matmul on chip")
    ch = AWGNChannel(code, ChannelConfig(snr_db=(DENSE_SNR,)), device=device)
    llr, bits = ch.sample_at(ch.generator(41), batch, 0, all_zero=True)
    read = _zero_counters()
    app = fused(llr)
    torch.cuda.synchronize()
    res["decode_launches"], res["decode_cuda_launches"] = read(), read(cuda=True)
    res["channel_ber"], _ = ber(bits, llr.reshape(batch, -1))
    res["decoded_ber"], res["decoded_fer"] = ber(bits, app)
    chan = llr.reshape(batch, -1)
    n = 512
    ref = fused_fwd_plain(chan[:n], lay, *fused._w).clamp(lay.clip_lo, lay.clip_hi)
    res["vs_plain_512"] = compare("f_dense K6 (512 words)", "MS", n, app[:n], ref)
    res["ms"] = cuda_ms(lambda: fused_fwd_k6(chan, lay, *fused._w), reps)
    res["ops_per_word"] = ops_per_word(lay)
    (res["bound_ms"], res["bound_by"], res["tensor_core_ms"],
     res["tensor_core_ops_per_word"]) = routed_bound(lay, batch, 2 * lay.N * lay.Z * 4,
                                                     res["ops_per_word"], "fwd")
    res["roofline_share"] = res["bound_ms"] / res["ms"]
    print(f"[dense] (f) E = {graph.E} at Z = {graph.Z} (check degrees "
          f"{int(lay.deg_classes[0][0])}-{lay.max_degree}), MS x10 cn=3, routing "
          f"{lay.routing}: decode at {batch} words, {DENSE_SNR} dB: channel BER "
          f"{res['channel_ber']:.4g} -> decoded BER {res['decoded_ber']:.4g}, FER "
          f"{res['decoded_fer']:.4g}; K6 {res['ms']:.3f} ms per launch, bound "
          f"{res['bound_ms']:.3f} ({res['bound_by']}, {res['ops_per_word']:,} ops per word), "
          f"share {res['roofline_share']:.4f}; launches {res['decode_launches']}", flush=True)
    if not (res["decoded_ber"] < res["channel_ber"] and res["decode_launches"]["fused_fwd_k6"]):
        fail("path (f): the decode did not lower the BER through K6")
    del app, ref, llr, bits, chan

    case = DENSE_CAMPAIGN[:7] + (batch,) + DENSE_CAMPAIGN[8:]
    _, camp = make_campaign(case, device, capacity_div=DENSE_CAPACITY_DIV, probe_batches=2)
    res["campaign_shapes"] = check_campaign_decoders(case[0], code, camp, DENSE_SNR, device,
                                                     reps=1, chunk=plain_chunk)
    for label, r in res["campaign_shapes"].items():  # path (e)'s bound, stats mode
        dl = camp.decoders[label].layout
        ops = ops_per_word(dl) + epilogue_ops(dl)
        nbytes = 12 if camp.kernel_sampling else dl.N * dl.Z * 4 + 12
        if camp.kernel_sampling:
            ops += sampler_ops(dl)
        r["ops_per_word"] = ops
        r["bound_ms"], r["bound_by"], _, _ = routed_bound(dl, r["words"], nbytes, ops, "stats")
        r["roofline_share"] = r["bound_ms"] / r["ms"]
        print(f"[dense] (f) campaign {label}: {r['words']:,} words, K6 {r['ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ({r['bound_by']}, {ops:,} ops per word), share "
              f"{r['roofline_share']:.4f}", flush=True)
    read = _zero_counters()
    camp.run_snr_point(0, batches=2)
    w0, e0 = int(camp.words[0]), int(camp.escalations[0])
    t0 = time.perf_counter()
    camp.run_snr_point(0, batches=4)
    dt_s = time.perf_counter() - t0
    r = camp.results()[DENSE_SNR]
    res["campaign"] = dict(batch=batch, timed_batches=4, timed_s=dt_s,
                           words_per_s=(int(camp.words[0]) - w0) / dt_s,
                           escalations_timed=int(camp.escalations[0]) - e0,
                           guard_keeps_early_exit=bool(camp._ee_choice.get(0)), words=r["words"],
                           ber=r["ber"][0], fer=r["fer"][0], launches=read(),
                           cuda_launches=read(cuda=True))
    print(f"[dense] (f) campaign: batch {batch}, 4 timed batches in {dt_s:.3f} s = "
          f"{res['campaign']['words_per_s']:,.0f} words/s; phase-1 failures (escalations) "
          f"{res['campaign']['escalations_timed']} in the timed batches; auto-guard keeps early "
          f"exit: {res['campaign']['guard_keeps_early_exit']}; BER {r['ber'][0]:.4g}, FER "
          f"{r['fer'][0]:.4g}; launches {res['campaign']['launches']}", flush=True)
    if not (res["campaign"]["launches"]["fused_fwd_k6"] and int(camp.escalations[0]) > 0):
        fail("path (f): the campaign never launched K6 or phase 1 never failed")
    del camp

    # one training batch as Trainer's step runs it: K6's training forward
    # (stream + store) and backward against their plain versions
    train_dec = FusedTrainDecoder.from_decoder(dec)
    tlay, w = train_dec.layout, train_dec.pack_weights(*dec._expanded_weights(params))
    tllr, _ = ch.sample_at(ch.generator(43), train_batch, 0, all_zero=True)
    tchan = tllr.reshape(train_batch, -1)
    gcot = torch.randn(dec.config.n_iterations, train_batch, tchan.shape[1], device=device,
                       generator=torch.Generator(device=device).manual_seed(3))
    outs, st = fused_fwd_k6(tchan, tlay, *w, mode="stream")
    ref_outs, ref_st = fused_fwd_train_plain(tchan, tlay, *w)
    res["train_fwd_vs_plain"] = _stream_diff(outs, st, ref_outs, ref_st)
    res["bwd_vs_plain"] = _grad_diffs(fused_bwd_k6(tchan, tlay, *w, st, outs, gcot),
                                      fused_bwd_plain(tchan, tlay, *w, ref_st, ref_outs, gcot))
    # the backward per call at the Trainer's batch, against path (e)'s bound
    res["bwd_ms"] = cuda_ms(lambda: fused_bwd_k6(tchan, tlay, *w, st, outs, gcot), reps)
    res["bwd_block"] = k2_report(tlay, device, train_batch, "K6's backward, (f)")
    res["bwd_plain_ms"] = cuda_ms(lambda: fused_bwd_plain(tchan, tlay, *w, st, outs, gcot), 1)
    bb = (tlay.N * tlay.Z * (2 + tlay.n_iterations) + tlay.E * tlay.Z * tlay.n_iterations) * 4
    (res["bwd_bound_ms"], res["bwd_bound_by"], res["bwd_tensor_core_ms"],
     res["bwd_tensor_core_ops_per_word"]) = routed_bound(tlay, train_batch, bb,
                                                         bwd_ops_per_word(tlay), "bwd")
    torch.cuda.synchronize()
    print(f"[dense] (f) training batch of {train_batch} words, routing {tlay.routing}: K6 "
          f"training forward (stream + store) vs plain max |diff| {res['train_fwd_vs_plain']:.3g}; "
          f"backward vs plain (channel max |diff|, weights max rel diff) {res['bwd_vs_plain']}; "
          f"backward {res['bwd_ms']:.3f} ms per call, bound {res['bwd_bound_ms']:.3f} "
          f"({res['bwd_bound_by']}), plain {res['bwd_plain_ms']:.1f} ms", flush=True)
    if not res["train_fwd_vs_plain"] <= TOLERANCE["MS"] or res["bwd_vs_plain"] is None:
        fail("path (f): K6's training forward or backward disagrees with its plain version")
    del outs, st, ref_outs, ref_st, tllr, tchan, gcot

    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(total_epochs=3, batch_size=train_batch,
                           train_words_per_epoch=train_batch * steps_per_epoch,
                           validate_words=train_batch, engine="fused", is_y_all_zero=True,
                           learning_rate=LearningRate(1e-3, 0.0, 0), validate_epoch_step=1,
                           checkpoint_step=1, checkpoint_dir=tmp, export_weights_txt=False,
                           seed=2042, verbose=False)
        tch = AWGNChannel(code, ChannelConfig(snr_db=(DENSE_SNR,)), device=device)
        read = _zero_counters()
        t0 = time.perf_counter()
        trained, _, _ = Trainer(dec, tch, tcfg).train()
        torch.cuda.synchronize()
        res["train_s"] = time.perf_counter() - t0
        res["train_launches"], res["train_cuda_launches"] = read(), read(cuda=True)
        read = _zero_counters()
        resumed, _, _ = Trainer(dec, tch, tcfg).resume("checkpoint_epoch_0002")
        torch.cuda.synchronize()
        res["resume_launches"] = read()
        res["resume_bitwise"] = all(torch.equal(trained[k], resumed[k]) for k in trained)
    steps = 3 * steps_per_epoch
    print(f"[dense] (f) Trainer, fused engine: {steps} steps of batch {train_batch} in "
          f"{res['train_s']:.2f} s; launches {res['train_launches']}; resume from epoch 2 bitwise: "
          f"{res['resume_bitwise']} (launches {res['resume_launches']})", flush=True)
    if (res["train_launches"]["fused_fwd_k6"], res["train_launches"]["fused_bwd_k6"]) != (
            steps, steps):
        fail("path (f): K6 did not run forward and backward once per step")
    if not res["resume_bitwise"]:
        fail("path (f): the resumed run differs from the uninterrupted one")
    return res


# fp32 instructions of K7 outside the chain: acc_k = a * (0.25 + 0.125 k)
# (none where the factor is 1, k = 6), the 7 adds of the sum and its * 0.0625
K7_OUTSIDE_CHAIN = sum(0.25 + 0.125 * k != 1.0 for k in range(8)) + 7 + 1
K7_ISSUED_PER_STEP = 4  # sub, mul, add, min with |.| as FMNMX's operand modifier


# ---------------------------------------------------------------------------
# (h) Checks above 32 edges: the kernels' kAnyDegree instantiations
# ---------------------------------------------------------------------------
# synth_dense(3, M, N, target_e) (neural_ldpc_tpu_torch.codes.protograph):
# the largest check degree -> (M, N, target_e)
HIGH_CODES = {41: (12, 60, 400), 73: (8, 80, 560)}
HIGH_BATCH = 2048
HIGH_SNR = 3.0
HIGH_DM_Z = 96  # the degree-41 code off chip: the two-pass K3, the device-memory K4
HIGH_DM_BATCH = 256
# (type, sharing, iterations); the campaigns run the MS decoder
HIGH_DECODERS = [("MS", dict(cn=3, ucn=2, vn=3), 10), ("QMS", dict(cn=3, vn=3), 10),
                 ("SP", dict(cn=1, vn=2), 5)]
HIGH_KERNELS = ("fused_fwd_k1a", "fused_fwd_k1b", "fused_fwd_k1c", "fused_fwd_k1d",
                "fused_bwd_k2", "fused_fwd_k3", "fused_bwd_k4", "fused_legacy_k5",
                "fused_fwd_k6", "fused_bwd_k6")


def high_decoder(degree, decoder_type, sharing, iters, device, Z=16, seed=5):
    """(code, decoder, params) on synth_dense's code with checks of up to
    ``degree`` edges at lift Z, random weights around 1 from ``seed``."""
    import numpy as np

    from neural_ldpc_tpu_torch.codes import TannerGraph
    from neural_ldpc_tpu_torch.codes.protograph import CodeSpec, synth_dense
    from neural_ldpc_tpu_torch.models import (
        BoostedDecoderConfig, BoostedNeuralDecoder, params_from_numpy)
    from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig

    code = CodeSpec(name=f"synth_dense_deg{degree}_z{Z}",
                    basegraph=synth_dense(3, *HIGH_CODES[degree]), Z=Z)
    dec = BoostedNeuralDecoder(TannerGraph.from_basegraph(code.basegraph, Z), BoostedDecoderConfig(
        n_iterations=iters, decoder_type=DecoderType[decoder_type], qms_qbit=5,
        sharing=NodeWeightSharingConfig(**sharing)), device=device)
    rng = np.random.default_rng(seed)
    params = params_from_numpy({
        k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
        for k, v in dec.init_params().items()}, device)
    return code, dec, params


def high_degree_path(device, batch=HIGH_BATCH, dm_batch=HIGH_DM_BATCH):
    """Phase (h): codes with checks of 41 and 73 edges (at Z = 16, on chip)
    through the entry points a user calls, with every counter set to 0
    just before and read just after: the decode (K1a), the fused campaign
    with the channel sampled in the kernel (K1c) and read (K1b), one fused
    train step (K1d + K2), the whole loss through matmul routing (K6's
    forward and backward), the legacy engine (K5); and the degree-41 code at
    Z = 96 (the two-pass K3 and the device-memory K4) through a decode and
    the whole loss.  Then every kernel of the path is held against its
    plain version on the card at that path's shapes: QMS and MS bit for bit
    (K1, K5, K6, K3), SP within 5e-3; backwards at K2's bars; the
    campaigns' early-exit counters equal to the full unroll and their
    phase-1 and escalation decoders exact.  Fails if a kernel of the path
    was never launched.  Returns a result dict."""
    import torch

    from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, FusedTrainDecoder, fused_bwd_dm_plain, fused_bwd_k2, fused_bwd_k4,
        fused_bwd_k6, fused_bwd_plain, fused_fwd_dm_plain, fused_fwd_k1d, fused_fwd_k3,
        fused_fwd_k6, fused_fwd_plain, fused_fwd_train_plain, fused_legacy_k5, legacy_plain)
    from neural_ldpc_tpu_torch.training import (
        TrainConfig, make_train_step, multi_iteration_loss)

    def loss_backward(fused_dec, dec, params, llr, bits):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        o = fused_dec.apply(*dec._expanded_weights(p), llr)
        multi_iteration_loss(o, bits, coeff=list(range(o.shape[0]))).backward()

    res = {"diffs": {}, "blocks": {}}
    cases = []
    t0 = time.perf_counter()
    read = _zero_counters()
    for degree in HIGH_CODES:
        for dt, sharing, iters in HIGH_DECODERS:
            code, dec, params = high_decoder(degree, dt, sharing, iters, device)
            llr, bits = channel_llr(code, HIGH_SNR, batch, seed=degree,
                                    device=device, qms_qbit=5 if dt == "QMS" else None)
            fused = FusedMinsumDecoder.from_decoder(dec, params)
            app = fused(llr)  # K1a
            init, step = make_train_step(dec, TrainConfig(engine="fused"))
            step(params, init(params), llr, bits, 1e-3)  # K1d + K2
            mm = matmul_decoder(dec, "float32")  # K6: int8 for QMS, split-3 otherwise
            loss_backward(mm, dec, params, llr, bits)
            leg = FusedMinsumDecoder.from_decoder(dec, params, engine="legacy",
                                                  int8_routing=dt == "QMS")
            app5 = leg(llr)  # K5
            cases.append((f"deg{degree}_{dt.lower()}{iters}", dt, dec, params, llr, bits,
                          fused, app, mm, leg, app5))
        # the fused campaign of the MS decoder: channel sampled in the kernel
        # (K1c) and read (K1b), early exit after 5 iterations
        code, dec, params = high_decoder(degree, "MS", dict(cn=3), 10, device)
        ch = campaign_channel(code, HIGH_SNR, "MS", device)
        for sampling in ("on", "off"):
            camp = MonteCarloCampaign(dec, params, ch, CampaignConfig(
                batch_size=batch, max_words_per_snr=4 * batch, min_frame_errors=0, seed=7,
                engine="fused", early_exit_iters=5, early_exit_capacity=batch // 2,
                early_exit_auto_guard=False, kernel_channel_sampling=sampling))
            camp.run_snr_point(0, batches=2)
            cases.append((f"deg{degree}_ms10_campaign_{sampling}", "MS", dec, params, None, None,
                          camp, None, None, None, None))
    code96, dec96, params96 = high_decoder(41, "MS", dict(cn=3, vn=3), 5, device, Z=HIGH_DM_Z)
    llr96, bits96 = channel_llr(code96, HIGH_SNR, dm_batch, seed=96, device=device)
    hbm = FusedTrainDecoder.from_decoder(dec96)
    app96 = FusedMinsumDecoder.from_decoder(dec96, params96)(llr96)  # K3
    loss_backward(hbm, dec96, params96, llr96, bits96)  # K3 + K4
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    res["launches"], res["cuda_launches"] = read(), read(cuda=True)
    print(f"[high] (h) checks above 32 edges: launches {res['launches']}; CUDA launches "
          f"{res['cuda_launches']} ({res['seconds']:.1f} s)", flush=True)
    missing = [k for k in HIGH_KERNELS if not res["launches"][k]]
    if missing:
        fail(f"path (h) never launched {missing}")

    # every kernel of the path against its plain version
    diffs = res["diffs"]
    for name, dt, dec, params, llr, bits, fused, app, mm, leg, app5 in cases:
        if llr is None:  # a campaign: counters and its own decoders
            camp = fused
            full = MonteCarloCampaign(dec, params, camp.channel, dataclasses.replace(
                camp.cfg, early_exit_iters=None))
            full.run_snr_point(0, batches=2)
            same = full.results() == camp.results()
            print(f"[high] {name}: in-kernel sampling {camp.kernel_sampling}; counters equal "
                  f"to the full unroll: {same}; {camp.results()}", flush=True)
            if not same:
                fail(f"(h) {name}: early-exit counters differ from the full unroll")
            shapes = check_campaign_decoders(f"(h) {name}", camp.channel.code, camp, HIGH_SNR,
                                             device, reps=1)
            diffs[name] = max(r["max_abs_diff"] for r in shapes.values())
            continue
        lay, w = fused.layout, fused._w
        chan = llr.reshape(llr.shape[0], -1)
        exact = dt != "SP"
        diffs[f"{name}_k1a"] = compare(f"(h) {name} K1a", dt, chan.shape[0], app,
                                       fused_fwd_plain(chan, lay, *w).clamp(lay.clip_lo,
                                                                            lay.clip_hi),
                                       exact=exact)
        outs, st = fused_fwd_k1d(chan, lay, *w)
        ref_outs, ref_st = fused_fwd_train_plain(chan, lay, *w)
        diffs[f"{name}_k1d"] = max((outs - ref_outs).abs().max().item(),
                                   (st - ref_st).abs().max().item())
        g = torch.randn(outs.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(3))
        k2 = _grad_diffs(fused_bwd_k2(chan, lay, *w, st, outs, g),
                         fused_bwd_plain(chan, lay, *w, ref_st, ref_outs, g))
        res["blocks"][name] = k2_report(lay, device, chan.shape[0], f"K2, (h) {name}")
        mlay, mw = mm.layout, mm.pack_weights(*dec._expanded_weights(params))
        diffs[f"{name}_k6"] = compare(f"(h) {name} K6 ({mlay.routing})", dt, chan.shape[0],
                                      fused_fwd_k6(chan, mlay, *mw),
                                      fused_fwd_plain(chan, mlay, *mw), exact=exact)
        m_outs, m_st = fused_fwd_k6(chan, mlay, *mw, mode="stream")
        k6 = _grad_diffs(fused_bwd_k6(chan, mlay, *mw, m_st, m_outs, g),
                         fused_bwd_plain(chan, mlay, *mw, m_st, m_outs, g))
        diffs[f"{name}_k5"] = compare(f"(h) {name} K5 ({leg.layout.routing})", dt,
                                      chan.shape[0], app5,
                                      legacy_plain(chan, leg.layout, *leg._w).clamp(
                                          leg.layout.clip_lo, leg.layout.clip_hi), exact=exact)
        diffs[f"{name}_k2"], diffs[f"{name}_k6_bwd"] = k2, k6
        print(f"[high] {name}: K1d vs plain {diffs[f'{name}_k1d']:.3g}; K2 vs plain {k2}; K6 "
              f"backward vs plain {k6}", flush=True)
        if diffs[f"{name}_k1d"] > TOLERANCE[dt] or k2 is None or k6 is None:
            fail(f"(h) {name}: a training kernel disagrees with its plain version")
        del outs, st, ref_outs, ref_st, g, m_outs, m_st
    lay96 = hbm.layout
    w96 = hbm.pack_weights(*dec96._expanded_weights(params96))
    chan96 = llr96.reshape(dm_batch, -1)
    if (lay96.k3_kernel, lay96.k4_kernel) != ("two-pass", "device-memory"):
        fail("(h) the degree-41 code at Z = 96 should take the two-pass K3 and the "
             "device-memory K4")
    diffs["deg41_z96_ms5_k3"] = compare("(h) deg41 Z=96 K3", "MS", dm_batch, app96,
                                        fused_fwd_dm_plain(chan96, lay96, *w96)[0].clamp(
                                            lay96.clip_lo, lay96.clip_hi), exact=True)
    outs, st = fused_fwd_k3(chan96, lay96, *w96, mode="stream")
    g = torch.randn(outs.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(5))
    k4 = _grad_diffs(fused_bwd_k4(chan96, lay96, *w96, st, outs, g),
                     fused_bwd_dm_plain(chan96, lay96, *w96, st, outs, g))
    diffs["deg41_z96_ms5_k4"] = k4
    print(f"[high] deg41 Z=96 MS x5 (K3 {lay96.k3_kernel}, K4 {lay96.k4_kernel}): K4 vs plain "
          f"{k4}", flush=True)
    if k4 is None:
        fail("(h) the device-memory K4 disagrees with its plain version")
    return res


def sol_sass_per_step():
    """fp32 instructions K7 issues per chain step, read from its SASS
    (``cuobjdump -sass`` of the built library): (FADD + FMUL + FMNMX -
    K7_OUTSIDE_CHAIN) / FMNMX, one FMNMX per step.  (per step, opcode
    counts), or (None, {}) where the SASS cannot be read."""
    from neural_ldpc_tpu_torch.ops.cuda import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", _build._lib_path("sol_probe")], capture_output=True,
                             text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None, {}
    ops = re.findall(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", out.stdout, re.M)
    counts = {op: ops.count(op) for op in ("FADD", "FMUL", "FMNMX")}
    if out.returncode != 0 or not counts["FMNMX"]:
        return None, counts
    return (sum(counts.values()) - K7_OUTSIDE_CHAIN) / counts["FMNMX"], counts


def sol_path(device):
    """Path (g): ``measure_sol`` at its TPU shape, counters at 0 before.
    ``instr_per_s`` counts the TPU script's 5 operations a step, for the
    comparison with it; ``bound_ms`` the instructions the card issues per
    step, read from K7's SASS (K7_ISSUED_PER_STEP where it cannot be read),
    so that the bound stays a bound."""
    from neural_ldpc_tpu_torch.ops.cuda import measure_sol, sol_plain
    from neural_ldpc_tpu_torch.ops.cuda.sol import CHAIN, COLS, GRID, NACC, ROWS, sol_input

    read = _zero_counters()
    res = measure_sol(device)
    res["launches"], res["cuda_launches"] = read()["sol_k7"], read(cuda=True)["sol_k7"]
    n = GRID * ROWS * COLS
    per_step, res["sass_counts"] = sol_sass_per_step()
    res["issued_per_step_from_sass"] = per_step is not None
    res["issued_per_step"] = per_step if per_step is not None else K7_ISSUED_PER_STEP
    issued = n * (CHAIN * NACC * res["issued_per_step"] + K7_OUTSIDE_CHAIN)
    res["issued_ops_per_launch"] = issued
    res["issued_instr_per_s"] = issued / res["launch_ms"] * 1e3
    t_bytes, t_ops = 8 * n / H100_BYTES_PER_S * 1e3, issued / H100_INSTR_PER_S * 1e3
    res["bound_ms"], res["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                                                   "operations")
    res["roofline_share"] = res["bound_ms"] / res["launch_ms"]
    x = sol_input(device, rows=GRID * ROWS)
    res["plain_ms"] = cuda_ms(lambda: sol_plain(x), 1)
    print(f"[sol] (g) K7 at [{GRID * ROWS}, {COLS}]: {res['launch_ms']:.3f} ms per launch = "
          f"{res['instr_per_s']:.4g} counted instructions/s (5 a step, as the TPU script counts; "
          f"data sheet 33.5e12; {res['instr_per_s'] / H100_INSTR_PER_S:.3f} of it); issued "
          f"{res['issued_per_step']:g} a step ({'from the SASS ' + str(res['sass_counts']) if per_step is not None else 'SASS not read'}) "
          f"= {res['issued_instr_per_s']:.4g} instructions/s; bound {res['bound_ms']:.3f} ms "
          f"({res['bound_by']}), share {res['roofline_share']:.3f}; launches {res['launches']}; "
          f"plain version {res['plain_ms']:.1f} ms", flush=True)
    if not (res["finite"] and res["launches"]):
        fail("path (g): the probe gave non-finite values or never launched K7")
    return res


# ---------------------------------------------------------------------------
# Path (i): Kwak's boosted error-floor pipeline; path (j): Dai's greedy
# training, the profiler and the small CLIs
# ---------------------------------------------------------------------------
BOOSTED_EPOCHS = 2  # per stage (the preset: 500)
BOOSTED_WORDS = 400  # words an epoch: 20 steps at the preset's batch of 20 (the preset: 10,000)
BOOSTED_VALIDATE = 200  # the preset: 1,000
HARVEST_BATCH = 65536
HARVEST_WORDS = 2048
# 3.5 dB: the barely trained base fails about 4 words in 10,000 there, so
# the 2,048-word budget fills in about 80 batches; at the preset's -1
# (4.5 dB) it would take hundreds
HARVEST_SNR_INDEX = 0
TWO_STAGE_BATCH = 1 << 20
TWO_STAGE_CHECK = 65536  # the plain decoders' slice
BOOSTED_CLI_COLLECT = 32  # the CLI run's harvest budget (the preset: 2,048)
GREEDY_EPOCHS = 2  # the preset: 500


def boosted_pipeline(device, ckpt_dir, harvest_batch=HARVEST_BATCH):
    """The boosted_error_floor preset's pipeline as the train CLI builds it
    (BG2 QMS, cn / ucn / vn ITER, base 20 + post 5 iterations, post UCN
    NODE_ITER, all-zero words at 3.5 / 4.0 / 4.5 dB), with the fused engine,
    each stage cut to BOOSTED_EPOCHS of BOOSTED_WORDS and the harvest to
    HARVEST_*: (config, pipeline)."""
    from neural_ldpc_tpu_torch.training.boosted_pipeline import (
        BoostedPipeline, BoostedPipelineConfig)
    from neural_ldpc_tpu_torch.utils.config import get_preset

    cfg = get_preset("boosted_error_floor").override(
        engine="fused", total_epochs=BOOSTED_EPOCHS, train_words_per_epoch=BOOSTED_WORDS,
        validate_words=BOOSTED_VALIDATE, validate_epoch_step=1, checkpoint_step=1,
        checkpoint_dir=ckpt_dir)
    code, graph = cfg.build_graph()
    channel = cfg.build_channel(code, device=device)
    tcfg = dataclasses.replace(cfg.build_train_config(), verbose=False)
    pipe = BoostedPipeline(
        graph, channel, cfg.build_decoder_config(n_iterations=cfg.base_iters), tcfg, tcfg,
        BoostedPipelineConfig(base_iters=cfg.base_iters, post_iters=cfg.post_iters,
                              collect_words=HARVEST_WORDS, collect_batch_size=harvest_batch,
                              collect_snr_index=HARVEST_SNR_INDEX))
    return cfg, pipe


def check_stage2_rows(pipe, base_params, ext, where):
    """Stage 2's output against its seed: every leaf's frozen rows equal
    the transferred ones bit for bit (CN and VN: the base's; UCN: seeded
    from the base CN rows), the post CN / VN rows exactly 1.0, the post UCN
    rows moved.  Returns the largest move of a post UCN weight."""
    import torch

    nb = pipe.cfg.base_iters
    seeded = pipe.transfer_base_params(base_params)
    frozen = all(torch.equal(ext[k][:nb], seeded[k][:nb]) for k in ext)
    base_equal = all(torch.equal(ext[k][:nb], base_params[k]) for k in ("weight_cn", "weight_vn"))
    neutral = all(bool((ext[k][nb:] == 1.0).all()) for k in ("weight_cn", "weight_vn"))
    moved = (ext["weight_ucn"][nb:] - 1.0).abs().max().item()
    print(f"[boosted] {where}: rows 0-{nb - 1} of {sorted(ext)} equal the transferred ones bit "
          f"for bit: {frozen} (CN / VN = the base's: {base_equal}); post CN / VN rows exactly "
          f"1.0: {neutral}; post UCN rows moved by up to {moved:.3g}", flush=True)
    if not (frozen and base_equal and neutral and moved > 0):
        fail(f"{where}: stage 2 moved a frozen row or a neutral one, or left UCN untrained")
    return moved


def check_post_engines(pipe, base_params, llr_pool, bits_pool, device, lr=1e-3):
    """One stage-2 step on each engine from the transferred params, on one
    batch of the stage's datagen (the loss over iterations 20-24 only, UCN
    rows 20-24 trainable): loss within 1e-6, frozen and neutral rows
    unchanged bit for bit on both, UCN rows within 1e-6 where the plain
    engine's |g| > 1e-5 and within 2 lr elsewhere."""
    import numpy as np
    import torch

    from neural_ldpc_tpu_torch.training import make_train_step, multi_iteration_loss

    dec = pipe.post_decoder
    params = pipe.transfer_base_params(base_params)
    x, y = pipe.make_post_datagen(llr_pool, bits_pool, np.random.default_rng(0))(
        pipe.post_train.batch_size)
    x, y = torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
    res = {}
    for engine in ("xla", "fused"):
        init, step = make_train_step(dec, dataclasses.replace(pipe.post_train, engine=engine))
        res[engine] = step(params, init(params), x, y, lr)
    i0, i1 = pipe.post_train.training_iter_start, pipe.post_train.training_iter_end
    pg = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = multi_iteration_loss(dec.apply(pg, x)[i0:i1], y, coeff=list(range(i1 - i0)))
    g_ucn = torch.autograd.grad(loss, [pg["weight_ucn"]])[0]
    nb = pipe.cfg.base_iters
    unchanged = all(torch.equal(r[0][k][:nb], params[k][:nb]) for r in res.values()
                    for k in params) and all(torch.equal(r[0][k], params[k]) for r in res.values()
                                             for k in ("weight_cn", "weight_vn"))
    diff = (res["xla"][0]["weight_ucn"] - res["fused"][0]["weight_ucn"]).abs()
    big = g_ucn.abs() > 1e-5
    big_diff = diff[big].max().item() if big.any() else 0.0
    loss_diff = abs(res["xla"][2].item() - res["fused"][2].item())
    out = dict(loss_diff=loss_diff, ucn_diff_where_g_above_1e_5=big_diff,
               ucn_diff_elsewhere=diff.max().item(), frozen_unchanged=unchanged,
               ucn_rows_with_g_above_1e_5=int(big.any(dim=1).sum()))
    print(f"[boosted] one stage-2 step on each engine (loss over iterations {i0}-{i1 - 1}, "
          f"weight_ucn only): {out}", flush=True)
    if not (unchanged and loss_diff <= 1e-6 and big_diff <= 1e-6 and diff.max().item() <= 2 * lr
            and big.any()):
        fail("the fused stage-2 step disagrees with the plain one, or moved a frozen row")
    return out


def two_stage_path(pipe, base_params, ext_params, device, batch=TWO_STAGE_BATCH,
                   check=TWO_STAGE_CHECK, reps=2):
    """TwoStageDecoder over the stage-1 (base) and stage-2 (post) params'
    FusedMinsumDecoders at ``batch`` all-zero words of the preset's mixed
    SNRs: ``__call__`` and ``decode_sparse`` equal on every row, the stats
    of the first ``check`` words equal those of the plain decoders, and the
    words/s of the base decode alone, ``__call__`` and ``decode_sparse``."""
    import torch

    from neural_ldpc_tpu_torch.eval import TwoStageDecoder
    from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder

    base = FusedMinsumDecoder.from_decoder(pipe.base_decoder, base_params)
    post = FusedMinsumDecoder.from_decoder(pipe.post_decoder, ext_params)
    two = TwoStageDecoder(pipe.graph, base, post, device=device)
    llr, _ = pipe.channel.sample_mixed(pipe.channel.generator(21), batch, all_zero=True)
    read = _zero_counters()
    app, used = two(llr)
    sparse, sused = two.decode_sparse(llr)
    torch.cuda.synchronize()
    out = dict(launches=read(), cuda_launches=read(cuda=True))
    out["sparse_equals_full"] = torch.equal(app, sparse) and torch.equal(used, sused)
    del app, sparse, sused
    out["stats"] = two.decode_with_fallback_stats(llr)
    escalated = out["stats"]["escalated"]
    if not int(used.sum()) == escalated:
        fail("two-stage: __call__'s escalations differ from decode_with_fallback_stats'")
    out["bucket"] = max(256, 1 << (escalated - 1).bit_length()) if escalated else 0
    with torch.no_grad():
        plain = TwoStageDecoder(pipe.graph, lambda x: pipe.base_decoder.apply(base_params, x)[-1],
                                lambda x: pipe.post_decoder.apply(ext_params, x)[-1],
                                device=device)
        out["plain_stats"] = plain.decode_with_fallback_stats(llr[:check])
    out["kernel_stats"] = two.decode_with_fallback_stats(llr[:check])
    for name, fn in (("base", lambda: base(llr)), ("call", lambda: two(llr)),
                     ("decode_sparse", lambda: two.decode_sparse(llr))):
        ms = cuda_ms(fn, reps)
        out[f"{name}_ms"], out[f"{name}_words_per_s"] = ms, batch / ms * 1e3
    print(f"[two-stage] {batch:,} words: {out['stats']}; decode_sparse equals __call__ on every "
          f"row: {out['sparse_equals_full']} (post bucket {out['bucket']}); launches "
          f"{out['launches']}; words/s: base decode {out['base_words_per_s']:,.0f} "
          f"({out['base_ms']:.3f} ms), __call__ {out['call_words_per_s']:,.0f} "
          f"({out['call_ms']:.3f} ms), decode_sparse {out['decode_sparse_words_per_s']:,.0f} "
          f"({out['decode_sparse_ms']:.3f} ms); over the first {check:,} words, kernels "
          f"{out['kernel_stats']}, plain decoders {out['plain_stats']}", flush=True)
    expected_k1a = 4 if escalated else 3
    if not (out["sparse_equals_full"] and out["kernel_stats"] == out["plain_stats"]
            and out["launches"]["fused_fwd_k1a"] == expected_k1a):
        fail("two-stage decoding: decode_sparse differs from __call__, the kernels' stats from "
             "the plain decoders', or K1a did not run each stage")
    return out


def time_post_kernels(pipe, base_params, ext_params, device, reps=REPS):
    """The train step of each stage at the preset's batch of 20 (the fused
    engine, CUDA events), and K1d and K2 of the extended decoder (25
    iterations with UCN) at that batch against their bounds and plain
    versions, held against those (K1d exact, K2 at its bars)."""
    import torch

    from neural_ldpc_tpu_torch.ops.cuda import (
        FusedMinsumDecoder, fused_bwd_k2, fused_bwd_plain, fused_fwd_k1d, fused_fwd_train_plain)
    from neural_ldpc_tpu_torch.training import make_train_step

    b = pipe.post_train.batch_size
    x, y = pipe.channel.sample_mixed(pipe.channel.generator(31), b, all_zero=True)
    res = {}
    for stage, dec, params, tcfg in (("stage1", pipe.base_decoder, base_params, pipe.base_train),
                                     ("stage2", pipe.post_decoder, ext_params, pipe.post_train)):
        init, step = make_train_step(dec, tcfg)
        opt = init(params)
        ms = cuda_ms(lambda: step(params, opt, x, y, 1e-3), reps)
        res[f"{stage}_step"] = dict(ms=ms, words_per_s=b / ms * 1e3)
    fused = FusedMinsumDecoder.from_decoder(pipe.post_decoder, ext_params)
    lay, w = fused.layout, fused._w
    chan = x.reshape(b, -1)
    outs, st = fused_fwd_k1d(chan, lay, *w)
    ref_outs, ref_st = fused_fwd_train_plain(chan, lay, *w)
    k1d_diff = max((outs - ref_outs).abs().max().item(), (st - ref_st).abs().max().item())
    g = torch.randn(outs.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(6))
    k2 = _grad_diffs(fused_bwd_k2(chan, lay, *w, st, outs, g),
                     fused_bwd_plain(chan, lay, *w, st, outs, g))
    for name, kernel, plain, mode in (
            ("fused_fwd_k1d", lambda: fused_fwd_k1d(chan, lay, *w),
             lambda: fused_fwd_train_plain(chan, lay, *w), "k1d"),
            ("fused_bwd_k2", lambda: fused_bwd_k2(chan, lay, *w, st, outs, g),
             lambda: fused_bwd_plain(chan, lay, *w, st, outs, g), "k2")):
        r = dict(ms=cuda_ms(kernel, reps), plain_ms=cuda_ms(plain, reps))
        r["bound_ms"], r["bound_by"] = train_bound_ms(lay, b, mode)
        r["roofline_share"] = r["bound_ms"] / r["ms"]
        res[name] = r
    res["fused_fwd_k1d"]["vs_plain"], res["fused_bwd_k2"]["vs_plain"] = k1d_diff, k2
    res["k2_block"] = k2_report(lay, device, b, "K2, the boosted post decoder (25 iterations, UCN)")
    print(f"[boosted-time] batch {b}: step stage 1 {res['stage1_step']['ms']:.3f} ms, stage 2 "
          f"{res['stage2_step']['ms']:.3f} ms; extended decoder (QMS x25, UCN): "
          + "; ".join(f"{n} {r['ms']:.3f} ms per launch, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}), plain {r['plain_ms']:.3f} ms, vs plain {r['vs_plain']}"
                      for n, r in res.items() if n.startswith("fused_")), flush=True)
    if not (k1d_diff == 0 and k2 is not None):
        fail("the extended decoder's K1d or K2 disagrees with its plain version")
    return res


def boosted_path(device, two_stage_batch=TWO_STAGE_BATCH, two_stage_check=TWO_STAGE_CHECK,
                 harvest_batch=HARVEST_BATCH):
    """Path (i): the boosted_error_floor pipeline through its entry points,
    every counter at 0 before each step and read after: the whole pipeline
    from init (K1d and K2 once a step of either stage, K1a in the harvest);
    the harvest alone (every word a failure of the base's plain decode on
    the card); stage 2 alone from the stage-1 params (equal to the whole
    run's bit for bit); one stage-2 step on each engine; two-stage decoding;
    the train CLI in mode "boosted".  Returns a result dict."""
    import numpy as np
    import torch

    from neural_ldpc_tpu_torch.cli import train as train_cli

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg, pipe = boosted_pipeline(device, os.path.join(tmp, "run"), harvest_batch)
        steps = BOOSTED_EPOCHS * (BOOSTED_WORDS // cfg.batch_size)

        read = _zero_counters()
        t0 = time.perf_counter()
        base_params, ext_params, report = pipe.run(verbose=False)
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        out["run_launches"], out["run_cuda_launches"] = read(), read(cuda=True)
        out["collected_words"] = report["collected_words"]
        n = out["run_launches"]
        print(f"[boosted] BoostedPipeline.run from init (fused engine, {steps} steps a stage at "
              f"batch {cfg.batch_size}, harvest at {cfg.snr_db[HARVEST_SNR_INDEX]} dB in batches "
              f"of {harvest_batch:,}): {out['run_s']:.2f} s, {out['collected_words']} words "
              f"harvested; launches {n}", flush=True)
        if (n["fused_fwd_k1d"], n["fused_bwd_k2"]) != (2 * steps, 2 * steps):
            fail("the pipeline did not launch K1d and K2 once per step of each stage")
        if n["fused_fwd_k1a"] < 1 or out["collected_words"] != HARVEST_WORDS:
            fail("the pipeline's harvest did not decode through K1a or fell short")
        out["ucn_moved"] = check_stage2_rows(pipe, base_params, ext_params, "the whole run")

        read = _zero_counters()
        t0 = time.perf_counter()
        llr, bits = pipe.collect_uncorrected_words(base_params, verbose=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        batches = read()["fused_fwd_k1a"]
        with torch.no_grad():
            app = pipe.base_decoder.apply(base_params, torch.as_tensor(llr, device=device))[-1]
        fails = ((app < 0).to(torch.int32).cpu().numpy() != bits.astype(np.int32)).any(axis=1)
        out["harvest"] = dict(seconds=secs, batches=batches, words_decoded=batches * harvest_batch,
                              harvested=len(llr), harvested_words_per_s=len(llr) / secs,
                              decoded_words_per_s=batches * harvest_batch / secs,
                              all_fail_plain=bool(fails.all()))
        print(f"[boosted] harvest alone: {len(llr)} words from {batches} batches of "
              f"{harvest_batch:,} (K1a launches) in {secs:.3f} s: {len(llr) / secs:,.0f} harvested "
              f"and {batches * harvest_batch / secs:,.0f} decoded words/s; every harvested word "
              f"fails the base's plain decode on the card: {bool(fails.all())}", flush=True)
        if not (fails.all() and len(llr) == HARVEST_WORDS and batches >= 1):
            fail("a harvested word does not fail the plain base decode, or K1a never ran")

        read = _zero_counters()
        t0 = time.perf_counter()
        _, ext2, _ = pipe.run(base_params=base_params, verbose=False)
        torch.cuda.synchronize()
        out["stage2_s"] = time.perf_counter() - t0
        out["stage2_launches"] = n2 = read()
        out["stage2_equals_run"] = all(torch.equal(ext2[k], ext_params[k]) for k in ext_params)
        print(f"[boosted] run(base_params) (harvest + stage 2): {out['stage2_s']:.2f} s; "
              f"launches {n2}; params equal to the whole run's bit for bit: "
              f"{out['stage2_equals_run']}", flush=True)
        if (n2["fused_fwd_k1d"], n2["fused_bwd_k2"], n2["fused_fwd_k1a"]) != (steps, steps, batches):
            fail("stage 2 did not launch K1d and K2 once per step, or its harvest K1a once a batch")
        if not out["stage2_equals_run"]:
            fail("stage 2 from the stage-1 params differs from the whole run's")
        check_stage2_rows(pipe, base_params, ext2, "stage 2 alone")
        out["engines"] = check_post_engines(pipe, base_params, llr, bits, device)
        out["timing"] = time_post_kernels(pipe, base_params, ext_params, device)
        out["two_stage"] = two_stage_path(pipe, base_params, ext_params, device,
                                          two_stage_batch, two_stage_check)
        del pipe, llr, bits, app
        torch.cuda.empty_cache()

        ck = os.path.join(tmp, "cli")
        argv = ["--preset", "boosted_error_floor", "--set", 'engine="fused"', "--epochs", "1",
                "--device", str(device), "--set", f"checkpoint_dir={ck}",
                "--set", f"train_words_per_epoch={BOOSTED_WORDS}",
                "--set", f"validate_words={BOOSTED_VALIDATE}", "--set", "validate_epoch_step=1",
                "--set", f"collect_words={BOOSTED_CLI_COLLECT}"]
        read = _zero_counters()
        t0 = time.perf_counter()
        if train_cli.main(argv) != 0:
            fail("the train CLI failed in mode boosted")
        torch.cuda.synchronize()
        out["cli_s"] = time.perf_counter() - t0
        out["cli_launches"] = n3 = read()
        written = os.path.exists(os.path.join(ck, "boosted_final.npz")) and os.path.exists(
            os.path.join(ck, "boosted_final_weights_txt", "index.txt"))
        cli_steps = BOOSTED_WORDS // cfg.batch_size
        print(f"[boosted] cli.train.main(--preset boosted_error_floor --set engine=fused --epochs "
              f"1 --set collect_words={BOOSTED_CLI_COLLECT}): {out['cli_s']:.2f} s; launches "
              f"{n3}; boosted_final written: {written}", flush=True)
        if not (written and n3["fused_fwd_k1d"] == n3["fused_bwd_k2"] == 2 * cli_steps
                and n3["fused_fwd_k1a"] >= 1):
            fail("the boosted train CLI did not write boosted_final or skipped a kernel")
    out["launches_i"] = {k: sum(r[k] for r in (out["run_launches"], out["stage2_launches"],
                                               out["two_stage"]["launches"], out["cli_launches"]))
                         + (batches if k == "fused_fwd_k1a" else 0)
                         for k in ("fused_fwd_k1a", "fused_fwd_k1d", "fused_bwd_k2")}
    return out


def dai_path(device, epochs=GREEDY_EPOCHS, reps=REPS, profile_batch=None,
             eval_words=1 << 18):
    """Path (j): GreedyLayerTrainer on the wman_neural_train preset (wman,
    20 layers, batch 50, its 20-SNR curriculum) for ``epochs`` epochs, then
    one step on each layer checking that it moves its own row alone, the
    step timed; the train CLI in mode "greedy" for one epoch;
    ``cli/profile.py --preset bg2_qms_train --reps 5`` with a trace
    directory; ``cli/evaluate.py --import-reference`` on a txt export this
    function writes.  Returns a result dict."""
    import contextlib
    import io

    import numpy as np
    import torch

    from neural_ldpc_tpu_torch.cli import evaluate as evaluate_cli
    from neural_ldpc_tpu_torch.cli import profile as profile_cli
    from neural_ldpc_tpu_torch.cli import train as train_cli
    from neural_ldpc_tpu_torch.models import (
        BoostedNeuralDecoder, NeuralDecoderConfig, NeuralMinSumDecoder, params_from_numpy)
    from neural_ldpc_tpu_torch.training.greedy import GreedyLayerTrainer, GreedyTrainConfig
    from neural_ldpc_tpu_torch.utils import CheckpointManager
    from neural_ldpc_tpu_torch.utils.checkpoint import import_reference_weights
    from neural_ldpc_tpu_torch.utils.config import get_preset

    out = {}
    cfg = get_preset("wman_neural_train")
    code, graph = cfg.build_graph()
    channel = cfg.build_channel(code, device=device)
    dec = NeuralMinSumDecoder(graph, NeuralDecoderConfig(
        n_iterations=cfg.n_iterations, convention=cfg.convention), device=device)
    trainer = GreedyLayerTrainer(dec, channel, GreedyTrainConfig(
        total_epochs=epochs, batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
        is_y_all_zero=cfg.y_all_zero, seed=cfg.seed, verbose=False))
    read = _zero_counters()
    t0 = time.perf_counter()
    params, opt, report = trainer.train()
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["train_launches"] = read()
    losses = report["layer_losses"]
    moved = (params["weights_var"] - 0.5).abs().max().item()
    rows_ok = True
    I = cfg.n_iterations
    for layer in range(I):
        llr, bits = channel.sample_at(channel.generator(100 + layer), cfg.batch_size, layer,
                                      all_zero=True)
        new, opt, loss = trainer._step(params, opt, llr, bits, layer)
        others = [i for i in range(I) if i != layer]
        rows_ok &= all(torch.equal(new[k][others], params[k][others])
                       and not torch.equal(new[k][layer], params[k][layer]) for k in params)
        rows_ok &= math.isfinite(loss.item())
        params = new
    out["step_ms"] = cuda_ms(lambda: trainer._step(params, opt, llr, bits, I - 1), reps)
    out.update(layer_losses=losses, weights_moved=moved, each_step_moves_its_row=rows_ok)
    print(f"[greedy] wman_neural_train: {epochs} epochs x {I} layers at batch {cfg.batch_size} in "
          f"{out['train_s']:.2f} s (launches {out['train_launches']}); layer losses "
          f"{np.round(losses, 5).tolist()}; weights moved by up to {moved:.3g}; one step per "
          f"layer moves its own rows alone: {rows_ok}; step {out['step_ms']:.3f} ms", flush=True)
    if not (all(math.isfinite(v) for v in losses) and moved > 0 and rows_ok):
        fail("greedy training: a non-finite loss, no move, or a step moved another layer's rows")

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "greedy")
        t0 = time.perf_counter()
        if train_cli.main(["--preset", "wman_neural_train", "--epochs", "1", "--device",
                           str(device), "--set", f"checkpoint_dir={ck}"]) != 0:
            fail("the train CLI failed in mode greedy")
        out["greedy_cli_s"] = time.perf_counter() - t0
        with np.load(os.path.join(ck, "greedy_final.npz")) as data:
            out["greedy_cli_rows"] = len(data.files)
        print(f"[greedy] cli.train.main(--preset wman_neural_train --epochs 1): "
              f"{out['greedy_cli_s']:.2f} s; greedy_final holds {out['greedy_cli_rows']} rows",
              flush=True)
        if out["greedy_cli_rows"] != 2 * I:
            fail("the greedy train CLI wrote the wrong weights")

        tdir = os.path.join(tmp, "trace")
        argv = ["--preset", "bg2_qms_train", "--reps", "5", "--device", str(device),
                "--trace-dir", tdir]
        if profile_batch:
            argv += ["--batch-size", str(profile_batch)]
        read = _zero_counters()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = profile_cli.main(argv)
        torch.cuda.synchronize()
        out["profile_launches"] = read()
        table = buf.getvalue()
        for line in table.splitlines():
            print(f"[profile-cli] {line}", flush=True)
        rows = [l for l in table.splitlines() if " compile " in l]
        out["profile_rows"] = rows
        out["trace_files"] = sorted(os.listdir(tdir)) if os.path.isdir(tdir) else []
        if not (rc == 0 and [r.split()[0] for r in rows] == ["decode_xla", "decode_fused", "train"]
                and out["profile_launches"]["fused_fwd_k1a"] > 0 and len(out["trace_files"]) == 3):
            fail("the profile CLI did not print its three rows, launch K1a or write its traces")

        ecfg = get_preset("montecarlo_campaign")
        edec = BoostedNeuralDecoder(ecfg.build_graph()[1], ecfg.build_decoder_config(),
                                    device=device)
        rng = np.random.default_rng(7)
        ref = params_from_numpy({k: (v.cpu().numpy() * (1 + 0.2 * rng.normal(size=v.shape)))
                                 .astype(np.float32) for k, v in edec.init_params().items()},
                                device)
        CheckpointManager(tmp).save_weights("reference", edec.named_parameter_rows(ref),
                                            as_txt=True)
        txt = os.path.join(tmp, "reference_weights_txt")
        imported = import_reference_weights(edec, txt)
        same = all(torch.equal(imported[k], ref[k]) for k in ref)
        res_path = os.path.join(tmp, "eval.json")
        read = _zero_counters()
        rc = evaluate_cli.main(["--import-reference", txt, "--snr", "3.0", "--batch-size",
                                str(min(eval_words, 65536)), "--max-words", str(eval_words),
                                "--min-frame-errors", "0", "--engine", "fused",
                                "--device", str(device), "--out", res_path])
        torch.cuda.synchronize()
        out["evaluate_launches"] = read()
        with open(res_path) as f:
            res = json.load(f)["results"]["3.0"]
        out["evaluate"] = res
        k1 = sum(v for k, v in out["evaluate_launches"].items() if k.startswith("fused_fwd_k1"))
        print(f"[evaluate-cli] --import-reference of a txt export (wman MS x20, cn ITER): params "
              f"equal to the exported ones bit for bit: {same}; {res['words']:,} words at 3.0 dB "
              f"through the fused campaign, launches {out['evaluate_launches']}; result {res}",
              flush=True)
        if not (rc == 0 and same and res["words"] == eval_words and k1 > 0):
            fail("evaluate --import-reference did not import the export or run the kernels")
    return out


# ROUTE template values of csrc/fused_fwd.cu (csrc/bp_common.cuh's kInt8,
# kBf16, kSplit3, kLegacyInt8)
FWD_ROUTES = {0: "roll", 1: "int8", 2: "bf16", 3: "split3", 4: "legacy_int8"}


def cluster_instantiations(log: str) -> dict:
    """{"qms=0" or "qms=1": {registers, spill_stores, spill_loads}} of the
    cluster K3's instantiations, from ptxas' -v output."""
    out, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"k3_clusterILb([01])EE", m.group(1))
            cur = f"qms={k.group(1)}" if k else None
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = dict(registers=int(m.group(1)), spill_stores=spill[0], spill_loads=spill[1])
            cur = None
    return out


def k4_instantiations(log: str) -> dict:
    """{"qms=0/sp=0" ...: {registers, spill_stores, spill_loads}} of the
    cluster K4's instantiations, from ptxas' -v output."""
    out, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"k4_clusterILb([01])ELb([01])EE", m.group(1))
            cur = f"qms={k.group(1)}/sp={k.group(2)}" if k else None
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = dict(registers=int(m.group(1)), spill_stores=spill[0], spill_loads=spill[1])
            cur = None
    return out


def fwd_instantiations(log: str) -> dict:
    """{"MAXB/routing[/qms]": {registers, spill_stores, spill_loads}} of
    fused_fwd_kernel's instantiations, from ptxas' -v output."""
    out, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"fused_fwd_kernelILi(\d+)ELi(\d+)E(?:Lb([01])E)?", m.group(1))
            cur = (f"{k.group(1)}/{FWD_ROUTES.get(int(k.group(2)), k.group(2))}"
                   f"{'/qms' if k.group(3) == '1' else ''}" if k else None)
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = dict(registers=int(m.group(1)), spill_stores=spill[0], spill_loads=spill[1])
            cur = None
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
    sources = ("fused_fwd", "fused_bwd", "fused_fwd_cl", "fused_fwd_dm", "fused_bwd_cl",
               "fused_bwd_dm", "sol_probe")
    _build.load_all(sources)  # one nvcc per source, in parallel
    build_s = time.perf_counter() - t_build
    print(f"[build] {', '.join(f'{n}.cu' for n in sources)}: {build_s:.1f} s "
          f"(nvcc seconds each: {_build.build_seconds})", flush=True)
    for name in sources:
        for line in _build.build_log.get(name, "").splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "Compiling entry" in line):
                print(f"[build] {name}: {line.strip()}", flush=True)
    fwd_regs = fwd_instantiations(_build.build_log.get("fused_fwd", ""))
    print("[build] fused_fwd_kernel<MAXB, ROUTE, QMS> (K1: roll, K6: int8 / split3, K5: bf16 / "
          "legacy_int8, and roll for f32): " + "; ".join(
        f"{k} {v['registers']} registers, spills {v['spill_stores']} B stored / "
        f"{v['spill_loads']} B loaded" for k, v in sorted(fwd_regs.items())), flush=True)
    cl_regs = cluster_instantiations(_build.build_log.get("fused_fwd_cl", ""))
    print("[build] k3_cluster<QMS> (K3, 1,024 threads a CTA): " + "; ".join(
        f"{k} {v['registers']} registers, spills {v['spill_stores']} B stored / "
        f"{v['spill_loads']} B loaded" for k, v in sorted(cl_regs.items())), flush=True)
    k4_regs = k4_instantiations(_build.build_log.get("fused_bwd_cl", ""))
    print("[build] k4_cluster<QMS, SP> (K4, 1,024 threads a CTA): " + "; ".join(
        f"{k} {v['registers']} registers, spills {v['spill_stores']} B stored / "
        f"{v['spill_loads']} B loaded" for k, v in sorted(k4_regs.items())), flush=True)
    if len(k4_regs) != 4:
        fail("ptxas reported no register count for one of the cluster K4's instantiations")

    k1_block = k1_report(device)
    diffs, stats_diffs = check_kernel(device, CHECK_BATCH)
    llr_diffs = check_sampler(device, SAMPLER_BATCH)
    check_campaigns(device, CAMPAIGN_CHECK_BATCH)
    shapes = check_campaign_shapes(device)
    results, launches, cuda_launches = main_path(device, MAIN_BATCH)
    time_configs(results, MAIN_BATCH, REPS, diffs)
    camp_results, camp_launches = campaign_path(device)
    ktimes = time_campaign_kernels(device, MAIN_BATCH, REPS)
    k1d_diffs, k2_diffs = check_training_kernels(device, CHECK_BATCH)
    train = training_path(device)
    engines = check_engines(device)
    ttimes = time_training(device, TRAIN_BATCH, REPS)

    # big codes: K3 and K4 (the earlier phases' cached blocks go back first)
    torch.cuda.empty_cache()
    k3_equal, k4_diffs, vs_on_chip = check_device_memory_kernels(device, CHECK_BATCH)
    big_diffs = check_big_codes(device, BIG_CHECK_BATCH)
    two_pass = check_two_pass(device)
    k4_dm = check_device_memory_k4(device)
    big_grads = check_big_loss_gradients(device)
    big_main, big_launches, big_cuda, (big_fused, big_llr) = big_decode_path(device, BIG_BATCH)
    big_time = time_big_decode(big_fused, big_llr, BIG_REPS)
    del big_fused, big_llr
    torch.cuda.empty_cache()
    check_campaigns(device, 8192, cases=[(BIG_CAMPAIGN[:7], BIG_CAMPAIGN[8])],
                    samplings=("auto",))
    big_shapes = check_campaign_shapes(device, [BIG_CAMPAIGN], reps=2)
    big_camp, _ = campaign_path(device, [BIG_CAMPAIGN])
    big_train = big_training_path(device)
    big_ttimes = time_big_training(device)
    # (calls, CUDA launches) of K3 on each path, each read after its own run
    b_run = big_camp[BIG_CAMPAIGN[0]]
    k3_paths = {"a_decode": (big_launches, big_cuda),
                "b_campaign": (b_run["launches"], b_run["cuda_launches"]),
                "c_training": (big_train["launches"], big_train["cuda_launches"]),
                "c_served": (big_train["serve_launches"], big_train["serve_cuda_launches"])}
    k3_kernels = {"a_decode": big_main["all_zero"]["k3_kernel"], "b_campaign": b_run["k3_kernel"],
                  "c_training": big_train["k3_kernel"], "c_served": big_main["all_zero"]["k3_kernel"]}
    k3_paths = {p: dict(calls=n["fused_fwd_k3"], cuda_launches=c["fused_fwd_k3"],
                        cuda_launches_per_call=c["fused_fwd_k3"] / max(n["fused_fwd_k3"], 1),
                        kernel=k3_kernels[p])
                for p, (n, c) in k3_paths.items()}
    k4_calls = big_train["launches"]["fused_bwd_k4"]
    k4_cuda = big_train["cuda_launches"]["fused_bwd_k4"]
    # the K4 each path's layout selects (only (c) runs a backward)
    k4_kernels = {"a_decode": big_main["all_zero"]["k4_kernel"], "b_campaign": b_run["k4_kernel"],
                  "c_training": big_train["k4_kernel"]}
    print(f"[big-main] K3 calls and CUDA launches by path: {k3_paths}; K4 by path's layout "
          f"{k4_kernels}; K4 in path (c): {k4_calls} calls, {k4_cuda} CUDA launches",
          flush=True)

    # matmul routing and the legacy engine: K5, K6, K7 (checks, then the paths)
    torch.cuda.empty_cache()
    k5_diffs = check_legacy(device, CHECK_BATCH)
    k6_fwd_diffs, k6_bwd_diffs = check_matmul_kernels(device, CHECK_BATCH)
    k7_diff = check_sol(device)
    legacy, k5_calls, k5_cuda = legacy_path(device, MAIN_BATCH)
    mm = matmul_path(device, MAIN_BATCH)
    dense = dense_path(device)
    high = high_degree_path(device)
    sol = sol_path(device)

    # the two papers' recipes: (i) Kwak's boosted pipeline, (j) Dai's greedy
    # training, the profiler and the small CLIs
    torch.cuda.empty_cache()
    boosted = boosted_path(device)
    dai = dai_path(device)

    res = results["bg2_qms20"][0]
    k1b, k1c = ktimes["fused_fwd_k1b"], ktimes["fused_fwd_k1c"]
    stats_diffs["wman_ms10_full_batch"] = k1b["full_batch_diff"]
    # K1b's launches are the read-channel campaign's (the evaluate CLI's
    # path), K1c's the sampling campaigns'; each run had its counters at 0
    sampled = [c[0] for c in CAMPAIGN_CASES if c[11] != "off"]
    read = [c[0] for c in CAMPAIGN_CASES if c[11] == "off"]

    def shape_diffs(cases):
        return {f"{c}_{label}": r["max_abs_diff"] for c in cases for label, r in shapes[c].items()}

    stats_diffs.update(shape_diffs(read))
    llr_diffs = dict(llr_diffs, **shape_diffs(sampled))
    kernels = {"kernels": [{
        "name": "fused_fwd_k1a",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": launches,
        "cuda_launches": cuda_launches,
        "max_abs_err": max(diffs.values()),
        "max_abs_diff": diffs,
        "ms": res["ms"],
        "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": None,  # no PyTorch call computes a BP decode
        "shape": f"bg2_qms20, batch {MAIN_BATCH}",
        "ptxas": {k: v for k, v in fwd_regs.items() if "/roll" in k},
        "nvcc_seconds": _build.build_seconds,  # every source's build, fused_fwd.cu's included
        "block": k1_block,
        "configs": {name: r for name, (r, _, _) in results.items()},
    }, {
        "name": "fused_fwd_k1b",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_STATS,
        "launches": sum(camp_launches[c]["fused_fwd_k1b"] for c in read),
        "cuda_launches": sum(camp_results[c]["cuda_launches"]["fused_fwd_k1b"] for c in read),
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
        "cuda_launches": sum(camp_results[c]["cuda_launches"]["fused_fwd_k1c"] for c in sampled),
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
        "cuda_launches": train["cuda_launches"]["fused_fwd_k1d"],
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
        "cuda_launches": train["cuda_launches"]["fused_bwd_k2"],
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
    }, {
        "name": "fused_fwd_k3",
        "route": "cuda",
        "source": K3_SOURCE,
        "replaces": TPU_K3,
        "launches": sum(r["calls"] for r in k3_paths.values()),
        "cuda_launches": sum(r["cuda_launches"] for r in k3_paths.values()),
        "launches_by_path": k3_paths,
        "max_abs_err": max(*big_diffs.values(), big_time["full_batch_diff"],
                           *(r["max_abs_diff"] for r in big_shapes[BIG_CAMPAIGN[0]].values()),
                           *(0.0 if same else math.inf for same in k3_equal.values()),
                           *(r["fused_fwd_k3"]["full_batch_diff"] for r in big_ttimes.values())),
        "max_abs_diff": dict(big_diffs, equal_to_k1=k3_equal,
                             a_bg1z384_ms20_full_batch=big_time["full_batch_diff"],
                             **{f"{c}_{label}": r["max_abs_diff"]
                                for c, rs in big_shapes.items() for label, r in rs.items()}),
        "ms": big_time["ms"],
        "plain_ms": big_time["plain_ms"],
        "bound_ms": big_time["bound_ms"],
        "bound_by": big_time["bound_by"],
        "library_ms": None,  # no PyTorch call computes a BP decode
        "shape": f"bg1z384 MS x20, cn=3, post-trained, batch {BIG_BATCH}",
        "kernel": big_time["kernel"],
        "ptxas": cl_regs,
        "peak_memory_bytes_a": big_main["all_zero"]["peak_memory_bytes"],
        "two_pass_check": two_pass,
        "timing": big_time,
        "decode_path": big_main,
        "campaign": big_camp,
        "campaign_shapes": big_shapes,
        "vs_on_chip_kernels": vs_on_chip,
        "training_forward": {b: r["fused_fwd_k3"] for b, r in big_ttimes.items()},
    }, {
        "name": "fused_bwd_k4",
        "route": "cuda",
        "source": K4_SOURCE,
        "replaces": TPU_K4,
        "kernel": big_ttimes[64]["fused_bwd_k4"]["kernel"],
        "launches": k4_calls,
        "cuda_launches": k4_cuda,
        "cuda_launches_per_call": k4_cuda / max(k4_calls, 1),
        # channel gradients bit for bit against K2 and the twin (0 here); the
        # whole loss and the device-memory plain version at K2's bars
        "max_abs_err": max(big_grads["step_vs_plain_engine"][0],
                           *(d[k][0] for d in k4_diffs.values() for k in ("vs_k2", "vs_plain")),
                           *(r["fused_bwd_k4"]["full_batch_diff"][0] for r in big_ttimes.values())),
        "max_abs_diff": dict(k4_diffs, c_bg1z256_ms10_loss=big_grads,
                             **{f"c_bg1z256_ms10_batch_{b}_vs_twin": r["fused_bwd_k4"][
                                 "full_batch_vs_twin"] for b, r in big_ttimes.items()}),
        "ms": big_ttimes[64]["fused_bwd_k4"]["ms"],
        "plain_ms": big_ttimes[64]["fused_bwd_k4"]["plain_ms"],
        "bound_ms": big_ttimes[64]["fused_bwd_k4"]["bound_ms"],
        "bound_by": big_ttimes[64]["fused_bwd_k4"]["bound_by"],
        "share": big_ttimes[64]["fused_bwd_k4"]["roofline_share"],
        "library_ms": None,  # no PyTorch call computes the adjoint of a BP decode
        "shape": "bg1z256 MS x10, cn=3, batch 64 (path (c)'s step)",
        "kernel_by_path": k4_kernels,
        "ptxas": k4_regs,
        "timing": {b: r["fused_bwd_k4"] for b, r in big_ttimes.items()},
        "train_steps": {b: {k: v for k, v in r.items() if k.endswith("_step")}
                        for b, r in big_ttimes.items()},
        "training": big_train,
    }, {
        "name": "fused_bwd_k4/device-memory",
        "route": "cuda",
        "source": K4_DM_SOURCE,
        "replaces": TPU_K4,
        "kernel": k4_dm["kernel"],
        # its forced case's run (the counters at 0 before it)
        "launches": k4_dm["launches"],
        "cuda_launches": k4_dm["cuda_launches"],
        "cuda_launches_per_call": k4_dm["cuda_launches"] / max(k4_dm["launches"], 1),
        "max_abs_err": k4_dm["diff"][0],
        "max_abs_diff": {f"{k4_dm['code']}_ms10": k4_dm["diff"]},
        "ms": k4_dm["ms"],
        "plain_ms": k4_dm["plain_ms"],
        "bound_ms": k4_dm["bound_ms"],
        "bound_by": k4_dm["bound_by"],
        "share": k4_dm["roofline_share"],
        "library_ms": None,  # no PyTorch call computes the adjoint of a BP decode
        "shape": f"{k4_dm['code']} MS x10, cn=3, batch {k4_dm['batch']} (its forced case)",
        "timing": k4_dm,
    }]}
    # K6 (calls, CUDA launches) by path and direction, each read after its own run
    k6_paths = {}
    for c, r in mm.items():
        k6_paths[f"e_{c}_decode"] = {"fwd": (r["decode_launches"], r["decode_cuda_launches"])}
        k6_paths[f"e_{c}_loss"] = {d: (r["loss_launches"][f"fused_{d}_k6"],
                                       r["loss_cuda_launches"][f"fused_{d}_k6"])
                                   for d in ("fwd", "bwd")}
    for label, (n, c) in (("f_decode", ("decode_launches", "decode_cuda_launches")),
                          ("f_training", ("train_launches", "train_cuda_launches"))):
        k6_paths[label] = {d: (dense[n][f"fused_{d}_k6"], dense[c][f"fused_{d}_k6"])
                           for d in ("fwd", "bwd")}
    camp_f = dense["campaign"]
    k6_paths["f_campaign"] = {"fwd": (camp_f["launches"]["fused_fwd_k6"],
                                      camp_f["cuda_launches"]["fused_fwd_k6"])}

    def k6_count(d, i):
        return sum(v[d][i] for v in k6_paths.values() if d in v)
    head5, head6, head6b = legacy[LEGACY_TIMED], mm["wman_ms5_split3"], mm["bg2_qms_train_int8_bf16"]
    kernels["kernels"] += [{
        "name": "fused_legacy_k5",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_K5,
        "launches": k5_calls,
        "cuda_launches": k5_cuda,
        "max_abs_err": max(*k5_diffs.values(), head5["full_batch_diff"]),
        "max_abs_diff": dict(k5_diffs, wman_ms5_bf16_full_batch=head5["full_batch_diff"]),
        "ms": head5["ms"],
        "plain_ms": head5["plain_ms"],
        "bound_ms": head5["bound_ms"],
        "bound_by": head5["bound_by"],
        "library_ms": None,  # no PyTorch call computes a BP decode
        "shape": f"wman MS x5 cn=3, bf16 routing, batch {MAIN_BATCH}",
        # the instantiations only K5 runs (its float32 routing is roll's)
        "ptxas": {k: v for k, v in fwd_regs.items()
                  if k.split("/")[1] in ("bf16", "legacy_int8")},
        "decode_path": legacy,
    }, {
        "name": "fused_fwd_k6",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_K6_FWD,
        "launches": k6_count("fwd", 0),
        "cuda_launches": k6_count("fwd", 1),
        "launches_by_path": {k: v["fwd"] for k, v in k6_paths.items() if "fwd" in v},
        "max_abs_err": max(*k6_fwd_diffs.values(), head6["full_batch_diff"],
                           dense["vs_plain_512"], dense["train_fwd_vs_plain"],
                           *(r["max_abs_diff"] for r in dense["campaign_shapes"].values()),
                           *(r["train_fwd_diff"] for r in mm.values())),
        "max_abs_diff": dict(k6_fwd_diffs, wman_ms5_split3_full_batch=head6["full_batch_diff"],
                             f_dense_512=dense["vs_plain_512"],
                             f_dense_train_fwd=dense["train_fwd_vs_plain"],
                             **{f"f_dense_campaign_{k}": r["max_abs_diff"]
                                for k, r in dense["campaign_shapes"].items()},
                             **{f"{c}_train_fwd": r["train_fwd_diff"] for c, r in mm.items()}),
        "ms": head6["ms"],
        "plain_ms": head6["plain_ms"],
        "bound_ms": head6["bound_ms"],
        "bound_by": head6["bound_by"],
        "library_ms": None,  # no PyTorch call computes a BP decode
        "shape": f"wman MS x5 cn=3, split-3 routing, batch {MAIN_BATCH}",
        "ptxas": {k: v for k, v in fwd_regs.items() if k.split("/")[1] in ("int8", "split3")},
        "shipped_codes": mm,
        "dense_path": dense,
    }, {
        "name": "fused_bwd_k6",
        "route": "cuda",
        "source": BWD_SOURCE,
        "replaces": TPU_K6_BWD,
        "launches": k6_count("bwd", 0),
        "cuda_launches": k6_count("bwd", 1),
        "launches_by_path": {k: v["bwd"] for k, v in k6_paths.items() if "bwd" in v},
        "max_abs_err": max(dense["bwd_vs_plain"][0],
                           *(d[0] for r in k6_bwd_diffs.values() for k, d in r.items()
                             if k.endswith(("_vs_plain", "_vs_k2")))),
        "max_abs_diff": dict(k6_bwd_diffs, f_dense_train_batch=dense["bwd_vs_plain"],
                             **{f"{c}_timed_batch": r["bwd_vs_plain"] for c, r in mm.items()}),
        "ms": head6b["bwd_ms"],
        "plain_ms": head6b["bwd_plain_ms"],
        "bound_ms": head6b["bwd_bound_ms"],
        "bound_by": head6b["bwd_bound_by"],
        "library_ms": None,  # no PyTorch call computes the adjoint of a BP decode
        "shape": f"bg2_qms_train (BG2 QMS x20, cn vn), int8 routing, bf16 cotangents, "
                 f"batch {MM_TRAIN_BATCH}",
        # per call on each path: (e) at MM_TRAIN_BATCH words, (f) at DENSE_TRAIN_BATCH
        "by_path": dict({f"e_{c}": {k: r[k] for k in ("bwd_ms", "k2_ms", "bwd_bound_ms",
                                                      "bwd_bound_by")} for c, r in mm.items()},
                        f_dense={k: dense[k] for k in ("bwd_ms", "bwd_plain_ms", "bwd_bound_ms",
                                                       "bwd_bound_by")}),
    }, {
        "name": "sol_k7",
        "route": "cuda",
        "source": K7_SOURCE,
        "replaces": TPU_K7,
        "launches": sol["launches"],
        "cuda_launches": sol["cuda_launches"],
        "max_abs_err": k7_diff,
        "ms": sol["launch_ms"],
        "plain_ms": sol["plain_ms"],
        "bound_ms": sol["bound_ms"],
        "bound_by": sol["bound_by"],
        "library_ms": None,  # no PyTorch call computes the chain
        "shape": "[65536, 512] float32, 8 chains of 64 steps",
        "instr_per_s": sol["instr_per_s"],  # 5 counted a step, as scripts/mfu_r4.py counts
        "issued_per_step": sol["issued_per_step"],
        "issued_per_step_from_sass": sol["issued_per_step_from_sass"],
        "sass_counts": sol["sass_counts"],
        "issued_instr_per_s": sol["issued_instr_per_s"],
        "data_sheet_instr_per_s": H100_INSTR_PER_S,
    }]
    # path (h)'s calls of each kernel (its run with the counters at 0); K4's
    # are the device-memory kernel's
    for row in kernels["kernels"]:
        base = "fused_bwd_k4" if row["name"] == "fused_bwd_k4/device-memory" else row["name"]
        if base in HIGH_KERNELS and row["name"] != "fused_bwd_k4":
            row["launches_h"] = high["launches"][base]
            row["cuda_launches_h"] = high["cuda_launches"][base]
    # path (i)'s calls of K1a, K1d and K2 (each step's run with the counters
    # at 0); K1a's on path (j) are the profile CLI's
    for row in kernels["kernels"]:
        if row["name"] in boosted["launches_i"]:
            row["launches_i"] = boosted["launches_i"][row["name"]]
        if row["name"] == "fused_fwd_k1a":
            row["launches_j"] = dai["profile_launches"]["fused_fwd_k1a"]
    k1d_row = next(r for r in kernels["kernels"] if r["name"] == "fused_fwd_k1d")
    k1d_row["boosted_path"] = boosted
    k1d_row["max_abs_diff"]["boosted_post_batch_20"] = boosted["timing"]["fused_fwd_k1d"]["vs_plain"]
    k1d_row["max_abs_err"] = max(k1d_row["max_abs_err"],
                                 boosted["timing"]["fused_fwd_k1d"]["vs_plain"])
    k1d_row["dai_path"] = dai
    k2_row = next(r for r in kernels["kernels"] if r["name"] == "fused_bwd_k2")
    k2_row["high_degree"] = high
    k2_row["max_abs_diff"]["boosted_post_batch_20"] = boosted["timing"]["fused_bwd_k2"]["vs_plain"]
    k2_row["max_abs_err"] = max(k2_row["max_abs_err"], *(
        d[0] for k, d in high["diffs"].items() if k.endswith(("_k2", "_k6_bwd", "_k4"))))
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
