"""Monte-Carlo BER/FER campaign engine on one device.

Port of ``neural_ldpc_tpu/eval/montecarlo.py``: per batch, sample -> decode
-> count, with early stopping per SNR point at a target frame-error count,
counters kept on the device and read once per window, syndrome-gated early
exit with an exact redo of overflowing windows, the auto-guard that keeps
early exit only where it is faster, and checkpointable state (counters and
generator state).

Engines: ``"fused"`` decodes through the hand-written CUDA kernel
(``ops/cuda``: final-APP K1a, stats and syndrome K1b, in-kernel sampling
K1c, and with ``fused_all_iterations`` the per-iteration stream K1d, which
gives per-iteration counts; for codes the on-chip kernel cannot hold, the
device-memory kernel K3 in the same modes, with the channel always read
from ``AWGNChannel`` as JAX's big-code campaigns read it; STANDARD-convention
decoders only); ``"xla"`` through the plain decoder
``BoostedNeuralDecoder.apply`` (the name is the JAX engine's, kept for the
CLI).  On CPU tensors the fused
engine runs the kernels' plain versions.

Random numbers: one key per batch from a CPU ``torch.Generator(seed)``
(``utils/rng.py``).  Its low 32 bits seed the in-kernel sampler, whose
counter-hash stream equals the JAX kernel's integer for integer; the key
also seeds the channel's device generator for batches sampled outside the
kernel.  The per-batch steps take both seeds as arguments, so a test can hand
them the seeds the JAX campaign derives.

Data parallelism: pass a ``parallel.Mesh``.  Each rank folds its rank into
the batch's key (``utils.rng.fold_in``, as JAX folds in the axis index),
samples its ``B/n`` words and decodes them on the engine it would use alone
(the channel read from ``AWGNChannel``: in-kernel sampling is off under a
mesh, as in JAX).  At each window flush the counters and escalations are
summed over the ranks and the per-batch failure maximum is max-reduced, so
every rank holds the global counters and takes the same decisions: an
overflowing window is redone on every rank, the auto-guard compares the
slowest rank's times, and ``run`` stops every rank at the same batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..channel.awgn import AWGNChannel
from ..eval.metrics import hard_decision
from ..parallel.mesh import all_reduce_max, all_reduce_sum, barrier, replicate
from ..structs import Convention
from ..utils.checkpoint import CheckpointManager
from ..utils.profiling import CAMPAIGN_BATCH, CAMPAIGN_ESCALATION, CAMPAIGN_FLUSH, span
from ..utils.rng import channel_seed, fold_in, kernel_seed, next_key


@dataclasses.dataclass
class CampaignConfig:
    batch_size: int = 1024
    max_words_per_snr: int = 1_000_000
    min_frame_errors: int = 100  # stop an SNR point once reached (0 = never)
    all_zero: bool = True
    seed: int = 2042
    checkpoint_dir: Optional[str] = None
    checkpoint_every_batches: int = 200
    # decode engine: "xla" = the plain decoder; "fused" = the CUDA kernel;
    # "auto" = fused on a CUDA device when the code fits the kernel
    engine: str = "auto"
    # per-iteration statistics from the fused engine (the K1d stream)
    fused_all_iterations: bool = False
    # read the counters every N batches; the device runs ahead meanwhile
    sync_every_batches: int = 1
    # syndrome-gated early exit: decode every word with this many iterations
    # first; words whose decisions satisfy every lifted check are counted
    # from phase 1, the rest are compacted and re-decoded from scratch with
    # the full unroll.  None = always the full unroll.
    early_exit_iters: Optional[int] = None
    # escalation slots per batch; a window in which a batch had more
    # failures is redone exactly, batch by batch, with the full unroll.
    # None = max(4096, batch_size // 64)
    early_exit_capacity: Optional[int] = None
    # time early exit against the full unroll once per SNR point and keep
    # the faster; probe batches' counters are folded in
    early_exit_auto_guard: bool = True
    early_exit_probe_batches: int = 8
    # sample the AWGN channel inside the decode kernel (stats-only all-zero
    # campaigns on the on-chip kernel): "off" | "on" | "auto" (= on where
    # the campaign is one and the code fits; "on" raises where it does not)
    kernel_channel_sampling: str = "off"
    # all-zero final-only campaigns ride the stats-only kernel; False = the
    # APP + count composition instead
    fused_stats_mode: bool = True
    # extra kwargs for the fused decoder constructors (e.g. bt)
    fused_kwargs: Optional[dict] = None


def _counts(bits: torch.Tensor, outputs: torch.Tensor, include=None,
            convention: Convention = Convention.STANDARD) -> torch.Tensor:
    """int64 [2, I]: bit errors and frame errors per iteration of outputs
    [I, B, NZ] (or [B, NZ]) against bits [B, NZ], decided under
    ``convention``; ``include`` [B] masks words out."""
    if outputs.dim() == 2:
        outputs = outputs[None]
    errs = hard_decision(outputs, convention) != bits[None].to(torch.int32)
    if include is not None:
        errs &= include[None, :, None]
    return torch.stack([errs.sum(dim=(1, 2)), errs.any(dim=2).sum(dim=1)])


def _stats_counts(ok, be, fe, include=None) -> torch.Tensor:
    """int64 [2, 1] from per-word stats, over the words ``include`` marks."""
    be = be.to(torch.int64)
    if include is not None:
        be, fe = be * include, fe & include
    return torch.stack([be.sum(), fe.sum()])[:, None]


def _compact_idx(ok1: torch.Tensor, K: int):
    """Failed rows into K slots: slot j holds the (j+1)-th failed row
    (searchsorted over the failure prefix sum).  Returns (idx [K] int32,
    valid [K] bool, number of failures) on the device."""
    fail = ~ok1
    c = torch.cumsum(fail.to(torch.int32), 0, dtype=torch.int32)
    slots = torch.arange(1, K + 1, dtype=torch.int32, device=ok1.device)
    idx = torch.searchsorted(c, slots, out_int32=True).clamp_max_(fail.shape[0] - 1)
    nf = c[-1]
    valid = torch.arange(K, device=ok1.device) < nf
    return idx, valid, nf


class MonteCarloCampaign:
    """Sweep the channel's SNR list, decode, and accumulate error counters.

    Results: dict snr_db -> {words, per-iteration ber/fer lists}.  State can
    be saved and restored mid-campaign (counters + generator state)."""

    def __init__(
        self,
        decoder,
        params,
        channel: AWGNChannel,
        config: CampaignConfig = CampaignConfig(),
        mesh=None,
    ):
        self.decoder = decoder
        self.channel = channel
        self.cfg = config
        self.mesh = mesh
        self.device = decoder.device
        if channel.device != self.device:
            raise ValueError(f"channel on {channel.device}, decoder on {self.device}")
        self.rows = config.batch_size  # this rank's words a batch
        if mesh is not None:
            if mesh.device != self.device:
                raise ValueError(f"mesh rank on {mesh.device}, decoder on {self.device}")
            if config.batch_size % mesh.size:
                raise ValueError(f"batch_size {config.batch_size} not divisible by "
                                 f"{mesh.size} mesh devices")
            self.rows = config.batch_size // mesh.size
        self.params = params
        self.n_iters = decoder.config.n_iterations
        self.fused = self._resolve_engine() == "fused"
        self.ee = config.early_exit_iters is not None
        if self.ee:
            if not self.fused:
                raise ValueError("early_exit_iters requires the fused engine")
            if config.fused_all_iterations:
                raise ValueError("early exit produces final-iteration stats only")
            if mesh is not None and not config.all_zero:
                raise ValueError("mesh early exit rides the stats-only kernel "
                                 "(all_zero campaigns); drop the mesh, the "
                                 "early_exit_iters, or set all_zero")
            if not (0 < config.early_exit_iters < self.n_iters):
                raise ValueError("early_exit_iters must be in (0, n_iterations)")
        if config.kernel_channel_sampling not in ("off", "on", "auto"):
            raise ValueError("kernel_channel_sampling: off | on | auto")
        if config.kernel_channel_sampling == "on" and (
                mesh is not None or not config.all_zero or config.fused_all_iterations):
            raise ValueError("kernel_channel_sampling='on' needs the single-"
                             "device stats mode (all_zero, final-only, no "
                             "mesh); use 'auto' to fall back silently")
        S = len(channel.sigma)
        n_cols = 1 if self.fused and not config.fused_all_iterations else self.n_iters
        self.gen = torch.Generator().manual_seed(config.seed)
        self.words = np.zeros(S, np.int64)
        self.bit_errors = np.zeros((S, n_cols), np.float64)
        self.frame_errors = np.zeros((S, n_cols), np.float64)
        self.escalations = np.zeros(S, np.int64)  # early-exit phase-1 failures
        self.redone_words = np.zeros(S, np.int64)  # words of windows redone exactly
        self._ee_choice: dict = {}  # per-SNR-point auto-guard decisions
        if mesh is not None:
            self.params = replicate(params, mesh)
        self._build_step()

    def _fused_eligible(self) -> bool:
        from ..ops.cuda.fused_train import fused_capacity_ok

        # the kernels implement the STANDARD convention; a REFERENCE
        # decoder runs the plain engine
        return (self.decoder.config.convention != Convention.REFERENCE
                and fused_capacity_ok(self.decoder.graph))

    def _resolve_engine(self) -> str:
        if self.cfg.engine == "xla":
            return "xla"
        if self.cfg.engine == "fused":
            if not self._fused_eligible():
                raise ValueError(
                    "decoder/config not eligible for the fused kernel: the kernels implement "
                    "the STANDARD convention, and a code the on-chip kernels cannot hold "
                    "needs E <= 1024 (fused_capacity_ok; the device-memory kernels route "
                    "by roll only)")
            return "fused"
        if self.cfg.engine != "auto":
            raise ValueError(f"unknown engine {self.cfg.engine!r}")
        return "fused" if self.device.type == "cuda" and self._fused_eligible() else "xla"

    def _sample(self, gseed: int, sigma: float, all_zero: bool):
        ch = self.channel
        return ch.sample_at_sigma(ch.generator(gseed), self.rows, sigma, all_zero)

    def _build_step(self):
        """Bake the per-batch steps ``step(kseed, gseed, sigma)``:
        ``self._exact_step`` (full unroll, always; returns int64 [2, cols]
        counts on the device), ``self._ee_step`` (early exit, None unless
        configured; returns (counts, failures)), and the window-overflow
        threshold ``self._ee_cap`` (per rank under a mesh).  The fused
        decoders the steps launch are in ``self.decoders``: "full", and with
        early exit "phase1" and "escalation"."""
        from ..ops.cuda import FusedMinsumDecoder
        from ..structs import DecoderType, SharingMode

        cfg, decoder = self.cfg, self.decoder
        B = self.rows
        self._ee_step = None
        cap = (cfg.early_exit_capacity if cfg.early_exit_capacity is not None
               else max(4096, cfg.batch_size // 64))
        self._ee_cap = K = min(cap, B) if self.mesh is None else max(1, min(cap, B))
        self.kernel_sampling = False
        self.decoders = {}

        if not self.fused:
            @torch.no_grad()
            def step(kseed, gseed, sigma):
                llr, bits = self._sample(gseed, sigma, cfg.all_zero)
                return _counts(bits, decoder.apply(self.params, llr),
                               convention=decoder.config.convention)

            self._exact_step = self._step = step
            return

        fkw = cfg.fused_kwargs or {}

        def full_unroll(**kw):
            return FusedMinsumDecoder.from_decoder(decoder, self.params, **kw, **fkw)

        stats_mode = cfg.all_zero and cfg.fused_stats_mode and not cfg.fused_all_iterations
        full = None
        # under a mesh "auto" reads the channel, as JAX's mesh campaign does
        if cfg.kernel_channel_sampling != "off" and stats_mode and self.mesh is None:
            try:
                full = full_unroll(emit_stats=True, sample_channel=True)
            except ValueError:
                # a code the on-chip kernel cannot hold samples outside the
                # kernel, as JAX's campaign falls back
                # (neural_ldpc_tpu/eval/montecarlo.py:333-342)
                if cfg.kernel_channel_sampling == "on":
                    raise
        self.kernel_sampling = full is not None
        if self.kernel_sampling:
            def exact_step(kseed, gseed, sigma):
                return _stats_counts(*full.sample_stats(kseed, sigma, B))
        elif stats_mode:
            full = full_unroll(emit_stats=True)

            def exact_step(kseed, gseed, sigma):
                llr, _ = self._sample(gseed, sigma, True)
                return _stats_counts(*full(llr))
        else:
            full = full_unroll(all_iterations=cfg.fused_all_iterations)

            def exact_step(kseed, gseed, sigma):
                llr, bits = self._sample(gseed, sigma, cfg.all_zero)
                return _counts(bits, full(llr))

        self._exact_step = exact_step
        self.decoders = {"full": full}
        if not self.ee:
            self._step = exact_step
            return

        # ---- syndrome-gated early exit ----
        # phase 1: truncated unroll; words whose decisions satisfy every
        # check are counted from it.  phase 2: failures, compacted into K
        # slots, are re-decoded from scratch with the full unroll (the same
        # words: re-sampled in the kernel from their original index, or
        # gathered from the batch).  Overflowing windows are redone exactly
        # by flush() with the full step above.
        I1 = cfg.early_exit_iters
        dcfg = decoder.config
        with torch.no_grad():
            cn_w, ucn_w, vn_w = decoder._expanded_weights(self.params)
        if dcfg.sharing.ucn == SharingMode.NONE:
            ucn_w = None

        def _sl(w):
            return None if w is None else w[:I1]

        def truncated(**kw):
            return FusedMinsumDecoder(
                decoder.graph, n_iterations=I1,
                clip=(dcfg.allowed_llr_range.start, dcfg.allowed_llr_range.end),
                qms_qbit=dcfg.qms_qbit if dcfg.decoder_type == DecoderType.QMS else None,
                cn_weights=_sl(cn_w), vn_weights=_sl(vn_w), ucn_weights=_sl(ucn_w),
                sum_product=dcfg.decoder_type == DecoderType.SP, device=self.device, **kw)

        if self.kernel_sampling:
            phase1 = truncated(emit_stats=True, sample_channel=True, bt=full.bt)
            esc = full_unroll(emit_stats=True, sample_channel=True, sample_at_idx=full.bt)

            def ee_step(kseed, gseed, sigma):
                ok1, be1, fe1 = phase1.sample_stats(kseed, sigma, B)
                idx, valid, nf = _compact_idx(ok1, K)
                with span(CAMPAIGN_ESCALATION):
                    c2 = _stats_counts(*esc.stats_sampled_at(kseed, sigma, idx), include=valid)
                return _stats_counts(ok1, be1, fe1, include=ok1) + c2, nf
        elif stats_mode:
            phase1, esc = truncated(emit_stats=True), full

            def ee_step(kseed, gseed, sigma):
                llr, _ = self._sample(gseed, sigma, True)
                ok1, be1, fe1 = phase1(llr)
                idx, valid, nf = _compact_idx(ok1, K)
                with span(CAMPAIGN_ESCALATION):
                    c2 = _stats_counts(*esc(llr[idx.long()]), include=valid)
                return _stats_counts(ok1, be1, fe1, include=ok1) + c2, nf
        else:
            phase1, esc = truncated(emit_syndrome=True), full

            def ee_step(kseed, gseed, sigma):
                llr, bits = self._sample(gseed, sigma, cfg.all_zero)
                app1, ok1 = phase1(llr)
                idx, valid, nf = _compact_idx(ok1, K)
                with span(CAMPAIGN_ESCALATION):
                    rows = idx.long()
                    c2 = _counts(bits[rows], esc(llr[rows]), include=valid)
                return _counts(bits, app1, include=ok1) + c2, nf

        self.decoders.update(phase1=phase1, escalation=esc)
        self._ee_step = self._step = ee_step

    # ------------------------------------------------------------------
    # Window accumulation: counts stay on the device across a window and
    # are read once per flush, so dispatch never waits on the card.
    def _window(self, s: int, sigma: float, step=None, is_ee=None):
        camp = self
        if step is None:
            step, is_ee = self._point_step(s, sigma)

        class _Window:
            """Device-side accumulator for one read window.  Words are
            counted at flush time, with the error counts, so saved state
            stays consistent.  In early-exit mode a window in which some
            batch failed more words than the capacity is redone exactly,
            batch by batch, with the full step on the same seeds."""

            def __init__(self):
                self.seeds = []
                self.acc = None
                self.nf = None  # (max, sum) of the batches' phase-1 failures

            def __len__(self):
                return len(self.seeds)

            def dispatch(self, seeds):
                with span(CAMPAIGN_BATCH):
                    r = step(*seeds, sigma)
                if is_ee:
                    r, nf = r
                    nf = torch.stack([nf, nf]).to(torch.int64)
                    self.nf = nf if self.nf is None else torch.stack(
                        [torch.maximum(self.nf[0], nf[0]), self.nf[1] + nf[1]])
                self.acc = r if self.acc is None else self.acc + r
                self.seeds.append(seeds)

            def flush(self):
                if not self.seeds:
                    return
                with span(CAMPAIGN_FLUSH):
                    c = self.acc
                    if is_ee:
                        both = camp._sum(torch.cat([c.reshape(-1), self.nf[1:]]))
                        nf_max = (self.nf[:1] if camp.mesh is None
                                  else all_reduce_max(self.nf[:1], camp.mesh))
                        host = torch.cat([both, nf_max]).cpu()  # one read
                        c, nf_sum, nf_max = host[:-2].reshape(c.shape), int(host[-2]), int(host[-1])
                        camp.escalations[s] += nf_sum
                        # every rank holds the global maximum, so all redo or none
                        if nf_max > camp._ee_cap:
                            c = camp._sum(sum(camp._exact_step(*sd, sigma) for sd in self.seeds))
                            camp.redone_words[s] += len(self.seeds) * camp.cfg.batch_size
                        c = c.cpu()
                    else:
                        c = camp._sum(c).cpu()
                    c = c.numpy().astype(np.float64)
                    camp.words[s] += len(self.seeds) * camp.cfg.batch_size
                    camp.bit_errors[s] += c[0]
                    camp.frame_errors[s] += c[1]
                    self.seeds = []
                    self.acc = self.nf = None

        return _Window()

    def _sum(self, counts: torch.Tensor) -> torch.Tensor:
        """The counts summed over the ranks (int64 keeps the sums exact)."""
        return counts if self.mesh is None else all_reduce_sum(counts, self.mesh)

    def _next_seeds(self):
        key = next_key(self.gen)
        if self.mesh is not None:
            key = fold_in(key, self.mesh.rank)
        return kernel_seed(key), channel_seed(key)

    def _point_step(self, s: int, sigma: float):
        """(step, is_ee) for one SNR point: the early-exit step when
        configured, the exact step otherwise; the auto-guard probes both
        once per point and keeps the faster."""
        if not self.ee:
            return self._exact_step, False
        if not self.cfg.early_exit_auto_guard:
            return self._ee_step, True
        if s not in self._ee_choice:
            self._ee_choice[s] = self._probe_ee(s, sigma)
        if self._ee_choice[s]:
            return self._ee_step, True
        return self._exact_step, False

    def _probe_ee(self, s: int, sigma: float) -> bool:
        """Time a short burst of early-exit and exact steps at this sigma;
        the counters of every probe batch (the warm-up batch too) are
        folded into the campaign state."""
        n = max(self.cfg.early_exit_probe_batches, 1)
        wps = {}
        for name, step, is_ee in (("ee", self._ee_step, True),
                                  ("full", self._exact_step, False)):
            w = self._window(s, sigma, step=step, is_ee=is_ee)
            w.dispatch(self._next_seeds())
            w.flush()  # warm-up, off the clock
            t0 = time.perf_counter()
            for _ in range(n):
                w.dispatch(self._next_seeds())
            w.flush()  # waits on the counter read
            elapsed = time.perf_counter() - t0
            if self.mesh is not None:
                # ranks timed alone could choose differently, and their
                # collectives would stop matching: all take the slowest's time
                elapsed = float(all_reduce_max(torch.tensor(
                    [elapsed], dtype=torch.float64, device=self.device), self.mesh))
            wps[name] = n * self.cfg.batch_size / elapsed
        return wps["ee"] >= wps["full"]

    def run_snr_point(self, s: int, batches: int = 64) -> None:
        """Advance one SNR point by ``batches`` batches, reading the
        counters every ``sync_every_batches``."""
        w = self._window(s, float(self.channel.sigma[s]))
        for _ in range(batches):
            w.dispatch(self._next_seeds())
            if len(w) >= max(self.cfg.sync_every_batches, 1):
                w.flush()
        w.flush()

    def run(self, verbose: bool = True):
        cfg = self.cfg
        ckpt = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        for s, sigma in enumerate(self.channel.sigma):
            batches_done = 0
            w = self._window(s, float(sigma))
            # dispatched-but-unread words count toward the budget
            while self.words[s] + len(w) * cfg.batch_size < cfg.max_words_per_snr:
                if cfg.min_frame_errors and self.frame_errors[s, -1] >= cfg.min_frame_errors:
                    break
                w.dispatch(self._next_seeds())
                batches_done += 1
                if len(w) >= max(cfg.sync_every_batches, 1):
                    w.flush()
                if ckpt and batches_done % cfg.checkpoint_every_batches == 0:
                    w.flush()
                    self.save_state(ckpt)
            w.flush()
            if verbose and (self.mesh is None or self.mesh.rank == 0):
                r = self.results()[float(self.channel.config.snr_db[s])]
                print(f"SNR {self.channel.config.snr_db[s]:.2f} dB: "
                      f"{int(self.words[s])} words, BER {r['ber'][-1]:.3e}, "
                      f"FER {r['fer'][-1]:.3e}")
        if ckpt:
            self.save_state(ckpt)
        return self.results()

    def results(self):
        out = {}
        nz = self.channel.code.n_bits
        for s, snr in enumerate(self.channel.config.snr_db):
            w = max(int(self.words[s]), 1)
            out[float(snr)] = {
                "words": int(self.words[s]),
                "ber": (self.bit_errors[s] / (w * nz)).tolist(),
                "fer": (self.frame_errors[s] / w).tolist(),
                "final_iter_only": self.fused and not self.cfg.fused_all_iterations,
            }
        return out

    # ------------------------------------------------------------------
    def save_state(self, ckpt: CheckpointManager, name: str = "mc_campaign"):
        """Write the counters and the generator state.  Under a mesh every
        rank calls it: rank 0 writes (the counters are global), and no rank
        returns before the file is complete."""
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.save(
                name, self.params, rng_state=self.gen.get_state(),
                extra_arrays={
                    "words": self.words,
                    "bit_errors": self.bit_errors,
                    "frame_errors": self.frame_errors,
                    "escalations": self.escalations,
                    "redone_words": self.redone_words,
                },
            )
        if self.mesh is not None:
            barrier(self.mesh)

    def restore_state(self, ckpt: CheckpointManager, name: str = "mc_campaign"):
        params, _, _, rng_state, extras = ckpt.load(name, self.params)
        if rng_state is not None and not isinstance(rng_state, torch.Tensor):
            raise ValueError(
                f"{name}: the state holds a JAX threefry key; its word stream "
                "cannot be continued by the port's generator")
        self.params = params
        if rng_state is not None:
            self.gen.set_state(rng_state)
        self.words = extras["words"].astype(np.int64)
        self.bit_errors = extras["bit_errors"]
        self.frame_errors = extras["frame_errors"]
        self.escalations = extras.get("escalations", np.zeros_like(self.words))
        self.redone_words = extras.get("redone_words", np.zeros_like(self.words))
        self._ee_choice = {}
        self._build_step()  # the fused decoders hold the params
