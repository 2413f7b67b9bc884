"""Two-stage boosted error-floor training pipeline (Kwak et al.,
arXiv:2310.07194).

Port of ``neural_ldpc_tpu/training/boosted_pipeline.py``.  The reference
ships the *machinery* for this workflow — fixed iterative nodes, temporal
weight sharing, ``fixed_iterative_nodes_init_weight`` freezing
(BoostedNeuralLDPCDecoder.py:264-334,:498-503) — but nothing that runs it end to end.
This module runs it:

  stage 1  train the BASE decoder (iterations 0..base_iters-1) on the normal
           mixed-SNR channel;
  collect  run the trained base decoder over fresh channel words and harvest
           the words it FAILS to correct (the error-floor sample set);
  stage 2  extend the decoder to base_iters + post_iters iterations, seed the
           first base_iters weight rows from stage 1 and freeze them
           (fixed_iterative_nodes_init_weight = base_iters), then train the
           post-decoder iterations on the collected uncorrected words with the
           loss restricted to the post iterations.

The decoders live on the channel's device.  On the card the harvest decodes
through the forward kernel (``FusedMinsumDecoder``, K1a) wherever the code
is eligible, and both stages train through whatever ``TrainConfig.engine``
names (``"fused"``: K1d and K2).  The uncorrected-word pool is numpy on the
host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..channel.awgn import AWGNChannel
from ..codes.tanner import TannerGraph
from ..eval.metrics import hard_decision
from ..models.boosted_decoder import BoostedDecoderConfig, BoostedNeuralDecoder
from ..structs import SharingMode
from ..utils.rng import channel_seed, next_key
from .train_loop import TrainConfig, Trainer


@dataclasses.dataclass
class BoostedPipelineConfig:
    base_iters: int = 20  # Delta_1 (reference train/…:141 iter_step)
    post_iters: int = 5  # Delta_2 (reference train/…:140 fixed_init)
    collect_words: int = 2048  # error-floor sample budget
    collect_batch_size: int = 1024
    collect_snr_index: int = -1  # channel SNR used for harvesting (-1 = highest)
    max_collect_batches: int = 2000
    seed: int = 911
    # fraction of each post-training batch drawn from the uncorrected-word
    # pool; the rest are fresh channel words.  Training the post iterations on
    # failures alone overfits their distribution (the decoder learns to
    # distrust the channel and then breaks easy words); mixing keeps the
    # easy-word behavior anchored while the pool supplies the error-floor
    # signal.
    pool_mix_ratio: float = 0.5
    # UCN sharing mode for the EXTENDED decoder (None = keep the base
    # config's).  The Kwak recipe hinges on this: post-iteration corrections
    # ride the unsatisfied-check weights, so converged words (no unsatisfied
    # checks) are untouched; the UCN rows of the frozen base iterations are
    # seeded from the base CN weights so base behavior is preserved exactly
    # on satisfied checks and near-exactly on unsatisfied ones.
    post_ucn_sharing: Optional[int] = 2  # SharingMode.NODE_ITER
    # train ONLY the UCN weights in the post stage (post CN/VN rows stay at
    # their neutral init of 1.0, i.e. plain min-sum): converged words have no
    # unsatisfied checks, so neutral post iterations cannot disturb them,
    # while corrections flow exclusively through the UCN path.
    post_train_ucn_only: bool = True


class BoostedPipeline:
    def __init__(
        self,
        graph: TannerGraph,
        channel: AWGNChannel,
        base_config: BoostedDecoderConfig,
        base_train: TrainConfig,
        post_train: TrainConfig,
        pipeline: BoostedPipelineConfig = BoostedPipelineConfig(),
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: not ported yet (data parallelism, ROADMAP Queue 1 item 11)")
        if base_config.n_iterations != pipeline.base_iters:
            raise ValueError("base_config.n_iterations must equal pipeline.base_iters")
        self.graph = graph
        self.channel = channel
        self.base_config = base_config
        self.base_train = base_train
        # gate post_train_ucn_only on the EFFECTIVE extended config: a
        # post_ucn_sharing of None keeps the base config's UCN mode, which may
        # itself enable UCN sharing
        effective_ucn = (
            pipeline.post_ucn_sharing
            if pipeline.post_ucn_sharing is not None
            else base_config.sharing.ucn
        )
        if pipeline.post_train_ucn_only and effective_ucn == SharingMode.NONE:
            raise ValueError(
                "post_train_ucn_only requires UCN sharing in the extended "
                "decoder (set post_ucn_sharing or enable it in base_config)"
            )
        self.post_train = dataclasses.replace(
            post_train,
            training_iter_start=pipeline.base_iters,
            training_iter_end=pipeline.base_iters + pipeline.post_iters,
            train_only_params=(
                ("weight_ucn",) if pipeline.post_train_ucn_only
                else post_train.train_only_params
            ),
        )
        self.cfg = pipeline
        self.mesh = mesh

        self.base_decoder = BoostedNeuralDecoder(graph, base_config, device=channel.device)
        self.post_decoder = BoostedNeuralDecoder(graph, self.extended_config(),
                                                 device=channel.device)

    def extended_config(self) -> BoostedDecoderConfig:
        sharing = self.base_config.sharing
        if self.cfg.post_ucn_sharing is not None:
            sharing = dataclasses.replace(sharing, ucn=self.cfg.post_ucn_sharing)
        return dataclasses.replace(
            self.base_config,
            n_iterations=self.cfg.base_iters + self.cfg.post_iters,
            fixed_iterative_nodes_init_weight=self.cfg.base_iters,
            sharing=sharing,
        )

    # ------------------------------------------------------------------
    def transfer_base_params(self, base_params) -> dict:
        """Seed the extended decoder: rows [0, base_iters) copied from the
        trained base, post rows at their init values.

        A UCN leaf the base didn't have gets its frozen rows seeded from the
        base CN weights (broadcast across its row width), so the base
        iterations behave identically on satisfied AND unsatisfied checks."""
        ext = self.post_decoder.init_params()
        out = {}
        nb = self.cfg.base_iters

        def rows(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.post_decoder.device)

        for k, v in ext.items():
            if k in base_params:
                base_rows = rows(base_params[k])
                v[: base_rows.shape[0]] = base_rows
            elif k == "weight_ucn" and "weight_cn" in base_params:
                cn_rows = rows(base_params["weight_cn"])[:nb]
                if cn_rows.shape[1] not in (1, v.shape[1]):
                    raise ValueError(
                        f"cannot seed UCN rows of width {v.shape[1]} from base "
                        f"CN rows of width {cn_rows.shape[1]}; use matching "
                        "sharing granularities (or scalar ITER cn) so the "
                        "frozen base behaves identically"
                    )
                v[:nb] = cn_rows.expand(nb, v.shape[1])
            out[k] = v
        return out

    # ------------------------------------------------------------------
    def collect_uncorrected_words(self, params, key: Optional[torch.Generator] = None,
                                  decoder=None, verbose=True):
        """Harvest channel words the (base) decoder fails on — the training
        set for the post decoder.  Returns numpy (llr [W, N, Z], bits
        [W, NZ]).  ``key`` is the CPU generator the per-batch keys come from
        (default: seeded with ``cfg.seed``).

        On a CUDA decoder whose code the kernels take (``fused_capacity_ok``)
        the batches decode through ``FusedMinsumDecoder`` (K1a); on the CPU,
        or for a code they do not take, through the plain decoder."""
        from ..ops.cuda import FusedMinsumDecoder, fused_capacity_ok

        cfg = self.cfg
        decoder = decoder or self.base_decoder
        gen = key if key is not None else torch.Generator().manual_seed(cfg.seed)
        snr_idx = cfg.collect_snr_index % len(self.channel.sigma)
        convention = decoder.config.convention

        if decoder.device.type == "cuda" and fused_capacity_ok(decoder.graph):
            decode_final = FusedMinsumDecoder.from_decoder(decoder, params)
        else:
            def decode_final(llr):
                return decoder.apply(params, llr)[-1]

        llrs, bit_rows = [], []
        collected = 0
        for _ in range(cfg.max_collect_batches):
            if collected >= cfg.collect_words:
                break
            g = self.channel.generator(channel_seed(next_key(gen)))
            llr, bits = self.channel.sample_at(
                g, cfg.collect_batch_size, snr_idx,
                all_zero=self.base_train.is_y_all_zero,
            )
            with torch.no_grad():
                fail = (hard_decision(decode_final(llr), convention)
                        != bits.to(torch.int32)).any(dim=1)
            # gather the failed rows on the device before fetching them
            idx = torch.nonzero(fail).squeeze(1)
            if idx.numel():
                llrs.append(llr.index_select(0, idx).cpu().numpy())
                bit_rows.append(bits.index_select(0, idx).cpu().numpy())
                collected += int(idx.numel())
        if collected == 0:
            raise RuntimeError(
                "no uncorrected words found — raise the SNR index or word budget"
            )
        llr = np.concatenate(llrs)[: cfg.collect_words]
        bits = np.concatenate(bit_rows)[: cfg.collect_words]
        if verbose:
            print(f"collected {len(llr)} uncorrected words at "
                  f"SNR {self.channel.config.snr_db[snr_idx]} dB")
        return llr, bits

    # ------------------------------------------------------------------
    def make_post_datagen(self, llr_pool, bits_pool, rng):
        """Host datagen for stage 2: ``pool_mix_ratio`` of each batch from the
        uncorrected pool (indices from the numpy ``rng``), the rest fresh
        channel words from a generator seeded ``seed + 1``; float32 numpy,
        as ``Trainer``'s ``host_datagen`` takes it."""
        gen = torch.Generator().manual_seed(self.cfg.seed + 1)

        def datagen(batch_size):
            n_pool = int(batch_size * self.cfg.pool_mix_ratio)
            idx = rng.integers(0, len(llr_pool), size=n_pool)
            parts_llr, parts_bits = [llr_pool[idx]], [bits_pool[idx]]
            n_fresh = batch_size - n_pool
            if n_fresh > 0:
                g = self.channel.generator(channel_seed(next_key(gen)))
                llr_f, bits_f = self.channel.sample_mixed(
                    g, n_fresh, all_zero=self.base_train.is_y_all_zero
                )
                parts_llr.append(llr_f.cpu().numpy())
                parts_bits.append(bits_f.cpu().numpy())
            return (
                np.concatenate(parts_llr).astype(np.float32),
                np.concatenate(parts_bits).astype(np.float32),
            )

        return datagen

    # ------------------------------------------------------------------
    def run(self, base_params: Optional[dict] = None, verbose: bool = True):
        """Execute the full pipeline; returns (base_params, extended_params,
        report)."""
        report = {}

        # stage 1: base decoder
        if base_params is None:
            trainer = Trainer(self.base_decoder, self.channel, self.base_train)
            base_params, _, s1 = trainer.train()
            report["stage1"] = s1

        # collect error-floor words
        llr_pool, bits_pool = self.collect_uncorrected_words(base_params,
                                                             verbose=verbose)
        report["collected_words"] = int(len(llr_pool))

        # stage 2: post decoder on the pool mixed with fresh channel words
        params = self.transfer_base_params(base_params)
        rng = np.random.default_rng(self.cfg.seed)
        bs = self.post_train.batch_size
        pool_datagen = self.make_post_datagen(llr_pool, bits_pool, rng)

        if int(bs * self.cfg.pool_mix_ratio) > len(llr_pool):
            raise ValueError("post batch pool share exceeds collected pool")
        trainer2 = Trainer(self.post_decoder, self.channel, self.post_train,
                           host_datagen=pool_datagen)
        params, _, s2 = trainer2.train(params=params)
        report["stage2"] = s2
        return base_params, params, report
