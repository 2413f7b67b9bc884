"""Host-side (CPU) data generation on the native C++ runtime.

Port of ``neural_ldpc_tpu/channel/host_datagen.py``.  Counterpart of the
on-device ``AWGNChannel`` for pipelines that want the host to produce
batches — e.g. overlapping datagen with device compute, verifying device
results, or running the channel where no accelerator exists.  Uses the
bit-packed GF(2) encoder and the counter-based AWGN sampler from
``neural_ldpc_tpu_torch.native`` (the port's own C++ library, with a
bit-exact numpy fallback).  Batches are numpy arrays, byte for byte the JAX
package's; a caller moves them to the card.

Unlike the reference's ``AWGNPassedDatagen`` (stateful ``RandomState`` pair +
O(B^2) vstack batch assembly, boosted_neural_ldpc_decoder/AWGNPassedDatagen.py:
51-52,120-121), every word here is addressed by an absolute 64-bit word index:
``HostDatagen(seed).batch(offset, n)`` always returns the same words for the
same (seed, offset), regardless of batch size, thread count, or how many
batches were drawn before — the property that makes checkpointed Monte-Carlo
campaigns resumable (SURVEY.md §5 failure detection).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .. import native
from ..codes.protograph import CodeSpec
from ..ops.quantize import qms_quantize_value
from ..structs import Convention
from .awgn import AWGNChannel, ChannelConfig


@dataclasses.dataclass
class HostBatch:
    llr: np.ndarray  # [B, N, Z] float32
    bits: np.ndarray  # [B, N*Z] uint8


class HostDatagen:
    """Deterministic host batch generator.

    ``sigma`` assignment mirrors AWGNChannel.sample_mixed: word with absolute
    index w gets snr_db[w % S] — so host and campaign bookkeeping agree on
    which SNR any word used, independent of batching.
    """

    def __init__(self, code: CodeSpec, config: ChannelConfig = ChannelConfig(), seed: int = 0):
        self.code = code
        self.config = config
        self.seed = int(seed)
        # reuse AWGNChannel's rate/sigma/mask bookkeeping (single source of
        # truth), built on the CPU: the host tier needs no card
        self._dev = AWGNChannel(code, config, device="cpu")
        self.sigma = np.asarray(self._dev.sigma, np.float64)
        self._mask = self._dev._mask.numpy()
        self._fill = self._dev._fill.numpy()
        self._gp = None
        if code.gen_matrix is not None:
            self._gp = native.pack_rows(np.asarray(code.gen_matrix))

    # ------------------------------------------------------------------
    def codewords(self, word_offset: int, n_words: int, all_zero: bool = True) -> np.ndarray:
        nz = self.code.n_bits
        if all_zero:
            return np.zeros((n_words, nz), np.uint8)
        if self._gp is None:
            raise ValueError("code has no generator matrix; use all-zero codewords")
        K = self.code.n_info_bits
        # info bits from the same counter-based RNG family (stream 1)
        idx = (np.uint64(word_offset) + np.arange(n_words, dtype=np.uint64))[:, None] * np.uint64(
            (K + 63) // 64
        ) + np.arange((K + 63) // 64, dtype=np.uint64)[None, :]
        words = native._splitmix64(np.uint64(self.seed ^ 0x1D) ^ native._splitmix64(idx))
        bits = (
            (words[:, :, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
        ).reshape(n_words, -1)[:, :K].astype(np.uint8)
        return native.gf2_encode(bits, self._gp, nz)

    def batch(
        self,
        word_offset: int,
        n_words: int,
        all_zero: bool = True,
        snr_index: Optional[int] = None,
    ) -> HostBatch:
        """Words [word_offset, word_offset + n_words) of the campaign stream.

        snr_index None = mixed round-robin by absolute word index; an int pins
        every word to that SNR (separate RNG offset space per SNR is NOT
        needed — the noise counter is the absolute word index either way).
        """
        nz = self.code.n_bits
        bits = self.codewords(word_offset, n_words, all_zero)
        if snr_index is None:
            widx = (word_offset + np.arange(n_words)) % len(self.sigma)
            sigma = self.sigma[widx]
        else:
            sigma = np.full(n_words, self.sigma[snr_index])
        llr = native.awgn_llr(
            None if all_zero else bits,
            sigma,
            nz,
            seed=self.seed,
            word_offset=word_offset,
            bit0_plus=self.config.convention != Convention.REFERENCE,
        )
        if self.config.qms_qbit is not None:
            llr = np.asarray(qms_quantize_value(llr, self.config.qms_qbit))
        llr = llr * (1.0 - self._mask) + self._fill * self._mask
        return HostBatch(
            llr=llr.astype(np.float32).reshape(n_words, self.code.N, self.code.Z),
            bits=bits,
        )

    def verify_codewords(self, bits: np.ndarray, graph) -> np.ndarray:
        """Syndrome-check a batch against the lifted H (native popcount path)."""
        hp = native.pack_rows(graph.lifted_parity_check_matrix())
        return native.gf2_syndrome_ok(bits, hp, self.code.n_bits)

    def as_train_datagen(self, all_zero: bool = True, start_offset: int = 0):
        """Adapter for ``Trainer(host_datagen=...)``: a callable drawing
        successive word windows from the deterministic stream (the native C++
        channel feeds training instead of the on-device generator)."""
        cursor = [int(start_offset)]

        def datagen(batch_size: int):
            b = self.batch(cursor[0], batch_size, all_zero=all_zero)
            cursor[0] += batch_size
            return b.llr, b.bits.astype(np.float32)

        return datagen
