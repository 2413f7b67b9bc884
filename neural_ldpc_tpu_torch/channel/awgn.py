"""AWGN channel + codeword generation on the device.

Codewords (all-zero or through the code's GF(2) generator), BPSK modulation,
noise, LLRs, QMS pre-quantization and puncturing/shortening, driven by an
explicit ``torch.Generator`` on the channel's device (reference
src/boosted_neural_ldpc_decoder/AWGNPassedDatagen.py).  A torch generator
gives other numbers than ``jax.random`` from the same seed; the tests hold
the channel to its moments and feed both packages the same numpy inputs.  A
host numpy generator with the reference's exact RandomState semantics lives
in ``reference_datagen.py``.

Conventions (structs.Convention):
  STANDARD: BPSK bit0 -> +1 (shortened bits pinned to +clip).
  REFERENCE: BPSK bit0 -> -1, matching the reference's inverted mapping
    (AWGNPassedDatagen.py:97-101; shortened bits pinned to -clip, :117-118),
    and the reference's rate K / (N - len(p) - len(s)) in base-graph columns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..codes.protograph import CodeSpec
from ..device import DeviceLike, resolve_device
from ..ops.quantize import qms_quantize_value
from ..structs import Clipping, Convention, Puncture, Shortening


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    snr_db: tuple[float, ...] = (2.0, 2.5, 3.0, 3.5, 4.0)
    puncture: Puncture = Puncture(0, 0)
    shortening: Shortening = Shortening(0, 0)
    allowed_llr_range: Clipping = Clipping(start=-20.0, end=20.0)
    convention: Convention = Convention.STANDARD
    qms_qbit: Optional[int] = None  # pre-quantize channel LLRs when set
    sp_puncture_value: float = 0.0  # reference uses 0.001 for SP (:111-114)
    rate_override: Optional[float] = None


class AWGNChannel:
    """``channel.sample(generator, n_words, sigma_per_word)`` -> (llr, bits).

    Code rate: (K*Z - shortened) / (N*Z - punctured - shortened) in bits
    (``CodeSpec.code_rate``), or ``rate_override``; under the REFERENCE
    convention the reference's K / (N - |puncture_cols| - |short_cols|) in
    base-graph columns (AWGNPassedDatagen.py:47), which counts punctured and
    shortened BITS against base-graph COLUMNS.  Sigma follows from the SNR
    in dB as sqrt(1 / (2 * 10^(snr/10) * rate)).
    """

    def __init__(self, code: CodeSpec, config: ChannelConfig = ChannelConfig(),
                 device: DeviceLike = "cuda"):
        self.code = code
        self.config = config
        self.device = resolve_device(device)
        reference = config.convention == Convention.REFERENCE
        if config.rate_override is not None:
            self.rate = config.rate_override
        elif reference:
            # the degenerate Puncture(0,0)/Shortening(0,0) ranges each count
            # len 1, so the reference's default SNR->sigma mapping uses rate
            # K/(N-2)
            self.rate = float(code.K) / float(
                code.N - len(config.puncture) - len(config.shortening)
            )
        else:
            n_p = len(config.puncture) if config.puncture.start > 0 else 0
            n_s = len(config.shortening) if config.shortening.start > 0 else 0
            self.rate = code.code_rate(n_p, n_s)
        snr = np.asarray(config.snr_db, dtype=np.float64)
        self.sigma = np.sqrt(1.0 / (2.0 * (10.0 ** (snr / 10.0)) * self.rate)).astype(np.float32)
        # f32 on the device: row sums of info @ G are <= K*Z << 2^24, exact
        self._gen_matrix = (
            torch.as_tensor(np.asarray(code.gen_matrix, np.float32), device=self.device)
            if code.gen_matrix is not None else None
        )

        nz = code.n_bits
        mask = np.zeros(nz, dtype=np.float32)
        fill = np.zeros(nz, dtype=np.float32)
        if config.puncture.start > 0:
            mask[config.puncture.start - 1 : config.puncture.end] = 1.0
            fill[config.puncture.start - 1 : config.puncture.end] = config.sp_puncture_value
        if config.shortening.start > 0:
            mask[config.shortening.start - 1 : config.shortening.end] = 1.0
            clip_abs = config.allowed_llr_range.abs
            fill[config.shortening.start - 1 : config.shortening.end] = (
                -clip_abs if reference else clip_abs)
        self._mask = torch.as_tensor(mask, device=self.device)
        self._fill = torch.as_tensor(fill, device=self.device)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the channel's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def encode(self, info_bits: torch.Tensor) -> torch.Tensor:
        """info_bits [B, K*Z] -> codeword bits [B, N*Z] via the systematic
        generator matrix (reference _gen_y, :195-203)."""
        if self._gen_matrix is None:
            raise ValueError("code has no generator matrix; use all-zero codewords")
        prod = info_bits.to(device=self.device, dtype=torch.float32) @ self._gen_matrix
        return torch.remainder(prod, 2.0)

    def random_codewords(self, generator: torch.Generator, n_words: int) -> torch.Tensor:
        info = torch.randint(0, 2, (n_words, self.code.n_info_bits), generator=generator,
                             device=self.device)
        return self.encode(info)

    def modulate(self, bits: torch.Tensor) -> torch.Tensor:
        if self.config.convention == Convention.REFERENCE:
            return 2.0 * bits - 1.0  # bit0 -> -1 (reference :97-101)
        return 1.0 - 2.0 * bits  # bit0 -> +1

    # ------------------------------------------------------------------
    def sample(self, generator: torch.Generator, n_words: int,
               sigma_per_word, all_zero: bool = True):
        """One batch: (llr [B, N, Z], bits [B, N*Z] float32).
        ``sigma_per_word``: [B] noise std per word."""
        if all_zero:
            bits = torch.zeros(n_words, self.code.n_bits, device=self.device)
        else:
            bits = self.random_codewords(generator, n_words)
        sym = self.modulate(bits)
        sigma = torch.as_tensor(sigma_per_word, dtype=torch.float32,
                                device=self.device).reshape(n_words, 1)
        noise = torch.randn(sym.shape, generator=generator, device=self.device)
        llr = 2.0 * (sym + sigma * noise) / (sigma ** 2)
        if self.config.qms_qbit is not None:
            llr = qms_quantize_value(llr, self.config.qms_qbit)
        llr = llr * (1.0 - self._mask) + self._fill * self._mask
        return llr.reshape(n_words, self.code.N, self.code.Z), bits

    def sample_mixed(self, generator: torch.Generator, n_words: int, all_zero: bool = True):
        """Round-robin SNR assignment within the batch — word i gets
        snr_db[i % S] (reference _gendata_mixed, :136-193)."""
        idx = np.arange(n_words) % len(self.sigma)
        return self.sample(generator, n_words, self.sigma[idx], all_zero)

    def sample_at(self, generator: torch.Generator, n_words: int, snr_index: int,
                  all_zero: bool = True):
        """All words at one SNR of the configuration."""
        return self.sample_at_sigma(generator, n_words, float(self.sigma[snr_index]), all_zero)

    def sample_at_sigma(self, generator: torch.Generator, n_words: int, sigma: float,
                        all_zero: bool = True):
        return self.sample(generator, n_words,
                           torch.full((n_words,), float(sigma), device=self.device), all_zero)
