"""Host-side numpy data generator with the reference's exact semantics.

Port of ``neural_ldpc_tpu/channel/reference_datagen.py``; it is numpy in
both packages, so the same seeds give the same arrays.  Reproduces
src/boosted_neural_ldpc_decoder/AWGNPassedDatagen.py word for word
(behaviorally): seeded ``RandomState`` pair (:51-52), per-word generation with
round-robin SNR in ``mix_snr`` mode (:136-193), inverted BPSK mapping
(:97-101), QMS pre-quantization (:106-107,:165-166), puncturing (SP gets
0.001, :110-114) and shortening (:117-118), and rate K/(N-p-s) (:47).  Used
for differential tests and for byte-identical training-data replay; the
production path is the on-device ``AWGNChannel``.  It generates one word at
a time, because its ``RandomState`` call order is the parity: tens of
thousands of words take host seconds.

Also provides the Dai-package generator (src/neural_ldpc_decoder/
AWGNPassedDatagen.py) including its two quirks — rate (N-M)/(N-2) (:34) and
the ``-1 ** (1 - y)`` precedence bug that maps every symbol to -1 (:74,
verified by execution; dormant for all-zero codewords) — behind
``emulate_bpsk_bug`` (default False = fixed).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from numpy.random import RandomState

from ..ops.quantize import qms_quantize_value
from ..structs import Clipping, DecoderType, Puncture, Shortening


class ReferenceAWGNDatagen:
    """Drop-in behavioral equivalent of the boosted reference's
    AWGNPassedDatagen (callable with gentype 'per_snr' | 'mix_snr')."""

    def __init__(
        self,
        N: int,
        M: int,
        snr_db: np.ndarray,
        awgn_noise_seed: int = 2042,
        wordgen_random_seed: int = 1074,
        x_dtype=np.float32,
        y_dtype=np.int64,
        gen_matrix: Optional[np.ndarray] = None,
        puncturing: Puncture = Puncture(0, 0),
        shortening: Shortening = Shortening(0, 0),
        allowed_llr_range: Clipping = Clipping(start=-20.0, end=20.0),
    ):
        self.N, self.M, self.K = N, M, N - M
        self.snr_db = np.asarray(snr_db, dtype=np.float64)
        self.code_rate = 1.0 * self.K / (N - len(puncturing) - len(shortening))
        self.snr_sigma = np.sqrt(1.0 / (2.0 * (10.0 ** (self.snr_db / 10.0)) * self.code_rate))
        self._awgn_noise_random = RandomState(awgn_noise_seed)
        self._wordgen_random = RandomState(wordgen_random_seed)
        self.x_dtype, self.y_dtype = x_dtype, y_dtype
        self.gen_matrix = gen_matrix
        self.puncturing, self.shortening = puncturing, shortening
        self.allowed_llr_range = allowed_llr_range

    def __call__(self, gentype: str = "per_snr", *args, **kwargs):
        if gentype == "per_snr":
            return self._gendata(*args, per_snr=True, **kwargs)
        if gentype == "mix_snr":
            return self._gendata(*args, per_snr=False, **kwargs)
        raise AttributeError('attribute `gentype` must be "per_snr" or "mix_snr".')

    def _gen_y(self, Z: int, is_y_all_zero: bool) -> np.ndarray:
        if is_y_all_zero:
            return np.zeros((1, self.N * Z), dtype=self.y_dtype)
        if self.gen_matrix is None:
            raise ValueError("gen_matrix must be provided when is_y_all_zero is False")
        info = self._wordgen_random.randint(0, 2, size=(1, self.K * Z))
        return np.dot(info, self.gen_matrix) % 2

    def _gendata(
        self,
        word_length: int,
        Z: int,
        is_y_all_zero: bool = True,
        decoding_type: DecoderType = DecoderType.MS,
        decoder_qms_qbit: int = 5,
        per_snr: bool = False,
    ):
        if word_length <= 0:
            raise ValueError("word_length must be positive integer")
        xs, ys = [], []
        for w in range(word_length):
            # mix_snr: round-robin through the SNR list; per_snr: the
            # reference's counter bug means only snr_sigma[0] is ever used
            # (verified, AWGNPassedDatagen.py:90-125) — reproduced here.
            sf = self.snr_sigma[w % len(self.snr_sigma)] if not per_snr else self.snr_sigma[0]
            y_i = self._gen_y(Z, is_y_all_zero)
            noise = self._awgn_noise_random.normal(0.0, 1.0, y_i.shape)
            x_p = noise * sf + (-1.0) ** (1 - y_i)  # bit0 -> -1 (reference :97-101)
            x_llr = 2.0 * x_p / (sf ** 2)
            if decoding_type == DecoderType.QMS:
                x_llr = qms_quantize_value(x_llr, decoder_qms_qbit)
            if self.puncturing.start > 0:
                v = 0.001 if decoding_type == DecoderType.SP else 0.0
                x_llr[0, self.puncturing.start - 1 : self.puncturing.end] = v
            if self.shortening.start > 0:
                x_llr[0, self.shortening.start - 1 : self.shortening.end] = (
                    -self.allowed_llr_range.abs
                )
            xs.append(x_llr.astype(self.x_dtype))
            ys.append(y_i)
        X = np.concatenate(xs, axis=0).reshape(word_length, self.N, Z)
        Y = np.concatenate(ys, axis=0)
        return X, Y


class ReferenceNeuralDatagen:
    """Behavioral equivalent of the Dai-package generator
    (src/neural_ldpc_decoder/AWGNPassedDatagen.py): returns one (X, Y) array
    pair PER SNR (a list each, :49-87)."""

    def __init__(
        self,
        N: int,
        M: int,
        snr_db: np.ndarray,
        awgn_noise_seed: int = 2042,
        wordgen_random_seed: int = 1074,
        x_dtype=np.float32,
        y_dtype=np.int64,
        gen_matrix: Optional[np.ndarray] = None,
        emulate_bpsk_bug: bool = False,
    ):
        self.N, self.M, self.K = N, M, N - M
        self.snr_db = np.asarray(snr_db, dtype=np.float64)
        self.code_rate = 1.0 * (N - M) / (N - 2)  # reference :34 (two implied punctures)
        self.snr_sigma = np.sqrt(1.0 / (2.0 * (10.0 ** (self.snr_db / 10.0)) * self.code_rate))
        self._awgn_noise_random = RandomState(awgn_noise_seed)
        self._wordgen_random = RandomState(wordgen_random_seed)
        self.x_dtype, self.y_dtype = x_dtype, y_dtype
        self.gen_matrix = gen_matrix
        self.emulate_bpsk_bug = emulate_bpsk_bug

    def __call__(self, word_length: int, Z: int, is_y_all_zero: bool = True):
        if word_length <= 0:
            raise ValueError("word_length must be positive integer")
        xs, ys = [], []
        for sf in self.snr_sigma:
            if is_y_all_zero:
                y_i = np.zeros((word_length, self.N * Z), dtype=self.y_dtype)
            else:
                if self.gen_matrix is None:
                    raise ValueError("gen_matrix must be provided when is_y_all_zero is False")
                info = self._wordgen_random.randint(0, 2, size=(word_length, self.K * Z))
                y_i = np.dot(info.astype(self.y_dtype), self.gen_matrix) % 2
            noise = self._awgn_noise_random.normal(0.0, 1.0, size=y_i.shape)
            if self.emulate_bpsk_bug:
                sym = -np.ones_like(y_i, dtype=np.float64)  # reference :74 (-1**(1-y) == -1)
            else:
                sym = (-1.0) ** (1 - y_i)
            x_llr = (2.0 * (noise * sf + sym) / (sf ** 2)).astype(self.x_dtype)
            xs.append(x_llr)
            ys.append(y_i)
        return xs, ys
