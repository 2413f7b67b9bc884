"""The one generator of the benchmark's inputs, driven by a cell's traffic
parameters and the run's seed.

Words are BPSK over AWGN (bit 0 -> +1), LLR = 2 y / sigma^2, sigma from the
SNR in dB and the design rate in bits: sqrt(1 / (2 * 10^(snr/10) * rate)).
Training batches carry random codewords of the code's generator matrix and
give word i of a batch the SNR snr_db[i % S]; decode batches are all-zero
words at one SNR.  Everything is drawn on the device by one generator
seeded from the run's seed, in a few large calls, so one seed gives the same
inputs and every seed the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.graph import read_gen_matrix


def sigma(snr_db, rate: float) -> np.ndarray:
    snr = np.asarray(snr_db, dtype=np.float64)
    return np.sqrt(1.0 / (2.0 * (10.0 ** (snr / 10.0)) * rate)).astype(np.float32)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _llr(bits, sig, noise):
    return 2.0 * ((1.0 - 2.0 * bits) + sig * noise) / (sig ** 2)


def _quantize_value(x, qbit: int):
    if qbit != 5:
        raise ValueError(f"QMS q={qbit} is not a configuration here")
    return torch.clamp(torch.round(x * 2.0) / 2.0, -7.5, 7.5)


def train_batches(cfg: dict, shape, batch: int, count: int, seed: int, device):
    """``count`` batches of (llr [B, N, Z], bits [B, N*Z]) float32."""
    ch, code = cfg["channel"], cfg["code"]
    g = generator(seed, device)
    nz, words = shape.n_bits, batch * count
    if ch["codewords"] == "random":
        gm = torch.as_tensor(read_gen_matrix(code["gen_matrix"]), dtype=torch.float32,
                             device=device)
        info = torch.randint(0, 2, (words, gm.shape[0]), generator=g, device=device)
        # sums of at most K*Z ones: exact in float32 at any matmul precision
        bits = torch.remainder(info.to(torch.float32) @ gm, 2.0)
    else:
        bits = torch.zeros(words, nz, device=device)
    sig = sigma(ch["snr_db"], shape.rate)
    sig_word = torch.as_tensor(sig[np.arange(batch) % len(sig)], device=device).repeat(count)
    noise = torch.randn(words, nz, generator=g, device=device)
    llr = _llr(bits, sig_word[:, None], noise)
    if ch.get("qms_quantize"):
        llr = _quantize_value(llr, cfg["decoder"]["qms_qbit"])
    llr = llr.reshape(count, batch, shape.N, shape.Z)
    bits = bits.reshape(count, batch, nz)
    return [(llr[k], bits[k]) for k in range(count)]


def all_zero_batches(shape, snr_db: float, batch: int, count: int, seed: int, device):
    """``count`` batches of all-zero words' LLRs [B, N*Z] at one SNR."""
    g = generator(seed, device)
    sig = float(sigma([snr_db], shape.rate)[0])
    out = []
    for _ in range(count):
        noise = torch.randn(batch, shape.n_bits, generator=g, device=device)
        out.append(_llr(0.0, sig, noise))
    return out
