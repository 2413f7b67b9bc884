"""ctypes bindings for the native host runtime (src/ldpc_host.cc).

Port of ``neural_ldpc_tpu/native``: the port keeps its own copy of the C++
source and builds it with the JAX package's flags into this package's
``native/build/`` at first use, so it never loads the JAX package's
library, and the two libraries give the same bytes.  This is host code:
the host tier (``channel/host_datagen.py``) makes numpy batches and needs no
card.

Every function has a pure-numpy fallback with identical semantics (the AWGN
sampler's RNG is reimplemented bit-exactly in vectorized numpy), so the
framework runs without a compiler; ``available()`` reports which path is
live.  The shared library is built on demand (g++ -O3 -march=native -shared)
and cached under ``native/build/``; ``make`` in this directory builds it too.

The reference has no native tier at all (SURVEY.md §2.2) — its datagen is an
O(B^2) numpy vstack loop (boosted_neural_ldpc_decoder/AWGNPassedDatagen.py:
120-121,179-180).  Here the host pipeline is C++ with index-addressed
counter-based RNG: llr[word w, bit n] depends only on (seed, word_offset + w,
n), making billion-word Monte-Carlo campaigns restartable and
thread/batch-size invariant.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "build", "libldpc_host.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False

N_THREADS = min(os.cpu_count() or 1, 16)


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        src = os.path.join(_DIR, "src", "ldpc_host.cc")
        # built under a name of this process's own and renamed into place,
        # so that processes building at once never load a half-written file
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
                 "-shared", "-o", tmp, src, "-lpthread"],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, _LIB_PATH)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.ldpc_host_abi_version.restype = ctypes.c_int
    lib.ldpc_host_abi_version.argtypes = []
    if lib.ldpc_host_abi_version() != 1:
        return None

    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    i32 = ctypes.c_int

    for fn in (lib.gf2_encode, lib.gf2_syndrome_ok, lib.awgn_llr, lib.count_errors):
        fn.restype = None
    lib.gf2_encode.argtypes = [u8p, u64p, u8p, i64, i64, i64, i32]
    lib.gf2_syndrome_ok.argtypes = [u8p, u64p, u8p, i64, i64, i64, i32]
    lib.awgn_llr.argtypes = [ctypes.c_void_p, f64p, f32p, i64, i64, u64, u64, i32, i32]
    lib.count_errors.argtypes = [
        f32p, ctypes.c_void_p, i64, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.c_void_p, i32,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the compiled library is loadable (builds it if needed)."""
    return _ensure_built() is not None


def pack_rows(mat: np.ndarray) -> np.ndarray:
    """Bit-pack a binary matrix row-wise into uint64 words (bit n of row k at
    word n//64, bit n%64)."""
    mat = np.ascontiguousarray(mat.astype(np.uint8) & 1)
    K, N = mat.shape
    W = (N + 63) // 64
    padded = np.zeros((K, W * 64), np.uint8)
    padded[:, :N] = mat
    bits = padded.reshape(K, W, 64).astype(np.uint64)
    return (bits << np.arange(64, dtype=np.uint64)).sum(axis=2, dtype=np.uint64)


# ---------------------------------------------------------------------------
# GF(2) ops
# ---------------------------------------------------------------------------
def gf2_encode(info: np.ndarray, gen_matrix_packed: np.ndarray, N: int) -> np.ndarray:
    """Codewords = info @ G mod 2.  info: [B, K] 0/1; G packed via pack_rows."""
    info = np.ascontiguousarray(info.astype(np.uint8))
    B, K = info.shape
    lib = _ensure_built()
    out = np.empty((B, N), np.uint8)
    if lib is not None:
        lib.gf2_encode(info, np.ascontiguousarray(gen_matrix_packed), out,
                       B, K, N, N_THREADS)
        return out
    # numpy fallback: unpack and matmul mod 2
    W = gen_matrix_packed.shape[1]
    g_bits = (
        (gen_matrix_packed[:, :, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    ).reshape(K, W * 64)[:, :N].astype(np.uint8)
    return (info.astype(np.int64) @ g_bits.astype(np.int64) % 2).astype(np.uint8)


def gf2_syndrome_ok(bits: np.ndarray, h_packed: np.ndarray, N: int) -> np.ndarray:
    """ok[b] = 1 iff every parity check is satisfied."""
    bits = np.ascontiguousarray(bits.astype(np.uint8))
    B = bits.shape[0]
    M = h_packed.shape[0]
    lib = _ensure_built()
    if lib is not None:
        ok = np.empty(B, np.uint8)
        lib.gf2_syndrome_ok(bits, np.ascontiguousarray(h_packed), ok, B, M, N, N_THREADS)
        return ok
    W = h_packed.shape[1]
    h_bits = (
        (h_packed[:, :, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    ).reshape(M, W * 64)[:, :N].astype(np.int64)
    syn = bits.astype(np.int64) @ h_bits.T % 2
    return (syn.sum(axis=1) == 0).astype(np.uint8)


# ---------------------------------------------------------------------------
# Counter-based AWGN sampler (numpy mirror of the C++ splitmix64/Box-Muller)
# ---------------------------------------------------------------------------
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x + _SM_GAMMA
        x = (x ^ (x >> np.uint64(30))) * _SM_M1
        x = (x ^ (x >> np.uint64(27))) * _SM_M2
        return x ^ (x >> np.uint64(31))


def _u01(bits: np.ndarray) -> np.ndarray:
    return ((bits >> np.uint64(11)) + np.uint64(1)).astype(np.float64) * (1.0 / 9007199254740992.0)


def _gauss_pairs(seed: int, idx: np.ndarray):
    with np.errstate(over="ignore"):
        seed = np.uint64(seed)
        a = _splitmix64(seed ^ _splitmix64(idx * np.uint64(2) + np.uint64(1)))
        b = _splitmix64(seed ^ _splitmix64(idx * np.uint64(2) + np.uint64(2)))
    r = np.sqrt(-2.0 * np.log(_u01(a)))
    t = 2.0 * np.pi * _u01(b)
    return r * np.cos(t), r * np.sin(t)


def awgn_llr(
    codewords: Optional[np.ndarray],
    sigma: np.ndarray,
    N: int,
    seed: int,
    word_offset: int = 0,
    bit0_plus: bool = True,
) -> np.ndarray:
    """Channel LLRs for a batch: BPSK + AWGN + llr = 2x/sigma^2.

    codewords: [B, N] 0/1 or None (all-zero).  sigma: [B] noise std.
    bit0_plus False reproduces the reference's inverted mapping
    (AWGNPassedDatagen.py:97-101).  Deterministic in (seed, word_offset + b, n).
    """
    sigma = np.ascontiguousarray(np.asarray(sigma, np.float64))
    B = sigma.shape[0]
    lib = _ensure_built()
    if lib is not None:
        out = np.empty((B, N), np.float32)
        cw = None
        if codewords is not None:
            cw = np.ascontiguousarray(codewords.astype(np.uint8))
        lib.awgn_llr(
            cw.ctypes.data if cw is not None else None,
            sigma, out, B, N, np.uint64(seed) & np.uint64(2**64 - 1),
            np.uint64(word_offset), int(bool(bit0_plus)), N_THREADS,
        )
        return out
    # numpy fallback (bit-exact with the C++ path)
    half = (N + 1) // 2
    word_key = (np.uint64(word_offset) + np.arange(B, dtype=np.uint64)) * np.uint64(half)
    idx = word_key[:, None] + np.arange(half, dtype=np.uint64)[None, :]
    g0, g1 = _gauss_pairs(seed, idx)
    noise = np.empty((B, half * 2), np.float64)
    noise[:, 0::2] = g0
    noise[:, 1::2] = g1
    noise = noise[:, :N]
    y = np.zeros((B, N), np.float64) if codewords is None else codewords.astype(np.float64)
    x = (1.0 - 2.0 * y) if bit0_plus else (2.0 * y - 1.0)
    x = x + sigma[:, None] * noise
    return (2.0 / sigma[:, None] ** 2 * x).astype(np.float32)


def count_errors(llr: np.ndarray, expected: Optional[np.ndarray] = None):
    """(bit_errors, frame_errors, frame_mask) with bit = (llr < 0)."""
    llr = np.ascontiguousarray(llr.astype(np.float32))
    B, N = llr.shape
    lib = _ensure_built()
    if lib is not None:
        be = ctypes.c_int64()
        fe = ctypes.c_int64()
        mask = np.empty(B, np.uint8)
        exp = None
        if expected is not None:
            exp = np.ascontiguousarray(expected.astype(np.uint8))
        lib.count_errors(
            llr, exp.ctypes.data if exp is not None else None, B, N,
            ctypes.byref(be), ctypes.byref(fe), mask.ctypes.data, N_THREADS,
        )
        return int(be.value), int(fe.value), mask.astype(bool)
    bits = (llr < 0).astype(np.uint8)
    exp = np.zeros_like(bits) if expected is None else expected.astype(np.uint8)
    errs = (bits != exp).sum(axis=1)
    return int(errs.sum()), int((errs > 0).sum()), errs > 0
