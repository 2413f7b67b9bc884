"""GF(2) linear algebra for code construction.

The reference ships a generator matrix only for BG2/Z=16
(resources/gen_matrix_bg2_z16.txt); its wman code can therefore only be run
with all-zero codewords (train/train_BoostedNeuralLDPCDecoder.py:96-98).
This module closes that gap: ``generator_from_parity_check`` derives a
systematic-up-to-column-permutation generator matrix for ANY full-rank-H
QC-LDPC code via GF(2) Gaussian elimination, so random-codeword training and
evaluation work for every loaded code.
"""

from __future__ import annotations

import numpy as np


def gf2_row_reduce(H: np.ndarray):
    """Reduced row-echelon form of a binary matrix over GF(2).

    Returns (R, pivot_cols): R is the RREF (uint8), pivot_cols the pivot
    column index per non-zero row.
    """
    R = (np.asarray(H, dtype=np.uint8) & 1).copy()
    m, n = R.shape
    pivots = []
    row = 0
    for col in range(n):
        if row >= m:
            break
        sel = np.nonzero(R[row:, col])[0]
        if sel.size == 0:
            continue
        pivot = row + sel[0]
        if pivot != row:
            R[[row, pivot]] = R[[pivot, row]]
        # eliminate the column everywhere else
        others = np.nonzero(R[:, col])[0]
        others = others[others != row]
        R[others] ^= R[row]
        pivots.append(col)
        row += 1
    return R[:row], pivots


def generator_from_parity_check(H: np.ndarray) -> np.ndarray:
    """Generator matrix G [K, N] with H @ G.T == 0 (mod 2) and K = N - rank(H).

    The information positions are the non-pivot columns of H's RREF (so G is
    systematic on those positions: G[:, info_cols] is the identity).  Works
    for any binary H, including rank-deficient ones.
    """
    H = (np.asarray(H, dtype=np.uint8) & 1)
    _, n = H.shape
    R, pivot_cols = gf2_row_reduce(H)
    rank = len(pivot_cols)
    info_cols = [c for c in range(n) if c not in set(pivot_cols)]
    K = n - rank
    assert len(info_cols) == K

    # For each pivot row r (pivot column p): x_p = sum over info cols c with
    # R[r, c] = 1 of x_c.  Build G rows as codewords with one info bit set.
    G = np.zeros((K, n), dtype=np.uint8)
    for k, c in enumerate(info_cols):
        G[k, c] = 1
        for r, p in enumerate(pivot_cols):
            if R[r, c]:
                G[k, p] = 1
    return G


def rank_gf2(H: np.ndarray) -> int:
    return len(gf2_row_reduce(H)[1])


def gf2_solve(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Solve ``A @ X = B (mod 2)`` for square invertible A ([n, n]), B [n, k].

    Bit-packed Gauss-Jordan (rows live as uint8 bit vectors), so the
    BG1-scale n = 17664 solve is minutes, not hours; raises ValueError if A
    is singular over GF(2).
    """
    A = np.asarray(A, dtype=np.uint8) & 1
    B = np.asarray(B, dtype=np.uint8) & 1
    n = A.shape[0]
    if A.shape != (n, n) or B.shape[0] != n:
        raise ValueError(f"shape mismatch: A {A.shape}, B {B.shape}")
    k = B.shape[1]
    pad = (-n) % 8  # keep B byte-aligned in the packed augmentation
    parts = [A] + ([np.zeros((n, pad), np.uint8)] if pad else []) + [B]
    P = np.packbits(np.concatenate(parts, axis=1), axis=1, bitorder="little")
    for col in range(n):
        byte, bit = col >> 3, np.uint8(1 << (col & 7))
        nz = np.nonzero(P[col:, byte] & bit)[0]
        if nz.size == 0:
            raise ValueError("matrix is singular over GF(2)")
        piv = col + int(nz[0])
        if piv != col:
            P[[col, piv]] = P[[piv, col]]
        mask = (P[:, byte] & bit).astype(bool)
        mask[col] = False
        np.bitwise_xor(P, P[col], out=P, where=mask[:, None])
    start = (n + pad) >> 3
    X = np.unpackbits(P[:, start:], axis=1, bitorder="little")
    return np.ascontiguousarray(X[:, :k])
