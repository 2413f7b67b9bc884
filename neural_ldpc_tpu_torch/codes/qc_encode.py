"""Quasi-cyclic generator matrices: derive, store, and expand in QC form.

A dense generator for the full BG1-scale lift is 220 MB
(K·Z × N·Z = 8448 × 26112 at Z = 384) — unshippable and slow to derive with
generic elimination.  But a QC-LDPC code's generator is itself quasi-cyclic:
the parity response to info bit (block i, offset z) is the z-rotation of the
response to (i, 0).  One Z-bit polynomial per (parity block, info block)
pair therefore determines the whole matrix — [M, K, Z] bits ≈ 49 KB packed
at BG1 scale, expanded to the dense form on demand.

Derivation solves H_p · X = H_i · e_{i,0} over GF(2) once (bit-packed
Gauss-Jordan, codes/gf2.py) with all K unit right-hand sides.  The reference
ships a precomputed dense generator only for BG2/Z=16
(resources/gen_matrix_bg2_z16.txt, consumed at
src/boosted_neural_ldpc_decoder/AWGNPassedDatagen.py:200-203)
and has no derivation tooling at all.

Lifted-H convention (codes/tanner.py lifted_parity_check_matrix): proto edge
(i, j) with shift s connects CN copy (i, z) to VN copy (j, (z+s) % Z), i.e.
H[i·Z + z, j·Z + (z+s) % Z] = 1.
"""

from __future__ import annotations

import numpy as np

from .gf2 import gf2_solve


def qc_generator_polys(basegraph: np.ndarray, Z: int) -> np.ndarray:
    """Derive the QC generator polynomials for a full-rank-H code.

    Info blocks are the first K = N - M base columns (systematic); parity
    blocks the remaining M.  Returns uint8 [M, K, Z]: ``polys[m, i]`` is the
    parity of block m when info bit (i, 0) is the only one set; the response
    to info bit (i, z) is ``np.roll(polys[m, i], z)``.

    Raises ValueError when the lifted H is singular at this Z (rank is
    lift-dependent).
    """
    from .tanner import TannerGraph

    g = TannerGraph.from_basegraph(basegraph, Z)
    M, K = g.M, g.N - g.M
    z = np.arange(Z)
    Hp = np.zeros((M * Z, M * Z), np.uint8)
    rhs = np.zeros((M * Z, K), np.uint8)
    for e in range(g.E):
        i = int(g.cn_of_edge[e])
        j = int(g.vn_of_edge[e])
        s = int(g.shift_of_edge[e])
        if j >= K:
            Hp[i * Z + z, (j - K) * Z + (z + s) % Z] = 1
        else:
            # column j·Z + 0 of H: row i·Z + z with (z+s) % Z == 0
            rhs[i * Z + (-s) % Z, j] ^= 1
    X = gf2_solve(Hp, rhs)  # [M*Z, K]: parity vector per unit info word
    return np.ascontiguousarray(X.reshape(M, Z, K).transpose(0, 2, 1))


def expand_qc_generator(polys: np.ndarray, Z: int) -> np.ndarray:
    """Expand [M, K, Z] QC polynomials to the dense systematic generator
    [K·Z, N·Z] (info blocks first, identity; then circulant parity blocks)."""
    M, K, Zp = polys.shape
    if Zp != Z:
        raise ValueError(f"polys lift {Zp} != requested {Z}")
    G = np.zeros((K * Z, (K + M) * Z), np.uint8)
    r = np.arange(Z)
    circ_idx = (r[None, :] - r[:, None]) % Z  # rows z, cols r -> (r - z) % Z
    for i in range(K):
        G[i * Z + r, i * Z + r] = 1
    for m in range(M):
        base = (K + m) * Z
        for i in range(K):
            G[i * Z:(i + 1) * Z, base:base + Z] = polys[m, i][circ_idx]
    return G


def pack_qc_polys(polys: np.ndarray) -> np.ndarray:
    return np.packbits(polys, axis=2, bitorder="little")


def unpack_qc_polys(packed: np.ndarray, Z: int) -> np.ndarray:
    out = np.unpackbits(packed, axis=2, bitorder="little")
    return np.ascontiguousarray(out[:, :, :Z])
