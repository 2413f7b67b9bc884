"""The code of a configuration, read from its files with a loader of its own.

A base graph (``.pcm``: ``#`` comments, then comma-separated rows, -1 = no
edge, else the circulant's shift) lifted by Z gives the flat layouts the
plain decoder uses: edge e in row-major order of the base graph, message
q = e*Z + zc, bit p = n*Z + z.  Check copy (i, zc) of edge (i, n, s) reads
VN copy (n, (zc + s) % Z).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_basegraph(path: str) -> np.ndarray:
    rows = []
    with open(os.path.join(ROOT, path)) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                rows.append([int(v) for v in line.split(",")])
    bg = np.asarray(rows, dtype=np.int64)
    if bg.ndim != 2:
        raise ValueError(f"{path}: not a matrix")
    return bg


def read_gen_matrix(path: str) -> np.ndarray:
    """A bit-packed ``.npz`` generator matrix [K*Z, N*Z] of 0/1."""
    with np.load(os.path.join(ROOT, path)) as data:
        cols = int(data["shape"][1])
        return np.unpackbits(data["packed"], axis=1)[:, :cols].astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Shape:
    """What the work counts read of a code: its sizes and degrees."""

    M: int
    N: int
    Z: int
    E: int
    cn_degrees: tuple
    vn_degrees: tuple

    @property
    def n_bits(self) -> int:
        return self.N * self.Z

    @property
    def rate(self) -> float:
        return (self.N - self.M) / self.N


def shape_of(bg: np.ndarray, Z: int) -> Shape:
    conn = bg != -1
    return Shape(M=bg.shape[0], N=bg.shape[1], Z=int(Z), E=int(conn.sum()),
                 cn_degrees=tuple(int(d) for d in conn.sum(axis=1)),
                 vn_degrees=tuple(int(d) for d in conn.sum(axis=0)))


@dataclasses.dataclass(frozen=True)
class Tables:
    """Index tables of the flat layout on one device."""

    shape: Shape
    D: int  # largest check degree
    route: torch.Tensor  # [E*Z]: the bit each message reads
    vn_gather: torch.Tensor  # [N*Z, dv]: a bit's messages (pads read message 0)
    vn_pad: torch.Tensor  # [N*Z, dv] True on a pad slot
    cn_gather: torch.Tensor  # [M*D*Z]: a check copy's messages by slot (pads read 0)
    cn_pad: torch.Tensor  # [M, D, 1] True on a pad slot
    cn_of_edge: torch.Tensor  # [E]
    slot_of_edge: torch.Tensor  # [E]


def tables(bg: np.ndarray, Z: int, device) -> Tables:
    shape = shape_of(bg, Z)
    M, N, E = shape.M, shape.N, shape.E
    rows, cols = np.nonzero(bg != -1)
    shifts = bg[rows, cols] % Z
    zc = np.arange(Z)
    route = cols[:, None] * Z + (zc[None, :] + shifts[:, None]) % Z
    D = max(shape.cn_degrees)
    dv = max(shape.vn_degrees)
    cn_gather = np.full((M, D), E, np.int64)
    slot = np.zeros(E, np.int64)
    fill = np.zeros(M, np.int64)
    for e, i in enumerate(rows):
        cn_gather[i, fill[i]] = e
        slot[e] = fill[i]
        fill[i] += 1
    # a bit adds its messages in increasing edge order
    vn_gather = np.full((N, Z, dv), E * Z, np.int64)
    for n in range(N):
        for k, e in enumerate(np.nonzero(cols == n)[0]):
            vn_gather[n, :, k] = e * Z + (zc - shifts[e]) % Z

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    vn_pad = vn_gather == E * Z
    cn_pad = cn_gather == E
    cn_flat = np.where(cn_pad, 0, cn_gather)[:, :, None] * Z + zc[None, None, :]
    return Tables(shape=shape, D=D, route=t(route.reshape(-1)),
                  vn_gather=t(np.where(vn_pad, 0, vn_gather).reshape(N * Z, dv)),
                  vn_pad=torch.as_tensor(vn_pad.reshape(N * Z, dv), device=device),
                  cn_gather=t(cn_flat.reshape(-1)),
                  cn_pad=torch.as_tensor(cn_pad[:, :, None], device=device),
                  cn_of_edge=t(rows), slot_of_edge=t(slot))


def config_shape(cfg: dict) -> Shape:
    code = cfg["code"]
    return shape_of(read_basegraph(code["basegraph"]), code["Z"])


def config_tables(cfg: dict, device) -> Tables:
    code = cfg["code"]
    return tables(read_basegraph(code["basegraph"]), code["Z"], device)
