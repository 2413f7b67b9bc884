"""Protograph / QC-LDPC code definitions and loaders.

Replaces the reference's implicit ``np.loadtxt`` protograph loading
(reference: train/train_BoostedNeuralLDPCDecoder.py:92-93) with a first-class
code registry.  Base graphs are stored as ``.pcm`` files: ``#`` comment header
followed by comma-separated integer rows, ``-1`` meaning "no edge" and any
other value the cyclic shift of the lifted circulant (taken mod Z downstream,
matching reference src/boosted_neural_ldpc_decoder/ConnectingMatrix.py:88).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

_RESOURCE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "resources")


def load_basegraph(path: str) -> np.ndarray:
    """Load a protograph base matrix from a ``.pcm`` file (or legacy tab-separated txt)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            sep = "," if "," in line else None  # legacy files are whitespace/tab separated
            rows.append([int(v) for v in (line.split(sep) if sep else line.split())])
    bg = np.asarray(rows, dtype=np.int64)
    if bg.ndim != 2:
        raise ValueError(f"base graph in {path!r} is not a matrix")
    return bg


def load_gen_matrix(path: str) -> np.ndarray:
    """Load a generator matrix: ``.npz`` (bit-packed) or comma-separated text."""
    if path.endswith(".npz"):
        data = np.load(path)
        shape = tuple(int(v) for v in data["shape"])
        return np.unpackbits(data["packed"], axis=1)[:, : shape[1]].astype(np.int64)
    return np.loadtxt(path, dtype=np.int64, delimiter=",")


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """A lifted QC-LDPC code: protograph + lifting factor (+ optional generator matrix).

    Attributes mirror the quantities the reference derives ad hoc
    (N/M base-graph dims, Z lifting factor; reference
    src/boosted_neural_ldpc_decoder/ConnectingMatrix.py:39-53).
    """

    name: str
    basegraph: np.ndarray  # [M, N] ints, -1 = no edge
    Z: int
    gen_matrix: Optional[np.ndarray] = None  # [K*Z, N*Z] binary, systematic

    def __post_init__(self):
        if self.basegraph.ndim != 2:
            raise ValueError("basegraph must be 2D")
        if self.Z <= 0:
            raise ValueError("Z must be positive")
        if self.gen_matrix is not None:
            K, N = self.K * self.Z, self.N * self.Z
            if self.gen_matrix.shape != (K, N):
                raise ValueError(
                    f"gen_matrix shape {self.gen_matrix.shape} != ({K}, {N}) for {self.name}"
                )

    @property
    def M(self) -> int:
        return self.basegraph.shape[0]

    @property
    def N(self) -> int:
        return self.basegraph.shape[1]

    @property
    def K(self) -> int:
        return self.N - self.M

    @property
    def n_bits(self) -> int:
        """Lifted codeword length N*Z."""
        return self.N * self.Z

    @property
    def n_checks(self) -> int:
        return self.M * self.Z

    @property
    def n_info_bits(self) -> int:
        return self.K * self.Z

    def code_rate(self, n_punctured_bits: int = 0, n_shortened_bits: int = 0) -> float:
        """Design rate counted in bits: (K*Z - short) / (N*Z - punct - short).

        Shortened positions are known-zero info bits, so they leave the
        numerator as well as the transmitted length.  The reference computes
        K/(N - len(punct) - len(short)) with N in base-graph COLUMNS but
        puncture/shortening lengths in BITS
        (src/boosted_neural_ldpc_decoder/AWGNPassedDatagen.py:47 vs the bit
        ranges applied at :110-118) — that goes negative for any real range.
        All formulas agree in the unpunctured/unshortened case the reference
        exercises; we use the dimensionally consistent one.
        """
        return float(self.n_info_bits - n_shortened_bits) / float(
            self.n_bits - n_punctured_bits - n_shortened_bits
        )

    def with_derived_generator(self) -> "CodeSpec":
        """Return a copy whose generator matrix is derived from the lifted H
        via GF(2) elimination (codes/gf2.py).

        Capability beyond the reference: its wman code ships no generator
        matrix and is therefore restricted to all-zero codewords
        (train/train_BoostedNeuralLDPCDecoder.py:96-98); this enables
        random-codeword training/eval for every code.
        """
        import dataclasses

        from .gf2 import generator_from_parity_check
        from .tanner import TannerGraph

        H = TannerGraph.from_basegraph(self.basegraph, self.Z).lifted_parity_check_matrix()
        G = generator_from_parity_check(H)
        if G.shape[0] != self.n_info_bits:
            raise ValueError(
                f"H has rank {self.n_bits - G.shape[0]} (deficient); derived "
                f"K={G.shape[0]} != K*Z={self.n_info_bits} for {self.name}"
            )
        return dataclasses.replace(self, gen_matrix=G)


def _resource(name: str) -> str:
    return os.path.join(_RESOURCE_DIR, name)


def wman_n576() -> CodeSpec:
    """IEEE 802.16e WiMAX rate-3/4 code, Z=24, N=576 (reference resources/wman_N0576_R34_z24.txt)."""
    return CodeSpec(
        name="wman_n576_r34_z24",
        basegraph=load_basegraph(_resource("wman_n576_r34_z24.pcm")),
        Z=24,
    )


def nr_bg2_z16(with_gen_matrix: bool = True) -> CodeSpec:
    """5G NR base graph 2 set 0, Z=16, N=832 (reference resources/basegraph2_set0.txt)."""
    gm = load_gen_matrix(_resource("nr_bg2_set0_z16_genmatrix.npz")) if with_gen_matrix else None
    return CodeSpec(
        name="nr_bg2_set0_z16",
        basegraph=load_basegraph(_resource("nr_bg2_set0_z16.pcm")),
        Z=16,
        gen_matrix=gm,
    )


def nr_bg1_like(Z: int = 384, with_gen_matrix: bool = False) -> CodeSpec:
    """BG1-STRUCTURED QC-LDPC: 46x68, kb=22, E=316, Z<=384 (N*Z=26112 at the
    full lift).  Same dimensions/template as 3GPP 38.212 base graph 1
    (dual-diagonal core, identity staircase extension, two heavily-connected
    leading info columns) with shifts from a seeded 4-cycle-free +
    core-invertible search — the standardized shift tables are not
    reproducible in this offline environment (scripts/make_bg1_like.py;
    divergence noted in PARITY.md).

    A generator matrix ships in compact QC form (49 KB,
    nr_bg1_like_z384_genmatrix_qc.npz: one Z-bit polynomial per
    parity/info block pair) and expands to the dense [K*Z, N*Z] systematic
    form on request (220 MB at Z=384, ~2 s) — pass with_gen_matrix=True or
    use get_code("nr_bg1_like_z384_gen").  For other lifts derive one via
    ``codes.qc_encode.qc_generator_polys`` (seconds) or
    ``CodeSpec.with_derived_generator()``."""
    gm = None
    if with_gen_matrix:
        from .qc_encode import expand_qc_generator, unpack_qc_polys

        if Z == 384:
            d = np.load(_resource("nr_bg1_like_z384_genmatrix_qc.npz"))
            polys = unpack_qc_polys(d["polys_packed"], int(d["Z"]))
        else:
            from .qc_encode import qc_generator_polys

            polys = qc_generator_polys(
                load_basegraph(_resource("nr_bg1_like.pcm")), Z
            )
        gm = expand_qc_generator(polys, Z)
    return CodeSpec(
        name=f"nr_bg1_like_z{Z}",
        basegraph=load_basegraph(_resource("nr_bg1_like.pcm")),
        Z=Z,
        gen_matrix=gm,
    )


def synth_dense(seed: int, M: int = 46, N: int = 68, target_e: int = 580,
                max_shift: int = 383) -> np.ndarray:
    """A denser BG1-like protograph: a staircase on the first M columns, then
    random free entries of the last N - M columns up to ``target_e`` edges,
    shifts from numpy's ``seed`` (the recipe of
    scripts/bg1_e2e_routing_r4.py:144-156)."""
    rng = np.random.default_rng(seed)
    bg = np.full((M, N), -1, np.int64)
    for m in range(M):
        bg[m, m] = rng.integers(0, max_shift)
        if m > 0:
            bg[m, m - 1] = rng.integers(0, max_shift)
    free = [(m, c) for m in range(M) for c in range(M, N)]
    rng.shuffle(free)
    for m, c in free[: target_e - int((bg >= 0).sum())]:
        bg[m, c] = rng.integers(0, max_shift)
    return bg


def dense_protograph(Z: int = 16) -> CodeSpec:
    """``synth_dense(3, target_e=1100)`` lifted at Z: E = 1100 edges (over
    the 1024 up to which routing "auto" takes roll), check degrees 23-24,
    VN degrees up to 46; no generator matrix (all-zero words)."""
    return CodeSpec(name="synth_dense_e1100", basegraph=synth_dense(3, target_e=1100), Z=Z)


_REGISTRY = {
    "wman_n576_r34_z24": wman_n576,
    "nr_bg2_set0_z16": nr_bg2_z16,
    "nr_bg1_like_z384": nr_bg1_like,
    "nr_bg1_like_z384_gen": lambda: nr_bg1_like(with_gen_matrix=True),
}


def get_code(name: str) -> CodeSpec:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown code {name!r}; available: {sorted(_REGISTRY)}") from None


def available_codes() -> list[str]:
    return sorted(_REGISTRY)
