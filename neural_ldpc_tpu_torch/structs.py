"""Typed configuration value-objects.

Parity with the reference's ``src/boosted_neural_ldpc_decoder/struct/`` package
(NodeType, ParamType, DecoderType, LossType, Puncture, Shortening, Clipping,
NodeWeightSharingConfig).  The step-decay LearningRate lives in
``training.lr_schedule``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, Optional, Tuple


class NodeType(enum.Enum):
    """Reference struct/NodeType.py:3-6."""

    CN = "CN"
    UCN = "UCN"
    VN = "VN"


class ParamType(enum.Enum):
    """Reference struct/ParamType.py:4-6."""

    Weight = "weight"
    Bias = "bias"


class DecoderType(enum.Enum):
    """BP message-update variant (reference struct/DecoderType.py:4-7)."""

    SP = 0  # sum-product (tanh domain)
    MS = 1  # min-sum
    QMS = 2  # quantized min-sum (fake-quant with STE)


class LossType(enum.Enum):
    """Reference struct/LossType.py:4-7."""

    BCE = "BCE"
    SoftBEROnAllZero = "SoftBEROnAllZero"
    FEROnAllZero = "FEROnAllZero"


class Convention(enum.Enum):
    """LLR sign convention.

    STANDARD: BPSK bit0 -> +1, so positive channel LLR favours bit 0 and the
      hard decision is bit = (LLR < 0).  CN sign update is the textbook
      product-of-signs.

    REFERENCE: reproduces the torch reference exactly: BPSK bit0 -> -1
      (reference AWGNPassedDatagen.py:97-101), positive LLR favours bit 1, and
      the CN update carries an extra (-1)^deg_c sign factor (the net effect of
      the reference's tile formulation, BoostedNeuralLDPCDecoder.py:417-423).
      Note the reference's own ``evaluate_ber_fer`` decides bit = (LLR < 0),
      which is inverted under this convention (verified in SURVEY.md §5); our
      evaluator accepts a convention argument and decides consistently.
    """

    STANDARD = "standard"
    REFERENCE = "reference"


@dataclasses.dataclass(frozen=True)
class Clipping:
    """Closed range, either symmetric (``abs``) or explicit start/end
    (reference struct/Clipping.py:1-17)."""

    start: float
    end: float

    @staticmethod
    def of(abs: Optional[float] = None, start: Optional[float] = None,
           end: Optional[float] = None) -> "Clipping":
        if abs is None and (start is None or end is None):
            raise ValueError("Either abs or both start and end must be provided")
        if abs is not None:
            sign = 1.0 if abs >= 0 else -1.0
            return Clipping(start=-abs * sign, end=abs * sign)
        return Clipping(start=float(start), end=float(end))

    @property
    def abs(self) -> float:
        return max(abs(self.start), abs(self.end))


@dataclasses.dataclass(frozen=True)
class Puncture:
    """1-based inclusive bit range whose LLRs are erased at the channel
    (reference struct/Puncture.py:1-14); start=0 disables."""

    start: int = 0
    end: int = 0

    def __post_init__(self):
        if self.start < 0 or self.end < 0 or self.start > self.end:
            raise ValueError("Invalid puncture range")

    def __len__(self) -> int:
        return self.end - self.start + 1


@dataclasses.dataclass(frozen=True)
class Shortening:
    """1-based inclusive bit range pinned to a known bit (LLR = -clip)
    (reference struct/Shortening.py:1-14); start=0 disables."""

    start: int = 0
    end: int = 0

    def __post_init__(self):
        if self.start < 0 or self.end < 0 or self.start > self.end:
            raise ValueError("Invalid shortening range")

    def __len__(self) -> int:
        return self.end - self.start + 1


class SharingMode(enum.IntEnum):
    """Weight-sharing granularity per node type
    (reference struct/NodeWeightSharingConfig.py:4-40, derived from
    ghy1228/LDPC_Error_Floor):

    0 = no weights; 1 = per-edge per-iteration; 2 = per-node per-iteration;
    3 = scalar per-iteration; 4 = per-edge temporally shared (boosting);
    5 = per-node temporally shared (boosting).

    6 (DEGREE_ITER) is a framework extension beyond the reference: one weight
    per distinct node *degree* per iteration (degree-specific neural weights,
    arXiv:2107.04221 / arXiv:2310.15483) — far fewer parameters than per-node
    modes while keeping the degree-dependent scaling that matters for
    irregular codes.
    """

    NONE = 0
    EDGE_ITER = 1
    NODE_ITER = 2
    ITER = 3
    EDGE_TEMPORAL = 4
    NODE_TEMPORAL = 5
    DEGREE_ITER = 6


@dataclasses.dataclass(frozen=True)
class NodeWeightSharingConfig:
    cn: SharingMode = SharingMode.ITER
    ucn: SharingMode = SharingMode.NONE
    vn: SharingMode = SharingMode.NONE

    def __post_init__(self):
        object.__setattr__(self, "cn", SharingMode(self.cn))
        object.__setattr__(self, "ucn", SharingMode(self.ucn))
        object.__setattr__(self, "vn", SharingMode(self.vn))

    def __iter__(self) -> Iterator[Tuple[NodeType, SharingMode]]:
        yield (NodeType.CN, self.cn)
        yield (NodeType.UCN, self.ucn)
        yield (NodeType.VN, self.vn)

    def get(self, node_type: NodeType) -> SharingMode:
        return {NodeType.CN: self.cn, NodeType.UCN: self.ucn, NodeType.VN: self.vn}[node_type]
