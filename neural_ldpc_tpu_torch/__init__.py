"""PyTorch / CUDA port of the neural LDPC decoder framework.

Trainable belief-propagation decoding of protograph/QC-LDPC codes
(Dai et al., arXiv:2102.03828) and boosted error-floor training
(Kwak et al., arXiv:2310.07194), on NVIDIA Hopper GPUs.  The decode hot path
runs through a hand-written CUDA kernel (``ops/cuda``); the plain PyTorch
decoder (``models.BoostedNeuralDecoder``) is the CPU ground truth.

Public layouts follow the JAX package ``neural_ldpc_tpu``: channel LLRs
``[B, N, Z]``, APP ``[B, N*Z]`` in bit order ``n*Z + z``, per-iteration
weights ``[I, E]`` (check side) and ``[I, N]`` (variable side).
"""

from .structs import (
    Clipping,
    Convention,
    DecoderType,
    LossType,
    NodeType,
    NodeWeightSharingConfig,
    ParamType,
    Puncture,
    SharingMode,
    Shortening,
)

__version__ = "0.1.0"
