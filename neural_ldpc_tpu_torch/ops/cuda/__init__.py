"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Kernels build from ``csrc/`` with ``nvcc`` at first use (``_build``); each
wrapper runs its plain PyTorch version on CPU tensors.  K1-K4 and the
fused BCE step's loss head are in ``fused_train`` (K6, the matmul routing,
is the routing of a layout, which the K1 and K2 wrappers launch), K5 (the
legacy engine, the forward kernel with its own routings) in ``legacy``, K7
(the instruction rate probe) in ``sol``."""

from .fused_train import (
    FusedTrainDecoder,
    BwdClusterSplit,
    ClusterSplit,
    FusedBceLossFn,
    FusedTrainFn,
    FwdLayout,
    K1Plan,
    K2Plan,
    build_layout,
    bwd_cluster_occupancy,
    bwd_cluster_plan,
    bwd_cluster_split,
    cluster_occupancy,
    cluster_plan,
    cluster_split,
    fused_bce_head,
    fused_bce_head_plain,
    fused_bwd_block_plain,
    fused_bwd_cl_plain,
    fused_bwd_dm_plain,
    fused_bwd_k2,
    fused_bwd_k4,
    fused_bwd_plain,
    fused_capacity_ok,
    fused_fwd_block_plain,
    fused_fwd_cl_plain,
    fused_fwd_dm_plain,
    fused_fwd_k1a,
    fused_fwd_k1b,
    fused_fwd_k1c,
    fused_fwd_k1d,
    fused_fwd_k3,
    fused_fwd_plain,
    fused_fwd_train_plain,
    k1_occupancy,
    k1_plan,
    k2_occupancy,
    k2_plan,
    on_chip_ok,
    sample_channel_plain,
    split_stats,
    stats_plain,
    syndrome_ok_plain,
)
from .legacy import fused_legacy_k5, legacy_plain
from .minsum import FusedMinsumDecoder
from .sol import measure_sol, sol_k7, sol_plain

# every kernel wrapper; each counts its calls that launched (``.launches``)
# and the CUDA kernels those calls launched (``.cuda_launches``)
WRAPPERS = (fused_fwd_k1a, fused_fwd_k1b, fused_fwd_k1c, fused_fwd_k1d, fused_bwd_k2,
            fused_fwd_k3, fused_bwd_k4, fused_legacy_k5, sol_k7, fused_bce_head)
