"""Weight-sharing parameter registry for the boosted decoder.

Reference semantics: BoostedNeuralLDPCDecoder._register_params (:108-151),
fetch_param (:216-236), get_trainable_parameters (:238-258) and
_apply_constraints (:153-179).  The reference materializes one
``nn.Parameter`` per (node type, iteration); here parameters are stored as
stacked tensors — one per node type — and expanded at call time into a
dense per-iteration, per-edge weight tensor ``[I, E]`` (or per-VN ``[I, N]``)
that feeds the iteration loop.  Temporal-sharing modes (4/5) store one row per fixed
iterative node and are expanded through a static iteration->row map that
mirrors fetch_param's "closest fixed iteration <= i" rule (:227-235).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..codes.tanner import TannerGraph
from ..structs import NodeType, SharingMode


def _idx(ix, like: torch.Tensor) -> torch.Tensor:
    """Index table (tuple, numpy or tensor) as a long tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(ix) if not isinstance(ix, torch.Tensor) else ix,
                           dtype=torch.long, device=like.device)


def _row(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class SharingSpec:
    """Static description of one node type's weight parameterization."""

    node_type: NodeType
    mode: SharingMode
    n_iterations: int
    n_nodes: int  # M for CN/UCN, N for VN
    n_edges: int
    temporal_rows: tuple[int, ...]  # iteration ids owning a row (modes 4/5)
    row_of_iteration: tuple[int, ...]  # [I] row index into the stacked param
    # DEGREE_ITER (framework extension, arXiv:2107.04221): class index per
    # node (nodes of equal degree share a weight) and the class count
    degree_class_of_node: tuple[int, ...] = ()
    n_degree_classes: int = 0

    @staticmethod
    def build(
        node_type: NodeType,
        mode: SharingMode,
        n_iterations: int,
        n_nodes: int,
        n_edges: int,
        fixed_iterative_nodes: tuple[int, ...] = (),
        node_degrees=None,
    ) -> "SharingSpec":
        mode = SharingMode(mode)
        degree_class_of_node: tuple[int, ...] = ()
        n_degree_classes = 0
        if mode == SharingMode.DEGREE_ITER:
            if node_degrees is None:
                raise ValueError("DEGREE_ITER needs the per-node degree array")
            degrees = np.asarray(node_degrees)
            classes = np.unique(degrees)
            degree_class_of_node = tuple(
                int(np.searchsorted(classes, d)) for d in degrees
            )
            n_degree_classes = len(classes)
        if mode in (SharingMode.EDGE_TEMPORAL, SharingMode.NODE_TEMPORAL):
            # reference _register_params creates iteration 0 plus each fixed
            # node (:141-145); fetch resolves i -> closest fixed node <= i,
            # falling back to the first fixed node, or iteration 0 when no
            # fixed nodes exist (:227-235).
            rows = [0]
            for it in fixed_iterative_nodes:
                if it not in rows:
                    rows.append(it)
            row_index = {it: r for r, it in enumerate(rows)}
            fixed = list(fixed_iterative_nodes)
            row_of_iter = []
            for i in range(n_iterations):
                if fixed:
                    valid = [f for f in fixed if f <= i]
                    chosen = max(valid) if valid else fixed[0]
                else:
                    chosen = 0
                row_of_iter.append(row_index[chosen])
            temporal_rows = tuple(rows)
            row_of_iteration = tuple(row_of_iter)
        else:
            temporal_rows = ()
            row_of_iteration = tuple(range(n_iterations))
        return SharingSpec(
            node_type=node_type, mode=mode, n_iterations=n_iterations,
            n_nodes=n_nodes, n_edges=n_edges,
            temporal_rows=temporal_rows, row_of_iteration=row_of_iteration,
            degree_class_of_node=degree_class_of_node,
            n_degree_classes=n_degree_classes,
        )

    @property
    def n_rows(self) -> int:
        if self.mode in (SharingMode.EDGE_TEMPORAL, SharingMode.NODE_TEMPORAL):
            return len(self.temporal_rows)
        return self.n_iterations

    @property
    def row_width(self) -> Optional[int]:
        """Per-row parameter width, or None when mode is NONE."""
        if self.mode == SharingMode.NONE:
            return None
        if self.mode in (SharingMode.EDGE_ITER, SharingMode.EDGE_TEMPORAL):
            return self.n_edges
        if self.mode in (SharingMode.NODE_ITER, SharingMode.NODE_TEMPORAL):
            return self.n_nodes
        if self.mode == SharingMode.DEGREE_ITER:
            return self.n_degree_classes
        return 1  # SharingMode.ITER: scalar per iteration

    def init(self, value: float, dtype=torch.float32,
             device=None) -> Optional[torch.Tensor]:
        if self.mode == SharingMode.NONE:
            return None
        return torch.full((self.n_rows, self.row_width), value, dtype=dtype,
                          device=device)

    def expand_to_edges(
        self,
        raw: Optional[torch.Tensor],
        node_of_edge: torch.Tensor,
        overrides: Optional[dict[int, torch.Tensor]] = None,
    ) -> Optional[torch.Tensor]:
        """Expand the stacked parameter to a dense per-iteration per-edge
        weight [I, E] (gradients flow back through the gather/broadcast).

        ``overrides`` maps iteration -> weight array (broadcastable to [E]) and
        implements the forward-time ``fixed_iter_weight`` substitution
        (reference forward :330-334, :498-503).
        """
        if self.mode == SharingMode.NONE:
            return None
        rows = raw[_idx(self.row_of_iteration, raw)]  # [I, row_width]
        if self.mode in (SharingMode.NODE_ITER, SharingMode.NODE_TEMPORAL):
            per_edge = rows[:, _idx(node_of_edge, raw)]
        elif self.mode == SharingMode.DEGREE_ITER:
            cls = _idx(self.degree_class_of_node, raw)
            per_edge = rows[:, cls][:, _idx(node_of_edge, raw)]
        elif self.mode == SharingMode.ITER:
            per_edge = rows.expand(self.n_iterations, self.n_edges)
        else:  # per-edge modes
            per_edge = rows
        if overrides:
            per_edge_rows = []
            for i in range(self.n_iterations):
                if i in overrides:
                    per_edge_rows.append(_row(overrides[i], raw).expand(self.n_edges))
                else:
                    per_edge_rows.append(per_edge[i])
            per_edge = torch.stack(per_edge_rows)
        return per_edge

    def expand_to_nodes(
        self,
        raw: Optional[torch.Tensor],
        overrides: Optional[dict[int, torch.Tensor]] = None,
    ) -> Optional[torch.Tensor]:
        """Expand to per-iteration per-node weights [I, n_nodes] (VN path:
        reference applies VN weights to the [B, Z, N] channel tensor,
        :325-334)."""
        if self.mode == SharingMode.NONE:
            return None
        rows = raw[_idx(self.row_of_iteration, raw)]
        if self.mode in (SharingMode.NODE_ITER, SharingMode.NODE_TEMPORAL):
            per_node = rows
        elif self.mode == SharingMode.DEGREE_ITER:
            per_node = rows[:, _idx(self.degree_class_of_node, raw)]
        elif self.mode == SharingMode.ITER:
            per_node = rows.expand(self.n_iterations, self.n_nodes)
        else:
            # Per-edge VN sharing cannot broadcast onto [B, Z, N]; the
            # reference registers such weights but its forward never applies
            # them (BoostedNeuralLDPCDecoder.py:325-334 handles modes 2/3/4
            # only, with mode 4's [E]-shaped weight shape-incompatible unless
            # E == N).  We define VN temporal/edge modes as per-node.
            raise ValueError(
                f"VN weights with per-edge sharing mode {self.mode} are not "
                "broadcastable to variable nodes; use NODE_ITER/ITER/NODE_TEMPORAL"
            )
        if overrides:
            per_node_rows = []
            for i in range(self.n_iterations):
                if i in overrides:
                    per_node_rows.append(_row(overrides[i], raw).expand(self.n_nodes))
                else:
                    per_node_rows.append(per_node[i])
            per_node = torch.stack(per_node_rows)
        return per_node

    def trainable_row_mask(self, frozen_below: int) -> Optional[np.ndarray]:
        """Row-wise trainability mask implementing
        ``fixed_iterative_nodes_init_weight`` (reference
        get_trainable_parameters skips params whose iteration id is below the
        threshold, :251-253).  Returns None when the mode has no parameters."""
        if self.mode == SharingMode.NONE:
            return None
        if self.mode in (SharingMode.EDGE_TEMPORAL, SharingMode.NODE_TEMPORAL):
            row_iters = np.asarray(self.temporal_rows)
        else:
            row_iters = np.arange(self.n_iterations)
        return (row_iters >= frozen_below).astype(np.float32)


def build_sharing_specs(
    graph: TannerGraph,
    sharing_cfg,
    n_iterations: int,
    fixed_iterative_nodes: tuple[int, ...] = (),
) -> dict[str, SharingSpec]:
    """One spec per node type, keyed 'cn' / 'ucn' / 'vn'."""
    n_nodes = {NodeType.CN: graph.M, NodeType.UCN: graph.M, NodeType.VN: graph.N}
    degrees = {
        NodeType.CN: graph.cn_degree,
        NodeType.UCN: graph.cn_degree,
        NodeType.VN: graph.vn_degree,
    }
    return {
        nt.value.lower(): SharingSpec.build(
            node_type=nt, mode=mode, n_iterations=n_iterations,
            n_nodes=n_nodes[nt], n_edges=graph.E,
            fixed_iterative_nodes=fixed_iterative_nodes,
            node_degrees=degrees[nt],
        )
        for nt, mode in sharing_cfg
    }
