"""Tanner-graph edge tables for lifted protograph codes — the index-table
replacement for the reference's dense routing matrices.

The reference (src/boosted_neural_ldpc_decoder/ConnectingMatrix.py) encodes the
graph as six dense E x E / (EZ) x (EZ) one-hot matmul operands and runs the
check-node update on a [B, Z, E, E] tile.  Here the same topology is captured
as small integer index tables:

* ``cn_of_edge`` / ``vn_of_edge`` / ``shift_of_edge`` — per-edge metadata in a
  single canonical edge order (CN-order = base-graph row-major, so each check's
  edges are contiguous).
* padded per-check / per-variable edge lists — turn the CN min/sign reduction
  and the VN accumulation into dense masked row-reductions over the max node
  degree (O(E * deg) work instead of the reference's O(E^2)).
* per-edge cyclic-shift gather tables — replace the (EZ) x (EZ) block-circulant
  "lifting" matmuls (reference ConnectingMatrix.py:84-99) with
  ``take_along_axis`` rolls of each edge's Z-vector.

``routing_matrices()`` reconstructs the reference's dense matrices from the
edge tables so tests can verify exact structural equivalence.

Edge-order conventions (mirrors reference semantics, see SURVEY.md §2.4):
  VN-order: for each base column j, its edges ordered by row i (column-major).
  CN-order: for each base row i, its edges ordered by column j (row-major).
The reference stores VN->CN messages in VN-order and CN->VN messages in
CN-order; with explicit tables we keep everything in CN-order and translate
only where parity tests need it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TannerGraph:
    """Edge-table view of a lifted protograph.  All arrays are numpy (host,
    host); models copy what they need to the device as index tensors."""

    M: int  # base-graph rows (proto checks)
    N: int  # base-graph cols (proto variables)
    Z: int  # lifting factor
    E: int  # number of proto edges

    # canonical CN-order (row-major) tables
    cn_of_edge: np.ndarray  # [E] int32, base row of edge
    vn_of_edge: np.ndarray  # [E] int32, base col of edge
    shift_of_edge: np.ndarray  # [E] int32, circulant shift mod Z

    cn_degree: np.ndarray  # [M] int32
    vn_degree: np.ndarray  # [N] int32

    # padded reduction layouts (sentinel = E for padding slots)
    cn_edges: np.ndarray  # [M, max_cn_degree] int32 edge ids, E = pad
    vn_edges: np.ndarray  # [N, max_vn_degree] int32 edge ids, E = pad

    # CN-order edges are contiguous per check: edge e occupies slot
    # slot_of_edge[e] of check cn_of_edge[e]; row_ptr[c] is its first edge.
    row_ptr: np.ndarray  # [M+1] int32
    slot_of_edge: np.ndarray  # [E] int32

    # order translation: perm_vn2cn[k] = CN-order index of the VN-order edge k
    perm_vn2cn: np.ndarray  # [E] int32
    perm_cn2vn: np.ndarray  # [E] int32

    # lifting roll gather tables, used as gather indices along Z of [B, Z, E]
    z_roll_in: np.ndarray  # [Z, E] int32: out[z, e] = x[(z + shift_e) % Z, e]
    z_roll_out: np.ndarray  # [Z, E] int32: out[z, e] = x[(z - shift_e) % Z, e]

    @property
    def max_cn_degree(self) -> int:
        return self.cn_edges.shape[1]

    @property
    def max_vn_degree(self) -> int:
        return self.vn_edges.shape[1]

    @property
    def cn_mask(self) -> np.ndarray:
        """[M, max_cn_degree] bool, True where a real edge occupies the slot."""
        return self.cn_edges < self.E

    @property
    def vn_mask(self) -> np.ndarray:
        return self.vn_edges < self.E

    @staticmethod
    def from_basegraph(basegraph: np.ndarray, Z: int) -> "TannerGraph":
        bg = np.asarray(basegraph)
        M, N = bg.shape
        conn = bg != -1

        # CN-order enumeration: row-major over the base graph.
        rows, cols = np.nonzero(conn)  # np.nonzero is row-major => CN-order
        E = rows.size
        cn_of_edge = rows.astype(np.int32)
        vn_of_edge = cols.astype(np.int32)
        shift_of_edge = (bg[rows, cols] % Z).astype(np.int32)

        cn_degree = conn.sum(axis=1).astype(np.int32)
        vn_degree = conn.sum(axis=0).astype(np.int32)

        max_dc = int(cn_degree.max())
        max_dv = int(vn_degree.max())

        row_ptr = np.zeros(M + 1, dtype=np.int32)
        np.cumsum(cn_degree, out=row_ptr[1:])
        slot_of_edge = (np.arange(E, dtype=np.int32) - row_ptr[cn_of_edge]).astype(np.int32)

        cn_edges = np.full((M, max_dc), E, dtype=np.int32)
        slot = np.zeros(M, dtype=np.int64)
        for e in range(E):
            c = cn_of_edge[e]
            cn_edges[c, slot[c]] = e
            slot[c] += 1

        vn_edges = np.full((N, max_dv), E, dtype=np.int32)
        slot = np.zeros(N, dtype=np.int64)
        for e in range(E):
            v = vn_of_edge[e]
            vn_edges[v, slot[v]] = e
            slot[v] += 1

        # VN-order enumeration: column-major.  perm_vn2cn[k_v] = k_c.
        cols_v, rows_v = np.nonzero(conn.T)  # iterate columns outer
        cnorder_index = np.full((M, N), -1, dtype=np.int64)
        cnorder_index[rows, cols] = np.arange(E)
        perm_vn2cn = cnorder_index[rows_v, cols_v].astype(np.int32)
        perm_cn2vn = np.empty(E, dtype=np.int32)
        perm_cn2vn[perm_vn2cn] = np.arange(E, dtype=np.int32)

        z = np.arange(Z, dtype=np.int32)[:, None]  # [Z, 1]
        s = shift_of_edge[None, :]  # [1, E]
        z_roll_in = ((z + s) % Z).astype(np.int32)
        z_roll_out = ((z - s) % Z).astype(np.int32)

        return TannerGraph(
            M=M, N=N, Z=int(Z), E=int(E),
            cn_of_edge=cn_of_edge, vn_of_edge=vn_of_edge, shift_of_edge=shift_of_edge,
            cn_degree=cn_degree, vn_degree=vn_degree,
            cn_edges=cn_edges, vn_edges=vn_edges,
            row_ptr=row_ptr, slot_of_edge=slot_of_edge,
            perm_vn2cn=perm_vn2cn, perm_cn2vn=perm_cn2vn,
            z_roll_in=z_roll_in, z_roll_out=z_roll_out,
        )

    # ------------------------------------------------------------------
    # Dense-matrix reconstruction (for tests / interop with the reference
    # formulation; semantics documented in SURVEY.md §2.4).
    # ------------------------------------------------------------------
    def routing_matrices(self) -> dict[str, np.ndarray]:
        """Build the reference's six routing matrices + two lifting matrices
        from the edge tables.  Row/column edge orders follow the reference:

        * W_skipconn2even [N, E]: col k_v (VN-order) one-hot at its VN.
        * W_odd2even [E, E]: entry [l_c, k_v] = 1 iff CN-order edge l and
          VN-order edge k share a VN and are distinct edges.
        * W_even2odd [E, E]: entry [l_v, k_c] = 1 iff VN-order edge l and
          CN-order edge k share a CN and are distinct edges.
        * W_even2odd_with_self: same but keeping the self edge.
        * W_output [E, N]: row k_c (CN-order) one-hot at its VN.
        * W_skipconn2odd [M, E]: row i marks CN-order edges of check i.
        * lifting_matrix_1 [EZ, EZ]: block-circulant in VN-order.
        * lifting_matrix_2 [EZ, EZ]: block-circulant in CN-order.
        """
        E, M, N, Z = self.E, self.M, self.N, self.Z
        vn_cn = self.vn_of_edge  # CN-order VN ids
        cn_cn = self.cn_of_edge
        vn_vn = vn_cn[self.perm_vn2cn]  # VN-order VN ids
        cn_vn = cn_cn[self.perm_vn2cn]

        W_skipconn2even = np.zeros((N, E), dtype=np.float32)
        W_skipconn2even[vn_vn, np.arange(E)] = 1.0

        same_vn = vn_cn[:, None] == vn_vn[None, :]  # [l_c, k_v]
        same_edge_v = self.perm_vn2cn[None, :] == np.arange(E)[:, None]  # l_c == edge(k_v)
        W_odd2even = (same_vn & ~same_edge_v).astype(np.float32)

        same_cn = cn_vn[:, None] == cn_cn[None, :]  # [l_v, k_c]
        same_edge_c = self.perm_vn2cn[:, None] == np.arange(E)[None, :]
        W_even2odd = (same_cn & ~same_edge_c).astype(np.float32)
        W_even2odd_with_self = same_cn.astype(np.float32)

        W_output = np.zeros((E, N), dtype=np.float32)
        W_output[np.arange(E), vn_cn] = 1.0

        W_skipconn2odd = np.zeros((M, E), dtype=np.float32)
        W_skipconn2odd[cn_cn, np.arange(E)] = 1.0

        def lifting(shifts: np.ndarray) -> np.ndarray:
            L = np.zeros((E * Z, E * Z), dtype=np.float32)
            h = np.arange(Z)
            for k, s in enumerate(shifts):
                L[k * Z + h, k * Z + (h + s) % Z] = 1.0
            return L

        lifting_matrix_1 = lifting(self.shift_of_edge[self.perm_vn2cn])  # VN-order
        lifting_matrix_2 = lifting(self.shift_of_edge)  # CN-order

        return dict(
            W_odd2even=W_odd2even,
            W_skipconn2even=W_skipconn2even,
            W_even2odd=W_even2odd,
            W_even2odd_with_self=W_even2odd_with_self,
            W_output=W_output,
            W_skipconn2odd=W_skipconn2odd,
            lifting_matrix_1=lifting_matrix_1,
            lifting_matrix_2=lifting_matrix_2,
        )

    def lifted_parity_check_matrix(self) -> np.ndarray:
        """Expand to the full binary H matrix [M*Z, N*Z] (row = lifted check).

        Lifted edge semantics match the reference's circulants (the roll-in
        gather sends VN copy (j, (z + s) % Z)'s message to CN copy (i, z)):
        proto edge (i, j) with shift s connects CN copy (i, z) to VN copy
        (j, (z + s) % Z), i.e. H block (i, j) is the circulant with
        block[z, z'] = 1 iff z' = (z + s) % Z.  Verified against the BG2
        generator matrix: H @ G.T == 0 (mod 2).
        """
        H = np.zeros((self.M * self.Z, self.N * self.Z), dtype=np.uint8)
        z = np.arange(self.Z)
        for e in range(self.E):
            i, j, s = self.cn_of_edge[e], self.vn_of_edge[e], self.shift_of_edge[e]
            H[i * self.Z + z, j * self.Z + (z + s) % self.Z] = 1
        return H
