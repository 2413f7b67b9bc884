"""Port's code tables (neural_ldpc_tpu_torch.codes) against the JAX package's."""

import dataclasses

import numpy as np
import pytest

from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.codes.protograph import nr_bg1_like as jax_nr_bg1_like
from neural_ldpc_tpu.codes.qc_encode import qc_generator_polys as jax_qc_polys
from neural_ldpc_tpu.ops.pallas.fused_train import build_layout as jax_build_layout
from neural_ldpc_tpu_torch.codes import TannerGraph, available_codes, get_code
from neural_ldpc_tpu_torch.codes.protograph import nr_bg1_like
from neural_ldpc_tpu_torch.codes.qc_encode import expand_qc_generator, qc_generator_polys
from neural_ldpc_tpu_torch.ops.cuda import build_layout

CODES = [
    ("wman", lambda m: m[0]("wman_n576_r34_z24")),
    ("bg2", lambda m: m[0]("nr_bg2_set0_z16")),
    ("bg1_z16", lambda m: m[1](16)),
    ("bg1_z384", lambda m: m[1](384)),
]
PORT = (get_code, nr_bg1_like)
JAX = (jax_get_code, jax_nr_bg1_like)


@pytest.mark.parametrize("name,make", CODES, ids=[c[0] for c in CODES])
def test_tanner_graph_matches_jax(name, make):
    code, jcode = make(PORT), make(JAX)
    assert code.name == jcode.name and code.Z == jcode.Z
    np.testing.assert_array_equal(code.basegraph, jcode.basegraph)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    jg = JaxTannerGraph.from_basegraph(jcode.basegraph, jcode.Z)
    for f in dataclasses.fields(jg):
        a, b = getattr(g, f.name), getattr(jg, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name,make", CODES, ids=[c[0] for c in CODES])
def test_build_layout_matches_jax(name, make):
    code = make(PORT)
    g = TannerGraph.from_basegraph(code.basegraph, code.Z)
    edge_perm, deg_classes = build_layout(g)
    j_perm, j_classes, r = jax_build_layout(
        JaxTannerGraph.from_basegraph(code.basegraph, code.Z), need_routing_operand=False)
    assert r is None
    np.testing.assert_array_equal(edge_perm, j_perm)
    assert deg_classes == j_classes
    # each check's edges stay contiguous, classes in ascending degree
    assert [d for d, _ in deg_classes] == sorted(d for d, _ in deg_classes)
    assert sum(d * n for d, n in deg_classes) == g.E


def test_build_layout_rejects_degree_one_checks():
    bg = np.array([[0, 1, -1], [-1, 2, 0]])
    bg1 = np.array([[0, -1, -1], [-1, 2, 0]])
    build_layout(TannerGraph.from_basegraph(bg, 4))
    with pytest.raises(ValueError, match="degree-1"):
        build_layout(TannerGraph.from_basegraph(bg1, 4))


def test_registry_and_generators_match_jax():
    assert available_codes() == sorted(
        ["wman_n576_r34_z24", "nr_bg2_set0_z16", "nr_bg1_like_z384", "nr_bg1_like_z384_gen"])
    bg2, jbg2 = get_code("nr_bg2_set0_z16"), jax_get_code("nr_bg2_set0_z16")
    np.testing.assert_array_equal(bg2.gen_matrix, jbg2.gen_matrix)
    H = TannerGraph.from_basegraph(bg2.basegraph, bg2.Z).lifted_parity_check_matrix()
    assert not ((H.astype(np.int64) @ bg2.gen_matrix.T) % 2).any()
    with pytest.raises(KeyError):
        get_code("no_such_code")


def test_qc_generator_zero_syndrome():
    """QC polynomials derived by the port equal JAX's, and the shipped Z=384
    polynomials give a generator whose codewords satisfy every check (checked
    on a few generator rows without expanding the 220 MB matrix)."""
    code = nr_bg1_like(16)
    polys = qc_generator_polys(code.basegraph, 16)
    np.testing.assert_array_equal(polys, jax_qc_polys(code.basegraph, 16))
    G = expand_qc_generator(polys, 16)
    H = TannerGraph.from_basegraph(code.basegraph, 16).lifted_parity_check_matrix()
    assert not ((H.astype(np.int64) @ G.T.astype(np.int64)) % 2).any()

    from neural_ldpc_tpu_torch.codes.protograph import _resource
    from neural_ldpc_tpu_torch.codes.qc_encode import unpack_qc_polys

    d = np.load(_resource("nr_bg1_like_z384_genmatrix_qc.npz"))
    polys384 = unpack_qc_polys(d["polys_packed"], int(d["Z"]))
    M, K, Z = polys384.shape
    g384 = TannerGraph.from_basegraph(nr_bg1_like(384).basegraph, 384)
    rng = np.random.default_rng(0)
    for row in rng.choice(K * Z, size=4, replace=False):
        i, z = divmod(int(row), Z)
        word = np.zeros((K + M) * Z, np.uint8)
        word[i * Z + z] = 1
        for m in range(M):
            word[(K + m) * Z:(K + m + 1) * Z] = np.roll(polys384[m, i], z)
        # syndrome of one codeword through the edge tables
        syn = np.zeros((g384.M, Z), np.uint8)
        zz = np.arange(Z)
        for e in range(g384.E):
            c, v, s = g384.cn_of_edge[e], g384.vn_of_edge[e], g384.shift_of_edge[e]
            syn[c] ^= word[v * Z + (zz + s) % Z]
        assert not syn.any()
