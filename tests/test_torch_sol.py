"""The instruction-rate probe (K7) on the CPU: its plain version against the
TPU kernel ``scripts/mfu_r4.py::_sol_kernel`` run by ``pl.pallas_call`` in
interpret mode on a grid of 2, bit for bit (the same float32 operations in
the same order).

The interpret run compiles the kernel body with XLA for the CPU, whose
algebraic simplifier rewrites the chain's first step, ``a * c - a``, into
``a * (c - 1)``: one rounding instead of two.  The TPU compiles the kernel's
operations as they are written, and so do the CUDA kernel and its plain
version; the interpret run here therefore goes to a process of its own with
that pass disabled (``XLA_FLAGS=--xla_disable_hlo_passes=algsimp``)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neural_ldpc_tpu_torch.ops.cuda import measure_sol, sol_k7, sol_plain
from neural_ldpc_tpu_torch.ops.cuda import sol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_INTERPRET = """
import importlib.util, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental import pallas as pl
spec = importlib.util.spec_from_file_location("mfu_r4", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
x = np.load(sys.argv[2])
grid = x.shape[0] // m.ROWS
fn = pl.pallas_call(
    m._sol_kernel("decode_mix"), grid=(grid,),
    in_specs=[pl.BlockSpec((m.ROWS, m.COLS), lambda i: (i, 0))],
    out_specs=pl.BlockSpec((m.ROWS, m.COLS), lambda i: (i, 0)),
    out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True)
np.save(sys.argv[3], np.asarray(fn(jnp.asarray(x))))
print(m.ROWS, m.COLS, m.CHAIN, m.GRID, m.NACC)
"""


def test_plain_version_matches_the_tpu_kernel_exactly(tmp_path):
    x = sol.sol_input("cpu", rows=2 * sol.ROWS).numpy()  # a grid of 2
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_disable_hlo_passes=algsimp")
    res = subprocess.run(
        [sys.executable, "-c", _INTERPRET, os.path.join(ROOT, "scripts", "mfu_r4.py"),
         str(tmp_path / "x.npy"), str(tmp_path / "out.npy")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    shape = tuple(int(v) for v in res.stdout.split()[-5:])
    assert shape == (sol.ROWS, sol.COLS, sol.CHAIN, sol.GRID, sol.NACC)
    ours = sol_plain(torch.tensor(x)).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_array_equal(ours, np.load(tmp_path / "out.npy"))


def test_wrapper_on_the_cpu_and_the_rate_needs_the_card():
    x = sol.sol_input("cpu", rows=3)
    before = sol_k7.launches
    assert torch.equal(sol_k7(x), sol_plain(x))
    assert sol_k7.launches == before
    assert sol.sol_input("cpu", rows=3, seed=0).shape == (3, sol.COLS)
    with pytest.raises(ValueError, match="float32"):
        sol_k7(x.double())
    with pytest.raises(ValueError, match="times the GPU kernel"):
        measure_sol("cpu")
