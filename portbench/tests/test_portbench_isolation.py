"""Nothing a run imports is JAX or the JAX package, and the reference
imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "neural_ldpc_tpu"}
REF = os.path.join(cells.HERE, "reference")
TINY = {
    "bg2_qms20.train_b16k": dict(batch=4, pool_batches=4, warmup_units=1, checked_from=2,
                                slice_units=2, reference_block=2),
    "wman_ms10.campaign_5p5db": dict(batch=256, early_exit_capacity=8,
                                     early_exit_probe_batches=1, early_exit_auto_guard=False,
                                     sync_every_batches=8, setup_batches=1, snr_db=3.0,
                                     reference_block=128),
    "wman_ms10.decode_b256k": dict(batch=64, llr_batches=2, warmup_units=1, checked_calls=2,
                                   checked_calls_from=3, slice_units=2, reference_block=32),
}


@pytest.mark.parametrize("path", sorted(f for f in os.listdir(REF) if f.endswith(".py")))
def test_reference_imports_nothing_of_the_port(path):
    tree = ast.parse(open(os.path.join(REF, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops = [(node.module or "").split(".")[0]] if node.level == 0 else []
        else:
            continue
        for top in tops:
            assert top not in FORBIDDEN | {"neural_ldpc_tpu_torch"}, (path, top)


@pytest.mark.parametrize("name", sorted(TINY))
def test_run_loads_no_jax(name):
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {cells.ROOT!r})\n"
        "from portbench import run\n"
        f"r = run.run_cell({name!r}, 2**31 + 5, 0.5, False, device='cpu', "
        f"overrides={TINY[name]!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN
    assert "neural_ldpc_tpu_torch" in tops
