"""work.py's counts against counts worked out by hand, and its isolation
from the port."""

import ast
import os

import pytest

from portbench import cells, work
from portbench.reference import graph as G


def shape_of(name):
    cfg = cells.config(name)
    return G.shape_of(G.read_basegraph(cfg["code"]["basegraph"]), cfg["code"]["Z"]), cfg


def test_wman_ms10_by_hand():
    s, cfg = shape_of("wman_ms10")
    assert (s.N, s.M, s.Z, s.E) == (24, 6, 24, 88)
    dec = cfg["decoder"]
    # an edge copy: v2c 1 + clip 2, check 7, |c2v| weight relu clip 2 sign 2 = 8, sum 1
    per_iter = 88 * 24 * (3 + 7 + 8 + 1) + 576 * 1
    assert work.forward_ops_per_word(s, dec) == 10 * per_iter + 576 == 407_616
    assert work.decodes(s, dec, 1) == (407_616 + 2 * 576, 2 * 576 * 4)
    first = 2 * per_iter + 576  # 81,984
    epilogue = 576 + 88 * 24  # 2,688
    sampler = 288 * 51 + 576 * 4  # 16,992
    ops, nbytes = work.campaign(s, dec, words=1000, escalated=10, first_iterations=2)
    assert ops == 1000 * (first + epilogue + sampler) + 10 * (407_616 + epilogue + sampler)
    assert nbytes == 1000 * 12 + 10 * 16


def test_bg2_qms20_by_hand():
    s, cfg = shape_of("bg2_qms20")
    assert (s.N, s.M, s.Z, s.E) == (52, 42, 16, 197)
    dec = cfg["decoder"]
    fwd = 20 * (197 * 16 * 25 + 832 * 7) + 832
    bwd = 20 * (197 * 16 * 60 + 832 * 21)
    loss = 20 * 832 * 19
    assert (fwd, bwd, loss) == (1_693_312, 4_131_840, 316_160)
    assert work.forward_ops_per_word(s, dec) == fwd
    assert work.backward_ops_per_word(s, dec) == bwd
    assert work.train_steps(s, dec, batch=20, steps=3) == (60 * (fwd + bwd + loss), 60 * 6656)


def test_peaks_and_least_time():
    assert work.PEAK_OPS_PER_S == pytest.approx(33.45e12, rel=1e-3)
    assert work.least_seconds(33.45e12, 1.0) == pytest.approx(1.0, rel=1e-3)
    assert work.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("path", ["work.py", "readers.py"] + [
    f"metrics/{f}" for f in sorted(os.listdir(os.path.join(cells.HERE, "metrics")))])
def test_takes_nothing_from_the_port(path):
    tree = ast.parse(open(os.path.join(cells.HERE, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
            for n in names:
                assert (n or "").split(".")[0] in ("__future__", "portbench"), n
