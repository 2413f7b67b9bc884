"""The BG1-sized code at its largest lift (the benchmark's configuration
``bg1z384_ms20``: 46x68, E = 316, Z = 384, MS x20 with one CN weight an
iteration) through the port's decode entry, ``FusedMinsumDecoder``, held
against the benchmark's plain reference (``portbench/reference``, plain
PyTorch in float32 that imports nothing of the port).

On the CPU the route is the cluster K3's: its plain version
``fused_fwd_cl_plain`` decodes, and no launch counter moves.  The test
marked ``gpu`` holds the kernel itself against the reference on the card,
with its launch and cluster counters:

    python -m pytest tests/test_torch_bg1z384.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from neural_ldpc_tpu_torch.models.boosted_decoder import params_from_numpy
from neural_ldpc_tpu_torch.ops.cuda import FusedMinsumDecoder, fused_fwd_k3
from neural_ldpc_tpu_torch.ops.cuda import fused_train as fused_train_mod
from portbench import cells, port, traffic
from portbench.reference import decode as R
from portbench.reference import decoder as D
from portbench.reference import graph as G

CFG = cells.config("bg1z384_ms20")
SNR_DB = 2.5  # the benchmark cell's SNR: about two thirds of the APPs stay inside the clip
WORDS = 3
SEED = 2**31 + 20
K3_COUNTERS = ("launches", "cuda_launches", "resident_ctas", "sm_slots")

# Largest |APP - reference| allowed (the clipped APP, |APP| <= 20).  Both
# cases: the kernel and the reference run the same float32 operations and
# add each bit's messages in increasing edge order, so they agree to a few
# ulps at most (1.9e-6 at 16); 2e-5 is the repo's bar for two float32
# min-sum decoders.  bfloat16 (ulp 0.125 at 16) misses it by four orders.
TOL = {
    "trained": 2e-5,  # trained/bg1_ms20_z384_post.npz, the cell's weights
    "random": 2e-5,  # CN weights drawn from [0.5, 1.0]: other magnitudes, other ties
}


def _weights(case: str) -> dict:
    if case == "trained":
        return port.weights(CFG)
    rng = np.random.default_rng(SEED)
    shape = (CFG["decoder"]["iterations"], 1)
    return {"weight_cn": rng.uniform(0.5, 1.0, shape).astype(np.float32)}


def _decoder(case: str, device):
    w = _weights(case)
    fused = FusedMinsumDecoder.from_decoder(port.decoder(CFG, device),
                                            params_from_numpy(w, device))
    return fused, w


def _reference(w: dict, llr, dtype=torch.float32):
    t = G.config_tables(CFG, llr.device)
    cn, vn = D.iteration_weights(CFG["decoder"], w, llr.device)
    return R.app(t, CFG["decoder"], cn, vn, llr, dtype=dtype, block=llr.shape[0])


def _llr(words: int, device):
    return traffic.all_zero_batches(G.config_shape(CFG), SNR_DB, words, 1, SEED, device)[0]


def _counters() -> tuple:
    return tuple(getattr(fused_fwd_k3, k) for k in K3_COUNTERS)


def test_route_is_the_cluster_k3():
    """Z = 384 is above the on-chip limit: the message state lives in a
    thread-block cluster of four CTAs a word."""
    lay = _decoder("trained", torch.device("cpu"))[0].layout
    assert lay.hbm_store and lay.k3_kernel == "cluster" and lay.cluster.C == 4
    assert lay.N * lay.Z == 26112 and lay.E * lay.Z == 121344


@pytest.mark.parametrize("case", sorted(TOL))
def test_decode_entry_against_the_reference(case, monkeypatch):
    cpu = torch.device("cpu")
    fused, w = _decoder(case, cpu)
    calls = []
    plain = fused_train_mod.fused_fwd_cl_plain
    monkeypatch.setattr(fused_train_mod, "fused_fwd_cl_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    llr = _llr(WORDS, cpu)
    before = _counters()
    out = fused(llr)
    assert len(calls) == 1 and _counters() == before  # the CPU launches nothing
    ref = _reference(w, llr)
    assert out.shape == ref.shape == (WORDS, 26112)
    assert float((out - ref).abs().max()) <= TOL[case]
    assert torch.equal(out < 0, ref < 0)
    assert bool(((ref.abs() < 20) & (ref.abs() > 0)).any())  # the gap is read off the clip
    bf16 = _reference(w, llr, torch.bfloat16)
    assert float((bf16 - ref).abs().max()) > TOL[case]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cluster K3 has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(TOL))
def test_cluster_k3_on_the_card(cuda, case):
    """Two calls of 256 words: each launches the cluster K3 once, adds the
    card's clusters at once times four CTAs to ``.resident_ctas`` and its
    SMs to ``.sm_slots``, and agrees with the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fused, w = _decoder(case, cuda)
    llr = _llr(256, cuda)
    ans = fused_train_mod.cluster_occupancy(fused.layout, cuda)
    before = _counters()
    for _ in range(2):
        out = fused(llr)
    torch.cuda.synchronize()
    after = _counters()
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2 * 4 * ans["clusters"],
                                                       2 * ans["sms"]]
    assert 0 < 4 * ans["clusters"] <= ans["sms"]
    ref = _reference(w, llr)
    assert float((out - ref).abs().max()) <= TOL[case]
    assert torch.equal(out < 0, ref < 0)
