"""Data parallelism of the port (``neural_ldpc_tpu_torch.parallel``) on the
CPU over gloo: a one-rank group in this process (the mesh step, eval step,
campaign and Trainer against their no-mesh runs, bit for bit), the mesh API
and the campaign's mesh rules against JAX's, one spawn of two ranks (the
sharded step against JAX's 2-device mesh step and the one-process step,
counter-addressed ``HostDatagen`` ranges, eval counts, a campaign with early
exit behind the auto-guard, a Trainer's resume), the train CLI over two
ranks, and the build lock that keeps concurrent ranks from compiling a
source twice.  The rank processes import no JAX; JAX runs here."""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from neural_ldpc_tpu.channel import AWGNChannel as JaxChannel
from neural_ldpc_tpu.channel import ChannelConfig as JaxChannelConfig
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.eval import count_errors as jax_count_errors
from neural_ldpc_tpu.eval.montecarlo import CampaignConfig as JaxCampaignConfig
from neural_ldpc_tpu.eval.montecarlo import MonteCarloCampaign as JaxCampaign
from neural_ldpc_tpu.parallel import make_mesh as jax_make_mesh
from neural_ldpc_tpu.parallel import replicate as jax_replicate
from neural_ldpc_tpu.parallel import shard_batch as jax_shard_batch
from neural_ldpc_tpu.training import TrainConfig as JaxTrainConfig
from neural_ldpc_tpu.training import make_train_step as jax_make_train_step
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig, HostDatagen
from neural_ldpc_tpu_torch.cli import evaluate as evaluate_cli
from neural_ldpc_tpu_torch.cli import train as train_cli
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.parallel import (
    Mesh, data_sharding, make_mesh, pad_to_multiple, replicate, replicated_sharding, shard_batch)
from neural_ldpc_tpu_torch.training import TrainConfig, Trainer, make_eval_step, make_train_step
from neural_ldpc_tpu_torch.utils import CheckpointManager
from neural_ldpc_tpu_torch.utils.rng import channel_seed, fold_in, kernel_seed, next_key
from test_torch_grad import WMAN, build_grad_pair, grad_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARING = dict(cn=3, vn=3)
B = 16  # the sharded step's global batch
SNR = 3.0
LR = 1e-2
CAMPAIGN = dict(batch_size=32, max_words_per_snr=6 * 32, min_frame_errors=0, seed=11,
                engine="fused")
EE = dict(early_exit_iters=2, early_exit_probe_batches=1)  # the auto-guard on
TRAIN = dict(batch_size=8, train_words_per_epoch=16, validate_words=8, total_epochs=2,
             validate_epoch_step=1, checkpoint_step=1, log_metrics_step=1, verbose=False,
             engine="fused", seed=5, is_y_all_zero=True)


def _setup():
    """wman MS x3, cn / vn scalar per iteration, both packages, and two
    steps' worth of seeded inputs."""
    code, dec, jdec = build_grad_pair(WMAN, None, "MS", SHARING, 3)
    params, llr, bits = grad_inputs(code, dec, jdec, batch=2 * B, sigma=0.8, seed=3)
    return code, dec, jdec, params, llr.reshape(2, B, *llr.shape[1:]), bits.reshape(2, B, -1)


def _torch(params):
    return {k: torch.tensor(v) for k, v in params.items()}


def _channel(code):
    return AWGNChannel(code, ChannelConfig(snr_db=(SNR,)), device="cpu")


@pytest.fixture
def mesh1(tmp_path):
    """A one-rank gloo group in this process."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- one rank
@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_mesh_of_one_steps_equal_no_mesh_bit_for_bit(mesh1, engine):
    code, dec, _, params, llr, bits = _setup()
    cfg = TrainConfig(batch_size=B, engine=engine)
    runs = []
    for mesh in (None, mesh1):
        init, step = make_train_step(dec, cfg, mesh)
        p = _torch(params)
        opt, losses = init(p), []
        for it in range(2):
            p, opt, loss = step(p, opt, torch.tensor(llr[it]), torch.tensor(bits[it]), LR)
            losses.append(loss)
        ev = make_eval_step(dec, cfg, mesh)(p, torch.tensor(llr[0]), torch.tensor(bits[0]))
        runs.append((p, opt, losses, ev))
    (p0, o0, l0, e0), (p1, o1, l1, e1) = runs
    for k in p0:
        assert torch.equal(p0[k], p1[k]) and torch.equal(o0.mu[k], o1.mu[k]), k
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert torch.equal(e0[0], e1[0])
    for a, b in zip(e0[1], e1[1]):
        assert torch.equal(a, b)


def test_mesh_of_one_campaign_early_exit_equals_full_unroll(mesh1):
    code, dec, _, params, _, _ = _setup()
    full = MonteCarloCampaign(dec, _torch(params), _channel(code), CampaignConfig(**CAMPAIGN),
                              mesh=mesh1)
    r_full = full.run(verbose=False)[SNR]
    ee = MonteCarloCampaign(dec, _torch(params), _channel(code),
                            CampaignConfig(**CAMPAIGN, **EE, kernel_channel_sampling="auto"),
                            mesh=mesh1)
    r_ee = ee.run(verbose=False)[SNR]
    assert not ee.kernel_sampling  # "auto" reads the channel under a mesh
    assert 0 in ee._ee_choice and r_ee == r_full and 0 < r_full["fer"][0] < 1


def test_mesh_of_one_trainer_equals_no_mesh_and_cross_loads(mesh1, tmp_path):
    code, dec, _, _, _, _ = _setup()
    out = {}
    for name, mesh in (("alone", None), ("mesh", mesh1)):
        cfg = TrainConfig(**TRAIN, checkpoint_dir=str(tmp_path / name))
        out[name] = Trainer(dec, _channel(code), cfg, mesh=mesh).train()[0]
    for k in out["alone"]:
        assert torch.equal(out["alone"][k], out["mesh"][k]), k
    # the mesh run's checkpoint resumes a no-mesh Trainer bitwise
    cfg = TrainConfig(**TRAIN, checkpoint_dir=str(tmp_path / "mesh"))
    resumed = Trainer(dec, _channel(code), cfg).resume("checkpoint_epoch_0001")[0]
    for k in resumed:
        assert torch.equal(resumed[k], out["mesh"][k]), k


def test_cli_mesh_devices_1_runs_the_collective_path(tmp_path):
    assert evaluate_cli.main(["--preset", "wman_ms_plain", "--snr", "3.0", "--batch-size", "16",
                              "--max-words", "32", "--min-frame-errors", "0", "--device", "cpu",
                              "--mesh-devices", "1", "--out", str(tmp_path / "r.json")]) == 0
    assert (tmp_path / "r.json").exists() and not dist.is_initialized()


# ---------------------------------------------------------------- the API
def test_make_mesh_count_error_is_jax_s():
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        jax_make_mesh(9)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device="cpu")
    assert not dist.is_initialized()


def test_shard_batch_rows_and_divisibility_error():
    x = torch.arange(12).reshape(6, 2)
    for r in range(3):
        mesh = Mesh("data", None, r, 3, torch.device("cpu"))
        assert torch.equal(shard_batch(x, mesh), x[2 * r:2 * r + 2])
        got = shard_batch({"a": x, "b": np.arange(6)}, mesh)
        assert torch.equal(got["a"], x[2 * r:2 * r + 2]) and list(got["b"]) == [2 * r, 2 * r + 1]
    with pytest.raises(ValueError, match="batch_size 5 not divisible by 3 mesh devices"):
        shard_batch(torch.zeros(5), mesh)
    assert pad_to_multiple(5, 3) == 6 and pad_to_multiple(6, 3) == 6
    assert str(data_sharding(mesh)) == "S(0)" and str(replicated_sharding(mesh)) == "R"


def test_replicate_on_one_rank(mesh1):
    tree = {"w": torch.randn(3, 2), "count": torch.tensor(4, dtype=torch.int32)}
    got = replicate(tree, mesh1)
    assert torch.equal(got["w"], tree["w"]) and got["count"].dtype == torch.int32
    assert int(got["count"]) == 4 and got["w"].data_ptr() != tree["w"].data_ptr()


@pytest.mark.parametrize("rule", ["early_exit_needs_all_zero", "sampling_on", "divisible"])
def test_campaign_mesh_rules_raise_as_jax_s(rule):
    code, dec, jdec, params, _, _ = _setup()
    kw = dict(batch_size=32, engine="fused")
    kw.update({"early_exit_needs_all_zero": dict(early_exit_iters=2, all_zero=False),
               "sampling_on": dict(kernel_channel_sampling="on"),
               "divisible": dict(batch_size=33)}[rule])
    jchannel = JaxChannel(jax_get_code(WMAN), JaxChannelConfig(snr_db=(SNR,)))
    with pytest.raises(ValueError) as jerr:
        JaxCampaign(jdec, {k: jnp.asarray(v) for k, v in params.items()}, jchannel,
                    JaxCampaignConfig(**kw), mesh=jax_make_mesh(2))
    mesh = Mesh("data", None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError) as err:
        MonteCarloCampaign(dec, _torch(params), _channel(code), CampaignConfig(**kw), mesh=mesh)
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------- two ranks
WORKER = r"""
import os, sys, time
sys.path.insert(0, %(repo)r)
import numpy as np
import torch

torch.set_num_threads(2)
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig, HostDatagen
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder
from neural_ldpc_tpu_torch.parallel import initialize_distributed, make_mesh, shard_batch
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
from neural_ldpc_tpu_torch.training import TrainConfig, Trainer, make_eval_step, make_train_step
from neural_ldpc_tpu_torch.utils import CheckpointManager

rank, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
mesh = make_mesh(2, device="cpu")
inp = np.load(os.path.join(tmp, "inputs.npz"))
code = get_code(%(code)r)
dec = BoostedNeuralDecoder(
    TannerGraph.from_basegraph(code.basegraph, code.Z),
    BoostedDecoderConfig(n_iterations=3, decoder_type=DecoderType.MS,
                         sharing=NodeWeightSharingConfig(**%(sharing)r)), device="cpu")
keys = [k[2:] for k in inp.files if k.startswith("p/")]
params = {k: torch.tensor(inp["p/" + k]) for k in keys}
out = {}

# the sharded step on both engines: two steps on this rank's rows
for engine in ("xla", "fused"):
    init, step = make_train_step(dec, TrainConfig(batch_size=%(B)d, engine=engine), mesh)
    p = dict(params)
    opt = init(p)
    for it in range(2):
        p, opt, loss = step(p, opt, shard_batch(torch.tensor(inp["llr"][it]), mesh),
                            shard_batch(torch.tensor(inp["bits"][it]), mesh), %(lr)r)
        out[f"{engine}/loss{it}"] = loss.numpy()
    out.update({f"{engine}/p/{k}": v.numpy() for k, v in p.items()})

# counter-addressed HostDatagen ranges: rank r takes [r B/2, (r+1) B/2) of each batch
init, step = make_train_step(dec, TrainConfig(batch_size=%(B)d), mesh)
p = dict(params)
opt = init(p)
gen = HostDatagen(code, seed=7)
for it in range(2):
    hb = gen.batch(word_offset=it * %(B)d + rank * (%(B)d // 2), n_words=%(B)d // 2,
                   snr_index=2, all_zero=True)
    p, opt, _ = step(p, opt, torch.tensor(hb.llr, dtype=torch.float32),
                     torch.tensor(hb.bits, dtype=torch.float32), %(lr)r)
out.update({f"host/p/{k}": v.numpy() for k, v in p.items()})

# the eval step's counts over the global batch
loss, counts = make_eval_step(dec, TrainConfig(), mesh)(
    params, shard_batch(torch.tensor(inp["llr"][0]), mesh),
    shard_batch(torch.tensor(inp["bits"][0]), mesh))
out["eval/loss"] = loss.numpy()
out.update({f"eval/{k}": v.numpy() for k, v in counts._asdict().items()})

# a campaign: early exit behind the auto-guard against the full unroll
channel = AWGNChannel(code, ChannelConfig(snr_db=(%(snr)r,)), device="cpu")
full = MonteCarloCampaign(dec, params, channel, CampaignConfig(**%(campaign)r), mesh=mesh)
full.run(verbose=False)
ee = MonteCarloCampaign(dec, params, channel, CampaignConfig(**%(campaign)r, **%(ee)r), mesh=mesh)
if rank == 1:
    # rank 1's full unroll is slow: the guard, which reads the slowest
    # rank's times, must keep early exit on both ranks
    exact = ee._exact_step

    def slow_exact(*a):
        time.sleep(0.5)
        return exact(*a)
    ee._exact_step = slow_exact
ee.run(verbose=False)
for name, c in (("full", full), ("ee", ee)):
    out[f"{name}/counts"] = np.stack([c.words.astype(np.float64), c.bit_errors[:, 0],
                                      c.frame_errors[:, 0]])
out["ee/choice"] = np.array(ee._ee_choice[0])
out["ee/escalations"] = ee.escalations
ck = CheckpointManager(os.path.join(tmp, "campaign"))
ee.save_state(ck)
back = MonteCarloCampaign(dec, params, channel, CampaignConfig(**%(campaign)r, **%(ee)r),
                          mesh=mesh)
back.restore_state(ck)
out["restored/counts"] = np.stack([back.words.astype(np.float64), back.bit_errors[:, 0],
                                   back.frame_errors[:, 0]])

# a Trainer over two ranks: resume bitwise, and only rank 0 writes
cfg = TrainConfig(**%(train)r, checkpoint_dir=os.path.join(tmp, "train"))
writes = []
trainer = Trainer(dec, channel, cfg, mesh=mesh)
for obj, name in ((trainer.checkpoints, "save"), (trainer.checkpoints, "save_weights"),
                  (trainer.logger, "log")):
    def counted(*a, _f=getattr(obj, name), _n=name, **kw):
        writes.append(_n)
        return _f(*a, **kw)
    setattr(obj, name, counted)
whole = trainer.train()[0]
resumed = Trainer(dec, channel, cfg, mesh=mesh).resume("checkpoint_epoch_0001")[0]
out.update({f"trainer/p/{k}": v.numpy() for k, v in whole.items()})
out.update({f"resumed/p/{k}": v.numpy() for k, v in resumed.items()})
out["trainer/writes"] = np.array(len(writes))
out["jax_imported"] = np.array("jax" in sys.modules)
np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Spawn two gloo ranks once; returns their results and the inputs."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    code, dec, jdec, params, llr, bits = _setup()
    np.savez(tmp / "inputs.npz", llr=llr, bits=bits, **{f"p/{k}": v for k, v in params.items()})
    script = tmp / "worker.py"
    script.write_text(WORKER % dict(repo=REPO, code=WMAN, sharing=SHARING, B=B, lr=LR, snr=SNR,
                                    campaign=CAMPAIGN, ee=EE, train=TRAIN))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return ranks, (code, dec, jdec, params, llr, bits)


def _params(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def test_two_ranks_import_no_jax_and_agree_bit_for_bit(two_ranks):
    ranks, _ = two_ranks
    assert not ranks[0]["jax_imported"] and not ranks[1]["jax_imported"]
    for k in ranks[0]:
        if not k.startswith("trainer/writes"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_two_rank_step_matches_jax_mesh_and_one_process(two_ranks, engine):
    ranks, (code, dec, jdec, params, llr, bits) = two_ranks
    got = _params(ranks[0], f"{engine}/p/")
    # JAX's step on make_mesh(2) (its xla engine), and the port's one process
    jinit, jstep = jax_make_train_step(jdec, JaxTrainConfig(batch_size=B), mesh=jax_make_mesh(2))
    mesh = jax_make_mesh(2)
    jp = jax_replicate({k: jnp.asarray(v) for k, v in params.items()}, mesh)
    jopt = jax_replicate(jinit(jp), mesh)
    init, step = make_train_step(dec, TrainConfig(batch_size=B, engine=engine))
    p = _torch(params)
    opt = init(p)
    for it in range(2):
        jp, jopt, jl = jstep(jp, jopt, jax_shard_batch(llr[it], mesh),
                             jax_shard_batch(bits[it], mesh), jnp.float32(LR))
        p, opt, loss = step(p, opt, torch.tensor(llr[it]), torch.tensor(bits[it]), LR)
        got_loss = float(ranks[0][f"{engine}/loss{it}"])
        np.testing.assert_allclose(got_loss, float(jl), rtol=1e-5)
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], p[k].numpy(), atol=1e-6, err_msg=k)


def test_two_rank_host_datagen_ranges_equal_one_process_on_the_union(two_ranks):
    ranks, (code, dec, _, params, _, _) = two_ranks
    init, step = make_train_step(dec, TrainConfig(batch_size=B))
    p = _torch(params)
    opt = init(p)
    gen = HostDatagen(code, seed=7)
    for it in range(2):
        hb = gen.batch(word_offset=it * B, n_words=B, snr_index=2, all_zero=True)
        p, opt, _ = step(p, opt, torch.tensor(hb.llr, dtype=torch.float32),
                         torch.tensor(hb.bits, dtype=torch.float32), LR)
    got = _params(ranks[0], "host/p/")
    for k in params:
        np.testing.assert_allclose(got[k], p[k].numpy(), atol=1e-6, err_msg=k)


def test_two_rank_eval_counts_equal_jax_count_errors_on_the_global_batch(two_ranks):
    ranks, (_, _, jdec, params, llr, bits) = two_ranks
    outputs = jdec.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(llr[0]))
    ref = jax_count_errors(jnp.asarray(bits[0]), outputs)
    for k in ("bit_errors", "frame_errors", "total_bits", "total_frames"):
        np.testing.assert_array_equal(ranks[0][f"eval/{k}"], np.asarray(getattr(ref, k)), k)


def test_two_rank_campaign_early_exit_equals_the_full_unroll_and_one_process(two_ranks):
    ranks, (code, dec, _, params, _, _) = two_ranks
    r0 = ranks[0]
    # one guard choice, from the slowest rank's times (rank 1's full unroll)
    assert ranks[0]["ee/choice"] and ranks[1]["ee/choice"]
    assert r0["ee/escalations"][0] > 0
    np.testing.assert_array_equal(r0["ee/counts"], r0["full/counts"])
    assert r0["full/counts"][0, 0] == CAMPAIGN["max_words_per_snr"]
    assert 0 < r0["full/counts"][2, 0] < CAMPAIGN["max_words_per_snr"]
    np.testing.assert_array_equal(r0["restored/counts"], r0["ee/counts"])
    # one process decoding each batch's two rank streams (the rank folded
    # into the batch key) sums to the same counters
    alone = MonteCarloCampaign(dec, _torch(params), _channel(code),
                               CampaignConfig(**dict(CAMPAIGN, batch_size=CAMPAIGN["batch_size"] // 2)))
    gen = torch.Generator().manual_seed(CAMPAIGN["seed"])
    sigma = float(alone.channel.sigma[0])
    total = 0
    for _ in range(CAMPAIGN["max_words_per_snr"] // CAMPAIGN["batch_size"]):
        key = next_key(gen)
        for r in range(2):
            k = fold_in(key, r)
            total = total + alone._exact_step(kernel_seed(k), channel_seed(k), sigma)
    np.testing.assert_array_equal(total[:, 0].numpy(), r0["full/counts"][1:, 0])


def test_two_rank_trainer_resumes_bitwise_and_only_rank_0_writes(two_ranks, tmp_path):
    ranks, (code, dec, _, _, _, _) = two_ranks
    whole, resumed = _params(ranks[0], "trainer/p/"), _params(ranks[0], "resumed/p/")
    for k in whole:
        np.testing.assert_array_equal(whole[k], resumed[k], err_msg=k)
    assert int(ranks[0]["trainer/writes"]) > 0 and int(ranks[1]["trainer/writes"]) == 0
    # the same words as one process: within the reduction order's rounding
    alone = Trainer(dec, _channel(code), TrainConfig(**TRAIN, checkpoint_dir=str(tmp_path)))
    for k, v in alone.train()[0].items():
        np.testing.assert_allclose(whole[k], v.numpy(), atol=1e-6, err_msg=k)


def test_train_cli_over_two_ranks(tmp_path):
    common = ["--preset", "bg2_qms_train", "--device", "cpu", "--set", "n_iterations=3",
              "--set", "batch_size=4", "--set", "train_words_per_epoch=8",
              "--set", "validate_words=4", "--set", "validate_epoch_step=1",
              "--set", "checkpoint_step=1", "--set", 'engine="fused"', "--epochs", "1"]
    assert train_cli.main(common + ["--mesh-devices", "2",
                                    "--set", f"checkpoint_dir={tmp_path / 'mesh'}"]) == 0
    assert train_cli.main(common + ["--set", f"checkpoint_dir={tmp_path / 'alone'}"]) == 0
    with np.load(tmp_path / "mesh" / "checkpoint_epoch_0001.npz") as a, \
            np.load(tmp_path / "alone" / "checkpoint_epoch_0001.npz") as b:
        keys = [k for k in b.files if k.startswith("params/")]
        assert keys and set(a.files) == set(b.files)
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)
    assert (tmp_path / "mesh" / "training_metrics.txt").exists()


# ---------------------------------------------------------------- the build
BUILD_WORKER = r"""
import os, sys, time
sys.path.insert(0, %(repo)r)
from neural_ldpc_tpu_torch.ops.cuda import _build

d = sys.argv[1]
_build.BUILD_DIR = d
_build._lib_path = lambda name: os.path.join(d, "libstub.so")
_build._nvcc = lambda: "nvcc"


def compile_stub(name, out):
    with open(os.path.join(d, "compiled"), "a") as f:
        f.write(f"{os.getpid()}\n")
    time.sleep(1.0)
    open(out, "w").close()


_build._compile = compile_stub
_build.ctypes.CDLL = lambda path: path
open(os.path.join(d, f"ready.{os.getpid()}"), "w").close()
while not os.path.exists(os.path.join(d, "go")):
    time.sleep(0.01)
print(_build.load("stub"))
"""


def test_concurrent_loads_compile_a_source_once(tmp_path):
    script = tmp_path / "build_worker.py"
    script.write_text(BUILD_WORKER % dict(repo=REPO))
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    # both processes are imported and waiting: release them together
    deadline = time.monotonic() + 60
    while len(list(tmp_path.glob("ready.*"))) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    (tmp_path / "go").touch()
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
        assert o.strip().endswith("libstub.so"), o
    assert len((tmp_path / "compiled").read_text().split()) == 1
