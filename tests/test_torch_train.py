"""The port's training (``neural_ldpc_tpu_torch.training``) against the JAX
package's: the loss, the learning-rate schedule, Adam, one train step on
either engine, the trainer's metrics log, checkpoints with the optimizer
state, bitwise resume, and the train CLI."""

import dataclasses
from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_ldpc_tpu.training import LearningRate as JaxLearningRate
from neural_ldpc_tpu.training import TrainConfig as JaxTrainConfig
from neural_ldpc_tpu.training import make_train_step as jax_make_train_step
from neural_ldpc_tpu.training.loss import multi_iteration_loss as jax_loss
from neural_ldpc_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from neural_ldpc_tpu.utils.metrics_logger import format_header as jax_format_header
from neural_ldpc_tpu.utils.metrics_logger import format_row as jax_format_row
from neural_ldpc_tpu.structs import LossType as JaxLossType
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.cli import train as train_cli
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.models import BoostedDecoderConfig, BoostedNeuralDecoder
from neural_ldpc_tpu_torch.structs import DecoderType, LossType, NodeWeightSharingConfig
from neural_ldpc_tpu_torch.training import (
    LearningRate, TrainConfig, Trainer, make_train_step, multi_iteration_loss)
from neural_ldpc_tpu_torch.training.train_loop import adam_init, adam_update, format_train_progress
from neural_ldpc_tpu_torch.utils import CheckpointManager
from neural_ldpc_tpu_torch.utils.metrics_logger import format_header, format_row
from test_torch_grad import BG2, WMAN, build_grad_pair, grad_inputs


@pytest.mark.parametrize("loss_type", ["BCE", "SoftBEROnAllZero", "FEROnAllZero"])
def test_loss_values_and_grads_match_jax(loss_type):
    rng = np.random.default_rng(3)
    outs = (rng.normal(size=(3, 4, 10)) * 3).astype(np.float32)
    outs[0, 0, :4] = 0.0  # logits exactly 0: BCE's kinks and the tied FER minimum
    outs[1, 1, :] = 0.0
    bits = (rng.random((4, 10)) < 0.3).astype(np.float32)
    kw = dict(etha=0.8, coeff=[0, 1, 2])
    x = torch.tensor(outs, requires_grad=True)
    loss = multi_iteration_loss(x, torch.tensor(bits), LossType[loss_type], **kw)
    (g,) = torch.autograd.grad(loss, x)
    jval, jg = jax.value_and_grad(
        lambda o: jax_loss(o, jnp.asarray(bits), JaxLossType[loss_type], **kw))(jnp.asarray(outs))
    assert abs(loss.item() - float(jval)) < 1e-6
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-4)
    # one iteration [B, NZ] and a scalar coefficient broadcast, as in JAX
    single = multi_iteration_loss(torch.tensor(outs[0]), torch.tensor(bits), LossType[loss_type])
    assert abs(single.item() - float(jax_loss(jnp.asarray(outs[0]), jnp.asarray(bits),
                                              JaxLossType[loss_type]))) < 1e-6


def test_learning_rate_matches_jax():
    for args in ((1e-3, 0.0, 0), (1e-2, 0.5, 2), (5e-3, 0.9, 3)):
        ours, theirs = LearningRate(*args), JaxLearningRate(*args)
        assert [ours() for _ in range(9)] == [theirs() for _ in range(9)]
        assert ours.lr == theirs.lr and ours.clone().step == 0
        assert [ours.value_at(k) for k in range(7)] == [theirs.value_at(k) for k in range(7)]


def test_adam_matches_optax_scale_by_adam():
    """Three steps on the same gradients: the moments and the step count
    equal optax's, the updates within 1 ulp (XLA may fold a division)."""
    rng = np.random.default_rng(0)
    shapes = {"weight_cn": (5, 3), "weight_vn": (5, 4)}
    adam = optax.scale_by_adam()
    js = adam.init({k: jnp.zeros(s) for k, s in shapes.items()})
    ts = adam_init({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        g = {k: (rng.normal(size=s) * 10 ** rng.uniform(-6, 0, size=s)).astype(np.float32)
             for k, s in shapes.items()}
        ju, js = adam.update({k: jnp.asarray(v) for k, v in g.items()}, js)
        tu, ts = adam_update({k: torch.tensor(v) for k, v in g.items()}, ts)
        for k in g:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6, atol=0)
            np.testing.assert_array_equal(ts.mu[k].numpy(), np.asarray(js.mu[k]))
            np.testing.assert_array_equal(ts.nu[k].numpy(), np.asarray(js.nu[k]))
    assert ts.count.dtype == torch.int32 and int(ts.count) == int(js.count) == 3


def _preset_step_case(batch=20):
    """BG2 QMS x4 with CN and VN weights on random codewords (the
    bg2_qms_train preset cut to 4 iterations), both packages."""
    code, dec, jdec = build_grad_pair(BG2, None, "QMS", dict(cn=3, vn=3), 4)
    params, llr, bits = grad_inputs(code, dec, jdec, batch=batch, sigma=0.8,
                                    random_codewords=True)
    return code, dec, jdec, params, llr, bits


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_one_train_step_matches_jax(engine):
    """Loss within 1e-6; params within 1e-6 where the plain engine's |g| >
    1e-5, and within 2 lr elsewhere (Adam's first step moves any nonzero
    gradient by +-lr, so a gradient that is 0 up to rounding may step
    either way)."""
    code, dec, jdec, params, llr, bits = _preset_step_case()
    lr = 1e-3
    init, step = make_train_step(dec, TrainConfig(engine=engine))
    p = {k: torch.tensor(v) for k, v in params.items()}
    new, opt, loss = step(p, init(p), torch.tensor(llr), torch.tensor(bits), lr)
    jinit, jstep = jax_make_train_step(jdec, JaxTrainConfig(engine="xla"))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jnew, jopt, jl = jstep(jp, jinit(jp), jnp.asarray(llr), jnp.asarray(bits), jnp.float32(lr))
    assert abs(loss.item() - float(jl)) < 1e-6
    pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    l_plain = multi_iteration_loss(dec.apply(pg, torch.tensor(llr)), torch.tensor(bits),
                                   coeff=list(range(4)))
    grads = dict(zip(pg, torch.autograd.grad(l_plain, list(pg.values()))))
    for k in params:
        diff = np.abs(new[k].numpy() - np.asarray(jnew[k]))
        big = np.abs(grads[k].numpy()) > 1e-5
        assert big.any() and diff[big].max() <= 1e-6, k
        assert diff.max() <= 2 * lr, k
    assert int(opt.count) == 1


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_frozen_rows_do_not_move(engine):
    code = get_code(WMAN)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, code.Z),
        BoostedDecoderConfig(n_iterations=4, decoder_type=DecoderType.MS,
                             sharing=NodeWeightSharingConfig(cn=1),
                             fixed_iterative_nodes_init_weight=2), device="cpu")
    channel = AWGNChannel(code, ChannelConfig(snr_db=(2.0, 3.0)), device="cpu")
    init, step = make_train_step(dec, TrainConfig(batch_size=8, engine=engine))
    params = dec.init_params()
    opt = init(params)
    before = params["weight_cn"].clone()
    llr, bits = channel.sample_mixed(channel.generator(1), 8)
    for _ in range(3):
        params, opt, _ = step(params, opt, llr, bits, 1e-2)
    after = params["weight_cn"]
    assert torch.equal(after[:2], before[:2])  # frozen
    assert (after[2:] - before[2:]).abs().max() > 0  # trained


def _trainer_setup(tmp, total, engine="xla", decay=True, **kw):
    code = get_code(WMAN)
    dec = BoostedNeuralDecoder(
        TannerGraph.from_basegraph(code.basegraph, code.Z),
        BoostedDecoderConfig(n_iterations=3, decoder_type=DecoderType.MS,
                             sharing=NodeWeightSharingConfig(cn=3, vn=3)), device="cpu")
    channel = AWGNChannel(code, ChannelConfig(snr_db=(2.0, 3.0, 4.0)), device="cpu")
    cfg = TrainConfig(
        total_epochs=total, batch_size=8, train_words_per_epoch=16, validate_words=8,
        validate_epoch_step=2, checkpoint_step=2, log_metrics_step=1, checkpoint_dir=str(tmp),
        verbose=False, engine=engine, is_y_all_zero=True, patience=100,
        learning_rate=LearningRate(1e-2, 0.5 if decay else 0.0, 2 if decay else 0), **kw)
    return Trainer(dec, channel, cfg)


def test_trainer_metrics_log_is_the_jax_format(tmp_path):
    """A short CPU run: checkpoints, the .txt weight export, and a metrics
    log byte for byte what JAX's formatter writes for the same rows under
    an injected clock."""
    trainer = _trainer_setup(tmp_path, 2)
    at = datetime(2026, 1, 2, 3, 4, 5)
    trainer.logger._clock = lambda: at
    rows, log = [], trainer.logger.log

    def record(epoch, metrics, ckpt, config=None):
        rows.append((epoch, dict(metrics), ckpt, config))
        log(epoch, metrics, ckpt, config)

    trainer.logger.log = record
    trainer.train()
    expected = ""
    for epoch, metrics, ckpt, config in rows:
        if epoch == 0:
            expected = jax_format_header(config, metrics.keys(), at)
        expected += jax_format_row(epoch, metrics, ckpt, at)
    assert [r[0] for r in rows] == [0, 1, 2]
    assert (tmp_path / "training_metrics.txt").read_text() == expected
    assert (tmp_path / "checkpoint_epoch_0002.npz").exists()
    assert (tmp_path / "weights_epoch_0002_weights_txt" / "weight_VN_2.txt").exists()
    m = {"loss": 0.25, "ber_last_iter": 1.5e-4, "fer_last_iter": 0.125}
    assert format_header({"lr": 0.001}, m, at) == jax_format_header({"lr": 0.001}, m, at)
    assert format_row(7, m, "NA", at) == jax_format_row(7, m, "NA", at)
    from neural_ldpc_tpu.training.train_loop import format_train_progress as jax_progress
    assert format_train_progress(3, 10, 2, 5, 0.5, at.timestamp() - 30, now=at) == \
        jax_progress(3, 10, 2, 5, 0.5, at.timestamp() - 30, now=at)


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_resume_bitwise_matches_uninterrupted(tmp_path, engine):
    straight = _trainer_setup(tmp_path / "a", 4, engine)
    p_a, opt_a, _ = straight.train()
    _trainer_setup(tmp_path / "b", 2, engine).train()
    p_b, opt_b, _ = _trainer_setup(tmp_path / "b", 4, engine).resume("checkpoint_epoch_0002")
    for k in p_a:
        assert torch.equal(p_a[k], p_b[k]), k
        assert torch.equal(opt_a.mu[k], opt_b.mu[k]) and torch.equal(opt_a.nu[k], opt_b.nu[k])
    assert int(opt_a.count) == int(opt_b.count) == 8


def test_trainer_takes_batches_from_host_datagen(tmp_path):
    """A host generator stands in for the channel: the trained params equal
    the train step run by hand on the training batches it handed out (the
    first batch is the epoch-0 validation's)."""
    base = _trainer_setup(tmp_path, 1, decay=False)
    handed = []

    def datagen(batch):
        llr, bits = base.channel.sample_mixed(base.channel.generator(len(handed)), batch)
        handed.append((llr, bits))
        return llr.numpy(), bits.numpy()

    params, opt, _ = Trainer(base.decoder, base.channel, base.cfg, host_datagen=datagen).train()
    assert len(handed) == 3  # 1 validation batch, then 2 training batches
    init, step = make_train_step(base.decoder, base.cfg)
    ref = base.decoder.init_params()
    ref_opt = init(ref)
    lr = base.cfg.learning_rate.clone()()
    for llr, bits in handed[1:]:
        ref, ref_opt, _ = step(ref, ref_opt, llr, bits, lr)
    for k in ref:
        assert torch.equal(params[k], ref[k]), k
    assert int(opt.count) == 2


def test_checkpoints_with_opt_state_cross_load(tmp_path):
    code, dec, jdec, params, llr, bits = _preset_step_case(batch=4)
    jinit, jstep = jax_make_train_step(jdec, JaxTrainConfig(engine="xla"))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp, jopt, _ = jstep(jp, jinit(jp), jnp.asarray(llr), jnp.asarray(bits), jnp.float32(1e-3))
    JaxCheckpointManager(str(tmp_path)).save("jax", jp, jopt, epoch=1,
                                             rng_key=jax.random.PRNGKey(0))
    tmpl = dec.init_params()
    p, opt, meta, rng, _ = CheckpointManager(str(tmp_path)).load("jax", tmpl, adam_init(tmpl))
    assert opt.count.dtype == torch.int32 and int(opt.count) == 1 and meta["epoch"] == 1
    for k in params:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(opt.mu[k].numpy(), np.asarray(jopt.mu[k]))
        np.testing.assert_array_equal(opt.nu[k].numpy(), np.asarray(jopt.nu[k]))
    assert not isinstance(rng, torch.Tensor)  # the threefry key's raw data
    # the reverse: the port's checkpoint, after one of its own steps, in JAX
    init, step = make_train_step(dec, TrainConfig())
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tp, topt, _ = step(tp, init(tp), torch.tensor(llr), torch.tensor(bits), 1e-3)
    CheckpointManager(str(tmp_path)).save("port", tp, topt, epoch=1,
                                          rng_state=torch.Generator().get_state())
    jtmpl = jdec.init_params()
    back, bopt, _, key, _ = JaxCheckpointManager(str(tmp_path)).load("port", jtmpl, jinit(jtmpl))
    assert key is None and int(bopt.count) == 1
    for k in params:
        np.testing.assert_array_equal(np.asarray(back[k]), tp[k].numpy())
        np.testing.assert_array_equal(np.asarray(bopt.mu[k]), topt.mu[k].numpy())
    # training cannot continue a JAX checkpoint's threefry data stream
    trainer = Trainer(dec, AWGNChannel(code, ChannelConfig(qms_qbit=5), device="cpu"),
                      TrainConfig(checkpoint_dir=str(tmp_path), verbose=False))
    with pytest.raises(ValueError, match="threefry"):
        trainer.resume("jax")


CLI_COMMON = ["--preset", "bg2_qms_train", "--device", "cpu", "--set", "n_iterations=3",
              "--set", "batch_size=4", "--set", "train_words_per_epoch=8",
              "--set", "validate_words=4", "--set", "validate_epoch_step=1",
              "--set", "checkpoint_step=1", "--set", 'engine="fused"']


def test_cli_train_resume(tmp_path, capsys):
    common = CLI_COMMON + ["--set", f"checkpoint_dir={tmp_path}"]
    assert train_cli.main(common + ["--epochs", "2"]) == 0
    assert (tmp_path / "checkpoint_epoch_0002.npz").exists()
    assert train_cli.main(common + ["--epochs", "3", "--resume", "checkpoint_epoch_0002"]) == 0
    assert (tmp_path / "checkpoint_epoch_0003.npz").exists()
    out = capsys.readouterr().out
    assert "engine=fused device=cpu" in out and out.count("training done:") == 2
    assert train_cli.main(common + ["--dump-config"]) == 0
    assert '"engine": "fused"' in capsys.readouterr().out


@pytest.mark.parametrize("argv,item", [
    # both recipes are ported; the REFERENCE convention is not
    (["--preset", "wman_neural_train", "--set", 'convention="reference"'], "item 9"),
    (["--preset", "boosted_error_floor", "--set", 'convention="reference"'], "item 9"),
    (["--mesh-devices", "2"], "item 11"),
])
def test_cli_train_unported_modes_name_their_roadmap_items(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        train_cli.main(argv + ["--device", "cpu"])
    if argv[0] != "--preset":
        with pytest.raises(NotImplementedError, match=item):
            make_train_step(None, TrainConfig(), mesh=object())


def test_train_config_fields_are_jax_fields():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        if k != "loss_type" and v is not dataclasses.MISSING:
            assert ours[k] == v, k
