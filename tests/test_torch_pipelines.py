"""The two papers' training recipes in the port against the JAX package:
Kwak's boosted error-floor pipeline
(``neural_ldpc_tpu_torch.training.boosted_pipeline``) and Dai's greedy
per-layer training (``training.greedy``), and the train CLI's ``boosted``
and ``greedy`` modes.

The port's random streams are its own (``torch.Generator``), so whole runs
are held to JAX's behaviour (frozen rows, what trains, every harvested word
a failure); on equal inputs the pieces are held to JAX's values: the
extended config field for field, the parameter transfer bit for bit, the
post-stage datagen's pool rows exactly, and the greedy step's params and
losses within 1e-6."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.channel import AWGNChannel as JaxChannel
from neural_ldpc_tpu.channel import ChannelConfig as JaxChannelConfig
from neural_ldpc_tpu.codes import TannerGraph as JaxTannerGraph
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.models import BoostedDecoderConfig as JaxConfig
from neural_ldpc_tpu.models import NeuralDecoderConfig as JaxNeuralConfig
from neural_ldpc_tpu.models import NeuralMinSumDecoder as JaxNeuralDecoder
from neural_ldpc_tpu.structs import DecoderType as JaxType
from neural_ldpc_tpu.structs import NodeWeightSharingConfig as JaxSharing
from neural_ldpc_tpu.training import TrainConfig as JaxTrainConfig
from neural_ldpc_tpu.training.boosted_pipeline import BoostedPipeline as JaxPipeline
from neural_ldpc_tpu.training.boosted_pipeline import BoostedPipelineConfig as JaxPipelineConfig
from neural_ldpc_tpu.training.greedy import DAI_SNR_CURRICULUM as JAX_CURRICULUM
from neural_ldpc_tpu.training.greedy import GreedyLayerTrainer as JaxGreedy
from neural_ldpc_tpu.training.greedy import GreedyTrainConfig as JaxGreedyConfig
from neural_ldpc_tpu.utils.config import PRESETS as JAX_PRESETS
from neural_ldpc_tpu_torch.channel import AWGNChannel, ChannelConfig
from neural_ldpc_tpu_torch.cli import train as train_cli
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.models import (
    BoostedDecoderConfig, NeuralDecoderConfig, NeuralMinSumDecoder, neural_params_from_numpy)
from neural_ldpc_tpu_torch.structs import DecoderType, NodeWeightSharingConfig
from neural_ldpc_tpu_torch.training import LearningRate, TrainConfig
from neural_ldpc_tpu_torch.training.boosted_pipeline import (
    BoostedPipeline, BoostedPipelineConfig)
from neural_ldpc_tpu_torch.training.greedy import (
    DAI_SNR_CURRICULUM, GreedyLayerTrainer, GreedyTrainConfig)

WMAN, BG2 = "wman_n576_r34_z24", "nr_bg2_set0_z16"
GREEDY_TOL = dict(rtol=0, atol=1e-6)


def _enum_values(x):
    """A dataclass as a dict with enums by value (nested ones too)."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if dataclasses.is_dataclass(v):
            v = _enum_values(v)
        elif hasattr(v, "value"):
            v = v.value
        out[f.name] = v
    return out


def pipeline_pair(code_name, decoder_type, sharing, base_iters, post_iters, snr=(3.0, 4.0),
                  train_kw=None, **pipe_kw):
    """(port pipeline on the CPU, JAX pipeline) on the same configuration."""
    code, jcode = get_code(code_name), jax_get_code(code_name)
    kw = dict(batch_size=16, is_y_all_zero=True, verbose=False, **(train_kw or {}))
    pipe = BoostedPipeline(
        TannerGraph.from_basegraph(code.basegraph, code.Z),
        AWGNChannel(code, ChannelConfig(snr_db=snr), device="cpu"),
        BoostedDecoderConfig(n_iterations=base_iters, decoder_type=DecoderType[decoder_type],
                             sharing=NodeWeightSharingConfig(**sharing)),
        TrainConfig(**kw), TrainConfig(**kw),
        BoostedPipelineConfig(base_iters=base_iters, post_iters=post_iters, **pipe_kw))
    jkw = {k: v for k, v in kw.items() if k != "learning_rate"}
    jpipe = JaxPipeline(
        JaxTannerGraph.from_basegraph(jcode.basegraph, jcode.Z),
        JaxChannel(jcode, JaxChannelConfig(snr_db=snr)),
        JaxConfig(n_iterations=base_iters, decoder_type=JaxType[decoder_type],
                  sharing=JaxSharing(**sharing)),
        JaxTrainConfig(**jkw), JaxTrainConfig(**jkw),
        JaxPipelineConfig(base_iters=base_iters, post_iters=post_iters, **pipe_kw))
    return pipe, jpipe


@pytest.mark.parametrize("sharing,post_ucn", [
    (dict(cn=3), 2), (dict(cn=3, vn=3), 2), (dict(cn=2, ucn=2, vn=0), None),
    (dict(cn=1, vn=2), 1)])
def test_extended_config_and_post_train_match_jax(sharing, post_ucn):
    pipe, jpipe = pipeline_pair(BG2, "QMS", sharing, 3, 2, post_ucn_sharing=post_ucn)
    # field for field over the port's fields; JAX's config also has the
    # routing fields of its edge path (routing, cn_reduce, matmul_precision)
    ours = _enum_values(pipe.extended_config())
    theirs = _enum_values(jpipe.extended_config())
    assert ours == {k: theirs[k] for k in ours}
    ours, theirs = dataclasses.asdict(pipe.post_train), dataclasses.asdict(jpipe.post_train)
    for k in ("training_iter_start", "training_iter_end", "train_only_params", "batch_size"):
        assert ours[k] == theirs[k], k
    assert pipe.post_decoder.config.n_iterations == 5


@pytest.mark.parametrize("sharing,post_ucn", [
    (dict(cn=3), 2), (dict(cn=3, vn=3), 2), (dict(cn=2, ucn=2, vn=0), None),
    (dict(cn=2, vn=2), 2), (dict(cn=1, vn=2), 1),
    (dict(cn=3, ucn=3, vn=3), 2)])  # the boosted_error_floor preset's: base UCN rows widen
def test_transfer_base_params_matches_jax_bit_for_bit(sharing, post_ucn):
    pipe, jpipe = pipeline_pair(BG2, "QMS", sharing, 3, 2, post_ucn_sharing=post_ucn)
    rng = np.random.default_rng(7)
    base = {k: (np.asarray(v) * (1 + 0.3 * rng.standard_normal(v.shape))).astype(np.float32)
            for k, v in jpipe.base_decoder.init_params().items()}
    ours = pipe.transfer_base_params({k: torch.as_tensor(v) for k, v in base.items()})
    theirs = jpipe.transfer_base_params({k: jnp.asarray(v) for k, v in base.items()})
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=k)
    if "weight_ucn" not in base:  # the UCN rows of the frozen iterations are seeded
        assert not np.array_equal(ours["weight_ucn"][:3].numpy(), np.ones((3, 1)))


def test_transfer_refuses_ucn_rows_of_another_width_as_jax():
    # per-edge CN rows cannot seed per-check UCN rows
    pipe, jpipe = pipeline_pair(BG2, "QMS", dict(cn=1), 2, 1)
    base = {"weight_cn": np.ones((2, pipe.graph.E), np.float32)}
    with pytest.raises(ValueError, match="cannot seed UCN rows") as ours:
        pipe.transfer_base_params({k: torch.as_tensor(v) for k, v in base.items()})
    with pytest.raises(ValueError, match="cannot seed UCN rows") as theirs:
        jpipe.transfer_base_params({k: jnp.asarray(v) for k, v in base.items()})
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("base_iters,kw,match", [
    (4, dict(base_iters=3), "must equal pipeline.base_iters"),
    (3, dict(base_iters=3, post_ucn_sharing=None), "requires UCN sharing"),
])
def test_constructor_errors_match_jax(base_iters, kw, match):
    code, jcode = get_code(WMAN), jax_get_code(WMAN)
    with pytest.raises(ValueError, match=match):
        BoostedPipeline(TannerGraph.from_basegraph(code.basegraph, code.Z),
                        AWGNChannel(code, device="cpu"),
                        BoostedDecoderConfig(n_iterations=base_iters), TrainConfig(),
                        TrainConfig(), BoostedPipelineConfig(**kw))
    with pytest.raises(ValueError, match=match):
        JaxPipeline(JaxTannerGraph.from_basegraph(jcode.basegraph, jcode.Z),
                    JaxChannel(jcode), JaxConfig(n_iterations=base_iters), JaxTrainConfig(),
                    JaxTrainConfig(), JaxPipelineConfig(**kw))


def test_pipeline_config_fields_are_jax_fields():
    ours = {f.name: f.default for f in dataclasses.fields(BoostedPipelineConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxPipelineConfig)}
    assert ours == theirs


def test_collect_finds_real_failures():
    """tests/test_pipelines.py's harvest (wman MS x2 cn=3 at 2 dB) in the
    port: every harvested word fails the port's base decode."""
    pipe, _ = pipeline_pair(WMAN, "MS", dict(cn=3), 2, 1, snr=(2.0,), collect_words=32,
                            collect_batch_size=64, collect_snr_index=0)
    params = pipe.base_decoder.init_params()
    llr, bits = pipe.collect_uncorrected_words(params, verbose=False)
    assert llr.shape == (32, 24, 24) and bits.shape == (32, 576)
    assert llr.dtype == np.float32 and bits.dtype == np.float32
    out = pipe.base_decoder.apply(params, torch.as_tensor(llr))[-1].numpy()
    decided = (out < 0).astype(np.int64)
    assert ((decided != bits.astype(np.int64)).any(axis=1)).all()


def test_collect_raises_when_nothing_fails():
    pipe, _ = pipeline_pair(WMAN, "MS", dict(cn=3), 2, 1, snr=(12.0,), collect_words=4,
                            collect_batch_size=8, max_collect_batches=2)
    with pytest.raises(RuntimeError, match="no uncorrected words"):
        pipe.collect_uncorrected_words(pipe.base_decoder.init_params(), verbose=False)


def test_post_datagen_mixes_the_pool_as_jax():
    pipe, jpipe = pipeline_pair(WMAN, "MS", dict(cn=3), 2, 1, pool_mix_ratio=0.25)
    rng = np.random.default_rng(3)
    llr_pool = rng.standard_normal((40, 24, 24)).astype(np.float32)
    bits_pool = (rng.random((40, 576)) < 0.5).astype(np.float32)
    ours = pipe.make_post_datagen(llr_pool, bits_pool, np.random.default_rng(11))
    theirs = jpipe.make_post_datagen(llr_pool, bits_pool, np.random.default_rng(11))
    for _ in range(2):
        x, y = ours(16)
        jx, jy = theirs(16)
        assert x.shape == jx.shape == (16, 24, 24) and y.shape == jy.shape == (16, 576)
        assert x.dtype == y.dtype == np.float32
        # the pool share: the same rows as JAX's (same numpy generator)
        np.testing.assert_array_equal(x[:4], jx[:4])
        np.testing.assert_array_equal(y[:4], jy[:4])
        # the rest: fresh all-zero words from the port's channel
        assert not np.isin(x[4:, 0, 0], llr_pool[:, 0, 0]).any()
        assert (y[4:] == 0).all()


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_pipeline_end_to_end(tmp_path, engine):
    """tests/test_pipelines.py's end-to-end run in the port, on each
    gradient engine (the fused one through the kernels' plain versions)."""
    pipe, _ = pipeline_pair(
        WMAN, "MS", dict(cn=3), 3, 2,
        train_kw=dict(total_epochs=1, train_words_per_epoch=64, validate_words=32,
                      validate_epoch_step=1, checkpoint_step=1, checkpoint_dir=str(tmp_path),
                      learning_rate=LearningRate(1e-3, 0, 0), engine=engine),
        collect_words=64, collect_batch_size=64, collect_snr_index=0, max_collect_batches=50)
    base_params, ext_params, report = pipe.run(verbose=False)
    assert report["collected_words"] > 0 and "stage1" in report and "stage2" in report
    # base rows transferred and frozen
    assert torch.equal(ext_params["weight_cn"][:3], base_params["weight_cn"])
    assert ext_params["weight_cn"].shape == (5, 1)
    # the post stage trains ONLY the UCN weights: CN post rows stay at 1.0
    assert (ext_params["weight_cn"][3:] == 1.0).all()
    # frozen base UCN rows are seeded from the base CN scalars
    assert torch.equal(ext_params["weight_ucn"][:3],
                       base_params["weight_cn"].expand(3, ext_params["weight_ucn"].shape[1]))
    assert (ext_params["weight_ucn"][3:] - 1.0).abs().max() > 0


# ---------------------------------------------------------------------------
# Greedy per-layer training (Dai)
# ---------------------------------------------------------------------------
def greedy_pair(n_iter=3, snr=(6.0, 4.0, 3.0), **cfg):
    code, jcode = get_code(WMAN), jax_get_code(WMAN)
    dec = NeuralMinSumDecoder(TannerGraph.from_basegraph(code.basegraph, code.Z),
                              NeuralDecoderConfig(n_iterations=n_iter), device="cpu")
    jdec = JaxNeuralDecoder(JaxTannerGraph.from_basegraph(jcode.basegraph, jcode.Z),
                            JaxNeuralConfig(n_iterations=n_iter, matmul_precision="highest"))
    trainer = GreedyLayerTrainer(dec, AWGNChannel(code, ChannelConfig(snr_db=snr), device="cpu"),
                                 GreedyTrainConfig(verbose=False, **cfg))
    jtrainer = JaxGreedy(jdec, JaxChannel(jcode, JaxChannelConfig(snr_db=snr)),
                         JaxGreedyConfig(verbose=False, **cfg))
    return trainer, jtrainer


def test_greedy_step_matches_jax():
    """Three steps over layers 1, 2, 1 on identical params, optimizer state
    and batches: params, moments and losses within 1e-6, and each step moves
    only its layer's rows."""
    trainer, jtrainer = greedy_pair()
    params = trainer.decoder.init_params()
    opt = trainer.init_optimizer_state(params)
    jparams = jtrainer.decoder.init_params()
    jopt = jtrainer.init_optimizer_state(jparams)
    assert set(opt) == set(jopt) == {"m", "v", "t"}
    rng = np.random.default_rng(5)
    for layer, sigma in ((1, 0.7), (2, 0.8), (1, 0.7)):
        llr = (2 * (1 + sigma * rng.standard_normal((16, 24, 24))) / sigma**2).astype(np.float32)
        bits = np.zeros((16, 576), np.float32)
        new, opt, loss = trainer._step(params, opt, torch.as_tensor(llr),
                                       torch.as_tensor(bits), layer)
        jparams, jopt, jloss = jtrainer._step(jparams, jopt, jnp.asarray(llr),
                                              jnp.asarray(bits), jnp.int32(layer))
        np.testing.assert_allclose(loss.item(), float(jloss), **GREEDY_TOL)
        for k in params:
            np.testing.assert_allclose(new[k].numpy(), np.asarray(jparams[k]), err_msg=k,
                                       **GREEDY_TOL)
            np.testing.assert_allclose(opt["m"][k].numpy(), np.asarray(jopt["m"][k]), **GREEDY_TOL)
            others = [i for i in range(3) if i != layer]
            assert torch.equal(new[k][others], params[k][others]), k
            assert not torch.equal(new[k][layer], params[k][layer]), k
        np.testing.assert_array_equal(opt["t"].numpy(), np.asarray(jopt["t"]))
        params = new


def test_greedy_training_moves_weights_and_rejects_a_wrong_curriculum():
    trainer, _ = greedy_pair(total_epochs=3, batch_size=16, learning_rate=2e-2)
    params, opt, report = trainer.train()
    assert len(report["layer_losses"]) == 3 and all(np.isfinite(report["layer_losses"]))
    assert (params["weights_var"] - 0.5).abs().max() > 1e-3
    assert opt["t"].tolist() == [3.0, 3.0, 3.0]
    code = get_code(WMAN)
    dec = NeuralMinSumDecoder(TannerGraph.from_basegraph(code.basegraph, code.Z),
                              NeuralDecoderConfig(n_iterations=4), device="cpu")
    with pytest.raises(ValueError, match="curriculum"):
        GreedyLayerTrainer(dec, AWGNChannel(code, ChannelConfig(snr_db=(6.0, 5.0)), device="cpu"))


def test_greedy_config_and_curriculum_are_jax_s():
    assert DAI_SNR_CURRICULUM == JAX_CURRICULUM
    ours = {f.name: f.default for f in dataclasses.fields(GreedyTrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxGreedyConfig)}
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        assert (ours[k].value if k == "loss_type" else ours[k]) == \
            (v.value if k == "loss_type" else v), k


def test_neural_params_from_jax_arrays():
    trainer, jtrainer = greedy_pair()
    jp = jtrainer.decoder.init_params()
    ours = neural_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    for k in jp:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(jp[k]))


# ---------------------------------------------------------------------------
# The train CLI's two recipes
# ---------------------------------------------------------------------------
def _write_config(tmp_path, preset, **overrides):
    cfg = json.loads(JAX_PRESETS[preset].to_json())
    cfg.update(checkpoint_dir=str(tmp_path / "ckpt"), **overrides)
    path = tmp_path / f"{preset}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_greedy_mode(tmp_path, capsys):
    cfg = _write_config(tmp_path, "wman_neural_train", n_iterations=3, snr_db=[4.0, 3.0, 2.0],
                        total_epochs=1, batch_size=8)
    assert train_cli.main(["--config", cfg, "--device", "cpu"]) == 0
    assert "greedy training done:" in capsys.readouterr().out
    ck = tmp_path / "ckpt"
    with np.load(ck / "greedy_final.npz") as data:
        assert sorted(data.files) == sorted(
            f"{k}_{i}" for k in ("weights_var", "biases_var") for i in range(3))
    assert (ck / "greedy_final_weights_txt" / "index.txt").exists()


def test_cli_boosted_mode(tmp_path, capsys):
    cfg = _write_config(tmp_path, "boosted_error_floor", base_iters=2, post_iters=1,
                        total_epochs=1, batch_size=4, train_words_per_epoch=8,
                        validate_words=4, collect_words=8, engine="fused")
    assert train_cli.main(["--config", cfg, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert 'boosted pipeline done: {"collected_words": 8}' in out
    ck = tmp_path / "ckpt"
    with np.load(ck / "boosted_final.npz") as data:
        assert {"weight_CN_0", "weight_UCN_2", "weight_VN_2"} <= set(data.files)
        assert float(data["weight_CN_2"][0]) == 1.0  # the post CN row stays neutral
    assert (ck / "boosted_final_weights_txt" / "index.txt").exists()
