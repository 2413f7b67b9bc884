"""The port's experiment configs, checkpoints and evaluate CLI against the
JAX package's: presets serialise identically, params files cross-load both
ways, and the CLI writes the JAX CLI's JSON keys."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from neural_ldpc_tpu.cli import evaluate as jax_evaluate
from neural_ldpc_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from neural_ldpc_tpu.utils.config import PRESETS as JAX_PRESETS
from neural_ldpc_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from neural_ldpc_tpu_torch.cli import evaluate
from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
from neural_ldpc_tpu_torch.utils import CheckpointManager
from neural_ldpc_tpu_torch.utils.config import PRESETS, ExperimentConfig, get_preset
from test_torch_decoder import BG2, build_pair, random_weights


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_presets_serialise_as_the_jax_presets(name):
    assert PRESETS[name].to_json() == JAX_PRESETS[name].to_json()
    # a config written by either package loads in the other
    assert ExperimentConfig.from_json(JAX_PRESETS[name].to_json()) == PRESETS[name]
    assert JaxExperimentConfig.from_json(PRESETS[name].to_json()).to_json() == \
        PRESETS[name].to_json()


def test_config_build_methods_and_unported_training():
    cfg = get_preset("bg2_qms_train")
    code, graph = cfg.build_graph()
    assert (graph.N, graph.Z) == (52, 16)
    ch = cfg.build_channel(code, device="cpu")
    assert ch.config.qms_qbit == 5 and ch.device.type == "cpu"
    assert cfg.build_decoder_config().n_iterations == 20
    assert cfg.override(n_iterations=3).n_iterations == 3
    with pytest.raises(KeyError, match="unknown config field"):
        ExperimentConfig.from_dict({"nope": 1})
    with pytest.raises(KeyError, match="unknown preset"):
        get_preset("nope")
    # training is ported: the port's TrainConfig, field for field JAX's
    tc = cfg.override(engine="fused", lr_decay_rate=0.5, lr_decay_steps=3).build_train_config()
    jtc = JAX_PRESETS["bg2_qms_train"].override(
        engine="fused", lr_decay_rate=0.5, lr_decay_steps=3).build_train_config()
    for f in dataclasses.fields(jtc):
        a, b = getattr(tc, f.name), getattr(jtc, f.name)
        if f.name == "learning_rate":
            assert [a.value_at(k) for k in range(8)] == [b.value_at(k) for k in range(8)]
        elif f.name == "loss_type":
            assert a.value == b.value
        else:
            assert a == b, f.name
    assert {f.name for f in dataclasses.fields(tc)} == {f.name for f in dataclasses.fields(jtc)}


def _bg2_params():
    code, dec, jdec = build_pair(BG2, "QMS", dict(cn=3, vn=3), 4)
    return dec, jdec, random_weights(jdec, seed=8)


def test_jax_checkpoint_params_load_in_the_port(tmp_path):
    dec, jdec, w = _bg2_params()
    jm = JaxCheckpointManager(str(tmp_path))
    jm.save("ck", {k: jnp.asarray(v) for k, v in w.items()}, epoch=3,
            extra_arrays={"words": np.arange(3)})
    params, opt, meta, rng, extras = CheckpointManager(str(tmp_path)).load(
        "ck", dec.init_params())
    assert opt is None and rng is None and meta["epoch"] == 3
    np.testing.assert_array_equal(extras["words"], np.arange(3))
    for k, v in w.items():
        assert params[k].dtype == torch.float32
        np.testing.assert_array_equal(params[k].numpy(), v)


def test_port_checkpoint_loads_in_jax(tmp_path):
    dec, jdec, w = _bg2_params()
    gen = torch.Generator().manual_seed(4)
    CheckpointManager(str(tmp_path)).save(
        "ck", {k: torch.tensor(v) for k, v in w.items()}, rng_state=gen.get_state(),
        opt_state={"mu": [torch.ones(2), torch.zeros(3)]})
    params, _, _, key, _ = JaxCheckpointManager(str(tmp_path)).load("ck", jdec.init_params())
    assert key is None
    for k, v in w.items():
        np.testing.assert_array_equal(np.asarray(params[k]), v)
    _, opt, _, rng, _ = CheckpointManager(str(tmp_path)).load(
        "ck", {k: torch.tensor(v) for k, v in w.items()},
        opt_state_template={"mu": [torch.empty(2), torch.empty(3)]})
    np.testing.assert_array_equal(opt["mu"][1].numpy(), np.zeros(3))
    assert torch.equal(rng, gen.get_state())


def test_campaign_refuses_a_jax_state_with_a_threefry_key(tmp_path):
    import jax

    dec, jdec, w = _bg2_params()
    JaxCheckpointManager(str(tmp_path)).save(
        "mc_campaign", {k: jnp.asarray(v) for k, v in w.items()},
        rng_key=jax.random.PRNGKey(0),
        extra_arrays={"words": np.zeros(1, np.int64), "bit_errors": np.zeros((1, 1)),
                      "frame_errors": np.zeros((1, 1))})
    cfg = get_preset("bg2_qms_train").override(snr_db=(3.0,))
    camp = MonteCarloCampaign(dec, dec.init_params(), cfg.build_channel(device="cpu"),
                              CampaignConfig(engine="fused"))
    with pytest.raises(ValueError, match="threefry"):
        camp.restore_state(CheckpointManager(str(tmp_path)))


def test_save_weights_exports_and_the_cli_restacks_them(tmp_path):
    dec, jdec, w = _bg2_params()
    params = {k: torch.tensor(v) for k, v in w.items()}
    named = dec.named_parameter_rows(params)
    cm = CheckpointManager(str(tmp_path))
    cm.save_weights("weights", named, as_txt=True)
    assert os.path.exists(tmp_path / "weights_weights_txt" / "index.txt")
    back = evaluate.load_weights_npz(str(tmp_path / "weights.npz"), dec, dec.init_params())
    for k in params:
        np.testing.assert_array_equal(back[k].numpy(), params[k].numpy())


CLI_ARGS = ["--preset", "wman_ms_plain", "--snr", "3.0,4.0", "--batch-size", "16",
            "--max-words", "32", "--min-frame-errors", "0"]


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_evaluate_cli_writes_the_jax_cli_keys(tmp_path, engine, capsys):
    out = tmp_path / "ours.json"
    assert evaluate.main(CLI_ARGS + ["--engine", engine, "--device", "cpu",
                                     "--out", str(out)]) == 0
    ours = json.loads(out.read_text())
    jout = tmp_path / "theirs.json"
    assert jax_evaluate.main(CLI_ARGS + ["--engine", "xla", "--out", str(jout)]) == 0
    theirs = json.loads(jout.read_text())
    if engine == "fused":  # final-iteration stats only, as the JAX fused engine
        for r in theirs["results"].values():
            r["ber"], r["fer"], r["final_iter_only"] = r["ber"][-1:], r["fer"][-1:], True
    assert _keys(ours) == _keys(theirs)
    assert {k: ours[k] for k in ("code", "decoder", "n_iterations")} == \
        {k: theirs[k] for k in ("code", "decoder", "n_iterations")}
    for snr, r in ours["results"].items():
        assert r["words"] == 32 and len(r["ber"]) == len(theirs["results"][snr]["ber"])
        assert r["final_iter_only"] == (engine == "fused")


def test_evaluate_cli_resumes_from_its_state(tmp_path):
    state = str(tmp_path / "state")
    args = CLI_ARGS + ["--device", "cpu", "--engine", "fused", "--state-dir", state]
    evaluate.main(args + ["--out", str(tmp_path / "a.json")])
    evaluate.main(args + ["--resume", "--max-words", "64", "--out", str(tmp_path / "b.json")])
    a = json.loads((tmp_path / "a.json").read_text())["results"]
    b = json.loads((tmp_path / "b.json").read_text())["results"]
    assert [r["words"] for r in a.values()] == [32, 32]
    assert [r["words"] for r in b.values()] == [64, 64]


@pytest.mark.parametrize("flag,item", [
    (["--mesh-devices", "2"], "item 11"),
    (["--set", 'convention="reference"'], "item 9"),
    (["--set", "mesh_devices=2"], "item 11"),
])
def test_evaluate_cli_unported_flags_name_their_roadmap_item(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        evaluate.main(CLI_ARGS + ["--device", "cpu"] + flag)


def test_parse_helpers_match_jax():
    from neural_ldpc_tpu.cli.train import parse_overrides as jax_parse_overrides

    pairs = ["n_iterations=3", "code=wman_n576_r34_z24", "snr_db=[1.0, 2.0]"]
    assert evaluate.parse_overrides(pairs) == jax_parse_overrides(pairs)
    for spec in ("1.0:5.0:0.5", "2,3.5"):
        assert evaluate.parse_snr(spec) == jax_evaluate.parse_snr(spec)
