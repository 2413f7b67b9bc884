"""The REFERENCE convention's data path in the port: the reference's numpy
generators (``channel/reference_datagen.py``) equal to the JAX package's
arrays exactly, the REFERENCE ``AWGNChannel`` (rate quirk, inverted BPSK,
shortened bits at -clip) against JAX's bookkeeping and its own statistics,
one REFERENCE train step on the plain engine against JAX's, and the call
sites that take REFERENCE decoders: ``Trainer`` fed by the reference
generator, the boosted pipeline, and the train and evaluate CLIs."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ldpc_tpu.channel import AWGNChannel as JaxChannel
from neural_ldpc_tpu.channel import ChannelConfig as JaxChannelConfig
from neural_ldpc_tpu.channel import ReferenceAWGNDatagen as JaxRefDatagen
from neural_ldpc_tpu.channel import ReferenceNeuralDatagen as JaxNeuralDatagen
from neural_ldpc_tpu.codes import get_code as jax_get_code
from neural_ldpc_tpu.structs import Convention as JaxConvention
from neural_ldpc_tpu.structs import DecoderType as JaxType
from neural_ldpc_tpu.training import TrainConfig as JaxTrainConfig
from neural_ldpc_tpu.training import make_train_step as jax_make_train_step
from neural_ldpc_tpu.utils.config import PRESETS as JAX_PRESETS
from neural_ldpc_tpu_torch.channel import (
    AWGNChannel, ChannelConfig, ReferenceAWGNDatagen, ReferenceNeuralDatagen)
from neural_ldpc_tpu_torch.cli import evaluate
from neural_ldpc_tpu_torch.cli import train as train_cli
from neural_ldpc_tpu_torch.codes import TannerGraph, get_code
from neural_ldpc_tpu_torch.structs import Convention, DecoderType, Puncture, Shortening
from neural_ldpc_tpu_torch.training import TrainConfig, Trainer, make_train_step
from neural_ldpc_tpu_torch.training import multi_iteration_loss
from test_torch_edge import boosted_pair

WMAN, BG2 = "wman_n576_r34_z24", "nr_bg2_set0_z16"
REF = Convention.REFERENCE


# (gentype, words, all-zero, decoder type, puncture, shortening)
DATAGEN_CASES = [
    ("per_snr", 7, True, "MS", (0, 0), (0, 0)),
    ("mix_snr", 9, True, "QMS", (0, 0), (0, 0)),
    ("mix_snr", 6, True, "SP", (1, 16), (800, 808)),
    ("mix_snr", 5, False, "QMS", (1, 16), (0, 0)),
    ("per_snr", 4, False, "MS", (0, 0), (0, 0)),
]


@pytest.mark.parametrize("gentype,words,all_zero,decoder_type,punct,short", DATAGEN_CASES)
def test_reference_awgn_datagen_matches_jax(gentype, words, all_zero, decoder_type, punct,
                                            short):
    code = get_code(BG2)
    kw = dict(snr_db=np.array([2.0, 3.0, 4.0]), gen_matrix=code.gen_matrix)
    ours = ReferenceAWGNDatagen(code.N, code.M, puncturing=Puncture(*punct),
                                shortening=Shortening(*short), **kw)
    theirs = JaxRefDatagen(code.N, code.M, puncturing=Puncture(*punct),
                           shortening=Shortening(*short), **kw)
    # the reference counts punctured and shortened bits against base columns
    assert ours.code_rate == theirs.code_rate > 0
    for _ in range(2):  # the RandomState streams carry over between calls
        x, y = ours(gentype, words, code.Z, all_zero, DecoderType[decoder_type], 5)
        jx, jy = theirs(gentype, words, code.Z, all_zero, JaxType[decoder_type], 5)
        assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    flat = x.reshape(words, -1)
    if punct[0]:  # punctured bits: 0.001 for SP, else 0
        assert (flat[:, punct[0] - 1:punct[1]] == (0.001 if decoder_type == "SP" else 0.0)).all()
    if short[0]:
        assert (flat[:, short[0] - 1:short[1]] == -20.0).all()
    if decoder_type == "QMS":
        assert (flat * 2 == np.round(flat * 2)).all()
    with pytest.raises(AttributeError, match="gentype"):
        ours("nope", 1, code.Z)


@pytest.mark.parametrize("emulate_bpsk_bug", [False, True])
@pytest.mark.parametrize("all_zero", [True, False])
def test_reference_neural_datagen_matches_jax(emulate_bpsk_bug, all_zero):
    code = get_code(BG2)
    kw = dict(snr_db=np.array([1.0, 2.5]), gen_matrix=code.gen_matrix,
              emulate_bpsk_bug=emulate_bpsk_bug)
    ours = ReferenceNeuralDatagen(code.N, code.M, **kw)
    theirs = JaxNeuralDatagen(code.N, code.M, **kw)
    assert ours.code_rate == theirs.code_rate
    xs, ys = ours(6, code.Z, all_zero)
    jxs, jys = theirs(6, code.Z, all_zero)
    assert len(xs) == len(jxs) == 2
    for a, b in zip(xs + ys, jxs + jys):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


CHANNEL_CASES = [
    dict(snr_db=(2.0, 3.0)),
    dict(snr_db=(1.0, 4.0), puncture=Puncture(1, 16), shortening=Shortening(800, 808),
         qms_qbit=5, sp_puncture_value=0.001),
    dict(snr_db=(3.0,), rate_override=0.5),
]


@pytest.mark.parametrize("cfg", CHANNEL_CASES)
def test_reference_channel_bookkeeping_matches_jax(cfg):
    code = get_code(BG2)
    ch = AWGNChannel(code, ChannelConfig(convention=REF, **cfg), device="cpu")
    jch = JaxChannel(jax_get_code(BG2), JaxChannelConfig(convention=JaxConvention.REFERENCE,
                                                        **cfg))
    assert ch.rate == jch.rate
    assert np.isfinite(ch.sigma).all()
    np.testing.assert_array_equal(ch.sigma, jch.sigma)
    np.testing.assert_array_equal(ch._mask.numpy(), np.asarray(jch._mask))
    np.testing.assert_array_equal(ch._fill.numpy(), np.asarray(jch._fill))
    bits = (np.arange(2 * code.n_bits) % 3 == 0).astype(np.float32).reshape(2, -1)
    np.testing.assert_array_equal(ch.modulate(torch.tensor(bits)).numpy(),
                                  np.asarray(jch.modulate(jnp.asarray(bits))))


def test_reference_channel_statistics():
    """All-zero words: LLR mean -2/sigma^2 (bit 0 -> -1), variance 4/sigma^2;
    random codewords satisfy H and the LLR sign follows 2b - 1."""
    code = get_code(BG2)
    ch = AWGNChannel(code, ChannelConfig(snr_db=(1.0, 3.0), convention=REF), device="cpu")
    # the reference's rate: K / (N - 2) in base columns, as its default
    # Puncture(0, 0) / Shortening(0, 0) count one column each
    assert ch.rate == code.K / (code.N - 2)
    for i, sigma in enumerate(ch.sigma):
        x = ch.sample_at(ch.generator(i), 1000, i)[0].double()
        s2 = float(sigma) ** 2
        assert abs(x.mean().item() + 2 / s2) < 6 * (4 / s2) ** 0.5 / x.numel() ** 0.5
        assert x.var().item() == pytest.approx(4 / s2, rel=0.02)
    llr, bits = ch.sample_at(ch.generator(7), 64, 1, all_zero=False)
    H = TannerGraph.from_basegraph(code.basegraph, code.Z).lifted_parity_check_matrix()
    assert not ((bits.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2).any()
    assert ((llr.reshape(64, -1) > 0).float() == bits).float().mean() > 0.75


def _reference_batch(dec, words, seed=5):
    """A REFERENCE-convention batch of random codewords from the reference's
    generator (BG2 at the decoder's lift)."""
    code = get_code(BG2)
    gen = ReferenceAWGNDatagen(code.N, code.M, np.array([2.0, 3.0]), seed, seed + 1,
                               gen_matrix=code.gen_matrix)
    x, y = gen("mix_snr", words, code.Z, False, dec.config.decoder_type, dec.config.qms_qbit)
    return x, y.astype(np.float32)


def test_one_reference_train_step_matches_jax():
    """The plain engine's step against JAX's: loss within 1e-6; params within
    1e-6 where the plain engine's |g| > 1e-5, and within 2 lr elsewhere."""
    dec, jdec = boosted_pair(BG2, "QMS", dict(cn=3, vn=3), 3, "reference")
    rng = np.random.default_rng(3)
    params = {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in jdec.init_params().items()}
    llr, bits = _reference_batch(dec, 8)
    lr = 1e-3
    init, step = make_train_step(dec, TrainConfig(engine="xla"))
    p = {k: torch.tensor(v) for k, v in params.items()}
    new, opt, loss = step(p, init(p), torch.tensor(llr), torch.tensor(bits), lr)
    jinit, jstep = jax_make_train_step(jdec, JaxTrainConfig(engine="xla"))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jnew, _, jl = jstep(jp, jinit(jp), jnp.asarray(llr), jnp.asarray(bits), jnp.float32(lr))
    assert abs(loss.item() - float(jl)) < 1e-6
    pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    l_plain = multi_iteration_loss(dec.apply(pg, torch.tensor(llr)), torch.tensor(bits),
                                   coeff=list(range(3)), convention=REF)
    grads = dict(zip(pg, torch.autograd.grad(l_plain, list(pg.values()))))
    for k in params:
        diff = np.abs(new[k].numpy() - np.asarray(jnew[k]))
        big = np.abs(grads[k].numpy()) > 1e-5
        assert big.any() and diff[big].max() <= 1e-6, k
        assert diff.max() <= 2 * lr, k
    with pytest.raises(ValueError, match="STANDARD convention"):
        make_train_step(dec, TrainConfig(engine="fused"))


def test_trainer_on_the_reference_generator(tmp_path):
    """``Trainer`` fed by ``ReferenceAWGNDatagen`` (``host_datagen``) trains a
    REFERENCE decoder on the plain engine, validating on the REFERENCE
    channel."""
    dec, _ = boosted_pair(BG2, "QMS", dict(cn=3, vn=3), 3, "reference")
    code = get_code(BG2)
    gen = ReferenceAWGNDatagen(code.N, code.M, np.array([2.0, 3.0]), 2042, 1074,
                               gen_matrix=code.gen_matrix)
    channel = AWGNChannel(code, ChannelConfig(snr_db=(2.0, 3.0), convention=REF, qms_qbit=5),
                          device="cpu")
    cfg = TrainConfig(total_epochs=2, batch_size=4, train_words_per_epoch=8, validate_words=8,
                      validate_epoch_step=1, checkpoint_step=10**9, log_metrics_step=10**9,
                      progress_step=10**9, checkpoint_dir=str(tmp_path),
                      export_weights_txt=False, verbose=False)
    trainer = Trainer(dec, channel, cfg, host_datagen=lambda b: gen(
        "mix_snr", b, code.Z, False, DecoderType.QMS, 5))
    params, _, info = trainer.train()
    assert np.isfinite(info["best_loss"])
    assert float((params["weight_cn"] - 1.0).abs().max()) > 0


def _write_config(tmp_path, preset, **overrides):
    cfg = json.loads(JAX_PRESETS[preset].to_json())
    cfg.update(checkpoint_dir=str(tmp_path / "ckpt"), convention="reference", **overrides)
    path = tmp_path / f"{preset}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_train_reference_convention(tmp_path, capsys):
    """The train CLI's three modes on REFERENCE decoders (plain engine; the
    boosted harvest takes the plain decoder)."""
    runs = [
        ("bg2_qms_train", dict(n_iterations=2, total_epochs=1, batch_size=4,
                               train_words_per_epoch=8, validate_words=4), "training done:"),
        ("wman_neural_train", dict(n_iterations=2, snr_db=[4.0, 3.0], total_epochs=1,
                                   batch_size=4), "greedy training done:"),
        ("boosted_error_floor", dict(base_iters=2, post_iters=1, total_epochs=1, batch_size=4,
                                     train_words_per_epoch=8, validate_words=4,
                                     collect_words=4, snr_db=[1.0]),
         'boosted pipeline done: {"collected_words": 4}'),
    ]
    for preset, over, done in runs:
        cfg = _write_config(tmp_path, preset, **over)
        assert train_cli.main(["--config", cfg, "--device", "cpu"]) == 0
        assert done in capsys.readouterr().out, preset


def test_cli_evaluate_reference_convention(tmp_path):
    out = tmp_path / "r.json"
    evaluate.main(["--preset", "wman_ms_plain", "--snr", "3.0,5.0", "--batch-size", "16",
                   "--max-words", "32", "--min-frame-errors", "0", "--device", "cpu",
                   "--set", 'convention="reference"', "--out", str(out)])
    res = json.loads(out.read_text())["results"]
    assert [r["words"] for r in res.values()] == [32, 32]
    # the plain engine's per-iteration rows; decoding lowers the BER
    assert all(len(r["ber"]) == 5 and r["ber"][-1] <= r["ber"][0] for r in res.values())
