"""Experiment configuration: dataclass configs with JSON round-trip and named
presets covering the five BASELINE.json workloads.

Port of ``neural_ldpc_tpu/utils/config.py``, field for field: a config saved
by either package loads in the other.  The ``build_*`` methods return the
port's code, graph, decoder configuration, channel (on the device the caller
names) and training configuration.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Optional

from ..device import DeviceLike
from ..structs import (
    Clipping,
    Convention,
    DecoderType,
    LossType,
    NodeWeightSharingConfig,
    Puncture,
    SharingMode,
    Shortening,
)


@dataclasses.dataclass
class ExperimentConfig:
    # code / model
    code: str = "nr_bg2_set0_z16"
    decoder_type: DecoderType = DecoderType.QMS
    n_iterations: int = 20
    qms_qbit: int = 5
    cn_sharing: SharingMode = SharingMode.ITER
    ucn_sharing: SharingMode = SharingMode.NONE
    vn_sharing: SharingMode = SharingMode.ITER
    convention: Convention = Convention.STANDARD
    llr_clip: float = 20.0
    weight_clip: tuple[float, float] = (0.0, 2.0)
    init_cn_weight: float = 1.0
    init_ucn_weight: float = 1.0
    init_vn_weight: float = 1.0
    fixed_iterative_nodes: tuple[int, ...] = ()
    fixed_iterative_nodes_init_weight: int = 0

    # channel
    snr_db: tuple[float, ...] = (2.0, 2.5, 3.0, 3.5, 4.0)
    puncture: tuple[int, int] = (0, 0)
    shortening: tuple[int, int] = (0, 0)
    y_all_zero: bool = False
    qms_channel_quantize: bool = True
    # derive a generator matrix from H (GF(2) elimination, codes/gf2.py) when
    # the code ships none — enables random codewords for e.g. wman
    derive_gen_matrix: bool = False

    # training
    mode: str = "standard"  # standard | greedy | boosted
    total_epochs: int = 500
    batch_size: int = 20
    train_words_per_epoch: int = 10000
    validate_words: int = 1000
    learning_rate: float = 1e-3
    lr_decay_rate: float = 0.0
    lr_decay_steps: int = 0
    loss_type: LossType = LossType.BCE
    etha: float = 1.0
    grad_clip_norm: float = 1.0
    # gradient engine: "xla" (the plain decoder's autograd) or "fused"
    engine: str = "xla"
    patience: int = 10
    min_delta: float = 1e-5
    validate_epoch_step: int = 5
    checkpoint_step: int = 5
    checkpoint_dir: str = "checkpoints"
    seed: int = 2042

    # boosted pipeline
    base_iters: int = 20
    post_iters: int = 5
    collect_words: int = 2048

    # eval / parallel
    eval_batch_size: int = 1024
    eval_max_words_per_snr: int = 1_000_000
    eval_min_frame_errors: int = 100
    mesh_devices: Optional[int] = None

    # ------------------------------------------------------------------
    def build_code(self):
        from ..codes import get_code

        code = get_code(self.code)
        if self.derive_gen_matrix and code.gen_matrix is None:
            code = code.with_derived_generator()
        return code

    def build_graph(self):
        from ..codes import TannerGraph

        code = self.build_code()
        return code, TannerGraph.from_basegraph(code.basegraph, code.Z)

    def build_decoder_config(self, n_iterations: Optional[int] = None):
        from ..models import BoostedDecoderConfig

        return BoostedDecoderConfig(
            n_iterations=n_iterations if n_iterations is not None else self.n_iterations,
            decoder_type=self.decoder_type,
            qms_qbit=self.qms_qbit,
            sharing=NodeWeightSharingConfig(
                cn=self.cn_sharing, ucn=self.ucn_sharing, vn=self.vn_sharing
            ),
            fixed_iterative_nodes=tuple(self.fixed_iterative_nodes),
            fixed_iterative_nodes_init_weight=self.fixed_iterative_nodes_init_weight,
            allowed_weight_range=Clipping(self.weight_clip[0], self.weight_clip[1]),
            allowed_llr_range=Clipping.of(abs=self.llr_clip),
            init_cn_weight=self.init_cn_weight,
            init_ucn_weight=self.init_ucn_weight,
            init_vn_weight=self.init_vn_weight,
            convention=self.convention,
        )

    def build_channel(self, code=None, device: DeviceLike = "cuda"):
        from ..channel import AWGNChannel, ChannelConfig

        code = code or self.build_code()
        qbit = self.qms_qbit if (
            self.qms_channel_quantize and self.decoder_type == DecoderType.QMS
        ) else None
        return AWGNChannel(code, ChannelConfig(
            snr_db=tuple(self.snr_db),
            puncture=Puncture(*self.puncture),
            shortening=Shortening(*self.shortening),
            allowed_llr_range=Clipping.of(abs=self.llr_clip),
            convention=self.convention,
            qms_qbit=qbit,
            # the reference keeps punctured LLRs epsilon-alive for SP so
            # tanh(0) does not annihilate the check products
            sp_puncture_value=0.001 if self.decoder_type == DecoderType.SP else 0.0,
        ), device=device)

    def build_train_config(self):
        from ..training import LearningRate, TrainConfig

        return TrainConfig(
            total_epochs=self.total_epochs,
            batch_size=self.batch_size,
            train_words_per_epoch=self.train_words_per_epoch,
            validate_words=self.validate_words,
            loss_type=self.loss_type,
            etha=self.etha,
            learning_rate=LearningRate(self.learning_rate, self.lr_decay_rate,
                                       self.lr_decay_steps),
            grad_clip_norm=self.grad_clip_norm,
            engine=self.engine,
            is_y_all_zero=self.y_all_zero,
            patience=self.patience,
            min_delta=self.min_delta,
            validate_epoch_step=self.validate_epoch_step,
            checkpoint_step=self.checkpoint_step,
            checkpoint_dir=self.checkpoint_dir,
            seed=self.seed,
        )

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        def enc(v):
            if isinstance(v, enum.Enum):
                return v.value
            if isinstance(v, tuple):
                return list(v)
            return v

        return json.dumps({k: enc(v) for k, v in dataclasses.asdict(self).items()},
                          indent=2)

    @staticmethod
    def from_json(text: str) -> "ExperimentConfig":
        return ExperimentConfig.from_dict(json.loads(text))

    @staticmethod
    def from_dict(raw: dict[str, Any]) -> "ExperimentConfig":
        kwargs: dict[str, Any] = {}
        fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
        converters = {
            "decoder_type": lambda v: DecoderType(v) if not isinstance(v, DecoderType) else v,
            "loss_type": lambda v: LossType(v) if not isinstance(v, LossType) else v,
            "convention": lambda v: Convention(v) if not isinstance(v, Convention) else v,
            "cn_sharing": SharingMode,
            "ucn_sharing": SharingMode,
            "vn_sharing": SharingMode,
        }
        for k, v in raw.items():
            if k not in fields:
                raise KeyError(f"unknown config field {k!r}")
            if k in converters:
                v = converters[k](v)
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return ExperimentConfig(**kwargs)

    def override(self, **kwargs) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)


# ----------------------------------------------------------------------
# Named presets — the five BASELINE.json configs.
# ----------------------------------------------------------------------
PRESETS: dict[str, ExperimentConfig] = {
    # 1. Plain weighted min-sum decode, WiMAX, 5 iterations (parity/eval config)
    "wman_ms_plain": ExperimentConfig(
        code="wman_n576_r34_z24", decoder_type=DecoderType.MS, n_iterations=5,
        cn_sharing=SharingMode.ITER, vn_sharing=SharingMode.NONE,
        y_all_zero=True, batch_size=128, snr_db=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0),
    ),
    # 2. Neural (Dai) decoder training on wman, 20 unrolled iterations, 1-4 dB
    "wman_neural_train": ExperimentConfig(
        code="wman_n576_r34_z24", decoder_type=DecoderType.MS, n_iterations=20,
        mode="greedy", y_all_zero=True, batch_size=50, learning_rate=5e-3,
        snr_db=(4.0, 3.5, 3.0, 2.8, 2.6, 2.4, 2.2, 2.0, 1.9, 1.8,
                1.7, 1.6, 1.5, 1.4, 1.3, 1.2, 1.15, 1.1, 1.05, 1.0),
    ),
    # 3. 5G BG2 protograph decoder (the reference training script's default)
    "bg2_qms_train": ExperimentConfig(
        code="nr_bg2_set0_z16", decoder_type=DecoderType.QMS, n_iterations=20,
        qms_qbit=5, cn_sharing=SharingMode.ITER, vn_sharing=SharingMode.ITER,
        batch_size=20, learning_rate=1e-3, y_all_zero=False,
    ),
    # 4. Boosted error-floor pipeline (Kwak): base + post decoder
    "boosted_error_floor": ExperimentConfig(
        code="nr_bg2_set0_z16", decoder_type=DecoderType.QMS, n_iterations=20,
        mode="boosted", base_iters=20, post_iters=5,
        cn_sharing=SharingMode.ITER, ucn_sharing=SharingMode.ITER,
        vn_sharing=SharingMode.ITER, y_all_zero=True,
        snr_db=(3.5, 4.0, 4.5),
    ),
    # 5. Monte-Carlo BER campaign
    "montecarlo_campaign": ExperimentConfig(
        code="wman_n576_r34_z24", decoder_type=DecoderType.MS, n_iterations=20,
        y_all_zero=True, snr_db=(1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0),
        eval_batch_size=4096, eval_max_words_per_snr=10_000_000,
        eval_min_frame_errors=200,
    ),
}


def get_preset(name: str) -> ExperimentConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}") from None
