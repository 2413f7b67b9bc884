"""Greedy per-layer training (Dai et al.) for the neural min-sum decoder.

Port of ``neural_ldpc_tpu/training/greedy.py``.  Reference workflow:
test/test_neural_ldpc_decoder/test_NeuralLDPCDecoder.py — 25 unrolled
iterations with a 25-entry decreasing-SNR curriculum (one SNR per layer,
:34-36), batch 50, one Adam optimizer PER iteration over that iteration's
(weight, bias) pair (:75-76); each epoch trains every layer once on data
drawn at its own SNR with BCE on that layer's output (:90-113).

One step takes the gradient through the full unrolled decoder (autograd
through ``NeuralMinSumDecoder.apply``) and a per-row Adam (independent
moments and step counts per layer, like the reference's optimizer list)
updates that layer's row only, in the JAX step's arithmetic.  Data: one key
per batch from a CPU ``torch.Generator(seed)`` (``utils/rng.py``), as the
port's ``Trainer`` draws it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..channel.awgn import AWGNChannel
from ..models.neural_decoder import NeuralMinSumDecoder
from ..structs import LossType
from ..utils.rng import channel_seed, next_key
from .loss import multi_iteration_loss

# Dai et al. 25-layer SNR curriculum (reference test :34-36)
DAI_SNR_CURRICULUM = (
    9.0, 6.05, 4.1, 2.95, 2.25, 1.8, 1.55, 1.3, 1.15, 1.05, 0.94, 0.85,
    0.83, 0.81, 0.8, 0.8, 0.8, 0.75, 0.75, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7,
)


@dataclasses.dataclass
class GreedyTrainConfig:
    total_epochs: int = 100
    batch_size: int = 50
    learning_rate: float = 5e-3
    # BCE is the reference's greedy loss, but it is bitwise and can improve
    # BER while hurting FER; FEROnAllZero trains each layer on the
    # frame-error surrogate instead (all-zero codewords only).
    loss_type: LossType = LossType.BCE
    is_y_all_zero: bool = True
    seed: int = 2042
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    verbose: bool = True
    log_every_epochs: int = 10


class GreedyLayerTrainer:
    """Per-layer curriculum trainer.  ``channel`` must be built with one SNR
    per decoder layer (e.g. DAI_SNR_CURRICULUM), on the decoder's device."""

    def __init__(
        self,
        decoder: NeuralMinSumDecoder,
        channel: AWGNChannel,
        config: GreedyTrainConfig = GreedyTrainConfig(),
    ):
        if len(channel.sigma) != decoder.config.n_iterations:
            raise ValueError(
                f"curriculum length {len(channel.sigma)} != layers "
                f"{decoder.config.n_iterations}"
            )
        if channel.device != decoder.device:
            raise ValueError(f"channel on {channel.device}, decoder on {decoder.device}")
        self.decoder = decoder
        self.channel = channel
        self.cfg = config

    def init_optimizer_state(self, params):
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        steps = torch.zeros((self.decoder.config.n_iterations,), dtype=torch.float32,
                            device=self.decoder.device)
        return {"m": zeros, "v": dict(zeros), "t": steps}

    def _step(self, params, opt, llr, bits, layer: int):
        """One step on ``layer``: ``(new_params, new_opt, loss)``."""
        cfg = self.cfg
        keys = list(params)
        p = {k: params[k].detach().requires_grad_(True) for k in keys}
        outputs = self.decoder.apply(p, llr)
        loss = multi_iteration_loss(outputs[layer][None], bits, cfg.loss_type,
                                    convention=self.decoder.config.convention)
        grads = dict(zip(keys, torch.autograd.grad(loss, [p[k] for k in keys])))
        t = opt["t"][layer] + 1.0
        new_params, new_m, new_v = {}, {}, {}
        with torch.no_grad():
            for k in keys:
                g = grads[k][layer]
                m = cfg.adam_b1 * opt["m"][k][layer] + (1 - cfg.adam_b1) * g
                v = cfg.adam_b2 * opt["v"][k][layer] + (1 - cfg.adam_b2) * g * g
                mhat = m / (1 - torch.pow(cfg.adam_b1, t))
                vhat = v / (1 - torch.pow(cfg.adam_b2, t))
                upd = -cfg.learning_rate * mhat / (torch.sqrt(vhat) + cfg.adam_eps)
                new_params[k] = params[k].clone()
                new_params[k][layer] = params[k][layer] + upd
                new_m[k] = opt["m"][k].clone()
                new_m[k][layer] = m
                new_v[k] = opt["v"][k].clone()
                new_v[k][layer] = v
            new_t = opt["t"].clone()
            new_t[layer] = t
        return new_params, {"m": new_m, "v": new_v, "t": new_t}, loss.detach()

    def train(self, params=None, opt_state: Optional[dict] = None):
        cfg = self.cfg
        n_layers = self.decoder.config.n_iterations
        params = params if params is not None else self.decoder.init_params()
        opt_state = opt_state if opt_state is not None else self.init_optimizer_state(params)
        gen = torch.Generator().manual_seed(cfg.seed)
        # per-layer losses stay on the device; read at log lines and the end
        last_losses = [torch.zeros(())] * n_layers
        for epoch in range(cfg.total_epochs):
            for layer in range(n_layers):
                g = self.channel.generator(channel_seed(next_key(gen)))
                llr, bits = self.channel.sample_at(g, cfg.batch_size, layer,
                                                   all_zero=cfg.is_y_all_zero)
                params, opt_state, last_losses[layer] = self._step(
                    params, opt_state, llr, bits, layer)
            if cfg.verbose and epoch % cfg.log_every_epochs == 0:
                losses = np.array([float(l) for l in last_losses])
                print(f"greedy epoch {epoch}/{cfg.total_epochs}: "
                      f"layer losses {losses.round(4).tolist()}")
        return params, opt_state, {"layer_losses": [float(l) for l in last_losses]}
