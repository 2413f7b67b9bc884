"""Training step and training driver.

Port of ``neural_ldpc_tpu/training/train_loop.py``: one step is forward,
BCE (or SoftBER / FER) over the trained iterations, backward, a global-norm
gradient clip, row freezing, Adam and the clamp projection of the weights
(the reference's train/train_BoostedNeuralLDPCDecoder.py:260-296); the epoch
driver validates every N epochs with a per-iteration BER table, stops early
on the validation loss, and writes checkpoints, weight exports and the
metrics log at their cadences.

Gradient engines: ``"xla"`` differentiates the plain decoder
(``BoostedNeuralDecoder.apply``) through autograd (the name is the JAX
engine's, kept for configs); ``"fused"`` runs ``FusedTrainDecoder.apply``,
whose gradients come from the hand-written forward (K1d) and backward (K2)
kernels on the card (K3 and K4, which keep the state in device memory, for
codes the on-chip kernels cannot hold), or from their plain versions on CPU
tensors.  With the BCE loss and one label a bit for every iteration
([B, N*Z]), the fused step's final clip, loss and their gradient are one
hand-written loss head (``FusedTrainDecoder.bce_loss``) in place of the
eager composition; on the on-chip kernels without UCN the training forward
(K1d) computes them itself as it streams its outputs, and no head runs.

Adam is written out as ``optax.scale_by_adam()`` composes it, not taken from
``torch.optim``, whose rounding order differs.  Its state is
``AdamState(count, mu, nu)``, which the checkpoint stores under the JAX
keys ``opt_state/count``, ``opt_state/mu/<param>`` and
``opt_state/nu/<param>``.

Data: one key per batch from a CPU ``torch.Generator(seed)``
(``utils/rng.py``); the key seeds the channel's device generator, which
draws the batch.  So the port's data stream is its own, and the generator's
state in a checkpoint resumes it bitwise.  A host generator can be plugged
in through ``host_datagen``.  The loop keeps per-batch losses on the device
and reads them only at progress prints.

Data parallelism: pass a ``parallel.Mesh``.  Every rank draws the global
batch from the same generator and keeps its rows, so a mesh run trains on
exactly the single-process words; the step averages the loss and the
gradients over the ranks in one collective before the clip, and every rank
applies the same update, so the params stay replicated bit for bit.  Only
rank 0 writes checkpoints, weight exports and the metrics log.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from math import floor
from sys import stdout
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..channel.awgn import AWGNChannel
from ..eval.metrics import count_errors
from ..models.boosted_decoder import BoostedNeuralDecoder
from ..parallel.mesh import all_reduce_mean, all_reduce_sum, barrier, replicate, shard_batch
from ..structs import LossType
from ..utils.checkpoint import CheckpointManager
from ..utils.metrics_logger import MetricsLogger
from ..utils.profiling import (TRAIN_BACKWARD, TRAIN_FORWARD, TRAIN_LOSS, TRAIN_STEP,
                               TRAIN_UPDATE, span)
from ..utils.rng import channel_seed, next_key
from .loss import multi_iteration_loss
from .lr_schedule import LearningRate


@dataclasses.dataclass
class TrainConfig:
    """Training hyperparameters (reference constant block, train/…:123-177)."""

    total_epochs: int = 500
    batch_size: int = 20
    train_words_per_epoch: int = 10000
    validate_words: int = 1000
    loss_type: LossType = LossType.BCE
    etha: float = 1.0
    learning_rate: LearningRate = dataclasses.field(
        default_factory=lambda: LearningRate(1e-3, 0.0, 0)
    )
    grad_clip_norm: float = 1.0
    is_y_all_zero: bool = False
    training_iter_start: int = 0
    training_iter_end: Optional[int] = None  # default: all iterations
    # restrict optimization to these param leaves (e.g. ("weight_ucn",));
    # None = train everything the row masks allow
    train_only_params: Optional[tuple[str, ...]] = None
    # gradient engine: "xla" differentiates the plain decoder; "fused" runs
    # the training-forward and backward kernels (ops/cuda/fused_train.py)
    engine: str = "xla"
    patience: int = 10
    min_delta: float = 1e-5
    validate_epoch_step: int = 5
    checkpoint_step: int = 5
    log_metrics_step: int = 5
    progress_step: int = 5
    checkpoint_dir: str = "checkpoints"
    seed: int = 2042
    export_weights_txt: bool = True
    verbose: bool = True


class AdamState(NamedTuple):
    """``optax.ScaleByAdamState``: step count (int32) and the two moments."""

    count: torch.Tensor
    mu: dict
    nu: dict


def adam_init(params) -> AdamState:
    dev = next(iter(params.values())).device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def adam_update(grads, state: AdamState, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, eps_root: float = 0.0):
    """``optax.scale_by_adam().update``, operation for operation: (updates,
    new state)."""
    mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
    nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
    count = state.count + 1
    bc1 = 1 - torch.pow(b1, count.to(torch.float32))
    bc2 = 1 - torch.pow(b2, count.to(torch.float32))
    updates = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2 + eps_root) + eps) for k in grads}
    return updates, AdamState(count=count, mu=mu, nu=nu)


def global_norm(tree: dict) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares, leaves in key order."""
    total = 0
    for k in sorted(tree):
        total = total + torch.sum(tree[k] * tree[k])
    return torch.sqrt(total)


def make_train_step(decoder: BoostedNeuralDecoder, train_cfg: TrainConfig, mesh=None):
    """Build ``(init_opt_state, step)``.  ``step(params, opt_state, llr,
    bits, lr)`` -> ``(params, opt_state, loss)``: the gradient of the loss,
    the global-norm clip, row freezing, Adam and the clamp projection.
    ``lr`` is a Python float; the loss stays on the device.  Under a
    ``mesh`` ``llr`` and ``bits`` are the rank's rows, and the loss and the
    gradients are the means over the ranks (JAX's ``sharded_step``)."""
    masks = decoder.trainable_row_masks()
    if train_cfg.train_only_params is not None:
        keep = set(train_cfg.train_only_params)
        masks = {k: (m if k in keep else m * 0.0) for k, m in masks.items()}
    i0 = train_cfg.training_iter_start
    i1 = (train_cfg.training_iter_end if train_cfg.training_iter_end is not None
          else decoder.config.n_iterations)
    coeffs = list(range(i1 - i0))  # reference: coeff_param=list(range(len(outputs)))
    convention = decoder.config.convention

    head = False  # the fused BCE step's loss head, where the labels allow it
    if train_cfg.engine == "fused":
        from ..ops.cuda.fused_train import FusedTrainDecoder

        ft = FusedTrainDecoder.from_decoder(decoder)
        head = train_cfg.loss_type == LossType.BCE

        def outputs_of(params, llr):
            cn_w, ucn_w, vn_w = decoder._expanded_weights(params)
            return ft.apply(cn_w, ucn_w, vn_w, llr)
    elif train_cfg.engine == "xla":
        def outputs_of(params, llr):
            return decoder.apply(params, llr)
    else:
        raise ValueError(f"unknown training engine {train_cfg.engine!r}")

    def step(params, opt_state, llr, bits, lr):
        with span(TRAIN_STEP):
            keys = list(params)
            p = {k: params[k].detach().requires_grad_(True) for k in keys}
            # one label a bit for every iteration: the loss head computes the
            # clip, the loss and its gradient in one pass, or the forward
            # does where its layout allows (per-iteration labels keep the
            # composition)
            if head and bits.dim() == 2:
                with span(TRAIN_FORWARD):
                    fwd = ft.train_forward(*decoder._expanded_weights(p), llr, bits,
                                           (i0, i1, train_cfg.etha, coeffs))
                with span(TRAIN_LOSS):
                    loss = ft.bce_loss(fwd)
                del fwd
            else:
                with span(TRAIN_FORWARD):
                    outputs = outputs_of(p, llr)
                with span(TRAIN_LOSS):
                    loss = multi_iteration_loss(outputs[i0:i1], bits, train_cfg.loss_type,
                                                train_cfg.etha, coeffs, convention)
            with span(TRAIN_BACKWARD):
                gl = torch.autograd.grad(loss, [p[k] for k in keys], allow_unused=True)
                grads = {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(keys, gl)}
                loss = loss.detach()
                if mesh is not None:
                    # one collective for the loss and every gradient; the clip
                    # below must see the mean gradients (a per-rank clip is
                    # another update)
                    red = all_reduce_mean(dict({f"g/{k}": g for k, g in grads.items()}, loss=loss),
                                          mesh)
                    grads, loss = {k: red[f"g/{k}"] for k in keys}, red["loss"]
            with span(TRAIN_UPDATE):
                # global-norm clip over ALL grads, frozen rows included (the
                # reference clips model.parameters() before the optimizer
                # sees them, train/…:292)
                gnorm = global_norm(grads)
                # a true division, as JAX's (a Python float over a tensor
                # would be computed as a reciprocal times the float)
                scale = torch.clamp_max(
                    torch.div(torch.full_like(gnorm, train_cfg.grad_clip_norm), gnorm + 1e-12), 1.0)
                grads = {k: g * scale for k, g in grads.items()}
                grads = {k: (g * masks[k] if k in masks else g) for k, g in grads.items()}
                updates, opt_state = adam_update(grads, opt_state)
                neg_lr = -float(lr)
                params = decoder.clamp_params({k: params[k] + updates[k] * neg_lr for k in keys})
        return params, opt_state, loss

    return adam_init, step


def make_eval_step(decoder: BoostedNeuralDecoder, train_cfg: TrainConfig, mesh=None):
    """``step(params, llr, bits)`` -> ``(loss, ErrorCounts)`` over all
    iterations, through ``decoder.apply`` as the JAX eval step does.  Under
    a ``mesh``: the mean of the ranks' losses and the sums of their counts."""
    convention = decoder.config.convention

    @torch.no_grad()
    def step(params, llr, bits):
        outputs = decoder.apply(params, llr)
        loss = multi_iteration_loss(outputs, bits, train_cfg.loss_type, train_cfg.etha,
                                    list(range(outputs.shape[0])), convention)
        counts = count_errors(bits, outputs, convention)
        if mesh is None:
            return loss, counts
        red = all_reduce_sum(dict(counts._asdict(), loss=loss), mesh)
        return red.pop("loss") / mesh.size, type(counts)(**red)

    return step


def format_eta(seconds: float) -> str:
    """Largest-two-units ETA rendering ("2h 5m" / "5m 12s" / "47s")."""
    h, rem = divmod(int(seconds), 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}h {m}m"
    if m:
        return f"{m}m {s}s"
    return f"{s}s"


def format_train_progress(
    current_batch, total_batches, current_epoch, total_epochs,
    loss=None, start_time=None, bar_length=40, now=None,
) -> str:
    """One progress line (the reference renders the same fields inline,
    train/train_BoostedNeuralLDPCDecoder.py:21-69).  The bar fills by epoch
    fraction while the counter shows batches, as the reference's does."""
    now = now if now is not None else datetime.now()
    filled = int(bar_length * current_epoch / max(total_epochs, 1))
    parts = [
        f"[{now.strftime('%H:%M:%S')}]",
        f"Epoch {current_epoch}/{total_epochs}",
        f"[{'#' * filled}{' ' * (bar_length - filled)}]",
        f"{current_batch}/{total_batches}",
    ]
    if loss is not None:
        parts.append(f"Loss: {loss:.6f}")
    done = (current_epoch - 1) * total_batches + current_batch
    if start_time is not None and current_batch > 0 and done > 0:
        elapsed = now.timestamp() - start_time
        remaining = total_epochs * total_batches - done
        parts.append(f"ETA: {format_eta(remaining * elapsed / done)}")
    return " ".join(parts)


def print_train_progress(
    current_batch, total_batches, current_epoch, total_epochs,
    loss=None, start_time=None, bar_length=40,
):
    """In-place TTY progress bar with ETA; newline on the epoch's last batch."""
    stdout.write("\r" + format_train_progress(
        current_batch, total_batches, current_epoch, total_epochs,
        loss, start_time, bar_length,
    ))
    stdout.flush()
    if current_batch == total_batches:
        stdout.write("\n")


class Trainer:
    """Epoch driver with validation, early stopping, checkpointing and
    metrics logging: the reference's train/train_BoostedNeuralLDPCDecoder.py
    program as a reusable class."""

    def __init__(
        self,
        decoder: BoostedNeuralDecoder,
        channel: AWGNChannel,
        train_cfg: TrainConfig = TrainConfig(),
        mesh=None,
        host_datagen: Optional[Callable] = None,
    ):
        if channel.device != decoder.device:
            raise ValueError(f"channel on {channel.device}, decoder on {decoder.device}")
        if mesh is not None:
            if mesh.device != decoder.device:
                raise ValueError(f"mesh rank on {mesh.device}, decoder on {decoder.device}")
            if train_cfg.batch_size % mesh.size:
                raise ValueError(f"batch_size {train_cfg.batch_size} not divisible by "
                                 f"{mesh.size} mesh devices")
        self.decoder = decoder
        self.channel = channel
        self.cfg = train_cfg
        self.mesh = mesh
        # rank 0 alone writes files; every rank reads them
        self.writes = mesh is None or mesh.rank == 0
        self.host_datagen = host_datagen
        self.init_opt_state, self.train_step = make_train_step(decoder, train_cfg, mesh)
        self.eval_step = make_eval_step(decoder, train_cfg, mesh)
        self.checkpoints = CheckpointManager(train_cfg.checkpoint_dir)
        self.logger = MetricsLogger(train_cfg.checkpoint_dir)

    def _batch(self, gen: torch.Generator):
        """The global batch, or under a mesh this rank's rows of it: every
        rank draws the same words (JAX places one batch over the mesh)."""
        dev = self.decoder.device
        if self.host_datagen is not None:
            x, y = self.host_datagen(self.cfg.batch_size)
            if self.mesh is not None:
                x, y = shard_batch(np.asarray(x), self.mesh), shard_batch(np.asarray(y), self.mesh)
            return (torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev),
                    torch.as_tensor(np.asarray(y), dtype=torch.float32, device=dev))
        g = self.channel.generator(channel_seed(next_key(gen)))
        llr, bits = self.channel.sample_mixed(g, self.cfg.batch_size,
                                              all_zero=self.cfg.is_y_all_zero)
        if self.mesh is not None:
            llr, bits = shard_batch(llr, self.mesh), shard_batch(bits, self.mesh)
        return llr, bits

    def resume(self, checkpoint_name: str):
        """Restore params, optimizer state, epoch and the key generator's
        state from a checkpoint written by ``train`` and continue training,
        bitwise as an uninterrupted run would (the generator state is saved
        at the epoch boundary and the LR schedule is fast-forwarded)."""
        params_t = self.decoder.init_params()
        opt_t = self.init_opt_state(params_t)
        params, opt_state, meta, rng_state, extras = self.checkpoints.load(
            checkpoint_name, params_t, opt_t)
        if rng_state is None:
            raise ValueError(f"checkpoint {checkpoint_name!r} has no generator state")
        if not isinstance(rng_state, torch.Tensor):
            raise ValueError(
                f"checkpoint {checkpoint_name!r} holds a JAX threefry key; its data stream "
                "cannot be continued by the port's generator")
        return self.train(
            params=params, opt_state=opt_state, start_epoch=int(meta.get("epoch", 0)) + 1,
            rng_state=rng_state,
            best_loss=float(extras.get("best_loss", np.inf)),
            patience_counter=int(extras.get("patience_counter", 0)),
        )

    def train(self, params=None, opt_state=None, start_epoch: int = 0,
              rng_state: Optional[torch.Tensor] = None, best_loss: float = float("inf"),
              patience_counter: int = 0):
        cfg = self.cfg
        params = params if params is not None else self.decoder.init_params()
        if self.mesh is not None:
            params = replicate(params, self.mesh)
        opt_state = opt_state if opt_state is not None else self.init_opt_state(params)
        verbose = cfg.verbose and self.writes
        gen = torch.Generator().manual_seed(cfg.seed)
        if rng_state is not None:
            gen.set_state(rng_state)
        # fresh clone per train() call: the config's instance is shared, and
        # advancing it in place would double-advance on train-then-resume
        lr_sched = cfg.learning_rate.clone()
        lr_sched.step = max(0, start_epoch - 1)
        batches_per_epoch = floor(cfg.train_words_per_epoch / cfg.batch_size)
        valid_batches = floor(cfg.validate_words / cfg.batch_size)

        avg_valid_loss = last_iter_ber = last_iter_fer = 0.0
        avg_epoch_loss, current_lr = 0.0, lr_sched.lr
        t0 = datetime.now().timestamp()

        for epoch in range(start_epoch, cfg.total_epochs + 1):
            if epoch > 0:
                current_lr = lr_sched()
                # per-batch losses stay on the device: reading one per step
                # would wait on the card every step; read at progress prints
                epoch_losses, loss_val = [], 0.0
                for b in range(batches_per_epoch):
                    llr, bits = self._batch(gen)
                    params, opt_state, loss = self.train_step(
                        params, opt_state, llr, bits, current_lr)
                    epoch_losses.append(loss)
                    if verbose and b % cfg.progress_step == 0:
                        loss_val = float(loss)
                        print_train_progress(b + 1, batches_per_epoch, epoch,
                                             cfg.total_epochs, loss_val, t0)
                loss_val = float(epoch_losses[-1])
                avg_epoch_loss = float(torch.mean(torch.stack(epoch_losses)))
                if verbose:
                    print_train_progress(batches_per_epoch, batches_per_epoch, epoch,
                                         cfg.total_epochs, loss_val, t0)
                    print(f"\nEpoch {epoch}/{cfg.total_epochs} avg loss {avg_epoch_loss:.6f}")

            stop = False
            if epoch % cfg.validate_epoch_step == 0:
                valid_loss = 0.0
                tot = dict(be=0.0, bits=0.0, fe=0.0, frames=0.0,
                           last_be=0.0, last_bits=0.0, last_fe=0.0, last_frames=0.0)
                for b in range(valid_batches):
                    llr, bits = self._batch(gen)
                    loss, counts = self.eval_step(params, llr, bits)
                    valid_loss += float(loss)
                    be = counts.bit_errors.cpu().numpy()
                    fe = counts.frame_errors.cpu().numpy()
                    nbits, nframes = float(counts.total_bits), float(counts.total_frames)
                    if b == 0 and verbose:
                        bers, fers = be / nbits, fe / nframes
                        best = int(np.argmin(bers))
                        print(">>> Per-Iteration Performance (First Validation Batch):")
                        for i, (bb, ff) in enumerate(zip(bers, fers)):
                            mark = " <- BEST BER" if i == best else ""
                            print(f"    Iter {i:2d}: BER={bb:.6e}, FER={ff:.4f}{mark}")
                    tot["be"] += be.sum(); tot["bits"] += nbits * len(be)
                    tot["fe"] += fe.sum(); tot["frames"] += nframes * len(fe)
                    tot["last_be"] += be[-1]; tot["last_bits"] += nbits
                    tot["last_fe"] += fe[-1]; tot["last_frames"] += nframes
                avg_valid_loss = valid_loss / max(valid_batches, 1)
                last_iter_ber = tot["last_be"] / max(tot["last_bits"], 1)
                last_iter_fer = tot["last_fe"] / max(tot["last_frames"], 1)
                if verbose:
                    print(f">>> Validation (epoch {epoch}): loss {avg_valid_loss:.6f}, "
                          f"BER(all) {tot['be']/max(tot['bits'],1):.6e}, "
                          f"BER(last) {last_iter_ber:.6e}, FER(last) {last_iter_fer:.6f}")
                if avg_valid_loss < best_loss - cfg.min_delta:
                    best_loss, patience_counter = avg_valid_loss, 0
                else:
                    patience_counter += 1
                    if patience_counter >= cfg.patience:
                        if verbose:
                            print(f"Early stopping at epoch {epoch}; best loss {best_loss:.6f}")
                        stop = True

            metrics = {
                "loss": avg_valid_loss if epoch % cfg.validate_epoch_step == 0 else avg_epoch_loss,
                "ber_last_iter": last_iter_ber,
                "fer_last_iter": last_iter_fer,
            }
            ckpt_cfg = {"batch_size": cfg.batch_size, "lr": current_lr}
            save, log = epoch % cfg.checkpoint_step == 0, epoch % cfg.log_metrics_step == 0
            ckpt_name = f"checkpoint_epoch_{epoch:04d}" if save else "NA"
            if save and self.writes:
                self.checkpoints.save(ckpt_name, params, opt_state, epoch=epoch,
                                      metrics=metrics, config=ckpt_cfg,
                                      rng_state=gen.get_state(),
                                      extra_arrays={
                                          "best_loss": np.float64(best_loss),
                                          "patience_counter": np.int64(patience_counter),
                                      })
                self.checkpoints.save_weights(
                    f"weights_epoch_{epoch:04d}",
                    self.decoder.named_parameter_rows(params),
                    as_txt=cfg.export_weights_txt,
                )
            if log and self.writes:
                self.logger.log(epoch, metrics, ckpt_name, config=ckpt_cfg)
            if self.mesh is not None and (save or log):
                barrier(self.mesh)  # rank 0's files exist before any rank goes on
            if stop:
                break

        return params, opt_state, {"best_loss": best_loss, "ber_last_iter": last_iter_ber}
