"""Training CLI (port of ``neural_ldpc_tpu.cli.train``).

  python -m neural_ldpc_tpu_torch.cli.train --preset bg2_qms_train \
      --set engine='"fused"' --epochs 50 [--resume checkpoint_epoch_0010] \
      [--device cpu]
  python -m neural_ldpc_tpu_torch.cli.train --preset boosted_error_floor
  python -m neural_ldpc_tpu_torch.cli.train --preset wman_neural_train

The same flags as the JAX CLI plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch paths).  The config's ``mode`` picks the recipe:
``standard`` trains through ``training.Trainer``; with ``--set
engine='"fused"'`` its gradients come from the hand-written forward and
backward kernels.  ``boosted`` runs Kwak's pipeline
(``training.boosted_pipeline``: base decoder, harvest of its failures, post
decoder on its UCN weights) and ``greedy`` Dai's per-layer training of the
neural min-sum decoder (``training.greedy``); each saves its final weights
(``boosted_final`` / ``greedy_final``, npz + txt export) in the config's
``checkpoint_dir``.

``--mesh-devices N`` trains data-parallel over N ranks (``parallel.mesh``):
under ``torchrun --nproc-per-node N`` each process joins the launcher's
group (N must equal its world size); without a launcher the command starts
N local ranks itself.  Ranks use NCCL over ``cuda:r``, or gloo with
``--device cpu``; rank 0 writes the files.  Greedy training takes no mesh,
as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from .evaluate import parse_overrides


def build_parser():
    p = argparse.ArgumentParser(description="Train a neural LDPC decoder on the GPU")
    p.add_argument("--preset", default="bg2_qms_train",
                   help="named experiment preset (see utils/config.py PRESETS)")
    p.add_argument("--config", help="path to an ExperimentConfig JSON file")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="override any config field (JSON-parsed value)")
    # reference-compatible shortcuts (train/…:461-469)
    p.add_argument("--epochs", type=int, help="total training epochs")
    p.add_argument("--y_all_zero", action="store_true",
                   help="use all-zero codewords for training")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="shard the batch over N ranks (default: single device)")
    p.add_argument("--resume", metavar="CKPT", default=None,
                   help="resume standard-mode training from a checkpoint name "
                        "in the configured checkpoint_dir (restores params, "
                        "optimizer state, epoch and the generator state)")
    p.add_argument("--dump-config", action="store_true",
                   help="print the resolved config JSON and exit")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def resolve_config(args):
    from neural_ldpc_tpu_torch.utils.config import ExperimentConfig, get_preset

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = get_preset(args.preset)
    overrides = parse_overrides(args.set)
    if args.epochs is not None:
        overrides["total_epochs"] = args.epochs
    if args.y_all_zero:
        overrides["y_all_zero"] = True
    if args.mesh_devices is not None:
        overrides["mesh_devices"] = args.mesh_devices
    if overrides:
        raw = dataclasses.asdict(cfg)
        raw.update(overrides)
        cfg = ExperimentConfig.from_dict(raw)
    return cfg


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    cfg = resolve_config(args)
    if args.dump_config:
        print(cfg.to_json())
        return 0
    if cfg.mode not in ("standard", "greedy", "boosted"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    from neural_ldpc_tpu_torch.parallel import run_with_mesh

    return run_with_mesh("neural_ldpc_tpu_torch.cli.train", argv, cfg.mesh_devices, args.device,
                         lambda mesh: _run(args, cfg, mesh))


def _run(args, cfg, mesh):

    from neural_ldpc_tpu_torch.models import (
        BoostedNeuralDecoder, NeuralDecoderConfig, NeuralMinSumDecoder)
    from neural_ldpc_tpu_torch.training import Trainer
    from neural_ldpc_tpu_torch.training.boosted_pipeline import (
        BoostedPipeline, BoostedPipelineConfig)
    from neural_ldpc_tpu_torch.training.greedy import GreedyLayerTrainer, GreedyTrainConfig
    from neural_ldpc_tpu_torch.utils import CheckpointManager

    writes = mesh is None or mesh.rank == 0
    code, graph = cfg.build_graph()
    channel = cfg.build_channel(code, device=args.device)
    print(f"code={code.name} N={code.n_bits} K={code.n_info_bits} "
          f"mode={cfg.mode} decoder={cfg.decoder_type.name} iters={cfg.n_iterations} "
          f"engine={cfg.engine} device={channel.device}"
          + (f" rank={mesh.rank}/{mesh.size}" if mesh is not None else ""))

    if cfg.mode == "greedy":
        decoder = NeuralMinSumDecoder(graph, NeuralDecoderConfig(
            n_iterations=cfg.n_iterations, convention=cfg.convention), device=args.device)
        trainer = GreedyLayerTrainer(decoder, channel, GreedyTrainConfig(
            total_epochs=cfg.total_epochs, batch_size=cfg.batch_size,
            learning_rate=cfg.learning_rate, is_y_all_zero=cfg.y_all_zero,
            seed=cfg.seed))
        params, _, report = trainer.train()
        if writes:
            CheckpointManager(cfg.checkpoint_dir).save_weights(
                "greedy_final", decoder.named_parameter_rows(params), as_txt=True)
            print("greedy training done:", report["layer_losses"][-1])
    elif cfg.mode == "boosted":
        pipe = BoostedPipeline(
            graph, channel,
            cfg.build_decoder_config(n_iterations=cfg.base_iters),
            cfg.build_train_config(), cfg.build_train_config(),
            BoostedPipelineConfig(base_iters=cfg.base_iters,
                                  post_iters=cfg.post_iters,
                                  collect_words=cfg.collect_words),
            mesh=mesh,
        )
        base_params, ext_params, report = pipe.run()
        if writes:
            CheckpointManager(cfg.checkpoint_dir).save_weights(
                "boosted_final", pipe.post_decoder.named_parameter_rows(ext_params),
                as_txt=True)
            print("boosted pipeline done:",
                  json.dumps({"collected_words": report["collected_words"]}))
    else:
        decoder = BoostedNeuralDecoder(graph, cfg.build_decoder_config(), device=args.device)
        trainer = Trainer(decoder, channel, cfg.build_train_config(), mesh=mesh)
        if args.resume:
            params, _, summary = trainer.resume(args.resume)
        else:
            params, _, summary = trainer.train()
        if writes:
            print("training done:", json.dumps({k: float(v) for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
