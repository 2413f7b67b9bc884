"""Training CLI (port of ``neural_ldpc_tpu.cli.train``).

  python -m neural_ldpc_tpu_torch.cli.train --preset bg2_qms_train \
      --set engine='"fused"' --epochs 50 [--resume checkpoint_epoch_0010] \
      [--device cpu]

The same flags as the JAX CLI plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch paths).  The standard mode trains through
``training.Trainer``; with ``--set engine='"fused"'`` its gradients come
from the hand-written forward and backward kernels.  The greedy and boosted
modes and ``--mesh-devices`` are not ported yet and raise.
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
                   help="shard the batch over N devices (not ported yet)")
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
    args = build_parser().parse_args(argv)
    cfg = resolve_config(args)
    if args.dump_config:
        print(cfg.to_json())
        return 0
    if cfg.mesh_devices:
        raise NotImplementedError(
            "--mesh-devices: not ported yet (data parallelism, ROADMAP Queue 1 item 11)")
    if cfg.mode == "greedy":
        raise NotImplementedError(
            "mode='greedy': not ported yet (the neural (Dai) decoder and greedy layer "
            "training, ROADMAP Queue 1 items 9 and 10)")
    if cfg.mode == "boosted":
        raise NotImplementedError(
            "mode='boosted': not ported yet (the boosted pipeline, ROADMAP Queue 1 item 10)")
    if cfg.mode != "standard":
        raise ValueError(f"unknown mode {cfg.mode!r}")

    from neural_ldpc_tpu_torch.models import BoostedNeuralDecoder
    from neural_ldpc_tpu_torch.training import Trainer

    code, graph = cfg.build_graph()
    channel = cfg.build_channel(code, device=args.device)
    print(f"code={code.name} N={code.n_bits} K={code.n_info_bits} "
          f"mode={cfg.mode} decoder={cfg.decoder_type.name} iters={cfg.n_iterations} "
          f"engine={cfg.engine} device={channel.device}")
    decoder = BoostedNeuralDecoder(graph, cfg.build_decoder_config(), device=args.device)
    trainer = Trainer(decoder, channel, cfg.build_train_config())
    if args.resume:
        params, _, summary = trainer.resume(args.resume)
    else:
        params, _, summary = trainer.train()
    print("training done:", json.dumps({k: float(v) for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
