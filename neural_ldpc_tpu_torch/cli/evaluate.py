"""Monte-Carlo BER/FER evaluation CLI (port of ``neural_ldpc_tpu.cli.evaluate``).

  python -m neural_ldpc_tpu_torch.cli.evaluate --preset montecarlo_campaign \
      --snr 1.0:5.0:0.5 --max-words 1000000 --min-frame-errors 100 \
      [--weights checkpoints/weights_epoch_0100.npz] [--out results.json] \
      [--device cpu]

  # weights trained by the torch reference (.pth or *_weights_txt export)
  python -m neural_ldpc_tpu_torch.cli.evaluate --import-reference run_weights_txt

Runs on the GPU by default (``--device cuda``); ``--device cpu`` runs the
plain PyTorch paths.  ``--mesh-devices N`` runs the campaign data-parallel
over N ranks (``parallel.mesh``): under ``torchrun --nproc-per-node N`` each
process joins the launcher's group; without a launcher the command starts N
local ranks itself (NCCL over ``cuda:r``, gloo with ``--device cpu``).
Rank 0 prints or writes the results.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def parse_overrides(pairs):
    """``KEY=VALUE`` pairs -> {key: JSON-parsed value (else the string)}."""
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def parse_snr(spec):
    if spec is None:
        return None
    if ":" in spec:
        start, stop, step = (float(v) for v in spec.split(":"))
        return tuple(np.round(np.arange(start, stop + 1e-9, step), 6).tolist())
    return tuple(float(v) for v in spec.split(","))


def load_weights_npz(path, decoder, params):
    """Params from a weights npz that stores per-iteration names
    (``weight_CN_0``, ...), restacked in each spec's row order."""
    import torch

    with np.load(path) as data:
        for key in list(params):
            node = key.split("_", 1)[1]
            prefix = f"weight_{node.upper()}_"
            names = {int(n.rsplit("_", 1)[1]): n for n in data.files if n.startswith(prefix)}
            if not names:
                continue
            # temporal-sharing params store rows in temporal_rows order (which
            # need not be ascending); replay that order, not sorted()
            spec = decoder.specs[node]
            row_iters = spec.temporal_rows if spec.temporal_rows else sorted(names)
            params[key] = torch.as_tensor(
                np.stack([np.atleast_1d(data[names[it]]) for it in row_iters]),
                dtype=torch.float32, device=params[key].device)
    return params


def main(argv=None):
    p = argparse.ArgumentParser(description="Monte-Carlo BER/FER campaign")
    p.add_argument("--preset", default="montecarlo_campaign")
    p.add_argument("--config", help="ExperimentConfig JSON file")
    p.add_argument("--set", action="append", metavar="KEY=VALUE")
    p.add_argument("--snr", help="SNR list 'a,b,c' or range 'start:stop:step' (dB)")
    p.add_argument("--weights", help="npz of per-iteration decoder weights (save_weights)")
    p.add_argument("--checkpoint", help="full training checkpoint to restore params from")
    p.add_argument("--import-reference", metavar="PATH",
                   help="torch-reference checkpoint (.pth or *_weights_txt dir) to import")
    p.add_argument("--import-reference-unsafe", action="store_true",
                   help="with --import-reference: allow full (unsafe) unpickling of a "
                        ".pth that fails the weights_only loader")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--max-words", type=int)
    p.add_argument("--min-frame-errors", type=int)
    p.add_argument("--mesh-devices", type=int, help="shard each batch over N ranks")
    p.add_argument("--engine", choices=("auto", "fused", "xla"), default="auto",
                   help="decode engine: fused CUDA kernel (final-iteration stats) or "
                        "the plain decoder ('xla', per-iteration stats)")
    p.add_argument("--state-dir", help="campaign checkpoint dir (restartable)")
    p.add_argument("--resume", action="store_true", help="resume campaign state from --state-dir")
    p.add_argument("--out", help="write results JSON here (default stdout)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)

    from neural_ldpc_tpu_torch.utils.config import ExperimentConfig, get_preset

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = get_preset(args.preset)
    overrides = parse_overrides(args.set)
    if args.snr:
        overrides["snr_db"] = parse_snr(args.snr)
    if args.batch_size:
        overrides["eval_batch_size"] = args.batch_size
    if args.max_words:
        overrides["eval_max_words_per_snr"] = args.max_words
    if args.min_frame_errors is not None:
        overrides["eval_min_frame_errors"] = args.min_frame_errors
    if args.mesh_devices:
        overrides["mesh_devices"] = args.mesh_devices
    if overrides:
        raw = dataclasses.asdict(cfg)
        raw.update(overrides)
        cfg = ExperimentConfig.from_dict(raw)
    from neural_ldpc_tpu_torch.parallel import run_with_mesh

    return run_with_mesh("neural_ldpc_tpu_torch.cli.evaluate", argv, cfg.mesh_devices, args.device,
                         lambda mesh: _run(args, cfg, mesh))


def _run(args, cfg, mesh):
    from neural_ldpc_tpu_torch.eval import CampaignConfig, MonteCarloCampaign
    from neural_ldpc_tpu_torch.models import BoostedNeuralDecoder
    from neural_ldpc_tpu_torch.utils import CheckpointManager

    code, graph = cfg.build_graph()
    channel = cfg.build_channel(code, device=args.device)
    decoder = BoostedNeuralDecoder(graph, cfg.build_decoder_config(), device=args.device)
    params = decoder.init_params()
    if args.weights:
        params = load_weights_npz(args.weights, decoder, params)
    elif args.checkpoint:
        params, _, _, _, _ = CheckpointManager(cfg.checkpoint_dir).load(args.checkpoint, params)
    elif args.import_reference:
        from neural_ldpc_tpu_torch.utils.checkpoint import import_reference_weights

        params = import_reference_weights(
            decoder, args.import_reference,
            allow_unsafe=args.import_reference_unsafe,
        )

    camp = MonteCarloCampaign(
        decoder, params, channel,
        CampaignConfig(
            batch_size=cfg.eval_batch_size,
            max_words_per_snr=cfg.eval_max_words_per_snr,
            min_frame_errors=cfg.eval_min_frame_errors,
            all_zero=cfg.y_all_zero,
            seed=cfg.seed,
            checkpoint_dir=args.state_dir,
            engine=args.engine,
        ),
        mesh=mesh,
    )
    if args.resume and args.state_dir:
        camp.restore_state(CheckpointManager(args.state_dir))
    results = camp.run()
    if mesh is not None and mesh.rank != 0:
        return 0
    payload = json.dumps({
        "code": code.name,
        "decoder": cfg.decoder_type.name,
        "n_iterations": cfg.n_iterations,
        "results": {str(k): v for k, v in results.items()},
    }, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        print(f"wrote {args.out}")
    else:
        print(payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
