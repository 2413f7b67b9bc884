"""Checkpoints: params + optimizer state + generator state + counters, plus
the hardware-oriented per-parameter ``.txt`` export.

Port of ``neural_ldpc_tpu/utils/checkpoint.py::CheckpointManager`` in the
same file format: one ``.npz`` whose arrays are named by their path in the
params tree (``params/<name>``, ``opt_state/<path>``, ``extra/<name>``) and a
JSON sidecar for metadata, so that either package loads the other's params.
The optimizer state ``AdamState(count, mu, nu)`` flattens to the keys
``optax.scale_by_adam().init`` flattens to: ``opt_state/count`` (int32),
``opt_state/mu/<param>`` and ``opt_state/nu/<param>``.  The port's random
state is a ``torch.Generator`` state, stored under ``torch_rng_state``; a
JAX checkpoint's threefry ``rng_key`` is returned as its raw key data, which
the port cannot continue.  ``import_reference_weights`` reads a
torch-reference checkpoint (a ``.pth`` or a ``*_weights_txt`` export) into
the params of a boosted or a Dai decoder.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Optional, Union

import numpy as np
import torch

RNG_STATE = "torch_rng_state"
JAX_RNG_KEY = "rng_key"


def _children(node):
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten_with_paths(tree, prefix: str = "") -> dict[str, Any]:
    """{"a/b/0": leaf} for a tree of dicts, named tuples, lists and tuples,
    named as ``jax.tree_util`` paths name them."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for k, v in kids:
        flat.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _restore_like(template, data, prefix: str, path: str = ""):
    kids = _children(template)
    if kids is None:
        arr = data[f"{prefix}/{path}"]
        if isinstance(template, torch.Tensor):
            return torch.as_tensor(arr, dtype=template.dtype, device=template.device)
        return arr
    vals = [(k, _restore_like(v, data, prefix, f"{path}/{k}" if path else str(k)))
            for k, v in kids]
    if isinstance(template, dict):
        return dict(vals)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(v for _, v in vals))
    return type(template)(v for _, v in vals)


class CheckpointManager:
    def __init__(self, checkpoint_dir: str = "checkpoints"):
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def save(
        self,
        filepath: str,
        params,
        opt_state=None,
        epoch: Optional[int] = None,
        metrics: Optional[dict[str, float]] = None,
        config: Optional[dict[str, Any]] = None,
        rng_state: Optional[torch.Tensor] = None,
        extra_arrays: Optional[dict[str, np.ndarray]] = None,
    ) -> str:
        """Write ``<dir>/<filepath>.npz`` (+ ``.json`` metadata).
        ``rng_state`` is a ``torch.Generator.get_state()``."""
        base = filepath[:-4] if filepath.endswith(".npz") else filepath
        path = os.path.join(self.checkpoint_dir, base + ".npz")
        arrays = {f"params/{k}": _as_numpy(v) for k, v in _flatten_with_paths(params).items()}
        if opt_state is not None:
            arrays.update({f"opt_state/{k}": _as_numpy(v)
                           for k, v in _flatten_with_paths(opt_state).items()})
        if rng_state is not None:
            arrays[RNG_STATE] = _as_numpy(rng_state)
        if extra_arrays:
            arrays.update({f"extra/{k}": np.asarray(v) for k, v in extra_arrays.items()})
        np.savez(path, **arrays)
        meta = {
            "epoch": epoch,
            "metrics": metrics or {},
            "config": config or {},
            "saved_at": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        }
        with open(os.path.join(self.checkpoint_dir, base + ".json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        return path

    def load(self, filepath: str, params_template, opt_state_template=None):
        """Restore ``(params, opt_state, metadata, rng_state, extras)``,
        shaped like the templates (tensors land on the template's device
        and dtype).  ``rng_state`` is a generator state (uint8 tensor), the
        raw key data (numpy) of a JAX checkpoint's threefry key, or None."""
        base = filepath[:-4] if filepath.endswith(".npz") else filepath
        path = base if os.path.isabs(base) else os.path.join(self.checkpoint_dir, base)
        with np.load(path + ".npz") as data:
            params = _restore_like(params_template, data, "params")
            opt_state = (_restore_like(opt_state_template, data, "opt_state")
                         if opt_state_template is not None else None)
            rng_state: Union[torch.Tensor, np.ndarray, None] = None
            if RNG_STATE in data.files:
                rng_state = torch.as_tensor(data[RNG_STATE], dtype=torch.uint8)
            elif JAX_RNG_KEY in data.files:
                rng_state = data[JAX_RNG_KEY]
            extras = {k[len("extra/"):]: data[k] for k in data.files if k.startswith("extra/")}
        meta = {}
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
        return params, opt_state, meta, rng_state, extras

    # ------------------------------------------------------------------
    def save_weights(
        self,
        filepath: str,
        named_params: dict[str, np.ndarray],
        as_txt: bool = False,
    ) -> str:
        """Save weights only.  ``named_params`` maps exported parameter names
        (e.g. ``weight_CN_3``) to arrays; with ``as_txt`` each parameter is
        written to its own ``.txt`` with an ``index.txt`` manifest, the
        reference's hardware-export format."""
        base = filepath[:-4] if filepath.endswith(".npz") else filepath
        path = os.path.join(self.checkpoint_dir, base + ".npz")
        np.savez(path, **{k: _as_numpy(v) for k, v in named_params.items()})

        if as_txt:
            txt_dir = os.path.join(self.checkpoint_dir, f"{base}_weights_txt")
            os.makedirs(txt_dir, exist_ok=True)
            index_file = os.path.join(txt_dir, "index.txt")
            total = sum(int(_as_numpy(v).size) for v in named_params.values())
            with open(index_file, "w") as f:
                f.write(f"# Model weights saved at: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}\n")
                f.write(f"# Total parameters: {total}\n")
                f.write("# Format: Each parameter saved in separate .txt file\n")
                f.write("-" * 80 + "\n")
                f.write("Parameter_Name, Shape, Filename\n")
            for name, param in named_params.items():
                arr = _as_numpy(param)
                safe = name.replace(".", "_").replace("/", "_")
                fname = f"{safe}.txt"
                out = os.path.join(txt_dir, fname)
                if arr.ndim > 2:
                    np.savetxt(out, arr.reshape(arr.shape[0], -1),
                               header=f"Original shape: {arr.shape}\nReshaped to 2D for savetxt")
                else:
                    np.savetxt(out, np.atleast_1d(arr))
                with open(index_file, "a") as f:
                    f.write(f"{name}, {list(arr.shape)}, {fname}\n")
        return path


# ---------------------------------------------------------------------------
# Torch-reference checkpoint import
# ---------------------------------------------------------------------------
def _read_reference_txt_dir(txt_dir: str) -> dict[str, np.ndarray]:
    """Parse a reference ``*_weights_txt`` export (CheckPointUtil.py:91-122):
    an ``index.txt`` manifest of ``name, [shape], filename`` rows plus one
    ``np.savetxt`` file per parameter."""
    named = {}
    with open(os.path.join(txt_dir, "index.txt")) as f:
        lines = [l.strip() for l in f if l.strip()]
    for line in lines:
        if line.startswith(("#", "-", "Parameter_Name")):
            continue
        # "{name}, {list(shape)}, {filename}" — the shape repr has inner commas
        name, rest = line.split(", ", 1)
        shape_s, fname = rest.rsplit(", ", 1)
        shape = json.loads(shape_s)
        arr = np.loadtxt(os.path.join(txt_dir, fname), dtype=np.float64)
        named[name] = np.asarray(arr, np.float32).reshape(shape)
    return named


def _read_reference_pth(path: str, allow_unsafe: bool = False) -> dict[str, np.ndarray]:
    """Load a reference ``.pth`` — either a full training checkpoint
    (``{'model_state_dict': ...}``, CheckPointUtil.save :21-63) or a bare
    ``state_dict`` (save_weights :65-89).

    Loads with ``weights_only=True`` (no arbitrary-pickle execution); the
    reference's own checkpoints load fine that way.  A checkpoint that fails
    the safe loader is only retried with full unpickling when the caller
    explicitly opts in via ``allow_unsafe=True`` — full unpickling executes
    arbitrary code embedded in the file."""
    try:
        data = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not allow_unsafe:
            raise ValueError(
                f"{path!r} failed the safe (weights_only=True) torch loader: {e}. "
                "If you trust this file, retry with allow_unsafe=True "
                "(CLI: --import-reference-unsafe); full unpickling can execute "
                "arbitrary code embedded in the checkpoint."
            ) from e
        import warnings

        warnings.warn(
            f"UNSAFE LOAD: retrying {path!r} with weights_only=False — "
            "arbitrary code in the pickle will execute.",
            stacklevel=3,
        )
        data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, dict) and "model_state_dict" in data:
        data = data["model_state_dict"]
    return {k: np.asarray(v.detach().cpu().numpy(), np.float32) for k, v in data.items()}


def read_reference_named_weights(path: str, allow_unsafe: bool = False) -> dict[str, np.ndarray]:
    """Reference checkpoint -> {parameter name: array}, from a ``.pth`` file
    or a ``*_weights_txt`` directory."""
    if os.path.isdir(path):
        return _read_reference_txt_dir(path)
    return _read_reference_pth(path, allow_unsafe=allow_unsafe)


def import_reference_weights(decoder, path: str, allow_unsafe: bool = False, device=None):
    """Build the port's params from a torch-reference checkpoint, as float32
    tensors on ``device`` (default: the decoder's).

    ``decoder`` is a BoostedNeuralDecoder (stacked ``weight_{cn,ucn,vn}``
    leaves; reference names ``weight_{CN,UCN,VN}_{iter}``,
    BoostedNeuralLDPCDecoder._param_name :105-106) or a NeuralMinSumDecoder
    (``weights_var``/``biases_var`` stacks; reference nn.ParameterList keys
    ``weights_var.{i}``).  Inverse of ``named_parameter_rows``; cross-validates
    trained reference decoders inside this framework."""
    named = read_reference_named_weights(path, allow_unsafe=allow_unsafe)
    dev = decoder.device if device is None else torch.device(device)

    if hasattr(decoder, "specs"):  # boosted family
        params = {}
        template = decoder.init_params()
        for key, spec in decoder.specs.items():
            pk = f"weight_{key}"
            if pk not in template:
                continue
            row_iters = spec.temporal_rows if spec.temporal_rows else range(spec.n_iterations)
            rows = []
            for it in row_iters:
                name = f"weight_{key.upper()}_{it}"
                if name not in named:
                    raise KeyError(
                        f"reference checkpoint at {path!r} is missing {name!r} "
                        f"(has: {sorted(named)[:8]}...)"
                    )
                rows.append(np.asarray(named[name], np.float32).reshape(-1))
            params[pk] = torch.as_tensor(np.stack(rows), device=dev)
            if params[pk].shape != template[pk].shape:
                raise ValueError(
                    f"{pk}: reference rows stack to {tuple(params[pk].shape)}, decoder "
                    f"expects {tuple(template[pk].shape)} (sharing config mismatch?)"
                )
        return params

    # Dai neural decoder: ParameterList entries weights_var.{i} / biases_var.{i}
    n = decoder.config.n_iterations
    out = {}
    for stack, ref_prefix in (("weights_var", "weights_var"), ("biases_var", "biases_var")):
        rows = []
        for i in range(n):
            for cand in (f"{ref_prefix}.{i}", f"{ref_prefix}_{i}"):
                if cand in named:
                    rows.append(np.asarray(named[cand], np.float32).reshape(-1))
                    break
            else:
                raise KeyError(f"reference checkpoint missing {ref_prefix}.{i}")
        out[stack] = torch.as_tensor(np.stack(rows), device=dev)
    return out
