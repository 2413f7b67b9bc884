"""The training step in plain PyTorch: the multi-iteration loss, its
gradient through the plain decoder, the global-norm clip, Adam and the
clamp of the weights.

Loss: the mean over bits of the sigmoid cross-entropy of -APP against the
labels, max(l, 0) - l y + log1p(exp(-|l|)), averaged over the iterations
(added from the last to the first).  Adam is optax's scale_by_adam
(bias-corrected, eps outside the root); the update is p - lr * u, then the
clamp to the configuration's weight range.  A batch runs in blocks of rows
so that its activations fit; each block's loss is weighted by its share of
the batch.
"""

from __future__ import annotations

import torch

from . import decoder as D
from .graph import Tables

ADAM_KEYS = ("b1", "b2", "eps")


def init_params(cfg: dict, dtype, device) -> dict:
    """One weight a iteration for each weighted node type ([I, 1])."""
    dec = cfg["decoder"]
    out = {}
    for kind in ("cn", "vn"):
        mode = dec["sharing"].get(kind, 0)
        if mode == 0:
            continue
        if mode != 3:
            raise ValueError(f"sharing mode {mode} is not a configuration here")
        out[f"weight_{kind}"] = torch.full((dec["iterations"], 1), dec["init_weights"][kind],
                                           dtype=dtype, device=device)
    return out


def loss_of(t: Tables, dec: dict, params: dict, llr, bits):
    cn = params.get("weight_cn")
    vn = params.get("weight_vn")
    outs = D.decode(t, dec, llr, None if cn is None else cn[:, 0], None if vn is None else vn[:, 0])
    total = 0.0
    for i in range(outs.shape[0] - 1, -1, -1):
        logits = -outs[i]
        total = total + torch.mean(D.relu(logits) - logits * bits
                                   + torch.log1p(torch.exp(-D.absolute(logits))))
    return total / outs.shape[0]


def gradient(t: Tables, dec: dict, params: dict, llr, bits, block: int, rows=None):
    """(loss, grads) over the batch (or its first ``rows`` rows), block by
    block."""
    B = llr.shape[0] if rows is None else rows
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = 0.0
    for b0 in range(0, B, block):
        b1 = min(B, b0 + block)
        part = loss_of(t, dec, p, llr[b0:b1].reshape(b1 - b0, -1), bits[b0:b1]) * ((b1 - b0) / B)
        part.backward()
        loss = loss + part.detach()
    return loss, {k: v.grad for k, v in p.items()}


def steps(cfg: dict, t: Tables, batches, dtype=torch.float32, block: int = 2048,
          fault: str | None = None, state: dict | None = None):
    """Steps on ``batches`` [(llr, bits)] in turn, from the configuration's
    initial weights or from ``state`` ({"params", "mu", "nu", "count": the
    steps already made}): {"loss": [...], "first_grad": {leaf: g},
    "start": params, "end": params}.  ``fault`` plants a fault of a program
    in the reference's place: "half" (each step's loss over the first half
    of the batch), "frozen" (the weights never change)."""
    tr, dec = cfg["training"], cfg["decoder"]
    b1, b2, eps = (tr["adam"][k] for k in ADAM_KEYS)
    lo, hi = dec["weight_clip"]
    device = batches[0][0].device
    if state is None:
        params = init_params(cfg, dtype, device)
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        count = 0
    else:
        params, mu, nu = ({k: v.to(device, dtype) for k, v in state[part].items()}
                          for part in ("params", "mu", "nu"))
        count = state["count"]
    start = {k: v.clone() for k, v in params.items()}
    losses, first = [], None
    for n, (llr, bits) in enumerate(batches, start=count + 1):
        llr, bits = llr.to(dtype), bits.to(dtype)
        rows = llr.shape[0] // 2 if fault == "half" else None
        loss, g = gradient(t, dec, params, llr, bits, block, rows)
        losses.append(float(loss))
        total = 0
        for k in sorted(g):
            total = total + torch.sum(g[k] * g[k])
        norm = torch.sqrt(total)
        scale = torch.clamp_max(torch.div(torch.full_like(norm, tr["grad_clip_norm"]),
                                          norm + 1e-12), 1.0)
        g = {k: v * scale for k, v in g.items()}
        if first is None:
            first = {k: v.clone() for k, v in g.items()}
        mu = {k: (1 - b1) * g[k] + b1 * mu[k] for k in g}
        nu = {k: (1 - b2) * (g[k] * g[k]) + b2 * nu[k] for k in g}
        c1, c2 = 1 - b1 ** n, 1 - b2 ** n
        if fault != "frozen":
            params = {k: torch.clamp(params[k] + ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
                                     * -tr["learning_rate"], lo, hi) for k in params}
    return {"loss": losses, "first_grad": first, "start": start, "end": params}
