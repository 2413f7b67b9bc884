"""Weighted min-sum and quantized min-sum (QMS) decoding in plain PyTorch.

The configurations' algorithm, written out on the flat layout of
``graph.py``: per iteration, the VN input (channel times the VN weight,
quantized under QMS), the extrinsic VN-to-check message (clipped, or
quantized under QMS), the min-sum check update, the CN weight on its
magnitude, ReLU and clip (or quantize), and the a-posteriori value
clip(channel + the sum of a bit's messages).  STANDARD convention: a
positive LLR favours bit 0.

Gradients take these conventions where an operation sits on its kink, as
the configurations state them: a clip passes 0.5 at either bound (and
``maximum(x, 0)`` 0.5 at 0), ``abs`` passes +1 at 0, a tied minimum splits
its gradient evenly, and the extrinsic minimum is the two-minimum rule (the
second minimum for the first minimal slot).  QMS quantizes with a
straight-through gradient: the clipped identity's.

``dtype`` runs every operation in that precision: float32 is the
reference, bfloat16 the control that must fail the comparisons.
"""

from __future__ import annotations

import torch

from .graph import Tables

BIG = 10000.0  # fills the padded slots of a min-reduction
QMS_GRID = {5: (-7.5, 7.5, 2.0)}  # q bits -> (lowest, highest, steps per unit)


def clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def relu(x):
    return torch.maximum(x, x.new_full((), 0.0))


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def absolute(x):
    return _Abs.apply(x)


def quantize(x, qbit: int):
    """Round half to even onto the QMS grid, clipped to its range; the
    gradient is the clipped identity's."""
    lo, hi, scale = QMS_GRID[qbit]
    q = torch.clamp(torch.round(x * scale) / scale, lo, hi)
    c = clip(x, lo, hi)
    return c + (q - c).detach()


def _check_view(msg, t: Tables, fill: float):
    """[B, E*Z] -> [B, M, D, Z], padded slots = ``fill``."""
    s = t.shape
    return msg[:, t.cn_gather].reshape(msg.shape[0], s.M, t.D, s.Z).masked_fill(t.cn_pad, fill)


def min_sum(v2c, t: Tables):
    """Extrinsic min-sum check update, [B, E*Z] -> [B, E*Z]."""
    B, s = v2c.shape[0], t.shape
    sgn = torch.where(v2c >= 0, 1.0, -1.0).to(v2c.dtype)
    mags = _check_view(absolute(v2c), t, BIG).transpose(2, 3)  # [B, M, Z, D]
    m1 = mags.amin(dim=-1)
    first = mags.argmin(dim=-1)
    slots = torch.arange(t.D, device=v2c.device)
    m2 = torch.where(slots == first[..., None], BIG, mags).amin(dim=-1)
    prod = _check_view(sgn, t, 1.0).prod(dim=2)  # [B, M, Z]
    own = t.slot_of_edge[None, :, None] == first[:, t.cn_of_edge, :]
    mag = torch.where(own, m2[:, t.cn_of_edge, :], m1[:, t.cn_of_edge, :])
    return (mag * prod[:, t.cn_of_edge, :] * sgn.reshape(B, s.E, s.Z)).reshape(B, s.E * s.Z)


def bit_sums(msg, t: Tables):
    """Each bit's sum of its messages, added in increasing edge order."""
    g = msg[:, t.vn_gather].masked_fill(t.vn_pad, 0.0)
    acc = g[:, :, 0]
    for k in range(1, g.shape[2]):
        acc = acc + g[:, :, k]
    return acc


def decode(t: Tables, dec: dict, chan, cn_w=None, vn_w=None, iterations=None):
    """Every iteration's APP [I, B, N*Z] of ``chan`` [B, N*Z].  ``dec``: the
    configuration's decoder block; ``cn_w`` / ``vn_w``: [I] weights a
    iteration (or None where the configuration has none)."""
    qbit = dec["qms_qbit"] if dec["type"] == "QMS" else None
    lo, hi = -dec["llr_clip"], dec["llr_clip"]
    iterations = dec["iterations"] if iterations is None else iterations
    s = t.shape

    def clip_or_quantize(x):
        return quantize(x, qbit) if qbit else clip(x, lo, hi)

    chan_out = quantize(chan, qbit) if qbit else chan
    msg = chan.new_zeros(chan.shape[0], s.E * s.Z)
    sums = chan.new_zeros(chan.shape)
    outs = []
    for i in range(iterations):
        xa = chan * vn_w[i] if vn_w is not None else chan
        if qbit:
            xa = quantize(xa, qbit)
        v2c = clip_or_quantize((xa + sums)[:, t.route] - msg)
        c2v = min_sum(v2c, t)
        mag = absolute(c2v)
        if cn_w is not None:
            mag = mag * cn_w[i]
        msg = clip_or_quantize(relu(mag)) * torch.sign(c2v)
        sums = bit_sums(msg, t)
        outs.append(clip(chan_out + sums, lo, hi))
    return torch.stack(outs)


def iteration_weights(dec: dict, arrays: dict, device):
    """(cn [I], vn [I]) from weight arrays [I, 1] of one weight a
    iteration, None for a node type the configuration does not weight."""
    out = []
    for kind in ("cn", "vn"):
        mode = dec["sharing"].get(kind, 0)
        if mode not in (0, 3):
            raise ValueError(f"sharing mode {mode} is not a configuration here")
        out.append(None if mode == 0 else
                   torch.as_tensor(arrays[f"weight_{kind}"][:, 0], device=device))
    return tuple(out)


def syndrome_ok(app, t: Tables):
    """[B] True where the decisions (APP < 0 is a 1) satisfy every check."""
    s = t.shape
    ones = (app < 0).to(torch.int32)[:, t.route]
    view = _check_view(ones, t, 0)
    return (view.sum(dim=2) % 2 == 0).reshape(app.shape[0], -1).all(dim=1)
