"""The work a cell's units need, counted from the configuration alone.

Operations and bytes of the configured algorithm, from the code's shape
(N, M, Z, E; the check and VN degrees only through E), the decoder
(iterations, min-sum or QMS, which weights it has) and the traffic (words,
escalated words).  Nothing here reads the port: no layout, plan or kernel
family, so a kernel's roofline share and a step's ``mfu`` read the same
work whatever implements it.

Operations are fp32 lane operations: each add, multiply, min, max, compare,
select, abs or rint is one, a transcendental one (the least its sequence
takes).  Work that depends only on a bit is counted once per bit and not
once per edge.  Bytes count each input read once and each output written
once; intermediate state (messages, a training forward's store) is the
implementation's and is not counted.  Where the work depends on the data
(early exit), the count is what the configured algorithm needs for these
inputs: every word at the first stage's iterations, plus each escalated
word's full unroll.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: 67 TFLOP/s fp32 outside the tensor cores,
# counting an FMA as two = 132 SMs x 128 fp32 lanes x 1.98 GHz single
# operations a second; HBM3 3.35 TB/s.  The BP kernels issue no tensor-core
# instruction, so these are the peaks in use.
PEAK_OPS_PER_S = 132 * 128 * 1.98e9  # 33.5e12
PEAK_BYTES_PER_S = 3.35e12

QUANTIZE = 5  # x * scale, rint, / scale, max, min
SAMPLER_OPS_PER_PAIR = 2 * 23 + 5  # two hashed uniforms; 1 - u, log, * -2, sqrt, 2 pi u
SAMPLER_OPS_PER_BIT = 4  # cos or sin, r * g, * scale, + base
STATS_BYTES = 12  # per word: syndrome flag, bit errors, frame error (int32 each)


def _flags(dec: dict):
    sh = dec["sharing"]
    return (dec["type"] == "QMS", dec["type"] == "SP", sh.get("cn", 0) != 0,
            sh.get("vn", 0) != 0, sh.get("ucn", 0) != 0)


def forward_ops_per_word(shape, dec: dict, iterations: int | None = None) -> int:
    """One word's decode: every iteration's VN, check and post-chain
    updates and the final APP."""
    qms, sp, cn_w, vn_w, ucn = _flags(dec)
    iters = dec["iterations"] if iterations is None else iterations
    cq = QUANTIZE if qms else 2  # clip or quantize
    per_bit = 1  # total = VN input + sums
    if vn_w:
        per_bit += 1 + (QUANTIZE if qms else 0)  # Q(chan * w)
    if ucn:
        per_bit += 4
    per_edge = 1 + cq  # v2c = clip_or_quantize(total - msg)
    per_edge += 11 if sp else 7  # check update
    per_edge += 2 * int(ucn)
    per_edge += 1 + int(cn_w or ucn) + 1 + cq + 2 + 1  # |c2v|, weight, relu, cq, sign
    per_edge += 1  # the bit's sum
    ez, nz = shape.E * shape.Z, shape.N * shape.Z
    return iters * (ez * per_edge + nz * per_bit) + nz


def backward_ops_per_word(shape, dec: dict) -> int:
    """One word's backward through every iteration: the forward's
    recompute, the post-chain and check-update adjoints, the VN sums and
    the weight reductions."""
    qms, sp, cn_w, vn_w, ucn = _flags(dec)
    cq = QUANTIZE if qms else 2
    mask = 6  # a clip's gradient mask
    per_bit = 1 + 2 + 2
    if vn_w:
        per_bit += 1 + (QUANTIZE if qms else 0)
        per_bit += 1 + (mask if qms else 0) + 1 + 2
    if ucn:
        per_bit += 2
    per_edge = 1 + cq
    per_edge += 11 if sp else 7
    per_edge += 2 + 1 + 1 + 1 + 2 + 1 + 1 + mask + 1 + 2 + 1 + 1 + 1
    per_edge += 26 if sp else 15
    per_edge += mask + 2
    per_edge += 2 * int(ucn)
    per_edge += 3
    ez, nz = shape.E * shape.Z, shape.N * shape.Z
    return dec["iterations"] * (ez * per_edge + nz * per_bit)


def loss_ops_per_word(shape, dec: dict) -> int:
    """The multi-iteration BCE on every iteration's clipped APP, and its
    gradient: clip 2, loss 9, gradient 8 a bit and iteration."""
    return dec["iterations"] * shape.N * shape.Z * (2 + 9 + 8)


def epilogue_ops_per_word(shape) -> int:
    """Syndrome and error counts: a compare a bit, a parity a message."""
    return shape.N * shape.Z + shape.E * shape.Z


def sampler_ops_per_word(shape) -> int:
    nz = shape.N * shape.Z
    return -(-nz // 2) * SAMPLER_OPS_PER_PAIR + nz * SAMPLER_OPS_PER_BIT


def train_steps(shape, dec: dict, batch: int, steps: int):
    """(ops, bytes) of ``steps`` train steps: each word's forward, loss,
    backward; channel LLRs and labels in."""
    ops = (forward_ops_per_word(shape, dec) + backward_ops_per_word(shape, dec)
           + loss_ops_per_word(shape, dec))
    return steps * batch * ops, steps * batch * 2 * shape.N * shape.Z * 4


def decodes(shape, dec: dict, words: int):
    """(ops, bytes) of decoding ``words`` words to their clipped final APP:
    LLRs in, APP out."""
    return (words * (forward_ops_per_word(shape, dec) + 2 * shape.N * shape.Z),
            words * 2 * shape.N * shape.Z * 4)


def campaign(shape, dec: dict, words: int, escalated: int, first_iterations: int):
    """(ops, bytes) of an early-exit campaign over ``words`` all-zero words
    sampled on the device, ``escalated`` of them failing the first stage:
    every word sampled and decoded at ``first_iterations`` with its
    syndrome and counts; each escalated word sampled again and decoded at
    the full unroll.  Bytes: each word's stats out, an escalated word's
    index in and its stats out."""
    per = sampler_ops_per_word(shape) + epilogue_ops_per_word(shape)
    ops = (words * (forward_ops_per_word(shape, dec, first_iterations) + per)
           + escalated * (forward_ops_per_word(shape, dec) + per))
    return ops, words * STATS_BYTES + escalated * (4 + STATS_BYTES)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
