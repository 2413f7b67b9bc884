// Forward BP decode for NVIDIA Hopper (sm_90a): final-APP, stats, syndrome,
// in-kernel AWGN sampling and training-forward modes.
//
// Replaces the TPU kernel neural_ldpc_tpu/ops/pallas/fused_train.py::_fwd_kernel
// (roll routing; MS / QMS / SP check updates; CN, UCN and VN weights):
//   K1a  final-APP decode: writes the pre-clip APP.
//   K1b  epilogues (_stats_rows, _syndrome_ok_lanes): per word, ok = every
//        lifted check satisfied by the APP's decisions, bit errors = APP < 0
//        (all-zero words), frame error = bit errors > 0.  Stats mode writes
//        only these; syndrome mode writes the APP as well.
//   K1c  in-kernel AWGN for all-zero words (sample_channel, emit_chan,
//        sample_at_idx): the channel is computed in the kernel from a
//        counter hash and never read from device memory.
//   K1d  training forward (stream_outputs, store_msgs): kStream writes the
//        pre-clip APP chan_out + sums of every iteration to out[i, w, :];
//        kStore writes the message state ENTERING iteration i (zeros at
//        i = 0) to store[i, w, k*Z + zc], in the permuted flat-edge order.
//        Neither changes the arithmetic: the last streamed output equals
//        K1a's APP bit for bit.  The backward kernel (fused_bwd.cu) reads
//        both.  kLoss (with both, without UCN; the fused BCE train step)
//        writes in place of each streamed APP x the gradient that the BCE
//        loss head at the end of fused_bwd.cu computes from x and the bit's
//        label, bit for bit (inside the loss window; 0 outside it), and one
//        partial of the loss a block: the head's pass over the stream is
//        not needed.
//
//   K6   the matmul branch (routing="matmul": _route_e_rows / _route_n_from_e,
//        _dot_split3, routed signs _ucn_mask_from_app / _syndrome_ok_lanes),
//        the ROUTE template parameter, in every mode above.  Each one-hot
//        routing product is a permutation, so K6 routes by index through
//        K1's own loop; what the matmul branch adds is its roundings, which
//        enter as compile-time hooks where a value is routed: the VN total
//        to an edge (int8: rint(clamp(x, +-2 q_hi) * scale) / scale), the
//        UCN and syndrome decision signs (int8: the +-1 sign quantized so),
//        and the VN phase's sums (int8: rint(m * scale) summed in an int,
//        then / scale; split-3: one f32 sum per bf16 part, (S_hi + S_mid) +
//        S_lo).  int8 for QMS is value-exact, so K6 = K1 bit for bit;
//        split-3's sums are a rounding away from K1.
//   K5   the legacy engine (neural_ldpc_tpu/ops/pallas/minsum.py::_kernel,
//        engine="legacy": one-hot products Rt / R in routing_dtype, or int8)
//        on its natural-order layout (ops/cuda/legacy.py), final APP only:
//        ROUTE kBf16 rounds the VN total to bf16 (round to nearest even)
//        before it reaches an edge and each message to bf16 before the VN
//        sum, which runs in f32; kLegacyInt8 is K6's int8 with the UCN
//        decision signs routed exactly (JAX routes them as int8 +-1, which
//        K6's scale would round to 0 at scale 0.5); float32 routing is roll.
//
// What it computes, per word and iteration i (roll branch of _fwd_kernel):
//   1. xa_q   = Q(chan * vn_w[i]) under QMS, chan * vn_w[i] otherwise
//               (chan_out = Q(chan) or chan when there are no VN weights)
//   2. UCN    = parity of the routed decision signs of app, where app = xa_q
//               at i = 0 and clip(chan_out + sums) after that
//   3. v2c    = clip_or_quant(vn_total[vn, (z + shift) mod Z] - old_msg)
//   4. c2v    = extrinsic two-min (sign: x >= 0 -> +1) or sum-product
//               (prefix/suffix tanh products, clamp +-(1 - 1e-7),
//               log((1 + x) / (1 - x)))
//   5. msg    = clip_or_quant(relu(|c2v| * (UCN ? ucn_w : cn_w))) * sign(c2v)
//               (sign(0) = 0)
//   6. sums   = per VN copy, the messages rolled back by -shift, added in
//               increasing original edge id (the plain decoder's order, so
//               MS sums equal its float sums term for term)
// and writes the pre-clip APP chan_out + sums of the last iteration.  Steps
// 3-5 are bp_common.cuh's, shared with fused_fwd_dm.cu.
//
// Design.  A block of up to 256 threads owns W whole words, W as many as
// let 3 blocks share an SM's shared memory (2 for checks of more than 16
// edges; ops/cuda/fused_train.py::k1_plan); their state lives in shared
// memory for all iterations, so device memory sees one read of the channel
// and one write of the APP per word.  The kernel is instantiated per MAXB
// (16 or 32 slots, or kAnyDegree for a code with a check of more than 32
// edges), routing and QMS (the int8 routings for QMS only), so that no flag
// is tested per value.
// A word's region (S floats; S mod 32 is Z mod 32 rounded down to a multiple
// of 4, so that the lanes of two words in one warp fall in other banks) holds
//   chan [NZ4]      the channel (read or sampled once);
//   tot  [NZ4]      per VN copy, the total its edges read next: chan_in +
//                   sums (K6 int8: its routed value); after the last
//                   iteration in the stats modes, the APP;
//   app  [NZ4]      with UCN, the app whose signs gate the UCN weights;
//   msg  [E*Z]      the messages in the VN's frame: edge k's message from
//                   lifted check zc sits at k*Z + (zc + shift_k) mod Z, the
//                   lift of the VN copy it goes to.
// A table the block loads once (k1_plan) gives, per VN slot (VNs sorted by
// degree), its first copy, edge range and index; per sorted check its first
// edge and degree; per edge the packed offsets (tot row + shift) | (msg row
// + shift) << 16 and Z - shift, so that lifted check zc reaches both with
// one add, one compare and no table of shifts; and per VN entry its message
// row.  Each iteration:
//   check phase  the threads walk (check, word, lift) items, the words of a
//                check side by side (degrees change only between checks,
//                which are sorted by degree).  A check runs the smallest of
//                nine instantiations (4 ... 32 slots, up to the kernel's
//                MAXB) that holds its degree, issues every load before the
//                arithmetic (slots past d repeat edge d - 1), reads one total
//                and one entering message per slot, and writes its messages
//                back in place (each thread owns its edges' slots); with
//                kStore it also writes the entering messages to the store.
//                A check of more than 32 edges (kAnyDegree only) runs
//                check_loop: two passes over its slots, v2c (SP: tanh(v2c /
//                2)) kept in its message slots between them;
//   barrier;
//   VN phase     the threads walk (VN slot, word, 4 lifts) items (1 lift
//                where Z % 4 != 0): each reads its incoming message rows 16
//                bytes at a time (the VN frame lines them up), adds them in
//                vn_list order, writes the APP where the mode asks and the
//                next iteration's total (with UCN the clipped APP) once per
//                VN copy;
//   barrier.
// So a check reads each value once per slot and the VN weight is read once
// per VN copy, with no table read from device memory and no branch in front
// of a load.
//
// K1b: in the last VN phase each thread counts APP < 0 into a per-word
// shared-memory integer (atomics on integers are exact in any order); the
// total holds the APP, and each (check, lift) item takes the parity of its
// routed decisions and marks the word unsatisfied in a per-word shared flag
// (every writer stores the same value).  Stats mode then writes 12 bytes per
// word instead of the APP.
//
// K1d's loss epilogue (kLoss; fused_fwd_loss_kernel, its own instantiation
// of the training routings at MAXB 16 and 32, so that no other mode carries
// it): the block reads its words' labels once, with the channel, into
// shared memory after the stats integers ([W] rows of NZ4 floats at a
// 16-byte boundary), then a double a thread.  In each VN phase inside the
// window [i0, i1) a thread writes the head's gradient of each of its values
// (a dozen at BG2's Z = 16; loss_element: bp_common.cuh's bce_element, as
// the head's) and sums their loss terms in float, the log1p(e) parts as one
// log1pf of the product of their 1 + e, carried less 1 so that no e is
// lost: with a log1pf an element the epilogue cost more than the head's
// whole pass.  At the phase's end the thread adds w_i times that sum
// to its own double; after the last iteration the block sums the threads'
// doubles in a fixed order (warp shuffles, then the warps in order) into its
// partial, and a second launch of one block sums the partials in a fixed
// order and scales the sum (bp_common.cuh's loss_finish_kernel, as the
// head's).  No float atomics: the loss does not depend on the schedule.
//
// K1c: word w (its batch position, or widx[w] in index mode) lies in stream
// tile t = w / bt at column c = w % bt, where bt is the logical stream tile
// of the TPU kernel's batch grid (not this kernel's block shape).  Bit
// (n, z) has row r = n*Zp + z of the padded [N*Zp] layout (Zp = Z rounded up
// to 8); rows below half = round8(ceil(N*Zp / 2)) take pair p = r and the
// cosine, the others pair p = r - half and the sine, so pad rows consume
// their pair but hold no bit.  With key = seed ^ (t * 2654435761) (uint32)
// and i = p*bt + c, each uniform is
//   u = (mix(mix((2i + draw) ^ key) ^ (key * 0x9E3779B9)) >> 8) * 2^-24
// (mix = lowbias32, draw 0 for u1, 1 for u2), and
//   llr = 2/s^2 + (2/s) * (sqrt(-2 log(1 - u1)) * cos|sin(2 pi u2)),
// the TPU kernel's integer stream and operation order exactly.  A thread
// takes a pair and writes both its bits, so the hash, the log and the
// square root run once per pair.
//
// Bound on this card: device-memory bytes are 2 * N*Z * 4 per word for K1a
// (read the channel, write the APP), N*Z*4 + 12 for K1b, 12 for K1c and
// (1 + I) * N*Z*4 + I * E*Z*4 for K1d with the store (K1d is the one mode
// bound by bytes); the operations are ~20-40 fp32 per edge copy and
// iteration (E*Z*I edge updates per word), plus the epilogue and the
// sampler's hash, which at 33.5e12 single instructions per second (132 SMs x
// 128 lanes x 1.98 GHz; built without FMA contraction, each add or multiply
// is its own instruction) is the larger bound in every other mode.  Shared
// memory (~19 KB a BG2 word) caps the words an SM holds (9 BG2 words, 15
// wman words), and the 80 registers a thread has at 3 blocks of 256
// threads an SM cap the slots a check keeps in flight.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// (-fmad=false keeps a*b+c as two roundings, as the PyTorch version computes
// it, so QMS decodes stay bit-exact and MS within float sum-order noise.  Do
// not add --use_fast_math: the sampler's logf, sqrtf, cosf and sinf must be
// the precise functions PyTorch's CUDA operators call.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_common.cuh"
#include "block_common.cuh"

namespace {

using namespace bp;

constexpr int kThreads = 256;  // threads a block at most (k1_plan picks the count)
// flag bit beside bp_common.cuh's: with kStream | kStore and no kUcn, the
// BCE head's gradient in place of the streamed APP and one loss partial a
// block (K1d's loss epilogue)
constexpr int kLoss = 1 << 16;
constexpr int kLossMaxIters = 32;     // iterations a loss window may hold (kLoss)
constexpr int kLossMaxItems = 31;     // VN items a thread may take a phase (kLoss)

struct Params {
  const float* chan;    // [B, N*Z]
  float* out;           // [B, N*Z] pre-clip APP; [I, B, N*Z] with kStream
  float* store;         // [I, B, E*Z] entering messages (kStore)
  const int* tab;       // the block table (k1_plan): vn[N] int4, chk[M] int2, edge[E] int2, row[E]
  const float* cnw;     // [I, E] in permuted edge order (or null)
  const float* ucnw;    // [I, E] (or null)
  const float* vnw;     // [I, N] (or null)
  int* stats;           // [B, 3] ok, bit errors, frame error (kStats | kSyndrome)
  float* chan_emit;     // [B, N*Z] sampled channel (kEmitChan)
  const int* widx;      // [B] original word indices (kAtIdx)
  long long B;
  int N, M, Z, E, I, W, flags;
  int S, TAB;           // floats of a word's region, ints of the table (a multiple of 4)
  int Zp, bt;           // padded lift and logical stream tile of the sampler
  unsigned seed;
  float sigma;
  float clip_lo, clip_hi, q_lo, q_hi, q_scale, q_inv_scale;
};

// K1d's loss epilogue (kLoss): the loss kernel's second parameter
// (__grid_constant__: read from the constant bank, never copied)
struct LossParams {
  const float* bits;          // [B, N*Z] labels
  double* partials;           // [blocks] each block's sum of w_i * term
  int i0, i1;                 // the loss window
  float w[kLossMaxIters];     // etha ** coeff of iteration i0 + k
  float gc[kLossMaxIters];    // its gradient factor, -w / (sum w * B*N*Z)
};

// lowbias32: full-avalanche 32-bit finalizer (fused_train.py:912-917)
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

// 24-bit uniform in [0, 1) of counter i, draw 0 or 1 (fused_train.py:919-925)
__device__ __forceinline__ float unit_uniform(uint32_t i, uint32_t draw, uint32_t key) {
  uint32_t h = mix32((i * 2u + draw) ^ key);
  h = mix32(h ^ (key * 0x9E3779B9u));
  return (float)(int)(h >> 8) * (1.0f / 16777216.0f);
}

constexpr int kRoll = 0;  // ROUTE: roll (K1), kInt8 / kSplit3 (K6), kBf16 / kLegacyInt8 (K5)

// The routing's rounding of a VN total on its way to the edges: int8 (K6 and
// K5, bp_common.cuh's int8_routed) or bf16 (K5); roll and split-3 route it
// exactly.
template <int ROUTE>
__device__ __forceinline__ float routed_total(float x, const Params& p) {
  if constexpr (int8_values(ROUTE)) return int8_routed(x, p);
  if constexpr (ROUTE == kBf16) return bf16_round(x);
  return x;
}

// whether the routed decision sign of ``app`` is negative (K6's int8:
// _routed_negative, the +-1 sign routed as a value; every other routing,
// the legacy engine's int8 too, routes it exactly)
template <int ROUTE>
__device__ __forceinline__ bool routed_negative(float app, const Params& p) {
  if constexpr (ROUTE == kInt8) return int8_routed(app < 0.0f ? -1.0f : 1.0f, p) < 0.0f;
  return app < 0.0f;
}

// bp_common.cuh's clip_or_quant and chan_out with the QMS flag known at
// compile time (the same operations)
template <bool QMS>
__device__ __forceinline__ float cq(float x, const Params& p) {
  if constexpr (QMS) return quant(x, p);
  return fminf(fmaxf(x, p.clip_lo), p.clip_hi);
}

template <bool QMS>
__device__ __forceinline__ float ch_out(float c, const Params& p) {
  if constexpr (QMS) return quant(c, p);
  return c;
}

// bp_common.cuh's post_chain with the edge's weight loaded beforehand (the
// same operations): msg = clip_or_quant(relu(|c2v| * w)) * sign(c2v)
template <bool QMS>
__device__ __forceinline__ float post_chain_w(float c2v, float wt, bool weighted,
                                              const Params& p) {
  float wm = fabsf(c2v);
  if (weighted) wm = wm * wt;
  wm = fmaxf(wm, 0.0f);
  return cq<QMS>(wm, p) * sign0(c2v);
}

// A word's regions in shared memory (see the note at the top).
struct Word {
  float *chan, *tot, *app, *msg;
};

__device__ __forceinline__ Word word_at(float* words, int lw, const Params& p) {
  const int nz4 = (p.N * p.Z + 3) & ~3;
  float* w = words + (size_t)lw * p.S;
  return Word{w, w + nz4, w + 2 * nz4, w + ((p.flags & kUcn) ? 3 : 2) * nz4};
}

// One lifted check (first edge k0, degree d <= D, lift zc) of one word in
// the check phase of iteration ``it``.  Every load is made for j < D (slots
// past d repeat edge d - 1), so that they issue ahead of the arithmetic;
// only j < d is used or written.  ``st`` is the check's first slot in the
// store (kStore), or null.
template <int D, int ROUTE, bool QMS>
__device__ __forceinline__ void check_one(const Params& p, const int2* edge, const Word& w,
                                          int k0, int d, int zc, int it, float* st) {
  const int Z = p.Z;
  uint32_t at[D];  // (tot index) | (msg index) << 16 of each slot
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int2 e = edge[k0 + (j < d ? j : d - 1)];
    const int z = zc - (zc >= e.y ? Z : 0);  // (zc + shift) mod Z minus shift
    at[j] = (uint32_t)e.x + (uint32_t)z * 0x10001u;
  }
  const bool weighted = p.flags & (kCnW | kUcn);
  bool unsat = false;
  if (p.flags & kUcn) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      unsat ^= (j < d) & routed_negative<ROUTE>(w.app[at[j] & 0xFFFFu], p);
  }
  const float* wrow = weighted
      ? (((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw) + (size_t)it * p.E + k0 : nullptr;
  // v[] holds v2c, then (SP) tanh(v2c / 2), then c2v, in place
  float v[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float old = (it == 0) ? 0.0f : w.msg[at[j] >> 16];
    if (st && j < d) st[(size_t)j * Z] = old;
    v[j] = cq<QMS>(w.tot[at[j] & 0xFFFFu] - old, p);
  }
  constexpr bool kHoist = D <= 12;  // weights loaded ahead of the check update
  float wt[kHoist ? D : 1];
  if constexpr (kHoist) {
#pragma unroll
    for (int j = 0; j < D; ++j) wt[j] = weighted ? __ldg(wrow + (j < d ? j : d - 1)) : 1.0f;
  }
  check_update<D>(v, d, p.flags & kSumProduct);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float wj;
    if constexpr (kHoist) {
      wj = wt[j];
    } else {
      wj = weighted ? __ldg(wrow + (j < d ? j : d - 1)) : 1.0f;
    }
    if (j < d) w.msg[at[j] >> 16] = post_chain_w<QMS>(v[j], wj, weighted, p);
  }
}

// A lifted check of more than 32 edges (the kAnyDegree instantiation):
// check_one's loads and arithmetic in passes over the slots
// (bp_common.cuh's check_update_loop), its messages between the passes in
// its own message slots.
template <int ROUTE, bool QMS>
__device__ __noinline__ void check_loop(const Params& p, const int2* edge, const Word& w, int k0,
                                        int d, int zc, int it, float* st) {
  const int Z = p.Z;
  auto at = [&](int j) {  // (tot index) | (msg index) << 16 of slot j
    const int2 e = edge[k0 + j];
    return (uint32_t)e.x + (uint32_t)(zc - (zc >= e.y ? Z : 0)) * 0x10001u;
  };
  const bool weighted = p.flags & (kCnW | kUcn);
  bool unsat = false;
  if (p.flags & kUcn) {
    for (int j = 0; j < d; ++j) unsat ^= routed_negative<ROUTE>(w.app[at(j) & 0xFFFFu], p);
  }
  const float* wrow = weighted
      ? (((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw) + (size_t)it * p.E + k0 : nullptr;
  check_update_loop(
      d, p.flags & kSumProduct,
      [&](int j) {
        const uint32_t a = at(j);
        const float old = (it == 0) ? 0.0f : w.msg[a >> 16];
        if (st) st[(size_t)j * Z] = old;
        return cq<QMS>(w.tot[a & 0xFFFFu] - old, p);
      },
      [&](int j) -> float& { return w.msg[at(j) >> 16]; },
      [&](int j, float c2v) {
        return post_chain_w<QMS>(c2v, weighted ? __ldg(wrow + j) : 1.0f, weighted, p);
      });
}

// The check at its smallest instantiation (4, 6, 8, 10, 12, 16; with MAXB
// 32 or kAnyDegree also 20, 24 and 32 slots; with kAnyDegree, beyond 32
// slots, check_loop).
template <int MAXB, int ROUTE, bool QMS>
__device__ __forceinline__ void check_any(const Params& p, const int2* edge, const Word& w,
                                          int k0, int d, int zc, int it, float* st) {
#define K1_CHECK(D) check_one<D, ROUTE, QMS>(p, edge, w, k0, d, zc, it, st)
  if (d <= 4) K1_CHECK(4);
  else if (d <= 6) K1_CHECK(6);
  else if (d <= 8) K1_CHECK(8);
  else if (d <= 10) K1_CHECK(10);
  else if (d <= 12) K1_CHECK(12);
  else if (MAXB == 16 || d <= 16) K1_CHECK(16);
  else if constexpr (MAXB != 16) {
    if (d <= 20) K1_CHECK(20);
    else if (d <= 24) K1_CHECK(24);
    else if (MAXB == 32 || d <= 32) K1_CHECK(32);
    else if constexpr (MAXB == kAnyDegree) check_loop<ROUTE, QMS>(p, edge, w, k0, d, zc, it, st);
  }
#undef K1_CHECK
}

// chan_in of iteration ``it`` (bp_common.cuh's, with the VN weight read
// once for the VEC copies)
template <int VEC, bool QMS>
__device__ __forceinline__ void chan_in_v(const float (&c)[VEC], int vn, int it, const Params& p,
                                          float (&x)[VEC]) {
  if (p.flags & kVnW) {
    const float wv = __ldg(p.vnw + (size_t)it * p.N + vn);
#pragma unroll
    for (int u = 0; u < VEC; ++u) x[u] = ch_out<QMS>(c[u] * wv, p);  // xa_q = Q(chan * vn_w)
  } else {
#pragma unroll
    for (int u = 0; u < VEC; ++u) x[u] = ch_out<QMS>(c[u], p);
  }
}

// kLoss: the block's label rows ([W] of NZ4 floats at a 16-byte boundary
// after the stats integers) and, after them, a double a thread; computed
// where they are used, so that no pointer stays live through the loop.
__device__ __forceinline__ float* loss_labels(const Params& p, float* words) {
  return words + (((size_t)p.W * p.S + 2 * p.W + 3) & ~(size_t)3);
}

__device__ __forceinline__ double* loss_sums(const Params& p, float* words) {
  return reinterpret_cast<double*>(loss_labels(p, words) + (size_t)p.W * ((p.N * p.Z + 3) & ~3));
}

// One value x of window iteration k with label y (kLoss): the gradient with
// respect to x, bp_common.cuh's bce_element as the loss head computes it.
// Its loss term lin + log1p(e) goes in two parts, so that no value takes a
// log of its own: lin is added to ``sum``, and ``d``, the product of the
// phase's 1 + e less 1, becomes d (1 + e) + e, one FMA on the 1 + e that
// the gradient's division takes too; the phase takes one log1pf(d).  d
// keeps each e as a float sum would, however small (at a clip of 20, e =
// 2.06e-9 and 1 + e rounds to 1: a product of the 1 + e drops it), and at
// most kLossMaxItems items of 4 values keep it below 2^124.
__device__ __forceinline__ float loss_element(const Params& p, const LossParams& lp, int k,
                                              float x, float y, float& sum, float& d) {
  float lin, e;
  const float g = bce_element(x, y, p.clip_lo, p.clip_hi, lp.gc[k], lin, e);
  sum += lin;
  d = __fmaf_rn(d, 1.0f + e, e);
  return g;
}

// The VN phase of iteration ``it`` over the block's words, VEC lifts an
// item; counts APP < 0 into ``berr`` (last iteration, stats modes); with
// LOSS (kLoss, ``lp``) writes the loss's gradient and adds w_i times the sum
// of this thread's terms (a dozen a phase at BG2's Z = 16) to its double.
template <int VEC, int ROUTE, bool QMS, bool LOSS>
__device__ __forceinline__ void vn_phase(const Params& p, const LossParams* lp, const int* tab,
                                         float* words, int* berr, long long word0, int it) {
  const int NZ = p.N * p.Z;
  const bool last = it == p.I - 1;
  const bool stream = p.flags & kStream, stats = p.flags & (kStats | kSyndrome);
  const bool write_out = (last || stream) && !(p.flags & kStats);
  const bool ucn = p.flags & kUcn;
  bool in_window = false;
  if constexpr (LOSS) in_window = it >= lp->i0 && it < lp->i1;
  const int4* vns = reinterpret_cast<const int4*>(tab);
  const int* row = tab + 4 * p.N + 2 * p.M + 2 * p.E;
  float* out = p.out + (stream ? (size_t)it * p.B * NZ : 0);
  float lsum = 0.0f, ld = 0.0f;  // LOSS: the phase's terms, in two parts (loss_element)
  for (Walk v = walk(p.N, p.W, p.Z / VEC); v.ok(); v.next()) {
    const int4 vn = vns[v.a];  // first copy n*Z, edge range, VN index
    const Word w = word_at(words, v.b, p);
    const int zoff = VEC * v.c, q = vn.x + zoff;
    const long long gw = word0 + v.b;
    float acc[VEC], ch[VEC], co[VEC], app[VEC];
    vn_sums<VEC, ROUTE>(p, row, w.msg, vn.y, vn.z, zoff, acc);
    lds<VEC>(w.chan + q, ch);
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      co[u] = ch_out<QMS>(ch[u], p);
      app[u] = co[u] + acc[u];
    }
    if (gw < p.B) {
      if (write_out) {
        float* o = out + gw * NZ + q;
        if constexpr (LOSS) {  // the loss's gradient in place of the APP (no stats, no UCN
                               // read it below), 0 outside the window
          if (in_window) {
            float y[VEC];
            lds<VEC>(loss_labels(p, words) + (size_t)v.b * ((NZ + 3) & ~3) + q, y);
#pragma unroll
            for (int u = 0; u < VEC; ++u)
              app[u] = loss_element(p, *lp, it - lp->i0, app[u], y[u], lsum, ld);
          } else {
#pragma unroll
            for (int u = 0; u < VEC; ++u) app[u] = 0.0f;
          }
        }
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(o) = make_float4(app[0], app[1], app[2], app[3]);
        } else {
          *o = app[0];
        }
      }
      if (last && stats) {
        int neg = 0;
#pragma unroll
        for (int u = 0; u < VEC; ++u) neg += app[u] < 0.0f;
        if (neg) atomicAdd(berr + v.b, neg);
      }
    }
    if (last) {
      if (stats) sts<VEC>(w.tot + q, app);  // the syndrome's decisions
      continue;
    }
    float x[VEC], tot[VEC];
    if (p.flags & kVnW) {
      chan_in_v<VEC, QMS>(ch, vn.w, it + 1, p, x);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) x[u] = co[u];
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      tot[u] = routed_total<ROUTE>(x[u] + acc[u], p);
    }
    sts<VEC>(w.tot + q, tot);
    if (ucn) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) app[u] = fminf(fmaxf(app[u], p.clip_lo), p.clip_hi);
      sts<VEC>(w.app + q, app);
    }
  }
  if constexpr (LOSS) {
    if (in_window)  // the thread's own double, iterations in order
      loss_sums(p, words)[threadIdx.x] += (double)(lp->w[it - lp->i0] * (lsum + log1pf(ld)));
  }
}

// Iteration 0's totals (chan_in + 0; K6 int8 routed) and, with UCN, app =
// chan_in, from the channel in shared memory or, ``read``, from device
// memory (then also written to shared memory; with kLoss the labels too).
template <int VEC, int ROUTE, bool QMS, bool LOSS>
__device__ __forceinline__ void first_totals(const Params& p, const LossParams* lp, const int* tab,
                                             float* words, long long word0, bool read) {
  const int NZ = p.N * p.Z;
  const int4* vns = reinterpret_cast<const int4*>(tab);
  for (Walk v = walk(p.N, p.W, p.Z / VEC); v.ok(); v.next()) {
    const int4 vn = vns[v.a];
    const Word w = word_at(words, v.b, p);
    const int q = vn.x + VEC * v.c;
    const long long gw = word0 + v.b;
    float ch[VEC], x[VEC], tot[VEC];
    if (read) {
      if (gw < p.B) {
        const float* src = p.chan + gw * NZ + q;
        if constexpr (VEC == 4) {
          const float4 c4 = __ldg(reinterpret_cast<const float4*>(src));
          ch[0] = c4.x;
          ch[1] = c4.y;
          ch[2] = c4.z;
          ch[3] = c4.w;
        } else {
          ch[0] = __ldg(src);
        }
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u) ch[u] = 0.0f;  // past the batch end: never written back
      }
      sts<VEC>(w.chan + q, ch);
      if constexpr (LOSS) {
        float y[VEC] = {};
        if (gw < p.B) {
          const float* src = lp->bits + gw * NZ + q;
          if constexpr (VEC == 4) {
            const float4 y4 = __ldg(reinterpret_cast<const float4*>(src));
            y[0] = y4.x;
            y[1] = y4.y;
            y[2] = y4.z;
            y[3] = y4.w;
          } else {
            y[0] = __ldg(src);
          }
        }
        sts<VEC>(loss_labels(p, words) + (size_t)v.b * ((NZ + 3) & ~3) + q, y);
      }
    } else {
      lds<VEC>(w.chan + q, ch);
    }
    chan_in_v<VEC, QMS>(ch, vn.w, 0, p, x);
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      tot[u] = routed_total<ROUTE>(x[u] + 0.0f, p);
    }
    sts<VEC>(w.tot + q, tot);
    if (p.flags & kUcn) sts<VEC>(w.app + q, x);
  }
}

// K1c: the block's words' channel, sampled in the kernel a pair of rows a
// thread, into shared memory (and, kEmitChan, device memory).
__device__ __forceinline__ void sample_words(const Params& p, float* words, long long word0) {
  const int NZ = p.N * p.Z, nzp = p.N * p.Zp;
  const int half = ((nzp + 1) / 2 + 7) / 8 * 8;
  const uint32_t bt = (uint32_t)p.bt;
  const float base = 2.0f / (p.sigma * p.sigma);
  const float scale = 2.0f / p.sigma;
  for (Walk s = walk(p.W, half, 1); s.ok(); s.next()) {
    const long long gw = word0 + s.a;
    float* chan = word_at(words, s.a, p).chan;
    const int p1 = s.b, p2 = s.b + half;  // the pair's rows
    const int n1 = p1 / p.Zp, z1 = p1 - n1 * p.Zp;
    const int n2 = p2 / p.Zp, z2 = p2 - n2 * p.Zp;
    const bool has1 = z1 < p.Z, has2 = p2 < nzp && z2 < p.Z;
    const int q1 = n1 * p.Z + z1, q2 = n2 * p.Z + z2;
    if (gw >= p.B) {  // past the batch end: zeros, never written back
      if (has1) chan[q1] = 0.0f;
      if (has2) chan[q2] = 0.0f;
      continue;
    }
    const uint32_t wid = (p.flags & kAtIdx) ? (uint32_t)__ldg(p.widx + gw) : (uint32_t)gw;
    const uint32_t key = p.seed ^ ((wid / bt) * 2654435761u);
    const uint32_t i = (uint32_t)p1 * bt + wid % bt;
    const float u1 = unit_uniform(i, 0u, key);
    const float u2 = unit_uniform(i, 1u, key);
    const float r = sqrtf(-2.0f * logf(1.0f - u1));
    float theta = (float)(2.0 * 3.14159265358979323846) * u2;
    if (has1) {
      const float c = base + scale * (r * cosf(theta));
      chan[q1] = c;
      if (p.flags & kEmitChan) p.chan_emit[gw * NZ + q1] = c;
    }
    // keep sinf and cosf the separate functions PyTorch's operators call
    asm volatile("" : "+f"(theta));
    if (has2) {
      const float c = base + scale * (r * sinf(theta));
      chan[q2] = c;
      if (p.flags & kEmitChan) p.chan_emit[gw * NZ + q2] = c;
    }
  }
}

// The kernel's body; LOSS: K1d's loss epilogue (fused_fwd_loss_kernel, ``lp``).
template <int MAXB, int ROUTE, bool QMS, bool LOSS>
__device__ __forceinline__ void fwd_block(const Params& p, const LossParams* lp) {
  extern __shared__ __align__(16) float smem[];
  int* tab = reinterpret_cast<int*>(smem);
  float* words = smem + p.TAB;
  int* berr_s = reinterpret_cast<int*>(words + (size_t)p.W * p.S);  // [W] bit errors (K1b)
  int* bad_s = berr_s + p.W;  // [W] some check unsatisfied (K1b)
  const int tid = threadIdx.x, T = blockDim.x;
  const long long word0 = (long long)blockIdx.x * p.W;
  const bool epilogue = p.flags & (kStats | kSyndrome);
  const bool vec4 = (p.Z & 3) == 0;

  for (int i = tid; i < p.TAB / 4; i += T)
    reinterpret_cast<int4*>(tab)[i] = __ldg(reinterpret_cast<const int4*>(p.tab) + i);
  if (tid < p.W) {
    berr_s[tid] = 0;
    bad_s[tid] = 0;
  }
  if constexpr (LOSS) loss_sums(p, words)[tid] = 0.0;
  if (p.flags & kSample) sample_words(p, words, word0);
  __syncthreads();
  const bool read = !(p.flags & kSample);
  if (vec4) {
    first_totals<4, ROUTE, QMS, LOSS>(p, lp, tab, words, word0, read);
  } else {
    first_totals<1, ROUTE, QMS, LOSS>(p, lp, tab, words, word0, read);
  }
  __syncthreads();

  const int2* chk = reinterpret_cast<const int2*>(tab + 4 * p.N);
  const int2* edge = chk + p.M;
  const size_t EZ = (size_t)p.E * p.Z;
  for (int it = 0; it < p.I; ++it) {
    // -------------------------------- check phase -------------------------
    for (Walk c = walk(p.M, p.W, p.Z); c.ok(); c.next()) {
      const int2 ck = chk[c.a];  // first edge, degree
      const long long gw = word0 + c.b;
      float* st = ((p.flags & kStore) && gw < p.B)
          ? p.store + ((size_t)it * p.B + gw) * EZ + (size_t)ck.x * p.Z + c.c : nullptr;
      check_any<MAXB, ROUTE, QMS>(p, edge, word_at(words, c.b, p), ck.x, ck.y, c.c, it, st);
    }
    __syncthreads();
    // --------------------------------- VN phase ---------------------------
    if (vec4) {
      vn_phase<4, ROUTE, QMS, LOSS>(p, lp, tab, words, berr_s, word0, it);
    } else {
      vn_phase<1, ROUTE, QMS, LOSS>(p, lp, tab, words, berr_s, word0, it);
    }
    __syncthreads();
  }

  // ---------------- K1b epilogue: syndrome and per-word stats ----------------
  if (epilogue) {
    for (Walk c = walk(p.M, p.W, p.Z); c.ok(); c.next()) {
      const int2 ck = chk[c.a];
      const float* tot = word_at(words, c.b, p).tot;  // the last APP
      bool odd = false;
#pragma unroll 4
      for (int k = ck.x; k < ck.x + ck.y; ++k) {
        const int2 e = edge[k];
        const int z = c.c - (c.c >= e.y ? p.Z : 0);
        odd ^= routed_negative<ROUTE>(tot[(e.x & 0xFFFF) + z], p);
      }
      if (odd) bad_s[c.b] = 1;  // every writer stores the same value
    }
    __syncthreads();
    if (tid < p.W) {
      const long long gw = word0 + tid;
      if (gw < p.B) {
        int* st = p.stats + gw * 3;
        st[0] = bad_s[tid] ? 0 : 1;
        st[1] = berr_s[tid];
        st[2] = berr_s[tid] > 0 ? 1 : 0;
      }
    }
  }

  // ---------------- K1d's loss: the block's partial, in a fixed order ----------------
  if constexpr (LOSS) {
    double* lacc = loss_sums(p, words);
    double s = lacc[tid];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if ((tid & 31) == 0) lacc[tid] = s;  // lane 0 read its own slot above
    __syncthreads();
    if (tid == 0) {
      double b = 0.0;
      for (int w = 0; w < T; w += 32) b += lacc[w];
      lp->partials[blockIdx.x] = b;
    }
  }
}

template <int MAXB, int ROUTE, bool QMS>
__global__ void __launch_bounds__(kThreads, MAXB == 16 ? 3 : 2) fused_fwd_kernel(Params p) {
  fwd_block<MAXB, ROUTE, QMS, false>(p, nullptr);
}

// K1d's loss mode (kLoss), its own instantiation so that no other mode
// carries the epilogue: the training routings (roll, K6's int8 and split-3)
// at MAXB 16 and 32.
template <int MAXB, int ROUTE>
constexpr bool kLossRoute = MAXB != kAnyDegree && (ROUTE == kRoll || ROUTE == kInt8 ||
                                                   ROUTE == kSplit3);

template <int MAXB, int ROUTE, bool QMS>
__global__ void __launch_bounds__(kThreads, MAXB == 16 ? 3 : 2)
    fused_fwd_loss_kernel(Params p, const __grid_constant__ LossParams lp) {
  fwd_block<MAXB, ROUTE, QMS, true>(p, &lp);
}

template <class K, class... A>
cudaError_t launch_kernel(K kern, const Params& p, int threads, int smem, cudaStream_t stream,
                          int* launched, const A&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((p.B + p.W - 1) / p.W);
  kern<<<blocks, threads, smem, stream>>>(p, args...);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

// the kernel of ``p.flags``' mode; kLoss with a routing that has no loss
// instantiation is refused
template <int MAXB, int ROUTE, bool QMS>
cudaError_t launch(const Params& p, const LossParams& lp, int threads, int smem,
                   cudaStream_t stream, int* launched) {
  if (!(p.flags & kLoss))
    return launch_kernel(fused_fwd_kernel<MAXB, ROUTE, QMS>, p, threads, smem, stream, launched);
  if constexpr (kLossRoute<MAXB, ROUTE>)
    return launch_kernel(fused_fwd_loss_kernel<MAXB, ROUTE, QMS>, p, threads, smem, stream,
                         launched, lp);
  return cudaErrorInvalidValue;
}

template <class K>
cudaError_t query_kernel(K kern, int threads, int smem, int* blocks, cudaFuncAttributes* fa) {
  cudaError_t err = cudaFuncGetAttributes(fa, kern);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads, smem);
  return err;
}

template <int MAXB, int ROUTE, bool QMS>
cudaError_t query(int flags, int threads, int smem, int* blocks, cudaFuncAttributes* fa) {
  if (!(flags & kLoss))
    return query_kernel(fused_fwd_kernel<MAXB, ROUTE, QMS>, threads, smem, blocks, fa);
  if constexpr (kLossRoute<MAXB, ROUTE>)
    return query_kernel(fused_fwd_loss_kernel<MAXB, ROUTE, QMS>, threads, smem, blocks, fa);
  return cudaErrorInvalidValue;
}

template <int MAXB, int ROUTE, bool QMS>
struct Launch {
  static cudaError_t run(const Params* p, const LossParams* lp, int threads, int smem,
                         cudaStream_t s, int* launched) {
    return launch<MAXB, ROUTE, QMS>(*p, *lp, threads, smem, s, launched);
  }
};

template <int MAXB, int ROUTE, bool QMS>
struct Query {
  static cudaError_t run(int flags, int threads, int smem, int* blocks, cudaFuncAttributes* fa) {
    return query<MAXB, ROUTE, QMS>(flags, threads, smem, blocks, fa);
  }
};

// the instantiation for the largest check degree, the routing bits and the
// QMS flag of ``flags``: F<MAXB, ROUTE, QMS>::run(args...).  int8 routing
// is QMS's.
template <template <int, int, bool> class F, int MAXB, class... A>
cudaError_t dispatch_route(int flags, A... args) {
  const bool qms = flags & kQms;
  if (flags & kRouteLegacy) {
    if (flags & kRouteInt8)
      return qms ? F<MAXB, kLegacyInt8, true>::run(args...) : cudaErrorInvalidValue;
    return qms ? F<MAXB, kBf16, true>::run(args...) : F<MAXB, kBf16, false>::run(args...);
  }
  if (flags & kRouteInt8) return qms ? F<MAXB, kInt8, true>::run(args...) : cudaErrorInvalidValue;
  if (flags & kRouteSplit3)
    return qms ? F<MAXB, kSplit3, true>::run(args...) : F<MAXB, kSplit3, false>::run(args...);
  return qms ? F<MAXB, kRoll, true>::run(args...) : F<MAXB, kRoll, false>::run(args...);
}

template <template <int, int, bool> class F, class... A>
cudaError_t dispatch(int max_deg, int flags, A... args) {
  if (max_deg <= 16) return dispatch_route<F, 16>(flags, args...);
  if (max_deg <= 32) return dispatch_route<F, 32>(flags, args...);
  return dispatch_route<F, kAnyDegree>(flags, args...);
}

}  // namespace

// The instantiation for ``max_deg`` and the routing of ``flags``: how many
// blocks of ``threads`` threads with ``smem`` bytes of dynamic shared memory
// an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and
// its registers and local (spill) bytes per thread.
extern "C" int fused_fwd_query(int max_deg, int flags, int threads, int smem, int* blocks,
                               int* registers, int* local_bytes) {
  cudaFuncAttributes fa = {};
  *blocks = 0;
  const cudaError_t err = dispatch<Query>(max_deg, flags, flags, threads, smem, blocks, &fa);
  *registers = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)err;
}

// One launch of the decode kernel in the mode and routing ``flags`` select
// (K1; K6 with kRouteInt8 / kRouteSplit3; K5 with kRouteLegacy, and
// kRouteInt8 for its int8), added to ``*launched``: blocks
// of ``threads`` threads, each ``W`` words of ``S`` floats after the table
// ``tab`` of ``TAB`` ints (ops/cuda/fused_train.py::k1_plan).  With kLoss
// ``out`` receives the loss's gradient, ``partials`` a double a block and
// ``loss`` [] the loss over the window [i0, i1) of the labels ``bits``
// [B, N*Z], ``loss_w`` a host array of the window's i1 - i0 weights etha **
// coeff, copied into the launch's parameters; a second launch sums the
// partials.  Pointers the mode does not use may be null.  Returns a
// cudaError_t.
extern "C" int fused_fwd_launch(
    const float* chan, float* out, float* store, int* stats, float* chan_emit, const int* widx,
    const int* tab, const float* cnw, const float* ucnw, const float* vnw, const float* bits,
    double* partials, float* loss, const float* loss_w,
    int B, int N, int M, int Z, int E, int I, int max_deg, int W, int threads, int S, int TAB,
    int flags, int Zp, int bt, int seed, int i0, int i1, float sigma, float clip_lo,
    float clip_hi, float q_lo, float q_hi, float q_scale, void* stream, int* launched) {
  Params p{chan, out, store, tab, cnw, ucnw, vnw, stats, chan_emit, widx,
           (long long)B, N, M, Z, E, I, W, flags, S, TAB, Zp, bt, (unsigned)seed, sigma,
           clip_lo, clip_hi, q_lo, q_hi, q_scale, 1.0f / q_scale};
  LossParams lp{bits, partials, i0, i1, {}, {}};
  if (B <= 0) return (int)cudaSuccess;
  if (I <= 0 || W < 1 || threads < 32 || threads > kThreads || !tab || TAB % 4 ||
      (long long)N * Z > 65535 || (long long)E * Z > 65535)
    return (int)cudaErrorInvalidValue;
  if ((flags & kSample) ? bt <= 0 : !chan) return (int)cudaErrorInvalidValue;
  if ((flags & kStream) && (flags & (kStats | kSyndrome))) return (int)cudaErrorInvalidValue;
  if ((flags & kStore) && (!(flags & kStream) || !store)) return (int)cudaErrorInvalidValue;
  if ((flags & (kStats | kSyndrome)) && !stats) return (int)cudaErrorInvalidValue;
  if (!(flags & kStats) && !out) return (int)cudaErrorInvalidValue;
  const bool with_loss = flags & kLoss;
  if (with_loss && (!(flags & kStore) || (flags & (kUcn | kSample)) || !bits || !partials ||
                    !loss || !loss_w || i0 < 0 || i1 <= i0 || i1 > I || i1 - i0 > kLossMaxIters ||
                    ((long long)N * W * ((Z & 3) ? Z : Z / 4) + threads - 1) / threads >
                        kLossMaxItems))
    return (int)cudaErrorInvalidValue;
  // the VN phase moves 4 lifts at once where Z % 4 == 0: 16-byte rows
  if ((Z & 3) == 0 && (((uintptr_t)out | (uintptr_t)(flags & kSample ? nullptr : chan) |
                        (uintptr_t)(with_loss ? bits : nullptr)) & 15))
    return (int)cudaErrorMisalignedAddress;
  long long smem = 4LL * TAB + 4LL * W * S + 8LL * W;
  if (with_loss) smem = (smem + 15) / 16 * 16 + 4LL * W * ((N * Z + 3) & ~3) + 8LL * threads;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  double scale = 0.0;
  if (with_loss) {
    double wsum = 0.0;  // from the last iteration down, as the loss head adds them
    for (int k = i1 - i0 - 1; k >= 0; --k) wsum += (double)loss_w[k];
    scale = 1.0 / (wsum * ((double)B * N * Z));
    for (int k = 0; k < i1 - i0; ++k) {
      lp.w[k] = loss_w[k];
      lp.gc[k] = (float)(-(double)loss_w[k] * scale);
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = dispatch<Launch>(max_deg, flags, &p, &lp, threads, (int)smem, s, launched);
  if (err != cudaSuccess || !with_loss) return (int)err;
  loss_finish_kernel<double><<<1, kFinishThreads, 0, s>>>(partials, (B + W - 1) / W, scale,
                                                         loss);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
