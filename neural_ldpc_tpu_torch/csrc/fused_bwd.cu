// Backward BP kernel for NVIDIA Hopper (sm_90a): the adjoint of the
// training forward (fused_fwd.cu with kStream | kStore), iteration by
// iteration from the last to the first, inside one launch.
//
// Replaces the TPU kernel neural_ldpc_tpu/ops/pallas/fused_train.py::_bwd_kernel
// (roll routing; MS / QMS / SP; CN, UCN and VN weights).  The TPU kernel's
// grid over (batch tile, reversed iteration) becomes a loop inside the block:
// blocks run in no order on the GPU, so nothing could carry between them.
//
// Inputs per word: the channel, store[i] (the message state entering
// iteration i, in the permuted flat-edge order k*Z + zc), outs[i] (the
// pre-clip APP of iteration i, read with UCN) and g_outs[i] (the cotangent
// of outs[i]; the final clip's adjoint is autograd's, outside).
//
// Design (fused_fwd.cu's block, ops/cuda/fused_train.py::k2_plan).  A block
// of up to 1,024 threads owns W whole words: as many as let 2 blocks of 512
// threads share an SM, and one word a block where the batch is small (then
// up to 1,024 threads spread one word's items).  A word's region in shared
// memory (S floats, S mod 32 as in the forward, so that the lanes of two
// words in one warp fall in other banks) holds
//   chan   [NZ4]  the channel;
//   tot    [NZ4]  chan_in + sums_{i-1} per VN copy (B0), then the VN-weight
//                 terms (B1);
//   gsums  [NZ4]  the cotangent of sums_i, carried (K6 int8 with bf16
//                 cotangents: kept bf16-rounded, as phase A reads it through
//                 the routing product);
//   gchan  [NZ4]  the channel-gradient accumulator; gchanq [NZ4] under QMS
//                 (the cotangent of chan_out lands there);
//   app    [NZ4]  with UCN, the clipped APP of iteration i-1 (xa_q at i = 0);
//   st     [E*Z]  store[i] in the VN's frame (edge k's entry of lifted check
//                 zc at k*Z + (zc + shift_k) mod Z), then the weight terms;
//   gmsg   [E*Z]  the message cotangent carry, in the VN's frame;
//   ucn    [M*Z]  with UCN, a flag byte per lifted check.
// Before the words: the forward's table (k1_plan's: VN slots by degree,
// checks, packed edge offsets, message rows) plus each edge's sorted check,
// loaded once; the iteration's CN (and UCN) weight rows.  Per iteration
// i = I-1 .. 0, four barriers:
//   L   store[i] copied into st rotated, 4 bytes a value by cp.async (no
//       register, all in flight at once); the weight rows; the VN-weight
//       partial of iteration i+1;
//   B0  per (VN slot, word, 4 lifts): sums_{i-1} from st's rows 16 bytes at
//       a time in vn_list order (the forward's order: the exact recompute;
//       K6: the routing's value rounding), tot = chan_in + sums; g_outs[i]
//       joins gsums and the chan_out accumulator; with UCN the app;
//   A   per (check, word, lift), checks sorted by degree: the smallest of
//       nine slot codes (4 ... 32) that holds the check's degree, every load
//       issued before the arithmetic (slots past d repeat edge d - 1):
//       v2c before clip/quantize from tot and st, the UCN flag, the forward
//       recomputed and its adjoint (bp_common.cuh's check_adjoint,
//       restated with the VN frame's addresses; JAX's ties), the weight
//       terms into st and the new carry gmsg = -g_v2c_pre; a check of more
//       than 32 edges (the kAnyDegree instantiation) runs check_adjoint_loop;
//   B1  per (VN slot, word, 4 lifts): g_T = -(gmsg's rows summed in vn_list
//       order; K6: the cotangent rounding), the next sums carry, the
//       channel-side gradients through the VN weight and the QMS input
//       quantizer, the VN-weight terms into tot; and the edge-weight
//       partial: a thread per edge sums its terms over the block's words
//       and lifts (UCN: split by the check's flag) in a fixed order, four
//       interleaved partial sums, one partial row [I, E] a block (the VN
//       weights' likewise in the next L).
// The wrapper sums the partials over blocks in a fixed order.  No float
// atomics: their order changes from run to run.  The channel gradients take
// each term in the same order as the plain version, so they equal it bit
// for bit.
//
// K6, the matmul branch of _bwd_kernel (routing="matmul"), is the ROUTE
// template parameter: the same phases, gathering by index, since each
// one-hot routing product is a permutation; what the branch adds is its
// roundings (fused_train.py:476, :1506-1515): B0's sums through R (int8:
// rint(m * scale) summed in an int, then / scale; split-3: (S_hi + S_mid) +
// S_lo over the bf16 parts), the sums cotangent through Rt (int8: rounded to
// bf16 unless kGradF32; split-3 exact), the VN total through Rt in phase A
// (int8: int8_routed; split-3 exact) and B1's g_T through R (int8: bf16
// terms unless kGradF32; split-3's three sums).  The forward's pre-clip of
// the VN total at +-2 q_hi puts a saturated v2c on the quantizer's bound,
// where the clip mask would be 0.5 and the true one is 0, so phase A moves
// such a v2c one unit past the bound (same quantized value, mask 0:
// :1392-1439).  The UCN decision signs route as the forward routes them
// (int8: the +-1 sign quantized as a value; split-3 exactly).
//
// Ties, as JAX differentiates the flat path: clip masks 0.5 at either
// bound, the ReLU's 0.5 at 0; g_m2 to the first-occurrence argmin, g_m1
// split over the c1 ties of m1 and g_m2 over max(c2, 1) ties of the masked
// array; |v2c| has gradient +1 at 0, sign(c2v) none; UCN reads outs[i-1]
// clipped, xa_q at i = 0.  SP: 2/(1 - extc^2), the clip mask at +-(1 -
// 1e-7), the prefix and suffix chains in reverse.
//
// Bound on this card: device-memory bytes per word are the reads of the
// channel, store (I * E*Z * 4), outs (I * N*Z * 4 with UCN) and g_outs
// (I * N*Z * 4) and the writes of g_chan (and g_chanq); the operations
// (recompute plus adjoint, roughly three times the forward's per edge and
// iteration) at 33.5e12 instructions/s are the larger bound.  Shared memory
// (~42 KB a BG2 word) caps the words an SM holds (4 BG2 words at 2 blocks
// of 2), and the 64 registers a thread has at 1,024 threads an SM cap the
// slots a check holds: addresses in registers up to 10 slots, recomputed
// from the table beyond; sum-product is an instantiation of its own (its
// chains hold six values a slot).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// (-fmad=false keeps every product and sum a rounding of its own, as the
// plain PyTorch version fused_bwd_plain computes them.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_common.cuh"
#include "block_common.cuh"

namespace {

using namespace bp;

constexpr int kMaxThreads = 1024;  // threads a block at most (k2_plan picks the count)
constexpr int kRoll = 0;           // ROUTE: roll (K2), or kInt8 / kSplit3 (K6)
constexpr int kHold = 10;          // slot codes up to this hold their addresses

struct BwdParams {
  const float* chan;    // [B, N*Z]
  const float* store;   // [I, B, E*Z]
  const float* outs;    // [I, B, N*Z] pre-clip APP (read with UCN)
  const float* g_outs;  // [I, B, N*Z]
  const int* tab;       // the block table (k2_plan): vn[N] int4, chk[M] int2, edge[E] int2, row[E], e_chk[E]
  const float* cnw;     // [I, E] permuted edge order (or null)
  const float* ucnw;    // [I, E] (or null)
  const float* vnw;     // [I, N] (or null)
  float* g_chan;        // [B, N*Z]
  float* g_chanq;       // [B, N*Z] (QMS; null otherwise: its terms go to g_chan)
  float* g_cnw_part;    // [blocks, I, E] (or null)
  float* g_ucnw_part;   // [blocks, I, E] (or null)
  float* g_vnw_part;    // [blocks, I, N] (or null)
  float* spx;           // [3, blocks * W, E*Z]: SP scratch for checks above 32 edges (or null)
  long long B;
  int N, M, Z, E, I, W, flags;
  int S, TAB, WT;       // floats of a word's region, ints of the table, floats of the weight rows
  // a word's arrays, floats from its region's start (chan at 0; -1: absent)
  int o_tot, o_gsums, o_gchan, o_gchanq, o_app, o_st, o_gmsg, o_ucn;
  float clip_lo, clip_hi, q_lo, q_hi, q_scale, q_inv_scale;
};

// A word's arrays in shared memory (see the note at the top).
struct Word {
  float *chan, *tot, *gsums, *gchan, *gq, *app, *st, *gmsg;
  uint8_t* ucn;
};

__device__ __forceinline__ Word word_at(float* words, int lw, const BwdParams& p) {
  float* w = words + (size_t)lw * p.S;
  float* gchan = w + p.o_gchan;
  return Word{w, w + p.o_tot, w + p.o_gsums, gchan,
              (p.flags & kQms) ? w + p.o_gchanq : gchan,
              w + p.o_app, w + p.o_st, w + p.o_gmsg, reinterpret_cast<uint8_t*>(w + p.o_ucn)};
}

// whether the routed decision sign of ``app`` is negative (K6's int8: the
// +-1 sign routed as a value; roll and split-3 route it exactly)
template <int ROUTE>
__device__ __forceinline__ bool routed_negative(float app, const BwdParams& p) {
  if constexpr (ROUTE == kInt8) return int8_routed(app < 0.0f ? -1.0f : 1.0f, p) < 0.0f;
  return app < 0.0f;
}

// v2c before clip/quantize from the VN total ``vt`` and the entering
// message ``sv``; K6's int8 routes the total and moves a saturated v2c one
// unit past the quantizer's bound (the routed -1/0/+1 saturation indicator
// of fused_train.py:1392-1439: the same quantized value, clip mask 0)
template <int ROUTE>
__device__ __forceinline__ float v2c_pre(float vt, float sv, const BwdParams& p) {
  if constexpr (ROUTE == kInt8) {
    const float t = 2.0f * p.q_hi;
    float v = int8_routed(vt, p) - sv;
    if (vt > t && v == p.q_hi) v = p.q_hi + 1.0f;
    else if (vt < -t && v == p.q_lo) v = p.q_lo - 1.0f;
    return v;
  }
  return vt - sv;
}

// (tot index) | (st / gmsg index) << 16 of lifted check zc's slot on edge e
__device__ __forceinline__ uint32_t slot_at(int2 e, int zc, int Z) {
  return (uint32_t)e.x + (uint32_t)(zc - (zc >= e.y ? Z : 0)) * 0x10001u;
}

// One lifted check (first edge k0, degree d <= D, lift zc) of one word in
// phase A of iteration ``it``: check_adjoint's arithmetic on the VN frame's
// addresses.  Every load is made for j < D (slots past d repeat edge
// d - 1); only j < d is used or written.  ``wrow`` is the check's first
// weight in shared memory, or null.
template <int D, int ROUTE, bool SP>
__device__ __forceinline__ void adjoint_one(const BwdParams& p, const int2* edge, const Word& w,
                                            const float* wrow, int k0, int d, int zc, bool live) {
  const int Z = p.Z;
  constexpr bool kHeld = D <= kHold;
  uint32_t at_h[kHeld ? D : 1];
  auto at = [&](int j) -> uint32_t {
    if constexpr (kHeld) return at_h[j];
    return slot_at(edge[k0 + (j < d ? j : d - 1)], zc, Z);
  };
  if constexpr (kHeld) {
#pragma unroll
    for (int j = 0; j < D; ++j) at_h[j] = slot_at(edge[k0 + (j < d ? j : d - 1)], zc, Z);
  }
  float vp[D];  // v2c before clip/quantize
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const uint32_t a = at(j);
    vp[j] = v2c_pre<ROUTE>(w.tot[a & 0xFFFFu], w.st[a >> 16], p);
  }
  auto gin = [&](int j) -> float {  // the message's cotangent: carry + sums cotangent
    const uint32_t a = at(j);
    return w.gmsg[a >> 16] + w.gsums[a & 0xFFFFu];
  };
  const bool weighted = wrow != nullptr;
  const bool qms = p.flags & kQms;
  const float lo_m = qms ? p.q_lo : p.clip_lo;
  const float hi_m = qms ? p.q_hi : p.clip_hi;
  if constexpr (SP) {
    float t[D], pr[D], sf[D], gpre[D], gsuf[D], gt[D];
    float acc = 1.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j < d) {
        t[j] = tanhf(0.5f * clip_or_quant(vp[j], p));
        pr[j] = acc;
        acc = acc * t[j];
        gt[j] = 0.0f;
      }
    }
    acc = 1.0f;
#pragma unroll
    for (int j = D - 1; j >= 0; --j) {
      if (j < d) {
        sf[j] = acc;
        acc = acc * t[j];
      }
    }
    const float lo_c = -1.0f + kSpEps, hi_c = 1.0f - kSpEps;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j < d) {
        const float ext = pr[j] * sf[j];
        const float extc = fminf(fmaxf(ext, lo_c), hi_c);
        const float o = logf((1.0f + extc) / (1.0f - extc));
        float g_w;
        const float gmag = post_adjoint(o, weighted ? wrow[j] : 1.0f, weighted, gin(j), lo_m,
                                        hi_m, &g_w);
        w.st[at(j) >> 16] = live ? g_w : 0.0f;
        const float gout = gmag * ((o == 0.0f) ? 1.0f : sign0(o));  // |out| has gradient +1 at 0
        const float gextc = (gout * 2.0f) / (1.0f - extc * extc);
        const float gext = gextc * clip_mask(ext, lo_c, hi_c);
        gpre[j] = gext * sf[j];
        gsuf[j] = gext * pr[j];
      }
    }
    // reverse the prefix chain pre[j] = pre[j-1] * t[j-1] ...
    float cc = 0.0f;
    bool started = false;
#pragma unroll
    for (int j = D - 1; j >= 1; --j) {
      if (j < d) {
        if (!started) {
          cc = gpre[j];
          started = true;
        }
        gt[j - 1] = gt[j - 1] + cc * pr[j - 1];
        cc = gpre[j - 1] + cc * t[j - 1];
      }
    }
    // ... and the suffix chain suf[j] = suf[j+1] * t[j+1]
    cc = gsuf[0];
#pragma unroll
    for (int j = 0; j < D - 1; ++j) {
      if (j < d - 1) {
        gt[j + 1] = gt[j + 1] + cc * sf[j + 1];
        cc = gsuf[j + 1] + cc * t[j + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j < d) {
        const float gv = gt[j] * 0.5f * (1.0f - t[j] * t[j]);
        w.gmsg[at(j) >> 16] = -(gv * clip_mask(vp[j], lo_m, hi_m));
      }
    }
    return;
  } else {
  // forward recompute: m1, first-occurrence argmin am, m2 over the others,
  // total sign (x >= 0 -> +1)
  float m1 = kBig, m2 = kBig;
  int am = 0;
  bool neg = false;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) {
      const float v = clip_or_quant(vp[j], p);
      const float a = fabsf(v);
      neg ^= !(v >= 0.0f);
      if (a < m1) {
        m2 = m1;
        m1 = a;
        am = j;
      } else if (a < m2) {
        m2 = a;
      }
    }
  }
  const float total = neg ? -1.0f : 1.0f;
  // post-chain adjoint per edge (the weight terms overwrite st, which vp
  // has read); g_m1 / g_m2 gather the extrinsic minimum's cotangents
  float gm1 = 0.0f, gm2 = 0.0f, c1 = 0.0f, c2 = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) {
      const float v = clip_or_quant(vp[j], p);
      const float a = fabsf(v);
      const float own = (v >= 0.0f) ? 1.0f : -1.0f;
      float g_w;
      const float ge = post_adjoint(((j == am) ? m2 : m1) * (total * own),
                                    weighted ? wrow[j] : 1.0f, weighted, gin(j), lo_m, hi_m,
                                    &g_w);
      w.st[at(j) >> 16] = live ? g_w : 0.0f;
      gm1 = gm1 + ((j == am) ? 0.0f : ge);
      gm2 = gm2 + ((j == am) ? ge : 0.0f);
      c1 = c1 + ((a == m1) ? 1.0f : 0.0f);
      c2 = c2 + ((((j == am) ? kBig : a) == m2) ? 1.0f : 0.0f);
    }
  }
  const float g1 = gm1 / c1;
  const float g2 = gm2 / fmaxf(c2, 1.0f);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) {
      const float v = clip_or_quant(vp[j], p);
      const float a = fabsf(v);
      const float sg = (v >= 0.0f) ? 1.0f : -1.0f;
      const float gmag = ((a == m1) ? g1 : 0.0f) + ((((j == am) ? kBig : a) == m2) ? g2 : 0.0f);
      const float gv = gmag * ((a == 0.0f) ? 1.0f : sg);  // |v| has gradient +1 at 0
      w.gmsg[at(j) >> 16] = -(gv * clip_mask(vp[j], lo_m, hi_m));
    }
  }
  }
}

// A lifted check's slots for check_adjoint_loop (a check of more than 32
// edges): the VN frame's arrays in shared memory, the SP scratch in device
// memory at the word's block position ``bw``.
template <int ROUTE>
struct LoopSlots {
  const BwdParams& p;
  const int2* edge;
  const Word& w;
  const float* wrow;
  long long bw;
  int k0, d, zc;
  __device__ uint32_t at(int j) const { return slot_at(edge[k0 + j], zc, p.Z); }
  __device__ float vpre(int j) const {
    const uint32_t a = at(j);
    return v2c_pre<ROUTE>(w.tot[a & 0xFFFFu], w.st[a >> 16], p);
  }
  __device__ float gin(int j) const {
    const uint32_t a = at(j);
    return w.gmsg[a >> 16] + w.gsums[a & 0xFFFFu];
  }
  __device__ float wt(int j) const { return wrow ? wrow[j] : 1.0f; }
  __device__ float& gmsg(int j) const { return w.gmsg[at(j) >> 16]; }
  __device__ float& gw(int j) const { return w.st[at(j) >> 16]; }
  __device__ float& x(int a, int j) const {
    const size_t EZ = (size_t)p.E * p.Z;
    return p.spx[((size_t)a * (size_t)(gridDim.x * p.W) + bw) * EZ + (size_t)(k0 + j) * p.Z + zc];
  }
};

template <int ROUTE>
__device__ __noinline__ void adjoint_loop(const BwdParams& p, const int2* edge, const Word& w,
                                          const float* wrow, int k0, int d, int zc, bool live,
                                          long long bw) {
  LoopSlots<ROUTE> s{p, edge, w, wrow, bw, k0, d, zc};
  check_adjoint_loop(p, d, wrow != nullptr, live, s);
}

// Phase A of one lifted check: its UCN flag, then the adjoint at the
// smallest slot code (4, 6, 8, 10, 12, 16; with MAXB 32 or kAnyDegree also
// 20, 24, 32; with kAnyDegree, beyond 32 slots, adjoint_loop).
template <int MAXB, int ROUTE, bool SP>
__device__ __forceinline__ void adjoint_any(const BwdParams& p, const int2* edge,
                                            const float* wts, const Word& w, int c, int k0, int d,
                                            int zc, bool live, long long bw) {
  const int Z = p.Z;
  bool unsat = false;
  if (p.flags & kUcn) {
    for (int j = 0; j < d; ++j)
      unsat ^= routed_negative<ROUTE>(w.app[slot_at(edge[k0 + j], zc, Z) & 0xFFFFu], p);
    w.ucn[c * Z + zc] = unsat ? 1 : 0;
  }
  const float* wrow =
      (p.flags & (kCnW | kUcn)) ? wts + (((p.flags & kUcn) && unsat) ? p.E : 0) + k0 : nullptr;
#define K2_CHECK(D) adjoint_one<D, ROUTE, SP>(p, edge, w, wrow, k0, d, zc, live)
  if (d <= 4) K2_CHECK(4);
  else if (d <= 6) K2_CHECK(6);
  else if (d <= 8) K2_CHECK(8);
  else if (d <= 10) K2_CHECK(10);
  else if (d <= 12) K2_CHECK(12);
  else if (MAXB == 16 || d <= 16) K2_CHECK(16);
  else if constexpr (MAXB != 16) {
    if (d <= 20) K2_CHECK(20);
    else if (d <= 24) K2_CHECK(24);
    else if (MAXB == 32 || d <= 32) K2_CHECK(32);
    else if constexpr (MAXB == kAnyDegree) adjoint_loop<ROUTE>(p, edge, w, wrow, k0, d, zc, live, bw);
  }
#undef K2_CHECK
}

// chan_in of iteration ``it`` for VEC copies of VN ``vn`` (bp_common.cuh's)
template <int VEC>
__device__ __forceinline__ void chan_in_v(const float (&c)[VEC], int vn, int it,
                                          const BwdParams& p, float (&x)[VEC]) {
#pragma unroll
  for (int u = 0; u < VEC; ++u) x[u] = chan_in(c[u], vn, it, p);
}

template <int VEC>
__device__ __forceinline__ void ldg_row(const float* src, bool live, float (&v)[VEC]) {
  if (!live) {
#pragma unroll
    for (int u = 0; u < VEC; ++u) v[u] = 0.0f;
  } else if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = __ldg(src);
  }
}

// The channel in, the carries and accumulators zeroed.
template <int VEC>
__device__ __forceinline__ void init_words(const BwdParams& p, const int* tab, float* words,
                                           long long word0) {
  const int NZ = p.N * p.Z;
  const int4* vns = reinterpret_cast<const int4*>(tab);
  const float zero[VEC] = {};
  for (Walk v = walk(p.N, p.W, p.Z / VEC); v.ok(); v.next()) {
    const Word w = word_at(words, v.b, p);
    const int q = vns[v.a].x + VEC * v.c;
    const long long gw = word0 + v.b;
    float ch[VEC];
    ldg_row<VEC>(p.chan + gw * NZ + q, gw < p.B, ch);
    sts<VEC>(w.chan + q, ch);
    sts<VEC>(w.gsums + q, zero);
    sts<VEC>(w.gchan + q, zero);
    sts<VEC>(w.gq + q, zero);
  }
  const int EZ = p.E * p.Z;
  for (int i = threadIdx.x; i < p.W * EZ; i += blockDim.x)
    word_at(words, i / EZ, p).gmsg[i % EZ] = 0.0f;
}

// 4 bytes from device memory to shared memory, asynchronously (cp.async):
// the load needs no register and waits in cp_async_wait, not at its issue
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// L: store[it] of the block's words into st, rotated into the VN's frame,
// one asynchronous 4-byte copy a value (the warp's reads of a row are
// coalesced); the caller waits (cp_async_wait) before the barrier.
__device__ __forceinline__ void load_store(const BwdParams& p, const int2* edge, float* words,
                                           long long word0, int it) {
  const size_t EZ = (size_t)p.E * p.Z;
  for (Walk v = walk(p.E, p.W, p.Z); v.ok(); v.next()) {
    const int k = v.a, zc = v.c;
    const long long gw = word0 + v.b;
    const int wrap = edge[k].y;  // Z - shift
    float* dst = word_at(words, v.b, p).st + k * p.Z + zc - (zc >= wrap ? wrap : wrap - p.Z);
    if (gw < p.B) {
      cp_async4(dst, p.store + ((size_t)it * p.B + gw) * EZ + (size_t)k * p.Z + zc);
    } else {
      *dst = 0.0f;  // past the batch end: never written back
    }
  }
}

// B0 of iteration ``it``: sums_{i-1} from st's rows, tot, the carries, with
// UCN the app.
template <int VEC, int ROUTE>
__device__ __forceinline__ void vn_b0(const BwdParams& p, const int* tab, float* words,
                                      long long word0, int it) {
  const int NZ = p.N * p.Z;
  const int4* vns = reinterpret_cast<const int4*>(tab);
  const int* row = tab + 4 * p.N + 2 * p.M + 2 * p.E;
  const bool bf16_gsums = ROUTE == kInt8 && !(p.flags & kGradF32);
  for (Walk v = walk(p.N, p.W, p.Z / VEC); v.ok(); v.next()) {
    const int4 vn = vns[v.a];  // first copy n*Z, edge range, VN index
    const Word w = word_at(words, v.b, p);
    const int q = vn.x + VEC * v.c;
    const long long gw = word0 + v.b;
    float acc[VEC], ch[VEC], x[VEC], g[VEC], gs[VEC], gq[VEC];
    vn_sums<VEC, ROUTE>(p, row, w.st, vn.y, vn.z, VEC * v.c, acc);  // K6: the value rounding
    lds<VEC>(w.chan + q, ch);
    chan_in_v<VEC>(ch, vn.w, it, p, x);
    ldg_row<VEC>(p.g_outs + ((size_t)it * p.B + gw) * NZ + q, gw < p.B, g);
    lds<VEC>(w.gsums + q, gs);
    lds<VEC>(w.gq + q, gq);
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      acc[u] = x[u] + acc[u];
      const float s = gs[u] + g[u];  // out_i = chan_out + sums_i
      gs[u] = bf16_gsums ? bf16_round(s) : s;
      gq[u] = gq[u] + g[u];
    }
    sts<VEC>(w.tot + q, acc);
    sts<VEC>(w.gsums + q, gs);
    sts<VEC>(w.gq + q, gq);
    if (p.flags & kUcn) {
      float app[VEC];
      if (it == 0) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) app[u] = x[u];
      } else {
        ldg_row<VEC>(p.outs + ((size_t)(it - 1) * p.B + gw) * NZ + q, gw < p.B, app);
#pragma unroll
        for (int u = 0; u < VEC; ++u) app[u] = fminf(fmaxf(app[u], p.clip_lo), p.clip_hi);
      }
      sts<VEC>(w.app + q, app);
    }
  }
}

// B1 of iteration ``it``: g_T and the channel-side gradients.
template <int VEC, int ROUTE>
__device__ __forceinline__ void vn_b1(const BwdParams& p, const int* tab, float* words, int it) {
  const int4* vns = reinterpret_cast<const int4*>(tab);
  const int* row = tab + 4 * p.N + 2 * p.M + 2 * p.E;
  const bool qms = p.flags & kQms;
  for (Walk v = walk(p.N, p.W, p.Z / VEC); v.ok(); v.next()) {
    const int4 vn = vns[v.a];
    const Word w = word_at(words, v.b, p);
    const int q = vn.x + VEC * v.c;
    // g_T = sum of g_v2c_pre = -(sum of the new carry): negation is exact,
    // and commutes with K6's roundings (bf16 terms in int8 routing unless
    // kGradF32, split-3's parts)
    float gt[VEC];
    if constexpr (ROUTE == kInt8) {
      if (p.flags & kGradF32) {
        vn_sums<VEC, kRoll>(p, row, w.gmsg, vn.y, vn.z, VEC * v.c, gt);
      } else {
        vn_sums<VEC, kBf16>(p, row, w.gmsg, vn.y, vn.z, VEC * v.c, gt);
      }
    } else {
      vn_sums<VEC, ROUTE>(p, row, w.gmsg, vn.y, vn.z, VEC * v.c, gt);
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) gt[u] = -gt[u];
    if (p.flags & kVnW) {
      float ch[VEC], gc[VEC], term[VEC];
      lds<VEC>(w.chan + q, ch);
      lds<VEC>(w.gchan + q, gc);
      const float vw = __ldg(p.vnw + (size_t)it * p.N + vn.w);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const float gxa = qms ? gt[u] * clip_mask(ch[u] * vw, p.q_lo, p.q_hi) : gt[u];
        term[u] = gxa * ch[u];  // VN-weight term, reduced in the next L
        gc[u] = gc[u] + gxa * vw;
      }
      sts<VEC>(w.tot + q, term);
      sts<VEC>(w.gchan + q, gc);
    } else {
      float gq[VEC];
      lds<VEC>(w.gq + q, gq);
#pragma unroll
      for (int u = 0; u < VEC; ++u) gq[u] = gq[u] + gt[u];  // xa_q is chan_out
      sts<VEC>(w.gq + q, gq);
    }
    sts<VEC>(w.gsums + q, gt);  // the cotangent of sums_{i-1}
  }
}

// A thread's fixed-order sum of one row of Z floats, from lift z0 on
// (z0 = the thread's edge or VN mod Z: a warp's threads read other banks),
// in four interleaved partial sums so that the loads overlap;
// ``split(z)`` routes the term of lift z to ``other`` instead (UCN).
template <class Split>
__device__ __forceinline__ void row_sum(const float* row, int Z, int z0, float (&acc)[4],
                                        float (&other)[4], Split split) {
  for (int j = 0; j < Z; j += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j + u < Z) {
        int z = z0 + j + u;
        if (z >= Z) z -= Z;
        const float g = row[z];
        if (split(z)) other[u] = other[u] + g;
        else acc[u] = acc[u] + g;
      }
    }
  }
}

// The block's edge-weight partial of iteration ``it``: a thread per edge
// adds its terms over the live words and their lifts in a fixed order
// (``row_sum``), UCN terms apart.
__device__ __forceinline__ void reduce_edges(const BwdParams& p, const int* tab, float* words,
                                             int nw, int it) {
  const int2* edge = reinterpret_cast<const int2*>(tab + 4 * p.N + 2 * p.M);
  const int* e_chk = tab + 4 * p.N + 2 * p.M + 3 * p.E;
  const bool ucn = p.flags & kUcn;
  for (int k = threadIdx.x; k < p.E; k += blockDim.x) {
    const int shift = p.Z - edge[k].y, ck = e_chk[k] * p.Z;
    float cn[4] = {}, un[4] = {};
    for (int lw = 0; lw < nw; ++lw) {
      const Word w = word_at(words, lw, p);
      // the term of VN-frame lift z belongs to lifted check (z - shift) mod Z
      row_sum(w.st + k * p.Z, p.Z, k % p.Z, cn, un, [&](int z) {
        return ucn && w.ucn[ck + z - shift + (z < shift ? p.Z : 0)];
      });
    }
    const size_t o = ((size_t)blockIdx.x * p.I + it) * p.E + k;
    p.g_cnw_part[o] = (cn[0] + cn[1]) + (cn[2] + cn[3]);
    if (p.g_ucnw_part) p.g_ucnw_part[o] = (un[0] + un[1]) + (un[2] + un[3]);
  }
}

// The block's VN-weight partial of iteration ``it`` (B1's terms in tot): a
// thread per VN, as reduce_edges.
__device__ __forceinline__ void reduce_vns(const BwdParams& p, float* words, int nw, int it) {
  for (int n = threadIdx.x; n < p.N; n += blockDim.x) {
    float acc[4] = {}, none[4] = {};
    for (int lw = 0; lw < nw; ++lw)
      row_sum(word_at(words, lw, p).tot + n * p.Z, p.Z, n % p.Z, acc, none,
              [](int) { return false; });
    p.g_vnw_part[((size_t)blockIdx.x * p.I + it) * p.N + n] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

template <int VEC>
__device__ __forceinline__ void write_grads(const BwdParams& p, const int* tab, float* words,
                                            long long word0) {
  const int NZ = p.N * p.Z;
  const int4* vns = reinterpret_cast<const int4*>(tab);
  for (Walk v = walk(p.N, p.W, p.Z / VEC); v.ok(); v.next()) {
    const long long gw = word0 + v.b;
    if (gw >= p.B) continue;
    const Word w = word_at(words, v.b, p);
    const int q = vns[v.a].x + VEC * v.c;
    float g[VEC];
    lds<VEC>(w.gchan + q, g);
    sts<VEC>(p.g_chan + gw * NZ + q, g);
    if (p.flags & kQms) {
      lds<VEC>(w.gq + q, g);
      sts<VEC>(p.g_chanq + gw * NZ + q, g);
    }
  }
}

template <int MAXB, int ROUTE, bool SP, int VEC>
__device__ __forceinline__ void backward(const BwdParams& p, const int* tab, float* wts,
                                         float* words) {
  const long long word0 = (long long)blockIdx.x * p.W;
  const int nw = (int)min((long long)p.W, p.B - word0);
  const int2* chk = reinterpret_cast<const int2*>(tab + 4 * p.N);
  const int2* edge = chk + p.M;
  const bool weighted = p.flags & (kCnW | kUcn);
  init_words<VEC>(p, tab, words, word0);
  for (int it = p.I - 1; it >= 0; --it) {
    // ------------- L: store[it], the weight rows, VN-weight partial of it+1 -------------
    load_store(p, edge, words, word0, it);
    if (weighted) {
      for (int k = threadIdx.x; k < p.E; k += blockDim.x) {
        wts[k] = __ldg(p.cnw + (size_t)it * p.E + k);
        if (p.flags & kUcn) wts[p.E + k] = __ldg(p.ucnw + (size_t)it * p.E + k);
      }
    }
    if (p.g_vnw_part && it < p.I - 1) reduce_vns(p, words, nw, it + 1);
    cp_async_wait();
    __syncthreads();
    // ------------- B0: sums_{i-1}; g_out joins the carries -------------
    vn_b0<VEC, ROUTE>(p, tab, words, word0, it);
    __syncthreads();
    // ------------- A: recompute the check update, then its adjoint -------------
    for (Walk c = walk(p.M, p.W, p.Z); c.ok(); c.next()) {
      const int2 ck = chk[c.a];  // first edge, degree
      adjoint_any<MAXB, ROUTE, SP>(p, edge, wts, word_at(words, c.b, p), c.a, ck.x, ck.y, c.c,
                               word0 + c.b < p.B, word0 + c.b);
    }
    __syncthreads();
    // ------------- B1: g_T, the channel-side gradients; edge-weight partial -------------
    vn_b1<VEC, ROUTE>(p, tab, words, it);
    if (p.g_cnw_part) reduce_edges(p, tab, words, nw, it);
    __syncthreads();
  }
  if (p.g_vnw_part) reduce_vns(p, words, nw, 0);
  write_grads<VEC>(p, tab, words, word0);
}

template <int MAXB, int ROUTE, bool SP>
__global__ void __launch_bounds__(kMaxThreads, 1) fused_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  int* tab = reinterpret_cast<int*>(smem);
  float* wts = smem + p.TAB;  // the iteration's CN (and UCN) weight rows
  float* words = wts + p.WT;
  for (int i = threadIdx.x; i < p.TAB / 4; i += blockDim.x)
    reinterpret_cast<int4*>(tab)[i] = __ldg(reinterpret_cast<const int4*>(p.tab) + i);
  __syncthreads();
  if ((p.Z & 3) == 0) {
    backward<MAXB, ROUTE, SP, 4>(p, tab, wts, words);
  } else {
    backward<MAXB, ROUTE, SP, 1>(p, tab, wts, words);
  }
}

template <int MAXB, int ROUTE, bool SP>
cudaError_t launch(const BwdParams& p, int threads, int smem, cudaStream_t stream,
                   int* launched) {
  auto kern = fused_bwd_kernel<MAXB, ROUTE, SP>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((p.B + p.W - 1) / p.W);
  kern<<<blocks, threads, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <int MAXB, int ROUTE, bool SP>
cudaError_t query(int threads, int smem, int* blocks, cudaFuncAttributes* fa) {
  auto kern = fused_bwd_kernel<MAXB, ROUTE, SP>;
  cudaError_t err = cudaFuncGetAttributes(fa, kern);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads, smem);
  return err;
}

template <int MAXB, int ROUTE, bool SP>
struct Launch {
  static cudaError_t run(const BwdParams* p, int threads, int smem, cudaStream_t s,
                         int* launched) {
    return launch<MAXB, ROUTE, SP>(*p, threads, smem, s, launched);
  }
};

template <int MAXB, int ROUTE, bool SP>
struct Query {
  static cudaError_t run(int threads, int smem, int* blocks, cudaFuncAttributes* fa) {
    return query<MAXB, ROUTE, SP>(threads, smem, blocks, fa);
  }
};

// the instantiation for the largest check degree, the routing bits and
// sum-product of ``flags`` (int8 routing is QMS's, and QMS excludes SP):
// F<MAXB, ROUTE, SP>::run(args...)
template <template <int, int, bool> class F, int MAXB, class... A>
cudaError_t dispatch_route(int flags, A... args) {
  const bool sp = flags & kSumProduct;
  if (flags & kRouteInt8)
    return (flags & kQms) ? F<MAXB, kInt8, false>::run(args...) : cudaErrorInvalidValue;
  if (flags & kRouteSplit3)
    return sp ? F<MAXB, kSplit3, true>::run(args...) : F<MAXB, kSplit3, false>::run(args...);
  return sp ? F<MAXB, kRoll, true>::run(args...) : F<MAXB, kRoll, false>::run(args...);
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
extern "C" int fused_bwd_query(int max_deg, int flags, int threads, int smem, int* blocks,
                               int* registers, int* local_bytes) {
  cudaFuncAttributes fa = {};
  *blocks = 0;
  const cudaError_t err = dispatch<Query>(max_deg, flags, threads, smem, blocks, &fa);
  *registers = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)err;
}

// One launch of the backward kernel over B words (K2, or K6 with the routing
// bits kRouteInt8 / kRouteSplit3 and kGradF32 in ``flags``), added to
// ``*launched``: blocks of ``threads`` threads, each ``W`` words of ``S``
// floats after the table ``tab`` (``TAB`` ints) and ``WT`` floats of weight
// rows, a word's arrays at the offsets ``o_*`` (ops/cuda/fused_train.py::
// k2_plan).  Weight pointers and partials the configuration does not use
// may be null; the partials hold ceil(B / W) blocks; ``spx`` is needed only
// for SP on a code with a check of more than 32 edges.  Returns a
// cudaError_t.
extern "C" int fused_bwd_launch(
    const float* chan, const float* store, const float* outs, const float* g_outs,
    const int* tab, const float* cnw, const float* ucnw, const float* vnw,
    float* g_chan, float* g_chanq, float* g_cnw_part, float* g_ucnw_part, float* g_vnw_part,
    float* spx,
    int B, int N, int M, int Z, int E, int I, int max_deg, int W, int threads, int S, int TAB,
    int WT, int o_tot, int o_gsums, int o_gchan, int o_gchanq, int o_app, int o_st, int o_gmsg,
    int o_ucn, int flags,
    float clip_lo, float clip_hi, float q_lo, float q_hi, float q_scale, void* stream,
    int* launched) {
  BwdParams p{chan, store, outs, g_outs, tab, cnw, ucnw, vnw,
              g_chan, g_chanq, g_cnw_part, g_ucnw_part, g_vnw_part, spx,
              (long long)B, N, M, Z, E, I, W, flags, S, TAB, WT,
              o_tot, o_gsums, o_gchan, o_gchanq, o_app, o_st, o_gmsg, o_ucn,
              clip_lo, clip_hi, q_lo, q_hi, q_scale, 1.0f / q_scale};
  if (B <= 0) return (int)cudaSuccess;
  if (I <= 0 || W < 1 || threads < 32 || threads > kMaxThreads || threads % 32 || !tab ||
      TAB % 4 || S % 4 || WT % 4 || (long long)N * Z > 65535 || (long long)E * Z > 65535)
    return (int)cudaErrorInvalidValue;
  if ((flags & kQms) && (!g_chanq || o_gchanq < 0)) return (int)cudaErrorInvalidValue;
  if ((flags & kUcn) && (!outs || o_app < 0 || o_ucn < 0)) return (int)cudaErrorInvalidValue;
  if ((flags & (kCnW | kUcn)) && (!cnw || !g_cnw_part || WT < ((flags & kUcn) ? 2 : 1) * E))
    return (int)cudaErrorInvalidValue;
  if ((flags & kVnW) && (!vnw || !g_vnw_part)) return (int)cudaErrorInvalidValue;
  if (max_deg > 32 && (flags & kSumProduct) && !spx) return (int)cudaErrorInvalidValue;
  // the VN phases and the store load move 4 lifts at once where Z % 4 == 0
  if ((Z & 3) == 0 &&
      (((uintptr_t)chan | (uintptr_t)store | (uintptr_t)g_outs | (uintptr_t)outs |
        (uintptr_t)g_chan | (uintptr_t)g_chanq) & 15))
    return (int)cudaErrorMisalignedAddress;
  const long long smem = 4LL * TAB + 4LL * WT + 4LL * W * S;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  return (int)dispatch<Launch>(max_deg, flags, &p, threads, (int)smem, (cudaStream_t)stream,
                               launched);
}
