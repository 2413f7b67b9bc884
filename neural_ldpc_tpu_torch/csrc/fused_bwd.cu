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
// pre-clip APP of iteration i) and g_outs[i] (the cotangent of outs[i]; the
// final clip's adjoint is autograd's, outside).  For i = I-1 .. 0 the block
//   L   loads store[i] into a shared scatter buffer,
//   B0  recomputes sums_{i-1} per VN copy in the forward's phase-B order (the
//       exact recompute: any other order moves MS's v2c by ulps, and then
//       the clip masks at +-20 and the tie sets flip), adds g_outs[i] to the
//       sums cotangent carry and to the channel-side accumulator,
//   A   one thread per (word, lifted check): recomputes v2c and the check
//       update, takes the adjoint of the post chain (weight, ReLU,
//       clip/quantize, re-sign) and of the check update, and writes the new
//       message cotangent carry gmsg = -g_v2c_pre,
//   B1  one thread per (word, VN copy): g_T = the rolled-back sum of
//       g_v2c_pre (becomes the sums carry for i-1) and the channel-side
//       gradients (through the VN weight and the QMS input quantizer),
//   R   reduces the weight gradients of the block's words in shared memory
//       in a fixed order and writes one partial [I, E] (and [I, N]) per
//       block; the wrapper sums the partials over blocks, as _bwd_run sums
//       its tiles.  No float atomics go to device memory: their order
//       changes from run to run.
// K6, the matmul branch of _bwd_kernel (routing="matmul"), is the ROUTE
// template parameter; the roll instantiations are the code K2 had.  Its
// routing products run on the tensor cores (mm_route.cuh): B0's sums_{i-1}
// and B1's g_T through R, and through Rt the VN totals (v2c = routed - msg,
// written over store[i] in buf_s), the UCN decision signs (their parity
// gathered into ucn_s by integer xor, exact in any order) and the sums
// cotangent (added into the message carry before phase A reads it).  With
// int8 routing (QMS) the values are int8 and exact, the cotangents go
// through bf16 (or f32 with mmr::kGradF32), as routing_dtype makes them
// (:464, :1506-1515); the forward's pre-clip of the VN total at +-2 q_hi puts
// a saturated v2c on the quantizer's bound, where the clip mask would be 0.5
// and the true one is 0, so a routed -1/0/+1 saturation indicator moves such
// a v2c one unit past the bound (same quantized value, mask 0: :1392-1439).
// Split-3 routes values and cotangents exactly and sums (S_hi + S_mid) + S_lo.
//
// Ties, as JAX differentiates the flat path (each is a trouble spot, and
// QMS lands on every one of them; the adjoint is bp_common.cuh's
// check_adjoint, shared with fused_bwd_dm.cu):
//   - clip masks are 0.5 at either bound (_clip_grad_mask), the ReLU's is
//     0.5 at 0 (_relu_grad_mask);
//   - the two-min adjoint routes g_m2 to the first-occurrence argmin f and
//     splits g_m1 over the c1 ties of m1 and g_m2 over the c2 ties of the
//     masked array, max(c2, 1);
//   - |v2c| has gradient +1 at 0, but sign(c2v) in the post chain carries 0
//     at 0 (the re-sign has no gradient);
//   - UCN reads outs[i-1], the pre-clip APP, and clips it here; at i = 0 it
//     uses the weighted quantized channel xa_q.  The mask has no gradient.
// SP's adjoint: 2/(1 - extc^2), the clip mask at +-(1 - 1e-7), then the
// prefix and suffix product chains in reverse (_cn_sumproduct_fwd_bwd_one).
//
// Shared memory per word: channel, sums_{i-1}, the sums cotangent carry and
// the two channel-gradient accumulators (5 * N*Z floats), the message
// cotangent carry and a scatter buffer (2 * E*Z floats), and one UCN flag
// per lifted check (M*Z ints): 44.5 KB for BG2 at Z = 16.
//
// Bound on this card: device-memory bytes per word are the reads of the
// channel, store (I * E*Z * 4), outs (I * N*Z * 4 with UCN, else none) and
// g_outs (I * N*Z * 4) and the writes of g_chan (and g_chanq under QMS);
// the operations (recompute plus adjoint, roughly three times the forward's
// per edge and iteration) at 33.5e12 instructions/s are the larger bound.
// This version is simple and right, not tuned: per-check register arrays
// (MAXD = 32 spills), four block-wide barriers per iteration, and a
// bank-conflicted edge reduction.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// (-fmad=false keeps every product and sum a rounding of its own, as the
// plain PyTorch version fused_bwd_plain computes them.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_common.cuh"
#include "mm_route.cuh"

namespace {

using namespace bp;

struct BwdParams {
  const float* chan;    // [B, N*Z]
  const float* store;   // [I, B, E*Z]
  const float* outs;    // [I, B, N*Z] pre-clip APP (read with UCN)
  const float* g_outs;  // [I, B, N*Z]
  const int* tables;    // chk_off[M] chk_deg[M] e_vn[E] e_shift[E] vn_ptr[N+1] vn_list[E] e_chk[E]
  const float* cnw;     // [I, E] permuted edge order (or null)
  const float* ucnw;    // [I, E] (or null)
  const float* vnw;     // [I, N] (or null)
  float* g_chan;        // [B, N*Z]
  float* g_chanq;       // [B, N*Z] (QMS; null otherwise: its terms go to g_chan)
  float* g_cnw_part;    // [blocks, I, E] (or null)
  float* g_ucnw_part;   // [blocks, I, E] (or null)
  float* g_vnw_part;    // [blocks, I, N] (or null)
  int B, N, M, Z, E, I, wpb, flags;
  float clip_lo, clip_hi, q_lo, q_hi, q_scale, q_inv_scale;
};

constexpr int kRoll = 0;  // ROUTE: roll (K2), or mmr::kInt8 / mmr::kSplit3 (K6)

__device__ float k6_zero = 0.0f;  // K6's sums cotangent is already in the carry

// K6: one iteration ``it`` of fused_bwd_kernel (phases L, B0, route, A, B1;
// the weight partials R follow in the kernel), its routing on the tensor
// cores.  Every thread of the block calls it.
template <int MAXD, int ROUTE>
__device__ __forceinline__ void fused_bwd_k6(const BwdParams& p, int it, float* smem, bool owner,
                                             int lw, int c, int zc, int k0, int d) {
  const int NZ = p.N * p.Z, MZ = p.M * p.Z, EZ = p.E * p.Z, Z = p.Z, W = p.wpb;
  float* chan_s = smem;
  float* sums_s = chan_s + W * NZ;
  float* gsums_s = sums_s + W * NZ;
  float* gchan_s = gsums_s + W * NZ;
  float* gchanq_s = gchan_s + W * NZ;
  float* gmsg_s = gchanq_s + W * NZ;
  float* buf_s = gmsg_s + W * EZ;
  int* ucn_s = (int*)(buf_s + W * EZ);
  const bool qms = p.flags & kQms;
  float* gq_s = qms ? gchanq_s : gchan_s;
  const int* e_vn = p.tables + 2 * p.M;
  const int* e_shift = e_vn + p.E;
  const int* vn_ptr = e_shift + p.E;
  const int* vn_list = vn_ptr + p.N + 1;
  const int* e_chk = vn_list + p.E;
  const mmr::Quant q{2.0f * p.q_hi, p.q_scale, p.q_inv_scale};
  const long long word0 = (long long)blockIdx.x * W, gword = word0 + lw;
  const bool live = gword < p.B;
  const float lo_m = qms ? p.q_lo : p.clip_lo, hi_m = qms ? p.q_hi : p.clip_hi;
  float* buf_w = buf_s + lw * EZ;

  // ---------------- L: the message state entering iteration it ----------------
  if (owner) {
    const float* st = p.store + ((size_t)it * p.B + (live ? gword : 0)) * EZ + zc;
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < d) buf_w[(k0 + j) * Z + zc] = live ? st[(size_t)(k0 + j) * Z] : 0.0f;
    ucn_s[lw * MZ + c * Z + zc] = 0;
  }
  __syncthreads();

  // ---------------- B0: sums_{i-1} through R; g_out joins the carries ----------------
  mmr::for_units(p.N, Z, W, [&](int n, int to, int wt) {
    float r[4];
    mmr::to_vns<ROUTE>(r, __ldg(vn_ptr + n), __ldg(vn_ptr + n + 1), vn_list, e_shift, to, wt, Z,
                       W, q, [&](int w, int k, int z) { return buf_s[w * EZ + k * Z + z]; });
    mmr::for_cells(to, wt, Z, W, [&](int i, int row, int w) { sums_s[w * NZ + n * Z + row] = r[i]; });
  });
  for (int idx = threadIdx.x; idx < W * NZ; idx += blockDim.x) {
    const long long gw = word0 + idx / NZ;
    const float g = (gw < p.B) ? p.g_outs[((size_t)it * p.B + gw) * NZ + idx % NZ] : 0.0f;
    gsums_s[idx] = gsums_s[idx] + g;  // out_i = chan_out + sums_i
    gq_s[idx] = gq_s[idx] + g;
  }
  __syncthreads();

  // ---------------- through Rt: UCN signs, v2c, the sums cotangent ----------------
  auto total = [&](int w, int qv) { return chan_in(chan_s[w * NZ + qv], qv / Z, it, p) + sums_s[w * NZ + qv]; };
  mmr::for_units(p.E, Z, W, [&](int k, int to, int wt) {
    const int vn = __ldg(e_vn + k), s = __ldg(e_shift + k), ck = __ldg(e_chk + k);
    float u[4] = {1.0f, 1.0f, 1.0f, 1.0f}, vt[4], sat[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gr[4];
    if (p.flags & kUcn) {  // the pre-clip APP of iteration i-1, clipped; xa_q at i = 0
      mmr::to_edges<ROUTE>(u, s, to, wt, Z, W, q, [&](int w, int zi) {
        const int qv = vn * Z + zi;
        const long long gw = word0 + w;
        const float app = (it == 0) ? chan_in(chan_s[w * NZ + qv], vn, it, p)
            : (gw < p.B ? fminf(fmaxf(p.outs[((size_t)(it - 1) * p.B + gw) * NZ + qv], p.clip_lo),
                                p.clip_hi) : 0.0f);
        return app < 0.0f ? -1.0f : 1.0f;
      });
    }
    mmr::to_edges<ROUTE>(vt, s, to, wt, Z, W, q, [&](int w, int zi) { return total(w, vn * Z + zi); });
    if constexpr (ROUTE == mmr::kInt8) {
      // the int8 indicator itself, unscaled (sat_n.astype(int8))
      mmr::to_edges<mmr::kInt8>(sat, s, to, wt, Z, W, mmr::unit_quant(), [&](int w, int zi) {
        const float t = total(w, vn * Z + zi);
        return (t > q.t) ? 1.0f : ((t < -q.t) ? -1.0f : 0.0f);
      });
      auto g = [&](int w, int zi) { return gsums_s[w * NZ + vn * Z + zi]; };
      if (p.flags & mmr::kGradF32) mmr::to_edges<mmr::kExact>(gr, s, to, wt, Z, W, q, g);
      else mmr::to_edges<mmr::kBf16>(gr, s, to, wt, Z, W, q, g);
    } else {
      mmr::to_edges<ROUTE>(gr, s, to, wt, Z, W, q,
                           [&](int w, int zi) { return gsums_s[w * NZ + vn * Z + zi]; });
    }
    mmr::for_cells(to, wt, Z, W, [&](int i, int row, int w) {
      const int e = w * EZ + k * Z + row;
      if (u[i] < 0.0f) atomicXor(ucn_s + w * MZ + ck * Z + row, 1);
      float vp = vt[i] - buf_s[e];  // v2c before clip/quantize
      if (sat[i] > 0.0f && vp == hi_m) vp = hi_m + 1.0f;
      else if (sat[i] < 0.0f && vp == lo_m) vp = lo_m - 1.0f;
      buf_s[e] = vp;
      gmsg_s[e] = gmsg_s[e] + gr[i];
    });
  });
  __syncthreads();

  // ---------------- A: recompute the check update, then its adjoint ----------------
  if (owner) {
    const bool unsat = (p.flags & kUcn) && ucn_s[lw * MZ + c * Z + zc];
    const float* wrow = nullptr;
    if (p.flags & (kCnW | kUcn))
      wrow = (((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw) + (size_t)it * p.E + k0;
    float vpre[MAXD];
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < d) vpre[j] = buf_w[(k0 + j) * Z + zc];
    check_adjoint<MAXD>(p, vpre, d, wrow, &k6_zero, [](int) { return 0; },
                        gmsg_s + lw * EZ + k0 * Z + zc, buf_w + k0 * Z + zc, Z, live);
  }
  __syncthreads();

  // ---------------- B1: g_T through R and the channel-side gradients ----------------
  mmr::for_units(p.N, Z, W, [&](int n, int to, int wt) {
    float r[4];
    auto gm = [&](int w, int k, int z) { return gmsg_s[w * EZ + k * Z + z]; };
    const int e0 = __ldg(vn_ptr + n), e1 = __ldg(vn_ptr + n + 1);
    if constexpr (ROUTE == mmr::kInt8) {
      if (p.flags & mmr::kGradF32) mmr::to_vns<mmr::kExact>(r, e0, e1, vn_list, e_shift, to, wt, Z, W, q, gm);
      else mmr::to_vns<mmr::kBf16>(r, e0, e1, vn_list, e_shift, to, wt, Z, W, q, gm);
    } else {
      mmr::to_vns<ROUTE>(r, e0, e1, vn_list, e_shift, to, wt, Z, W, q, gm);
    }
    mmr::for_cells(to, wt, Z, W, [&](int i, int row, int w) {
      const int idx = w * NZ + n * Z + row;
      const float gT = -r[i];  // the carry holds -g_v2c_pre; rounding and sums commute with -
      if (p.flags & kVnW) {
        const float ch = chan_s[idx];
        const float vw = __ldg(p.vnw + (size_t)it * p.N + n);
        const float gxa = qms ? gT * clip_mask(ch * vw, p.q_lo, p.q_hi) : gT;
        sums_s[idx] = gxa * ch;  // VN-weight term, reduced in the kernel
        gchan_s[idx] = gchan_s[idx] + gxa * vw;
      } else {
        gq_s[idx] = gq_s[idx] + gT;  // xa_q is chan_out
      }
      gsums_s[idx] = gT;  // the cotangent of sums_{i-1}
    });
  });
}

template <int MAXD, int ROUTE>
__global__ void __launch_bounds__(1024) fused_bwd_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int NZ = p.N * p.Z;
  const int MZ = p.M * p.Z;
  const int EZ = p.E * p.Z;
  const int wpb = p.wpb;
  float* chan_s = smem;                  // [wpb, NZ]
  float* sums_s = chan_s + wpb * NZ;     // [wpb, NZ] sums_{i-1}, then VN-weight terms
  float* gsums_s = sums_s + wpb * NZ;    // [wpb, NZ] cotangent of sums_i (carry)
  float* gchan_s = gsums_s + wpb * NZ;   // [wpb, NZ]
  float* gchanq_s = gchan_s + wpb * NZ;  // [wpb, NZ] (QMS)
  float* gmsg_s = gchanq_s + wpb * NZ;   // [wpb, EZ] cotangent of the messages (carry)
  float* buf_s = gmsg_s + wpb * EZ;      // [wpb, EZ] store[i], then weight terms
  int* ucn_s = (int*)(buf_s + wpb * EZ); // [wpb, MZ] UCN flag per lifted check
  const bool qms = p.flags & kQms;
  float* gq_s = qms ? gchanq_s : gchan_s;  // cotangent of chan_out lands here

  const int* chk_off = p.tables;
  const int* chk_deg = chk_off + p.M;
  const int* e_vn = chk_deg + p.M;
  const int* e_shift = e_vn + p.E;
  const int* vn_ptr = e_shift + p.E;
  const int* vn_list = vn_ptr + p.N + 1;
  const int* e_chk = vn_list + p.E;

  const int tid = threadIdx.x;
  const long long word0 = (long long)blockIdx.x * wpb;

  for (int idx = tid; idx < wpb * NZ; idx += blockDim.x) {
    long long w = word0 + idx / NZ;
    chan_s[idx] = (w < p.B) ? p.chan[w * NZ + idx % NZ] : 0.0f;
    gsums_s[idx] = 0.0f;
    gchan_s[idx] = 0.0f;
    gchanq_s[idx] = 0.0f;
  }
  for (int idx = tid; idx < wpb * EZ; idx += blockDim.x) gmsg_s[idx] = 0.0f;

  // phase-A ownership: (local word, sorted check c, check copy zc)
  const bool owner = tid < wpb * MZ;
  int lw = 0, c = 0, zc = 0, k0 = 0, d = 0;
  if (owner) {
    lw = tid / MZ;
    int r = tid % MZ;
    c = r / p.Z;
    zc = r % p.Z;
    k0 = __ldg(chk_off + c);
    d = __ldg(chk_deg + c);
  }
  const long long gword = word0 + lw;
  const bool live = gword < p.B;
  const float* chan_w = chan_s + lw * NZ;
  const float* sums_w = sums_s + lw * NZ;
  const float* gsums_w = gsums_s + lw * NZ;
  float* gmsg_w = gmsg_s + lw * EZ;
  float* buf_w = buf_s + lw * EZ;

  // VN copy feeding edge slot j of this check copy (lift roll by +shift)
  auto pos = [&](int j) {
    int k = k0 + j;
    int zv = zc + __ldg(e_shift + k);
    if (zv >= p.Z) zv -= p.Z;
    return __ldg(e_vn + k) * p.Z + zv;
  };
  // sum over the incoming edges of VN copy q of word w of an edge-side
  // shared array, in the forward's phase-B order
  auto vn_sum = [&](const float* edge_s, int w, int q) {
    const float* mw = edge_s + w * EZ;
    int vn = q / p.Z, zv = q % p.Z;
    int e0 = __ldg(vn_ptr + vn), e1 = __ldg(vn_ptr + vn + 1);
    float acc = 0.0f;
    for (int e = e0; e < e1; ++e) {
      int k = __ldg(vn_list + e);
      int z = zv - __ldg(e_shift + k);
      if (z < 0) z += p.Z;
      float m = mw[k * p.Z + z];
      acc = (e == e0) ? m : acc + m;
    }
    return acc;
  };

  __syncthreads();

  for (int it = p.I - 1; it >= 0; --it) {
    if constexpr (ROUTE != kRoll) {
      fused_bwd_k6<MAXD, ROUTE>(p, it, smem, owner, lw, c, zc, k0, d);
    } else {
    // ---------------- L: the message state entering iteration it ----------------
    if (owner) {
      const float* st = p.store + ((size_t)it * p.B + (live ? gword : 0)) * EZ + zc;
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < d) buf_w[(k0 + j) * p.Z + zc] = live ? st[(size_t)(k0 + j) * p.Z] : 0.0f;
    }
    __syncthreads();

    // ---------------- B0: sums_{i-1}; g_out joins the carries ----------------
    for (int idx = tid; idx < wpb * NZ; idx += blockDim.x) {
      int w = idx / NZ, q = idx % NZ;
      long long gw = word0 + w;
      sums_s[idx] = vn_sum(buf_s, w, q);
      float g = (gw < p.B) ? p.g_outs[((size_t)it * p.B + gw) * NZ + q] : 0.0f;
      gsums_s[idx] = gsums_s[idx] + g;  // out_i = chan_out + sums_i
      gq_s[idx] = gq_s[idx] + g;
    }
    __syncthreads();

    // ---------------- A: recompute the check update, then its adjoint ----------------
    if (owner) {
      bool unsat = false;
      if (p.flags & kUcn) {
        const float* prev = p.outs + ((size_t)(it > 0 ? it - 1 : 0) * p.B + (live ? gword : 0)) * NZ;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
          if (j < d) {
            int q = pos(j);
            float app = (it == 0) ? chan_in(chan_w[q], q / p.Z, it, p)
                        : (live ? fminf(fmaxf(prev[q], p.clip_lo), p.clip_hi) : 0.0f);
            unsat ^= (app < 0.0f);
          }
        }
      }
      ucn_s[lw * MZ + c * p.Z + zc] = unsat ? 1 : 0;
      const float* wrow = nullptr;
      if (p.flags & (kCnW | kUcn))
        wrow = (((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw) + (size_t)it * p.E + k0;

      float vpre[MAXD];  // v2c before clip/quantize
#pragma unroll
      for (int j = 0; j < MAXD; ++j) {
        if (j < d) {
          int q = pos(j);
          float vt = chan_in(chan_w[q], q / p.Z, it, p) + sums_w[q];
          vpre[j] = vt - buf_w[(k0 + j) * p.Z + zc];
        }
      }
      // the weight terms overwrite store[it] in buf_w, which vpre has read.
      // Shared-memory offsets fit 32 bits: 64-bit ones cost K2 ~4% (PERF.md).
      check_adjoint<MAXD>(p, vpre, d, wrow, gsums_w, pos, gmsg_w + k0 * p.Z + zc,
                          buf_w + k0 * p.Z + zc, p.Z, live);
    }
    __syncthreads();

    // ---------------- B1: g_T and the channel-side gradients ----------------
    for (int idx = tid; idx < wpb * NZ; idx += blockDim.x) {
      int w = idx / NZ, q = idx % NZ;
      // g_T = sum of g_v2c_pre = -(sum of the new carry): negation is exact
      float gT = -vn_sum(gmsg_s, w, q);
      if (p.flags & kVnW) {
        float ch = chan_s[idx];
        float vw = __ldg(p.vnw + (size_t)it * p.N + q / p.Z);
        float gxa = qms ? gT * clip_mask(ch * vw, p.q_lo, p.q_hi) : gT;
        sums_s[idx] = gxa * ch;  // VN-weight term, reduced below
        gchan_s[idx] = gchan_s[idx] + gxa * vw;
      } else {
        gq_s[idx] = gq_s[idx] + gT;  // xa_q is chan_out
      }
      gsums_s[idx] = gT;  // the cotangent of sums_{i-1}
    }
    }
    // ---------------- R: per-block edge-weight partials, fixed order ----------------
    if (p.g_cnw_part) {
      const int nw = (int)min((long long)wpb, p.B - word0);
      for (int k = tid; k < p.E; k += blockDim.x) {
        const int ck = __ldg(e_chk + k);
        float acc_cn = 0.0f, acc_ucn = 0.0f;
        for (int w = 0; w < nw; ++w) {
          const float* bw = buf_s + w * EZ + k * p.Z;
          const int* uw = ucn_s + w * MZ + ck * p.Z;
          for (int z = 0; z < p.Z; ++z) {
            if ((p.flags & kUcn) && uw[z]) acc_ucn = acc_ucn + bw[z];
            else acc_cn = acc_cn + bw[z];
          }
        }
        const size_t o = ((size_t)blockIdx.x * p.I + it) * p.E + k;
        p.g_cnw_part[o] = acc_cn;
        if (p.g_ucnw_part) p.g_ucnw_part[o] = acc_ucn;
      }
    }
    __syncthreads();
    if (p.g_vnw_part) {
      const int nw = (int)min((long long)wpb, p.B - word0);
      for (int n = tid; n < p.N; n += blockDim.x) {
        float acc = 0.0f;
        for (int w = 0; w < nw; ++w)
          for (int z = 0; z < p.Z; ++z) acc = acc + sums_s[w * NZ + n * p.Z + z];
        p.g_vnw_part[((size_t)blockIdx.x * p.I + it) * p.N + n] = acc;
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < wpb * NZ; idx += blockDim.x) {
    long long w = word0 + idx / NZ;
    if (w < p.B) {
      p.g_chan[w * NZ + idx % NZ] = gchan_s[idx];
      if (qms) p.g_chanq[w * NZ + idx % NZ] = gchanq_s[idx];
    }
  }
}

template <int MAXD, int ROUTE>
cudaError_t launch(const BwdParams& p, cudaStream_t stream, int* launched) {
  const int threads = ((p.wpb * p.M * p.Z + 31) / 32) * 32;
  const size_t smem = 4 * (size_t)p.wpb * (5 * p.N * p.Z + 2 * p.E * p.Z + p.M * p.Z);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_bwd_kernel<MAXD, ROUTE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((p.B + p.wpb - 1) / p.wpb);
  fused_bwd_kernel<MAXD, ROUTE><<<blocks, threads, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace

// One launch of the backward kernel over B words (K2, or K6 with the routing
// bits of mm_route.cuh in ``flags``), added to ``*launched``.
// Weight pointers and partials the configuration does not use may be null;
// the partials hold ceil(B / wpb) blocks.  Returns a cudaError_t.
extern "C" int fused_bwd_launch(
    const float* chan, const float* store, const float* outs, const float* g_outs,
    const int* tables, const float* cnw, const float* ucnw, const float* vnw,
    float* g_chan, float* g_chanq, float* g_cnw_part, float* g_ucnw_part, float* g_vnw_part,
    int B, int N, int M, int Z, int E, int I, int max_deg, int wpb, int flags,
    float clip_lo, float clip_hi, float q_lo, float q_hi, float q_scale, void* stream,
    int* launched) {
  BwdParams p{chan, store, outs, g_outs, tables, cnw, ucnw, vnw,
              g_chan, g_chanq, g_cnw_part, g_ucnw_part, g_vnw_part,
              B, N, M, Z, E, I, wpb, flags,
              clip_lo, clip_hi, q_lo, q_hi, q_scale, 1.0f / q_scale};
  if (B <= 0) return (int)cudaSuccess;
  if (wpb * M * Z > 1024) return (int)cudaErrorInvalidConfiguration;
  if ((flags & kQms) && !g_chanq) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (flags & mmr::kRouteInt8) {  // K6
    if (max_deg <= 16) return (int)launch<16, mmr::kInt8>(p, s, launched);
    if (max_deg <= 32) return (int)launch<32, mmr::kInt8>(p, s, launched);
  } else if (flags & mmr::kRouteSplit3) {
    if (max_deg <= 16) return (int)launch<16, mmr::kSplit3>(p, s, launched);
    if (max_deg <= 32) return (int)launch<32, mmr::kSplit3>(p, s, launched);
  } else {
    if (max_deg <= 16) return (int)launch<16, kRoll>(p, s, launched);
    if (max_deg <= 32) return (int)launch<32, kRoll>(p, s, launched);
  }
  return (int)cudaErrorInvalidValue;
}
