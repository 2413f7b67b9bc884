// Backward BP kernel for NVIDIA Hopper (sm_90a) with the message state, the
// adjoint carries and the channel-gradient accumulators in device memory:
// the big-code counterpart of fused_bwd.cu, the adjoint of fused_fwd_dm.cu's
// training forward (kStream | kStore).
//
// Replaces the TPU kernel neural_ldpc_tpu/ops/pallas/fused_train.py::
// _bwd_kernel_hbm (launcher _bwd_run_hbm; "K4"): roll routing, MS / QMS / SP,
// CN, UCN and VN weights.  Its reversed grid over iterations becomes a host
// loop i = I-1 .. 0; per iteration, three to five launches on one stream:
//   B0  one thread per (word, VN copy): pass 1, sums_{i-1} rebuilt from store
//       slot i-1 (zeros at i = 0) in the forward's phase-B order (the exact
//       recompute: any other order moves MS's v2c by ulps and flips the clip
//       masks and tie sets); g_outs[i] joins the sums cotangent carry and
//       the channel-side accumulator;
//   A   one thread per (word, lifted check): pass 2, the forward recomputed
//       from slot i-1 and its adjoint (bp_common.cuh's check_adjoint, as
//       fused_bwd.cu's phase A): UCN from the clipped outs[i-1] (the weighted
//       quantised channel at i = 0), the post chain's adjoint (weight, ReLU,
//       clip/quantise, re-sign), the check update's adjoint; writes the new message
//       cotangent carry gmsg = -g_v2c_pre in place (each thread reads its own
//       edges before it writes them), each edge copy's weight-gradient term
//       and each lifted check's UCN flag;
//   B1  one thread per (word, VN copy): g_T = -(rolled-back sum of the new
//       carry), the next sums carry, and the channel-side gradients through
//       the VN weight and the QMS input quantizer;
//   RE  one block per (edge, chunk of words): the chunk's CN (and UCN)
//       weight-gradient terms summed in a fixed order (a strided serial sum
//       per thread, then a fixed tree), one partial per chunk;
//   RV  the same per (VN, chunk) for the VN weights.
// The wrapper sums the partials over chunks in a fixed order, as _bwd_run_hbm
// sums its batch tiles.  No float atomics anywhere: their order changes from
// run to run, and bitwise resume of a training run needs the same gradients
// every time.  The channel gradients are accumulated per element in
// fused_bwd.cu's order, so they equal K2's bit for bit; the weight gradients
// are summed over words in another order than K2's.  The ties follow JAX's
// conventions (bp_common.cuh).
//
// Device memory the wrapper allocates besides the inputs and outputs: the
// sums carry and sums_{i-1} [B, N*Z], the message cotangent carry and the
// weight terms [B, E*Z], a UCN flag per lifted check [B, M*Z] bytes; for SP
// on a code with a check of more than 32 edges, whose pass A runs every
// check in passes over its slots (kAnyDegree, pass_a_any), three scratch
// floats per edge copy [3, B, E*Z].
//
// Bound on this card: the bytes a backward must move are the reads of the
// channel, the store ((I-1) * E*Z * 4 per word), g_outs (I * N*Z * 4) and,
// with UCN, outs, and the writes of g_chan (and g_chanq); the operations
// (recompute plus adjoint, about three times the forward's per edge and
// iteration) are the larger bound.  This design moves the store twice and
// the carries several times per iteration.  Simple and right, not tuned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_common.cuh"

namespace {

using namespace bp;

constexpr int kThreads = 256;  // every kernel; the reductions' trees assume it

struct Params {
  const float* chan;    // [B, N*Z]
  const float* store;   // [max(I-1, 1), B, E*Z]: slot i-1 = state entering iteration i
  const float* outs;    // [I, B, N*Z] pre-clip APP (read with UCN)
  const float* g_outs;  // [I, B, N*Z]
  const int* tables;    // chk_off[M] chk_deg[M] e_vn[E] e_shift[E] vn_ptr[N+1] vn_list[E] e_chk[E]
  const float* cnw;     // [I, E] permuted edge order (or null)
  const float* ucnw;    // [I, E] (or null)
  const float* vnw;     // [I, N] (or null)
  float* g_chan;        // [B, N*Z] accumulator, zeros on entry
  float* g_chanq;       // [B, N*Z] (QMS; zeros on entry), else null: its terms go to g_chan
  float* gsums;         // [B, N*Z] cotangent of sums_i (carry), zeros on entry
  float* gmsg;          // [B, E*Z] cotangent of the messages (carry), zeros on entry
  float* sums;          // [B, N*Z] sums_{i-1}, then the VN-weight terms
  float* gw;            // [B, E*Z] weight-gradient term per edge copy
  uint8_t* ucn;         // [B, M*Z] UCN flag per lifted check (kUcn)
  float* g_cnw_part;    // [chunks, I, E] (or null)
  float* g_ucnw_part;   // [chunks, I, E] (or null)
  float* g_vnw_part;    // [chunks, I, N] (or null)
  long long B;
  int N, M, Z, E, I, flags, chunk;
  float clip_lo, clip_hi, q_lo, q_hi, q_scale, q_inv_scale;
};

__device__ __forceinline__ int edge_pos(const Params& p, int k0, int zc, int j) {
  const int* e_vn = p.tables + 2 * p.M;
  const int* e_shift = e_vn + p.E;
  const int k = k0 + j;
  int zv = zc + __ldg(e_shift + k);
  if (zv >= p.Z) zv -= p.Z;
  return __ldg(e_vn + k) * p.Z + zv;
}

// sum over the incoming edges of VN copy q of one word's edge-side array, in
// the forward's phase-B order
__device__ __forceinline__ float vn_sum(const Params& p, const float* mw, int q) {
  const int* e_shift = p.tables + 2 * p.M + p.E;
  const int* vn_ptr = e_shift + p.E;
  const int* vn_list = vn_ptr + p.N + 1;
  const int vn = q / p.Z, zv = q - vn * p.Z;
  const int e0 = __ldg(vn_ptr + vn), e1 = __ldg(vn_ptr + vn + 1);
  float acc = 0.0f;
  for (int e = e0; e < e1; ++e) {
    int k = __ldg(vn_list + e);
    int z = zv - __ldg(e_shift + k);
    if (z < 0) z += p.Z;
    float m = mw[(size_t)k * p.Z + z];
    acc = (e == e0) ? m : acc + m;
  }
  return acc;
}

__device__ __forceinline__ float* gq_of(const Params& p) {
  return (p.flags & kQms) ? p.g_chanq : p.g_chan;  // the cotangent of chan_out
}

// ---------------- B0: sums_{i-1}; g_out joins the carries ----------------
__global__ void __launch_bounds__(kThreads) pass_b0(Params p, int it) {
  const int NZ = p.N * p.Z;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.B * NZ) return;
  const long long w = idx / NZ;
  const int q = (int)(idx - w * NZ);
  const size_t slot = (size_t)p.B * p.E * p.Z;
  p.sums[idx] = (it == 0) ? 0.0f
      : vn_sum(p, p.store + (size_t)(it - 1) * slot + (size_t)w * p.E * p.Z, q);
  const float g = p.g_outs[(size_t)it * p.B * NZ + idx];
  p.gsums[idx] = p.gsums[idx] + g;  // out_i = chan_out + sums_i
  float* gq = gq_of(p);
  gq[idx] = gq[idx] + g;
}

// ---------------- A: recompute the check update, then its adjoint ----------------
template <int MAXD>
__global__ void __launch_bounds__(kThreads) pass_a(Params p, int it) {
  const int MZ = p.M * p.Z, NZ = p.N * p.Z, EZ = p.E * p.Z;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.B * MZ) return;
  const long long w = idx / MZ;
  const int r = (int)(idx - w * MZ);
  const int c = r / p.Z, zc = r - c * p.Z;
  const int k0 = __ldg(p.tables + c), d = __ldg(p.tables + p.M + c);
  const float* chan_w = p.chan + w * NZ;
  const float* sums_w = p.sums + w * NZ;
  const float* gsums_w = p.gsums + w * NZ;
  const size_t wo = (size_t)w * EZ + zc;  // + (k0 + j) * Z: this thread's edges
  const float* mprev = (it == 0) ? nullptr
      : p.store + (size_t)(it - 1) * p.B * EZ + wo;

  bool unsat = false;
  if (p.flags & kUcn) {
    const float* prev = p.outs + ((size_t)(it > 0 ? it - 1 : 0) * p.B + w) * NZ;
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      if (j < d) {
        int q = edge_pos(p, k0, zc, j);
        float app = (it == 0) ? chan_in(chan_w[q], q / p.Z, it, p)
                              : fminf(fmaxf(prev[q], p.clip_lo), p.clip_hi);
        unsat ^= (app < 0.0f);
      }
    }
    p.ucn[w * MZ + r] = unsat ? 1 : 0;
  }
  const float* wrow = nullptr;
  if (p.flags & (kCnW | kUcn))
    wrow = (((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw) + (size_t)it * p.E + k0;

  float vpre[MAXD];  // v2c before clip/quantize
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    if (j < d) {
      int q = edge_pos(p, k0, zc, j);
      float vt = chan_in(chan_w[q], q / p.Z, it, p) + sums_w[q];
      vpre[j] = vt - (mprev ? mprev[(size_t)(k0 + j) * p.Z] : 0.0f);
    }
  }
  check_adjoint<MAXD>(p, vpre, d, wrow, gsums_w,
                      [&](int j) { return edge_pos(p, k0, zc, j); },
                      p.gmsg + wo + (size_t)k0 * p.Z, p.gw + wo + (size_t)k0 * p.Z, p.Z, true);
}

// One lifted check's slots in device memory, as bp_common.cuh's
// check_adjoint_loop reads and writes them (pass_a_any); ``spx`` is SP's
// scratch [3, B, E*Z].
struct DmSlots {
  const Params& p;
  float* spx;
  const float* chan_w;
  const float* sums_w;
  const float* gsums_w;
  const float* mprev;  // the check's first slot of store slot it-1, or null at it = 0
  const float* wrow;   // its first edge weight, or null
  size_t at;           // its first slot in the [B, E*Z] arrays: w*E*Z + k0*Z + zc
  int k0, zc, it;
  __device__ int pos(int j) const { return edge_pos(p, k0, zc, j); }
  __device__ float vpre(int j) const {
    const int q = pos(j);
    const float vt = chan_in(chan_w[q], q / p.Z, it, p) + sums_w[q];
    return vt - (mprev ? mprev[(size_t)j * p.Z] : 0.0f);
  }
  __device__ float gin(int j) const { return p.gmsg[at + (size_t)j * p.Z] + gsums_w[pos(j)]; }
  __device__ float wt(int j) const { return wrow ? __ldg(wrow + j) : 1.0f; }
  __device__ float& gmsg(int j) const { return p.gmsg[at + (size_t)j * p.Z]; }
  __device__ float& gw(int j) const { return p.gw[at + (size_t)j * p.Z]; }
  __device__ float& x(int a, int j) const {
    return spx[(size_t)a * p.B * p.E * p.Z + at + (size_t)j * p.Z];
  }
};

// Pass A of the kAnyDegree instantiation (a code with a check of more than
// 32 edges): every lifted check through check_adjoint_loop, the same floats
// as pass_a; ``spx`` [3, B, E*Z] is SP's scratch (else null).
__global__ void __launch_bounds__(kThreads) pass_a_any(Params p, int it, float* spx) {
  const int MZ = p.M * p.Z, NZ = p.N * p.Z, EZ = p.E * p.Z;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.B * MZ) return;
  const long long w = idx / MZ;
  const int r = (int)(idx - w * MZ);
  const int c = r / p.Z, zc = r - c * p.Z;
  const int k0 = __ldg(p.tables + c), d = __ldg(p.tables + p.M + c);
  const float* chan_w = p.chan + w * NZ;
  const size_t wo = (size_t)w * EZ + zc;
  bool unsat = false;
  if (p.flags & kUcn) {
    const float* prev = p.outs + ((size_t)(it > 0 ? it - 1 : 0) * p.B + w) * NZ;
    for (int j = 0; j < d; ++j) {
      int q = edge_pos(p, k0, zc, j);
      float app = (it == 0) ? chan_in(chan_w[q], q / p.Z, it, p)
                            : fminf(fmaxf(prev[q], p.clip_lo), p.clip_hi);
      unsat ^= (app < 0.0f);
    }
    p.ucn[w * MZ + r] = unsat ? 1 : 0;
  }
  const float* wrow = nullptr;
  if (p.flags & (kCnW | kUcn))
    wrow = (((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw) + (size_t)it * p.E + k0;
  const size_t at = wo + (size_t)k0 * p.Z;
  DmSlots s{p, spx, chan_w, p.sums + w * NZ, p.gsums + w * NZ,
            (it == 0) ? nullptr : p.store + (size_t)(it - 1) * p.B * EZ + at, wrow, at, k0, zc,
            it};
  check_adjoint_loop(p, d, wrow != nullptr, true, s);
}

// ---------------- B1: g_T and the channel-side gradients ----------------
__global__ void __launch_bounds__(kThreads) pass_b1(Params p, int it) {
  const int NZ = p.N * p.Z;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.B * NZ) return;
  const long long w = idx / NZ;
  const int q = (int)(idx - w * NZ);
  // g_T = sum of g_v2c_pre = -(sum of the new carry): negation is exact
  const float gT = -vn_sum(p, p.gmsg + (size_t)w * p.E * p.Z, q);
  if (p.flags & kVnW) {
    const float ch = p.chan[idx];
    const float vw = __ldg(p.vnw + (size_t)it * p.N + q / p.Z);
    const float gxa = (p.flags & kQms) ? gT * clip_mask(ch * vw, p.q_lo, p.q_hi) : gT;
    p.sums[idx] = gxa * ch;  // VN-weight term, reduced by reduce_vn
    p.g_chan[idx] = p.g_chan[idx] + gxa * vw;
  } else {
    float* gq = gq_of(p);
    gq[idx] = gq[idx] + gT;  // xa_q is chan_out
  }
  p.gsums[idx] = gT;  // the cotangent of sums_{i-1}
}

// fixed-order tree over the block's kThreads partial sums
__device__ __forceinline__ void tree(float* s) {
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h) s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + h];
    __syncthreads();
  }
}

// ---------------- RE: per-chunk edge-weight partials ----------------
// block (edge k, chunk ch): the terms of the chunk's words, split by the UCN
// flag of edge copy (w, k, z)'s lifted check
__global__ void __launch_bounds__(kThreads) reduce_edges(Params p, int it) {
  const int k = blockIdx.x;
  const long long w0 = (long long)blockIdx.y * p.chunk;
  const int nw = (int)min((long long)p.chunk, p.B - w0);
  const int ck = __ldg(p.tables + 2 * p.M + 2 * p.E + p.N + 1 + p.E + k);  // e_chk[k]
  const bool ucn = p.flags & kUcn;
  const size_t EZ = (size_t)p.E * p.Z, MZ = (size_t)p.M * p.Z;
  float acc_cn = 0.0f, acc_ucn = 0.0f;
  for (int t = threadIdx.x; t < nw * p.Z; t += kThreads) {
    const long long w = w0 + t / p.Z;
    const int z = t % p.Z;
    const float g = p.gw[w * EZ + (size_t)k * p.Z + z];
    if (ucn && p.ucn[w * MZ + (size_t)ck * p.Z + z]) acc_ucn = acc_ucn + g;
    else acc_cn = acc_cn + g;
  }
  __shared__ float s_cn[kThreads], s_ucn[kThreads];
  s_cn[threadIdx.x] = acc_cn;
  s_ucn[threadIdx.x] = acc_ucn;
  tree(s_cn);
  tree(s_ucn);
  if (threadIdx.x == 0) {
    const size_t o = ((size_t)blockIdx.y * p.I + it) * p.E + k;
    p.g_cnw_part[o] = s_cn[0];
    if (p.g_ucnw_part) p.g_ucnw_part[o] = s_ucn[0];
  }
}

// ---------------- RV: per-chunk VN-weight partials ----------------
__global__ void __launch_bounds__(kThreads) reduce_vns(Params p, int it) {
  const int n = blockIdx.x;
  const long long w0 = (long long)blockIdx.y * p.chunk;
  const int nw = (int)min((long long)p.chunk, p.B - w0);
  const size_t NZ = (size_t)p.N * p.Z;
  float acc = 0.0f;
  for (int t = threadIdx.x; t < nw * p.Z; t += kThreads) {
    const long long w = w0 + t / p.Z;
    acc = acc + p.sums[w * NZ + (size_t)n * p.Z + t % p.Z];
  }
  __shared__ float s[kThreads];
  s[threadIdx.x] = acc;
  tree(s);
  if (threadIdx.x == 0) p.g_vnw_part[((size_t)blockIdx.y * p.I + it) * p.N + n] = s[0];
}

template <int MAXD>
cudaError_t run(const Params& p, float* spx, cudaStream_t s, int* launched) {
  const long long nchk = p.B * p.M * p.Z, nvn = p.B * p.N * p.Z;
  const unsigned gc = (unsigned)((nchk + kThreads - 1) / kThreads);
  const unsigned gv = (unsigned)((nvn + kThreads - 1) / kThreads);
  const unsigned chunks = (unsigned)((p.B + p.chunk - 1) / p.chunk);
  cudaError_t err;
  for (int it = p.I - 1; it >= 0; --it) {
    pass_b0<<<gv, kThreads, 0, s>>>(p, it);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launched;
    if constexpr (MAXD == kAnyDegree) {
      pass_a_any<<<gc, kThreads, 0, s>>>(p, it, spx);
    } else {
      pass_a<MAXD><<<gc, kThreads, 0, s>>>(p, it);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launched;
    pass_b1<<<gv, kThreads, 0, s>>>(p, it);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++*launched;
    if (p.g_cnw_part) {
      reduce_edges<<<dim3(p.E, chunks), kThreads, 0, s>>>(p, it);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      ++*launched;
    }
    if (p.g_vnw_part) {
      reduce_vns<<<dim3(p.N, chunks), kThreads, 0, s>>>(p, it);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      ++*launched;
    }
  }
  return cudaSuccess;
}

}  // namespace

// One backward call over B words: per iteration B0, A, B1 and, with weights,
// the edge and VN reductions (3 to 5 launches), each added to ``*launched``
// as it is issued.  The partials hold ceil(B / chunk) chunks.  Pointers the
// configuration does not use may be null.  Returns a cudaError_t.
extern "C" int fused_bwd_dm_launch(
    const float* chan, const float* store, const float* outs, const float* g_outs,
    const int* tables, const float* cnw, const float* ucnw, const float* vnw,
    float* g_chan, float* g_chanq, float* gsums, float* gmsg, float* sums, float* gw,
    uint8_t* ucn, float* spx, float* g_cnw_part, float* g_ucnw_part, float* g_vnw_part,
    int B, int N, int M, int Z, int E, int I, int max_deg, int flags, int chunk,
    float clip_lo, float clip_hi, float q_lo, float q_hi, float q_scale, void* stream,
    int* launched) {
  Params p{chan, store, outs, g_outs, tables, cnw, ucnw, vnw, g_chan, g_chanq,
           gsums, gmsg, sums, gw, ucn, g_cnw_part, g_ucnw_part, g_vnw_part,
           (long long)B, N, M, Z, E, I, flags, chunk,
           clip_lo, clip_hi, q_lo, q_hi, q_scale, 1.0f / q_scale};
  if (B <= 0) return (int)cudaSuccess;
  if (I <= 0 || chunk <= 0 || (long long)chunk * Z > (1LL << 30)) return (int)cudaErrorInvalidValue;
  if ((flags & kQms) && !g_chanq) return (int)cudaErrorInvalidValue;
  if ((flags & kUcn) && (!ucn || !outs)) return (int)cudaErrorInvalidValue;
  if ((B + chunk - 1) / chunk > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (max_deg <= 16) return (int)run<16>(p, spx, s, launched);
  if (max_deg <= 32) return (int)run<32>(p, spx, s, launched);
  if ((flags & kSumProduct) && !spx) return (int)cudaErrorInvalidValue;
  return (int)run<kAnyDegree>(p, spx, s, launched);
}
