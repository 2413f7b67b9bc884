// Forward BP decode for NVIDIA Hopper (sm_90a) with the message state in
// device memory: K3 for a word whose state no thread-block cluster of 8 CTAs
// holds (every other big code takes fused_fwd_cl.cu; ops/cuda/fused_train.py::
// cluster_plan decides).
//
// Replaces the TPU kernel neural_ldpc_tpu/ops/pallas/fused_train.py::
// _fwd_kernel_hbm (launcher _fwd_run_hbm; "K3"), in all its modes:
//   final APP      writes the pre-clip APP chan_out + sums of the last
//                  iteration;
//   kStats         per word ok / bit errors / frame error (_stats_rows), no
//                  APP; kSyndrome writes the APP and the same stats;
//   kStream        the pre-clip APP of every iteration to out[i, w, :];
//   kStore         with kStream: the store IS the carry.  Slot i-1 holds the
//                  message state entering iteration i (i = 0 reads zeros),
//                  max(I-1, 1) slots; the last iteration's messages go to
//                  the scratch ``msg`` and never into the store.
// Without kStore the state lives in one slot (``msg``), read-modify-write.
// A code with a check of more than 32 edges takes the kAnyDegree
// instantiation, whose check pass runs every check in passes over its slots
// (check_pass_any).
// The TPU kernel samples no channel in this mode, and neither does this one.
//
// Why a second kernel: fused_fwd.cu keeps a word's whole state in one
// block's shared memory and one thread per lifted check of the word in that
// block.  The BG1-like code at Z = 384 has 17,664 lifted checks (over the
// 1,024 threads of a block) and needs 694 KB of state per word (over the 227
// KB of shared memory).  Here nothing of a word has to fit one block:
//   check pass  one thread per (word, lifted check), over as many blocks as
//               the batch needs: reads the channel, sums_{i-1} and the
//               entering messages of its d edges from device memory,
//               computes UCN, v2c, the check update and the post chain
//               (bp_common.cuh, as fused_fwd.cu's phase A), and writes the
//               check's new messages;
//   VN pass     one thread per (word, VN copy): adds the copy's incoming
//               messages in the order of fused_fwd.cu's phase B (each VN's
//               edges in increasing original edge id, FwdLayout.build), so
//               this kernel equals fused_fwd.cu bit for bit on MS and QMS;
//               writes sums_i and, where the mode asks, the APP;
//   epilogue    (kStats | kSyndrome) one block per word: bit errors by
//               integer atomics in shared memory (exact in any order) and
//               the syndrome over the word's lifted checks.
// The TPU grid (batch tile, iteration) becomes a host loop over iterations
// with two launches each (plus the epilogue): stream order puts the check
// pass of iteration i (which reads sums_{i-1}) before the VN pass that
// overwrites the sums, and after the VN pass of i-1.  The TPU kernel's
// chunked DMA bounce buffers are a VMEM device and have no counterpart.
//
// Layout: msg / store slots [B, E*Z] in the permuted flat-edge order
// k*Z + zc that fused_fwd.cu's store uses; sums [B, N*Z].  Offsets are 64-bit
// throughout: B*E*Z is 3.98e9 at batch 32,768 on the Z = 384 code.
//
// Bound on this card: a decode must read the channel and write the APP,
// 2 * N*Z * 4 bytes per word; the training forward (1 + I) * N*Z * 4 +
// (I-1) * E*Z * 4.  This design moves far more: every iteration reads the
// entering messages and writes the new ones (check pass), reads them again
// (VN pass), and reads the channel and sums at each edge copy and writes
// the sums: about (5 * E*Z + N*Z) * 4 bytes per word and iteration, 50.6 MB
// per word at Z = 384, MS x20 against a bound of 0.2 MB.  The operations
// (~20-40 fp32 per edge copy and iteration, as fused_fwd.cu) are the larger
// bound.  Simple and right, not tuned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// (-fmad=false keeps a*b+c as two roundings, as fused_fwd.cu and the PyTorch
// plain version compute it.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_common.cuh"

namespace {

using namespace bp;

constexpr int kThreads = 256;

struct Params {
  const float* chan;  // [B, N*Z]
  float* out;         // [B, N*Z] pre-clip APP; [I, B, N*Z] with kStream
  float* store;       // [max(I-1, 1), B, E*Z] (kStore)
  float* msg;         // [B, E*Z] the one slot; with kStore the last iteration's messages
  float* sums;        // [B, N*Z] VN sums of the latest iteration
  int* stats;         // [B, 3] ok, bit errors, frame error (kStats | kSyndrome)
  const int* tables;  // chk_off[M] chk_deg[M] e_vn[E] e_shift[E] vn_ptr[N+1] vn_list[E] e_chk[E]
  const float* cnw;   // [I, E] in permuted edge order (or null)
  const float* ucnw;  // [I, E] (or null)
  const float* vnw;   // [I, N] (or null)
  long long B;
  int N, M, Z, E, I, flags;
  float clip_lo, clip_hi, q_lo, q_hi, q_scale, q_inv_scale;
};

// VN copy feeding edge slot j of lifted check (k0, zc) (lift roll by +shift)
__device__ __forceinline__ int edge_pos(const Params& p, int k0, int zc, int j) {
  const int* e_vn = p.tables + 2 * p.M;
  const int* e_shift = e_vn + p.E;
  const int k = k0 + j;
  int zv = zc + __ldg(e_shift + k);
  if (zv >= p.Z) zv -= p.Z;
  return __ldg(e_vn + k) * p.Z + zv;
}

// ------------------------------- check pass -------------------------------
// m_in: the state entering iteration it (null at it = 0: zeros); m_out: where
// the new messages go (may equal m_in: each thread reads its own edges before
// it writes them).
template <int MAXD>
__global__ void __launch_bounds__(kThreads)
check_pass(Params p, int it, const float* m_in, float* m_out) {
  const int MZ = p.M * p.Z, NZ = p.N * p.Z, EZ = p.E * p.Z;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.B * MZ) return;
  const long long w = idx / MZ;
  const int r = (int)(idx - w * MZ);
  const int c = r / p.Z, zc = r - c * p.Z;
  const int k0 = __ldg(p.tables + c), d = __ldg(p.tables + p.M + c);
  const float* chan_w = p.chan + w * NZ;
  const float* sums_w = p.sums + w * NZ;
  const size_t wo = (size_t)w * EZ + zc;

  bool unsat = false;
  if (p.flags & kUcn) {
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      if (j < d) {
        int q = edge_pos(p, k0, zc, j);
        float ch = chan_w[q];
        float app = (it == 0)
            ? chan_in(ch, q / p.Z, it, p)
            : fminf(fmaxf(chan_out(ch, p) + sums_w[q], p.clip_lo), p.clip_hi);
        unsat ^= (app < 0.0f);
      }
    }
  }

  // v[] holds v2c, then (SP) tanh(v2c / 2), then c2v, in place
  float v[MAXD];
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    if (j < d) {
      int q = edge_pos(p, k0, zc, j);
      float s = (it == 0) ? 0.0f : sums_w[q];
      float vt = chan_in(chan_w[q], q / p.Z, it, p) + s;
      float old = m_in ? m_in[wo + (size_t)(k0 + j) * p.Z] : 0.0f;
      v[j] = clip_or_quant(vt - old, p);
    }
  }

  check_update<MAXD>(v, d, p.flags & kSumProduct);

  const float* wrow = nullptr;
  if (p.flags & (kCnW | kUcn)) {
    wrow = ((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw;
    wrow += (size_t)it * p.E;
  }
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    if (j < d)
      m_out[wo + (size_t)(k0 + j) * p.Z] = post_chain(v[j], wrow ? wrow + k0 + j : nullptr, p);
  }
}

// The check pass of the kAnyDegree instantiation (a code with a check of
// more than 32 edges): every lifted check in bp_common.cuh's
// check_update_loop, its v2c (SP: tanh(v2c / 2)) in its m_out slots between
// the passes; the same floats as check_pass.
__global__ void __launch_bounds__(kThreads)
check_pass_any(Params p, int it, const float* m_in, float* m_out) {
  const int MZ = p.M * p.Z, NZ = p.N * p.Z, EZ = p.E * p.Z;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.B * MZ) return;
  const long long w = idx / MZ;
  const int r = (int)(idx - w * MZ);
  const int c = r / p.Z, zc = r - c * p.Z;
  const int k0 = __ldg(p.tables + c), d = __ldg(p.tables + p.M + c);
  const float* chan_w = p.chan + w * NZ;
  const float* sums_w = p.sums + w * NZ;
  const size_t wo = (size_t)w * EZ + zc;

  bool unsat = false;
  if (p.flags & kUcn) {
    for (int j = 0; j < d; ++j) {
      int q = edge_pos(p, k0, zc, j);
      float ch = chan_w[q];
      float app = (it == 0)
          ? chan_in(ch, q / p.Z, it, p)
          : fminf(fmaxf(chan_out(ch, p) + sums_w[q], p.clip_lo), p.clip_hi);
      unsat ^= (app < 0.0f);
    }
  }
  const float* wrow = nullptr;
  if (p.flags & (kCnW | kUcn)) {
    wrow = ((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw;
    wrow += (size_t)it * p.E;
  }
  check_update_loop(
      d, p.flags & kSumProduct,
      [&](int j) {
        int q = edge_pos(p, k0, zc, j);
        float s = (it == 0) ? 0.0f : sums_w[q];
        float vt = chan_in(chan_w[q], q / p.Z, it, p) + s;
        float old = m_in ? m_in[wo + (size_t)(k0 + j) * p.Z] : 0.0f;
        return clip_or_quant(vt - old, p);
      },
      [&](int j) -> float& { return m_out[wo + (size_t)(k0 + j) * p.Z]; },
      [&](int j, float c2v) { return post_chain(c2v, wrow ? wrow + k0 + j : nullptr, p); });
}

// --------------------------------- VN pass --------------------------------
__global__ void __launch_bounds__(kThreads) vn_pass(Params p, int it, const float* m) {
  const int NZ = p.N * p.Z, EZ = p.E * p.Z;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.B * NZ) return;
  const long long w = idx / NZ;
  const int q = (int)(idx - w * NZ);
  const int vn = q / p.Z, zv = q - vn * p.Z;
  const int* e_shift = p.tables + 2 * p.M + p.E;
  const int* vn_ptr = e_shift + p.E;
  const int* vn_list = vn_ptr + p.N + 1;
  const float* mw = m + (size_t)w * EZ;
  const int e0 = __ldg(vn_ptr + vn), e1 = __ldg(vn_ptr + vn + 1);
  float acc = 0.0f;
  for (int e = e0; e < e1; ++e) {
    int k = __ldg(vn_list + e);
    int z = zv - __ldg(e_shift + k);
    if (z < 0) z += p.Z;
    float mv = mw[(size_t)k * p.Z + z];
    acc = (e == e0) ? mv : acc + mv;
  }
  p.sums[idx] = acc;
  const bool last = it == p.I - 1;
  if ((last || (p.flags & kStream)) && !(p.flags & kStats)) {
    float* o = p.out + ((p.flags & kStream) ? (size_t)it * p.B * NZ : 0);
    o[idx] = chan_out(p.chan[idx], p) + acc;
  }
}

// ------------------------- stats / syndrome epilogue ----------------------
// One block per word, after the last VN pass: the APP is chan_out + sums.
__global__ void __launch_bounds__(kThreads) epilogue(Params p) {
  const int NZ = p.N * p.Z, MZ = p.M * p.Z;
  const long long w = blockIdx.x;
  const float* chan_w = p.chan + w * NZ;
  const float* sums_w = p.sums + w * NZ;
  __shared__ int berr, bad;
  if (threadIdx.x == 0) {
    berr = 0;
    bad = 0;
  }
  __syncthreads();
  int mine = 0;
  for (int q = threadIdx.x; q < NZ; q += blockDim.x)
    mine += (chan_out(chan_w[q], p) + sums_w[q]) < 0.0f;
  if (mine) atomicAdd(&berr, mine);
  for (int r = threadIdx.x; r < MZ; r += blockDim.x) {
    const int c = r / p.Z, zc = r - c * p.Z;
    const int k0 = __ldg(p.tables + c), d = __ldg(p.tables + p.M + c);
    bool odd = false;
    for (int j = 0; j < d; ++j) {
      int q = edge_pos(p, k0, zc, j);
      odd ^= (chan_out(chan_w[q], p) + sums_w[q]) < 0.0f;
    }
    if (odd) bad = 1;  // every writer stores the same value
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int* st = p.stats + w * 3;
    st[0] = bad ? 0 : 1;
    st[1] = berr;
    st[2] = berr > 0 ? 1 : 0;
  }
}

template <int MAXD>
cudaError_t run(const Params& p, cudaStream_t s, int* launched) {
  const long long nchk = p.B * p.M * p.Z, nvn = p.B * p.N * p.Z;
  const unsigned gc = (unsigned)((nchk + kThreads - 1) / kThreads);
  const unsigned gv = (unsigned)((nvn + kThreads - 1) / kThreads);
  const size_t slot = (size_t)p.B * p.E * p.Z;
  const bool store = p.flags & kStore;
  for (int it = 0; it < p.I; ++it) {
    const float* m_in = (it == 0) ? nullptr : (store ? p.store + (size_t)(it - 1) * slot : p.msg);
    float* m_out = (store && it < p.I - 1) ? p.store + (size_t)it * slot : p.msg;
    if constexpr (MAXD == kAnyDegree) {
      check_pass_any<<<gc, kThreads, 0, s>>>(p, it, m_in, m_out);
    } else {
      check_pass<MAXD><<<gc, kThreads, 0, s>>>(p, it, m_in, m_out);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
    vn_pass<<<gv, kThreads, 0, s>>>(p, it, m_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  if (p.flags & (kStats | kSyndrome)) {
    epilogue<<<(unsigned)p.B, kThreads, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return err;
  }
  return cudaSuccess;
}

}  // namespace

// One forward call: 2 * I launches (check pass and VN pass per iteration),
// plus the epilogue in the stats and syndrome modes, each added to
// ``*launched`` as it is issued.  ``msg`` [B, E*Z] and ``sums`` [B, N*Z] are
// scratch the caller allocates; pointers the mode does not use may be null.
// Returns a cudaError_t.
extern "C" int fused_fwd_dm_launch(
    const float* chan, float* out, float* store, float* msg, float* sums, int* stats,
    const int* tables, const float* cnw, const float* ucnw, const float* vnw,
    int B, int N, int M, int Z, int E, int I, int max_deg, int flags,
    float clip_lo, float clip_hi, float q_lo, float q_hi, float q_scale, void* stream,
    int* launched) {
  Params p{chan, out, store, msg, sums, stats, tables, cnw, ucnw, vnw,
           (long long)B, N, M, Z, E, I, flags,
           clip_lo, clip_hi, q_lo, q_hi, q_scale, 1.0f / q_scale};
  if (B <= 0) return (int)cudaSuccess;
  if (I <= 0 || !msg || !sums) return (int)cudaErrorInvalidValue;
  if ((flags & kStream) && (flags & (kStats | kSyndrome))) return (int)cudaErrorInvalidValue;
  if ((flags & kStore) && (!(flags & kStream) || !store)) return (int)cudaErrorInvalidValue;
  if ((flags & (kStats | kSyndrome)) && !stats) return (int)cudaErrorInvalidValue;
  if (!(flags & kStats) && !out) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (max_deg <= 16) return (int)run<16>(p, s, launched);
  if (max_deg <= 32) return (int)run<32>(p, s, launched);
  return (int)run<kAnyDegree>(p, s, launched);
}
