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
//        sample_at_idx): the channel is computed in the load loop from a
//        counter hash and never read from device memory.
//   K1d  training forward (stream_outputs, store_msgs): kStream writes the
//        pre-clip APP chan_out + sums of every iteration to out[i, w, :];
//        kStore writes the message state ENTERING iteration i (the
//        registers' msg[], zeros at i = 0) to store[i, w, k*Z + zc], in the
//        permuted flat-edge order.  Neither changes the arithmetic: the last
//        streamed output equals K1a's APP bit for bit.  The backward kernel
//        (fused_bwd.cu) reads both.
//
//   K6   the matmul branch (routing="matmul": _route_e_rows / _route_n_from_e,
//        _dot_split3, routed signs _ucn_mask_from_app / _syndrome_ok_lanes),
//        the ROUTE template parameter, in every mode above.  Each one-hot
//        routing product is a permutation, so K6 routes by index through
//        K1's own loop; what the matmul branch adds is its roundings, which
//        enter as compile-time hooks where a value is routed: the VN total
//        to an edge (int8: rint(clamp(x, +-2 q_hi) * scale) / scale), the
//        UCN and syndrome decision signs (int8: the +-1 sign quantized so),
//        and phase B's sums (int8: rint(m * scale) summed in an int, then /
//        scale; split-3: one f32 sum per bf16 part, (S_hi + S_mid) + S_lo).
//        int8 for QMS is value-exact, so K6 = K1 bit for bit; split-3's sums
//        are a rounding away from K1.  The roll instantiations (ROUTE =
//        kRoll) compile to the code K1 had.
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
// and writes the pre-clip APP chan_out + sums of the last iteration.  Steps 1
// and 3-5 are bp_common.cuh's, shared with fused_fwd_dm.cu.
//
// Design.  A block owns a few whole words; their channel, VN sums and a
// message scatter buffer live in shared memory for all iterations, so device
// memory sees one read of the channel and one write of the APP per word.
//   Phase A: one thread per (word, lifted check).  The check's d messages
//            stay in registers across iterations; checks are numbered in the
//            degree-sorted order of build_layout, so a warp mostly sees one
//            degree (the GPU reason for the TPU kernel's degree classes).
//   Phase B: one thread per (word, VN copy) sums its incoming edges in a
//            fixed order (no atomics, whose order changes from run to run).
// Graph tables and weights are small (wman 88 edges, BG2 197) and are read
// through the L1 cache.
//
// K1b: after the last iteration each phase-B thread counts APP < 0 into a
// per-word shared-memory integer (atomics on integers are exact in any
// order), and each phase-A thread takes the parity of its check's routed
// decisions and marks the word unsatisfied in a per-word shared flag (every
// writer stores the same value).  Stats mode then writes 12 bytes per word
// instead of the APP.
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
// the TPU kernel's integer stream and operation order exactly.
//
// K6 runs this design unchanged, block shape, barriers and shared memory
// included; its hooks add a few operations per routed value and, for
// split-3, three sums in place of one.
//
// Bound on this card: device-memory bytes are 2 * N*Z * 4 per word for K1a
// (read the channel, write the APP), N*Z*4 + 12 for K1b, 12 for K1c and
// (1 + I) * N*Z*4 + I * E*Z*4 for K1d with the store (for BG2 QMS x20,
// 322,048 B: K1d is the one mode bound by bytes); the
// operations are ~20-40 fp32 per edge copy and iteration (E*Z*I edge updates
// per word), plus the epilogue and the sampler's hash, which at 33.5e12
// single instructions per second (132 SMs x 128 lanes x 1.98 GHz; built
// without FMA contraction, each add or multiply is its own instruction) is
// the larger bound for both shipped codes in every other mode.  This version is
// simple and right, not tuned: it uses one word's worth of threads per
// check, shared-memory routing and a __syncthreads pair per iteration.
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

namespace {

using namespace bp;

struct Params {
  const float* chan;    // [B, N*Z]
  float* out;           // [B, N*Z] pre-clip APP; [I, B, N*Z] with kStream
  float* store;         // [I, B, E*Z] entering messages (kStore)
  const int* tables;    // chk_off[M] chk_deg[M] e_vn[E] e_shift[E] vn_ptr[N+1] vn_list[E] e_chk[E]
  const float* cnw;     // [I, E] in permuted edge order (or null)
  const float* ucnw;    // [I, E] (or null)
  const float* vnw;     // [I, N] (or null)
  int* stats;           // [B, 3] ok, bit errors, frame error (kStats | kSyndrome)
  float* chan_emit;     // [B, N*Z] sampled channel (kEmitChan)
  const int* widx;      // [B] original word indices (kAtIdx)
  int B, N, M, Z, E, I, wpb, flags;
  int Zp, bt;           // padded lift and logical stream tile of the sampler
  unsigned seed;
  float sigma;
  float clip_lo, clip_hi, q_lo, q_hi, q_scale, q_inv_scale;
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

// sampled channel LLR of bit q = n*Z + z of word w (batch position)
__device__ float sample_llr(long long w, int q, const Params& p) {
  const uint32_t wid = (p.flags & kAtIdx) ? (uint32_t)__ldg(p.widx + w) : (uint32_t)w;
  const uint32_t bt = (uint32_t)p.bt;
  const uint32_t key = p.seed ^ ((wid / bt) * 2654435761u);
  const int nzp = p.N * p.Zp;
  const int half = ((nzp + 1) / 2 + 7) / 8 * 8;
  const int row = (q / p.Z) * p.Zp + q % p.Z;
  const bool second = row >= half;
  const uint32_t i = (uint32_t)(second ? row - half : row) * bt + wid % bt;
  const float u1 = unit_uniform(i, 0u, key);
  const float u2 = unit_uniform(i, 1u, key);
  const float r = sqrtf(-2.0f * logf(1.0f - u1));
  const float theta = (float)(2.0 * 3.14159265358979323846) * u2;
  const float g = second ? sinf(theta) : cosf(theta);
  const float base = 2.0f / (p.sigma * p.sigma);
  const float scale = 2.0f / p.sigma;
  return base + scale * (r * g);
}

constexpr int kRoll = 0;  // ROUTE: roll (K1), or kInt8 / kSplit3 (K6)

// K6's int8 routing of a VN-side value to an edge copy (int8_to_edges):
// rint(clamp(x, +-2 q_hi) * scale) * (1 / scale).  Roll and split-3 route
// values exactly.  In the kernel each hook is an if constexpr whose other
// branch is K1's statement as it was: written through a helper returning
// bool, the roll instantiations' decision-sign parities compiled to other
// instructions, so they keep their own.
__device__ __forceinline__ float int8_routed(float x, const Params& p) {
  const float t = 2.0f * p.q_hi;
  return rintf(fminf(fmaxf(x, -t), t) * p.q_scale) * p.q_inv_scale;
}

// whether the int8-routed decision sign of ``app`` is negative
// (_routed_negative: the +-1 sign routed as a value)
__device__ __forceinline__ bool int8_negative(float app, const Params& p) {
  return int8_routed(app < 0.0f ? -1.0f : 1.0f, p) < 0.0f;
}

template <int MAXD, int ROUTE>
__global__ void __launch_bounds__(1024) fused_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int NZ = p.N * p.Z;
  const int MZ = p.M * p.Z;
  const int EZ = p.E * p.Z;
  float* chan_s = smem;                    // [wpb, NZ]
  float* sums_s = chan_s + p.wpb * NZ;     // [wpb, NZ]
  float* msg_s = sums_s + p.wpb * NZ;      // [wpb, EZ]
  int* berr_s = (int*)(msg_s + p.wpb * EZ);  // [wpb] bit errors (K1b)
  int* bad_s = berr_s + p.wpb;               // [wpb] some check unsatisfied (K1b)
  const bool epilogue = p.flags & (kStats | kSyndrome);

  const int* chk_off = p.tables;
  const int* chk_deg = chk_off + p.M;
  const int* e_vn = chk_deg + p.M;
  const int* e_shift = e_vn + p.E;
  const int* vn_ptr = e_shift + p.E;
  const int* vn_list = vn_ptr + p.N + 1;

  const int tid = threadIdx.x;
  const long long word0 = (long long)blockIdx.x * p.wpb;

  // load (or sample) the block's channel; words past the batch end hold 0
  // and are never written back
  for (int idx = tid; idx < p.wpb * NZ; idx += blockDim.x) {
    long long w = word0 + idx / NZ;
    int q = idx % NZ;
    float c = 0.0f;
    if (w < p.B) {
      if (p.flags & kSample) {
        c = sample_llr(w, q, p);
        if (p.flags & kEmitChan) p.chan_emit[w * NZ + q] = c;
      } else {
        c = p.chan[w * NZ + q];
      }
    }
    chan_s[idx] = c;
    sums_s[idx] = 0.0f;
  }
  if (tid < p.wpb) {
    berr_s[tid] = 0;
    bad_s[tid] = 0;
  }

  // phase-A ownership: (local word, sorted check c, check copy zc)
  const bool owner = tid < p.wpb * MZ;
  int lw = 0, zc = 0, k0 = 0, d = 0;
  if (owner) {
    lw = tid / MZ;
    int r = tid % MZ;
    int c = r / p.Z;
    zc = r % p.Z;
    k0 = __ldg(chk_off + c);
    d = __ldg(chk_deg + c);
  }
  const float* chan_w = chan_s + lw * NZ;
  const float* sums_w = sums_s + lw * NZ;
  float* msg_w = msg_s + lw * EZ;

  // VN copy feeding edge slot j of this check copy (lift roll by +shift)
  auto pos = [&](int j) {
    int k = k0 + j;
    int zv = zc + __ldg(e_shift + k);
    if (zv >= p.Z) zv -= p.Z;
    return __ldg(e_vn + k) * p.Z + zv;
  };

  float msg[MAXD];
#pragma unroll
  for (int j = 0; j < MAXD; ++j) msg[j] = 0.0f;

  __syncthreads();

  const long long gword = word0 + lw;
  for (int it = 0; it < p.I; ++it) {
    // ---------------- phase A: check update in registers ----------------
    if (owner) {
      if ((p.flags & kStore) && gword < p.B) {
        float* st = p.store + ((size_t)it * p.B + gword) * EZ + zc;
#pragma unroll
        for (int j = 0; j < MAXD; ++j)
          if (j < d) st[(size_t)(k0 + j) * p.Z] = msg[j];
      }
      bool unsat = false;
      if (p.flags & kUcn) {
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
          if (j < d) {
            int q = pos(j);
            float c = chan_w[q];
            float app = (it == 0)
                ? chan_in(c, q / p.Z, it, p)
                : fminf(fmaxf(chan_out(c, p) + sums_w[q], p.clip_lo), p.clip_hi);
            if constexpr (ROUTE == kInt8) {
              unsat ^= int8_negative(app, p);
            } else {
              unsat ^= (app < 0.0f);
            }
          }
        }
      }

      // v[] holds v2c, then (SP) tanh(v2c / 2), then c2v, in place
      float v[MAXD];
#pragma unroll
      for (int j = 0; j < MAXD; ++j) {
        if (j < d) {
          int q = pos(j);
          float vt = chan_in(chan_w[q], q / p.Z, it, p) + sums_w[q];
          if constexpr (ROUTE == kInt8) vt = int8_routed(vt, p);
          v[j] = clip_or_quant(vt - msg[j], p);
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
        if (j < d) {
          msg[j] = post_chain(v[j], wrow ? wrow + k0 + j : nullptr, p);
          msg_w[(k0 + j) * p.Z + zc] = msg[j];
        }
      }
    }
    __syncthreads();

    // ---------------- phase B: fixed-order VN sums ----------------
    const bool last = it == p.I - 1;
    const bool write = last || (p.flags & kStream);
    float* out_it = p.out + ((p.flags & kStream) ? (size_t)it * p.B * NZ : 0);
    for (int idx = tid; idx < p.wpb * NZ; idx += blockDim.x) {
      int w = idx / NZ;
      int q = idx % NZ;
      int vn = q / p.Z;
      int zv = q % p.Z;
      const float* mw = msg_s + w * EZ;
      int e0 = __ldg(vn_ptr + vn), e1 = __ldg(vn_ptr + vn + 1);
      // message of the e-th incoming edge (lift roll by -shift)
      auto edge_msg = [&](int e) {
        int k = __ldg(vn_list + e);
        int z = zv - __ldg(e_shift + k);
        if (z < 0) z += p.Z;
        return mw[k * p.Z + z];
      };
      float acc = 0.0f;
      if constexpr (ROUTE == kInt8) {
        // int8_to_vns: rint(m * scale) summed exactly, then * (1 / scale)
        int s8 = 0;
        for (int e = e0; e < e1; ++e) s8 += (int)rintf(edge_msg(e) * p.q_scale);
        acc = (float)s8 * p.q_inv_scale;
      } else if constexpr (ROUTE == kSplit3) {
        // _dot_split3: one sum per bf16 part, then (S_hi + S_mid) + S_lo
        float s_hi = 0.0f, s_mid = 0.0f, s_lo = 0.0f;
        for (int e = e0; e < e1; ++e) {
          float hi, mid, lo;
          split3(edge_msg(e), hi, mid, lo);
          s_hi = (e == e0) ? hi : s_hi + hi;
          s_mid = (e == e0) ? mid : s_mid + mid;
          s_lo = (e == e0) ? lo : s_lo + lo;
        }
        if (e1 > e0) acc = (s_hi + s_mid) + s_lo;
      } else {
        for (int e = e0; e < e1; ++e) {
          float m = edge_msg(e);
          acc = (e == e0) ? m : acc + m;
        }
      }
      sums_s[idx] = acc;
      if (write) {
        long long gw = word0 + w;
        float app = chan_out(chan_s[idx], p) + acc;
        if (gw < p.B) {
          if (!(p.flags & kStats)) out_it[gw * NZ + q] = app;
          if (last && epilogue && app < 0.0f) atomicAdd(berr_s + w, 1);
        }
      }
    }
    __syncthreads();
  }

  // ---------------- K1b epilogue: syndrome and per-word stats ----------------
  if (epilogue) {
    if (owner) {
      bool odd = false;
#pragma unroll
      for (int j = 0; j < MAXD; ++j) {
        if (j < d) {
          int q = pos(j);
          if constexpr (ROUTE == kInt8) {
            odd ^= int8_negative(chan_out(chan_w[q], p) + sums_w[q], p);
          } else {
            odd ^= (chan_out(chan_w[q], p) + sums_w[q]) < 0.0f;
          }
        }
      }
      if (odd) bad_s[lw] = 1;
    }
    __syncthreads();
    if (tid < p.wpb) {
      long long gw = word0 + tid;
      if (gw < p.B) {
        int* st = p.stats + gw * 3;
        st[0] = bad_s[tid] ? 0 : 1;
        st[1] = berr_s[tid];
        st[2] = berr_s[tid] > 0 ? 1 : 0;
      }
    }
  }
}

template <int MAXD, int ROUTE>
cudaError_t launch(const Params& p, cudaStream_t stream, int* launched) {
  const int threads = ((p.wpb * p.M * p.Z + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (size_t)p.wpb * (2 * p.N * p.Z + p.E * p.Z + 2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_fwd_kernel<MAXD, ROUTE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((p.B + p.wpb - 1) / p.wpb);
  fused_fwd_kernel<MAXD, ROUTE><<<blocks, threads, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace

// One launch of the decode kernel in the mode and routing ``flags`` select (K1, or K6 with
// kRouteInt8 / kRouteSplit3), added to
// ``*launched``.  Pointers the mode does not use may be null.  Returns a
// cudaError_t.
extern "C" int fused_fwd_launch(
    const float* chan, float* out, float* store, int* stats, float* chan_emit, const int* widx,
    const int* tables, const float* cnw, const float* ucnw, const float* vnw,
    int B, int N, int M, int Z, int E, int I, int max_deg, int wpb, int flags,
    int Zp, int bt, int seed, float sigma, float clip_lo, float clip_hi,
    float q_lo, float q_hi, float q_scale, void* stream, int* launched) {
  Params p{chan, out, store, tables, cnw, ucnw, vnw, stats, chan_emit, widx,
           B, N, M, Z, E, I, wpb, flags, Zp, bt, (unsigned)seed, sigma,
           clip_lo, clip_hi, q_lo, q_hi, q_scale, 1.0f / q_scale};
  if (B <= 0) return (int)cudaSuccess;
  if (wpb * M * Z > 1024) return (int)cudaErrorInvalidConfiguration;
  if ((flags & kSample) && bt <= 0) return (int)cudaErrorInvalidValue;
  if ((flags & kStream) && (flags & (kStats | kSyndrome))) return (int)cudaErrorInvalidValue;
  if ((flags & kStore) && !(flags & kStream)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (flags & kRouteInt8) {  // K6
    if (max_deg <= 16) return (int)launch<16, kInt8>(p, s, launched);
    if (max_deg <= 32) return (int)launch<32, kInt8>(p, s, launched);
  } else if (flags & kRouteSplit3) {
    if (max_deg <= 16) return (int)launch<16, kSplit3>(p, s, launched);
    if (max_deg <= 32) return (int)launch<32, kSplit3>(p, s, launched);
  } else {
    if (max_deg <= 16) return (int)launch<16, kRoll>(p, s, launched);
    if (max_deg <= 32) return (int)launch<32, kRoll>(p, s, launched);
  }
  return (int)cudaErrorInvalidValue;
}
