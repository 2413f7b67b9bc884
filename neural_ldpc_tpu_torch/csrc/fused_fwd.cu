// Forward BP decode, final-APP mode, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel neural_ldpc_tpu/ops/pallas/fused_train.py::_fwd_kernel
// in its final-APP decode mode (ROADMAP "K1a": stream_outputs=False,
// store_msgs=False; MS / QMS / SP check updates; CN, UCN and VN weights).
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
//               the degree-sorted (permuted) edge order
// and writes the pre-clip APP chan_out + sums of the last iteration.
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
// Bound on this card: device-memory bytes are 2 * N*Z * 4 per word (read the
// channel, write the APP); the operations are ~20-40 fp32 per edge copy and
// iteration (E*Z*I edge updates per word), which at 67 TFLOP/s (fp32 without
// tensor cores) is the larger bound for both shipped codes.  This first
// version is simple and right, not tuned: it uses one word's worth of
// threads per check, shared-memory routing and a __syncthreads pair per
// iteration.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// (-fmad=false keeps a*b+c as two roundings, as the PyTorch version computes
// it, so QMS decodes stay bit-exact and MS within float sum-order noise.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum : int {
  kQms = 1,
  kSumProduct = 2,
  kCnW = 4,
  kUcn = 8,
  kVnW = 16,
};

struct Params {
  const float* chan;    // [B, N*Z]
  float* out;           // [B, N*Z], pre-clip APP
  const int* tables;    // chk_off[M] chk_deg[M] e_vn[E] e_shift[E] vn_ptr[N+1] vn_list[E]
  const float* cnw;     // [I, E] in permuted edge order (or null)
  const float* ucnw;    // [I, E] (or null)
  const float* vnw;     // [I, N] (or null)
  int B, N, M, Z, E, I, wpb, flags;
  float clip_lo, clip_hi, q_lo, q_hi, q_scale, q_inv_scale;
};

__device__ __forceinline__ float quant(float x, const Params& p) {
  // jnp.round / torch.round are half-to-even: rintf, not roundf.  The QMS
  // scales are powers of two, so * (1 / scale) is exactly / scale.
  return fminf(fmaxf(rintf(x * p.q_scale) * p.q_inv_scale, p.q_lo), p.q_hi);
}

__device__ __forceinline__ float clip_or_quant(float x, const Params& p) {
  if (p.flags & kQms) return quant(x, p);
  return fminf(fmaxf(x, p.clip_lo), p.clip_hi);
}

// chan_out: the APP's channel term
__device__ __forceinline__ float chan_out(float c, const Params& p) {
  return (p.flags & kQms) ? quant(c, p) : c;
}

// xa_q: the weighted (and quantized) channel feeding the VN update
__device__ __forceinline__ float chan_in(float c, int vn, int it, const Params& p) {
  if (p.flags & kVnW) {
    float x = c * __ldg(p.vnw + (size_t)it * p.N + vn);
    return (p.flags & kQms) ? quant(x, p) : x;
  }
  return chan_out(c, p);
}

template <int MAXD>
__global__ void __launch_bounds__(1024) fused_fwd_k1a_kernel(Params p) {
  extern __shared__ float smem[];
  const int NZ = p.N * p.Z;
  const int MZ = p.M * p.Z;
  const int EZ = p.E * p.Z;
  float* chan_s = smem;                    // [wpb, NZ]
  float* sums_s = chan_s + p.wpb * NZ;     // [wpb, NZ]
  float* msg_s = sums_s + p.wpb * NZ;      // [wpb, EZ]

  const int* chk_off = p.tables;
  const int* chk_deg = chk_off + p.M;
  const int* e_vn = chk_deg + p.M;
  const int* e_shift = e_vn + p.E;
  const int* vn_ptr = e_shift + p.E;
  const int* vn_list = vn_ptr + p.N + 1;

  const int tid = threadIdx.x;
  const long long word0 = (long long)blockIdx.x * p.wpb;

  // load the block's channel; words past the batch end read as 0 and are
  // never written back
  for (int idx = tid; idx < p.wpb * NZ; idx += blockDim.x) {
    long long w = word0 + idx / NZ;
    chan_s[idx] = (w < p.B) ? p.chan[w * NZ + idx % NZ] : 0.0f;
    sums_s[idx] = 0.0f;
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

  float msg[MAXD];
#pragma unroll
  for (int j = 0; j < MAXD; ++j) msg[j] = 0.0f;

  __syncthreads();

  for (int it = 0; it < p.I; ++it) {
    // ---------------- phase A: check update in registers ----------------
    if (owner) {
      // VN copy feeding edge slot j of this check copy (lift roll by +shift)
      auto pos = [&](int j) {
        int k = k0 + j;
        int zv = zc + __ldg(e_shift + k);
        if (zv >= p.Z) zv -= p.Z;
        return __ldg(e_vn + k) * p.Z + zv;
      };

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
            unsat ^= (app < 0.0f);
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
          v[j] = clip_or_quant(vt - msg[j], p);
        }
      }

      if (p.flags & kSumProduct) {
        float pre[MAXD];
        float acc = 1.0f;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
          if (j < d) {
            v[j] = tanhf(0.5f * v[j]);
            pre[j] = acc;
            acc = acc * v[j];
          }
        }
        acc = 1.0f;
#pragma unroll
        for (int j = MAXD - 1; j >= 0; --j) {
          if (j < d) {
            float ext = pre[j] * acc;
            acc = acc * v[j];
            ext = fminf(fmaxf(ext, -1.0f + 1e-7f), 1.0f - 1e-7f);
            v[j] = logf((1.0f + ext) / (1.0f - ext));
          }
        }
      } else {
        float m1 = 10000.0f, m2 = 10000.0f;
        int am = 0;
        bool neg = false;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
          if (j < d) {
            float a = fabsf(v[j]);
            neg ^= !(v[j] >= 0.0f);
            if (a < m1) {  // strict: first occurrence of the minimum
              m2 = m1;
              m1 = a;
              am = j;
            } else if (a < m2) {
              m2 = a;
            }
          }
        }
        const float total = neg ? -1.0f : 1.0f;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
          if (j < d) {
            float own = (v[j] >= 0.0f) ? 1.0f : -1.0f;
            v[j] = ((j == am) ? m2 : m1) * (total * own);
          }
        }
      }

      const float* wrow = nullptr;
      if (p.flags & (kCnW | kUcn)) {
        wrow = ((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw;
        wrow += (size_t)it * p.E;
      }
#pragma unroll
      for (int j = 0; j < MAXD; ++j) {
        if (j < d) {
          float c = v[j];
          float wm = fabsf(c);
          if (wrow) wm = wm * __ldg(wrow + k0 + j);
          wm = fmaxf(wm, 0.0f);
          wm = clip_or_quant(wm, p);
          float s = (c > 0.0f) ? 1.0f : ((c < 0.0f) ? -1.0f : 0.0f);
          msg[j] = wm * s;
          msg_w[(k0 + j) * p.Z + zc] = msg[j];
        }
      }
    }
    __syncthreads();

    // ---------------- phase B: fixed-order VN sums ----------------
    const bool last = it == p.I - 1;
    for (int idx = tid; idx < p.wpb * NZ; idx += blockDim.x) {
      int w = idx / NZ;
      int q = idx % NZ;
      int vn = q / p.Z;
      int zv = q % p.Z;
      const float* mw = msg_s + w * EZ;
      int e0 = __ldg(vn_ptr + vn), e1 = __ldg(vn_ptr + vn + 1);
      float acc = 0.0f;
      for (int e = e0; e < e1; ++e) {
        int k = __ldg(vn_list + e);
        int z = zv - __ldg(e_shift + k);
        if (z < 0) z += p.Z;
        float m = mw[k * p.Z + z];
        acc = (e == e0) ? m : acc + m;
      }
      sums_s[idx] = acc;
      if (last) {
        long long gw = word0 + w;
        if (gw < p.B) p.out[gw * NZ + q] = chan_out(chan_s[idx], p) + acc;
      }
    }
    __syncthreads();
  }
}

template <int MAXD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int threads = ((p.wpb * p.M * p.Z + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (size_t)p.wpb * (2 * p.N * p.Z + p.E * p.Z);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_fwd_k1a_kernel<MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((p.B + p.wpb - 1) / p.wpb);
  fused_fwd_k1a_kernel<MAXD><<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_fwd_k1a_launch(
    const float* chan, float* out, const int* tables, const float* cnw,
    const float* ucnw, const float* vnw, int B, int N, int M, int Z, int E,
    int I, int max_deg, int wpb, int flags, float clip_lo, float clip_hi,
    float q_lo, float q_hi, float q_scale, void* stream) {
  Params p{chan, out, tables, cnw, ucnw, vnw, B, N, M, Z, E, I, wpb, flags,
           clip_lo, clip_hi, q_lo, q_hi, q_scale, 1.0f / q_scale};
  if (B <= 0) return (int)cudaSuccess;
  if (wpb * M * Z > 1024) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (max_deg <= 16) return (int)launch<16>(p, s);
  if (max_deg <= 32) return (int)launch<32>(p, s);
  return (int)cudaErrorInvalidValue;
}
