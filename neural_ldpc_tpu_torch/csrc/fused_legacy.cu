// Legacy single-launch BP decode for NVIDIA Hopper (sm_90a): K5.
//
// Replaces the TPU kernel neural_ldpc_tpu/ops/pallas/minsum.py::_kernel, the
// round-1 decode engine (engine="legacy"): one launch, a loop over the
// iterations inside it, checks in their natural row_ptr order, the VN <->
// edge routing as one-hot products on the matrix unit, and the final APP.
// Per word and iteration i:
//   1. xa       = Q(chan * vn_w[i]) under QMS, chan * vn_w[i] otherwise
//                 (chan_out = Q(chan) or chan)
//   2. UCN      = parity of the routed decision signs of app, app = xa at
//                 i = 0 and clip(chan_out + sums) after that
//   3. routed   = Rt x with x = bf16(xa + sums) (routing_dtype bf16, the
//                 default), xa + sums (float32), or, with int8 routing (QMS),
//                 rint(clip(xa + sums, +-2 q_hi) * scale) in int8 and the
//                 int32 result * (1 / scale)
//   4. v2c      = clip_or_quant(routed - msg); c2v the extrinsic two-min or
//                 sum-product; msg = clip_or_quant(relu(|c2v| * w)) * sign(c2v)
//   5. sums     = R msg: the bf16-rounded messages summed in f32, the f32
//                 messages, or rint(msg * scale) in int8 summed in int32 and
//                 * (1 / scale)
// and writes the pre-clip APP chan_out + sums.  The roundings of steps 3 and
// 5 make bf16 legacy MS another function than the stream engine's.
//
// Design.  A block owns W whole words: 8, the mma's column count, or fewer
// where 8 words' state would not fit the 227 KB of shared memory.  Their
// channel, VN sums and messages live in shared memory for all iterations,
// so device memory sees one read of the channel and one write of the APP per
// word.  Threads are decoupled from checks: each takes (word, lifted check)
// pairs in turn, reads the check's routed values from the message array,
// and writes its new messages back in place.  The two routing products run
// on the tensor cores over the operand's nonzero blocks (mm_route.cuh); a
// VN copy's sum adds its edges in vn_list order (increasing edge id) on the
// CUDA cores, so the float results equal the plain PyTorch version
// legacy_plain term for term.  Steps 1, 2 and 4 are bp_common.cuh's.
//
// Bound on this card: device-memory bytes are 2 * N*Z * 4 per word; the
// fp32 work of the check updates (~20-40 instructions per edge copy and
// iteration at 33.5e12 per second) is the larger bound; the routing products
// add 2 * 2 E Z^2 tensor-core operations per word and iteration (x3 for f32
// routing), a few percent of it at 989e12 (bf16) or 1979e12 (int8) per second.
// Simple and right, not tuned: three barriers per iteration, B fragments
// formed from shared memory element by element.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_common.cuh"
#include "mm_route.cuh"

namespace {

using namespace bp;

struct LegacyParams {
  const float* chan;  // [B, N*Z]
  float* out;         // [B, N*Z] pre-clip APP
  const int* tables;  // chk_off[M] chk_deg[M] e_vn[E] e_shift[E] vn_ptr[N+1] vn_list[E] e_chk[E], natural order
  const float* cnw;   // [I, E] (or null)
  const float* ucnw;  // [I, E] (or null)
  const float* vnw;   // [I, N] (or null)
  int B, N, M, Z, E, I, W, flags;
  float clip_lo, clip_hi, q_lo, q_hi, q_scale, q_inv_scale;
};

constexpr int kThreads = 512;

template <int MAXD, int ROUTE>
__global__ void __launch_bounds__(kThreads) fused_legacy_kernel(LegacyParams p) {
  extern __shared__ float smem[];
  const int NZ = p.N * p.Z, MZ = p.M * p.Z, EZ = p.E * p.Z, Z = p.Z, W = p.W;
  float* chan_s = smem;               // [W, NZ]
  float* sums_s = chan_s + W * NZ;    // [W, NZ]
  float* msg_s = sums_s + W * NZ;     // [W, EZ] messages; v2c during the check update
  int* ucn_s = (int*)(msg_s + W * EZ);  // [W, MZ] routed-sign parity per lifted check (UCN)

  const int* chk_off = p.tables;
  const int* chk_deg = chk_off + p.M;
  const int* e_vn = chk_deg + p.M;
  const int* e_shift = e_vn + p.E;
  const int* vn_ptr = e_shift + p.E;
  const int* vn_list = vn_ptr + p.N + 1;
  const int* e_chk = vn_list + p.E;
  const mmr::Quant q{2.0f * p.q_hi, p.q_scale, p.q_inv_scale};
  const long long word0 = (long long)blockIdx.x * W;

  // words past the batch end hold 0 and are never written back
  for (int idx = threadIdx.x; idx < W * NZ; idx += blockDim.x) {
    const long long w = word0 + idx / NZ;
    chan_s[idx] = (w < p.B) ? p.chan[w * NZ + idx % NZ] : 0.0f;
    sums_s[idx] = 0.0f;
  }
  for (int idx = threadIdx.x; idx < W * EZ; idx += blockDim.x) msg_s[idx] = 0.0f;

  // value(w, VN copy) through Rt to every edge copy: sink(w, k, row, routed)
  auto route = [&](const mmr::Quant& qq, auto value, auto sink) {
    mmr::for_units(p.E, Z, W, [&](int k, int to, int wt) {
      const int vn = __ldg(e_vn + k);
      float r[4];
      mmr::to_edges<ROUTE>(r, __ldg(e_shift + k), to, wt, Z, W, qq,
                           [&](int w, int zi) { return value(w, vn * Z + zi); });
      mmr::for_cells(to, wt, Z, W, [&](int i, int row, int w) { sink(w, k, row, r[i]); });
    });
  };

  for (int it = 0; it < p.I; ++it) {
    if (p.flags & kUcn) {
      for (int idx = threadIdx.x; idx < W * MZ; idx += blockDim.x) ucn_s[idx] = 0;
    }
    __syncthreads();
    if (p.flags & kUcn) {
      // the decision signs, as int8 -1/+1 with int8 routing (dsign.astype(int8))
      route(mmr::unit_quant(),
            [&](int w, int qv) {
              const float c = chan_s[w * NZ + qv];
              const float app = (it == 0) ? chan_in(c, qv / Z, it, p)
                  : fminf(fmaxf(chan_out(c, p) + sums_s[w * NZ + qv], p.clip_lo), p.clip_hi);
              return app < 0.0f ? -1.0f : 1.0f;
            },
            [&](int w, int k, int row, float r) {
              if (r < 0.0f) atomicXor(ucn_s + w * MZ + __ldg(e_chk + k) * Z + row, 1);
            });
    }
    route(q, [&](int w, int qv) { return chan_in(chan_s[w * NZ + qv], qv / Z, it, p) + sums_s[w * NZ + qv]; },
          [&](int w, int k, int row, float r) {
            float* m = msg_s + w * EZ + k * Z + row;
            *m = clip_or_quant(r - *m, p);  // v2c over the message it replaces
          });
    __syncthreads();

    // ---------------- check update: (word, lifted check) pairs in turn ----------------
    for (int idx = threadIdx.x; idx < W * MZ; idx += blockDim.x) {
      const int w = idx / MZ, r = idx % MZ, c = r / Z, zc = r % Z;
      const int k0 = __ldg(chk_off + c), d = __ldg(chk_deg + c);
      float* mw = msg_s + w * EZ + zc;
      float v[MAXD];
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < d) v[j] = mw[(k0 + j) * Z];
      check_update<MAXD>(v, d, p.flags & kSumProduct);
      const float* wrow = nullptr;
      if (p.flags & (kCnW | kUcn))
        wrow = (((p.flags & kUcn) && ucn_s[idx]) ? p.ucnw : p.cnw) + (size_t)it * p.E + k0;
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < d) mw[(k0 + j) * Z] = post_chain(v[j], wrow ? wrow + j : nullptr, p);
    }
    __syncthreads();

    // ---------------- VN sums through R ----------------
    mmr::for_units(p.N, Z, W, [&](int n, int to, int wt) {
      float r[4];
      mmr::to_vns<ROUTE>(r, __ldg(vn_ptr + n), __ldg(vn_ptr + n + 1), vn_list, e_shift, to, wt, Z,
                         W, q, [&](int w, int k, int z) { return msg_s[w * EZ + k * Z + z]; });
      mmr::for_cells(to, wt, Z, W, [&](int i, int row, int w) { sums_s[w * NZ + n * Z + row] = r[i]; });
    });
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < W * NZ; idx += blockDim.x) {
    const long long w = word0 + idx / NZ;
    if (w < p.B) p.out[w * NZ + idx % NZ] = chan_out(chan_s[idx], p) + sums_s[idx];
  }
}

template <int MAXD, int ROUTE>
cudaError_t launch(const LegacyParams& p, cudaStream_t stream, int* launched) {
  const size_t smem = 4 * (size_t)p.W *
      (2 * p.N * p.Z + p.E * p.Z + ((p.flags & kUcn) ? p.M * p.Z : 0));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_legacy_kernel<MAXD, ROUTE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((p.B + p.W - 1) / p.W);
  fused_legacy_kernel<MAXD, ROUTE><<<blocks, kThreads, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <int ROUTE>
cudaError_t launch_route(const LegacyParams& p, int max_deg, cudaStream_t s, int* launched) {
  if (max_deg <= 16) return launch<16, ROUTE>(p, s, launched);
  if (max_deg <= 32) return launch<32, ROUTE>(p, s, launched);
  return cudaErrorInvalidValue;
}

}  // namespace

// One launch of the legacy decode over B words, W per block, added to
// ``*launched``.  ``route``: 1 int8 (QMS), 2 bf16, 4 float32 (mm_route.cuh's
// kInt8, kBf16, kExact).  Weight pointers the flags do not use may be null.
// Returns a cudaError_t.
extern "C" int fused_legacy_launch(
    const float* chan, float* out, const int* tables, const float* cnw, const float* ucnw,
    const float* vnw, int B, int N, int M, int Z, int E, int I, int max_deg, int W, int flags,
    int route, float clip_lo, float clip_hi, float q_lo, float q_hi, float q_scale, void* stream,
    int* launched) {
  LegacyParams p{chan, out, tables, cnw, ucnw, vnw, B, N, M, Z, E, I, W, flags,
                 clip_lo, clip_hi, q_lo, q_hi, q_scale, 1.0f / q_scale};
  if (B <= 0) return (int)cudaSuccess;
  if (W < 1 || W > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (route) {
    case mmr::kInt8: return (int)launch_route<mmr::kInt8>(p, max_deg, s, launched);
    case mmr::kBf16: return (int)launch_route<mmr::kBf16>(p, max_deg, s, launched);
    case mmr::kExact: return (int)launch_route<mmr::kExact>(p, max_deg, s, launched);
    default: return (int)cudaErrorInvalidValue;
  }
}
