// Block-level helpers of the on-chip kernels whose blocks hold W whole
// words in shared memory (fused_fwd.cu, the forward; fused_bwd.cu, the
// backward): the item walk, 16-byte shared-memory rows and the VN sums of
// message rows in the VN's frame, with the routings' roundings.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "bp_common.cuh"

namespace bp {

// Walks the items (a, b, c) of [0, na) x [0, nb) x [0, nc), c fastest, with
// stride blockDim.x from this thread, without dividing inside the loop.
struct Walk {
  int a, b, c, da, db, dc, na, nb, nc;
  __device__ __forceinline__ bool ok() const { return a < na; }
  __device__ __forceinline__ void next() {
    c += dc;
    int carry = c >= nc;
    if (carry) c -= nc;
    b += db + carry;
    carry = b >= nb;
    if (carry) b -= nb;
    a += da + carry;
  }
};

__device__ __forceinline__ Walk walk(int na, int nb, int nc) {
  const int t = threadIdx.x, T = blockDim.x;
  return Walk{t / (nb * nc), (t / nc) % nb, t % nc, T / (nb * nc), (T / nc) % nb, T % nc,
              na, nb, nc};
}

template <int VEC>
__device__ __forceinline__ void lds(const float* a, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(a);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = *a;
  }
}

template <int VEC>
__device__ __forceinline__ void sts(float* a, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(a) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *a = v[0];
  }
}

// Per VN copy of VN slot entry ``vn`` at lifts 4g..4g+VEC-1 (VEC g with 1),
// the messages of edges e0..e1-1 (rows ``row``) summed in that order as the
// routing adds them.
template <int VEC, int ROUTE, class P>
__device__ __forceinline__ void vn_sums(const P& p, const int* row, const float* msg,
                                        int e0, int e1, int zoff, float (&acc)[VEC]) {
  if constexpr (int8_values(ROUTE)) {
    // int8_to_vns: rint(m * scale) summed exactly, then * (1 / scale)
    int s8[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) s8[u] = 0;
    for (int e = e0; e < e1; ++e) {
      float m[VEC];
      lds<VEC>(msg + row[e] + zoff, m);
#pragma unroll
      for (int u = 0; u < VEC; ++u) s8[u] += (int)rintf(m[u] * p.q_scale);
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = (float)s8[u] * p.q_inv_scale;
  } else if constexpr (ROUTE == kSplit3) {
    // _dot_split3: one sum per bf16 part, then (S_hi + S_mid) + S_lo
    float hi[VEC], mid[VEC], lo[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0.0f;
    if (e1 <= e0) return;
    {
      float m[VEC];
      lds<VEC>(msg + row[e0] + zoff, m);
#pragma unroll
      for (int u = 0; u < VEC; ++u) split3(m[u], hi[u], mid[u], lo[u]);
    }
    for (int e = e0 + 1; e < e1; ++e) {
      float m[VEC];
      lds<VEC>(msg + row[e] + zoff, m);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        float h, md, l;
        split3(m[u], h, md, l);
        hi[u] = hi[u] + h;
        mid[u] = mid[u] + md;
        lo[u] = lo[u] + l;
      }
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = (hi[u] + mid[u]) + lo[u];
  } else if constexpr (ROUTE == kBf16) {
    // the legacy engine's bf16 routing: each message rounded to bf16, the
    // sum in f32 from its first term
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0.0f;
    if (e1 <= e0) return;
    lds<VEC>(msg + row[e0] + zoff, acc);
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = bf16_round(acc[u]);
#pragma unroll 4
    for (int e = e0 + 1; e < e1; ++e) {
      float m[VEC];
      lds<VEC>(msg + row[e] + zoff, m);
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[u] = acc[u] + bf16_round(m[u]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0.0f;
    if (e1 <= e0) return;
    lds<VEC>(msg + row[e0] + zoff, acc);
    int e = e0 + 1;
    for (; e + 4 <= e1; e += 4) {
      float m[4][VEC];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds<VEC>(msg + row[e + i] + zoff, m[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < VEC; ++u) acc[u] = acc[u] + m[i][u];
    }
    for (; e < e1; ++e) {
      float m[VEC];
      lds<VEC>(msg + row[e] + zoff, m);
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[u] = acc[u] + m[u];
    }
  }
}

}  // namespace bp
