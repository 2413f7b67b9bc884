// Tensor-core routing shared by the matmul-routed kernels: the legacy decode
// (K5, fused_legacy.cu) and the matmul branches of the on-chip forward and
// backward (K6, fused_fwd.cu and fused_bwd.cu).
//
// Replaces the one-hot routing products of the TPU kernels
// (neural_ldpc_tpu/ops/pallas/minsum.py::_kernel, Rt @ x and R @ msg;
// neural_ldpc_tpu/ops/pallas/fused_train.py::_route_e_rows, _route_n_from_e
// and _dot_split3): VN-side values [N*Z] go to the edge copies [E*Z] through
// Rt, and edge-side messages are summed per VN copy through R = Rt^T, each
// product on the matrix unit.  Here each product is a hand-written
// mma.sync.m16n8k16 (bf16 x bf16 -> f32, or s8 x s8 -> s32) over the
// operand's nonzero Z x Z blocks only: block (edge k, VN vn(k)) of Rt is the
// cyclic shift zi = (zo + shift_k) mod Z, so its A fragments are formed in
// registers from e_shift and no operand is stored, and the zero blocks, which
// would add exact zeros to every sum, are skipped.  A block's rows and
// columns are cut into 16-row tiles (the last one masked past Z) and the
// words into the mma's 8 columns (masked past the block's words, so a block
// of fewer than 8 words pads the product).  A dense operand would cost E*Z x
// N*Z per product instead of E*Z x Z (wman: 24x, BG2: 52x more tensor work).
//
// Exactness.  Each product of one block has a single 1 per row, so it yields
// one input value exactly (every other term is an exact zero).  Sums over a
// VN copy's several edges are therefore taken on the CUDA cores in the order
// of vn_list (increasing original edge id), so that they equal the plain
// PyTorch versions' float sums term for term: the tensor core's own
// accumulation order and rounding never reach a float result.  Integer sums
// (s8 x s8 -> s32) are exact in any order and stay in the accumulator.
//
// Modes, what a routed value becomes (TPU semantics in brackets):
//   kInt8    values: s8 = rint(clamp(x, -t, t) * scale), t = 2 q_hi, the
//            result s32 * (1 / scale) [int8 routing of QMS; the pre-clip is
//            value-exact because the quantizer saturates beyond it]; sums:
//            s8 = rint(m * scale), s32 sums * (1 / scale)
//   kBf16    x rounded to bf16 [routing_dtype bf16: the legacy engine's
//            values and messages, the int8 mode's cotangents]; sums of the
//            bf16 terms in f32
//   kSplit3  x = hi + mid + lo, three bf16 products [_dot_split3]: routed
//            values exact; sums (S_hi + S_mid) + S_lo over the three parts
//   kExact   values as kSplit3; sums of the exact terms in f32 [f32 routing]
//
// Bound: the products are a few percent of the kernels' work (block-sparse,
// 2 E Z^2 multiply-adds per product and word at 989e12 bf16 / 1979e12 int8
// operations per second); forming the B fragments from shared memory and the
// CUDA-core sums cost more.  Simple and right, not tuned: no ldmatrix, no
// wgmma, operands re-formed for every edge of a VN.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mmr {

enum : int { kInt8 = 1, kBf16 = 2, kSplit3 = 3, kExact = 4 };

// routing bits of the on-chip kernels' flags (above bp_common.cuh's)
enum : int {
  kRouteInt8 = 1 << 12,    // K6 with int8 routing (QMS)
  kRouteSplit3 = 1 << 13,  // K6 with the exact split-3 routing
  kGradF32 = 1 << 14,      // int8 routing's cotangents in f32, not bf16
};

struct Quant {
  float t, scale, inv_scale;  // kInt8: pre-clip of values, 1/grid step, its inverse
};
// kInt8 of -1/0/+1 values as they are (an int8 indicator, not a grid value)
__device__ __forceinline__ Quant unit_quant() { return Quant{1.0f, 1.0f, 1.0f}; }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// x = hi + mid + lo exactly, each a bf16 value (_split3_bf16)
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  hi = bf16_round(x);
  const float r1 = x - hi;
  mid = bf16_round(r1);
  lo = bf16_round(r1 - mid);
}

__device__ __forceinline__ uint32_t s8_quad(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xFF) | ((uint32_t)(b & 0xFF) << 8) | ((uint32_t)(c & 0xFF) << 16) |
         ((uint32_t)(d & 0xFF) << 24);
}

// 1 where in-row zi = 16 ti + c is the image of out-row zo = 16 to + r < Z
// under zo -> (zo + s) mod Z (0 <= s < Z)
__device__ __forceinline__ bool onehot(int r, int c, int to, int ti, int s, int Z) {
  const int zo = 16 * to + r;
  if (zo >= Z) return false;
  int zi = zo + s;
  if (zi >= Z) zi -= Z;
  return zi == 16 * ti + c;
}

// whether in-tile ti holds the image of some row of out-tile ``to``
__device__ __forceinline__ bool tile_hit(int to, int ti, int s, int Z) {
  const int lo = 16 * to, n = min(16, Z - lo);
  const int a = (lo + s) % Z;  // the images are [a, a + n - 1] modulo Z
  const int t0 = 16 * ti, t1 = t0 + 15;
  if (a <= t1 && min(a + n - 1, Z - 1) >= t0) return true;
  return a + n - 1 >= Z && a + n - 1 - Z >= t0;
}

// A fragments of the one-hot tile (m16n8k16: lane g = lane / 4, t = lane % 4)
__device__ __forceinline__ void a_bf16(uint32_t (&a)[4], int g, int t, int to, int ti, int s,
                                       int Z) {
  const uint32_t one = 0x3F80u;  // bf16 1.0
  auto pair = [&](int r, int c) {
    return (onehot(r, c, to, ti, s, Z) ? one : 0u) |
           (onehot(r, c + 1, to, ti, s, Z) ? one << 16 : 0u);
  };
  a[0] = pair(g, 2 * t);
  a[1] = pair(g + 8, 2 * t);
  a[2] = pair(g, 2 * t + 8);
  a[3] = pair(g + 8, 2 * t + 8);
}

__device__ __forceinline__ void a_s8(uint32_t (&a)[2], int g, int t, int to, int ti, int s,
                                     int Z) {
  auto quad = [&](int r) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (onehot(r, 4 * t + i, to, ti, s, Z)) v |= 1u << (8 * i);
    return v;
  };
  a[0] = quad(g);
  a[1] = quad(g + 8);
}

// d += a b on the tensor cores
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Calls body(outer, to, wt) for the units (block, row tile, word tile) of
// this warp; every lane of a warp takes the same units, as mma.sync needs.
template <class F>
__device__ __forceinline__ void for_units(int outer, int Z, int W, F body) {
  const int Zt = (Z + 15) >> 4, Wt = (W + 7) >> 3, per = Zt * Wt;
  const int nwarps = blockDim.x >> 5;
  for (int u = threadIdx.x >> 5; u < outer * per; u += nwarps)
    body(u / per, (u % per) / Wt, u % Wt);
}

// Calls f(i, row, w) for this lane's D cells i of unit (to, wt) that hold a
// row < Z of a word < W.
template <class F>
__device__ __forceinline__ void for_cells(int to, int wt, int Z, int W, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 16 * to + g + 8 * (i >> 1), w = 8 * wt + 2 * t + (i & 1);
    if (row < Z && w < W) f(i, row, w);
  }
}

// One product of a block with shift s into out-tile ``to`` of word tile wt:
// the routed values at this lane's D cells.  ``val(w, zi)`` is the input
// value of in-row zi < Z of local word w < W.  MODE kInt8 quantizes with
// ``q``, clamping at +-q.t when ``clamp`` is set (values), not otherwise
// (messages on the grid); kBf16 rounds to bf16; kExact routes the three
// bf16 parts and returns (hi + mid) + lo = the value.  A product's rows hold
// one input each, so the tiles chain in the accumulator exactly.
template <int MODE, class Val>
__device__ __forceinline__ void block_product(float (&out)[4], int s, int to, int wt, int Z, int W,
                                              const Quant& q, bool clamp, Val val) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int Zt = (Z + 15) >> 4, w = 8 * wt + g;  // the word of this lane's B column
  auto x = [&](int zi) { return (zi < Z && w < W) ? val(w, zi) : 0.0f; };
  if constexpr (MODE == kInt8) {
    int acc[4] = {0, 0, 0, 0};
    auto s8 = [&](int zi) {
      float v = x(zi);
      if (clamp) v = fminf(fmaxf(v, -q.t), q.t);
      return (int)rintf(v * q.scale);
    };
    for (int ti = 0; ti < Zt; ++ti) {
      if (!tile_hit(to, ti, s, Z)) continue;
      uint32_t a[2];
      a_s8(a, g, t, to, ti, s, Z);
      const int r = 16 * ti + 4 * t;
      mma_s8(acc, a, s8_quad(s8(r), s8(r + 1), s8(r + 2), s8(r + 3)));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (float)acc[i] * q.inv_scale;
  } else if constexpr (MODE == kBf16) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int ti = 0; ti < Zt; ++ti) {
      if (!tile_hit(to, ti, s, Z)) continue;
      uint32_t a[4];
      a_bf16(a, g, t, to, ti, s, Z);
      const int r = 16 * ti + 2 * t;
      mma_bf16(acc, a, bf16_pair(x(r), x(r + 1)), bf16_pair(x(r + 8), x(r + 9)));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = acc[i];
  } else {
    static_assert(MODE == kExact, "block_product: kInt8, kBf16 or kExact");
    float hi[4] = {0.0f, 0.0f, 0.0f, 0.0f}, mid[4] = {0.0f, 0.0f, 0.0f, 0.0f},
          lo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int ti = 0; ti < Zt; ++ti) {
      if (!tile_hit(to, ti, s, Z)) continue;
      uint32_t a[4];
      a_bf16(a, g, t, to, ti, s, Z);
      const int r = 16 * ti + 2 * t;
      float h[4], m[4], l[4];
      split3(x(r), h[0], m[0], l[0]);
      split3(x(r + 1), h[1], m[1], l[1]);
      split3(x(r + 8), h[2], m[2], l[2]);
      split3(x(r + 9), h[3], m[3], l[3]);
      mma_bf16(hi, a, bf16_pair(h[0], h[1]), bf16_pair(h[2], h[3]));
      mma_bf16(mid, a, bf16_pair(m[0], m[1]), bf16_pair(m[2], m[3]));
      mma_bf16(lo, a, bf16_pair(l[0], l[1]), bf16_pair(l[2], l[3]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (hi[i] + mid[i]) + lo[i];
  }
}

// VN-side values to the edge copies of an edge block (shift ``s``):
// ``val(w, zi)`` is the value of copy zi of the edge's VN in word w; out[i]
// is the routed value at for_cells' cell i (edge copy row, word w).
template <int MODE, class Val>
__device__ __forceinline__ void to_edges(float (&out)[4], int s, int to, int wt, int Z, int W,
                                         const Quant& q, Val val) {
  block_product<MODE == kSplit3 ? kExact : MODE>(out, s, to, wt, Z, W, q, true, val);
}

// Per-VN-copy sums of out-tile ``to`` over the VN's edges k = vn_list[e] for
// e in [e0, e1), in that order; ``val(w, k, z)`` is the value of edge copy
// k*Z + z of word w.  Zero for a VN without edges.
template <int MODE, class Val>
__device__ __forceinline__ void to_vns(float (&out)[4], int e0, int e1, const int* vn_list,
                                       const int* e_shift, int to, int wt, int Z, int W,
                                       const Quant& q, Val val) {
  if constexpr (MODE == kInt8) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int Zt = (Z + 15) >> 4, w = 8 * wt + g;
    int acc[4] = {0, 0, 0, 0};  // exact integer sums: any order
    for (int e = e0; e < e1; ++e) {
      const int k = __ldg(vn_list + e), sh = __ldg(e_shift + k), s = sh ? Z - sh : 0;
      auto s8 = [&](int z) { return (z < Z && w < W) ? (int)rintf(val(w, k, z) * q.scale) : 0; };
      for (int ti = 0; ti < Zt; ++ti) {
        if (!tile_hit(to, ti, s, Z)) continue;
        uint32_t a[2];
        a_s8(a, g, t, to, ti, s, Z);
        const int r = 16 * ti + 4 * t;
        mma_s8(acc, a, s8_quad(s8(r), s8(r + 1), s8(r + 2), s8(r + 3)));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (float)acc[i] * q.inv_scale;
  } else {
    // float sums in vn_list order, the first term as it is (gather_sum's
    // order); kSplit3 keeps one sum per bf16 part
    constexpr int parts = (MODE == kSplit3) ? 3 : 1;
    float sum[parts][4];
    for (int e = e0; e < e1; ++e) {
      const int k = __ldg(vn_list + e), sh = __ldg(e_shift + k), s = sh ? Z - sh : 0;
#pragma unroll
      for (int part = 0; part < parts; ++part) {
        float d[4];
        if constexpr (MODE == kSplit3) {
          block_product<kBf16>(d, s, to, wt, Z, W, q, false, [&](int ww, int z) {
            float h, m, l;
            split3(val(ww, k, z), h, m, l);
            return part == 0 ? h : (part == 1 ? m : l);
          });
        } else {
          block_product<MODE>(d, s, to, wt, Z, W, q, false,
                              [&](int ww, int z) { return val(ww, k, z); });
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[part][i] = (e == e0) ? d[i] : sum[part][i] + d[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (e1 == e0) out[i] = 0.0f;
      else if constexpr (MODE == kSplit3) out[i] = (sum[0][i] + sum[1][i]) + sum[2][i];
      else out[i] = sum[0][i];
    }
  }
}

}  // namespace mmr
