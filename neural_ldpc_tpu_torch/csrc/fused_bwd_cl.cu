// Backward BP for NVIDIA Hopper (sm_90a) with a word's whole adjoint state in
// the shared memory of one thread-block cluster: K4 for every big code whose
// backward a cluster of at most 8 CTAs holds.
//
// Replaces the TPU kernel neural_ldpc_tpu/ops/pallas/fused_train.py::
// _bwd_kernel_hbm (launcher _bwd_run_hbm :1843, pallas_call :1856; "K4"): roll
// routing, MS / QMS / SP, CN, UCN and VN weights, the adjoint of
// fused_fwd_cl.cu's training forward (kStream | kStore).  One cluster of C
// CTAs (C the smallest that holds the word, ops/cuda/fused_train.py::
// bwd_cluster_plan) runs one word's whole backward, all I iterations, in one
// launch; the word index is the cluster's index.  fused_bwd_dm.cu, the state
// in device memory, takes the words no cluster holds.
//
// The split (built once per layout in Python, bwd_cluster_split, passed as
// one table).  Rank r owns the sorted base checks [chk_b[r], chk_b[r+1]) with
// all their lifts, i.e. the permuted edges [k_b[r], k_b[r+1]), and keeps in
// its shared memory (4-byte words):
//   rows [0, MZ)          its edges' rows in the VN's frame: edge k's value
//                         of lifted check zc at (k - k_b[r]) * Z + (zc +
//                         shift_k) mod Z, the lift of the VN copy it meets.
//                         It holds store slot i-1 (the messages entering
//                         iteration i), then, after phase A, each edge copy's
//                         weight-gradient term;
//   carry [MZ, 2MZ)       the message cotangent carry gmsg, in the same frame;
//   totals [2MZ, +RZ)     a replica of chan_in + sums_{i-1} of every VN its
//                         checks touch (slot * Z + zv);
//   gsums [+RZ, +2RZ)     a replica of the sums cotangent at those VNs;
//   with kUcn [+2RZ, +3RZ) a replica of the clipped APP of iteration i-1;
//   accumulators          for the base VNs [wv_b[r], wv_b[r+1]) it works on
//                         (WZ words each): the cotangent of chan_out (g_chanq
//                         under QMS, else g_chan); under QMS with VN weights
//                         also g_chan; with VN weights the VN-weight terms;
//   with kUcn             a UCN flag byte per lifted check of its range;
//   the table.
// The channel, g_outs and (with UCN) outs stay in device memory, read once a
// VN copy and iteration in the VN phase, the store once a slot.
//
// One launch of 1,024 threads a CTA.  Setup zeroes the carry and the
// accumulators and loads slot I-2; a VN phase runs B0 of iteration I-1.
// Then per iteration i = I-1 .. 0:
//   A        each thread takes lifted checks of its rank (the smallest of
//            eight instantiations, 4 ... 32 slots, that holds the degree,
//            loads first): v2c = totals - rows (0 at i = 0) from its own
//            shared memory, UCN from the APP replica, then the check's
//            adjoint as bp_common.cuh's check_adjoint computes it (the same
//            operations in the same order, with the edges' values behind the
//            frame's addresses); the new carry goes back in place and each
//            edge copy's weight term over its slot i-1 row;
//   reduce   a warp per edge sums its Z weight terms (by UCN flag) in a
//            fixed order into the word's partial [B, I, E];
//   load     slot i-2 (i >= 2) into the rows: each row Z contiguous floats
//            from the store (K3 wrote it in the permuted flat-edge order
//            k*Z + zc), rotated by the edge's shift;
//   cluster sync;
//   VN phase each thread takes 4 consecutive lifts of a VN of its work range
//            (1 where Z % 4 != 0).  B1 of iteration i: g_T = -(the carry rows
//            summed in vn_list order, 16-byte ld.shared::cluster reads), the
//            channel-side gradients through the VN weight and the QMS input
//            quantizer, into the accumulators.  Then B0 of iteration i-1:
//            g_outs[i-1] joins g_T (the next sums cotangent) and the
//            accumulator; sums_{i-2} from slot i-2's rows in vn_list order;
//            chan_in + sums_{i-2}, the sums cotangent and (UCN) the clipped
//            outs[i-2] go to every rank that needs the VN with 16-byte
//            st.shared::cluster.  At i = 0 the accumulators go to g_chan
//            (and g_chanq) instead; with VN weights a warp per VN sums its
//            terms into the word's partial [B, I, N];
//   cluster sync.
// The first sync of an iteration orders phase A's carry writes and the
// slot's rows before the VN phase reads them remotely, and the replica reads
// of phase A before the VN phase overwrites them; the second orders the
// replica pushes before the next phase A and the carry reads before it
// overwrites the carry.  So one buffer of each suffices, and the sums
// cotangent needs no copy beyond the replicas: B1 and the next B0 run in one
// VN phase on the same values.
//
// Every float operation is the one fused_bwd_dm.cu performs, in the same
// order (sums in vn_list order from their first term, g_outs added as
// gsums + g before phase A reads it, -fmad=false, JAX's ties): the channel
// gradients equal fused_bwd_dm.cu's, K2's and fused_bwd_dm_plain's bit for
// bit.  No float atomics: each cluster writes its word's weight partials,
// which the wrapper sums over words in a fixed order, so the weight
// gradients are the same on every run; they differ from fused_bwd_dm.cu's
// chunked sums by their order.
//
// Bound on this card: the bytes a backward must move are the reads of the
// channel, the store ((I-1) * E*Z * 4 per word), g_outs (I * N*Z * 4) and,
// with UCN, outs, and the writes of g_chan (and g_chanq) and the partials;
// the operations (recompute plus adjoint) are about three times the
// forward's per edge and iteration.  fused_bwd_dm.cu moved ~3 MB a word and
// iteration through its device-memory carries in 4 launches an iteration;
// here the carries never leave the chip, one launch does every iteration,
// and distributed shared memory moves only 16-byte rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bp_common.cuh"

namespace {

using namespace bp;

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kSmemOptin = 232448;
constexpr int kThreads = 1024;  // one CTA an SM: its shared memory is the word's

struct Params {
  const float* chan;    // [B, N*Z]
  const float* store;   // [max(I-1, 1), B, E*Z]: slot i-1 = state entering iteration i
  const float* outs;    // [I, B, N*Z] pre-clip APP (read with UCN)
  const float* g_outs;  // [I, B, N*Z]
  const int* tab;       // the split's table (ops/cuda/fused_train.py::bwd_cluster_split)
  const float* cnw;     // [I, E] in permuted edge order (or null)
  const float* ucnw;    // [I, E] (or null)
  const float* vnw;     // [I, N] (or null)
  float* g_chan;        // [B, N*Z]: written unless QMS without VN weights
  float* g_chanq;       // [B, N*Z] (QMS)
  float* g_cnw_part;    // [B, I, E] (or null)
  float* g_ucnw_part;   // [B, I, E] (or null)
  float* g_vnw_part;   // [B, I, N] (or null)
  long long* prof;      // null, or [C, 5 I + 2] clock64 stamps of word 0's ranks
  long long B;
  int N, M, Z, E, I, flags;
  int C, MZ, RZ, WZ, FZ, NN, TAB;  // cluster size, region sizes, need entries, table ints
  float clip_lo, clip_hi, q_lo, q_hi, q_scale, q_inv_scale;
};

// Offsets (4-byte words) of the regions after the replicas, as
// bwd_cluster_split's smem_bytes counts them.
struct Lay {
  int acc;   // the cotangent of chan_out
  int gc;    // g_chan under QMS with VN weights (else == acc)
  int vt;    // the VN-weight terms (VN weights)
  int nacc;  // accumulator regions
  int flag;  // UCN flag bytes
  int tab;
};

__device__ __forceinline__ Lay lay_of(const Params& p) {
  const bool ucn = p.flags & kUcn, vnw = p.flags & kVnW, qms = p.flags & kQms;
  Lay L;
  L.acc = 2 * p.MZ + (ucn ? 3 : 2) * p.RZ;
  L.gc = (qms && vnw) ? L.acc + p.WZ : L.acc;
  L.vt = L.gc + p.WZ;
  L.nacc = 1 + ((qms && vnw) ? 1 : 0) + (vnw ? 1 : 0);
  L.flag = L.acc + L.nacc * p.WZ;
  L.tab = L.flag + (ucn ? (p.FZ + 3) / 4 : 0);
  return L;
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// the shared::cluster address of shared::cta address ``a`` in CTA ``rank``
__device__ __forceinline__ uint32_t map_rank(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

template <int VEC>
__device__ __forceinline__ void ld_cluster(uint32_t a, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(a));
  } else {
    asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v[0]) : "r"(a));
  }
}

template <int VEC>
__device__ __forceinline__ void st_cluster(uint32_t a, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a), "f"(v[0]),
                 "f"(v[1]), "f"(v[2]), "f"(v[3]) : "memory");
  } else {
    asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v[0]) : "memory");
  }
}

// every thread of every CTA of the cluster; release / acquire order the
// shared-memory accesses before it against those after it, cluster-wide
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// VEC consecutive floats from device memory (16-byte aligned where VEC = 4);
// ``stream``: read once, kept out of L1 and first to leave L2
template <int VEC, bool STREAM>
__device__ __forceinline__ void ld_global(const float* a, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = STREAM ? __ldcs(reinterpret_cast<const float4*>(a))
                            : __ldg(reinterpret_cast<const float4*>(a));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = STREAM ? __ldcs(a) : __ldg(a);
  }
}

template <int VEC>
__device__ __forceinline__ void st_global(float* a, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(a) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    a[0] = v[0];
  }
}

// The table, as bwd_cluster_split lays it out:
//   chk_b[C+1] wv_b[C+1] k_b[C+1] chk_k0[M] chk_d[M] e_at[E] e_wrap[E]
//   e_chk[E] vn_ptr[N+1] l_loc[E] need_ptr[N+1] need_loc[NN]
// For edge k with shift s on its rank: e_at = (totals replica offset of its
// VN, 2 MZ included, + s) | (its row's offset + s) << 16 and e_wrap = Z - s,
// so that lifted check zc reaches both at + zc - (zc >= e_wrap ? Z : 0);
// e_chk its sorted check.  l_loc (the row of vn_list entry e) and need_loc
// (a totals replica slot of a VN) hold owner << 24 | offset and become
// shared::cluster addresses.
struct Tab {
  const int *chk_b, *wv_b, *k_b, *chk_k0, *chk_d, *e_wrap, *e_chk, *vn_ptr, *need_ptr;
  const uint32_t *e_at, *l_addr, *need_addr;
};

__device__ __forceinline__ Tab tab_view(const int* t, const Params& p) {
  Tab v;
  const int C1 = p.C + 1;
  v.chk_b = t;
  v.wv_b = t + C1;
  v.k_b = t + 2 * C1;
  v.chk_k0 = t + 3 * C1;
  v.chk_d = v.chk_k0 + p.M;
  v.e_at = reinterpret_cast<const uint32_t*>(v.chk_d + p.M);
  v.e_wrap = v.chk_d + p.M + p.E;
  v.e_chk = v.e_wrap + p.E;
  v.vn_ptr = v.e_chk + p.E;
  v.l_addr = reinterpret_cast<const uint32_t*>(v.vn_ptr + p.N + 1);
  v.need_ptr = v.vn_ptr + p.N + 1 + p.E;
  v.need_addr = reinterpret_cast<const uint32_t*>(v.need_ptr + p.N + 1);
  return v;
}

// Walks the items (base index b, lift z) of [b0 * L, b1 * L) with stride
// kThreads from this thread without dividing inside the loop.
struct Walk {
  int b, z, b1, db, dz, L;
  __device__ __forceinline__ bool ok() const { return b < b1; }
  __device__ __forceinline__ void next() {
    z += dz;
    b += db;
    if (z >= L) {
      z -= L;
      ++b;
    }
  }
};

__device__ __forceinline__ Walk walk(int b0, int b1, int L) {
  const int t = threadIdx.x;
  return Walk{b0 + t / L, t % L, b1, kThreads / L, kThreads % L, L};
}

// bp_common.cuh's clip_or_quant and chan_in with the QMS flag known at
// compile time (the same operations)
template <bool QMS>
__device__ __forceinline__ float cq(float x, const Params& p) {
  if constexpr (QMS) return quant(x, p);
  return fminf(fmaxf(x, p.clip_lo), p.clip_hi);
}

template <bool QMS>
__device__ __forceinline__ float ch_in(float c, int vn, int it, const Params& p) {
  if (p.flags & kVnW) {
    const float x = c * __ldg(p.vnw + (size_t)it * p.N + vn);
    if constexpr (QMS) return quant(x, p);
    return x;
  }
  if constexpr (QMS) return quant(c, p);
  return c;
}

// Rows [e0, e1) of vn_list at byte offset ``off_a`` of each row (the region
// and the lifts) summed into ``a``, and with ``two`` at ``off_b`` into ``b``,
// each in vn_list order from the first term, 16 bytes a read where VEC = 4
// (both sums' reads issued together); 0 for a VN of no edge.
template <int VEC>
__device__ __forceinline__ void row_sums(const Tab& T, int e0, int e1, uint32_t off_a,
                                         uint32_t off_b, bool two, float (&a)[VEC],
                                         float (&b)[VEC]) {
#pragma unroll
  for (int u = 0; u < VEC; ++u) a[u] = b[u] = 0.0f;
  int e = e0;
  for (; e + 4 <= e1; e += 4) {
    float ma[4][VEC], mb[4][VEC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t r = T.l_addr[e + i];
      ld_cluster<VEC>(r + off_a, ma[i]);
      if (two) ld_cluster<VEC>(r + off_b, mb[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        a[u] = (e + i == e0) ? ma[i][u] : a[u] + ma[i][u];
        if (two) b[u] = (e + i == e0) ? mb[i][u] : b[u] + mb[i][u];
      }
  }
  for (; e < e1; ++e) {
    float ma[VEC], mb[VEC];
    const uint32_t r = T.l_addr[e];
    ld_cluster<VEC>(r + off_a, ma);
    if (two) ld_cluster<VEC>(r + off_b, mb);
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      a[u] = (e == e0) ? ma[u] : a[u] + ma[u];
      if (two) b[u] = (e == e0) ? mb[u] : b[u] + mb[u];
    }
  }
}

// Store slot ``s`` of word w into this rank's rows, in the VN's frame.
template <int VEC>
__device__ __forceinline__ void load_slot(const Params& p, const Tab& T, float* sm,
                                          uint32_t rank, long long w, int s) {
  const int Z = p.Z, k_lo = T.k_b[rank];
  const float* src = p.store + ((size_t)s * p.B + w) * ((size_t)p.E * Z);
  for (Walk e = walk(k_lo, T.k_b[rank + 1], Z / VEC); e.ok(); e.next()) {
    const int zc = VEC * e.z;
    float v[VEC];
    ld_global<VEC, true>(src + (size_t)e.b * Z + zc, v);
    float* row = sm + (e.b - k_lo) * Z;
    int pos = zc + Z - T.e_wrap[e.b];  // zc + shift
    if (pos >= Z) pos -= Z;
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      row[pos] = v[u];
      if (++pos == Z) pos = 0;
    }
  }
}

// The VN phase: B1 of iteration i1 (none where i1 < 0, the setup), then B0
// of iteration i0, or where i0 < 0 the channel gradients out.
template <int VEC, bool QMS>
__device__ __forceinline__ void vn_phase(const Params& p, const Tab& T, const Lay& L, float* sm,
                                         uint32_t rank, long long w, int i1, int i0) {
  const int Z = p.Z, NZ = p.N * p.Z;
  const bool ucn = p.flags & kUcn, vnw = p.flags & kVnW;
  const bool two = QMS && vnw;  // g_chan and g_chanq both accumulate
  const int wv0 = T.wv_b[rank];
  const float* cw = p.chan + w * NZ;
  const uint32_t carry = 4u * p.MZ;  // byte offset of the carry rows from the rows
  for (Walk n = walk(wv0, T.wv_b[rank + 1], Z / VEC); n.ok(); n.next()) {
    const int e0 = T.vn_ptr[n.b], e1 = T.vn_ptr[n.b + 1];
    const uint32_t zoff = 4u * VEC * n.z;
    const int q = n.b * Z + VEC * n.z;
    const int a = (n.b - wv0) * Z + VEC * n.z;  // in each accumulator region
    // the device-memory reads first, then the rows: g_T from the carry (B1),
    // sums_{i0-1} from slot i0-1 (B0)
    float ch[VEC], g[VEC], app[VEC], gsum[VEC], ssum[VEC];
    ld_global<VEC, false>(cw + q, ch);
    if (i0 >= 0) ld_global<VEC, true>(p.g_outs + ((size_t)i0 * p.B + w) * NZ + q, g);
    if (ucn && i0 >= 1) ld_global<VEC, true>(p.outs + ((size_t)(i0 - 1) * p.B + w) * NZ + q, app);
    if (i1 >= 0) {
      row_sums<VEC>(T, e0, e1, carry + zoff, zoff, i0 >= 1, gsum, ssum);
    } else if (i0 >= 1) {
      row_sums<VEC>(T, e0, e1, zoff, 0, false, ssum, gsum);
    }
    float gq[VEC], gc[VEC], gT[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      gq[u] = sm[L.acc + a + u];
      gc[u] = two ? sm[L.gc + a + u] : 0.0f;
      gT[u] = 0.0f;
    }
    if (i1 >= 0) {
      // B1: g_T = sum of g_v2c_pre = -(sum of the new carry): negation is exact
#pragma unroll
      for (int u = 0; u < VEC; ++u) gT[u] = -gsum[u];
      if (vnw) {
        const float vw = __ldg(p.vnw + (size_t)i1 * p.N + n.b);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const float gxa = QMS ? gT[u] * clip_mask(ch[u] * vw, p.q_lo, p.q_hi) : gT[u];
          sm[L.vt + a + u] = gxa * ch[u];  // VN-weight term
          if (two) {
            gc[u] = gc[u] + gxa * vw;
          } else {
            gq[u] = gq[u] + gxa * vw;
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u) gq[u] = gq[u] + gT[u];  // xa_q is chan_out
      }
    }
    if (i0 < 0) {
      // the last iteration's: the channel gradients out
      st_global<VEC>((QMS ? p.g_chanq : p.g_chan) + w * NZ + q, gq);
      if (two) st_global<VEC>(p.g_chan + w * NZ + q, gc);
      continue;
    }
    // B0 of iteration i0: g_out joins the carries (out_i = chan_out + sums_i)
    float gs[VEC], tot[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      gs[u] = gT[u] + g[u];
      gq[u] = gq[u] + g[u];
      sm[L.acc + a + u] = gq[u];
      if (two) sm[L.gc + a + u] = gc[u];
      // sums_{i0-1}: 0 at i0 = 0
      tot[u] = ch_in<QMS>(ch[u], n.b, i0, p) + (i0 >= 1 ? ssum[u] : 0.0f);
    }
    if (ucn) {
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        app[u] = (i0 == 0) ? ch_in<QMS>(ch[u], n.b, 0, p)
                           : fminf(fmaxf(app[u], p.clip_lo), p.clip_hi);
    }
    for (int k = T.need_ptr[n.b]; k < T.need_ptr[n.b + 1]; ++k) {
      const uint32_t at = T.need_addr[k] + zoff;
      st_cluster<VEC>(at, tot);
      st_cluster<VEC>(at + 4u * p.RZ, gs);
      if (ucn) st_cluster<VEC>(at + 8u * p.RZ, app);
    }
  }
}

// A warp's fixed-order sum of its lanes' values (lane 0 holds the result).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + __shfl_down_sync(0xFFFFFFFFu, x, o);
  return x;
}

// Iteration ``it``'s weight terms of this rank's edges, over the rows, summed
// per edge over the Z lifts (each lane a fixed stride, then the warp's tree)
// by the UCN flag of the edge copy's lifted check.
__device__ __forceinline__ void reduce_edges(const Params& p, const Tab& T, const float* sm,
                                             const uint8_t* flags, uint32_t rank, long long w,
                                             int it) {
  const int Z = p.Z, k_lo = T.k_b[rank], c0 = T.chk_b[rank];
  const int lane = threadIdx.x & 31;
  const bool ucn = p.flags & kUcn;
  for (int k = k_lo + (int)(threadIdx.x >> 5); k < T.k_b[rank + 1]; k += kThreads / 32) {
    const float* row = sm + (k - k_lo) * Z;
    const uint8_t* fl = flags + (T.e_chk[k] - c0) * Z;
    const int s = Z - T.e_wrap[k];
    float cn = 0.0f, uc = 0.0f;
    for (int zc = lane; zc < Z; zc += 32) {
      int pos = zc + s;
      if (pos >= Z) pos -= Z;
      const float g = row[pos];
      if (ucn && fl[zc]) {
        uc = uc + g;
      } else {
        cn = cn + g;
      }
    }
    cn = warp_sum(cn);
    uc = warp_sum(uc);
    if (lane == 0) {
      const size_t o = ((size_t)w * p.I + it) * p.E + k;
      p.g_cnw_part[o] = cn;
      if (p.g_ucnw_part) p.g_ucnw_part[o] = uc;
    }
  }
}

// Iteration ``it``'s VN-weight terms of this rank's work VNs, summed per VN
// over the Z lifts in a fixed order.
__device__ __forceinline__ void reduce_vns(const Params& p, const Tab& T, const float* vt,
                                           uint32_t rank, long long w, int it) {
  const int Z = p.Z, wv0 = T.wv_b[rank];
  const int lane = threadIdx.x & 31;
  for (int n = wv0 + (int)(threadIdx.x >> 5); n < T.wv_b[rank + 1]; n += kThreads / 32) {
    float acc = 0.0f;
    for (int z = lane; z < Z; z += 32) acc = acc + vt[(n - wv0) * Z + z];
    acc = warp_sum(acc);
    if (lane == 0) p.g_vnw_part[((size_t)w * p.I + it) * p.N + n] = acc;
  }
}

// Phase A for one lifted check (sorted base check b, lift zc) of degree d <=
// D at iteration ``it``, in this rank's shared memory: bp_common.cuh's
// check_adjoint (the same operations in the same order) with edge j's values
// at its replica index ta (totals; gsums at + RZ, the APP at + 2 RZ) and its
// row index ma (slot i-1; the carry at + MZ), packed as ta | ma << 16.  Every
// load of the first pass is made for j < D (slots past d repeat edge d - 1),
// so that they issue ahead of the arithmetic; only j < d is used or
// written.  Up to 8 slots the packed indices stay in registers; above, each
// pass recomputes them from the table (two shared loads), which spills less
// at the 64 registers 1,024 threads leave a thread.
template <int D, bool QMS, bool SP>
__device__ __forceinline__ void check_bwd(const Params& p, const Tab& T, float* sm, int b, int zc,
                                          int d, int it, uint8_t* flag) {
  const int Z = p.Z, MZ = p.MZ, RZ = p.RZ, k0 = T.chk_k0[b];
  constexpr bool kHold = D <= 8;
  auto addr = [&](int k) {
    const int z = zc - (zc >= T.e_wrap[k] ? Z : 0);
    return T.e_at[k] + (uint32_t)z * 0x10001u;
  };
  uint32_t held[kHold ? D : 1];
  float vpre[D];  // v2c before clip / quantize
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const uint32_t a = addr(k0 + (j < d ? j : d - 1));
    if constexpr (kHold) held[j] = a;
    const float old = (it == 0) ? 0.0f : sm[a >> 16];
    vpre[j] = sm[a & 0xFFFFu] - old;
  }
  auto pk = [&](int j) {
    if constexpr (kHold) {
      return held[j];
    } else {
      return addr(k0 + j);
    }
  };
  bool unsat = false;
  if (p.flags & kUcn) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (j < d) unsat ^= (sm[(pk(j) & 0xFFFFu) + 2 * RZ] < 0.0f);
    *flag = unsat ? 1 : 0;
  }
  const float* wrow = nullptr;
  if (p.flags & (kCnW | kUcn))
    wrow = (((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw) + (size_t)it * p.E + k0;
  const float lo_m = QMS ? p.q_lo : p.clip_lo;
  const float hi_m = QMS ? p.q_hi : p.clip_hi;
  const bool weighted = wrow != nullptr;
  if constexpr (SP) {
    float t[D], pr[D], sf[D], gpre[D], gsuf[D], gt[D];
    float acc = 1.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j < d) {
        t[j] = tanhf(0.5f * cq<QMS>(vpre[j], p));
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
        const uint32_t at = pk(j), ta = at & 0xFFFFu, ma = at >> 16;
        float ext = pr[j] * sf[j];
        float extc = fminf(fmaxf(ext, lo_c), hi_c);
        float o = logf((1.0f + extc) / (1.0f - extc));
        float g_w;
        float gmag = post_adjoint(o, weighted ? __ldg(wrow + j) : 1.0f, weighted,
                                  sm[ma + MZ] + sm[ta + RZ], lo_m, hi_m, &g_w);
        sm[ma] = g_w;
        float gout = gmag * ((o == 0.0f) ? 1.0f : sign0(o));  // |out| has gradient +1 at 0
        float gextc = (gout * 2.0f) / (1.0f - extc * extc);
        float gext = gextc * clip_mask(ext, lo_c, hi_c);
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
        float gv = gt[j] * 0.5f * (1.0f - t[j] * t[j]);
        sm[(pk(j) >> 16) + MZ] = -(gv * clip_mask(vpre[j], lo_m, hi_m));
      }
    }
    return;
  }
  // forward recompute: m1, first-occurrence argmin am, m2 over the others,
  // total sign (x >= 0 -> +1)
  float m1 = kBig, m2 = kBig;
  int am = 0;
  bool neg = false;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) {
      float v = cq<QMS>(vpre[j], p);
      float a = fabsf(v);
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
  // post-chain adjoint per edge; g_m1 / g_m2 gather the cotangents of the
  // extrinsic minimum (m2 at the argmin, m1 elsewhere)
  float gm1 = 0.0f, gm2 = 0.0f, c1 = 0.0f, c2 = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) {
      const uint32_t at = pk(j), ta = at & 0xFFFFu, ma = at >> 16;
      float v = cq<QMS>(vpre[j], p);
      float a = fabsf(v);
      float own = (v >= 0.0f) ? 1.0f : -1.0f;
      float c2v = ((j == am) ? m2 : m1) * (total * own);
      float g_w;
      float ge = post_adjoint(c2v, weighted ? __ldg(wrow + j) : 1.0f, weighted,
                              sm[ma + MZ] + sm[ta + RZ], lo_m, hi_m, &g_w);
      sm[ma] = g_w;
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
      float v = cq<QMS>(vpre[j], p);
      float a = fabsf(v);
      float sg = (v >= 0.0f) ? 1.0f : -1.0f;
      float gmag = ((a == m1) ? g1 : 0.0f) + ((((j == am) ? kBig : a) == m2) ? g2 : 0.0f);
      float gv = gmag * ((a == 0.0f) ? 1.0f : sg);  // |v| has gradient +1 at 0
      sm[(pk(j) >> 16) + MZ] = -(gv * clip_mask(vpre[j], lo_m, hi_m));
    }
  }
}

template <bool QMS, bool SP>
__global__ void __launch_bounds__(kThreads, 1) k4_cluster(Params p) {
  extern __shared__ __align__(16) float sm[];
  const uint32_t rank = cluster_ctarank();
  const long long w = cluster_id();
  const int Z = p.Z;
  const Lay L = lay_of(p);
  int* s_tab = reinterpret_cast<int*>(sm + L.tab);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(sm + L.flag);
  const uint32_t s_base = (uint32_t)__cvta_generic_to_shared(sm);
  const bool stamp = p.prof && w == 0 && threadIdx.x == 0;
  long long* prof = stamp ? p.prof + (size_t)rank * (5 * p.I + 2) : nullptr;
  if (stamp) prof[0] = clock64();

  for (int i = threadIdx.x; i < p.TAB; i += kThreads) s_tab[i] = __ldg(p.tab + i);
  // the message cotangent carry and the accumulators start at 0
  for (int i = p.MZ + threadIdx.x; i < 2 * p.MZ; i += kThreads) sm[i] = 0.0f;
  for (int i = L.acc + threadIdx.x; i < L.acc + L.nacc * p.WZ; i += kThreads) sm[i] = 0.0f;
  __syncthreads();
  const Tab T = tab_view(s_tab, p);
  {
    // packed owner << 24 | offset -> shared::cluster address
    uint32_t* l = const_cast<uint32_t*>(T.l_addr);
    uint32_t* nd = const_cast<uint32_t*>(T.need_addr);
    for (int i = threadIdx.x; i < p.E; i += kThreads)
      l[i] = map_rank(s_base + 4u * (l[i] & 0xFFFFFFu), l[i] >> 24);
    for (int i = threadIdx.x; i < p.NN; i += kThreads)
      nd[i] = map_rank(s_base + 4u * (nd[i] & 0xFFFFFFu), nd[i] >> 24);
  }
  const bool vec4 = (Z & 3) == 0;
  if (p.I >= 2) {
    if (vec4) load_slot<4>(p, T, sm, rank, w, p.I - 2);
    else load_slot<1>(p, T, sm, rank, w, p.I - 2);
  }
  // every CTA of the cluster runs, with its table, zeroed carry and slot I-2
  cluster_sync();
  if (vec4) vn_phase<4, QMS>(p, T, L, sm, rank, w, -1, p.I - 1);
  else vn_phase<1, QMS>(p, T, L, sm, rank, w, -1, p.I - 1);
  cluster_sync();
  if (stamp) prof[1] = clock64();

  const int c0 = T.chk_b[rank], c1 = T.chk_b[rank + 1];
  for (int it = p.I - 1; it >= 0; --it) {
    // ------------------------------- phase A -------------------------------
    for (Walk c = walk(c0, c1, Z); c.ok(); c.next()) {
      const int d = T.chk_d[c.b];
      uint8_t* flag = s_flag + (c.b - c0) * Z + c.z;
#define K4_CHECK(D) check_bwd<D, QMS, SP>(p, T, sm, c.b, c.z, d, it, flag)
      if (d <= 4) K4_CHECK(4);
      else if (d <= 6) K4_CHECK(6);
      else if (d <= 8) K4_CHECK(8);
      else if (d <= 12) K4_CHECK(12);
      else if (d <= 16) K4_CHECK(16);
      else if (d <= 20) K4_CHECK(20);
      else if (d <= 24) K4_CHECK(24);
      else K4_CHECK(32);
#undef K4_CHECK
    }
    __syncthreads();
    long long* st = stamp ? prof + 2 + 5 * (p.I - 1 - it) : nullptr;
    if (st) st[0] = clock64();
    if (p.g_cnw_part) reduce_edges(p, T, sm, s_flag, rank, w, it);
    // the weight terms are read before slot it-2 takes their rows
    __syncthreads();
    if (st) st[1] = clock64();
    if (it >= 2) {
      if (vec4) load_slot<4>(p, T, sm, rank, w, it - 2);
      else load_slot<1>(p, T, sm, rank, w, it - 2);
    }
    cluster_sync();
    if (st) st[2] = clock64();
    // ------------------------------ VN phase -------------------------------
    if (vec4) vn_phase<4, QMS>(p, T, L, sm, rank, w, it, it - 1);
    else vn_phase<1, QMS>(p, T, L, sm, rank, w, it, it - 1);
    if (p.g_vnw_part) {
      __syncthreads();
      reduce_vns(p, T, sm + L.vt, rank, w, it);
    }
    if (st) st[3] = clock64();
    if (it > 0) cluster_sync();
    if (st) st[4] = clock64();
  }
  // no CTA leaves while another may still read its shared memory
  cluster_sync();
}

template <bool QMS, bool SP>
cudaError_t prepare(int smem, int C, int* clusters, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr) {
  auto kern = k4_cluster<QMS, SP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kern, cfg);
}

template <bool QMS, bool SP>
cudaError_t run(const Params& p, int smem, cudaStream_t s, int* launched) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((unsigned)(p.B * p.C));
  cfg.stream = s;
  int clusters = 0;
  cudaError_t err = prepare<QMS, SP>(smem, p.C, &clusters, &cfg, &attr);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;  // the card cannot place one
  err = cudaLaunchKernelEx(&cfg, k4_cluster<QMS, SP>, p);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <bool QMS, bool SP>
cudaError_t query(int C, int smem, int* clusters, cudaFuncAttributes* fa) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((unsigned)C);
  const cudaError_t err = cudaFuncGetAttributes(fa, k4_cluster<QMS, SP>);
  return err != cudaSuccess ? err : prepare<QMS, SP>(smem, C, clusters, &cfg, &attr);
}

// f(QMS, SP) on the instantiation of ``flags``' QMS and sum-product bits
template <class F>
cudaError_t by_mode(int flags, F f) {
  if (flags & kSumProduct) {
    return (flags & kQms) ? f(std::true_type(), std::true_type())
                          : f(std::false_type(), std::true_type());
  }
  return (flags & kQms) ? f(std::true_type(), std::false_type())
                        : f(std::false_type(), std::false_type());
}

}  // namespace

// The instantiation for ``flags`` (its QMS and sum-product bits): how many
// clusters of ``C`` CTAs with ``smem`` bytes of dynamic shared memory each
// the card can hold at once (0: it cannot place one), and the kernel's
// registers and local (spill) bytes per thread, at 1,024 threads a CTA.
extern "C" int fused_bwd_cl_query(int flags, int C, int smem, int* clusters, int* registers,
                                  int* local_bytes) {
  cudaFuncAttributes fa = {};
  *clusters = 0;
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = by_mode(flags, [&](auto qms, auto sp) {
    return query<decltype(qms)::value, decltype(sp)::value>(C, smem, clusters, &fa);
  });
  *registers = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)err;
}

// One backward call over B words: one cluster launch of B * C CTAs, added to
// ``*launched`` when issued; refuses (cudaErrorInvalidConfiguration) a
// cluster the card cannot place.  ``tab`` is the split's table of ``TAB``
// ints; ``MZ``, ``RZ`` and ``WZ`` the sizes of a rank's row, replica and
// accumulator regions in 4-byte words, ``FZ`` its UCN flag bytes; ``NN`` the
// need entries.  The partials are [B, I, E] (CN, UCN) and [B, I, N] (VN).
// ``prof``, if not null, receives [C, 5 I + 2] clock64 stamps of word 0's
// ranks: start, after setup (B0 of iteration I-1 and its cluster sync),
// then per iteration I-1 .. 0 the end of phase A, of the weight reduction,
// of the slot load's cluster sync, of the VN phase (thread 0's work) and of
// its cluster sync.  Pointers the configuration does not use may be null.
// Returns a cudaError_t.
extern "C" int fused_bwd_cl_launch(
    const float* chan, const float* store, const float* outs, const float* g_outs,
    const int* tab, const float* cnw, const float* ucnw, const float* vnw, float* g_chan,
    float* g_chanq, float* g_cnw_part, float* g_ucnw_part, float* g_vnw_part, long long* prof,
    int B, int N, int M, int Z, int E, int I, int max_deg, int flags, int C, int MZ, int RZ,
    int WZ, int FZ, int NN, int TAB,
    float clip_lo, float clip_hi, float q_lo, float q_hi, float q_scale, void* stream,
    int* launched) {
  Params p{chan, store, outs, g_outs, tab, cnw, ucnw, vnw, g_chan, g_chanq,
           g_cnw_part, g_ucnw_part, g_vnw_part, prof,
           (long long)B, N, M, Z, E, I, flags, C, MZ, RZ, WZ, FZ, NN, TAB,
           clip_lo, clip_hi, q_lo, q_hi, q_scale, 1.0f / q_scale};
  if (B <= 0) return (int)cudaSuccess;
  if (I <= 0 || C < 1 || C > kMaxCluster || !tab || max_deg > 32 || Z > 65535)
    return (int)cudaErrorInvalidValue;
  const bool qms = flags & kQms, ucn = flags & kUcn, vnw_on = flags & kVnW;
  if ((qms && !g_chanq) || ((!qms || vnw_on) && !g_chan)) return (int)cudaErrorInvalidValue;
  if ((ucn && !outs) || (vnw_on && (!vnw || !g_vnw_part))) return (int)cudaErrorInvalidValue;
  if ((flags & (kCnW | kUcn)) && (!cnw || !g_cnw_part)) return (int)cudaErrorInvalidValue;
  if (ucn && (!ucnw || !g_ucnw_part)) return (int)cudaErrorInvalidValue;
  const long long nacc = 1 + ((qms && vnw_on) ? 1 : 0) + (vnw_on ? 1 : 0);
  const long long smem = 4LL * (2LL * MZ + (ucn ? 3LL : 2LL) * RZ + nacc * WZ
                                + (ucn ? (FZ + 3) / 4 : 0) + TAB);
  if (smem > kSmemOptin || 2LL * MZ + RZ > 0xFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)by_mode(flags, [&](auto q, auto sp) {
    return run<decltype(q)::value, decltype(sp)::value>(p, (int)smem, s, launched);
  });
}
