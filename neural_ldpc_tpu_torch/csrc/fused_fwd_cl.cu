// Forward BP decode for NVIDIA Hopper (sm_90a) with a word's whole message
// state in the shared memory of one thread-block cluster: K3 for every big
// code whose word state a cluster of at most 8 CTAs holds.
//
// Replaces the TPU kernel neural_ldpc_tpu/ops/pallas/fused_train.py::
// _fwd_kernel_hbm (launcher _fwd_run_hbm :1270, pallas_call :1303; "K3"),
// in all its modes:
//   final APP      the pre-clip APP chan_out + sums of the last iteration;
//   kStats         per word ok / bit errors / frame error (_stats_rows), no
//                  APP; kSyndrome writes the APP and the same stats;
//   kStream        the pre-clip APP of every iteration to out[i, w, :];
//   kStore         with kStream: slot i (i < I-1) of the store receives the
//                  message state entering iteration i + 1, in the permuted
//                  flat-edge order k*Z + zc, [max(I-1, 1), B, E*Z] (K4 reads
//                  it; at I = 1 the single slot is not written).
// The TPU kernel streams the state through HBM because VMEM has nothing
// between one core and HBM.  On the H100 the shared memory of up to 8 SMs
// can be pooled: one cluster of C CTAs (C the smallest that holds the word,
// ops/cuda/fused_train.py::cluster_plan) decodes one word, the word index
// being the cluster's index.
//
// The split (built once per layout in Python, cluster_split, passed as one
// table).  Rank r owns the sorted base checks [chk_b[r], chk_b[r+1]) with all
// their lifts, and keeps in its shared memory (4-byte words):
//   messages [0, MZ)     its edges' messages in the VN's frame: edge k's
//                        message from lifted check zc sits at
//                        (k - k_lo) * Z + (zc + shift_k) mod Z, i.e. at the
//                        lift zv of the VN copy it goes to;
//   totals [MZ, MZ+RZ)   a replica of chan_in + sums of every VN its checks
//                        touch (slot * Z + zv);
//   with kUcn, [MZ+RZ, MZ+2RZ) the same VNs' clipped APP of the last
//   iteration (its sign gates the UCN weights);
//   the table and two stats counters.
// Its threads also do the VN phase of the base VNs [wv_b[r], wv_b[r+1]).
// The checks are split by their cost in the check phase where that split
// fits, else by edges; the VN work by degree and pushes.
//
// One launch of 1,024 threads a CTA does all I iterations.  Each iteration:
//   check phase  each thread takes lifted checks of its rank and reads and
//                writes only its own shared memory: the totals (and UCN
//                APPs) at its edges from the replica, its entering messages,
//                then check_update and post_chain (bp_common.cuh, as
//                fused_fwd_dm.cu's check pass); the new messages go back in
//                place (each thread reads its own edges' slots before it
//                writes them) and, with kStore, to the store.  A check runs
//                the smallest of eight instantiations (4 ... 32 slots) that
//                holds its degree, with every load issued before the
//                arithmetic: one MAXD for all checks, with loads behind the
//                per-slot branches, made a first version's check phase 2-3x
//                slower;
//   cluster sync;
//   VN phase     each thread takes 4 consecutive lifts of a VN of its work
//                range (1 where Z % 4 != 0): reads each incoming message row
//                at the same 4 lifts with one 16-byte ld.shared::cluster (the
//                VN frame makes the rows line up), adds them in the order of
//                vn_list (each VN's edges in increasing original edge id,
//                FwdLayout.build), so that this kernel equals fused_fwd.cu bit
//                for bit on MS and QMS; writes the APP where the mode asks,
//                and pushes next iteration's chan_in + sums (with kUcn the
//                clipped APP; after the last iteration in the stats modes the
//                APP) into the replica of every rank that needs the VN with
//                16-byte st.shared::cluster;
//   cluster sync.
// The first sync orders the check phase's message writes before the VN
// phase reads them and its replica reads before the VN phase overwrites
// them; the second orders the replica writes before the next check phase
// and the message reads before the next check phase overwrites them.  So
// one buffer of each suffices.  Distributed shared memory moves only
// 16-byte words: the 4-byte remote loads of a first version (the VN copies'
// channel and sums at every edge, the messages at every VN entry) ran at
// the speed of device memory.  The channel stays in device memory, where
// the VN phase reads it once an iteration (a word's 104 KB stay in L2); the
// replicas are filled from it once a word.  The stats are reduced by
// integer atomics in each rank's shared memory (exact in any order) and
// summed by rank 0 over the cluster; the syndrome reads the last APP from
// the replica.  A last cluster sync keeps every CTA's shared memory alive
// until no rank reads it.
//
// Bound on this card: a decode must read the channel and write the APP,
// 2 * N*Z * 4 bytes a word (0.21 MB at Z = 384); the operations are the
// larger bound: ~19 per edge copy and iteration, 46.66 M a word at Z = 384,
// MS x20 (45.640 ms at 32,768 words and 33.5e12 instructions/s).  The
// two-pass kernel (fused_fwd_dm.cu) moved ~(5 E*Z + N*Z) * 4 bytes a word
// and iteration through device memory (50.6 MB a word at Z = 384, MS x20)
// in 2 I launches and did 64-bit divisions per thread; here the state never
// leaves the chip, one launch does the word, and the addresses are 32-bit
// offsets from tables in shared memory.  Device-memory offsets stay 64-bit
// (B * E*Z passes 2^31).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_common.cuh"

namespace {

using namespace bp;

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kSmemOptin = 232448;
constexpr int kThreads = 1024;  // one CTA an SM: its shared memory is the word's

struct Params {
  const float* chan;  // [B, N*Z]
  float* out;         // [B, N*Z] pre-clip APP; [I, B, N*Z] with kStream
  float* store;       // [max(I-1, 1), B, E*Z] (kStore)
  int* stats;         // [B, 3] ok, bit errors, frame error (kStats | kSyndrome)
  const int* tab;     // the split's table (ops/cuda/fused_train.py::cluster_split)
  const float* cnw;   // [I, E] in permuted edge order (or null)
  const float* ucnw;  // [I, E] (or null)
  const float* vnw;   // [I, N] (or null)
  long long* prof;    // null, or [C, 4 I + 2] clock64 stamps of word 0's ranks
  long long B;
  int N, M, Z, E, I, flags;
  int C, MZ, RZ, NN, TAB;  // cluster size, region sizes, need entries, table ints
  float clip_lo, clip_hi, q_lo, q_hi, q_scale, q_inv_scale;
};

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

__device__ __forceinline__ int ld_cluster_int(uint32_t a) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// every thread of every CTA of the cluster; release / acquire order the
// shared-memory accesses before it against those after it, cluster-wide
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The table, as cluster_split lays it out:
//   chk_b[C+1] wv_b[C+1] rep_ptr[C+1] chk_k0[M] chk_d[M] e_at[E] e_wrap[E]
//   vn_ptr[N+1] l_loc[E] need_ptr[N+1] need_loc[NN] rep_vn[NN]
// For edge k with shift s on its rank: e_at = (replica slot offset + s) |
// (message row offset + s) << 16 and e_wrap = Z - s, so that lifted check
// zc reaches both at + zc - (zc >= e_wrap ? Z : 0), the lift zv = (zc + s)
// mod Z of its VN copy, with no table of shifts.  l_loc (edge k's message
// row) and need_loc (a replica slot of a VN) hold owner << 24 | offset and
// become shared::cluster addresses.
struct Tab {
  const int *chk_b, *wv_b, *rep_ptr, *chk_k0, *chk_d, *e_wrap, *vn_ptr, *need_ptr, *rep_vn;
  const uint32_t *e_at, *l_addr, *need_addr;
};

__device__ __forceinline__ Tab tab_view(const int* t, const Params& p) {
  Tab v;
  const int C1 = p.C + 1;
  v.chk_b = t;
  v.wv_b = t + C1;
  v.rep_ptr = t + 2 * C1;
  v.chk_k0 = t + 3 * C1;
  v.chk_d = v.chk_k0 + p.M;
  v.e_at = reinterpret_cast<const uint32_t*>(v.chk_d + p.M);
  v.e_wrap = v.chk_d + p.M + p.E;
  v.vn_ptr = v.e_wrap + p.E;
  v.l_addr = reinterpret_cast<const uint32_t*>(v.vn_ptr + p.N + 1);
  v.need_ptr = v.vn_ptr + p.N + 1 + p.E;
  v.need_addr = reinterpret_cast<const uint32_t*>(v.need_ptr + p.N + 1);
  v.rep_vn = v.need_ptr + p.N + 1 + p.NN;
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

// bp_common.cuh's clip_or_quant, chan_out and chan_in with the QMS flag
// known at compile time (the same operations): no flag test per value
template <bool QMS>
__device__ __forceinline__ float cq(float x, const Params& p) {
  if constexpr (QMS) return quant(x, p);
  return fminf(fmaxf(x, p.clip_lo), p.clip_hi);
}

template <bool QMS>
__device__ __forceinline__ float ch_out(float c, const Params& p) {
  if constexpr (QMS) return quant(c, p);
  return c;
}

template <bool QMS>
__device__ __forceinline__ float ch_in(float c, int vn, int it, const Params& p) {
  if (p.flags & kVnW) {
    const float x = c * __ldg(p.vnw + (size_t)it * p.N + vn);
    if constexpr (QMS) return quant(x, p);
    return x;
  }
  return ch_out<QMS>(c, p);
}

// The VN phase of iteration ``it`` over this rank's work VNs, VEC lifts a
// thread; returns the bit errors it counted (last iteration, stats modes).
template <int VEC, bool QMS>
__device__ __forceinline__ int vn_phase(const Params& p, const Tab& T, uint32_t rank,
                                        long long w, int it) {
  const int Z = p.Z, NZ = p.N * p.Z;
  const bool last = it == p.I - 1;
  const bool stream = p.flags & kStream, stats = p.flags & (kStats | kSyndrome);
  const bool write_out = (last || stream) && !(p.flags & kStats);
  const bool ucn = p.flags & kUcn;
  // what the replicas receive: next iteration's totals, or the last APP for
  // the syndrome
  const bool push = !last || stats;
  float* o = p.out + (stream ? (size_t)it * p.B * NZ : 0) + w * NZ;
  const float* cw = p.chan + w * NZ;
  int berr = 0;
  for (Walk n = walk(T.wv_b[rank], T.wv_b[rank + 1], Z / VEC); n.ok(); n.next()) {
    const int e0 = T.vn_ptr[n.b], e1 = T.vn_ptr[n.b + 1];
    const uint32_t zoff = 4u * VEC * n.z;
    float acc[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0.0f;
    int e = e0;
    for (; e + 4 <= e1; e += 4) {
      float m[4][VEC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ld_cluster<VEC>(T.l_addr[e + i] + zoff, m[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < VEC; ++u) acc[u] = (e + i == e0) ? m[i][u] : acc[u] + m[i][u];
    }
    for (; e < e1; ++e) {
      float m[VEC];
      ld_cluster<VEC>(T.l_addr[e] + zoff, m);
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[u] = (e == e0) ? m[u] : acc[u] + m[u];
    }
    const int q = n.b * Z + VEC * n.z;
    float ch[VEC], app[VEC];
    if constexpr (VEC == 4) {
      const float4 c4 = __ldg(reinterpret_cast<const float4*>(cw + q));
      ch[0] = c4.x;
      ch[1] = c4.y;
      ch[2] = c4.z;
      ch[3] = c4.w;
    } else {
      ch[0] = __ldg(cw + q);
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) app[u] = ch_out<QMS>(ch[u], p) + acc[u];
    if (write_out) {
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(o + q) = make_float4(app[0], app[1], app[2], app[3]);
      } else {
        o[q] = app[0];
      }
    }
    if (last && stats) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) berr += app[u] < 0.0f;
    }
    if (!push) continue;
    float tot[VEC], clipped[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      tot[u] = last ? app[u] : ch_in<QMS>(ch[u], n.b, it + 1, p) + acc[u];
      clipped[u] = fminf(fmaxf(app[u], p.clip_lo), p.clip_hi);
    }
    for (int k = T.need_ptr[n.b]; k < T.need_ptr[n.b + 1]; ++k) {
      st_cluster<VEC>(T.need_addr[k] + zoff, tot);
      if (ucn && !last) st_cluster<VEC>(T.need_addr[k] + 4u * p.RZ + zoff, clipped);
    }
  }
  return berr;
}

// bp_common.cuh's post_chain with the edge's weight loaded beforehand (the
// same operations): msg = clip_or_quant(relu(|c2v| * w)) * sign(c2v)
template <bool QMS>
__device__ __forceinline__ float post_chain_w(float c2v, float wt, bool weighted,
                                              const Params& p) {
  float wm = fabsf(c2v);
  if (weighted) wm = wm * wt;
  wm = fmaxf(wm, 0.0f);
  return cq<QMS>(wm, p) * sign0(c2v);
}

// One lifted check (sorted base check b, lift zc) of degree d <= D in the
// check phase of iteration ``it``, from and to this rank's shared memory.
// Every load is made for j < D (slots past d repeat edge d - 1), so that
// they issue ahead of the arithmetic; only j < d is used or written.  Above
// 8 slots the weights load in the last loop, where they need no registers
// beside the messages (1,024 threads leave 64 a thread).
template <int D, bool QMS>
__device__ __forceinline__ void check_one(const Params& p, const Tab& T, float* s_msg,
                                          const float* s_app, int b, int zc, int d, int it,
                                          long long w) {
  const int Z = p.Z, k0 = T.chk_k0[b];
  int tot_at[D], msg_at[D];
  float v[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int k = k0 + (j < d ? j : d - 1);
    const uint32_t at = T.e_at[k];
    const int z = zc - (zc >= T.e_wrap[k] ? Z : 0);
    tot_at[j] = (int)(at & 0xFFFFu) + z;
    msg_at[j] = (int)(at >> 16) + z;
  }
  bool unsat = false;
  if (p.flags & kUcn) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (j < d) unsat ^= (s_app[tot_at[j]] < 0.0f);
  }
  // v[] holds v2c, then (SP) tanh(v2c / 2), then c2v, in place
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float old = (it == 0) ? 0.0f : s_msg[msg_at[j]];
    v[j] = cq<QMS>(s_msg[tot_at[j]] - old, p);
  }
  check_update<D>(v, d, p.flags & kSumProduct);

  const bool weighted = p.flags & (kCnW | kUcn);
  const float* wrow = nullptr;
  if (weighted) wrow = (((p.flags & kUcn) && unsat) ? p.ucnw : p.cnw) + (size_t)it * p.E + k0;
  constexpr bool kHoist = D <= 8;
  float wt[kHoist ? D : 1];
  if constexpr (kHoist) {
#pragma unroll
    for (int j = 0; j < D; ++j) wt[j] = weighted ? __ldg(wrow + (j < d ? j : d - 1)) : 1.0f;
  }
  float* slot = ((p.flags & kStore) && it < p.I - 1)
      ? p.store + ((size_t)it * p.B + w) * ((size_t)p.E * Z) + (size_t)k0 * Z + zc
      : nullptr;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) {
      float wj = 1.0f;
      if constexpr (kHoist) {
        wj = wt[j];
      } else if (weighted) {
        wj = __ldg(wrow + j);
      }
      const float m = post_chain_w<QMS>(v[j], wj, weighted, p);
      s_msg[msg_at[j]] = m;
      if (slot) slot[(size_t)j * Z] = m;
    }
  }
}

template <bool QMS>
__global__ void __launch_bounds__(kThreads, 1) k3_cluster(Params p) {
  extern __shared__ __align__(16) float sm[];
  const uint32_t rank = cluster_ctarank();
  const long long w = cluster_id();
  const int Z = p.Z, NZ = p.N * p.Z;
  const bool ucn = p.flags & kUcn;
  float* s_msg = sm;  // the messages, then the replicas: e_at counts from 0
  float* s_app = sm + p.RZ;
  int* s_tab = reinterpret_cast<int*>(sm + p.MZ + (ucn ? 2 : 1) * p.RZ);
  int* s_cnt = s_tab + p.TAB;  // bit errors, unsatisfied checks of this rank
  const uint32_t s_base = (uint32_t)__cvta_generic_to_shared(sm);
  const bool stamp = p.prof && w == 0 && threadIdx.x == 0;
  long long* prof = stamp ? p.prof + (size_t)rank * (4 * p.I + 2) : nullptr;
  if (stamp) prof[0] = clock64();

  for (int i = threadIdx.x; i < p.TAB; i += kThreads) s_tab[i] = __ldg(p.tab + i);
  if (threadIdx.x < 2) s_cnt[threadIdx.x] = 0;
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
  {
    // this rank's replica for iteration 0: chan_in + 0 (and the UCN APP
    // chan_in), from the channel in device memory
    const int r0 = T.rep_ptr[rank];
    const float* cw = p.chan + w * NZ;
    for (Walk s = walk(r0, T.rep_ptr[rank + 1], Z); s.ok(); s.next()) {
      const int n = T.rep_vn[s.b];
      const float x = ch_in<QMS>(__ldg(cw + n * Z + s.z), n, 0, p);
      const int at = p.MZ + (s.b - r0) * Z + s.z;
      s_msg[at] = x + 0.0f;
      if (ucn) s_app[at] = x;
    }
  }
  // every CTA of the cluster runs and has its table and replica in place
  cluster_sync();
  if (stamp) prof[1] = clock64();

  const int c0 = T.chk_b[rank], c1 = T.chk_b[rank + 1];
  const bool stats = p.flags & (kStats | kSyndrome);
  int berr = 0;

  for (int it = 0; it < p.I; ++it) {
    // ------------------------------ check phase ----------------------------
    for (Walk c = walk(c0, c1, Z); c.ok(); c.next()) {
      const int d = T.chk_d[c.b];
      // the smallest instantiation that holds the check (checks of one
      // degree fill whole warps where Z % 32 == 0)
#define K3_CHECK(D) check_one<D, QMS>(p, T, s_msg, s_app, c.b, c.z, d, it, w)
      if (d <= 4) K3_CHECK(4);
      else if (d <= 6) K3_CHECK(6);
      else if (d <= 8) K3_CHECK(8);
      else if (d <= 12) K3_CHECK(12);
      else if (d <= 16) K3_CHECK(16);
      else if (d <= 20) K3_CHECK(20);
      else if (d <= 24) K3_CHECK(24);
      else K3_CHECK(32);
#undef K3_CHECK
    }
    if (stamp) prof[2 + 4 * it] = clock64();
    cluster_sync();
    if (stamp) prof[3 + 4 * it] = clock64();

    // -------------------------------- VN phase -----------------------------
    berr += (Z & 3) == 0 ? vn_phase<4, QMS>(p, T, rank, w, it)
                         : vn_phase<1, QMS>(p, T, rank, w, it);
    if (stamp) prof[4 + 4 * it] = clock64();
    cluster_sync();
    if (stamp) prof[5 + 4 * it] = clock64();
  }

  if (stats) {
    // bit errors over this rank's VN work, the syndrome over its checks on
    // the last APP in the replica
    if (berr) atomicAdd(s_cnt, berr);
    bool bad = false;
    for (Walk c = walk(c0, c1, Z); c.ok(); c.next()) {
      const int k0 = T.chk_k0[c.b], d = T.chk_d[c.b];
      bool odd = false;
      for (int k = k0; k < k0 + d; ++k) {
        const int z = c.z - (c.z >= T.e_wrap[k] ? Z : 0);
        odd ^= s_msg[(T.e_at[k] & 0xFFFFu) + z] < 0.0f;  // the last APP
      }
      bad |= odd;
    }
    if (bad) s_cnt[1] = 1;  // every writer stores the same value
    cluster_sync();
    if (rank == 0 && threadIdx.x == 0) {
      const uint32_t cnt = s_base + 4u * (uint32_t)((s_cnt - reinterpret_cast<int*>(sm)));
      int e = 0, b = 0;
      for (int r = 0; r < p.C; ++r) {
        const uint32_t a = map_rank(cnt, r);
        e += ld_cluster_int(a);
        b |= ld_cluster_int(a + 4);
      }
      int* st = p.stats + w * 3;
      st[0] = b ? 0 : 1;
      st[1] = e;
      st[2] = e > 0 ? 1 : 0;
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster_sync();
}

template <bool QMS>
cudaError_t prepare(int smem, int C, int* clusters, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr) {
  auto kern = k3_cluster<QMS>;
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

template <bool QMS>
cudaError_t run(const Params& p, int smem, cudaStream_t s, int* launched) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((unsigned)(p.B * p.C));
  cfg.stream = s;
  int clusters = 0;
  cudaError_t err = prepare<QMS>(smem, p.C, &clusters, &cfg, &attr);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;  // the card cannot place one
  err = cudaLaunchKernelEx(&cfg, k3_cluster<QMS>, p);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <bool QMS>
cudaError_t query(int C, int smem, int* clusters, cudaFuncAttributes* fa) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((unsigned)C);
  const cudaError_t err = cudaFuncGetAttributes(fa, k3_cluster<QMS>);
  return err != cudaSuccess ? err : prepare<QMS>(smem, C, clusters, &cfg, &attr);
}

}  // namespace

// The instantiation for ``qms`` (0 or 1): how many clusters of ``C`` CTAs
// with ``smem`` bytes of dynamic shared memory each the card can hold at
// once (0: it cannot place one), and the kernel's registers and local
// (spill) bytes per thread, at 1,024 threads a CTA.
extern "C" int fused_fwd_cl_query(int qms, int C, int smem, int* clusters, int* registers,
                                  int* local_bytes) {
  cudaFuncAttributes fa = {};
  *clusters = 0;
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = qms ? query<true>(C, smem, clusters, &fa) : query<false>(C, smem, clusters, &fa);
  *registers = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)err;
}

// One forward call: one cluster launch of B * C CTAs, added to ``*launched``
// when issued; refuses (cudaErrorInvalidConfiguration) a cluster the card
// cannot place.  ``tab`` is the split's table of ``TAB`` ints; ``MZ`` and
// ``RZ`` the sizes of a rank's message and replica regions in 4-byte words;
// ``NN`` the need entries.  ``prof``, if not null, receives [C, 4 I + 2]
// clock64 stamps of word 0's ranks: start, after setup, then per iteration
// the end of the check work, after its cluster sync, the end of the VN
// work, after its cluster sync.  Pointers the mode does not use may be null.  Returns a
// cudaError_t.
extern "C" int fused_fwd_cl_launch(
    const float* chan, float* out, float* store, int* stats, const int* tab,
    const float* cnw, const float* ucnw, const float* vnw, long long* prof,
    int B, int N, int M, int Z, int E, int I, int max_deg, int flags, int C, int MZ, int RZ,
    int NN, int TAB,
    float clip_lo, float clip_hi, float q_lo, float q_hi, float q_scale, void* stream,
    int* launched) {
  Params p{chan, out, store, stats, tab, cnw, ucnw, vnw, prof,
           (long long)B, N, M, Z, E, I, flags, C, MZ, RZ, NN, TAB,
           clip_lo, clip_hi, q_lo, q_hi, q_scale, 1.0f / q_scale};
  if (B <= 0) return (int)cudaSuccess;
  if (I <= 0 || C < 1 || C > kMaxCluster || !tab || max_deg > 32 || Z > 65535)
    return (int)cudaErrorInvalidValue;
  if ((flags & kStream) && (flags & (kStats | kSyndrome))) return (int)cudaErrorInvalidValue;
  if ((flags & kStore) && (!(flags & kStream) || !store)) return (int)cudaErrorInvalidValue;
  if ((flags & (kStats | kSyndrome)) && !stats) return (int)cudaErrorInvalidValue;
  if (!(flags & kStats) && !out) return (int)cudaErrorInvalidValue;
  const long long smem = 4LL * (MZ + ((flags & kUcn) ? 2LL : 1LL) * RZ + TAB + 2);
  if (smem > kSmemOptin) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)((flags & kQms) ? run<true>(p, (int)smem, s, launched)
                               : run<false>(p, (int)smem, s, launched));
}
