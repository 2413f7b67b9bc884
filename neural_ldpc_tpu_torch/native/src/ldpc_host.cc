// Native host runtime for the LDPC framework's PyTorch/CUDA port.
//
// The port's own copy of neural_ldpc_tpu/native/src/ldpc_host.cc, built into
// this package's build/ directory: the same source and flags, so its outputs
// equal the JAX package's library byte for byte.
//
// The reference implementation (ShapeLayer/neural-ldpc-decoder-torch) has no
// native code at all — its host pipeline is pure numpy
// (src/boosted_neural_ldpc_decoder/AWGNPassedDatagen.py:75-203, with an
// O(B^2) np.vstack batch builder).  This library supplies the host side:
// bit-packed GF(2) linear algebra for codeword generation and
// verification, and a multithreaded, counter-based AWGN+LLR sampler whose
// determinism is index-addressed (seed, word, bit), so Monte-Carlo campaigns
// are restartable and thread-count-invariant.
//
// Exposed via a plain C ABI and loaded from Python with ctypes
// (neural_ldpc_tpu_torch/native/__init__.py); every entry point has a numpy
// fallback so the framework works without a compiler.
//
// Build: make -C neural_ldpc_tpu_torch/native  (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <functional>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Counter-based RNG: splitmix64 keyed by (seed, index).  Stateless — the
// value at any index can be regenerated independently, which is what makes
// the datagen restartable and invariant to thread count.
// ---------------------------------------------------------------------------
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

static inline double u01(uint64_t bits) {
  // 53-bit mantissa uniform in (0, 1]; never exactly 0 so log() is safe
  return (double)((bits >> 11) + 1) * (1.0 / 9007199254740992.0);
}

// Box-Muller from two counter values.
static inline void gauss_pair(uint64_t seed, uint64_t idx, double* g0, double* g1) {
  uint64_t a = splitmix64(seed ^ splitmix64(idx * 2 + 1));
  uint64_t b = splitmix64(seed ^ splitmix64(idx * 2 + 2));
  double r = std::sqrt(-2.0 * std::log(u01(a)));
  double t = 6.283185307179586476925286766559 * u01(b);
  *g0 = r * std::cos(t);
  *g1 = r * std::sin(t);
}

static void parallel_for(int64_t n, int n_threads, const std::function<void(int64_t, int64_t)>& fn) {
  if (n_threads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// GF(2) codeword generation: out = info @ G mod 2, with G bit-packed row-wise
// (G_packed[k][w] holds bits 64*w .. 64*w+63 of row k).  XOR-accumulate the
// packed rows selected by each word's information bits: O(B * K * N/64).
// Replaces the reference's dense ``info @ G % 2``
// (boosted_neural_ldpc_decoder/AWGNPassedDatagen.py:200-203).
// ---------------------------------------------------------------------------
void gf2_encode(const uint8_t* info, const uint64_t* g_packed, uint8_t* out,
                int64_t B, int64_t K, int64_t N, int n_threads) {
  const int64_t W = (N + 63) / 64;
  parallel_for(B, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<uint64_t> acc(W);
    for (int64_t b = lo; b < hi; ++b) {
      std::memset(acc.data(), 0, W * sizeof(uint64_t));
      const uint8_t* row = info + b * K;
      for (int64_t k = 0; k < K; ++k) {
        if (row[k] & 1) {
          const uint64_t* g = g_packed + k * W;
          for (int64_t w = 0; w < W; ++w) acc[w] ^= g[w];
        }
      }
      uint8_t* o = out + b * N;
      for (int64_t n = 0; n < N; ++n) o[n] = (acc[n >> 6] >> (n & 63)) & 1;
    }
  });
}

// ---------------------------------------------------------------------------
// Syndrome check: ok[b] = 1 iff H @ bits[b] == 0 (mod 2).  H bit-packed
// row-wise like G.  Early-exits on the first unsatisfied check.
// ---------------------------------------------------------------------------
void gf2_syndrome_ok(const uint8_t* bits, const uint64_t* h_packed, uint8_t* ok,
                     int64_t B, int64_t M, int64_t N, int n_threads) {
  const int64_t W = (N + 63) / 64;
  parallel_for(B, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<uint64_t> word(W);
    for (int64_t b = lo; b < hi; ++b) {
      const uint8_t* x = bits + b * N;
      std::memset(word.data(), 0, W * sizeof(uint64_t));
      for (int64_t n = 0; n < N; ++n)
        if (x[n] & 1) word[n >> 6] |= 1ULL << (n & 63);
      uint8_t good = 1;
      for (int64_t m = 0; m < M && good; ++m) {
        const uint64_t* h = h_packed + m * W;
        uint64_t parity = 0;
        for (int64_t w = 0; w < W; ++w) parity ^= word[w] & h[w];
        good = (uint8_t)(1 - (__builtin_popcountll(parity) & 1));
      }
      ok[b] = good;
    }
  });
}

// ---------------------------------------------------------------------------
// AWGN channel + LLR: for codeword bits y, BPSK-modulate
// (standard convention: bit 0 -> +1, bit 1 -> -1; the reference's inverted
// mapping is available via bit0_plus=0, see AWGNPassedDatagen.py:97-101 and
// SURVEY.md §5), add N(0, sigma[b]^2) noise, emit llr = 2x / sigma^2.
// ``cw`` may be null for the all-zero codeword.  ``word_offset`` shifts the
// RNG index space so successive batches of one campaign never reuse counters.
// ---------------------------------------------------------------------------
void awgn_llr(const uint8_t* cw, const double* sigma, float* llr,
              int64_t B, int64_t N, uint64_t seed, uint64_t word_offset,
              int bit0_plus, int n_threads) {
  parallel_for(B, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      const double s = sigma[b];
      const double scale = 2.0 / (s * s);
      const uint64_t word_key = (word_offset + (uint64_t)b) * (uint64_t)((N + 1) / 2);
      float* o = llr + b * N;
      const uint8_t* y = cw ? cw + b * N : nullptr;
      for (int64_t n = 0; n < N; n += 2) {
        double g0, g1;
        gauss_pair(seed, word_key + (uint64_t)(n / 2), &g0, &g1);
        double b0 = y ? (double)(y[n] & 1) : 0.0;
        double x0 = (bit0_plus ? 1.0 - 2.0 * b0 : 2.0 * b0 - 1.0) + s * g0;
        o[n] = (float)(scale * x0);
        if (n + 1 < N) {
          double b1 = y ? (double)(y[n + 1] & 1) : 0.0;
          double x1 = (bit0_plus ? 1.0 - 2.0 * b1 : 2.0 * b1 - 1.0) + s * g1;
          o[n + 1] = (float)(scale * x1);
        }
      }
    }
  });
}

// ---------------------------------------------------------------------------
// Bit/frame error counting against an expected word (usually all-zero):
// hard-decide sign(llr) under the standard convention (llr < 0 -> bit 1).
// Returns totals via out pointers; per-word frame errors optional.
// ---------------------------------------------------------------------------
void count_errors(const float* llr, const uint8_t* expected,
                  int64_t B, int64_t N,
                  int64_t* bit_errors, int64_t* frame_errors,
                  uint8_t* frame_error_mask, int n_threads) {
  std::vector<int64_t> be(n_threads > 1 ? n_threads : 1, 0);
  std::vector<int64_t> fe(n_threads > 1 ? n_threads : 1, 0);
  int nt = n_threads > 1 ? n_threads : 1;
  int64_t chunk = (B + nt - 1) / nt;
  parallel_for(B, n_threads, [&](int64_t lo, int64_t hi) {
    int tid = (int)(lo / (chunk > 0 ? chunk : 1));
    if (tid >= nt) tid = nt - 1;
    for (int64_t b = lo; b < hi; ++b) {
      const float* x = llr + b * N;
      const uint8_t* e = expected ? expected + b * N : nullptr;
      int64_t errs = 0;
      for (int64_t n = 0; n < N; ++n) {
        uint8_t bit = x[n] < 0.0f ? 1 : 0;
        errs += bit != (e ? (e[n] & 1) : 0);
      }
      be[tid] += errs;
      fe[tid] += errs > 0;
      if (frame_error_mask) frame_error_mask[b] = errs > 0;
    }
  });
  int64_t tb = 0, tf = 0;
  for (int t = 0; t < nt; ++t) { tb += be[t]; tf += fe[t]; }
  *bit_errors = tb;
  *frame_errors = tf;
}

int ldpc_host_abi_version() { return 1; }

}  // extern "C"
