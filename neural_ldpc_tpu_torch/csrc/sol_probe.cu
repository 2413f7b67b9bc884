// Speed-of-light probe of the fp32 instruction rate for NVIDIA Hopper
// (sm_90a): K7.
//
// Replaces the TPU kernel scripts/mfu_r4.py::_sol_kernel (the "decode_mix"
// chain measure_sol times): per element a of the input, NACC = 8
// independent accumulators acc_k = a * (0.25 + 0.125 k) run CHAIN = 64 steps
// of acc = min(|acc - a|, a + acc * 0.001), five counted operations a step
// (sub, abs, mul, add, min: the check update's operation classes), then the
// output is (acc_0 + ... + acc_7) * 0.0625.  The step values depend on the
// data, so nothing folds; the eight chains give the scheduler independent
// work, so the probe measures instruction throughput and not one chain's latency.
//
// One thread per element, in the order of the TPU kernel's operations.
// Built with -fmad=false, so a + acc * 0.001 stays a multiply and an add
// (the count of 5 holds, and the result equals the plain PyTorch version
// bit for bit).  The abs may fold into the min as a source modifier, so the
// counted rate can exceed the instructions executed; the count is the TPU
// script's, for comparison with it.  Bound: 8 bytes per element at 3.35 TB/s
// against 2,560 counted operations per element at 33.5e12 per second: the
// operations, by 32x.

#include <cuda_runtime.h>

namespace {

constexpr int kChain = 64, kAcc = 8;

__global__ void __launch_bounds__(256) sol_kernel(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = x[i];
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = a * (0.25f + 0.125f * k);
#pragma unroll 4
  for (int s = 0; s < kChain; ++s) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = fminf(fabsf(acc[k] - a), a + acc[k] * 0.001f);
  }
  float total = acc[0];
#pragma unroll
  for (int k = 1; k < kAcc; ++k) total = total + acc[k];
  out[i] = total * 0.0625f;
}

}  // namespace

// One launch over n elements, added to ``*launched``.  Returns a cudaError_t.
extern "C" int sol_launch(const float* x, float* out, int n, void* stream, int* launched) {
  if (n <= 0) return (int)cudaSuccess;
  sol_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, out, n);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
