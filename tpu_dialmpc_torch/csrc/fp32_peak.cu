// fp32_peak.cu — a dependent fp32 FMA chain per thread: the microbenchmark
// that measures the card's fp32 peak for the profiler's roofline
// (tpu_dialmpc_torch/telemetry/profile.py: fp32_peak_ops_per_sec).
//
// Replaces: tpu_dialmpc/telemetry/profile.py:vpu_peak_eqn_ops_per_sec (:106),
// the JAX package's measured VPU peak.  That one is plain JAX (a scan of
// FMA chains over VMEM-resident tiles), not a Pallas kernel; its
// counterpart here has to be a kernel because a chain of PyTorch ops is one
// memory-bound launch per op and would measure bandwidth, not the FMA rate.
// The plain PyTorch version of the same function is profile.py's
// `FmaChain.plain`; the wrapper that builds and launches this file is
// `FmaChain`.
//
// What it computes: thread i keeps FP_NACC accumulators acc_j = x0[i] + j
// and applies acc_j = fma(acc_j, a[i], b[i]) k times to each, then writes
// out[i] = sum_j acc_j.  a and b are read from memory at run time, so nvcc
// cannot fold the chain, and the result is written, so it is not dead code.
//
// What bounds it: operations, by construction: 12 bytes in and 4 out per
// thread against 2 * FP_NACC * k fp32 operations.  The FMA is the explicit
// intrinsic __fmaf_rn: the port builds with -fmad=false, under which
// `a * b + c` would compile to a separate multiply and add and measure half
// the rate.  The FP_NACC independent chains per thread hide the FMA's
// latency within one warp; the wrapper launches enough blocks to fill every
// SM several times over.

#include <cuda_runtime.h>

#define FP_NACC 8

__global__ void fp32_fma_chain_kernel(const float* __restrict__ x0, const float* __restrict__ a,
                                      const float* __restrict__ b, float* __restrict__ out,
                                      int n, int k) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float av = a[i], bv = b[i];
  float acc[FP_NACC];
#pragma unroll
  for (int j = 0; j < FP_NACC; ++j) acc[j] = x0[i] + (float)j;
#pragma unroll 4
  for (int s = 0; s < k; ++s) {
#pragma unroll
    for (int j = 0; j < FP_NACC; ++j) acc[j] = __fmaf_rn(acc[j], av, bv);
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < FP_NACC; ++j) sum += acc[j];
  out[i] = sum;
}

extern "C" int fp32_peak_nacc() { return FP_NACC; }

// Launches on `stream` and returns cudaGetLastError(): 0 when the launch
// was accepted.  Faults during the run surface at the next synchronize.
extern "C" int fp32_fma_chain_launch(int n, int k, int threads, const float* x0, const float* a,
                                     const float* b, float* out, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + threads - 1) / threads;
  fp32_fma_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(x0, a, b, out, n, k);
  return (int)cudaGetLastError();
}
