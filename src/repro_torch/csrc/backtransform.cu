// Kernel C: blocked Q2 back-transform from the sweep-major chase log.
//
// Replaces repro/kernels/backtransform.py:backtransform_wy_pallas (body
// _bt_kernel).  Applies Q2 X (sweeps s = S-1 .. 0) or Q2^T X (s = 0 ..
// S-1) to X (n, m) in place; within sweep s, reflector k updates the b rows
// [s+1+kb, s+1+(k+1)b): P <- P - tau v (v^T P).  Rows at or past n are
// skipped (their v entries are zero; the TPU kernel pads X instead).
//
// What bounds it on the H100: S ~ n sweeps each touch the whole (n, m)
// panel at 4 flops per element, so the flops are 4 S n m while the panel is
// read and written once: operations-bound on the fp32 SIMT units once the
// panel is held on chip, and bound by the sweep-to-sweep dependence.
//
// Design.  The TPU kernel keeps the whole padded panel in VMEM and walks the
// sweeps as a sequential grid.  Here the columns of X are independent, so
// each CTA owns a strip of `cw` columns and walks all S sweeps over it, one
// __syncthreads() between sweeps; within a sweep its threads take (k,
// column) pairs, whose row supports are disjoint.  The (n, cw) strip lives
// in shared memory when it fits the wrapper's budget (read once, written
// once), else in global memory.  Reflectors with tau == 0 (masked slots)
// are skipped.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void backtransform_wy_kernel(float* __restrict__ X, int n, int m,
                                        const float* __restrict__ vs,
                                        const float* __restrict__ taus, int S, int K,
                                        int b, int transpose, int cw, int use_smem) {
  REPRO_DYNAMIC_SMEM(sm);
  const int c0 = blockIdx.x * cw;
  const int nc = min(cw, m - c0);
  float* P = use_smem ? sm : X + c0;
  const long long ld = use_smem ? cw : m;
  if (use_smem) {
    for (long long e = threadIdx.x; e < (long long)n * nc; e += blockDim.x) {
      const long long r = e / nc;
      const int c = (int)(e % nc);
      P[r * ld + c] = X[r * m + c0 + c];
    }
  }
  __syncthreads();
  const int items = K * nc;
  for (int t = 0; t < S; ++t) {
    const int s = transpose ? t : S - 1 - t;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int k = it / nc;
      const int c = it % nc;
      const float tau = taus[(long long)s * K + k];
      if (tau == 0.f) continue;
      const float* v = vs + ((long long)s * K + k) * b;
      const int rbase = s + 1 + k * b;
      const int rend = min(b, n - rbase);
      float proj = 0.f;
      for (int r = 0; r < rend; ++r) proj += v[r] * P[(rbase + r) * ld + c];
      for (int r = 0; r < rend; ++r) P[(rbase + r) * ld + c] -= tau * v[r] * proj;
    }
    __syncthreads();
  }
  if (use_smem) {
    for (long long e = threadIdx.x; e < (long long)n * nc; e += blockDim.x) {
      const long long r = e / nc;
      const int c = (int)(e % nc);
      X[r * m + c0 + c] = P[r * ld + c];
    }
  }
}

}  // namespace

// One launch per call.
extern "C" int backtransform_wy_launch(float* X, int n, int m, const float* vs,
                                       const float* taus, int S, int K, int b, int transpose,
                                       int cw, int use_smem, void* stream) {
  if (n < 1 || m < 1 || cw < 1 || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = use_smem ? n * cw * (int)sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        backtransform_wy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((m + cw - 1) / cw);
  REPRO_LAUNCH(backtransform_wy_kernel, blocks, kThreads, smem, st)
  (X, n, m, vs, taus, S, K, b, transpose, cw, use_smem);
  REPRO_CHECK_LAUNCH();
  return 0;
}
