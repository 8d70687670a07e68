// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// Each .cu file in this directory is compiled on its own by nvcc into a
// shared library with a plain C interface (see repro_torch/kernels/cuda_lib.py)
// and loaded with ctypes.  Every exported function launches on the stream it
// is given, allocates nothing, and returns cudaGetLastError() as an int.
#pragma once

#include <cuda_runtime.h>

// Launch and dynamic shared memory go through macros so that the host
// emulation in tests/cuda_host/ can compile these sources with g++.
#ifndef REPRO_LAUNCH
#define REPRO_LAUNCH(kern, grid, block, smem, stream) \
  kern<<<(grid), (block), (smem), (stream)>>>
#endif
#ifndef REPRO_DYNAMIC_SMEM
#define REPRO_DYNAMIC_SMEM(name) extern __shared__ float name[]
#endif

#define REPRO_CHECK_LAUNCH()                \
  do {                                      \
    cudaError_t err_ = cudaGetLastError();  \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

namespace repro {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum the first `cnt` entries of `v` (cnt <= N) over the whole block.  Every
// thread gets the totals back in `v`.  `red` is shared scratch of at least
// 32 * N floats.  Contains __syncthreads(): call from all threads.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], int cnt, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < cnt) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < cnt) red[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < cnt) {
      float s = 0.f;
      for (int wi = 0; wi < nwarps; ++wi) s += red[wi * N + i];
      v[i] = s;
    }
  }
  __syncthreads();
}

}  // namespace repro
