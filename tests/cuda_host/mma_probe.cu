// One warp's repro::mma_bf16_16816 on a 16 x 16 by 16 x 8 bf16 product, its
// fragments gathered from row-major A (16 x 16) and B (16 x 8, k x n) by the
// PTX layout that csrc/common.cuh states, and D (16 x 8, float32) scattered
// back by it.  tests/test_torch_kernels_host.py holds D against a float
// matmul.
#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned pack(unsigned short lo, unsigned short hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

__global__ void mma_probe_kernel(const unsigned short* A, const unsigned short* B, float* D) {
  const int g = threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  unsigned a[4], b[2];
  for (int r = 0; r < 4; ++r) {
    const int row = g + 8 * (r & 1);
    const int col = 2 * t + 8 * (r >> 1);
    a[r] = pack(A[row * 16 + col], A[row * 16 + col + 1]);
  }
  for (int r = 0; r < 2; ++r) {
    const int kk = 2 * t + 8 * r;
    b[r] = pack(B[kk * 8 + g], B[(kk + 1) * 8 + g]);
  }
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  repro::mma_bf16_16816(d, a, b);
  for (int i = 0; i < 4; ++i) D[(g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] = d[i];
}

}  // namespace

extern "C" int mma_probe_launch(const void* A, const void* B, float* D) {
  REPRO_LAUNCH(mma_probe_kernel, 1, 32, 0, nullptr)
  ((const unsigned short*)A, (const unsigned short*)B, D);
  REPRO_CHECK_LAUNCH();
  return 0;
}
