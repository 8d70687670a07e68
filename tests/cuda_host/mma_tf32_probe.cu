// One warp's repro::mma_tf32_1688 on a 16 x 8 by 8 x 8 product of float32
// values rounded with repro::to_tf32, its fragments gathered from row-major
// A (16 x 8) and B (8 x 8, k x n) by the PTX layout that csrc/common.cuh
// states, and D (16 x 8, float32) scattered back by it; RA (16 x 8) gets
// the TF32 bits of A.  tests/test_torch_kernels_host.py holds RA against
// the rounding computed in numpy and D against a float64 matmul.
#include "common.cuh"

namespace {

__global__ void mma_tf32_probe_kernel(const float* A, const float* B, float* D, unsigned* RA) {
  const int g = threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  unsigned a[4], b[2];
  for (int r = 0; r < 4; ++r) {
    const int row = g + 8 * (r & 1);
    const int col = t + 4 * (r >> 1);
    a[r] = repro::to_tf32(A[row * 8 + col]);
    RA[row * 8 + col] = a[r];
  }
  for (int r = 0; r < 2; ++r) b[r] = repro::to_tf32(B[(t + 4 * r) * 8 + g]);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  repro::mma_tf32_1688(d, a, b);
  for (int i = 0; i < 4; ++i) D[(g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] = d[i];
}

}  // namespace

extern "C" int mma_tf32_probe_launch(const float* A, const float* B, float* D, unsigned* RA) {
  REPRO_LAUNCH(mma_tf32_probe_kernel, 1, 32, 0, nullptr)(A, B, D, RA);
  REPRO_CHECK_LAUNCH();
  return 0;
}
