// The lower-tile SYR2K walk shared by kernel A's trailing update
// (fused_panel.cu:trailing_lower) and kernel D (syr2k.cu): one CTA of
// kSyr2kThreads threads per 64 x 64 tile of the lower triangle, each thread
// a 4 x 4 block of the tile, k in 16-wide strips staged in shared memory.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kSyr2kTile = 64;
constexpr int kSyr2kStrip = 16;
constexpr int kSyr2kThreads = 256;

// Tile (ti, tj), ti >= tj, of the t-th lower tile, row-major over the
// triangle (the TPU grid's lower_tile_indices order).
__device__ __forceinline__ void lower_tile(long long t, int& ti, int& tj) {
  ti = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((long long)ti * (ti + 1) / 2 > t) --ti;
  while ((long long)(ti + 1) * (ti + 2) / 2 <= t) ++ti;
  tj = (int)(t - (long long)ti * (ti + 1) / 2);
}

// acc[a][c] = sum_k A[i][k] B[j][k] + B[i][k] A[j][k] for row
// i = gi0 + (threadIdx.x / 16) * 4 + a and j = gj0 + (threadIdx.x % 16) * 4 + c
// of A, B (rows, kdim), leading dimension ld.  Rows past `rows` and k past
// `kdim` read as zero.  Contains __syncthreads(): call from all threads.
__device__ __forceinline__ void syr2k_tile_acc(const float* __restrict__ A,
                                               const float* __restrict__ B, long long ld,
                                               int rows, int kdim, int gi0, int gj0,
                                               float (&acc)[4][4]) {
  __shared__ float sAi[kSyr2kStrip][kSyr2kTile + 1];
  __shared__ float sBi[kSyr2kStrip][kSyr2kTile + 1];
  __shared__ float sAj[kSyr2kStrip][kSyr2kTile + 1];
  __shared__ float sBj[kSyr2kStrip][kSyr2kTile + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  for (int k0 = 0; k0 < kdim; k0 += kSyr2kStrip) {
    for (int e = threadIdx.x; e < kSyr2kTile * kSyr2kStrip; e += blockDim.x) {
      const int r = e / kSyr2kStrip;
      const int kk = e % kSyr2kStrip;
      const int k = k0 + kk;
      const int gi = gi0 + r;
      const int gj = gj0 + r;
      const bool ok_i = k < kdim && gi < rows;
      const bool ok_j = k < kdim && gj < rows;
      const long long oi = (long long)gi * ld + k;
      const long long oj = (long long)gj * ld + k;
      sAi[kk][r] = ok_i ? A[oi] : 0.f;
      sBi[kk][r] = ok_i ? B[oi] : 0.f;
      sAj[kk][r] = ok_j ? A[oj] : 0.f;
      sBj[kk][r] = ok_j ? B[oj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSyr2kStrip; ++kk) {
      float ai[4], bi[4], aj[4], bj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ai[a] = sAi[kk][ty * 4 + a];
        bi[a] = sBi[kk][ty * 4 + a];
        aj[a] = sAj[kk][tx * 4 + a];
        bj[a] = sBj[kk][tx * 4 + a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] += ai[a] * bj[c] + bi[a] * aj[c];
    }
    __syncthreads();
  }
}

}  // namespace repro
