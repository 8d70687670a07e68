// Kernel D: the symmetric rank-2k update out = C + alpha (A B^T + B A^T).
//
// Replaces repro/kernels/syr2k.py:syr2k_lower_pallas together with the
// padding and symmetrization of its wrapper repro/kernels/ops.py:syr2k.  The
// DBR trailing update C - Z Y^T - Y Z^T is the alpha = -1 case
// (registry op trailing_update); the unfused first stage makes one call per
// block, at (n - w, k) = (3840, 256) first on the n = 4096 path.
//
// What bounds it on the H100: 2 n^2 k flops over the lower triangle against
// (n^2 + 2 n k) * 4 bytes, so at k = 256 it is operations-bound on the fp32
// SIMT units here (tensor cores / wgmma are a later PR's work).
//
// Design.  The TPU kernel's grid enumerates only the lower tiles and
// carries each tile over a sequential k grid dimension in VMEM.  Here one
// CTA owns one 64 x 64 lower tile for the whole k loop (the tile walk of
// csrc/syr2k_tile.cuh: k in 16-wide strips of A_i, B_i, A_j, B_j in shared
// memory, a 4 x 4 register block per thread), then writes the tile and its
// mirror, so the result is exactly symmetric and built from C's lower
// triangle only, as ops.syr2k's tril(low) + tril(low, -1).T is.  Ragged
// edges are masked, not padded; C may be absent (zeros) and may be a
// strided view (leading dimension ldc).  Out of place: out is a new matrix.
// A, B, C and out are all float32 or all bf16: bf16 is loaded as such,
// summed in float32 and rounded once to bf16 on the way out (the TPU
// kernel's preferred_element_type=float32 with a cast to C's dtype).
#include "syr2k_tile.cuh"

namespace {

template <class T>
__global__ void syr2k_lower(const T* __restrict__ A, const T* __restrict__ B,
                            long long ldab, int n, int k, float alpha,
                            const T* __restrict__ C, long long ldc, T* __restrict__ out) {
  int ti, tj;
  repro::lower_tile(blockIdx.x, ti, tj);
  const int gi0 = ti * repro::kSyr2kTile;
  const int gj0 = tj * repro::kSyr2kTile;
  float acc[4][4];
  repro::syr2k_tile_acc(A, B, ldab, n, k, gi0, gj0, acc);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = gi0 + ty * 4 + a;
      const int j = gj0 + tx * 4 + c;
      if (i < n && j < n && i >= j) {
        const float c_in = C ? repro::to_float(C[(long long)i * ldc + j]) : 0.f;
        const float val = c_in + alpha * acc[a][c];
        repro::store_as(out + (long long)i * n + j, val);
        repro::store_as(out + (long long)j * n + i, val);
      }
    }
  }
}

template <class T>
int run(const void* A, const void* B, long long ldab, int n, int k, float alpha,
        const void* C, long long ldc, void* out, cudaStream_t st) {
  const long long nt = (n + repro::kSyr2kTile - 1) / repro::kSyr2kTile;
  REPRO_LAUNCH(syr2k_lower<T>, (unsigned)(nt * (nt + 1) / 2), repro::kSyr2kThreads, 0, st)
  ((const T*)A, (const T*)B, ldab, n, k, alpha, (const T*)C, ldc, (T*)out);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// One launch.  A, B: (n, k) row-major with leading dimension ldab; C: (n, n)
// with leading dimension ldc, or null for zeros; out: (n, n) contiguous.
// bf16: 0 for float32 operands, 1 for bf16.
extern "C" int syr2k_launch(const void* A, const void* B, long long ldab, int n, int k,
                            float alpha, const void* C, long long ldc, void* out, int bf16,
                            void* stream) {
  if (n < 1 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return run<__nv_bfloat16>(A, B, ldab, n, k, alpha, C, ldc, out, st);
  return run<float>(A, B, ldab, n, k, alpha, C, ldc, out, st);
}
