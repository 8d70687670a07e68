// Kernel D: the symmetric rank-2k update out = C + alpha (A B^T + B A^T).
//
// Replaces repro/kernels/syr2k.py:syr2k_lower_pallas together with the
// padding and symmetrization of its wrapper repro/kernels/ops.py:syr2k.  The
// DBR trailing update C - Z Y^T - Y Z^T is the alpha = -1 case
// (registry op trailing_update); the unfused first stage makes one call per
// block, at (n - w, k) = (3840, 256) first on the n = 4096 path.
//
// What bounds it on the H100: 2 n^2 k flops over the lower triangle against
// (n^2 + 2 n k) * (4 or 2) bytes.  Both dtypes run on the tensor cores.  In
// float32 (3xTF32: three TF32 products per product) at k = 256 that is
// operations-bound, 3 * 2 n^2 k flops over the TF32 rate; in bf16 it is
// bytes-bound (C's lower triangle in, the full out).
//
// Design.  The TPU kernel's grid enumerates only the lower tiles and
// carries each tile over a sequential k grid dimension in VMEM.  Here one
// CTA owns one lower tile for the whole k loop, then writes the tile and
// its mirror, so the result is exactly symmetric and built from C's lower
// triangle only, as ops.syr2k's tril(low) + tril(low, -1).T is.  Ragged
// edges are masked, not padded; C may be absent (zeros) and may be a
// strided view (leading dimension ldc).  Out of place: out is a new matrix.
// A bucket of `batch` updates (the counterpart of the batching rule that
// jax.vmap gives the Pallas kernel) is one launch, the matrix taken from
// blockIdx.y.
// Both walks stage k in strips with 16-byte cp.async (zero-filled past k
// and n, element by element where a 16-byte copy does not fit or is
// misaligned) through the pipeline of syr2k_tile.cuh, and share its
// epilogue: a float tile in shared memory, C's lower tile read with
// 16-byte loads, the tile and, off the diagonal, its transpose written as
// rows with 16-byte stores; a diagonal tile's upper half is its lower half
// transposed.
//  - float32: the walk of syr2k_tile.cuh (shared with kernel A's trailing
//    update): 64 x 64 tiles, 4 warps of 32 x 32, 8-wide float strips three
//    stages deep, mma.sync m16n8k8 TF32 with each operand split into
//    big + small (3xTF32) and each strip summed from zero on the tensor
//    cores, which keeps float32 accuracy.
//  - bf16 (the TPU kernel's bf16 operands with preferred_element_type=
//    float32 and one cast to C's dtype): 64 x 64 tiles, mma.sync m16n8k16
//    with float32 accumulation, four warps of 32 x 32, 32-wide bf16 strips;
//    each value is rounded to bf16 once, so tile and mirror are equal.
#include "syr2k_tile.cuh"

namespace {

using repro::bf16_bits;

__global__ void __launch_bounds__(repro::Syr2kF32::kThreads)
    syr2k_lower(const float* __restrict__ A, const float* __restrict__ B, long long ldab,
                long long sab, int n, int k, float alpha, const float* __restrict__ C,
                long long ldc, long long sc, float* __restrict__ out) {
  REPRO_DYNAMIC_SMEM(sm);
  const long long z = blockIdx.y;
  repro::syr2k_tf32_tile(A + z * sab, B + z * sab, ldab, n, k, alpha, C ? C + z * sc : C, ldc,
                         out + z * n * n, n, sm);
}

// ---- bf16 on the tensor cores --------------------------------------------
constexpr int kTile = 64;
constexpr int kStrip = 32;             // k per stage
constexpr int kRow = kStrip + 8;       // padded row of a staged strip: 80 bytes,
                                       // conflict-free 32-bit fragment loads
constexpr int kStripElems = kTile * kRow;
constexpr int kStages = 2;
constexpr int kMmaThreads = 128;       // 4 warps, 2 x 2 over the tile
constexpr int kOutRow = kTile + 1;     // the epilogue's float tile
constexpr int kMmaSmem = kStages * 4 * kStripElems * (int)sizeof(bf16_bits);
static_assert(kTile * kOutRow * (int)sizeof(float) <= kMmaSmem, "epilogue tile fits the stages");

__device__ __forceinline__ unsigned word(const bf16_bits* s, int row, int col) {
  return *reinterpret_cast<const unsigned*>(s + row * kRow + col);
}

__global__ void __launch_bounds__(kMmaThreads)
    syr2k_lower_bf16(const bf16_bits* __restrict__ A, const bf16_bits* __restrict__ B,
                     long long ldab, long long sab, int n, int k, float alpha,
                     const bf16_bits* __restrict__ C, long long ldc, long long sc,
                     bf16_bits* __restrict__ out) {
  REPRO_DYNAMIC_SMEM(sm_f);
  {
    const long long z = blockIdx.y;
    A += z * sab;
    B += z * sab;
    if (C) C += z * sc;
    out += z * n * n;
  }
  bf16_bits* sm = reinterpret_cast<bf16_bits*>(sm_f);
  int ti, tj;
  repro::lower_tile(blockIdx.x, ti, tj);
  const bool diag = ti == tj;
  const int gi0 = ti * kTile;
  const int gj0 = tj * kTile;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (tid / 32) / 2 * 32;  // the warp's rows and columns in the tile
  const int wn = (tid / 32) % 2 * 32;
  const bool vec = ldab % 8 == 0 && repro::aligned16(A) && repro::aligned16(B);

  // Stage st holds A_i, B_i, A_j, B_j; a diagonal tile stages only A_i, B_i.
  auto strip = [&](int st, int m) { return sm + (st * 4 + m) * kStripElems; };
  auto load = [&](int st, int s) {
    using repro::stage_strip;
    const int k0 = s * kStrip;
    stage_strip<bf16_bits, kTile, kStrip, kRow>(strip(st, 0), A, ldab, n, k, gi0, k0, vec);
    stage_strip<bf16_bits, kTile, kStrip, kRow>(strip(st, 1), B, ldab, n, k, gi0, k0, vec);
    if (!diag) {
      stage_strip<bf16_bits, kTile, kStrip, kRow>(strip(st, 2), A, ldab, n, k, gj0, k0, vec);
      stage_strip<bf16_bits, kTile, kStrip, kRow>(strip(st, 3), B, ldab, n, k, gj0, k0, vec);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  repro::strip_pipeline<kStages>((k + kStrip - 1) / kStrip, load, [&](int st) {
    const bf16_bits* sAi = strip(st, 0);
    const bf16_bits* sBi = strip(st, 1);
    const bf16_bits* sAj = diag ? sAi : strip(st, 2);
    const bf16_bits* sBj = diag ? sBi : strip(st, 3);
#pragma unroll
    for (int kk = 0; kk < kStrip; kk += 16) {
      unsigned aA[2][4], aB[2][4], bA[4][2], bB[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = wm + mt * 16 + g + 8 * (r & 1);
          const int col = kk + 2 * t + 8 * (r >> 1);
          aA[mt][r] = word(sAi, row, col);
          aB[mt][r] = word(sBi, row, col);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wn + nt * 8 + g;
          const int col = kk + 2 * t + 8 * r;
          bA[nt][r] = word(sAj, row, col);
          bB[nt][r] = word(sBj, row, col);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          repro::mma_bf16_16816(acc[mt][nt], aA[mt], bB[nt]);  // A_i B_j^T
          repro::mma_bf16_16816(acc[mt][nt], aB[mt], bA[nt]);  // B_i A_j^T
        }
      }
    }
  });

  repro::fragments_to_tile<2, 4, kOutRow>(sm_f, acc, wm, wn);
  __syncthreads();
  repro::store_lower_tile<bf16_bits, kTile>(sm_f, C, ldc, alpha, out, n, n, gi0, gj0, diag);
}

}  // namespace

// One launch, whatever its batch.  A, B: `batch` (n, k) row-major with
// leading dimension ldab, matrix z at z * sab; C: `batch` (n, n) with
// leading dimension ldc, matrix z at z * sc, or null for zeros; out:
// (batch, n, n) contiguous.  batch <= 65535 (gridDim.y).  bf16: 0 for
// float32 operands, 1 for bf16.
extern "C" int syr2k_launch(const void* A, const void* B, long long ldab, long long sab, int n,
                            int k, float alpha, const void* C, long long ldc, long long sc,
                            void* out, int bf16, int batch, void* stream) {
  if (n < 1 || k < 0 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto tiles = [n, batch](int tile) {
    const long long nt = (n + tile - 1) / tile;
    return dim3((unsigned)(nt * (nt + 1) / 2), (unsigned)batch);
  };
  if (bf16) {
    REPRO_LAUNCH(syr2k_lower_bf16, tiles(kTile), kMmaThreads, kMmaSmem, st)
    ((const bf16_bits*)A, (const bf16_bits*)B, ldab, sab, n, k, alpha, (const bf16_bits*)C, ldc, sc,
     (bf16_bits*)out);
  } else {
    using W = repro::Syr2kF32;
    cudaError_t err = cudaFuncSetAttribute(syr2k_lower, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           W::kSmem);
    if (err != cudaSuccess) return (int)err;
    REPRO_LAUNCH(syr2k_lower, tiles(W::kTile), W::kThreads, W::kSmem, st)
    ((const float*)A, (const float*)B, ldab, sab, n, k, alpha, (const float*)C, ldc, sc, (float*)out);
  }
  REPRO_CHECK_LAUNCH();
  return 0;
}
