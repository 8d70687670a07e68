// Kernel D: the symmetric rank-2k update out = C + alpha (A B^T + B A^T).
//
// Replaces repro/kernels/syr2k.py:syr2k_lower_pallas together with the
// padding and symmetrization of its wrapper repro/kernels/ops.py:syr2k.  The
// DBR trailing update C - Z Y^T - Y Z^T is the alpha = -1 case
// (registry op trailing_update); the unfused first stage makes one call per
// block, at (n - w, k) = (3840, 256) first on the n = 4096 path.
//
// What bounds it on the H100: 2 n^2 k flops over the lower triangle against
// (n^2 + 2 n k) * (4 or 2) bytes.  In float32 at k = 256 that is
// operations-bound on the SIMT units; in bf16, with the products on the
// tensor cores, it is bytes-bound (C's lower triangle in, the full out).
//
// Design.  The TPU kernel's grid enumerates only the lower tiles and
// carries each tile over a sequential k grid dimension in VMEM.  Here one
// CTA owns one 64 x 64 lower tile for the whole k loop, then writes the
// tile and its mirror, so the result is exactly symmetric and built from
// C's lower triangle only, as ops.syr2k's tril(low) + tril(low, -1).T is.
// Ragged edges are masked, not padded; C may be absent (zeros) and may be a
// strided view (leading dimension ldc).  Out of place: out is a new matrix.
//  - float32: the tile walk of csrc/syr2k_tile.cuh (shared with kernel A),
//    k in 16-wide strips of A_i, B_i, A_j, B_j in shared memory, a 4 x 4
//    register block per thread on the SIMT units.
//  - bf16 (the TPU kernel's bf16 operands with preferred_element_type=
//    float32 and one cast to C's dtype): the products on the tensor cores,
//    mma.sync m16n8k16 with float32 accumulation, four warps of 32 x 32.
//    k comes in 32-wide bf16 strips staged with 16-byte cp.async, two
//    stages deep (zero-filled past k and n, element by element where a
//    16-byte copy does not fit or is misaligned).  The epilogue goes through
//    a float tile in shared memory: C's lower tile read with 16-byte loads,
//    the tile and, off the diagonal, its transpose written as rows with
//    16-byte stores; a diagonal tile's upper half is its lower half
//    transposed.  Each value is rounded to bf16 once, so tile and mirror
//    are equal.
#include <cuda_bf16.h>

#include <cstdint>

#include "syr2k_tile.cuh"

namespace {

__global__ void syr2k_lower(const float* __restrict__ A, const float* __restrict__ B,
                            long long ldab, int n, int k, float alpha,
                            const float* __restrict__ C, long long ldc, float* __restrict__ out) {
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
        const float c_in = C ? C[(long long)i * ldc + j] : 0.f;
        const float val = c_in + alpha * acc[a][c];
        out[(long long)i * n + j] = val;
        out[(long long)j * n + i] = val;
      }
    }
  }
}

// ---- bf16 on the tensor cores --------------------------------------------
// bf16 values are handled as their bits (unsigned short) until the epilogue.
typedef unsigned short bf16_bits;

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

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}
__device__ __forceinline__ float bf16_to_float(bf16_bits h) {
  return __uint_as_float((unsigned)h << 16);
}
__device__ __forceinline__ bf16_bits float_to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// Stage k columns [k0, k0 + kStrip) of rows [g0, g0 + kTile) of M into dst
// (kTile x kRow), zeros past `rows` and `kdim`.
__device__ __forceinline__ void stage_strip(bf16_bits* dst, const bf16_bits* __restrict__ M,
                                            long long ld, int rows, int kdim, int g0, int k0,
                                            bool vec) {
  for (int q = threadIdx.x; q < kTile * (kStrip / 8); q += blockDim.x) {
    const int r = q / (kStrip / 8);
    const int c = (q % (kStrip / 8)) * 8;
    const int g = g0 + r;
    const int kk = k0 + c;
    bf16_bits* d = dst + r * kRow + c;
    const bf16_bits* src = M + (long long)g * ld + kk;
    if (vec && g < rows && kk + 8 <= kdim) {
      repro::cp_async16(reinterpret_cast<float*>(d), reinterpret_cast<const float*>(src));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = (g < rows && kk + e < kdim) ? src[e] : (bf16_bits)0;
    }
  }
}

__device__ __forceinline__ unsigned word(const bf16_bits* s, int row, int col) {
  return *reinterpret_cast<const unsigned*>(s + row * kRow + col);
}

__global__ void __launch_bounds__(kMmaThreads)
    syr2k_lower_bf16(const bf16_bits* __restrict__ A, const bf16_bits* __restrict__ B,
                     long long ldab, int n, int k, float alpha, const bf16_bits* __restrict__ C,
                     long long ldc, bf16_bits* __restrict__ out) {
  REPRO_DYNAMIC_SMEM(sm_f);
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
  const bool vec = ldab % 8 == 0 && aligned16(A) && aligned16(B);

  // Stage st holds A_i, B_i, A_j, B_j; a diagonal tile stages only A_i, B_i.
  auto strip = [&](int st, int m) { return sm + (st * 4 + m) * kStripElems; };
  auto load = [&](int st, int k0) {
    stage_strip(strip(st, 0), A, ldab, n, k, gi0, k0, vec);
    stage_strip(strip(st, 1), B, ldab, n, k, gi0, k0, vec);
    if (!diag) {
      stage_strip(strip(st, 2), A, ldab, n, k, gj0, k0, vec);
      stage_strip(strip(st, 3), B, ldab, n, k, gj0, k0, vec);
    }
    repro::cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int strips = (k + kStrip - 1) / kStrip;
  if (strips > 0) load(0, 0);
  for (int sidx = 0; sidx < strips; ++sidx) {
    const int st = sidx % kStages;
    if (sidx + 1 < strips) {
      load((sidx + 1) % kStages, (sidx + 1) * kStrip);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
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
    __syncthreads();
  }

  // Epilogue: S = the tile in float, then S = C + alpha S on the lower part.
  float* S = sm_f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        S[(wm + mt * 16 + g + 8 * (i >> 1)) * kOutRow + wn + nt * 8 + 2 * t + (i & 1)] =
            acc[mt][nt][i];
  __syncthreads();
  const bool vec_c = C && ldc % 8 == 0 && aligned16(C);
  for (int q = tid; q < kTile * (kTile / 8); q += blockDim.x) {
    const int r = q / (kTile / 8);
    const int c = (q % (kTile / 8)) * 8;
    const int gi = gi0 + r;
    const int gj = gj0 + c;
    if (gi >= n || (diag && c > r)) continue;
    alignas(16) bf16_bits cv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (vec_c && gj + 8 <= n) {
      *reinterpret_cast<uint4*>(cv) = *reinterpret_cast<const uint4*>(C + (long long)gi * ldc + gj);
    } else if (C) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (gj + e < n) cv[e] = C[(long long)gi * ldc + gj + e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float* p = S + r * kOutRow + c + e;
      *p = bf16_to_float(cv[e]) + alpha * *p;
    }
  }
  __syncthreads();
  // Rows of the tile, then (off the diagonal) rows of its mirror: 8 values
  // of a row per store.  Element e of chunk q is (row, col0 + e) of `out`
  // and reads S[sr + e * dr][sc + e * dc].
  const bool vec_out = n % 8 == 0 && aligned16(out);
  for (int q = tid; q < (diag ? 1 : 2) * kTile * (kTile / 8); q += blockDim.x) {
    const bool mirror = q >= kTile * (kTile / 8);
    const int qq = mirror ? q - kTile * (kTile / 8) : q;
    const int r = qq / (kTile / 8);
    const int c = (qq % (kTile / 8)) * 8;
    const int row = (mirror ? gj0 : gi0) + r;
    const int col0 = (mirror ? gi0 : gj0) + c;
    if (row >= n || col0 >= n) continue;
    alignas(16) bf16_bits v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int sr = r, sc = c + e;                     // the tile
      if (mirror || (diag && sc > sr)) {          // the transpose
        sr = c + e;
        sc = r;
      }
      v[e] = float_to_bf16(S[sr * kOutRow + sc]);
    }
    bf16_bits* dst = out + (long long)row * n + col0;
    if (vec_out && col0 + 8 <= n) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col0 + e < n) dst[e] = v[e];
    }
  }
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
  const long long nt = (n + repro::kSyr2kTile - 1) / repro::kSyr2kTile;
  const unsigned tiles = (unsigned)(nt * (nt + 1) / 2);
  if (bf16) {
    REPRO_LAUNCH(syr2k_lower_bf16, tiles, kMmaThreads, kMmaSmem, st)
    ((const bf16_bits*)A, (const bf16_bits*)B, ldab, n, k, alpha, (const bf16_bits*)C, ldc,
     (bf16_bits*)out);
  } else {
    REPRO_LAUNCH(syr2k_lower, tiles, repro::kSyr2kThreads, 0, st)
    ((const float*)A, (const float*)B, ldab, n, k, alpha, (const float*)C, ldc, (float*)out);
  }
  REPRO_CHECK_LAUNCH();
  return 0;
}
