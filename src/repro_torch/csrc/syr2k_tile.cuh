// The lower-tile SYR2K of kernel D (syr2k.cu) and of kernel A's trailing
// update (fused_panel.cu:trailing_lower): out = C + alpha (A B^T + B A^T)
// over the lower tiles, each tile written with its mirror.
//
// One CTA owns one tile (ti, tj), ti >= tj, for the whole k loop;
// A_i B_j^T + B_i A_j^T is one product of depth 2k.  float32 runs on the
// tensor cores with 3xTF32 (syr2k_tf32_tile): each operand x splits into
// big = tf32(x) and small = tf32(x - big), and big big' + big small' +
// small big' is summed in float32, which keeps float32 accuracy (the
// dropped small small' is ~2^-22 of the product).  The staging and the
// epilogue below are shared with kernel D's bf16 walk (syr2k.cu).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace repro {

// bf16 values are handled as their bits until the epilogue.
typedef unsigned short bf16_bits;

// Tile (ti, tj), ti >= tj, of the t-th lower tile, row-major over the
// triangle (the TPU grid's lower_tile_indices order).
__device__ __forceinline__ void lower_tile(long long t, int& ti, int& tj) {
  ti = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((long long)ti * (ti + 1) / 2 > t) --ti;
  while ((long long)(ti + 1) * (ti + 2) / 2 <= t) ++ti;
  tj = (int)(t - (long long)ti * (ti + 1) / 2);
}

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ float tile_float(float v) { return v; }
__device__ __forceinline__ float tile_float(bf16_bits h) { return __uint_as_float((unsigned)h << 16); }
__device__ __forceinline__ void tile_put(float& d, float v) { d = v; }
__device__ __forceinline__ void tile_put(bf16_bits& d, float v) {
  d = __bfloat16_as_ushort(__float2bfloat16(v));
}

// Stage k columns [k0, k0 + kStrip) of rows [g0, g0 + kTile) of M into dst
// (kTile rows of kRow elements), zeros past `rows` and `kdim`: 16-byte
// cp.async where `vec` (M's rows 16-byte aligned) and the copy fits, else
// element by element.
template <class T, int kTile, int kStrip, int kRow>
__device__ __forceinline__ void stage_strip(T* dst, const T* __restrict__ M, long long ld, int rows,
                                            int kdim, int g0, int k0, bool vec) {
  constexpr int V = 16 / (int)sizeof(T);
  for (int q = threadIdx.x; q < kTile * (kStrip / V); q += blockDim.x) {
    const int r = q / (kStrip / V);
    const int c = (q % (kStrip / V)) * V;
    const int g = g0 + r;
    const int kk = k0 + c;
    T* d = dst + r * kRow + c;
    const T* src = M + (long long)g * ld + kk;
    if (vec && g < rows && kk + V <= kdim) {
      cp_async16(reinterpret_cast<float*>(d), reinterpret_cast<const float*>(src));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) d[e] = (g < rows && kk + e < kdim) ? src[e] : (T)0;
    }
  }
}

// The k loop over `strips` staged strips, kStages - 1 ahead: load(st, s)
// stages strip s into stage st (cp.async or plain stores), body(st)
// computes on stage st.  One commit group per strip (empty past the last),
// so strip s has landed once all but the newest kStages - 1 groups have;
// a stage is refilled only after the barrier that ends its last use.
template <int kStages, class Load, class Body>
__device__ __forceinline__ void strip_pipeline(int strips, Load load, Body body) {
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < strips) load(p, p);
    cp_async_commit();
  }
  for (int s = 0; s < strips; ++s) {
    const int ahead = s + kStages - 1;
    if (ahead < strips) load(ahead % kStages, ahead);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    body(s % kStages);
    __syncthreads();
  }
}

// A warp's m16n8 accumulator fragments (rows wm.., columns wn.. of the
// tile) into the float tile S (leading dimension kOutRow).
template <int kMT, int kNT, int kOutRow>
__device__ __forceinline__ void fragments_to_tile(float* S, const float (&acc)[kMT][kNT][4], int wm,
                                                  int wn) {
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        S[(wm + mt * 16 + g + 8 * (i >> 1)) * kOutRow + wn + nt * 8 + 2 * t + (i & 1)] = acc[mt][nt][i];
}

// The epilogue of lower tile (gi0, gj0) of an n x n result from its sums S
// (kTile x (kTile + 1) floats in shared memory, complete: call after a
// __syncthreads()): out = C + alpha S on the tile and its mirror, from C's
// lower triangle only (C null: zeros).  C and out may be one matrix
// (kernel A updates in place): a CTA reads only its own lower tile, all
// before it writes.  C is read and the tile and, off the diagonal, its
// transpose written as rows, 16 bytes at a time where the leading dimension
// and alignment allow; a diagonal tile's upper half is its lower half
// transposed.  Each value is converted to T once, so tile and mirror are
// equal.
template <class T, int kTile>
__device__ __forceinline__ void store_lower_tile(float* S, const T* C, long long ldc, float alpha,
                                                 T* out, long long ldo, int n, int gi0, int gj0,
                                                 bool diag) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int kOutRow = kTile + 1;
  constexpr int kChunks = kTile * (kTile / V);
  const bool vec_c = C && ldc % V == 0 && aligned16(C);
  for (int q = threadIdx.x; q < kChunks; q += blockDim.x) {
    const int r = q / (kTile / V);
    const int c = (q % (kTile / V)) * V;
    const int gi = gi0 + r;
    const int gj = gj0 + c;
    if (gi >= n || (diag && c > r)) continue;
    alignas(16) T cv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) cv[e] = (T)0;
    if (vec_c && gj + V <= n) {
      *reinterpret_cast<uint4*>(cv) = *reinterpret_cast<const uint4*>(C + (long long)gi * ldc + gj);
    } else if (C) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (gj + e < n) cv[e] = C[(long long)gi * ldc + gj + e];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float* p = S + r * kOutRow + c + e;
      *p = tile_float(cv[e]) + alpha * *p;
    }
  }
  __syncthreads();
  // Rows of the tile, then (off the diagonal) rows of its mirror: V values
  // of a row per store.  Element e of chunk q is (row, col0 + e) of `out`
  // and reads S[sr][sc].
  const bool vec_out = ldo % V == 0 && aligned16(out);
  for (int q = threadIdx.x; q < (diag ? 1 : 2) * kChunks; q += blockDim.x) {
    const bool mirror = q >= kChunks;
    const int qq = mirror ? q - kChunks : q;
    const int r = qq / (kTile / V);
    const int c = (qq % (kTile / V)) * V;
    const int row = (mirror ? gj0 : gi0) + r;
    const int col0 = (mirror ? gi0 : gj0) + c;
    if (row >= n || col0 >= n) continue;
    alignas(16) T v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      int sr = r, sc = c + e;             // the tile
      if (mirror || (diag && sc > sr)) {  // the transpose
        sr = c + e;
        sc = r;
      }
      tile_put(v[e], S[sr * kOutRow + sc]);
    }
    T* dst = out + (long long)row * ldo + col0;
    if (vec_out && col0 + V <= n) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (col0 + e < n) dst[e] = v[e];
    }
  }
}

// ---- float32 on the tensor cores (3xTF32) ---------------------------------
// 64 x 64 tiles, 4 warps of 32 x 32 (2 x 2 over the tile); k in 8-wide
// strips of A_i, B_i, A_j, B_j staged with 16-byte cp.async three deep (a
// diagonal tile stages only A_i, B_i), rows padded to kRow floats so that a
// warp's fragment loads (rows g, columns t: 8 x 4) fall on 32 distinct
// banks.  scripts/syr2k_tile_trial.py builds copies of this header with
// other values and times them.  On the H100 at (n, k) = (3840, 256):
// 128 x 128 tiles (8 warps of 64 x 32, one CTA per SM by their 207
// registers a thread) ran 12 % slower than 64 x 64; deeper pipelines
// gained nothing (the walk is not waiting on its loads).  The strip is one
// k8 step because each strip sums from zero on the tensor cores, which
// round toward zero: the product term came out 3.8e-7 of its mean entry
// too small with 32-wide strips, 1.8e-7 with 16 and 8.6e-8 with 8, for
// 3 % more time.
struct Syr2kF32 {
  static constexpr int kTile = 64;
  static constexpr int kWarpM = 32;
  static constexpr int kWarpN = 32;
  static constexpr int kWarpsN = kTile / kWarpN;
  static constexpr int kThreads = (kTile / kWarpM) * kWarpsN * 32;
  static constexpr int kMT = kWarpM / 16;  // m16 fragments per warp
  static constexpr int kNT = kWarpN / 8;   // n8 fragments per warp
  static constexpr int kStrip = 8;
  static constexpr int kRow = kStrip + 4;
  static constexpr int kStripElems = kTile * kRow;
  static constexpr int kStages = 3;
  static constexpr int kSmem = kStages * 4 * kStripElems * (int)sizeof(float);
  static constexpr int kOutRow = kTile + 1;
};
static_assert(Syr2kF32::kTile * Syr2kF32::kOutRow * (int)sizeof(float) <= Syr2kF32::kSmem,
              "the epilogue tile fits the stages");
static_assert(Syr2kF32::kSmem <= kSmemPerBlockMax, "the stages fit a block's shared memory");
constexpr int kSyr2kTile = Syr2kF32::kTile;

// The split x = big + small, both TF32 (cvt.rna).
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b' in 3xTF32 for rows wm.. of sa and rows wn.. of sb (each a
// staged strip, row-major with kRow floats a row), k columns [kk, kk + 8).
__device__ __forceinline__ void mma_3xtf32_step(float (&acc)[Syr2kF32::kMT][Syr2kF32::kNT][4],
                                                const float* sa, const float* sb, int wm, int wn,
                                                int kk) {
  using W = Syr2kF32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  unsigned ab[W::kMT][4], as[W::kMT][4], bb[W::kNT][2], bs[W::kNT][2];
#pragma unroll
  for (int mt = 0; mt < W::kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_tf32(sa[(wm + mt * 16 + g + 8 * (r & 1)) * W::kRow + kk + t + 4 * (r >> 1)], ab[mt][r],
                 as[mt][r]);
#pragma unroll
  for (int nt = 0; nt < W::kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      split_tf32(sb[(wn + nt * 8 + g) * W::kRow + kk + t + 4 * r], bb[nt][r], bs[nt][r]);
  // The small terms first; each pass over the kMT x kNT fragments issues
  // independent products back to back.
#pragma unroll
  for (int mt = 0; mt < W::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::kNT; ++nt) mma_tf32_1688(acc[mt][nt], as[mt], bb[nt]);
#pragma unroll
  for (int mt = 0; mt < W::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::kNT; ++nt) mma_tf32_1688(acc[mt][nt], ab[mt], bs[nt]);
#pragma unroll
  for (int mt = 0; mt < W::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::kNT; ++nt) mma_tf32_1688(acc[mt][nt], ab[mt], bb[nt]);
}

// One lower tile (the block's tile of the triangle, blockIdx.x) of
// out = C + alpha (A B^T + B A^T), all float32: A, B (n x kdim, leading
// dimension ld), rows past n and k past kdim read as zero; C (leading
// dimension ldc) or null, out (leading dimension ldo; may be C).  sm:
// Syr2kF32::kSmem bytes of dynamic shared memory.  Launch with
// Syr2kF32::kThreads threads.
__device__ __forceinline__ void syr2k_tf32_tile(const float* __restrict__ A,
                                                const float* __restrict__ B, long long ld, int n,
                                                int kdim, float alpha, const float* C, long long ldc,
                                                float* out, long long ldo, float* sm) {
  using W = Syr2kF32;
  int ti, tj;
  lower_tile(blockIdx.x, ti, tj);
  const bool diag = ti == tj;
  const int gi0 = ti * W::kTile;
  const int gj0 = tj * W::kTile;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / W::kWarpsN) * W::kWarpM;
  const int wn = (warp % W::kWarpsN) * W::kWarpN;
  const bool vec = ld % 4 == 0 && aligned16(A) && aligned16(B);

  auto strip = [&](int st, int mtx) { return sm + (st * 4 + mtx) * W::kStripElems; };
  auto load = [&](int st, int s) {
    const int k0 = s * W::kStrip;
    stage_strip<float, W::kTile, W::kStrip, W::kRow>(strip(st, 0), A, ld, n, kdim, gi0, k0, vec);
    stage_strip<float, W::kTile, W::kStrip, W::kRow>(strip(st, 1), B, ld, n, kdim, gi0, k0, vec);
    if (!diag) {
      stage_strip<float, W::kTile, W::kStrip, W::kRow>(strip(st, 2), A, ld, n, kdim, gj0, k0, vec);
      stage_strip<float, W::kTile, W::kStrip, W::kRow>(strip(st, 3), B, ld, n, kdim, gj0, k0, vec);
    }
  };

  float acc[W::kMT][W::kNT][4];
#pragma unroll
  for (int mt = 0; mt < W::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  strip_pipeline<W::kStages>((kdim + W::kStrip - 1) / W::kStrip, load, [&](int st) {
    const float* sAi = strip(st, 0);
    const float* sBi = strip(st, 1);
    const float* sAj = diag ? sAi : strip(st, 2);
    const float* sBj = diag ? sBi : strip(st, 3);
    // The tensor cores round their float32 sums toward zero, which over a
    // long chain drifts by an ulp of the sum per product (4e-6 of max|ref|
    // at k = 256 on the H100); so each strip sums on them from zero, and the
    // strips are summed here, rounded to nearest (the drift left shrinks
    // with the strip, see above).
    float part[W::kMT][W::kNT][4];
#pragma unroll
    for (int mt = 0; mt < W::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < W::kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W::kStrip; kk += 8) {
      mma_3xtf32_step(part, sAi, sBj, wm, wn, kk);  // A_i B_j^T
      mma_3xtf32_step(part, sBi, sAj, wm, wn, kk);  // B_i A_j^T
    }
#pragma unroll
    for (int mt = 0; mt < W::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < W::kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  });

  fragments_to_tile<W::kMT, W::kNT, W::kOutRow>(sm, acc, wm, wn);
  __syncthreads();
  store_lower_tile<float, W::kTile>(sm, C, ldc, alpha, out, ldo, n, gi0, gj0, diag);
}

}  // namespace repro
