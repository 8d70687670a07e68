// Kernel A: one fused DBR block step (first stage of the two-stage EVD).
//
// Replaces repro/kernels/fused_panel.py:fused_panel_update_pallas (body
// _fused_kernel, with repro/kernels/panel.py:panel_qr_body(lapack_sign=True)
// inlined).  On a trailing view Bv (m, m), leading dimension ldb, it factors
// the first w = q*b columns to bandwidth b with q compensated panel QRs and
// applies the rank-2w update C - Z V^T - V Z^T to the trailing (m-w, m-w)
// block, in place.
//
// What bounds it on the H100: the panel phase is a sequence of q GEMVs
// M = Bv * Vhat over the (m, m-r0) view, so it reads the trailing view q
// times at 2b flops per 4-byte element (bytes-bound, as LAPACK's latrd
// is; the view stays in the 50 MB L2 below m ~ 3600); the trailing update
// is a rank-2w SYR2K over the lower tiles (2*(m-w)^2*w flops:
// operations-bound, on the fp32 SIMT units here).
//
// Design.  The TPU kernel runs the whole block as one sequential grid over a
// VMEM-resident view.  Here the sequential part is kept to one small CTA per
// panel and the rest spreads over the SMs, with the factors passed through
// L2 between launches.  Per panel j (c0 = j*b, r0 = c0 + b):
//   K1 panel_prep    many CTAs  P = Bv[:, c0:c0+b] - Z V[c0:c0+b]^T - V Z[c0:c0+b]^T
//   K2 panel_qr      one CTA    b-step LAPACK-sign Householder QR of P[r0:m],
//                               larft, writes V, Vh, F columns and T_j.  The
//                               (m-r0, b) panel lives in shared memory up to
//                               qr_smem_max bytes and in global memory above.
//   K3 panel_xred    many CTAs  X1 = V[:, :c0]^T Vhat, X2 = Z[:, :c0]^T Vhat
//                               (reduction over m by atomics)
//   K4 panel_gemv    warp/row   M = Bv Vhat - Z X1 - V X2, MT = M T_j and
//                               Y = Vhat^T MT (atomics)
//   K5 panel_zfinal  many CTAs  Z_j = MT - 1/2 Vhat (T_j^T Y)
// then, once per block:
//   K6 trailing_lower  one CTA per lower 64x64 tile of the trailing block,
//                      k = w in 16-wide shared-memory strips (the tile walk
//                      of csrc/syr2k_tile.cuh); writes the tile and its mirror
//   K7 write_f         the exact banded values F into Bv[:, :w] and F^T into
//                      Bv[:w, w:]
// Every product of the TPU kernel's body stays inside these kernels (no
// cuBLAS).  Tensor cores, TMA and wgmma are later work.
#include "panel_qr.cuh"
#include "syr2k_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = repro::kSyr2kTile;
constexpr int kGemvSmemMax = 96 * 1024;

__global__ void panel_prep(const float* __restrict__ Bv, long long ldb, int m, int w,
                           int b, int c0, const float* __restrict__ V,
                           const float* __restrict__ Z, float* __restrict__ P,
                           float* __restrict__ X, int nx, float* __restrict__ Y, int ny) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < nx) X[idx] = 0.f;
  if (idx < ny) Y[idx] = 0.f;
  if (idx >= (long long)m * b) return;
  const int i = (int)(idx / b);
  const int cc = (int)(idx % b);
  const int r = c0 + cc;
  const float* zi = Z + (long long)i * w;
  const float* vi = V + (long long)i * w;
  const float* vr = V + (long long)r * w;
  const float* zr = Z + (long long)r * w;
  float s1 = 0.f, s2 = 0.f;
  for (int c = 0; c < c0; ++c) {
    s1 += zi[c] * vr[c];
    s2 += vi[c] * zr[c];
  }
  P[idx] = Bv[(long long)i * ldb + r] - s1 - s2;
}

// Householder QR of the (rows, b) panel P[r0:m] with LAPACK signs (port of
// panel_qr_body(lapack_sign=True), csrc/panel_qr.cuh), then larft.  One CTA.
template <int BM>
__global__ void panel_qr(float* __restrict__ P, int m, int w, int b, int c0, int jpanel,
                         int use_smem, float* __restrict__ V, float* __restrict__ Vh,
                         float* __restrict__ F, float* __restrict__ Ts) {
  REPRO_DYNAMIC_SMEM(smem);
  __shared__ float red[32 * BM];
  __shared__ float s_tau[BM];
  __shared__ float s_scal[2];
  __shared__ float s_T[BM * BM];
  __shared__ float s_VtV[BM * BM];
  const int r0 = c0 + b;
  const int rows = m - r0;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* Wk = use_smem ? smem : P + (long long)r0 * b;
  if (use_smem)
    for (int e = tid; e < rows * b; e += nt) Wk[e] = P[(long long)r0 * b + e];
  __syncthreads();
  repro::householder_panel<BM, true>(Wk, rows, b, red, s_tau, s_scal);
  repro::larft_panel<BM>(Wk, rows, b, red, s_tau, s_VtV, s_T);
  for (int e = tid; e < b * b; e += nt)
    Ts[(long long)jpanel * b * b + e] = s_T[(e / b) * BM + (e % b)];

  // V and Vh columns, and the exact final (banded) values F of the panel.
  for (int e = tid; e < m * b; e += nt) {
    const int i = e / b;
    const int cc = e % b;
    float v = 0.f;
    float f = 0.f;
    if (i >= r0) {
      const int li = i - r0;
      v = li == cc ? 1.f : (li > cc ? Wk[li * b + cc] : 0.f);
      Vh[li * b + cc] = v;
      if (li < b && li <= cc) f = Wk[li * b + cc];  // R
    } else {
      f = P[e];  // compensated panel above the elimination point
    }
    if (i < c0 + cc - b) f = 0.f;  // exact zeros above the band
    V[(long long)i * w + c0 + cc] = v;
    F[(long long)i * w + c0 + cc] = f;
  }
}

// X1 = V[:, :c0]^T Vhat and X2 = Z[:, :c0]^T Vhat, partial sums over a chunk
// of rows per CTA, added with atomics (X was zeroed by panel_prep).
template <int BM>
__global__ void panel_xred(const float* __restrict__ V, const float* __restrict__ Z,
                           const float* __restrict__ Vh, int m, int w, int b, int r0,
                           int c0, int chunk, float* __restrict__ X) {
  const int i0 = r0 + blockIdx.x * chunk;
  const int i1 = min(m, i0 + chunk);
  for (int c = threadIdx.x; c < c0; c += blockDim.x) {
    float a1[BM], a2[BM];
#pragma unroll
    for (int cc = 0; cc < BM; ++cc) a1[cc] = a2[cc] = 0.f;
    for (int i = i0; i < i1; ++i) {
      const float v = V[(long long)i * w + c];
      const float z = Z[(long long)i * w + c];
      const float* vh = Vh + (long long)(i - r0) * b;
#pragma unroll
      for (int cc = 0; cc < BM; ++cc)
        if (cc < b) {
          a1[cc] += v * vh[cc];
          a2[cc] += z * vh[cc];
        }
    }
#pragma unroll
    for (int cc = 0; cc < BM; ++cc)
      if (cc < b) {
        atomicAdd(&X[c * b + cc], a1[cc]);
        atomicAdd(&X[w * b + c * b + cc], a2[cc]);
      }
  }
}

// One warp per row i: M[i] = Bv[i, r0:] Vh - Z[i, :c0] X1 - V[i, :c0] X2,
// MT[i] = M[i] T_j, and the partial Y += Vhat[i]^T MT[i] (atomics).
template <int BM>
__global__ void panel_gemv(const float* __restrict__ Bv, long long ldb, int m, int w,
                           int b, int r0, int c0, const float* __restrict__ V,
                           const float* __restrict__ Z, const float* __restrict__ Vh,
                           const float* __restrict__ X, int x_in_smem,
                           const float* __restrict__ T, float* __restrict__ MT,
                           float* __restrict__ Y) {
  REPRO_DYNAMIC_SMEM(sx);
  __shared__ float sT[BM * BM];
  __shared__ float sY[BM * BM];
  const int tid = threadIdx.x;
  if (x_in_smem) {
    for (int e = tid; e < c0 * b; e += blockDim.x) {
      sx[e] = X[e];
      sx[c0 * b + e] = X[w * b + e];
    }
  }
  for (int e = tid; e < b * b; e += blockDim.x) {
    sT[e] = T[e];
    sY[e] = 0.f;
  }
  __syncthreads();
  const float* x1 = x_in_smem ? sx : X;
  const float* x2 = x_in_smem ? sx + c0 * b : X + w * b;
  const int lane = tid & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (tid >> 5);
  if (i < m) {
    float acc[BM];
#pragma unroll
    for (int cc = 0; cc < BM; ++cc) acc[cc] = 0.f;
    const float* brow = Bv + (long long)i * ldb;
    for (int k = r0 + lane; k < m; k += 32) {
      const float bv = brow[k];
      const float* vh = Vh + (long long)(k - r0) * b;
#pragma unroll
      for (int cc = 0; cc < BM; ++cc)
        if (cc < b) acc[cc] += bv * vh[cc];
    }
    const float* zi = Z + (long long)i * w;
    const float* vi = V + (long long)i * w;
    for (int c = lane; c < c0; c += 32) {
      const float z = zi[c];
      const float v = vi[c];
#pragma unroll
      for (int cc = 0; cc < BM; ++cc)
        if (cc < b) acc[cc] -= z * x1[c * b + cc] + v * x2[c * b + cc];
    }
#pragma unroll
    for (int cc = 0; cc < BM; ++cc)
      if (cc < b) acc[cc] = repro::warp_sum(acc[cc]);
    if (lane < b) {
      float mt = 0.f;
#pragma unroll
      for (int a = 0; a < BM; ++a)
        if (a < b) mt += acc[a] * sT[a * b + lane];
      MT[(long long)i * b + lane] = mt;
      if (i >= r0) {
        const float* vhi = Vh + (long long)(i - r0) * b;
        for (int a = 0; a < b; ++a) atomicAdd(&sY[a * b + lane], vhi[a] * mt);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < b * b; e += blockDim.x) atomicAdd(&Y[e], sY[e]);
}

// Z_j = MT - 1/2 Vhat G with G = T_j^T Y.
__global__ void panel_zfinal(const float* __restrict__ MT, const float* __restrict__ Vh,
                             const float* __restrict__ T, const float* __restrict__ Y,
                             int m, int w, int b, int r0, int c0, float* __restrict__ Z) {
  __shared__ float sG[32 * 32];
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
    const int a = e / b;
    const int c = e % b;
    float s = 0.f;
    for (int t = 0; t < b; ++t) s += T[t * b + a] * Y[t * b + c];
    sG[e] = s;
  }
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * b) return;
  const int i = (int)(idx / b);
  const int cc = (int)(idx % b);
  float z = MT[idx];
  if (i >= r0) {
    const float* vhi = Vh + (long long)(i - r0) * b;
    float s = 0.f;
    for (int a = 0; a < b; ++a) s += vhi[a] * sG[a * b + cc];
    z -= 0.5f * s;
  }
  Z[(long long)i * w + c0 + cc] = z;
}

// Lower 64x64 tiles of C = Bv[w:, w:]: C -= Z V^T + V Z^T (k = w), written
// to the tile and its mirror.
__global__ void trailing_lower(float* __restrict__ Bv, long long ldb, int m, int w,
                               const float* __restrict__ V, const float* __restrict__ Z) {
  int ti, tj;
  repro::lower_tile(blockIdx.x, ti, tj);
  const int mt = m - w;
  const int gi0 = ti * kTile;
  const int gj0 = tj * kTile;
  float acc[4][4];
  repro::syr2k_tile_acc(Z + (long long)w * w, V + (long long)w * w, w, mt, w, gi0, gj0, acc);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int li = gi0 + ty * 4 + a;
      const int lj = gj0 + tx * 4 + c;
      if (li < mt && lj < mt && li >= lj) {
        float* p = Bv + (long long)(w + li) * ldb + (w + lj);
        const float val = *p - acc[a][c];
        *p = val;
        Bv[(long long)(w + lj) * ldb + (w + li)] = val;
      }
    }
  }
}

__global__ void write_f(float* __restrict__ Bv, long long ldb, int m, int w,
                        const float* __restrict__ F) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * w) return;
  const int i = (int)(idx / w);
  const int c = (int)(idx % w);
  const float f = F[idx];
  Bv[(long long)i * ldb + c] = f;
  if (i >= w) Bv[(long long)c * ldb + i] = f;
}

inline unsigned blocks_for(long long n, int per) { return (unsigned)((n + per - 1) / per); }

template <int BM>
int run(float* Bv, long long ldb, int m, int w, int b, float* V, float* Ts, float* Z,
        float* F, float* P, float* Vh, float* MT, float* X, float* Y, int qr_smem_max,
        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      panel_qr<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, qr_smem_max);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(panel_gemv<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kGemvSmemMax);
  if (err != cudaSuccess) return (int)err;
  const int q = w / b;
  const int nx = 2 * w * b;
  for (int j = 0; j < q; ++j) {
    const int c0 = j * b;
    const int r0 = c0 + b;
    const int rows = m - r0;
    const long long prep_n = (long long)m * b > nx ? (long long)m * b : nx;
    REPRO_LAUNCH(panel_prep, blocks_for(prep_n, kThreads), kThreads, 0, st)
    (Bv, ldb, m, w, b, c0, V, Z, P, X, nx, Y, b * b);
    REPRO_CHECK_LAUNCH();
    const long long panel_bytes = (long long)rows * b * sizeof(float);
    const int qr_smem = panel_bytes <= qr_smem_max ? (int)panel_bytes : 0;
    REPRO_LAUNCH(panel_qr<BM>, 1, kThreads, qr_smem, st)
    (P, m, w, b, c0, j, qr_smem > 0, V, Vh, F, Ts);
    REPRO_CHECK_LAUNCH();
    if (j > 0) {
      const int chunk = 32;
      REPRO_LAUNCH(panel_xred<BM>, blocks_for(rows, chunk), kThreads, 0, st)
      (V, Z, Vh, m, w, b, r0, c0, chunk, X);
      REPRO_CHECK_LAUNCH();
    }
    const int x_bytes = 2 * c0 * b * (int)sizeof(float);
    const int x_in_smem = x_bytes <= kGemvSmemMax;
    REPRO_LAUNCH(panel_gemv<BM>, blocks_for(m, kThreads / 32), kThreads,
                 x_in_smem ? x_bytes : 0, st)
    (Bv, ldb, m, w, b, r0, c0, V, Z, Vh, X, x_in_smem, Ts + (long long)j * b * b, MT, Y);
    REPRO_CHECK_LAUNCH();
    REPRO_LAUNCH(panel_zfinal, blocks_for((long long)m * b, kThreads), kThreads, 0, st)
    (MT, Vh, Ts + (long long)j * b * b, Y, m, w, b, r0, c0, Z);
    REPRO_CHECK_LAUNCH();
  }
  const int mt = m - w;
  const long long nt = (mt + kTile - 1) / kTile;
  REPRO_LAUNCH(trailing_lower, (unsigned)(nt * (nt + 1) / 2), kThreads, 0, st)
  (Bv, ldb, m, w, V, Z);
  REPRO_CHECK_LAUNCH();
  REPRO_LAUNCH(write_f, blocks_for((long long)m * w, kThreads), kThreads, 0, st)
  (Bv, ldb, m, w, F);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// Launch count of one call: 5 per panel (4 for the first) + 2.
extern "C" int fused_panel_update_launch(float* Bv, long long ldb, int m, int w, int b,
                                         float* V, float* Ts, float* Z, float* F, float* P,
                                         float* Vh, float* MT, float* X, float* Y,
                                         int qr_smem_max, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b < 1 || w % b != 0 || w < b || m - w < b) return (int)cudaErrorInvalidValue;
  if (b <= 8) return run<8>(Bv, ldb, m, w, b, V, Ts, Z, F, P, Vh, MT, X, Y, qr_smem_max, st);
  if (b <= 16) return run<16>(Bv, ldb, m, w, b, V, Ts, Z, F, P, Vh, MT, X, Y, qr_smem_max, st);
  if (b <= 32) return run<32>(Bv, ldb, m, w, b, V, Ts, Z, F, P, Vh, MT, X, Y, qr_smem_max, st);
  return (int)cudaErrorInvalidValue;
}
