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
// operations-bound, on the tensor cores in 3xTF32, three TF32 products per
// product).  Between them sits the
// chain of q panel QRs, each b dependent reductions over the panel's rows.
//
// Design.  The TPU kernel runs the whole block as one sequential grid over a
// VMEM-resident view.  Here the sequential part is one thread-block cluster
// per panel and the rest spreads over the SMs, with the factors passed
// through L2 between launches.  The compensated panels
// P_j = Bv[:, c0:c0+b] - Z V[c0:c0+b]^T - V Z[c0:c0+b]^T are kept in F
// (m, w): after panel j, panel_zfinal subtracts its rank-2b term from every
// later column of the block (right-looking, spread over all SMs), so the
// next panel's QR starts from a plain load.  Per panel j (c0 = j*b,
// r0 = c0 + b):
//   K1 panel_qr_cluster  one cluster of up to 16 CTAs (csrc/panel_qr_cluster.cuh):
//                        each CTA loads a slice of the rows of P_j, the b
//                        LAPACK-sign Householder steps exchange their sums
//                        through distributed shared memory, rank 0 builds
//                        T_j, and each CTA writes its rows of V, Vh and F.
//                        A slice lives in shared memory up to qr_smem_max
//                        bytes and in global memory above.
//   K2 panel_xred        many CTAs  X1 = V[:, :c0]^T Vhat, X2 = Z[:, :c0]^T Vhat
//                        (128 rows by 32 columns per CTA in row groups,
//                        Vhat staged in shared memory; partials per CTA,
//                        summed in a fixed order, see last_arrival)
//   K3 panel_gemv        a tall-skinny product: a warp owns 16 / b rows
//                        (one CTA of 16 warps per SM at m = 4096), stages
//                        Vhat (transposed) in shared memory in chunks of up
//                        to 4096 rows, reads Bv coalesced along its rows
//                        with 16 loads per row and lane in flight, the next
//                        16 issued before the current ones are summed, and
//                        computes M = Bv Vhat - Z X1 - V X2, MT = M T_j and
//                        its share of Y = Vhat^T MT on chip (a partial per
//                        CTA, summed in a fixed order)
//   K4 panel_zfinal      many CTAs  Z_j = MT - 1/2 Vhat (T_j^T Y), then
//                        F[:, c] -= Z_j V[c, c0:c0+b]^T + V[:, c0:c0+b] Z_j[c]^T
//                        for the block's later columns c in [r0, w)
// then, once per block:
//   K5 trailing_lower  one CTA per lower 64x64 tile of the trailing block,
//                      the float32 walk of csrc/syr2k_tile.cuh shared with
//                      kernel D: k = w in cp.async-staged strips, mma.sync
//                      in 3xTF32; writes the tile and its mirror
//   K6 write_f         the exact banded values F into Bv[:, :w] and F^T into
//                      Bv[:w, w:]
// A bucket.  One call runs the block on ``batch`` views Bv + z * sbv at once
// (the counterpart of the batching rule that jax.vmap gives the Pallas
// kernel): every launch above takes the matrix z from blockIdx.y, and each
// matrix has its own copy of every buffer and ticket (see Bucket), so a
// last-arrival sum never mixes matrices.  K1's cluster stays one cluster a
// matrix, along x.  The arithmetic of each matrix is that of a call on it
// alone, bit for bit.
// No float atomics: every reduction adds its terms in an order fixed by the
// shapes, so two calls on one input give the same bits.  Every product of
// the TPU kernel's body stays inside these kernels (no cuBLAS).  Only K5 runs on the tensor cores; TMA and wgmma are later work.
#include "panel_qr_cluster.cuh"
#include "syr2k_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = repro::kSyr2kTile;
constexpr int kGemvSmemMax = 96 * 1024;  // X1, X2 in shared memory up to this
constexpr int kZRows = 32;        // rows per CTA of panel_zfinal
constexpr int kZCols = 256;       // later columns per chunk of panel_zfinal's update
constexpr int kXredRows = 128;    // rows of the X reduction per CTA
constexpr int kXredCols = 32;     // columns c < c0 per CTA (128 bytes of a row of V and Z)
constexpr int kXredGroups = 8;    // row groups of kXredCols threads each
constexpr int kGemvVh = 32768;    // floats of Vhat staged per chunk of the GEMV
constexpr int kGemvUnroll = 16;   // loads of Bv in flight per row and lane
constexpr int kGemvThreads = 512;

inline __host__ __device__ long long blocks_for(long long n, int per) { return (n + per - 1) / per; }

// Column chunks of panel_xred over c < c0, and the floats of its partials
// over every panel of a call (slots of 2 * kXredCols * 32 floats).
inline __host__ __device__ int xred_chunks(int c0) { return (int)blocks_for(c0, kXredCols); }
inline __host__ __device__ long long xred_part_floats(int m, int w, int b) {
  return blocks_for(m, kXredRows) * xred_chunks(w) * 2 * kXredCols * 32;
}

// Floats (ints for the tickets) of one matrix's copy of each buffer of a
// call: a buffer holds the bucket's copies back to back, matrix z at
// z times its size.
struct Bucket {
  long long mw, ts, mb, x, y, r;
  int tickets;
  __host__ __device__ Bucket(int m, int w, int b)
      : mw((long long)m * w), ts((long long)w * b), mb((long long)m * b), x(2LL * w * b),
        y((long long)b * b),
        r(xred_part_floats(m, w, b) + blocks_for(m, kGemvThreads / 32) * 32 * 32),
        tickets(xred_chunks(w) + 1) {}
};

// Panel j as one cluster: the compensated panel's QR, T_j and the
// write-out of V, Vh and F (see above).  gridDim.x is the cluster size;
// kSmem: the slices are in shared memory.
template <int BM, bool kSmem>
__global__ void panel_qr_cluster(const float* __restrict__ Bv, long long ldb, long long sbv, int m,
                                 int w, int b, int c0, int jpanel,
                                 float* __restrict__ V, float* __restrict__ Vh, float* __restrict__ F,
                                 float* __restrict__ Ts, float* __restrict__ P,
                                 int* __restrict__ tickets) {
  REPRO_DYNAMIC_SMEM(sm);
  using L = repro::ClusterQrSmem<BM>;
  const int cs = gridDim.x;
  const long long z = blockIdx.y;
  const Bucket bk(m, w, b);
  const int ntickets = bk.tickets;
  Bv += z * sbv;
  V += z * bk.mw;
  F += z * bk.mw;
  Vh += z * bk.mb;
  Ts += z * bk.ts;
  P += z * (long long)(m + cs) * b;
  tickets += z * bk.tickets;
  const int rank = (int)repro::cluster_rank();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int r0 = c0 + b;
  const int rows = m - r0;
  const int len = (rows + cs - 1) / cs;
  const int base = rank * len;
  const int nrows = max(0, min(len, rows - base));
  const int ldw = kSmem ? (len | 1) : len;
  float* W = kSmem ? sm + L::total : P + (long long)rank * len * b;
  // This CTA's rows above the elimination point, [ub, ub + nup): F only.
  const int up = (r0 + cs - 1) / cs;
  const int ub = rank * up;
  const int nup = max(0, min(up, r0 - ub));

  // The tickets of last_arrival start at 0; each last CTA resets its own.
  if (jpanel == 0 && rank == 0)
    for (int e = tid; e < ntickets; e += nt) tickets[e] = 0;

  // P_j: the first panel is Bv's own columns; later ones were compensated
  // in F by the earlier panels' panel_zfinal.  The upper rows stay in F.
  const float* src = c0 == 0 ? Bv : F;
  const long long lds = c0 == 0 ? ldb : w;
  for (int e = tid; e < (nup + nrows) * b; e += nt) {
    const int q = e / b;
    const int cc = e % b;
    const int i = q < nup ? ub + q : r0 + base + (q - nup);
    const float val = src[(long long)i * lds + c0 + cc];
    if (q >= nup) W[cc * ldw + (q - nup)] = val;
    else if (c0 == 0) F[(long long)i * w + cc] = val;
  }
  __syncthreads();

  repro::cluster_householder<BM, true>(W, ldw, base, nrows, b, sm, cs);

  if (rank == 0)
    for (int e = tid; e < b * b; e += nt)
      Ts[(long long)jpanel * b * b + e] = sm[L::T + (e / b) * BM + (e % b)];
  // V and Vh columns, and the exact final (banded) values F of the panel.
  for (int e = tid; e < nrows * b; e += nt) {
    const int lr = e / b;
    const int cc = e % b;
    const int li = base + lr;
    const float x = W[cc * ldw + lr];
    const float v = li == cc ? 1.f : (li > cc ? x : 0.f);
    const long long o = (long long)(r0 + li) * w + c0 + cc;
    Vh[(long long)li * b + cc] = v;
    V[o] = v;
    F[o] = li < b && li <= cc ? x : 0.f;  // R
  }
  for (int e = tid; e < nup * b; e += nt) {
    const int i = ub + e / b;
    const int cc = e % b;
    const long long o = (long long)i * w + c0 + cc;
    V[o] = 0.f;
    if (i < c0 + cc - b) F[o] = 0.f;  // exact zeros above the band
  }
  // Peers write into this CTA's shared memory only before the exchanges'
  // cluster barriers, so it may exit without another.
}

// True in the CTA that is the last of ``count`` to arrive at ``ticket``
// (which it resets to 0 for the next launch); the partials that the others
// wrote before arriving are visible to it.  The sum it then forms walks the
// partials in index order, so it does not depend on which CTA came last.
__device__ __forceinline__ bool last_arrival(int* ticket, int count, int* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *s_last = atomicAdd(ticket, 1) == count - 1;
    if (*s_last) *ticket = 0;
  }
  __syncthreads();
  const bool last = *s_last != 0;
  if (last) __threadfence();
  return last;
}

// X1 = V[:, :c0]^T Vhat and X2 = Z[:, :c0]^T Vhat.  CTA blockIdx.x = ck *
// nrc + rc sums rows [r0 + rc * kXredRows, +kXredRows) of the columns
// [ck * kXredCols, +kXredCols) (their Vhat rows staged in shared memory):
// its row groups each sum every kXredGroups-th row, the groups are added in
// group order, and the CTA writes its partial to slot blockIdx.x of
// ``part``.  The last CTA of column chunk ck to arrive adds the chunk's nrc
// slots in row order into X.
template <int BM>
__global__ void __launch_bounds__(kXredCols * kXredGroups)
    panel_xred(const float* __restrict__ V, const float* __restrict__ Z,
               const float* __restrict__ Vh, int m, int w, int b, int r0, int c0, int nrc,
               float* __restrict__ part, int* __restrict__ tickets, float* __restrict__ X) {
  {
    const long long z = blockIdx.y;
    const Bucket bk(m, w, b);
    V += z * bk.mw;
    Z += z * bk.mw;
    Vh += z * bk.mb;
    part += z * bk.r;
    tickets += z * bk.tickets;
    X += z * bk.x;
  }
  __shared__ float sVh[kXredRows * BM];
  __shared__ float sx[2 * kXredCols * BM];
  __shared__ int s_last;
  constexpr int kSlot = 2 * kXredCols * BM;
  const int rc = blockIdx.x % nrc;
  const int ck = blockIdx.x / nrc;
  const int i0 = r0 + rc * kXredRows;
  const int ni = min(kXredRows, m - i0);
  const int ncol = min(kXredCols, c0 - ck * kXredCols);
  const int cl = threadIdx.x % kXredCols;
  const int g = threadIdx.x / kXredCols;
  const int c = ck * kXredCols + cl;
  for (int e = threadIdx.x; e < ni * b; e += blockDim.x) sVh[e] = Vh[(long long)(i0 - r0) * b + e];
  __syncthreads();
  float a1[BM], a2[BM];
#pragma unroll
  for (int cc = 0; cc < BM; ++cc) a1[cc] = a2[cc] = 0.f;
  if (cl < ncol) {
#pragma unroll 4
    for (int ii = g; ii < ni; ii += kXredGroups) {
      const float v = V[(long long)(i0 + ii) * w + c];
      const float z = Z[(long long)(i0 + ii) * w + c];
      const float* vh = sVh + ii * b;
#pragma unroll
      for (int cc = 0; cc < BM; ++cc)
        if (cc < b) {
          a1[cc] += v * vh[cc];
          a2[cc] += z * vh[cc];
        }
    }
  }
  for (int gg = 0; gg < kXredGroups; ++gg) {
    if (g == gg && cl < ncol) {
#pragma unroll
      for (int cc = 0; cc < BM; ++cc) {
        float* s1 = sx + cl * BM + cc;
        float* s2 = s1 + kXredCols * BM;
        *s1 = gg ? *s1 + a1[cc] : a1[cc];
        *s2 = gg ? *s2 + a2[cc] : a2[cc];
      }
    }
    __syncthreads();
  }
  float* slot = part + (long long)blockIdx.x * kSlot;
  for (int e = threadIdx.x; e < 2 * ncol * BM; e += blockDim.x) {
    const int h = e / (ncol * BM);
    const int o = h * kXredCols * BM + e % (ncol * BM);
    slot[o] = sx[o];
  }
  if (!last_arrival(tickets + ck, nrc, &s_last)) return;
  const float* chunk = part + (long long)ck * nrc * kSlot;
  for (int e = threadIdx.x; e < 2 * ncol * b; e += blockDim.x) {
    const int h = e / (ncol * b);
    const int cl2 = (e / b) % ncol;
    const int cc = e % b;
    const int o = h * kXredCols * BM + cl2 * BM + cc;
    float s = 0.f;
    for (int r = 0; r < nrc; ++r) s += __ldcg(chunk + (long long)r * kSlot + o);
    X[(long long)h * w * b + (ck * kXredCols + cl2) * b + cc] = s;
  }
}

// Rows per warp of the GEMV (its rows x BM accumulators stay in registers)
// and Vhat rows per staged chunk.
template <int BM>
struct Gemv {
  static constexpr int kRows = BM >= 16 ? 1 : 16 / BM;
  static constexpr int kChunk = kGemvVh / BM;
};

// M[i] = Bv[i, r0:] Vh - Z[i, :c0] X1 - V[i, :c0] X2, MT[i] = M[i] T_j, and
// Y = Vhat^T MT.  A warp owns kRows rows; each lane takes every 32nd k of a
// staged Vhat chunk and keeps kGemvUnroll loads of each of its rows in
// flight.  The CTA adds its warps' shares of Y in warp order and writes the
// sum to its slot of ``part``; the last CTA to arrive adds the slots in
// order into Y.
template <int BM, bool kXSmem>
__global__ void panel_gemv(const float* __restrict__ Bv, long long ldb, long long sbv, int m, int w,
                           int b, int r0, int c0, const float* __restrict__ V,
                           const float* __restrict__ Z, const float* __restrict__ Vh,
                           const float* __restrict__ X,
                           const float* __restrict__ T, float* __restrict__ MT,
                           float* __restrict__ part, int* __restrict__ ticket,
                           float* __restrict__ Y) {
  {
    const long long z = blockIdx.y;
    const Bucket bk(m, w, b);
    Bv += z * sbv;
    V += z * bk.mw;
    Z += z * bk.mw;
    Vh += z * bk.mb;
    X += z * bk.x;
    T += z * bk.ts;
    MT += z * bk.mb;
    part += z * bk.r;
    ticket += z * bk.tickets;
    Y += z * bk.y;
  }
  constexpr int R = Gemv<BM>::kRows;
  constexpr int KC = Gemv<BM>::kChunk;
  constexpr int U = kGemvUnroll;
  REPRO_DYNAMIC_SMEM(smem);
  __shared__ float sT[BM * BM];
  __shared__ float sY[BM * BM];
  __shared__ int s_last;
  float* sVh = smem;           // [BM][KC]: Vhat chunk, transposed
  float* sx = smem + BM * KC;  // X1^T, X2^T ([b][c0] each) when they fit
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  if (kXSmem) {
    for (int e = tid; e < c0 * b; e += blockDim.x) {
      const int c = e / b;
      const int cc = e % b;
      sx[cc * c0 + c] = X[e];
      sx[(b + cc) * c0 + c] = X[w * b + e];
    }
  }
  for (int e = tid; e < b * b; e += blockDim.x) sT[e] = T[e];
  // X1[c][cc] = x1[c * xs + cc * xt], X2 likewise.
  const float* x1 = kXSmem ? sx : X;
  const float* x2 = kXSmem ? sx + b * c0 : X + w * b;
  const int xs = kXSmem ? 1 : b;
  const int xt = kXSmem ? c0 : 1;
  const int row0 = (blockIdx.x * nwarps + warp) * R;

  float acc[R][BM];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int cc = 0; cc < BM; ++cc) acc[r][cc] = 0.f;
  const float* brow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) brow[r] = Bv + (long long)min(row0 + r, m - 1) * ldb;
  for (int kc = r0; kc < m; kc += KC) {
    const int kn = min(KC, m - kc);
    __syncthreads();
    for (int k = tid; k < kn; k += blockDim.x) {
      const float* src = Vh + (long long)(kc - r0 + k) * b;
#pragma unroll
      for (int cc = 0; cc < BM; ++cc)
        if (cc < b) sVh[cc * KC + k] = src[cc];
    }
    __syncthreads();
    // Software-pipelined: the next U columns' loads are in flight while
    // the current ones are summed.
    float xb[U][R], xn[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r)
        xb[u][r] = lane + 32 * u < kn ? brow[r][kc + lane + 32 * u] : 0.f;
    for (int k = lane; k < kn; k += 32 * U) {
      const int kq = k + 32 * U;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r)
          xn[u][r] = kq + 32 * u < kn ? brow[r][kc + kq + 32 * u] : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k + 32 * u;
        if (kk < kn) {
#pragma unroll
          for (int cc = 0; cc < BM; ++cc) {
            const float vh = cc < b ? sVh[cc * KC + kk] : 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r][cc] += xb[u][r] * vh;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r) xb[u][r] = xn[u][r];
    }
  }
  // The compensation - Z X1 - V X2, lanes over c < c0.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(row0 + r, m - 1);
    const float* zi = Z + (long long)i * w;
    const float* vi = V + (long long)i * w;
    for (int c = lane; c < c0; c += 32) {
      const float z = zi[c];
      const float v = vi[c];
#pragma unroll
      for (int cc = 0; cc < BM; ++cc)
        if (cc < b) acc[r][cc] -= z * x1[c * xs + cc * xt] + v * x2[c * xs + cc * xt];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int cc = 0; cc < BM; ++cc)
      if (cc < b) acc[r][cc] = repro::warp_sum(acc[r][cc]);
  // MT = M T_j (lane = column), and Vhat[i]^T MT[i] summed over the warp's rows.
  float ya[BM];
#pragma unroll
  for (int a = 0; a < BM; ++a) ya[a] = 0.f;
  if (lane < b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r;
      if (i < m) {
        float mt = 0.f;
#pragma unroll
        for (int a = 0; a < BM; ++a)
          if (a < b) mt += acc[r][a] * sT[a * b + lane];
        MT[(long long)i * b + lane] = mt;
        if (i >= r0) {
          const float* vhi = Vh + (long long)(i - r0) * b;
#pragma unroll
          for (int a = 0; a < BM; ++a)
            if (a < b) ya[a] += vhi[a] * mt;
        }
      }
    }
  }
  for (int wp = 0; wp < nwarps; ++wp) {
    if (warp == wp && lane < b) {
#pragma unroll
      for (int a = 0; a < BM; ++a)
        if (a < b) sY[a * b + lane] = wp ? sY[a * b + lane] + ya[a] : ya[a];
    }
    __syncthreads();
  }
  float* slot = part + (long long)blockIdx.x * b * b;
  for (int e = tid; e < b * b; e += blockDim.x) slot[e] = sY[e];
  if (!last_arrival(ticket, gridDim.x, &s_last)) return;
  for (int e = tid; e < b * b; e += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < (int)gridDim.x; ++r) s += __ldcg(part + (long long)r * b * b + e);
    Y[e] = s;
  }
}

// Z_j = MT - 1/2 Vhat G with G = T_j^T Y for kZRows rows per CTA, then the
// rank-2b update of the block's later compensated columns c in [r0, w):
// F[i][c] -= Z_j[i] . V[c, c0:c0+b] + V[i, c0:c0+b] . Z_j[c] (the first
// panel reads Bv's columns as their starting value).  Each CTA rebuilds
// Z_j[c] for those columns itself (b x b work per column).  A thread owns
// one column of a chunk, its V and Z_j coefficients in registers.
template <int BM>
__global__ void panel_zfinal(const float* __restrict__ MT, const float* __restrict__ Vh,
                             const float* __restrict__ T, const float* __restrict__ Y,
                             const float* __restrict__ Bv, long long ldb, long long sbv, int m,
                             int w, int b, int r0, int c0, const float* __restrict__ V,
                             float* __restrict__ Z, float* __restrict__ F) {
  {
    const long long z = blockIdx.y;
    const Bucket bk(m, w, b);
    MT += z * bk.mb;
    Vh += z * bk.mb;
    T += z * bk.ts;
    Y += z * bk.y;
    Bv += z * sbv;
    V += z * bk.mw;
    Z += z * bk.mw;
    F += z * bk.mw;
  }
  __shared__ float sG[BM * BM];
  __shared__ float sZi[kZRows * BM];  // Z_j of this CTA's rows
  __shared__ float sVi[kZRows * BM];  // V[i, c0:c0+b] of this CTA's rows
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int e = tid; e < b * b; e += nt) {
    const int a = e / b;
    const int c = e % b;
    float s = 0.f;
    for (int t = 0; t < b; ++t) s += T[t * b + a] * Y[t * b + c];
    sG[e] = s;
  }
  __syncthreads();
  const int i0 = blockIdx.x * kZRows;
  const int ni = min(kZRows, m - i0);
  for (int e = tid; e < ni * b; e += nt) {
    const int i = i0 + e / b;
    const int cc = e % b;
    float z = MT[(long long)i * b + cc];
    if (i >= r0) {
      const float* vhi = Vh + (long long)(i - r0) * b;
      float s = 0.f;
      for (int a = 0; a < b; ++a) s += vhi[a] * sG[a * b + cc];
      z -= 0.5f * s;
    }
    Z[(long long)i * w + c0 + cc] = z;
    sZi[(e / b) * BM + cc] = z;
    sVi[(e / b) * BM + cc] = V[(long long)i * w + c0 + cc];
  }
  __syncthreads();
  const float* base = c0 == 0 ? Bv : F;
  const long long ldbase = c0 == 0 ? ldb : w;
  for (int cA = r0; cA < w; cA += kZCols) {
    const int c = cA + tid;
    if (tid < kZCols && c < w) {
      // Z_j[c] (c >= r0) and V[c, c0:c0+b] in registers.
      float zc[BM], vc[BM], vh[BM];
#pragma unroll
      for (int a = 0; a < BM; ++a) vh[a] = a < b ? Vh[(long long)(c - r0) * b + a] : 0.f;
#pragma unroll
      for (int cc = 0; cc < BM; ++cc) {
        float s = 0.f;
#pragma unroll
        for (int a = 0; a < BM; ++a)
          if (a < b && cc < b) s += vh[a] * sG[a * b + cc];
        zc[cc] = cc < b ? MT[(long long)c * b + cc] - 0.5f * s : 0.f;
        vc[cc] = cc < b ? V[(long long)c * w + c0 + cc] : 0.f;
      }
      // Eight rows' starting values in flight at a time.
      for (int ii0 = 0; ii0 < ni; ii0 += 8) {
        float fb[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          fb[q] = ii0 + q < ni ? base[(long long)(i0 + ii0 + q) * ldbase + c] : 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int ii = ii0 + q;
          if (ii < ni) {
            float s = 0.f;
#pragma unroll
            for (int cc = 0; cc < BM; ++cc)
              if (cc < b) s += sZi[ii * BM + cc] * vc[cc] + sVi[ii * BM + cc] * zc[cc];
            F[(long long)(i0 + ii) * w + c] = fb[q] - s;
          }
        }
      }
    }
  }
}

// Lower tiles of C = Bv[w:, w:]: C -= Z V^T + V Z^T (k = w), in place, each
// tile written with its mirror (the float32 walk of csrc/syr2k_tile.cuh).
__global__ void __launch_bounds__(repro::Syr2kF32::kThreads)
    trailing_lower(float* __restrict__ Bv, long long ldb, long long sbv, int m, int w,
                   const float* __restrict__ V, const float* __restrict__ Z) {
  REPRO_DYNAMIC_SMEM(sm);
  const long long mw = (long long)m * w;
  V += blockIdx.y * mw;
  Z += blockIdx.y * mw;
  float* C = Bv + blockIdx.y * sbv + (long long)w * ldb + w;
  repro::syr2k_tf32_tile(Z + (long long)w * w, V + (long long)w * w, w, m - w, w, -1.f, C, ldb, C,
                         ldb, sm);
}

__global__ void write_f(float* __restrict__ Bv, long long ldb, long long sbv, int m, int w,
                        const float* __restrict__ F) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * w) return;
  Bv += blockIdx.y * sbv;
  F += blockIdx.y * (long long)m * w;
  const int i = (int)(idx / w);
  const int c = (int)(idx % w);
  const float f = F[idx];
  Bv[(long long)i * ldb + c] = f;
  if (i >= w) Bv[(long long)c * ldb + i] = f;
}

template <int BM>
int run(float* Bv, long long ldb, long long sbv, int batch, int m, int w, int b, float* V,
        float* Ts, float* Z, float* F, float* P, float* Vh, float* MT, float* X, float* Y,
        float* R, int* tickets, int qr_smem_max, int cluster, cudaStream_t st) {
  using L = repro::ClusterQrSmem<BM>;
  const int vh_bytes = BM * Gemv<BM>::kChunk * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      panel_gemv<BM, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, vh_bytes + kGemvSmemMax);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(panel_gemv<BM, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             vh_bytes);
  if (err != cudaSuccess) return (int)err;
  // The first panel has the most rows; every panel uses its slice layout.
  auto qr_smem_for = [&](int cs, int* in_smem) {
    const int len = (m - b + cs - 1) / cs;
    const int slice_bytes = (len | 1) * BM * (int)sizeof(float);
    const int fixed = L::total * (int)sizeof(float);
    *in_smem = slice_bytes <= qr_smem_max && fixed + slice_bytes <= repro::kSmemPerBlockMax;
    return fixed + (*in_smem ? slice_bytes : 0);
  };
  int slice_in_smem = 0;
  int qr_smem = qr_smem_for(cluster, &slice_in_smem);
  auto qr = slice_in_smem ? panel_qr_cluster<BM, true> : panel_qr_cluster<BM, false>;
  err = cudaFuncSetAttribute(qr, cudaFuncAttributeMaxDynamicSharedMemorySize, qr_smem);
  if (err != cudaSuccess) return (int)err;
  const int cs = repro::fit_cluster(qr, repro::kQrThreads, qr_smem, cluster);
  if (cs > repro::kMaxCluster) return (int)cudaErrorInvalidValue;
  if (cs != cluster) {
    qr_smem = qr_smem_for(cs, &slice_in_smem);
    qr = slice_in_smem ? panel_qr_cluster<BM, true> : panel_qr_cluster<BM, false>;
    err = cudaFuncSetAttribute(qr, cudaFuncAttributeMaxDynamicSharedMemorySize, qr_smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int q = w / b;
  const int gemv_rows = (kGemvThreads / 32) * Gemv<BM>::kRows;
  // R: the partials of panel_xred, then (after them) of panel_gemv; the
  // last ticket is panel_gemv's.
  const int ntickets = xred_chunks(w) + 1;
  float* gemv_part = R + xred_part_floats(m, w, b);
  const unsigned nz = (unsigned)batch;
  for (int j = 0; j < q; ++j) {
    const int c0 = j * b;
    const int r0 = c0 + b;
    err = REPRO_LAUNCH_CLUSTER(qr, dim3(cs, nz), dim3(repro::kQrThreads), (size_t)qr_smem, st,
                               (unsigned)cs, (const float*)Bv, ldb, sbv, m, w, b, c0, j, V, Vh, F,
                               Ts, P, tickets);
    if (err != cudaSuccess) return (int)err;
    REPRO_CHECK_LAUNCH();
    if (j > 0) {
      const int nrc = (int)blocks_for(m - r0, kXredRows);
      REPRO_LAUNCH(panel_xred<BM>, dim3(nrc * xred_chunks(c0), nz), kXredCols * kXredGroups, 0, st)
      (V, Z, Vh, m, w, b, r0, c0, nrc, R, tickets, X);
      REPRO_CHECK_LAUNCH();
    }
    const int x_bytes = 2 * c0 * b * (int)sizeof(float);
    const bool x_in_smem = x_bytes <= kGemvSmemMax;
    auto gemv = x_in_smem ? panel_gemv<BM, true> : panel_gemv<BM, false>;
    REPRO_LAUNCH(gemv, dim3(blocks_for(m, gemv_rows), nz), kGemvThreads,
                 vh_bytes + (x_in_smem ? x_bytes : 0), st)
    (Bv, ldb, sbv, m, w, b, r0, c0, V, Z, Vh, X, Ts + (long long)j * b * b, MT, gemv_part,
     tickets + ntickets - 1, Y);
    REPRO_CHECK_LAUNCH();
    REPRO_LAUNCH(panel_zfinal<BM>, dim3(blocks_for(m, kZRows), nz), kThreads, 0, st)
    (MT, Vh, Ts + (long long)j * b * b, Y, Bv, ldb, sbv, m, w, b, r0, c0, V, Z, F);
    REPRO_CHECK_LAUNCH();
  }
  using S = repro::Syr2kF32;
  err = cudaFuncSetAttribute(trailing_lower, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long nt = (m - w + kTile - 1) / kTile;
  REPRO_LAUNCH(trailing_lower, dim3(nt * (nt + 1) / 2, nz), S::kThreads, S::kSmem, st)
  (Bv, ldb, sbv, m, w, V, Z);
  REPRO_CHECK_LAUNCH();
  REPRO_LAUNCH(write_f, dim3(blocks_for((long long)m * w, kThreads), nz), kThreads, 0, st)
  (Bv, ldb, sbv, m, w, F);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// The workspace of one matrix: floats of R (the reductions' partials) and
// ints of the tickets (no initial value needed); a call on a bucket takes
// `batch` times both.
extern "C" long long fused_panel_update_workspace(int m, int w, int b, int* ntickets) {
  const Bucket bk(m, w, b);
  *ntickets = bk.tickets;
  return bk.r;
}

// Launch count of one call, whatever its batch: 4 per panel (3 for the
// first) + 2.  Bv: `batch` views (m, m) with leading dimension ldb, view z
// at Bv + z * sbv; batch <= 65535 (gridDim.y).  cluster: CTAs of the panel
// QR's cluster, 1 to 16 (8 where the card cannot co-schedule more).  Every
// other buffer holds `batch` copies back to back: V, Z, F (m, w); Ts
// (w/b, b, b); P, (m + cluster, b), which holds the panel slices when a
// slice exceeds qr_smem_max bytes; Vh, MT (m, b); X (2 w b); Y (b, b); R
// and tickets the workspace that fused_panel_update_workspace sizes.
extern "C" int fused_panel_update_launch(float* Bv, long long ldb, long long sbv, int batch, int m,
                                         int w, int b, float* V, float* Ts, float* Z, float* F,
                                         float* P, float* Vh, float* MT, float* X, float* Y,
                                         float* R, int* tickets, int qr_smem_max, int cluster,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b < 1 || w % b != 0 || w < b || m - w < b || cluster < 1 || cluster > 16 || batch < 1 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (b <= 8)
    return run<8>(Bv, ldb, sbv, batch, m, w, b, V, Ts, Z, F, P, Vh, MT, X, Y, R, tickets,
                  qr_smem_max, cluster, st);
  if (b <= 16)
    return run<16>(Bv, ldb, sbv, batch, m, w, b, V, Ts, Z, F, P, Vh, MT, X, Y, R, tickets,
                   qr_smem_max, cluster, st);
  if (b <= 32)
    return run<32>(Bv, ldb, sbv, batch, m, w, b, V, Ts, Z, F, P, Vh, MT, X, Y, R, tickets,
                   qr_smem_max, cluster, st);
  return (int)cudaErrorInvalidValue;
}
