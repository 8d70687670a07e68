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
// M = Bv * Vhat over the (m, m-r0) view, which read the lower triangle of
// rows r0..m of the view q times at 4b flops per 4-byte element (a
// symmetric product, bytes-bound as LAPACK's latrd is) past m = 4096 and
// at m <= 128, and the whole view at 2b flops an element between (the row
// walk: there the view sits in the 50 MB L2 and chains of dependent
// reads, not bytes, bound a panel); the trailing update
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
//   K3 panel_gemv        for 128 < m <= 4096 the row walk: a warp owns 16 /
//                        b rows, Vhat staged (transposed) in shared memory,
//                        Bv read along its rows with 16 loads a lane in
//                        flight, M = Bv Vhat - Z X1 - V X2, MT = M T_j and
//                        its share of Y on chip (a partial a CTA, summed in
//                        a fixed order).  Elsewhere
//                        a symmetric product (MAGMA's blocked ssymv): it
//                        reads only the lower triangle of rows r0..m of the
//                        view, each element once, as S x S tiles (a CTA a
//                        strip of them, or a tile row's share of the
//                        compensation - Z X1 - V X2), an element adding to
//                        its row's M and to its column's; the last CTA to
//                        reach a block of M adds the block's partials in a
//                        fixed order, forms MT = M T_j and its share of
//                        Y = Vhat^T MT, and the last block Y (see SymvPlan).
//                        This relies on the view being symmetric bit for
//                        bit: every caller passes one (band_reduce reduces
//                        its input's lower triangle and that triangle's
//                        mirror, and K5 and K6 below write each trailing
//                        view with its mirror).
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
#include <cstdint>

#include "panel_qr_cluster.cuh"
#include "syr2k_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = repro::kSyr2kTile;
constexpr int kZRows = 32;        // rows per CTA of panel_zfinal
constexpr int kZCols = 256;       // later columns per chunk of panel_zfinal's update
constexpr int kXredRows = 128;    // rows of the X reduction per CTA
constexpr int kXredCols = 32;     // columns c < c0 per CTA (128 bytes of a row of V and Z)
constexpr int kXredGroups = 8;    // row groups of kXredCols threads each
constexpr int kGemvSmemMax = 96 * 1024;  // X1, X2 in shared memory up to this (the row walk; see x_cap)
constexpr int kGemvVh = 32768;    // floats of Vhat staged per chunk of the row walk
constexpr int kGemvUnroll = 16;   // loads of Bv in flight per row and lane of the row walk
constexpr int kGemvThreads = 512; // threads of the row walk
constexpr int kGemvLoads = 8;     // loads in flight a thread in the row walk's staging of X and compensation
// The row walk for 128 < m <= kGemvRowsMax (see gemv_rows_for).  The host
// emulation's tests also build a copy with -DREPRO_GEMV_ROWS_MAX=0, so that
// the symmetric product's tile edges run at the sizes it can reach.
#ifndef REPRO_GEMV_ROWS_MAX
#define REPRO_GEMV_ROWS_MAX 4096
#endif
constexpr int kGemvRowsMax = REPRO_GEMV_ROWS_MAX;
constexpr int kSymvThreads = 256; // threads of panel_gemv's symmetric product: 8 warps
constexpr int kCompCols = 256;    // columns c < c0 per unit of panel_gemv's compensation
constexpr int kCompRows = 64;     // rows per unit of panel_gemv's compensation
constexpr int kSymvTilesAlong = 32;  // tiles along a side of the view that panel_gemv aims at
constexpr int kSymvMaxStrip = 2;     // tiles a strip of panel_gemv at most (SymvPlan's L)

inline __host__ __device__ long long blocks_for(long long n, int per) { return (n + per - 1) / per; }
// The instantiation (8, 16 or 32) that takes panel width b.
inline __host__ __device__ int bm_for(int b) { return b <= 8 ? 8 : b <= 16 ? 16 : 32; }
// Whether panel_gemv walks whole rows of the view (the row walk) on an
// (m, m) view, where the symmetric product measured slower on the H100.
inline __host__ __device__ bool gemv_rows_for(int m) { return m > 128 && m <= kGemvRowsMax; }

// Column chunks of panel_xred over c < c0, and the floats of its partials
// over every panel of a call (slots of 2 * kXredCols * 32 floats).
inline __host__ __device__ int xred_chunks(int c0) { return (int)blocks_for(c0, kXredCols); }
inline __host__ __device__ long long xred_part_floats(int m, int w, int b) {
  return blocks_for(m, kXredRows) * xred_chunks(w) * 2 * kXredCols * 32;
}


// panel_gemv's tiling of the view for one panel (r0 = c0 + b): square
// tiles of side S over the lower triangle of rows r0..m, a tile row I of
// them split into strips of L tiles (J in [s L, s L + L), J <= I); M's rows
// fall in nt blocks of S.  Its grid walks the tile rows from the last one
// up, so that a block of M is complete soon after its own tile row: for
// each, the units of block I's compensation (kCompRows rows by chunk ch of
// kCompCols columns c < c0, into those rows of the block's slot for the
// chunk), then the strips of tile row I (none above I0).  Every quantity is
// a function of m, b and c0 alone, so that a matrix sums in the same order
// alone and in any bucket.
struct SymvPlan {
  int S, L, nt, I0, nch, nparts, ncomp;  // ncomp: a block's compensation units
  // About 32 tiles along a side (two waves of CTAs or more), from 64 (a
  // warp's walk a multiple of the ring's depth) to 256 (the partials it
  // writes, 2 BM / S of the bytes it reads, over L = 2 tiles for the row
  // partials at m > 8192), and one tile at Shampoo's m <= 128.
  __host__ __device__ static int tile(int m, int b) {
    if (m <= 128) return 128;
    int s = 64;
    while (s < 256 && s * kSymvTilesAlong < m) s *= 2;
    return b > 8 && s > 128 ? 128 : s;
  }
  // Loads of Bv in flight a thread: a whole tile of 128 (64 KB), 16 KB of
  // the others (a tile of 64; 256 leave no room for more beside their row
  // partials).  It divides the steps of a warp's walk.
  __host__ __device__ static int depth(int S) { return S == 128 ? 16 : 4; }
  __host__ __device__ static int comp_chunks(int c0) { return (int)blocks_for(c0, kCompCols); }
  __host__ __device__ SymvPlan(int m, int b, int c0) {
    S = tile(m, b);
    L = S == 256 && m > 8192 ? 2 : 1;
    nt = (int)blocks_for(m, S);
    I0 = (c0 + b) / S;
    nch = comp_chunks(c0);
    nparts = S / kCompRows;
    ncomp = nch * nparts;
  }
  __host__ __device__ int strips(int I) const { return I / L + 1; }
  __host__ __device__ int row_units(int I) const { return ncomp + (I >= I0 ? strips(I) : 0); }
  // The grid's size.
  __host__ int units() const {
    int u = 0;
    for (int I = 0; I < nt; ++I) u += row_units(I);
    return u;
  }
  // The column partials of block B, from the tiles (I, B), I >= max(B, I0).
  __device__ int cols(int B) const { return nt - max(B, I0); }
  // Partials that block B of M sums: its compensation units, the row
  // partials of tile row B's strips and its column partials.
  __device__ int arrivals(int B) const { return ncomp + (B >= I0 ? strips(B) : 0) + cols(B); }
  // Unit u: tile row I and its unit k there (compensation units first).
  __device__ void unit_of(int u, int* I, int* k) const {
    int i = nt - 1;
    while (u >= row_units(i)) u -= row_units(i--);
    *I = i;
    *k = u;
  }
};

// Where panel_gemv keeps its partials in R, slots of S x BM floats ([row][BM]):
// the row partial of strip s of tile row B, the column partial of tile
// (I, B) and chunk ch of block B's compensation; then the blocks' shares
// of Y.
struct SymvSlots {
  float* base;
  int nt, nsmax, nchmax;
  long long sz;
  __host__ __device__ SymvSlots(float* p, int m, int w, int b, int bm) {
    const SymvPlan pl(m, b, 0);
    base = p;
    nt = pl.nt;
    nsmax = pl.strips(pl.nt - 1);
    nchmax = SymvPlan::comp_chunks(w - b);
    sz = (long long)pl.S * bm;
  }
  __host__ __device__ long long slots() const { return (long long)nt * (nsmax + nt + nchmax); }
  __host__ __device__ long long floats(int b) const { return slots() * sz + (long long)nt * b * b; }
  __device__ float* row(int B, int s) const { return base + ((long long)B * nsmax + s) * sz; }
  __device__ float* col(int B, int I) const {
    return base + ((long long)nt * nsmax + (long long)B * nt + I) * sz;
  }
  __device__ float* comp(int B, int ch) const {
    return base + ((long long)nt * (nsmax + nt) + (long long)B * nchmax + ch) * sz;
  }
  __device__ float* yshare(int B, int bb) const { return base + slots() * sz + (long long)B * bb; }
};

// Floats of one matrix's copy of each buffer of a call: a buffer holds the
// bucket's copies back to back, matrix z at z times its size.
struct Bucket {
  long long mw, ts, mb, x, y;
  __host__ __device__ Bucket(int m, int w, int b)
      : mw((long long)m * w), ts((long long)w * b), mb((long long)m * b), x(2LL * w * b),
        y((long long)b * b) {}
};

// One matrix's copy of the workspace: floats of R and ints of the
// tickets.  R holds panel_xred's partials, then from float gemv
// panel_gemv's (SymvSlots, or a slot a CTA of the row walk); the tickets
// are panel_xred's column chunks', panel_gemv's Y and one a block of M.
// Formed once a call on the host and passed to the kernels that index it
// (formed in a kernel's prologue, its arithmetic cost panel_xred ~10 % on
// the H100).
struct Workspace {
  long long gemv, r;
  int tickets;
  Workspace(int m, int w, int b) : gemv(xred_part_floats(m, w, b)) {
    const SymvSlots sl(nullptr, m, w, b, bm_for(b));
    const long long rows = blocks_for(m, kGemvThreads / 32) * 32 * 32;  // the row walk's
    r = (gemv + max(sl.floats(b), rows) + 3) / 4 * 4;  // each matrix's slots start on 16 bytes
    tickets = xred_chunks(w) + 1 + sl.nt;
  }
};

// Panel j as one cluster: the compensated panel's QR, T_j and the
// write-out of V, Vh and F (see above).  gridDim.x is the cluster size;
// kSmem: the slices are in shared memory.
template <int BM, bool kSmem>
__device__ __forceinline__ void qr_cluster_body(const float* __restrict__ Bv, long long ldb,
                                                long long sbv, int m, int w, int b, int c0,
                                                int jpanel, float* __restrict__ V,
                                                float* __restrict__ Vh, float* __restrict__ F,
                                                float* __restrict__ Ts, float* __restrict__ P,
                                                int* __restrict__ tickets, const Workspace& ws) {
  REPRO_DYNAMIC_SMEM(sm);
  using L = repro::ClusterQrSmem<BM>;
  const int cs = gridDim.x;
  const long long z = blockIdx.y;
  const Bucket bk(m, w, b);
  const int ntickets = ws.tickets;
  Bv += z * sbv;
  V += z * bk.mw;
  F += z * bk.mw;
  Vh += z * bk.mb;
  Ts += z * bk.ts;
  P += z * (long long)(m + cs) * b;
  tickets += z * ws.tickets;
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

#define REPRO_QR_CLUSTER_ARGS                                                                    \
  const float* __restrict__ Bv, long long ldb, long long sbv, int m, int w, int b, int c0,      \
      int jpanel, float* __restrict__ V, float* __restrict__ Vh, float* __restrict__ F,         \
      float* __restrict__ Ts, float* __restrict__ P, int* __restrict__ tickets, Workspace ws
template <int BM, bool kSmem>
__global__ void panel_qr_cluster(REPRO_QR_CLUSTER_ARGS) {
  qr_cluster_body<BM, kSmem>(Bv, ldb, sbv, m, w, b, c0, jpanel, V, Vh, F, Ts, P, tickets, ws);
}
// At BM = 32 the body asks for more registers than a block of kQrThreads
// has (the launch was refused, cudaError 701), so its build is bounded;
// the bound changed the smaller panels' code (~1 % slower on the H100),
// so they keep the unbounded one.
template <int BM, bool kSmem>
__global__ void __launch_bounds__(repro::kQrThreads) panel_qr_cluster_bounded(REPRO_QR_CLUSTER_ARGS) {
  qr_cluster_body<BM, kSmem>(Bv, ldb, sbv, m, w, b, c0, jpanel, V, Vh, F, Ts, P, tickets, ws);
}
#undef REPRO_QR_CLUSTER_ARGS

// True for the arrival that is the last of ``count`` at ``ticket`` (which
// it then resets to 0 for the next launch).  One thread calls it, after
// its CTA's partials are fenced.
__device__ __forceinline__ bool arrive(int* ticket, int count) {
  const bool last = atomicAdd(ticket, 1) == count - 1;
  if (last) *ticket = 0;
  return last;
}

// True in the CTA that is the last of ``count`` to arrive at ``ticket``;
// the partials that the others wrote before arriving are visible to it.
// The sum it then forms walks the partials in index order, so it does not
// depend on which CTA came last.
__device__ __forceinline__ bool last_arrival(int* ticket, int count, int* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = arrive(ticket, count);
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
               float* __restrict__ part, int* __restrict__ tickets, float* __restrict__ X,
               Workspace ws) {
  {
    const long long z = blockIdx.y;
    const Bucket bk(m, w, b);
    V += z * bk.mw;
    Z += z * bk.mw;
    Vh += z * bk.mb;
    part += z * ws.r;
    tickets += z * ws.tickets;
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

// Floats of panel_gemv's dynamic shared memory: a strip's row partials (one
// copy a column strip of 32), column partials (one copy a row group, when
// there are several), Vhat at the tile row's rows and at the strip's
// columns, and each thread's ring of Bv loads; a compensation unit's X1
// and X2 chunk; the finish's M, MT, Vhat and Y partials.
template <int BM>
__host__ __device__ int symv_smem_floats(const SymvPlan& pl) {
  constexpr int CPL = 32 / BM;
  const int S = pl.S, NS = S / 32, NG = (kSymvThreads / 32) / NS;
  const int strip = NS * S * BM + (NG > 1 ? NG * S * BM : 0) + S * BM + pl.L * S * BM +
                    SymvPlan::depth(S) * kSymvThreads * CPL;
  const int comp = 2 * kCompCols * BM;
  const int finish = 3 * S * BM + BM * BM + 5 * kSymvThreads;
  return max(strip, max(comp, finish));
}

// Rows [rb, rb + nr) of block B's compensation Z[i, c] X1[c] + V[i, c] X2[c]
// over the columns c in [ca, cb) into ``out``: a warp takes two rows at a
// time, its lanes every 32nd column, and sums over the warp.
template <int BM>
__device__ void symv_comp(int rb, int nr, int ca, int cb, int w, int b, const float* __restrict__ V,
                          const float* __restrict__ Z, const float* __restrict__ X, float* out,
                          float* smem) {
  constexpr int KI = kCompCols / 32;
  float* sx1 = smem;                  // [kCompCols][BM]
  float* sx2 = smem + kCompCols * BM;
  const int nc = cb - ca;
  for (int e = threadIdx.x; e < kCompCols * BM; e += kSymvThreads) {
    const int c = e / BM, cc = e % BM;
    const bool ok = c < nc && cc < b;
    const float* x1 = X + (long long)(ca + c) * b + cc;
    repro::cp_async_zfill<4>(sx1 + e, ok ? x1 : X, ok ? 4 : 0);
    repro::cp_async_zfill<4>(sx2 + e, ok ? x1 + (long long)w * b : X, ok ? 4 : 0);
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = 2 * warp; i0 < nr; i0 += 2 * (kSymvThreads / 32)) {
    float z[2][KI], v[2][KI];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int t = 0; t < KI; ++t) {
        const int c = lane + 32 * t;
        const bool ok = i0 + r < nr && c < nc;
        const long long o = (long long)(rb + i0 + r) * w + ca + c;
        z[r][t] = ok ? Z[o] : 0.f;
        v[r][t] = ok ? V[o] : 0.f;
      }
    float acc[2][BM];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < BM; ++cc) acc[r][cc] = 0.f;
#pragma unroll
    for (int t = 0; t < KI; ++t) {
      const float* x1 = sx1 + (lane + 32 * t) * BM;
      const float* x2 = sx2 + (lane + 32 * t) * BM;
#pragma unroll
      for (int cc = 0; cc < BM; ++cc)
#pragma unroll
        for (int r = 0; r < 2; ++r) acc[r][cc] += z[r][t] * x1[cc] + v[r][t] * x2[cc];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < BM; ++cc) acc[r][cc] = repro::warp_sum(acc[r][cc]);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (i0 + r < nr && lane < BM) {
#pragma unroll
        for (int cc = 0; cc < BM; ++cc)
          if (cc == lane) out[(i0 + r) * BM + cc] = acc[r][cc];
      }
  }
}

// Block B of M is complete (every partial it sums has arrived): M = the row
// partials of tile row B's strips, then the column partials of the tiles
// (I, B), summed in that order, less the compensation's chunks; MT = M T_j;
// the block's share of Y = Vhat^T MT; and, in the last block to finish, Y =
// the shares summed in block order.  The slots' floats are shared among
// the threads in groups of contiguous slots where a slot has fewer float4
// than the CTA has threads, and the groups are added in order.
template <int BM>
__device__ void symv_finish(int B, const SymvPlan& pl, const SymvSlots& sl, int m, int b, int r0,
                            const float* __restrict__ Vh, const float* __restrict__ T,
                            float* __restrict__ MT, int* yticket, float* __restrict__ Y,
                            float* smem, int* s_last) {
  const int S = pl.S, tid = threadIdx.x;
  const int rb = B * S, nr = min(S, m - rb);
  float* sM = smem;             // [S][BM]
  float* sMT = sM + S * BM;     // [S][BM]
  float* sV = sMT + S * BM;     // [S][BM]: Vhat at the block's rows
  float* sT = sV + S * BM;      // [b][b]
  float* sY = sT + BM * BM;     // [kSymvThreads]: partial sums of Y's share
  float* sGrp = sY + kSymvThreads;  // [kSymvThreads][4]: the slot groups' sums
  // Vhat at the block's rows and T_j, copied while the partials are summed.
  for (int e = tid; e < S * BM; e += kSymvThreads) {
    const int k = rb + e / BM, cc = e % BM;
    const bool ok = k >= r0 && k < m && cc < b;
    repro::cp_async_zfill<4>(sV + e, ok ? Vh + (long long)(k - r0) * b + cc : Vh, ok ? 4 : 0);
  }
  for (int e = tid; e < b * b; e += kSymvThreads) repro::cp_async_zfill<4>(sT + e, T + e, 4);
  repro::cp_async_commit();
  const int nrow = B >= pl.I0 ? pl.strips(B) : 0;
  const int Imin = max(B, pl.I0);
  const int nsum = nrow + pl.cols(B);
  // Thread t sums float4 f = t % nf (and f + kSymvThreads) of the slots of
  // group t / nf, eight slots' loads in flight at a time.
  const int nf = S * BM / 4;
  const int G = max(1, kSymvThreads / nf);
  const int g = tid / nf;
  const int lo = g * nsum / G, hi = (g + 1) * nsum / G;
  for (int f = tid % nf; f < nf; f += 2 * kSymvThreads) {
    const bool two = f + kSymvThreads < nf;
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
    for (int q0 = lo; q0 < hi; q0 += 8) {
      float4 t0[8], t1[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = q0 + u;
        const float* slot = q < nrow ? sl.row(B, q) : sl.col(B, Imin + q - nrow);
        const float4* p = reinterpret_cast<const float4*>(slot) + f;
        t0[u] = q < hi ? __ldcg(p) : make_float4(0.f, 0.f, 0.f, 0.f);
        t1[u] = q < hi && two ? __ldcg(p + kSymvThreads) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s0.x += t0[u].x;
        s0.y += t0[u].y;
        s0.z += t0[u].z;
        s0.w += t0[u].w;
        s1.x += t1[u].x;
        s1.y += t1[u].y;
        s1.z += t1[u].z;
        s1.w += t1[u].w;
      }
    }
    if (G == 1) {
      for (int ch = 0; ch < pl.nch; ++ch) {
        const float4* p = reinterpret_cast<const float4*>(sl.comp(B, ch)) + f;
        const float4 t0 = __ldcg(p);
        const float4 t1 = two ? __ldcg(p + kSymvThreads) : make_float4(0.f, 0.f, 0.f, 0.f);
        s0.x -= t0.x;
        s0.y -= t0.y;
        s0.z -= t0.z;
        s0.w -= t0.w;
        s1.x -= t1.x;
        s1.y -= t1.y;
        s1.z -= t1.z;
        s1.w -= t1.w;
      }
      reinterpret_cast<float4*>(sM)[f] = s0;
      if (two) reinterpret_cast<float4*>(sM)[f + kSymvThreads] = s1;
    } else if (g < G) {
      reinterpret_cast<float4*>(sGrp)[tid] = s0;
    }
  }
  if (G > 1) {
    // The groups' sums added in group order, less the compensation.
    __syncthreads();
    if (tid < nf) {
      float4 s = reinterpret_cast<float4*>(sGrp)[tid];
      for (int gg = 1; gg < G; ++gg) {
        const float4 t = reinterpret_cast<float4*>(sGrp)[gg * nf + tid];
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
      for (int ch = 0; ch < pl.nch; ++ch) {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(sl.comp(B, ch)) + tid);
        s.x -= t.x;
        s.y -= t.y;
        s.z -= t.z;
        s.w -= t.w;
      }
      reinterpret_cast<float4*>(sM)[tid] = s;
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < nr * BM; e += kSymvThreads) {
    const int il = e / BM, c = e % BM;
    float mt = 0.f;
    if (c < b) {
#pragma unroll
      for (int cc = 0; cc < BM; ++cc)
        if (cc < b) mt += sM[il * BM + cc] * sT[cc * b + c];
      MT[(long long)(rb + il) * b + c] = mt;
    }
    sMT[e] = mt;
  }
  __syncthreads();
  // Y's share: P partial sums an entry over contiguous row ranges.
  const int bb = b * b;
  const int P = max(1, kSymvThreads / bb);
  for (int t = tid; t < P * bb; t += kSymvThreads) {
    const int e = t % bb, p = t / bb;
    const int a2 = e / b, c = e % b;
    const int lo = p * nr / P, hi = (p + 1) * nr / P;
    float y = 0.f;
    for (int il = lo; il < hi; ++il) y += sV[il * BM + a2] * sMT[il * BM + c];
    if (P == 1) sl.yshare(B, bb)[e] = y;
    else sY[t] = y;
  }
  if (P > 1) {
    __syncthreads();
    for (int e = tid; e < bb; e += kSymvThreads) {
      float y = sY[e];
      for (int p = 1; p < P; ++p) y += sY[p * bb + e];
      sl.yshare(B, bb)[e] = y;
    }
  }
  if (!last_arrival(yticket, pl.nt, s_last)) return;
  // Y: the blocks' shares summed in block order, P partial sums an entry
  // over contiguous ranges of blocks, then added in order.
  for (int t = tid; t < P * bb; t += kSymvThreads) {
    const int e = t % bb, p = t / bb;
    const int lo = p * pl.nt / P, hi = (p + 1) * pl.nt / P;
    float y = 0.f;
    for (int q0 = lo; q0 < hi; q0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = q0 + u < hi ? __ldcg(sl.yshare(q0 + u, bb) + e) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) y += v[u];
    }
    if (P == 1) Y[e] = y;
    else sY[t] = y;
  }
  if (P > 1) {
    __syncthreads();
    for (int e = tid; e < bb; e += kSymvThreads) {
      float y = sY[e];
      for (int p = 1; p < P; ++p) y += sY[p * bb + e];
      Y[e] = y;
    }
  }
}

// M = Bv[:, r0:] Vhat - Z X1 - V X2, MT = M T_j and Y = Vhat^T MT, from the
// lower triangle of rows r0..m of Bv alone: the view is bitwise symmetric
// (every caller passes one: see the header), so a stored element Bv[k, j],
// j <= k, adds Bv[k, j] x[j] to M[k] (the row product, x[j] = Vhat[j - r0],
// 0 for j < r0) and, for j < k, Bv[k, j] x[k] to M[j] (the column product;
// the rows i < r0 of M have only these).  One unit of SymvPlan a CTA.
//
// A strip (I, J0..J0+L-1): a warp owns a column strip of 32 of a row group
// (S / 32 strips, 8 / (S / 32) groups); lane (rl, cl) = (lane / BM, lane %
// BM) holds 32 / BM adjacent columns, their Vhat (xj) and their column sums
// (acc) in registers, and walks the group's rows 32 / BM at a time, each
// row coming through the lane's own ring of D = SymvPlan::depth(S) cp.async
// loads (zero past the diagonal, past m and above r0), which runs on across
// the strip's tiles.  Its entries of Vhat sit at v ^ cl, so that the row sums
// reduce-scatter over the BM lanes of a row by shuffles alone; each lane
// adds its row sum to its entry of the strip's row partial in shared
// memory.  After a tile the column sums are added over the lanes rl (and
// the groups, in order) into the column partial of block J; after the
// strip the column strips' row partials, in order, into the row partial of
// block I.  Each partial has a slot of its own; the CTA then arrives at the
// tickets of the blocks it wrote, and the last to arrive at a block
// finishes it (symv_finish).  No CTA waits on another.
template <int BM, bool kVec, int D>
__device__ __forceinline__ void gemv_tiles(const float* __restrict__ Bv, long long ldb,
                                           long long sbv, int m, int w, int b, int r0, int c0,
                                           const float* __restrict__ V,
                                           const float* __restrict__ Z,
                                           const float* __restrict__ Vh,
                                           const float* __restrict__ X,
                                           const float* __restrict__ T, float* __restrict__ MT,
                                           float* __restrict__ part, int* __restrict__ tickets,
                                           float* __restrict__ Y, const Workspace& ws) {
  const Bucket bk(m, w, b);
  {
    const long long z = blockIdx.y;
    Bv += z * sbv;
    V += z * bk.mw;
    Z += z * bk.mw;
    Vh += z * bk.mb;
    X += z * bk.x;
    T += z * bk.ts;
    MT += z * bk.mb;
    part += z * ws.r;
    tickets += z * ws.tickets;
    Y += z * bk.y;
  }
  constexpr int CPL = 32 / BM;  // columns a lane, rows a warp's step
  REPRO_DYNAMIC_SMEM(smem);
  __shared__ int s_last;
  __shared__ int s_done[kSymvMaxStrip + 1];  // the blocks whose last partial this CTA wrote, or -1
  const SymvPlan pl(m, b, c0);
  const SymvSlots sl(part + ws.gemv, m, w, b, BM);
  int* yticket = tickets + xred_chunks(w);
  int* bticket = yticket + 1;  // one a block of M
  const int S = pl.S, tid = threadIdx.x;

  int I, k;
  pl.unit_of(blockIdx.x, &I, &k);
  if (k < pl.ncomp) {
    const int B = I, ch = k / pl.nparts, piece = k % pl.nparts;
    const int ca = ch * kCompCols, rb = B * S + piece * kCompRows;
    symv_comp<BM>(rb, max(0, min(kCompRows, m - rb)), ca, min(c0, ca + kCompCols), w, b, V, Z, X,
                  sl.comp(B, ch) + piece * kCompRows * BM, smem);
    __threadfence();
    __syncthreads();
    if (tid <= kSymvMaxStrip) s_done[tid] = tid == 0 && arrive(bticket + B, pl.arrivals(B)) ? B : -1;
  } else {
    const int s = k - pl.ncomp;
    const int J0 = s * pl.L, nl = min(pl.L, I - J0 + 1);
    const int NS = S / 32, NG = (kSymvThreads / 32) / NS, RG = S / NG;
    const int nsteps = RG / CPL;
    float* sRow = smem;                                   // [NS][S][BM]
    float* sCol = sRow + NS * S * BM;                     // [NG][S][BM] (NG > 1)
    float* sX = sCol + (NG > 1 ? NG * S * BM : 0);        // [S][BM]
    float* sXj = sX + S * BM;                             // [L][S][BM]
    float* ring = sXj + pl.L * S * BM;                    // [D][kSymvThreads][CPL]
    const int lane = tid & 31, warp = tid >> 5;
    const int cl = lane % BM, rl = lane / BM;
    const int cstrip = warp % NS, group = warp / NS;
    const int jl = cstrip * 32 + cl * CPL;  // the lane's first column in a tile
    const int kl0 = group * RG + rl;        // its first row in a tile
    const int i0 = I * S;

    // Ring slot d of the lane holds its row of step t * nsteps + st of the
    // strip, d = st % D (D divides nsteps).  feed(d, t, st): that row of
    // tile t into slot d (zero past the diagonal, past m and above r0), then
    // one commit group (an empty one past the strip's last step).
    float* const ring0 = ring + tid * CPL;
    auto full_tile = [&](int J) { return J != I && i0 >= r0 && i0 + S <= m; };
    auto feed = [&](int d, int t, int st) {
      if (t < nl) {
        const int row = i0 + kl0 + st * CPL, j = (J0 + t) * S + jl;
        const float* src = Bv + (long long)row * ldb + j;
        int valid = CPL;
        if (!full_tile(J0 + t)) {
          valid = 0;
          if (row >= r0 && row < m)
            valid = max(0, min(min(CPL, m - j), J0 + t == I ? row + 1 - j : CPL));
        }
        float* dst = ring0 + d * kSymvThreads * CPL;
        if constexpr (kVec) {
          repro::cp_async_zfill<4 * CPL>(dst, valid > 0 ? src : Bv, 4 * valid);
        } else {
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            repro::cp_async_zfill<4>(dst + c, c < valid ? src + c : Bv, c < valid ? 4 : 0);
        }
      }
      repro::cp_async_commit();
    };
    // Vhat at the tile row's rows and at the strip's columns, 0 outside [r0,
    // m), copied with the ring's first rows.
    for (int e = tid; e < (1 + nl) * S * BM; e += kSymvThreads) {
      const int t = e / (S * BM), kk = (e / BM) % S, cc = e % BM;
      const int k = (t == 0 ? i0 : (J0 + t - 1) * S) + kk;
      const bool ok = k >= r0 && k < m && cc < b;
      float* dst = (t == 0 ? sX : sXj + (t - 1) * S * BM) + kk * BM + cc;
      repro::cp_async_zfill<4>(dst, ok ? Vh + (long long)(k - r0) * b + cc : Vh, ok ? 4 : 0);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) feed(d, 0, d);
    repro::cp_async_wait<D - 1>();
    __syncthreads();

    for (int t = 0; t < nl; ++t) {
      const int J = J0 + t;
      const bool diag = J == I;
      // xj[c][v]: Vhat entry v ^ cl of the lane's column c.
      float xj[CPL][BM];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int v = 0; v < BM; ++v) xj[c][v] = sXj[(t * S + jl + c) * BM + (v ^ cl)];
      float acc[CPL][BM];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int cc = 0; cc < BM; ++cc) acc[c][cc] = 0.f;
      for (int st0 = 0; st0 < nsteps; st0 += D) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int st = st0 + d, kl = kl0 + st * CPL;
          repro::cp_async_wait<D - 1>();
          float L[CPL], xk[BM];
          const float* in = ring0 + d * kSymvThreads * CPL;
          if constexpr (CPL == 4) {
            const float4 q = *reinterpret_cast<const float4*>(in);
            L[0] = q.x, L[1] = q.y, L[2] = q.z, L[3] = q.w;
          } else {
#pragma unroll
            for (int c = 0; c < CPL; ++c) L[c] = in[c];
          }
#pragma unroll
          for (int cc = 0; cc < BM; cc += 4) {
            const float4 q = *reinterpret_cast<const float4*>(sX + kl * BM + cc);
            xk[cc] = q.x, xk[cc + 1] = q.y, xk[cc + 2] = q.z, xk[cc + 3] = q.w;
          }
          float r[BM];
#pragma unroll
          for (int v = 0; v < BM; ++v) {
            float q = 0.f;
#pragma unroll
            for (int c = 0; c < CPL; ++c) q += L[c] * xj[c][v];
            r[v] = q;
          }
          // r[v] holds the row's sum for column v ^ cl of Vhat; halve over the lanes cl ^ h.
#pragma unroll
          for (int h = BM / 2; h > 0; h >>= 1)
#pragma unroll
            for (int v = 0; v < h; ++v) r[v] += __shfl_xor_sync(0xffffffffu, r[v + h], h);
          float* prow = sRow + (cstrip * S + kl) * BM + cl;
          *prow = t == 0 ? r[0] : *prow + r[0];
          if (diag) {
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              if (jl + c >= kl) L[c] = 0.f;  // the diagonal counts once, in the row product
          }
#pragma unroll
          for (int c = 0; c < CPL; ++c)
#pragma unroll
            for (int cc = 0; cc < BM; ++cc) acc[c][cc] += L[c] * xk[cc];
          // The slot just read takes the row D steps on: this tile's or the next one's.
          if (st + D < nsteps) feed(d, t, st + D);
          else feed(d, t + 1, st + D - nsteps);
        }
      }
      // Column sums over the lanes rl; lane rl writes column jl + rl.
#pragma unroll
      for (int h = BM; h < 32; h <<= 1)
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int cc = 0; cc < BM; ++cc) acc[c][cc] += __shfl_xor_sync(0xffffffffu, acc[c][cc], h);
      float* cdst = NG > 1 ? sCol + (group * S + jl + rl) * BM : sl.col(J, I) + (jl + rl) * BM;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (c == rl) {
#pragma unroll
          for (int cc = 0; cc < BM; cc += 4)
            *reinterpret_cast<float4*>(cdst + cc) =
                make_float4(acc[c][cc], acc[c][cc + 1], acc[c][cc + 2], acc[c][cc + 3]);
        }
      if (NG > 1) {
        __syncthreads();
        float4* dst = reinterpret_cast<float4*>(sl.col(J, I));
        for (int f = tid; f < S * BM / 4; f += kSymvThreads) {
          float4 q = reinterpret_cast<const float4*>(sCol)[f];
          for (int gg = 1; gg < NG; ++gg) {
            const float4 p = reinterpret_cast<const float4*>(sCol + gg * S * BM)[f];
            q.x += p.x;
            q.y += p.y;
            q.z += p.z;
            q.w += p.w;
          }
          dst[f] = q;
        }
        __syncthreads();
      }
    }
    repro::cp_async_wait<0>();
    __syncthreads();
    float4* rdst = reinterpret_cast<float4*>(sl.row(I, s));
    for (int f = tid; f < S * BM / 4; f += kSymvThreads) {
      float4 q = reinterpret_cast<const float4*>(sRow)[f];
      for (int t = 1; t < NS; ++t) {
        const float4 p = reinterpret_cast<const float4*>(sRow + t * S * BM)[f];
        q.x += p.x;
        q.y += p.y;
        q.z += p.z;
        q.w += p.w;
      }
      rdst[f] = q;
    }
    __threadfence();
    __syncthreads();
    // Lane t < nl arrives at block J0 + t with its column partial, lane
    // kSymvMaxStrip at block I with the row partial.
    if (tid <= kSymvMaxStrip) {
      int done = -1;
      if (tid < nl) done = arrive(bticket + J0 + tid, pl.arrivals(J0 + tid)) ? J0 + tid : -1;
      else if (tid == kSymvMaxStrip) done = arrive(bticket + I, pl.arrivals(I)) ? I : -1;
      s_done[tid] = done;
    }
  }
  __syncthreads();
  bool any = false;
  for (int q = 0; q <= kSymvMaxStrip; ++q) any |= s_done[q] >= 0;
  if (any) __threadfence();
  for (int q = 0; q <= kSymvMaxStrip; ++q) {
    const int B = s_done[q];
    if (B < 0) continue;
    __syncthreads();  // the shared memory of the previous finish or of the unit
    symv_finish<BM>(B, pl, sl, m, b, r0, Vh, T, MT, yticket, Y, smem, &s_last);
  }
}

// Rows per warp of the row walk (its rows x BM accumulators stay in
// registers) and Vhat rows per staged chunk.
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
// order into Y, its threads over contiguous ranges of them.
template <int BM, bool kXSmem>
__device__ __forceinline__ void gemv_rows(const float* __restrict__ Bv, long long ldb, long long sbv,
                                          int m, int w, int b, int r0, int c0,
                                          const float* __restrict__ V, const float* __restrict__ Z,
                                          const float* __restrict__ Vh, const float* __restrict__ X,
                                          const float* __restrict__ T, float* __restrict__ MT,
                                          float* __restrict__ part, int* __restrict__ ticket,
                                          float* __restrict__ Y, const Workspace& ws) {
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
    part += z * ws.r + ws.gemv;
    ticket += z * ws.tickets + xred_chunks(w);
    Y += z * bk.y;
  }
  constexpr int R = Gemv<BM>::kRows;
  constexpr int KC = Gemv<BM>::kChunk;
  constexpr int U = kGemvUnroll;
  REPRO_DYNAMIC_SMEM(smem);
  __shared__ float sT[BM * BM];
  __shared__ int s_last;
  float* sVh = smem;           // [BM][KC]: Vhat chunk, transposed
  float* sx = smem + BM * KC;  // X1^T, X2^T ([b][c0] each) when they fit
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  if (kXSmem) {
    // kGemvLoads loads of X1 and of X2 in flight a thread.
    for (int e0 = tid; e0 < c0 * b; e0 += kGemvLoads * blockDim.x) {
      float x1v[kGemvLoads], x2v[kGemvLoads];
#pragma unroll
      for (int u = 0; u < kGemvLoads; ++u) {
        const int e = e0 + u * blockDim.x;
        x1v[u] = e < c0 * b ? X[e] : 0.f;
        x2v[u] = e < c0 * b ? X[w * b + e] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kGemvLoads; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < c0 * b) {
          sx[(e % b) * c0 + e / b] = x1v[u];
          sx[(b + e % b) * c0 + e / b] = x2v[u];
        }
      }
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
    // 32 / BM rows of Vhat loaded a thread at once.
    constexpr int KR = 32 / BM;
    for (int k0 = tid; k0 < kn; k0 += KR * blockDim.x) {
      float vr[KR][BM];
#pragma unroll
      for (int u = 0; u < KR; ++u) {
        const int k = k0 + u * blockDim.x;
        const float* src = Vh + (long long)(kc - r0 + min(k, kn - 1)) * b;
#pragma unroll
        for (int cc = 0; cc < BM; ++cc) vr[u][cc] = cc < b && k < kn ? src[cc] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < KR; ++u) {
        const int k = k0 + u * blockDim.x;
        if (k < kn) {
#pragma unroll
          for (int cc = 0; cc < BM; ++cc)
            if (cc < b) sVh[cc * KC + k] = vr[u][cc];
        }
      }
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
  // The compensation - Z X1 - V X2, lanes over c < c0 in order, with
  // kGemvLoads loads of each of Z's and V's rows in flight.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(row0 + r, m - 1);
    const float* zi = Z + (long long)i * w;
    const float* vi = V + (long long)i * w;
    for (int c0l = lane; c0l < c0; c0l += 32 * kGemvLoads) {
      float zv[kGemvLoads], vv[kGemvLoads];
#pragma unroll
      for (int u = 0; u < kGemvLoads; ++u) {
        const int c = c0l + 32 * u;
        zv[u] = c < c0 ? zi[c] : 0.f;
        vv[u] = c < c0 ? vi[c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kGemvLoads; ++u) {
        const int c = c0l + 32 * u;
        if (c < c0) {
#pragma unroll
          for (int cc = 0; cc < BM; ++cc)
            if (cc < b) acc[r][cc] -= zv[u] * x1[c * xs + cc * xt] + vv[u] * x2[c * xs + cc * xt];
        }
      }
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
  // The warps' shares of Y, each in its own place where Vhat was staged,
  // added in warp order into the CTA's slot.
  const int bb = b * b;
  float* sY = smem;  // [nwarps][b * b], then the final sum's partial sums
  __syncthreads();
  if (lane < b) {
#pragma unroll
    for (int a = 0; a < BM; ++a)
      if (a < b) sY[warp * bb + a * b + lane] = ya[a];
  }
  __syncthreads();
  float* slot = part + (long long)blockIdx.x * bb;
  for (int e = tid; e < bb; e += blockDim.x) {
    float s = sY[e];
    for (int wp = 1; wp < nwarps; ++wp) s += sY[wp * bb + e];
    slot[e] = s;
  }
  if (!last_arrival(ticket, gridDim.x, &s_last)) return;
  // Y: the slots summed in CTA order, P partial sums an entry over
  // contiguous ranges of slots, then added in order.
  const int n = gridDim.x, P = max(1, (int)blockDim.x / bb);
  for (int t = tid; t < P * bb; t += blockDim.x) {
    const int e = t % bb, p = t / bb;
    float s = 0.f;
#pragma unroll 4
    for (int r = p * n / P; r < (p + 1) * n / P; ++r) s += __ldcg(part + (long long)r * bb + e);
    sY[t] = s;
  }
  __syncthreads();
  for (int e = tid; e < bb; e += blockDim.x) {
    float s = sY[e];
    for (int p = 1; p < P; ++p) s += sY[p * bb + e];
    Y[e] = s;
  }
}

// K3: the row walk where gemv_rows_for(m) says so (D = 0; kA: X1, X2 in
// shared memory), else the symmetric product (ring depth D; kA: 16-byte
// copies of Bv).  One name for both, so that a trace sums them as one.
template <int BM, int D, bool kA>
__global__ void __launch_bounds__(D ? kSymvThreads : kGemvThreads, D && BM == 8 ? 2 : 1)
    panel_gemv(const float* __restrict__ Bv, long long ldb, long long sbv, int m, int w, int b,
               int r0, int c0, const float* __restrict__ V, const float* __restrict__ Z,
               const float* __restrict__ Vh, const float* __restrict__ X,
               const float* __restrict__ T, float* __restrict__ MT, float* __restrict__ part,
               int* __restrict__ tickets, float* __restrict__ Y, Workspace ws) {
  if constexpr (D == 0)
    gemv_rows<BM, kA>(Bv, ldb, sbv, m, w, b, r0, c0, V, Z, Vh, X, T, MT, part, tickets, Y, ws);
  else
    gemv_tiles<BM, kA, D>(Bv, ldb, sbv, m, w, b, r0, c0, V, Z, Vh, X, T, MT, part, tickets, Y, ws);
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
  const Workspace ws(m, w, b);
  // panel_gemv: the symmetric product reads rows of Bv in 4 * (32 /
  // BM)-byte copies where every matrix's rows align to them, and its shared
  // memory depends on m alone; the row walk's X1, X2 go to shared memory
  // while they fit (2 c0 b floats, the most at the last panel).
  constexpr int kCpl = 32 / BM;
  const bool rows = gemv_rows_for(m);
  const bool vec = (uintptr_t)Bv % (4 * kCpl) == 0 && ldb % kCpl == 0 && sbv % kCpl == 0;
  const SymvPlan pl0(m, b, 0);
  const int vh_bytes = BM * Gemv<BM>::kChunk * (int)sizeof(float);
  // The row walk's X1, X2 in shared memory up to x_cap bytes: what Vhat's
  // chunk and 8 KB for its static T_j (BM x BM floats) leave of a block's
  // shared memory, at most kGemvSmemMax.
  const int x_cap = min(kGemvSmemMax, repro::kSmemPerBlockMax - vh_bytes - 8192);
  auto gemv = rows ? panel_gemv<BM, 0, false>
              : SymvPlan::depth(pl0.S) == 16 ? (vec ? panel_gemv<BM, 16, true> : panel_gemv<BM, 16, false>)
                                             : (vec ? panel_gemv<BM, 4, true> : panel_gemv<BM, 4, false>);
  const int gemv_smem = rows ? vh_bytes : symv_smem_floats<BM>(pl0) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gemv, cudaFuncAttributeMaxDynamicSharedMemorySize, gemv_smem);
  if (err != cudaSuccess) return (int)err;
  if (rows) {
    err = cudaFuncSetAttribute(panel_gemv<BM, 0, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               vh_bytes + x_cap);
    if (err != cudaSuccess) return (int)err;
  }
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
  auto qr_kernel = [](bool in_smem) {
    if constexpr (BM == 32)
      return in_smem ? panel_qr_cluster_bounded<BM, true> : panel_qr_cluster_bounded<BM, false>;
    else
      return in_smem ? panel_qr_cluster<BM, true> : panel_qr_cluster<BM, false>;
  };
  auto qr = qr_kernel(slice_in_smem);
  err = cudaFuncSetAttribute(qr, cudaFuncAttributeMaxDynamicSharedMemorySize, qr_smem);
  if (err != cudaSuccess) return (int)err;
  const int cs = repro::fit_cluster(qr, repro::kQrThreads, qr_smem, cluster);
  if (cs > repro::kMaxCluster) return (int)cudaErrorInvalidValue;
  if (cs != cluster) {
    qr_smem = qr_smem_for(cs, &slice_in_smem);
    qr = qr_kernel(slice_in_smem);
    err = cudaFuncSetAttribute(qr, cudaFuncAttributeMaxDynamicSharedMemorySize, qr_smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int q = w / b;
  const unsigned nz = (unsigned)batch;
  for (int j = 0; j < q; ++j) {
    const int c0 = j * b;
    const int r0 = c0 + b;
    err = REPRO_LAUNCH_CLUSTER(qr, dim3(cs, nz), dim3(repro::kQrThreads), (size_t)qr_smem, st,
                               (unsigned)cs, (const float*)Bv, ldb, sbv, m, w, b, c0, j, V, Vh, F,
                               Ts, P, tickets, ws);
    if (err != cudaSuccess) return (int)err;
    REPRO_CHECK_LAUNCH();
    if (j > 0) {
      const int nrc = (int)blocks_for(m - r0, kXredRows);
      REPRO_LAUNCH(panel_xred<BM>, dim3(nrc * xred_chunks(c0), nz), kXredCols * kXredGroups, 0, st)
      (V, Z, Vh, m, w, b, r0, c0, nrc, R, tickets, X, ws);
      REPRO_CHECK_LAUNCH();
    }
    if (rows) {
      const int x_bytes = 2 * c0 * b * (int)sizeof(float);
      const bool x_in_smem = x_bytes <= x_cap;
      auto walk = x_in_smem ? panel_gemv<BM, 0, true> : panel_gemv<BM, 0, false>;
      REPRO_LAUNCH(walk, dim3(blocks_for(m, (kGemvThreads / 32) * Gemv<BM>::kRows), nz),
                   kGemvThreads, vh_bytes + (x_in_smem ? x_bytes : 0), st)
      (Bv, ldb, sbv, m, w, b, r0, c0, V, Z, Vh, X, Ts + (long long)j * b * b, MT, R, tickets, Y, ws);
    } else {
      REPRO_LAUNCH(gemv, dim3((unsigned)SymvPlan(m, b, c0).units(), nz), kSymvThreads, gemv_smem, st)
      (Bv, ldb, sbv, m, w, b, r0, c0, V, Z, Vh, X, Ts + (long long)j * b * b, MT, R, tickets, Y, ws);
    }
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
// 1 where panel_gemv walks whole rows of an (m, m) view (see gemv_rows_for).
extern "C" int fused_panel_gemv_rows(int m) { return gemv_rows_for(m); }

extern "C" long long fused_panel_update_workspace(int m, int w, int b, int* ntickets) {
  const Workspace ws(m, w, b);
  *ntickets = ws.tickets;
  return ws.r;
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
