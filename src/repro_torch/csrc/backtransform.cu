// Kernel C: blocked Q2 back-transform from the sweep-major chase log.
//
// Replaces repro/kernels/backtransform.py:backtransform_wy_pallas (body
// _bt_kernel).  Applies Q2 X (sweeps s = S-1 .. 0) or Q2^T X (s = 0 ..
// S-1) to X (n, m) in place; within sweep s, reflector k updates the b rows
// [s+1+kb, s+1+(k+1)b): P <- P - tau v (v^T P).  Rows at or past n are
// skipped (their v entries are zero; the TPU kernel pads X instead).
//
// What bounds it on the H100: S ~ n sweeps each touch the whole (n, m)
// panel at 4 flops per element, so the flops are 4 S n m while the panel is
// read and written once: operations-bound on the fp32 SIMT units once the
// panel is held on chip.
//
// Design.  The TPU kernel keeps the whole padded panel in VMEM and walks the
// sweeps as a sequential grid.  Here each CTA owns a strip of `cw` columns
// (in shared memory when it fits the wrapper's budget, else in global
// memory) and the sweeps are blocked: block (G, k) is the reflectors (s, k)
// of the kGroup consecutive sweeps s of group G, spanning kGroup + b - 1
// rows.  For Q2^T X, block (G, k) must follow (G, k+1) and (G-1, k), and
// every other overlapping pair is ordered through those two, so the blocks
// of one anti-diagonal t = G + (K-1-k) touch disjoint rows: the CTA walks
// the ~S/kGroup + K anti-diagonals (not the S sweeps) in stages of up to
// kBlocks blocks of one anti-diagonal, a __syncthreads() pair per stage, and
// its threads take the (block, column) pairs of a stage.  A thread loads its column's rows of the block into
// registers once, applies the block's reflectors from there and writes the
// rows back: strip traffic falls ~kGroup-fold against one pass per sweep.
// The sweep-major log scatters a block's reflectors K*b floats apart, so a
// first launch (regroup_log) rewrites it once per call block by block in
// walk order: kGroup v rows (zero past b) then kGroup taus, contiguous, and
// zero where a sweep is past S.  Every CTA then stages up to kLogChunk
// floats of it (about one block-column item per thread) into shared memory
// with coalesced 16-byte cp.async, kStages buffers deep: the next two
// stages' copies are in flight while one is applied.  Q2 X runs
// the exact reverse (anti-diagonals descending, sweeps descending inside a
// block).  Blocks whose first row is at or past n are skipped; reflectors
// with tau == 0 (masked slots, and sweeps past S in a short last group,
// staged as zeros) leave the strip as it is.  A bucket (the counterpart of
// the batching rule that jax.vmap gives the Pallas kernel): one call applies
// the logs of `batch` matrices to their X, both launches taking the matrix
// from blockIdx.y, each matrix with its own regrouped log.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRegroupThreads = 256;
constexpr int kGroup = 8;         // sweeps per block
constexpr int kLogChunk = 3456;   // floats of staged log per buffer
constexpr int kStages = 3;        // log buffers: two stages in flight while one is applied

// Staged log of one block: [kGroup][BB] v (zero past b), then [kGroup] tau;
// a buffer holds up to kBlocks blocks.
template <int BB>
struct Stage {
  static constexpr int kPer = kGroup * BB + kGroup;
  static constexpr int kBlocks = kLogChunk / kPer;
};

// The blocks of anti-diagonal t (walk index tt) whose first row is below
// n: grp in [glo, ghi], k = grp + K-1-t.
template <bool kT>
__host__ __device__ inline int diag_range(int tt, int T, int ngroups, int n, int b, int K,
                                          int& glo, int& ghi) {
  const int t = kT ? tt : T - 1 - tt;
  glo = t - (K - 1) > 0 ? t - (K - 1) : 0;
  ghi = ngroups - 1 < t ? ngroups - 1 : t;
  const long long lim = (long long)n - 2 - (long long)(K - 1 - t) * b;
  const long long top = lim / (kGroup + b);
  if (lim < 0) ghi = -1;
  else if (top < ghi) ghi = (int)top;
  return t;
}

// A position in the walk: anti-diagonal walk index tt (t its anti-diagonal,
// [glo, ghi] its blocks) and the first group g0 of a stage.
// `off` is the regrouped log's index of block glo of anti-diagonal t (the
// blocks of all anti-diagonals, t ascending); the walk of Q2 X (kT false)
// starts it at the total and counts down.
struct Cursor {
  int tt, t, glo, ghi, g0;
  long long off;
  __device__ __forceinline__ int count(int kBlocks) const { return min(kBlocks, ghi - g0 + 1); }
  __device__ __forceinline__ long long block(int g) const { return off + (g - glo); }
  // The next stage: the rest of this anti-diagonal, else the next non-empty one.
  template <bool kT>
  __device__ __forceinline__ void advance(int kBlocks, int T, int ngroups, int n, int b, int K) {
    if (tt >= 0 && g0 + kBlocks <= ghi) {
      g0 += kBlocks;
      return;
    }
    if (kT && tt >= 0) off += ghi - glo + 1;
    for (++tt; tt < T; ++tt) {
      t = diag_range<kT>(tt, T, ngroups, n, b, K, glo, ghi);
      if (ghi >= glo) break;
    }
    if (!kT && tt < T) off -= ghi - glo + 1;
    g0 = glo;
  }
};

// Blocks of the log, all anti-diagonals: the regrouped log's length / kPer.
__host__ __device__ inline long long log_blocks(int n, int S, int K, int b) {
  const int ngroups = (S + kGroup - 1) / kGroup;
  const int T = ngroups + K - 1;
  long long total = 0;
  for (int t = 0; t < T; ++t) {
    int glo, ghi;
    diag_range<true>(t, T, ngroups, n, b, K, glo, ghi);
    if (ghi >= glo) total += ghi - glo + 1;
  }
  return total;
}

// Block (grp, k) on column c of the strip P (leading dimension ld): its
// rows [grp*G + 1 + k*b, +G+b-1) in registers, the reflectors from the
// staged log `lg`.  BB >= b is the compile-time reflector length; a block
// cut short by n (or b < BB) takes the predicated path.  A reflector with
// tau == 0 leaves x as it is (x - 0 * v = x), so there is no branch on it.
template <int BB, bool kT, bool kSmem>
__device__ __forceinline__ void apply_block(float* P, long long ld, int c, int n, int b,
                                            int grp, int k, const float* lg) {
  using Idx = typename std::conditional<kSmem, int, long long>::type;
  constexpr int G = kGroup;
  constexpr int R = G + BB - 1;
  const int row0 = grp * G + 1 + k * b;
  const int rows = min(G + b - 1, n - row0);
  const Idx ldi = (Idx)ld;
  float* p = P + (Idx)row0 * ldi + c;
  const bool full = rows == R;
  float x[R];
  if (full) {
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = p[r * ldi];
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = r < rows ? p[r * ldi] : 0.f;
  }
  float tau[G];
#pragma unroll
  for (int j = 0; j < G; j += 4) {
    const float4 t4 = *reinterpret_cast<const float4*>(lg + G * BB + j);
    tau[j] = t4.x;
    tau[j + 1] = t4.y;
    tau[j + 2] = t4.z;
    tau[j + 3] = t4.w;
  }
#pragma unroll
  for (int jj = 0; jj < G; ++jj) {
    const int j = kT ? jj : G - 1 - jj;
    float vr[BB];
#pragma unroll
    for (int r = 0; r < BB; r += 4) {
      const float4 v4 = *reinterpret_cast<const float4*>(lg + j * BB + r);
      vr[r] = v4.x;
      vr[r + 1] = v4.y;
      vr[r + 2] = v4.z;
      vr[r + 3] = v4.w;
    }
    // v^T x as two interleaved chains (half the dependent latency)
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int r = 0; r < BB; r += 2) {
      p0 += vr[r] * x[j + r];
      p1 += vr[r + 1] * x[j + r + 1];
    }
    const float tp = tau[j] * (p0 + p1);
#pragma unroll
    for (int r = 0; r < BB; ++r) x[j + r] -= tp * vr[r];
  }
  if (full) {
#pragma unroll
    for (int r = 0; r < R; ++r) p[r * ldi] = x[r];
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < rows) p[r * ldi] = x[r];
  }
}

// Copy `nb` blocks of the regrouped log, from block `first`, into `buf`.
template <int BB>
__device__ __forceinline__ void stage_log(float* buf, const float* __restrict__ lg,
                                          long long first, int nb) {
  constexpr int kPer = Stage<BB>::kPer;
  const float* src = lg + first * kPer;
  for (int e = threadIdx.x; e < nb * kPer / 4; e += blockDim.x)
    repro::cp_async16(buf + 4 * e, src + 4 * e);
  repro::cp_async_commit();
}

// One CTA per anti-diagonal t: its blocks' v and tau, regrouped (see above).
template <int BB>
__global__ void regroup_log(const float* __restrict__ vs, const float* __restrict__ taus,
                            int n, int S, int K, int b, float* __restrict__ lg, long long lg_floats) {
  __shared__ long long part[kRegroupThreads];
  constexpr int G = kGroup;
  constexpr int kPer = Stage<BB>::kPer;
  vs += blockIdx.y * (long long)S * K * b;
  taus += blockIdx.y * (long long)S * K;
  lg += blockIdx.y * lg_floats;
  const int ngroups = (S + G - 1) / G;
  const int T = ngroups + K - 1;
  const int t = blockIdx.x;
  int glo, ghi;
  // Blocks of the anti-diagonals before t, counted in integers (exact at
  // any n): a partial per thread, then every thread sums the partials.
  long long mine = 0;
  for (int u = threadIdx.x; u < t; u += blockDim.x) {
    diag_range<true>(u, T, ngroups, n, b, K, glo, ghi);
    if (ghi >= glo) mine += ghi - glo + 1;
  }
  part[threadIdx.x] = mine;
  __syncthreads();
  long long off = 0;
  for (int i = 0; i < kRegroupThreads; ++i) off += part[i];
  diag_range<true>(t, T, ngroups, n, b, K, glo, ghi);
  for (int e = threadIdx.x; e < (ghi - glo + 1) * kPer; e += blockDim.x) {
    const int grp = glo + e / kPer;
    const int o = e % kPer;
    const int k = grp + K - 1 - t;
    float val;
    if (o < G * BB) {
      const int s = grp * G + o / BB;
      const int r = o % BB;
      val = s < S && r < b ? vs[((long long)s * K + k) * b + r] : 0.f;
    } else {
      const int s = grp * G + (o - G * BB);
      val = s < S ? taus[(long long)s * K + k] : 0.f;
    }
    lg[(off + grp - glo) * kPer + o] = val;
  }
}

// kSmem: the strip is in shared memory (so its accesses compile to shared
// loads and stores, not generic ones).
template <int BB, bool kT, bool kSmem>
__global__ void backtransform_blocked(float* __restrict__ X, int n, int m,
                                      const float* __restrict__ lgr, long long total, int S,
                                      int K, int b, int cw) {
  REPRO_DYNAMIC_SMEM(sm);
  constexpr int kPer = Stage<BB>::kPer;
  X += blockIdx.y * (long long)n * m;
  lgr += blockIdx.y * total * kPer;
  const int c0 = blockIdx.x * cw;
  const int nc = min(cw, m - c0);
  // Blocks per stage: about one (block, column) item per thread.
  const int kBlocks = max(1, min(Stage<BB>::kBlocks, (int)blockDim.x / nc));
  float* P = kSmem ? sm + kStages * kLogChunk : X + c0;
  const long long ld = kSmem ? cw : m;
  if (kSmem) {
    for (long long e = threadIdx.x; e < (long long)n * nc; e += blockDim.x) {
      const long long r = e / nc;
      const int c = (int)(e % nc);
      P[r * ld + c] = X[r * m + c0 + c];
    }
  }
  const int ngroups = (S + kGroup - 1) / kGroup;
  const int T = ngroups + K - 1;
  // Stages: up to kBlocks blocks of one non-empty anti-diagonal, in walk
  // order.  `iss` is the next stage to copy, `cur` the next to apply.
  Cursor iss{-1, 0, 0, -1, 0, kT ? 0 : total}, cur;
  iss.advance<kT>(kBlocks, T, ngroups, n, b, K);
  cur = iss;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (iss.tt < T) {
      stage_log<BB>(sm + p * kLogChunk, lgr, iss.block(iss.g0), iss.count(kBlocks));
      iss.advance<kT>(kBlocks, T, ngroups, n, b, K);
    } else {
      repro::cp_async_commit();
    }
  }
  for (int i = 0; cur.tt < T; ++i) {
    if (iss.tt < T) {
      stage_log<BB>(sm + (i + kStages - 1) % kStages * kLogChunk, lgr, iss.block(iss.g0),
                    iss.count(kBlocks));
      iss.advance<kT>(kBlocks, T, ngroups, n, b, K);
    } else {
      repro::cp_async_commit();
    }
    repro::cp_async_wait<kStages - 1>();
    __syncthreads();
    // Computed from `sm` (not picked from an array) so that its reads
    // compile to shared loads.
    const float* lg = sm + i % kStages * kLogChunk;
    const int items = cur.count(kBlocks) * nc;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int blk = it / nc;
      const int grp = cur.g0 + blk;
      apply_block<BB, kT, kSmem>(P, ld, it % nc, n, b, grp, grp + K - 1 - cur.t, lg + blk * kPer);
    }
    __syncthreads();
    cur.advance<kT>(kBlocks, T, ngroups, n, b, K);
  }
  if (kSmem) {
    for (long long e = threadIdx.x; e < (long long)n * nc; e += blockDim.x) {
      const long long r = e / nc;
      const int c = (int)(e % nc);
      X[r * m + c0 + c] = P[r * ld + c];
    }
  }
}

template <int BB>
int run(float* X, int n, int m, const float* vs, const float* taus, int S, int K, int b,
        int transpose, int cw, int use_smem, float* work, int batch, cudaStream_t st) {
  const int ngroups = (S + kGroup - 1) / kGroup;
  const long long total = log_blocks(n, S, K, b);
  REPRO_LAUNCH(regroup_log<BB>, dim3(ngroups + K - 1, batch), kRegroupThreads, 0, st)
  (vs, taus, n, S, K, b, work, total * Stage<BB>::kPer);
  REPRO_CHECK_LAUNCH();
  auto kern = transpose ? (use_smem ? backtransform_blocked<BB, true, true>
                                    : backtransform_blocked<BB, true, false>)
                        : (use_smem ? backtransform_blocked<BB, false, true>
                                    : backtransform_blocked<BB, false, false>);
  const long long smem = (long long)kStages * kLogChunk * (long long)sizeof(float) +
                         (use_smem ? (long long)n * cw * (long long)sizeof(float) : 0);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((m + cw - 1) / cw);
  REPRO_LAUNCH(kern, dim3(blocks, batch), kThreads, smem, st)(X, n, m, work, total, S, K, b, cw);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// Floats of the launcher's workspace `work` (the regrouped log) a matrix;
// a call on a bucket takes `batch` times as many.
extern "C" long long backtransform_wy_workspace(int n, int S, int K, int b) {
  if (n < 1 || S < 1 || K < 1 || b < 1 || b > 32) return 0;
  const int per = b <= 4 ? Stage<4>::kPer : b <= 8 ? Stage<8>::kPer : b <= 16 ? Stage<16>::kPer
                                                                            : Stage<32>::kPer;
  return log_blocks(n, S, K, b) * per;
}

// Two launches per call (regroup_log, backtransform_blocked), whatever its
// batch.  X (batch, n, m), vs (batch, S, K, b), taus (batch, S, K), all
// contiguous; batch <= 65535 (gridDim.y); b <= 32; cw * n * 4 bytes of
// strip in shared memory (use_smem) plus the staged log must fit the
// H100's 227 KB per block.
extern "C" int backtransform_wy_launch(float* X, int n, int m, const float* vs,
                                       const float* taus, int S, int K, int b, int transpose,
                                       int cw, int use_smem, float* work, int batch, void* stream) {
  if (n < 1 || m < 1 || cw < 1 || b < 1 || S < 1 || K < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (b <= 4) return run<4>(X, n, m, vs, taus, S, K, b, transpose, cw, use_smem, work, batch, st);
  if (b <= 8) return run<8>(X, n, m, vs, taus, S, K, b, transpose, cw, use_smem, work, batch, st);
  if (b <= 16) return run<16>(X, n, m, vs, taus, S, K, b, transpose, cw, use_smem, work, batch, st);
  if (b <= 32) return run<32>(X, n, m, vs, taus, S, K, b, transpose, cw, use_smem, work, batch, st);
  return (int)cudaErrorInvalidValue;
}
