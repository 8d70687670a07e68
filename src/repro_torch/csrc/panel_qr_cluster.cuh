// The Householder panel QR of kernels A (fused_panel.cu, LAPACK signs) and
// E (panel.cu, beta = +|x|), spread over the CTAs of one thread-block
// cluster: port of repro/kernels/panel.py:panel_qr_body followed by larft,
// with the sign as a template parameter.
//
// The (rows, b) panel is split by rows: the CTA of cluster rank r holds panel
// rows [base, base + nrows) in W, column-major with leading dimension ldw
// (its own shared memory, or global memory above the caller's budget).
// Each of the b Householder steps needs, from all rows, the sums
// d[c] = sum_{i>j} W[i][j] W[i][c] (c >= j; d[j] is sigma) and the pivot
// row W[j][c]; with them every CTA forms tau, beta and v0 (by the sign's
// rule from alpha = W[j][j], sigma and mu = |x|) and
// acc[c] = W[j][c] + d[c] / v0 itself (the sum of v_i W[i][c] over the
// step's rows, v_i = W[i][j] / v0 below the pivot, up to rounding).  So one
// pass over its rows per step applies the previous step's update and
// gathers the next step's partial sums, and one cluster exchange per step
// (partials in shared memory, a cluster barrier, every CTA summing its
// peers' partials through distributed shared memory in one fixed order, so
// all CTAs get bitwise the same totals) replaces a one-CTA recurrence's two
// block reductions.  larft's V^T V is one more exchange; rank 0 runs the T
// recurrence.  A cluster of one CTA is the one-CTA QR.
//
// Shared state lives in dynamic shared memory (ClusterQrSmem), as the host
// emulation requires of a cluster kernel.  Every function contains barriers:
// call it from all threads of all CTAs of the cluster, with a block of
// 32 to kQrThreads threads, a multiple of 32.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kQrThreads = 512;
constexpr int kMaxCluster = 16;

// Float offsets of a cluster CTA's exchange state in dynamic shared memory.
template <int BM>
struct ClusterQrSmem {
  static constexpr int kPairs = BM * (BM - 1) / 2;
  static constexpr int kNP = 2 * BM > kPairs ? 2 * BM : kPairs;
  static constexpr int kRed = kQrThreads > (kQrThreads / 32) * BM ? kQrThreads : (kQrThreads / 32) * BM;
  static constexpr int part = 0;             // [kNP]: this CTA's partials
  static constexpr int tot = kNP;            // [kNP]: the cluster's totals
  static constexpr int red = tot + kNP;      // [kRed]: per-warp / per-group partials
  static constexpr int tau = red + kRed;     // [BM]
  static constexpr int piv = tau + BM;       // [BM]: the pivot row, if this CTA holds it
  static constexpr int T = piv + BM;         // [BM * BM]
  static constexpr int gather = T + BM * BM; // [2][kMaxCluster][kNP]: partials pushed by peers
  static constexpr int total = gather + 2 * kMaxCluster * kNP;
};

// Sum the first `cnt` floats of `part` (this CTA's partials, complete for
// the whole CTA) over the cluster into `tot`.  Each CTA pushes its partials
// into slot [rank] of every peer's `gather` (buffer `par`, alternating by
// exchange: a peer may push the next exchange's partials before this CTA
// has read the last ones) before the cluster barrier, so after it every
// read is local; the 16 lanes of value i then add the peers' values in a
// fixed shuffle tree, so every CTA gets bitwise the same totals.
template <int NP>
__device__ __forceinline__ void cluster_sum(const float* part, int cnt, float* tot,
                                            float* gather, int par, int cs) {
  static_assert(kMaxCluster == 16, "one value per 16 lanes");
  float* slot = gather + (par * kMaxCluster + (int)cluster_rank()) * NP;
  for (int e = threadIdx.x; e < cnt * cs; e += blockDim.x)
    cluster_peer(slot, (unsigned)(e / cnt))[e % cnt] = part[e % cnt];
  cluster_sync();
  const float* g = gather + par * kMaxCluster * NP;
  for (int e0 = 0; e0 < cnt * kMaxCluster; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    const int i = e / kMaxCluster;
    const int r = e % kMaxCluster;
    float v = i < cnt && r < cs ? g[r * NP + i] : 0.f;
#pragma unroll
    for (int off = kMaxCluster / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (r == 0 && i < cnt) tot[i] = v;
  }
  __syncthreads();
}

// b Householder steps and larft over a panel split across the cluster (see
// above): kLapackSign, LAPACK larfg's beta = -sign(alpha) |x|; else the JAX
// package's historical beta = +|x| (repro/core/householder.py house).
// Leaves R on and above the diagonal of panel rows [0, b) and each v (unit
// head implied) below it, in W; taus in sm + tau; on rank 0, T (leading
// dimension BM) in sm + T.
template <int BM, bool kLapackSign>
__device__ __forceinline__ void cluster_householder(float* W, int ldw, int base, int nrows, int b,
                                                    float* sm, int cs) {
  using L = ClusterQrSmem<BM>;
  float* red = sm + L::red;
  float* tot = sm + L::tot;
  float* s_piv = sm + L::piv;
  float* s_tau = sm + L::tau;
  float* part = sm + L::part;
  float* gather = sm + L::gather;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nt + 31) >> 5;
  float tau = 0.f, beta = 0.f, inv_v0 = 1.f;
  float acc[BM];
#pragma unroll
  for (int c = 0; c < BM; ++c) acc[c] = 0.f;

  // Pass j applies step j-1 to rows >= j-1 and gathers step j's sums.
  for (int j = 0; j <= b; ++j) {
    const int pj = j - 1;
    float p[BM];
#pragma unroll
    for (int c = 0; c < BM; ++c) p[c] = 0.f;
    for (int lr = tid; lr < nrows; lr += nt) {
      const int li = base + lr;
      if (li < pj) continue;  // final rows of R
      float x[BM];
#pragma unroll
      for (int c = 0; c < BM; ++c) x[c] = (c >= pj && c < b) ? W[c * ldw + lr] : 0.f;
      if (j > 0) {
        float xp = 0.f;
#pragma unroll
        for (int c = 0; c < BM; ++c)
          if (c == pj) xp = x[c];
        const bool pivot = li == pj;
        const float v = pivot ? 1.f : xp * inv_v0;
#pragma unroll
        for (int c = 0; c < BM; ++c) {
          if (c > pj && c < b) x[c] -= tau * v * acc[c];
          if (c == pj) x[c] = pivot ? beta : v;
        }
#pragma unroll
        for (int c = 0; c < BM; ++c)
          if (c >= pj && c < b) W[c * ldw + lr] = x[c];
      }
      if (j < b) {
        float xj = 0.f;
#pragma unroll
        for (int c = 0; c < BM; ++c)
          if (c == j) xj = x[c];
        if (li > j) {
#pragma unroll
          for (int c = 0; c < BM; ++c)
            if (c >= j && c < b) p[c] += xj * x[c];
        } else if (li == j) {
#pragma unroll
          for (int c = 0; c < BM; ++c)
            if (c >= j && c < b) s_piv[c] = x[c];
        }
      }
    }
    if (j == b) break;
#pragma unroll
    for (int c = 0; c < BM; ++c) {
      if (c >= j && c < b) {
        const float s = warp_sum(p[c]);
        if (lane == 0) red[warp * BM + c] = s;
      }
    }
    __syncthreads();
    if (tid < BM) {
      const int c = tid;
      const bool live = c >= j && c < b;
      float s = 0.f;
      for (int wi = 0; wi < nwarps; ++wi) s += live ? red[wi * BM + c] : 0.f;
      const bool owns = base <= j && j < base + nrows;
      part[c] = s;
      part[BM + c] = live && owns ? s_piv[c] : 0.f;
    }
    __syncthreads();
    cluster_sum<L::kNP>(part, 2 * BM, tot, gather, j & 1, cs);
    const float sigma = tot[j];
    const float alpha = tot[BM + j];
    const float mu = sqrtf(alpha * alpha + sigma);
    const bool degenerate = sigma == 0.f;
    if constexpr (kLapackSign) {
      // LAPACK larfg: beta = -sign(alpha) mu
      const float sign_a = alpha >= 0.f ? 1.f : -1.f;
      const float beta_nd = -sign_a * mu;
      const float safe_beta = beta_nd == 0.f ? 1.f : beta_nd;
      tau = degenerate ? 0.f : (beta_nd - alpha) / safe_beta;
      beta = degenerate ? alpha : beta_nd;
      const float denom = alpha - beta_nd;  // sign(alpha)(|alpha| + mu): no cancellation
      inv_v0 = 1.f / (denom == 0.f ? 1.f : denom);
    } else {
      // house: beta = +mu, v0 = alpha - mu (formed without cancellation)
      const float safe_denom = alpha + mu == 0.f ? 1.f : alpha + mu;
      const float v0 = alpha <= 0.f ? alpha - mu : -sigma / safe_denom;
      const float v0s = degenerate ? 1.f : v0;
      tau = degenerate ? 0.f : 2.f * v0s * v0s / (sigma + v0s * v0s);
      beta = degenerate ? alpha : mu;
      inv_v0 = 1.f / v0s;
    }
#pragma unroll
    for (int c = 0; c < BM; ++c) acc[c] = (c > j && c < b) ? tot[BM + c] + tot[c] * inv_v0 : 0.f;
    if (tid == 0) s_tau[j] = tau;
  }
  __syncthreads();

  // larft: V^T V[a][c] = v_a . v_c for a < c (v_c is zero above row c, one
  // at it), threads split over (pair, group of rows); a block of fewer
  // threads than pairs takes the pairs in turn.
  const int npairs = b * (b - 1) / 2;
  if (npairs > 0) {
    const int groups = max(1, nt / npairs);
    for (int q = tid; q < npairs * groups; q += nt) {
      const int pidx = q % npairs;
      const int g = q / npairs;
      int c = 1;
      while (c * (c + 1) / 2 <= pidx) ++c;
      const int a = pidx - c * (c - 1) / 2;
      float s = 0.f;
      for (int lr = g; lr < nrows; lr += groups) {
        const int li = base + lr;
        if (li < c) continue;
        const float vc = li == c ? 1.f : W[c * ldw + lr];
        s += W[a * ldw + lr] * vc;
      }
      red[q] = s;
    }
    __syncthreads();
    for (int pidx = tid; pidx < npairs; pidx += nt) {
      float t = 0.f;
      for (int g = 0; g < groups; ++g) t += red[pidx + g * npairs];
      part[pidx] = t;
    }
  }
  __syncthreads();
  cluster_sum<L::kNP>(part, npairs, tot, gather, b & 1, cs);
  if (cluster_rank() == 0 && tid == 0) {
    float* s_T = sm + L::T;
    for (int e = 0; e < BM * BM; ++e) s_T[e] = 0.f;
    for (int j = 0; j < b; ++j) {
      for (int a = 0; a < j; ++a) {
        float s = 0.f;
        for (int t = 0; t < j; ++t) {
          const float vtv = t < j ? tot[j * (j - 1) / 2 + t] : 0.f;
          s += s_T[a * BM + t] * vtv;
        }
        s_T[a * BM + j] = -s_tau[j] * s;
      }
      s_T[j * BM + j] = s_tau[j];
    }
  }
  __syncthreads();
}

}  // namespace repro
