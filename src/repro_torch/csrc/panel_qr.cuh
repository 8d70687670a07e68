// The Householder panel QR shared by kernel A (fused_panel.cu, LAPACK
// signs) and kernel E (panel.cu, beta = +|x|): port of
// repro/kernels/panel.py:panel_qr_body with the sign as a template
// parameter.  One CTA works on a (rows, b) panel Wk, row-major with leading
// dimension b, in shared or global memory.
//
// householder_panel leaves R on and above the diagonal of Wk's first b rows
// and each reflector's v (unit head implied) packed below the diagonal;
// s_tau gets the b taus.  larft_panel then builds the upper-triangular T of
// H_1 ... H_b = I - V T V^T in s_T (leading dimension BM).
//
// Every function contains __syncthreads(): call it from all threads.
#pragma once

#include "common.cuh"

namespace repro {

template <int BM, bool kLapackSign>
__device__ __forceinline__ void householder_panel(float* Wk, int rows, int b, float* red,
                                                  float* s_tau, float* s_scal) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int j = 0; j < b; ++j) {
    float sig[1] = {0.f};
    for (int i = j + 1 + tid; i < rows; i += nt) {
      const float x = Wk[i * b + j];
      sig[0] += x * x;
    }
    block_sum<1>(sig, 1, red);
    if (tid == 0) {
      const float alpha = Wk[j * b + j];
      const float sigma = sig[0];
      const float mu = sqrtf(alpha * alpha + sigma);
      const bool degenerate = sigma == 0.f;
      if (kLapackSign) {  // LAPACK larfg: beta = -sign(alpha) mu
        const float sign_a = alpha >= 0.f ? 1.f : -1.f;
        const float beta_nd = -sign_a * mu;
        const float safe_beta = beta_nd == 0.f ? 1.f : beta_nd;
        s_tau[j] = degenerate ? 0.f : (beta_nd - alpha) / safe_beta;
        s_scal[1] = degenerate ? alpha : beta_nd;
        const float denom = alpha - beta_nd;  // sign(alpha)(|alpha| + mu): no cancellation
        s_scal[0] = denom == 0.f ? 1.f : denom;
      } else {  // repro.core.householder.house: beta = +mu
        const float safe_denom = alpha + mu == 0.f ? 1.f : alpha + mu;
        const float v0 = alpha <= 0.f ? alpha - mu : -sigma / safe_denom;
        const float v0s = degenerate ? 1.f : v0;
        s_tau[j] = degenerate ? 0.f : 2.f * v0s * v0s / (sigma + v0s * v0s);
        s_scal[1] = degenerate ? alpha : mu;
        s_scal[0] = v0s;
      }
    }
    __syncthreads();
    const float v0s = s_scal[0];
    const float tau = s_tau[j];
    for (int i = j + 1 + tid; i < rows; i += nt) Wk[i * b + j] = Wk[i * b + j] / v0s;
    __syncthreads();
    float acc[BM];
#pragma unroll
    for (int c = 0; c < BM; ++c) acc[c] = 0.f;
    for (int i = j + tid; i < rows; i += nt) {
      const float vi = (i == j) ? 1.f : Wk[i * b + j];
#pragma unroll
      for (int c = 0; c < BM; ++c)
        if (c > j && c < b) acc[c] += vi * Wk[i * b + c];
    }
    block_sum<BM>(acc, b, red);
    for (int i = j + tid; i < rows; i += nt) {
      const float vi = (i == j) ? 1.f : Wk[i * b + j];
#pragma unroll
      for (int c = 0; c < BM; ++c)
        if (c > j && c < b) Wk[i * b + c] -= tau * vi * acc[c];
    }
    __syncthreads();
    if (tid == 0) Wk[j * b + j] = s_scal[1];  // beta; v stays packed below
    __syncthreads();
  }
}

// larft: VtV[a][c] = v_a . v_c for a < c (v_c is zero above row c), then
// the T recurrence on one thread.  s_VtV and s_T are BM x BM.
template <int BM>
__device__ __forceinline__ void larft_panel(const float* Wk, int rows, int b, float* red,
                                            const float* s_tau, float* s_VtV, float* s_T) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int e = tid; e < BM * BM; e += nt) {
    s_T[e] = 0.f;
    s_VtV[e] = 0.f;
  }
  __syncthreads();
  for (int c = 1; c < b; ++c) {
    float acc[BM];
#pragma unroll
    for (int a = 0; a < BM; ++a) acc[a] = 0.f;
    for (int i = c + tid; i < rows; i += nt) {
      const float vc = (i == c) ? 1.f : Wk[i * b + c];
#pragma unroll
      for (int a = 0; a < BM; ++a)
        if (a < c) acc[a] += Wk[i * b + a] * vc;
    }
    block_sum<BM>(acc, c, red);
    if (tid == 0)
      for (int a = 0; a < c; ++a) s_VtV[a * BM + c] = acc[a];
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < b; ++j) {
      for (int a = 0; a < j; ++a) {
        float s = 0.f;
        for (int t = 0; t < j; ++t) s += s_T[a * BM + t] * s_VtV[t * BM + j];
        s_T[a * BM + j] = -s_tau[j] * s;
      }
      s_T[j * BM + j] = s_tau[j];
    }
  }
  __syncthreads();
}

}  // namespace repro
