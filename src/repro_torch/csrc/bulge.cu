// Kernel B: wavefront bulge chase, band -> tridiagonal (second stage).
//
// Replaces repro/kernels/bulge.py:bulge_wavefront_pallas (body _bulge_kernel,
// window update _window_update).  At wavefront wf, slot a runs op (s, k) with
// s = wf/3 - a, k = wf - 3s: one two-sided Householder update of the 3b x 3b
// window at rows/cols [r0, r0+3b), r0 = s+1+(k-1)b, that eliminates column
// b-1 (k == 0) or 0 (k >= 1) of the window below its row b.  Optionally it
// writes the reflector log (vs, taus, row0) in the (W, A, b) layout of the
// plain version; an inactive slot logs v = e_0, tau = 0, row0 = n.
//
// What bounds it on the H100: neither bytes nor flops.  One op moves
// ~2 * 9b^2 * 4 bytes and does ~20 b^2 flops; at n = 4096, b = 8 the chase
// runs 3(n-3)+1 = 12280 dependent wavefronts of at most 172 ops, so the
// time is launch and synchronization latency.
//
// Design.  The TPU kernel keeps the whole padded matrix in VMEM and walks
// the wavefronts as a sequential grid.  Here the matrix stays in global
// memory (the dense n x n copy, no padding: reads outside [0, n) are zeros
// and are not written), there is one launch per wavefront (the stream
// orders them), and one CTA per `group` slots, each window in shared
// memory.  Windows of one wavefront share at most the corner element
// (r0 + 3b - 1) with the next slot, and neither op changes it, so a CTA
// writes back only what its reflector changes: window rows [b, 2b) and
// window columns [b, 2b).  Writing the whole window back would race.  The
// persistent kernel with the paper's inter-CTA flags is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void bulge_wavefront_kernel(float* __restrict__ T, int n, int b, int wf, int A,
                                       int G, float* __restrict__ vs,
                                       float* __restrict__ taus, int* __restrict__ row0,
                                       int with_log) {
  REPRO_DYNAMIC_SMEM(sm);
  __shared__ float s_tau, s_beta, s_v0, s_vmv;
  __shared__ int s_deg;
  const int w3 = 3 * b;
  float* W = sm;
  float* u = W + w3 * w3;
  float* Mv = u + w3;
  float* wv = Mv + w3;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int g = 0; g < G; ++g) {
    const int a = blockIdx.x * G + g;
    if (a >= A) return;
    const int s = wf / 3 - a;
    const int k = wf - 3 * s;
    const bool active = s >= 0 && s <= n - 3 && k >= 0 && k <= (n - 3 - s) / b;
    const long long lidx = (long long)wf * A + a;
    if (!active) {
      if (with_log) {
        for (int r = tid; r < b; r += nt) vs[lidx * b + r] = r == 0 ? 1.f : 0.f;
        if (tid == 0) {
          taus[lidx] = 0.f;
          row0[lidx] = n;
        }
      }
      continue;
    }
    const int r0 = s + 1 + (k - 1) * b;
    for (int e = tid; e < w3 * w3; e += nt) {
      const int gr = r0 + e / w3;
      const int gc = r0 + e % w3;
      W[e] = (gr >= 0 && gr < n && gc >= 0 && gc < n) ? T[(long long)gr * n + gc] : 0.f;
    }
    __syncthreads();
    const int elim = k == 0 ? b - 1 : 0;
    if (tid == 0) {
      // house(x) of x = W[b:2b, elim]: beta = +|x|, the JAX package's sign.
      const float alpha = W[b * w3 + elim];
      float sigma = 0.f;
      for (int r = 1; r < b; ++r) {
        const float x = W[(b + r) * w3 + elim];
        sigma += x * x;
      }
      const float mu = sqrtf(alpha * alpha + sigma);
      const float safe_denom = (alpha + mu == 0.f) ? 1.f : alpha + mu;
      const float v0 = alpha <= 0.f ? alpha - mu : -sigma / safe_denom;
      const bool degenerate = sigma == 0.f;
      const float v0s = degenerate ? 1.f : v0;
      s_v0 = v0s;
      s_deg = degenerate;
      s_tau = degenerate ? 0.f : 2.f * v0s * v0s / (sigma + v0s * v0s);
      s_beta = degenerate ? alpha : mu;
    }
    __syncthreads();
    for (int r = tid; r < w3; r += nt) {
      float val = 0.f;
      if (r == b) val = 1.f;
      else if (r > b && r < 2 * b) val = s_deg ? 0.f : W[r * w3 + elim] / s_v0;
      u[r] = val;
    }
    __syncthreads();
    for (int r = tid; r < w3; r += nt) {
      float acc = 0.f;
      for (int c = b; c < 2 * b; ++c) acc += W[r * w3 + c] * u[c];
      Mv[r] = acc;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int r = b; r < 2 * b; ++r) acc += u[r] * Mv[r];
      s_vmv = acc;
    }
    __syncthreads();
    for (int r = tid; r < w3; r += nt) wv[r] = s_tau * (Mv[r] - 0.5f * s_tau * s_vmv * u[r]);
    __syncthreads();
    for (int e = tid; e < w3 * w3; e += nt) {
      const int r = e / w3;
      const int c = e % w3;
      const bool rin = r >= b && r < 2 * b;
      const bool cin = c >= b && c < 2 * b;
      if (!rin && !cin) continue;
      float val = W[e] - u[r] * wv[c] - wv[r] * u[c];
      if (rin && c == elim) val = (r == b) ? s_beta : 0.f;
      if (cin && r == elim) val = (c == b) ? s_beta : 0.f;
      const int gr = r0 + r;
      const int gc = r0 + c;
      if (gr >= 0 && gr < n && gc >= 0 && gc < n) T[(long long)gr * n + gc] = val;
    }
    if (with_log) {
      for (int r = tid; r < b; r += nt) vs[lidx * b + r] = u[b + r];
      if (tid == 0) {
        taus[lidx] = s_tau;
        row0[lidx] = s + 1 + k * b;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// One launch per wavefront: 3(n-3)+1 launches per call.
extern "C" int bulge_wavefront_launch(float* T, int n, int b, int A, int G, float* vs,
                                      float* taus, int* row0, int with_log, void* stream) {
  if (n < 3 || b < 2 || A < 1 || G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int w3 = 3 * b;
  const int smem = (w3 * w3 + 3 * w3) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bulge_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int W = 3 * (n - 3) + 1;
  const unsigned blocks = (unsigned)((A + G - 1) / G);
  for (int wf = 0; wf < W; ++wf) {
    REPRO_LAUNCH(bulge_wavefront_kernel, blocks, kThreads, smem, st)
    (T, n, b, wf, A, G, vs, taus, row0, with_log);
    REPRO_CHECK_LAUNCH();
  }
  return 0;
}
