// Kernel E: the standalone Householder panel QR in compact-WY form.
//
// Replaces repro/kernels/panel.py:panel_qr_pallas (body panel_qr_body with
// the default lapack_sign=False): an (m, b) panel becomes V (m, b), unit
// lower trapezoidal, T (b, b) upper triangular (larft), taus (b,) and
// R (b, b), with the historical sign beta = +|x| (repro/core/householder.py
// house).  band_reduce(panel_method="kernel") makes one call per panel:
// 511 at n = 4096, b = 8, with m = n - c0 - b up to 4088.
//
// What bounds it on the H100: nothing of the card's rates.  It moves
// ~2 m b * 4 bytes (0.26 MB at m = 4088) and does ~4 m b^2 flops, under a
// microsecond either way; a chain of b dependent block reductions over m,
// two barriers each, on one CTA, sets its time.
//
// Design.  The TPU kernel keeps the panel in VMEM and unrolls the b column
// steps in one grid step.  Here one CTA runs the same steps
// (csrc/panel_qr.cuh, shared with kernel A, which instantiates it with
// LAPACK signs) on the panel in shared memory while m * b * 4 bytes fit the
// smem_max budget (repro_torch/kernels/limits.py PANEL_QR_SMEM), and in
// place in the V output buffer in global memory above it.
#include "panel_qr.cuh"

namespace {

constexpr int kThreads = 256;

template <int BM>
__global__ void panel_qr_wy(const float* __restrict__ P, int m, int b, int use_smem,
                            float* __restrict__ V, float* __restrict__ T,
                            float* __restrict__ taus, float* __restrict__ R) {
  REPRO_DYNAMIC_SMEM(smem);
  __shared__ float red[32 * BM];
  __shared__ float s_tau[BM];
  __shared__ float s_scal[2];
  __shared__ float s_T[BM * BM];
  __shared__ float s_VtV[BM * BM];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* Wk = use_smem ? smem : V;
  for (int e = tid; e < m * b; e += nt) Wk[e] = P[e];
  __syncthreads();
  repro::householder_panel<BM, false>(Wk, m, b, red, s_tau, s_scal);
  repro::larft_panel<BM>(Wk, m, b, red, s_tau, s_VtV, s_T);
  for (int e = tid; e < b * b; e += nt) {
    const int i = e / b;
    const int c = e % b;
    T[e] = s_T[i * BM + c];
    R[e] = i <= c ? Wk[e] : 0.f;
  }
  if (tid < b) taus[tid] = s_tau[tid];
  // R is read before V overwrites the packed panel (the same thread reads
  // and writes each element, so V may alias Wk).
  __syncthreads();
  for (int e = tid; e < m * b; e += nt) {
    const int i = e / b;
    const int c = e % b;
    V[e] = i == c ? 1.f : (i > c ? Wk[e] : 0.f);
  }
}

template <int BM>
int run(const float* P, int m, int b, float* V, float* T, float* taus, float* R,
        int smem_max, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      panel_qr_wy<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return (int)err;
  const long long panel_bytes = (long long)m * b * sizeof(float);
  const int smem = panel_bytes <= smem_max ? (int)panel_bytes : 0;
  REPRO_LAUNCH(panel_qr_wy<BM>, 1, kThreads, smem, st)(P, m, b, smem > 0, V, T, taus, R);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// One launch.  P: (m, b) row-major, m >= b; V (m, b), T (b, b), taus (b,),
// R (b, b) are written whole.  smem_max: the shared-memory budget of the panel.
extern "C" int panel_qr_launch(const float* P, int m, int b, float* V, float* T,
                               float* taus, float* R, int smem_max, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b < 1 || m < b) return (int)cudaErrorInvalidValue;
  if (b <= 8) return run<8>(P, m, b, V, T, taus, R, smem_max, st);
  if (b <= 16) return run<16>(P, m, b, V, T, taus, R, smem_max, st);
  if (b <= 32) return run<32>(P, m, b, V, T, taus, R, smem_max, st);
  return (int)cudaErrorInvalidValue;
}
