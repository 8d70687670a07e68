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
// microsecond either way; the chain of b dependent sums over all m rows,
// plus larft's, sets its time.
//
// Design.  The TPU kernel keeps the panel in VMEM and unrolls the b column
// steps in one grid step.  Here one thread-block cluster runs kernel A's
// panel QR (csrc/panel_qr_cluster.cuh) with the sign beta = +|x|: each CTA
// loads its slice of P's rows column-major into its own shared memory (in
// a global workspace above the smem_max budget,
// repro_torch/kernels/limits.py PANEL_QR_SMEM), the b steps and larft take
// b + 1 cluster exchanges, each CTA writes its rows of V (and of R), and
// rank 0 writes T and taus.  A cluster of one CTA is the one-CTA QR.  The
// block has about one thread per row of its slice (32 to kQrThreads).
#include <atomic>
#include <initializer_list>

#include "panel_qr_cluster.cuh"

namespace {

template <int BM, bool kSmem>
__global__ void panel_qr_wy(const float* __restrict__ P, int m, int b, float* __restrict__ V,
                            float* __restrict__ T, float* __restrict__ taus,
                            float* __restrict__ R, float* __restrict__ work) {
  REPRO_DYNAMIC_SMEM(sm);
  using L = repro::ClusterQrSmem<BM>;
  const int cs = gridDim.x;
  const int rank = (int)repro::cluster_rank();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int len = (m + cs - 1) / cs;
  const int base = rank * len;
  const int nrows = max(0, min(len, m - base));
  const int ldw = kSmem ? (len | 1) : len;
  float* W = kSmem ? sm + L::total : work + (long long)rank * len * b;
  const float* src = P + (long long)base * b;
  for (int e = tid; e < nrows * b; e += nt) W[(e % b) * ldw + e / b] = src[e];
  __syncthreads();

  repro::cluster_householder<BM, false>(W, ldw, base, nrows, b, sm, cs);

  if (rank == 0) {
    for (int e = tid; e < b * b; e += nt) T[e] = sm[L::T + (e / b) * BM + (e % b)];
    if (tid < b) taus[tid] = sm[L::tau + tid];
  }
  float* dst = V + (long long)base * b;
  for (int e = tid; e < nrows * b; e += nt) {
    const int li = base + e / b;
    const int c = e % b;
    const float x = W[c * ldw + e / b];
    dst[e] = li == c ? 1.f : (li > c ? x : 0.f);
    if (li < b) R[li * b + c] = li <= c ? x : 0.f;
  }
  // Peers write into this CTA's shared memory only before the exchanges'
  // cluster barriers, so it may exit without another.
}

// The launch of an (m, b) panel on `cs` CTAs: the block size, the dynamic
// shared memory and whether the slices live there.
template <int BM>
struct Plan {
  int cs, threads, smem;
  bool in_smem;
  Plan(int m, int smem_max, int cs_) : cs(cs_) {
    const int len = (m + cs - 1) / cs;
    const long long slice = (long long)(len | 1) * BM * (int)sizeof(float);
    const int fixed = repro::ClusterQrSmem<BM>::total * (int)sizeof(float);
    in_smem = slice <= smem_max && fixed + slice <= repro::kSmemPerBlockMax;
    smem = fixed + (in_smem ? (int)slice : 0);
    const int rows32 = (len + 31) / 32 * 32;
    threads = rows32 > repro::kQrThreads ? repro::kQrThreads : rows32;  // len >= 1
  }
  auto kernel() const { return in_smem ? panel_qr_wy<BM, true> : panel_qr_wy<BM, false>; }
};

// Once per device, before fit_cluster asks the card about them and before
// a launch: both instantiations may take the whole shared memory of a
// block, and clusters above 8 CTAs where the card allows them.
template <int BM>
cudaError_t prepare() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  for (auto kern : {panel_qr_wy<BM, true>, panel_qr_wy<BM, false>}) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               repro::kSmemPerBlockMax);
    if (err != cudaSuccess) return err;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess)
      cudaGetLastError();  // no non-portable sizes: plan() falls back to 8
  }
  ready.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

// The cluster size a launch on `want` CTAs can run with: `want`, or 8 where
// the card cannot co-schedule it.
template <int BM>
int plan(int m, int smem_max, int want, int* in_smem) {
  if (prepare<BM>() != cudaSuccess) return -1;
  Plan<BM> pl(m, smem_max, want);
  const int fit = repro::fit_cluster(pl.kernel(), pl.threads, pl.smem, want);
  if (fit != want) pl = Plan<BM>(m, smem_max, fit);
  *in_smem = pl.in_smem;
  return pl.cs;
}

template <int BM>
int run(const float* P, int m, int b, float* V, float* T, float* taus, float* R, float* work,
        int smem_max, int cluster, cudaStream_t st) {
  cudaError_t err = prepare<BM>();
  if (err != cudaSuccess) return (int)err;
  const Plan<BM> pl(m, smem_max, cluster);
  if (!pl.in_smem && work == nullptr) return (int)cudaErrorInvalidValue;
  err = REPRO_LAUNCH_CLUSTER(pl.kernel(), dim3(pl.cs), dim3(pl.threads), (size_t)pl.smem, st,
                             (unsigned)pl.cs, P, m, b, V, T, taus, R, work);
  if (err != cudaSuccess) return (int)err;
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// One cluster launch.  P: (m, b) row-major, m >= b; V (m, b), T (b, b),
// taus (b,), R (b, b) are written whole.  cluster: CTAs, 1 to 16, a size
// the card can co-schedule (what panel_qr_plan returns).  work,
// (m + cluster) * b floats, holds the slices when one exceeds smem_max
// bytes (panel_qr_plan's in_smem is 0), and may be null otherwise.
extern "C" int panel_qr_launch(const float* P, int m, int b, float* V, float* T, float* taus,
                               float* R, float* work, int smem_max, int cluster, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b < 1 || m < b || cluster < 1 || cluster > repro::kMaxCluster) return (int)cudaErrorInvalidValue;
  if (b <= 8) return run<8>(P, m, b, V, T, taus, R, work, smem_max, cluster, st);
  if (b <= 16) return run<16>(P, m, b, V, T, taus, R, work, smem_max, cluster, st);
  if (b <= 32) return run<32>(P, m, b, V, T, taus, R, work, smem_max, cluster, st);
  return (int)cudaErrorInvalidValue;
}

// The cluster size for an (m, b) panel asked for `cluster` CTAs on the
// current device (below `cluster` where the card cannot co-schedule it),
// or -1; *in_smem: whether its slices fit shared memory.  Queries the
// card: call it once per shape, not per launch.
extern "C" int panel_qr_plan(int m, int b, int smem_max, int cluster, int* in_smem) {
  if (b < 1 || m < b || cluster < 1 || cluster > repro::kMaxCluster) return -1;
  if (b <= 8) return plan<8>(m, smem_max, cluster, in_smem);
  if (b <= 16) return plan<16>(m, smem_max, cluster, in_smem);
  if (b <= 32) return plan<32>(m, smem_max, cluster, in_smem);
  return -1;
}
