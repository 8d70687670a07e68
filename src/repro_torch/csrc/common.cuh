// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// Each .cu file in this directory is compiled on its own by nvcc into a
// shared library with a plain C interface (see repro_torch/kernels/cuda_lib.py)
// and loaded with ctypes.  Every exported function launches on the stream it
// is given, allocates nothing, and returns cudaGetLastError() as an int.
#pragma once

#include <cuda_runtime.h>

// Launch and dynamic shared memory go through macros so that the host
// emulation in tests/cuda_host/ can compile these sources with g++.
#ifndef REPRO_LAUNCH
#define REPRO_LAUNCH(kern, grid, block, smem, stream) \
  kern<<<(grid), (block), (smem), (stream)>>>
#endif
#ifndef REPRO_DYNAMIC_SMEM
#define REPRO_DYNAMIC_SMEM(name) extern __shared__ float name[]
#endif

// Thread-block clusters (the panel QR of kernels A and E).  The three helpers below --
// this CTA's rank, the cluster barrier and a peer's copy of a shared-memory
// address -- and REPRO_LAUNCH_CLUSTER are all a cluster kernel may use, so
// that the host emulation can run a cluster's CTAs together, each with its
// own dynamic shared memory (a cluster kernel keeps its shared state there).
#ifndef REPRO_HOST_EMULATION
#include <cooperative_groups.h>
namespace repro {
__device__ __forceinline__ unsigned cluster_rank() {
  return cooperative_groups::this_cluster().block_rank();
}
// Barrier over every thread of the cluster, with release / acquire order of
// shared (and distributed shared) memory.
__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }
// `p` (this CTA's dynamic shared memory) as seen in the CTA of rank `rank`.
template <class T>
__device__ __forceinline__ T* cluster_peer(T* p, unsigned rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// Launch `kern` with clusters of `cluster` CTAs along x.
template <class... Exp, class... Act>
inline cudaError_t launch_cluster(void (*kern)(Exp...), dim3 grid, dim3 block, size_t smem,
                                  cudaStream_t st, unsigned cluster, Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<Act&&>(args)...);
}

// `want` if the card can co-schedule a cluster of that many CTAs of `kern`
// (above 8 a cluster size is non-portable: H100 allows 16), else 8.
template <class K>
inline int fit_cluster(K kern, int threads, size_t smem, int want) {
  if (want <= 8) return want;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess)
    return 8;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(want);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = want;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) != cudaSuccess || clusters < 1) {
    cudaGetLastError();  // clear the query's error
    return 8;
  }
  return want;
}
}  // namespace repro
#define REPRO_LAUNCH_CLUSTER repro::launch_cluster
#endif

// Asynchronous 16-byte copies from global to shared memory (cp.async,
// sm_80+; dst and src 16-byte aligned).
// A thread's copies land after cp_async_wait<N>() (all but its N most
// recent committed groups), visible to the CTA after the next
// __syncthreads().  The host emulation copies at once.
#ifndef REPRO_HOST_EMULATION
namespace repro {
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
// kBytes (4, 8 or 16; dst and src aligned to it) of which only the first
// src_bytes are read from src; the rest of dst is zero-filled.  A thread
// that refills a ring slot it has just read issues the copy after the read
// (the "memory" clobber), and the copy lands only once its global read has
// returned, long after the shared-memory read.
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(kBytes),
                 "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
}  // namespace repro
#endif

// A persistent grid: CTAs that take work from a ticket and hand it to each
// other through flags in global memory (kernel B).  On the card it is a
// plain launch; the host emulation runs all its CTAs together.
#ifndef REPRO_LAUNCH_PERSISTENT
#define REPRO_LAUNCH_PERSISTENT(kern, grid, block, smem, stream) \
  kern<<<(grid), (block), (smem), (stream)>>>
#endif

#ifndef REPRO_HOST_EMULATION
namespace repro {
// Flags between CTAs.  flag_publish is a release store: this thread's
// earlier global stores, and those of its CTA ordered before it by
// __syncthreads(), are visible at gpu scope before `value` lands.
// flag_wait spins on acquire loads until the flag reaches `target` (this
// thread's later loads are ordered after it) and returns what it read.
__device__ __forceinline__ int flag_wait(const int* flag, int target) {
  int v;
  do {
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
  } while (v < target);
  return v;
}
__device__ __forceinline__ void flag_publish(int* flag, int value) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(flag), "r"(value) : "memory");
}

// d += a b on the tensor cores: one warp-wide m16n8k16 product of bf16
// fragments with float32 accumulation.  With g = lane / 4, t = lane % 4 and
// the element of lower index in the lower 16 bits of a register:
//   a[r]: A (16 x 16, row-major) row g + 8 (r & 1), columns 2t + 8 (r >> 1), +1
//   b[r]: B (16 x 8, k x n) rows 2t + 8 r, +1, column g
//   d[i]: D (16 x 8) row g + 8 (i >> 1), column 2t + (i & 1)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero;
// cvt.rna), as the bits of a float whose low 13 bits are zero.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

// d += a b on the tensor cores: one warp-wide m16n8k8 product of TF32
// fragments (one value per register) with float32 accumulation (the
// H100 rounds the sums toward zero).  Not volatile: the compiler may
// interleave independent products.  With g = lane / 4 and t = lane % 4:
//   a[r]: A (16 x 8, row-major) row g + 8 (r & 1), column t + 4 (r >> 1)
//   b[r]: B (8 x 8, k x n) row t + 4 r, column g
//   d[i]: D (16 x 8) row g + 8 (i >> 1), column 2t + (i & 1)
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
}  // namespace repro
#endif

namespace repro {
constexpr int kSmemPerBlockMax = 232448;  // the H100's 227 KB of shared memory per block
}  // namespace repro

#define REPRO_CHECK_LAUNCH()                \
  do {                                      \
    cudaError_t err_ = cudaGetLastError();  \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

namespace repro {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum the first `cnt` entries of `v` (cnt <= N) over the whole block.  Every
// thread gets the totals back in `v`.  `red` is shared scratch of at least
// 32 * N floats.  Contains __syncthreads(): call from all threads.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], int cnt, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < cnt) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < cnt) red[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < cnt) {
      float s = 0.f;
      for (int wi = 0; wi < nwarps; ++wi) s += red[wi * N + i];
      v[i] = s;
    }
  }
  __syncthreads();
}

}  // namespace repro
