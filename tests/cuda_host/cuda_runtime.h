// Host emulation of the CUDA runtime features that src/repro_torch/csrc uses,
// so that tests/test_torch_kernels_host.py can compile the kernels with g++
// and run their arithmetic and indexing on the CPU.
//
// A launch runs one cluster of CTAs at a time (a plain launch is a cluster of
// one), with one std::thread per CUDA thread of the cluster.  Each CTA of
// the running cluster has its own dynamic shared memory, its own block
// barrier (__syncthreads) and its own warps (__shfl_xor_sync); the CTAs of a
// cluster run together, meet at repro::cluster_sync() and read each other's
// dynamic shared memory through repro::cluster_peer().  Clusters run one
// after another, so this checks what one cluster computes, not races
// between clusters.  `__shared__` variables are process-wide statics here:
// a kernel launched with a cluster of more than one CTA keeps its shared
// state in dynamic shared memory (REPRO_DYNAMIC_SMEM).
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define REPRO_HOST_EMULATION 1
#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
namespace emu {
// The on-chip state of one emulated CTA.
struct Cta {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<float> shfl;
  std::vector<float> smem;
};
inline thread_local dim3 tIdx, bIdx;
inline thread_local Cta* cta = nullptr;
inline thread_local unsigned cta_rank = 0;
inline dim3 bDim, gDim;
inline std::vector<Cta>* cluster_ctas = nullptr;
inline std::barrier<>* cluster_bar = nullptr;
inline std::mutex atomic_lock;
}  // namespace emu
#define threadIdx emu::tIdx
#define blockIdx emu::bIdx
#define blockDim emu::bDim
#define gridDim emu::gDim
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed,
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline void __syncthreads() { emu::cta->bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = emu::tIdx.x;
  auto* bar = emu::cta->warp_bars[t / 32].get();
  emu::cta->shfl[t] = v;
  bar->arrive_and_wait();
  const float r = emu::cta->shfl[t ^ lane_mask];
  bar->arrive_and_wait();
  return r;
}
inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> g(emu::atomic_lock);
  const float old = *p;
  *p += v;
  return old;
}
struct alignas(16) float4 {
  float x, y, z, w;
};

// bf16 as the card stores it: the high 16 bits of a float, rounded to
// nearest even on the way in.
struct __nv_bfloat16 {
  unsigned short x;
};
inline float __bfloat162float(__nv_bfloat16 h) {
  unsigned u = (unsigned)h.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  __nv_bfloat16 h;
  if ((u & 0x7f800000u) == 0x7f800000u && (u & 0x007fffffu)) {
    h.x = (unsigned short)((u >> 16) | 0x40u);  // quiet NaN
  } else {
    u += 0x7fffu + ((u >> 16) & 1u);
    h.x = (unsigned short)(u >> 16);
  }
  return h;
}

namespace repro {
// The cluster helpers of csrc/common.cuh.
inline unsigned cluster_rank() { return emu::cta_rank; }
inline void cluster_sync() { emu::cluster_bar->arrive_and_wait(); }
template <class T>
inline T* cluster_peer(T* p, unsigned rank) {
  const float* base = emu::cta->smem.data();
  const size_t off = (size_t)((const char*)p - (const char*)base);
  return (T*)((char*)(*emu::cluster_ctas)[rank].smem.data() + off);
}
// cp.async copies at once here.
inline void cp_async16(float* dst, const float* src) {
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
// Every cluster size can be co-scheduled here.
template <class K>
inline int fit_cluster(K, int, size_t, int want) { return want; }
}  // namespace repro

namespace emu {
template <class K, class... A>
cudaError_t run(K kern, dim3 grid, dim3 block, size_t smem, unsigned cluster, A... args) {
  if (cluster < 1 || grid.x % cluster != 0) return cudaErrorInvalidValue;
  bDim = block;
  gDim = grid;
  std::vector<Cta> ctas(cluster);
  for (auto& c : ctas) {
    c.bar.reset(new std::barrier<>(block.x));
    for (unsigned w = 0; w < (block.x + 31) / 32; ++w)
      c.warp_bars.emplace_back(new std::barrier<>(std::min(32u, block.x - 32 * w)));
    c.shfl.assign(block.x, 0.f);
    c.smem.assign(smem / sizeof(float) + 1, 0.f);
  }
  std::barrier<> all(cluster * block.x);
  cluster_ctas = &ctas;
  cluster_bar = &all;
  // One host thread per CUDA thread of a cluster for the whole launch; the
  // threads walk the clusters together and meet before the next one.
  std::vector<std::thread> threads;
  for (unsigned r = 0; r < cluster; ++r)
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([=, &ctas, &all]() {
        tIdx = dim3(t);
        cta = &ctas[r];
        cta_rank = r;
        for (unsigned c0 = 0; c0 < grid.x; c0 += cluster) {
          bIdx = dim3(c0 + r);
          kern(args...);
          all.arrive_and_wait();
        }
      });
  for (auto& th : threads) th.join();
  cluster_ctas = nullptr;
  cluster_bar = nullptr;
  return cudaSuccess;
}
template <class K>
struct Launch {
  K kern;
  dim3 grid, block;
  size_t smem;
  template <class... A>
  void operator()(A... args) {
    run(kern, grid, block, smem, 1, args...);
  }
};
template <class K>
Launch<K> make(K kern, dim3 grid, dim3 block, size_t smem) { return Launch<K>{kern, grid, block, smem}; }
template <class K, class... A>
cudaError_t launch_cluster(K kern, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                           unsigned cluster, A... args) {
  return run(kern, grid, block, smem, cluster, args...);
}
}  // namespace emu
#define REPRO_LAUNCH(kern, grid, block, smem, stream) \
  emu::make(kern, dim3(grid), dim3(block), (size_t)(smem))
#define REPRO_LAUNCH_CLUSTER emu::launch_cluster
#define REPRO_DYNAMIC_SMEM(name) float* name = emu::cta->smem.data()
