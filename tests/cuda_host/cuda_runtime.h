// Host emulation of the CUDA runtime features that src/repro_torch/csrc uses,
// so that tests/test_torch_kernels_host.py can compile the kernels with g++
// and run their arithmetic and indexing on the CPU.
//
// A launch runs one cluster of CTAs at a time (a plain launch is a cluster of
// one; clusters lie along x, and the grid's y and z rows run one after
// another), with one std::thread per CUDA thread of the cluster.  Each CTA of
// the running cluster has its own dynamic shared memory, its own block
// barrier (__syncthreads) and its own warps (__shfl_xor_sync,
// repro::mma_bf16_16816, repro::mma_tf32_1688); the CTAs of a cluster run together, meet at
// repro::cluster_sync() and read each other's dynamic shared memory through
// repro::cluster_peer().  Clusters run one after another, so this checks
// what one cluster computes, not races between clusters.  A persistent
// grid (REPRO_LAUNCH_PERSISTENT) runs as one group of all its CTAs, which
// hand work to each other through repro::flag_wait / flag_publish and int
// atomicAdd (clock64() is a steady-clock count, so kernel B's wait counter
// runs too); emu_run_ctas_in_turn(1) runs its CTAs one after another
// instead.  `__shared__` variables are process-wide statics here: a kernel
// whose CTAs run together keeps its shared state in dynamic shared memory
// (REPRO_DYNAMIC_SMEM).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
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
  std::vector<unsigned> mma_a, mma_b;  // each thread's mma fragments
  std::vector<float> smem;
};
inline thread_local dim3 tIdx, bIdx;
inline thread_local Cta* cta = nullptr;
inline thread_local unsigned cta_rank = 0;
inline dim3 bDim, gDim;
inline std::vector<Cta>* cluster_ctas = nullptr;
inline std::barrier<>* cluster_bar = nullptr;
inline std::mutex atomic_lock;
inline bool ctas_in_turn = false;
}  // namespace emu
// Run a persistent grid's CTAs one after another (1) or together (0, the
// default).
extern "C" void emu_run_ctas_in_turn(int on) { emu::ctas_in_turn = on != 0; }
#define threadIdx emu::tIdx
#define blockIdx emu::bIdx
#define blockDim emu::bDim
#define gridDim emu::gDim
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
// The emulated card: 4 SMs, one CTA of any kernel resident on each.
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 4; return cudaSuccess; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, K, int, size_t) {
  *v = 1;
  return cudaSuccess;
}
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
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
// clock64(): a steady-clock count in ns (the card counts SM cycles).
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch()).count();
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <class T>
inline T __ldcg(const T* p) { return *p; }
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
struct alignas(16) uint4 {
  unsigned x, y, z, w;
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
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
inline float __uint_as_float(unsigned u) {
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
template <int kBytes>
inline void cp_async_zfill(float* dst, const float* src, int src_bytes) {
  for (int i = 0; i < kBytes / 4; ++i) dst[i] = 4 * i < src_bytes ? src[i] : 0.f;
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
// Every cluster size can be co-scheduled here.
template <class K>
inline int fit_cluster(K, int, size_t, int want) { return want; }

// The flag helpers of csrc/common.cuh: an acquire load that yields while
// it spins, and a release store.
inline int flag_wait(const int* flag, int target) {
  std::atomic_ref<int> f(*const_cast<int*>(flag));
  int v;
  while ((v = f.load(std::memory_order_acquire)) < target) std::this_thread::yield();
  return v;
}
inline void flag_publish(int* flag, int value) {
  std::atomic_ref<int>(*flag).store(value, std::memory_order_release);
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, d += a b, by the PTX
// fragment layout (g = lane / 4, t = lane % 4; the lower 16 bits of a
// register hold the element of lower index):
//   a[r]: A (16 x 16, row-major) rows g + 8 (r & 1), columns 2t + 8 (r >> 1), +1
//   b[r]: B (16 x 8, k x n) rows 2t + 8 r, +1, column g
//   d[i]: D (16 x 8) row g + 8 (i >> 1), column 2t + (i & 1)
// The warp's fragments meet in the CTA's buffers between two warp barriers.
inline float bf16_half(unsigned reg, int hi) {
  const unsigned u = (hi ? reg >> 16 : reg & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  const int t = emu::tIdx.x;
  const int w0 = t & ~31;
  auto* bar = emu::cta->warp_bars[t / 32].get();
  unsigned* fa = emu::cta->mma_a.data();
  unsigned* fb = emu::cta->mma_b.data();
  for (int r = 0; r < 4; ++r) fa[4 * t + r] = a[r];
  for (int r = 0; r < 2; ++r) fb[2 * t + r] = b[r];
  bar->arrive_and_wait();
  const int lane = t - w0;
  for (int i = 0; i < 4; ++i) {
    const int row = lane / 4 + 8 * (i >> 1);
    const int col = 2 * (lane % 4) + (i & 1);
    float acc = d[i];
    for (int k = 0; k < 16; ++k) {
      const int la = w0 + (row % 8) * 4 + (k % 8) / 2;
      const float av = bf16_half(fa[4 * la + (row >= 8) + 2 * (k >= 8)], k & 1);
      const int lb = w0 + col * 4 + (k % 8) / 2;
      const float bv = bf16_half(fb[2 * lb + (k >= 8)], k & 1);
      acc += av * bv;
    }
    d[i] = acc;
  }
  bar->arrive_and_wait();
}

// cvt.rna.tf32.f32: to nearest with ties away from zero on the magnitude
// (sign and magnitude are separate bits, so adding half of the dropped
// unit to the bits does it; a carry moves into the exponent as it should),
// keeping 10 mantissa bits.  NaN stays NaN.
inline unsigned to_tf32(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) == 0x7f800000u) return (u & 0x007fffffu) ? (u | 0x00400000u) & ~0x1fffu : u;
  return (u + 0x1000u) & ~0x1fffu;
}
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a b, by the PTX
// fragment layout (g = lane / 4, t = lane % 4; one TF32 value per
// register, whose low 13 bits the tensor cores ignore):
//   a[r]: A (16 x 8, row-major) row g + 8 (r & 1), column t + 4 (r >> 1)
//   b[r]: B (8 x 8, k x n) row t + 4 r, column g
//   d[i]: D (16 x 8) row g + 8 (i >> 1), column 2t + (i & 1)
// Products of two TF32 values are exact; d and the eight products are
// summed exactly and rounded toward zero, as the H100's tensor cores round
// (a 3xTF32 walk that chains all k through them drifts by ~4e-6 of max|ref|
// at k = 256 on the card, as it does here).
inline float tf32_value(unsigned reg) {
  const unsigned u = reg & ~0x1fffu;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline void mma_tf32_1688(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  const int t = emu::tIdx.x;
  const int w0 = t & ~31;
  auto* bar = emu::cta->warp_bars[t / 32].get();
  unsigned* fa = emu::cta->mma_a.data();
  unsigned* fb = emu::cta->mma_b.data();
  for (int r = 0; r < 4; ++r) fa[4 * t + r] = a[r];
  for (int r = 0; r < 2; ++r) fb[2 * t + r] = b[r];
  bar->arrive_and_wait();
  const int lane = t - w0;
  for (int i = 0; i < 4; ++i) {
    const int row = lane / 4 + 8 * (i >> 1);
    const int col = 2 * (lane % 4) + (i & 1);
    long double acc = d[i];
    for (int k = 0; k < 8; ++k) {
      const float av = tf32_value(fa[4 * (w0 + (row % 8) * 4 + k % 4) + (row >= 8) + 2 * (k >= 4)]);
      const float bv = tf32_value(fb[2 * (w0 + col * 4 + k % 4) + (k >= 4)]);
      acc += (long double)av * bv;
    }
    float r = (float)acc;
    if (std::fabs((long double)r) > std::fabs(acc)) r = std::nextafter(r, 0.f);
    d[i] = r;
  }
  bar->arrive_and_wait();
}
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
    c.mma_a.assign(4 * block.x, 0u);
    c.mma_b.assign(2 * block.x, 0u);
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
        for (unsigned z = 0; z < grid.z; ++z)
          for (unsigned y = 0; y < grid.y; ++y)
            for (unsigned c0 = 0; c0 < grid.x; c0 += cluster) {
              bIdx = dim3(c0 + r, y, z);
              kern(args...);
              all.arrive_and_wait();
            }
      });
  for (auto& th : threads) th.join();
  cluster_ctas = nullptr;
  cluster_bar = nullptr;
  return cudaSuccess;
}
// A plain launch: its CTAs one after another; a persistent one (a grid
// along x): all its CTAs together (unless ctas_in_turn).
template <class K>
struct Launch {
  K kern;
  dim3 grid, block;
  size_t smem;
  bool persistent;
  template <class... A>
  void operator()(A... args) {
    run(kern, grid, block, smem, persistent && !ctas_in_turn ? grid.x : 1, args...);
  }
};
template <class K>
Launch<K> make(K kern, dim3 grid, dim3 block, size_t smem, bool persistent = false) {
  return Launch<K>{kern, grid, block, smem, persistent};
}
template <class K, class... A>
cudaError_t launch_cluster(K kern, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                           unsigned cluster, A... args) {
  return run(kern, grid, block, smem, cluster, args...);
}
}  // namespace emu
#define REPRO_LAUNCH(kern, grid, block, smem, stream) \
  emu::make(kern, dim3(grid), dim3(block), (size_t)(smem))
#define REPRO_LAUNCH_PERSISTENT(kern, grid, block, smem, stream) \
  emu::make(kern, dim3(grid), dim3(block), (size_t)(smem), true)
#define REPRO_LAUNCH_CLUSTER emu::launch_cluster
#define REPRO_DYNAMIC_SMEM(name) float* name = emu::cta->smem.data()
