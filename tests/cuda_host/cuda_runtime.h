// Host emulation of the CUDA runtime features that src/repro_torch/csrc uses,
// so that tests/test_torch_kernels_host.py can compile the kernels with g++
// and run their arithmetic and indexing on the CPU.
//
// A launch runs its blocks one after another on blockDim.x std::threads,
// one per CUDA thread; __syncthreads() is a block-wide std::barrier and
// __shfl_xor_sync a warp-wide exchange.  Blocks never overlap, so this
// checks what one block computes, not races between blocks.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __restrict__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
namespace emu {
inline thread_local dim3 tIdx, bIdx;
inline dim3 bDim, gDim;
inline std::barrier<>* block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
inline float shfl[1024];
inline std::vector<float> dynamic_smem(1 << 22);
inline std::mutex atomic_lock;
}  // namespace emu
#define threadIdx emu::tIdx
#define blockIdx emu::bIdx
#define blockDim emu::bDim
#define gridDim emu::gDim
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = emu::tIdx.x;
  auto* bar = emu::warp_barriers[t / 32].get();
  emu::shfl[t] = v;
  bar->arrive_and_wait();
  const float r = emu::shfl[t ^ lane_mask];
  bar->arrive_and_wait();
  return r;
}
inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> g(emu::atomic_lock);
  const float old = *p;
  *p += v;
  return old;
}
namespace emu {
template <class K>
struct Launch {
  K kern;
  dim3 grid, block;
  size_t smem;
  template <class... A>
  void operator()(A... args) {
    if (smem > dynamic_smem.size() * sizeof(float)) throw std::bad_alloc();
    bDim = block;
    gDim = grid;
    std::barrier<> bar(block.x);
    block_barrier = &bar;
    warp_barriers.clear();
    for (unsigned w = 0; w < (block.x + 31) / 32; ++w)
      warp_barriers.emplace_back(new std::barrier<>(std::min(32u, block.x - 32 * w)));
    // One host thread per CUDA thread for the whole launch; the threads walk
    // the blocks together and meet at the barrier before the next block.
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([=, this, &bar]() {
        tIdx = dim3(t);
        for (unsigned blk = 0; blk < grid.x; ++blk) {
          bIdx = dim3(blk);
          kern(args...);
          bar.arrive_and_wait();
        }
      });
    for (auto& th : threads) th.join();
  }
};
template <class K>
Launch<K> make(K kern, dim3 grid, dim3 block, size_t smem) { return Launch<K>{kern, grid, block, smem}; }
}  // namespace emu
#define REPRO_LAUNCH(kern, grid, block, smem, stream) \
  emu::make(kern, dim3(grid), dim3(block), (size_t)(smem))
#define REPRO_DYNAMIC_SMEM(name) float* name = emu::dynamic_smem.data()
