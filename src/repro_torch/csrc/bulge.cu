// Kernel B: bulge chase, band -> tridiagonal (second stage), in one launch.
//
// Replaces repro/kernels/bulge.py:bulge_wavefront_pallas (body _bulge_kernel,
// window update _window_update).  Op (s, k) of sweep s is one two-sided
// Householder update of the 3b x 3b window at rows/cols [r0, r0+3b),
// r0 = s+1+(k-1)b, that eliminates column b-1 (k == 0) or 0 (k >= 1) of
// the window below its row b; sweep s runs ops k = 0 .. kmax(s),
// kmax(s) = (n-3-s)/b.  The plain version runs op (s, k) at wavefront
// 3s+k, in slot a = k/3.  Optionally the kernel writes the reflector log
// (vs, taus, row0) in that (W, A, b) layout; an inactive slot logs v = e_0,
// tau = 0, row0 = n.
//
// What bounds it on the H100: neither bytes nor flops.  One op moves
// ~2 * 9b^2 * 4 bytes and does ~20 b^2 flops, and the chase is a chain of
// 3(n-3)+1 dependent steps (12280 at n = 4096), so its time is the latency
// of one step: the window's load from L2, the reflector, the write-back
// and the hand-off to the next sweep.
//
// Design: a persistent grid, the paper's sweeps pipelined across CTAs.
// One call chases a bucket of `batch` bands (the counterpart of the
// batching rule that jax.vmap gives the Pallas kernel), each with its own
// progress counters.  Each CTA takes (matrix, sweep) pairs in order from one
// ticket (an atomic counter) and runs all ops of its sweep; sweep s of
// matrix z publishes its count of finished ops in done[z][s].  The tickets
// walk the bucket matrix-major by groups: the matrices in groups of G, and
// within a group sweep-major (sweep s of each of its matrices, then sweep
// s+1).  A matrix keeps about min(A, n-2) sweeps in flight, so G =
// ceil(CTAs / min(A, n-2)) gives every CTA a sweep to run; plain
// matrix-major order (G = 1 on a full grid) leaves most of the card idle
// while one band's few sweeps run.  Before op k, sweep s waits until
// done[z][s-1] >= min(k+3, kmax(s-1)+1), i.e. until op (s-1, k+2) of its
// own matrix has finished, or all of sweep s-1 where it has fewer ops.  Why
// that is enough:
//  - Every op that precedes (s, k) in the wavefront order and overlaps its
//    window has finished.  Op (s-j, k') runs at wavefront 3(s-j)+k', before
//    (s, k) when k' < k+3j.  The waits chain: (s-j, k+2j) finished before
//    (s-j+1, k+2j-2) started, ..., before (s, k), and the ops of one sweep
//    run in order, so (s-j, k') has finished for every k' <= k+2j.  The
//    rest, k+2j < k' < k+3j, start at row s-j+1+(k'-1)b >= s+(k+2)b +
//    (j-1)(2b-1): for j >= 2 past the window's last row s+(k+2)b, for
//    j = 1 (k' = k+3 is the only one) exactly at it.
//  - An op that may run beside (s, k) does not touch what (s, k) reads or
//    writes.  Of its own matrix the only candidates are (s-1, k') with
//    k' >= k+3 (and, mirrored, (s+1, k') with k' <= k-3): (s-1, k+3)'s
//    window shares one element with (s, k)'s, the corner (s+(k+2)b,
//    s+(k+2)b), which is local (3b-1, 3b-1) of one window and (0, 0) of
//    the other, and neither op changes it: an op writes back only window
//    rows and columns [b, 2b).  Later ops of sweep s-1 lie past the window.
//    Ops of other matrices touch other memory.
//  - A sweep waits only on the previous sweep of its own matrix, whose
//    ticket is G (or the last group's size) smaller, so it was taken
//    earlier, by a CTA that is running; sweep 0 waits for nothing.  So the
//    grid cannot deadlock whether or not all its CTAs are resident, and
//    whatever their number against the bucket's sweeps.  The last ops of
//    a sweep may reach past n (reads there are zeros, nothing is written),
//    and a wait never asks more of done[z][s-1] than kmax(s-1)+1, what
//    sweep s-1 publishes last.
// The window's loads after a wait go through L2 (__ldcg), since L1 is not
// coherent across SMs.  Windows of consecutive ops of a sweep overlap by
// 2b rows and columns, but each op loads its whole window, in one round
// trip to L2.  Keeping the overlap in shared memory saves no round trip:
// what sweep s-1 wrote into the window since the last load has to be read
// after the wait.  A version that kept it, fetched the next window while
// the op computed and carried (s-1, k+3)'s beta (the one entry of its
// writes that op (s, k+1) reads) in the flag was slower on the H100: its
// op grew by more than the load it hid.  The log's inactive slots are
// written by the grid after its sweeps, so one call is one CUDA launch.
//
// Its wait counter: with `stats` set (kStats), thread 0 of each CTA sums the
// clock64() cycles it spends in flag_wait before each op, the cycles from
// the end of that wait to the end of chase_op (the CTA's barrier after the
// op included), and the ops it ran, and adds each sum to stats[0..2] with one
// atomicAdd as the CTA leaves.  Without it (stats null) the kernel is the
// instantiation that reads no clock.  T and the log are the same either way.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLoadBatch = 8;  // window loads a thread has in flight at once

// Shared memory: the window W (3b rows of 3b + 1 floats: the padding makes
// thread r's walk along row r conflict-free), u and Mv (3b each), the sweep
// number.
__host__ __device__ constexpr int smem_floats(int b) { return 3 * b * (3 * b + 1) + 6 * b + 1; }

// Op (s, k): load the window, form the reflector, write back window rows
// and columns [b, 2b), and log it at slot (3s+k, k/3).  kB > 0 fixes b at
// compile time (the main path's b = 8: index arithmetic folds, loops
// unroll); kB == 0 takes b as it comes.  Every warp forms tau, beta and
// v^T M v from the same warp-wide sums, so all threads agree bitwise
// without a barrier; wv is formed where it is used.
template <int kB>
__device__ __forceinline__ void chase_op(float* __restrict__ T, int n, int b_in, int s, int k,
                                         int A, float* sm, float* __restrict__ vs,
                                         float* __restrict__ taus, int* __restrict__ row0,
                                         int with_log) {
  const int b = kB > 0 ? kB : b_in;
  const int w3 = 3 * b;
  const int ld = w3 + 1;
  float* W = sm;
  float* u = W + w3 * ld;  // the reflector, v = u[b:2b] with v[0] = 1
  float* Mv = u + w3;
  const int tid = threadIdx.x;
  constexpr int nt = kThreads;  // the launch's block size: loops over threads unroll
  const int lane = tid % 32;
  const int r0 = s + 1 + (k - 1) * b;
  // The window, kLoadBatch independent loads per thread at a time: one
  // round trip to L2 per batch.
  for (int e0 = 0; e0 < w3 * w3; e0 += kLoadBatch * nt) {
    float v[kLoadBatch];
    int at[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int e = e0 + j * nt + tid;
      const int r = e / w3;
      const int c = e - r * w3;
      const int gr = r0 + r;
      const int gc = r0 + c;
      at[j] = e < w3 * w3 ? r * ld + c : -1;
      v[j] = (at[j] >= 0 && gr >= 0 && gr < n && gc >= 0 && gc < n)
                 ? __ldcg(T + (long long)gr * n + gc) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j)
      if (at[j] >= 0) W[at[j]] = v[j];
  }
  __syncthreads();
  // house(x) of x = W[b:2b, elim]: beta = +|x|, the JAX package's sign.
  const int elim = k == 0 ? b - 1 : 0;
  const float alpha = W[b * ld + elim];
  float sigma = 0.f;
  for (int i = 1 + lane; i < b; i += 32) {
    const float x = W[(b + i) * ld + elim];
    sigma += x * x;
  }
  sigma = repro::warp_sum(sigma);
  const float mu = sqrtf(alpha * alpha + sigma);
  const float safe_denom = (alpha + mu == 0.f) ? 1.f : alpha + mu;
  const bool degenerate = sigma == 0.f;
  const float v0 = degenerate ? 1.f : (alpha <= 0.f ? alpha - mu : -sigma / safe_denom);
  const float tau = degenerate ? 0.f : 2.f * v0 * v0 / (sigma + v0 * v0);
  const float beta = degenerate ? alpha : mu;
  for (int r = tid; r < w3; r += nt) {
    float val = 0.f;
    if (r == b) val = 1.f;
    else if (r > b && r < 2 * b) val = degenerate ? 0.f : W[r * ld + elim] / v0;
    u[r] = val;
  }
  __syncthreads();
  for (int r = tid; r < w3; r += nt) {  // Mv = W[:, b:2b] v
    float acc = 0.f;
    for (int c = b; c < 2 * b; ++c) acc += W[r * ld + c] * u[c];
    Mv[r] = acc;
  }
  __syncthreads();
  float part = 0.f;
  for (int i = lane; i < b; i += 32) part += u[b + i] * Mv[b + i];
  const float vmv = repro::warp_sum(part);
  auto wv = [&](int r) { return tau * (Mv[r] - 0.5f * tau * vmv * u[r]); };
  // Write back rows [b, 2b) (all columns), then columns [b, 2b) of the
  // other rows.
  const int n_rows = b * w3;
  for (int q = tid; q < n_rows + 2 * b * b; q += nt) {
    int r, c;
    if (q < n_rows) {
      r = b + q / w3;
      c = q % w3;
    } else {
      const int rr = (q - n_rows) / b;
      r = rr < b ? rr : rr + b;
      c = b + (q - n_rows) % b;
    }
    const bool rin = r >= b && r < 2 * b;
    const bool cin = c >= b && c < 2 * b;
    float val = W[r * ld + c] - u[r] * wv(c) - wv(r) * u[c];
    if (rin && c == elim) val = (r == b) ? beta : 0.f;
    if (cin && r == elim) val = (c == b) ? beta : 0.f;
    const int gr = r0 + r;
    const int gc = r0 + c;
    if (gr >= 0 && gr < n && gc >= 0 && gc < n) T[(long long)gr * n + gc] = val;
  }
  if (with_log) {
    const long long lidx = (long long)(3 * s + k) * A + k / 3;
    for (int i = tid; i < b; i += nt) vs[lidx * b + i] = u[b + i];
    if (tid == 0) {
      taus[lidx] = tau;
      row0[lidx] = s + 1 + k * b;
    }
  }
  __syncthreads();
}

// done[z * (n-2) + s]: finished ops of sweep s of matrix z;
// done[batch * (n-2)]: the ticket.  Zero before the launch.  Thread 0 waits
// on sweep s-1 while thread 32 publishes the op before, so the two round
// trips to L2 overlap.  T (batch, n, n), the log (batch, W, A, b | -);
// stats (3: wait cycles, op cycles, ops), read with kStats only.
template <int kB, bool kStats>
__global__ void __launch_bounds__(kThreads)
    bulge_chase_kernel(float* __restrict__ T, int n, int b_in, int A, float* __restrict__ vs,
                       float* __restrict__ taus, int* __restrict__ row0, int with_log,
                       int* __restrict__ done, int batch, int group,
                       unsigned long long* __restrict__ stats) {
  const int b = kB > 0 ? kB : b_in;
  REPRO_DYNAMIC_SMEM(sm);
  int* s_sweep = reinterpret_cast<int*>(sm + smem_floats(b) - 1);
  const int tid = threadIdx.x;
  const int sweeps = n - 2;
  const long long tickets = (long long)batch * sweeps;
  const long long slots = (long long)(3 * (n - 3) + 1) * A;  // log slots a matrix
  unsigned long long wait_cycles = 0, op_cycles = 0, op_count = 0;  // thread 0's, with kStats
  for (;;) {
    if (tid == 0) *s_sweep = atomicAdd(done + tickets, 1);
    __syncthreads();
    const long long t = *s_sweep;
    __syncthreads();
    if (t >= tickets) break;
    // Ticket t: group g of `group` matrices (the last may have fewer),
    // sweep-major inside it.
    const long long per_group = (long long)group * sweeps;
    const int g = (int)(t / per_group);
    const int r = (int)(t - g * per_group);
    const int gsize = min(group, batch - g * group);
    const int s = r / gsize;
    const long long z = (long long)g * group + r % gsize;
    float* Tz = T + z * n * n;
    int* dz = done + z * sweeps;
    const int ops = (n - 3 - s) / b + 1;
    const int prev_ops = (n - 2 - s) / b + 1;  // kmax(s-1) + 1
    int seen = 0;                              // thread 0: done[z][s-1] as last read
    for (int k = 0; k < ops; ++k) {
      const int target = min(k + 3, prev_ops);
      long long c0 = 0, c1 = 0;
      if (kStats && tid == 0) c0 = clock64();
      if (s > 0 && tid == 0 && seen < target) seen = repro::flag_wait(dz + s - 1, target);
      if (kStats && tid == 0) c1 = clock64();
      if (k > 0 && tid == 32) repro::flag_publish(dz + s, k);
      __syncthreads();
      chase_op<kB>(Tz, n, b, s, k, A, sm, vs + z * slots * b, taus + z * slots, row0 + z * slots,
                   with_log);
      if (kStats && tid == 0) {
        wait_cycles += (unsigned long long)(c1 - c0);
        op_cycles += (unsigned long long)(clock64() - c1);
        op_count += 1;
      }
    }
    if (tid == 32) repro::flag_publish(dz + s, ops);
  }
  if (kStats && tid == 0) {
    atomicAdd(stats, wait_cycles);
    atomicAdd(stats + 1, op_cycles);
    atomicAdd(stats + 2, op_count);
  }
  if (!with_log) return;
  // Inactive slots: slot (wf, a) holds op (s, k) = (wf/3 - a, wf - 3s).
  const int last = n - 3;
  for (long long i = (long long)blockIdx.x * blockDim.x + tid; i < batch * slots;
       i += (long long)gridDim.x * blockDim.x) {
    const long long j = i % slots;
    const int wf = (int)(j / A);
    const int a = (int)(j % A);
    const int s = wf / 3 - a;
    const int k = wf - 3 * s;
    if (s >= 0 && s <= last && k <= (n - 3 - s) / b) continue;
    for (int r = 0; r < b; ++r) vs[i * b + r] = r == 0 ? 1.f : 0.f;
    taus[i] = 0.f;
    row0[i] = n;
  }
}

template <int kB, bool kStats>
int launch(float* T, int n, int b, int A, int ctas, float* vs, float* taus, int* row0,
           int with_log, int* work, int batch, unsigned long long* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = smem_floats(b) * (int)sizeof(float);
  auto* kernel = bulge_chase_kernel<kB, kStats>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    ctas = (int)std::min<long long>(per_sm * sms, (long long)batch * std::min(A, n - 2));
    if (ctas < 1) return (int)cudaErrorInvalidValue;
  }
  // Enough matrices a group for the grid's CTAs, a matrix keeping about
  // min(A, n-2) sweeps in flight.
  const int inflight = std::min(A, n - 2);
  const int group = std::max(1, std::min(batch, (ctas + inflight - 1) / inflight));
  REPRO_LAUNCH_PERSISTENT(kernel, (unsigned)ctas, kThreads, smem, st)
  (T, n, b, A, vs, taus, row0, with_log, work, batch, group, stats);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// Bytes of the zeroed workspace the launcher needs for a bucket of `batch`
// bands: n-2 progress counters a matrix and the ticket.
extern "C" long long bulge_wavefront_workspace(int n, int batch) {
  return ((long long)batch * (n - 2) + 1) * (long long)sizeof(int);
}

// One launch for the whole chase of a bucket.  T: (batch, n, n) row-major,
// chased in place; A: slots per wavefront of the log, (batch, W, A, b);
// ctas: CTAs of the persistent grid, or 0 for as many as the card keeps
// resident, at most batch x min(A, n-2), the sweeps that can be in flight
// (the ticket groups follow from it, see above);
// work: bulge_wavefront_workspace(n, batch) zeroed bytes; stats: null, or
// 3 zeroed counters the grid adds its wait cycles, op cycles and ops to.
extern "C" int bulge_wavefront_launch(float* T, int n, int b, int A, int ctas, float* vs,
                                      float* taus, int* row0, int with_log, int* work, int batch,
                                      unsigned long long* stats, void* stream) {
  if (n < 3 || b < 2 || A < 1 || ctas < 0 || batch < 1 ||
      (long long)batch * (n - 2) > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  if (stats)
    return b == 8 ? launch<8, true>(T, n, b, A, ctas, vs, taus, row0, with_log, work, batch, stats, stream)
                  : launch<0, true>(T, n, b, A, ctas, vs, taus, row0, with_log, work, batch, stats, stream);
  return b == 8 ? launch<8, false>(T, n, b, A, ctas, vs, taus, row0, with_log, work, batch, stats, stream)
                : launch<0, false>(T, n, b, A, ctas, vs, taus, row0, with_log, work, batch, stats, stream);
}
