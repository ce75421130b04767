// Ordered compaction in one launch, by decoupled look-back (Merrill &
// Garland 2016, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back"), shared by the fire kernels redesigned for Hopper:
// fire_pack (lane_kernels.cu), count_fire (count_window_kernels.cu) and
// the top-n selections of topn_select.cuh (topn_select_lanes,
// topn_select_append, the fused step's fire tail and topn_select_given).
// A block ranks the selected items of its tile, publishes the tile's
// count and takes its global offset from the tiles before it in the same
// launch, so no per-item scratch goes through device memory and no
// second launch reads it back (or has to select the same items again).
//
// Tile t is block t: the scheduler starts blocks in index order, so a
// tile's predecessors are running or done when it waits on them (CUB's
// single-pass scan relies on the same order). A tile's descriptor is one
// 64-bit word — the call's epoch, a flag (aggregate: the tile's own
// count; inclusive: the count of every tile up to and including it) and
// the count — written in one store, so no fence orders its parts.
//
// The epoch keeps the workspace clean with no memset and no clean-up
// pass: a descriptor counts only when its epoch is this call's, and the
// grid's last tile advances the epoch once its look-back is done (every
// tile has read the epoch by then: each published a descriptor holding
// it). The workspace starts zeroed (window_kernels.py clean_workspace,
// once a device and stream, renewed before the 24-bit epoch could wrap).
// Include once, after window_common.cuh.
#pragma once

#include "window_common.cuh"

namespace {

constexpr int kLbCountBits = 38;
constexpr unsigned long long kLbCount = (1ull << kLbCountBits) - 1;
constexpr unsigned long long kLbAgg = 1ull << kLbCountBits;
constexpr unsigned long long kLbInc = 2ull << kLbCountBits;
constexpr unsigned long long kLbFlags = kLbAgg | kLbInc;
constexpr uint32_t kLbEpochMask = (1u << 24) - 1;

__device__ __forceinline__ unsigned long long lb_load(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void lb_store(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long lb_word(uint32_t epoch, unsigned long long flag,
                                                      long long count) {
  return ((unsigned long long)(epoch & kLbEpochMask) << 40) | flag | (unsigned long long)count;
}

// published in the call of this epoch
__device__ __forceinline__ bool lb_published(unsigned long long d, uint32_t epoch) {
  return (d >> 40) == (epoch & kLbEpochMask) && (d & kLbFlags);
}

__device__ __forceinline__ int block_min_int(int v, int* smem) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // smem may still be read by a previous call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  int r = smem[0];
  for (int i = 1; i < kWarps; ++i) r = min(r, smem[i]);
  return r;
}

// Descriptor t lies at desc[t * kStride] (64-bit words): 1 packs them;
// kLbLine gives each its own 128-byte line, so a wave of tiles polling
// them spreads over the L2 instead of queueing on a few lines (the
// top-n selections' look-back measured 1.5 against 3.0 us a tile,
// PERF.md §6, PR 13).
constexpr int kLbLine = 16;

// A tile's own count, published as soon as the block knows it (thread 0;
// before lookback_exclusive, and before any other work the tile can do
// first, so its successors wait less).
template <int kStride = 1>
__device__ __forceinline__ void lb_publish(unsigned long long* __restrict__ desc, int64_t tile,
                                           long long agg, uint32_t epoch) {
  if (threadIdx.x == 0)
    lb_store(desc + tile * kStride, lb_word(epoch, tile ? kLbAgg : kLbInc, agg));
}

// The count of the items selected in the tiles before ``tile``, given its
// own count ``agg`` (published by lb_publish); every thread of the block
// calls it and gets the same value. Each thread reads
// one predecessor's descriptor (kThreads at once, nearest first) and
// waits until it is published; the block adds them up to the nearest
// inclusive one (or all, then the next kThreads). With every tile of the
// grid running at once (one wave: ~260 tiles at WordCount's fire) a tile
// waits for its predecessors' aggregates, not for a chain of inclusive
// counts; thread 0 then publishes its own inclusive count.
template <int kStride = 1>
__device__ long long lookback_exclusive(unsigned long long* __restrict__ desc, int64_t tile,
                                        long long agg, uint32_t epoch, long long* s_sum,
                                        int* s_min) {
  long long excl = 0;
  if (tile > 0) {
    for (int64_t p = tile - 1;; p -= kThreads) {
      // before the first tile: an inclusive count of 0
      const int64_t q = p - threadIdx.x;
      unsigned long long d = lb_word(epoch, kLbInc, 0);
      if (q >= 0)
        do {
          d = lb_load(desc + q * kStride);
        } while (!lb_published(d, epoch));
      const int nearest = block_min_int((d & kLbInc) ? (int)threadIdx.x : kThreads, s_min);
      excl += block_sum((int)threadIdx.x <= nearest ? (long long)(d & kLbCount) : 0, s_sum);
      if (nearest < kThreads) break;
    }
    if (threadIdx.x == 0) lb_store(desc + tile * kStride, lb_word(epoch, kLbInc, excl + agg));
  }
  return excl;
}

// the grid's last tile, its look-back done: the next call's epoch
__device__ __forceinline__ void lb_advance(uint32_t* word, uint32_t epoch) {
  *(volatile uint32_t*)word = epoch + 1;
}

// block_exclusive_scan's position of v, and (into *s_total) the block's
// sum, for every thread
__device__ __forceinline__ int block_scan_total(int v, int* s_scan, int* s_total) {
  const int before = block_exclusive_scan(v, s_scan);
  if (threadIdx.x == blockDim.x - 1) *s_total = before + v;
  __syncthreads();
  return before;
}

// True in every thread of the one block that calls this last of the
// launch's ``blocks`` (``done`` then wraps back to 0). What every block
// wrote or read before its call is done before the last block goes on.
__device__ bool last_block(unsigned int* done, unsigned int blocks, int* s_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *s_flag = atomicInc(done, blocks - 1) == blocks - 1;
  }
  __syncthreads();
  const bool last = *s_flag != 0;
  if (last) __threadfence();
  return last;
}

// one 4- or 16-byte copy from device memory into shared memory,
// asynchronously (every load of a tile in flight at once);
// cp_async_wait waits for this thread's copies
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the copies issued since the last commit as one group; wait until at
// most one group of this thread is still in flight (a two-stage pipeline:
// the next stage's copies run while the current one is read)
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// n consecutive 32-bit words from src into shared memory, every thread
// of the block taking part: 16-byte copies for the aligned body, 4-byte
// ones for the head and tail. The words land at dst + shift, where shift
// (returned, 0..3) puts src's 16-byte alignment on dst's (dst 16-byte
// aligned, room for n + 3 words).
__device__ __forceinline__ int stage_words(uint32_t* dst, const uint32_t* src, int64_t n) {
  const int shift = (int)(((uintptr_t)src >> 2) & 3);
  uint32_t* d = dst + shift;
  const int head = shift ? 4 - shift : 0;
  const int64_t h = head < n ? head : n;
  const int64_t body = (n - h) / 4;
  for (int64_t i = threadIdx.x; i < h; i += blockDim.x) cp_async_4(d + i, src + i);
  for (int64_t i = threadIdx.x; i < body; i += blockDim.x)
    cp_async_16(d + h + 4 * i, src + h + 4 * i);
  for (int64_t i = h + 4 * body + threadIdx.x; i < n; i += blockDim.x) cp_async_4(d + i, src + i);
  return shift;
}

}  // namespace
