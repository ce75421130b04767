// Ordered compaction in two launches, for count_fire
// (count_window_kernels.cu), which packs its fired rows for the host in
// the reference's order (its cumsum). fire_pack and the top-n selections
// (topn_select.cuh) compact in one launch instead (lookback.cuh).
//
//   A  one block per kTile items, each thread testing kItems consecutive
//      items: compact_count stores the block's selected count;
//   B  the same tiling: compact_write sums the counts of the blocks
//      before it (deterministic, no atomic cursor), scans its tile in
//      thread order and hands each selected item its position.
//
// Both passes must select the same items: the predicate reads nothing
// that pass B's writes change before it is read. Include once, after
// window_common.cuh.
#pragma once

#include "window_common.cuh"

namespace {

// Pass A: block_counts[blockIdx.x] = how many items of this block's tile
// ``sel(i)`` selects (``sel`` may also store a per-item result).
template <class Sel>
__device__ __forceinline__ void compact_count(int64_t K, Sel sel,
                                              int32_t* __restrict__ block_counts) {
  __shared__ long long s_sum[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  long long c = 0;
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    if (i >= K) break;
    if (sel(i)) ++c;
  }
  c = block_sum(c, s_sum);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = (int32_t)c;
}

// Pass B: each selected item i of this block's tile, in item order, gets
// ``emit(i, pos)`` with its position among all selected items, while pos
// < cap; block 0's thread 0 gets ``head(total)`` with the count of all of
// them. Items at or past the cap are not emitted.
template <class Sel, class Emit, class Head>
__device__ __forceinline__ void compact_write(int64_t K, const int32_t* __restrict__ block_counts,
                                              int32_t n_blocks, long long cap, Sel sel,
                                              Emit emit, Head head) {
  __shared__ long long s_sum[kWarps];
  __shared__ int s_scan[kWarps];
  long long before = 0;
  for (int32_t b = threadIdx.x; b < (int32_t)blockIdx.x; b += blockDim.x) before += block_counts[b];
  before = block_sum(before, s_sum);
  if (blockIdx.x == 0) {
    long long all = 0;
    for (int32_t b = threadIdx.x; b < n_blocks; b += blockDim.x) all += block_counts[b];
    all = block_sum(all, s_sum);
    if (threadIdx.x == 0) head(all);
  }
  if (before >= cap) return;  // uniform per block: every item of it is past the cap
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  bool s[kItems];
  int mine = 0;
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    s[j] = i < K && sel(i);
    mine += s[j];
  }
  long long pos = before + block_exclusive_scan(mine, s_scan);
  for (int j = 0; j < kItems; ++j) {
    if (!s[j]) continue;
    if (pos >= cap) break;
    emit(base + j, pos);
    ++pos;
  }
}

inline int32_t compact_blocks(int64_t K) { return (int32_t)((K + kTile - 1) / kTile); }

}  // namespace
