// The count-window fire, hand-written for Hopper (sm_90a). Plain C
// interface, bound from Python with ctypes
// (flink_tpu_torch/kernels/count_window_kernels.py); the entry point
// launches on the caller's stream, allocates nothing (the wrapper passes
// its clean workspace) and returns cudaGetLastError(). It shares
// window_kernels.py's error word: a fire with more rows than its buffer
// ORs kErrCountFireCap into it.
//
// C1 count_fire   replaces flink_tpu/ops/count_window.py:106
//                 CountWindowOperator._build_step.step, its fire, the
//                 finalize input, the cumsum compaction and the purge
//                 (:116-143); the ingest scatter before it is
//                 scatter_lanes / scatter_counts with a ring of 1
//
// State: counts (rows,) int32, sums / maxs / mins (rows, width) f32, row
// = key slot, the last row the dump row (never fires). The trigger count
// since the last fire is counts[r] - base[r]; ``base`` is null for a
// purging window, whose counts restart at 0 on every fire (so the
// reference's since-lane equals counts there). A row fires when it is
// not the dump row and its trigger count is at least N.
//
// Output: an int32 (cap + 1, 2 + S + M + m) buffer. Row 0 is the head
// [n fired, 0, ...]; rows 1..min(n, cap) are [row, count, f32 bits of its
// sums, maxs, mins], in ascending row order (the reference's cumsum
// order). The aggregate's finalize runs on these rows in torch. Then the
// thread that stored a word resets what it came from: with purge, sums
// to 0, maxs to -inf, mins to +inf and counts to 0; without, base =
// counts (only the trigger count restarts). Rows past the cap are
// neither written nor reset, and set the error bit.
//
// Bound: bytes — the counts (and base) once, and each fired row's lanes
// read once, written to the buffer once and reset once: ~0.3 MB at
// WindowWordCount's 65,537 rows, under 0.1 us, so a launch's ramp and its
// ordering set the time. Design: one launch (lookback.cuh's ordered
// compaction, as fire_pack). A block takes a tile of kFireRowItems rows a
// thread, loads its counts (and base) with wide loads, ranks its fired
// rows with a block scan, publishes the tile's count and lists its fired
// rows in shared memory, so the rows are read once and no second pass
// has to select the same rows again. Then the tile's packed rows are
// built a word a thread: each thread's first word (a lane value) is read
// while the look-back runs, the words are stored as one run at the
// tile's offset, and the thread that stored a word resets it. The tile
// that sees the grand total (the last) writes the head. No float
// arithmetic (lanes are copied as bits), so the result is exact. A tile
// is kThreads x kFireRowItems = 512 rows, the fastest of the sizes tried
// on the card (PERF.md §6).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_common.cuh"
#include "lookback.cuh"

namespace {

// error-word bit (window_kernels.py ERROR_BITS decodes it)
constexpr int32_t kErrCountFireCap = 128;
// rows a thread; a tile is kThreads x kFireRowItems rows
// (count_window_kernels.py FIRE_TILE)
constexpr int kFireRowItems = 2;
constexpr int kFireTile = kThreads * kFireRowItems;

struct CountFireParams {
  int32_t* counts;
  int32_t* base;  // null: a purging window
  int64_t rows;
  float* lane[3];  // sums, maxs, mins (null where absent)
  int32_t width[3];
  int32_t size;
  int32_t* out;
  int32_t out_cap;
  int32_t* err;
  uint32_t* epoch;
  unsigned long long* desc;  // a descriptor a tile, kLbLine words apart
  int64_t tiles;
};

// kFireRowItems rows of counts (or base) from row r into v: an 8-byte
// load where both rows are there and aligned, else one a row (rows past
// the end read as 0)
__device__ __forceinline__ void load_rows(const int32_t* p, int64_t r, int64_t rows,
                                          int32_t (&v)[kFireRowItems]) {
  static_assert(kFireRowItems == 2, "one int2 load a thread");
  if (r + kFireRowItems <= rows && ((uintptr_t)(p + r) & 7) == 0) {
    const int2 q = *(const int2*)(p + r);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < kFireRowItems; ++j) v[j] = r + j < rows ? p[r + j] : 0;
  }
}

// Word k of the packed row of fired row r (count c): its row, its count,
// then the f32 bits of its sums, maxs and mins
__device__ __forceinline__ int32_t packed_word(const CountFireParams& p, int64_t r, int32_t c,
                                               int32_t k) {
  if (k < 2) return k == 0 ? (int32_t)r : c;
  k -= 2;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    if (k < p.width[f]) return __float_as_int(p.lane[f][r * p.width[f] + k]);
    k -= p.width[f];
  }
  return 0;
}

// ... and its reset: the count (purge: 0; else base = count) and each
// lane's identity (0, -inf, +inf) with purge; nothing for the row word
__device__ __forceinline__ void reset_word(const CountFireParams& p, int64_t r, int32_t c,
                                           int32_t k) {
  if (k == 0) return;
  if (k == 1) {
    if (p.base != nullptr) p.base[r] = c;
    else p.counts[r] = 0;
    return;
  }
  if (p.base != nullptr) return;
  k -= 2;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    if (k < p.width[f]) {
      p.lane[f][r * p.width[f] + k] = f == 0 ? 0.0f : f == 1 ? -INFINITY : INFINITY;
      return;
    }
    k -= p.width[f];
  }
}

__global__ void __launch_bounds__(kThreads)
    count_fire_kernel(const __grid_constant__ CountFireParams p) {
  __shared__ int s_scan[kWarps];
  __shared__ int s_total, s_min[kWarps];
  __shared__ long long s_sum[kWarps];
  __shared__ uint32_t s_epoch;
  __shared__ int32_t s_row[kFireTile], s_cnt[kFireTile];  // the tile's fired rows
  const int64_t tile = blockIdx.x;
  const int64_t row0 = tile * kFireTile;
  const int64_t r0 = row0 + (int64_t)threadIdx.x * kFireRowItems;

  // 1: this thread's rows (and the epoch, in flight with them), and
  // which of them fire (the dump row never)
  int32_t c[kFireRowItems], b[kFireRowItems];
  load_rows(p.counts, r0, p.rows, c);
  if (p.base != nullptr) load_rows(p.base, r0, p.rows, b);
  if (threadIdx.x == 0) s_epoch = *(volatile const uint32_t*)p.epoch;
  uint32_t sel = 0;
#pragma unroll
  for (int j = 0; j < kFireRowItems; ++j) {
    // counts - base wraps as torch's int32 subtraction does
    const int32_t since = p.base != nullptr ? (int32_t)((uint32_t)c[j] - (uint32_t)b[j]) : c[j];
    if (r0 + j < p.rows - 1 && since >= p.size) sel |= 1u << j;
  }

  // 2: the tile's count, published; its fired rows in row order in
  // shared memory
  const int before = block_scan_total(__popc(sel), s_scan, &s_total);  // syncs: s_epoch
  const int32_t tile_n = s_total;
  const uint32_t epoch = s_epoch;
  lb_publish<kLbLine>(p.desc, tile, tile_n, epoch);
  {
    int q = before;
#pragma unroll
    for (int j = 0; j < kFireRowItems; ++j)
      if ((sel >> j) & 1u) {
        s_row[q] = (int32_t)(r0 + j - row0);
        s_cnt[q++] = c[j];
      }
  }
  __syncthreads();

  // 3: a word a thread of the tile's packed rows, read while the
  // look-back runs (each word is read and later reset by one thread)
  const int cols = 2 + p.width[0] + p.width[1] + p.width[2];
  const int words = tile_n * cols;
  int32_t first_word = 0;
  if ((int)threadIdx.x < words) {
    const int e = threadIdx.x / cols;
    first_word = packed_word(p, row0 + s_row[e], s_cnt[e], threadIdx.x - e * cols);
  }

  // 4: the tile's place among all fired rows; the last tile's head and
  // the next call's epoch
  const long long excl = lookback_exclusive<kLbLine>(p.desc, tile, tile_n, epoch, s_sum, s_min);
  if (tile == p.tiles - 1 && threadIdx.x == 0) {
    const long long all = excl + tile_n;
    p.out[0] = (int32_t)all;
    for (int k = 1; k < cols; ++k) p.out[k] = 0;
    if (all > p.out_cap) atomicOr(p.err, kErrCountFireCap);
    lb_advance(p.epoch, epoch);
  }

  // 5: the packed rows below the cap, stored as one run, each row reset
  const long long room = p.out_cap - excl;
  const int n_w = room <= 0 ? 0 : room < tile_n ? (int)room : tile_n;
  int32_t* dst = p.out + (excl + 1) * cols;
  for (int w = threadIdx.x; w < n_w * cols; w += kThreads) {
    const int e = w / cols, k = w - e * cols;
    const int64_t r = row0 + s_row[e];
    dst[w] = w < kThreads ? first_word : packed_word(p, r, s_cnt[e], k);
    reset_word(p, r, s_cnt[e], k);
  }
}

}  // namespace

extern "C" {

const char* cw_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// base null: a purging window. work: the clean workspace of work_words
// int64 words (the epoch, then from word kLbLine a descriptor a tile,
// kLbLine words apart: count_window_kernels.py _fire_work_words), zeroed
// once and left clean by every call.
int cw_count_fire(int32_t* counts, int32_t* base, int64_t rows, float* sums, int32_t sw,
                  float* maxs, int32_t mw, float* mins, int32_t nw, int32_t size, int32_t* out,
                  int32_t out_cap, void* work, int64_t work_words, int32_t* err, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const int64_t tiles = (rows + kFireTile - 1) / kFireTile;
  if (tiles >= (1ll << 31) || work_words < kLbLine * (tiles + 1))
    return (int)cudaErrorInvalidValue;
  CountFireParams p{};
  p.counts = counts;
  p.base = base;
  p.rows = rows;
  p.lane[0] = sums;
  p.lane[1] = maxs;
  p.lane[2] = mins;
  p.width[0] = sums != nullptr ? sw : 0;
  p.width[1] = maxs != nullptr ? mw : 0;
  p.width[2] = mins != nullptr ? nw : 0;
  p.size = size;
  p.out = out;
  p.out_cap = out_cap;
  p.err = err;
  p.epoch = (uint32_t*)work;
  p.desc = (unsigned long long*)work + kLbLine;
  p.tiles = tiles;
  count_fire_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// the lean launch path (window_kernels.py LeanEntry): cw_count_fire
// from one packed block of 15 64-bit words, the stream beside
int cw_count_fire_packed(const int64_t* a, void* stream) {
  return cw_count_fire(
      (int32_t*)(intptr_t)a[0], (int32_t*)(intptr_t)a[1], (int64_t)a[2], (float*)(intptr_t)a[3],
      (int32_t)a[4], (float*)(intptr_t)a[5], (int32_t)a[6], (float*)(intptr_t)a[7],
      (int32_t)a[8], (int32_t)a[9], (int32_t*)(intptr_t)a[10], (int32_t)a[11],
      (void*)(intptr_t)a[12], (int64_t)a[13], (int32_t*)(intptr_t)a[14], stream);
}

}  // extern "C"
