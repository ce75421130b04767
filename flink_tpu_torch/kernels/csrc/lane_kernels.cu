// Lane kernels of the general window aggregates (sum/max/min lanes beside
// the count lane), hand-written for Hopper (sm_90a). Plain C interface,
// bound from Python with ctypes (flink_tpu_torch/kernels/lane_kernels.py);
// every entry point launches on the caller's stream, allocates nothing
// (the wrapper passes scratch) and returns cudaGetLastError(). They share
// window_kernels.py's error word: an entry outside the state, or a fire
// with more rows than its buffer, ORs a kErr* bit into it.
//
// Pane state: counts (rows, ring) int32 and sums / maxs / mins
// (rows, ring, width) f32, row = key slot (+ 1 dump row), column = pane
// ring position. Float rules: no float atomics and no TF32 anywhere; a
// sum adds in a fixed order, so a rerun gives the same bits, and so does
// the plain PyTorch version beside each kernel. A scatter adds a cell's
// records in record order, which is also the JAX reference's order on
// XLA's CPU backend (bit for bit). The fire adds the ring columns in
// column order, each times its 0/1 mask bit; the reference's jitted
// column-mask product leaves the association to XLA's GEMM, which picks
// it by shape, so fired sums agree with it to a rounding or two. Max and
// min are IEEE 754-2019 maximum / minimum, as XLA's are: NaN wins, and
// -0 < +0.
//
// L1 fire_pack           replaces flink_tpu/ops/window.py:384
//                        fire_pack_kernel, with fire_kernel's (:286)
//                        sum/max/min lanes (:320-344)
// L2 scatter_lanes       replaces flink_tpu/ops/window.py:62 apply_kernel /
//                        :85 _scatter_panes (+ ops/aggregates.py:67
//                        lift_masked, done in torch before the launch)
// L3 scatter_pair_lanes  replaces flink_tpu/ops/window.py:205
//                        apply_preagg_i32_kernel
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "compact.cuh"
#include "window_common.cuh"

namespace {

// error-word bits (window_kernels.py ERROR_BITS decodes them)
constexpr int32_t kErrScatterLanes = 8;
constexpr int32_t kErrPairLanes = 16;
constexpr int32_t kErrFireCap = 32;

// ---- L1: fire_pack ---------------------------------------------------------
// For every (row, window) cell of a chunk of W window ends: the window's
// count over its live panes, selection (count > 0, row in use, window
// valid), stable row-major compaction into an int32 buffer and, for the
// selected cells, the window's lane values. Row 0 of the buffer is the
// head [n selected, 0, ...]; rows 1..min(n, cap) are [row, end - pane_lo,
// count] — or, in the count-only packed2 layout, [(row << 8) | delta,
// count]. ``row_offset`` is added to the row column of the 3-column
// layout: a key-sharded operator's device block passes its first global
// row (flink_tpu/ops/window.py:1552 fire_shard). The lanes go to a (cap, S + M + m) f32 buffer in the same row
// order; the aggregate's finalize runs on them in torch.
//
// Bound: bytes — the count lane's live columns once, each selected cell's
// lane columns once (the sums row is read whole, since the reference adds
// every column times its mask bit), the output rows once. Design, the
// two launches of compact.cuh's ordered compaction on one stream:
//   A  window counts into a (rows, W) scratch and each block's selected
//      count;
//   B  each selected cell's row and lanes at its position; block 0
//      writes the head. The rows land in exactly the order of the
//      reference's stable argsort.

__global__ void fire_count_kernel(const int32_t* __restrict__ counts, int64_t rows, int32_t ring,
                                  const int64_t* __restrict__ end_panes,
                                  const uint8_t* __restrict__ w_valid, int32_t W,
                                  int64_t pane_lo, int64_t pane_hi, int32_t ppw,
                                  const uint8_t* __restrict__ used, int32_t* __restrict__ wc,
                                  int32_t* __restrict__ block_counts) {
  const int64_t hi_cap = live_hi_cap(pane_lo, pane_hi, ring);
  compact_count(
      rows * (int64_t)W,
      [&](int64_t i) {
        const int64_t r = i / W;
        const int32_t w = (int32_t)(i - r * W);
        const int32_t v = w_valid[w] ? window_count(counts + r * ring, ring, end_panes[w],
                                                    pane_lo, hi_cap, ppw)
                                     : 0;
        wc[i] = v;
        return v > 0 && used[r];
      },
      block_counts);
}

__global__ void fire_write_kernel(const int32_t* __restrict__ wc, int64_t rows, int32_t W,
                                  const uint8_t* __restrict__ used,
                                  const int32_t* __restrict__ block_counts, int32_t n_blocks,
                                  const int64_t* __restrict__ end_panes, int64_t pane_lo,
                                  int64_t pane_hi, int32_t ppw, int32_t ring,
                                  const float* __restrict__ sums, int32_t sw,
                                  const float* __restrict__ maxs, int32_t mw,
                                  const float* __restrict__ mins, int32_t nw,
                                  int32_t* __restrict__ out, int32_t out_cols, int32_t out_cap,
                                  int32_t packed2, int32_t row_offset,
                                  float* __restrict__ lanes, int32_t* __restrict__ err) {
  const int32_t L = sw + mw + nw;
  compact_write(
      rows * (int64_t)W, block_counts, n_blocks, out_cap,
      [&](int64_t i) { return wc[i] > 0 && used[i / W]; },
      [&](int64_t i, long long pos) {
        const int64_t r = i / W;
        const int32_t w = (int32_t)(i - r * W);
        const int64_t e = end_panes[w];
        const int32_t delta = (int32_t)(e - pane_lo);
        int32_t* dst = out + (pos + 1) * out_cols;
        if (packed2) {
          dst[0] = ((int32_t)r << 8) | delta;
          dst[1] = wc[i];
        } else {
          dst[0] = (int32_t)r + row_offset;
          dst[1] = delta;
          dst[2] = wc[i];
        }
        if (L == 0) return;
        // the window's live panes [lo_w, hi_w]; column c is live when it
        // holds one of them (span < ring: one live pane per column)
        const int64_t lo_w = e - ppw > pane_lo ? e - ppw : pane_lo;
        const int64_t hi_w = e - 1 < pane_hi ? e - 1 : pane_hi;
        const int64_t span = hi_w - lo_w;
        const int32_t c0 = (int32_t)floor_mod(lo_w, ring);
        const int32_t span32 = span < 0 ? -1 : (span >= ring - 1 ? ring - 1 : (int32_t)span);
        float* lo_out = lanes + pos * L;
        for (int32_t s = 0; s < sw; ++s) {
          float acc = 0.0f;
          for (int32_t c = 0; c < ring; ++c) {
            const int32_t d = c >= c0 ? c - c0 : c - c0 + ring;
            acc += sums[(r * ring + c) * sw + s] * (d <= span32 ? 1.0f : 0.0f);
          }
          lo_out[s] = acc;
        }
        for (int32_t s = 0; s < mw; ++s) {
          float acc = -INFINITY;
          for (int32_t c = 0; c < ring; ++c) {
            const int32_t d = c >= c0 ? c - c0 : c - c0 + ring;
            if (d <= span32) acc = max_ieee(acc, maxs[(r * ring + c) * mw + s]);
          }
          lo_out[sw + s] = acc;
        }
        for (int32_t s = 0; s < nw; ++s) {
          float acc = INFINITY;
          for (int32_t c = 0; c < ring; ++c) {
            const int32_t d = c >= c0 ? c - c0 : c - c0 + ring;
            if (d <= span32) acc = min_ieee(acc, mins[(r * ring + c) * nw + s]);
          }
          lo_out[sw + mw + s] = acc;
        }
      },
      [&](long long all) {
        out[0] = (int32_t)all;
        for (int32_t c = 1; c < out_cols; ++c) out[c] = 0;
        if (all > out_cap) atomicOr(err, kErrFireCap);
      });
}

// ---- L2: scatter_lanes -----------------------------------------------------
// Fold one batch of records into every lane: for each record i with
// flat cell idx[i], sums[cell] += s[i], maxs[cell] = max(maxs[cell],
// mx[i]), mins[cell] = min(mins[cell], mn[i]), counts[cell] += 1 — each
// cell's records in record order, as the reference's XLA scatter adds
// them (so the f32 sums come out bit for bit equal). No float atomics:
// every cell is written by one thread, so a rerun gives the same bits.
//
// Bound: bytes — idx and each record's lanes once, each touched cell's
// count and lanes read and written once (~20 MB at 2^20 records into
// the bid-aggregate state, 0.006 ms). The order costs a sort on top.
//
// Design, one memset and 2 + passes launches on the caller's stream:
//   H  lanes_hist_kernel reads idx once, a block a sort tile: the range
//      check (an index outside the state, or a negative one unless
//      skip_negative, sets kErrScatterLanes and is dropped), the count
//      of valid records and the digit histogram of every pass, into the
//      zeroed ctrl block.
//   S  lanes_sort_kernel, once per digit pass: a stable LSD radix pass of
//      (cell, record index) over tiles of kSortTile records, each tile's
//      digit offsets from a chained scan with decoupled look-back
//      (Merrill & Garland 2016, as Onesweep uses it for sorting, Adinets
//      & Merrill 2022): a tile publishes its digit counts, sums its
//      predecessors' (kLookback words a read) until one has published an
//      inclusive prefix, then publishes its own; the global digit bases
//      come from H's histogram. No scan launches. Inside a tile a
//      record's rank among its warp's records of its digit comes from
//      __match_any_sync, warps in record order, so the pass is stable
//      (ranking by a ballot a digit bit measured no faster); the tile is
//      ordered in shared memory first, so the writes to device memory run
//      in digit runs. The first pass reads idx and keeps only the valid
//      records.
//   F  lanes_fold_kernel: each thread owns kFoldSpan sorted places and
//      folds every run that ends among them, from the run's head (found
//      by a galloping search back over the sorted cells when the run
//      started in an earlier span) to its end: count, sums, maxes and
//      mins in one walk, in record order, each record's lanes read from
//      the caller's arrays by its index, a chunk of records' loads in
//      flight together. A run longer than kLongRun is folded by the
//      span's whole warp instead: coalesced index loads two rounds ahead,
//      maxes and mins across the lanes, the sums in record order from
//      shuffles. Max and min compare order-preserving int keys (IEEE
//      754-2019: NaN wins, -0 < +0), one integer op on the chain.
//
// The lanes are read in the fold, not placed by the last pass: a last
// pass that gathered them by index ran about three times as long as a
// pass that moves indices (random reads from a block at 2 an SM), and
// carrying them through every pass in shared memory doubled each pass;
// the fold waits on its loads anyway. Digits: at most 8 bits
// (kMaxDigitBits), passes = ceil(bits / 8) with the bits spread evenly
// (21 key bits: 3 passes of 7), so one thread of the 256 owns each digit
// in the look-back and the scans; the per-warp digit table (8 KB) and
// the tile's staging (32 KB) fit in 48 KB of static shared memory. Wider
// digits (11 bits, 2 passes) would need 2048 counters a warp and 8
// look-back chains a thread. Tiles of 2048 records measured slower than
// 4096 (the per-tile scans and look-back dominate at 2^20 records). A
// cell's records form one run whose sum is one dependent chain of f32
// adds in record order: a batch with most records in one cell (2^18 in
// chip_smoke.py's hot-cell case) waits for that chain, which is the
// contract's cost; the maxes, mins and count add no chain of their own.
// The wrapper keeps the workspace (ctrl, look-back words, two cell and
// two index buffers) per device and stream.
constexpr int kSortItems = 16;
constexpr int kSortTile = kThreads * kSortItems;
constexpr int kMaxDigitBits = 8;
constexpr int kMaxRadix = 1 << kMaxDigitBits;
constexpr int kMaxPasses = 4;
// predecessors' look-back words read at once
constexpr int kLookback = 8;
// a fold thread's sorted places, and the records it loads at once
constexpr int kFoldSpan = 16;
constexpr int kFoldChunk = 8;
constexpr int kFoldLanes = 8;
// a run longer than kLongRun is folded by its span's whole warp,
// kWarpBatch records a lane a round
constexpr int kLongRun = 32;
constexpr int kWarpBatch = 4;
// the ctrl block at the head of the zeroed workspace: each pass's digit
// histogram, each pass's tile counter, the valid records; 256-byte rounded
constexpr int kCtrlTiles = kMaxPasses * kMaxRadix;
constexpr int kCtrlValid = kCtrlTiles + kMaxPasses;
constexpr int kCtrlInts = (kCtrlValid + 1 + 63) / 64 * 64;
// a look-back word: a flag in the top two bits, a record count below
constexpr uint32_t kFlagAgg = 1u << 30;
constexpr uint32_t kFlagInc = 2u << 30;
constexpr uint32_t kCountMask = kFlagAgg - 1u;

static_assert(kMaxRadix == kThreads, "one thread per digit");

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// order-preserving int32 keys of f32 values (-0 < +0); NaN takes the top
// key for a maximum and the bottom one for a minimum, so it wins
__device__ __forceinline__ int32_t max_key(float x) {
  const int32_t b = __float_as_int(x);
  return isnan(x) ? 0x7fffffff : b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ int32_t min_key(float x) {
  const int32_t b = __float_as_int(x);
  return isnan(x) ? (int32_t)0x80000000 : b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_key(int32_t k) {
  if (k == 0x7fffffff || k == (int32_t)0x80000000) return __int_as_float(0x7fc00000);
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__global__ void __launch_bounds__(kThreads)
    lanes_hist_kernel(const int32_t* __restrict__ idx, int64_t n, int64_t n_cells,
                      int32_t skip_negative, int32_t passes, int32_t digit_bits,
                      int32_t* __restrict__ ctrl, int32_t* __restrict__ err) {
  __shared__ int s_h[kMaxPasses * kMaxRadix];
  __shared__ long long s_sum[kWarps];
  for (int e = threadIdx.x; e < kMaxPasses * kMaxRadix; e += kThreads) s_h[e] = 0;
  __syncthreads();
  const uint32_t mask = (1u << digit_bits) - 1u;
  // block b reads the records of sort tile b, all its loads in flight
  // before the first count
  const int64_t base = (int64_t)blockIdx.x * kSortTile + threadIdx.x;
  int32_t c[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int64_t i = base + (int64_t)j * kThreads;
    c[j] = i < n ? idx[i] : -1;
  }
  int valid = 0;
  int bad = 0;
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (base + (int64_t)j * kThreads >= n) break;
    if (c[j] < 0 && skip_negative) continue;  // an invalid record: touches nothing
    if (c[j] < 0 || (int64_t)c[j] >= n_cells) {
      bad = 1;
      continue;
    }
    ++valid;
    for (int p = 0; p < passes; ++p)
      atomicAdd(&s_h[p * kMaxRadix + (((uint32_t)c[j] >> (p * digit_bits)) & mask)], 1);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(err, kErrScatterLanes);
  for (int e = threadIdx.x; e < passes * kMaxRadix; e += kThreads)
    if (s_h[e]) atomicAdd(&ctrl[e], s_h[e]);
  const long long total = block_sum(valid, s_sum);
  if (threadIdx.x == 0 && total) atomicAdd(&ctrl[kCtrlValid], (int32_t)total);
}

// One stable digit pass over the records' cells and indices. kFirst:
// the cells come from idx (a record outside the state is dropped) and a
// record's index is its position; else both come from the previous pass
// (n_valid of them). status: this pass's look-back words, tile-major.
template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
    lanes_sort_kernel(const int32_t* __restrict__ keys_in, const int32_t* __restrict__ vals_in,
                      int64_t n, int64_t n_cells, int32_t pass, int32_t digit_bits,
                      int32_t* __restrict__ ctrl, uint32_t* __restrict__ status,
                      int32_t* __restrict__ keys_out, int32_t* __restrict__ vals_out) {
  __shared__ int s_tile, s_tile_n;
  __shared__ int s_warp[kWarps][kMaxRadix];  // digit counts, then offsets, a warp
  __shared__ int s_start[kMaxRadix];         // a digit's first place in the tile
  __shared__ int s_gofs[kMaxRadix];          // its global place less s_start
  __shared__ int s_scan[kWarps];
  __shared__ int32_t s_key[kSortTile];
  __shared__ int32_t s_val[kSortTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int radix = 1 << digit_bits;
  const int shift = pass * digit_bits;
  const uint32_t mask = (uint32_t)radix - 1u;
  // tiles in the order blocks start, so a tile's predecessors are running
  if (threadIdx.x == 0) s_tile = atomicAdd(&ctrl[kCtrlTiles + pass], 1);
  for (int e = threadIdx.x; e < kWarps * kMaxRadix; e += kThreads) (&s_warp[0][0])[e] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int64_t n_in = kFirst ? n : (int64_t)ctrl[kCtrlValid];
  const int64_t base = (int64_t)tile * kSortTile;
  if (base >= n_in) return;
  // warp w ranks records [wbase, wbase + 32 * kSortItems) of the tile, in
  // rounds of 32 consecutive records
  const int64_t wbase = base + (int64_t)warp * 32 * kSortItems;
  const uint32_t lt = (1u << lane) - 1u;
  int32_t key[kSortItems], val[kSortItems];
  int rank[kSortItems];  // among the warp's records of its digit; -1: none
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int64_t i = wbase + (int64_t)j * 32 + lane;
    bool ok = i < n_in;
    const int32_t c = ok ? keys_in[i] : 0;
    if (kFirst) ok = ok && c >= 0 && (int64_t)c < n_cells;
    key[j] = c;
    val[j] = kFirst ? (int32_t)i : (ok ? vals_in[i] : 0);
    // kMaxRadix: a value no digit has, so a missing record joins no group
    const uint32_t dig = ok ? ((uint32_t)c >> shift) & mask : (uint32_t)kMaxRadix;
    const uint32_t peers = __match_any_sync(0xffffffffu, dig);
    rank[j] = ok ? s_warp[warp][dig] + __popc(peers & lt) : -1;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) s_warp[warp][dig] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const int d = threadIdx.x;  // the digit this thread owns
  int total = 0;
  if (d < radix) {
    for (int w = 0; w < kWarps; ++w) {
      const int t = s_warp[w][d];
      s_warp[w][d] = total;
      total += t;
    }
    st_relaxed(&status[(int64_t)tile * radix + d], (tile ? kFlagAgg : kFlagInc) | (uint32_t)total);
  }
  const int start = block_exclusive_scan(d < radix ? total : 0, s_scan);
  const int gbase = block_exclusive_scan(d < radix ? ctrl[pass * kMaxRadix + d] : 0, s_scan);
  if (d < radix) {
    int excl = 0;
    if (tile) {
      // read kLookback predecessors' words at once, nearest first; add
      // them up to the first inclusive one, or stop at the first one not
      // yet published and read again from there
      for (int64_t p = tile - 1;;) {
        uint32_t w[kLookback];
#pragma unroll
        for (int i = 0; i < kLookback; ++i)
          w[i] = p - i >= 0 ? ld_relaxed(&status[(p - i) * radix + d]) : kFlagInc;
        int used = 0;
        bool inclusive = false;
#pragma unroll
        for (int i = 0; i < kLookback; ++i) {
          if (inclusive || used < i || w[i] < kFlagAgg) continue;
          excl += (int)(w[i] & kCountMask);
          inclusive = (w[i] & kFlagInc) != 0;
          used = i + 1;
        }
        if (inclusive) break;
        p -= used;
      }
      st_relaxed(&status[(int64_t)tile * radix + d], kFlagInc | (uint32_t)(excl + total));
    }
    s_start[d] = start;
    s_gofs[d] = gbase + excl - start;
    if (d == radix - 1) s_tile_n = start + total;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (rank[j] < 0) continue;
    const int dg = ((uint32_t)key[j] >> shift) & mask;
    const int at = s_start[dg] + s_warp[warp][dg] + rank[j];
    s_key[at] = key[j];
    s_val[at] = val[j];
  }
  __syncthreads();
  // the tile in digit order: runs of one digit land on consecutive places
  const int tile_n = s_tile_n;
  for (int k = threadIdx.x; k < tile_n; k += kThreads) {
    const int32_t c = s_key[k];
    const int64_t g = (int64_t)s_gofs[((uint32_t)c >> shift) & mask] + k;
    keys_out[g] = c;
    vals_out[g] = s_val[k];
  }
}

// the first sorted place of cell's run, given keys[hi] == cell: gallop
// back, then bisect
__device__ __forceinline__ int64_t run_head(const int32_t* __restrict__ keys, int64_t hi,
                                            int32_t cell) {
  int64_t lo = -1;
  for (int64_t step = 1;; step <<= 1) {
    const int64_t p = hi - step;
    if (p < 0) break;
    if (keys[p] != cell) {
      lo = p;
      break;
    }
    hi = p;
  }
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (keys[mid] == cell)
      hi = mid;
    else
      lo = mid;
  }
  return hi;
}

// one record's lanes v into the accumulators, widths known at compile time
template <int SW, int MW, int NW>
__device__ __forceinline__ void fold_one(const float (&v)[SW + MW + NW], float* as, int32_t* ax,
                                         int32_t* an) {
#pragma unroll
  for (int j = 0; j < SW; ++j) as[j] += v[j];
#pragma unroll
  for (int j = 0; j < MW; ++j) ax[j] = max(ax[j], max_key(v[SW + j]));
#pragma unroll
  for (int j = 0; j < NW; ++j) an[j] = min(an[j], min_key(v[SW + MW + j]));
}

// the lanes of record r, widths known at compile time
template <int SW, int MW, int NW>
__device__ __forceinline__ void load_record(float (&v)[SW + MW + NW], int64_t r,
                                            const float* __restrict__ s_in,
                                            const float* __restrict__ mx_in,
                                            const float* __restrict__ mn_in) {
#pragma unroll
  for (int j = 0; j < SW; ++j) v[j] = s_in[r * SW + j];
#pragma unroll
  for (int j = 0; j < MW; ++j) v[SW + j] = mx_in[r * MW + j];
#pragma unroll
  for (int j = 0; j < NW; ++j) v[SW + MW + j] = mn_in[r * NW + j];
}

// fold the sorted records [head, end) of one cell (record indices
// vals[head..end)), widths known at compile time: a chunk of up to
// kFoldChunk records' indices, then their lanes, are loaded before they
// are added, so the walk waits twice a chunk and not on each record
template <int SW, int MW, int NW>
__device__ __forceinline__ void fold_run_fixed(int32_t cell, int64_t head, int64_t end,
                                               const int32_t* __restrict__ vals,
                                               const float* __restrict__ s_in,
                                               const float* __restrict__ mx_in,
                                               const float* __restrict__ mn_in,
                                               float* __restrict__ sums,
                                               float* __restrict__ maxs,
                                               float* __restrict__ mins) {
  constexpr int L = SW + MW + NW;
  if constexpr (L > 0) {
    float as[SW > 0 ? SW : 1];
    int32_t ax[MW > 0 ? MW : 1], an[NW > 0 ? NW : 1];
#pragma unroll
    for (int j = 0; j < SW; ++j) as[j] = sums[(int64_t)cell * SW + j];
#pragma unroll
    for (int j = 0; j < MW; ++j) ax[j] = max_key(maxs[(int64_t)cell * MW + j]);
#pragma unroll
    for (int j = 0; j < NW; ++j) an[j] = min_key(mins[(int64_t)cell * NW + j]);
    for (int64_t q = head; q < end; q += kFoldChunk) {
      const int m = end - q < kFoldChunk ? (int)(end - q) : kFoldChunk;
      int32_t r[kFoldChunk];
#pragma unroll
      for (int k = 0; k < kFoldChunk; ++k)
        if (k < m) r[k] = vals[q + k];
      float v[kFoldChunk][L];
#pragma unroll
      for (int k = 0; k < kFoldChunk; ++k)
        if (k < m) load_record<SW, MW, NW>(v[k], r[k], s_in, mx_in, mn_in);
#pragma unroll
      for (int k = 0; k < kFoldChunk; ++k)
        if (k < m) fold_one<SW, MW, NW>(v[k], as, ax, an);
    }
#pragma unroll
    for (int j = 0; j < SW; ++j) sums[(int64_t)cell * SW + j] = as[j];
#pragma unroll
    for (int j = 0; j < MW; ++j) maxs[(int64_t)cell * MW + j] = from_key(ax[j]);
#pragma unroll
    for (int j = 0; j < NW; ++j) mins[(int64_t)cell * NW + j] = from_key(an[j]);
  }
}

// lane l of record r, widths at run time; kind: 0 sum, 1 max, 2 min
__device__ __forceinline__ float record_lane(int64_t r, int32_t l, int32_t sw, int32_t mw,
                                             int32_t nw, const float* __restrict__ s_in,
                                             const float* __restrict__ mx_in,
                                             const float* __restrict__ mn_in) {
  return l < sw        ? s_in[r * sw + l]
         : l < sw + mw ? mx_in[r * mw + l - sw]
                       : mn_in[r * nw + l - sw - mw];
}

// the same with the widths at run time, kFoldLanes lanes a walk
__device__ __forceinline__ void fold_run_any(int32_t cell, int64_t head, int64_t end,
                                             const int32_t* __restrict__ vals,
                                             const float* __restrict__ s_in,
                                             const float* __restrict__ mx_in,
                                             const float* __restrict__ mn_in, int32_t sw,
                                             int32_t mw, int32_t nw, float* __restrict__ sums,
                                             float* __restrict__ maxs,
                                             float* __restrict__ mins) {
  const int32_t L = sw + mw + nw;
  for (int32_t g0 = 0; g0 < L; g0 += kFoldLanes) {
    int32_t acc[kFoldLanes];
#pragma unroll
    for (int j = 0; j < kFoldLanes; ++j) {
      const int32_t l = g0 + j;
      acc[j] = l < sw        ? __float_as_int(sums[(int64_t)cell * sw + l])
               : l < sw + mw ? max_key(maxs[(int64_t)cell * mw + l - sw])
               : l < L       ? min_key(mins[(int64_t)cell * nw + l - sw - mw])
                             : 0;
    }
    for (int64_t q = head; q < end; ++q) {
      const int64_t r = vals[q];
#pragma unroll
      for (int j = 0; j < kFoldLanes; ++j) {
        const int32_t l = g0 + j;
        if (l >= L) continue;
        const float x = record_lane(r, l, sw, mw, nw, s_in, mx_in, mn_in);
        if (l < sw)
          acc[j] = __float_as_int(__int_as_float(acc[j]) + x);
        else if (l < sw + mw)
          acc[j] = max(acc[j], max_key(x));
        else
          acc[j] = min(acc[j], min_key(x));
      }
    }
#pragma unroll
    for (int j = 0; j < kFoldLanes; ++j) {
      const int32_t l = g0 + j;
      if (l < sw)
        sums[(int64_t)cell * sw + l] = __int_as_float(acc[j]);
      else if (l < sw + mw)
        maxs[(int64_t)cell * mw + l - sw] = from_key(acc[j]);
      else if (l < L)
        mins[(int64_t)cell * nw + l - sw - mw] = from_key(acc[j]);
    }
  }
}

// a long run [head, end) of one cell folded by the whole warp, widths
// known at compile time: each round every lane loads kWarpBatch records
// (their indices coalesced, the next round's loads in flight), takes
// their maxes and mins into its own accumulators, and every lane adds
// the round's records into the sums in record order, each value from its
// lane by a shuffle; lane 0 writes the cell
template <int SW, int MW, int NW>
__device__ __forceinline__ void warp_fold_fixed(int32_t cell, int64_t head, int64_t end,
                                                const int32_t* __restrict__ vals,
                                                const float* __restrict__ s_in,
                                                const float* __restrict__ mx_in,
                                                const float* __restrict__ mn_in,
                                                float* __restrict__ sums,
                                                float* __restrict__ maxs,
                                                float* __restrict__ mins) {
  constexpr int L = SW + MW + NW;
  if constexpr (L > 0) {
    const int lane = threadIdx.x & 31;
    float as[SW > 0 ? SW : 1];
    int32_t ax[MW > 0 ? MW : 1], an[NW > 0 ? NW : 1];
#pragma unroll
    for (int j = 0; j < SW; ++j) as[j] = sums[(int64_t)cell * SW + j];
#pragma unroll
    for (int j = 0; j < MW; ++j) ax[j] = max_key(maxs[(int64_t)cell * MW + j]);
#pragma unroll
    for (int j = 0; j < NW; ++j) an[j] = min_key(mins[(int64_t)cell * NW + j]);
    // two rounds in flight: the next round's lanes, the one after's indices
    constexpr int kRound = 32 * kWarpBatch;
    float v[kWarpBatch][L];
    int32_t nidx[kWarpBatch];
#pragma unroll
    for (int r = 0; r < kWarpBatch; ++r) {
      const int64_t q = head + r * 32 + lane;
      if (q < end) load_record<SW, MW, NW>(v[r], vals[q], s_in, mx_in, mn_in);
      nidx[r] = q + kRound < end ? vals[q + kRound] : 0;
    }
    for (int64_t q0 = head; q0 < end; q0 += kRound) {
      float w[kWarpBatch][L];
#pragma unroll
      for (int r = 0; r < kWarpBatch; ++r) {
        const int64_t q = q0 + kRound + r * 32 + lane;
        if (q < end) load_record<SW, MW, NW>(w[r], nidx[r], s_in, mx_in, mn_in);
        nidx[r] = q + kRound < end ? vals[q + kRound] : 0;
      }
#pragma unroll
      for (int r = 0; r < kWarpBatch; ++r) {
        const int64_t qr = q0 + r * 32;
        if (qr + lane < end) {
#pragma unroll
          for (int j = 0; j < MW; ++j) ax[j] = max(ax[j], max_key(v[r][SW + j]));
#pragma unroll
          for (int j = 0; j < NW; ++j) an[j] = min(an[j], min_key(v[r][SW + MW + j]));
        }
        if constexpr (SW > 0) {
          const int cnt = end - qr < 32 ? (int)(end - qr) : 32;
#pragma unroll
          for (int src = 0; src < 32; ++src) {
#pragma unroll
            for (int j = 0; j < SW; ++j) {
              const float x = __shfl_sync(0xffffffffu, v[r][j], src);
              if (src < cnt) as[j] += x;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kWarpBatch; ++r)
#pragma unroll
        for (int e = 0; e < L; ++e) v[r][e] = w[r][e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < MW; ++j) ax[j] = max(ax[j], __shfl_xor_sync(0xffffffffu, ax[j], o));
#pragma unroll
      for (int j = 0; j < NW; ++j) an[j] = min(an[j], __shfl_xor_sync(0xffffffffu, an[j], o));
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < SW; ++j) sums[(int64_t)cell * SW + j] = as[j];
#pragma unroll
      for (int j = 0; j < MW; ++j) maxs[(int64_t)cell * MW + j] = from_key(ax[j]);
#pragma unroll
      for (int j = 0; j < NW; ++j) mins[(int64_t)cell * NW + j] = from_key(an[j]);
    }
  }
}

// the same with the widths at run time, one lane of the record a walk
__device__ __forceinline__ void warp_fold_any(int32_t cell, int64_t head, int64_t end,
                                              const int32_t* __restrict__ vals,
                                              const float* __restrict__ s_in,
                                              const float* __restrict__ mx_in,
                                              const float* __restrict__ mn_in, int32_t sw,
                                              int32_t mw, int32_t nw, float* __restrict__ sums,
                                              float* __restrict__ maxs,
                                              float* __restrict__ mins) {
  const int lane = threadIdx.x & 31;
  const int32_t L = sw + mw + nw;
  for (int32_t l = 0; l < L; ++l) {
    const int kind = l < sw ? 0 : l < sw + mw ? 1 : 2;  // sum, max, min
    int32_t acc = kind == 0   ? __float_as_int(sums[(int64_t)cell * sw + l])
                  : kind == 1 ? max_key(maxs[(int64_t)cell * mw + l - sw])
                              : min_key(mins[(int64_t)cell * nw + l - sw - mw]);
    for (int64_t q0 = head; q0 < end; q0 += 32) {
      const int64_t q = q0 + lane;
      const float x = q < end ? record_lane(vals[q], l, sw, mw, nw, s_in, mx_in, mn_in) : 0.0f;
      if (kind == 0) {
        const int cnt = end - q0 < 32 ? (int)(end - q0) : 32;
        float a = __int_as_float(acc);
#pragma unroll
        for (int src = 0; src < 32; ++src) {
          const float y = __shfl_sync(0xffffffffu, x, src);
          if (src < cnt) a += y;
        }
        acc = __float_as_int(a);
      } else if (q < end) {
        acc = kind == 1 ? max(acc, max_key(x)) : min(acc, min_key(x));
      }
    }
    if (kind != 0) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int32_t y = __shfl_xor_sync(0xffffffffu, acc, o);
        acc = kind == 1 ? max(acc, y) : min(acc, y);
      }
    }
    if (lane == 0) {
      if (kind == 0)
        sums[(int64_t)cell * sw + l] = __int_as_float(acc);
      else if (kind == 1)
        maxs[(int64_t)cell * mw + l - sw] = from_key(acc);
      else
        mins[(int64_t)cell * nw + l - sw - mw] = from_key(acc);
    }
  }
}

// SW < 0: the widths come at run time (sw, mw, nw)
template <int SW, int MW, int NW>
__global__ void __launch_bounds__(kThreads)
    lanes_fold_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
                      const float* __restrict__ s_in, const float* __restrict__ mx_in,
                      const float* __restrict__ mn_in, const int32_t* __restrict__ ctrl, int32_t sw, int32_t mw, int32_t nw,
                      int32_t* __restrict__ counts, float* __restrict__ sums,
                      float* __restrict__ maxs, float* __restrict__ mins) {
  const int64_t nv = ctrl[kCtrlValid];
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  // a warp's 32 spans a round, so its threads meet at the warp folds
  for (int64_t t0 = (int64_t)blockIdx.x * kThreads + (threadIdx.x - lane); t0 * kFoldSpan < nv;
       t0 += stride) {
    const int64_t a = (t0 + lane) * kFoldSpan;
    const int64_t b = a + kFoldSpan < nv ? a + kFoldSpan : nv;
    bool has_long = false;  // at most one a span: a long run covers its start
    int32_t long_cell = 0;
    long long long_head = 0, long_end = 0;
    for (int64_t k = a; k < b;) {
      const int32_t cell = keys[k];
      int64_t e = k + 1;  // the run's end, or b
      while (e < b && keys[e] == cell) ++e;
      if (e == b && b < nv && keys[b] == cell) break;  // a later span folds it
      const int64_t head = k == a && a > 0 && keys[a - 1] == cell ? run_head(keys, a - 1, cell) : k;
      if (e - head > kLongRun) {
        has_long = true;
        long_cell = cell;
        long_head = head;
        long_end = e;
      } else {
        counts[cell] += (int32_t)(e - head);
        if constexpr (SW >= 0)
          fold_run_fixed<SW, MW, NW>(cell, head, e, vals, s_in, mx_in, mn_in, sums, maxs, mins);
        else
          fold_run_any(cell, head, e, vals, s_in, mx_in, mn_in, sw, mw, nw, sums, maxs, mins);
      }
      k = e;
    }
    for (uint32_t pend = __ballot_sync(0xffffffffu, has_long); pend; pend &= pend - 1) {
      const int src = __ffs(pend) - 1;
      const int32_t cell = __shfl_sync(0xffffffffu, long_cell, src);
      const int64_t head = __shfl_sync(0xffffffffu, long_head, src);
      const int64_t end = __shfl_sync(0xffffffffu, long_end, src);
      if (lane == 0) counts[cell] += (int32_t)(end - head);
      if constexpr (SW >= 0)
        warp_fold_fixed<SW, MW, NW>(cell, head, end, vals, s_in, mx_in, mn_in, sums, maxs,
                                    mins);
      else
        warp_fold_any(cell, head, end, vals, s_in, mx_in, mn_in, sw, mw, nw, sums, maxs, mins);
    }
  }
}

template <int SW, int MW, int NW>
bool fold_if(int32_t sw, int32_t mw, int32_t nw, int32_t blocks, cudaStream_t s,
             const int32_t* keys, const int32_t* vals, const float* s_in, const float* mx_in,
             const float* mn_in, const int32_t* ctrl, int32_t* counts, float* sums, float* maxs,
             float* mins) {
  if (SW >= 0 && (sw != SW || mw != MW || nw != NW)) return false;
  lanes_fold_kernel<SW, MW, NW><<<blocks, kThreads, 0, s>>>(
      keys, vals, s_in, mx_in, mn_in, ctrl, sw, mw, nw, counts, sums, maxs, mins);
  return true;
}

// ---- L3: scatter_pair_lanes ------------------------------------------------
// One host-combined row per distinct (slot, ring column) pair:
// [pair, count, f32 bits of each pre-summed sum lane]; pair < 0 marks
// padding and touches nothing, a pair at or past n_cells sets
// kErrPairLanes. The host's combine makes the pairs of one upload
// distinct, so each cell takes at most one add per launch: a sum is one
// plain add, no atomics (the int count takes an integer RED anyway, exact
// in any order).
//
// Bound: bytes — the rows once and one read-modify-write of each touched
// cell's count and sums; at ~110k pairs that is under a microsecond of
// HBM time, so the kernel is bound by latency: a row's load, then its
// cell's sum load, then the store, over random sectors when the pairs
// come in the C combine's first-seen order (the numpy lane's ascending
// order keeps a warp's cells together). Design: each warp copies its 32
// rows into shared memory with coalesced 16-byte loads, then each thread
// folds one row: the count's RED, then every sum load before any add.
// One row a thread measured faster than four with all their loads in
// flight (PERF.md §6): more threads keep more random sectors in
// flight. Widths 0, 1 and 4 (the main paths' avg and sum layouts) are
// compile-time; any other takes the run-time kernel below, which reads
// each row where it lies. A pair is an int32 (the upload's format); the
// sums' and the rows' offsets are 64-bit, so a state of 2^31 words or
// more takes the same path.
constexpr int kPairThreads = 128;
constexpr int kPairWarps = kPairThreads / 32;

__device__ __forceinline__ bool pair_in_state(int32_t pair, int64_t n_cells,
                                              int32_t* __restrict__ err) {
  if (pair < 0) return false;
  if (pair >= n_cells) {
    atomicOr(err, kErrPairLanes);
    return false;
  }
  return true;
}

template <int SW>
__global__ void __launch_bounds__(kPairThreads)
    pair_lanes_kernel(const int32_t* __restrict__ buf, int32_t P, int64_t n_cells,
                      int32_t* __restrict__ counts, float* __restrict__ sums,
                      int32_t* __restrict__ err) {
  constexpr int C = 2 + SW;
  constexpr int kWarpWords = 32 * C;  // a multiple of 4
  __shared__ __align__(16) int32_t stage[kPairWarps][kWarpWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* rows = stage[warp];
  const int32_t n_blocks = (P + 31) / 32;
  const bool aligned = ((uintptr_t)buf & 15) == 0;
  for (int32_t b = blockIdx.x * kPairWarps + warp; b < n_blocks; b += gridDim.x * kPairWarps) {
    const int32_t n = min(32, P - b * 32);
    const int32_t* src = buf + (int64_t)b * kWarpWords;
    if (n == 32 && aligned) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(rows);
#pragma unroll
      for (int i = lane; i < kWarpWords / 4; i += 32) d4[i] = s4[i];
    } else {
      for (int i = lane; i < n * C; i += 32) rows[i] = src[i];
    }
    __syncwarp();
    const int32_t* row = rows + lane * C;
    const int32_t pair = lane < n ? row[0] : -1;
    if (pair_in_state(pair, n_cells, err)) {
      atomicAdd(&counts[pair], row[1]);
      float cur[SW > 0 ? SW : 1];
#pragma unroll
      for (int s = 0; s < SW; ++s) cur[s] = sums[(int64_t)pair * SW + s];
#pragma unroll
      for (int s = 0; s < SW; ++s)
        sums[(int64_t)pair * SW + s] = cur[s] + __int_as_float(row[2 + s]);
    }
    __syncwarp();  // the stage is rewritten next round
  }
}

// any other width: one row a thread, read where it lies
__global__ void __launch_bounds__(kPairThreads)
    pair_lanes_any_kernel(const int32_t* __restrict__ buf, int32_t P, int32_t C,
                          int64_t n_cells, int32_t* __restrict__ counts,
                          float* __restrict__ sums, int32_t sw, int32_t* __restrict__ err) {
  for (int32_t p = blockIdx.x * kPairThreads + threadIdx.x; p < P; p += gridDim.x * kPairThreads) {
    const int32_t* row = buf + (int64_t)p * C;
    const int32_t pair = row[0];
    if (!pair_in_state(pair, n_cells, err)) continue;
    atomicAdd(&counts[pair], row[1]);
    for (int32_t s = 0; s < sw; ++s) sums[(int64_t)pair * sw + s] += __int_as_float(row[2 + s]);
  }
}

template <int SW>
bool pair_lanes_if(int32_t sw, const int32_t* buf, int32_t P, int64_t n_cells, int32_t* counts,
                   float* sums, int32_t* err, cudaStream_t s) {
  if (sw != SW) return false;
  const int64_t blocks = ((int64_t)P + kPairThreads - 1) / kPairThreads;
  pair_lanes_kernel<SW><<<(int)(blocks < kMaxBlocks ? blocks : kMaxBlocks), kPairThreads, 0, s>>>(
      buf, P, n_cells, counts, sums, err);
  return true;
}

}  // namespace

extern "C" {

const char* lk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// scratch: wc (rows * W int32), block_counts (ceil(rows * W / kTile) int32)
int lk_fire_pack(const int32_t* counts, int64_t rows, int32_t ring, const float* sums, int32_t sw,
                 const float* maxs, int32_t mw, const float* mins, int32_t nw,
                 const int64_t* end_panes, const uint8_t* w_valid, int32_t W, int64_t pane_lo,
                 int64_t pane_hi, int32_t ppw, const uint8_t* used, int32_t* out,
                 int32_t out_cols, int32_t out_cap, int32_t packed2, int32_t row_offset,
                 float* lanes, int32_t* wc,
                 int32_t* block_counts, int32_t* err, void* stream) {
  const int64_t K = rows * (int64_t)W;
  if (K <= 0) return (int)cudaGetLastError();
  const int32_t n_blocks = compact_blocks(K);
  cudaStream_t s = (cudaStream_t)stream;
  fire_count_kernel<<<n_blocks, kThreads, 0, s>>>(counts, rows, ring, end_panes, w_valid, W,
                                                  pane_lo, pane_hi, ppw, used, wc, block_counts);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  fire_write_kernel<<<n_blocks, kThreads, 0, s>>>(wc, rows, W, used, block_counts, n_blocks,
                                                  end_panes, pane_lo, pane_hi, ppw, ring, sums,
                                                  sw, maxs, mw, mins, nw, out, out_cols, out_cap,
                                                  packed2, row_offset, lanes, err);
  return (int)cudaGetLastError();
}

// the plan (lane_kernels.py _scatter_plan): passes digit passes of
// digit_bits each over tiles of kSortTile records (a hist block and a
// sort block a tile), fold_blocks fold blocks; work: the zeroed region
// (the ctrl block, then passes * tiles << digit_bits look-back words),
// zero_ints long; keys0, vals0, keys1, vals1: n int32 each
int lk_scatter_lanes(int32_t* counts, float* sums, int32_t sw, float* maxs, int32_t mw,
                     float* mins, int32_t nw, int64_t n_cells, const int32_t* idx,
                     const float* s_in, const float* mx_in, const float* mn_in, int64_t n,
                     int32_t skip_negative, int32_t passes, int32_t digit_bits, int32_t tiles,
                     int32_t fold_blocks, int32_t* work, int64_t zero_ints, int32_t* keys0,
                     int32_t* vals0, int32_t* keys1, int32_t* vals1, int32_t* err,
                     void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t status_pass = (int64_t)tiles << digit_bits;
  if (passes < 1 || passes > kMaxPasses || digit_bits < 1 || digit_bits > kMaxDigitBits ||
      (int64_t)tiles * kSortTile < n || n > (int64_t)kCountMask ||
      zero_ints < kCtrlInts + passes * status_pass || fold_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaMemsetAsync(work, 0, (size_t)zero_ints * sizeof(int32_t), s);
  if (rc) return rc;
  lanes_hist_kernel<<<tiles, kThreads, 0, s>>>(idx, n, n_cells, skip_negative, passes, digit_bits,
                                               work, err);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  uint32_t* status = (uint32_t*)(work + kCtrlInts);
  const int32_t* k_in = idx;
  const int32_t* v_in = nullptr;
  for (int32_t p = 0; p < passes; ++p) {
    int32_t* k_out = p % 2 ? keys1 : keys0;
    int32_t* v_out = p % 2 ? vals1 : vals0;
    auto* kernel = p ? &lanes_sort_kernel<false> : &lanes_sort_kernel<true>;
    kernel<<<tiles, kThreads, 0, s>>>(k_in, v_in, n, n_cells, p, digit_bits, work,
                                      status + p * status_pass, k_out, v_out);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    k_in = k_out;
    v_in = v_out;
  }
  // the main paths' widths at compile time (window-wordcount's sum, job
  // T, the bid aggregates, job C's changelog), any other at run time
#define LK_FOLD(a, b, c)                                                                   \
  fold_if<a, b, c>(sw, mw, nw, fold_blocks, s, k_in, v_in, s_in, mx_in, mn_in, work, counts, \
                   sums, maxs, mins)
  if (!LK_FOLD(1, 0, 0) && !LK_FOLD(1, 1, 0) && !LK_FOLD(1, 1, 1) && !LK_FOLD(4, 0, 0))
    LK_FOLD(-1, -1, -1);
#undef LK_FOLD
  return (int)cudaGetLastError();
}

// the wrapper's argument block (lane_kernels.py _PAIR_ARGS), every field
// 64 bits
struct PairArgs {
  int64_t counts, sums, sw, n_cells, buf, P, C, err;
};

int lk_scatter_pair_lanes(const PairArgs* a, void* stream) {
  int32_t* counts = (int32_t*)a->counts;
  float* sums = (float*)a->sums;
  int32_t* err = (int32_t*)a->err;
  const int32_t* buf = (const int32_t*)a->buf;
  const int64_t sw = a->sw, n_cells = a->n_cells, P = a->P, C = a->C;
  if (P <= 0) return (int)cudaGetLastError();
  if (sw < 0 || sw >= (1ll << 31) || C != 2 + sw || P >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t p = (int32_t)P;
  const int64_t cells = n_cells;
  if (!pair_lanes_if<1>(sw, buf, p, cells, counts, sums, err, s) &&
      !pair_lanes_if<0>(sw, buf, p, cells, counts, sums, err, s) &&
      !pair_lanes_if<4>(sw, buf, p, cells, counts, sums, err, s)) {
    const int64_t blocks = ((int64_t)P + kPairThreads - 1) / kPairThreads;
    pair_lanes_any_kernel<<<(int)(blocks < kMaxBlocks ? blocks : kMaxBlocks), kPairThreads, 0,
                            s>>>(buf, p, (int32_t)C, cells, counts, sums, (int32_t)sw, err);
  }
  return (int)cudaGetLastError();
}

// the lean launch path (window_kernels.py LeanEntry): each entry
// above from one packed block of 64-bit words, the stream beside
// lk_fire_pack from one packed block of 25 64-bit words
int lk_fire_pack_packed(const int64_t* a, void* stream) {
  return lk_fire_pack(
      (const int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2], (const float*)(intptr_t)a[3],
      (int32_t)a[4], (const float*)(intptr_t)a[5], (int32_t)a[6], (const float*)(intptr_t)a[7],
      (int32_t)a[8], (const int64_t*)(intptr_t)a[9], (const uint8_t*)(intptr_t)a[10],
      (int32_t)a[11], (int64_t)a[12], (int64_t)a[13], (int32_t)a[14],
      (const uint8_t*)(intptr_t)a[15], (int32_t*)(intptr_t)a[16], (int32_t)a[17], (int32_t)a[18],
      (int32_t)a[19], (int32_t)a[20], (float*)(intptr_t)a[21], (int32_t*)(intptr_t)a[22],
      (int32_t*)(intptr_t)a[23], (int32_t*)(intptr_t)a[24], stream);
}

// lk_scatter_lanes from one packed block of 25 64-bit words
int lk_scatter_lanes_packed(const int64_t* a, void* stream) {
  return lk_scatter_lanes(
      (int32_t*)(intptr_t)a[0], (float*)(intptr_t)a[1], (int32_t)a[2], (float*)(intptr_t)a[3],
      (int32_t)a[4], (float*)(intptr_t)a[5], (int32_t)a[6], (int64_t)a[7],
      (const int32_t*)(intptr_t)a[8], (const float*)(intptr_t)a[9],
      (const float*)(intptr_t)a[10], (const float*)(intptr_t)a[11], (int64_t)a[12],
      (int32_t)a[13], (int32_t)a[14], (int32_t)a[15], (int32_t)a[16], (int32_t)a[17],
      (int32_t*)(intptr_t)a[18], (int64_t)a[19], (int32_t*)(intptr_t)a[20],
      (int32_t*)(intptr_t)a[21], (int32_t*)(intptr_t)a[22], (int32_t*)(intptr_t)a[23],
      (int32_t*)(intptr_t)a[24], stream);
}

}  // extern "C"
