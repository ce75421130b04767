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

#include "lookback.cuh"
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
// head [n selected, 0, ...]; rows 1..min(n, cap) are [row + row_offset,
// end - pane_lo, count] — or, in the count-only packed2 layout,
// [(row << 8) | delta, count]. ``row_offset`` is a key-sharded operator's
// device block's first global row (flink_tpu/ops/window.py:1552
// fire_shard). The lanes go to a (cap, S + M + m) f32 buffer in the same
// row order; the aggregate's finalize runs on them in torch.
//
// Bound: bytes — the count lane's live columns once, each selected cell's
// lane columns once (the sums row is read whole, since the reference adds
// every column times its mask bit), the output rows once.
//
// Design, one launch, no per-cell scratch in device memory: a block
// takes a tile of tile_cells consecutive cells of the row-major (row,
// window) grid, which spans at most tile_rows rows.
//   1  The tile's rows' count columns, contiguous in memory, and their
//      used flags go into shared memory by cp.async (16 bytes a copy for
//      the aligned body); each window's first live column and run lengths
//      come from a table worked out once a block.
//   2  Each thread counts its consecutive cells from shared memory and
//      selects them; a block scan ranks them in row-major order, and the
//      tile publishes its count at once (lookback.cuh lb_publish).
//   3  With lanes: the rows of the tile that hold a selected cell get
//      their lane rows staged, a warp a row, in flight through step 4.
//   4  The tile's offset among all selected cells comes from
//      lookback.cuh's decoupled look-back in the same launch; the grid's
//      last tile writes the head and advances the workspace's epoch.
//   5  The tile's rows are built in shared memory and stored as one
//      contiguous run, neighbouring threads on neighbouring words.
//   6  With lanes: each thread computes one (cell, lane) output within
//      the cap, in the lanes buffer's order, so the stores coalesce. Sums
//      add every column in column order from 0.0f, each times its 0/1
//      live bit, dead columns included (an inf or NaN there gives NaN, as
//      the reference's column-mask product and the plain version do); max
//      and min fold the live columns only (max_ieee / min_ieee).
// The tile size is the wrapper's (lane_kernels.py _fire_plan): as many
// cells (up to kFireCells) as leave the staged rows within kFireSmem
// bytes of shared memory; a ring too long to stage reads its rows where
// they lie (the plan's stage flags). Row and cell offsets are 64-bit, so
// a state of 2^31 count cells or more takes the same path.
constexpr int kFireItems = 4;                      // cells a thread at most
constexpr int kFireCells = kThreads * kFireItems;  // cells a tile at most
constexpr int kFireWinTable = 64;                  // windows of the block's table
constexpr int kFireSmem = 44 * 1024;  // dynamic shared memory a block (+ static < 48 KB)

struct FireParams {
  const int32_t* counts;
  const float* lane[3];
  int32_t width[3];
  int64_t rows;
  int32_t ring, W, ppw;
  const int64_t* end_panes;
  const uint8_t* w_valid;
  const uint8_t* used;
  int64_t pane_lo, pane_hi;
  int32_t* out;
  int32_t out_cols, out_cap, packed2, row_offset;
  float* lanes;
  int32_t* err;
  uint32_t* epoch;
  unsigned long long* desc;
  int32_t tile_cells, tile_rows, stage_counts, stage_lanes;
  int64_t tiles;
};

__host__ __device__ __forceinline__ int64_t round4(int64_t n) { return (n + 3) / 4 * 4; }

// a staged lane row: each family's columns and one pad word after each,
// the row's stride made odd so neighbouring rows fall on distinct banks
__host__ __device__ __forceinline__ int64_t fire_lane_stride(int64_t ring, int64_t L) {
  const int64_t s = ring * L + 3;
  return s % 2 ? s : s + 1;
}

// the block's shared memory, in 32-bit words: the out rows, then the
// selected cells, the rows' slots, the rows' used flags (bytes, by
// aligned words), the staged count rows (3 words of room for the
// alignment shift; copied as they lie, 16 bytes a copy: an odd row stride
// for distinct banks took 4-byte copies and staged 3.3 x slower at
// WordCount's fire) and the staged lane rows
struct FireLayout {
  int64_t sel, slot, used, cnt, lane, words;
};

__host__ __device__ __forceinline__ FireLayout fire_layout(int64_t cells, int64_t tile_rows,
                                                           int64_t ring, int64_t L, int64_t cols,
                                                           bool stage_counts, bool stage_lanes) {
  FireLayout f;
  f.sel = round4(cells * cols);
  f.slot = f.sel + (L ? round4(cells) : 0);
  f.used = f.slot + (L && stage_lanes ? round4(tile_rows) : 0);
  f.cnt = f.used + round4((tile_rows + 6) / 4 + 1);
  f.lane = f.cnt + (stage_counts ? round4(tile_rows * ring + 3) : 0);
  f.words = f.lane + (L && stage_lanes ? tile_rows * fire_lane_stride(ring, L) : 0);
  return f;
}

// a window's live columns, mod ring: the count's [c0, c0 + ncnt) (0 for
// an invalid window) and the lanes' [c0, c0 + span] (span -1: none);
// delta = end - pane_lo
struct FireWin {
  int32_t c0, ncnt, span, delta;
};

__device__ __forceinline__ FireWin fire_window(const FireParams& p, int32_t w, int64_t hi_cap) {
  const int64_t e = p.end_panes[w];
  const int64_t lo = e - p.ppw > p.pane_lo ? e - p.ppw : p.pane_lo;
  const int64_t hc = e - 1 < hi_cap ? e - 1 : hi_cap;
  const int64_t hl = e - 1 < p.pane_hi ? e - 1 : p.pane_hi;
  const int64_t span = hl - lo;
  FireWin f;
  f.c0 = (int32_t)floor_mod(lo, p.ring);
  f.ncnt = p.w_valid[w] && lo <= hc ? (int32_t)(hc - lo + 1) : 0;
  f.span = span < 0 ? -1 : (span >= p.ring - 1 ? p.ring - 1 : (int32_t)span);
  f.delta = (int32_t)(e - p.pane_lo);
  return f;
}

// the column-order sum of x's ring columns (stride wf), each times its
// live bit: live are [c0, c0 + span] mod ring
__device__ __forceinline__ float fire_sum(const float* x, int32_t wf, int32_t ring, int32_t c0,
                                          int32_t span) {
  const int32_t end = c0 + span + 1;
  const int32_t e1 = end > ring ? end - ring : 0, e3 = end < ring ? end : ring;
  float acc = 0.0f;
  int32_t c = 0;
  for (; c < e1; ++c) acc += x[c * wf] * 1.0f;
  for (; c < c0; ++c) acc += x[c * wf] * 0.0f;
  for (; c < e3; ++c) acc += x[c * wf] * 1.0f;
  for (; c < ring; ++c) acc += x[c * wf] * 0.0f;
  return acc;
}

// the IEEE maximum (kMax) or minimum of the live columns only
template <bool kMax>
__device__ __forceinline__ float fire_fold(const float* x, int32_t wf, int32_t ring, int32_t c0,
                                           int32_t span) {
  const int32_t end = c0 + span + 1;
  const int32_t e1 = end > ring ? end - ring : 0, e3 = end < ring ? end : ring;
  float acc = kMax ? -INFINITY : INFINITY;
  for (int32_t c = 0; c < e1; ++c)
    acc = kMax ? max_ieee(acc, x[c * wf]) : min_ieee(acc, x[c * wf]);
  for (int32_t c = c0; c < e3; ++c)
    acc = kMax ? max_ieee(acc, x[c * wf]) : min_ieee(acc, x[c * wf]);
  return acc;
}

// a window's table entry: from the block's table (kTable: W <=
// kFireWinTable) or worked out where it is used (a run-time choice let
// the compiler load both sides)
template <bool kTable>
__device__ __forceinline__ FireWin fire_win(const FireParams& p, const FireWin* s_win, int32_t w,
                                            int64_t hi_cap) {
  if constexpr (kTable)
    return s_win[w];
  else
    return fire_window(p, w, hi_cap);
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads) fire_pack_kernel(const FireParams p) {
  extern __shared__ __align__(16) uint32_t fire_smem[];
  __shared__ FireWin s_win[kFireWinTable];
  __shared__ int s_scan[kWarps];
  __shared__ int s_total, s_slots, s_min[kWarps];
  __shared__ long long s_sum[kWarps];
  __shared__ uint32_t s_epoch;
  const int64_t tile = blockIdx.x;
  const int32_t W = p.W, ring = p.ring, C = p.tile_cells;
  const int32_t L = p.width[0] + p.width[1] + p.width[2];
  const int cols = p.out_cols;
  const bool stage_lanes = L && p.stage_lanes;
  const int64_t a = tile * C, K = p.rows * (int64_t)W;
  const int32_t nc = (int32_t)(K - a < C ? K - a : C);
  const int64_t r_lo = a / W;
  const int32_t a_off = (int32_t)(a - r_lo * W);  // the tile's first window
  const int32_t nr = (a_off + nc - 1) / W + 1;    // the rows it spans
  const FireLayout lay = fire_layout(C, p.tile_rows, ring, L, cols, p.stage_counts, stage_lanes);
  int32_t* s_out = (int32_t*)fire_smem;
  int32_t* s_sel = (int32_t*)fire_smem + lay.sel;
  int32_t* s_slot = (int32_t*)fire_smem + lay.slot;
  float* s_lane = (float*)fire_smem + lay.lane;
  const int64_t hi_cap = live_hi_cap(p.pane_lo, p.pane_hi, ring);

  // 1: the count rows in flight, then this thread's rows' used flags, the
  // window table and the rows' flags while they land
  const int32_t* crow = p.counts + r_lo * ring;
  const int32_t* cnt = crow;
  if (p.stage_counts)
    cnt = (const int32_t*)fire_smem + lay.cnt +
          stage_words(fire_smem + lay.cnt, (const uint32_t*)crow, (int64_t)nr * ring);
  // the rows' used flags: their bytes by aligned words (the words around
  // them lie in the same allocation)
  const uint8_t* ub = p.used + r_lo;
  const int ushift = (int)((uintptr_t)ub & 3);
  const uint32_t* uw = (const uint32_t*)(ub - ushift);
  for (int32_t i = threadIdx.x; i < (ushift + nr + 3) / 4; i += kThreads)
    cp_async_4(fire_smem + lay.used + i, uw + i);
  const uint8_t* s_used = (const uint8_t*)(fire_smem + lay.used) + ushift;
  const int32_t ipt = (C + kThreads - 1) / kThreads;
  const int32_t first = threadIdx.x * ipt;
  const int32_t x0 = a_off + first;
  const int32_t rl0 = x0 / W, w0 = x0 - rl0 * W;
  if (kTable)
    for (int32_t w = threadIdx.x; w < W; w += kThreads) s_win[w] = fire_window(p, w, hi_cap);
  if (stage_lanes)
    for (int32_t r = threadIdx.x; r < nr; r += kThreads) s_slot[r] = 0;
  if (threadIdx.x == 0) s_epoch = *(volatile const uint32_t*)p.epoch;
  cp_async_wait();
  __syncthreads();
  const uint32_t epoch = s_epoch;

  // 2: count and select this thread's cells
  int32_t v[kFireItems];
  uint32_t sel = 0;
  {
    int32_t rl = rl0, w = w0;
#pragma unroll
    for (int j = 0; j < kFireItems; ++j) {
      v[j] = 0;
      if (j < ipt && first + j < nc && s_used[rl]) {
        const FireWin f = fire_win<kTable>(p, s_win, w, hi_cap);
        const int32_t* row = cnt + (int64_t)rl * ring;
        const int32_t end = f.c0 + f.ncnt, e3 = end < ring ? end : ring;
        int32_t c = 0;
        for (int32_t k = f.c0; k < e3; ++k) c += row[k];
        for (int32_t k = 0; k < end - ring; ++k) c += row[k];
        v[j] = c;
        if (c > 0) sel |= 1u << j;
      }
      if (++w == W) {
        w = 0;
        ++rl;
      }
    }
  }
  const int before = block_scan_total(__popc(sel), s_scan, &s_total);
  const int32_t tile_n = s_total;
  lb_publish(p.desc, tile, tile_n, epoch);

  // 3: with lanes, each selected cell's place and the lane rows of the
  // tile's rows that hold one, in flight through the look-back
  // a staged lane row: each family's columns from base_f, then a pad word
  const int32_t sw = p.width[0], mw = p.width[1];
  const int64_t stride = fire_lane_stride(ring, L);
  const int64_t base_m = (int64_t)ring * sw + 1, base_n = base_m + (int64_t)ring * mw + 1;
  if (L && tile_n > 0) {  // uniform over the block
    int32_t rl = rl0, q = before;
#pragma unroll
    for (int j = 0; j < kFireItems; ++j) {
      if ((sel >> j) & 1) {
        s_sel[q++] = first + j;
        if (stage_lanes) s_slot[rl] = 1;
      }
      rl += (w0 + j + 1) % W == 0;
    }
    __syncthreads();
    if (stage_lanes) {
      // the flagged rows' slots, in row order
      const int32_t per = (nr + kThreads - 1) / kThreads, r0 = threadIdx.x * per;
      int flagged = 0;
      for (int32_t i = 0; i < per && r0 + i < nr; ++i) flagged += s_slot[r0 + i];
      int slot = block_scan_total(flagged, s_scan, &s_slots);
      for (int32_t i = 0; i < per && r0 + i < nr; ++i)
        s_slot[r0 + i] = s_slot[r0 + i] ? slot++ : -1;
      __syncthreads();
      // a warp a row: each family's columns, coalesced
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      for (int32_t r = warp; r < nr; r += kWarps) {
        const int32_t sl = s_slot[r];
        if (sl < 0) continue;
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const int64_t n = (int64_t)ring * p.width[f];
          const float* src = p.lane[f] + (r_lo + r) * n;
          float* d = s_lane + sl * stride + (f == 0 ? 0 : f == 1 ? base_m : base_n);
          for (int64_t e = lane; e < n; e += 32) cp_async_4(d + e, src + e);
        }
      }
    }
  }

  // 4: the tile's place among all selected cells; the last tile's head
  // and the next call's epoch
  const long long excl = lookback_exclusive(p.desc, tile, tile_n, epoch, s_sum, s_min);
  if (tile == p.tiles - 1 && threadIdx.x == 0) {
    const long long all = excl + tile_n;
    p.out[0] = (int32_t)all;
    for (int c = 1; c < cols; ++c) p.out[c] = 0;
    if (all > p.out_cap) atomicOr(p.err, kErrFireCap);
    lb_advance(p.epoch, epoch);
  }
  const long long room = p.out_cap - excl;
  const int32_t n_w = room <= 0 ? 0 : (room < tile_n ? (int32_t)room : tile_n);

  if (n_w > 0) {  // uniform over the block
    // 5: the rows, built in shared memory, stored as one run
    int32_t rl = rl0, w = w0, q = before;
#pragma unroll
    for (int j = 0; j < kFireItems; ++j) {
      if (((sel >> j) & 1) && q < n_w) {
        const int32_t delta = fire_win<kTable>(p, s_win, w, hi_cap).delta;
        const int32_t r = (int32_t)(r_lo + rl);
        int32_t* d = s_out + q * cols;
        if (p.packed2) {
          d[0] = (r << 8) | delta;
          d[1] = v[j];
        } else {
          d[0] = r + p.row_offset;
          d[1] = delta;
          d[2] = v[j];
        }
      }
      q += (sel >> j) & 1;
      if (++w == W) {
        w = 0;
        ++rl;
      }
    }
    __syncthreads();
    int32_t* dst = p.out + (excl + 1) * cols;
    for (int32_t i = threadIdx.x; i < n_w * cols; i += kThreads) dst[i] = s_out[i];

    // 6: the lanes, one (cell, lane) output a thread, in the buffer's order
    if (L) {
      cp_async_wait();
      __syncthreads();
      float* lo_out = p.lanes + excl * L;
      for (int32_t e = threadIdx.x; e < n_w * L; e += kThreads) {
        const int32_t qi = e / L, l = e - qi * L;
        const int32_t x = a_off + s_sel[qi];
        const int32_t rr = x / W, ww = x - rr * W;
        const FireWin f = fire_win<kTable>(p, s_win, ww, hi_cap);
        // the lane's family, index in it and width, by selects (an index
        // into the parameter block would copy it to local memory)
        const int fam = l < sw ? 0 : l < sw + mw ? 1 : 2;
        const int32_t j = fam == 0 ? l : fam == 1 ? l - sw : l - sw - mw;
        const int32_t wf = fam == 0 ? sw : fam == 1 ? mw : p.width[2];
        const float* xs =
            stage_lanes
                ? s_lane + s_slot[rr] * stride + (fam == 0 ? 0 : fam == 1 ? base_m : base_n) + j
                : (fam == 0 ? p.lane[0] : fam == 1 ? p.lane[1] : p.lane[2]) +
                      (r_lo + rr) * ring * wf + j;
        lo_out[e] = fam == 0   ? fire_sum(xs, wf, ring, f.c0, f.span)
                    : fam == 1 ? fire_fold<true>(xs, wf, ring, f.c0, f.span)
                               : fire_fold<false>(xs, wf, ring, f.c0, f.span);
      }
    }
  }

  cp_async_wait();  // a tile past the cap may still have lane rows in flight
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
//      zeroed ctrl block. idx is the flat int32 cells, or the split
//      upload's 3 bytes a record decoded where H and the first S pass load
//      them (SplitCells: window_common.cuh's SplitRecords, K7's rule and
//      error bit, so no cell array and no split_cells launch; H reads a
//      thread's 16 consecutive records by 16-byte loads).
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

// Where H and the first S pass read a record's cell: the flat int32 cells
// (an index outside the state sets kErrScatterLanes; a negative one is an
// invalid record under skip_negative), or the split upload's 3 bytes
// (K7's decode and kErrSplitCell; slot 0xFFFF folds into the dump row, as
// its split_cells cell did). load() is record i's raw word (read-only
// loads: the first pass keeps every load of its 16 rounds in flight
// across its shared-memory stores), cell() H's cell or -1 for a record
// that touches nothing (bad set when it is outside the state), key() the
// first pass's cell or -1 (H reported the bad ones). kWide: H, which only
// counts, takes a thread's 16 consecutive records by three 16-byte loads
// (SplitRecords::load16; a thread's 48 byte loads measured 0.0014 ms
// slower at job (a)'s batch, the tile staged in shared memory 0.0011); the
// first pass keeps the records' order and their byte loads (its rounds
// wait on their scans, not on the loads).
struct FlatCells {
  const int32_t* idx;
  int64_t n_cells;
  int32_t skip_negative;
  static constexpr int32_t kErr = kErrScatterLanes;
  static constexpr bool kWide = false;

  __device__ __forceinline__ int32_t load(int64_t i) const { return __ldg(idx + i); }
  __device__ __forceinline__ int32_t cell(int32_t c, bool& bad) const {
    if (c < 0 && skip_negative) return -1;
    if (c < 0 || (int64_t)c >= n_cells) {
      bad = true;
      return -1;
    }
    return c;
  }
  __device__ __forceinline__ int32_t key(int32_t c) const {
    return (int64_t)c < n_cells ? c : -1;
  }
};

struct SplitCells {
  SplitRecords rec;
  static constexpr int32_t kErr = kErrSplitCell;
  static constexpr bool kWide = true;

  __device__ __forceinline__ int32_t load(int64_t i) const { return (int32_t)rec.load(i); }
  __device__ __forceinline__ int32_t cell(int32_t v, bool& bad) const {
    const int32_t c = rec.cell(v);
    if (c < 0) bad = true;
    return c;
  }
  __device__ __forceinline__ int32_t key(int32_t v) const { return rec.cell(v); }
};

template <class Src>
__global__ void __launch_bounds__(kThreads)
    lanes_hist_kernel(const Src src, int64_t n, int32_t passes, int32_t digit_bits,
                      int32_t* __restrict__ ctrl, int32_t* __restrict__ err) {
  __shared__ int s_h[kMaxPasses * kMaxRadix];
  __shared__ long long s_sum[kWarps];
  for (int e = threadIdx.x; e < kMaxPasses * kMaxRadix; e += kThreads) s_h[e] = 0;
  __syncthreads();
  const uint32_t mask = (1u << digit_bits) - 1u;
  // block b reads the records of sort tile b, all its loads in flight
  // before the first count: a thread's records j * kThreads + threadIdx.x
  // of the tile, or with kWide its kSortItems consecutive ones
  const int64_t base = (int64_t)blockIdx.x * kSortTile + threadIdx.x;
  const int64_t wide0 = (int64_t)blockIdx.x * kSortTile + (int64_t)threadIdx.x * kSortItems;
  int32_t v[kSortItems];
  if constexpr (Src::kWide) {
    static_assert(kSortItems == 16, "load16 takes 16 records");
    src.rec.load16(wide0, n, v);
  } else {
#pragma unroll
    for (int j = 0; j < kSortItems; ++j) {
      const int64_t i = base + (int64_t)j * kThreads;
      v[j] = i < n ? src.load(i) : 0;
    }
  }
  int valid = 0;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if ((Src::kWide ? wide0 + j : base + (int64_t)j * kThreads) >= n) break;
    const int32_t c = src.cell(v[j], bad);
    if (c < 0) continue;  // touches nothing
    ++valid;
    for (int p = 0; p < passes; ++p)
      atomicAdd(&s_h[p * kMaxRadix + (((uint32_t)c >> (p * digit_bits)) & mask)], 1);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(err, Src::kErr);
  for (int e = threadIdx.x; e < passes * kMaxRadix; e += kThreads)
    if (s_h[e]) atomicAdd(&ctrl[e], s_h[e]);
  const long long total = block_sum(valid, s_sum);
  if (threadIdx.x == 0 && total) atomicAdd(&ctrl[kCtrlValid], (int32_t)total);
}

// One stable digit pass over the records' cells and indices. kFirst:
// the cells come from src (a record that touches nothing is dropped) and
// a record's index is its position; else both come from the previous
// pass (n_valid of them). status: this pass's look-back words, tile-major.
template <bool kFirst, class Src>
__global__ void __launch_bounds__(kThreads)
    lanes_sort_kernel(const Src src, const int32_t* __restrict__ keys_in,
                      const int32_t* __restrict__ vals_in, int64_t n, int32_t pass,
                      int32_t digit_bits,
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
    int32_t c = 0;
    if (kFirst) {
      c = ok ? src.key(src.load(i)) : -1;
      ok = c >= 0;
    } else if (ok) {
      c = keys_in[i];
    }
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

// H, then the digit passes (the first reading the records through src):
// the sorted cells and record indices end in keys0 / vals0 after an odd
// number of passes, keys1 / vals1 after an even one
template <class Src>
int lanes_sort(const Src& src, int64_t n, int32_t passes, int32_t digit_bits, int32_t tiles,
               int32_t* work, uint32_t* status, int64_t status_pass, int32_t* keys0,
               int32_t* vals0, int32_t* keys1, int32_t* vals1, int32_t* err, cudaStream_t s) {
  lanes_hist_kernel<Src><<<tiles, kThreads, 0, s>>>(src, n, passes, digit_bits, work, err);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int32_t* k_in = nullptr;
  const int32_t* v_in = nullptr;
  for (int32_t p = 0; p < passes; ++p) {
    int32_t* k_out = p % 2 ? keys1 : keys0;
    int32_t* v_out = p % 2 ? vals1 : vals0;
    auto* kernel = p ? &lanes_sort_kernel<false, Src> : &lanes_sort_kernel<true, Src>;
    kernel<<<tiles, kThreads, 0, s>>>(src, k_in, v_in, n, p, digit_bits, work,
                                      status + p * status_pass, k_out, v_out);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    k_in = k_out;
    v_in = v_out;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* lk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// fire_pack's argument block (lane_kernels.py _FIRE_PACK), every field
// 64 bits: the state and its widths, the fire, the outputs, the clean
// workspace (lookback.cuh; work_words int64 words: the epoch, then a
// descriptor a tile) and the plan (_fire_plan)
struct FireArgs {
  int64_t counts, rows, ring, sums, sw, maxs, mw, mins, nw;
  int64_t end_panes, w_valid, W, pane_lo, pane_hi, ppw, used;
  int64_t out, out_cols, out_cap, packed2, row_offset, lanes, err;
  int64_t work, work_words, tile_cells, tile_rows, stage_counts, stage_lanes;
};

int lk_fire_pack_packed(const FireArgs* a, void* stream) {
  const int64_t K = a->rows * a->W;
  if (K <= 0) return (int)cudaGetLastError();
  const int64_t L = a->sw + a->mw + a->nw, C = a->tile_cells;
  const int64_t tiles = (K + C - 1) / C;
  const bool stage_lanes = L && a->stage_lanes;
  // the plan must fit this kernel: cells a tile, the rows a tile spans,
  // the shared memory it reserves, the workspace's descriptors
  if (a->ring < 1 || a->ring >= (1ll << 31) || a->W >= (1ll << 31) || C < 1 || C > kFireCells ||
      a->tile_rows != (C + a->W - 2) / a->W + 1 || tiles >= (1ll << 31) ||
      a->work_words < tiles + 1 || (a->out_cols != 2 && a->out_cols != 3) ||
      fire_layout(C, a->tile_rows, a->ring, L, a->out_cols, a->stage_counts != 0, stage_lanes)
                  .words * 4 > kFireSmem)
    return (int)cudaErrorInvalidValue;
  FireParams p{};
  p.counts = (const int32_t*)a->counts;
  p.lane[0] = (const float*)a->sums;
  p.lane[1] = (const float*)a->maxs;
  p.lane[2] = (const float*)a->mins;
  p.width[0] = (int32_t)a->sw;
  p.width[1] = (int32_t)a->mw;
  p.width[2] = (int32_t)a->nw;
  p.rows = a->rows;
  p.ring = (int32_t)a->ring;
  p.W = (int32_t)a->W;
  p.ppw = (int32_t)a->ppw;
  p.end_panes = (const int64_t*)a->end_panes;
  p.w_valid = (const uint8_t*)a->w_valid;
  p.used = (const uint8_t*)a->used;
  p.pane_lo = a->pane_lo;
  p.pane_hi = a->pane_hi;
  p.out = (int32_t*)a->out;
  p.out_cols = (int32_t)a->out_cols;
  p.out_cap = (int32_t)a->out_cap;
  p.packed2 = (int32_t)a->packed2;
  p.row_offset = (int32_t)a->row_offset;
  p.lanes = (float*)a->lanes;
  p.err = (int32_t*)a->err;
  p.epoch = (uint32_t*)a->work;
  p.desc = (unsigned long long*)a->work + 1;
  p.tile_cells = (int32_t)C;
  p.tile_rows = (int32_t)a->tile_rows;
  p.stage_counts = (int32_t)a->stage_counts;
  p.stage_lanes = (int32_t)stage_lanes;
  p.tiles = tiles;
  const size_t smem =
      (size_t)fire_layout(C, a->tile_rows, a->ring, L, a->out_cols, a->stage_counts != 0,
                          stage_lanes)
          .words *
      4;
  if (a->W <= kFireWinTable)
    fire_pack_kernel<true><<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(p);
  else
    fire_pack_kernel<false><<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// the plan (lane_kernels.py _scatter_plan): passes digit passes of
// digit_bits each over tiles of kSortTile records (a hist block and a
// sort block a tile), fold_blocks fold blocks; work: the zeroed region
// (the ctrl block, then passes * tiles << digit_bits look-back words),
// zero_ints long; keys0, vals0, keys1, vals1: n int32 each. idx is n
// int32 flat cells (split_ring 0), or the split upload's (n, 3) bytes
// over a ring of split_ring columns (1..256) with its dump row.
int lk_scatter_lanes(int32_t* counts, float* sums, int32_t sw, float* maxs, int32_t mw,
                     float* mins, int32_t nw, int64_t n_cells, const void* idx,
                     const float* s_in, const float* mx_in, const float* mn_in, int64_t n,
                     int32_t skip_negative, int32_t passes, int32_t digit_bits, int32_t tiles,
                     int32_t fold_blocks, int32_t* work, int64_t zero_ints, int32_t* keys0,
                     int32_t* vals0, int32_t* keys1, int32_t* vals1, int32_t* err,
                     int32_t split_ring, int32_t dump_row, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t status_pass = (int64_t)tiles << digit_bits;
  if (passes < 1 || passes > kMaxPasses || digit_bits < 1 || digit_bits > kMaxDigitBits ||
      (int64_t)tiles * kSortTile < n || n > (int64_t)kCountMask ||
      zero_ints < kCtrlInts + passes * status_pass || fold_blocks < 1)
    return (int)cudaErrorInvalidValue;
  // a split record's cell lies below (dump_row + 1) * ring
  if (split_ring && (split_ring < 1 || split_ring > 256 || dump_row < 0 ||
                     dump_row >= (int32_t)kInvalidSlotU16 ||
                     ((int64_t)dump_row + 1) * split_ring > n_cells))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaMemsetAsync(work, 0, (size_t)zero_ints * sizeof(int32_t), s);
  if (rc) return rc;
  uint32_t* status = (uint32_t*)(work + kCtrlInts);
  rc = split_ring
           ? lanes_sort(SplitCells{SplitRecords{(const uint8_t*)idx, split_ring, dump_row}}, n,
                        passes, digit_bits, tiles, work, status, status_pass, keys0, vals0,
                        keys1, vals1, err, s)
           : lanes_sort(FlatCells{(const int32_t*)idx, n_cells, skip_negative}, n, passes,
                        digit_bits, tiles, work, status, status_pass, keys0, vals0, keys1,
                        vals1, err, s);
  if (rc) return rc;
  // the last pass's sorted cells and record indices
  const int32_t* k_in = passes % 2 ? keys0 : keys1;
  const int32_t* v_in = passes % 2 ? vals0 : vals1;
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
// lk_scatter_lanes from one packed block of 27 64-bit words
int lk_scatter_lanes_packed(const int64_t* a, void* stream) {
  return lk_scatter_lanes(
      (int32_t*)(intptr_t)a[0], (float*)(intptr_t)a[1], (int32_t)a[2], (float*)(intptr_t)a[3],
      (int32_t)a[4], (float*)(intptr_t)a[5], (int32_t)a[6], (int64_t)a[7],
      (const void*)(intptr_t)a[8], (const float*)(intptr_t)a[9],
      (const float*)(intptr_t)a[10], (const float*)(intptr_t)a[11], (int64_t)a[12],
      (int32_t)a[13], (int32_t)a[14], (int32_t)a[15], (int32_t)a[16], (int32_t)a[17],
      (int32_t*)(intptr_t)a[18], (int64_t)a[19], (int32_t*)(intptr_t)a[20],
      (int32_t*)(intptr_t)a[21], (int32_t*)(intptr_t)a[22], (int32_t*)(intptr_t)a[23],
      (int32_t*)(intptr_t)a[24], (int32_t)a[25], (int32_t)a[26], stream);
}

}  // extern "C"
