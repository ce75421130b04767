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

// L2 radix sort: 8-bit digits, kRadixItems records per thread per pass
constexpr int kRadixBits = 8;
constexpr int kRadixDigits = 1 << kRadixBits;
constexpr int kRadixItems = 16;
constexpr int kRadixTile = kThreads * kRadixItems;
constexpr int kScanThreads = 1024;
// error-word bits (window_kernels.py ERROR_BITS decodes them)
constexpr int32_t kErrScatterLanes = 8;
constexpr int32_t kErrPairLanes = 16;
constexpr int32_t kErrFireCap = 32;

static_assert(kThreads == kRadixDigits, "one thread per radix digit");

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
// them (so the f32 sums come out bit for bit equal).
//
// Design: a stable LSD radix sort of (cell, record index) by cell, 8 bits
// a pass over the bits a cell index needs (3 passes at 2^20 cells), a
// gather of the records' lanes into that order, then the thread at each
// run's end folds the run (from its head, noted by a first pass) in order
// over consecutive addresses. No float
// atomics; no atomics at all on the state. A pass: A counts each block's
// digits (shared-memory atomics, order-free), B scans the (digit, block)
// table, C places each record at its digit's offset plus its rank among
// the equal digits before it in the tile (a warp's ranks from
// __match_any_sync, warps in record order), which keeps the sort stable.
// An index outside the state takes the sentinel cell n_cells, sorts last,
// is skipped, and sets kErrScatterLanes; with skip_negative a negative
// index (an invalid record of a key-sharded block's received buckets)
// takes the sentinel without the error.
//
// Bound: bytes — idx once, each record's lanes once, each touched cell's
// lanes and count read and written once. The sort's own passes (~24 bytes
// a record a pass) and the run fold's gathers come on top.

__global__ void lanes_prep_kernel(const int32_t* __restrict__ idx, int64_t n, int64_t n_cells,
                                  int32_t skip_negative, int32_t* __restrict__ keys,
                                  int32_t* __restrict__ vals, int32_t* __restrict__ err) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int32_t c = idx[i];
    if (c < 0 && skip_negative) {
      c = (int32_t)n_cells;  // an invalid record: sorts last, is skipped
    } else if (c < 0 || (int64_t)c >= n_cells) {
      atomicOr(err, kErrScatterLanes);
      c = (int32_t)n_cells;
    }
    keys[i] = c;
    vals[i] = (int32_t)i;
  }
}

__global__ void radix_upsweep_kernel(const int32_t* __restrict__ keys, int64_t n, int32_t shift,
                                     int32_t* __restrict__ hist, int32_t n_blocks) {
  __shared__ int s_h[kRadixDigits];
  s_h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kRadixTile;
  for (int j = 0; j < kRadixItems; ++j) {
    const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&s_h[((uint32_t)keys[i] >> shift) & (kRadixDigits - 1)], 1);
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * n_blocks + blockIdx.x] = s_h[threadIdx.x];
}

// exclusive prefix sum of v over a block of kScanThreads threads
__device__ __forceinline__ int scan_block_1024(int v, int* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();  // s_w may still be read by a previous call
  if (lane == 31) s_w[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = s_w[lane];
    int u = t;
    for (int o = 1; o < 32; o <<= 1) {
      int x = __shfl_up_sync(0xffffffffu, u, o);
      if (lane >= o) u += x;
    }
    s_w[lane] = u - t;
  }
  __syncthreads();
  return s_w[warp] + incl - v;
}

// exclusive scan of the (digit-major) hist table in place, in three
// launches: A the sum of each kScanThreads-entry chunk, B an exclusive
// scan of those sums (one block, looping when there are more chunks
// than threads), C each chunk's own scan plus its prefix
__global__ void scan_chunk_sums_kernel(const int32_t* __restrict__ hist, int64_t m,
                                       int32_t* __restrict__ chunk) {
  __shared__ int s_w[kScanThreads / 32];
  const int64_t i = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  const int v = i < m ? hist[i] : 0;
  const int before = scan_block_1024(v, s_w);
  if (threadIdx.x == kScanThreads - 1) chunk[blockIdx.x] = before + v;
}

__global__ void scan_chunks_kernel(int32_t* __restrict__ chunk, int64_t n_chunks) {
  __shared__ int s_w[kScanThreads / 32];
  __shared__ int s_carry;
  if (threadIdx.x == 0) s_carry = 0;
  for (int64_t base = 0; base < n_chunks; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int v = i < n_chunks ? chunk[i] : 0;
    __syncthreads();
    const int carry = s_carry;
    const int before = scan_block_1024(v, s_w);
    if (i < n_chunks) chunk[i] = carry + before;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) s_carry = carry + before + v;
  }
}

__global__ void scan_apply_kernel(int32_t* __restrict__ hist, int64_t m,
                                  const int32_t* __restrict__ chunk) {
  __shared__ int s_w[kScanThreads / 32];
  const int64_t i = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  const int v = i < m ? hist[i] : 0;
  const int before = scan_block_1024(v, s_w);
  if (i < m) hist[i] = chunk[blockIdx.x] + before;
}

__global__ void radix_downsweep_kernel(const int32_t* __restrict__ keys_in,
                                       const int32_t* __restrict__ vals_in, int64_t n,
                                       int32_t shift, const int32_t* __restrict__ hist,
                                       int32_t n_blocks, int32_t* __restrict__ keys_out,
                                       int32_t* __restrict__ vals_out) {
  __shared__ int s_cnt[kWarps][kRadixDigits];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < kWarps * kRadixDigits; d += blockDim.x) (&s_cnt[0][0])[d] = 0;
  __syncthreads();
  // warp w owns records [wbase, wbase + 32 * kRadixItems) of the tile, in
  // rounds of 32 consecutive records
  const int64_t wbase = (int64_t)blockIdx.x * kRadixTile + (int64_t)warp * 32 * kRadixItems;
  int32_t key[kRadixItems];
  uint32_t dig[kRadixItems];
  for (int j = 0; j < kRadixItems; ++j) {
    const int64_t i = wbase + (int64_t)j * 32 + lane;
    key[j] = i < n ? keys_in[i] : 0;
    // past the end: a value no real digit has, so it never joins a group
    dig[j] = i < n ? ((uint32_t)key[j] >> shift) & (kRadixDigits - 1) : kRadixDigits;
    const uint32_t peers = __match_any_sync(0xffffffffu, dig[j]);
    if (dig[j] < kRadixDigits && lane == __ffs(peers) - 1) s_cnt[warp][dig[j]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  {
    // digit d: the global offset of this block's first d, then each
    // warp's start within it
    const int d = threadIdx.x;
    int run = hist[(int64_t)d * n_blocks + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const int t = s_cnt[w][d];
      s_cnt[w][d] = run;
      run += t;
    }
  }
  __syncthreads();
  const uint32_t lt = (1u << lane) - 1u;
  for (int j = 0; j < kRadixItems; ++j) {
    const int64_t i = wbase + (int64_t)j * 32 + lane;
    const uint32_t peers = __match_any_sync(0xffffffffu, dig[j]);
    int pos = 0;
    if (dig[j] < kRadixDigits) pos = s_cnt[warp][dig[j]] + __popc(peers & lt);
    __syncwarp();
    if (dig[j] < kRadixDigits) {
      keys_out[pos] = key[j];
      vals_out[pos] = vals_in[i];
      if (lane == __ffs(peers) - 1) s_cnt[warp][dig[j]] += __popc(peers);
    }
    __syncwarp();
  }
}

// the records' lanes in sorted order, lane-major: sorted[l * n + k] is
// lane l (sums, then maxs, then mins) of the k-th record in cell order,
// so a run's fold reads consecutive addresses
__global__ void lanes_gather_kernel(const int32_t* __restrict__ vals, int64_t n,
                                    const float* __restrict__ s_in, int32_t sw,
                                    const float* __restrict__ mx_in, int32_t mw,
                                    const float* __restrict__ mn_in, int32_t nw,
                                    float* __restrict__ sorted) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    const int64_t i = vals[k];
    for (int32_t s = 0; s < sw; ++s) sorted[s * n + k] = s_in[i * sw + s];
    for (int32_t s = 0; s < mw; ++s) sorted[(sw + s) * n + k] = mx_in[i * mw + s];
    for (int32_t s = 0; s < nw; ++s) sorted[(sw + mw + s) * n + k] = mn_in[i * nw + s];
  }
}

// each run's first position, at its cell (head_of has n_cells entries;
// only cells that have a run in this batch are written, then read)
__global__ void lanes_heads_kernel(const int32_t* __restrict__ keys, int64_t n, int64_t n_cells,
                                   int32_t* __restrict__ head_of) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    const int32_t cell = keys[k];
    if ((int64_t)cell != n_cells && (k == 0 || keys[k - 1] != cell)) head_of[cell] = (int32_t)k;
  }
}

// the thread at each run's last position folds the run, in order
__global__ void lanes_fold_kernel(const int32_t* __restrict__ keys, int64_t n, int64_t n_cells,
                                  const int32_t* __restrict__ head_of,
                                  const float* __restrict__ sorted, int32_t sw, int32_t mw,
                                  int32_t nw, int32_t* __restrict__ counts,
                                  float* __restrict__ sums, float* __restrict__ maxs,
                                  float* __restrict__ mins) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    const int32_t cell = keys[k];
    if ((int64_t)cell == n_cells || (k + 1 < n && keys[k + 1] == cell)) continue;
    const int64_t head = head_of[cell], end = k + 1;
    counts[cell] += (int32_t)(end - head);
    for (int32_t s = 0; s < sw; ++s) {
      const float* x = sorted + (int64_t)s * n;
      float acc = sums[(int64_t)cell * sw + s];
#pragma unroll 8
      for (int64_t q = head; q < end; ++q) acc += x[q];
      sums[(int64_t)cell * sw + s] = acc;
    }
    for (int32_t s = 0; s < mw; ++s) {
      const float* x = sorted + (int64_t)(sw + s) * n;
      float acc = maxs[(int64_t)cell * mw + s];
#pragma unroll 8
      for (int64_t q = head; q < end; ++q) acc = max_ieee(acc, x[q]);
      maxs[(int64_t)cell * mw + s] = acc;
    }
    for (int32_t s = 0; s < nw; ++s) {
      const float* x = sorted + (int64_t)(sw + mw + s) * n;
      float acc = mins[(int64_t)cell * nw + s];
#pragma unroll 8
      for (int64_t q = head; q < end; ++q) acc = min_ieee(acc, x[q]);
      mins[(int64_t)cell * nw + s] = acc;
    }
  }
}

// ---- L3: scatter_pair_lanes ------------------------------------------------
// One host-combined row per distinct (slot, ring column) pair:
// [pair, count, f32 bits of each pre-summed sum lane]; pair < 0 marks
// padding and touches nothing. The host's combine makes the pairs of one
// upload distinct, so each cell takes at most one add per launch: one
// thread per row adds without atomics (the int count takes an integer
// atomic anyway, exact in any order). Bound: bytes — the rows once and
// one read-modify-write of each touched cell's count and sums.
__global__ void pair_lanes_kernel(const int32_t* __restrict__ buf, int64_t P, int32_t C,
                                  int64_t n_cells, int32_t* __restrict__ counts,
                                  float* __restrict__ sums, int32_t sw,
                                  int32_t* __restrict__ err) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < P; p += stride) {
    const int32_t* row = buf + p * C;
    const int32_t pair = row[0];
    if (pair < 0) continue;
    if ((int64_t)pair >= n_cells) {
      atomicOr(err, kErrPairLanes);
      continue;
    }
    atomicAdd(&counts[pair], row[1]);
    for (int32_t s = 0; s < sw; ++s) sums[(int64_t)pair * sw + s] += __int_as_float(row[2 + s]);
  }
}

}  // namespace

extern "C" {

const char* lk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int lk_fire_tile() { return kTile; }

int lk_radix_tile() { return kRadixTile; }

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

// scratch: keys_a, vals_a, keys_b, vals_b (n int32 each), hist
// (kRadixDigits * ceil(n / kRadixTile) int32), chunk (ceil(hist size /
// kScanThreads) int32), head_of (n_cells int32), sorted ((sw + mw + nw) *
// n f32); bits: the bit length of n_cells (the sentinel), at most 31
int lk_scatter_lanes(int32_t* counts, float* sums, int32_t sw, float* maxs, int32_t mw,
                     float* mins, int32_t nw, int64_t n_cells, const int32_t* idx,
                     const float* s_in, const float* mx_in, const float* mn_in, int64_t n,
                     int32_t skip_negative, int32_t bits, int32_t* keys_a, int32_t* vals_a, int32_t* keys_b,
                     int32_t* vals_b, int32_t* hist, int32_t* chunk, int32_t* head_of,
                     float* sorted, int32_t* err, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  lanes_prep_kernel<<<grid_for(n), kThreads, 0, s>>>(idx, n, n_cells, skip_negative, keys_a,
                                                     vals_a, err);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int32_t n_blocks = (int32_t)((n + kRadixTile - 1) / kRadixTile);
  const int64_t m = (int64_t)kRadixDigits * n_blocks;
  const int32_t n_chunks = (int32_t)((m + kScanThreads - 1) / kScanThreads);
  for (int32_t shift = 0; shift < bits; shift += kRadixBits) {
    radix_upsweep_kernel<<<n_blocks, kThreads, 0, s>>>(keys_a, n, shift, hist, n_blocks);
    scan_chunk_sums_kernel<<<n_chunks, kScanThreads, 0, s>>>(hist, m, chunk);
    scan_chunks_kernel<<<1, kScanThreads, 0, s>>>(chunk, n_chunks);
    scan_apply_kernel<<<n_chunks, kScanThreads, 0, s>>>(hist, m, chunk);
    radix_downsweep_kernel<<<n_blocks, kThreads, 0, s>>>(keys_a, vals_a, n, shift, hist,
                                                         n_blocks, keys_b, vals_b);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    int32_t* t = keys_a;
    keys_a = keys_b;
    keys_b = t;
    t = vals_a;
    vals_a = vals_b;
    vals_b = t;
  }
  if (sw + mw + nw > 0) {
    lanes_gather_kernel<<<grid_for(n), kThreads, 0, s>>>(vals_a, n, s_in, sw, mx_in, mw, mn_in, nw,
                                                         sorted);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  lanes_heads_kernel<<<grid_for(n), kThreads, 0, s>>>(keys_a, n, n_cells, head_of);
  lanes_fold_kernel<<<grid_for(n), kThreads, 0, s>>>(keys_a, n, n_cells, head_of, sorted, sw, mw,
                                                     nw, counts, sums, maxs, mins);
  return (int)cudaGetLastError();
}

int lk_scatter_pair_lanes(int32_t* counts, float* sums, int32_t sw, int64_t n_cells,
                          const int32_t* buf, int64_t P, int32_t C, int32_t* err, void* stream) {
  if (P > 0) {
    pair_lanes_kernel<<<grid_for(P), kThreads, 0, (cudaStream_t)stream>>>(buf, P, C, n_cells,
                                                                         counts, sums, sw, err);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
