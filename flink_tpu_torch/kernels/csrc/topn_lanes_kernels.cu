// Top-n fires over lane aggregates, hand-written for Hopper (sm_90a):
// top-n by any result field of any aggregate, beside the count-only form
// of window_fire.cuh (K3), which stays as it is. Plain C interface, bound
// from Python with ctypes (flink_tpu_torch/kernels/topn_lanes_kernels.py);
// every entry point launches on the caller's stream, allocates nothing
// (the wrapper passes scratch) and returns cudaGetLastError().
//
// TA window_lanes         replaces flink_tpu/ops/window.py:318-346, the
//                         sum / max / min lanes of fire_kernel over the
//                         whole (rows, W) grid
// TB topn_select_lanes    replaces flink_tpu/ops/window.py:547
//                         _ring_append_topn_core + :456
//                         _topn_select_append, for a ranking field other
//                         than a count-only aggregate's count
//
// Between the two, in torch: the aggregate's finalize on TA's grid and
// window_counts' (K2) counts gives the ranking grid v (rows, W) and the
// result columns (rows, W, F) as int32 (int results) or f32 bits. The
// finalize is elementwise, so finalizing the grid gives the same bits as
// the reference, which finalizes the selected cells only.
//
// Float rules (as lane_kernels.cu): no float atomics and no TF32. A
// window's sum adds the ring columns in column order, each times its 0/1
// live bit — fire_pack's order, so the two fires agree bit for bit; the
// reference's jitted column-mask product leaves the association to XLA's
// GEMM, so its sums agree with these to a rounding or two. Max and min
// are IEEE maximum / minimum (NaN wins, -0 < +0). The ranking follows
// lax.top_k over the ranking field: the n-th largest value in IEEE total
// order (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN; non-candidates
// rank as -inf) is the window's threshold, and a candidate is selected
// when v >= threshold as an IEEE comparison (so a NaN threshold selects
// nothing, and -0 and +0 tie).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lookback.cuh"
#include "window_common.cuh"

namespace {

// ---- TA: window_lanes --------------------------------------------------------
// out_s[r, w, :] = sum over ring columns c (in column order) of
// sums[r, c, :] * live(w, c); out_x / out_n = IEEE max / min of maxs /
// mins over the live columns (identity -inf / +inf when none). Column c
// is live for window w when it holds a pane of [end_w - ppw, end_w) ∩
// [pane_lo, pane_hi] (the reference's column mask; at most one live pane
// per column). An invalid window (!w_valid[w]) gets 0 sums and the max /
// min identities.
//
// Bound: bytes — the lanes read once (rows x ring x (S + M + N) x 4) and
// the (rows x W x (S + M + N)) output written once. Design: a block owns
// a tile of rows, a group of windows and a group of lanes (concatenated
// sums, maxs, mins). Its threads copy the tile's ring columns into
// shared memory with cp.async, every load in flight at once (neighbouring
// threads on neighbouring words: a row's columns are contiguous, so the
// loads coalesce), one region a lane family with an odd row stride, so
// the threads of a warp on neighbouring rows read distinct banks. Each
// window's live columns are at most two runs of the ring; the block works
// them out once into shared memory (no thread divides by the ring). Then
// each thread owns one (row, window, lane) output, in the order of the
// outputs in memory, so the stores coalesce. A sum adds
// every column in column order, run by run, each times its run's 0/1
// live bit (so a NaN or inf in a dead column poisons it, as the plain
// version and the reference's column-mask product do); a max or min folds
// the live runs only. A ring too long for the tile goes through in
// chunks of columns, each thread's accumulators kept across them, so the
// column order holds. The launch shape (rows a tile, windows and lanes a
// block, columns a chunk) is the wrapper's (topn_lanes_kernels.py
// _lanes_plan). No float atomics, no TF32.
constexpr int kLanesWindows = 64;                      // windows a block at most
constexpr int kLanesSmemFloats = 11264;                // the staged tile, 44 KB

struct LanesParams {
  const float* lane[3];
  float* out[3];
  int32_t width[3];
  int64_t rows;
  int32_t ring, W, ppw;
  const int64_t* end_panes;
  const uint8_t* w_valid;
  int64_t pane_lo, pane_hi;
  int32_t tile_rows, win_group, lane_group, col_chunk;
};

// n / d for the small n and d of a staged tile (n * d < 2^32): one
// multiply-high by a magic number worked out once a block
struct FastDiv {
  uint32_t d, m;
};

__device__ __forceinline__ FastDiv fast_div(uint32_t d) {
  return FastDiv{d, d > 1 ? 0xFFFFFFFFu / d + 1 : 0u};
}

__device__ __forceinline__ uint32_t div_by(uint32_t n, FastDiv f) {
  return f.d > 1 ? __umulhi(n, f.m) : n;
}

// a += each column of [x, y) (chunk-relative, clipped to [0, cn)) times m,
// in column order; t is the output's row and lane in the tile, step its
// family's lanes in the group
__device__ __forceinline__ float add_run(float a, const float* t, int32_t step, int32_t x,
                                         int32_t y, int32_t cn, float m) {
  x = x < 0 ? 0 : x;
  y = y > cn ? cn : y;
#pragma unroll 4
  for (int32_t c = x; c < y; ++c) a += t[c * step] * m;
  return a;
}

template <bool kMax>
__device__ __forceinline__ float fold_run(float a, const float* t, int32_t step, int32_t x,
                                          int32_t y, int32_t cn) {
  x = x < 0 ? 0 : x;
  y = y > cn ? cn : y;
#pragma unroll 4
  for (int32_t c = x; c < y; ++c) a = kMax ? max_ieee(a, t[c * step]) : min_ieee(a, t[c * step]);
  return a;
}

__global__ void __launch_bounds__(kThreads) window_lanes_kernel(const LanesParams p) {
  extern __shared__ float tile[];
  // window w's live columns: [0, e1) and [e2, e3) of the ring
  __shared__ int32_t s_e1[kLanesWindows], s_e2[kLanesWindows], s_e3[kLanesWindows];
  __shared__ uint8_t s_valid[kLanesWindows];
  const int64_t r0 = (int64_t)blockIdx.x * p.tile_rows;
  const int32_t w0 = blockIdx.y * p.win_group, l0 = blockIdx.z * p.lane_group;
  const int32_t L = p.width[0] + p.width[1] + p.width[2];
  const int32_t nr = (int32_t)(p.rows - r0 < p.tile_rows ? p.rows - r0 : p.tile_rows);
  const int32_t nwin = p.W - w0 < p.win_group ? p.W - w0 : p.win_group;
  const int32_t nl = L - l0 < p.lane_group ? L - l0 : p.lane_group;
  const int32_t ring = p.ring;
  for (int32_t w = threadIdx.x; w < nwin; w += kThreads) {
    // the window's live panes [lo_w, hi_w], from column c0 on for span
    // + 1 columns (span < ring: one live pane per column)
    const int64_t e = p.end_panes[w0 + w];
    const int64_t lo_w = e - p.ppw > p.pane_lo ? e - p.ppw : p.pane_lo;
    const int64_t hi_w = e - 1 < p.pane_hi ? e - 1 : p.pane_hi;
    const int64_t span = hi_w - lo_w;
    const bool valid = p.w_valid[w0 + w] != 0;
    int32_t e1 = 0, e2 = ring, e3 = ring;
    if (valid && span >= 0) {
      const int32_t c0 = (int32_t)floor_mod(lo_w, ring);
      const int32_t last = c0 + (span >= ring - 1 ? ring - 1 : (int32_t)span);
      e2 = c0;
      if (last < ring) {
        e3 = last + 1;
      } else {
        e1 = last - ring + 1;
      }
    }
    s_valid[w] = valid;
    s_e1[w] = e1;
    s_e2[w] = e2;
    s_e3[w] = e3;
  }
  // the lane families' parts of this block's lane group [l0, l0 + nl):
  // family f has lanes [j0[f], j0[f] + nf[f]) in the group
  int32_t j0[3], nf[3];
  {
    int32_t off = 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int32_t a = l0 > off ? l0 : off;
      const int32_t b = l0 + nl < off + p.width[f] ? l0 + nl : off + p.width[f];
      nf[f] = b > a ? b - a : 0;
      j0[f] = a - off;
      off += p.width[f];
    }
  }
  // this thread's output, in memory order: family, then (row, window,
  // lane)
  const int32_t seg0 = nr * nwin * nf[0], seg1 = nr * nwin * nf[1];
  const int32_t o = threadIdx.x;
  const bool mine = o < nr * nwin * nl;
  const int f = o < seg0 ? 0 : (o < seg0 + seg1 ? 1 : 2);
  const int32_t oo = o - (f == 0 ? 0 : (f == 1 ? seg0 : seg0 + seg1));
  const int32_t n_f = f == 0 ? nf[0] : (f == 1 ? nf[1] : nf[2]);
  const int32_t per_row = nwin * (n_f > 0 ? n_f : 1);
  const int32_t orow = oo / per_row, rem = oo - orow * per_row;
  const int32_t win = rem / (n_f > 0 ? n_f : 1), olane = rem - win * n_f;
  float acc = f == 0 ? 0.0f : (f == 1 ? -INFINITY : INFINITY);
  for (int32_t cc0 = 0; cc0 < ring; cc0 += p.col_chunk) {
    const int32_t cn = ring - cc0 < p.col_chunk ? ring - cc0 : p.col_chunk;
    // family f's region: nr rows of stride rs[f] (its cn x nf[f] words,
    // odd), from base[f]
    int32_t rs[3], base[3];
    {
      int32_t at = 0;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        rs[g] = nf[g] ? ((cn * nf[g]) | 1) : 0;
        base[g] = at;
        at += nr * rs[g];
      }
    }
    __syncthreads();  // the previous chunk's reads are done; the window table is written
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      if (nf[g] == 0) continue;
      const int64_t S = p.width[g];
      const uint32_t row_len = (uint32_t)(cn * nf[g]), n_el = (uint32_t)nr * row_len;
      const FastDiv by_row = fast_div(row_len), by_lane = fast_div((uint32_t)nf[g]);
      const float* src = p.lane[g] + (r0 * ring + cc0) * S + j0[g];
      for (uint32_t e = threadIdx.x; e < n_el; e += kThreads) {
        const uint32_t r = div_by(e, by_row), i = e - r * row_len;
        const uint32_t c = div_by(i, by_lane), j = i - c * (uint32_t)nf[g];
        cp_async_4(tile + base[g] + r * rs[g] + i, src + ((int64_t)r * ring + c) * S + j);
      }
    }
    cp_async_wait();
    __syncthreads();
    if (mine) {
      const int32_t e1 = s_e1[win] - cc0, e2 = s_e2[win] - cc0, e3 = s_e3[win] - cc0;
      const float* t = tile + (f == 0 ? base[0] : (f == 1 ? base[1] : base[2])) +
                       orow * (f == 0 ? rs[0] : (f == 1 ? rs[1] : rs[2])) + olane;
      if (f == 0) {
        if (s_valid[win]) {
          acc = add_run(acc, t, n_f, 0, e1, cn, 1.0f);
          acc = add_run(acc, t, n_f, e1, e2, cn, 0.0f);
          acc = add_run(acc, t, n_f, e2, e3, cn, 1.0f);
          acc = add_run(acc, t, n_f, e3, cn, cn, 0.0f);
        }
      } else if (f == 1) {
        acc = fold_run<true>(acc, t, n_f, 0, e1, cn);
        acc = fold_run<true>(acc, t, n_f, e2, e3, cn);
      } else {
        acc = fold_run<false>(acc, t, n_f, 0, e1, cn);
        acc = fold_run<false>(acc, t, n_f, e2, e3, cn);
      }
    }
  }
  if (mine) {
    const int64_t S = f == 0 ? p.width[0] : (f == 1 ? p.width[1] : p.width[2]);
    const int32_t j_f = f == 0 ? j0[0] : (f == 1 ? j0[1] : j0[2]);
    float* out = f == 0 ? p.out[0] : (f == 1 ? p.out[1] : p.out[2]);
    out[((r0 + orow) * p.W + w0 + win) * S + j_f + olane] = acc;
  }
}

// The main path's form, for rings of up to 64 columns: one thread a
// (row, lane) pair of one lane family. Each thread reads the pair's ring
// columns into registers (16-byte loads where a row's columns lie
// together) before the block works out each window of its group (the
// plan's win_group, grid.y the groups) as a 64-bit live mask in shared
// memory, so the two waits overlap; then every window of the group from
// the registers. A sum adds every column in column order, each times its
// live bit (the group's 0/1 multipliers read from shared memory four
// columns at a time); a max or min
// folds the live columns' order-preserving integer keys (NaN as the
// extreme key, -0 below +0: IEEE maximum / minimum, the plain version's
// form). Windows go kLanesGroup at a time, their chains interleaved, so a
// thread keeps that many adds in flight. Each block is one family's run
// of pairs: blocks [0, nb0) the sums, [nb0, nb0 + nb1) the maxes, the
// rest the mins. With one lane a family and every window
// in one group of at most kLanesStageW (job T's shape), a block's outputs
// are one run of memory: they go through shared memory and out in
// coalesced stores.
constexpr int kLanesGroup = 4;
constexpr int kLanesStageW = 16;

__device__ __forceinline__ bool col_live(uint32_t lo, uint32_t hi, int c) {
  return c < 32 ? (lo >> c) & 1u : (hi >> (c & 31)) & 1u;
}

// order-preserving int32 key of an f32; a NaN takes nan_key
__device__ __forceinline__ int32_t ordered_key(float x, int32_t nan_key) {
  const int32_t b = __float_as_int(x);
  return isnan(x) ? nan_key : (b >= 0 ? b : b ^ 0x7FFFFFFF);
}

// the f32 of an ordered key; the extreme keys (a NaN's) give the
// canonical NaN
__device__ __forceinline__ float from_ordered_key(int32_t k) {
  if (k == INT32_MAX || k == INT32_MIN) return __int_as_float(0x7fc00000);
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

template <int RC>
__global__ void __launch_bounds__(kThreads)
    window_lanes_reg_kernel(const LanesParams p, int32_t nb0, int32_t nb1) {
  __shared__ uint32_t s_lo[kLanesWindows], s_hi[kLanesWindows];
  __shared__ uint8_t s_valid[kLanesWindows];
  // each window's live bits as f32 multipliers (1 or 0), column by column
  __shared__ __align__(16) float s_mul[kLanesWindows * RC];
  __shared__ float s_out[kThreads * (kLanesStageW | 1)];
  const int32_t w0 = blockIdx.y * p.win_group;
  const int32_t nwin = p.W - w0 < p.win_group ? p.W - w0 : p.win_group;
  const int32_t ring = p.ring;
  const int f = (int)blockIdx.x < nb0 ? 0 : ((int)blockIdx.x < nb0 + nb1 ? 1 : 2);
  const int64_t i0 = (int64_t)(blockIdx.x - (f == 0 ? 0 : (f == 1 ? nb0 : nb0 + nb1))) * kThreads;
  const int64_t i = i0 + threadIdx.x;
  const int64_t S = f == 0 ? p.width[0] : (f == 1 ? p.width[1] : p.width[2]);
  const int64_t n_i = p.rows * S;
  const bool active = i < n_i;
  // the pair's ring columns, in flight while the window table is made
  float x[RC];
  const int64_t r = S == 1 ? i : i / S, j = i - r * S;
  if (active) {
    const float* src = (f == 0 ? p.lane[0] : (f == 1 ? p.lane[1] : p.lane[2])) + r * ring * S + j;
    if (S == 1 && (ring & 3) == 0 && ((uintptr_t)src & 15) == 0) {
#pragma unroll
      for (int q = 0; q < RC / 4; ++q) {
        if (4 * q < ring) {
          const float4 v = reinterpret_cast<const float4*>(src)[q];
          x[4 * q] = v.x;
          x[4 * q + 1] = v.y;
          x[4 * q + 2] = v.z;
          x[4 * q + 3] = v.w;
        } else {
          x[4 * q] = x[4 * q + 1] = x[4 * q + 2] = x[4 * q + 3] = 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < RC; ++c) x[c] = c < ring ? src[c * S] : 0.0f;
    }
  }
  for (int32_t w = threadIdx.x; w < nwin; w += kThreads) {
    const int64_t e = p.end_panes[w0 + w];
    const int64_t lo_w = e - p.ppw > p.pane_lo ? e - p.ppw : p.pane_lo;
    const int64_t hi_w = e - 1 < p.pane_hi ? e - 1 : p.pane_hi;
    const int64_t span = hi_w - lo_w;
    const bool valid = p.w_valid[w0 + w] != 0;
    uint64_t mask = 0;
    if (valid && span >= 0) {
      // span + 1 live columns from lo_w's (span < ring: one live pane a
      // column), wrapping past the ring's end
      int32_t c = (int32_t)floor_mod(lo_w, ring);
      const int32_t n = span >= ring - 1 ? ring : (int32_t)span + 1;
      for (int32_t k = 0; k < n; ++k) {
        mask |= 1ull << c;
        if (++c == ring) c = 0;
      }
    }
    s_lo[w] = (uint32_t)mask;
    s_hi[w] = (uint32_t)(mask >> 32);
    s_valid[w] = valid;
  }
  __syncthreads();
  if (f == 0) {
    for (int32_t e = threadIdx.x; e < nwin * RC; e += kThreads) {
      const int32_t w = e / RC, c = e - w * RC;
      s_mul[e] = col_live(s_lo[w], s_hi[w], c) ? 1.0f : 0.0f;
    }
    __syncthreads();
  }
  // the block's outputs through shared memory (its pair k's window w at k
  // * stride + w, stride odd) when they are one run of memory
  const bool staged = S == 1 && nwin == p.W && p.W <= kLanesStageW;
  const int32_t stride = nwin | 1;
  float* out_f = f == 0 ? p.out[0] : (f == 1 ? p.out[1] : p.out[2]);
  if (active) {
    float* dst = out_f + (r * p.W + w0) * S + j;
    float* mine = s_out + (i - i0) * stride;
    if (f == 0) {
      for (int32_t w = 0; w < nwin; w += kLanesGroup) {
        // a window past the group reads window 0's multipliers, unused
        const float* mul[kLanesGroup];
        float a[kLanesGroup];
#pragma unroll
        for (int g = 0; g < kLanesGroup; ++g) {
          mul[g] = s_mul + (w + g < nwin ? w + g : 0) * RC;
          a[g] = 0.0f;
        }
#pragma unroll
        for (int q = 0; q < RC / 4; ++q) {
          float4 m[kLanesGroup];
#pragma unroll
          for (int g = 0; g < kLanesGroup; ++g)
            m[g] = reinterpret_cast<const float4*>(mul[g])[q];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = 4 * q + u;
            if (c < ring) {
#pragma unroll
              for (int g = 0; g < kLanesGroup; ++g)
                a[g] = fmaf(x[c], u == 0 ? m[g].x : u == 1 ? m[g].y : u == 2 ? m[g].z : m[g].w,
                            a[g]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kLanesGroup; ++g) {
          if (w + g >= nwin) continue;
          const float v = s_valid[w + g] ? a[g] : 0.0f;
          if (staged)
            mine[w + g] = v;
          else
            dst[(w + g) * S] = v;
        }
      }
    } else {
      // a max or a min: the columns as ordered keys, NaN the winning
      // extreme
      const bool is_max = f == 1;
      const int32_t nan_key = is_max ? INT32_MAX : INT32_MIN;
      int32_t k[RC];
#pragma unroll
      for (int c = 0; c < RC; ++c) k[c] = ordered_key(x[c], nan_key);
      const int32_t ident = ordered_key(is_max ? -INFINITY : INFINITY, 0);
      for (int32_t w = 0; w < nwin; w += kLanesGroup) {
        uint32_t lo[kLanesGroup], hi[kLanesGroup];
        int32_t a[kLanesGroup];
#pragma unroll
        for (int g = 0; g < kLanesGroup; ++g) {
          const bool in = w + g < nwin;
          lo[g] = in ? s_lo[w + g] : 0u;
          hi[g] = in ? s_hi[w + g] : 0u;
          a[g] = ident;
        }
        if (is_max) {
#pragma unroll
          for (int c = 0; c < RC; ++c)
#pragma unroll
            for (int g = 0; g < kLanesGroup; ++g)
              if (col_live(lo[g], hi[g], c)) a[g] = max(a[g], k[c]);
        } else {
#pragma unroll
          for (int c = 0; c < RC; ++c)
#pragma unroll
            for (int g = 0; g < kLanesGroup; ++g)
              if (col_live(lo[g], hi[g], c)) a[g] = min(a[g], k[c]);
        }
#pragma unroll
        for (int g = 0; g < kLanesGroup; ++g) {
          if (w + g >= nwin) continue;
          const float v = from_ordered_key(a[g]);
          if (staged)
            mine[w + g] = v;
          else
            dst[(w + g) * S] = v;
        }
      }
    }
  }
  if (staged) {
    __syncthreads();
    // the block's pairs' outputs are out_f[i0 * W, (i0 + n) * W)
    const int64_t n = n_i - i0 < kThreads ? n_i - i0 : kThreads;
    const uint32_t total = (uint32_t)(n * nwin);
    const FastDiv by_w = fast_div((uint32_t)nwin);
    float* out = out_f + i0 * nwin;
    for (uint32_t e = threadIdx.x; e < total; e += kThreads) {
      const uint32_t q = div_by(e, by_w);
      out[e] = s_out[q * stride + (e - q * nwin)];
    }
  }
}

// ---- TB: topn_select_lanes ---------------------------------------------------
// Candidates: cells with count > 0 on a registered row of a valid window.
// Per window, the threshold is the k-th largest ranking key (k = min(n,
// rows)) with ties counted, non-candidates keyed as -inf; a candidate at
// or above it (IEEE >=) is selected. Selected cells are compacted in
// row-major (row, window) order and appended to the emit ring as [row,
// end_pane - anchor, count, result columns...].
//
// Bound: bytes — the (rows x W) counts and ranking values read once, the
// used mask, and the appended rows (3 + F words each).
//
// Design: every kernel reads the row-major grid in tiles over the whole
// card, neighbouring threads on neighbouring cells, every load of a
// thread in flight before the first test (a block a window would hold W
// of the 132 SMs and read one word of each row's W). A cell's key is its
// total-order key (total_key) with the sign bit flipped, so unsigned
// order is IEEE total order; a non-candidate's is -inf's (kNonCand).
//   k = 1   lanes_max_kernel: a block's per-window maximum of its
//           candidates in shared memory (and a flag when it saw a
//           non-candidate), then one 64-bit atomicMax a window of (epoch,
//           key) into the workspace: exact, in any order, and an older
//           call's value always loses.
//   k > 1   an MSB-first radix select on the keys, 8 bits a digit, four
//           passes. Pass p histograms, per window, digit p of the
//           candidates' keys whose higher digits equal the window's prefix
//           so far (shared-memory atomics, merged by global atomics); the
//           non-candidates are counted once (rows less the candidates) and
//           stand in -inf's bin while -inf matches the prefix. The last
//           block to finish a pass picks each window's digit and the count
//           still needed below it, a warp a window, and clears the bins.
//           After four passes the prefix is the k-th key. Where the grid's
//           blocks fit on the card at once, lanes_radix_all_kernel runs
//           the passes and the selection in one cooperative launch (grid
//           barriers between passes, the keys kept in registers); else
//           lanes_radix_kernel runs a launch a pass.
//   then    select_tile: the selection and the append in the same launch,
//           each tile's place from lookback.cuh's look-back; the grid's
//           last tile updates the ring's head and advances the epoch
//           (lanes_select_kernel after the max or the per-pass passes).
// Launches a call: 2 at k = 1; above, 1 (cooperative) or 5. A small grid
// takes the same kernels with few blocks (no single-block form is kept).
//   The rules are the plain version's: a -NaN candidate at the k-th place
// gives a NaN threshold (nothing selected), as lax.top_k over the masked
// grid does; a window with fewer candidates than k gets -inf.
//   The workspace (window_kernels.py clean_workspace; its layout by the
// capacities it was allocated for, select_work_words) holds the ring's
// old head, the radix passes' done counter, the epoch, the grid
// barrier's words, each window's tagged threshold, radix prefix, count
// still needed, non-candidate count and bins, and a descriptor a
// selection tile.
constexpr int kThrItems = 8;                     // cells a thread, threshold passes
constexpr int kThrCells = kThreads * kThrItems;  // cells a threshold block
constexpr int kSelItems = 4;                     // cells a thread, lanes_select_kernel
constexpr int kSelCells = kThreads * kSelItems;  // cells a selection tile (8 a thread
                                                 // measured slower: 0.0078 against 0.0067 ms)
constexpr int kSelWinTable = 64;                 // windows of a block's table
constexpr int kRadixWindows = 32;                // windows a radix block histograms

struct SelParams {
  const int32_t* wcounts;
  const float* v;
  const int32_t* cols;
  int32_t F;
  int64_t rows;
  int32_t W, k, sel_cap, row_cap, ring_cols;
  const uint8_t* used;
  const int64_t* end_panes;
  const uint8_t* w_valid;
  int64_t anchor;
  int32_t* ring;
  // the workspace
  long long* old_total;
  unsigned int* done;
  uint32_t* epoch;
  unsigned long long* thresh;  // (epoch << 32) | key, a window
  uint32_t* prefix;
  uint32_t* need;
  uint32_t* noncand;
  uint32_t* hist;     // 256 a window
  unsigned int* bar;  // the grid barrier's count and generation
  unsigned long long* desc;
  int64_t tiles;
};

// int32 key whose integer order is IEEE total order on f32
__device__ __forceinline__ int32_t total_key(float x) {
  const int32_t b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float from_total_key(int32_t k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// the unsigned key of -inf, every non-candidate's
constexpr uint32_t kNonCand = 0x007FFFFFu;  // total_key(-inf) ^ 0x80000000

// the workspace's unsigned threshold key as the f32 it ranks
__device__ __forceinline__ float thresh_value(unsigned long long t) {
  return from_total_key((int32_t)((uint32_t)t ^ 0x80000000u));
}

// a threshold block's cells: thread t takes cells a + t + kThreads * j,
// so each load of the block reads consecutive words; (r, w) of each
// step follow without a division
struct GridWalk {
  int64_t i, r;
  int32_t w, dr, dw, W;
  __device__ __forceinline__ GridWalk(int64_t i0, int32_t W_) : i(i0), W(W_) {
    r = i0 / W_;
    w = (int32_t)(i0 - r * W_);
    dr = kThreads / W_;
    dw = kThreads % W_;
  }
  __device__ __forceinline__ void next() {
    i += kThreads;
    r += dr;
    w += dw;
    if (w >= W) {
      w -= W;
      ++r;
    }
  }
};

// a threshold block's cells of windows [g0, g0 + gw): win = the window
// less g0 (-1: a cell outside them or the grid), cand = a candidate, key
// its unsigned key; every load in flight before the first test
__device__ __forceinline__ void walk_keys(const SelParams& p, int32_t g0, int32_t gw,
                                          uint32_t (&key)[kThrItems], int32_t (&win)[kThrItems],
                                          bool (&cand)[kThrItems]) {
  const int64_t K = p.rows * (int64_t)p.W;
  GridWalk g((int64_t)blockIdx.x * kThrCells + threadIdx.x, p.W);
  int32_t wc[kThrItems];
  float v[kThrItems];
  uint8_t used[kThrItems], valid[kThrItems];
#pragma unroll
  for (int j = 0; j < kThrItems; ++j) {
    const int32_t wl = g.w - g0;
    win[j] = g.i < K && wl >= 0 && wl < gw ? wl : -1;
    wc[j] = 0;
    v[j] = 0.0f;
    used[j] = valid[j] = 0;
    if (win[j] >= 0) {
      wc[j] = p.wcounts[g.i];
      v[j] = p.v[g.i];
      used[j] = p.used[g.r];
      valid[j] = p.w_valid[g.w];
    }
    g.next();
  }
#pragma unroll
  for (int j = 0; j < kThrItems; ++j) {
    cand[j] = win[j] >= 0 && wc[j] > 0 && valid[j] && used[j];
    key[j] = (uint32_t)total_key(v[j]) ^ 0x80000000u;
  }
}

__global__ void __launch_bounds__(kThreads) lanes_max_kernel(const SelParams p) {
  __shared__ uint32_t s_max[kSelWinTable];
  __shared__ uint8_t s_seen[kSelWinTable], s_nc[kSelWinTable];
  __shared__ uint32_t s_epoch;
  const int32_t W = p.W;
  const bool table = W <= kSelWinTable;
  uint32_t key[kThrItems];
  int32_t win[kThrItems];
  bool cand[kThrItems];
  walk_keys(p, 0, W, key, win, cand);
  if (table)
    for (int32_t w = threadIdx.x; w < W; w += kThreads) {
      s_max[w] = 0;
      s_seen[w] = s_nc[w] = 0;
    }
  if (threadIdx.x == 0) {
    s_epoch = *(volatile const uint32_t*)p.epoch;
    if (blockIdx.x == 0) *p.old_total = p.ring[0];
  }
  __syncthreads();
  const unsigned long long tag = (unsigned long long)s_epoch << 32;
#pragma unroll
  for (int j = 0; j < kThrItems; ++j) {
    if (win[j] < 0) continue;
    const uint32_t k = cand[j] ? key[j] : kNonCand;
    if (!table) {
      atomicMax(&p.thresh[win[j]], tag | k);
    } else if (cand[j]) {
      atomicMax(&s_max[win[j]], k);
      s_seen[win[j]] = 1;
    } else {
      s_nc[win[j]] = s_seen[win[j]] = 1;
    }
  }
  __syncthreads();
  if (table)
    for (int32_t w = threadIdx.x; w < W; w += kThreads)
      if (s_seen[w])
        atomicMax(&p.thresh[w], tag | (s_nc[w] && s_max[w] < kNonCand ? kNonCand : s_max[w]));
}

// A radix pick for one window, a warp: pass ``pass``'s bins h (lane l
// holds bins 255 - 8l down to 248 - 8l), the prefix so far, the count
// still needed and (past pass 0) the window's non-candidate count. The
// non-candidates stand in -inf's bin while -inf matches the prefix (pass
// 0 counts them: the rows less the candidates); the lane whose bins hold
// the key still needed walks them. Every lane gets the new prefix, the
// count still needed below it and the non-candidate count.
struct RadixPick {
  uint32_t prefix, need, noncand;
};

__device__ __forceinline__ RadixPick radix_pick(const uint32_t* h, int pass, uint32_t pre,
                                                uint32_t need, uint32_t nc, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int shift = 24 - 8 * pass;
  const uint32_t above = pass ? 0xFFFFFFFFu << (shift + 8) : 0u;
  uint32_t b[8];
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    b[i] = __ldcg(h + 255 - 8 * lane - i);
    sum += b[i];
  }
  if (pass == 0) {
    uint32_t cands = sum;
    for (int o = 16; o > 0; o >>= 1) cands += __shfl_xor_sync(0xffffffffu, cands, o);
    nc = (uint32_t)(rows - cands);
  }
  if ((kNonCand & above) == (pre & above)) {
    const int at = 255 - (int)((kNonCand >> shift) & 255);  // 8 lane + i
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (8 * lane + i == at) {
        b[i] += nc;
        sum += nc;
      }
  }
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  const uint32_t higher = incl - sum;  // keys in the higher bins
  const bool mine = higher < need && need <= incl;
  const unsigned who = __ballot_sync(0xffffffffu, mine);
  uint32_t digit = 0, left = need;
  if (mine) {
    uint32_t c = higher;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c + b[i] >= need) {
        digit = 255 - 8 * lane - i;
        left = need - c;
        break;
      }
      c += b[i];
    }
  }
  const int src = who ? __ffs(who) - 1 : 0;
  RadixPick r;
  r.prefix = pre | (__shfl_sync(0xffffffffu, digit, src) << shift);
  r.need = __shfl_sync(0xffffffffu, left, src);
  r.noncand = nc;
  return r;
}

// a block's histogram of pass ``pass`` over its cells (windows [g0, g0 +
// gw), pre: their prefixes in shared memory), merged into h
__device__ __forceinline__ void radix_histogram(uint32_t* s_hist, const uint32_t* s_pre,
                                                const uint32_t (&key)[kThrItems],
                                                const int32_t (&win)[kThrItems],
                                                const bool (&cand)[kThrItems], int pass,
                                                int32_t gw, uint32_t* h) {
  const int shift = 24 - 8 * pass;
  // the digits above this pass's must equal the window's prefix
  const uint32_t above = pass ? 0xFFFFFFFFu << (shift + 8) : 0u;
  for (int32_t e = threadIdx.x; e < gw * 256; e += kThreads) s_hist[e] = 0;
  __syncthreads();
  // (a warp's atomics on one bin merged by __match_any_sync measured
  // slower: 2.3 against 1.1 us a pass at job T's top-3)
#pragma unroll
  for (int j = 0; j < kThrItems; ++j)
    if (cand[j] && (key[j] & above) == (s_pre[win[j]] & above))
      atomicAdd(&s_hist[win[j] * 256 + ((key[j] >> shift) & 255)], 1u);
  __syncthreads();
  for (int32_t e = threadIdx.x; e < gw * 256; e += kThreads)
    if (s_hist[e]) atomicAdd(&h[e], s_hist[e]);
}

// the last radix block's picks of pass ``pass`` for every window, a warp
// a window: into the workspace's prefix, need and non-candidate count
// (the thresholds after pass 3); each window's bins cleared
__device__ __forceinline__ void radix_pick_all(const SelParams& p, int pass, uint32_t epoch) {
  const unsigned long long tag = (unsigned long long)epoch << 32;
  for (int32_t w = threadIdx.x >> 5; w < p.W; w += kWarps) {
    uint32_t* h = p.hist + (int64_t)w * 256;
    const RadixPick r = radix_pick(h, pass, pass ? __ldcg(p.prefix + w) : 0u,
                                   pass ? __ldcg(p.need + w) : (uint32_t)p.k,
                                   pass ? __ldcg(p.noncand + w) : 0u, p.rows);
    for (int i = threadIdx.x & 31; i < 256; i += 32) h[i] = 0;
    if ((threadIdx.x & 31) == 0) {
      p.prefix[w] = r.prefix;
      p.need[w] = r.need;
      p.noncand[w] = r.noncand;
      if (pass == 3) p.thresh[w] = tag | r.prefix;
    }
  }
}

// k > 1 otherwise: one launch a pass (windows in groups of
// kRadixWindows on the grid's y), the bins H_0 only; the last block to
// finish picks every window's digit into the workspace and clears the
// bins.
__global__ void __launch_bounds__(kThreads) lanes_radix_kernel(const SelParams p, int pass) {
  __shared__ uint32_t s_hist[kRadixWindows * 256];
  __shared__ uint32_t s_pre[kRadixWindows];
  __shared__ uint32_t s_epoch;
  __shared__ int s_flag;
  const int32_t W = p.W, g0 = blockIdx.y * kRadixWindows;
  const int32_t gw = W - g0 < kRadixWindows ? W - g0 : kRadixWindows;
  // the prefixes and the epoch in flight with the grid's loads
  const uint32_t pre = pass && (int32_t)threadIdx.x < gw ? p.prefix[g0 + threadIdx.x] : 0u;
  const uint32_t epoch = threadIdx.x == 0 ? *(volatile const uint32_t*)p.epoch : 0u;
  uint32_t key[kThrItems];
  int32_t win[kThrItems];
  bool cand[kThrItems];
  walk_keys(p, g0, gw, key, win, cand);
  if ((int32_t)threadIdx.x < gw) s_pre[threadIdx.x] = pre;
  if (threadIdx.x == 0) {
    s_epoch = epoch;
    if (pass == 0 && blockIdx.x == 0 && blockIdx.y == 0) *p.old_total = p.ring[0];
  }
  radix_histogram(s_hist, s_pre, key, win, cand, pass, gw, p.hist + (int64_t)g0 * 256);
  if (last_block(p.done, gridDim.x * gridDim.y, &s_flag)) radix_pick_all(p, pass, s_epoch);
}

// One selection tile (kItems consecutive cells a thread, tile =
// blockIdx.x): the test against the thresholds, the rank in the tile, the
// place among all p.tiles tiles by the look-back, the appended rows; the
// grid's last tile updates the ring's head and advances the epoch.
// kTable: W <= kSelWinTable, the thresholds in a block table (a run-time
// choice let the compiler load both sides).
template <bool kTable, int kItems>
__device__ __forceinline__ void select_tile(const SelParams& p) {
  __shared__ float s_thr[kSelWinTable];
  __shared__ int s_scan[kWarps];
  __shared__ int s_total, s_min[kWarps];
  __shared__ long long s_sum[kWarps];
  __shared__ uint32_t s_epoch;
  const int32_t W = p.W;
  const int64_t tile = blockIdx.x, K = p.rows * (int64_t)W;
  const int64_t first = (tile * kThreads + threadIdx.x) * kItems;
  const int64_t r0 = first / W;
  const int32_t w0 = (int32_t)(first - r0 * W);
  uint32_t sel = 0;
  {
    // every load in flight before the first test
    int32_t wc[kItems];
    float v[kItems];
    uint8_t used[kItems], valid[kItems];
    int64_t r = r0;
    int32_t w = w0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = first + j;
      wc[j] = 0;
      v[j] = 0.0f;
      used[j] = valid[j] = 0;
      if (i < K) {
        wc[j] = p.wcounts[i];
        v[j] = p.v[i];
        used[j] = p.used[r];
        valid[j] = p.w_valid[w];
      }
      if (++w == W) {
        w = 0;
        ++r;
      }
    }
    if (kTable)
      for (int32_t x = threadIdx.x; x < W; x += kThreads)
        s_thr[x] = thresh_value(__ldcg(p.thresh + x));
    if (threadIdx.x == 0) s_epoch = *(volatile const uint32_t*)p.epoch;
    __syncthreads();
    w = w0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (wc[j] > 0 && valid[j] && used[j] &&
          v[j] >= (kTable ? s_thr[w] : thresh_value(__ldcg(p.thresh + w))))
        sel |= 1u << j;
      if (++w == W) w = 0;
    }
  }
  const uint32_t epoch = s_epoch;
  const int before = block_scan_total(__popc(sel), s_scan, &s_total);
  const int tile_n = s_total;
  lb_publish(p.desc, tile, tile_n, epoch);
  const long long excl = lookback_exclusive(p.desc, tile, tile_n, epoch, s_sum, s_min);
  const long long total = __ldcg(p.old_total);
  if (tile == p.tiles - 1 && threadIdx.x == 0) {
    const long long all = excl + tile_n;
    const long long written = all < p.sel_cap ? all : p.sel_cap;
    p.ring[0] = (int32_t)(total + written);
    p.ring[1] += (int32_t)(all - written);
    lb_advance(p.epoch, epoch);
  }
  if (sel) {
    long long pos = excl + before;
    int64_t r = r0;
    int32_t w = w0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (((sel >> j) & 1) && pos < p.sel_cap) {
        const int64_t i = first + j;
        int32_t* dst = p.ring + ((total + pos) % p.row_cap + 1) * p.ring_cols;
        dst[0] = (int32_t)r;
        dst[1] = (int32_t)(p.end_panes[w] - p.anchor);
        dst[2] = p.wcounts[i];
        for (int32_t f = 0; f < p.F; ++f) dst[3 + f] = p.cols[i * p.F + f];
      }
      pos += (sel >> j) & 1;
      if (++w == W) {
        w = 0;
        ++r;
      }
    }
  }
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads) lanes_select_kernel(const SelParams p) {
  select_tile<kTable, kSelItems>(p);
}

// k > 1, when the threshold blocks fit on the card at once (a
// cooperative launch) and W <= kRadixWindows: the four passes and the
// selection in one launch. Each block loads its cells once and keeps their keys in
// registers. After each pass's histogram the blocks meet at a grid
// barrier whose last arrival picks every window's digit (as the last
// block of lanes_radix_kernel does) before it releases the others, who
// then read the windows' new prefixes; after the last, every block
// selects its own cells (select_tile, a tile of kThrCells). The four passes alone took 0.0263 ms
// at job T's top-3 on the H100; two other forms measured slower there:
// every block picking from the merged bins itself (0.0369 ms: the bins'
// lines hot in L2, 3-5 us a pick), and a launch a pass
// (lanes_radix_kernel, kept for the grids that do not fit: 0.0324-0.0355
// ms). PERF.md §6 has the figures.
__global__ void __launch_bounds__(kThreads) lanes_radix_all_kernel(const SelParams p) {
  __shared__ uint32_t s_hist[kRadixWindows * 256];
  __shared__ uint32_t s_pre[kRadixWindows];
  __shared__ uint32_t s_epoch;
  __shared__ int s_flag;
  const int32_t W = p.W;
  unsigned int* count = p.bar;
  unsigned int* gen = p.bar + 1;
  uint32_t key[kThrItems];
  int32_t win[kThrItems];
  bool cand[kThrItems];
  walk_keys(p, 0, W, key, win, cand);
  for (int32_t w = threadIdx.x; w < W; w += kThreads) s_pre[w] = 0;
  if (threadIdx.x == 0) {
    s_epoch = *(volatile const uint32_t*)p.epoch;
    if (blockIdx.x == 0) *p.old_total = p.ring[0];
  }
  for (int pass = 0; pass < 4; ++pass) {
    radix_histogram(s_hist, s_pre, key, win, cand, pass, W, p.hist);
    // the grid barrier; its last arrival picks, then releases the others
    __syncthreads();
    unsigned int g = 0;
    if (threadIdx.x == 0) {
      g = *(volatile unsigned int*)gen;
      __threadfence();
      s_flag = atomicAdd(count, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (s_flag) {
      __threadfence();
      radix_pick_all(p, pass, s_epoch);
      __syncthreads();
      if (threadIdx.x == 0) {
        *(volatile unsigned int*)count = 0;
        __threadfence();
        atomicAdd(gen, 1u);
      }
    } else if (threadIdx.x == 0) {
      while (*(volatile unsigned int*)gen == g) __nanosleep(32);
      __threadfence();
    }
    __syncthreads();
    if (pass < 3)
      for (int32_t w = threadIdx.x; w < W; w += kThreads) s_pre[w] = __ldcg(p.prefix + w);
  }
  select_tile<true, kThrItems>(p);
}

}  // namespace

extern "C" {

const char* tl_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// window_lanes' argument block (topn_lanes_kernels.py _LANES_ARGS), every
// field 64 bits: the lanes and their widths, the fire, the three
// outputs, then the plan (_lanes_plan)
struct LanesArgs {
  int64_t sums, maxs, mins, sw, mw, nw;
  int64_t rows, ring, end_panes, w_valid, W, pane_lo, pane_hi, ppw;
  int64_t out_s, out_x, out_n;
  int64_t tile_rows, win_group, lane_group, col_chunk;
};

int tl_window_lanes(const LanesArgs* a, void* stream) {
  const int64_t L = a->sw + a->mw + a->nw;
  if (a->rows <= 0 || a->W <= 0 || L <= 0) return (int)cudaGetLastError();
  const int64_t nr = a->tile_rows, nw = a->win_group, nl = a->lane_group, cn = a->col_chunk;
  // the plan must fit this kernel's tables: outputs a block, windows a
  // block, the staged tile (odd row stride) and the packed tile offsets
  // the plan must fit this kernel's tables: outputs a block, windows a
  // block, and the staged tile (each family's row stride odd)
  if (a->ring < 1 || a->ring >= (1ll << 31) || a->W >= (1ll << 31) || L >= (1ll << 31) ||
      nr < 1 || nr >= (1ll << 31) || nw < 1 || nw > kLanesWindows || nl < 1 || cn < 1 ||
      cn > a->ring || nr * nw * nl > kThreads || nr * (cn * nl + 3) > kLanesSmemFloats)
    return (int)cudaErrorInvalidValue;
  LanesParams p{};
  p.lane[0] = (const float*)a->sums;
  p.lane[1] = (const float*)a->maxs;
  p.lane[2] = (const float*)a->mins;
  p.out[0] = (float*)a->out_s;
  p.out[1] = (float*)a->out_x;
  p.out[2] = (float*)a->out_n;
  p.width[0] = (int32_t)a->sw;
  p.width[1] = (int32_t)a->mw;
  p.width[2] = (int32_t)a->nw;
  p.rows = a->rows;
  p.ring = (int32_t)a->ring;
  p.W = (int32_t)a->W;
  p.ppw = (int32_t)a->ppw;
  p.end_panes = (const int64_t*)a->end_panes;
  p.w_valid = (const uint8_t*)a->w_valid;
  p.pane_lo = a->pane_lo;
  p.pane_hi = a->pane_hi;
  p.tile_rows = (int32_t)nr;
  p.win_group = (int32_t)nw;
  p.lane_group = (int32_t)nl;
  p.col_chunk = (int32_t)cn;
  if (a->ring <= 64) {
    // the register form: a (row, lane) pair a thread
    const int64_t nb[3] = {(a->rows * a->sw + kThreads - 1) / kThreads,
                           (a->rows * a->mw + kThreads - 1) / kThreads,
                           (a->rows * a->nw + kThreads - 1) / kThreads};
    const int64_t gxr = nb[0] + nb[1] + nb[2], gyr = (a->W + nw - 1) / nw;
    if (gxr >= (1ll << 31) || gyr > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)gxr, (unsigned)gyr);
    cudaStream_t s = (cudaStream_t)stream;
    if (a->ring <= 32)
      window_lanes_reg_kernel<32><<<grid, kThreads, 0, s>>>(p, (int32_t)nb[0], (int32_t)nb[1]);
    else
      window_lanes_reg_kernel<64><<<grid, kThreads, 0, s>>>(p, (int32_t)nb[0], (int32_t)nb[1]);
    return (int)cudaGetLastError();
  }
  const int64_t gx = (a->rows + nr - 1) / nr, gy = (a->W + nw - 1) / nw, gz = (L + nl - 1) / nl;
  if (gx >= (1ll << 31) || gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(nr * (cn * nl + 3)) * sizeof(float);
  window_lanes_kernel<<<dim3((unsigned)gx, (unsigned)gy, (unsigned)gz), kThreads, smem,
                        (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// topn_select_lanes' argument block (topn_lanes_kernels.py
// _TOPN_SELECT_LANES), every field 64 bits: the grid, the fire, the emit
// ring and the clean workspace with the window and tile capacities its
// layout is cut for (select_work_words)
struct SelectArgs {
  int64_t wcounts, v, cols, F, rows, W, used, end_panes, w_valid, anchor, k, sel_cap;
  int64_t ring, ring_rows, ring_cols, work, work_windows, work_tiles;
};

// the workspace's int64 words for Wc windows and Tc selection tiles: the
// ring's old head; the done counter and the epoch; the grid barrier's two
// words; a tagged threshold a window; each window's prefix, count still
// needed, non-candidate count and 256 bins (32-bit words); a descriptor
// a tile (topn_lanes_kernels.py _select_work_words)
inline int64_t select_work_words(int64_t Wc, int64_t Tc) {
  return 3 + Wc + (Wc * (3 + 256) + 1) / 2 + Tc;
}

// the threshold blocks the card holds at once for lanes_radix_all_kernel
// (its cooperative launch), once a device
int radix_all_capacity() {
  static int capacity[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!capacity[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lanes_radix_all_kernel, kThreads,
                                                      0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    capacity[dev] = per_sm * sms;
  }
  return capacity[dev];
}

int tl_topn_select_lanes_packed(const SelectArgs* a, void* stream) {
  const int64_t K = a->rows * a->W;
  if (K <= 0 || a->W <= 0 || a->k <= 0) return (int)cudaGetLastError();
  const int64_t tiles = (K + kSelCells - 1) / kSelCells;
  const int64_t blocks = (K + kThrCells - 1) / kThrCells;
  const int64_t groups = (a->W + kRadixWindows - 1) / kRadixWindows;
  const int64_t Wc = a->work_windows, Tc = a->work_tiles;
  if (a->W >= (1ll << 31) || a->rows >= (1ll << 32) || tiles >= (1ll << 31) ||
      blocks >= (1ll << 31) || groups > 65535 || a->ring_rows < 3 || Wc < a->W || Tc < tiles)
    return (int)cudaErrorInvalidValue;
  SelParams p{};
  p.wcounts = (const int32_t*)a->wcounts;
  p.v = (const float*)a->v;
  p.cols = (const int32_t*)a->cols;
  p.F = (int32_t)a->F;
  p.rows = a->rows;
  p.W = (int32_t)a->W;
  p.k = (int32_t)a->k;
  p.sel_cap = (int32_t)a->sel_cap;
  p.row_cap = (int32_t)(a->ring_rows - 2);
  p.ring_cols = (int32_t)a->ring_cols;
  p.used = (const uint8_t*)a->used;
  p.end_panes = (const int64_t*)a->end_panes;
  p.w_valid = (const uint8_t*)a->w_valid;
  p.anchor = a->anchor;
  p.ring = (int32_t*)a->ring;
  int64_t* work = (int64_t*)a->work;
  p.old_total = (long long*)work;
  p.done = (unsigned int*)(work + 1);
  p.epoch = (uint32_t*)(work + 1) + 1;
  p.bar = (unsigned int*)(work + 2);
  p.thresh = (unsigned long long*)(work + 3);
  p.prefix = (uint32_t*)(work + 3 + Wc);
  p.need = p.prefix + Wc;
  p.noncand = p.need + Wc;
  p.hist = p.noncand + Wc;
  p.desc = (unsigned long long*)(work + 3 + Wc + (Wc * (3 + 256) + 1) / 2);
  p.tiles = tiles;
  cudaStream_t s = (cudaStream_t)stream;
  if (a->k > 1 && a->W <= kRadixWindows && blocks <= radix_all_capacity()) {
    p.tiles = blocks;  // it selects a threshold block's cells a tile
    void* args[] = {(void*)&p};
    return (int)cudaLaunchCooperativeKernel((const void*)lanes_radix_all_kernel,
                                            dim3((unsigned)blocks), dim3(kThreads), args, 0, s);
  }
  if (a->k == 1) {
    lanes_max_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(p);
  } else {
    for (int pass = 0; pass < 4; ++pass) {
      lanes_radix_kernel<<<dim3((unsigned)blocks, (unsigned)groups), kThreads, 0, s>>>(p, pass);
      const int rc = (int)cudaGetLastError();
      if (rc) return rc;
    }
  }
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  if (a->W <= kSelWinTable)
    lanes_select_kernel<true><<<(unsigned)tiles, kThreads, 0, s>>>(p);
  else
    lanes_select_kernel<false><<<(unsigned)tiles, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
