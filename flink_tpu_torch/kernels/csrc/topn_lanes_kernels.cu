// Top-n fires over lane aggregates, hand-written for Hopper (sm_90a):
// top-n by any result field of any aggregate, beside the count-only form
// of window_fire.cuh (K3); both select with topn_select.cuh. Plain C
// interface, bound from Python with ctypes
// (flink_tpu_torch/kernels/topn_lanes_kernels.py); every entry point
// launches on the caller's stream, allocates nothing (the wrapper passes
// scratch) and returns cudaGetLastError().
//
// TA window_lanes         replaces flink_tpu/ops/window.py:318-346, the
//                         sum / max / min lanes of fire_kernel over the
//                         whole (rows, W) grid
// TB topn_select_lanes    replaces flink_tpu/ops/window.py:547
//                         _ring_append_topn_core + :456
//                         _topn_select_append, for a ranking field other
//                         than a count-only aggregate's count
// TC topn_candidates_lanes    replaces flink_tpu/ops/window.py:1585-1610
//                         topn_shard's lax.top_k(v.T, k) over a block's
//                         -inf-masked ranking grid (any result field)
// TD topn_select_lanes_given  replaces :1611-1617, topn_shard's
//                         lax.top_k(all_top, k)[0][:, k - 1] and
//                         _topn_select_append with a row offset
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
#include "topn_select.cuh"
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
struct SmallDiv {
  uint32_t d, m;
};

__device__ __forceinline__ SmallDiv small_div(uint32_t d) {
  return SmallDiv{d, d > 1 ? 0xFFFFFFFFu / d + 1 : 0u};
}

__device__ __forceinline__ uint32_t div_by(uint32_t n, SmallDiv f) {
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
      const SmallDiv by_row = small_div(row_len), by_lane = small_div((uint32_t)nf[g]);
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
    const SmallDiv by_w = small_div((uint32_t)nwin);
    float* out = out_f + i0 * nwin;
    for (uint32_t e = threadIdx.x; e < total; e += kThreads) {
      const uint32_t q = div_by(e, by_w);
      out[e] = s_out[q * stride + (e - q * nwin)];
    }
  }
}

// ---- TB: topn_select_lanes ---------------------------------------------------
// topn_select.cuh's lane form: candidates rank by the ranking grid v, and
// each appended row carries the cell's F result columns. Bound and design
// there; the count form (window_fire.cuh K3) runs the same bodies.
__global__ void __launch_bounds__(kThreads) lanes_max_kernel(const SelParams p) {
  sel_max<false>(p);
}

__global__ void __launch_bounds__(kThreads) lanes_radix_kernel(const SelParams p, int pass) {
  sel_radix<false>(p, pass);
}

__global__ void __launch_bounds__(kThreads) lanes_radix_all_kernel(const SelParams p) {
  sel_radix_all<false>(p);
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads) lanes_select_kernel(const SelParams p) {
  select_tile<false, kTable, kSelItems>(p);
}

int g_lanes_capacity[64];
const SelKernels kLanesKernels{lanes_max_kernel,           lanes_radix_kernel,
                               lanes_radix_all_kernel,     lanes_select_kernel<true>,
                               lanes_select_kernel<false>, g_lanes_capacity};

// ---- TC / TD: the key-sharded top-n over lanes --------------------------------
// The mesh's top-n by a result field (the reference's topn_shard, lane
// form): each block's top k a window of its ranking grid (TC, the
// count form's topn_candidates bodies on v: tiles over the whole card,
// one launch up to top-16, the radix select above), written into the
// block's columns of the gathered (W, blocks * k) buffer; then each
// block's selection against the window's k-th of that buffer (TD,
// select_tile's given mode, one launch, W <= kSelWinTable), its rows
// appended with the block's first global row as the offset. Both rank
// by total-order keys: the candidates stay f32 in the buffer, ranked by
// their keys across blocks (kth_windows_key), so +NaN, -0 / +0 and -inf
// keep lax.top_k's order; the selection compares v >= k-th in IEEE.
// Bound: bytes — TC reads the (rows x W) counts and ranking grid once
// and writes (W x k) f32; TD reads the counts, the grid and the gathered
// buffer once and writes the appended rows (3 + F words each).
__global__ void __launch_bounds__(kThreads) lanes_cand_max_kernel(const SelParams p) {
  sel_max<false, kCandItems>(p);
  cand_max_tail(p);
}

template <int KS>
__global__ void __launch_bounds__(kThreads) lanes_cand_merge_kernel(const SelParams p) {
  cand_merge<KS, false>(p);
}

__global__ void __launch_bounds__(kThreads) lanes_cand_radix_all_kernel(const SelParams p) {
  cand_radix_all<false>(p);
}

__global__ void __launch_bounds__(kThreads) lanes_cand_collect_kernel(const SelParams p) {
  cand_collect_all<false>(p);
}

__global__ void __launch_bounds__(kThreads) lanes_cand_sort_kernel(const SelParams p) {
  cand_sort_all(p);
}

__global__ void __launch_bounds__(kThreads) lanes_given_kernel(const SelParams p) {
  select_tile<false, true, kSelItems, true>(p);
}

int g_lanes_cand_capacity[64];
const CandKernels kLanesCandKernels{lanes_cand_max_kernel,
                                    lanes_cand_merge_kernel<4>,
                                    lanes_cand_merge_kernel<kCandSmallK>,
                                    lanes_radix_kernel,
                                    lanes_cand_radix_all_kernel,
                                    lanes_cand_collect_kernel,
                                    lanes_cand_sort_kernel,
                                    g_lanes_cand_capacity};
// the given mode takes the table form only (W <= kSelWinTable)
const SelKernels kLanesGivenKernels{nullptr, nullptr, nullptr, lanes_given_kernel, nullptr,
                                    g_lanes_capacity};

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

int tl_topn_select_lanes_packed(const SelectArgs* a, void* stream) {
  if (a->W >= (1ll << 31) || a->k >= (1ll << 31) || a->ring_rows < 3)
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
  p.src = host_fire(0, 0, a->anchor);
  p.ring = (int32_t*)a->ring;
  return launch_select(p, (int64_t*)a->work, a->work_windows, a->work_tiles, kLanesKernels,
                       (cudaStream_t)stream);
}

// topn_candidates_lanes' argument block (topn_lanes_kernels.py
// _TOPN_CANDIDATES_LANES), every field 64 bits: the grid, k, the (W, k)
// output with its row stride, the scratch list (cand_list_words uint32
// words; 0 at k = 1) and the clean workspace
struct CandArgs {
  int64_t wcounts, v, rows, W, used, w_valid, k, out, out_ld, list, list_words;
  int64_t work, work_windows, work_tiles;
};

int tl_topn_candidates_lanes_packed(const CandArgs* a, void* stream) {
  if (a->W >= (1ll << 31) || a->k < 1 || a->k >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  SelParams p{};
  p.wcounts = (const int32_t*)a->wcounts;
  p.v = (const float*)a->v;
  p.rows = a->rows;
  p.W = (int32_t)a->W;
  p.k = (int32_t)a->k;
  p.used = (const uint8_t*)a->used;
  p.w_valid = (const uint8_t*)a->w_valid;
  p.cand_out = (float*)a->out;
  p.cand_ld = a->out_ld;
  p.cand_list = (uint32_t*)a->list;
  return launch_candidates(p, a->list_words, (int64_t*)a->work, a->work_windows, a->work_tiles,
                           kLanesCandKernels, (cudaStream_t)stream);
}

// topn_select_lanes_given's argument block (topn_lanes_kernels.py
// _TOPN_SELECT_LANES_GIVEN): topn_select_lanes' fields, then the gathered
// (W, M) candidates and the block's row offset
struct GivenArgs {
  int64_t wcounts, v, cols, F, rows, W, used, end_panes, w_valid, anchor, k, sel_cap;
  int64_t ring, ring_rows, ring_cols, work, work_windows, work_tiles;
  int64_t given, given_m, row_offset;
};

int tl_topn_select_lanes_given_packed(const GivenArgs* a, void* stream) {
  if (a->W >= (1ll << 31) || a->k < 1 || a->k > a->given_m || a->given_m >= (1ll << 31) ||
      a->ring_rows < 3 || a->row_offset < 0 || a->row_offset >= (1ll << 31))
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
  p.row_offset = (int32_t)a->row_offset;
  p.used = (const uint8_t*)a->used;
  p.end_panes = (const int64_t*)a->end_panes;
  p.w_valid = (const uint8_t*)a->w_valid;
  p.src = host_fire(0, 0, a->anchor);
  p.given = (const float*)a->given;
  p.given_m = (int32_t)a->given_m;
  p.ring = (int32_t*)a->ring;
  return launch_select(p, (int64_t*)a->work, a->work_windows, a->work_tiles, kLanesGivenKernels,
                       (cudaStream_t)stream);
}

}  // extern "C"
