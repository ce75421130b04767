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

#include "compact.cuh"
#include "window_common.cuh"

namespace {

// ---- TA: window_lanes --------------------------------------------------------
// out_s[r, w, :] = sum over ring columns c (in column order) of
// sums[r, c, :] * live(w, c); out_x / out_n = IEEE max / min of maxs /
// mins over the live columns (identity -inf / +inf when none). Column c
// is live for window w when it holds a pane of [end_w - ppw, end_w) ∩
// [pane_lo, pane_hi] (the reference's column mask; at most one live pane
// per column). An invalid window (!w_valid[w]) gets the identities.
//
// Bound: bytes — the lanes read once (rows x ring x (S + M + N) x 4) and
// the (rows x W x (S + M + N)) output written once. Design: one thread per
// (row, window) cell, neighbouring threads on one row's windows, so a
// row's ring columns are read from HBM once and then from L1/L2 by the W
// threads that share it.
__global__ void window_lanes_kernel(const float* __restrict__ sums, int32_t sw,
                                    const float* __restrict__ maxs, int32_t mw,
                                    const float* __restrict__ mins, int32_t nw, int64_t rows,
                                    int32_t ring, const int64_t* __restrict__ end_panes,
                                    const uint8_t* __restrict__ w_valid, int32_t W,
                                    int64_t pane_lo, int64_t pane_hi, int32_t ppw,
                                    float* __restrict__ out_s, float* __restrict__ out_x,
                                    float* __restrict__ out_n) {
  const int64_t total = rows * (int64_t)W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int64_t r = t / W;
    const int32_t w = (int32_t)(t - r * W);
    // the window's live panes [lo_w, hi_w]; column c is live when its
    // distance d from lo_w's column is <= span (span < ring: one live
    // pane per column; -1: none)
    int32_t c0 = 0, span32 = -1;
    if (w_valid[w]) {
      const int64_t e = end_panes[w];
      const int64_t lo_w = e - ppw > pane_lo ? e - ppw : pane_lo;
      const int64_t hi_w = e - 1 < pane_hi ? e - 1 : pane_hi;
      const int64_t span = hi_w - lo_w;
      c0 = (int32_t)floor_mod(lo_w, ring);
      span32 = span < 0 ? -1 : (span >= ring - 1 ? ring - 1 : (int32_t)span);
    }
    for (int32_t s = 0; s < sw; ++s) {
      float acc = 0.0f;
      if (w_valid[w]) {
        for (int32_t c = 0; c < ring; ++c) {
          const int32_t d = c >= c0 ? c - c0 : c - c0 + ring;
          acc += sums[(r * ring + c) * sw + s] * (d <= span32 ? 1.0f : 0.0f);
        }
      }
      out_s[t * sw + s] = acc;
    }
    for (int32_t s = 0; s < mw; ++s) {
      float acc = -INFINITY;
      for (int32_t c = 0; c < ring; ++c) {
        const int32_t d = c >= c0 ? c - c0 : c - c0 + ring;
        if (d <= span32) acc = max_ieee(acc, maxs[(r * ring + c) * mw + s]);
      }
      out_x[t * mw + s] = acc;
    }
    for (int32_t s = 0; s < nw; ++s) {
      float acc = INFINITY;
      for (int32_t c = 0; c < ring; ++c) {
        const int32_t d = c >= c0 ? c - c0 : c - c0 + ring;
        if (d <= span32) acc = min_ieee(acc, mins[(r * ring + c) * nw + s]);
      }
      out_n[t * nw + s] = acc;
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
// used mask, and the appended rows (3 + F words each). Design, three
// launches on one stream, as K3's:
//   A  one block per window: up to k rounds of a max and a count over the
//      window's column of total-order keys (k = 1: one max pass), each
//      round looking below the previous one's value. Not K3's loop: K3's
//      keys are counts >= 1, so it stops at the first round with no
//      candidate left; this one keys non-candidates as -inf and counts
//      them, so a -NaN candidate at the k-th place gives a NaN threshold
//      (nothing selected), as lax.top_k over the masked grid does;
//   B, C  compact.cuh's ordered compaction: each block's count, then
//      topn_ring_append (K3's append, with the F result columns).

// int32 key whose integer order is IEEE total order on f32
__device__ __forceinline__ int32_t total_key(float x) {
  const int32_t b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float from_total_key(int32_t k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

__device__ __forceinline__ bool lanes_candidate(const int32_t* __restrict__ wcounts, int64_t i,
                                                int32_t W, const uint8_t* __restrict__ used,
                                                const uint8_t* __restrict__ w_valid) {
  const int64_t r = i / W;
  return wcounts[i] > 0 && w_valid[(int32_t)(i - r * W)] && used[r];
}

__device__ __forceinline__ int32_t block_max_i32(int32_t v, int32_t* smem) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // smem may still be read by a previous call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  int32_t r = smem[0];
  for (int i = 1; i < kWarps; ++i) r = max(r, smem[i]);
  return r;
}

__global__ void lanes_threshold_kernel(const int32_t* __restrict__ wcounts,
                                       const float* __restrict__ v, int64_t rows, int32_t W,
                                       const uint8_t* __restrict__ used,
                                       const uint8_t* __restrict__ w_valid, int32_t k,
                                       float* __restrict__ thresh,
                                       const int32_t* __restrict__ ring,
                                       long long* __restrict__ old_total) {
  __shared__ int32_t s_max[kWarps];
  __shared__ long long s_sum[kWarps];
  const int32_t w = blockIdx.x;
  if (w == 0 && threadIdx.x == 0) *old_total = ring[0];
  const int32_t neg_inf = total_key(-INFINITY);
  long long ceiling = (long long)INT32_MAX + 1;  // this round looks only below it
  long long need = k;
  int32_t result = neg_inf;
  while (need > 0) {
    int32_t m = INT32_MIN;
    bool any = false;
    for (int64_t r = threadIdx.x; r < rows; r += blockDim.x) {
      const int64_t i = r * W + w;
      const int32_t key = lanes_candidate(wcounts, i, W, used, w_valid) ? total_key(v[i]) : neg_inf;
      if ((long long)key < ceiling && (!any || key > m)) {
        m = key;
        any = true;
      }
    }
    if (!any) m = INT32_MIN;
    m = block_max_i32(m, s_max);
    long long c = 0;
    for (int64_t r = threadIdx.x; r < rows; r += blockDim.x) {
      const int64_t i = r * W + w;
      const int32_t key = lanes_candidate(wcounts, i, W, used, w_valid) ? total_key(v[i]) : neg_inf;
      if (key == m) ++c;
    }
    need -= block_sum(c, s_sum);
    result = m;
    ceiling = m;
  }
  if (threadIdx.x == 0) thresh[w] = from_total_key(result);
}

__device__ __forceinline__ bool lanes_selected(const int32_t* __restrict__ wcounts,
                                               const float* __restrict__ v, int64_t i, int32_t W,
                                               const uint8_t* __restrict__ used,
                                               const uint8_t* __restrict__ w_valid,
                                               const float* __restrict__ thresh) {
  return lanes_candidate(wcounts, i, W, used, w_valid) &&
         v[i] >= thresh[(int32_t)(i % W)];
}

__global__ void lanes_count_kernel(const int32_t* __restrict__ wcounts,
                                   const float* __restrict__ v, int64_t rows, int32_t W,
                                   const uint8_t* __restrict__ used,
                                   const uint8_t* __restrict__ w_valid,
                                   const float* __restrict__ thresh,
                                   int32_t* __restrict__ block_counts) {
  compact_count(
      rows * (int64_t)W,
      [&](int64_t i) { return lanes_selected(wcounts, v, i, W, used, w_valid, thresh); },
      block_counts);
}

__global__ void lanes_write_kernel(const int32_t* __restrict__ wcounts,
                                   const float* __restrict__ v, const int32_t* __restrict__ cols,
                                   int32_t F, int64_t rows, int32_t W,
                                   const uint8_t* __restrict__ used,
                                   const uint8_t* __restrict__ w_valid,
                                   const float* __restrict__ thresh,
                                   const int32_t* __restrict__ block_counts, int32_t n_blocks,
                                   const long long* __restrict__ old_total,
                                   const int64_t* __restrict__ end_panes, int64_t anchor,
                                   int32_t sel_cap, int32_t* __restrict__ ring, int32_t row_cap,
                                   int32_t ring_cols) {
  topn_ring_append(
      rows, W, wcounts, block_counts, n_blocks, *old_total, end_panes, anchor, sel_cap, ring,
      row_cap, ring_cols, 0,
      [&](int64_t i) { return lanes_selected(wcounts, v, i, W, used, w_valid, thresh); },
      [&](int64_t i, int32_t* dst) {
        for (int32_t f = 0; f < F; ++f) dst[f] = cols[i * F + f];
      });
}

}  // namespace

extern "C" {

const char* tl_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int tl_tile() { return kTile; }

int tl_window_lanes(const float* sums, int32_t sw, const float* maxs, int32_t mw,
                    const float* mins, int32_t nw, int64_t rows, int32_t ring,
                    const int64_t* end_panes, const uint8_t* w_valid, int32_t W, int64_t pane_lo,
                    int64_t pane_hi, int32_t ppw, float* out_s, float* out_x, float* out_n,
                    void* stream) {
  const int64_t total = rows * (int64_t)W;
  if (total > 0 && sw + mw + nw > 0) {
    window_lanes_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        sums, sw, maxs, mw, mins, nw, rows, ring, end_panes, w_valid, W, pane_lo, pane_hi, ppw,
        out_s, out_x, out_n);
  }
  return (int)cudaGetLastError();
}

// scratch: thresh (W floats), block_counts (ceil(rows*W / kTile) int32),
// old_total (one int64) — allocated by the caller
int tl_topn_select_lanes(const int32_t* wcounts, const float* v, const int32_t* cols, int32_t F,
                         int64_t rows, int32_t W, const uint8_t* used, const int64_t* end_panes,
                         const uint8_t* w_valid, int64_t anchor, int32_t k, int32_t sel_cap,
                         int32_t* ring, int32_t ring_rows, int32_t ring_cols, float* thresh,
                         int32_t* block_counts, long long* old_total, void* stream) {
  const int64_t K = rows * (int64_t)W;
  if (K <= 0 || W <= 0 || k <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t n_blocks = compact_blocks(K);
  lanes_threshold_kernel<<<W, kThreads, 0, s>>>(wcounts, v, rows, W, used, w_valid, k, thresh,
                                                ring, old_total);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  lanes_count_kernel<<<n_blocks, kThreads, 0, s>>>(wcounts, v, rows, W, used, w_valid, thresh,
                                                   block_counts);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  lanes_write_kernel<<<n_blocks, kThreads, 0, s>>>(wcounts, v, cols, F, rows, W, used, w_valid,
                                                   thresh, block_counts, n_blocks, old_total,
                                                   end_panes, anchor, sel_cap, ring,
                                                   ring_rows - 2, ring_cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
