// The element path's reduction, hand-written for Hopper (sm_90a). Plain C
// interface, bound from Python with ctypes
// (flink_tpu_torch/kernels/element_kernels.py); the entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError(). It shares window_kernels.py's error word: an offset
// table that is not a non-decreasing run inside the lanes ORs
// kErrSegmentOffsets into it.
//
// E1 segment_lanes  replaces flink_tpu/api/datastream.py:443
//                   _element_window_fn, its three reductions (jnp.sum,
//                   jnp.max, jnp.min over the element axis of one fired
//                   window's lifted lanes), for every window of a drain
//                   in one launch instead of one device program per
//                   window
//
// Input: offsets (W + 1) int64, segment w = elements [offsets[w],
// offsets[w + 1]); the lifted lanes sums (E, S), maxs (E, M), mins (E, N),
// f32, row-major, any width 0. Output: sums (W, S), maxs (W, M), mins
// (W, N) f32 and counts (W,) int32 (the segment lengths).
//
// Arithmetic, which the plain version in element_kernels.py repeats step
// for step: each sum starts at +0 and adds the segment's elements in
// element order (__fadd_rn: no contraction, no atomics), so reruns agree
// bit for bit. Max and min walk the segment in the same order under
// IEEE 754-2019 maximum / minimum (-0 < +0) with NaN propagated as it
// is: the max keeps the last NaN of the segment, the min the first,
// which is what XLA's CPU reduction gives for a column with one NaN (a
// column with several NaNs gives a NaN either way). An empty segment
// gives 0, -inf, +inf and count 0.
//
// Bound: bytes — each lifted lane read once, the offsets once, each
// output written once. Design: one thread per (segment, lane column),
// walking its segment in order (grid-stride over W x columns); the
// thread of column 0 also writes the count. Segments run from one
// element to thousands, so long ones serialise on one thread: the
// simple form that is right, before any speed work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_common.cuh"

namespace {

// error-word bit (window_kernels.py ERROR_BITS decodes it)
constexpr int32_t kErrSegmentOffsets = 256;

__global__ void segment_lanes_kernel(const int64_t* __restrict__ offsets, int64_t n_seg,
                                     int64_t n_elem, const float* __restrict__ sums,
                                     int32_t sw, const float* __restrict__ maxs, int32_t mw,
                                     const float* __restrict__ mins, int32_t nw,
                                     float* __restrict__ out_sums, float* __restrict__ out_maxs,
                                     float* __restrict__ out_mins, int32_t* __restrict__ counts,
                                     int32_t* __restrict__ err) {
  const int32_t cols = sw + mw + nw;
  const int32_t per = cols > 0 ? cols : 1;
  const int64_t total = n_seg * per;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int64_t w = t / per;
    const int32_t c = (int32_t)(t - w * per);
    int64_t lo = offsets[w], hi = offsets[w + 1];
    if (lo < 0 || hi < lo || hi > n_elem) {
      if (c == 0) atomicOr(err, kErrSegmentOffsets);
      lo = hi = 0;
    }
    if (c == 0) counts[w] = (int32_t)(hi - lo);
    if (c < sw) {
      float acc = 0.0f;
      for (int64_t e = lo; e < hi; ++e) acc = __fadd_rn(acc, sums[e * sw + c]);
      out_sums[w * sw + c] = acc;
    } else if (c < sw + mw) {
      const int32_t m = c - sw;
      float acc = -INFINITY;
      for (int64_t e = lo; e < hi; ++e) {
        const float x = maxs[e * mw + m];
        if (isnan(x) || (!isnan(acc) && (x > acc || (x == acc && !signbit(x))))) acc = x;
      }
      out_maxs[w * mw + m] = acc;
    } else if (c < cols) {
      const int32_t m = c - sw - mw;
      float acc = INFINITY;
      for (int64_t e = lo; e < hi; ++e) {
        const float x = mins[e * nw + m];
        if (!isnan(acc) && (isnan(x) || x < acc || (x == acc && signbit(x)))) acc = x;
      }
      out_mins[w * nw + m] = acc;
    }
  }
}

}  // namespace

extern "C" {

const char* ek_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ek_segment_lanes(const int64_t* offsets, int64_t n_seg, int64_t n_elem, const float* sums,
                     int32_t sw, const float* maxs, int32_t mw, const float* mins, int32_t nw,
                     float* out_sums, float* out_maxs, float* out_mins, int32_t* counts,
                     int32_t* err, void* stream) {
  if (n_seg <= 0) return (int)cudaGetLastError();
  const int32_t cols = sw + mw + nw;
  const int64_t total = n_seg * (cols > 0 ? cols : 1);
  segment_lanes_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      offsets, n_seg, n_elem, sums, sw, maxs, mw, mins, nw, out_sums, out_maxs, out_mins,
      counts, err);
  return (int)cudaGetLastError();
}

// the lean launch path (window_kernels.py LeanEntry): each entry
// above from one packed block of 64-bit words, the stream beside
// ek_segment_lanes from one packed block of 14 64-bit words
int ek_segment_lanes_packed(const int64_t* a, void* stream) {
  return ek_segment_lanes(
      (const int64_t*)(intptr_t)a[0], (int64_t)a[1], (int64_t)a[2], (const float*)(intptr_t)a[3],
      (int32_t)a[4], (const float*)(intptr_t)a[5], (int32_t)a[6], (const float*)(intptr_t)a[7],
      (int32_t)a[8], (float*)(intptr_t)a[9], (float*)(intptr_t)a[10], (float*)(intptr_t)a[11],
      (int32_t*)(intptr_t)a[12], (int32_t*)(intptr_t)a[13], stream);
}

}  // extern "C"
