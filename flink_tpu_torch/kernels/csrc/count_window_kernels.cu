// The count-window fire, hand-written for Hopper (sm_90a). Plain C
// interface, bound from Python with ctypes
// (flink_tpu_torch/kernels/count_window_kernels.py); the entry point
// launches on the caller's stream, allocates nothing (the wrapper passes
// scratch) and returns cudaGetLastError(). It shares window_kernels.py's
// error word: a fire with more rows than its buffer ORs kErrCountFireCap
// into it.
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
// thread that wrote a row resets it: with purge, sums to 0, maxs to
// -inf, mins to +inf and counts to 0; without, base = counts (only the
// trigger count restarts). Rows past the cap are neither written nor
// reset, and set the error bit.
//
// Bound: bytes — the counts (and base) once, and each fired row's lanes
// read once, written to the buffer once and reset once. Design: the two
// launches of compact.cuh's ordered compaction, one row per item; no
// float arithmetic (lanes are copied as bits), so the result is exact.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "compact.cuh"
#include "window_common.cuh"

namespace {

// error-word bit (window_kernels.py ERROR_BITS decodes it)
constexpr int32_t kErrCountFireCap = 128;

struct CountFireRule {
  const int32_t* counts;
  const int32_t* base;
  int64_t fire_rows;  // rows below this may fire (the dump row may not)
  int32_t size;

  __device__ __forceinline__ bool operator()(int64_t r) const {
    const int32_t since = base != nullptr ? counts[r] - base[r] : counts[r];
    return r < fire_rows && since >= size;
  }
};

__global__ void count_fire_count_kernel(CountFireRule rule, int64_t rows,
                                        int32_t* __restrict__ block_counts) {
  compact_count(rows, rule, block_counts);
}

// counts and base are also read through ``rule``: no __restrict__ on them
__global__ void count_fire_write_kernel(CountFireRule rule, int64_t rows,
                                        const int32_t* __restrict__ block_counts,
                                        int32_t n_blocks, int32_t* counts, int32_t* base,
                                        float* __restrict__ sums,
                                        int32_t sw, float* __restrict__ maxs, int32_t mw,
                                        float* __restrict__ mins, int32_t nw,
                                        int32_t* __restrict__ out, int32_t out_cap,
                                        int32_t* __restrict__ err) {
  const int32_t cols = 2 + sw + mw + nw;
  compact_write(
      rows, block_counts, n_blocks, out_cap, rule,
      [&](int64_t r, long long pos) {
        int32_t* dst = out + (pos + 1) * cols;
        dst[0] = (int32_t)r;
        dst[1] = counts[r];
        int32_t* lane_out = dst + 2;
        for (int32_t s = 0; s < sw; ++s) lane_out[s] = __float_as_int(sums[r * sw + s]);
        for (int32_t s = 0; s < mw; ++s) lane_out[sw + s] = __float_as_int(maxs[r * mw + s]);
        for (int32_t s = 0; s < nw; ++s) lane_out[sw + mw + s] = __float_as_int(mins[r * nw + s]);
        if (base != nullptr) {
          base[r] = counts[r];
          return;
        }
        counts[r] = 0;
        for (int32_t s = 0; s < sw; ++s) sums[r * sw + s] = 0.0f;
        for (int32_t s = 0; s < mw; ++s) maxs[r * mw + s] = -INFINITY;
        for (int32_t s = 0; s < nw; ++s) mins[r * nw + s] = INFINITY;
      },
      [&](long long all) {
        out[0] = (int32_t)all;
        for (int32_t c = 1; c < cols; ++c) out[c] = 0;
        if (all > out_cap) atomicOr(err, kErrCountFireCap);
      });
}

}  // namespace

extern "C" {

const char* cw_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// base null: a purging window. scratch: block_counts (ceil(rows / kTile)
// int32)
int cw_count_fire(int32_t* counts, int32_t* base, int64_t rows, float* sums, int32_t sw,
                  float* maxs, int32_t mw, float* mins, int32_t nw, int32_t size, int32_t* out,
                  int32_t out_cap, int32_t* block_counts, int32_t* err, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t n_blocks = compact_blocks(rows);
  const CountFireRule rule{counts, base, rows - 1, size};
  count_fire_count_kernel<<<n_blocks, kThreads, 0, s>>>(rule, rows, block_counts);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  count_fire_write_kernel<<<n_blocks, kThreads, 0, s>>>(rule, rows, block_counts, n_blocks,
                                                        counts, base, sums, sw, maxs, mw, mins,
                                                        nw, out, out_cap, err);
  return (int)cudaGetLastError();
}

// the lean launch path (window_kernels.py LeanEntry): each entry
// above from one packed block of 64-bit words, the stream beside
// cw_count_fire from one packed block of 14 64-bit words
int cw_count_fire_packed(const int64_t* a, void* stream) {
  return cw_count_fire(
      (int32_t*)(intptr_t)a[0], (int32_t*)(intptr_t)a[1], (int64_t)a[2], (float*)(intptr_t)a[3],
      (int32_t)a[4], (float*)(intptr_t)a[5], (int32_t)a[6], (float*)(intptr_t)a[7],
      (int32_t)a[8], (int32_t)a[9], (int32_t*)(intptr_t)a[10], (int32_t)a[11],
      (int32_t*)(intptr_t)a[12], (int32_t*)(intptr_t)a[13], stream);
}

}  // extern "C"
