// Device helpers shared by the window-operator kernel sources
// (window_kernels.cu, lane_kernels.cu, devgen_kernels.cu,
// topn_lanes_kernels.cu, ...): the launch shape, block-wide sum and scan,
// division by a divisor fixed a launch (FastDiv), a fire's scalars and
// where a fire kernel reads them (FireSource), the
// window-count rule (which panes of a window are live), IEEE maximum /
// minimum and the split upload's decode (SplitRecords: K7's rule, read
// by split_cells, scatter_split_counts, scatter_lanes and bucket_records).
// Each .cu file includes this once, inside no
// namespace of its own; everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// compaction tile: each thread owns kItems consecutive (row, window)
// cells, so a block covers kTile cells of the row-major grid
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
// grid-stride kernels never launch more blocks than this (8 per SM on
// the 132-SM card keeps every SM busy and the grid loop short)
constexpr int64_t kMaxBlocks = 132 * 8;

inline int grid_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// n / d for 0 <= n < 2^31 and a divisor fixed a launch, by a multiply
// and a shift (the round-up reciprocal, as CUTLASS's FastDivmod)
struct FastDiv {
  uint32_t d, m, s;
};

inline FastDiv fast_div(uint32_t d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    uint32_t l = 0;
    while ((1ull << l) < d) ++l;  // ceil(log2 d)
    const uint32_t p = 31 + l;
    f.m = (uint32_t)(((1ull << p) + d - 1) / d);
    f.s = p - 32;
  }
  return f;
}

__device__ __forceinline__ uint32_t div_of(uint32_t n, const FastDiv& f) {
  return f.d > 1 ? __umulhi(n, f.m) >> f.s : n;
}

__host__ __device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t m) {
  int64_t r = a % m;
  return r < 0 ? r + m : r;
}

// IEEE 754-2019 maximum / minimum, as XLA's max and min: a NaN operand
// gives the canonical NaN, and -0 < +0.
__device__ __forceinline__ float max_ieee(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  if (a == b) return signbit(a) ? b : a;
  return a > b ? a : b;
}

__device__ __forceinline__ float min_ieee(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  if (a == b) return signbit(a) ? a : b;
  return a < b ? a : b;
}

// ---- the split upload ------------------------------------------------------
// A record of 3 bytes, (B, 3) uint8: bytes 0-1 the little-endian slot id,
// byte 2 the ring column; slot 0xFFFF is an invalid record and goes to
// the dump row. K7's rule (window_kernels.cu split_cells), which every
// kernel that reads the upload shares: a slot past the dump row or a
// column past the ring sets kErrSplitCell and adds nothing.
// (window_kernels.py ERROR_BITS decodes the bit.)
constexpr int32_t kErrSplitCell = 64;
constexpr uint32_t kInvalidSlotU16 = 0xFFFF;

struct SplitRecords {
  const uint8_t* sc;
  int32_t ring;
  int32_t dump_row;
  static constexpr int32_t kErr = kErrSplitCell;

  // record i's three bytes as one value (slot | col << 16); neighbouring
  // threads on neighbouring records read a warp's 96 bytes in one or two
  // sectors, so byte loads are whole transactions
  __device__ __forceinline__ int64_t load(int64_t i) const {
    const uint8_t* r = sc + 3 * i;
    return (int64_t)((uint32_t)__ldg(r) | ((uint32_t)__ldg(r + 1) << 8) |
                     ((uint32_t)__ldg(r + 2) << 16));
  }
  // row and ring column of a loaded record: 1 a valid record, 0 slot
  // 0xFFFF (row = the dump row), -1 outside the state (the error bit)
  __device__ __forceinline__ int decode(int64_t v, int32_t& row, int32_t& col) const {
    const uint32_t slot = (uint32_t)v & 0xFFFFu;
    col = (int32_t)((uint32_t)v >> 16);
    row = slot == kInvalidSlotU16 ? dump_row : (int32_t)slot;
    if (row > dump_row || col >= ring) return -1;
    return slot == kInvalidSlotU16 ? 0 : 1;
  }
  // K7's int32 flat cell row * ring + col of a loaded record (slot 0xFFFF
  // at the dump row), or -1 for one outside the state
  __device__ __forceinline__ int32_t cell(int64_t v) const {
    int32_t row = 0, col = 0;
    return decode(v, row, col) < 0 ? -1 : row * ring + col;
  }
  // load() of the 16 consecutive records first .. first + 15 (first a
  // multiple of 16), 0 past record n: their 48 bytes by three 16-byte
  // loads where the upload is 16-byte aligned and all 16 exist, each
  // record cut out of the words by a funnel shift; byte loads otherwise
  __device__ __forceinline__ void load16(int64_t first, int64_t n, int32_t (&v)[16]) const {
    const uint8_t* g = sc + 3 * first;
    if (first + 16 <= n && ((uintptr_t)g & 15) == 0) {
      const uint4 a = __ldg((const uint4*)g), b = __ldg((const uint4*)g + 1),
                  c = __ldg((const uint4*)g + 2);
      const uint32_t w[13] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, 0u};
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int at = 3 * r;
        v[r] = (int32_t)(__funnelshift_r(w[at >> 2], w[(at >> 2) + 1], 8 * (at & 3)) &
                         0xFFFFFFu);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = first + r < n ? (int32_t)load(first + r) : 0;
    }
  }
};

// A fire's pane bounds, emit-ring anchor and pane_lo's ring column
// (pane_lo mod ring, for window_counts; 0 where a kernel reads none).
struct FireScalars {
  int64_t pane_lo, pane_hi, anchor, lo_col;
};

// Where a fire kernel takes its scalars from, and whether it runs: the
// values of a host launch (dev and run null), or the fused step's
// parameter block in device memory (dev), with its gate word (run: the
// kernel does nothing when *run == 0).
struct FireSource {
  FireScalars imm;
  const FireScalars* dev;
  const int32_t* run;

  __device__ __forceinline__ FireScalars get() const { return dev != nullptr ? *dev : imm; }
  __device__ __forceinline__ bool skip() const { return run != nullptr && *run == 0; }
};

inline FireSource host_fire(int64_t pane_lo, int64_t pane_hi, int64_t anchor,
                            int64_t lo_col = 0) {
  return FireSource{{pane_lo, pane_hi, anchor, lo_col}, nullptr, nullptr};
}

// ---- block reductions / scan (kThreads threads) ---------------------------

__device__ __forceinline__ long long block_sum(long long v, long long* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // smem may still be read by a previous call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  long long r = 0;
  for (int i = 0; i < kWarps; ++i) r += smem[i];
  return r;
}

// exclusive prefix sum of v in thread order (thread 0 gets 0)
__device__ __forceinline__ int block_exclusive_scan(int v, int* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  __syncthreads();
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += smem[i];
  return before + incl - v;
}

// ---- the window-count rule -------------------------------------------------
// The last pane a fire may read: the ring holds panes [pane_lo, pane_lo +
// ring - 1] at most, whatever pane_hi says.
__host__ __device__ __forceinline__ int64_t live_hi_cap(int64_t pane_lo, int64_t pane_hi,
                                                        int32_t ring) {
  return pane_hi < pane_lo + ring - 1 ? pane_hi : pane_lo + ring - 1;
}

// The count of one row (``row`` = its ring columns) over the window ending
// at pane e: panes [e - ppw, e) ∩ [pane_lo, hi_cap], each at column p mod
// ring.
__device__ __forceinline__ int32_t window_count(const int32_t* __restrict__ row, int32_t ring,
                                                int64_t e, int64_t pane_lo, int64_t hi_cap,
                                                int32_t ppw) {
  const int64_t lo = e - ppw > pane_lo ? e - ppw : pane_lo;
  const int64_t hi = e - 1 < hi_cap ? e - 1 : hi_cap;
  int32_t acc = 0;
  if (lo <= hi) {
    int64_t col = floor_mod(lo, ring);
    for (int64_t p = lo; p <= hi; ++p) {
      acc += row[col];
      if (++col == ring) col = 0;
    }
  }
  return acc;
}

}  // namespace
