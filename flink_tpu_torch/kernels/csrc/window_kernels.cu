// Window-operator kernels of the Nexmark Q5 path, hand-written for Hopper
// (sm_90a). Plain C interface, bound from Python with ctypes
// (flink_tpu_torch/kernels/window_kernels.py); every entry point launches
// on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch raises in the wrapper. The two
// kernels that index with host-built entries (K1, K4) take an error word
// and OR a kErr* bit into it for an entry outside the tensor, so a bad
// upload is reported (the wrapper's error word is read back and raises)
// rather than hidden.
//
// K1-K3 work on the int32 COUNT lane of the pane state (rows = key slots
// + 1 dump row, ring = pane ring columns). Integer sums are exact in any
// order, so every result here is bit-identical to the plain PyTorch
// version beside it and to the JAX reference, atomics or not. K4 moves or
// clears ring columns of every lane of a state block in one launch (the
// count lane and each (rows, ring, width) f32 sum/max/min lane): pure
// copies and fills of 32-bit words, exact too.
//
// K1 scatter_counts       replaces flink_tpu/ops/window.py:190
//                         _apply_preagg_u32_core (and the count lane of
//                         :62 apply_kernel / :145 / :205 preagg variants)
// K2 window_counts        replaces flink_tpu/ops/window.py:286 fire_kernel
//                         count output (:355-365)
// K3 topn_select_append   replaces flink_tpu/ops/window.py:547
//                         _ring_append_topn_core + :456 _topn_select_append;
//                         its distributed mode (topn_candidates,
//                         topn_select_given with the global k-th folded in;
//                         topn_global_threshold, that k-th alone) replaces
//                         :1585 topn_shard's top_k, all_gather threshold
//                         and select
// K4 ring_columns         replaces flink_tpu/ops/window.py:825 clear_kernel
//                         and :888 ring_remap_kernel (every lane)
// K7 split_cells          replaces flink_tpu/ops/window.py:101 split_decode
//                         and the decode of :122 apply_kernel_split (the
//                         lane scatter itself is lane_kernels.cu's L2);
//                         every kernel that reads the upload decodes it
//                         itself, so no path launches it
// K1s scatter_split_counts replaces :122 apply_kernel_split's count lane:
//                         K1's per-record form decoding the split upload
//                         itself (K7's decode and error rule, one launch)
//
// K2-K4's kernels live in window_fire.cuh, which fused_kernels.cu (the
// one-upload fused step) launches too.
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_common.cuh"
#include "window_fire.cuh"

namespace {

// error-word bit of scatter_counts (window_kernels.py ERROR_BITS decodes
// it; split_cells' kErrSplitCell is window_common.cuh's)
constexpr int32_t kErrScatterIndex = 1;

// ---- K1: scatter_counts --------------------------------------------------
// counts.flat[idx[i]] += cnt[i] (or += 1 when cnt is null); idx is int32,
// or int64 once the state reaches 2^31 cells (the operator's upload
// switches where the reference's does). An out-of-range index is not
// written (a malformed upload cannot corrupt memory) and sets
// kErrScatterIndex; with skip_negative a negative index is an invalid
// record, skipped silently (a key-sharded block's received buckets pad
// with -1).
//
// Host-combined pairs (cnt given; ~110k distinct cells at the Q5 shape,
// each once): one thread per entry, integer atomicAdd (exact in any
// order). Bound: bytes — the idx/cnt stream plus one 4-byte
// read-modify-write a cell, ~1.8 MB, so the launch dominates.
template <typename Idx>
__global__ void scatter_counts_kernel(int32_t* __restrict__ counts, int64_t n_cells,
                                      const Idx* __restrict__ idx,
                                      const int32_t* __restrict__ cnt, int64_t n,
                                      int32_t skip_negative, int32_t* __restrict__ err) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t c = idx[i];
    if (c < 0 && skip_negative) continue;
    if (c < 0 || c >= n_cells) {
      atomicOr(err, kErrScatterIndex);
      continue;
    }
    const int32_t v = cnt != nullptr ? cnt[i] : 1;
    if (v != 0) atomicAdd(&counts[c], v);
  }
}

// Per record (cnt null; 2^20 WordCount words, ~294k distinct cells, the
// hottest 623 records; or the split upload's 3 bytes a record, decoded
// here — K7's decode folded in, one launch and no cell array): the pace
// is the L2's rate of scattered atomics, one transaction each, and the
// serial chains on the hot cells. Bound: bytes — 4 (or 3) bytes a record
// read once, each distinct cell read and written once.
// Design: a block takes a contiguous chunk of fewer than 2^16 records
// and counts them in a shared-memory histogram of the state's rows,
// 16-bit counters, two rows a word, for one ring column: the column of
// the chunk's middle record (records arrive about in time order, so a
// chunk's records share their pane); a record of another column goes
// to its cell with a global atomic. Then one global atomic a counted
// row. A chunk of at most 65,535 records cannot carry a counter into its
// neighbour. The chunk comes from count_plan (window_kernels.py
// count_plan mirrors it): a wave of ~132 chunks did best at 2^20
// records on the card (chunks of 2,048 to 63,488 records measured, and
// ranges of rows a block each, which reread their chunk: slower). The
// fold pays where a chunk repeats its cells (the bid stream's hot
// auctions: 57 % of a chunk's records stay distinct); WordCount's spread
// words leave 80 % distinct, so there it is no faster than an atomic a
// record. States past kHistMaxRows rows, or past 2^31 cells, take the
// per-entry kernel above.
constexpr int kCountThreads = 512;
constexpr int32_t kCountMaxChunk = 65535;
// rows of the largest histogram (its 16-bit counters in about 200 KB)
constexpr int64_t kHistMaxRows = 100000;
// blocks the plan aims at: a wave of the 132-SM card
constexpr int64_t kCountBlocks = 132;

// a record's row and ring column: 1 to count it, 0 to skip it, -1 for an
// entry outside the state (the error bit, nothing written)
template <typename Idx>
struct FlatRecords {
  const Idx* idx;
  int64_t n_cells;
  FastDiv ring;
  int32_t skip_negative;
  static constexpr int32_t kErr = kErrScatterIndex;

  __device__ __forceinline__ int64_t load(int64_t i) const {
    if constexpr (sizeof(Idx) == 8)
      return (int64_t)__ldg((const long long*)idx + i);
    else
      return (int64_t)__ldg((const int*)idx + i);
  }
  __device__ __forceinline__ int decode(int64_t c, int32_t& row, int32_t& col) const {
    if (c < 0 && skip_negative) return 0;
    if (c < 0 || c >= n_cells) return -1;
    const uint32_t r = div_of((uint32_t)c, ring);
    row = (int32_t)r;
    col = (int32_t)((uint32_t)c - r * ring.d);
    return 1;
  }
};

struct CountPlan {
  int32_t chunk;   // records a block (a multiple of 4 x kCountThreads, < 2^16)
  int32_t groups;  // 16-byte groups of the histogram (8 rows each)
  int64_t chunks;
};

inline CountPlan count_plan(int64_t n, int64_t rows) {
  CountPlan p{};
  const int64_t step = 4 * kCountThreads;
  const int64_t want = (n + kCountBlocks - 1) / kCountBlocks;
  int64_t chunk = (want + step - 1) / step * step;
  if (chunk > kCountMaxChunk) chunk = kCountMaxChunk / step * step;
  p.chunk = (int32_t)chunk;
  p.groups = (int32_t)((rows + 7) / 8);
  p.chunks = (n + chunk - 1) / chunk;
  return p;
}

// the body of both per-record kernels (their own names in a profile)
template <class Rec>
__device__ __forceinline__ void count_records(int32_t* __restrict__ counts, int32_t ring,
                                              const Rec& rec, int64_t n, const CountPlan& plan,
                                              int32_t* __restrict__ err) {
  extern __shared__ uint4 hist4[];  // rows / 2 words, 16-byte groups
  uint32_t* hist = (uint32_t*)hist4;
  __shared__ int32_t ref_col;
  for (int32_t k = threadIdx.x; k < plan.groups; k += kCountThreads)
    hist4[k] = make_uint4(0, 0, 0, 0);
  const int64_t i0 = (int64_t)blockIdx.x * plan.chunk;
  const int64_t i1 = i0 + plan.chunk < n ? i0 + plan.chunk : n;
  if (threadIdx.x == 0) {
    int32_t r = 0, c = 0;
    ref_col = rec.decode(rec.load(i0 + (i1 - i0) / 2), r, c) > 0 ? c : 0;
  }
  __syncthreads();
  const int32_t ref = ref_col;
  for (int64_t base = i0 + threadIdx.x; base < i1; base += 4 * kCountThreads) {
    int64_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t i = base + u * kCountThreads;
      v[u] = i < i1 ? rec.load(i) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (base + u * kCountThreads >= i1) continue;
      int32_t r = 0, c = 0;
      const int k = rec.decode(v[u], r, c);
      if (k < 0) {
        atomicOr(err, Rec::kErr);
        continue;
      }
      if (k == 0) continue;
      if (c == ref)
        atomicAdd(&hist[r >> 1], 1u << ((r & 1) << 4));
      else
        atomicAdd(&counts[(int64_t)r * ring + c], 1);
    }
  }
  __syncthreads();
  // one global atomic a counted row, read four words (eight rows) at a
  // time
  for (int32_t k = threadIdx.x; k < plan.groups; k += kCountThreads) {
    const uint4 g = hist4[k];
    const uint32_t h[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (h[u] == 0) continue;
      const int64_t r = 8 * (int64_t)k + 2 * u;
      if (h[u] & 0xFFFFu) atomicAdd(&counts[r * ring + ref], (int32_t)(h[u] & 0xFFFFu));
      if (h[u] >> 16) atomicAdd(&counts[(r + 1) * ring + ref], (int32_t)(h[u] >> 16));
    }
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kCountThreads)
    count_records_kernel(int32_t* __restrict__ counts, int32_t ring, FlatRecords<Idx> rec,
                         int64_t n, CountPlan plan, int32_t* __restrict__ err) {
  count_records(counts, ring, rec, n, plan, err);
}

// the split upload's records (SplitRecords); slot 0xFFFF decodes to 0
// and adds nothing, as the reference's apply_kernel_split adds its 0 to
// the dump row
__global__ void __launch_bounds__(kCountThreads)
    split_counts_kernel(int32_t* __restrict__ counts, int32_t ring, SplitRecords rec, int64_t n,
                        CountPlan plan, int32_t* __restrict__ err) {
  count_records(counts, ring, rec, n, plan, err);
}

template <class Rec>
int launch_count_records(void (*kernel)(int32_t*, int32_t, Rec, int64_t, CountPlan, int32_t*),
                         int32_t* counts, int64_t rows, int32_t ring, const Rec& rec, int64_t n,
                         int32_t* err, cudaStream_t s) {
  const CountPlan p = count_plan(n, rows);
  // the opt-in past 48 KB, once a kernel and device
  static uint64_t opted = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= 64 || !((opted >> dev) & 1u)) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(16 * ((kHistMaxRows + 7) / 8)));
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 64) opted |= 1ull << dev;
  }
  kernel<<<(unsigned)p.chunks, kCountThreads, 16 * p.groups, s>>>(counts, ring, rec, n, p, err);
  return (int)cudaGetLastError();
}

// ---- K7: split_cells -----------------------------------------------------
// The per-record upload of 3 bytes a record (window_common.cuh
// SplitRecords): cells[i] = row * ring + col, the int32 flat cell, slot
// 0xFFFF at the dump row. A slot past the dump row or a column past the
// ring writes cell -1 and sets kErrSplitCell. Every kernel that reads the
// upload decodes it where it loads a record (scatter_split_counts,
// scatter_lanes' and bucket_records' split forms), so no path launches
// this one: it is the decode alone, for a shuffle registered through the
// exchange SPI, which takes flat cells.
// Bound: bytes — 3 read and 4 written a record. Design: one thread per
// record reads its three bytes (records are 3-byte aligned, so no wider
// load); the writes coalesce.
__global__ void split_cells_kernel(const SplitRecords rec, int64_t n, int32_t* __restrict__ cells,
                                   int32_t* __restrict__ err) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t c = rec.cell(rec.load(i));
    if (c < 0) atomicOr(err, kErrSplitCell);
    cells[i] = c;
  }
}

// ---- K3 distributed mode (a): topn_candidates -----------------------------
// A device block's top k candidate values a window (window_fire.cuh's
// distributed mode, topn_select.cuh's cand_* bodies): the (rows x W) grid
// read in tiles over the whole card, not a CUDA block a window. Top-1 is
// one launch (the per-window maxima, the last block writes the output),
// and so is k <= 16 (each block's top k a window, the last block's
// merge); above, one cooperative launch (the radix passes, the collect of
// the keys above each window's k-th, the sort), else six.
__global__ void __launch_bounds__(kThreads) cand_max_kernel(const SelParams p) {
  sel_max<true, kCandItems>(p);
  cand_max_tail(p);
}

template <int KS>
__global__ void __launch_bounds__(kThreads) cand_merge_kernel(const SelParams p) {
  cand_merge<KS>(p);
}

__global__ void __launch_bounds__(kThreads) cand_radix_kernel(const SelParams p, int pass) {
  sel_radix<true>(p, pass);
}

__global__ void __launch_bounds__(kThreads) cand_radix_all_kernel(const SelParams p) {
  cand_radix_all(p);
}

__global__ void __launch_bounds__(kThreads) cand_collect_kernel(const SelParams p) {
  cand_collect_all(p);
}

__global__ void __launch_bounds__(kThreads) cand_sort_kernel(const SelParams p) {
  cand_sort_all(p);
}

int g_cand_capacity[64];
const CandKernels kCandKernels{cand_max_kernel,          cand_merge_kernel<4>,
                               cand_merge_kernel<kCandSmallK>, cand_radix_kernel,
                               cand_radix_all_kernel,    cand_collect_kernel,
                               cand_sort_kernel,         g_cand_capacity};

}  // namespace

extern "C" {

const char* fk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int fk_scatter_counts(int32_t* counts, int64_t rows, int32_t ring, const void* idx,
                      int32_t idx_bytes, const int32_t* cnt, int64_t n, int32_t skip_negative,
                      int32_t* err, void* stream) {
  if (idx_bytes != 4 && idx_bytes != 8) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_cells = rows * ring;
  if (cnt == nullptr && rows <= kHistMaxRows && n_cells < (1ll << 31)) {
    if (idx_bytes == 8)
      return launch_count_records(
          count_records_kernel<int64_t>, counts, rows, ring,
          FlatRecords<int64_t>{(const int64_t*)idx, n_cells, fast_div((uint32_t)ring),
                               skip_negative},
          n, err, s);
    return launch_count_records(
        count_records_kernel<int32_t>, counts, rows, ring,
        FlatRecords<int32_t>{(const int32_t*)idx, n_cells, fast_div((uint32_t)ring),
                             skip_negative},
        n, err, s);
  }
  if (idx_bytes == 8)
    scatter_counts_kernel<int64_t><<<grid_for(n), kThreads, 0, s>>>(
        counts, n_cells, (const int64_t*)idx, cnt, n, skip_negative, err);
  else
    scatter_counts_kernel<int32_t><<<grid_for(n), kThreads, 0, s>>>(
        counts, n_cells, (const int32_t*)idx, cnt, n, skip_negative, err);
  return (int)cudaGetLastError();
}

// the split upload's per-record count: K1's per-record form decoding the
// (n, 3) bytes itself (rows of counts: at least dump_row + 1)
int fk_scatter_split_counts(int32_t* counts, int64_t rows, int32_t ring, const uint8_t* sc,
                            int64_t n, int32_t dump_row, int32_t* err, void* stream) {
  if (dump_row < 0 || dump_row >= rows || dump_row >= (int32_t)kInvalidSlotU16 || ring < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  return launch_count_records(split_counts_kernel, counts, (int64_t)dump_row + 1, ring,
                              SplitRecords{sc, ring, dump_row}, n, err, (cudaStream_t)stream);
}

int fk_split_cells(const uint8_t* sc, int64_t n, int32_t ring, int32_t dump_row, int32_t* cells,
                   int32_t* err, void* stream) {
  if (n > 0) {
    split_cells_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        SplitRecords{sc, ring, dump_row}, n, cells, err);
  }
  return (int)cudaGetLastError();
}

int fk_window_counts(const int32_t* counts, int64_t rows, int32_t ring, const int64_t* end_panes,
                     const uint8_t* w_valid, int32_t W, int64_t pane_lo, int64_t pane_hi,
                     int32_t ppw, int32_t* out, void* stream) {
  if (ring < 1) return (int)cudaErrorInvalidValue;
  return launch_window_counts(counts, rows, ring, end_panes, w_valid, W,
                              host_fire(pane_lo, pane_hi, 0, floor_mod(pane_lo, ring)), ppw,
                              out, (cudaStream_t)stream);
}

// work: the entry point's clean workspace (window_kernels.py
// clean_workspace), cut for work_windows windows and work_tiles selection
// tiles (select_work_words)
int fk_topn_select_append(const int32_t* wcounts, int64_t rows, int32_t W, const uint8_t* used,
                          const int64_t* end_panes, const uint8_t* w_valid, int64_t anchor,
                          int32_t n, int32_t sel_cap, int32_t* ring, int32_t ring_rows,
                          int32_t ring_cols, int64_t* work, int64_t work_windows,
                          int64_t work_tiles, void* stream) {
  return launch_topn(wcounts, rows, W, used, end_panes, w_valid, host_fire(0, 0, anchor), n,
                     nullptr, 0, 0, sel_cap, ring, ring_rows, ring_cols, work, work_windows,
                     work_tiles, (cudaStream_t)stream);
}

// cand: (W, k) with rows cand_ld floats apart (a block's columns of the
// gathered (W, M) buffer, or its own (W, k) at cand_ld = k); list:
// list_words of uint32 scratch at k > 1 (cand_list_words; null at k = 1);
// work: as fk_topn_select_append's
int fk_topn_candidates(const int32_t* wcounts, int64_t rows, int32_t W, const uint8_t* used,
                       const uint8_t* w_valid, int32_t k, float* cand, int64_t cand_ld,
                       uint32_t* list, int64_t list_words, int64_t* work, int64_t work_windows,
                       int64_t work_tiles, void* stream) {
  SelParams p{};
  p.wcounts = wcounts;
  p.rows = rows;
  p.W = W;
  p.k = k;
  p.used = used;
  p.w_valid = w_valid;
  p.cand_out = cand;
  p.cand_ld = cand_ld;
  p.cand_list = list;
  return launch_candidates(p, list_words, work, work_windows, work_tiles, kCandKernels,
                           (cudaStream_t)stream);
}

int fk_topn_global_threshold(const float* cand, int32_t W, int32_t M, int32_t k, float* thresh,
                             void* stream) {
  if (k < 1 || k > M) return (int)cudaErrorInvalidValue;
  if (W > 0) {
    topn_global_threshold_kernel<<<(W + kSelWinTable - 1) / kSelWinTable, kThreads, 0,
                                   (cudaStream_t)stream>>>(cand, W, M, k, thresh);
  }
  return (int)cudaGetLastError();
}

// cands: the gathered (W, M) candidates, each window's threshold their
// k-th (W <= kSelWinTable, 1 <= k <= M); work: as fk_topn_select_append's
int fk_topn_select_given(const int32_t* wcounts, int64_t rows, int32_t W, const uint8_t* used,
                         const int64_t* end_panes, const uint8_t* w_valid, int64_t anchor,
                         const float* cands, int32_t M, int32_t k, int32_t row_offset,
                         int32_t sel_cap, int32_t* ring, int32_t ring_rows, int32_t ring_cols,
                         int64_t* work, int64_t work_windows, int64_t work_tiles, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  return launch_topn(wcounts, rows, W, used, end_panes, w_valid, host_fire(0, 0, anchor), k,
                     cands, M, row_offset, sel_cap, ring, ring_rows, ring_cols, work,
                     work_windows, work_tiles, (cudaStream_t)stream);
}

// the wrapper's argument block (window_kernels.py _RING_ARGS), every
// field 64 bits: lanes in PaneState order with their words' width and
// fill bits, unused lanes dropped
struct RingArgs {
  int64_t rows, src_ring, dst_ring, n_lanes;
  int64_t src_col, keep, err;
  int64_t src[kRingLanes], dst[kRingLanes], width[kRingLanes], fill[kRingLanes];
};

int fk_ring_columns(const RingArgs* a, void* stream) {
  if (a->rows >= (1ll << 31) || a->src_ring >= (1ll << 31) || a->dst_ring >= (1ll << 31) ||
      a->n_lanes < 1 || a->n_lanes > kRingLanes)
    return (int)cudaErrorInvalidValue;
  RingParams p{};
  p.n_lanes = (int32_t)a->n_lanes;
  p.rows = (int32_t)a->rows;
  p.src_ring = (int32_t)a->src_ring;
  p.dst_ring = (int32_t)a->dst_ring;
  p.src_col = (const int32_t*)a->src_col;
  p.keep = (const uint8_t*)a->keep;
  p.err = (int32_t*)a->err;
  p.run = nullptr;
  for (int l = 0; l < p.n_lanes; ++l) {
    if (a->width[l] < 1 || a->width[l] >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    p.lane[l] = RingLane{(const uint32_t*)a->src[l], (uint32_t*)a->dst[l], (int32_t)a->width[l],
                         (uint32_t)a->fill[l]};
  }
  return launch_ring_columns(p, (cudaStream_t)stream);
}

// the lean launch path (window_kernels.py LeanEntry): each entry
// above from one packed block of 64-bit words, the stream beside
// fk_scatter_counts from one packed block of 9 64-bit words
int fk_scatter_counts_packed(const int64_t* a, void* stream) {
  return fk_scatter_counts(
      (int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2], (const void*)(intptr_t)a[3],
      (int32_t)a[4], (const int32_t*)(intptr_t)a[5], (int64_t)a[6], (int32_t)a[7],
      (int32_t*)(intptr_t)a[8], stream);
}

// fk_scatter_split_counts from one packed block of 7 64-bit words
int fk_scatter_split_counts_packed(const int64_t* a, void* stream) {
  return fk_scatter_split_counts(
      (int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2], (const uint8_t*)(intptr_t)a[3],
      (int64_t)a[4], (int32_t)a[5], (int32_t*)(intptr_t)a[6], stream);
}

// fk_split_cells from one packed block of 6 64-bit words
int fk_split_cells_packed(const int64_t* a, void* stream) {
  return fk_split_cells(
      (const uint8_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2], (int32_t)a[3],
      (int32_t*)(intptr_t)a[4], (int32_t*)(intptr_t)a[5], stream);
}

// fk_window_counts from one packed block of 10 64-bit words
int fk_window_counts_packed(const int64_t* a, void* stream) {
  return fk_window_counts(
      (const int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2],
      (const int64_t*)(intptr_t)a[3], (const uint8_t*)(intptr_t)a[4], (int32_t)a[5],
      (int64_t)a[6], (int64_t)a[7], (int32_t)a[8], (int32_t*)(intptr_t)a[9], stream);
}

// fk_topn_select_append from one packed block of 15 64-bit words
int fk_topn_select_append_packed(const int64_t* a, void* stream) {
  return fk_topn_select_append(
      (const int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2],
      (const uint8_t*)(intptr_t)a[3], (const int64_t*)(intptr_t)a[4],
      (const uint8_t*)(intptr_t)a[5], (int64_t)a[6], (int32_t)a[7], (int32_t)a[8],
      (int32_t*)(intptr_t)a[9], (int32_t)a[10], (int32_t)a[11], (int64_t*)(intptr_t)a[12],
      (int64_t)a[13], (int64_t)a[14], stream);
}

// fk_topn_candidates from one packed block of 13 64-bit words
int fk_topn_candidates_packed(const int64_t* a, void* stream) {
  return fk_topn_candidates(
      (const int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2],
      (const uint8_t*)(intptr_t)a[3], (const uint8_t*)(intptr_t)a[4], (int32_t)a[5],
      (float*)(intptr_t)a[6], (int64_t)a[7], (uint32_t*)(intptr_t)a[8], (int64_t)a[9],
      (int64_t*)(intptr_t)a[10], (int64_t)a[11], (int64_t)a[12], stream);
}

// fk_topn_global_threshold from one packed block of 5 64-bit words
int fk_topn_global_threshold_packed(const int64_t* a, void* stream) {
  return fk_topn_global_threshold(
      (const float*)(intptr_t)a[0], (int32_t)a[1], (int32_t)a[2], (int32_t)a[3],
      (float*)(intptr_t)a[4], stream);
}

// fk_topn_select_given from one packed block of 18 64-bit words
int fk_topn_select_given_packed(const int64_t* a, void* stream) {
  return fk_topn_select_given(
      (const int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2],
      (const uint8_t*)(intptr_t)a[3], (const int64_t*)(intptr_t)a[4],
      (const uint8_t*)(intptr_t)a[5], (int64_t)a[6], (const float*)(intptr_t)a[7], (int32_t)a[8],
      (int32_t)a[9], (int32_t)a[10], (int32_t)a[11], (int32_t*)(intptr_t)a[12], (int32_t)a[13],
      (int32_t)a[14], (int64_t*)(intptr_t)a[15], (int64_t)a[16], (int64_t)a[17], stream);
}

}  // extern "C"
