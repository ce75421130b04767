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
//                         topn_global_threshold, topn_select_given)
//                         replaces :1585 topn_shard's top_k, all_gather
//                         threshold and select
// K4 ring_columns         replaces flink_tpu/ops/window.py:825 clear_kernel
//                         and :888 ring_remap_kernel (every lane)
// K7 split_cells          replaces flink_tpu/ops/window.py:101 split_decode
//                         and the decode of :122 apply_kernel_split (the
//                         scatter itself is K1 or lane_kernels.cu's L2)
//
// K2-K4's kernels live in window_fire.cuh, which fused_kernels.cu (the
// one-upload fused step) launches too.
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_common.cuh"
#include "window_fire.cuh"

namespace {

// error-word bits of scatter_counts and split_cells (window_kernels.py
// ERROR_BITS decodes them)
constexpr int32_t kErrScatterIndex = 1;
constexpr int32_t kErrSplitCell = 64;
// the slot id of an invalid record in a split upload
constexpr uint32_t kInvalidSlotU16 = 0xFFFF;

// ---- K1: scatter_counts --------------------------------------------------
// counts.flat[idx[i]] += cnt[i] (or += 1 when cnt is null); idx is int32,
// or int64 once the state reaches 2^31 cells (the operator's upload
// switches where the reference's does).
// Bound: bytes — the idx/cnt stream plus one 4-byte read-modify-write per
// entry; at the Q5 shape (~110k host-combined pairs) that is ~1.8 MB,
// well under a microsecond of HBM time, so the launch dominates. Design:
// one thread per entry, integer atomicAdd (exact in any order, so no
// sort or segment pass is needed). An out-of-range index is not written
// (a malformed upload cannot corrupt memory) and sets kErrScatterIndex;
// with skip_negative a negative index is an invalid record, skipped
// silently (a key-sharded block's received buckets pad with -1).
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

// ---- K7: split_cells -----------------------------------------------------
// The per-record upload of 3 bytes a record, (B, 3) uint8: bytes 0-1 the
// little-endian slot id, byte 2 the ring column; slot 0xFFFF is an
// invalid record and goes to the dump row. cells[i] = row * ring + col,
// the int32 flat cell that scatter_counts / scatter_lanes take. A slot
// past the dump row or a column past the ring writes cell -1 (which the
// scatter then skips and reports too) and sets kErrSplitCell.
// Bound: bytes — 3 read and 4 written a record. Design: one thread per
// record reads its three bytes (records are 3-byte aligned, so no wider
// load); the writes coalesce.
__global__ void split_cells_kernel(const uint8_t* __restrict__ sc, int64_t n, int32_t ring,
                                   int32_t dump_row, int32_t* __restrict__ cells,
                                   int32_t* __restrict__ err) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint8_t* rec = sc + 3 * i;
    const uint32_t slot = (uint32_t)rec[0] | ((uint32_t)rec[1] << 8);
    const int32_t col = rec[2];
    const int32_t row = slot == kInvalidSlotU16 ? dump_row : (int32_t)slot;
    if (row > dump_row || col >= ring) {
      atomicOr(err, kErrSplitCell);
      cells[i] = -1;
      continue;
    }
    cells[i] = row * ring + col;
  }
}

}  // namespace

extern "C" {

const char* fk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int fk_scatter_counts(int32_t* counts, int64_t n_cells, const void* idx, int32_t idx_bytes,
                      const int32_t* cnt, int64_t n, int32_t skip_negative, int32_t* err,
                      void* stream) {
  if (idx_bytes != 4 && idx_bytes != 8) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (idx_bytes == 8)
      scatter_counts_kernel<int64_t><<<grid_for(n), kThreads, 0, s>>>(
          counts, n_cells, (const int64_t*)idx, cnt, n, skip_negative, err);
    else
      scatter_counts_kernel<int32_t><<<grid_for(n), kThreads, 0, s>>>(
          counts, n_cells, (const int32_t*)idx, cnt, n, skip_negative, err);
  }
  return (int)cudaGetLastError();
}

int fk_split_cells(const uint8_t* sc, int64_t n, int32_t ring, int32_t dump_row, int32_t* cells,
                   int32_t* err, void* stream) {
  if (n > 0) {
    split_cells_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(sc, n, ring, dump_row,
                                                                          cells, err);
  }
  return (int)cudaGetLastError();
}

int fk_window_counts(const int32_t* counts, int64_t rows, int32_t ring, const int64_t* end_panes,
                     const uint8_t* w_valid, int32_t W, int64_t pane_lo, int64_t pane_hi,
                     int32_t ppw, int32_t* out, void* stream) {
  launch_window_counts(counts, rows, ring, end_panes, w_valid, W, host_fire(pane_lo, pane_hi, 0),
                       ppw, out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
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
                     nullptr, 0, sel_cap, ring, ring_rows, ring_cols, work, work_windows,
                     work_tiles, (cudaStream_t)stream);
}

int fk_topn_candidates(const int32_t* wcounts, int64_t rows, int32_t W, const uint8_t* used,
                       const uint8_t* w_valid, int32_t k, float* cand, void* stream) {
  if (W > 0 && k > 0) {
    topn_candidates_kernel<<<W, kThreads, 0, (cudaStream_t)stream>>>(wcounts, rows, W, used,
                                                                    w_valid, k, cand);
  }
  return (int)cudaGetLastError();
}

int fk_topn_global_threshold(const float* cand, int32_t W, int32_t M, int32_t k, float* thresh,
                             void* stream) {
  if (W > 0) {
    topn_global_threshold_kernel<<<W, kThreads, 0, (cudaStream_t)stream>>>(cand, M, k, thresh);
  }
  return (int)cudaGetLastError();
}

// work: as fk_topn_select_append's
int fk_topn_select_given(const int32_t* wcounts, int64_t rows, int32_t W, const uint8_t* used,
                         const int64_t* end_panes, const uint8_t* w_valid, int64_t anchor,
                         const float* thresh, int32_t row_offset, int32_t sel_cap, int32_t* ring,
                         int32_t ring_rows, int32_t ring_cols, int64_t* work,
                         int64_t work_windows, int64_t work_tiles, void* stream) {
  return launch_topn(wcounts, rows, W, used, end_panes, w_valid, host_fire(0, 0, anchor), 1,
                     thresh, row_offset, sel_cap, ring, ring_rows, ring_cols, work, work_windows,
                     work_tiles, (cudaStream_t)stream);
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
// fk_scatter_counts from one packed block of 8 64-bit words
int fk_scatter_counts_packed(const int64_t* a, void* stream) {
  return fk_scatter_counts(
      (int32_t*)(intptr_t)a[0], (int64_t)a[1], (const void*)(intptr_t)a[2], (int32_t)a[3],
      (const int32_t*)(intptr_t)a[4], (int64_t)a[5], (int32_t)a[6], (int32_t*)(intptr_t)a[7],
      stream);
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

// fk_topn_candidates from one packed block of 7 64-bit words
int fk_topn_candidates_packed(const int64_t* a, void* stream) {
  return fk_topn_candidates(
      (const int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2],
      (const uint8_t*)(intptr_t)a[3], (const uint8_t*)(intptr_t)a[4], (int32_t)a[5],
      (float*)(intptr_t)a[6], stream);
}

// fk_topn_global_threshold from one packed block of 5 64-bit words
int fk_topn_global_threshold_packed(const int64_t* a, void* stream) {
  return fk_topn_global_threshold(
      (const float*)(intptr_t)a[0], (int32_t)a[1], (int32_t)a[2], (int32_t)a[3],
      (float*)(intptr_t)a[4], stream);
}

// fk_topn_select_given from one packed block of 16 64-bit words
int fk_topn_select_given_packed(const int64_t* a, void* stream) {
  return fk_topn_select_given(
      (const int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2],
      (const uint8_t*)(intptr_t)a[3], (const int64_t*)(intptr_t)a[4],
      (const uint8_t*)(intptr_t)a[5], (int64_t)a[6], (const float*)(intptr_t)a[7], (int32_t)a[8],
      (int32_t)a[9], (int32_t*)(intptr_t)a[10], (int32_t)a[11], (int32_t)a[12],
      (int64_t*)(intptr_t)a[13], (int64_t)a[14], (int64_t)a[15], stream);
}

}  // extern "C"
