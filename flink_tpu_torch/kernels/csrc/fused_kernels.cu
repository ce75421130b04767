// Kernels of the window operator's host-fed native lane, hand-written for
// Hopper (sm_90a). Plain C interface, bound from Python with ctypes
// (flink_tpu_torch/kernels/fused_kernels.py); every entry point launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// The host's fused ingest scan (flink_tpu_torch/native/codec.cc) combines a
// batch per (slot, ring column) pair and packs each pair into one word.
// These kernels fold such uploads into the int32 count lane:
//
// F1 apply_pairs_u32  replaces flink_tpu/ops/window.py:190
//                     _apply_preagg_u32_core (via :172 apply_preagg_u32_kernel)
// F2 fused_step       replaces flink_tpu/ops/window.py:587 fused_step_kernel
//                     + :633 _fused_fire_clear
// F3 apply_pairs_u16  replaces flink_tpu/ops/window.py:145
//                     apply_preagg_u16_kernel
//
// All three add integers with atomics, exact in any order, so the state
// equals the plain PyTorch versions and the JAX reference bit for bit;
// F2's fire and purge are window_fire.cuh's kernels, the same ones that
// window_kernels.cu launches from the host.
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_common.cuh"
#include "window_fire.cuh"

namespace {

// the fused-step upload: a kHdr-word header, then one u32 pair word each
// (flink_tpu/ops/window.py:570-584, FUSED_HDR)
constexpr int64_t kHdr = 128;
// header window-end slots (MIN_FIRE_PAD) and the widest ring whose clear
// mask the header's two words carry
constexpr int32_t kMaxFirePad = 64;
constexpr int32_t kMaxRing = 64;
// an unused window-end slot's delta (_DELTA_SENTINEL), and the end pane a
// fire reads for it (_END_SENTINEL)
constexpr int32_t kDeltaSentinel = -(1 << 30);
constexpr int64_t kEndSentinel = -(1LL << 62);

// ---- F1: apply_pairs_u32 --------------------------------------------------
// word = pair << 12 | count, decoded with a logical shift; the padding
// word 0xFFFFFFFF decodes to count 0xFFF and is skipped, and so is a pair
// at or beyond ``limit`` (= dump_row * ring: the reference sends it to no
// cell). counts.flat[pair] += count. Bound: bytes — each word read once
// and one 4-byte read-modify-write per pair (~110k pairs for a Q5 batch,
// ~330k for WordCount: 1-4 MB, a microsecond of HBM time), so the launch
// dominates. Design: one thread per word, integer atomicAdd.
__device__ __forceinline__ void apply_pair_word(int32_t* __restrict__ counts, int64_t limit,
                                                uint32_t word) {
  const uint32_t cnt = word & 0xFFFu;
  const uint32_t pair = word >> 12;
  if (cnt == 0xFFFu || (int64_t)pair >= limit) return;
  if (cnt != 0) atomicAdd(&counts[pair], (int32_t)cnt);
}

__global__ void apply_pairs_u32_kernel(int32_t* __restrict__ counts, int64_t limit,
                                       const int32_t* __restrict__ words, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    apply_pair_word(counts, limit, (uint32_t)words[i]);
}

// ---- F3: apply_pairs_u16 --------------------------------------------------
// (P, 3) uint16 triples [pair lo16, pair hi16, count]: the form for a pair
// count of 0xFFF or more. The pair decodes as an int32, so the padding
// triple 0xFFFF/0xFFFF is -1 and skipped; a pair beyond the state
// (row >= rows) is skipped as the reference's scatter drops it.
// counts.flat[pair] += count. Bound: bytes — 6 bytes a triple plus one
// read-modify-write per pair. Design: one thread per triple, atomicAdd.
__global__ void apply_pairs_u16_kernel(int32_t* __restrict__ counts, int64_t n_cells,
                                       const uint16_t* __restrict__ triples, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint16_t* t = triples + 3 * i;
    const int32_t pair = (int32_t)((uint32_t)t[0] | ((uint32_t)t[1] << 16));
    if (pair < 0 || (int64_t)pair >= n_cells) continue;
    if (t[2] != 0) atomicAdd(&counts[pair], (int32_t)t[2]);
  }
}

// ---- F2: fused_step ---------------------------------------------------------
// One upload per batch: the kHdr-word header, then the pair words. The
// header (flink_tpu/ops/window.py:570-584; the reference's _fused_fill_header
// writes it, so does the port's):
//   words 0-1 pane_lo, 2-3 pane_hi, 4-5 anchor (int64, little endian);
//   word 7 the clear mask of ring columns 0-31, word 6 of columns 32-63;
//   words 8 .. 8 + 63 window-end deltas vs pane_lo, kDeltaSentinel unused.
// A chain of launches on one stream, each reading what it needs from
// device memory — no header field goes back to the host:
//   1 fused_header_kernel decodes the header into a FusedParams block:
//     the scalars, the first fire_pad end panes and valid flags, the
//     purge's keep mask and identity column map, and two gate words —
//     fire = any valid end among the fire_pad slots, clear = a non-zero
//     clear word (with the gate off both are 1);
//   2 apply_pairs_u32_kernel folds the pairs in (F1);
//   3 window_counts_kernel, 4-5 the top-n's two kernels at top-1 (K2, K3;
//     above top-1 the radix select's one cooperative launch or five),
//     which write nothing when the fire word is 0;
//   6 ring_columns_kernel in place (K4), the purge, which returns at once
//     when the clear word is 0.
// Skipping changes no byte: with no valid end the top-n selects no row
// (and a skipped one leaves the ring and its workspace's epoch as they
// are), and an all-zero clear mask keeps every column.
struct FusedParams {
  FireScalars s;
  int32_t fire;
  int32_t clear;
  int64_t end_panes[kMaxFirePad];
  int32_t src_col[kMaxRing];
  uint8_t w_valid[kMaxFirePad];
  uint8_t keep[kMaxRing];
};

__device__ __forceinline__ int64_t hdr_i64(const int32_t* __restrict__ hdr, int i) {
  return (int64_t)(((uint64_t)(uint32_t)hdr[i + 1] << 32) | (uint64_t)(uint32_t)hdr[i]);
}

// one block of kMaxFirePad (== kMaxRing) threads
__global__ void fused_header_kernel(const int32_t* __restrict__ hdr, int32_t ring,
                                    int32_t fire_pad, int32_t fire_gate,
                                    FusedParams* __restrict__ p) {
  const int t = threadIdx.x;
  const int64_t pane_lo = hdr_i64(hdr, 0);
  const int32_t d = t < fire_pad ? hdr[8 + t] : kDeltaSentinel;
  const bool valid = d > kDeltaSentinel;
  if (t < fire_pad) {
    p->w_valid[t] = valid;
    p->end_panes[t] = valid ? pane_lo + d : kEndSentinel;
  }
  const uint32_t clear_lo = (uint32_t)hdr[7], clear_hi = (uint32_t)hdr[6];
  if (t < ring) {
    const uint32_t bit = t < 32 ? (clear_lo >> t) & 1u : (clear_hi >> (t - 32)) & 1u;
    p->keep[t] = bit == 0;
    p->src_col[t] = t;
  }
  const int any_valid = __syncthreads_or(valid);
  if (t == 0) {
    p->s = FireScalars{pane_lo, hdr_i64(hdr, 2), hdr_i64(hdr, 4), floor_mod(pane_lo, ring)};
    p->fire = !fire_gate || any_valid;
    p->clear = !fire_gate || (clear_lo | clear_hi) != 0;
  }
}

}  // namespace

extern "C" {

const char* ff_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ff_params_bytes() { return (int)sizeof(FusedParams); }

int ff_apply_pairs_u32(int32_t* counts, int64_t limit, const int32_t* words, int64_t n,
                       void* stream) {
  if (n > 0) {
    apply_pairs_u32_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(counts, limit,
                                                                               words, n);
  }
  return (int)cudaGetLastError();
}

int ff_apply_pairs_u16(int32_t* counts, int64_t n_cells, const uint16_t* triples, int64_t n,
                       void* stream) {
  if (n > 0) {
    apply_pairs_u16_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(counts, n_cells,
                                                                               triples, n);
  }
  return (int)cudaGetLastError();
}

// scratch (allocated by the caller): params (ff_params_bytes()), wcounts
// (rows * fire_pad int32); work: the step's clean workspace
// (window_kernels.py clean_workspace), cut for work_windows windows and
// work_tiles selection tiles (select_work_words)
int ff_fused_step(int32_t* counts, int64_t rows, int32_t ring, const int32_t* buf,
                  int64_t n_words, const uint8_t* used, int32_t ppw, int32_t n, int32_t sel_cap,
                  int32_t* emit_ring, int32_t ring_rows, int32_t ring_cols, int32_t dump_row,
                  int32_t fire_gate, int32_t fire_pad, void* params, int32_t* wcounts,
                  int64_t* work, int64_t work_windows, int64_t work_tiles, int32_t* err,
                  void* stream) {
  if (ring < 1 || ring > kMaxRing || fire_pad < 1 || fire_pad > kMaxFirePad || n_words < kHdr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  FusedParams* p = (FusedParams*)params;
  fused_header_kernel<<<1, kMaxFirePad, 0, s>>>(buf, ring, fire_pad, fire_gate, p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = ff_apply_pairs_u32(counts, (int64_t)dump_row * ring, buf + kHdr, n_words - kHdr, stream);
  if (rc) return rc;
  const FireSource fire{{0, 0, 0}, &p->s, &p->fire};
  rc = launch_window_counts(counts, rows, ring, p->end_panes, p->w_valid, fire_pad, fire, ppw,
                            wcounts, s);
  if (rc) return rc;
  rc = launch_topn(wcounts, rows, fire_pad, used, p->end_panes, p->w_valid, fire, n, nullptr, 0,
                   sel_cap, emit_ring, ring_rows, ring_cols, work, work_windows, work_tiles, s);
  if (rc) return rc;
  RingParams purge{};
  purge.lane[0] = RingLane{(const uint32_t*)counts, (uint32_t*)counts, 1, 0u};
  purge.n_lanes = 1;
  purge.rows = (int32_t)rows;
  purge.src_ring = purge.dst_ring = ring;
  purge.src_col = p->src_col;
  purge.keep = p->keep;
  purge.err = err;
  purge.run = &p->clear;
  return launch_ring_columns(purge, s);
}

// the lean launch path (window_kernels.py LeanEntry): each entry
// above from one packed block of 64-bit words, the stream beside
// ff_apply_pairs_u32 from one packed block of 4 64-bit words
int ff_apply_pairs_u32_packed(const int64_t* a, void* stream) {
  return ff_apply_pairs_u32(
      (int32_t*)(intptr_t)a[0], (int64_t)a[1], (const int32_t*)(intptr_t)a[2], (int64_t)a[3],
      stream);
}

// ff_apply_pairs_u16 from one packed block of 4 64-bit words
int ff_apply_pairs_u16_packed(const int64_t* a, void* stream) {
  return ff_apply_pairs_u16(
      (int32_t*)(intptr_t)a[0], (int64_t)a[1], (const uint16_t*)(intptr_t)a[2], (int64_t)a[3],
      stream);
}

// ff_fused_step from one packed block of 21 64-bit words
int ff_fused_step_packed(const int64_t* a, void* stream) {
  return ff_fused_step(
      (int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2], (const int32_t*)(intptr_t)a[3],
      (int64_t)a[4], (const uint8_t*)(intptr_t)a[5], (int32_t)a[6], (int32_t)a[7], (int32_t)a[8],
      (int32_t*)(intptr_t)a[9], (int32_t)a[10], (int32_t)a[11], (int32_t)a[12], (int32_t)a[13],
      (int32_t)a[14], (void*)(intptr_t)a[15], (int32_t*)(intptr_t)a[16], (int64_t*)(intptr_t)a[17],
      (int64_t)a[18], (int64_t)a[19], (int32_t*)(intptr_t)a[20], stream);
}

}  // extern "C"
