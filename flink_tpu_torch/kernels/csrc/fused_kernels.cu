// Kernels of the window operator's host-fed native lane, hand-written for
// Hopper (sm_90a). Plain C interface, bound from Python with ctypes
// (flink_tpu_torch/kernels/fused_kernels.py); every entry point launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// The host's fused ingest scan (flink_tpu_torch/native/codec.cc) combines a
// batch per (slot, ring column) pair and packs each pair into one word.
// These kernels fold such uploads into the int32 count lane (a pair
// count of 0xFFF or more, or a pair domain past 20 bits, takes uint16
// triples in place of the words):
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
// the form of the pairs behind the header: F1's u32 words or F3's uint16
// triples (a launch argument; the header's words keep their meaning)
constexpr int32_t kFormWords = 0;
constexpr int32_t kFormTriples = 1;

// ---- F1: apply_pairs_u32 --------------------------------------------------
// word = pair << 12 | count, decoded with a logical shift; the padding
// word 0xFFFFFFFF decodes to count 0xFFF and is skipped, and so is a pair
// at or beyond ``limit`` (= dump_row * ring: the reference sends it to no
// cell). counts.flat[pair] += count, duplicates allowed (the plain
// version's index_add_ takes them). Bound: bytes — each word read once and
// one 4-byte read-modify-write per pair (~110k pairs for a Q5 batch,
// ~294k for WordCount: 1-4 MB, a microsecond of HBM time); the scattered
// adds, one L2 atomic each, set the time. Design: the caller passes the
// real words only (the native lane's power-of-two padding is neither
// uploaded nor read); a thread takes four words with one 16-byte load, a
// block a tile of kApplyTile words, so Q5's batch is one wave of ~108
// blocks (a persistent grid of 132 or 264 blocks walking the tiles
// measured 5 % slower at WordCount's batch, PERF.md §6); a warp's 128 words pass through shared memory so that each of
// its four add instructions takes 32 consecutive words (cells near each
// other when the words come in cell order, as a thread's own four would
// not); adds are integer atomicAdd with the result unused (a reduction,
// RED, that waits for nothing). The words before the first 16-byte
// boundary and after the last whole vector (0-3 each) take scalar loads
// in the first tile's block. The header form (F2's first launch) gives
// block 0 to the fused step's header decode; the kernel follows that
// decode, under F2 below.
constexpr int kApplyItems = 4;                       // words a thread: one 16-byte load
constexpr int kApplyTile = kThreads * kApplyItems;   // words a block

__device__ __forceinline__ void apply_pair_word(int32_t* __restrict__ counts, int64_t limit,
                                                uint32_t word) {
  const uint32_t cnt = word & 0xFFFu;
  const uint32_t pair = word >> 12;
  if (cnt == 0xFFFu || (int64_t)pair >= limit) return;
  if (cnt != 0) atomicAdd(&counts[pair], (int32_t)cnt);
}

// ---- F3: apply_pairs_u16 --------------------------------------------------
// (P, 3) uint16 triples [pair lo16, pair hi16, count]: the form for a pair
// count of 0xFFF or more, or a pair domain past 20 bits. The pair decodes
// as an int32, so a padding triple 0xFFFF/0xFFFF is -1 and skipped; a pair
// beyond the state (row >= rows, the dump row included in the state) is
// skipped as the reference's scatter drops it. counts.flat[pair] += count.
// Bound: bytes — 6 bytes a triple plus one 4-byte read-modify-write per
// pair; the scattered L2 adds set the time, as in F1. Design: the caller
// passes the real triples only (the C finalize writes them, no padding); a
// warp takes a chunk of 32 triples (192 bytes) by twelve 16-byte loads,
// one a lane, into shared memory, so that its add instruction takes 32
// consecutive triples, one a lane; a block is kWarps chunks, so the hot
// Q5 batch's ~11k triples are ~45 blocks (a warp of 256 triples, eight
// adds a lane, left only ~6 blocks and ran 2 x slower, PERF.md §6). The
// triples before the first 16-byte boundary (0-7, a triple start meets
// one within eight) and after the last whole chunk take scalar loads in
// the first tile's block. The header form (F2's first launch in the
// triple form) gives block 0 to the fused step's header decode.
constexpr int kTripleChunk = 32;                         // triples a warp
constexpr int kTripleVecs = kTripleChunk * 6 / 16;       // 16-byte loads a chunk
static_assert(kTripleVecs <= 32, "a chunk is at most one load a lane");

__device__ __forceinline__ void apply_triple(int32_t* __restrict__ counts, int64_t n_cells,
                                             uint32_t lo, uint32_t hi, uint32_t cnt) {
  const int32_t pair = (int32_t)(lo | (hi << 16));
  if (pair < 0 || (int64_t)pair >= n_cells || cnt == 0) return;
  atomicAdd(&counts[pair], (int32_t)cnt);
}

// ---- F2: fused_step ---------------------------------------------------------
// One upload per batch: the kHdr-word header, then the pairs, as F1's
// words or as F3's triples (the form is a launch argument). The
// header (flink_tpu/ops/window.py:570-584; the reference's _fused_fill_header
// writes it, so does the port's):
//   words 0-1 pane_lo, 2-3 pane_hi, 4-5 anchor (int64, little endian);
//   word 7 the clear mask of ring columns 0-31, word 6 of columns 32-63;
//   words 8 .. 8 + 63 window-end deltas vs pane_lo, kDeltaSentinel unused.
// A chain of launches on one stream, each reading what it needs from
// device memory — no header field goes back to the host:
//   1 apply_pairs_u32_kernel<true> (or apply_pairs_u16_kernel<true>):
//     block 0 decodes the header into a FusedParams block (the scalars,
//     the first fire_pad end panes and valid flags, the purge's keep mask
//     and identity column map, and two gate words — fire = any valid end
//     among the fire_pad slots, clear = a non-zero clear word; with the
//     gate off both are 1), the other blocks fold the pairs in (F1, or
//     F3 for a hot key's counts or a pair domain past 20 bits, so such a
//     batch keeps its one upload and one step); it runs with no pairs;
//   2 window_counts_kernel, 3-4 the top-n's two kernels at top-1 (K2, K3;
//     above top-1 the radix select's one cooperative launch or five),
//     which write nothing when the fire word is 0;
//   5 ring_columns_kernel in place (K4), the purge, which returns at once
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

// where the header form decodes from and to (unused by the plain form)
struct HeaderArgs {
  const int32_t* hdr;
  int32_t ring, fire_pad, fire_gate;
  FusedParams* p;
};

__device__ __forceinline__ int64_t hdr_i64(const int32_t* __restrict__ hdr, int i) {
  return (int64_t)(((uint64_t)(uint32_t)hdr[i + 1] << 32) | (uint64_t)(uint32_t)hdr[i]);
}

// the header decode, one whole block (thread t < fire_pad its end slot,
// t < ring its ring column)
__device__ __forceinline__ void decode_header(const HeaderArgs& h) {
  const int t = threadIdx.x;
  FusedParams* p = h.p;
  const int64_t pane_lo = hdr_i64(h.hdr, 0);
  const int32_t d = t < h.fire_pad ? h.hdr[8 + t] : kDeltaSentinel;
  const bool valid = d > kDeltaSentinel;
  if (t < h.fire_pad) {
    p->w_valid[t] = valid;
    p->end_panes[t] = valid ? pane_lo + d : kEndSentinel;
  }
  const uint32_t clear_lo = (uint32_t)h.hdr[7], clear_hi = (uint32_t)h.hdr[6];
  if (t < h.ring) {
    const uint32_t bit = t < 32 ? (clear_lo >> t) & 1u : (clear_hi >> (t - 32)) & 1u;
    p->keep[t] = bit == 0;
    p->src_col[t] = t;
  }
  const int any_valid = __syncthreads_or(valid);
  if (t == 0) {
    p->s = FireScalars{pane_lo, hdr_i64(h.hdr, 2), hdr_i64(h.hdr, 4), floor_mod(pane_lo, h.ring)};
    p->fire = !h.fire_gate || any_valid;
    p->clear = !h.fire_gate || (clear_lo | clear_hi) != 0;
  }
}

static_assert(kThreads >= kMaxFirePad && kThreads >= kMaxRing,
              "the header decode takes a thread an end slot and a ring column");

// F1 over n words: ``head`` scalar words up to the first 16-byte boundary,
// ``vecs`` 16-byte vectors from there (one a thread), then n - head - 4
// vecs scalar words; the header form's block 0 decodes the header instead
template <bool kHeader>
__global__ void __launch_bounds__(kThreads) apply_pairs_u32_kernel(
    int32_t* __restrict__ counts, int64_t limit, const int32_t* __restrict__ words, int64_t n,
    int32_t head, int64_t vecs, HeaderArgs h) {
  __shared__ int4 s_words[kThreads];
  if (kHeader && blockIdx.x == 0) {
    decode_header(h);
    return;
  }
  const int64_t blk = kHeader ? blockIdx.x - 1 : blockIdx.x;
  const int64_t v = blk * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // a lane past the words holds padding, which adds nothing
  s_words[threadIdx.x] = v < vecs ? ((const int4*)(words + head))[v] : make_int4(-1, -1, -1, -1);
  __syncwarp();
  const uint32_t* w = (const uint32_t*)(s_words + (threadIdx.x & ~31));
#pragma unroll
  for (int j = 0; j < kApplyItems; ++j) apply_pair_word(counts, limit, w[32 * j + lane]);
  if (blk == 0) {
    const int64_t tail0 = head + 4 * vecs;  // the ragged end, 0-3 words
    if ((int)threadIdx.x < head) apply_pair_word(counts, limit, (uint32_t)words[threadIdx.x]);
    else if ((int)threadIdx.x >= 4 && tail0 + threadIdx.x - 4 < n)
      apply_pair_word(counts, limit, (uint32_t)words[tail0 + threadIdx.x - 4]);
  }
}

// F1's launch: a tile a block, and in the header form one block more;
// with no words and no header, no launch
template <bool kHeader>
int launch_apply_u32(int32_t* counts, int64_t limit, const int32_t* words, int64_t n,
                     const HeaderArgs& h, cudaStream_t s) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  // words before the first 16-byte boundary (a 4-byte aligned pointer)
  int32_t head = (int32_t)((4 - (((uintptr_t)words >> 2) & 3)) & 3);
  if (head > n) head = (int32_t)n;
  const int64_t vecs = (n - head) / 4;
  int64_t blocks = n > 0 ? (4 * vecs + kApplyTile - 1) / kApplyTile : 0;
  if (n > 0 && blocks < 1) blocks = 1;
  if (kHeader) ++blocks;
  if (blocks > 0)
    apply_pairs_u32_kernel<kHeader>
        <<<(unsigned)blocks, kThreads, 0, s>>>(counts, limit, words, n, head, vecs, h);
  return (int)cudaGetLastError();
}

// F3 over n triples: ``head`` scalar triples up to the first 16-byte
// boundary, ``chunks`` whole warp chunks from there in the first
// chunk_blocks blocks, then the rest; the head and the rest (at most 7 +
// 31 triples, a thread each) take a block of their own, so that no
// thread waits on two loads in a row; the header form's block 0 decodes
// the header instead
template <bool kHeader>
__global__ void __launch_bounds__(kThreads) apply_pairs_u16_kernel(
    int32_t* __restrict__ counts, int64_t n_cells, const uint16_t* __restrict__ triples,
    int64_t n, int32_t head, int64_t chunks, int64_t chunk_blocks, HeaderArgs h) {
  __shared__ int4 s_chunk[kWarps][kTripleVecs];
  if (kHeader && blockIdx.x == 0) {
    decode_header(h);
    return;
  }
  const int64_t blk = kHeader ? blockIdx.x - 1 : blockIdx.x;
  if (blk == chunk_blocks) {
    const int64_t tail0 = head + chunks * kTripleChunk;  // the ragged end
    const int64_t t = threadIdx.x;
    const int64_t k = t < head ? t : tail0 + (t - head);
    if (k < n)
      apply_triple(counts, n_cells, triples[3 * k], triples[3 * k + 1], triples[3 * k + 2]);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c = blk * kWarps + warp;
  if (c < chunks) {
    const int4* src = (const int4*)(triples + 3 * (int64_t)head) + c * kTripleVecs;
    if (lane < kTripleVecs) s_chunk[warp][lane] = src[lane];
    __syncwarp();
    const uint16_t* t = (const uint16_t*)s_chunk[warp] + 3 * lane;
    apply_triple(counts, n_cells, t[0], t[1], t[2]);
  }
}

// F3's launch: kWarps chunks a block, one block for the head and the
// rest when there are any, and in the header form one block more; with
// no triples and no header, no launch
template <bool kHeader>
int launch_apply_u16(int32_t* counts, int64_t n_cells, const uint16_t* triples, int64_t n,
                     const HeaderArgs& h, cudaStream_t s) {
  if (n < 0 || ((uintptr_t)triples & 1)) return (int)cudaErrorInvalidValue;
  // triples before the first 16-byte boundary: a triple starts 6 bytes
  // after the last, so one of the first eight starts on it
  int32_t head = 0;
  while (head < 8 && (((uintptr_t)triples + 6 * head) & 15)) ++head;
  if (head > n) head = (int32_t)n;
  const int64_t chunks = (n - head) / kTripleChunk;
  const int64_t chunk_blocks = (chunks + kWarps - 1) / kWarps;
  int64_t blocks = chunk_blocks + (n > head + chunks * kTripleChunk || head > 0 ? 1 : 0);
  static_assert(7 + kTripleChunk - 1 <= kThreads, "the rest is at most a thread a triple");
  if (kHeader) ++blocks;
  if (blocks > 0)
    apply_pairs_u16_kernel<kHeader><<<(unsigned)blocks, kThreads, 0, s>>>(
        counts, n_cells, triples, n, head, chunks, chunk_blocks, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ff_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ff_params_bytes() { return (int)sizeof(FusedParams); }

int ff_apply_pairs_u32(int32_t* counts, int64_t limit, const int32_t* words, int64_t n,
                       void* stream) {
  return launch_apply_u32<false>(counts, limit, words, n, HeaderArgs{}, (cudaStream_t)stream);
}

int ff_apply_pairs_u16(int32_t* counts, int64_t n_cells, const uint16_t* triples, int64_t n,
                       void* stream) {
  return launch_apply_u16<false>(counts, n_cells, triples, n, HeaderArgs{}, (cudaStream_t)stream);
}

// scratch (allocated by the caller): params (ff_params_bytes()), wcounts
// (rows * fire_pad int32); work: the step's clean workspace
// (window_kernels.py clean_workspace), cut for work_windows windows and
// work_tiles selection tiles (select_work_words)
int ff_fused_step(int32_t* counts, int64_t rows, int32_t ring, const int32_t* buf,
                  int64_t n_words, int32_t form, const uint8_t* used, int32_t ppw, int32_t n,
                  int32_t sel_cap, int32_t* emit_ring, int32_t ring_rows, int32_t ring_cols,
                  int32_t dump_row, int32_t fire_gate, int32_t fire_pad, void* params,
                  int32_t* wcounts, int64_t* work, int64_t work_windows, int64_t work_tiles,
                  int32_t* err, void* stream) {
  if (ring < 1 || ring > kMaxRing || fire_pad < 1 || fire_pad > kMaxFirePad || n_words < kHdr ||
      (form != kFormWords && form != kFormTriples))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  FusedParams* p = (FusedParams*)params;
  const HeaderArgs hdr{buf, ring, fire_pad, fire_gate, p};
  // the pairs behind the header: u32 words (F1's rule), or uint16 triples
  // (F3's rule: every cell of the state, the dump row's too), as many
  // whole triples as the words hold
  int rc = form == kFormWords
               ? launch_apply_u32<true>(counts, (int64_t)dump_row * ring, buf + kHdr,
                                        n_words - kHdr, hdr, s)
               : launch_apply_u16<true>(counts, rows * ring, (const uint16_t*)(buf + kHdr),
                                        (n_words - kHdr) * 4 / 6, hdr, s);
  if (rc) return rc;
  const FireSource fire{{0, 0, 0}, &p->s, &p->fire};
  rc = launch_window_counts(counts, rows, ring, p->end_panes, p->w_valid, fire_pad, fire, ppw,
                            wcounts, s);
  if (rc) return rc;
  rc = launch_topn(wcounts, rows, fire_pad, used, p->end_panes, p->w_valid, fire, n, nullptr, 0, 0,
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

// ff_fused_step from one packed block of 22 64-bit words (the form last)
int ff_fused_step_packed(const int64_t* a, void* stream) {
  return ff_fused_step(
      (int32_t*)(intptr_t)a[0], (int64_t)a[1], (int32_t)a[2], (const int32_t*)(intptr_t)a[3],
      (int64_t)a[4], (int32_t)a[21], (const uint8_t*)(intptr_t)a[5], (int32_t)a[6], (int32_t)a[7],
      (int32_t)a[8], (int32_t*)(intptr_t)a[9], (int32_t)a[10], (int32_t)a[11], (int32_t)a[12],
      (int32_t)a[13], (int32_t)a[14], (void*)(intptr_t)a[15], (int32_t*)(intptr_t)a[16],
      (int64_t*)(intptr_t)a[17], (int64_t)a[18], (int64_t)a[19], (int32_t*)(intptr_t)a[20],
      stream);
}

}  // extern "C"
