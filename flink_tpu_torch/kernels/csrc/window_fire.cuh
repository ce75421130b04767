// The fire and purge kernels of the count lane, shared by the sources
// that launch them: window_kernels.cu (K2-K4, each launched from the host
// with its scalars as arguments) and fused_kernels.cu (F2, the one-upload
// fused step, which launches the same kernels with their scalars and gates
// read from a parameter block that a kernel decoded on the card from the
// uploaded header). One body per kernel; a FireSource says where its
// scalars come from. Include once, after window_common.cuh.
#pragma once

#include <math.h>

#include "topn_select.cuh"
#include "window_common.cuh"

namespace {

// error-word bit of ring_columns (window_kernels.py ERROR_BITS decodes it)
constexpr int32_t kErrRingColumn = 2;

// ---- block max (kThreads threads) ----------------------------------------

__device__ __forceinline__ float block_max(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // smem may still be read by a previous call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float r = smem[0];
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, smem[i]);
  return r;
}

// ---- K2: window_counts ---------------------------------------------------
// out[r, w] = sum of counts[r, p mod ring] over panes p in
// [end_w - ppw, end_w) ∩ [pane_lo, min(pane_hi, pane_lo + ring - 1)],
// 0 where !w_valid[w]. The JAX kernel gets the same numbers from a ring
// roll + cumsum + prefix difference (a TPU-friendly form); here each
// thread owns one output cell and adds its window's live panes directly.
// Bound: bytes — counts read once (rows x ring x 4) and the
// (rows x W) output written once; neighbouring threads share a row, so
// the repeated pane reads of overlapping windows hit L1/L2, not HBM.
__global__ void window_counts_kernel(const int32_t* __restrict__ counts, int64_t rows,
                                     int32_t ring, const int64_t* __restrict__ end_panes,
                                     const uint8_t* __restrict__ w_valid, int32_t W,
                                     FireSource src, int32_t ppw, int32_t* __restrict__ out) {
  if (src.skip()) return;
  const FireScalars s = src.get();
  const int64_t total = rows * (int64_t)W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t hi_cap = live_hi_cap(s.pane_lo, s.pane_hi, ring);
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int64_t r = t / W;
    const int32_t w = (int32_t)(t - r * W);
    out[t] = w_valid[w]
                 ? window_count(counts + r * ring, ring, end_panes[w], s.pane_lo, hi_cap, ppw)
                 : 0;
  }
}

inline void launch_window_counts(const int32_t* counts, int64_t rows, int32_t ring,
                                 const int64_t* end_panes, const uint8_t* w_valid, int32_t W,
                                 FireSource src, int32_t ppw, int32_t* out, cudaStream_t s) {
  const int64_t total = rows * (int64_t)W;
  if (total > 0) {
    window_counts_kernel<<<grid_for(total), kThreads, 0, s>>>(counts, rows, ring, end_panes,
                                                             w_valid, W, src, ppw, out);
  }
}

// ---- K3: topn_select_append ----------------------------------------------
// Per window: candidates are cells with count > 0 on a registered row;
// they rank by the count as f32 (what count().finalize gives the JAX
// kernel, so counts past 2^24 tie as their f32 values do). The threshold
// is the n-th largest candidate value with ties counted, -inf when a
// window has fewer than n candidates. Cells at or above it are selected,
// compacted in row-major (row, window) order and appended to the emit
// ring as [row + row_offset, end_pane - anchor, count].
//
// Bound: bytes — one read of the (rows x W) window counts plus the used
// mask, and a few hundred bytes of appended rows. Design: topn_select.cuh's
// count form, the threshold over the whole card in tiles (a block a
// window would hold W = 11 of the 132 SMs and read one word in W of every
// row): at top-1 two launches (each block's per-window maxima into a
// 64-bit (epoch, key) atomicMax a window, then the selection and the ring
// append in one launch by the look-back); above, the radix select (one
// cooperative launch, else five); against a given threshold
// (topn_select_given) the selection alone, one launch. The fused step
// (fused_kernels.cu) runs the same kernels, gated by its fire word, with
// the anchor from its parameter block.
__global__ void __launch_bounds__(kThreads) topn_max_kernel(const SelParams p) {
  sel_max<true>(p);
}

__global__ void __launch_bounds__(kThreads) topn_radix_kernel(const SelParams p, int pass) {
  sel_radix<true>(p, pass);
}

__global__ void __launch_bounds__(kThreads) topn_radix_all_kernel(const SelParams p) {
  sel_radix_all<true>(p);
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads) topn_select_kernel(const SelParams p) {
  select_tile<true, kTable, kSelItems>(p);
}

// the selection against a given threshold (the same body; its own name
// in a profile)
template <bool kTable>
__global__ void __launch_bounds__(kThreads) topn_given_kernel(const SelParams p) {
  select_tile<true, kTable, kSelItems>(p);
}

int g_topn_capacity[64];
const SelKernels kTopnKernels{topn_max_kernel,           topn_radix_kernel,
                              topn_radix_all_kernel,     topn_select_kernel<true>,
                              topn_select_kernel<false>, g_topn_capacity};
const SelKernels kTopnGivenKernels{nullptr, nullptr, nullptr, topn_given_kernel<true>,
                                   topn_given_kernel<false>, g_topn_capacity};

// One count-form selection into the emit ring: each window's top n
// against the whole-card threshold, or (``given`` non-null, f32 a window)
// against the given thresholds; ``work`` is the entry point's clean
// workspace, cut for Wc windows and Tc selection tiles
// (select_work_words). Returns the first launch error.
inline int launch_topn(const int32_t* wcounts, int64_t rows, int32_t W, const uint8_t* used,
                       const int64_t* end_panes, const uint8_t* w_valid, FireSource src,
                       int32_t n, const float* given, int32_t row_offset, int32_t sel_cap,
                       int32_t* ring, int32_t ring_rows, int32_t ring_cols, int64_t* work,
                       int64_t Wc, int64_t Tc, cudaStream_t s) {
  SelParams p{};
  p.wcounts = wcounts;
  p.rows = rows;
  p.W = W;
  p.k = given != nullptr ? 1 : (int32_t)(n < rows ? n : rows);
  p.sel_cap = sel_cap;
  p.row_cap = ring_rows - 2;
  p.ring_cols = ring_cols;
  p.row_offset = row_offset;
  p.used = used;
  p.end_panes = end_panes;
  p.w_valid = w_valid;
  p.src = src;
  p.given = given;
  p.ring = ring;
  return launch_select(p, work, Wc, Tc, given != nullptr ? kTopnGivenKernels : kTopnKernels, s);
}

// ---- K3 distributed mode (a key-sharded operator's top-n) -----------------
// The reference's topn_shard (flink_tpu/ops/window.py:1585-1626): each
// device block ranks its own rows, the blocks' top-k values per window are
// gathered, the global threshold is the k-th largest of them, and each
// block selects its rows against that global threshold and appends them,
// with their global row ids, to its own emit ring. Three kernels:
//   topn_candidates_kernel  (a) one block per window: the window's top k
//      candidate values of this device block, descending, each repeated
//      as often as it occurs, -inf past the candidates (lax.top_k's
//      (W, k) output over the -inf-masked values);
//   topn_global_threshold_kernel  one block per window: the k-th largest
//      of the gathered (W, M) candidates, ties counted, -inf when fewer
//      than k are finite;
//   (b) K3's selection against that threshold with the block's row
//      offset (launch_topn with ``given``: one launch).
// Bound: bytes — (a) reads the (rows x W) window counts and the used
// mask once per round (one round for Q5's top-1), the rest is a few
// hundred bytes; (b) as K3.

__global__ void topn_candidates_kernel(const int32_t* __restrict__ wcounts, int64_t rows,
                                       int32_t W, const uint8_t* __restrict__ used,
                                       const uint8_t* __restrict__ w_valid, int32_t k,
                                       float* __restrict__ cand) {
  __shared__ float s_max[kWarps];
  __shared__ long long s_sum[kWarps];
  const int32_t w = blockIdx.x;
  float* out = cand + (int64_t)w * k;
  int32_t filled = 0;
  if (w_valid[w]) {
    float ceiling = INFINITY;  // each round looks only below it
    while (filled < k) {
      float m = -INFINITY;
      for (int64_t r = threadIdx.x; r < rows; r += blockDim.x) {
        const int32_t c = wcounts[r * W + w];
        if (c > 0 && used[r]) {
          const float v = (float)c;
          if (v < ceiling && v > m) m = v;
        }
      }
      m = block_max(m, s_max);
      if (m == -INFINITY) break;  // no candidate left
      long long cnt = 0;
      for (int64_t r = threadIdx.x; r < rows; r += blockDim.x) {
        const int32_t c = wcounts[r * W + w];
        if (c > 0 && used[r] && (float)c == m) ++cnt;
      }
      cnt = block_sum(cnt, s_sum);
      const int32_t take = cnt < (long long)(k - filled) ? (int32_t)cnt : k - filled;
      for (int32_t j = threadIdx.x; j < take; j += blockDim.x) out[filled + j] = m;
      filled += take;
      ceiling = m;
    }
  }
  for (int32_t j = filled + threadIdx.x; j < k; j += blockDim.x) out[j] = -INFINITY;
}

__global__ void topn_global_threshold_kernel(const float* __restrict__ cand, int32_t M,
                                             int32_t k, float* __restrict__ thresh) {
  __shared__ float s_max[kWarps];
  __shared__ long long s_sum[kWarps];
  const float* row = cand + (int64_t)blockIdx.x * M;
  float result = -INFINITY;
  float ceiling = INFINITY;
  long long need = k;
  for (int32_t round = 0; round < k; ++round) {
    float m = -INFINITY;
    for (int32_t i = threadIdx.x; i < M; i += blockDim.x) {
      const float v = row[i];
      if (v < ceiling && v > m) m = v;
    }
    m = block_max(m, s_max);
    if (m == -INFINITY) break;  // fewer than k finite candidates
    long long c = 0;
    for (int32_t i = threadIdx.x; i < M; i += blockDim.x) c += row[i] == m;
    need -= block_sum(c, s_sum);
    if (need <= 0) {
      result = m;
      break;
    }
    ceiling = m;
  }
  if (threadIdx.x == 0) thresh[blockIdx.x] = result;
}

// ---- K4: ring_columns ----------------------------------------------------
// dst[r, j, l] = keep[j] ? src[r, src_col[j], l] : fill, over every lane
// of a state block in one launch: the int32 count lane (width 1, fill 0)
// and any f32 sum, max and min lanes (width >= 1) with their identities
// (0, -inf, +inf) as fills. Lanes move as 32-bit words, so every bit
// (NaN payloads, -0.0) is copied as it is. The purge is the in-place case
// (src == dst on every lane, src_col[j] == j where kept); a ring growth
// the out-of-place case (new tensors, a new ring width). A kept column
// whose src_col lies outside the source is written as the fill and sets
// kErrRingColumn. ``run`` (null from a host launch) gates the fused step's
// purge: nothing happens when *run == 0.
//
// Bound: bytes — rows x cleared columns x width x 4 written a lane for a
// purge; one read of the kept columns and one write of the new tensor a
// lane for a growth. At the main path's shapes that is under two
// microseconds, so the kernel is bound by its own latency: what comes
// before the first store, and how many dependent steps each store takes.
// Design: every warp lists, with ballots over coalesced reads of keep
// and src_col, the destination columns that need a write (in place: the
// cleared ones only; kept cells are neither read nor written), each with
// its source column or -1 for the fill, into its own slice of shared
// memory — no block barrier. Then each warp takes whole
// rows of each lane in turn: a row's listed words (or 16-byte groups of
// them) go to neighbouring threads, several rows a pass when a row has
// fewer than 32, so a listed run of columns, or a whole growing row, is
// written contiguously. Indices are 32-bit, and a thread works out its
// place in a row (a division by the lane's width) once, before the row
// loop, wherever a row's units fit a warp. A group
// of four words is written with one 16-byte store where it is contiguous
// in the destination and aligned (a lane width that is a multiple of 4,
// or every column of a row listed). A cleared run that wraps past the
// ring's end is two runs of the list, and a row's last run meets the
// next row's first.

// a state block's lanes at most (sums, maxs, mins, counts)
constexpr int kRingLanes = 4;
// destination columns a warp lists in shared memory at a time
constexpr int32_t kRingChunk = 256;

struct RingLane {
  const uint32_t* src;  // (rows, src_ring, width) words
  uint32_t* dst;        // (rows, dst_ring, width) words; src itself in place
  int32_t width;
  uint32_t fill;        // the fill's bits
};

struct RingParams {
  RingLane lane[kRingLanes];
  int32_t n_lanes, rows, src_ring, dst_ring;
  const int32_t* src_col;
  const uint8_t* keep;
  int32_t* err;
  const int32_t* run;
};

// Word u of a row's listed words (4-word group u where ``vec``): its
// destination offset in the row, and each word's source offset in the
// source row or -1 for the fill.
template <bool kVec>
__device__ __forceinline__ uint32_t ring_unit(const RingLane& L, const int32_t* s_dst,
                                              const int32_t* s_src, uint32_t u,
                                              int32_t (&from)[kVec ? 4 : 1]) {
  const uint32_t w = (uint32_t)L.width, k = kVec ? u * 4 : u;
  uint32_t c = w == 1 ? k : k / w, e = k - c * w;
  const uint32_t at = (uint32_t)s_dst[c] * w + e;
#pragma unroll
  for (int i = 0; i < (kVec ? 4 : 1); ++i) {
    const int32_t s = s_src[c];
    from[i] = s < 0 ? -1 : (int32_t)((uint32_t)s * w + e);
    if (++e == w) {
      e = 0;
      ++c;
    }
  }
  return at;
}

template <bool kVec>
__device__ __forceinline__ void ring_store(const RingLane& L, const uint32_t* src, uint32_t* dst,
                                           uint32_t at, const int32_t (&from)[kVec ? 4 : 1]) {
  if (kVec) {
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = from[i] < 0 ? L.fill : src[from[i]];
    *reinterpret_cast<uint4*>(dst + at) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    dst[at] = from[0] < 0 ? L.fill : src[from[0]];
  }
}

// One lane's listed words, n columns of the warp's list (s_dst, s_src)
// a row; rows go to warps. While a row's units (words, or 4-word groups)
// fit a warp, each pass takes several rows and every thread keeps one
// unit, its offsets worked out once; a longer row is swept 32 units at a
// time.
template <bool kVec>
__device__ __forceinline__ void ring_lane_rows(const RingLane& L, const RingParams& p,
                                               const int32_t* s_dst, const int32_t* s_src,
                                               uint32_t n, uint32_t warp_id, uint32_t n_warps) {
  const uint32_t w = (uint32_t)L.width, lane = threadIdx.x & 31;
  const uint32_t dst_row = (uint32_t)p.dst_ring * w, src_row = (uint32_t)p.src_ring * w;
  const uint32_t units = kVec ? n * w / 4 : n * w, rows = (uint32_t)p.rows;
  int32_t from[kVec ? 4 : 1];
  if (units < 32) {
    const uint32_t per_pass = 32 / units, lane_row = lane / units;
    if (lane_row >= per_pass) return;
    const uint32_t at = ring_unit<kVec>(L, s_dst, s_src, lane - lane_row * units, from);
    for (uint32_t r = warp_id * per_pass + lane_row; r < rows; r += n_warps * per_pass)
      ring_store<kVec>(L, L.src + r * src_row, L.dst + r * dst_row, at, from);
    return;
  }
  for (uint32_t r = warp_id; r < rows; r += n_warps) {
    for (uint32_t u = lane; u < units; u += 32) {
      const uint32_t at = ring_unit<kVec>(L, s_dst, s_src, u, from);
      ring_store<kVec>(L, L.src + r * src_row, L.dst + r * dst_row, at, from);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_columns_kernel(const __grid_constant__ RingParams p) {
  if (p.run != nullptr && *p.run == 0) return;
  // each warp's list: destination columns ascending, each one's source
  // column or -1 for the fill
  __shared__ int32_t s_dst[kWarps][kRingChunk];
  __shared__ int32_t s_src[kWarps][kRingChunk];
  const bool in_place = p.lane[0].src == p.lane[0].dst;
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t warp_id = blockIdx.x * kWarps + warp, n_warps = gridDim.x * kWarps;
  for (int32_t j0 = 0; j0 < p.dst_ring; j0 += kRingChunk) {
    const int32_t chunk = min(kRingChunk, p.dst_ring - j0);
    uint32_t n = 0;
    bool bad = false;
    for (int32_t c0 = 0; c0 < chunk; c0 += 32) {
      const int32_t c = c0 + (int32_t)lane;
      int32_t src = -1;
      bool listed = false;
      if (c < chunk) {
        const int32_t j = j0 + c, s = p.src_col[j];
        const bool kept = p.keep[j] != 0, inside = s >= 0 && s < p.src_ring;
        bad |= kept && !inside;
        src = kept && inside ? s : -1;
        listed = !in_place || src != j;
      }
      const uint32_t ballot = __ballot_sync(0xffffffffu, listed);
      if (listed) {
        const uint32_t at = n + __popc(ballot & ((1u << lane) - 1u));
        s_dst[warp][at] = j0 + c;
        s_src[warp][at] = src;
      }
      n += __popc(ballot);
    }
    if (bad && warp_id == 0) atomicOr(p.err, kErrRingColumn);
    __syncwarp();
#pragma unroll
    for (int l = 0; l < kRingLanes; ++l) {
      if (l >= p.n_lanes || n == 0) continue;
      const RingLane& L = p.lane[l];
      const uint32_t w = (uint32_t)L.width;
      // 4-word groups where each is contiguous in the destination and
      // 16-byte aligned: a width that is a multiple of 4, or whole rows
      if (((uintptr_t)L.dst & 15) == 0 &&
          (w % 4 == 0 || (n == (uint32_t)p.dst_ring && ((uint32_t)p.dst_ring * w) % 4 == 0)))
        ring_lane_rows<true>(L, p, s_dst[warp], s_src[warp], n, warp_id, n_warps);
      else
        ring_lane_rows<false>(L, p, s_dst[warp], s_src[warp], n, warp_id, n_warps);
    }
    __syncwarp();  // the next chunk rewrites the list
  }
}

// Validates the lanes (1..kRingLanes, widths >= 1, every lane in place
// or none, each lane's words below 2^31) and launches one kernel for all.
inline int launch_ring_columns(const RingParams& p, cudaStream_t s) {
  if (p.n_lanes < 1 || p.n_lanes > kRingLanes || p.rows < 0 || p.src_ring < 0 || p.dst_ring < 0)
    return (int)cudaErrorInvalidValue;
  const bool in_place = p.lane[0].src == p.lane[0].dst;
  if (in_place && p.src_ring != p.dst_ring) return (int)cudaErrorInvalidValue;
  int64_t most = 0;
  for (int l = 0; l < p.n_lanes; ++l) {
    const RingLane& L = p.lane[l];
    const int64_t words = (int64_t)p.rows * (p.src_ring > p.dst_ring ? p.src_ring : p.dst_ring) *
                          L.width;
    if (L.width < 1 || (L.src == L.dst) != in_place || words >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    if (words > most) most = words;
  }
  // a warp a row at most, and 2 blocks an SM: every warp lists the
  // columns before its first store, so more warps only add listing (the
  // purge and WordCount's count-lane growth measured fastest so; a
  // four-lane growth was faster with 8 an SM, PERF.md §6)
  int64_t blocks = ((int64_t)p.rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks / 4) blocks = kMaxBlocks / 4;
  if (most > 0 && p.dst_ring > 0)
    ring_columns_kernel<<<(int)(blocks > 0 ? blocks : 1), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
