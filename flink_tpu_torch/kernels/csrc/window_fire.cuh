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

// ---- K2: window_counts ---------------------------------------------------
// out[r, w] = sum of counts[r, p mod ring] over panes p in
// [end_w - ppw, end_w) ∩ [pane_lo, hi_cap], hi_cap = min(pane_hi,
// pane_lo + ring - 1); 0 where !w_valid[w]. The reference's form
// (flink_tpu/ops/window.py:355-365): each row's live panes summed once,
// in pane order, into a prefix P (P[0] = 0, P[j] = the first j live
// panes), and each window one difference, P[min(e - 1, hi_cap) -
// pane_lo + 1] - P[max(e - ppw, pane_lo) - pane_lo].
// Bound: bytes — each row's live columns read once and the (rows x W)
// output written once (at the Q5 fire, 32,769 x 21 live columns and
// 32,769 x 11 windows: 4.2 MB, 1.25 µs of HBM time).
// Design: a block takes a tile of up to kWcRows consecutive rows, one
// contiguous span of the row-major state. It asks for its first window
// table's inputs, stages the tile's live columns in pane order (16-byte
// loads of the 4-column chunks that hold a live column where the ring
// is whole chunks; the dead columns are not read), then works out the
// table once (each window's two prefix positions: the 64-bit arithmetic
// is done there and nowhere per output). One thread a row sums the
// row's prefix in place; then the block's threads take the (rows x
// windows) outputs in row-major order, each one difference, stored
// straight to the output (consecutive threads, consecutive words). A
// staged row's stride is odd, so a warp's rows hit distinct banks. Any
// W: the table holds kWcWindows windows a pass. Any ring: a row's live
// panes are staged WcPlan::seg at a time, each segment adding its share
// of every window with the row's running carry (one segment wherever a
// tile holds more than one row). The fused step's launch (its scalars
// on the card) stores only the valid windows' columns: its top-n reads
// w_valid before any count (topn_select.cuh), so the others' scratch
// words are never read.
constexpr int kWcThreads = 256;
constexpr int kWcRows = 128;
constexpr int kWcWindows = 64;
// a block's shared words at most: the window table (3 x kWcWindows), the
// rows' carries (kWcRows), then the staged prefix rows and, for rings
// staged in segments, the partial outputs (96 KB: the launch opts in
// past 48 KB)
constexpr int kWcSmemWords = 24576;

struct WcPlan {
  int32_t tile_rows;  // rows a block (a power of two, at most kWcRows)
  int32_t seg;        // live panes a row stages at once
  int32_t pstride;    // words of a staged prefix row (odd, >= seg + 1)
  int32_t wchunk;     // windows a pass (at most kWcWindows)
  int32_t smem_bytes;
  int32_t vec;        // 16-byte loads (see wc_stage)
  int64_t tiles;
};

// window_kernels.py window_counts_plan mirrors this; the tests hold the
// two together
inline WcPlan wc_plan(int64_t rows, int32_t ring, int32_t W) {
  WcPlan p{};
  p.wchunk = W < kWcWindows ? W : kWcWindows;
  const int32_t budget = kWcSmemWords - 3 * kWcWindows - kWcRows;
  int32_t t = kWcRows;
  while (t > 1 && (int64_t)t * (((ring + 1) | 1) + p.wchunk) > budget) t >>= 1;
  p.tile_rows = t;
  const int32_t room = budget / t - p.wchunk;  // words a row's prefix may take
  int32_t seg = ring < room - 1 ? ring : room - 1;
  if (((seg + 1) | 1) > room) --seg;
  p.seg = seg;
  p.pstride = (seg + 1) | 1;
  p.smem_bytes = 4 * (3 * kWcWindows + kWcRows + t * (p.pstride + p.wchunk));
  p.tiles = (rows + t - 1) / t;
  return p;
}

// P[t][1 + d] = tile[t][(c0 + s0 + d) mod ring] for the tile's T rows
// and the segment's positions d < ns (its live columns in pane order):
// with ``vec`` (a ring of whole 16-byte chunks whose count divides
// kWcThreads, a 16-byte aligned state) 16-byte loads of each chunk that
// holds a live column of the segment, up to eight in flight a thread;
// else 4-byte loads of the live columns, four in flight
__device__ __forceinline__ void wc_stage(const int32_t* __restrict__ tile, int32_t ring,
                                         int32_t T, uint32_t c0, int32_t s0, int32_t ns,
                                         uint32_t* P, int32_t pstride, bool vec) {
  if (ns <= 0) return;
  const uint32_t uring = (uint32_t)ring, uns = (uint32_t)ns;
  uint32_t cs = c0 + (uint32_t)s0;  // the segment's first column (s0 < nl <= ring, c0 < ring)
  if (cs >= uring) cs -= uring;
  const int32_t tid = (int32_t)threadIdx.x;
  if (vec) {
    // a thread keeps one chunk column k and takes every
    // (kWcThreads / cpr)-th row: its positions are worked out once
    const int32_t cpr = ring >> 2;  // chunks a row, dividing kWcThreads
    const uint4* src = (const uint4*)tile;
    const int32_t rstep = kWcThreads / cpr;
    const int32_t k = tid % cpr;
    uint32_t d = 4u * (uint32_t)k + uring - cs;
    if (d >= uring) d -= uring;
    uint32_t pos[4];
    bool in[4], any = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pos[c] = d + c >= uring ? d + c - uring : d + c;
      in[c] = pos[c] < uns;
      any = any || in[c];
    }
    if (!any) return;
    for (int32_t t0 = tid / cpr; t0 < T; t0 += 8 * rstep) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int32_t t = t0 + u * rstep;
        if (t < T) v[u] = __ldg(src + t * cpr + k);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int32_t t = t0 + u * rstep;
        if (t >= T) continue;
        uint32_t* dst = P + t * pstride + 1;
        if (in[0]) dst[pos[0]] = v[u].x;
        if (in[1]) dst[pos[1]] = v[u].y;
        if (in[2]) dst[pos[2]] = v[u].z;
        if (in[3]) dst[pos[3]] = v[u].w;
      }
    }
    return;
  }
  const int32_t total = T * ns;  // < 2^31 (wc_plan)
  const int32_t dt = kWcThreads / ns, dj = kWcThreads - dt * ns;
  int32_t t = tid / ns, j = tid - t * ns;
  for (int32_t i = tid; i < total; i += 4 * kWcThreads) {
    uint32_t v[4];
    int32_t at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t col = cs + (uint32_t)j;
      if (col >= uring) col -= uring;
      at[u] = i + u * kWcThreads < total ? t * pstride + 1 + j : -1;
      if (at[u] >= 0) v[u] = (uint32_t)__ldg(tile + t * ring + col);
      t += dt;
      j += dj;
      if (j >= ns) {
        j -= ns;
        ++t;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0) P[at[u]] = v[u];
  }
}

// two blocks an SM at least (at most 128 registers a thread): the Q5
// fire's 257 tiles then run in one wave of the 132 SMs
__global__ void __launch_bounds__(kWcThreads, 2)
    window_counts_kernel(const int32_t* __restrict__ counts, int64_t rows, int32_t ring,
                         const int64_t* __restrict__ end_panes,
                         const uint8_t* __restrict__ w_valid, int32_t W, FireSource src,
                         int32_t ppw, int32_t* __restrict__ out, WcPlan plan) {
  if (src.skip()) return;
  extern __shared__ uint32_t wc_smem[];
  int2* AB = (int2*)wc_smem;                 // a window's first live position, one past its last
  int32_t* V = (int32_t*)(AB + kWcWindows);  // its column is stored
  uint32_t* C = wc_smem + 3 * kWcWindows;    // a row's carry: its earlier segments' sum
  uint32_t* P = C + kWcRows;                 // tile_rows x pstride prefix
  uint32_t* O = P + plan.tile_rows * plan.pstride;  // tile_rows x wchunk partial outputs
  const int32_t tid = threadIdx.x;
  // the first window table's inputs, asked for first: their latency
  // hides behind the stage
  int64_t e_first = 0;
  uint8_t ok_first = 0;
  if (tid < plan.wchunk) {
    ok_first = w_valid[tid];
    e_first = end_panes[tid];
  }
  const FireScalars s = src.get();
  const int64_t hi_cap = live_hi_cap(s.pane_lo, s.pane_hi, ring);
  // live panes [pane_lo, hi_cap]: at most ring, none when pane_hi < pane_lo
  const int32_t nl = hi_cap >= s.pane_lo ? (int32_t)(hi_cap - s.pane_lo + 1) : 0;
  const uint32_t c0 = (uint32_t)s.lo_col;
  const int64_t r0 = (int64_t)blockIdx.x * plan.tile_rows;
  const int32_t T = rows - r0 < plan.tile_rows ? (int32_t)(rows - r0) : plan.tile_rows;
  const int32_t* tile = counts + r0 * ring;
  const bool store_invalid = src.dev == nullptr;
  const int32_t nsegs = nl > plan.seg ? (nl + plan.seg - 1) / plan.seg : 1;
  // one segment: its loads fly while the first window table is built
  if (nsegs == 1) wc_stage(tile, ring, T, c0, 0, nl, P, plan.pstride, plan.vec);
  for (int32_t w0 = 0; w0 < W; w0 += plan.wchunk) {
    const int32_t Wn = W - w0 < plan.wchunk ? W - w0 : plan.wchunk;
    if (tid < Wn) {
      const bool ok = (w0 == 0 ? ok_first : w_valid[w0 + tid]) != 0;
      const int64_t e = w0 == 0 ? e_first : end_panes[w0 + tid];
      int32_t a = 0, b = 0;
      if (ok) {
        const int64_t lo = e - ppw > s.pane_lo ? e - ppw : s.pane_lo;
        const int64_t hi = e - 1 < hi_cap ? e - 1 : hi_cap;
        if (lo <= hi) {
          a = (int32_t)(lo - s.pane_lo);
          b = (int32_t)(hi - s.pane_lo + 1);
        }
      }
      AB[tid] = make_int2(a, b);
      V[tid] = ok || store_invalid;
    }
    int32_t* dst = out + r0 * W + w0;  // T * W < 2^31 (launch_window_counts)
    const int32_t total = T * Wn;
    const int32_t dt = kWcThreads / Wn, dw = kWcThreads - dt * Wn;
    uint32_t carry = 0;  // the row's, in its prefix thread
    for (int32_t sg = 0; sg < nsegs; ++sg) {
      const int32_t s0 = sg * plan.seg;
      const int32_t ns = nl - s0 < plan.seg ? nl - s0 : plan.seg;
      // the prefix rows stay staged across window passes when one
      // segment holds every live pane
      const bool stage = nsegs > 1 || w0 == 0;
      if (nsegs > 1) wc_stage(tile, ring, T, c0, s0, ns, P, plan.pstride, plan.vec);
      __syncthreads();  // the staged rows (and the window table) are in
      if (stage && tid < T) {
        // the row's prefix in place, eight loads in flight at a time
        uint32_t* row = P + tid * plan.pstride;
        uint32_t acc = 0;
        row[0] = 0;
        int32_t j = 1;
        for (; j + 7 <= ns; j += 8) {
          uint32_t v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = row[j + u];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            acc += v[u];
            row[j + u] = acc;
          }
        }
        for (; j <= ns; ++j) {
          acc += row[j];
          row[j] = acc;
        }
        C[tid] = carry;
        carry += acc;
      }
      __syncthreads();  // the prefix rows and carries are in
      // the (T x Wn) outputs in row-major order: output i is row t,
      // window w
      int32_t t = tid / Wn, w = tid - t * Wn;
      if (nsegs == 1) {
        for (int32_t i = tid; i < total; i += 2 * kWcThreads) {
          uint32_t v[2];
          int32_t at[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            at[u] = -1;
            if (i + u * kWcThreads < total) {
              const int2 ab = AB[w];
              const uint32_t* pr = P + t * plan.pstride;
              v[u] = pr[ab.y] - pr[ab.x];
              if (V[w]) at[u] = t * W + w;
            }
            t += dt;
            w += dw;
            if (w >= Wn) {
              w -= Wn;
              ++t;
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (at[u] >= 0) dst[at[u]] = (int32_t)v[u];
        }
      } else {
        // position x lies in this segment when s0 <= x < s0 + ns, or it
        // is nl and this is the last one; P[x] = carry + row[x - s0]
        const int32_t s1 = s0 + ns;
        const bool last = sg == nsegs - 1;
        for (int32_t i = tid; i < total; i += kWcThreads) {
          const int2 ab = AB[w];
          const uint32_t* pr = P + t * plan.pstride;
          uint32_t v = sg == 0 ? 0u : O[i];
          if (ab.y >= s0 && (ab.y < s1 || last)) v += C[t] + pr[ab.y - s0];
          if (ab.x >= s0 && (ab.x < s1 || last)) v -= C[t] + pr[ab.x - s0];
          if (!last)
            O[i] = v;
          else if (V[w])
            dst[t * W + w] = (int32_t)v;
          t += dt;
          w += dw;
          if (w >= Wn) {
            w -= Wn;
            ++t;
          }
        }
      }
      __syncthreads();  // the segment's rows, the carries and the table are free
    }
  }
}

// Returns the first launch error (a W past 2^31 / kWcRows windows is
// refused).
inline int launch_window_counts(const int32_t* counts, int64_t rows, int32_t ring,
                                const int64_t* end_panes, const uint8_t* w_valid, int32_t W,
                                FireSource src, int32_t ppw, int32_t* out, cudaStream_t s) {
  if (ring < 1 || (int64_t)W * kWcRows >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || W <= 0) return (int)cudaGetLastError();
  WcPlan p = wc_plan(rows, ring, W);
  p.vec = ring % 4 == 0 && kWcThreads % (ring / 4) == 0 && ((uintptr_t)counts & 15) == 0;
  // the opt-in past 48 KB, once a device (each source has its own copy
  // of the kernel)
  static uint64_t opted = 0;
  if (p.smem_bytes > 48 * 1024) {
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess && (dev >= 64 || !((opted >> dev) & 1u))) {
      rc = cudaFuncSetAttribute(window_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                4 * kWcSmemWords);
      if (rc == cudaSuccess && dev < 64) opted |= 1ull << dev;
    }
    if (rc != cudaSuccess) return (int)rc;
  }
  window_counts_kernel<<<(unsigned)p.tiles, kWcThreads, p.smem_bytes, s>>>(
      counts, rows, ring, end_panes, w_valid, W, src, ppw, out, p);
  return (int)cudaGetLastError();
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
// cooperative launch, else five); against the key-sharded mode's gathered
// candidates (topn_select_given) the selection alone, each tile working
// out the windows' k-th itself, one launch. The fused step
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

// the selection against the gathered candidates (the same body; its own
// name in a profile)
__global__ void __launch_bounds__(kThreads) topn_given_kernel(const SelParams p) {
  select_tile<true, true, kSelItems>(p);
}

int g_topn_capacity[64];
const SelKernels kTopnKernels{topn_max_kernel,           topn_radix_kernel,
                              topn_radix_all_kernel,     topn_select_kernel<true>,
                              topn_select_kernel<false>, g_topn_capacity};
// the given mode takes the table form only (W <= kSelWinTable)
const SelKernels kTopnGivenKernels{nullptr, nullptr, nullptr, topn_given_kernel, nullptr,
                                   g_topn_capacity};

// One count-form selection into the emit ring: each window's top n
// against the whole-card threshold, or (``given`` non-null: the gathered
// (W, given_m) candidates, n their k) against each window's k-th of its
// candidates; ``work`` is the entry point's clean
// workspace, cut for Wc windows and Tc selection tiles
// (select_work_words). Returns the first launch error.
inline int launch_topn(const int32_t* wcounts, int64_t rows, int32_t W, const uint8_t* used,
                       const int64_t* end_panes, const uint8_t* w_valid, FireSource src,
                       int32_t n, const float* given, int32_t given_m, int32_t row_offset,
                       int32_t sel_cap, int32_t* ring, int32_t ring_rows, int32_t ring_cols,
                       int64_t* work, int64_t Wc, int64_t Tc, cudaStream_t s) {
  SelParams p{};
  p.wcounts = wcounts;
  p.rows = rows;
  p.W = W;
  p.k = given != nullptr ? n : (int32_t)(n < rows ? n : rows);
  p.sel_cap = sel_cap;
  p.row_cap = ring_rows - 2;
  p.ring_cols = ring_cols;
  p.row_offset = row_offset;
  p.used = used;
  p.end_panes = end_panes;
  p.w_valid = w_valid;
  p.src = src;
  p.given = given;
  p.given_m = given_m;
  p.ring = ring;
  return launch_select(p, work, Wc, Tc, given != nullptr ? kTopnGivenKernels : kTopnKernels, s);
}

// ---- K3 distributed mode (a key-sharded operator's top-n) -----------------
// The reference's topn_shard (flink_tpu/ops/window.py:1585-1626): each
// device block ranks its own rows, the blocks' top-k values per window are
// gathered, the global threshold is the k-th largest of them, and each
// block selects its rows against that global threshold and appends them,
// with their global row ids, to its own emit ring. Two steps:
//   (a) topn_candidates: the window's top k candidate values of this
//      device block, descending, each repeated as often as it occurs,
//      -inf past the candidates (lax.top_k's (W, k) output over the
//      -inf-masked values) — topn_select.cuh's whole-card threshold with
//      its own tails, launched from window_kernels.cu (cand_* kernels),
//      written into the block's columns of the gathered (W, M) buffer;
//   (b) K3's selection with the block's row offset against the gathered
//      candidates (launch_topn with ``given``: one launch), each tile
//      working out every window's k-th itself (kth_windows).
// topn_global_threshold_kernel is the global k-th alone (:1606-1610),
// kSelWinTable windows a block, a thread or a warp a window (kth_windows):
// the port's counterpart of that step, held to its plain version; no path
// launches it, since (b) folds it in. Bound: bytes — (a) reads the (rows
// x W) window counts and the used mask once, the rest is a few hundred
// bytes; (b) as K3, and the gathered candidates once a tile from L2.

__global__ void __launch_bounds__(kThreads) topn_global_threshold_kernel(
    const float* __restrict__ cand, int32_t W, int32_t M, int32_t k, float* __restrict__ thresh) {
  const int64_t x0 = (int64_t)blockIdx.x * kSelWinTable;
  const int32_t n = W - x0 < kSelWinTable ? (int32_t)(W - x0) : kSelWinTable;
  const float* rows = cand + x0 * M;
  float v[kKthRegs];
  kth_load(rows + (int64_t)threadIdx.x * M,
           (int32_t)threadIdx.x < n && M <= kKthRegs ? M : 0, v);
  kth_windows(rows, n, M, k, v, thresh + x0);
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
