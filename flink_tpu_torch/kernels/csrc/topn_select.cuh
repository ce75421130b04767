// The top-n selection of a fire over a row-major (rows x W) grid, shared
// by both forms of the reference's _ring_append_topn_core
// (flink_tpu/ops/window.py:547) + _topn_select_append (:456): the count
// form (window_fire.cuh K3: topn_select_append, the fused step's fire tail
// and topn_select_given, the key-sharded mode's select against a given
// threshold) and the lane form (topn_lanes_kernels.cu TB:
// topn_select_lanes). One body each; the form is a template flag
// (kCount) and the including source declares its own __global__ kernels,
// so the profiler names them apart. Include once, after
// window_common.cuh and lookback.cuh.
//
// Candidates: cells with count > 0 on a registered row of a valid window.
// They rank by a key: the count form's is the count as f32 (what
// count().finalize gives the reference, so counts past 2^24 tie as its
// f32 ranking does), the lane form's the ranking grid v. Per window, the
// threshold is the k-th largest key (k = min(n, rows)) in IEEE total
// order with ties counted, non-candidates keyed as -inf; a candidate at
// or above it (IEEE >=) is selected. Selected cells are compacted in
// row-major (row, window) order and appended to the emit ring as [row +
// row_offset, end_pane - anchor, count, result columns...].
//
// Bound: bytes — the (rows x W) counts (and ranking values) read once,
// the used mask, and the appended rows (3 + F words each).
//
// Design: every kernel reads the row-major grid in tiles over the whole
// card, neighbouring threads on neighbouring cells, every load of a
// thread in flight before the first test (a block a window would hold W
// of the 132 SMs and read one word of each row's W). A cell's key is its
// total-order key (total_key) with the sign bit flipped, so unsigned
// order is IEEE total order; a non-candidate's is -inf's (kNonCand).
//   k = 1   sel_max: a block's per-window maximum (a thread's cells all
//           of one window) in shared memory, then one 64-bit atomicMax a
//           window of (epoch, key) into the workspace: exact, in any
//           order, and an older call's value always loses.
//   k > 1   an MSB-first radix select on the keys, 8 bits a digit, four
//           passes. Pass p histograms, per window, digit p of the
//           candidates' keys whose higher digits equal the window's prefix
//           so far (shared-memory atomics, merged by global atomics); the
//           non-candidates are counted once (rows less the candidates) and
//           stand in -inf's bin while -inf matches the prefix. The last
//           block to finish a pass picks each window's digit and the count
//           still needed below it, a warp a window, and clears the bins.
//           After four passes the prefix is the k-th key. Where the grid's
//           blocks fit on the card at once, sel_radix_all runs the passes
//           and the selection in one cooperative launch (grid barriers
//           between passes, the keys kept in registers); else sel_radix
//           runs a launch a pass.
//   then    select_tile: the selection and the append in the same launch,
//           each tile's place from lookback.cuh's look-back (a descriptor
//           a 128-byte line); the grid's last tile updates the ring's head
//           and advances the epoch.
//   given   (topn_select_given) select_tile alone against the key-sharded
//           mode's gathered candidates, (W, M) f32: each tile works out a
//           window's threshold itself, the k-th of its M candidates
//           (kth_windows: a thread or a warp a window, into the block's
//           table), so no launch computes it first; W <= kSelWinTable.
//           One launch. Each tile reads the ring's head itself before it
//           publishes its count, so the last tile's new head (written
//           after its look-back) comes after every read.
// Launches a call: 2 at k = 1; above, 1 (cooperative) or 5; 1 given. A
// small grid takes the same kernels with few blocks.
//   The rules are the plain versions': a -NaN candidate at the k-th place
// gives a NaN threshold (nothing selected), as lax.top_k over the masked
// grid does; a window with fewer candidates than k gets -inf.
//   A FireSource gates the kernels and gives the anchor: the fused step's
// skip every write (nothing appended, the epoch not advanced) when its
// fire word is 0, and read the anchor from its parameter block.
//   The workspace (window_kernels.py clean_workspace, one per entry point
// and stream; its layout by the capacities it was allocated for,
// select_work_words) holds the ring's old head, the radix passes' done
// counter, the epoch, the grid barrier's words, each window's tagged
// threshold, radix prefix, count still needed, non-candidate count and
// bins, and a descriptor a selection tile.
#pragma once

#include "lookback.cuh"
#include "window_common.cuh"

namespace {

constexpr int kThrItems = 8;                     // cells a thread, threshold passes
constexpr int kThrCells = kThreads * kThrItems;  // cells a threshold block
constexpr int kSelItems = 4;                     // cells a thread, select kernels
constexpr int kSelCells = kThreads * kSelItems;  // cells a selection tile (8 a thread
                                                 // measured slower: 0.0078 against 0.0067 ms)
constexpr int kSelWinTable = 64;                 // windows of a block's table
constexpr int kRadixWindows = 32;                // windows a radix block histograms
static_assert(kSelWinTable <= kThreads, "a table entry a thread");

struct SelParams {
  const int32_t* wcounts;
  const float* v;       // the lane form's ranking grid (the count form: null)
  const int32_t* cols;  // (rows, W, F) result columns
  int32_t F;
  int64_t rows;
  int32_t W, k, sel_cap, row_cap, ring_cols, row_offset;
  const uint8_t* used;
  const int64_t* end_panes;
  const uint8_t* w_valid;
  FireSource src;       // the gate and the anchor
  // topn_select_given: the gathered candidates, (W, given_m) f32, whose
  // k-th a window is its threshold (else null)
  const float* given;
  int32_t given_m;
  int32_t* ring;        // the emit ring (topn_candidates: null)
  // topn_candidates: the (W, k) output, row w at cand_out + w * cand_ld
  // (a block's columns of a gathered buffer), and at k > 1 the (W, k)
  // list of each window's keys above its k-th (null otherwise)
  float* cand_out;
  int64_t cand_ld;
  uint32_t* cand_list;
  // the workspace
  long long* old_total;  // null in the given mode and for topn_candidates
  unsigned int* done;
  uint32_t* epoch;
  unsigned long long* thresh;  // (epoch << 32) | key, a window
  uint32_t* prefix;
  uint32_t* need;
  uint32_t* noncand;
  uint32_t* hist;     // 256 a window
  unsigned int* bar;  // the grid barrier's count and generation
  unsigned long long* desc;
  int64_t tiles;
};

// int32 key whose integer order is IEEE total order on f32
__device__ __forceinline__ int32_t total_key(float x) {
  const int32_t b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float from_total_key(int32_t k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// the unsigned key of -inf, every non-candidate's
constexpr uint32_t kNonCand = 0x007FFFFFu;  // total_key(-inf) ^ 0x80000000

// an unsigned key (the workspace's threshold's low word) as the f32 it ranks
__device__ __forceinline__ float key_value(uint32_t key) {
  return from_total_key((int32_t)(key ^ 0x80000000u));
}

__device__ __forceinline__ float thresh_value(unsigned long long t) {
  return key_value((uint32_t)t);
}

// The k-th largest of a window's M gathered candidates, ties counted, -inf
// when fewer than k are finite: the global threshold of the key-sharded
// top-n (the reference's lax.top_k(all_top, k)[0][:, k - 1]; counts as
// f32 or -inf: no NaN, no +inf). The rule is the one-block kernel's it
// replaces: round by round, the maximum below the value found last (the
// first round: the maximum) and the count of values equal to it, a round
// a distinct value, at most k; at k = 1 the maximum alone. Two forms:
//   M <= kKthRegs (M1's 4 blocks up to top-4): a thread a window, its
//   candidates in registers, loaded with the caller's other loads
//   (kth_load), so the k-th waits on L2 once and on no other thread;
//   M > kKthRegs: a warp a window (warp_kth), with shuffles.
// kth_windows runs the one a block's windows need.
constexpr int kKthRegs = 16;

// v[i] = row[i] for i < M, -inf past it (M = 0: no load)
__device__ __forceinline__ void kth_load(const float* __restrict__ row, int32_t M,
                                         float (&v)[kKthRegs]) {
#pragma unroll
  for (int i = 0; i < kKthRegs; ++i) v[i] = i < M ? row[i] : -INFINITY;
}

__device__ __forceinline__ float kth_regs(const float (&v)[kKthRegs], int32_t M, int32_t k) {
  float ceiling = INFINITY;
  for (int32_t need = k;;) {
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKthRegs; ++i)
      if (i < M && v[i] < ceiling) m = fmaxf(m, v[i]);
    if (m == -INFINITY || need == 1) return m;
    int32_t c = 0;
#pragma unroll
    for (int i = 0; i < kKthRegs; ++i) c += i < M && v[i] == m;
    need -= c;
    if (need <= 0) return m;
    ceiling = m;
  }
}

// every lane of a warp calling: the k-th of row[0, M), lane l taking
// row[l], row[l + 32], ... a round
__device__ __forceinline__ float warp_kth(const float* __restrict__ row, int32_t M, int32_t k) {
  const int lane = threadIdx.x & 31;
  float ceiling = INFINITY;
  for (int32_t need = k;;) {
    float m = -INFINITY;
    for (int32_t i = lane; i < M; i += 32) {
      const float v = row[i];
      if (v < ceiling) m = fmaxf(m, v);
    }
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (m == -INFINITY || need == 1) return m;
    int32_t c = 0;
    for (int32_t i = lane; i < M; i += 32) c += row[i] == m;
    need -= __reduce_add_sync(0xffffffffu, c);
    if (need <= 0) return m;
    ceiling = m;
  }
}

// out[x] = the k-th of given[x * M, (x + 1) * M) for x < W <= kSelWinTable,
// by the whole block (no barrier: the caller's comes before out is read);
// v: kth_load(given + threadIdx.x * M, threadIdx.x < W ? M : 0) where M <=
// kKthRegs (unused above)
__device__ __forceinline__ void kth_windows(const float* __restrict__ given, int32_t W, int32_t M,
                                            int32_t k, const float (&v)[kKthRegs], float* out) {
  if (M <= kKthRegs) {
    if ((int32_t)threadIdx.x < W) out[threadIdx.x] = kth_regs(v, M, k);
    return;
  }
  for (int32_t x = threadIdx.x >> 5; x < W; x += kWarps) {  // the whole warp
    const float t = warp_kth(given + (int64_t)x * M, M, k);
    if ((threadIdx.x & 31) == 0) out[x] = t;
  }
}

// The lane form's gathered k-th (topn_select_lanes_given): the same rule
// on the candidates' unsigned total-order keys, so -NaN < -inf < -0 < +0
// < +inf < +NaN rank as lax.top_k ranks them (the count form's f32
// comparisons would tie -0 with +0 and lose a NaN). Every gathered
// candidate is a value (its padding -inf), so k <= M values always hold
// the k-th: no early end.
__device__ __forceinline__ uint32_t ukey(float x) {
  return (uint32_t)total_key(x) ^ 0x80000000u;
}

__device__ __forceinline__ uint32_t kth_regs_key(const float (&v)[kKthRegs], int32_t M,
                                                 int32_t k) {
  bool top = true;
  uint32_t ceiling = 0;
  for (int32_t need = k;;) {
    uint32_t m = 0;
    bool any = false;
#pragma unroll
    for (int i = 0; i < kKthRegs; ++i) {
      const uint32_t x = ukey(v[i]);
      if (i < M && (top || x < ceiling) && (!any || x > m)) {
        m = x;
        any = true;
      }
    }
    if (!any || need == 1) return m;
    int32_t c = 0;
#pragma unroll
    for (int i = 0; i < kKthRegs; ++i) c += i < M && ukey(v[i]) == m;
    need -= c;
    if (need <= 0) return m;
    ceiling = m;
    top = false;
  }
}

__device__ __forceinline__ uint32_t warp_kth_key(const float* __restrict__ row, int32_t M,
                                                 int32_t k) {
  const int lane = threadIdx.x & 31;
  bool top = true;
  uint32_t ceiling = 0;
  for (int32_t need = k;;) {
    // the maximum key below the ceiling (a lane that finds none adds 0,
    // which no found key is below)
    uint32_t m = 0;
    bool any = false;
    for (int32_t i = lane; i < M; i += 32) {
      const uint32_t x = ukey(row[i]);
      if ((top || x < ceiling) && (!any || x > m)) {
        m = x;
        any = true;
      }
    }
    if (!__any_sync(0xffffffffu, any)) return 0;
    m = __reduce_max_sync(0xffffffffu, m);
    if (need == 1) return m;
    int32_t c = 0;
    for (int32_t i = lane; i < M; i += 32) c += ukey(row[i]) == m;
    need -= __reduce_add_sync(0xffffffffu, c);
    if (need <= 0) return m;
    ceiling = m;
    top = false;
  }
}

__device__ __forceinline__ void kth_windows_key(const float* __restrict__ given, int32_t W,
                                                int32_t M, int32_t k,
                                                const float (&v)[kKthRegs], float* out) {
  if (M <= kKthRegs) {
    if ((int32_t)threadIdx.x < W) out[threadIdx.x] = key_value(kth_regs_key(v, M, k));
    return;
  }
  for (int32_t x = threadIdx.x >> 5; x < W; x += kWarps) {  // the whole warp
    const uint32_t t = warp_kth_key(given + (int64_t)x * M, M, k);
    if ((threadIdx.x & 31) == 0) out[x] = key_value(t);
  }
}

// a threshold block's cells: thread t takes cells a + t + kThreads * j,
// so each load of the block reads consecutive words; (r, w) of each
// step follow without a division
struct GridWalk {
  int64_t i, r;
  int32_t w, dr, dw, W;
  __device__ __forceinline__ GridWalk(int64_t i0, int32_t W_) : i(i0), W(W_) {
    r = i0 / W_;
    w = (int32_t)(i0 - r * W_);
    dr = kThreads / W_;
    dw = kThreads % W_;
  }
  __device__ __forceinline__ void next() {
    i += kThreads;
    r += dr;
    w += dw;
    if (w >= W) {
      w -= W;
      ++r;
    }
  }
};

// a threshold block's cells of windows [g0, g0 + gw): win = the window
// less g0 (-1: a cell outside them or the grid), cand = a candidate, key
// its unsigned key; every load in flight before the first test
template <bool kCount>
__device__ __forceinline__ void walk_keys(const SelParams& p, int32_t g0, int32_t gw,
                                          uint32_t (&key)[kThrItems], int32_t (&win)[kThrItems],
                                          bool (&cand)[kThrItems]) {
  const int64_t K = p.rows * (int64_t)p.W;
  GridWalk g((int64_t)blockIdx.x * kThrCells + threadIdx.x, p.W);
  int32_t wc[kThrItems];
  float v[kThrItems];
  uint8_t used[kThrItems], valid[kThrItems];
#pragma unroll
  for (int j = 0; j < kThrItems; ++j) {
    const int32_t wl = g.w - g0;
    win[j] = g.i < K && wl >= 0 && wl < gw ? wl : -1;
    wc[j] = 0;
    v[j] = 0.0f;
    used[j] = valid[j] = 0;
    if (win[j] >= 0) {
      wc[j] = p.wcounts[g.i];
      if (!kCount) v[j] = p.v[g.i];
      used[j] = p.used[g.r];
      valid[j] = p.w_valid[g.w];
    }
    g.next();
  }
#pragma unroll
  for (int j = 0; j < kThrItems; ++j) {
    cand[j] = win[j] >= 0 && wc[j] > 0 && valid[j] && used[j];
    key[j] = (uint32_t)total_key(kCount ? (float)wc[j] : v[j]) ^ 0x80000000u;
  }
}

// k = 1: each block's per-window maxima into the tagged thresholds (a
// non-candidate keyed as -inf), then one 64-bit atomicMax a window of the
// block's. Where W <= kThreads a block's cells are max_span(W) x kThrItems
// consecutive ones and thread t < max_span(W) takes cells t, t + span,
// ... (span a multiple of W), all of one window: its maximum stays in a
// register, neighbouring threads still read neighbouring cells, and a
// warp's lanes of one window (l, l + W, ...) fold by shuffles where W <=
// 32, so a block makes a few shared atomics, not one a cell (a cell each,
// on W words, measured 0.0035 ms a call at 32,769 x 11). A window none of
// whose cells the block holds adds its epoch's tag with the lowest key,
// which no cell's key is below.
__host__ __device__ __forceinline__ int32_t max_span(int32_t W) {
  return W <= kThreads ? kThreads / W * W : kThreads;
}

// a block's cells in max_span's layout (kN a thread; block b starts at
// cell b * span * kN): each one's window (-1 outside the grid) and its
// unsigned key (a non-candidate's kNonCand, 0 outside the grid), every
// load in flight before the first test
template <bool kCount, int kN>
__device__ __forceinline__ void span_keys(const SelParams& p, uint32_t (&key)[kN],
                                          int32_t (&win)[kN]) {
  const int32_t W = p.W, span = max_span(W);
  const int64_t K = p.rows * (int64_t)W;
  const int64_t i0 = (int64_t)blockIdx.x * span * kN + threadIdx.x;
  const int64_t r0 = i0 / W;
  const int32_t w0 = (int32_t)(i0 - r0 * W);
  const int32_t dr = span / W;  // rows a step (W <= kThreads)
  int32_t wc[kN];
  float v[kN];
  uint8_t used[kN], valid[kN];
  {
    int64_t i = i0, r = r0;
    int32_t w = w0;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const bool in = (int32_t)threadIdx.x < span && i < K;
      win[j] = in ? w : -1;
      wc[j] = in ? p.wcounts[i] : 0;
      v[j] = in && !kCount ? p.v[i] : 0.0f;
      used[j] = in ? p.used[r] : 0;
      valid[j] = in ? p.w_valid[w] : 0;
      i += span;
      if (W <= kThreads) {
        r += dr;
      } else {
        r = i / W;
        w = (int32_t)(i - r * W);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j)
    key[j] = win[j] < 0 ? 0u
             : wc[j] > 0 && valid[j] && used[j]
                 ? (uint32_t)total_key(kCount ? (float)wc[j] : v[j]) ^ 0x80000000u
                 : kNonCand;
}

template <bool kCount, int kN = kThrItems>
__device__ __forceinline__ void sel_max(const SelParams& p) {
  __shared__ uint32_t s_max[kSelWinTable];
  __shared__ uint32_t s_epoch;
  const bool skip = p.src.skip();  // in flight with the grid's loads
  const int32_t W = p.W;
  const bool table = W <= kSelWinTable;
  uint32_t key[kN];
  int32_t win[kN];
  span_keys<kCount, kN>(p, key, win);
  if (skip) return;
  if (table)
    for (int32_t w = threadIdx.x; w < W; w += kThreads) s_max[w] = 0;
  if (threadIdx.x == 0) {
    s_epoch = __ldcg(p.epoch);
    if (blockIdx.x == 0 && p.old_total != nullptr) *p.old_total = p.ring[0];
  }
  __syncthreads();
  const unsigned long long tag = (unsigned long long)s_epoch << 32;
  if (W <= kThreads) {
    // one window a thread: its maximum, then the block's
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < kN; ++j) m = max(m, key[j]);
    const int lane = threadIdx.x & 31;
    if (W <= 32) {
      for (int32_t d = W; d < 32; d <<= 1) {
        const uint32_t o = __shfl_down_sync(0xffffffffu, m, d);
        if (lane + d < 32) m = max(m, o);
      }
      if (lane < W && m) atomicMax(&s_max[win[0]], m);
    } else if (m && table) {
      atomicMax(&s_max[win[0]], m);
    } else if (m) {
      atomicMax(&p.thresh[win[0]], tag | m);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (win[j] >= 0) atomicMax(&p.thresh[win[j]], tag | key[j]);
  }
  __syncthreads();
  if (table)
    for (int32_t w = threadIdx.x; w < W; w += kThreads) atomicMax(&p.thresh[w], tag | s_max[w]);
}

// A radix pick for one window, a warp: pass ``pass``'s bins h (lane l
// holds bins 255 - 8l down to 248 - 8l), the prefix so far, the count
// still needed and (past pass 0) the window's non-candidate count. The
// non-candidates stand in -inf's bin while -inf matches the prefix (pass
// 0 counts them: the rows less the candidates); the lane whose bins hold
// the key still needed walks them. Every lane gets the new prefix, the
// count still needed below it and the non-candidate count.
struct RadixPick {
  uint32_t prefix, need, noncand;
};

__device__ __forceinline__ RadixPick radix_pick(const uint32_t* h, int pass, uint32_t pre,
                                                uint32_t need, uint32_t nc, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int shift = 24 - 8 * pass;
  const uint32_t above = pass ? 0xFFFFFFFFu << (shift + 8) : 0u;
  uint32_t b[8];
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    b[i] = __ldcg(h + 255 - 8 * lane - i);
    sum += b[i];
  }
  if (pass == 0) {
    uint32_t cands = sum;
    for (int o = 16; o > 0; o >>= 1) cands += __shfl_xor_sync(0xffffffffu, cands, o);
    nc = (uint32_t)(rows - cands);
  }
  if ((kNonCand & above) == (pre & above)) {
    const int at = 255 - (int)((kNonCand >> shift) & 255);  // 8 lane + i
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (8 * lane + i == at) {
        b[i] += nc;
        sum += nc;
      }
  }
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  const uint32_t higher = incl - sum;  // keys in the higher bins
  const bool mine = higher < need && need <= incl;
  const unsigned who = __ballot_sync(0xffffffffu, mine);
  uint32_t digit = 0, left = need;
  if (mine) {
    uint32_t c = higher;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c + b[i] >= need) {
        digit = 255 - 8 * lane - i;
        left = need - c;
        break;
      }
      c += b[i];
    }
  }
  const int src = who ? __ffs(who) - 1 : 0;
  RadixPick r;
  r.prefix = pre | (__shfl_sync(0xffffffffu, digit, src) << shift);
  r.need = __shfl_sync(0xffffffffu, left, src);
  r.noncand = nc;
  return r;
}

// a block's histogram of pass ``pass`` over its cells (windows [g0, g0 +
// gw), pre: their prefixes in shared memory), merged into h
__device__ __forceinline__ void radix_histogram(uint32_t* s_hist, const uint32_t* s_pre,
                                                const uint32_t (&key)[kThrItems],
                                                const int32_t (&win)[kThrItems],
                                                const bool (&cand)[kThrItems], int pass,
                                                int32_t gw, uint32_t* h) {
  const int shift = 24 - 8 * pass;
  // the digits above this pass's must equal the window's prefix
  const uint32_t above = pass ? 0xFFFFFFFFu << (shift + 8) : 0u;
  for (int32_t e = threadIdx.x; e < gw * 256; e += kThreads) s_hist[e] = 0;
  __syncthreads();
  // (a warp's atomics on one bin merged by __match_any_sync measured
  // slower: 2.3 against 1.1 us a pass at job T's top-3)
#pragma unroll
  for (int j = 0; j < kThrItems; ++j)
    if (cand[j] && (key[j] & above) == (s_pre[win[j]] & above))
      atomicAdd(&s_hist[win[j] * 256 + ((key[j] >> shift) & 255)], 1u);
  __syncthreads();
  for (int32_t e = threadIdx.x; e < gw * 256; e += kThreads)
    if (s_hist[e]) atomicAdd(&h[e], s_hist[e]);
}

// the last radix block's picks of pass ``pass`` for every window, a warp
// a window: into the workspace's prefix, need and non-candidate count
// (the thresholds after pass 3; topn_candidates then takes the
// non-candidate count, no longer needed, as its collect count from 0);
// each window's bins cleared
__device__ __forceinline__ void radix_pick_all(const SelParams& p, int pass, uint32_t epoch) {
  const unsigned long long tag = (unsigned long long)epoch << 32;
  for (int32_t w = threadIdx.x >> 5; w < p.W; w += kWarps) {
    uint32_t* h = p.hist + (int64_t)w * 256;
    const RadixPick r = radix_pick(h, pass, pass ? __ldcg(p.prefix + w) : 0u,
                                   pass ? __ldcg(p.need + w) : (uint32_t)p.k,
                                   pass ? __ldcg(p.noncand + w) : 0u, p.rows);
    for (int i = threadIdx.x & 31; i < 256; i += 32) h[i] = 0;
    if ((threadIdx.x & 31) == 0) {
      p.prefix[w] = r.prefix;
      p.need[w] = r.need;
      p.noncand[w] = pass == 3 && p.cand_out != nullptr ? 0u : r.noncand;
      if (pass == 3) p.thresh[w] = tag | r.prefix;
    }
  }
}

// k > 1 otherwise: one launch a pass (windows in groups of
// kRadixWindows on the grid's y), the bins H_0 only; the last block to
// finish picks every window's digit into the workspace and clears the
// bins.
template <bool kCount>
__device__ __forceinline__ void sel_radix(const SelParams& p, int pass) {
  __shared__ uint32_t s_hist[kRadixWindows * 256];
  __shared__ uint32_t s_pre[kRadixWindows];
  __shared__ uint32_t s_epoch;
  __shared__ int s_flag;
  const bool skip = p.src.skip();
  const int32_t W = p.W, g0 = blockIdx.y * kRadixWindows;
  const int32_t gw = W - g0 < kRadixWindows ? W - g0 : kRadixWindows;
  // the prefixes and the epoch in flight with the grid's loads
  const uint32_t pre = pass && (int32_t)threadIdx.x < gw ? p.prefix[g0 + threadIdx.x] : 0u;
  const uint32_t epoch = threadIdx.x == 0 ? __ldcg(p.epoch) : 0u;
  uint32_t key[kThrItems];
  int32_t win[kThrItems];
  bool cand[kThrItems];
  walk_keys<kCount>(p, g0, gw, key, win, cand);
  if (skip) return;
  if ((int32_t)threadIdx.x < gw) s_pre[threadIdx.x] = pre;
  if (threadIdx.x == 0) {
    s_epoch = epoch;
    if (pass == 0 && blockIdx.x == 0 && blockIdx.y == 0 && p.old_total != nullptr)
      *p.old_total = p.ring[0];
  }
  radix_histogram(s_hist, s_pre, key, win, cand, pass, gw, p.hist + (int64_t)g0 * 256);
  if (last_block(p.done, gridDim.x * gridDim.y, &s_flag)) radix_pick_all(p, pass, s_epoch);
}

// One selection tile (kItems consecutive cells a thread, tile =
// blockIdx.x): the test against the thresholds (the workspace's, or the
// given ones), the rank in the tile, the place among all p.tiles tiles by
// the look-back, the appended rows; the grid's last tile updates the
// ring's head and advances the epoch. Everything a row needs besides its
// place (the ring's head, the anchor, the window ends where W <=
// kSelWinTable, the cell's count) is read before the look-back, in
// flight with the tile's loads. kTable: W <= kSelWinTable, the thresholds
// and ends in a block table (a run-time choice let the compiler load both
// sides); the given mode's thresholds, each window's k-th of its gathered
// candidates, are worked out into that table (kth_windows), and it takes
// the table form only (launch_select refuses it past kSelWinTable).
// kGivenLanes: the lane form's given mode (topn_select_lanes_given), its
// k-th by total-order keys (kth_windows_key); the lane form's other
// kernels leave it off, so they carry no gathered loads.
template <bool kCount, bool kTable, int kItems, bool kGivenLanes = false>
__device__ __forceinline__ void select_tile(const SelParams& p) {
  __shared__ float s_thr[kSelWinTable];
  __shared__ int64_t s_end[kSelWinTable];
  __shared__ int s_scan[kWarps];
  __shared__ int s_total, s_min[kWarps];
  __shared__ long long s_sum[kWarps], s_head;
  __shared__ int64_t s_anchor;
  __shared__ uint32_t s_epoch;
  const int32_t W = p.W;
  const int64_t tile = blockIdx.x, K = p.rows * (int64_t)W;
  const int64_t first = (tile * kThreads + threadIdx.x) * kItems;
  const int64_t r0 = first / W;
  const int32_t w0 = (int32_t)(first - r0 * W);
  const bool skip = p.src.skip();
  // the given mode (table only): window threadIdx.x's gathered
  // candidates, in flight with the grid's loads
  const bool given = (kCount || kGivenLanes) && kTable && p.given != nullptr;
  float kv[kKthRegs];
  kth_load(p.given + (int64_t)threadIdx.x * p.given_m,
           given && (int32_t)threadIdx.x < W && p.given_m <= kKthRegs ? p.given_m : 0, kv);
  // every load in flight before the first test
  int32_t wc[kItems];
  uint32_t sel = 0;
  {
    float v[kItems];
    uint8_t used[kItems], valid[kItems];
    int64_t r = r0;
    int32_t w = w0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = first + j;
      wc[j] = 0;
      v[j] = 0.0f;
      used[j] = valid[j] = 0;
      if (i < K) {
        wc[j] = p.wcounts[i];
        if (!kCount) v[j] = p.v[i];
        used[j] = p.used[r];
        valid[j] = p.w_valid[w];
      }
      if (++w == W) {
        w = 0;
        ++r;
      }
    }
    if (skip) return;
    // the table's entries (thread x its window x) and thread 0's scalars:
    // every load issued before the first store, so that they wait on L2
    // once (the epoch and the head were written by an earlier launch; in
    // the given mode the head by none before this tile's count is out)
    const bool tx = kTable && (int32_t)threadIdx.x < W;
    const int64_t end_x = tx ? p.end_panes[threadIdx.x] : 0;
    const float thr_x = tx && !given ? thresh_value(__ldcg(p.thresh + threadIdx.x)) : 0.0f;
    uint32_t epoch = 0;
    long long head = 0;
    int64_t anchor = 0;
    if (threadIdx.x == 0) {
      epoch = __ldcg(p.epoch);
      head = p.old_total != nullptr ? __ldcg(p.old_total) : __ldcg(p.ring);
      anchor = p.src.get().anchor;
    }
    if (tx) {
      s_end[threadIdx.x] = end_x;
      if (!given) s_thr[threadIdx.x] = thr_x;
    }
    // the given mode: each window's k-th of its gathered candidates
    if (given) {
      if (kCount)
        kth_windows(p.given, W, p.given_m, p.k, kv, s_thr);
      else
        kth_windows_key(p.given, W, p.given_m, p.k, kv, s_thr);
    }
    if (threadIdx.x == 0) {
      s_epoch = epoch;
      s_head = head;
      s_anchor = anchor;
    }
    __syncthreads();
    w = w0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const float t = kTable ? s_thr[w] : thresh_value(__ldcg(p.thresh + w));
      if (wc[j] > 0 && valid[j] && used[j] && (kCount ? (float)wc[j] : v[j]) >= t)
        sel |= 1u << j;
      if (++w == W) w = 0;
    }
  }
  const uint32_t epoch = s_epoch;
  const long long total = s_head;
  const int before = block_scan_total(__popc(sel), s_scan, &s_total);
  const int tile_n = s_total;
  // the given mode: this tile's read of the head is done before any tile
  // can see its count (and so before the last tile writes the head)
  if (p.old_total == nullptr && threadIdx.x == 0) __threadfence();
  lb_publish<kLbLine>(p.desc, tile, tile_n, epoch);
  const long long excl = lookback_exclusive<kLbLine>(p.desc, tile, tile_n, epoch, s_sum, s_min);
  if (tile == p.tiles - 1 && threadIdx.x == 0) {
    const long long all = excl + tile_n;
    const long long written = all < p.sel_cap ? all : p.sel_cap;
    __threadfence();  // every tile's read of the head, seen through its count, comes first
    p.ring[0] = (int32_t)(total + written);
    p.ring[1] += (int32_t)(all - written);
    lb_advance(p.epoch, epoch);
  }
  if (sel) {
    const int64_t anchor = s_anchor;
    long long pos = excl + before;
    int64_t r = r0;
    int32_t w = w0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (((sel >> j) & 1) && pos < p.sel_cap) {
        int32_t* dst = p.ring + ((total + pos) % p.row_cap + 1) * p.ring_cols;
        dst[0] = (int32_t)r + p.row_offset;
        dst[1] = (int32_t)((kTable ? s_end[w] : p.end_panes[w]) - anchor);
        dst[2] = wc[j];
        const int64_t i = first + j;
        for (int32_t f = 0; f < p.F; ++f) dst[3 + f] = p.cols[i * p.F + f];
      }
      pos += (sel >> j) & 1;
      if (++w == W) {
        w = 0;
        ++r;
      }
    }
  }
}

// A barrier of the whole (cooperative) grid: every block arrives, the
// last arrival runs on_last() with what every block wrote before it
// visible, then releases the others (bar: the count and the generation,
// left as it found them but the generation).
template <typename F>
__device__ __forceinline__ void grid_barrier(unsigned int* bar, int* s_flag, F on_last) {
  unsigned int* count = bar;
  unsigned int* gen = bar + 1;
  __syncthreads();
  unsigned int g = 0;
  if (threadIdx.x == 0) {
    g = *(volatile unsigned int*)gen;
    __threadfence();
    *s_flag = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (*s_flag) {
    __threadfence();
    on_last();
    __syncthreads();
    if (threadIdx.x == 0) {
      *(volatile unsigned int*)count = 0;
      __threadfence();
      atomicAdd(gen, 1u);
    }
  } else if (threadIdx.x == 0) {
    while (*(volatile unsigned int*)gen == g) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// k > 1, when the threshold blocks fit on the card at once (a
// cooperative launch) and W <= kRadixWindows: the four passes and the
// selection in one launch. Each block loads its cells once and keeps their
// keys in registers. After each pass's histogram the blocks meet at a
// grid barrier whose last arrival picks every window's digit (as the last
// block of sel_radix does) before it releases the others, who then read
// the windows' new prefixes; after the last, every block selects its own
// cells (select_tile, a tile of kThrCells). The four passes alone took
// 0.0263 ms at job T's top-3 on the H100; two other forms measured slower
// there: every block picking from the merged bins itself (0.0369 ms: the
// bins' lines hot in L2, 3-5 us a pick), and a launch a pass (sel_radix,
// kept for the grids that do not fit: 0.0324-0.0355 ms). PERF.md §6 has
// the figures.
template <bool kCount>
__device__ __forceinline__ void sel_radix_all(const SelParams& p) {
  __shared__ uint32_t s_hist[kRadixWindows * 256];
  __shared__ uint32_t s_pre[kRadixWindows];
  __shared__ uint32_t s_epoch;
  __shared__ int s_flag;
  const bool skip = p.src.skip();
  const int32_t W = p.W;
  uint32_t key[kThrItems];
  int32_t win[kThrItems];
  bool cand[kThrItems];
  walk_keys<kCount>(p, 0, W, key, win, cand);
  if (skip) return;  // every block of the grid: no barrier is met
  for (int32_t w = threadIdx.x; w < W; w += kThreads) s_pre[w] = 0;
  if (threadIdx.x == 0) {
    s_epoch = __ldcg(p.epoch);
    if (blockIdx.x == 0) *p.old_total = p.ring[0];
  }
  for (int pass = 0; pass < 4; ++pass) {
    radix_histogram(s_hist, s_pre, key, win, cand, pass, W, p.hist);
    grid_barrier(p.bar, &s_flag, [&] { radix_pick_all(p, pass, s_epoch); });
    if (pass < 3)
      for (int32_t w = threadIdx.x; w < W; w += kThreads) s_pre[w] = __ldcg(p.prefix + w);
  }
  select_tile<kCount, true, kThrItems>(p);
}

// The kernels of one form, each a __global__ wrapper of the bodies above
// declared by the including source, and the cooperative kernel's
// capacity (blocks the card holds at once), cached a device.
struct SelKernels {
  void (*max)(const SelParams);
  void (*radix)(const SelParams, int);
  void (*radix_all)(const SelParams);
  void (*select_table)(const SelParams);
  void (*select_wide)(const SelParams);
  int* capacity;  // 64 devices
};

// the workspace's int64 words for Wc windows and Tc selection tiles: the
// ring's old head; the done counter and the epoch; the grid barrier's two
// words; a tagged threshold a window; each window's prefix, count still
// needed, non-candidate count and 256 bins (32-bit words); then, from a
// 128-byte boundary, a descriptor a tile, each on its own 128-byte line
// (window_kernels.py select_work_words)
inline int64_t select_desc_word(int64_t Wc) {
  return (3 + Wc + (Wc * (3 + 256) + 1) / 2 + kLbLine - 1) / kLbLine * kLbLine;
}

inline int64_t select_work_words(int64_t Wc, int64_t Tc) {
  return select_desc_word(Wc) + kLbLine * Tc;
}

// the blocks of a cooperative kernel the card holds at once, cached a
// device in capacity[64]
inline int coop_capacity(const void* kernel, int* capacity) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!capacity[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    capacity[dev] = per_sm * sms;
  }
  return capacity[dev];
}

inline int radix_all_capacity(const SelKernels& k) {
  return coop_capacity((const void*)k.radix_all, k.capacity);
}

// the workspace (select_work_words(Wc, Tc) int64 words) bound into p
inline void bind_select_work(SelParams& p, int64_t* work, int64_t Wc) {
  p.old_total = (long long*)work;
  p.done = (unsigned int*)(work + 1);
  p.epoch = (uint32_t*)(work + 1) + 1;
  p.bar = (unsigned int*)(work + 2);
  p.thresh = (unsigned long long*)(work + 3);
  p.prefix = (uint32_t*)(work + 3 + Wc);
  p.need = p.prefix + Wc;
  p.noncand = p.need + Wc;
  p.hist = p.noncand + Wc;
  p.desc = (unsigned long long*)(work + select_desc_word(Wc));
}

// One selection: binds the workspace (select_work_words(Wc, Tc) int64
// words, zeroed when allocated) into p and launches the form's kernels
// (the selection alone where p.given is set); returns the first launch
// error. p's grid, fire and ring fields are set by the caller.
inline int launch_select(SelParams p, int64_t* work, int64_t Wc, int64_t Tc,
                         const SelKernels& k, cudaStream_t s) {
  const int64_t K = p.rows * (int64_t)p.W;
  if (K <= 0 || p.W <= 0 || p.k <= 0) return (int)cudaGetLastError();
  const int64_t tiles = (K + kSelCells - 1) / kSelCells;
  const int64_t blocks = (K + kThrCells - 1) / kThrCells;
  const int64_t groups = (p.W + kRadixWindows - 1) / kRadixWindows;
  if (p.rows >= (1ll << 32) || tiles >= (1ll << 31) || blocks >= (1ll << 31) ||
      groups > 65535 || p.row_cap < 1 || Wc < p.W || Tc < tiles || work == nullptr ||
      (p.given != nullptr && (p.W > kSelWinTable || p.k > p.given_m)))
    return (int)cudaErrorInvalidValue;
  bind_select_work(p, work, Wc);
  p.tiles = tiles;
  if (p.given != nullptr) {
    p.old_total = nullptr;  // each tile reads the head
  } else if (p.k > 1 && p.W <= kRadixWindows && blocks <= radix_all_capacity(k)) {
    p.tiles = blocks;  // it selects a threshold block's cells a tile
    void* args[] = {(void*)&p};
    return (int)cudaLaunchCooperativeKernel((const void*)k.radix_all, dim3((unsigned)blocks),
                                            dim3(kThreads), args, 0, s);
  } else if (p.k == 1) {
    const int64_t span_cells = (int64_t)max_span(p.W) * kThrItems;
    k.max<<<(unsigned)((K + span_cells - 1) / span_cells), kThreads, 0, s>>>(p);
  } else {
    for (int pass = 0; pass < 4; ++pass) {
      k.radix<<<dim3((unsigned)blocks, (unsigned)groups), kThreads, 0, s>>>(p, pass);
      const int rc = (int)cudaGetLastError();
      if (rc) return rc;
    }
  }
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  if (p.W <= kSelWinTable)
    k.select_table<<<(unsigned)tiles, kThreads, 0, s>>>(p);
  else
    k.select_wide<<<(unsigned)tiles, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// ---- topn_candidates: a block's top k a window -----------------------------
// The key-sharded top-n's candidates (flink_tpu/ops/window.py:1585
// topn_shard's lax.top_k(v.T, k) over the -inf-masked counts): out[w] =
// the window's k largest keys, descending, each as often as it occurs,
// -inf past its candidates. The grid is read in tiles over the whole card
// (kCandItems cells a thread in max_span's layout, ~90 blocks at M1's
// 8,193 x 11), with its own tails:
//   k = 1   sel_max, then the grid's last block (last_block) writes each
//           window's maximum key as the (W, 1) output: one launch.
//   k <= kCandSmallK (W <= kThreads)  cand_merge: each thread's top k of
//           its cells (all of one window) in registers, a warp a window
//           merges the block's lists (butterfly shuffles) into the
//           caller's (blocks, W, k) scratch, and the grid's last block
//           merges the blocks' lists a window into the output: one launch,
//           no histogram (the radix passes below took 0.0278 ms at M1's
//           top-3 on the H100, PERF.md §6: their shared-memory bins
//           for the top digits of small counts are a few hot words).
//   k > 1 otherwise  the radix select finds each window's k-th key T (need: how
//           many of the k equal it); cand_collect appends each window's
//           candidates above T (fewer than k) to its list in the caller's
//           (W, k) scratch, counting them in the non-candidate words
//           (zeroed by the last pick); cand_sort_window ranks a window's
//           list (each key: the keys above it, then the equal ones before
//           it) and writes it, then T into the rest. Where the threshold
//           blocks fit on the card and W <= kRadixWindows, one cooperative
//           launch (cand_radix_all: the passes, the collect and a grid
//           barrier, then a block's windows sorted); else four radix
//           launches, the collect and the sort (a block a window).
// The top-1 and radix forms tag the workspace's thresholds with the
// call's epoch; their last block (block 0 after the last barrier, or of
// the sort launch) advances it, so the next call's tags win. The merge
// tags nothing.

constexpr uint32_t kSortChunk = kRadixWindows * 256;  // keys staged a round (s_hist's words)
constexpr int kCandItems = 4;    // cells a thread, top-1 and the merge
constexpr int kCandSmallK = 16;  // the merge's largest k
constexpr int kCandBatch = 4;    // blocks' lists a lane loads at once, the last merge

// x into v, the top k (descending; k <= KS) of what v held and x
template <int KS>
__device__ __forceinline__ void topk_insert(uint32_t (&v)[KS], int k, uint32_t x) {
#pragma unroll
  for (int i = 0; i < KS; ++i)
    if (i < k && x > v[i]) {
      const uint32_t t = v[i];
      v[i] = x;
      x = t;
    }
}

// every lane's list the top k of the warp's 32 lists (a butterfly: each
// step merges two disjoint groups' lists)
template <int KS>
__device__ __forceinline__ void topk_warp_merge(uint32_t (&v)[KS], int k) {
  for (int o = 16; o > 0; o >>= 1) {
    uint32_t other[KS];
#pragma unroll
    for (int i = 0; i < KS; ++i) other[i] = __shfl_xor_sync(0xffffffffu, v[i], o);
#pragma unroll
    for (int i = 0; i < KS; ++i)
      if (i < k) topk_insert(v, k, other[i]);
  }
}

// 1 < k <= KS <= kCandSmallK, W <= kThreads: a block's top k a window
// into part (blocks, W, k), then the last block's merge into the output.
// A list's empty places hold 0, below every cell's key (kNonCand and up).
template <int KS, bool kCount = true>
__device__ __forceinline__ void cand_merge(const SelParams& p) {
  __shared__ uint32_t s_list[KS * kThreads];
  __shared__ int s_flag;
  const int32_t W = p.W, k = p.k, span = max_span(W);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* part = p.cand_list;
  uint32_t key[kCandItems];
  int32_t win[kCandItems];
  span_keys<kCount, kCandItems>(p, key, win);
  uint32_t v[KS];
#pragma unroll
  for (int i = 0; i < KS; ++i) v[i] = 0;
#pragma unroll
  for (int j = 0; j < kCandItems; ++j) topk_insert(v, k, key[j]);
#pragma unroll
  for (int i = 0; i < KS; ++i) s_list[i * kThreads + threadIdx.x] = v[i];
  __syncthreads();
  // window w's lists: threads w, w + W, ... below the span
  for (int32_t w = warp; w < W; w += kWarps) {
    uint32_t u[KS];
#pragma unroll
    for (int i = 0; i < KS; ++i) u[i] = 0;
    for (int32_t t = w + W * lane; t < span; t += W * 32)
#pragma unroll
      for (int i = 0; i < KS; ++i)
        if (i < k) topk_insert(u, k, s_list[i * kThreads + t]);
    topk_warp_merge(u, k);
    if (lane < k) {
      uint32_t mine = u[0];
#pragma unroll
      for (int i = 1; i < KS; ++i)
        if (i == lane) mine = u[i];
      part[((int64_t)blockIdx.x * W + w) * k + lane] = mine;
    }
  }
  __threadfence();  // each lane's list before the last block reads it
  if (!last_block(p.done, gridDim.x, &s_flag)) return;
  for (int32_t w = warp; w < W; w += kWarps) {
    uint32_t u[KS];
#pragma unroll
    for (int i = 0; i < KS; ++i) u[i] = 0;
    // kCandBatch blocks' lists a lane in flight at once
    for (int64_t b0 = lane; b0 < gridDim.x; b0 += 32 * kCandBatch) {
      uint32_t got[kCandBatch][KS];
#pragma unroll
      for (int m = 0; m < kCandBatch; ++m) {
        const int64_t b = b0 + 32 * m;
#pragma unroll
        for (int i = 0; i < KS; ++i)
          got[m][i] = b < gridDim.x && i < k ? __ldcg(part + (b * W + w) * k + i) : 0u;
      }
#pragma unroll
      for (int m = 0; m < kCandBatch; ++m)
#pragma unroll
        for (int i = 0; i < KS; ++i)
          if (i < k) topk_insert(u, k, got[m][i]);
    }
    topk_warp_merge(u, k);
    if (lane < k) {
      uint32_t mine = u[0];
#pragma unroll
      for (int i = 1; i < KS; ++i)
        if (i == lane) mine = u[i];
      p.cand_out[w * p.cand_ld + lane] = key_value(mine);
    }
  }
}

// k = 1: sel_max's tail, in the grid's last block
__device__ __forceinline__ void cand_max_tail(const SelParams& p) {
  __shared__ int s_flag;
  if (!last_block(p.done, gridDim.x * gridDim.y, &s_flag)) return;
  for (int32_t w = threadIdx.x; w < p.W; w += kThreads)
    p.cand_out[w * p.cand_ld] = thresh_value(__ldcg(p.thresh + w));
  __syncthreads();
  if (threadIdx.x == 0) lb_advance(p.epoch, __ldcg(p.epoch));
}

// a block's cells above their window's k-th key (t: each window's, in
// shared memory or the workspace) appended to the windows' lists. A
// non-candidate ranks as -inf (kNonCand): above t only where the k-th is
// a lane form's -NaN candidate, and then fewer than k cells are.
__device__ __forceinline__ void cand_collect(const SelParams& p, const uint32_t (&key)[kThrItems],
                                             const int32_t (&win)[kThrItems],
                                             const bool (&cand)[kThrItems], const uint32_t* t) {
#pragma unroll
  for (int j = 0; j < kThrItems; ++j) {
    const uint32_t x = cand[j] ? key[j] : kNonCand;
    if (win[j] >= 0 && x > t[win[j]]) {
      const uint32_t slot = atomicAdd(p.noncand + win[j], 1u);
      p.cand_list[(int64_t)win[j] * p.k + slot] = x;
    }
  }
  __threadfence();  // before the barrier's last arrival releases the sort
}

// window w's output from its list: m keys above T ranked descending (a
// key's place: the keys above it, then the equal ones before it; staged
// kSortChunk at a time), then T into the rest
__device__ void cand_sort_window(const SelParams& p, int32_t w, uint32_t* s_keys) {
  const int32_t k = p.k;
  const uint32_t m = __ldcg(p.noncand + w);
  const uint32_t t = __ldcg(p.prefix + w);
  const uint32_t* list = p.cand_list + (int64_t)w * k;
  float* out = p.cand_out + w * p.cand_ld;
  for (uint32_t i0 = 0; i0 < m; i0 += kThreads) {
    const uint32_t i = i0 + threadIdx.x;
    const uint32_t key = i < m ? __ldcg(list + i) : 0u;
    uint32_t pos = 0;
    for (uint32_t c0 = 0; c0 < m; c0 += kSortChunk) {
      const uint32_t n = m - c0 < kSortChunk ? m - c0 : kSortChunk;
      __syncthreads();
      for (uint32_t e = threadIdx.x; e < n; e += kThreads) s_keys[e] = __ldcg(list + c0 + e);
      __syncthreads();
      if (i < m)
        for (uint32_t e = 0; e < n; ++e) {
          const uint32_t o = s_keys[e];
          pos += o > key || (o == key && c0 + e < i);
        }
    }
    if (i < m) out[pos] = key_value(key);
  }
  for (int32_t i = (int32_t)m + threadIdx.x; i < k; i += kThreads) out[i] = key_value(t);
}

// k > 1, the threshold blocks resident at once and W <= kRadixWindows:
// sel_radix_all's passes, the collect, a grid barrier, then each block
// sorts windows blockIdx.x, + gridDim.x, ...
template <bool kCount = true>
__device__ __forceinline__ void cand_radix_all(const SelParams& p) {
  __shared__ uint32_t s_hist[kRadixWindows * 256];
  __shared__ uint32_t s_pre[kRadixWindows];
  __shared__ uint32_t s_epoch;
  __shared__ int s_flag;
  const int32_t W = p.W;
  uint32_t key[kThrItems];
  int32_t win[kThrItems];
  bool cand[kThrItems];
  walk_keys<kCount>(p, 0, W, key, win, cand);
  for (int32_t w = threadIdx.x; w < W; w += kThreads) s_pre[w] = 0;
  if (threadIdx.x == 0) s_epoch = __ldcg(p.epoch);
  for (int pass = 0; pass < 4; ++pass) {
    radix_histogram(s_hist, s_pre, key, win, cand, pass, W, p.hist);
    grid_barrier(p.bar, &s_flag, [&] { radix_pick_all(p, pass, s_epoch); });
    for (int32_t w = threadIdx.x; w < W; w += kThreads) s_pre[w] = __ldcg(p.prefix + w);
  }
  __syncthreads();
  cand_collect(p, key, win, cand, s_pre);
  grid_barrier(p.bar, &s_flag, [] {});
  for (int32_t w = blockIdx.x; w < W; w += gridDim.x) cand_sort_window(p, w, s_hist);
  if (blockIdx.x == 0 && threadIdx.x == 0) lb_advance(p.epoch, s_epoch);
}

// k > 1 otherwise, after the four sel_radix launches: the collect over
// the threshold blocks' cells (each window's T from the workspace, written
// by the last launch)
template <bool kCount = true>
__device__ __forceinline__ void cand_collect_all(const SelParams& p) {
  uint32_t key[kThrItems];
  int32_t win[kThrItems];
  bool cand[kThrItems];
  walk_keys<kCount>(p, 0, p.W, key, win, cand);
  cand_collect(p, key, win, cand, p.prefix);
}

// then a block a window; block 0 advances the epoch (the launches before
// it on the stream are done)
__device__ __forceinline__ void cand_sort_all(const SelParams& p) {
  __shared__ uint32_t s_keys[kSortChunk];
  for (int32_t w = blockIdx.x; w < p.W; w += gridDim.x) cand_sort_window(p, w, s_keys);
  if (blockIdx.x == 0 && threadIdx.x == 0) lb_advance(p.epoch, __ldcg(p.epoch));
}

struct CandKernels {
  void (*max)(const SelParams);
  void (*merge4)(const SelParams);   // cand_merge<4>: k <= 4
  void (*merge16)(const SelParams);  // cand_merge<kCandSmallK>
  void (*radix)(const SelParams, int);
  void (*radix_all)(const SelParams);
  void (*collect)(const SelParams);
  void (*sort)(const SelParams);
  int* capacity;  // 64 devices
};

// the blocks of the top-1 and merge launches (max_span's layout,
// kCandItems cells a thread)
inline int64_t cand_blocks(int64_t rows, int32_t W) {
  const int64_t span_cells = (int64_t)max_span(W) * kCandItems;
  return (rows * W + span_cells - 1) / span_cells;
}

// the uint32 words of the caller's scratch a call needs: none at top-1,
// the blocks' lists for the merge, else a list a window
inline int64_t cand_list_words(int64_t rows, int32_t W, int32_t k) {
  if (k <= 1) return 0;
  if (k <= kCandSmallK && W <= kThreads) return cand_blocks(rows, W) * W * k;
  return (int64_t)W * k;
}

// One topn_candidates call: p's grid fields, k, cand_out and its row
// stride cand_ld (at least k; and cand_list, list_words uint32 words, at
// k > 1) set by the caller; work the entry
// point's clean workspace (select_work_words(Wc, Tc)). Returns the first
// launch error.
inline int launch_candidates(SelParams p, int64_t list_words, int64_t* work, int64_t Wc,
                             int64_t Tc, const CandKernels& k, cudaStream_t s) {
  const int64_t K = p.rows * (int64_t)p.W;
  if (K <= 0 || p.W <= 0) return (int)cudaGetLastError();
  const int64_t blocks = (K + kThrCells - 1) / kThrCells;
  const int64_t groups = (p.W + kRadixWindows - 1) / kRadixWindows;
  const int64_t tiles = (K + kSelCells - 1) / kSelCells;
  if (p.rows >= (1ll << 32) || blocks >= (1ll << 31) || groups > 65535 || p.k < 1 ||
      p.k > p.rows || Wc < p.W || Tc < tiles || work == nullptr || p.cand_out == nullptr ||
      p.cand_ld < p.k ||
      (p.k > 1 && p.cand_list == nullptr) || list_words < cand_list_words(p.rows, p.W, p.k))
    return (int)cudaErrorInvalidValue;
  bind_select_work(p, work, Wc);
  p.old_total = nullptr;
  if (p.k == 1 || (p.k <= kCandSmallK && p.W <= kThreads)) {
    const unsigned grid = (unsigned)cand_blocks(p.rows, p.W);
    if (p.k == 1)
      k.max<<<grid, kThreads, 0, s>>>(p);
    else if (p.k <= 4)
      k.merge4<<<grid, kThreads, 0, s>>>(p);
    else
      k.merge16<<<grid, kThreads, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (p.W <= kRadixWindows && blocks <= coop_capacity((const void*)k.radix_all, k.capacity)) {
    void* args[] = {(void*)&p};
    return (int)cudaLaunchCooperativeKernel((const void*)k.radix_all, dim3((unsigned)blocks),
                                            dim3(kThreads), args, 0, s);
  }
  for (int pass = 0; pass < 4; ++pass) {
    k.radix<<<dim3((unsigned)blocks, (unsigned)groups), kThreads, 0, s>>>(p, pass);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  k.collect<<<(unsigned)blocks, kThreads, 0, s>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  k.sort<<<(unsigned)(p.W < 65535 ? p.W : 65535), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
