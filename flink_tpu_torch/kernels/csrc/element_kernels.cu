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
// bit for bit. Max and min are IEEE 754-2019 maximum / minimum (-0 < +0)
// with NaN propagated as it is: the max keeps the last NaN of the
// segment, the min the first, which is what XLA's CPU reduction gives
// for a column with one NaN (a column with several NaNs gives a NaN
// either way). An empty segment gives 0, -inf, +inf and count 0. Only the
// sums fix an order of operations: the non-NaN maximum and minimum are
// the same bits in any order, and the NaN kept is the one at the last
// (first) position, so max and min may fold in parallel.
//
// Bound: bytes — each lifted lane read once, the offsets once, each
// output written once (~6.5 MB, 0.0019 ms at job E's fire).
//
// Design. A group of G lanes takes a segment (32 / G segments a warp at
// once); persistent warps walk the segments, one wave of them. A segment's
// elements are contiguous rows of each lane array, so its group stages a
// chunk of them at a time into the warp's shared memory by cp.async,
// neighbouring lanes on neighbouring words (coalesced; the copies are
// 1/30 of the instructions of the fold, so no 16-byte form), two stages:
// the next chunk's copies are in flight while the current one folds.
//   sums    lane c of the group folds column c (G columns a pass) over the
//           chunk in element order from shared memory: the chain of
//           adds the contract fixes, about 4 cycles an add.
//   max/min the group's lanes split into phases, Mq lanes a phase (Mq the
//           power of two at or above the pass's columns), each phase
//           taking every (G / Mq)-th element: order-preserving int keys
//           for the non-NaN values, the position and bits of the last
//           (first) NaN; the phases merge by shuffles at the segment's
//           end.
// G is the wrapper's choice (element_kernels.py SEGMENT_WARP_MEAN): 8
// where segments are short (job E's fire: ~10,000 segments of up to 100
// elements; four a warp share the add chain's instructions), a warp a
// segment where they are long (job E2's prefixes of thousands: a stage
// of 256 elements folds for longer than the next one takes to arrive).
// A segment's add chain is the contract's cost: 5,000 elements take
// ~20,000 cycles whatever the grouping.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_common.cuh"
#include "lookback.cuh"

namespace {

// error-word bit (window_kernels.py ERROR_BITS decodes it)
constexpr int32_t kErrSegmentOffsets = 256;
// a warp's staging: two stages of kSegStage floats, each split between
// the warp's groups (element_kernels.py SEGMENT_STAGE mirrors it); group
// g's share starts kSegSkew * g words further on, so the groups' lanes
// that read or write the same offset of their shares fall on distinct
// banks
constexpr int kSegStage = 512;
constexpr int kSegSkew = 8;

struct SegParams {
  const int64_t* offsets;
  int64_t n_seg, n_elem;
  const float* in[3];  // the lifted sums, maxs, mins, (E, width) each
  int32_t width[3];
  float* out[3];  // (W, width) each
  int32_t* counts;
  int32_t* err;
};

__device__ __forceinline__ int32_t order_key(float x) {
  const int32_t b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_order_key(int32_t k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ int32_t lanes_for(int32_t cols) {  // a power of two >= cols
  int32_t q = 1;
  while (q < cols) q <<= 1;
  return q;
}

template <int G>
__global__ void __launch_bounds__(kThreads) segment_lanes_kernel(const SegParams p) {
  constexpr int kSegs = 32 / G;                     // segments a warp at once
  constexpr int kGroupStage = kSegStage / kSegs;    // floats of a group's stage
  __shared__ float s_stage[kWarps][2][kSegStage + kSegSkew * kSegs];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane & (G - 1), grp = lane / G;
  const int32_t S = p.width[0], M = p.width[1], N = p.width[2];
  const int32_t cols = S + M + N;
  const int32_t ce = kGroupStage / (cols > 0 ? cols : 1);  // elements a chunk
  const int32_t wide = max(S, max(M, N));
  const int32_t passes = wide > G ? (wide + G - 1) / G : 1;
  const int gofs = grp * (kGroupStage + kSegSkew);  // the group's share of a stage
  const int64_t step = (int64_t)gridDim.x * kWarps * kSegs;
  for (int64_t first = ((int64_t)blockIdx.x * kWarps + warp) * kSegs; first < p.n_seg;
       first += step) {
    const int64_t w = first + grp;
    int64_t lo = 0, hi = 0;
    if (w < p.n_seg) {
      lo = p.offsets[w];
      hi = p.offsets[w + 1];
      if (lo < 0 || hi < lo || hi > p.n_elem) {
        if (gl == 0) atomicOr(p.err, kErrSegmentOffsets);
        lo = hi = 0;
      }
      if (gl == 0) p.counts[w] = (int32_t)(hi - lo);
    }
    const int32_t len = (int32_t)(hi - lo);
    const int32_t chunks = (len + ce - 1) / ce;
    // the warp walks as many chunks as its longest segment has
    int32_t wchunks = chunks;
    for (int o = G; o < 32; o <<= 1) wchunks = max(wchunks, __shfl_xor_sync(~0u, wchunks, o));
    for (int32_t pass = 0; pass < passes; ++pass) {
      const int32_t c0 = pass * G;
      const int32_t Sp = min(max(S - c0, 0), G), Mp = min(max(M - c0, 0), G),
                    Np = min(max(N - c0, 0), G);
      const int32_t Mq = lanes_for(Mp), Nq = lanes_for(Np);
      const int32_t mc = gl & (Mq - 1), mph = gl / Mq, mP = G / Mq;  // column, phase, phases
      const int32_t nc = gl & (Nq - 1), nph = gl / Nq, nP = G / Nq;
      float acc = 0.0f;
      int32_t kx = order_key(-INFINITY), kn = order_key(INFINITY);
      int32_t px = -1, pn = INT32_MAX;  // the kept NaN's position
      uint32_t bx = 0, bn = 0;          // and bits
      // chunk c of the group's segment into stage b (an empty group when
      // the segment has no chunk c)
      auto stage = [&](int32_t c, int b) {
        if (c < chunks) {
          const int64_t e0 = lo + (int64_t)c * ce;
          const int32_t n = min(ce, len - c * ce);
          float* d = &s_stage[warp][b][gofs];
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            const int32_t wd = p.width[f];
            const float* src = p.in[f] + e0 * wd;
            for (int32_t i = gl; i < n * wd; i += G) cp_async_4(d + i, src + i);
            d += n * wd;
          }
        }
        cp_async_commit();
      };
      stage(0, 0);
      for (int32_t c = 0; c < wchunks; ++c) {
        stage(c + 1, (c + 1) & 1);
        cp_async_wait_one();
        __syncwarp();
        if (c < chunks) {
          const int32_t r0 = c * ce, n = min(ce, len - r0);
          const float* bs = &s_stage[warp][c & 1][gofs];
          const float* bm = bs + n * S;
          const float* bnn = bm + n * M;
          if (gl < Sp) {
            // the add chain in element order, the next 8 elements' loads
            // in flight behind the current 8 adds
            const float* q = bs + c0 + gl;
            int32_t k = 0;
            if (n >= 8) {
              float v[8];
#pragma unroll
              for (int u = 0; u < 8; ++u) v[u] = q[u * S];
              for (k = 8; k + 8 <= n; k += 8) {
                float nv[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) nv[u] = q[(k + u) * S];
#pragma unroll
                for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
#pragma unroll
                for (int u = 0; u < 8; ++u) v[u] = nv[u];
              }
#pragma unroll
              for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
            }
            for (; k < n; ++k) acc = __fadd_rn(acc, q[k * S]);
          }
          if (mc < Mp) {
            for (int32_t k = (mph - r0) & (mP - 1); k < n; k += mP) {
              const float x = bm[k * M + c0 + mc];
              if (isnan(x)) {
                px = r0 + k;  // a lane's elements come in order: the last
                bx = __float_as_uint(x);
              } else {
                kx = max(kx, order_key(x));
              }
            }
          }
          if (nc < Np) {
            for (int32_t k = (nph - r0) & (nP - 1); k < n; k += nP) {
              const float x = bnn[k * N + c0 + nc];
              if (isnan(x)) {
                if (pn == INT32_MAX) {  // the first
                  pn = r0 + k;
                  bn = __float_as_uint(x);
                }
              } else {
                kn = min(kn, order_key(x));
              }
            }
          }
        }
        __syncwarp();  // before the stage is written again
      }
      // each column's phases merged: the last NaN of a max, the first of
      // a min, else the extreme key
      for (int o = Mq; Mp > 0 && o < G; o <<= 1) {
        const int32_t k2 = __shfl_xor_sync(~0u, kx, o), p2 = __shfl_xor_sync(~0u, px, o);
        const uint32_t b2 = __shfl_xor_sync(~0u, bx, o);
        kx = max(kx, k2);
        if (p2 > px) {
          px = p2;
          bx = b2;
        }
      }
      for (int o = Nq; Np > 0 && o < G; o <<= 1) {
        const int32_t k2 = __shfl_xor_sync(~0u, kn, o), p2 = __shfl_xor_sync(~0u, pn, o);
        const uint32_t b2 = __shfl_xor_sync(~0u, bn, o);
        kn = min(kn, k2);
        if (p2 < pn) {
          pn = p2;
          bn = b2;
        }
      }
      if (w < p.n_seg) {
        if (gl < Sp) p.out[0][w * S + c0 + gl] = acc;
        if (mph == 0 && mc < Mp)
          p.out[1][w * M + c0 + mc] = px >= 0 ? __uint_as_float(bx) : from_order_key(kx);
        if (nph == 0 && nc < Np)
          p.out[2][w * N + c0 + nc] = pn != INT32_MAX ? __uint_as_float(bn) : from_order_key(kn);
      }
    }
  }
}

// the blocks of segment_lanes_kernel<G> the card holds at once, cached a
// device
template <int G>
int segment_capacity() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_lanes_kernel<G>, kThreads,
                                                      0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

template <int G>
int launch_segments(const SegParams& p, cudaStream_t s) {
  // every element of a chunk in one group's share of a stage
  if (p.width[0] + p.width[1] + p.width[2] > kSegStage / (32 / G))
    return (int)cudaErrorInvalidValue;
  const int fit = segment_capacity<G>();
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)kWarps * (32 / G);
  const int64_t need = (p.n_seg + per_block - 1) / per_block;
  segment_lanes_kernel<G><<<(unsigned)(need < fit ? need : fit), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ek_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// group: lanes a segment, 8 or 32 (element_kernels.py _segment_group)
int ek_segment_lanes(const int64_t* offsets, int64_t n_seg, int64_t n_elem, const float* sums,
                     int32_t sw, const float* maxs, int32_t mw, const float* mins, int32_t nw,
                     float* out_sums, float* out_maxs, float* out_mins, int32_t* counts,
                     int32_t* err, int32_t group, void* stream) {
  if (n_seg <= 0) return (int)cudaGetLastError();
  // positions within a segment are int32
  if (n_elem >= (1ll << 31) || sw < 0 || mw < 0 || nw < 0) return (int)cudaErrorInvalidValue;
  const SegParams p{offsets, n_seg, n_elem, {sums, maxs, mins}, {sw, mw, nw},
                    {out_sums, out_maxs, out_mins}, counts, err};
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 8) return launch_segments<8>(p, s);
  if (group == 32) return launch_segments<32>(p, s);
  return (int)cudaErrorInvalidValue;
}

// the lean launch path (window_kernels.py LeanEntry): each entry
// above from one packed block of 64-bit words, the stream beside
// ek_segment_lanes from one packed block of 15 64-bit words
int ek_segment_lanes_packed(const int64_t* a, void* stream) {
  return ek_segment_lanes(
      (const int64_t*)(intptr_t)a[0], (int64_t)a[1], (int64_t)a[2], (const float*)(intptr_t)a[3],
      (int32_t)a[4], (const float*)(intptr_t)a[5], (int32_t)a[6], (const float*)(intptr_t)a[7],
      (int32_t)a[8], (float*)(intptr_t)a[9], (float*)(intptr_t)a[10], (float*)(intptr_t)a[11],
      (int32_t*)(intptr_t)a[12], (int32_t*)(intptr_t)a[13], (int32_t)a[14], stream);
}

}  // extern "C"
