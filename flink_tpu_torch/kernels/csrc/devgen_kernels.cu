// Device bid generator and device ingest of the Nexmark Q5 headline path,
// hand-written for Hopper (sm_90a). Plain C interface, bound from Python
// with ctypes (flink_tpu_torch/kernels/devgen_kernels.py); every entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch raises in the wrapper.
//
// K5 nexmark_bids   replaces flink_tpu/nexmark/generator.py:125
//                   _NexmarkDeviceBidGen.__call__
// K6 devgen_ingest  replaces the ingest half of flink_tpu/ops/window.py:712
//                   devgen_step_kernel (:757-792: key -> slot, pane, late /
//                   miss masks, the segment sum into the pane counts, the
//                   refire bitmap and the stats words)
//
// Both are exact: K5 is integer arithmetic in native uint64, K6 adds
// int32 ones with atomics (integer sums do not depend on order), so each
// equals its plain PyTorch version and the JAX reference bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_common.cuh"

namespace {

// error-word bit (window_kernels.py ERROR_BITS decodes it)
constexpr int32_t kErrIngestCell = 4;
// stats vector layout (ops/window.py devgen_step_kernel): 8 header words
// [n_valid, n_late, n_miss, ring_total, n_refire, ring_truncated, 0, 0]
// then a refire bitmap of kRefireBits words
constexpr int kStatsHead = 8;
constexpr int64_t kRefireBits = 2048;

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t m) {
  int64_t q = a / m;
  return (a % m != 0 && ((a < 0) != (m < 0))) ? q - 1 : q;
}

// ---- K5: nexmark_bids ----------------------------------------------------
// Record i of the (sub-)batch is record off + i of logical batch
// `logical`: counter c = logical * 0xD1342543DE82EF95 + 1 + (off + i + 1) * G
// (codec.cc smx() advances the counter before mixing), splitmix64's mix,
// then a hot / cold auction by multiply-shift range reduction, and
// ts = (logical * batch_total + off + i) / events_per_ms.
// Bound: bytes — 16 B written per record (int64 key and ts), nothing
// read; the mix is ~20 integer operations (the two 64-bit multiplies
// are a few IMADs each), far under the write time. Design: one thread
// per record, grid-stride, coalesced 8-byte stores.
__global__ void nexmark_bids_kernel(int64_t* __restrict__ keys, int64_t* __restrict__ ts,
                                    int64_t n, uint64_t base, uint64_t off,
                                    int64_t id0, int64_t events_per_ms, uint64_t hot_ratio,
                                    uint64_t n_hot, uint64_t n_auctions) {
  const uint64_t G = 0x9E3779B97F4A7C15ULL;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint64_t z = base + (off + (uint64_t)i) * G + G;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    const uint64_t r1 = z ^ (z >> 31);
    const bool hot = (r1 & 0xFFULL) % hot_ratio == 0;
    const uint64_t a32 = (r1 >> 8) & 0xFFFFFFFFULL;
    keys[i] = (int64_t)((a32 * (hot ? n_hot : n_auctions)) >> 32);
    ts[i] = (id0 + i) / events_per_ms;
  }
}

// ---- K6: devgen_ingest ---------------------------------------------------
// Per record: hit = 0 <= key < key_domain (slot = key), pane =
// floor((ts - offset) / pane_ms), late = hit & pane < dead_below,
// miss = !hit, valid = hit & !late, col = pane mod ring. A valid record
// adds 1 to counts[slot * ring + col]; an invalid one to the dump row's
// cell dump_row * ring, as the reference's segment sum does, so the
// state equals the reference's on every row. A refire candidate (valid
// and pane < refire_below) sets bitmap word pane - dead_below when that
// lies in [0, kRefireBits) (the reference's segment sum drops the rest).
// Stats words 0, 1, 2, 4 = n_valid, n_late, n_miss, n_refire; a null
// stats pointer skips the bitmap and the counters (the host needs them
// only when a batch can be late, re-fire or miss). A cell outside
// counts is not written and sets kErrIngestCell.
// Bound: bytes — 16 B read per record plus a 4-byte read and write of
// each distinct cell the batch touches (the atomics of one cell meet in
// L2; the 4-8 MB state fits there). Design: one thread per record,
// grid-stride; the four counters go through a warp reduce
// (__reduce_add_sync), shared-memory per-warp partials and one global
// atomicAdd per block and counter. Hot cells take many same-address
// atomics (records arrive in ts order, so a warp mostly shares a pane);
// warp-aggregating them is later work (ROADMAP.md).
__global__ void devgen_ingest_kernel(int32_t* __restrict__ counts, int64_t n_cells,
                                     const int64_t* __restrict__ keys,
                                     const int64_t* __restrict__ ts, int64_t n,
                                     int64_t key_domain, int64_t pane_ms, int64_t offset_ms,
                                     int32_t ring, int64_t dead_below, int64_t refire_below,
                                     int64_t dump_row, int32_t* __restrict__ stats,
                                     int32_t* __restrict__ err) {
  __shared__ int32_t s_part[4][kWarps];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int32_t c_valid = 0, c_late = 0, c_miss = 0, c_refire = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t key = keys[i];
    const int64_t pane = floor_div(ts[i] - offset_ms, pane_ms);
    const bool hit = key >= 0 && key < key_domain;
    const bool late = hit && pane < dead_below;
    const bool valid = hit && !late;
    const int64_t cell = valid ? key * ring + floor_mod(pane, ring) : dump_row * ring;
    if (cell < 0 || cell >= n_cells) {
      atomicOr(err, kErrIngestCell);
    } else {
      atomicAdd(&counts[cell], 1);
    }
    c_valid += valid;
    c_late += late;
    c_miss += !hit;
    if (valid && pane < refire_below) {
      ++c_refire;
      const int64_t bit = pane - dead_below;
      if (stats != nullptr && bit >= 0 && bit < kRefireBits) stats[kStatsHead + bit] = 1;
    }
  }
  if (stats == nullptr) return;  // the same for every thread of the grid
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  c_valid = __reduce_add_sync(0xffffffffu, c_valid);
  c_late = __reduce_add_sync(0xffffffffu, c_late);
  c_miss = __reduce_add_sync(0xffffffffu, c_miss);
  c_refire = __reduce_add_sync(0xffffffffu, c_refire);
  if (lane == 0) {
    s_part[0][warp] = c_valid;
    s_part[1][warp] = c_late;
    s_part[2][warp] = c_miss;
    s_part[3][warp] = c_refire;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    int32_t sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += s_part[threadIdx.x][w];
    // words 0, 1, 2 and 4 (3 and 5 are the reference's ring head)
    const int word = threadIdx.x < 3 ? threadIdx.x : 4;
    if (sum) atomicAdd(&stats[word], sum);
  }
}

}  // namespace

extern "C" {

const char* dg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int dg_nexmark_bids(int64_t* keys, int64_t* ts, int64_t n, int64_t logical, int64_t off,
                    int64_t batch_total, int64_t events_per_ms, int64_t hot_ratio,
                    int64_t n_hot, int64_t n_auctions, void* stream) {
  if (n > 0) {
    const uint64_t base = (uint64_t)logical * 0xD1342543DE82EF95ULL + 1ULL;
    const int64_t id0 = logical * batch_total + off;
    nexmark_bids_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        keys, ts, n, base, (uint64_t)off, id0, events_per_ms, (uint64_t)hot_ratio,
        (uint64_t)n_hot, (uint64_t)n_auctions);
  }
  return (int)cudaGetLastError();
}

int dg_devgen_ingest(int32_t* counts, int64_t n_cells, const int64_t* keys, const int64_t* ts,
                     int64_t n, int64_t key_domain, int64_t pane_ms, int64_t offset_ms,
                     int32_t ring, int64_t dead_below, int64_t refire_below, int64_t dump_row,
                     int32_t* stats, int32_t* err, void* stream) {
  if (n > 0) {
    devgen_ingest_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        counts, n_cells, keys, ts, n, key_domain, pane_ms, offset_ms, ring, dead_below,
        refire_below, dump_row, stats, err);
  }
  return (int)cudaGetLastError();
}

// the lean launch path (window_kernels.py LeanEntry): each entry
// above from one packed block of 64-bit words, the stream beside
// dg_nexmark_bids from one packed block of 10 64-bit words
int dg_nexmark_bids_packed(const int64_t* a, void* stream) {
  return dg_nexmark_bids(
      (int64_t*)(intptr_t)a[0], (int64_t*)(intptr_t)a[1], (int64_t)a[2], (int64_t)a[3],
      (int64_t)a[4], (int64_t)a[5], (int64_t)a[6], (int64_t)a[7], (int64_t)a[8], (int64_t)a[9],
      stream);
}

// dg_devgen_ingest from one packed block of 14 64-bit words
int dg_devgen_ingest_packed(const int64_t* a, void* stream) {
  return dg_devgen_ingest(
      (int32_t*)(intptr_t)a[0], (int64_t)a[1], (const int64_t*)(intptr_t)a[2],
      (const int64_t*)(intptr_t)a[3], (int64_t)a[4], (int64_t)a[5], (int64_t)a[6], (int64_t)a[7],
      (int32_t)a[8], (int64_t)a[9], (int64_t)a[10], (int64_t)a[11], (int32_t*)(intptr_t)a[12],
      (int32_t*)(intptr_t)a[13], stream);
}

}  // extern "C"
