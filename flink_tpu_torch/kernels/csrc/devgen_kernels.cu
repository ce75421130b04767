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
//                   refire bitmap and the stats words); its Nexmark form
//                   makes the records in registers, as the reference's
//                   step traces its generator in (`keys, ts =
//                   gen(batch_index)`, :761), so the devgen path's bids
//                   never reach device memory and K5 launches nowhere on it
//
// Both are exact: K5 is integer arithmetic in native uint64
// (nexmark_gen.cuh, shared with K6's Nexmark form), K6 adds int32 counts
// with atomics, shared and global (integer sums do not depend on order),
// so each equals its plain PyTorch version and the JAX reference bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_common.cuh"
#include "nexmark_gen.cuh"

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
// The generator of nexmark_gen.cuh into device memory: each record's
// int64 auction and ts. Bound: bytes — 16 B written per record, nothing
// read; the mix is ~20 integer operations (the two 64-bit multiplies are
// a few IMADs each), far under the write time. Design: one thread per
// record, grid-stride, coalesced 8-byte stores.
__global__ void nexmark_bids_kernel(int64_t* __restrict__ keys, int64_t* __restrict__ ts,
                                    int64_t n, const NexmarkGen g) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    keys[i] = nexmark_key(g, (uint64_t)i);
    ts[i] = nexmark_ts(g, i);
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
//
// Two forms, one template: the records loaded from keys / ts (16 B read
// per record), or, in the Nexmark form, made in registers by
// nexmark_gen.cuh (each thread its records before the first is used, as
// the loads are: a counter one add from the last, each ts by a FastDiv
// multiply from the chunk's first id's remainder). The chunk's first pane
// and column (two 64-bit divisions) are one thread's work for the block.
// Bound: bytes — the memory form 16 B read per record plus a 4-byte read
// and write of each distinct cell the batch touches; the Nexmark form
// only the cells (and the generator's integer work, which bounds it by
// operations). What held it back (PERF.md §6): one global atomic
// a record, ~3 x the bound and no faster than index_add_ on cells
// computed in advance. Each of those atomics is its own L2 transaction,
// and their rate sets the pace: 2^20 of them take ~0.015 ms, the batch's
// ~110,000 distinct cells once each (in order) 0.0023 ms. Dropping the
// per-record int64 divisions moved nothing; the chunk's first pane
// divided once a block, not once a thread, took 0.0005-0.0009 ms off
// either form. The global atomics of the histograms' flush are
// the longest phase; made records are ready later than loaded ones.
// Design: a block takes a contiguous chunk of kIngestChunk records — a
// sub-batch is in time order, so a chunk lies in one pane, or two at a
// pane's edge — and counts it in a shared-memory histogram before any
// global write:
//   - every record of a thread (kIngestItems, neighbouring threads on
//     neighbouring records) is loaded before the first is used;
//   - the pane by comparison with the thread's running pane (from the
//     chunk's first record's, p0), a floor division only for a record
//     outside it; the column carried from that pane's;
//   - the histogram is direct-mapped by key over pane p0 (slot = key):
//     one shared atomicAdd a valid record, no probing; the invalid
//     records a warp's ballot, one add a warp;
//   - then one global atomicAdd a non-zero slot. At the headline mix
//     (10,000 auctions, a quarter of the bids on 100 hot ones) a chunk
//     of 8,192 records touches ~4,700 cells, so ~57 % of the records'
//     atomics remain, and a hot cell's ~240 adds a sub-batch become ~12.
// A record of another pane than p0, and every record where the key
// domain is too wide for the histogram (key_domain + 1 > kHistWords),
// takes one global atomicAdd. Integer adds, exact in any order: the
// state equals the plain version's bit for bit. Measured slower on the
// H100 (PERF.md §6, PR 13): one atomic a warp's group of equal cells; a
// shared-memory hash table of the chunk's cells (probing); a histogram
// over two panes; a cluster of 2-8 blocks adding their histograms
// through distributed shared memory, or adding each record into one
// histogram dealt round the cluster. The four counters go through a warp
// reduce, per-warp partials and one global atomicAdd a block and
// counter; the bitmap's words are plain stores of 1.
constexpr int kIngestThreads = 1024;
constexpr int kIngestWarps = kIngestThreads / 32;
constexpr int kIngestItems = 8;                              // records a thread
constexpr int kIngestChunk = kIngestThreads * kIngestItems;  // records a block
constexpr int kHistWords = 48 * 1024;                        // 192 KB at most

struct IngestParams {
  int32_t* counts;
  int64_t n_cells;
  const int64_t* keys;  // the memory form's records
  const int64_t* ts;
  NexmarkGen gen;       // the Nexmark form's
  int64_t n, key_domain, pane_ms, offset_ms;
  int32_t ring;
  int64_t dead_below, refire_below, dump_row;
  int32_t* stats;
  int32_t* err;
};

template <bool kGen>
__global__ void __launch_bounds__(kIngestThreads) devgen_ingest_kernel(const IngestParams p) {
  extern __shared__ uint32_t s_hist[];  // a slot a key of pane p0, then the dump's
  __shared__ int32_t s_part[4][kIngestWarps];
  __shared__ int64_t s_pane[3];  // the chunk's first pane, its first ms, its column
  // the grid's choice
  const bool hist = p.key_domain >= 0 && p.key_domain + 1 <= kHistWords;
  const int32_t hw = hist ? (int32_t)(p.key_domain + 1) : 0;
  const int64_t chunk = (int64_t)blockIdx.x * kIngestChunk;
  const int64_t first = chunk + threadIdx.x;
  // the Nexmark form's chunk: its first record's ms and id remainder
  int64_t q0 = 0, r0 = 0;
  if constexpr (kGen) q0 = nexmark_ms(p.gen, chunk, &r0);
  // the chunk's first pane (one thread's divisions, for the block)
  if (threadIdx.x == 0) {
    const int64_t t_first = kGen ? q0 : chunk < p.n ? p.ts[chunk] : 0;
    const int64_t p0 = floor_div(t_first - p.offset_ms, p.pane_ms);
    s_pane[0] = p0;
    s_pane[1] = p0 * p.pane_ms;
    s_pane[2] = floor_mod(p0, p.ring);
  }
  int64_t key[kIngestItems], t[kIngestItems];
  if constexpr (kGen) {
    // the thread's records are kIngestThreads apart: each counter one add
    // from the first's
    const uint64_t z0 = nexmark_counter(p.gen, (uint64_t)first);
#pragma unroll
    for (int j = 0; j < kIngestItems; ++j) {
      key[j] = nexmark_key_of(p.gen, z0 + (uint64_t)j * kIngestThreads * kNexmarkGamma);
      const int64_t d = r0 + (first - chunk) + (int64_t)j * kIngestThreads;
      // d < events_per_ms + kIngestChunk
      t[j] = q0 + (p.gen.fast_ts ? (int64_t)div_of((uint32_t)d, p.gen.epm_div)
                                 : d / p.gen.events_per_ms);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kIngestItems; ++j) {
      const int64_t i = first + (int64_t)j * kIngestThreads;
      key[j] = i < p.n ? p.keys[i] : 0;
      t[j] = i < p.n ? p.ts[i] : 0;
    }
  }
  for (int32_t e = threadIdx.x; e < hw; e += kIngestThreads) s_hist[e] = 0;
  __syncthreads();
  // the running pane, from the chunk's first: its number, its first ms
  // (offset-relative), its column
  const int64_t p0 = s_pane[0];
  int64_t pane = p0, pane_at = s_pane[1], col = s_pane[2];
  int32_t c_valid = 0, c_late = 0, c_miss = 0, c_refire = 0, c_dump = 0;
#pragma unroll
  for (int j = 0; j < kIngestItems; ++j) {
    const bool in = first + (int64_t)j * kIngestThreads < p.n;
    const int64_t kj = key[j];
    const int64_t dt = t[j] - p.offset_ms;
    const int64_t rel = dt - pane_at;
    if (in && (rel < 0 || rel >= p.pane_ms)) {
      pane = floor_div(dt, p.pane_ms);
      pane_at = pane * p.pane_ms;
      col = floor_mod(pane, p.ring);
    }
    const bool hit = kj >= 0 && kj < p.key_domain;
    const bool late = hit && pane < p.dead_below;
    const bool valid = in && hit && !late;
    if (valid) {
      if (hist && pane == p0) {
        atomicAdd(&s_hist[kj], 1u);
      } else {
        const int64_t cell = kj * p.ring + col;
        if (cell >= p.n_cells) atomicOr(p.err, kErrIngestCell);
        else atomicAdd(&p.counts[cell], 1);
      }
      if (pane < p.refire_below) {
        ++c_refire;
        const int64_t bit = pane - p.dead_below;
        if (p.stats != nullptr && bit >= 0 && bit < kRefireBits) p.stats[kStatsHead + bit] = 1;
      }
    }
    // the invalid records of the warp, one add
    const unsigned dumped = __ballot_sync(0xffffffffu, in && !valid);
    if ((threadIdx.x & 31) == 0) c_dump += __popc(dumped);
    c_valid += valid;
    c_late += in && late;
    c_miss += in && !hit;
  }
  if (c_dump) {
    if (hist) {
      atomicAdd(&s_hist[hw - 1], (uint32_t)c_dump);
    } else {
      const int64_t cell = p.dump_row * p.ring;
      if (cell < 0 || cell >= p.n_cells) atomicOr(p.err, kErrIngestCell);
      else atomicAdd(&p.counts[cell], c_dump);
    }
  }
  if (hist) {
    __syncthreads();  // every record of the chunk counted
    const int64_t c0 = s_pane[2];
    for (int32_t e = threadIdx.x; e < hw; e += kIngestThreads) {
      const uint32_t c = s_hist[e];
      if (c == 0) continue;
      const int64_t cell = e == hw - 1 ? p.dump_row * p.ring : (int64_t)e * p.ring + c0;
      if (cell < 0 || cell >= p.n_cells) atomicOr(p.err, kErrIngestCell);
      else atomicAdd(&p.counts[cell], (int32_t)c);
    }
  }
  if (p.stats == nullptr) return;  // the same for every thread of the grid
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
    for (int w = 0; w < kIngestWarps; ++w) sum += s_part[threadIdx.x][w];
    // words 0, 1, 2 and 4 (3 and 5 are the reference's ring head)
    const int word = threadIdx.x < 3 ? threadIdx.x : 4;
    if (sum) atomicAdd(&p.stats[word], sum);
  }
}

// one form's launch: a block a chunk, the histogram's shared memory
// allowed past 48 KB once a device
template <bool kGen>
int launch_ingest(const IngestParams& p, cudaStream_t stream) {
  if (p.n <= 0) return (int)cudaGetLastError();
  static bool smem_set[64];
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    rc = (int)cudaFuncSetAttribute(devgen_ingest_kernel<kGen>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kHistWords * (int)sizeof(uint32_t));
    if (rc) return rc;
    smem_set[dev] = true;
  }
  const int64_t blocks = (p.n + kIngestChunk - 1) / kIngestChunk;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = p.key_domain >= 0 && p.key_domain + 1 <= kHistWords
                          ? (size_t)(p.key_domain + 1) * 4
                          : 0;
  devgen_ingest_kernel<kGen><<<(unsigned)blocks, kIngestThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the generator's arguments, as the wrappers check them
bool bad_gen(int64_t n, int64_t logical, int64_t off, int64_t events_per_ms, int64_t hot_ratio,
             int64_t n_hot, int64_t n_auctions) {
  return n < 0 || logical < 0 || off < 0 || events_per_ms < 1 || hot_ratio < 1 || n_hot < 1 ||
         n_hot >= (1ll << 31) || n_auctions < 1 || n_auctions >= (1ll << 31);
}

IngestParams ingest_params(int32_t* counts, int64_t n_cells, int64_t n, int64_t key_domain,
                           int64_t pane_ms, int64_t offset_ms, int32_t ring, int64_t dead_below,
                           int64_t refire_below, int64_t dump_row, int32_t* stats, int32_t* err) {
  IngestParams p{};
  p.counts = counts;
  p.n_cells = n_cells;
  p.n = n;
  p.key_domain = key_domain;
  p.pane_ms = pane_ms;
  p.offset_ms = offset_ms;
  p.ring = ring;
  p.dead_below = dead_below;
  p.refire_below = refire_below;
  p.dump_row = dump_row;
  p.stats = stats;
  p.err = err;
  return p;
}

}  // namespace

extern "C" {

const char* dg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int dg_nexmark_bids(int64_t* keys, int64_t* ts, int64_t n, int64_t logical, int64_t off,
                    int64_t batch_total, int64_t events_per_ms, int64_t hot_ratio,
                    int64_t n_hot, int64_t n_auctions, void* stream) {
  if (bad_gen(n, logical, off, events_per_ms, hot_ratio, n_hot, n_auctions))
    return (int)cudaErrorInvalidValue;
  if (n > 0)
    nexmark_bids_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        keys, ts, n,
        nexmark_gen(logical, off, batch_total, events_per_ms, hot_ratio, n_hot, n_auctions, 0));
  return (int)cudaGetLastError();
}

int dg_devgen_ingest(int32_t* counts, int64_t n_cells, const int64_t* keys, const int64_t* ts,
                     int64_t n, int64_t key_domain, int64_t pane_ms, int64_t offset_ms,
                     int32_t ring, int64_t dead_below, int64_t refire_below, int64_t dump_row,
                     int32_t* stats, int32_t* err, void* stream) {
  IngestParams p = ingest_params(counts, n_cells, n, key_domain, pane_ms, offset_ms, ring,
                                 dead_below, refire_below, dump_row, stats, err);
  p.keys = keys;
  p.ts = ts;
  return launch_ingest<false>(p, (cudaStream_t)stream);
}

// devgen_ingest on records [off, off + n) of logical batch `logical` of
// the Nexmark bid stream (dg_nexmark_bids' arguments), made in registers
int dg_devgen_ingest_nexmark(int32_t* counts, int64_t n_cells, int64_t n, int64_t logical,
                             int64_t off, int64_t batch_total, int64_t events_per_ms,
                             int64_t hot_ratio, int64_t n_hot, int64_t n_auctions,
                             int64_t key_domain, int64_t pane_ms, int64_t offset_ms, int32_t ring,
                             int64_t dead_below, int64_t refire_below, int64_t dump_row,
                             int32_t* stats, int32_t* err, void* stream) {
  if (bad_gen(n, logical, off, events_per_ms, hot_ratio, n_hot, n_auctions))
    return (int)cudaErrorInvalidValue;
  IngestParams p = ingest_params(counts, n_cells, n, key_domain, pane_ms, offset_ms, ring,
                                 dead_below, refire_below, dump_row, stats, err);
  p.gen = nexmark_gen(logical, off, batch_total, events_per_ms, hot_ratio, n_hot, n_auctions,
                      n + kIngestChunk);
  return launch_ingest<true>(p, (cudaStream_t)stream);
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

// dg_devgen_ingest_nexmark from one packed block of 19 64-bit words
int dg_devgen_ingest_nexmark_packed(const int64_t* a, void* stream) {
  return dg_devgen_ingest_nexmark(
      (int32_t*)(intptr_t)a[0], (int64_t)a[1], (int64_t)a[2], (int64_t)a[3], (int64_t)a[4],
      (int64_t)a[5], (int64_t)a[6], (int64_t)a[7], (int64_t)a[8], (int64_t)a[9], (int64_t)a[10],
      (int64_t)a[11], (int64_t)a[12], (int32_t)a[13], (int64_t)a[14], (int64_t)a[15],
      (int64_t)a[16], (int32_t*)(intptr_t)a[17], (int32_t*)(intptr_t)a[18], stream);
}

}  // extern "C"
