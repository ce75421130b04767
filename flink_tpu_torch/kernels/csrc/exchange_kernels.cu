// Kernels of the key-sharded window operator's keyBy exchange,
// hand-written for Hopper (sm_90a). Plain C interface, bound from Python
// with ctypes (flink_tpu_torch/kernels/exchange_kernels.py); every entry
// point launches on the caller's stream, allocates nothing (the wrapper
// passes scratch) and returns cudaGetLastError().
//
// X1 bucket_records  replaces flink_tpu/exchange/keyby.py:37
//                    bucket_by_destination, with the routing and the
//                    rebase of flink_tpu/ops/window.py:1483 apply_shard
//                    (:1485-1503)
// X2 hash_keys       replaces flink_tpu/records.py:204 hash_keys_device
//
// Both are integer work and pure copies, so the kernel, the plain
// PyTorch version beside it and the JAX reference agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_common.cuh"

namespace {

// destinations one launch can bucket for (shared-memory tables;
// exchange_kernels.py MAX_DEST)
constexpr int kMaxDest = 64;

// A packed cell ``slot * ring + col`` is valid when it lies inside the
// mesh's slots: [0, n_dest * spd * ring). Anything else (-1, or the row
// past every block that the split upload's decode gives an invalid
// record) is dropped, as the reference's bucket drops an invalid row.
// Cells are int32, or int64 once the mesh's cells reach 2^31 (the
// operator's upload switches where the reference's does); a bucket's
// cells take the type of the upload's.
__device__ __forceinline__ int32_t dest_of(int64_t c, int64_t n_cells, int32_t ring, int32_t spd,
                                           int32_t n_dest) {
  if (c < 0 || c >= n_cells) return n_dest;
  return (int32_t)((c / ring) / spd);
}

// ---- X1: bucket_records ------------------------------------------------------
// One source block's records into (n_dest, cap) buckets by owner block:
// record i with cell c = slot * ring + col goes to destination
// d = slot / spd, written already rebased to d's block as
// (slot - d * spd) * ring + col, with its payload row (C 32-bit words,
// the lifted lanes). Within a bucket the records keep their arrival
// order (a stable counting sort), so each owner's scatter folds its
// records in batch order and its f32 sums are those of a one-block run.
// Records past a bucket's capacity are dropped and counted: overflow[d]
// = max(count_d - cap, 0). Positions past a bucket's records hold cell
// -1, valid 0 and a zero payload. The reference gets the same buckets
// from a stable argsort by destination, a bincount, exclusive starts and
// a scatter; an atomic slot cursor would give them in another order.
//
// Bound: bytes — the cells and payload read once, the buckets (every
// position, filled or not: the padded layout the exchange moves)
// written once. Design, two launches on one stream over tiles of kTile
// records, each thread owning kItems consecutive records:
//   A  each tile's count per destination (shared-memory atomics, order-
//      free) into tile_counts (n_tiles x n_dest);
//   B  each tile sums the counts of the tiles before it per destination
//      (one warp per destination), ranks its records per destination
//      with a block scan in thread order, and writes each record at its
//      bucket position; then the tiles fill the positions past every
//      bucket's records in a grid-stride loop. Block 0 writes overflow.

template <typename Cell>
__global__ void bucket_count_kernel(const Cell* __restrict__ cells, int64_t B, int32_t n_dest,
                                    int32_t ring, int32_t spd,
                                    int32_t* __restrict__ tile_counts) {
  __shared__ int s_h[kMaxDest];
  for (int d = threadIdx.x; d < n_dest; d += blockDim.x) s_h[d] = 0;
  __syncthreads();
  const int64_t n_cells = (int64_t)n_dest * spd * ring;
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    if (i >= B) break;
    const int32_t d = dest_of(cells[i], n_cells, ring, spd, n_dest);
    if (d < n_dest) atomicAdd(&s_h[d], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_dest; d += blockDim.x) {
    tile_counts[(int64_t)blockIdx.x * n_dest + d] = s_h[d];
  }
}

template <typename Cell>
__global__ void bucket_write_kernel(const Cell* __restrict__ cells,
                                    const int32_t* __restrict__ payload, int64_t B, int32_t C,
                                    int32_t n_dest, int32_t cap, int32_t ring, int32_t spd,
                                    const int32_t* __restrict__ tile_counts, int32_t n_tiles,
                                    Cell* __restrict__ out_cells,
                                    int32_t* __restrict__ out_payload,
                                    uint8_t* __restrict__ out_valid,
                                    int32_t* __restrict__ overflow) {
  __shared__ int s_before[kMaxDest];
  __shared__ int s_fill[kMaxDest];
  __shared__ int s_scan[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = warp; d < n_dest; d += kWarps) {
    long long before = 0, total = 0;
    for (int32_t t = lane; t < n_tiles; t += 32) {
      const int v = tile_counts[(int64_t)t * n_dest + d];
      total += v;
      if (t < (int32_t)blockIdx.x) before += v;
    }
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, o);
      total += __shfl_xor_sync(0xffffffffu, total, o);
    }
    if (lane == 0) {
      s_before[d] = (int)before;
      s_fill[d] = (int)(total < cap ? total : cap);
      if (blockIdx.x == 0) overflow[d] = (int32_t)(total > cap ? total - cap : 0);
    }
  }
  __syncthreads();
  const int64_t n_cells = (int64_t)n_dest * spd * ring;
  const int64_t base = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int32_t dst[kItems];
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    dst[j] = i < B ? dest_of(cells[i], n_cells, ring, spd, n_dest) : n_dest;
  }
  for (int32_t d = 0; d < n_dest; ++d) {
    int mine = 0;
    for (int j = 0; j < kItems; ++j) mine += dst[j] == d;
    // collective: every thread takes part for every destination
    int pos = s_before[d] + block_exclusive_scan(mine, s_scan);
    if (mine == 0) continue;
    for (int j = 0; j < kItems; ++j) {
      if (dst[j] != d) continue;
      if (pos < cap) {
        const int64_t i = base + j;
        const int64_t c = cells[i];
        const int64_t slot = c / ring;
        const int64_t o = (int64_t)d * cap + pos;
        out_cells[o] = (Cell)((slot - (int64_t)d * spd) * ring + (c - slot * ring));
        out_valid[o] = 1;
        for (int32_t k = 0; k < C; ++k) out_payload[o * C + k] = payload[i * C + k];
      }
      ++pos;
    }
  }
  const int64_t total = (int64_t)n_dest * cap;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; f < total; f += stride) {
    const int32_t d = (int32_t)(f / cap);
    if (f - (int64_t)d * cap < s_fill[d]) continue;
    out_cells[f] = -1;
    out_valid[f] = 0;
    for (int32_t k = 0; k < C; ++k) out_payload[f * C + k] = 0;
  }
}

// ---- X2: hash_keys -----------------------------------------------------------
// The splitmix64 finalizer of each int64 key (its bits as uint64), masked
// to 63 bits: hash_keys_numpy's mix. Bound: bytes — 8 read and 8 written
// a key. One thread per key.
__global__ void hash_keys_kernel(const int64_t* __restrict__ keys, int64_t n,
                                 int64_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint64_t x = (uint64_t)keys[i];
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    x ^= x >> 31;
    out[i] = (int64_t)(x & 0x7FFFFFFFFFFFFFFFull);
  }
}

// one source block's buckets: the two launches
template <typename Cell>
int bucket_records(const Cell* cells, const int32_t* payload, int64_t B, int32_t C,
                   int32_t n_dest, int32_t cap, int32_t ring, int32_t spd, int32_t* tile_counts,
                   Cell* out_cells, int32_t* out_payload, uint8_t* out_valid, int32_t* overflow,
                   cudaStream_t s) {
  int64_t t = (B + kTile - 1) / kTile;
  const int32_t n_tiles = (int32_t)(t < 1 ? 1 : t);
  bucket_count_kernel<Cell><<<n_tiles, kThreads, 0, s>>>(cells, B, n_dest, ring, spd,
                                                         tile_counts);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bucket_write_kernel<Cell><<<n_tiles, kThreads, 0, s>>>(cells, payload, B, C, n_dest, cap, ring,
                                                         spd, tile_counts, n_tiles, out_cells,
                                                         out_payload, out_valid, overflow);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* xk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// scratch: tile_counts (max(1, ceil(B / kTile)) * n_dest int32); cells
// and out_cells are int32 (cell_bytes 4) or int64 (8)
int xk_bucket_records(const void* cells, int32_t cell_bytes, const int32_t* payload, int64_t B,
                      int32_t C, int32_t n_dest, int32_t cap, int32_t ring, int32_t spd,
                      int32_t* tile_counts, void* out_cells, int32_t* out_payload,
                      uint8_t* out_valid, int32_t* overflow, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cell_bytes == 8)
    return bucket_records<int64_t>((const int64_t*)cells, payload, B, C, n_dest, cap, ring, spd,
                                   tile_counts, (int64_t*)out_cells, out_payload, out_valid,
                                   overflow, s);
  if (cell_bytes == 4)
    return bucket_records<int32_t>((const int32_t*)cells, payload, B, C, n_dest, cap, ring, spd,
                                   tile_counts, (int32_t*)out_cells, out_payload, out_valid,
                                   overflow, s);
  return (int)cudaErrorInvalidValue;
}

int xk_hash_keys(const int64_t* keys, int64_t n, int64_t* out, void* stream) {
  if (n > 0) {
    hash_keys_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(keys, n, out);
  }
  return (int)cudaGetLastError();
}

// the lean launch path (window_kernels.py LeanEntry): each entry
// above from one packed block of 64-bit words, the stream beside
// xk_bucket_records from one packed block of 14 64-bit words
int xk_bucket_records_packed(const int64_t* a, void* stream) {
  return xk_bucket_records(
      (const void*)(intptr_t)a[0], (int32_t)a[1], (const int32_t*)(intptr_t)a[2], (int64_t)a[3],
      (int32_t)a[4], (int32_t)a[5], (int32_t)a[6], (int32_t)a[7], (int32_t)a[8],
      (int32_t*)(intptr_t)a[9], (void*)(intptr_t)a[10], (int32_t*)(intptr_t)a[11],
      (uint8_t*)(intptr_t)a[12], (int32_t*)(intptr_t)a[13], stream);
}

// xk_hash_keys from one packed block of 3 64-bit words
int xk_hash_keys_packed(const int64_t* a, void* stream) {
  return xk_hash_keys(
      (const int64_t*)(intptr_t)a[0], (int64_t)a[1], (int64_t*)(intptr_t)a[2], stream);
}

}  // extern "C"
