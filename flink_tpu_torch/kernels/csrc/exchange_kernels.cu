// Kernels of the key-sharded window operator's keyBy exchange,
// hand-written for Hopper (sm_90a). Plain C interface, bound from Python
// with ctypes (flink_tpu_torch/kernels/exchange_kernels.py); every entry
// point launches on the caller's stream, allocates nothing (the wrapper
// passes its clean workspace) and returns cudaGetLastError().
//
// X1 bucket_records  replaces flink_tpu/exchange/keyby.py:37
//                    bucket_by_destination, with the routing and the
//                    rebase of flink_tpu/ops/window.py:1483 apply_shard
//                    (:1485-1503) and, in its split form, the decode of
//                    :1523 apply_shard_split; on blocks of one card its
//                    direct form also replaces keyby.py:75
//                    all_to_all_records' copies
// X2 hash_keys       replaces flink_tpu/records.py:204 hash_keys_device
//
// Both are integer work and pure copies, so the kernel, the plain
// PyTorch version beside it and the JAX reference agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"
#include "window_common.cuh"

namespace {

// destinations one launch can bucket for (shared-memory tables;
// exchange_kernels.py MAX_DEST)
constexpr int kMaxDest = 64;
// bits of a destination id, the invalid id (n_dest) included: 3 up to
// 7 destinations, else 7 (the kernel's NB)
constexpr int kDestBits = 7;
// a tile's (step, warp) counts: one warp scan a destination
static_assert(kItems * kWarps == 32, "bucket_records scans 32 (step, warp) counts a warp");

// ---- X1: bucket_records ------------------------------------------------------
// One source block's records into a row a destination by owner block:
// record i with cell c goes to destination d = c / (spd * ring) (its
// slot's owner), written already rebased to d's block as c - d * spd *
// ring, with its payload row (C 32-bit words, the lifted lanes). A cell
// outside [0, n_dest * spd * ring) (-1, or the row past every block that
// the split upload's decode gives an invalid record) goes nowhere. Within
// a row the records keep their arrival order (a stable counting sort), so
// each owner's scatter folds its records in batch order and its f32 sums
// are those of a one-block run. Records past a row's capacity are dropped
// and counted: overflow[d] = max(count_d - cap, 0). Positions past a row's
// records hold cell -1, valid 0 and a zero payload. Row d starts at
// record d * dstride of the outputs: dstride = cap gives the padded
// (n_dest, cap) buckets; on blocks of one card the operator passes row j
// of an (n_dest, n_src, cap) receive allocation and dstride = n_src * cap,
// so source j writes straight into each owner's receive row j and the
// exchange copies nothing. Cells are int32, or int64 once the mesh's
// cells reach 2^31 (the operator's upload switches where the reference's
// does). The split form (kSplit) reads the split upload's 3 bytes a record
// instead and decodes each where the rank step loads it (window_common.cuh
// SplitRecords, K7's rule) with the row past every block, n_dest * spd,
// as the dump row: slot 0xFFFF and slot n_dest * spd decode past every
// block and go nowhere, a slot beyond or a column past the ring sets
// kErrSplitCell in the device's error word and goes nowhere too; the
// output cells are int32, as split_cells' then the flat form's.
//
// Bound: bytes — the cells and payload read once, every row position
// (filled or not: the padded layout the owners read) written once.
//
// Design: one cooperative launch of persistent blocks (at most what the
// card holds at once), each walking tiles of kTile records (tile t,
// t + grid, ...):
//   rank    a thread loads kItems records at a stride of kThreads
//           (neighbouring threads, neighbouring records). Each warp splits
//           its 32 records of one step by destination with a ballot a bit
//           of the destination id (a lane's peers: the AND of the ballots
//           it matches), so a record's rank among its warp's peers is a
//           popcount, and the lowest of them writes the warp's count. The
//           step is issue-bound (1.7 of M1's 7.2 us in %globaltimer
//           stamps on the H100, PERF.md §6): ids take 3 bits up to 7
//           destinations, the division by a block's cells is a multiply
//           (FastDiv). One warp scan a
//           destination over the tile's (step, warp) counts gives each
//           record its place in the tile's run for its destination, in
//           arrival order: no scan a destination over the whole tile.
//   place   the tile publishes its count a destination through the
//           decoupled look-back (lookback.cuh's descriptors, a tile's
//           n_dest on whole 128-byte lines, bucket_lookback below: every
//           thread polls kLbReach (predecessor, destination) pairs at
//           once) and takes each destination's offset from the tiles
//           before it.
//   store   records staged in shared memory grouped by destination
//           (cell, source index), then each destination's run stored
//           contiguously: cells and valid bytes by consecutive threads,
//           payload rows as whole rows, word by word.
//   pad     each block waits for the last tile's inclusive counts (every
//           block is resident: the cooperative launch), then the grid
//           fills each row past its records with 16-byte stores. Each
//           tile padding its own share of the rows right after its
//           look-back (no wait) measured slower on the H100: 0.0098
//           against 0.0084 ms at M1's block (PERF.md §6).
// The last tile writes the overflow and advances the workspace's epoch.
// The workspace (exchange_kernels.py bucket_work_words: the epoch on its
// own line, then a tile's descriptors on whole lines) starts zeroed and no
// call clears it (lookback.cuh).

__host__ __device__ __forceinline__ int64_t bucket_desc_stride(int32_t n_dest) {
  return (n_dest + kLbLine - 1) / kLbLine * kLbLine;
}

template <typename Cell>
struct BucketParams {
  const Cell* cells;
  SplitRecords split;   // the split form's records (kSplit)
  int32_t* err;         // the device's error word (the split form's bit)
  const uint32_t* payload;
  int64_t B;
  int32_t C, n_dest, dbits, cap;
  bool narrow;          // int32 cells, block_cells < 2^32: by_block divides
  FastDiv by_block;
  int64_t block_cells;  // spd * ring: one block's cells
  int64_t n_cells;      // n_dest * block_cells
  int64_t dstride;      // records from one destination's row to the next
  Cell* out_cells;
  uint32_t* out_payload;
  uint8_t* out_valid;
  int32_t* overflow;
  uint32_t* epoch;
  unsigned long long* desc;
  int64_t tstride;  // descriptor words a tile
  int64_t tiles;
};

// predecessors a thread polls a look-back round, all in flight at once
constexpr int kLbReach = 4;

// The exclusive count of each destination's records in the tiles before
// ``tile`` (into s_excl), given this tile's own counts s_tot (already
// published as aggregates); then this tile's inclusive counts. Thread i
// polls, for destination x = i mod Dp, the predecessors at distances q +
// r * P (r < kLbReach; q = i / Dp, Dp = 2^dbits >= n_dest, P = kThreads /
// Dp) from the round's first, so a round reaches kLbReach * P tiles back
// (256 at M1's 4 destinations: its 256 tiles in one round); each
// destination stops at its nearest inclusive descriptor. The lanes of one
// destination share a warp where Dp <= 32 and reduce by shuffles.
__device__ void bucket_lookback(unsigned long long* __restrict__ desc, int64_t tstride,
                                int64_t tile, int32_t D, int32_t dbits, uint32_t epoch,
                                const int* s_tot, long long* s_excl, unsigned long long* s_acc,
                                int* s_near) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int Dp = 1 << dbits, x = tid & (Dp - 1), q = tid >> dbits, P = kThreads >> dbits;
  const int reach = P * kLbReach;
  if (tid < D) s_acc[tid] = 0;
  bool done = tile == 0 || x >= D;
  int64_t p0 = tile - 1;
  __syncthreads();
  while (__syncthreads_or(!done)) {
    if (tid < D) s_near[tid] = reach;
    __syncthreads();
    unsigned long long w[kLbReach];
    int near = reach;
    if (!done) {
#pragma unroll
      for (int r = 0; r < kLbReach; ++r) {
        const int64_t pt = p0 - q - r * P;
        // before the first tile: an inclusive count of 0
        w[r] = pt >= 0 ? lb_load(desc + pt * tstride + x) : lb_word(epoch, kLbInc, 0);
      }
#pragma unroll
      for (int r = 0; r < kLbReach; ++r) {
        const int64_t pt = p0 - q - r * P;
        while (!lb_published(w[r], epoch)) w[r] = lb_load(desc + pt * tstride + x);
        if ((w[r] & kLbInc) && q + r * P < near) near = q + r * P;
      }
    }
    for (int o = 16; o >= Dp; o >>= 1) near = min(near, __shfl_xor_sync(0xffffffffu, near, o));
    if (!done && lane < Dp) atomicMin(&s_near[x], near);
    __syncthreads();
    const int nr = x < D ? s_near[x] : reach;
    long long add = 0;
    if (!done)
#pragma unroll
      for (int r = 0; r < kLbReach; ++r)
        if (q + r * P <= nr) add += (long long)(w[r] & kLbCount);
    for (int o = 16; o >= Dp; o >>= 1) add += __shfl_xor_sync(0xffffffffu, add, o);
    if (!done && lane < Dp && add) atomicAdd(&s_acc[x], (unsigned long long)add);
    if (nr < reach) done = true;
    p0 -= reach;
  }
  if (tid < D) {
    s_excl[tid] = (long long)s_acc[tid];
    if (tile > 0)
      lb_store(desc + tile * tstride + tid,
               lb_word(epoch, kLbInc, (long long)s_acc[tid] + s_tot[tid]));
  }
  __syncthreads();
}

// n bytes from p set to the byte of ``word`` (0x00 or 0xFF in every
// byte), the grid's threads (t of stride) taking 16-byte stores for the
// aligned body
__device__ __forceinline__ void fill_bytes(uint8_t* p, int64_t n, uint32_t word, int64_t t,
                                           int64_t stride) {
  const int64_t lead = (int64_t)((16 - ((uintptr_t)p & 15)) & 15);
  const int64_t head = lead < n ? lead : n;
  for (int64_t i = t; i < head; i += stride) p[i] = (uint8_t)word;
  uint4* body = (uint4*)(p + head);
  const int64_t nb = (n - head) >> 4;
  const uint4 v = make_uint4(word, word, word, word);
  for (int64_t i = t; i < nb; i += stride) body[i] = v;
  for (int64_t i = head + (nb << 4) + t; i < n; i += stride) p[i] = (uint8_t)word;
}

template <typename Cell, int NB, bool kSplit>
__global__ void __launch_bounds__(kThreads) bucket_records_kernel(const BucketParams<Cell> p) {
  __shared__ Cell s_cell[kTile];
  __shared__ uint16_t s_src[kTile];
  __shared__ uint8_t s_dst[kTile];
  // a (step, warp)'s count a destination, then its offset in the tile's run
  __shared__ int s_wcnt[kItems * kWarps * kMaxDest];
  __shared__ int s_tot[kMaxDest], s_toff[kMaxDest + 1], s_near[kMaxDest];
  __shared__ long long s_excl[kMaxDest], s_fill[kMaxDest];
  __shared__ unsigned long long s_acc[kMaxDest];
  __shared__ uint32_t s_epoch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t D = p.n_dest, C = p.C;
  const int64_t cap = p.cap;
  const unsigned lt = (1u << lane) - 1;
  // a (step, warp)'s counts start at 0 (each tile clears them after use)
  const int wcnt_words = kItems * kWarps * D;
  for (int e = tid; e < wcnt_words; e += kThreads) s_wcnt[e] = 0;
  if (tid == 0) s_epoch = __ldcg(p.epoch);
  __syncthreads();
  for (int64_t tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int64_t base = tile * kTile;
    Cell c[kItems];
    if constexpr (kSplit) {
      // a byte load each, neighbouring threads on neighbouring records: a
      // warp's loads cover its 96 bytes in one or two sectors (a tile
      // staged in shared memory by 16-byte copies, and a warp's words
      // passed on by shuffles, each measured slower at M1's block)
      int32_t raw[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int64_t i = base + j * kThreads + tid;
        raw[j] = i < p.B ? (int32_t)p.split.load(i) : -1;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        c[j] = raw[j] < 0 ? (Cell)-1 : (Cell)p.split.cell(raw[j]);
        if (raw[j] >= 0 && c[j] < 0) atomicOr(p.err, kErrSplitCell);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int64_t i = base + j * kThreads + tid;
        c[j] = i < p.B ? p.cells[i] : (Cell)-1;
      }
    }
    int32_t d[kItems], rank[kItems];
    Cell local[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t v = (int64_t)c[j];
      d[j] = D;
      local[j] = 0;
      if (v >= 0 && v < p.n_cells) {
        const int64_t q = p.narrow ? (int64_t)div_of((uint32_t)v, p.by_block)
                                   : v / p.block_cells;
        d[j] = (int32_t)q;
        local[j] = (Cell)(v - q * p.block_cells);
      }
      unsigned peers = 0xffffffffu;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const unsigned bal = __ballot_sync(0xffffffffu, (d[j] >> b) & 1);
        peers &= ((d[j] >> b) & 1) ? bal : ~bal;
      }
      const unsigned below = peers & lt;
      rank[j] = __popc(below);
      // the lowest lane of each destination's peers writes the warp's count
      if (below == 0 && d[j] < D) s_wcnt[(j * kWarps + warp) * D + d[j]] = __popc(peers);
    }
    __syncthreads();
    const uint32_t epoch = s_epoch;
    // each destination's (step, warp) counts to offsets in the tile's run
    for (int32_t x = warp; x < D; x += kWarps) {
      const int v = s_wcnt[lane * D + x];
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += n;
      }
      s_wcnt[lane * D + x] = incl - v;
      if (lane == 31) s_tot[x] = incl;
    }
    __syncthreads();
    if (tid < D) lb_store(p.desc + tile * p.tstride + tid,
                          lb_word(epoch, tile ? kLbAgg : kLbInc, s_tot[tid]));
    if (warp == 0) {
      // the runs' starts in the tile, destination order
      const int a = lane < D ? s_tot[lane] : 0;
      const int b = lane + 32 < D ? s_tot[lane + 32] : 0;
      int ia = a, ib = b;
      for (int o = 1; o < 32; o <<= 1) {
        const int na = __shfl_up_sync(0xffffffffu, ia, o);
        const int nb = __shfl_up_sync(0xffffffffu, ib, o);
        if (lane >= o) {
          ia += na;
          ib += nb;
        }
      }
      const int half = __shfl_sync(0xffffffffu, ia, 31);
      s_toff[lane] = ia - a;
      s_toff[lane + 32] = half + ib - b;
      if (lane == 31) s_toff[kMaxDest] = half + ib;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (d[j] < D) {
        const int s = s_toff[d[j]] + s_wcnt[(j * kWarps + warp) * D + d[j]] + rank[j];
        s_cell[s] = local[j];
        s_src[s] = (uint16_t)(j * kThreads + tid);
        s_dst[s] = (uint8_t)d[j];
      }
    }
    bucket_lookback(p.desc, p.tstride, tile, D, p.dbits, epoch, s_tot, s_excl, s_acc, s_near);
    for (int e = tid; e < wcnt_words; e += kThreads) s_wcnt[e] = 0;
    if (tile == p.tiles - 1) {
      if (tid < D) {
        const long long over = s_excl[tid] + s_tot[tid] - cap;
        p.overflow[tid] = (int32_t)(over > 0 ? over : 0);
      }
      // every tile has read the epoch: each published a descriptor
      if (tid == 0) lb_advance(p.epoch, epoch);
    }
    const int tile_n = s_toff[kMaxDest];
    for (int s = tid; s < tile_n; s += kThreads) {
      const int x = s_dst[s];
      const int64_t pos = s_excl[x] + (s - s_toff[x]);
      if (pos < cap) {
        const int64_t o = x * p.dstride + pos;
        p.out_cells[o] = s_cell[s];
        p.out_valid[o] = 1;
      }
    }
    if (C > 0) {
      const int32_t words = tile_n * C;
      for (int32_t w = tid; w < words; w += kThreads) {
        const int s = w / C, k = w - s * C;
        const int x = s_dst[s];
        const int64_t pos = s_excl[x] + (s - s_toff[x]);
        if (pos < cap)
          p.out_payload[(x * p.dstride + pos) * C + k] = p.payload[(base + s_src[s]) * C + k];
      }
    }
    __syncthreads();  // the next tile reuses the shared tables
  }
  // every row's records end at the last tile's inclusive count
  if (tid < D) {
    const uint32_t epoch = s_epoch;
    unsigned long long w;
    do {
      w = lb_load(p.desc + (p.tiles - 1) * p.tstride + tid);
    } while (!lb_published(w, epoch) || !(w & kLbInc));
    const long long total = (long long)(w & kLbCount);
    s_fill[tid] = total < cap ? total : cap;
  }
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * kThreads + tid;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int32_t x = 0; x < D; ++x) {
    const int64_t f = s_fill[x], n = cap - f;
    if (n <= 0) continue;
    const int64_t o = x * p.dstride + f;
    fill_bytes((uint8_t*)(p.out_cells + o), n * (int64_t)sizeof(Cell), 0xFFFFFFFFu, t, stride);
    fill_bytes(p.out_valid + o, n, 0u, t, stride);
    if (C > 0) fill_bytes((uint8_t*)(p.out_payload + o * C), n * C * 4, 0u, t, stride);
  }
}

// the blocks of bucket_records_kernel<Cell, NB, kSplit> the card holds at
// once, cached a device
template <typename Cell, int NB, bool kSplit>
int bucket_capacity() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      bucket_records_kernel<Cell, NB, kSplit>,
                                                      kThreads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
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

inline int bits_for(int32_t v) {  // bits of the ids 0..v
  int b = 0;
  while ((1 << b) <= v) ++b;
  return b;
}

// one cooperative launch of at most the blocks the card holds at once
template <typename Cell, bool kSplit>
int bucket_launch(const BucketParams<Cell>& p, bool few, cudaStream_t s) {
  const int fit = few ? bucket_capacity<Cell, 3, kSplit>()
                      : bucket_capacity<Cell, kDestBits, kSplit>();
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(p.tiles < fit ? p.tiles : fit);
  void* args[] = {(void*)&p};
  const void* kernel = few ? (const void*)bucket_records_kernel<Cell, 3, kSplit>
                           : (const void*)bucket_records_kernel<Cell, kDestBits, kSplit>;
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0, s);
}

// split: the records are the split upload's (B, 3) bytes (cells then
// points at them; Cell int32), decoded with n_dest * spd as the dump row
template <typename Cell>
int bucket_records(const Cell* cells, bool split, const uint32_t* payload, int64_t B, int32_t C,
                   int32_t n_dest, int32_t cap, int32_t ring, int32_t spd, int64_t* work,
                   int64_t work_words, Cell* out_cells, uint32_t* out_payload,
                   uint8_t* out_valid, int32_t* overflow, int64_t dstride, int32_t* err,
                   cudaStream_t s) {
  if (n_dest < 1 || n_dest > kMaxDest || cap < 1 || ring < 1 || spd < 1 || C < 0 ||
      dstride < cap || B < 0 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  // the split form: a byte's column, a 16-bit slot with n_dest * spd (the
  // dump row) below 0xFFFF, and an error word for the bit
  if (split && (sizeof(Cell) != 4 || ring > 256 || err == nullptr ||
                (int64_t)n_dest * spd >= (int64_t)kInvalidSlotU16))
    return (int)cudaErrorInvalidValue;
  BucketParams<Cell> p{};
  p.cells = split ? nullptr : cells;
  p.split = SplitRecords{split ? (const uint8_t*)cells : nullptr, ring, n_dest * spd};
  p.err = err;
  p.payload = payload;
  p.B = B;
  p.C = C;
  p.n_dest = n_dest;
  p.dbits = bits_for(n_dest - 1);
  p.cap = cap;
  p.block_cells = (int64_t)spd * ring;
  p.n_cells = p.block_cells * n_dest;
  p.narrow = sizeof(Cell) == 4 && p.block_cells <= 0xFFFFFFFFll;
  if (p.narrow) p.by_block = fast_div((uint32_t)p.block_cells);
  p.dstride = dstride;
  p.out_cells = out_cells;
  p.out_payload = out_payload;
  p.out_valid = out_valid;
  p.overflow = overflow;
  p.tiles = B > 0 ? (B + kTile - 1) / kTile : 1;
  p.tstride = bucket_desc_stride(n_dest);
  if (kLbLine + p.tiles * p.tstride > work_words) return (int)cudaErrorInvalidValue;
  p.epoch = (uint32_t*)work;
  p.desc = (unsigned long long*)(work + kLbLine);
  // destination ids in 3 bits up to 7 destinations (the invalid id is
  // n_dest), else in kDestBits
  const bool few = n_dest <= 7;
  if constexpr (sizeof(Cell) == 4)
    if (split) return bucket_launch<Cell, true>(p, few, s);
  return bucket_launch<Cell, false>(p, few, s);
}

}  // namespace

extern "C" {

const char* xk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// work: the entry point's clean workspace (exchange_kernels.py
// bucket_work_words), work_words int64 words; cells and out_cells are
// int32 (cell_bytes 4) or int64 (8), or cells the split upload's (B, 3)
// bytes (cell_bytes 3) and out_cells int32; destination d's row starts at
// record d * dstride of the outputs; err: the device's error word
int xk_bucket_records(const void* cells, int32_t cell_bytes, const uint32_t* payload, int64_t B,
                      int32_t C, int32_t n_dest, int32_t cap, int32_t ring, int32_t spd,
                      int64_t* work, int64_t work_words, void* out_cells, uint32_t* out_payload,
                      uint8_t* out_valid, int32_t* overflow, int64_t dstride, int32_t* err,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cell_bytes == 8)
    return bucket_records<int64_t>((const int64_t*)cells, false, payload, B, C, n_dest, cap,
                                   ring, spd, work, work_words, (int64_t*)out_cells,
                                   out_payload, out_valid, overflow, dstride, err, s);
  if (cell_bytes == 4 || cell_bytes == 3)
    return bucket_records<int32_t>((const int32_t*)cells, cell_bytes == 3, payload, B, C,
                                   n_dest, cap, ring, spd, work, work_words,
                                   (int32_t*)out_cells, out_payload, out_valid, overflow,
                                   dstride, err, s);
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
// xk_bucket_records from one packed block of 17 64-bit words
int xk_bucket_records_packed(const int64_t* a, void* stream) {
  return xk_bucket_records(
      (const void*)(intptr_t)a[0], (int32_t)a[1], (const uint32_t*)(intptr_t)a[2], (int64_t)a[3],
      (int32_t)a[4], (int32_t)a[5], (int32_t)a[6], (int32_t)a[7], (int32_t)a[8],
      (int64_t*)(intptr_t)a[9], (int64_t)a[10], (void*)(intptr_t)a[11],
      (uint32_t*)(intptr_t)a[12], (uint8_t*)(intptr_t)a[13], (int32_t*)(intptr_t)a[14],
      (int64_t)a[15], (int32_t*)(intptr_t)a[16], stream);
}

// xk_hash_keys from one packed block of 3 64-bit words
int xk_hash_keys_packed(const int64_t* a, void* stream) {
  return xk_hash_keys(
      (const int64_t*)(intptr_t)a[0], (int64_t)a[1], (int64_t*)(intptr_t)a[2], stream);
}

}  // extern "C"
