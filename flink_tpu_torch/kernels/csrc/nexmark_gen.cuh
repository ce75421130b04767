// The Nexmark bid generator's auction lane and event time, one record at
// a time, shared by nexmark_bids (devgen_kernels.cu K5, into device
// memory) and the Nexmark form of devgen_ingest (K6, in registers), so
// both make the same bits.
//
// Record i of a (sub-)batch is record off + i of logical batch
// `logical`: counter c = logical * 0xD1342543DE82EF95 + 1 + (off + i + 1)
// * G (native/codec.cc smx() advances the counter before mixing),
// splitmix64's mix, then a hot / cold auction by multiply-shift range
// reduction, and ts = (logical * batch_total + off + i) / events_per_ms.
// Native uint64 arithmetic: exact, equal to the plain version and to the
// JAX reference (flink_tpu/nexmark/generator.py:125) bit for bit.
// Include once, after window_common.cuh (FastDiv).
#pragma once

#include "window_common.cuh"

namespace {

struct NexmarkGen {
  uint64_t base;          // logical * 0xD1342543DE82EF95 + 1
  uint64_t off;           // the (sub-)batch's first record in its logical batch
  int64_t id0;            // logical * batch_total + off: its event id
  int64_t events_per_ms;
  uint32_t hot_mod;       // min(hot_ratio, 256): (r1 & 0xFF) % hot_ratio in 32 bits
  FastDiv hot_div;        // ... by a multiply
  uint32_t n_hot, n_auctions;
  int64_t id_q, id_r;     // id0 / events_per_ms and its remainder
  FastDiv epm_div;        // events_per_ms, for ids below 2^31 (fast_ts)
  bool fast_ts;           // events_per_ms + span <= 2^31 (nexmark_gen)
};

// the generator of the records from off of logical batch `logical`; a
// caller may take the ms of the ids up to ``span`` past id0 from id_q,
// id_r and epm_div where fast_ts holds
inline NexmarkGen nexmark_gen(int64_t logical, int64_t off, int64_t batch_total,
                              int64_t events_per_ms, int64_t hot_ratio, int64_t n_hot,
                              int64_t n_auctions, int64_t span) {
  NexmarkGen g{};
  g.base = (uint64_t)logical * 0xD1342543DE82EF95ULL + 1ULL;
  g.off = (uint64_t)off;
  g.id0 = logical * batch_total + off;
  g.events_per_ms = events_per_ms;
  // x % h == x % min(h, 256) for x < 256
  g.hot_mod = (uint32_t)(hot_ratio < 256 ? hot_ratio : 256);
  g.hot_div = fast_div(g.hot_mod);
  g.n_hot = (uint32_t)n_hot;
  g.n_auctions = (uint32_t)n_auctions;
  g.id_q = g.id0 / events_per_ms;
  g.id_r = g.id0 - g.id_q * events_per_ms;
  g.fast_ts = events_per_ms + span <= (1ll << 31);
  g.epm_div = fast_div(g.fast_ts ? (uint32_t)events_per_ms : 1u);
  return g;
}

constexpr uint64_t kNexmarkGamma = 0x9E3779B97F4A7C15ULL;

// record i's counter; record i + d's is this plus d * kNexmarkGamma
__device__ __forceinline__ uint64_t nexmark_counter(const NexmarkGen& g, uint64_t i) {
  return g.base + (g.off + i) * kNexmarkGamma + kNexmarkGamma;
}

// the auction of the record with counter z
__device__ __forceinline__ int64_t nexmark_key_of(const NexmarkGen& g, uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  const uint64_t r1 = z ^ (z >> 31);
  const uint32_t lo = (uint32_t)(r1 & 0xFF);
  const bool hot = lo - div_of(lo, g.hot_div) * g.hot_mod == 0;
  const uint32_t a32 = (uint32_t)(r1 >> 8);
  return (int64_t)(((uint64_t)a32 * (hot ? g.n_hot : g.n_auctions)) >> 32);
}

// record i's auction
__device__ __forceinline__ int64_t nexmark_key(const NexmarkGen& g, uint64_t i) {
  return nexmark_key_of(g, nexmark_counter(g, i));
}

// record i's event time, with one 64-bit division
__device__ __forceinline__ int64_t nexmark_ts(const NexmarkGen& g, int64_t i) {
  return (g.id0 + i) / g.events_per_ms;
}

// record i's event time (ms) and the remainder of its id, for i up to
// span past the first record: by a multiply where fast_ts holds
__device__ __forceinline__ int64_t nexmark_ms(const NexmarkGen& g, int64_t i, int64_t* rem) {
  const int64_t m = g.id_r + i;
  const int64_t q = g.fast_ts ? (int64_t)div_of((uint32_t)m, g.epm_div) : m / g.events_per_ms;
  *rem = m - q * g.events_per_ms;
  return g.id_q + q;
}

}  // namespace
