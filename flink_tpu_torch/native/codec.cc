// Host ingest codec of the PyTorch/CUDA port: the C half of the window
// operator's native lane (flink_tpu_torch/ops/window.py
// _process_batch_fused), bound with ctypes by flink_tpu_torch/native_codec.py
// and built from this file alone with g++ at first use.
//
// The port's own copy of the functions of native/codec.cc that it runs:
// the key-directory hash table, the host pre-combine, the fused
// count-only ingest scan with its three finalizes, and the text plane of
// the file formats and the socket source (the whitespace tokenizer and
// string hashes, the delimited-table parsers, the row encoder and the
// line-framed TCP reader). The CRC stays zlib's on the Python side, and
// the Nexmark generator is not ported.
//
// Interface is plain C: the Python side passes raw numpy buffers.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// int64 -> int64 open-addressing hash table: the key-directory probe loop
// (ref role: CopyOnWriteStateMap.get/put — the per-record state-map probe —
// batched and compiled; state/keyed.py _NumpyHashTable is the numpy form
// with the same probe order). The mix MUST stay bit-identical to
// flink_tpu_torch/records.py hash_keys_numpy: the key shard of a key is
// that hash modulo the shard count on every path.

static inline uint64_t ht_mix(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  x = x ^ (x >> 31);
  return x & 0x7FFFFFFFFFFFFFFFULL;
}

struct FtHashTable {
  int64_t* keys;
  int64_t* vals;
  uint8_t* used;
  uint64_t mask;   // size - 1
  int64_t count;
};

static void ht_alloc(FtHashTable* t, uint64_t size) {
  t->keys = (int64_t*)calloc(size, sizeof(int64_t));
  t->vals = (int64_t*)calloc(size, sizeof(int64_t));
  t->used = (uint8_t*)calloc(size, 1);
  t->mask = size - 1;
  t->count = 0;
}

static void ht_grow(FtHashTable* t) {
  FtHashTable old = *t;
  ht_alloc(t, (old.mask + 1) * 2);
  for (uint64_t i = 0; i <= old.mask; ++i) {
    if (!old.used[i]) continue;
    uint64_t ix = ht_mix((uint64_t)old.keys[i]) & t->mask;
    while (t->used[ix]) ix = (ix + 1) & t->mask;
    t->keys[ix] = old.keys[i];
    t->vals[ix] = old.vals[i];
    t->used[ix] = 1;
    ++t->count;
  }
  free(old.keys); free(old.vals); free(old.used);
}

void* ht_new(int64_t capacity_hint) {
  uint64_t size = 16;
  while ((int64_t)size < capacity_hint * 2) size *= 2;
  FtHashTable* t = (FtHashTable*)malloc(sizeof(FtHashTable));
  ht_alloc(t, size);
  return t;
}

void ht_free(void* h) {
  FtHashTable* t = (FtHashTable*)h;
  free(t->keys); free(t->vals); free(t->used); free(t);
}

int64_t ht_count(void* h) { return ((FtHashTable*)h)->count; }

// Batch lookup; hashes computed inline. out_vals[i] untouched-where-miss
// semantics are NOT provided: misses write -1 and out_found[i]=0 (vals may
// legitimately be negative sentinels, so found is a separate byte).
void ht_lookup(void* h, const int64_t* keys, int64_t n,
               int64_t* out_vals, uint8_t* out_found) {
  FtHashTable* t = (FtHashTable*)h;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t ix = ht_mix((uint64_t)keys[i]) & t->mask;
    for (;;) {
      if (!t->used[ix]) { out_vals[i] = -1; out_found[i] = 0; break; }
      if (t->keys[ix] == keys[i]) {
        out_vals[i] = t->vals[ix]; out_found[i] = 1; break;
      }
      ix = (ix + 1) & t->mask;
    }
  }
}

// Batch insert-or-update (keys need not be distinct; later wins).
void ht_insert(void* h, const int64_t* keys, const int64_t* vals, int64_t n) {
  FtHashTable* t = (FtHashTable*)h;
  for (int64_t i = 0; i < n; ++i) {
    if ((t->count + 1) * 2 > (int64_t)(t->mask + 1)) ht_grow(t);
    uint64_t ix = ht_mix((uint64_t)keys[i]) & t->mask;
    for (;;) {
      if (!t->used[ix]) {
        t->keys[ix] = keys[i]; t->vals[ix] = vals[i]; t->used[ix] = 1;
        ++t->count;
        break;
      }
      if (t->keys[ix] == keys[i]) { t->vals[ix] = vals[i]; break; }
      ix = (ix + 1) & t->mask;
    }
  }
}

// splitmix64 finalizer over a batch (hash_keys_numpy fast path).
void hash_keys(const int64_t* keys, int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = (int64_t)ht_mix((uint64_t)keys[i]);
}

// Host pre-aggregation combine (mini-batch local aggregation, the
// window operator's upload shrinker): histogram one microbatch per
// (slot, ring-column) pair, with optional f64-accumulated sum lanes
// per pair. ``hist`` (domain i32) and ``lane_acc`` (domain*nlanes f64)
// are caller-owned workspaces that must be ZERO on entry; every touched
// entry is reset before returning, so steady-state calls never pay a
// full-domain clear. ``lanes`` is lane-major: lanes[l*n + i].
// Returns the distinct-pair count, or -1 when it exceeds ``cap`` — in
// that case recording stopped at cap and the workspaces are left DIRTY:
// the caller must re-zero them before the next call.
int64_t preagg_combine(int64_t n, const int64_t* slots, const int64_t* panes,
                       const uint8_t* valid, int64_t ring, int64_t domain,
                       int64_t nlanes, const double* lanes,
                       int32_t* hist, double* lane_acc,
                       int32_t* out_pairs, int32_t* out_counts,
                       float* out_lanes, int64_t cap) {
  int64_t np_ = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    int64_t pm = panes[i] % ring;
    if (pm < 0) pm += ring;
    int64_t p = slots[i] * ring + pm;  // caller guarantees p < domain
    if (hist[p] == 0) {
      if (np_ >= cap) return -1;  // workspaces dirty; caller re-zeros
      out_pairs[np_++] = (int32_t)p;
    }
    hist[p] += 1;
    for (int64_t l = 0; l < nlanes; ++l)
      lane_acc[p * nlanes + l] += lanes[l * n + i];
  }
  for (int64_t j = 0; j < np_; ++j) {
    int64_t p = out_pairs[j];
    out_counts[j] = hist[p];
    hist[p] = 0;
    for (int64_t l = 0; l < nlanes; ++l) {
      out_lanes[j * nlanes + l] = (float)lane_acc[p * nlanes + l];
      lane_acc[p * nlanes + l] = 0.0;
    }
  }
  return np_;
}

// Fully-fused count-only ingest: key->slot directory probe (the open-
// addressing table above) + event-time pane + late/refire accounting +
// (slot, ring-column) histogram in ONE scan over (keys, ts) — no
// separate slots array (8 MB per 2^20 batch) is written and read again.
//
// Records whose key is NOT in the table are skipped and their indices
// written to out_miss (caller registers the new keys, then re-invokes
// over the miss subset with np_in continuing — at steady state with a
// bounded key domain the miss list is empty). Keys mapped to a
// NEGATIVE slot (directory FULL sentinel) count into n_bad exactly as
// the unfused path did.
//
// stats accumulate ACROSS calls: [n_valid, n_late, n_bad, pmin, pmax,
// n_refire, n_miss, cmax]; the caller seeds pmin=INT64_MAX,
// pmax=INT64_MIN, rest 0. Returns the running distinct-pair count, or
// -1 on pair-cap overflow / -2 on miss-cap overflow (workspace left
// dirty; caller re-zeros and falls back).
int64_t ingest_fused_scan(
    int64_t n, const int64_t* keys, const int64_t* ts, void* ht,
    int64_t pane_ms, int64_t offset_ms, int64_t ring,
    int64_t dead_below, int64_t refire_below,
    int32_t* hist, int32_t* out_pairs, int64_t np_in, int64_t cap,
    int64_t* stats, uint8_t* refire_bitmap, int64_t bitmap_base,
    int64_t bitmap_len, int64_t* out_miss, int64_t miss_cap) {
  FtHashTable* t = (FtHashTable*)ht;
  int64_t np_ = np_in, n_valid = 0, n_late = 0, n_bad = 0;
  int64_t n_refire = 0, n_miss = stats[6];
  int64_t pmin = stats[3], pmax = stats[4], cmax = stats[7];
  for (int64_t i = 0; i < n; ++i) {
    // probe first: an unknown key must reach the miss list even when
    // its record is late (registration is not drop-sensitive)
    uint64_t ix = ht_mix((uint64_t)keys[i]) & t->mask;
    int64_t slot;
    for (;;) {
      if (!t->used[ix]) { slot = INT64_MIN; break; }  // miss
      if (t->keys[ix] == keys[i]) { slot = t->vals[ix]; break; }
      ix = (ix + 1) & t->mask;
    }
    if (slot == INT64_MIN) {
      if (n_miss >= miss_cap) return -2;
      out_miss[n_miss++] = i;
      continue;
    }
    int64_t tt = ts[i] - offset_ms;
    int64_t pane = tt / pane_ms - ((tt % pane_ms) < 0 ? 1 : 0);
    if (pane < dead_below) { ++n_late; continue; }
    if (slot < 0) { ++n_bad; continue; }
    ++n_valid;
    if (pane < pmin) pmin = pane;
    if (pane > pmax) pmax = pane;
    if (pane < refire_below) {
      int64_t off = pane - bitmap_base;
      if (off >= 0 && off < bitmap_len * 8) {
        refire_bitmap[off >> 3] |= (uint8_t)(1u << (off & 7));
        ++n_refire;
      }
    }
    int64_t col = pane % ring;
    if (col < 0) col += ring;
    int64_t p = slot * ring + col;
    if (hist[p] == 0) {
      if (np_ >= cap) return -1;
      out_pairs[np_++] = (int32_t)p;
    }
    if (++hist[p] > cmax) cmax = hist[p];
  }
  stats[0] += n_valid;
  stats[1] += n_late;
  stats[2] += n_bad;
  stats[3] = pmin;
  stats[4] = pmax;
  stats[5] += n_refire;
  stats[6] = n_miss;
  stats[7] = cmax;
  return np_;
}

// Finalize a fused scan into the packed u32 upload buffer the device
// kernel consumes: out_u32[hdr + j] = (pair << 12) | count for the np_
// recorded pairs, -1 padding elsewhere (header region included — the
// pending advance fills it before dispatch). Resets every touched hist
// entry, so steady-state calls never pay a full-domain clear.
// Precondition: every count < 0xFFF (the caller checked stats[7]).
void ingest_fused_finalize_u32(
    int64_t np_, int32_t* hist, const int32_t* out_pairs,
    int32_t* out_u32, int64_t hdr, int64_t cap_out) {
  for (int64_t j = 0; j < hdr; ++j) out_u32[j] = -1;
  for (int64_t j = 0; j < np_; ++j) {
    int32_t p = out_pairs[j];
    out_u32[hdr + j] = (int32_t)(((uint32_t)p << 12) | (uint32_t)hist[p]);
    hist[p] = 0;
  }
  for (int64_t j = hdr + np_; j < hdr + cap_out; ++j) out_u32[j] = -1;
}

// Finalize a fused scan into the fused step's triple form, in place:
// ``hdr`` words of -1 (the header, filled at the advance), then
// [pair lo16, pair hi16, count] as uint16 for the np_ recorded pairs, in
// the order the scan recorded them — the real pairs only, no padding; when
// np_ is odd the last word's upper half is 0xFFFF. Resets every touched
// hist entry. The form for a count of 0xFFF or more or a pair domain
// past 20 bits. Precondition: every count <= 0xFFFF (the caller checked
// stats[7]) and every pair < 2^31.
void ingest_fused_finalize_u16(
    int64_t np_, int32_t* hist, const int32_t* out_pairs, int32_t* out,
    int64_t hdr) {
  for (int64_t j = 0; j < hdr; ++j) out[j] = -1;
  uint16_t* t = (uint16_t*)(out + hdr);
  for (int64_t j = 0; j < np_; ++j) {
    uint32_t p = (uint32_t)out_pairs[j];
    t[3 * j] = (uint16_t)(p & 0xFFFFu);
    t[3 * j + 1] = (uint16_t)(p >> 16);
    t[3 * j + 2] = (uint16_t)hist[p];
    hist[p] = 0;
  }
  if (np_ & 1) t[3 * np_] = 0xFFFFu;
}

// Finalize into separate (pairs, counts) arrays — the fallback when a
// count overflows the triples' 16-bit field (the int32 index + count
// upload).
void ingest_fused_finalize_pairs(
    int64_t np_, int32_t* hist, const int32_t* out_pairs,
    int32_t* out_counts) {
  for (int64_t j = 0; j < np_; ++j) {
    int32_t p = out_pairs[j];
    out_counts[j] = hist[p];
    hist[p] = 0;
  }
}

// ---------------------------------------------------------------------------
// Text plane: the string hash is 63-bit FNV-1a, bit-identical to
// flink_tpu_torch/records.py hash_string_key, so a key hashed here and
// one hashed in Python route alike.

static inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

static inline int64_t fnv1a63(const char* p, const char* end) {
  uint64_t h = 0xCBF29CE484222325ULL;
  for (; p < end; ++p) h = (h ^ (uint8_t)(*p)) * 0x100000001B3ULL;
  return (int64_t)(h & 0x7FFFFFFFFFFFFFFFULL);
}

// Hash every whitespace-separated token of the lines [line_offs[i],
// line_offs[i+1]) of buf: out_ids the token hashes, out_line the line of
// each. Returns the tokens written, or -1 past max_out.
int64_t tokenize_hash(const char* buf, int64_t /*len*/,
                      const int64_t* line_offs, int64_t n_lines,
                      int64_t* out_ids, int64_t* out_line,
                      int64_t max_out) {
  int64_t n = 0;
  for (int64_t li = 0; li < n_lines; ++li) {
    const char* p = buf + line_offs[li];
    const char* end = buf + line_offs[li + 1];
    for (;;) {
      while (p < end && is_space(*p)) ++p;
      if (p >= end) break;
      const char* q = p;
      while (q < end && !is_space(*q)) ++q;
      if (n >= max_out) return -1;
      out_ids[n] = fnv1a63(p, q);
      out_line[n] = li;
      ++n;
      p = q;
    }
  }
  return n;
}

// Hash the n byte strings [offs[i], offs[i+1]) of buf.
void hash_strings(const char* buf, const int64_t* offs, int64_t n,
                  int64_t* out_ids) {
  for (int64_t i = 0; i < n; ++i)
    out_ids[i] = fnv1a63(buf + offs[i], buf + offs[i + 1]);
}

// Delimited integer rows of n_cols cells: an unparseable or missing cell
// reads 0, and whatever follows the last cell on a line is skipped.
// Returns the rows parsed (at most max_rows).
int64_t parse_i64_table(const char* buf, int64_t len, char delim,
                        int64_t n_cols, int64_t* out, int64_t max_rows) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0;
  for (; p < end && row < max_rows; ++row) {
    for (int64_t c = 0; c < n_cols; ++c) {
      bool neg = p < end && *p == '-';
      if (neg) ++p;
      int64_t v = 0;
      while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
      out[row * n_cols + c] = neg ? -v : v;
      if (p < end && *p == delim) ++p;
    }
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  return row;
}

// The same framing for float32 cells: digits, an optional fraction, the
// value accumulated in double and rounded once.
int64_t parse_f32_table(const char* buf, int64_t len, char delim,
                        int64_t n_cols, float* out, int64_t max_rows) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0;
  for (; p < end && row < max_rows; ++row) {
    for (int64_t c = 0; c < n_cols; ++c) {
      bool neg = p < end && *p == '-';
      if (neg) ++p;
      double v = 0.0;
      while (p < end && *p >= '0' && *p <= '9') v = v * 10.0 + (*p++ - '0');
      if (p < end && *p == '.') {
        ++p;
        double scale = 0.1;
        for (; p < end && *p >= '0' && *p <= '9'; scale *= 0.1)
          v += (*p++ - '0') * scale;
      }
      out[row * n_cols + c] = (float)(neg ? -v : v);
      if (p < end && *p == delim) ++p;
    }
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  return row;
}

// Rows of int64 cells as delimited text, one line a row. Returns the
// bytes written, or -1 when cap is too small.
int64_t encode_i64_rows(const int64_t* vals, int64_t n_rows, int64_t n_cols,
                        char delim, char* out, int64_t cap) {
  int64_t w = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    for (int64_t c = 0; c < n_cols; ++c) {
      int64_t v = vals[r * n_cols + c];
      char tmp[24];
      int t = 0;
      if (v < 0) {
        if (w >= cap) return -1;
        out[w++] = '-';
        v = -v;
      }
      do {
        tmp[t++] = (char)('0' + v % 10);
        v /= 10;
      } while (v);
      if (w + t + 1 > cap) return -1;
      while (t) out[w++] = tmp[--t];
      out[w++] = (c + 1 < n_cols) ? delim : '\n';
    }
  }
  return w;
}

// ---------------------------------------------------------------------------
// Line-framed TCP reader of the socket source: one loopback listener, one
// connection, blocks of complete lines. The bytes after a block's last
// newline wait in the carry for the next block.

struct SockReader {
  int listen_fd;
  int conn_fd;
  char* carry;
  int64_t carry_len;
  int64_t carry_cap;
};

void* sr_listen(int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)port);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 || listen(fd, 1) != 0) {
    close(fd);
    return nullptr;
  }
  SockReader* r = (SockReader*)calloc(1, sizeof(SockReader));
  r->listen_fd = fd;
  r->conn_fd = -1;
  r->carry_cap = 1 << 16;
  r->carry = (char*)malloc(r->carry_cap);
  return r;
}

int sr_port(void* h) {
  SockReader* r = (SockReader*)h;
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(r->listen_fd, (sockaddr*)&addr, &len) != 0) return -1;
  return ntohs(addr.sin_port);
}

// 1 = connected, 0 = timeout, -1 = error.
int sr_accept(void* h, int timeout_ms) {
  SockReader* r = (SockReader*)h;
  if (r->conn_fd >= 0) return 1;
  pollfd p{r->listen_fd, POLLIN, 0};
  int rc = poll(&p, 1, timeout_ms);
  if (rc <= 0) return rc;
  r->conn_fd = accept(r->listen_fd, nullptr, nullptr);
  if (r->conn_fd < 0) return -1;
  int one = 1;
  setsockopt(r->conn_fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return 1;
}

static int64_t sr_last_newline(const char* buf, int64_t n) {
  for (int64_t i = n - 1; i >= 0; --i)
    if (buf[i] == '\n') return i;
  return -1;
}

// Hand out out[0..nl] as the block; out[nl+1..have) goes to the FRONT of
// the carry, ahead of anything already carried.
static int64_t sr_flush(SockReader* r, char* out, int64_t have, int64_t nl) {
  int64_t tail = have - (nl + 1);
  if (tail > 0) {
    if (r->carry_len + tail > r->carry_cap) {
      r->carry_cap = (r->carry_len + tail) * 2;
      r->carry = (char*)realloc(r->carry, r->carry_cap);
    }
    memmove(r->carry + tail, r->carry, r->carry_len);
    memcpy(r->carry, out + nl + 1, tail);
    r->carry_len += tail;
  }
  return nl + 1;
}

// Complete lines into out (at most cap bytes, ending at a newline).
// Returns the bytes written; 0 = timeout with no complete line; -1 = the
// peer closed (an unterminated tail is no record and is dropped); -2 = an
// error, or one line longer than cap.
int64_t sr_read_block(void* h, char* out, int64_t cap, int timeout_ms) {
  SockReader* r = (SockReader*)h;
  if (r->conn_fd < 0) return -2;
  int64_t have = r->carry_len < cap ? r->carry_len : cap;
  memcpy(out, r->carry, have);
  memmove(r->carry, r->carry + have, r->carry_len - have);
  r->carry_len -= have;
  for (;;) {
    int64_t nl = sr_last_newline(out, have);
    if (nl >= 0 && (have == cap || r->carry_len > 0))
      return sr_flush(r, out, have, nl);
    if (have == cap) return -2;
    pollfd p{r->conn_fd, POLLIN, 0};
    int rc = poll(&p, 1, timeout_ms);
    if (rc == 0) return nl >= 0 ? sr_flush(r, out, have, nl) : 0;
    if (rc < 0) return -2;
    int64_t n = read(r->conn_fd, out + have, cap - have);
    if (n == 0) {
      int64_t last = sr_last_newline(out, have);
      return last >= 0 ? last + 1 : -1;
    }
    if (n < 0) return -2;
    have += n;
  }
}

void sr_close(void* h) {
  SockReader* r = (SockReader*)h;
  if (r->conn_fd >= 0) close(r->conn_fd);
  close(r->listen_fd);
  free(r->carry);
  free(r);
}

}  // extern "C"
