"""The device-generated ingest's two device functions: a CUDA kernel each
(``csrc/devgen_kernels.cu``) and a plain PyTorch version each, with the
same signature.

- ``nexmark_bids`` (K5): the Nexmark bid generator's auction lane and
  event time for one (sub-)batch, made on the device.
- ``devgen_ingest`` (K6): folds those records into the pane counts and
  writes the stats vector of ``flink_tpu``'s ``devgen_step_kernel``.
  Its Nexmark form, ``devgen_ingest_nexmark``, makes K5's records in
  registers inside the same launch (as the reference's step traces its
  generator in), so the devgen path's bids never reach device memory;
  it counts as a ``devgen_ingest`` launch.

As in ``window_kernels.py``: a wrapper takes the plain version only for
tensors on the CPU and launches the kernel (or raises) for CUDA
tensors; ``window_kernels.LAUNCHES`` counts the launches; an
out-of-range cell index makes the plain version raise and the kernel
set a bit in the device's error word. Both are exact integer work, so
kernel, plain version and JAX reference agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from flink_tpu_torch.kernels import window_kernels as wk

# stats vector: [n_valid, n_late, n_miss, ring_total, n_refire,
# ring_truncated, 0, 0] then the refire bitmap — the reference's layout
# (flink_tpu/ops/window.py devgen_step_kernel); the port leaves the
# emit-ring words 3 and 5 at 0, since it reads the ring head itself
STATS_HEAD = 8
REFIRE_BITS = 2048
STATS_WORDS = STATS_HEAD + REFIRE_BITS

# splitmix64 constants (native/codec.cc smx(), nexmark_bids()) as the
# signed int64 values of the same bits, for the plain version
_GAMMA = 0x9E3779B97F4A7C15
_MUL1 = 0xBF58476D1CE4E5B9
_MUL2 = 0x94D049BB133111EB
_SEED_MUL = 0xD1342543DE82EF95

_SIGNATURES = {
    "dg_error_string": [ctypes.c_int],
}


def _lib() -> ctypes.CDLL:
    return wk.load_library("devgen_kernels", _SIGNATURES, "dg_error_string")


def _entry(fn: str, name: str, n_words: int) -> wk.LeanEntry:
    return wk.LeanEntry(_lib, fn, name, n_words, "dg_error_string")


_NEXMARK_BIDS = _entry("dg_nexmark_bids", "nexmark_bids", 10)
_DEVGEN_INGEST = _entry("dg_devgen_ingest", "devgen_ingest", 14)
_DEVGEN_INGEST_NEXMARK = _entry("dg_devgen_ingest_nexmark", "devgen_ingest",
                                19)


def _i64(v: int) -> int:
    """The signed int64 with the bits of ``v`` mod 2^64."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic,
    and the CPU has no ``>>`` for uint64)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


# -- K5 ----------------------------------------------------------------------

def _check_gen(name, logical, off, n, batch_total, events_per_ms, hot_ratio,
               n_hot, n_auctions) -> None:
    if n < 0 or off < 0 or logical < 0 or events_per_ms < 1 \
            or hot_ratio < 1 or not 1 <= n_hot < 2 ** 31 \
            or not 1 <= n_auctions < 2 ** 31:
        raise ValueError(
            f"{name}: bad arguments (logical={logical}, off={off}, "
            f"n={n}, events_per_ms={events_per_ms}, hot_ratio={hot_ratio}, "
            f"n_hot={n_hot}, n_auctions={n_auctions})")


def nexmark_bids(logical: int, off: int, n: int, batch_total: int,
                 events_per_ms: int, hot_ratio: int, n_hot: int,
                 n_auctions: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Records ``[off, off + n)`` of logical batch ``logical`` (of
    ``batch_total`` records) of the counter-based Nexmark bid stream:
    int64 ``(auction, ts)`` tensors on ``device``. Auction is bit-exact
    with ``native/codec.cc`` ``nexmark_bids(seed=logical)``; ``ts`` is
    ``(logical * batch_total + off + i) // events_per_ms``."""
    _check_gen("nexmark_bids", logical, off, n, batch_total, events_per_ms,
               hot_ratio, n_hot, n_auctions)
    device = torch.device(device)
    out = torch.empty(2 * n, dtype=torch.int64, device=device)
    keys, ts = out[:n], out[n:]
    index = out.get_device()
    if index < 0:
        wk.on_cuda("nexmark_bids", keys, ts)
        return nexmark_bids_plain(logical, off, n, batch_total, events_per_ms,
                                  hot_ratio, n_hot, n_auctions, device)
    _, stream = wk.launch_context(index)
    _NEXMARK_BIDS(stream, keys.data_ptr(), ts.data_ptr(), n, logical, off,
                  batch_total, events_per_ms, hot_ratio, n_hot, n_auctions)
    return keys, ts


def nexmark_bids_plain(logical, off, n, batch_total, events_per_ms, hot_ratio,
                       n_hot, n_auctions, device):
    """int64 torch with a wrapping multiply and masked right shifts."""
    i = torch.arange(off, off + n, dtype=torch.int64, device=device)
    gamma = _i64(_GAMMA)
    z = i * gamma + _i64(logical * _SEED_MUL + 1 + _GAMMA)
    z = (z ^ _shr(z, 30)) * _i64(_MUL1)
    z = (z ^ _shr(z, 27)) * _i64(_MUL2)
    r1 = z ^ _shr(z, 31)
    hot = (r1 & 0xFF) % hot_ratio == 0
    a32 = (r1 >> 8) & 0xFFFFFFFF
    m = torch.where(hot, torch.full_like(a32, n_hot),
                    torch.full_like(a32, n_auctions))
    keys = (a32 * m) >> 32
    ts = torch.div(i + logical * batch_total, events_per_ms,
                   rounding_mode="floor")
    return keys, ts


# -- K6 ----------------------------------------------------------------------

def devgen_ingest(counts: torch.Tensor, keys: torch.Tensor, ts: torch.Tensor,
                  *, key_domain: int, pane_ms: int, offset_ms: int,
                  dead_below: int, refire_below: int, dump_row: int,
                  with_stats: bool = True) -> Optional[torch.Tensor]:
    """Fold one device-made batch into ``counts`` (``(rows, ring)``
    int32, in place). With ``with_stats``, return its stats vector
    (``STATS_WORDS`` int32, zeroed here first): words 0, 1, 2, 4 =
    valid, late, miss and refire records, bitmap word ``STATS_HEAD +
    pane - dead_below`` = 1 for each refire pane in range, the other
    words 0. Without, return None and write no stats.

    A record hits when ``0 <= key < key_domain`` (slot = key); its pane
    is ``floor((ts - offset_ms) / pane_ms)``; it is late when it hits
    below ``dead_below``; valid records add 1 at ``(key, pane mod
    ring)``, the others at ``(dump_row, 0)``; a valid record below
    ``refire_below`` is a refire candidate."""
    index = wk.fast_index((counts, torch.int32, 2), (keys, torch.int64, 1),
                          (ts, torch.int64, 1))
    if index is None:
        wk.check_tensor(counts, "counts", torch.int32, 2)
        wk.check_tensor(keys, "keys", torch.int64, 1)
        wk.check_tensor(ts, "ts", torch.int64, 1)
    if keys.numel() != ts.numel():
        raise ValueError("keys and ts differ in length")
    if pane_ms < 1:
        raise ValueError("pane_ms must be >= 1")
    stats = (torch.zeros(STATS_WORDS, dtype=torch.int32, device=counts.device)
             if with_stats else None)
    if index is None:
        if not wk.on_cuda("devgen_ingest", counts, keys, ts):
            return devgen_ingest_plain(counts, keys, ts, key_domain, pane_ms,
                                       offset_ms, dead_below, refire_below,
                                       dump_row, stats)
        index = counts.get_device()
    rows, ring = counts.shape
    err, stream = wk.launch_context(index)
    _DEVGEN_INGEST(stream, counts.data_ptr(), counts.numel(), keys.data_ptr(),
                   ts.data_ptr(), keys.numel(), int(key_domain), int(pane_ms),
                   int(offset_ms), ring, int(dead_below), int(refire_below),
                   int(dump_row), stats.data_ptr() if stats is not None else 0,
                   err)
    return stats


def devgen_ingest_nexmark(counts: torch.Tensor, gen: Tuple[int, ...], *,
                          key_domain: int, pane_ms: int, offset_ms: int,
                          dead_below: int, refire_below: int, dump_row: int,
                          with_stats: bool = True) -> Optional[torch.Tensor]:
    """``devgen_ingest`` of the records ``nexmark_bids(*gen)`` makes, in
    one launch that makes them in registers: ``gen`` is ``nexmark_bids``'
    ``(logical, off, n, batch_total, events_per_ms, hot_ratio, n_hot,
    n_auctions)``. The same counts and stats as ``nexmark_bids`` then
    ``devgen_ingest``; the launch counts as ``devgen_ingest``."""
    index = wk.fast_index((counts, torch.int32, 2))
    if index is None:
        wk.check_tensor(counts, "counts", torch.int32, 2)
    _check_gen("devgen_ingest_nexmark", *gen)
    if pane_ms < 1:
        raise ValueError("pane_ms must be >= 1")
    stats = (torch.zeros(STATS_WORDS, dtype=torch.int32, device=counts.device)
             if with_stats else None)
    if index is None:
        if not wk.on_cuda("devgen_ingest", counts):
            return devgen_ingest_nexmark_plain(
                counts, gen, key_domain, pane_ms, offset_ms, dead_below,
                refire_below, dump_row, stats)
        index = counts.get_device()
    logical, off, n, batch_total, epm, hot_ratio, n_hot, n_auctions = gen
    err, stream = wk.launch_context(index)
    _DEVGEN_INGEST_NEXMARK(
        stream, counts.data_ptr(), counts.numel(), n, logical, off,
        batch_total, epm, hot_ratio, n_hot, n_auctions, int(key_domain),
        int(pane_ms), int(offset_ms), counts.shape[1], int(dead_below),
        int(refire_below), int(dump_row),
        stats.data_ptr() if stats is not None else 0, err)
    return stats


def devgen_ingest_nexmark_plain(counts, gen, key_domain, pane_ms, offset_ms,
                                dead_below, refire_below, dump_row, stats):
    """``nexmark_bids_plain`` then ``devgen_ingest_plain``."""
    keys, ts = nexmark_bids_plain(*gen, counts.device)
    return devgen_ingest_plain(counts, keys, ts, key_domain, pane_ms,
                               offset_ms, dead_below, refire_below, dump_row,
                               stats)


def devgen_ingest_plain(counts, keys, ts, key_domain, pane_ms, offset_ms,
                        dead_below, refire_below, dump_row, stats):
    ring = counts.shape[1]
    hit = (keys >= 0) & (keys < key_domain)
    pane = torch.div(ts - offset_ms, pane_ms, rounding_mode="floor")
    late = hit & (pane < dead_below)
    valid = hit & ~late
    slot = torch.where(valid, keys, torch.zeros_like(keys))
    flat = torch.where(valid, slot * ring + torch.remainder(pane, ring),
                       torch.full_like(keys, dump_row * ring))
    if flat.numel() and (int(flat.min()) < 0
                         or int(flat.max()) >= counts.numel()):
        wk.raise_for_error_bits(4)
    counts.view(-1).index_add_(
        0, flat, torch.ones(flat.numel(), dtype=torch.int32,
                            device=counts.device))
    if stats is None:
        return None
    refire = valid & (pane < refire_below)
    stats[0] = valid.sum()
    stats[1] = late.sum()
    stats[2] = (~hit).sum()
    stats[4] = refire.sum()
    bits = pane[refire] - dead_below
    bits = bits[(bits >= 0) & (bits < REFIRE_BITS)]
    stats[STATS_HEAD + bits] = 1
    return stats
