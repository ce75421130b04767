"""Nexmark generators: deterministic in (split, batch index) — the
replayable-source contract.

Four streams, as in ``flink_tpu.nexmark.generator``:

- ``bid_stream``: the reference's numpy RNG branch (host-fed). The
  reference prefers its native C generator when that library is built,
  which yields a different, equally deterministic stream.
- ``bid_stream_device``: bids made on the card. A counter-based
  splitmix64 per record index (``nexmark_bids``, a numpy uint64 copy of
  ``native/codec.cc`` ``smx``/``nexmark_bids``), run on the card by the
  ``nexmark_bids`` kernel (``kernels/devgen_kernels.py``) inside the
  window operator's step; the host copy repairs device-side key misses
  and materializes batches when a devgen gate closes.

- ``person_stream`` and ``auction_stream``: the new-person and
  new-auction events of Q8's join, the reference's numpy generators.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from flink_tpu_torch.api.sources import DeviceGeneratorSource, GeneratorSource

# 1/HOT_AUCTION_RATIO of the auctions are hot
HOT_AUCTION_RATIO = 100

# the classic Nexmark mix: 1 person : 3 auctions : 46 bids
PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
BID_PROPORTION = 46
TOTAL_PROPORTION = PERSON_PROPORTION + AUCTION_PROPORTION + BID_PROPORTION

# the record schemas (field -> numpy dtype name) of the three streams
BID_SCHEMA = {"auction": "int64", "bidder": "int64", "price": "float32"}
PERSON_SCHEMA = {"person": "int64", "state_id": "int64"}
AUCTION_SCHEMA = {"auction": "int64", "seller": "int64",
                  "category": "int64", "reserve": "float32"}

# splitmix64 constants of native/codec.cc smx() and nexmark_bids()
SMX_GAMMA = 0x9E3779B97F4A7C15
SMX_MUL1 = 0xBF58476D1CE4E5B9
SMX_MUL2 = 0x94D049BB133111EB
SEED_MUL = 0xD1342543DE82EF95


@dataclasses.dataclass(frozen=True)
class NexmarkConfig:
    batch_size: int = 8192
    n_batches: int = 100
    events_per_ms: int = 100       # event-time density
    n_splits: int = 1
    num_active_auctions: int = 1000
    num_active_people: int = 500
    hot_ratio: int = 2             # 1/hot_ratio of bids go to hot auctions


def _event_ids(cfg: NexmarkConfig, split: int,
               index: int) -> Tuple[np.ndarray, np.ndarray]:
    """Global event ids + event time of one batch (monotone per split,
    interleaved across splits)."""
    b = cfg.batch_size
    base = (index * cfg.n_splits + split) * b
    ids = base + np.arange(b, dtype=np.int64)
    return ids, ids // cfg.events_per_ms


def bid_batch(cfg: NexmarkConfig, split: int,
              index: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """One batch of bids: auction, bidder, price; hot auctions get
    1/hot_ratio of the traffic."""
    _, ts = _event_ids(cfg, split, index)
    b = cfg.batch_size
    n_hot = max(1, cfg.num_active_auctions // HOT_AUCTION_RATIO)
    rng = np.random.default_rng((split << 20) | index)
    hot = rng.integers(0, cfg.hot_ratio, b) == 0
    auction = np.where(
        hot,
        rng.integers(0, n_hot, b),
        rng.integers(0, cfg.num_active_auctions, b),
    ).astype(np.int64)
    bidder = rng.integers(0, cfg.num_active_people, b).astype(np.int64)
    price = np.round(np.exp(rng.normal(6.0, 1.0, b)), 2).astype(np.float32)
    return {"auction": auction, "bidder": bidder, "price": price}, ts


def bid_stream(cfg: NexmarkConfig) -> GeneratorSource:
    """Bids only (the Q5 input)."""

    def gen(split: str, i: int) -> Optional[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        if i >= cfg.n_batches:
            return None
        return bid_batch(cfg, int(split), i)

    return GeneratorSource(gen, n_splits=cfg.n_splits)


# -- the counter-based generator (native/codec.cc nexmark_bids) -------------

def _smx(c: np.ndarray) -> np.ndarray:
    """splitmix64's mix of already-advanced counters (uint64 arrays)."""
    z = (c ^ (c >> np.uint64(30))) * np.uint64(SMX_MUL1)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(SMX_MUL2)
    return z ^ (z >> np.uint64(31))


def _fast_exp(x: np.ndarray) -> np.ndarray:
    """codec.cc fast_exp in float32: Schraudolph's bit trick."""
    y = np.float32(12102203.0) * x + np.float32(1064866805.0)
    return y.astype(np.int32).view(np.float32)


def nexmark_bids(seed: int, start: int, n: int, hot_ratio: int, n_hot: int,
                 n_auctions: int, n_people: int, *,
                 lanes: Tuple[str, ...] = ("auction", "bidder", "price"),
                 ) -> Dict[str, np.ndarray]:
    """Records ``[start, start + n)`` of ``native/codec.cc``
    ``nexmark_bids(seed, ...)``: auction and bidder bit for bit, price
    through the same float32 ``fast_exp`` formula. Counter-based, so any
    slice of a batch is computed alone. ``lanes`` picks the outputs."""
    with np.errstate(over="ignore"):
        g = np.uint64(SMX_GAMMA)
        b1 = np.array([seed], np.int64).astype(np.uint64) \
            * np.uint64(SEED_MUL) + np.uint64(1)
        i = np.arange(start, start + n, dtype=np.uint64)
        out: Dict[str, np.ndarray] = {}
        if "auction" in lanes or "bidder" in lanes:
            # smx advances the counter before mixing: c = base + (i+1)*G
            r1 = _smx(b1 + i * g + g)
            if "auction" in lanes:
                hot = (r1 & np.uint64(0xFF)) % np.uint64(hot_ratio) == 0
                a32 = (r1 >> np.uint64(8)) & np.uint64(0xFFFFFFFF)
                m = np.where(hot, np.uint64(n_hot), np.uint64(n_auctions))
                out["auction"] = ((a32 * m) >> np.uint64(32)).astype(np.int64)
            if "bidder" in lanes:
                b24 = (r1 >> np.uint64(40)) & np.uint64(0xFFFFFF)
                out["bidder"] = ((b24 * np.uint64(n_people))
                                 >> np.uint64(24)).astype(np.int64)
        if "price" in lanes:
            r2 = _smx((b1 ^ np.uint64(SMX_MUL2)) + i * g + g)
            m16 = np.uint64(0xFFFF)
            s = ((r2 & m16) + ((r2 >> np.uint64(16)) & m16)
                 + ((r2 >> np.uint64(32)) & m16) + (r2 >> np.uint64(48)))
            u = s.astype(np.float32) * np.float32(1.0 / 65536.0)
            z = (u - np.float32(2.0)) * np.float32(1.7320508)
            out["price"] = _fast_exp(np.float32(6.0) + z)
    return out


@dataclasses.dataclass(frozen=True)
class NexmarkDeviceBidGen:
    """The device form of ``nexmark_bids``' auction lane plus event
    time, for one (sub-)batch index; ``device_keys_ts`` of
    ``bid_stream_device``.

    ``sub_batches`` > 1 re-slices the stream: ``batch_size`` is then
    the SUB-batch size, and index ``s`` yields records ``[off, off +
    batch_size)`` of logical batch ``s // sub_batches`` (``off = (s %
    sub_batches) * batch_size``). The counter is seeded from the logical
    index and advanced by the offset, so the record stream is the same
    at every sub-batch count."""

    batch_size: int
    events_per_ms: int
    hot_ratio: int
    n_hot: int
    n_auctions: int
    sub_batches: int = 1

    def split_index(self, batch_index: int) -> Tuple[int, int]:
        """(logical batch, record offset inside it) of a batch index."""
        k = self.sub_batches
        return batch_index // k, (batch_index % k) * self.batch_size

    def __call__(self, batch_index: int, device):
        """(keys, ts) int64 tensors on ``device``: the ``nexmark_bids``
        kernel on a CUDA device, its plain version on the CPU."""
        from flink_tpu_torch.kernels import devgen_kernels as dk

        return dk.nexmark_bids(*self._gen(batch_index), device)

    def _gen(self, batch_index: int) -> Tuple[int, ...]:
        """``nexmark_bids``' arguments for a batch index."""
        logical, off = self.split_index(int(batch_index))
        return (logical, off, self.batch_size,
                self.batch_size * self.sub_batches, self.events_per_ms,
                self.hot_ratio, self.n_hot, self.n_auctions)

    def ingest_into(self, counts, batch_index: int, **ingest):
        """Make the batch and fold it into ``counts`` in one step, as the
        reference's step traces its generator in: ``devgen_ingest``'s
        Nexmark form (one launch on the card, the bids in registers; its
        plain version on the CPU). ``ingest`` is ``devgen_ingest``'s
        keywords; returns its stats vector (or None)."""
        from flink_tpu_torch.kernels import devgen_kernels as dk

        return dk.devgen_ingest_nexmark(counts, self._gen(batch_index),
                                        **ingest)


def bid_stream_device(cfg: NexmarkConfig,
                      sub_batches: int = 1) -> DeviceGeneratorSource:
    """Bids made on the card (the Q5 input of the headline path): the
    window operator's step runs ``device_keys_ts`` and never sees a
    host record. ``keys_ts_host`` is the same stream in numpy, bit for
    bit, for miss repair; ``gen`` materializes full bids (auction,
    bidder, price) when a devgen gate sends a batch to the host.

    ``sub_batches`` > 1 presents the same record stream at
    ``cfg.batch_size / sub_batches`` granularity: sub-batch ``s`` is
    the bit-exact slice of logical batch ``s // sub_batches``."""
    if cfg.n_splits != 1:
        # the device formula and ts_bounds assume the single-split id
        # base i * batch_size; _event_ids interleaves splits
        raise ValueError("bid_stream_device requires n_splits == 1")
    k = int(sub_batches)
    if k < 1 or cfg.batch_size % k:
        raise ValueError(
            f"sub_batches={k} must be >= 1 and divide "
            f"batch_size={cfg.batch_size}")
    if cfg.num_active_auctions >= 2 ** 31:
        # the plain version multiplies in int64: a32 * n must stay < 2^63
        raise ValueError("num_active_auctions must be < 2^31")
    B = cfg.batch_size          # logical batch size (the seed unit)
    b = B // k                  # produced (sub-)batch size
    n_hot = max(1, cfg.num_active_auctions // HOT_AUCTION_RATIO)
    device_keys_ts = NexmarkDeviceBidGen(
        batch_size=b, events_per_ms=cfg.events_per_ms,
        hot_ratio=cfg.hot_ratio, n_hot=n_hot,
        n_auctions=cfg.num_active_auctions, sub_batches=k)

    def _ids(s: int) -> np.ndarray:
        logical, off = device_keys_ts.split_index(s)
        return logical * B + off + np.arange(b, dtype=np.int64)

    def _bids(s: int, lanes: Tuple[str, ...]) -> Dict[str, np.ndarray]:
        logical, off = device_keys_ts.split_index(s)
        return nexmark_bids(logical, off, b, cfg.hot_ratio, n_hot,
                            cfg.num_active_auctions, cfg.num_active_people,
                            lanes=lanes)

    def keys_ts_host(s: int) -> Tuple[np.ndarray, np.ndarray]:
        return _bids(s, ("auction",))["auction"], _ids(s) // cfg.events_per_ms

    def ts_bounds(s: int) -> Tuple[int, int]:
        logical, off = device_keys_ts.split_index(s)
        base = logical * B + off
        return base // cfg.events_per_ms, (base + b - 1) // cfg.events_per_ms

    def gen(split: str, s: int):
        # host materialization (a devgen gate closed): the C generator's
        # seed unit is the logical batch, and the counter makes any
        # sub-batch slice of it directly
        if s // k >= cfg.n_batches:
            return None
        return _bids(s, ("auction", "bidder", "price")), \
            _ids(s) // cfg.events_per_ms

    return DeviceGeneratorSource(
        gen=gen, device_keys_ts=device_keys_ts,
        keys_ts_host=keys_ts_host, ts_bounds=ts_bounds,
        key_field="auction", batch_size=b, n_batches=cfg.n_batches * k,
        # multiply-shift range reduction: auction < n_auctions always
        key_domain=cfg.num_active_auctions, keys_bounded=True,
        # further subdivision re-derives from the config, so the
        # logical seed unit stays cfg.batch_size
        subdivide=(lambda kk: bid_stream_device(cfg, sub_batches=kk))
        if k == 1 else None)


def person_batch(cfg: NexmarkConfig, split: int,
                 index: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """One batch of new-person events (Q8's left input): person,
    state_id."""
    ids, ts = _event_ids(cfg, split, index)
    rng = np.random.default_rng(0x9E3779B9 ^ ((split << 20) | index))
    b = cfg.batch_size
    person = (ids * PERSON_PROPORTION // TOTAL_PROPORTION) % (
        cfg.num_active_people) + rng.integers(0, 2, b)
    return ({"person": person.astype(np.int64),
             "state_id": rng.integers(0, 50, b).astype(np.int64)}, ts)


def auction_batch(cfg: NexmarkConfig, split: int,
                  index: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """One batch of new-auction events (Q8's right input): auction,
    seller, category, reserve."""
    ids, ts = _event_ids(cfg, split, index)
    rng = np.random.default_rng(0x85EBCA6B ^ ((split << 20) | index))
    b = cfg.batch_size
    seller = rng.integers(0, cfg.num_active_people, b).astype(np.int64)
    return ({
        "auction": ids,
        "seller": seller,
        "category": rng.integers(0, 5, b).astype(np.int64),
        "reserve": np.round(np.exp(rng.normal(6.0, 1.0, b)), 2).astype(
            np.float32),
    }, ts)


def person_stream(cfg: NexmarkConfig) -> GeneratorSource:
    """New-person events, ``cfg.n_batches`` batches a split."""

    def gen(split: str, i: int) -> Optional[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        if i >= cfg.n_batches:
            return None
        return person_batch(cfg, int(split), i)

    return GeneratorSource(gen, n_splits=cfg.n_splits)


def auction_stream(cfg: NexmarkConfig) -> GeneratorSource:
    """New-auction events, ``cfg.n_batches`` batches a split."""

    def gen(split: str, i: int) -> Optional[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        if i >= cfg.n_batches:
            return None
        return auction_batch(cfg, int(split), i)

    return GeneratorSource(gen, n_splits=cfg.n_splits)
