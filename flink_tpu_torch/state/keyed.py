"""Keyed state: dense device pane tensors + a host key directory.

State lives as a dense ``(rows, ring)`` int32 count tensor (plus f32
sum/max/min lanes, ``None`` at zero width) on the device; row = key
slot, column = pane ring position, and one extra dump row keeps the
layout of the reference's snapshots. The host directory maps each key
to a stable slot inside its key shard (shard = splitmix64(key) %
num_shards; global slot = shard * slots_per_shard + local index) with
the C open-addressing table of the port's host codec
(``native_codec.NativeHashTable``), or its vectorized numpy form, which
tests select by making ``NativeHashTable.create`` return None.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.records import hash_keys_numpy


@dataclasses.dataclass(frozen=True)
class PaneStateLayout:
    """Static shape of one window operator's state. One extra dump row
    at index ``slots``."""

    slots: int
    ring: int
    sum_width: int
    max_width: int
    min_width: int

    @property
    def rows(self) -> int:
        return self.slots + 1

    def bytes(self) -> int:
        """Device bytes of one block's pane lanes and counts."""
        per_cell = 4 * (self.sum_width + self.max_width + self.min_width) + 4
        return self.rows * self.ring * per_cell


@dataclasses.dataclass
class PaneState:
    """Accumulator tensors; zero-width lane families are ``None``."""

    sums: Optional[torch.Tensor]   # (rows, ring, sum_width) f32
    maxs: Optional[torch.Tensor]   # (rows, ring, max_width) f32
    mins: Optional[torch.Tensor]   # (rows, ring, min_width) f32
    counts: torch.Tensor           # (rows, ring) i32

    def clone(self) -> "PaneState":
        return PaneState(*(None if t is None else t.clone()
                           for t in (self.sums, self.maxs, self.mins,
                                     self.counts)))


def init_state(layout: PaneStateLayout, device: torch.device) -> PaneState:
    def lane(width: int, fill: float) -> Optional[torch.Tensor]:
        if width == 0:
            return None
        return torch.full((layout.rows, layout.ring, width), fill,
                          dtype=torch.float32, device=device)

    return PaneState(
        sums=lane(layout.sum_width, 0.0),
        maxs=lane(layout.max_width, -float("inf")),
        mins=lane(layout.min_width, float("inf")),
        counts=torch.zeros((layout.rows, layout.ring), dtype=torch.int32,
                           device=device),
    )


class _NumpyHashTable:
    """Open-addressing int64→int64 map with fully vectorized batch
    lookup AND batch insert/update (linear probing; load factor kept
    ≤ 0.5 by doubling) — key churn costs numpy probe rounds, never a
    Python loop per key."""

    def __init__(self, capacity_hint: int = 1024) -> None:
        size = 1
        while size < max(capacity_hint * 2, 16):
            size *= 2
        self._keys = np.zeros(size, dtype=np.int64)
        self._vals = np.zeros(size, dtype=np.int64)
        self._used = np.zeros(size, dtype=bool)
        self._count = 0

    def lookup_keys(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.lookup(keys, hash_keys_numpy(keys))

    def lookup(self, keys: np.ndarray, key_hashes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(values, found) for a batch. Vectorized probe: each round
        resolves every query that hits its key or an empty bucket."""
        mask = len(self._keys) - 1
        ix = (key_hashes & mask).astype(np.int64)
        out = np.full(len(keys), -1, dtype=np.int64)
        found = np.zeros(len(keys), dtype=bool)
        pending = np.arange(len(keys))
        for _ in range(len(self._keys)):
            if len(pending) == 0:
                break
            pix = ix[pending]
            hit = self._used[pix] & (self._keys[pix] == keys[pending])
            empty = ~self._used[pix]
            out[pending[hit]] = self._vals[pix[hit]]
            found[pending[hit]] = True
            pending = pending[~hit & ~empty]
            ix[pending] = (ix[pending] + 1) & mask
        return out, found

    def insert_batch(self, keys: np.ndarray, key_hashes: np.ndarray,
                     vals: np.ndarray) -> None:
        """Vectorized linear-probe insert for a batch of DISTINCT keys.
        Each probe round settles every query whose bucket holds its key
        (update) or wins an empty bucket (one writer per bucket per
        round); the rest step forward — same round structure as lookup,
        so key churn costs O(rounds) numpy passes, not a Python loop
        per key."""
        n = len(keys)
        if n == 0:
            return
        while (self._count + n) * 2 > len(self._keys):
            self._grow()
        keys = np.asarray(keys, np.int64)
        vals = np.asarray(vals, np.int64)
        mask = len(self._keys) - 1
        ix = (key_hashes & mask).astype(np.int64)
        pending = np.arange(n)
        while len(pending):
            pix = ix[pending]
            used = self._used[pix]
            samekey = used & (self._keys[pix] == keys[pending])
            upd = pending[samekey]
            self._vals[ix[upd]] = vals[upd]
            emp = pending[~used]
            _, first = np.unique(ix[emp], return_index=True)
            win = emp[first]
            self._keys[ix[win]] = keys[win]
            self._vals[ix[win]] = vals[win]
            self._used[ix[win]] = True
            self._count += len(win)
            settled = np.zeros(n, dtype=bool)
            settled[upd] = True
            settled[win] = True
            pending = pending[~settled[pending]]
            ix[pending] = (ix[pending] + 1) & mask

    def _grow(self) -> None:
        old_keys, old_vals, old_used = self._keys, self._vals, self._used
        self.__init__(capacity_hint=len(old_keys))
        live = np.nonzero(old_used)[0]
        if len(live):
            self.insert_batch(
                old_keys[live], hash_keys_numpy(old_keys[live]), old_vals[live])


class KeyDirectory:
    """Host-side key → slot mapping, over all key shards of one device.

    Batch lookups probe the C table (or its numpy form); only
    never-before-seen keys take the insert path. Slot ids are stable for
    the life of the job (and across snapshots — the directory is part of
    them), and allocation is the reference package's, so both packages
    give a key the same slot.
    """

    FULL = -2  # sentinel: shard out of slots

    def __init__(self, num_shards: int, slots_per_shard: int) -> None:
        self.num_shards = num_shards
        self.slots_per_shard = slots_per_shard
        from flink_tpu_torch.native_codec import NativeHashTable

        self._table = NativeHashTable.create() or _NumpyHashTable()
        self._next_free = np.zeros(num_shards, dtype=np.int64)
        self._rev_keys = np.zeros(self.local_slots, dtype=np.int64)
        self._rev_used = np.zeros(self.local_slots, dtype=bool)

    @property
    def local_slots(self) -> int:
        return self.num_shards * self.slots_per_shard

    def assign(self, keys: np.ndarray) -> np.ndarray:
        """Map raw int64 keys → slot ids; FULL where the key's shard is
        out of slots."""
        keys = np.asarray(keys, dtype=np.int64)
        slots, found = self._table.lookup_keys(keys)
        if not found.all():
            miss_ix = np.nonzero(~found)[0]
            # allocate + register each distinct new key once, vectorized
            # (key churn is per-batch steady state in rotating-key
            # workloads like Nexmark; a Python loop here was 60ms/batch);
            # only the DISTINCT misses are hashed on the Python side —
            # the hit path's hashes live inside the table lookup
            uniq, inv = np.unique(keys[miss_ix], return_inverse=True)
            uh = hash_keys_numpy(uniq)
            alloc = self._alloc_slots(uniq, uh)
            self._table.insert_batch(uniq, uh, alloc)
            slots[miss_ix] = alloc[inv]
        return slots

    def register_misses(self, miss_keys: np.ndarray) -> None:
        """Register keys known to be absent (the fused ingest scan has
        just probed them): allocate and insert without a second lookup,
        in the order ``assign`` would allocate them."""
        uniq = np.unique(np.asarray(miss_keys, np.int64))
        uh = hash_keys_numpy(uniq)
        self._table.insert_batch(uniq, uh, self._alloc_slots(uniq, uh))

    def native(self) -> bool:
        """True when the directory probes the C table (the operator then
        takes its native ingest lane)."""
        from flink_tpu_torch.native_codec import NativeHashTable

        return isinstance(self._table, NativeHashTable)

    def lookup(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(slots, found) of ``keys`` without registering any; a key the
        directory refused has slot FULL."""
        return self._table.lookup_keys(np.ascontiguousarray(keys, np.int64))

    def register_dense(self, n: int) -> None:
        """Pre-register keys [0, n) with slot == key: the device-made
        ingest's contract (``kernels/devgen_kernels.py``
        ``devgen_ingest``), where slot must be a pure function of key
        on the device. It bypasses hash
        sharding, so it needs an empty directory; it claims the dense
        region from every shard's free pointer, so later keys outside
        [0, n) allocate normally from what each shard has left."""
        if self.num_keys():
            raise ValueError("register_dense requires an empty directory")
        if n > self.local_slots:
            raise ValueError(
                f"dense key domain {n} exceeds capacity {self.local_slots}")
        keys = np.arange(n, dtype=np.int64)
        self._table.insert_batch(keys, hash_keys_numpy(keys), keys)
        self._rev_keys[:n] = keys
        self._rev_used[:n] = True
        self._next_free[:] = np.clip(
            n - np.arange(self.num_shards) * self.slots_per_shard,
            0, self.slots_per_shard)

    def _alloc_slots(self, keys: np.ndarray, hashes: np.ndarray) -> np.ndarray:
        """Assign shard-local slots to a batch of DISTINCT new keys:
        group by shard, hand out contiguous indices from each shard's
        free pointer, mark FULL past capacity. Pure numpy — no per-key
        Python."""
        shards = (hashes % self.num_shards).astype(np.int64)
        out = np.full(len(keys), -1, dtype=np.int64)
        if not len(keys):
            return out
        sub = np.argsort(shards, kind="stable")
        sh = shards[sub]
        # rank of each key within its equal-shard run
        starts = np.r_[0, np.nonzero(np.diff(sh))[0] + 1]
        run_lens = np.diff(np.r_[starts, len(sh)])
        ranks = np.arange(len(sh)) - np.repeat(starts, run_lens)
        local_ix = self._next_free[sh] + ranks
        full = local_ix >= self.slots_per_shard
        slot = sh * self.slots_per_shard + local_ix
        slot[full] = self.FULL
        np.add.at(self._next_free, sh[~full], 1)
        ok = slot[~full]
        self._rev_keys[ok] = keys[sub[~full]]
        self._rev_used[ok] = True
        out[sub] = slot
        return out

    def key_of_slots(self, slots: np.ndarray) -> np.ndarray:
        return self._rev_keys[slots]

    def used_mask(self) -> np.ndarray:
        """(local_slots,) bool — which slots hold a registered key."""
        return self._rev_used

    def num_keys(self) -> int:
        return int(self._rev_used.sum())

    # -- snapshot (part of the checkpoint manifest) ----------------------
    def snapshot(self) -> Dict[str, np.ndarray]:
        return {
            "rev_keys": self._rev_keys.copy(),
            "rev_used": self._rev_used.copy(),
            "next_free": self._next_free.copy(),
        }

    @classmethod
    def restore(cls, num_shards: int, slots_per_shard: int,
                snap: Dict[str, np.ndarray]) -> "KeyDirectory":
        d = cls(num_shards, slots_per_shard)
        d._rev_keys = snap["rev_keys"].copy()
        d._rev_used = snap["rev_used"].copy()
        d._next_free = snap["next_free"].copy()
        used = np.nonzero(d._rev_used)[0]
        keys = d._rev_keys[used]
        if len(used):
            d._table.insert_batch(keys, hash_keys_numpy(keys), used)
        return d


def account_full_drop(op, n: int) -> None:
    """Key-directory overflow policy of an operator: by default a full
    shard fails the job (the JAX package's default); with
    ``op.allow_drops`` (``state.allow-drops``) its ``n`` records are
    dropped and counted in ``op.records_dropped_full``."""
    if n <= 0:
        return
    if not getattr(op, "allow_drops", False):
        raise RuntimeError(
            f"key directory shard full: {n} record(s) have no state slot "
            "(state.num-key-shards x state.slots-per-shard exceeded). The "
            "default policy never drops data - use state.backend='spill' "
            "for exact host-side degradation, raise the slot budget, or "
            "set state.allow-drops=true to drop with accounting "
            "(records_dropped_full).")
    op.records_dropped_full += n
