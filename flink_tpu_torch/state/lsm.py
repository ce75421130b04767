"""Disk-backed LSM keyed-state tier (``state.backend = lsm``): exact
windows over key domains larger than host memory, the JAX package's
``state/lsm.py`` on the port's host spill store.

``HostSpillStore`` (state/spill.py) keeps every spilled byte in RAM.
This tier keeps the same per-(key, pane) monoid accumulators, tiered to
disk:

- **delta (memtable)**: an internal ``HostSpillStore`` absorbs batches
  exactly as the RAM backend does, bounded by
  ``state.memory-budget-bytes``.
- **seal**: past the budget the delta's pane tables flatten into one
  run sorted by ``(pane, key)``, with a key-group (shard) column,
  written in the CRC'd columnar format (``formats_columnar``,
  ``run-<seq>.seg``): tmp + sync + rename, then the store manifest
  (``MANIFEST.json``, written atomically through ``fs.py``) publishes
  it. Fault points ``state.run.seal`` and ``state.run.fsync``.
- **fire**: the runs whose pane range meets the fired windows decode
  zero-copy off mmap and monoid-merge with the delta, runs in seal
  order and the delta last, so float lane sums keep the left-fold
  order of the un-spilled store: the fired bytes are the same whether
  or not the store sealed or compacted. The fire's lift and finalize
  are the spill store's torch functions on the CPU.
- **compact**: at ``state.lsm.compact-min-runs`` live runs, one pass
  folds them (the same seal-order fold) into one run a level up, under
  the log tier's maintenance lock (``log/bus.py``); the manifest swap
  is the visibility point (fault point ``state.compact.swap``), and the
  replaced files are deleted at a later pass.
- **changelog checkpoints**: ``snapshot()`` inlines only the delta and
  names the sealed runs (``aux_files``); the checkpoint plane hardlinks
  those immutable files (``checkpoint/storage.py``'s ``aux`` plane,
  fault point ``state.changelog.link``), so a checkpoint costs the
  write rate, not the state size. ``restore`` links the runs back and
  replays the delta; it also takes a plain ``HostSpillStore`` snapshot
  (a spill→lsm flip).
- **rescale**: every run row carries its key-group shard, so
  ``merge_rescale_spill`` re-slices the tier by filtering rows to a new
  shard range.

Compaction and purge never unlink a replaced run at once: a checkpoint
may have named it for a hardlink still in flight on the checkpoint
executor. Replaced files wait on a list swept at the next maintenance
or seal pass; a persist that outlives that grace fails loudly (ENOENT,
a failed checkpoint), never silently.

Scope: one store an operator instance on one host; local filesystem
(runs are mmap'd); no bloom filters or block cache (fires prune runs by
pane range, not key). Run files and manifests are the JAX package's
byte for byte, so either package reads the other's runs.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch import faults
from flink_tpu_torch.formats_columnar import (ColumnarWriter, iter_blocks,
                                              map_file_image)
from flink_tpu_torch.fs import get_filesystem, open_write_sync, write_atomic
from flink_tpu_torch.state.spill import HostSpillStore


def _run_image(path: str):
    """Sealed-run bytes: mmapped straight off the page cache on a
    plain local path, read through the fs layer on a path with a URL
    scheme."""
    if "://" not in path:
        return map_file_image(path)
    with get_filesystem(path).open_read(path) as f:
        data = f.read()
    return data if isinstance(data, bytes) else data.encode("utf-8")

MANIFEST = "MANIFEST.json"
_BASE_SCHEMA = (("shard", "i64"), ("key", "i64"), ("pane", "i64"),
                ("count", "i64"))


def run_schema(sum_width: int, max_width: int,
               min_width: int) -> Tuple[Tuple[str, str], ...]:
    """Run-file schema for an aggregate's lane widths: base columns +
    one f32 column per sum/max/min lane (s0.., x0.., n0..)."""
    lanes = ([(f"s{i}", "f32") for i in range(sum_width)]
             + [(f"x{i}", "f32") for i in range(max_width)]
             + [(f"n{i}", "f32") for i in range(min_width)])
    return _BASE_SCHEMA + tuple(lanes)


class LsmSpillStore:
    """Spill-store-compatible disk tier (duck-types ``HostSpillStore``:
    absorb / fire / purge_below / snapshot / restore / bytes_used /
    key_count / records_spilled). Constructed by ops/factory.py when
    ``state.backend = 'lsm'``."""

    def __init__(self, agg, *, store_dir: str,
                 memory_budget_bytes: int,
                 num_shards: int = 128,
                 compact_min_runs: int = 4,
                 pool=None,
                 fold_chunk_records: Optional[int] = None):
        self.agg = agg
        self.dir = str(store_dir)
        self.memory_budget_bytes = int(memory_budget_bytes)
        self.num_shards = int(num_shards)
        self.compact_min_runs = max(2, int(compact_min_runs))
        self._fs = get_filesystem(self.dir)
        self._delta = HostSpillStore(
            agg, pool=pool, fold_chunk_records=fold_chunk_records)
        self.schema = run_schema(agg.sum_width, agg.max_width,
                                 agg.min_width)
        self._runs: List[Dict[str, Any]] = []  # manifest order = seq order
        self._seq = 0        # monotone file-name counter (seals + compacts)
        self._gen = 0        # manifest generation (visibility swaps)
        self._floor = 0      # purge floor: panes below are dead
        self._pending_delete: List[str] = []  # replaced runs, grace-swept
        self.seals = 0
        self.compactions = 0
        self._open()

    # -- store directory lifecycle ---------------------------------------

    def _open(self) -> None:
        """Adopt an existing store directory (warm restart: manifest is
        the truth) or initialize a fresh one; either way sweep debris
        the manifest does not reference (crashed seal/compact tmp and
        pre-swap output — the log-tier orphan discipline)."""
        self._fs.mkdirs(self.dir)
        mpath = os.path.join(self.dir, MANIFEST)
        if self._fs.exists(mpath):
            with self._fs.open_read(mpath) as f:
                man = json.loads(f.read().decode("utf-8"))
            if man.get("format") != "lsm-state":
                raise ValueError(
                    f"{mpath} is not an lsm-state manifest "
                    f"(format={man.get('format')!r})")
            self._runs = [dict(r) for r in man.get("runs", [])]
            self._seq = int(man.get("seq", 0))
            self._gen = int(man.get("gen", 0))
            self._floor = int(man.get("purged_below", 0))
        self._sweep_orphans()

    def _sweep_orphans(self) -> None:
        live = {r["name"] for r in self._runs}
        for name in self._fs.listdir(self.dir):
            if name.endswith(".tmp") or (
                    name.startswith("run-") and name.endswith(".seg")
                    and name not in live):
                try:
                    self._fs.delete(os.path.join(self.dir, name))
                except OSError:
                    pass  # debris removal is best-effort; fsck re-flags

    def _write_manifest(self) -> None:
        self._gen += 1
        payload = json.dumps({
            "format": "lsm-state", "v": 1, "gen": self._gen,
            "seq": self._seq, "purged_below": self._floor,
            "num_shards": self.num_shards,
            "runs": self._runs,
        }, separators=(",", ":")).encode("utf-8")
        write_atomic(self._fs, os.path.join(self.dir, MANIFEST), payload)

    def _sweep_pending(self) -> None:
        """Unlink runs replaced a full pass ago (see module docstring:
        the checkpoint-link grace — never inline with the swap)."""
        pending, self._pending_delete = self._pending_delete, []
        for name in pending:
            try:
                self._fs.delete(os.path.join(self.dir, name))
            except OSError:
                self._pending_delete.append(name)  # retry next pass

    # -- ingest ----------------------------------------------------------

    def absorb(self, keys: np.ndarray, panes: np.ndarray,
               data: Dict[str, np.ndarray]) -> None:
        self._delta.absorb(keys, panes, data)
        self._maybe_seal()

    def _maybe_seal(self) -> None:
        if not self._delta.panes:
            return
        if self._delta.bytes_used() > self.memory_budget_bytes:
            self._seal_delta()
            if len(self._runs) >= self.compact_min_runs:
                self.compact()

    def _rows_from_tables(
            self, tables: Dict[int, Tuple[np.ndarray, ...]]
    ) -> Optional[Dict[str, np.ndarray]]:
        """Pane tables → (pane, key)-sorted run rows with the key-group
        shard column (the rescale address)."""
        if not tables:
            return None
        from flink_tpu_torch.exchange.partitioners import hash_shards

        S, M, m = (self.agg.sum_width, self.agg.max_width,
                   self.agg.min_width)
        kk, pp, ss, xx, nn, cc = [], [], [], [], [], []
        for p in sorted(tables):
            k, s, x, n, c = tables[p]
            kk.append(np.asarray(k, np.int64))
            pp.append(np.full(len(k), p, np.int64))
            ss.append(s)
            xx.append(x)
            nn.append(n)
            cc.append(np.asarray(c, np.int64))
        key = np.concatenate(kk)
        pane = np.concatenate(pp)
        # panes already pane-major and key-sorted within (HostSpillStore
        # pane keys are sorted unions), so rows are (pane, key)-ordered
        cols: Dict[str, np.ndarray] = {
            "shard": hash_shards(key, self.num_shards),
            "key": key, "pane": pane,
            "count": np.concatenate(cc),
        }
        sums = np.concatenate(ss)
        maxs = np.concatenate(xx)
        mins = np.concatenate(nn)
        for i in range(S):
            cols[f"s{i}"] = np.ascontiguousarray(sums[:, i])
        for i in range(M):
            cols[f"x{i}"] = np.ascontiguousarray(maxs[:, i])
        for i in range(m):
            cols[f"n{i}"] = np.ascontiguousarray(mins[:, i])
        return cols

    def _write_run(self, cols: Dict[str, np.ndarray], level: int,
                   seal: bool = False) -> Dict[str, Any]:
        """Durable run write: tmp + close-time sync + rename + dir
        barrier. The manifest (NOT this file's existence) is what makes
        a run live — a crash here leaves sweepable debris only. A seal's
        write fires ``state.run.fsync`` between staging and sync."""
        self._seq += 1
        name = f"run-{self._seq:06d}.seg"
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        with open_write_sync(self._fs, tmp, sync=True) as f:
            w = ColumnarWriter(f, self.schema)
            w.write_batch(cols)
            if seal:
                # the barrier seam: bytes staged, durability pending
                faults.fire("state.run.fsync", exc=OSError, run=name)
            w.close()
        self._fs.rename(tmp, path)
        self._fs.fsync(self.dir)  # the rename's directory entry
        pane = cols["pane"]
        shard = cols["shard"]
        return {
            "name": name, "level": int(level), "seq": self._seq,
            "rows": int(len(pane)),
            "min_pane": int(pane.min()), "max_pane": int(pane.max()),
            "shard_lo": int(shard.min()), "shard_hi": int(shard.max()),
            "bytes": self._fs.size(path),
        }

    def _seal_delta(self) -> None:
        cols = self._rows_from_tables(self._delta.panes)
        if cols is None:
            return
        faults.fire("state.run.seal", exc=OSError, store=self.dir)
        meta = self._write_run(cols, level=0, seal=True)
        self._runs.append(meta)
        self._write_manifest()  # visibility point: run is live
        spilled = self._delta.records_spilled
        self._delta.panes = {}
        self._delta._pane_locks = {}
        self._delta.records_spilled = spilled  # lifetime count survives
        self.seals += 1
        self._sweep_pending()

    # -- run reads -------------------------------------------------------

    def _run_tables(self, meta: Dict[str, Any],
                    pane_lo: Optional[int] = None,
                    pane_hi: Optional[int] = None
                    ) -> Dict[int, Tuple[np.ndarray, ...]]:
        """Decode one run (zero-copy off mmap) into pane tables,
        optionally restricted to panes in [pane_lo, pane_hi) and always
        excluding panes below the purge floor."""
        S, M, m = (self.agg.sum_width, self.agg.max_width,
                   self.agg.min_width)
        image = _run_image(os.path.join(self.dir, meta["name"]))
        out: Dict[int, Tuple[np.ndarray, ...]] = {}
        for block in iter_blocks(image, expect_schema=self.schema,
                                 zero_copy=True):
            pane = block["pane"]
            mask = pane >= self._floor
            if pane_lo is not None:
                mask &= (pane >= pane_lo) & (pane < pane_hi)
            if not mask.any():
                continue
            pane = pane[mask]
            key = block["key"][mask]
            cnt = block["count"][mask]
            sums = (np.stack([block[f"s{i}"][mask] for i in range(S)],
                             axis=1) if S else
                    np.zeros((len(key), 0), np.float32))
            maxs = (np.stack([block[f"x{i}"][mask] for i in range(M)],
                             axis=1) if M else
                    np.zeros((len(key), 0), np.float32))
            mins = (np.stack([block[f"n{i}"][mask] for i in range(m)],
                             axis=1) if m else
                    np.zeros((len(key), 0), np.float32))
            # rows are (pane, key)-sorted: pane groups are contiguous
            # and keys arrive sorted within each — exactly the pane-
            # table invariant _merge_pane/_fire_window rely on
            bounds = np.flatnonzero(np.concatenate(
                [[True], pane[1:] != pane[:-1], [True]]))
            for i in range(len(bounds) - 1):
                a, b = int(bounds[i]), int(bounds[i + 1])
                p = int(pane[a])
                piece = (key[a:b], sums[a:b], maxs[a:b], mins[a:b],
                         cnt[a:b])
                if p in out:  # same pane split across blocks
                    got = out[p]
                    tmp = HostSpillStore(self.agg)
                    tmp.panes[p] = got
                    tmp._merge_pane(p, *piece)
                    out[p] = tmp.panes[p]
                else:
                    out[p] = piece
        return out

    def _fold_runs(self, runs: List[Dict[str, Any]],
                   pane_lo: Optional[int] = None,
                   pane_hi: Optional[int] = None,
                   include_delta: bool = False) -> HostSpillStore:
        """Monoid-fold runs (seal order) and optionally the delta
        (LAST) into a scratch store — the one fold order everything
        (fire, compact, rescale) shares, so float lane sums are
        bit-stable across tiering decisions."""
        scratch = HostSpillStore(self.agg)
        for meta in runs:
            for p, piece in self._run_tables(
                    meta, pane_lo, pane_hi).items():
                scratch._merge_pane(p, *piece)
        if include_delta:
            for p, (k, s, x, n, c) in self._delta.panes.items():
                if p < self._floor:
                    continue
                if pane_lo is not None and not (pane_lo <= p < pane_hi):
                    continue
                scratch._merge_pane(p, k, s, x, n, c)
        return scratch

    def _live_runs(self, pane_lo: Optional[int] = None,
                   pane_hi: Optional[int] = None) -> List[Dict[str, Any]]:
        out = []
        for meta in self._runs:
            if meta["max_pane"] < self._floor:
                continue
            if pane_lo is not None and (meta["max_pane"] < pane_lo
                                        or meta["min_pane"] >= pane_hi):
                continue
            out.append(meta)
        return out

    # -- fire ------------------------------------------------------------

    def fire(self, ends: List[int], panes_per_window: int, pane_ms: int,
             offset_ms: int, size_ms: int
             ) -> Optional[Dict[str, np.ndarray]]:
        if not ends:
            return None
        if not self._runs:  # pure-RAM fast path: exact delta semantics
            return self._delta.fire(ends, panes_per_window, pane_ms,
                                    offset_ms, size_ms)
        ppw = panes_per_window
        pane_lo = min(ends) - ppw
        pane_hi = max(ends)
        runs = self._live_runs(pane_lo, pane_hi)
        scratch = self._fold_runs(runs, pane_lo, pane_hi,
                                  include_delta=True)
        return scratch.fire(ends, ppw, pane_ms, offset_ms, size_ms)

    # -- maintenance -----------------------------------------------------

    def compact(self) -> bool:
        """Leveled compaction: fold EVERY live run (seal order — the
        fire-time fold prefix, so fired bytes never change) into one
        run at level max+1, publish by manifest swap, queue replaced
        files for the grace sweep. Serialized per store by the bus
        tier's maintenance lock. Returns False when another pass holds
        the lock (skip, retry at the next seal)."""
        from flink_tpu_torch.log.bus import LogError, maintenance_pass

        live = self._live_runs()
        if len(live) < 2:
            return False
        try:
            with maintenance_pass(self.dir):
                self._sweep_pending()
                scratch = self._fold_runs(live)
                cols = self._rows_from_tables(scratch.panes)
                replaced = [r["name"] for r in live]
                if cols is None:
                    self._runs = [r for r in self._runs
                                  if r["name"] not in replaced]
                else:
                    level = max(r["level"] for r in live) + 1
                    meta = self._write_run(cols, level=level)
                    self._runs = [r for r in self._runs
                                  if r["name"] not in replaced] + [meta]
                faults.fire("state.compact.swap", exc=OSError,
                            store=self.dir)
                self._write_manifest()  # visibility point (the swap)
                self._pending_delete.extend(replaced)
                self.compactions += 1
                return True
        except LogError:
            return False

    def purge_below(self, dead_pane: int) -> None:
        self._delta.purge_below(dead_pane)
        if dead_pane <= self._floor:
            return
        self._floor = int(dead_pane)
        dead = [r for r in self._runs if r["max_pane"] < self._floor]
        if not dead:
            # the floor itself persists lazily (next seal/compact swap
            # carries it) — a stale floor after warm restart only
            # retains a few dead panes, it can never refire them, and
            # purge runs per watermark advance: an fsync here would tax
            # the hot path for no correctness gain
            return
        names = {r["name"] for r in dead}
        self._runs = [r for r in self._runs if r["name"] not in names]
        self._write_manifest()
        self._pending_delete.extend(r["name"] for r in dead)

    # -- accounting ------------------------------------------------------

    @property
    def records_spilled(self) -> int:
        return self._delta.records_spilled

    @records_spilled.setter
    def records_spilled(self, v: int) -> None:
        self._delta.records_spilled = int(v)

    def bytes_used(self) -> int:
        """Delta RAM + sealed run bytes (the tier's full footprint)."""
        return self._delta.bytes_used() + sum(
            int(r["bytes"]) for r in self._runs)

    @property
    def run_count(self) -> int:
        return len(self._runs)

    @property
    def key_count(self) -> int:
        ks = [t[0] for t in self._delta.panes.values()]
        for meta in self._live_runs():
            ks.extend(t[0] for t in self._run_tables(meta).values())
        if not ks:
            return 0
        return len(np.unique(np.concatenate(ks)))

    # -- checkpoint / restore --------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The CHANGELOG cut: inline delta + run NAMES. ``aux_files``
        is the contract with the checkpoint plane — the operator lifts
        it to ``__aux_files__`` and storage.save_v2 hardlinks each
        (immutable, already-durable) run into the checkpoint directory
        instead of re-serializing state, so checkpoint bytes track the
        write rate, not the key domain."""
        return {
            "kind": "lsm",
            "delta": self._delta.snapshot(),
            "runs": [dict(r) for r in self._runs],
            "seq": self._seq,
            "purged_below": self._floor,
            "num_shards": self.num_shards,
            "records_spilled": self._delta.records_spilled,
            "aux_files": {r["name"]: os.path.join(self.dir, r["name"])
                          for r in self._runs},
        }

    def restore(self, snap: Optional[Dict[str, Any]],
                aux_paths: Optional[Dict[str, str]] = None) -> None:
        """Rebuild the tier from a snapshot of either package. Accepts
        the lsm form (delta + named runs; ``aux_paths`` maps run name →
        source file, normally the checkpoint directory's hardlinks) or
        a plain ``HostSpillStore`` snapshot (``{"panes": ...}``) so a
        job may flip state.backend spill→lsm across a restore."""
        self._runs = []
        self._pending_delete = []
        if snap is None:
            self._delta.panes = {}
            self._delta.records_spilled = 0
            self._floor = 0
            self._write_manifest()
            self._sweep_orphans()
            return
        if snap.get("kind") != "lsm":
            self._delta.restore(snap)  # RAM-spill snapshot adoption
            self._floor = 0
            self._write_manifest()
            self._sweep_orphans()
            self._maybe_seal()
            return
        self._delta.restore(snap["delta"])
        self._delta.records_spilled = int(snap.get(
            "records_spilled", self._delta.records_spilled))
        self._floor = int(snap.get("purged_below", 0))
        self._seq = max(self._seq, int(snap.get("seq", 0)))
        aux = dict(snap.get("aux_files") or {})
        aux.update(aux_paths or {})
        for meta in snap.get("runs", []):
            meta = dict(meta)
            name = meta["name"]
            dst = os.path.join(self.dir, name)
            src = aux.get(name)
            if src and os.path.abspath(src) != os.path.abspath(dst):
                self._fs.link_or_copy(src, dst)
            elif not self._fs.exists(dst):
                raise ValueError(
                    f"lsm restore: run {name!r} named by the snapshot "
                    f"has no source (no aux path, not in {self.dir}) — "
                    "restore from the checkpoint directory that owns "
                    "the changelog files")
            self._runs.append(meta)
        self._fs.fsync(self.dir)
        self._write_manifest()
        self._sweep_orphans()
        self._maybe_seal()


# -- rescale (called by checkpoint/repartition.py's _merge_lsm_spill) --------

class _LaneWidths:
    """Width-only aggregate shim: the scratch merge below needs the
    lane contract's widths and nothing else of the aggregate."""

    def __init__(self, sum_width: int, max_width: int,
                 min_width: int) -> None:
        self.sum_width = sum_width
        self.max_width = max_width
        self.min_width = min_width


def _decode_run_panes(path: str, floor: int
                      ) -> List[Tuple[int, Tuple[np.ndarray, ...]]]:
    """Decode a run file into per-pane ``(keys, sums, maxs, mins,
    counts, shards)`` tuples using the lane widths recorded in its OWN
    schema — rescale runs in a tool/merge process that has no
    aggregate object to ask."""
    from flink_tpu_torch.formats_columnar import read_schema

    image = _run_image(path)
    names = [n for n, _ in read_schema(image)]
    S = sum(1 for n in names if n[0] == "s" and n[1:].isdigit())
    M = sum(1 for n in names if n[0] == "x" and n[1:].isdigit())
    m = sum(1 for n in names if n[0] == "n" and n[1:].isdigit())
    out: List[Tuple[int, Tuple[np.ndarray, ...]]] = []
    for block in iter_blocks(image, zero_copy=True):
        pane = np.asarray(block["pane"])
        mask = pane >= floor
        if not mask.any():
            continue
        pane = pane[mask]
        key = np.asarray(block["key"])[mask]
        shard = np.asarray(block["shard"])[mask]
        cnt = np.asarray(block["count"])[mask]
        sums = (np.stack([np.asarray(block[f"s{i}"])[mask]
                          for i in range(S)], axis=1) if S else
                np.zeros((len(key), 0), np.float32))
        maxs = (np.stack([np.asarray(block[f"x{i}"])[mask]
                          for i in range(M)], axis=1) if M else
                np.zeros((len(key), 0), np.float32))
        mins = (np.stack([np.asarray(block[f"n{i}"])[mask]
                          for i in range(m)], axis=1) if m else
                np.zeros((len(key), 0), np.float32))
        bounds = np.flatnonzero(np.concatenate(
            [[True], pane[1:] != pane[:-1], [True]]))
        for i in range(len(bounds) - 1):
            a, b = int(bounds[i]), int(bounds[i + 1])
            out.append((int(pane[a]),
                        (key[a:b], sums[a:b], maxs[a:b], mins[a:b],
                         cnt[a:b], shard[a:b])))
    return out


def merge_rescale_spill(parts, *, num_shards: int, shard_lo: int,
                        shard_hi: int) -> Dict[str, Any]:
    """Key-group repartition of lsm spill snapshots — the reason run
    rows carry a shard column.

    ``parts``: one ``(spill_snapshot, aux_paths)`` pair per OLD process
    in old-pid order (``aux_paths`` maps run name → file path, the
    savepoint's changelog hardlinks; ``None`` entries are processes
    with no lsm spill). Each process's state folds in the store's ONE
    fold order — runs in seal order, delta last — keeping only rows
    whose key-group lands in ``[shard_lo, shard_hi)``; run rows filter
    by their stored shard column, delta keys re-hash. Old processes
    own disjoint key sets, so the cross-process fold order cannot
    change any float lane.

    Returns a PURE-DELTA lsm snapshot (no runs): the restoring store
    re-seals under its own budget, so no run file crosses the cut and
    the merged payload stays self-contained.
    """
    from flink_tpu_torch.exchange.partitioners import hash_shards

    scratch: Optional[HostSpillStore] = None
    records = 0
    floors: List[int] = []

    def _scr(s: np.ndarray, x: np.ndarray, n: np.ndarray
             ) -> HostSpillStore:
        nonlocal scratch
        if scratch is None:
            scratch = HostSpillStore(_LaneWidths(
                s.shape[1], x.shape[1], n.shape[1]))
        return scratch

    for snap, aux in parts:
        if not snap:
            continue
        floor = int(snap.get("purged_below", 0))
        floors.append(floor)
        records += int(snap.get("records_spilled", 0))
        for meta in snap.get("runs", []):
            path = (aux or {}).get(meta["name"])
            if path is None:
                raise ValueError(
                    f"lsm rescale: run {meta['name']!r} named by the "
                    "snapshot has no aux path — merge savepoints "
                    "written by the changelog plane (save_v2), whose "
                    "manifests carry the run hardlinks")
            for p, (k, s, x, n, c, sh) in _decode_run_panes(path, floor):
                keep = (sh >= shard_lo) & (sh < shard_hi)
                if not keep.any():
                    continue
                _scr(s, x, n)._merge_pane(
                    p, k[keep], s[keep], x[keep], n[keep], c[keep])
        delta = snap.get("delta") or {}
        for p, tab in (delta.get("panes") or {}).items():
            p = int(p)
            if p < floor:
                continue
            k, s, x, n, c = (np.asarray(a) for a in tab)
            sh = hash_shards(np.asarray(k, np.int64), num_shards)
            keep = (sh >= shard_lo) & (sh < shard_hi)
            if not keep.any():
                continue
            _scr(s, x, n)._merge_pane(
                p, k[keep], s[keep], x[keep], n[keep], c[keep])
    panes = ({} if scratch is None
             else {int(p): t for p, t in scratch.panes.items()})
    return {
        "kind": "lsm",
        "delta": {"panes": panes, "records_spilled": records},
        "runs": [], "seq": 0,
        "purged_below": min(floors) if floors else 0,
        "num_shards": num_shards,
        "records_spilled": records,
    }
