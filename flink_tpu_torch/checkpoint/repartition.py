"""Key-group state repartition for process-level rescale (N -> M), the
JAX package's ``checkpoint/repartition.py``: host numpy in both
packages, over either package's checkpoint payloads.

ref role: StateAssignmentOperation — on rescale the reference re-splits
every operator's key-group ranges across the new subtask set. Here the
key-group space is ``state.num-key-shards`` (fixed, the maxParallelism
contract) and a PROCESS owns a contiguous shard span [p*spp, (p+1)*spp);
rescaling from N_old to N_new processes therefore moves whole shard
spans, never single keys (exchange/partitioners.hybrid_route is the one
routing truth both planes share).

The unit of work is a SAVEPOINT SET: one self-contained savepoint per
OLD process, all taken at the same DCN rendezvous barrier (a globally
consistent cut). ``merge_payloads`` fuses the set into ONE driver
payload restorable by a single NEW process — called once per new
process, each call slicing its own key-group range out of the merged
global state.

Merge rules by operator layout:

- device window ops (factory kind "window"): pane arrays are blocked
  per device (n_dev blocks of slots_local+1 rows, the +1 a dump row).
  De-block each payload, concatenate the old processes' shard spans
  into the global logical slot axis, slice the new range, and emit as
  one n_dev=1 block with a fresh dump row — restore_state re-blocks to
  the restoring mesh's device count (``_reblock_panes``).
- full-width slot ops (process, cep, count_window, global_agg, and the
  window sides of an aggregate-mode join): arrays span ALL shards but
  each old process only populated its own span — splice the owner's
  span per shard range.
- columnar host state (session columns, pairs-join side buffers,
  evicting-window bufs): concatenate rows and keep only keys whose
  shard (splitmix64 % num_shards) lands in the new range.
- KeyDirectory: rev arrays merge at the snapshot level (they are
  shard-major, so spans splice contiguously); next_free is global
  shard-indexed and splices per span. No directory code changes.
- timers (KeyedProcessOperator): slots are global (shard*sps + ix) and
  survive the splice unchanged; filtering to the new range is what
  prevents two new processes from both firing the same key's timer.

RAM-spilled window state (state.backend='spill' with live host panes)
does not repartition — the spill ledger is keyed by local pane id and
has no shard-major layout to splice; merge_payloads raises rather than
silently dropping it (see COMPONENTS.md for the residue). The DISK
tier (state.backend='lsm') DOES repartition: run rows carry their
key-group shard, so the merge filters each old process's runs + delta
to the new range and emits a pure-delta lsm snapshot
(_merge_lsm_spill / state/lsm.py merge_rescale_spill).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.exchange.partitioners import hash_shards

__all__ = ["merge_payloads", "RescaleError"]


class RescaleError(RuntimeError):
    """A savepoint set that cannot be repartitioned (geometry mismatch,
    unsupported state layout). Deliberately loud: a silent partial merge
    would drop keyed state."""


class _Geo:
    """Shard-space geometry shared by every merge rule."""

    def __init__(self, n_old: int, new_pid: int, new_nproc: int,
                 num_shards: int, slots_per_shard: int) -> None:
        if num_shards % n_old or num_shards % new_nproc:
            raise RescaleError(
                f"state.num-key-shards ({num_shards}) must divide by both "
                f"the old ({n_old}) and new ({new_nproc}) process counts")
        self.n_old = n_old
        self.num_shards = num_shards
        self.sps = slots_per_shard
        self.spp_old = num_shards // n_old
        spp_new = num_shards // new_nproc
        self.new_lo = new_pid * spp_new
        self.new_hi = (new_pid + 1) * spp_new
        self.R = num_shards * slots_per_shard

    # slot-axis span of old process o (global slot ids)
    def slot_span(self, o: int):
        return o * self.spp_old * self.sps, (o + 1) * self.spp_old * self.sps

    # shard-axis span of old process o
    def shard_span(self, o: int):
        return o * self.spp_old, (o + 1) * self.spp_old

    @property
    def tgt_slot_lo(self) -> int:
        return self.new_lo * self.sps

    @property
    def tgt_slot_hi(self) -> int:
        return self.new_hi * self.sps


def _splice_slots(arrs: Sequence[np.ndarray], g: _Geo) -> np.ndarray:
    """Full-width slot-indexed arrays (first dim == num_shards*sps):
    take each old owner's populated span, in shard order."""
    parts = []
    for o, a in enumerate(arrs):
        a = np.asarray(a)
        if a.shape[0] != g.R:
            raise RescaleError(
                f"slot array of length {a.shape[0]} != num_shards * "
                f"slots_per_shard ({g.R}) — geometry drifted across the "
                "savepoint set")
        lo, hi = g.slot_span(o)
        parts.append(a[lo:hi])
    return np.concatenate(parts)


def _splice_shards(arrs: Sequence[np.ndarray], g: _Geo) -> np.ndarray:
    """Global shard-indexed arrays (length num_shards), e.g. the
    directory's next_free."""
    parts = []
    for o, a in enumerate(arrs):
        lo, hi = g.shard_span(o)
        parts.append(np.asarray(a)[lo:hi])
    return np.concatenate(parts)


def _clear_outside_range(arr: np.ndarray, lo: int, hi: int, fill) -> None:
    """Zero a merged global array outside the new process's span — keys
    there belong to a sibling; keeping them would double-count metrics
    (directory occupancy) or, for self-firing state, double-emit."""
    arr[:lo] = fill
    arr[hi:] = fill


def _opt_min(vals):
    vs = [v for v in vals if v is not None]
    return min(vs) if vs else None


def _opt_max(vals):
    vs = [v for v in vals if v is not None]
    return max(vs) if vs else None


# -- KeyDirectory ----------------------------------------------------------

def _merge_directory(snaps: Sequence[Dict[str, np.ndarray]], g: _Geo,
                     src_ranged: bool, tgt_ranged: bool) -> Dict[str, Any]:
    """Snapshot-level merge: rev arrays are shard-major so old spans
    concatenate into the global reverse map; restore() rebuilds the
    hash table from them (state/keyed.py), so no directory class change
    is needed."""
    if src_ranged:
        # each payload's rev arrays ARE its span, already in shard order
        rev_keys = np.concatenate([np.asarray(s["rev_keys"]) for s in snaps])
        rev_used = np.concatenate([np.asarray(s["rev_used"]) for s in snaps])
        if rev_keys.shape[0] != g.R:
            raise RescaleError(
                f"ranged directory spans sum to {rev_keys.shape[0]} slots, "
                f"expected {g.R}")
    else:
        rev_keys = _splice_slots([s["rev_keys"] for s in snaps], g)
        rev_used = _splice_slots([s["rev_used"] for s in snaps], g)
    next_free = _splice_shards([s["next_free"] for s in snaps], g)
    _clear_outside_range(next_free, g.new_lo, g.new_hi, 0)
    if tgt_ranged:
        rev_keys = rev_keys[g.tgt_slot_lo:g.tgt_slot_hi]
        rev_used = rev_used[g.tgt_slot_lo:g.tgt_slot_hi]
    else:
        _clear_outside_range(rev_keys, g.tgt_slot_lo, g.tgt_slot_hi, 0)
        _clear_outside_range(rev_used, g.tgt_slot_lo, g.tgt_slot_hi, False)
    return {"rev_keys": rev_keys, "rev_used": rev_used,
            "next_free": next_free}


# -- timers (KeyedProcessOperator) ----------------------------------------

def _merge_timers(snaps: Sequence[Dict[str, Any]], g: _Geo) -> Dict[str, Any]:
    slots_l: List[np.ndarray] = []
    ts_l: List[np.ndarray] = []
    for o, t in enumerate(snaps):
        s = np.asarray(t["slots"], np.int64)
        ts = np.asarray(t["ts"], np.int64)
        lo, hi = g.slot_span(o)
        m = (s >= lo) & (s < hi)  # a timer belongs to its slot's owner
        slots_l.append(s[m])
        ts_l.append(ts[m])
    s = np.concatenate(slots_l)
    ts = np.concatenate(ts_l)
    m = (s >= g.tgt_slot_lo) & (s < g.tgt_slot_hi)
    s, ts = s[m], ts[m]
    order = np.lexsort((s, ts))  # TimerService fire order: (ts, slot)
    return {"slots": s[order], "ts": ts[order], "deleted": []}


# -- per-kind operator merges ----------------------------------------------

def _deblock(arr: np.ndarray, n_dev: int) -> np.ndarray:
    """Drop each device block's dump row and concatenate the blocks
    back into the logical (total_slots, ...) axis (inverse of the
    per-block layout _reblock_panes emits)."""
    arr = np.asarray(arr)
    rpl = arr.shape[0] // n_dev
    return np.concatenate(
        [arr[d * rpl:(d + 1) * rpl - 1] for d in range(n_dev)])


_PANE_FILLS = {"sums": 0.0, "maxs": -np.inf, "mins": np.inf, "counts": 0}


def _merge_window(snaps: Sequence[Dict[str, Any]], g: _Geo,
                  tgt_ranged: bool) -> Dict[str, Any]:
    from flink_tpu_torch.state.keyed import PaneState

    lsm_parts = []
    for s in snaps:
        sp = s.get("spill")
        if sp and sp.get("kind") == "lsm":
            # key-group-addressed tier (state/lsm.py): run rows carry
            # their shard, so the spill merges by filtering — see
            # _merge_lsm_spill below
            if int(sp.get("num_shards", g.num_shards)) != g.num_shards:
                raise RescaleError(
                    f"lsm spill was written with num_shards="
                    f"{sp['num_shards']} but the merge targets "
                    f"{g.num_shards} — state.num-key-shards is the "
                    "maxParallelism contract and cannot change")
            lsm_parts.append((sp, {**(sp.get("aux_files") or {}),
                                   **(s.get("__aux_files__") or {}),
                                   **(s.get("__aux_paths__") or {})}))
        elif sp and sp.get("panes"):
            raise RescaleError(
                "cannot repartition spilled window state "
                f"({len(sp['panes'])} live host pane(s)): the RAM spill "
                "ledger has no shard-major layout to re-split. Let the "
                "spill drain (lateness horizon) before rescaling, or "
                "use state.backend='lsm' (key-group-addressed runs "
                "rescale) or 'hbm'.")
    rings = sorted({int(s["ring"]) for s in snaps})
    if len(rings) != 1:
        raise RescaleError(
            f"pane rings diverged across the savepoint set ({rings}): an "
            "auto-grown ring is process-local and ring-indexed state "
            "cannot be spliced across geometries. Redeploy with the "
            "larger ring (raise allowed lateness) and re-savepoint.")
    per: List[Dict[str, Optional[np.ndarray]]] = []
    for s in snaps:
        pan = s["panes"]
        n_dev = int(s.get("n_dev", 1))
        per.append({f: (None if getattr(pan, f) is None
                        else _deblock(getattr(pan, f), n_dev))
                    for f in _PANE_FILLS})
    l0 = per[0]["counts"].shape[0]
    if l0 == g.R:
        src_ranged = False
    elif l0 == g.spp_old * g.sps:
        src_ranged = True
    else:
        raise RescaleError(
            f"window pane axis has {l0} logical slots; expected "
            f"{g.R} (full) or {g.spp_old * g.sps} (per-process span)")
    merged: Dict[str, Optional[np.ndarray]] = {}
    for f, fill in _PANE_FILLS.items():
        arrs = [d[f] for d in per]
        if arrs[0] is None:
            merged[f] = None
            continue
        if src_ranged:
            glob = np.concatenate(arrs)
        else:
            glob = _splice_slots(arrs, g)
        if tgt_ranged:
            glob = glob[g.tgt_slot_lo:g.tgt_slot_hi]
        dump = np.full((1,) + glob.shape[1:], fill, dtype=glob.dtype)
        merged[f] = np.concatenate([glob, dump])
    return {
        "spill": _merge_lsm_spill(lsm_parts, g),
        "n_dev": 1,  # restore re-blocks to the restoring mesh
        "ring": rings[0],
        "panes": PaneState(sums=merged["sums"], maxs=merged["maxs"],
                           mins=merged["mins"], counts=merged["counts"]),
        "directory": _merge_directory(
            [s["directory"] for s in snaps], g,
            src_ranged=src_ranged, tgt_ranged=tgt_ranged),
        # the cut is one rendezvous barrier, so the fleet agreed on the
        # clock; min/max below only matter for the data-dependent fields
        "watermark": min(s["watermark"] for s in snaps),
        "cleared_below": min(s["cleared_below"] for s in snaps),
        "fired_below_end": _opt_max(
            [s["fired_below_end"] for s in snaps]),
        "min_pane_seen": _opt_min([s["min_pane_seen"] for s in snaps]),
        "max_pane_seen": _opt_max([s["max_pane_seen"] for s in snaps]),
        "refire": sorted(set().union(*[set(s["refire"]) for s in snaps])),
        "late_records": sum(int(s["late_records"]) for s in snaps),
        "records_dropped_full": sum(
            int(s.get("records_dropped_full", 0)) for s in snaps),
    }


def _merge_lsm_spill(parts, g: _Geo) -> Optional[Dict[str, Any]]:
    """Fuse the old processes' lsm spill tiers into one pure-delta lsm
    snapshot for the new range (state/lsm.py merge_rescale_spill): run
    rows filter by their stored key-group column, delta keys re-hash —
    the disk tier rescales where the RAM spill ledger cannot."""
    if not parts:
        return None
    from flink_tpu_torch.state.lsm import merge_rescale_spill

    try:
        return merge_rescale_spill(parts, num_shards=g.num_shards,
                                   shard_lo=g.new_lo, shard_hi=g.new_hi)
    except (ValueError, OSError) as e:
        raise RescaleError(f"lsm spill merge failed: {e}") from e


def _merge_session(snaps: Sequence[Dict[str, Any]], g: _Geo) -> Dict[str, Any]:
    cols_list = [s["columns"] for s in snaps]
    names = list(cols_list[0])
    cols = {c: np.concatenate([np.asarray(cl[c]) for cl in cols_list])
            for c in names}
    sh = hash_shards(cols["key"], g.num_shards)
    m = (sh >= g.new_lo) & (sh < g.new_hi)
    cols = {c: v[m] for c, v in cols.items()}
    order = np.lexsort((cols["start"], cols["key"]))  # _merged_columns order
    return {
        "watermark": min(s["watermark"] for s in snaps),
        "late_records": sum(int(s["late_records"]) for s in snaps),
        "columns": {c: v[order] for c, v in cols.items()},
    }


def _merge_states(snaps: Sequence[Dict[str, Any]], g: _Geo) -> Dict[str, Any]:
    """KeyedProcessOperator named-state columns. State registers lazily
    on first use, so a name may exist on only SOME old processes — the
    missing spans fill with the descriptor's defaults."""
    names: Dict[str, tuple] = {}
    for s in snaps:
        for n, (cls_name, desc, _) in s.items():
            names.setdefault(n, (cls_name, desc))
    out = {}
    for n, (cls_name, desc) in names.items():
        cols, stamps = [], []
        any_stamp = any(n in s and s[n][2]["stamp"] is not None
                        for s in snaps)
        for s in snaps:
            if n in s:
                cols.append(np.asarray(s[n][2]["col"]))
                st = s[n][2]["stamp"]
                stamps.append(None if st is None else np.asarray(st))
            else:
                if cls_name == "ValueStateVector":
                    cols.append(np.full(g.R, desc.default, desc.dtype))
                else:
                    cols.append(np.empty(g.R, object))
                stamps.append(None)
        col = _splice_slots(cols, g)
        stamp = None
        if any_stamp:
            stamp = _splice_slots(
                [st if st is not None else np.zeros(g.R, np.int64)
                 for st in stamps], g)
        out[n] = (cls_name, desc, {"col": col, "stamp": stamp})
    return out


def _merge_process(snaps: Sequence[Dict[str, Any]], g: _Geo) -> Dict[str, Any]:
    return {
        "kind": "process",
        "directory": _merge_directory(
            [s["directory"] for s in snaps], g,
            src_ranged=False, tgt_ranged=False),
        # timers self-fire on the watermark — filtering them to the new
        # range is what keeps two new processes from both firing a key
        "timers": _merge_timers([s["timers"] for s in snaps], g),
        "proc_timers": _merge_timers(
            [s.get("proc_timers") or
             {"slots": np.zeros(0, np.int64), "ts": np.zeros(0, np.int64)}
             for s in snaps], g),
        "watermark": min(s["watermark"] for s in snaps),
        "late_records": sum(int(s["late_records"]) for s in snaps),
        "records_dropped_full": sum(
            int(s["records_dropped_full"]) for s in snaps),
        "states": _merge_states([s["states"] for s in snaps], g),
    }


def _merge_cep(snaps: Sequence[Dict[str, Any]], g: _Geo) -> Dict[str, Any]:
    def splice(field):
        arrs = [s[field] for s in snaps]
        if arrs[0] is None:
            return None
        return _splice_slots(arrs, g)

    return {
        "kind": "cep",
        "directory": _merge_directory(
            [s["directory"] for s in snaps], g,
            src_ranged=False, tgt_ranged=False),
        "stage": splice("stage"),
        "stage_ts": splice("stage_ts"),
        "loop_cnt": splice("loop_cnt"),
        "loop_last": splice("loop_last"),
        "last_ts": splice("last_ts"),
        "p_stage": splice("p_stage"),
        "p_ts": splice("p_ts"),
        "watermark": min(s["watermark"] for s in snaps),
        "late_records": sum(int(s["late_records"]) for s in snaps),
        "records_dropped_full": sum(
            int(s["records_dropped_full"]) for s in snaps),
    }


_COUNT_FILLS = (0.0, -np.inf, np.inf, 0, 0)


def _merge_count_window(snaps: Sequence[Dict[str, Any]],
                        g: _Geo) -> Dict[str, Any]:
    arrays = []
    for i, fill in enumerate(_COUNT_FILLS):
        # (R + 1, ...): body is slot-indexed, row R is the dump row
        bodies = [np.asarray(s["arrays"][i])[:g.R] for s in snaps]
        body = _splice_slots(bodies, g)
        dump = np.full((1,) + body.shape[1:], fill, dtype=body.dtype)
        arrays.append(np.concatenate([body, dump]))
    return {
        "kind": "count_window",
        "arrays": tuple(arrays),
        "directory": _merge_directory(
            [s["directory"] for s in snaps], g,
            src_ranged=False, tgt_ranged=False),
        "watermark": min(s["watermark"] for s in snaps),
        "late_records": sum(int(s["late_records"]) for s in snaps),
        "records_dropped_full": sum(
            int(s.get("records_dropped_full", 0)) for s in snaps),
    }


def _merge_global_agg(snaps: Sequence[Dict[str, Any]],
                      g: _Geo) -> Dict[str, Any]:
    out = {
        "kind": "global_agg",
        "directory": _merge_directory(
            [s["directory"] for s in snaps], g,
            src_ranged=False, tgt_ranged=False),
        "counts": _splice_slots([s["counts"] for s in snaps], g),
        "sums": _splice_slots([s["sums"] for s in snaps], g),
        "maxs": _splice_slots([s["maxs"] for s in snaps], g),
        "mins": _splice_slots([s["mins"] for s in snaps], g),
        "watermark": min(s["watermark"] for s in snaps),
        "records_dropped_full": sum(
            int(s.get("records_dropped_full", 0)) for s in snaps),
    }
    # retract mode adds last-emitted bookkeeping; absent on append-mode
    # snapshots (and pre-retract checkpoints), so splice conditionally
    for field in ("prev_counts", "prev_sums", "prev_maxs", "prev_mins",
                  "emitted"):
        if field in snaps[0]:
            out[field] = _splice_slots([s[field] for s in snaps], g)
    return out


def _merge_evicting(snaps: Sequence[Dict[str, Any]], g: _Geo) -> Dict[str, Any]:
    keep = []
    for s in snaps:
        for b in s["bufs"]:
            sh = int(hash_shards(
                np.asarray([b["key"]], np.int64), g.num_shards)[0])
            if g.new_lo <= sh < g.new_hi:
                keep.append(b)
    return {
        "kind": "evicting_window",
        "watermark": min(s["watermark"] for s in snaps),
        "late_records": sum(int(s["late_records"]) for s in snaps),
        "bufs": keep,
    }


def _merge_side_buffer(snaps: Sequence[Dict[str, Any]],
                       g: _Geo) -> Dict[str, Any]:
    """Pairs-join _SideBuffer: ragged (pane, key, cols) rows. Each key
    lives on exactly ONE old process, so concatenation preserves per-key
    insertion order (the join's stable argsort keeps it)."""
    panes = np.concatenate([np.asarray(s["panes"]) for s in snaps])
    keys = np.concatenate([np.asarray(s["keys"], np.int64) for s in snaps])
    names = list(snaps[0]["cols"])
    cols = {f: np.concatenate([np.asarray(s["cols"][f]) for s in snaps])
            for f in names}
    sh = hash_shards(keys, g.num_shards)
    m = (sh >= g.new_lo) & (sh < g.new_hi)
    return {"panes": panes[m], "keys": keys[m],
            "cols": {f: v[m] for f, v in cols.items()}}


def _merge_join(snaps: Sequence[Dict[str, Any]], g: _Geo) -> Dict[str, Any]:
    mode = snaps[0].get("mode", "aggregate")
    if mode == "aggregate":
        return {
            "mode": "aggregate",
            # aggregate-mode sides are full-width WindowOperators (no
            # mesh, no shard range — see WindowJoinOperator.__init__)
            "left": _merge_window([s["left"] for s in snaps], g,
                                  tgt_ranged=False),
            "right": _merge_window([s["right"] for s in snaps], g,
                                   tgt_ranged=False),
        }
    out = {
        "mode": "pairs",
        "left": _merge_side_buffer([s["left"] for s in snaps], g),
        "right": _merge_side_buffer([s["right"] for s in snaps], g),
        # HostPaneControl fields ride the top level (ctl.snapshot())
        "watermark": min(s["watermark"] for s in snaps),
        "late_records": sum(int(s["late_records"]) for s in snaps),
        "refire": sorted(set().union(*[set(s["refire"]) for s in snaps])),
        "cleared_below": min(s["cleared_below"] for s in snaps),
        "fired_below_end": _opt_max([s["fired_below_end"] for s in snaps]),
        "min_pane_seen": _opt_min([s["min_pane_seen"] for s in snaps]),
        "max_pane_seen": _opt_max([s["max_pane_seen"] for s in snaps]),
    }
    return out


def _merge_operator(kind: str, snaps: Sequence[Dict[str, Any]], g: _Geo,
                    new_nproc: int) -> Any:
    if kind == "window":
        # the factory hands shard_range to the window op only when the
        # job runs multi-process — the target layout follows suit
        return _merge_window(snaps, g, tgt_ranged=new_nproc > 1)
    if kind == "session":
        return _merge_session(snaps, g)
    if kind == "process":
        return _merge_process(snaps, g)
    if kind == "cep":
        return _merge_cep(snaps, g)
    if kind == "count_window":
        return _merge_count_window(snaps, g)
    if kind == "global_agg":
        return _merge_global_agg(snaps, g)
    if kind == "evicting_window":
        return _merge_evicting(snaps, g)
    if kind == "join":
        return _merge_join(snaps, g)
    raise RescaleError(
        f"no repartition rule for keyed operator kind {kind!r} — "
        "teach checkpoint/repartition.py its snapshot layout before "
        "rescaling jobs that use it")


# keyless operators whose snapshots carry no shard-partitioned state:
# every old process holds an equivalent (or process-local) copy; the
# merged payload takes the min-watermark holder's snapshot verbatim
_KEYLESS_KINDS = frozenset({"window_all", "async_io", "broadcast_connect"})


def merge_payloads(payloads: Sequence[Dict[str, Any]], *, new_pid: int,
                   new_nproc: int, num_shards: int, slots_per_shard: int,
                   op_kinds: Dict[Any, str]) -> Dict[str, Any]:
    """Fuse one savepoint per OLD process (old-pid order) into a single
    restorable payload for NEW process ``new_pid`` of ``new_nproc``.

    ``op_kinds`` maps operator node id -> plan kind (the merge rule
    dispatch). Driver-level state merges too: split positions come from
    each split's old owner (owner of split s = s % N_old, the strided
    enumeration contract), watermark state takes the fleet min, and
    staged 2PC sink epochs are dropped — the savepoint committed them
    synchronously before the set was complete."""
    if not payloads:
        raise RescaleError("empty savepoint set")
    n_old = len(payloads)
    for o, p in enumerate(payloads):
        ident = p.get("rescale") or {}
        if ident and int(ident.get("nproc", n_old)) != n_old:
            raise RescaleError(
                f"savepoint set has {n_old} payloads but payload {o} was "
                f"written by a {ident['nproc']}-process fleet")
        if ident and int(ident.get("pid", o)) != o:
            raise RescaleError(
                f"savepoint set out of order: payload {o} carries "
                f"pid {ident['pid']} (sort by -p<pid>/ before merging)")
    g = _Geo(n_old, new_pid, new_nproc, num_shards, slots_per_shard)

    ops: Dict[Any, Any] = {}
    for nid, kind in op_kinds.items():
        snaps = [p["operators"][nid] for p in payloads
                 if nid in p["operators"]]
        if not snaps:
            continue
        if len(snaps) != n_old:
            raise RescaleError(
                f"operator {nid!r} missing from part of the savepoint "
                f"set ({len(snaps)}/{n_old} payloads)")
        if kind in _KEYLESS_KINDS:
            ops[nid] = snaps[0]
        else:
            ops[nid] = _merge_operator(kind, snaps, g, new_nproc)

    # driver plane: positions/wm per split from its old OWNER (strided
    # split enumeration: owner of split s at N processes is s % N)
    positions: Dict[Any, Dict[int, int]] = {}
    wm_gens: Dict[Any, list] = {}
    for sid, pos0 in payloads[0]["sources"].items():
        merged_pos: Dict[int, int] = {}
        for i in pos0:
            owner = int(i) % n_old
            merged_pos[i] = payloads[owner]["sources"][sid][i]
        positions[sid] = merged_pos
        gens0 = payloads[0].get("wm_gens", {}).get(sid, [])
        wm_gens[sid] = [payloads[int(i) % n_old]["wm_gens"][sid][int(i)]
                        for i in range(len(gens0))]

    max_ts = {}
    out_wm = {}
    for sid in payloads[0].get("max_ts", {}):
        max_ts[sid] = max(p["max_ts"][sid] for p in payloads)
    for sid in payloads[0].get("out_wm", {}):
        out_wm[sid] = min(p["out_wm"][sid] for p in payloads)

    metrics: Dict[str, Any] = {}
    for p in payloads:
        for k, v in p.get("metrics", {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                metrics[k] = metrics.get(k, 0) + v
            else:
                metrics.setdefault(k, v)

    return {
        "sources": positions,
        "sub_factors": dict(payloads[0].get("sub_factors", {})),
        "wm_gens": wm_gens,
        "max_ts": max_ts,
        "out_wm": out_wm,
        "operators": ops,
        "op_versions": dict(payloads[0].get("op_versions", {})),
        # round-robin/shuffle counters reset on rescale (keyed routing
        # is stateless hash — unaffected)
        "partitioners": {},
        # staged 2PC epochs were committed by the savepoint itself; an
        # uncommitted epoch cannot survive into the set (checkpoint_now
        # is synchronous) — nothing to re-commit here
        "sinks": {},
        "metrics": metrics,
        "checkpoint_id": max(
            int(p.get("checkpoint_id", 0)) for p in payloads),
        # the merged payload restores THIS identity; a later restore of
        # the same file re-checks it (driver _run_loop)
        "rescale": {"nproc": new_nproc, "pid": new_pid,
                    "num_shards": num_shards,
                    "shard_range": [g.new_lo, g.new_hi]},
    }
