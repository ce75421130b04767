"""State processor — offline read/modify/write of checkpoints, the JAX
package's ``state_processor.py``: it reads and writes through the
port's ``checkpoint/storage.py``, so what it writes is the checkpoint
format both packages restore.

ref: flink-libraries/flink-state-processor-api (SavepointReader /
SavepointWriter: load a savepoint as datasets, transform operator
state, write a new savepoint a job can restore from).

Operator state here is columnar already (pane tensors,
numpy directories, struct-of-arrays), so the "dataset view" is just the
snapshot dicts themselves — no serializer gymnastics. The processor
loads a checkpoint/savepoint through the same storage + FileSystem seam
the runtime uses, lets callers read or rewrite per-operator payloads,
and writes a NEW v2 checkpoint directory that `execution.checkpointing
.restore` (or restore-from-path) accepts. A convenience view decodes a
WindowOperator snapshot into (key, pane, lanes) rows — the keyed-state
reader analogue.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage


class SavepointReader:
    """Read-side (ref: SavepointReader.read)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.payload = FsCheckpointStorage.load(path)

    @property
    def checkpoint_id(self) -> int:
        return int(self.payload.get("checkpoint_id", 0))

    def operator_ids(self) -> List[Any]:
        return sorted(self.payload.get("operators", {}))

    def operator_state(self, nid: Any) -> Dict[str, Any]:
        return self.payload["operators"][nid]

    def source_positions(self) -> Dict[Any, Dict[Any, int]]:
        return self.payload.get("sources", {})

    def window_keyed_rows(self, nid: Any) -> Dict[str, np.ndarray]:
        """Decode a WindowOperator snapshot into columnar keyed rows:
        one row per (key, live pane) with the raw lane values — the
        keyed-state dataset view (ref: SavepointReader.readKeyedState).
        """
        snap = self.operator_state(nid)
        if "panes" not in snap or "directory" not in snap:
            raise ValueError(
                f"operator {nid!r} is not a window-operator snapshot")
        panes = snap["panes"]
        counts = np.asarray(panes.counts)
        rows_total = counts.shape[0]
        ring = snap["ring"]
        n_dev = snap.get("n_dev", 1)
        rev_used = np.asarray(snap["directory"]["rev_used"])
        rev_keys = np.asarray(snap["directory"]["rev_keys"])
        # state rows: per device block, slots_local rows + 1 dump row
        spd = (rows_total // n_dev) - 1
        out_keys, out_panes = [], []
        out = {"sums": [], "maxs": [], "mins": [], "counts": []}
        for d in range(n_dev):
            block = slice(d * (spd + 1), d * (spd + 1) + spd)  # skip dump
            c = counts[block]
            slot_ix, ring_ix = np.nonzero(c > 0)
            gslot = d * spd + slot_ix
            used = rev_used[gslot]
            gslot, ring_ix = gslot[used], ring_ix[used]
            out_keys.append(rev_keys[gslot])
            out_panes.append(ring_ix)
            for name in ("sums", "maxs", "mins"):
                lane = getattr(panes, name)
                if lane is None:  # zero-width lane family (see PaneState)
                    out[name].append(
                        np.zeros((int(used.sum()), 0), np.float32))
                else:
                    arr = np.asarray(lane)[block]
                    out[name].append(arr[slot_ix[used], ring_ix])
            out["counts"].append(c[slot_ix[used], ring_ix])
        return {
            "key": np.concatenate(out_keys) if out_keys else np.zeros(0, np.int64),
            "ring_pane": np.concatenate(out_panes) if out_panes else np.zeros(0, np.int64),
            "sums": np.concatenate(out["sums"]) if out["sums"] else np.zeros((0, 0)),
            "maxs": np.concatenate(out["maxs"]) if out["maxs"] else np.zeros((0, 0)),
            "mins": np.concatenate(out["mins"]) if out["mins"] else np.zeros((0, 0)),
            "count": np.concatenate(out["counts"]) if out["counts"] else np.zeros(0),
        }


class SavepointWriter:
    """Write-side (ref: SavepointWriter.fromExistingSavepoint /
    withOperator → write). Starts from an existing checkpoint payload,
    applies per-operator transforms, writes a NEW savepoint directory
    restorable by the runtime."""

    def __init__(self, reader: SavepointReader) -> None:
        self._payload = dict(reader.payload)
        self._payload["operators"] = dict(reader.payload["operators"])

    def transform_operator(
            self, nid: Any,
            fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> "SavepointWriter":
        self._payload["operators"][nid] = fn(
            self._payload["operators"][nid])
        return self

    def remove_operator(self, nid: Any) -> "SavepointWriter":
        self._payload["operators"].pop(nid)
        return self

    def set_source_positions(
            self, positions: Dict[Any, Dict[Any, int]]) -> "SavepointWriter":
        self._payload["sources"] = positions
        return self

    def reset_watermarks(self, include_operators: bool = True
                         ) -> "SavepointWriter":
        """Reset event time for a rewound/bootstrapped savepoint: drops
        the driver-level clocks (watermark generators, max timestamps,
        per-node watermarks) AND, by default, rewinds each operator
        snapshot's own clock fields (watermark, fired/cleared horizons)
        — without the operator half, replayed records sit behind the
        old end-of-stream watermark and drop as late, or land in
        windows marked already-fired. Already-retained aggregates stay:
        replay merges ON TOP of them and re-fires the affected windows
        (the bootstrap-then-reprocess flow)."""
        from flink_tpu_torch.time.watermarks import LONG_MIN

        for k in ("wm_gens", "max_ts", "out_wm"):
            self._payload.pop(k, None)
        if include_operators:
            for snap in self._payload["operators"].values():
                if not isinstance(snap, dict):
                    continue
                if "watermark" in snap:
                    snap["watermark"] = LONG_MIN
                if "fired_below_end" in snap:
                    snap["fired_below_end"] = None
                if "refire" in snap:
                    snap["refire"] = []
                if "cleared_below" in snap:
                    # WindowPlan.first_dead_pane(LONG_MIN): nothing dead
                    snap["cleared_below"] = np.iinfo(np.int64).min // 2
                if "columns" in snap and "fired" in snap.get("columns", {}):
                    cols = snap["columns"]  # session spans re-emit
                    cols["fired"] = np.zeros_like(cols["fired"])
                    cols["refire"] = np.zeros_like(cols["refire"])
        return self

    def write(self, root: str, job_id: str,
              checkpoint_id: Optional[int] = None) -> str:
        """Write as ``<root>/<job_id>/savepoint-<id>``; returns the
        path. Loader-compat fields (op_files/op_file_versions) are
        stripped — they describe the OLD directory. Staged 2PC sink
        epochs are stripped too: a bootstrapped savepoint is not a
        crash-recovery point, and carrying the source checkpoint's
        staged epoch into a rewound replay would re-commit rows the
        replay is about to produce again (duplicates)."""
        payload = dict(self._payload)
        payload.pop("op_files", None)
        payload.pop("op_file_versions", None)
        payload.pop("sinks", None)
        cid = (checkpoint_id if checkpoint_id is not None
               else int(payload.get("checkpoint_id", 0)) + 1)
        payload["checkpoint_id"] = cid
        ops = payload.pop("operators")
        st = FsCheckpointStorage(root, job_id)
        from flink_tpu_torch.checkpoint import blobformat
        blobs = {str(nid): blobformat.encode(snap)
                 for nid, snap in ops.items()}
        h = st.save_v2(cid, payload, blobs, {}, savepoint=True)
        return h.path


def load_savepoint(path: str) -> SavepointReader:
    return SavepointReader(path)
