"""Broadcast state: a low-volume control stream joined with a data
stream, the JAX package's ``ops/broadcast.py``: host numpy in both
packages, no kernel.

ref: streaming/api/datastream/BroadcastConnectedStream.java +
api/operators/co/CoBroadcastWithNonKeyedOperator.java and the broadcast
state pattern: control elements replicate to every subtask and land in
broadcast state; data elements read that state.

The broadcast state is a small host-side dict, and the data side is
batch-vectorized: the user function receives whole column batches plus
the current state and returns column batches. Elements are processed in
arrival order per stream; as in the reference, no cross-stream order is
guaranteed.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["BroadcastProcessFunction", "BroadcastConnectOperator"]

Batch = Dict[str, np.ndarray]


class BroadcastProcessFunction:
    """User function for a connected (data, broadcast) pair: the
    vectorized analogue of BroadcastProcessFunction's processElement /
    processBroadcastElement pair."""

    def process_element(self, data: Batch, ts: np.ndarray,
                        state: Dict[str, Any]) -> Optional[Batch]:
        """Data-side batch against the current broadcast state. Return
        an output batch (columns of equal length) or None."""
        raise NotImplementedError

    def process_broadcast_element(self, data: Batch, ts: np.ndarray,
                                  state: Dict[str, Any]) -> None:
        """Control-side batch: mutate the broadcast state in place."""
        raise NotImplementedError


class BroadcastConnectOperator:
    """Runtime operator for ``stream.connect(control).process(fn)``.
    Emits per batch (no event-time timers); the broadcast state rides
    checkpoints, so a restore resumes with the control decisions applied
    so far (ref: broadcast state is checkpointed operator state)."""

    def __init__(self, fn: BroadcastProcessFunction) -> None:
        self.fn = fn
        self.state: Dict[str, Any] = {}
        self._out: List[Batch] = []
        # incremental checkpoints reuse an operator's previous blob while
        # its version is unchanged: a mutated broadcast state bumps it
        self.state_version = 0

    def process_main(self, ts: np.ndarray, data: Batch,
                     valid: np.ndarray) -> None:
        compact = {k: np.asarray(v)[valid] for k, v in data.items()}
        tsc = np.asarray(ts)[valid]
        out = self.fn.process_element(compact, tsc, self.state)
        if out:
            out = {k: np.asarray(v) for k, v in out.items()}
            lens = {len(v) for v in out.values()}
            if len(lens) > 1:
                raise ValueError(
                    f"process_element returned ragged columns: "
                    f"{ {k: len(v) for k, v in out.items()} }")
            n = lens.pop() if lens else 0
            if n:
                # downstream event time: the function may emit explicit
                # per-row __ts__; otherwise rows carry the batch's max
                # input timestamp (they happened by then)
                out.setdefault("__ts__", np.full(
                    n, int(tsc.max()) if len(tsc) else 0, np.int64))
                self._out.append(out)

    def process_broadcast(self, ts: np.ndarray, data: Batch,
                          valid: np.ndarray) -> None:
        compact = {k: np.asarray(v)[valid] for k, v in data.items()}
        self.fn.process_broadcast_element(
            compact, np.asarray(ts)[valid], self.state)
        self.state_version += 1

    def take_fired(self):
        """Rows emitted since the last take, as a ``FiredWindows``."""
        from flink_tpu_torch.ops.window import FiredWindows

        if not self._out:
            return None
        if len(self._out) == 1:
            out = self._out[0]
        else:
            out = {k: np.concatenate([b[k] for b in self._out])
                   for k in self._out[0]}
        self._out = []
        return FiredWindows(data=out)

    # -- checkpointing -------------------------------------------------------
    def snapshot_state(self) -> Dict[str, Any]:
        return {"broadcast_state": copy.deepcopy(self.state)}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self.state = copy.deepcopy(snap.get("broadcast_state", {}))
        self._out = []
