"""Async I/O: external enrichment without stalling ingest, the JAX
package's ``ops/async_io.py``: host threads in both packages, no kernel.

ref: streaming/api/operators/async/AsyncWaitOperator.java +
api/functions/async/AsyncFunction.java (asyncInvoke per record,
orderedWait/unorderedWait, capacity backpressure, timeout).

The unit of async work is the microbatch, not the record: one
``fn(data, ts) -> data'`` call per batch on a worker pool (an external
lookup amortized over the whole batch, as a client batches its RPCs).
Up to ``capacity`` batches run at once; ``ordered=True`` releases
results in arrival order (orderedWait), ``ordered=False`` as they
complete (unorderedWait). The reference's event-time contract holds: a
watermark never overtakes records it arrived behind, since the operator
releases watermark w only after every batch submitted before w has been
emitted. A timeout fails the job (the reference's default)."""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.time.watermarks import LONG_MIN

Batch = Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]


class AsyncIOOperator:
    """Driver-facing async enrichment stage."""

    def __init__(self, fn: Callable[..., Dict[str, np.ndarray]],
                 *, capacity: int = 8, timeout_ms: int = 60_000,
                 ordered: bool = True, workers: Optional[int] = None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.fn = fn
        self.capacity = capacity
        self.timeout_s = timeout_ms / 1000.0
        self.ordered = ordered
        self._pool = ThreadPoolExecutor(
            max_workers=workers or capacity,
            thread_name_prefix="async-io")
        # (future, ts, valid, wm_at_submit, submit_time, seq)
        self._inflight: collections.deque = collections.deque()
        self._seq = 0
        # worker thread id -> monotonic start of the lookup it runs
        self._running: Dict[int, float] = {}
        self.watermark = LONG_MIN  # released watermark (never overtakes)
        self._input_wm = LONG_MIN

    def submit(self, batch: Batch, input_wm: int) -> None:
        """The driver's push: never blocks, so a slow lookup never holds
        up the loop's deliveries. The capacity wait is ``throttle()``,
        which the loop calls after the push, as it throttles its window
        operators."""
        data, ts, valid = batch
        fut = self._pool.submit(self._lookup, dict(data), ts)
        self._inflight.append(
            (fut, ts, valid, input_wm, time.monotonic(), self._seq))
        self._seq += 1

    def _lookup(self, data: Dict[str, np.ndarray],
                ts: np.ndarray) -> Dict[str, np.ndarray]:
        """One batch's call of ``fn`` on a worker, with its start noted
        for ``close``."""
        me = threading.get_ident()
        self._running[me] = time.monotonic()
        try:
            return self.fn(data, ts)
        finally:
            del self._running[me]

    def throttle(self) -> None:
        """Capacity backpressure: block on the oldest still-running batch
        while more than ``capacity`` overlap (ref: AsyncWaitOperator's
        capacity semaphore). Completed batches awaiting ordered release
        do not count: they hold no worker."""
        while True:
            running = [it for it in self._inflight if not it[0].done()]
            if len(running) <= self.capacity:
                return
            self._await(running[0])

    def note_watermark(self, wm: int) -> None:
        self._input_wm = max(self._input_wm, wm)
        if not self._inflight:
            self.watermark = self._input_wm

    def poll(self, drain: bool = False) -> List[Batch]:
        """Completed batches ready for downstream, in the order mode;
        advances the released watermark to the input watermark captured
        before the oldest still-pending batch. ``drain`` blocks until
        everything in flight completes (end of input, a barrier)."""
        out: List[Batch] = []
        if drain:
            for item in list(self._inflight):
                self._await(item)
        while self._inflight:
            if self.ordered:
                head = self._inflight[0]
                if not (head[0].done() or drain):
                    break
                self._inflight.popleft()
                out.append(self._finish(head))
            else:
                done = [it for it in self._inflight if it[0].done()]
                if not done:
                    break
                for it in done:
                    self._inflight.remove(it)
                    out.append(self._finish(it))
        if self._inflight:
            # released only up to the oldest pending submit
            self.watermark = max(
                self.watermark,
                min(it[3] for it in self._inflight))
        else:
            self.watermark = max(self.watermark, self._input_wm)
        return out

    def _await(self, item) -> None:
        fut, _, _, _, t0, _ = item
        remaining = self.timeout_s - (time.monotonic() - t0)
        try:
            fut.result(timeout=max(remaining, 0.001))
        except TimeoutError:
            raise TimeoutError(
                f"async I/O batch exceeded {self.timeout_s * 1000:.0f}ms "
                "timeout") from None

    def _finish(self, item) -> Batch:
        fut, ts, valid, _, t0, _ = item
        self._await(item)
        data = fut.result()  # re-raises the user function's exception
        n = len(ts)
        for k, v in data.items():
            if len(np.asarray(v)) != n:
                raise ValueError(
                    f"async fn changed batch length for field {k!r}: "
                    f"{len(np.asarray(v))} != {n} (1:1 enrichment "
                    "contract)")
        return (data, ts, valid)

    @property
    def pending(self) -> int:
        return len(self._inflight)

    # -- snapshot seam: the driver's checkpoint barrier drains every
    # in-flight batch downstream first, so the operator holds no state
    # at a snapshot
    state_version = 0  # constant: the (empty) snapshot never changes

    def snapshot_state(self):
        assert not self._inflight, \
            "checkpoint barrier must drain async I/O first"
        return {"kind": "async_io"}

    def restore_state(self, snap) -> None:
        self._inflight.clear()

    def close(self) -> None:
        """End the worker pool, at the end of a job or of a failed
        attempt: batches not started are cancelled, and each of the
        pool's threads is joined until its lookup's timeout (an idle
        thread ends at once). A lookup past its timeout is not waited
        for, so one that never returns cannot hold up the job's failure;
        its thread ends when the lookup returns."""
        self._inflight.clear()
        self._pool.shutdown(wait=False, cancel_futures=True)
        now = time.monotonic()
        # the pool keeps its threads in ``_threads`` (CPython's
        # ThreadPoolExecutor has since 3.2)
        for t in list(self._pool._threads):
            start = self._running.get(t.ident, now)
            t.join(max(start + self.timeout_s - time.monotonic(), 0.0))


class AsyncFunction:
    """User interface (ref: api/functions/async/AsyncFunction.java),
    batch form: override ``invoke_batch(data, ts) -> data'`` to do the
    external lookup for a whole microbatch; return the enriched columns
    (same length, 1:1)."""

    def invoke_batch(self, data: Dict[str, np.ndarray],
                     ts: np.ndarray) -> Dict[str, np.ndarray]:
        raise NotImplementedError
