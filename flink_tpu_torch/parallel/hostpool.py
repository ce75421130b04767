"""The driver's shared host worker pool: ONE ``HostPool`` per driver,
sized by ``host.parallelism``, handed to every operator with
host-resident parallel work (the session span registry's key shards,
the spill store's per-pane merges, per-window fires and chunked tree
fold, which windowAll folds through). The passes are numpy-bound and
release the GIL in C loops, so the executor is a thread pool.

Determinism contract:

- ``host.parallelism = 1`` is the exact serial path: no executor is
  made, tasks run inline on the caller's thread in submission order.
- At any parallelism ``run_tasks`` returns results in submission order,
  so callers combine partials in an order that does not depend on the
  schedule. Every client's combine is exact on its lane monoids
  (max / min / count, and sums of values exact in f32), so parallel
  output equals serial output byte for byte. The spill store's chunked
  tree fold is the one place whose reduction tree differs from the
  serial one; its chunk size (``host.fold-chunk-records``) does not
  depend on the worker count.

Fault seam: every task submission passes the ``host.pool.task`` fault
point on the caller's thread, before dispatch, so a rule's invocation
count follows submission order, not the workers' interleaving.

Metrics, group ``hostpool``: ``tasks_total``, ``task_ms`` (each task's
wall time) and ``parallelism``.

A submitted closure runs on a worker thread: it returns a partial for
the caller to combine, or guards a shared write with a lock.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence

from flink_tpu_torch import faults
from flink_tpu_torch.config import HostOptions

__all__ = ["HostPool"]


class HostPool:
    """A worker pool with a lifecycle for host-resident operator work.
    Operators receive it at construction and submit batches of
    independent thunks through ``run_tasks``."""

    def __init__(self, parallelism: int,
                 *, registry: Optional[Any] = None) -> None:
        parallelism = int(parallelism)
        if parallelism < 1:
            raise ValueError(
                f"host.parallelism must be >= 1 (1 = serial path), "
                f"got {parallelism}")
        self.parallelism = parallelism
        # parallelism 1 never makes an executor: the serial path stays
        # thread-free
        self._executor: Optional[ThreadPoolExecutor] = (
            None if parallelism == 1 else ThreadPoolExecutor(
                max_workers=parallelism, thread_name_prefix="hostpool"))
        self._closed = False
        self._tasks = None
        self._task_ms = None
        if registry is not None:
            g = registry.group("hostpool")
            self._tasks = g.counter("tasks_total")
            self._task_ms = g.histogram("task_ms")
            g.gauge("parallelism").set(float(parallelism))

    @classmethod
    def from_config(cls, config, *, registry: Optional[Any] = None
                    ) -> "HostPool":
        """Sized by ``host.parallelism`` (default ``min(4,
        os.cpu_count())``); a value below 1 raises here."""
        return cls(int(config.get(HostOptions.PARALLELISM)),
                   registry=registry)

    # -- execution -------------------------------------------------------

    def _timed(self, fn: Callable[[], Any]) -> Any:
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            if self._task_ms is not None:
                self._task_ms.update((time.perf_counter() - t0) * 1e3)

    def _submit_seam(self) -> None:
        faults.fire("host.pool.task")
        if self._tasks is not None:
            self._tasks.inc()

    def run_tasks(self, fns: Sequence[Callable[[], Any]]) -> List[Any]:
        """Run independent thunks; results in submission order. A task's
        exception re-raises the first one by submission index, once every
        dispatched task has ended. After ``close`` (and at parallelism 1)
        tasks run inline on the caller's thread."""
        if not fns:
            return []
        if self._executor is None or self._closed:
            out = []
            for fn in fns:
                self._submit_seam()
                out.append(self._timed(fn))
            return out
        futures = []
        try:
            for fn in fns:
                self._submit_seam()
                futures.append(self._executor.submit(self._timed, fn))
        except BaseException:
            # a fault at the submit seam drains what was dispatched first:
            # no worker may still be changing operator state when the
            # caller's recovery resumes
            for f in futures:
                try:
                    f.result()
                except BaseException:
                    pass
            raise
        out: List[Any] = []
        first_err: Optional[BaseException] = None
        for f in futures:
            try:
                out.append(f.result())
            except BaseException as e:  # keep draining: no orphan task
                if first_err is None:
                    first_err = e
                out.append(None)
        if first_err is not None:
            raise first_err
        return out

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        """Shut the executor down without waiting (a wedged task must not
        hang the job's teardown); later ``run_tasks`` calls run inline."""
        self._closed = True
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    def __repr__(self) -> str:  # pragma: no cover
        return f"HostPool(parallelism={self.parallelism})"
