"""Log connectors — LogSink (two-phase-commit producer) + LogSource
(replayable, committed-offset consumer): the exactly-once JOB CHAINING
plane (ref: KafkaSink's transactional producer + the FLIP-27 Kafka
consumer; here the "broker" is an embedded filesystem topic,
``log/topic.py``). Job A's LogSink commits epochs in lockstep with its
checkpoints; job B's LogSource reads only committed offsets and
snapshots its positions through the ordinary source-position
checkpoint machinery — exactly-once holds END TO END across the job
boundary, under crashes on either side.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from flink_tpu_torch.api.sinks import TwoPhaseCommitSink
from flink_tpu_torch.api.sources import Source
from flink_tpu_torch.log.topic import (
    LogError,
    TopicAppender,
    TopicReader,
    topic_partitions,
)

__all__ = ["LogSink", "LogSource"]


class LogSink(TwoPhaseCommitSink):
    """Exactly-once producer into a log topic. Rows buffer in memory
    per partition (hash-routed by ``key_field``, or partition 0 when
    the topic has one); the checkpoint barrier stages them as sealed
    segments + a pre-commit marker; checkpoint completion publishes
    the commit marker (``topic.py`` has the protocol).

    Multi-writer (``owned_partitions`` + ``producer_id``): M LogSinks
    may produce into ONE topic concurrently as long as their owned
    partition sets are disjoint — each holds fenced per-partition
    leases (log/bus.py LeaseManager), acquired LAZILY at first
    use/epoch announcement (NOT at construction — building a plan must
    be side-effect-free on live lease state; see ``_ensure_open``),
    routes its rows among its OWNED partitions only, writer-scopes its
    transaction markers, and is re-verified by lease epoch before
    every marker publication (a deposed holder's late writes raise,
    never publish).
    Per-key order across the topic holds when each key is produced by
    exactly one producer (the callers' partitioning contract — there
    is no broker to re-route). Without ``owned_partitions`` the sink
    is the legacy single-writer owning every partition.

    Construction on a dirty topic (a dead attempt's staged
    transactions on disk) rolls THIS writer's uncommitted transactions
    back immediately — plus, when leased, a deposed previous holder's
    staged transactions on the partitions it took over."""

    def __init__(self, path: str, key_field: Optional[str] = None,
                 partitions: int = 1,
                 segment_records: int = 65536,
                 owned_partitions: Optional[List[int]] = None,
                 producer_id: Optional[str] = None,
                 lease_ttl_ms: int = 30_000,
                 fsync_mode: str = "group") -> None:
        if partitions > 1 and not key_field:
            raise LogError(
                "a multi-partition LogSink needs key_field: records "
                "hash-route by key so each partition holds a disjoint "
                "key range (per-key order)")
        if owned_partitions is not None and not producer_id:
            raise LogError(
                "owned_partitions needs producer_id: leases and "
                "transaction markers are writer-scoped")
        self.path = path
        self.key_field = key_field
        self._lease = None
        if owned_partitions is not None:
            from flink_tpu_torch.log.bus import LeaseManager

            # touches no disk: the lease dir is created in acquire(),
            # which runs lazily (TopicAppender below creates the topic)
            self._lease = LeaseManager(
                path, producer_id, list(owned_partitions),
                ttl_ms=lease_ttl_ms)
        self._appender = TopicAppender(
            path, partitions, segment_records=segment_records,
            writer_id=producer_id if owned_partitions is not None
            else None,
            owned_partitions=(list(owned_partitions)
                              if owned_partitions is not None else None),
            lease=self._lease, key_field=key_field,
            fsync_mode=fsync_mode)
        self._opened = self._lease is None
        if self._lease is None:
            # legacy single-writer: recovery at construction (the
            # documented dirty-topic sweep)
            self._appender.recover()
        self._route = self._appender.owned
        self._pending: Dict[int, List[Dict[str, np.ndarray]]] = {
            p: [] for p in range(partitions)}

    def _ensure_open(self) -> None:
        """Leased sinks acquire their partitions LAZILY, at first
        use/first epoch announcement — construction is side-effect-free
        on live lease state, so merely BUILDING a plan (the analyzer
        constructs sinks via the user's pipeline code) can neither
        depose a live producer whose lease momentarily lapsed nor
        crash on a held lease, and the LOG_TOPIC_MULTI_WRITER overlap
        diagnostic stays reachable. Acquisition then runs inside the
        attempt's retry scope: losing the fencing race restarts like
        any deploy failure."""
        if not self._opened:
            self._lease.acquire()
            self._appender.recover()
            self._opened = True

    @classmethod
    def from_config(cls, config, name: str,
                    key_field: Optional[str] = None,
                    owned_partitions: Optional[List[int]] = None,
                    producer_id: Optional[str] = None) -> "LogSink":
        """Topic resolved through the ``log.*`` config grammar:
        ``log.dir``/<name>, ``log.partitions``,
        ``log.segment-records``, ``log.lease.ttl-ms`` (the
        CLI-entry-point construction path)."""
        import os

        from flink_tpu_torch.config import LogOptions

        return cls(os.path.join(str(config.get(LogOptions.DIR)), name),
                   key_field=key_field,
                   partitions=int(config.get(LogOptions.PARTITIONS)),
                   segment_records=int(
                       config.get(LogOptions.SEGMENT_RECORDS)),
                   owned_partitions=owned_partitions,
                   producer_id=producer_id,
                   lease_ttl_ms=int(
                       config.get(LogOptions.LEASE_TTL_MS)),
                   fsync_mode=str(config.get(LogOptions.FSYNC_MODE)))

    def set_host_pool(self, pool) -> None:
        """Driver seam (announced next to ``set_attempt_epoch``): the
        run's shared HostPool — multi-partition stage() routes
        per-partition segment writes and the group-fsync pass through
        it so partition I/O scales with cores. Safe to never call:
        the appender's serial path is the exact legacy behavior."""
        self._appender.host_pool = pool

    def set_attempt_epoch(self, epoch: int) -> None:
        self._appender.epoch = int(epoch)
        if not self._opened:
            self._ensure_open()
            return
        # aborts are epoch-fenced (topic.py abort), so the recovery
        # sweep at construction time — which ran at the default epoch —
        # may have skipped a dead lower-epoch attempt's staged
        # transactions; now that this attempt's (higher) epoch is
        # known, roll them back for real
        self._appender.recover()

    # -- write path --------------------------------------------------------
    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self._ensure_open()
        cols = {k: np.asarray(v) for k, v in batch.items()}
        if not cols or not len(next(iter(cols.values()))):
            return
        route = self._route  # owned partitions (all of them, legacy)
        if len(route) == 1:
            self._pending[route[0]].append(cols)
            return
        from flink_tpu_torch.records import hash_keys_numpy

        if self.key_field not in cols:
            raise LogError(
                f"LogSink key_field {self.key_field!r} missing from "
                f"batch columns {sorted(cols)}")
        keys = np.asarray(cols[self.key_field], np.int64)
        # hash-route WITHIN the owned set: a leased producer only ever
        # stages into partitions it holds (legacy: owned == all, so
        # this is the original hash % partitions)
        dest = np.asarray(route, np.int64)[
            hash_keys_numpy(keys) % len(route)]
        for p in np.unique(dest):
            m = dest == p
            self._pending[int(p)].append(
                {k: v[m] for k, v in cols.items()})

    # -- TwoPhaseCommitSink contract ---------------------------------------
    # _ensure_open guards only the DURABLY MUTATING ops: clearing the
    # in-memory buffer (drop_pending) or listing staged ids must not
    # force a lease acquisition on a never-used sink inside a teardown
    # path — it could mask the root failure with a LeaseError, or
    # perform a takeover as a side effect of cleanup. If teardown DOES
    # find staged transactions to roll back, the abort itself opens.
    def drop_pending(self) -> None:
        self._pending = {p: [] for p in range(self._appender.partitions)}

    def stage_transaction(self, cid: int) -> bool:
        self._ensure_open()
        pending, self._pending = self._pending, {
            p: [] for p in range(self._appender.partitions)}
        return self._appender.stage(cid, pending)

    def staged_transaction_ids(self) -> List[int]:
        return self._appender.staged_ids()

    def commit_transaction(self, cid: int) -> None:
        self._ensure_open()
        self._appender.commit(cid)

    def abort_transaction(self, cid: int) -> None:
        self._ensure_open()
        self._appender.abort(cid)

    def snapshot_transaction(self, cid: int) -> Any:
        return self._appender.snapshot(cid)

    def rebuild_transaction(self, cid: int, payload: Any) -> None:
        self._ensure_open()
        self._appender.rebuild(cid, payload)

    def cleanup_unreferenced(self) -> None:
        self._appender.sweep_orphans()

    def close(self) -> None:
        if self._lease is not None and self._opened:
            # clean shutdown releases the partitions so a successor
            # producer can acquire immediately instead of waiting out
            # the ttl (a crash skips this — expiry + epoch bump is the
            # takeover path)
            self._lease.release()


class _ReadAhead:
    """Bounded background readahead at the log-read seam: a feeder
    thread pulls (and therefore DECODES) the next merged read batch
    while the pipeline consumes the current one — double-buffered at
    ``depth=1``, the ``cluster.dcn-overlap`` shape applied to segment
    I/O. Sits BELOW the driver's generic ``pipeline.source-prefetch``
    batch buffer (which overlaps the loop's keying/dispatch work);
    this stage overlaps the segment read+CRC+decode itself. Errors
    from the feeder surface on the consuming side at the batch where
    they occurred; ``close()`` unblocks and joins the feeder (the
    driver's failed-run cleanup calls it through the iterator-close
    seam). Checkpoint positions are untouched: readahead batches not
    yet CONSUMED are invisible to position bookkeeping — a restore
    simply rebuilds the source and re-reads from the frozen offset."""

    def __init__(self, it, depth: int = 1) -> None:
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._it = it
        self._done = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._feed, name="log-readahead", daemon=True)
        self._thread.start()

    def _feed(self) -> None:
        try:
            for item in self._it:
                if self._closed:
                    return
                self._q.put(item)
                if self._closed:
                    return
            self._q.put(StopIteration())
        except BaseException as e:  # surfaced on consume
            self._q.put(e)

    def close(self) -> None:
        self._closed = True
        self._done = True
        while True:  # empty the queue so a blocked put() completes
            try:
                self._q.get_nowait()
            except Exception:
                break
        self._thread.join(timeout=1.0)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if isinstance(item, StopIteration):
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        return item


class _SplitIter:
    """The iterator ``LogSource.open_split`` returns: stamps event
    time, keeps the replay-position side table, and owns the readahead
    thread's lifecycle (``close()`` — the driver's cleanup seam)."""

    def __init__(self, src: "LogSource", p: int, inner,
                 readahead) -> None:
        from flink_tpu_torch import faults

        self._src = src
        self._p = p
        self._inner = inner
        self._readahead = readahead
        # captured on the OPENING thread (the driver loop, which the
        # runner scoped to its tenant): the driver's generic
        # source-prefetch may consume this iterator on an unscoped
        # feeder thread, and the tenant's fault plan must still govern
        # its own prefetch seam
        self._fault_scope = faults.current_scope()

    def close(self) -> None:
        if self._readahead is not None:
            self._readahead.close()

    def __iter__(self):
        return self

    def __next__(self):
        from flink_tpu_torch import faults

        if self._readahead is not None:
            # the prefetch handoff seam: fires once per consumed batch
            # where a real readahead failure also surfaces, under the
            # opening thread's fault scope (the consuming thread may be
            # the driver's generic source-prefetch feeder, which is
            # unscoped). Per-split firing order is the batch order;
            # with multiple prefetched splits the cross-split
            # interleave is scheduling-dependent — the dcn.send.partial
            # discipline, not the host.pool.task submit-seam one.
            import os

            with faults.job_scope(self._fault_scope):
                faults.fire("log.prefetch.read", exc=OSError,
                            topic=os.path.basename(
                                os.path.normpath(self._src.path)),
                            partition=self._p)
        _offset, nxt, data = next(self._inner)
        src = self._src
        if src.ts_field is not None:
            if src.ts_field not in data:
                raise LogError(
                    f"LogSource ts_field {src.ts_field!r} missing "
                    f"from topic columns {sorted(data)}")
            ts = np.asarray(data[src.ts_field], np.int64)
        else:
            now = np.int64(time.time() * 1000)
            ts = np.full(len(next(iter(data.values()), ())),
                         now, np.int64)
        src._next_pos[id(data)] = (len(ts), int(nxt))
        return data, ts


class LogSource(Source):
    """FLIP-27-style replayable reads of a topic's COMMITTED prefix:
    one split per (assigned) partition; the replay position is the
    RECORD OFFSET, so a restore resumes mid-partition — whole
    already-consumed segments are skipped without opening, and the
    boundary block is sliced, not re-delivered. Committed-offset
    isolation: the segment list is captured from commit markers (and
    the compaction manifest) once per source instance, so staged
    (pre-committed, uncommitted) producer data is never observable.

    Compacted topics read transparently: below the compaction floor
    only the latest committed row per key survives, each at its
    ORIGINAL offset — ``position_after`` follows the sparse offsets
    (last row's offset + 1), so replay positions jump the gaps a naive
    ``pos + len`` would re-deliver from.

    Consumer groups (``group`` + ``member_index``/``members``): the
    member reads its statically assigned partitions
    (``p % members == member_index``), and the driver publishes its
    checkpointed positions to the group's committed-offset files at
    checkpoint complete (``commit_offsets`` — the compaction/retention
    safety floor). A NEW job joining the group bootstraps each
    assigned partition at ``max(restore position, group committed
    offset)`` — compacted history first, then the live tail (the
    backfill-then-live shape), exactly once per group across consumer
    generations.

    DYNAMIC membership (``member_id`` / ``log.group.member-id``):
    instead of a static ``member_index``/``members`` split, the member
    joins the group's durable membership manifest at first assignment
    (generation-bumping when the set changes, idempotent when not),
    reads its assignment from the sorted member list at that
    generation, and keys every offset commit by it — after any
    join/leave the old generation's late commits are REJECTED at the
    fence (bus.py ConsumerGroups), so a rebalance can never interleave
    two generations' offsets. ``leave_group()`` is the planned
    departure.

    ``ts_field`` names the event-time column (ms); absent, batches get
    ingest-time stamps like FileSource. Bounded: a split ends at the
    committed offset observed at open (chained jobs run producer then
    consumer; tailing a live topic is a broker's job, not this
    embedded log's).

    Perf-grade read path (all declared in the ``log.*`` grammar):
    ``zero_copy`` (``log.zero-copy``) mmaps sealed local segments and
    decodes fixed-width columns as read-only views — CRC still
    verified per block; ``batch_records`` (``log.read-batch-records``)
    COALESCES on-disk blocks into merged batches of at least that many
    rows before they enter the pipeline (small blocks otherwise starve
    the device path with tiny dispatches); ``prefetch_segments``
    (``log.prefetch-segments``) decodes the next merged batch on a
    feeder thread while the pipeline consumes the current one
    (0 = inline, the legacy path; positions stay checkpoint-exact
    because only CONSUMED batches advance them). The prefetch handoff
    carries the ``log.prefetch.read`` fault point."""

    def __init__(self, path: str, ts_field: Optional[str] = None,
                 group: Optional[str] = None, member_index: int = 0,
                 members: int = 1, member_id: Optional[str] = None,
                 zero_copy: bool = True,
                 batch_records: int = 262_144,
                 prefetch_segments: int = 1) -> None:
        # perf-grade read defaults (class defaults mirror the declared
        # log.* option defaults — direct construction and from_config
        # agree): zero-copy mmap decode, read batches COALESCED to
        # batch_records rows (small on-disk blocks otherwise starve
        # the device pipeline with tiny dispatches — the measured 2.6x
        # on the reference's backfill bench), one merged batch of
        # readahead decoded while the pipeline consumes the previous
        if batch_records < 0:
            raise LogError(
                f"LogSource batch_records must be >= 0 (0 = per-block "
                f"reads), got {batch_records}")
        if prefetch_segments < 0:
            raise LogError(
                f"LogSource prefetch_segments must be >= 0 (0 = "
                f"inline reads), got {prefetch_segments}")
        self.zero_copy = bool(zero_copy)
        self.batch_records = int(batch_records)
        self.prefetch_segments = int(prefetch_segments)
        self.path = path
        self.ts_field = ts_field
        self.group = group or None
        if self.group is not None:
            from flink_tpu_torch.log.topic import _WRITER_RE

            # early-loud (the writer_id discipline): an invalid name
            # would otherwise only fail at the FIRST checkpoint-
            # complete commit round, deep into the job
            if not _WRITER_RE.match(self.group):
                raise LogError(
                    f"consumer-group name {self.group!r} must match "
                    "[A-Za-z0-9_.-]+ (it becomes a directory name)")
        self.member_index = int(member_index)
        self.members = int(members)
        # dynamic membership (``log.group.member-id``): the member
        # JOINS the group's durable manifest lazily at first
        # assignment (construction is side-effect-free — the LogSink
        # _ensure_open discipline: building a plan must not bump the
        # group generation), caches the generation it joined at, and
        # keys every offset commit by it — a deposed member's late
        # commit (the generation moved: someone joined/left) is
        # REJECTED at the fence, never merged. A restore re-creates
        # the source, so the member re-joins (idempotent: same
        # membership set keeps the generation) and re-reads its
        # possibly-changed assignment.
        self.member_id = (member_id or None)
        if self.member_id is not None and self.group is None:
            raise LogError(
                "member_id needs a consumer group: dynamic membership "
                "is a property of the group manifest")
        self._generation: Optional[int] = None
        self._assigned: Optional[List[int]] = None
        self._reader: Optional[TopicReader] = None
        # per-batch replay positions for sparse (compacted) reads,
        # keyed by batch-dict identity: open_split records each
        # yielded batch's next position, position_after pops it — the
        # driver advances positions immediately after consuming each
        # batch, so at most one entry per in-flight split batch lives
        # here
        self._next_pos: Dict[int, int] = {}

    @classmethod
    def from_config(cls, config, name: str,
                    ts_field: Optional[str] = None) -> "LogSource":
        """Topic + group resolved through the ``log.*`` grammar:
        ``log.dir``/<name>, ``log.group.name`` / ``log.group.member``
        / ``log.group.members``."""
        import os

        from flink_tpu_torch.config import LogOptions

        group = str(config.get(LogOptions.GROUP_NAME)).strip()
        member_id = str(config.get(LogOptions.GROUP_MEMBER_ID)).strip()
        return cls(os.path.join(str(config.get(LogOptions.DIR)), name),
                   ts_field=ts_field, group=group or None,
                   member_index=int(config.get(LogOptions.GROUP_MEMBER)),
                   members=int(config.get(LogOptions.GROUP_MEMBERS)),
                   member_id=member_id or None,
                   zero_copy=bool(config.get(LogOptions.ZERO_COPY)),
                   batch_records=int(
                       config.get(LogOptions.READ_BATCH_RECORDS)),
                   prefetch_segments=int(
                       config.get(LogOptions.PREFETCH_SEGMENTS)))

    def _get_reader(self) -> TopicReader:
        # one reader per source instance, shared by all splits: the
        # TopicReader scan (every commit marker parsed + all partitions
        # contiguity-validated) runs ONCE, not once per partition —
        # and all splits observe the same committed snapshot. A
        # restore re-creates the source (build_env per attempt), so
        # the snapshot refreshes per attempt, not per split.
        if self._reader is None:
            self._reader = TopicReader(self.path,
                                       zero_copy=self.zero_copy)
        return self._reader

    def assigned_partitions(self) -> List[int]:
        n = topic_partitions(self.path)
        if self.member_id is not None:
            # dynamic membership: join (idempotent) at first
            # assignment, then read the manifest-driven assignment at
            # the generation this source instance observed — cached
            # per instance so splits, bootstrap and commits all agree
            # on ONE membership snapshot (a membership change after
            # this point deposes the member at the commit fence, and
            # the resulting restart re-joins at the new generation)
            if self._assigned is None:
                from flink_tpu_torch.log.bus import ConsumerGroups

                ConsumerGroups.join(self.path, self.group,
                                    self.member_id)
                gen, parts = ConsumerGroups.assignment_for(
                    self.path, self.group, self.member_id, n)
                self._generation, self._assigned = gen, parts
            return list(self._assigned)
        if self.group is None and self.members == 1:
            return list(range(n))
        from flink_tpu_torch.log.bus import ConsumerGroups

        return ConsumerGroups.assignment(
            n, self.member_index, self.members)

    def leave_group(self) -> None:
        """EXPLICIT departure from a dynamic group (bumps the
        generation, shrinking the membership — the planned-scale-down
        path; a crashed member simply stays in the manifest and its
        partitions stall until it re-joins or an operator removes it,
        which is the honest embedded-tier trade against a broker's
        heartbeat eviction)."""
        if self.member_id is None:
            return
        from flink_tpu_torch.log.bus import ConsumerGroups

        ConsumerGroups.leave(self.path, self.group, self.member_id)
        self._generation = None
        self._assigned = None

    def splits(self) -> List[str]:
        return [str(p) for p in self.assigned_partitions()]

    def _bootstrap_offset(self, p: int) -> int:
        """The group's committed offset for ``p`` (0 without a group):
        where a FRESH consumer generation starts reading."""
        if self.group is None:
            return 0
        from flink_tpu_torch.log.bus import ConsumerGroups

        return int(ConsumerGroups.committed(
            self.path, self.group).get(p, 0))

    def _coalesced(self, p: int,
                   start: int) -> Iterator[Any]:
        """``read3`` blocks merged up to ``batch_records`` rows per
        yielded batch (0 = per-block, the legacy granularity).
        Position-exact: each merged batch carries the NEXT-POSITION of
        its last constituent block, so replay positions advance at
        merged-batch boundaries and sparse (compacted) gaps are still
        jumped correctly. A single block already at or above the
        target passes through without a copy (the zero-copy views
        survive; merging is the one place the read path copies, and
        only when on-disk blocks are smaller than the pipeline wants)."""
        reader = self._get_reader()
        target = self.batch_records
        pend: list = []
        first = nxt = None
        rows = 0
        for off, nx, data in reader.read3(p, start_offset=start):
            if target <= 0:
                yield off, nx, data
                continue
            if first is None:
                first = off
            pend.append(data)
            rows += len(next(iter(data.values()), ()))
            nxt = nx
            if rows >= target:
                yield first, nxt, self._merge(pend)
                pend, first, rows = [], None, 0
        if pend:
            yield first, nxt, self._merge(pend)

    def _merge(self, pend: list) -> Any:
        if len(pend) == 1:
            return pend[0]
        out = {k: np.concatenate([d[k] for d in pend])
               for k in pend[0]}
        if self.zero_copy:
            # uniformity over speed-of-discovery: single-block batches
            # are read-only views, so merged batches are marked
            # read-only too — a consumer mutating its input in place
            # fails DETERMINISTICALLY on its first batch, not
            # intermittently on whichever tail batch happened to be a
            # lone block
            for arr in out.values():
                arr.flags.writeable = False
        return out

    def open_split(self, split: str,
                   start_pos: int = 0) -> Iterator[Any]:
        p = int(split)
        # group bootstrap applies ONLY to a fresh split (position 0 —
        # nothing consumed yet, so the group's committed offset is the
        # generation resume point). An EXPLICIT position > 0 is
        # authoritative even when it lies below the group offset: a
        # deliberate savepoint rewind must re-deliver those rows, not
        # silently fast-forward past them (the rows below it replay
        # under the job's own checkpoint lineage; group offsets never
        # regress, so the maintenance floor is unaffected).
        start = (self._bootstrap_offset(p) if int(start_pos) == 0
                 else int(start_pos))
        inner = self._coalesced(p, start)
        readahead = None
        if self.prefetch_segments > 0:
            inner = readahead = _ReadAhead(
                inner, depth=self.prefetch_segments)
        return _SplitIter(self, p, inner, readahead)

    def position_after(self, pos: int, data, ts) -> int:
        # offsets, not batch indices: replay-exact regardless of how
        # the committed prefix re-blocks at the restore boundary —
        # sparse (compacted) blocks advance to last-row-offset + 1 via
        # the side table recorded at yield time. Contract: the driver
        # advances positions once per consumed batch with the IDENTICAL
        # dict object (_advance_position); the recorded row count must
        # match, so a stale entry from a recycled id can never smuggle
        # in a wrong position — mismatches take the dense fallback
        # (exact everywhere except inside a compacted gap, which only
        # a re-blocking wrapper between source and driver could hit).
        rec = self._next_pos.pop(id(data), None)
        if rec is not None and rec[0] == len(ts):
            return rec[1]
        return pos + len(ts)

    def commit_offsets(self, checkpoint_id: int,
                       positions: Dict[int, int]) -> None:
        """Publish this member's checkpointed positions as the group's
        committed offsets (the driver's checkpoint-complete commit
        round calls this with the positions frozen at the barrier).
        No-op without a group; never regresses (max-merge)."""
        if self.group is None:
            return
        from flink_tpu_torch.log.bus import ConsumerGroups

        parts = self.assigned_partitions()
        offsets = {}
        for split_ix, pos in positions.items():
            if 0 <= int(split_ix) < len(parts) and int(pos) > 0:
                offsets[parts[int(split_ix)]] = int(pos)
        if offsets:
            # dynamic members key the commit by the generation they
            # joined at — a rebalance since then REJECTS this late
            # commit (LogError), failing the attempt so the restart
            # re-joins and re-reads its new assignment
            ConsumerGroups.commit(self.path, self.group, offsets,
                                  generation=self._generation)

    @property
    def bounded(self) -> bool:
        return True
