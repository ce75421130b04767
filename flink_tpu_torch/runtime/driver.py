"""The per-host driver loop: pull a batch from each source split, run the
fused host map chain, fold it into the window operator's device state,
advance the watermark clock, and hand fired windows to the downstream
chain and sinks.

A device-made source (``DeviceGeneratorSource``) whose only consumer
is a window operator keyed on its key field is chained into that
operator: the loop then pulls per-batch markers (index, exact max
timestamp, record count) instead of records, and the operator makes each
batch on the card. With ``pipeline.sub-batches`` K > 1 the chained
source is subdivided into K bit-exact slices per logical batch, each
its own step with its own watermark advance. A batch the operator's
devgen gates refuse is made on the host and fed normally (metric
``devgen_host_batches``), already at sub-batch size when the source was
subdivided.

With K > 1 a host-fed logical batch is pushed as K contiguous slices
(host-plane sub-batching): after each slice the watermark clock
advances, fires dispatch and landed fires are delivered, so rows reach
the sinks at sub-batch cadence. Records keep their order, so committed
rows are the K = 1 run's; only the grouping of fires is finer. The
watermark's max timestamp is still taken per logical batch.

The driver throttles its window operators (``external_throttle``): after
every host-fed push (each slice), and after a device-made step at every
sub-batch under ``pipeline.readiness`` 'piggyback' or at the last
sub-batch of each logical batch under 'probe', as the reference's
driver does. The in-flight credit is ``pipeline.max-inflight-steps`` x
K, except for a device chain whose source cannot subdivide.

A host-fed window operator may hold its last batch back for the next
watermark advance (its native lane's fused step); the end-of-input
``quiesce`` folds such a batch in before the final watermark.

A pattern match (``cep``) emits its matches per batch and queues them
behind earlier fires; a broadcast connect (``broadcast_connect``) takes
each batch on the side of its input edge (the control edge into its
broadcast state) and delivers its rows at once. An async I/O node
(``async_io``) submits each batch to its worker pool without blocking;
the loop's throttle waits while more than its capacity run, each
watermark pass pushes the completed batches downstream (in arrival
order, or as they complete), the node's watermark never passes a batch
still in flight, and a checkpoint barrier and the end of input drain
them all first.

A count window (``count_window``) fires per batch, not per watermark:
the driver takes its fires right after each batch and delivers them at
once, and leaves it out of the watermark advance (it is blind to event
time). An element-path window (``evicting_window``) fires both ways:
per batch (its triggers, late re-fires) and on the watermark; so does a
session window in retract mode (its merges' -U rows per batch, queued
behind its earlier fires; its sessions on the watermark). A
processing-time window ignores the event watermark: each pass fires
what the operator's clock has passed, and the end of input fires
everything seen.

The host-resident operators (session windows, windowAll, the windowed
join's pairs mode) share one ``HostPool`` of ``host.parallelism``
workers, which the driver builds and closes with the run; the spill
store gets it too. A join takes each batch on the side of the upstream
node it came from, and its watermark is the min over its two inputs.

Fired windows are delivered from the same thread, in fire order: after
every loop pass the driver polls the operators' emit rings for copies
that have landed and delivers the packed fires whose copies have landed
(never waiting on the device) and that are at least
``pipeline.emit-defer`` old (from the advance that fired them); at a
checkpoint and at end of input it drains everything with a barrier.

Exactly-once checkpoints (``execution.checkpointing.*``): at a batch
boundary, once the interval has passed and no checkpoint is in flight,
the loop drains every fire with a barrier, has the sinks stage their
epoch (``prepare_commit``) and freezes the snapshot: source positions
(sub-batches on a subdivided device chain), watermark state, the
sinks' staged epochs and each operator's state, whose device tensors
are clones enqueued on the operator's stream (no synchronization). The
checkpoint executor's thread fetches the clones, encodes and writes
them (``checkpoint/``), manifest last; the loop commits the sinks'
epoch once that is durable. A bounded job ends with a synchronous
checkpoint (without checkpointing, a terminal commit). ``restore``
('latest' or a path) resumes from a checkpoint of either package:
positions, watermarks, operator state and the staged epochs it proved.
A failed attempt abandons its in-flight checkpoint, drops its sinks'
uncommitted rows and closes its feeder threads;
``runtime/supervisor.py`` restarts it. Savepoints are
``checkpoint_now(savepoint=True)``.

A job across processes (``cluster.num-processes`` N > 1) runs this
program in every process with its ``cluster.process-id``: the process
reads a strided share of the source's splits, routes each batch's
records by key to the process that owns their shard span
(``partitioners.hybrid_route``), and the per-step rendezvous of
``exchange/dcn.py`` hands it its share and the fleet's consensus: the
global watermark (the min of the processes'), termination, and the
checkpoint decision of process 0's clock, so every process snapshots at
the same step (into its own ``<job>-p<pid>`` directory) and a checkpoint
commits once every process holds it. A restore negotiates the newest id
every process holds. The loop overlaps one step's exchange with the
next by default (``cluster.dcn-overlap``). A ``partition`` node
(``rebalance`` and the like) passes its batches through at this
parallelism of 1 and advances its partitioner, whose state rides the
checkpoint.

Batch mode (``execution.runtime-mode: batch``, the JAX package's bounded
run): the plan's waves (``runtime/scheduler.py``) run one after the
other. Wave 0 drains every source split to its end through the
stateless chains, whole batches (no sub-batch slices, no debloater
re-chunking) and no watermark between them; every edge into a stateful
operator is diverted at the top of ``_push`` into its spool
(``exchange/blocking.py``), so no record reaches a stateful operator in
wave 0. Each later wave replays its sealed partitions into its head
operators. At the end of a wave one final watermark pass over the
wave's nodes fires each stateful operator once, through the same fire
paths as streaming, and a barrier drain delivers the fires, into the
next wave's spools where they lead there. Nothing checkpoints: a
checkpoint interval or a restore path is refused, ``restore: latest``
reads as a fresh run (a supervisor's retry), a savepoint request fails
the run, and so does a job across processes. The 2PC sinks first drop
what an earlier attempt staged, then commit once at the end of input.

Rescaling: a restore path written by another process count or id (the
checkpoint's ``rescale`` identity) loads the whole checkpoint set that
``cluster.rescale-from`` names, one path per old process, and merges it
down to this process's span of the shards
(``checkpoint/repartition.py``); the window state is then re-blocked
onto this process's blocks. A later ``restore: latest`` never goes back
behind that set (the rescale floor).

With ``pipeline.target-latency`` set, the debloater re-chunks each
host-fed batch (each sub-batch slice at K > 1) before the push, and
steers the chunk once a loop pass by the recent fire-to-sink p99
(``_debloat_split``, ``_debloat_adjust``, gauge ``debloat_chunk``), as
the reference's driver does; device-made batches and the cross-process
loop's merged shares are not re-chunked, there or here.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.api.sources import DeviceGeneratorSource
from flink_tpu_torch.config import (
    CheckpointingOptions, ClusterOptions, Configuration, HostOptions,
    MemoryOptions, MetricsOptions, PipelineOptions, StateOptions)
from flink_tpu_torch.device import resolve_device
from flink_tpu_torch.exchange.partitioners import (
    hybrid_route, make_partitioner)
from flink_tpu_torch.graph.compiler import ExecutionPlan
from flink_tpu_torch.time.watermarks import LONG_MIN, make_generator

Batch = Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]  # data, ts, valid

_FINAL = int(np.iinfo(np.int64).max)  # end-of-input watermark
_STATEFUL = ("window", "evicting_window", "count_window", "session",
             "window_all", "join", "global_agg", "process", "cep")
# the kinds a fire must reach before the watermark that passed it: they
# hold state, or hand the watermark on behind their pending batches
_CONSUMERS = _STATEFUL + ("async_io", "broadcast_connect")
# the kinds the watermark advances (count windows fire per batch only)
_EVENT_TIME = ("window", "evicting_window", "session", "window_all", "join",
               "process")
# the kinds that emit per batch (take_fired) and queue behind the fires
# before them
_PER_BATCH = ("session", "global_agg", "process", "cep")


class Driver:
    """Execution of a lowered plan on one device, or with ``mesh_plan``
    its keyed windows over a mesh of device blocks; one process of a job
    across processes with ``cluster.num-processes`` > 1."""

    def __init__(self, plan: ExecutionPlan, config: Configuration,
                 device="cuda", mesh_plan=None) -> None:
        config.validate()
        self.plan = plan
        self.config = config
        self.device = resolve_device(device)
        self.mesh_plan = mesh_plan
        self._upstream: Dict[int, List[int]] = {nid: [] for nid in plan.nodes}
        for n in plan.nodes.values():
            for d in n.downstream:
                self._upstream[d].append(n.id)
        self._out_wm: Dict[int, int] = {nid: LONG_MIN for nid in plan.nodes}
        self._wm_gens: Dict[int, List[Any]] = {}
        self._max_ts: Dict[int, int] = {}
        # source id -> split index -> replay position
        self._positions: Dict[int, Dict[int, int]] = {}
        # the run's background log cleaners (log.cleaner.enabled)
        self._cleaners: List[Any] = []
        self.metrics: Dict[str, Any] = {
            "records_in": 0, "records_out": 0, "batches": 0,
            "fired_windows": 0, "devgen_host_batches": 0,
        }
        self._ops: Dict[int, Any] = {}
        from flink_tpu_torch.obs.metrics import MetricRegistry

        # the gauges read the driver's dicts, never the driver: a cycle
        # through it would keep its operators' device tensors alive until
        # the cyclic collector ran
        self.registry = MetricRegistry()
        g = self.registry.group("driver")
        m, ops = self.metrics, self._ops
        g.gauge("records_in", lambda: m["records_in"])
        g.gauge("records_out", lambda: m["records_out"])
        g.gauge("fired_windows", lambda: m["fired_windows"])
        g.gauge("records_dropped_full", lambda: sum(
            getattr(op, "records_dropped_full", 0) for op in ops.values()))
        g.gauge("exchange_overflow", lambda: sum(
            getattr(op, "exchange_overflow", 0) for op in ops.values()))
        self._eps_meter = g.meter("records_per_sec")
        # fire to sink: from the advance that dispatched a fire to its
        # delivery (time queued before the step dispatched is not in it)
        self._lat_hist = g.histogram("emit_latency_ms")
        self._wm_lag = g.gauge("watermark_lag_ms")
        # the adaptive microbatch debloater (ref: BufferDebloater): with
        # pipeline.target-latency set, ingest re-chunks host-fed source
        # batches; the chunk halves while the recent fire-to-sink p99
        # overshoots the target and regrows while it sits under half of
        # it (_debloat_split, _debloat_adjust)
        self._debloat_target = float(
            config.get(PipelineOptions.TARGET_LATENCY))
        # the chunk (None until the first batch seeds it) lives in a
        # dict the gauge reads, as the other gauges read the driver's
        debloat = self._debloat = {"chunk": None}
        self._debloat_min = 4096
        self._debloat_seen = 0  # histogram count at the last control step
        g.gauge("debloat_chunk", lambda: float(debloat["chunk"] or 0))
        self.prof: Dict[str, float] = collections.defaultdict(float)
        # a job across processes: this process's id among nproc, its
        # exchange endpoint while a run holds one, and the exchange's
        # figures (rendezvous wait a step, records routed and sent away)
        self._nproc = int(config.get(ClusterOptions.NUM_PROCESSES))
        self._pid = (int(config.get(ClusterOptions.PROCESS_ID))
                     if self._nproc > 1 else 0)
        self._dcn = None
        self._dcn_stats = {"records_routed": 0, "records_sent": 0,
                           "bytes_sent": 0}
        if self._nproc > 1:
            dg = self.registry.group("dcn")
            st = self._dcn_stats
            self._dcn_wait = dg.histogram("wait_ms")
            for k in st:
                dg.gauge(k, lambda k=k: st[k])
        # the DataStream partitioners' cursors and streams, by plan node
        self._partitioners: Dict[int, Any] = {}
        # (node id, lazy fire, the advance's wall time)
        self._pending_emits: List[Tuple[int, Any, float]] = []
        self._sub_batches = int(config.get(PipelineOptions.SUB_BATCHES))
        self._base_inflight = int(
            config.get(PipelineOptions.MAX_INFLIGHT_STEPS))
        self._readiness = str(
            config.get(PipelineOptions.READINESS)).strip().lower()
        # source batches each split generates ahead on its feeder thread
        self._prefetch = int(config.get(PipelineOptions.SOURCE_PREFETCH))
        # the least age of a fire before a periodic drain delivers it
        self._emit_defer_s = max(
            0, int(config.get(PipelineOptions.EMIT_DEFER_MS))) / 1000.0
        # one shared host worker pool a driver (parallel/hostpool.py):
        # parallelism 1 makes no threads and keeps the serial paths
        from flink_tpu_torch.parallel.hostpool import HostPool

        self._fold_chunk = int(config.get(HostOptions.FOLD_CHUNK_RECORDS))
        if self._fold_chunk < 1:
            raise ValueError(f"host.fold-chunk-records must be >= 1, got "
                             f"{self._fold_chunk}")
        self.host_pool = HostPool.from_config(config, registry=self.registry)
        self._build_ops()
        # plan-time device budget: the operators' dense tensors are known
        # before the first step (memory.hbm-budget)
        from flink_tpu_torch.memory import MemoryBudget

        self.memory = MemoryBudget(int(config.get(MemoryOptions.HBM_BUDGET)))
        for nid, op in self._ops.items():
            if hasattr(op, "hbm_bytes"):
                n = plan.node(nid)
                self.memory.register(
                    f"{n.kind}:{n.name or nid}", op.hbm_bytes(),
                    detail=f"layout={getattr(op, 'layout', None)}")
        self.memory.check()
        memory = self.memory
        self.registry.group("memory").gauge(
            "hbm_state_bytes", lambda: float(memory.hbm_total))
        # the loop throttles its window operators at the reference's
        # cadence (_throttle_ops)
        for op in self._ops.values():
            if hasattr(op, "throttle"):
                op.external_throttle = True
        # a window feeding another stateful operator delivers each fire
        # at once, as the reference does, so the next stage has the rows
        # before its own watermark passes them
        self._deliver_at_fire = any(
            n.kind in _STATEFUL and self._reaches_stateful(n.id)
            for n in plan.nodes.values())
        # source id -> (window node id, the source as chained, its
        # sub-batch factor); chained at run start, after any restore
        self._dev_chains: Dict[int, Tuple[int, DeviceGeneratorSource, int]] = {}
        # the factor each source's positions count in this run
        self._sub_factor: Dict[int, int] = {}
        # batch mode: (producer, stateful consumer) -> the edge's spool
        # while a run holds the shuffle open
        self._batch_capture: Dict[Tuple[int, int], Any] = {}
        self._savepoint_request = None
        self.last_savepoint: Optional[str] = None
        self._coordinator = None
        self._ckpt_executor = None
        self._ckpt_pending = None
        self._ckpt_base: Optional[Dict[str, Any]] = None
        self._ckpt_failures = 0
        self._last_freeze_versions: Dict[int, int] = {}
        self._metrics_server = None

    @property
    def _debloat_chunk(self) -> Optional[int]:
        return self._debloat["chunk"]

    @_debloat_chunk.setter
    def _debloat_chunk(self, chunk: Optional[int]) -> None:
        self._debloat["chunk"] = chunk

    def _debloat_split(self, data, ts):
        """Re-chunk one host-fed source batch (or sub-batch slice) to the
        debloater's chunk: the batch whole when the debloater is off or
        the batch fits, else contiguous slices in record order, so the
        watermark generators see the same max timestamp. The first
        non-empty batch seeds the chunk at its size."""
        n = len(ts)
        chunk = self._debloat_chunk
        if self._debloat_target <= 0 or chunk is None or n <= chunk:
            if self._debloat_target > 0 and chunk is None and n:
                self._debloat_chunk = n
            yield data, ts
            return
        chunk = max(1, chunk)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            yield ({k: v[lo:hi] for k, v in data.items()}, ts[lo:hi])

    def _debloat_adjust(self) -> None:
        """One control step (ref: BufferDebloater.recalculateBufferSize),
        once a loop pass: the p99 of the 16 newest fire-to-sink
        latencies above the target halves the chunk (not below
        ``_debloat_min``), under half the target doubles it (the split
        never merges batches, so the source batch caps it). It acts on
        fresh samples only (at least 2 since the last step): the loop
        passes far more often than windows fire."""
        if self._debloat_target <= 0 or self._debloat_chunk is None:
            return
        c = self._lat_hist.count
        if c - self._debloat_seen < 2:
            return
        self._debloat_seen = c
        p99 = self._lat_hist.quantile_recent(0.99, window=16)
        if p99 > self._debloat_target:
            self._debloat_chunk = max(self._debloat_min,
                                      self._debloat_chunk // 2)
        elif p99 < self._debloat_target / 2:
            self._debloat_chunk *= 2

    def _reaches_stateful(self, nid: int) -> bool:
        todo = list(self.plan.node(nid).downstream)
        seen = set()
        while todo:
            d = todo.pop()
            if d in seen:
                continue
            seen.add(d)
            if self.plan.node(d).kind in _CONSUMERS:
                return True
            todo.extend(self.plan.node(d).downstream)
        return False

    def _build_ops(self) -> None:
        from flink_tpu_torch.ops.factory import (
            OperatorBuildContext, lookup_operator_factory)

        ooo = [self.plan.watermark_strategy.max_out_of_orderness_ms]
        for n in self.plan.nodes.values():
            if n.kind == "source" and n.watermark_strategy is not None:
                ooo.append(n.watermark_strategy.max_out_of_orderness_ms)
        ctx = OperatorBuildContext(
            device=self.device,
            num_shards=int(self.config.get(StateOptions.NUM_KEY_SHARDS)),
            slots_per_shard=int(self.config.get(StateOptions.SLOTS_PER_SHARD)),
            # K sub-batch steps per logical batch, each 1/K of the
            # records: scale the in-flight credit so the queue depth in
            # logical batches (in bytes) stays the same
            max_inflight_steps=self._base_inflight * self._sub_batches,
            max_out_of_orderness_ms=max(ooo),
            fire_gate=bool(self.config.get(PipelineOptions.FIRE_GATE)),
            readiness=self._readiness,
            backend=str(self.config.get(StateOptions.BACKEND)).strip().lower(),
            memory_budget_bytes=int(self.config.get(
                StateOptions.MEMORY_BUDGET_BYTES)),
            lsm_dir=str(self.config.get(StateOptions.LSM_DIR)),
            lsm_compact_min_runs=int(self.config.get(
                StateOptions.LSM_COMPACT_MIN_RUNS)),
            allow_drops=bool(self.config.get(StateOptions.ALLOW_DROPS)),
            mesh_plan=self.mesh_plan,
            exchange_capacity=int(self.config.get(
                PipelineOptions.EXCHANGE_CAPACITY)) or None,
            exchange_impl=str(self.config.get(ClusterOptions.EXCHANGE_IMPL)),
            host_pool=self.host_pool,
            fold_chunk_records=self._fold_chunk,
            shard_range=self._shard_span())
        for n in self.plan.nodes.values():
            # a factory registered for the kind builds the node (the
            # built-in operators register theirs, ops/factory.py)
            factory = lookup_operator_factory(n.kind)
            if factory is not None:
                self._ops[n.id] = factory(n, ctx)
            elif n.kind == "global_agg":
                from flink_tpu_torch.ops.global_agg import (
                    GlobalAggregateOperator)

                if self.mesh_plan is not None:
                    raise NotImplementedError(
                        "unwindowed aggregation on a device mesh is not "
                        "yet supported; run without cluster.mesh-devices")
                t = n.window_transform
                op = self._ops[n.id] = GlobalAggregateOperator(
                    t.aggregate, num_shards=ctx.num_shards,
                    slots_per_shard=ctx.slots_per_shard, retract=t.retract)
                op.allow_drops = ctx.allow_drops
            elif n.kind == "process":
                from flink_tpu_torch.ops.process import KeyedProcessOperator

                op = self._ops[n.id] = KeyedProcessOperator(
                    n.window_transform.fn, num_shards=ctx.num_shards,
                    slots_per_shard=ctx.slots_per_shard)
                op.allow_drops = ctx.allow_drops
            elif n.kind == "cep":
                from flink_tpu_torch.cep import CepOperator

                t = n.window_transform
                op = self._ops[n.id] = CepOperator(
                    t.pattern, num_shards=ctx.num_shards,
                    slots_per_shard=ctx.slots_per_shard,
                    max_partials=t.max_partials)
                op.allow_drops = ctx.allow_drops
            elif n.kind == "async_io":
                from flink_tpu_torch.ops.async_io import AsyncIOOperator

                t = n.window_transform
                self._ops[n.id] = AsyncIOOperator(
                    getattr(t.fn, "invoke_batch", t.fn),
                    capacity=t.capacity, timeout_ms=t.timeout_ms,
                    ordered=t.ordered)
            elif n.kind == "broadcast_connect":
                from flink_tpu_torch.ops.broadcast import (
                    BroadcastConnectOperator)

                self._ops[n.id] = BroadcastConnectOperator(
                    n.window_transform.fn)

    def _shard_span(self) -> Optional[Tuple[int, int]]:
        """This process's contiguous span of the key shards in a job
        across processes (records reach it already routed); None in one
        process."""
        if self._nproc <= 1:
            return None
        spp = int(self.config.get(StateOptions.NUM_KEY_SHARDS)) // self._nproc
        return (self._pid * spp, (self._pid + 1) * spp)

    def _maybe_chain_device_source(self, sid: int, n) -> None:
        """Chain a device-made source into its consuming window operator
        when it is the source's only consumer, keyed on the source's key
        field, and the operator can host it (its own gate). K > 1
        subdivides the source first, when it can re-slice itself. Never
        across processes: there records cross between processes on the
        host."""
        src = n.source
        if (not isinstance(src, DeviceGeneratorSource)
                or src.device_keys_ts is None or len(n.downstream) != 1
                or self._dcn is not None):
            return
        wid = n.downstream[0]
        wn = self.plan.node(wid)
        if wn.kind != "window" or wn.key_field != src.key_field:
            return
        factor = 1
        if self._sub_batches > 1 and src.subdivide is not None:
            # a declared subdivision that fails is a config error, never
            # a silent fall back to logical-batch steps
            src = src.subdivided(self._sub_batches)
            factor = self._sub_batches
        op = self._ops[wid]
        if not op.attach_device_source(src):
            return
        self._dev_chains[sid] = (wid, src, factor)
        if factor > 1:
            self._sub_factor[sid] = factor
        if factor == 1:
            # steps stay logical batches: the K-scaled credit would
            # queue K times the bytes
            op.max_inflight_steps = self._base_inflight

    def _push_device_batch(self, sid: int, split_ix: int,
                           marker: "_DevBatch") -> bool:
        """Hand a device-made batch to its operator; False when a devgen
        gate closed and the batch must be fed from the host. Under
        'probe' readiness a subdivided chain rate-matches at the last
        sub-batch of each logical batch only (a probe a logical batch,
        as the reference amortizes them); under 'piggyback' at every
        sub-batch."""
        t0 = time.perf_counter()
        wid, _, factor = self._dev_chains[sid]
        ok = self._ops[wid].process_batch_device(marker.index)
        if ok:
            self.metrics["records_in"] += marker.n
            self.metrics["batches"] += 1
            if (factor == 1 or self._readiness == "piggyback"
                    or (marker.index + 1) % factor == 0):
                self._throttle_ops()
            self._positions[sid][split_ix] += 1
            self._eps_meter.mark(marker.n)
            self._on_source_ts(sid, split_ix, marker.ts_max)
        self.prof["push"] += time.perf_counter() - t0
        return ok

    def _host_batch_for(self, sid: int, marker: "_DevBatch"):
        """(the records of a device-made batch, made on the host; whether
        they are a sub-batch already). A subdivided source makes the
        bit-exact sub-batch slice, which the host path must not slice K
        ways again; a logical batch is sliced as any host-fed one."""
        _, src, factor = self._dev_chains[sid]
        self.metrics["devgen_host_batches"] += 1
        return src.gen("0", marker.index), factor > 1

    def _throttle_ops(self) -> None:
        """Backpressure: every window operator waits on its oldest
        in-flight step while it has more than its credit."""
        for op in self._ops.values():
            if hasattr(op, "throttle"):
                op.throttle()

    # -- checkpointing ------------------------------------------------------
    def _setup_checkpointing(self, job_name: str):
        from flink_tpu_torch.checkpoint.coordinator import CheckpointCoordinator
        from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

        interval = self.config.get(CheckpointingOptions.INTERVAL)
        restore = self.config.get(CheckpointingOptions.RESTORE)
        if interval <= 0 and not restore:
            return None
        if self._nproc > 1:
            # each process snapshots its span under a directory of its
            # own; the ids align because the decision rides the
            # rendezvous
            job_name = f"{job_name}-p{self._pid}"
        storage = FsCheckpointStorage(
            self.config.get(CheckpointingOptions.DIRECTORY),
            job_id=job_name.replace("/", "_"),
            retained=self.config.get(CheckpointingOptions.RETAINED),
            compression=self.config.get(CheckpointingOptions.COMPRESSION))
        return CheckpointCoordinator(storage)

    def _snapshot(self, allow_reuse: bool = True) -> Dict[str, Any]:
        """The checkpoint's payload, frozen at this batch boundary. An
        operator whose ``state_version`` is unchanged since the base (the
        last completed checkpoint) reuses that checkpoint's blob (a
        hardlink); savepoints stay self-contained."""
        from flink_tpu_torch.checkpoint.storage import ReusedOpState

        base = (self._ckpt_base
                if allow_reuse
                and self.config.get(CheckpointingOptions.INCREMENTAL)
                else None)
        ops: Dict[Any, Any] = {}
        versions: Dict[str, int] = {}
        for nid, op in self._ops.items():
            v = getattr(op, "state_version", None)
            versions[str(nid)] = -1 if v is None else int(v)
            if (v is not None and base is not None
                    and base["versions"].get(nid) == v
                    and nid in base["files"]):
                ops[nid] = ReusedOpState(
                    base["files"][nid], int(v),
                    # changelog aux (lsm runs) re-links from the base
                    # checkpoint's own hardlinks, never the store's live
                    # files: reuse must survive the store's compaction
                    aux=(base.get("aux") or {}).get(nid))
            else:
                ops[nid] = op.snapshot_state()
        self._last_freeze_versions = {
            nid: getattr(op, "state_version", -1)
            for nid, op in self._ops.items()}
        return {
            "sources": {sid: dict(pos) for sid, pos in self._positions.items()},
            # the factor positions count in: restore re-bases them when
            # its own factor differs (_rebase_position)
            "sub_factors": dict(self._sub_factor),
            "wm_gens": {sid: [g.snapshot() for g in gens]
                        for sid, gens in self._wm_gens.items()},
            "max_ts": dict(self._max_ts),
            "out_wm": dict(self._out_wm),
            "operators": ops,
            "op_versions": versions,
            "partitioners": {nid: p.snapshot()
                             for nid, p in self._partitioners.items()},
            # staged, uncommitted 2PC epochs: prepare_commit ran before
            # this snapshot, so the epoch it covers rides inside it
            "sinks": {
                nid: staged
                for nid, n in self.plan.nodes.items()
                if n.kind == "sink"
                and (staged := n.sink.snapshot_staged()) is not None
            },
            "metrics": dict(self.metrics),
            "rescale": self._rescale_identity(),
        }

    def _rescale_identity(self) -> Dict[str, Any]:
        """The key-group identity of the writing process, which a restore
        checks against its own."""
        num_shards = int(self.config.get(StateOptions.NUM_KEY_SHARDS))
        spp = num_shards // max(self._nproc, 1)
        return {"nproc": self._nproc, "pid": self._pid,
                "num_shards": num_shards,
                "shard_range": [self._pid * spp, (self._pid + 1) * spp]}

    # -- rescale restore ----------------------------------------------------
    def _rescale_from_paths(self) -> List[str]:
        """The checkpoint set (one per old process, in process order) a
        rescale restores from: ``cluster.rescale-from``, which every
        later attempt keeps, so each finds the pre-rescale cut (the
        restore floor in ``_run_loop``)."""
        raw = str(self.config.get(ClusterOptions.RESCALE_FROM) or "")
        return [p.strip() for p in raw.split(",") if p.strip()]

    @staticmethod
    def _checkpoint_seq(path: str) -> int:
        """The checkpoint id a checkpoint or savepoint directory was
        written under (ids are aligned across the processes): its
        manifest's ``checkpoint_id``, else the ``chk-<n>`` or
        ``savepoint-<n>`` of its name; -1 when it has neither."""
        import json
        import re

        from flink_tpu_torch.fs import get_filesystem

        mf = os.path.join(path, "MANIFEST.json")
        fs = get_filesystem(mf)
        if fs.exists(mf):
            with fs.open_read(mf) as f:
                return int(json.loads(f.read().decode())["checkpoint_id"])
        m = re.findall(r"(?:chk|savepoint)-(\d+)",
                       str(path).replace("\\", "/"))
        return int(m[-1]) if m else -1

    def _load_repartitioned(self, primary: str) -> Dict[str, Any]:
        """Load an explicit restore path. When its key-group identity
        (the writer's process count and id) is not this process's, load
        the whole set that ``cluster.rescale-from`` names and merge it
        down to this process's span of the shards
        (``checkpoint/repartition.py``). Profile keys ``restore_load``
        and ``restore_merge`` (s)."""
        from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

        t0 = time.perf_counter()
        payload = FsCheckpointStorage.load(primary)
        ident = payload.get("rescale")
        if ident is None or (int(ident.get("nproc", 1)) == self._nproc
                             and int(ident.get("pid", 0)) == self._pid):
            # the same identity (or a checkpoint without one): as it is
            return payload
        from flink_tpu_torch.checkpoint.repartition import merge_payloads

        paths = self._rescale_from_paths() or [primary]
        payloads = [payload if p == primary else FsCheckpointStorage.load(p)
                    for p in paths]
        payloads.sort(
            key=lambda pl: int((pl.get("rescale") or {}).get("pid", 0)))
        op_kinds = {nid: n.kind for nid, n in self.plan.nodes.items()
                    if nid in payload.get("operators", {})}
        t1 = time.perf_counter()
        merged = merge_payloads(
            payloads, new_pid=self._pid, new_nproc=self._nproc,
            num_shards=int(self.config.get(StateOptions.NUM_KEY_SHARDS)),
            slots_per_shard=int(self.config.get(StateOptions.SLOTS_PER_SHARD)),
            op_kinds=op_kinds)
        self.prof["restore_load"] += t1 - t0
        self.prof["restore_merge"] += time.perf_counter() - t1
        return merged

    def _restore(self, payload: Dict[str, Any]) -> None:
        self._positions = {sid: dict(pos)
                           for sid, pos in payload["sources"].items()}
        self._restored_sub_factors = {
            int(k): int(v)
            for k, v in payload.get("sub_factors", {}).items()}
        for sid, states in payload.get("wm_gens", {}).items():
            for g, st in zip(self._wm_gens[sid], states):
                g.restore(st)
        self._max_ts.update(payload.get("max_ts", {}))
        self._out_wm.update(payload.get("out_wm", {}))
        # the operators' state onto their blocks (a window's re-block and
        # upload): profile key restore_ops
        t0 = time.perf_counter()
        for nid, snap in payload["operators"].items():
            self._ops[nid].restore_state(snap)
        self.prof["restore_ops"] += time.perf_counter() - t0
        for nid, psnap in payload.get("partitioners", {}).items():
            p = make_partitioner(self.plan.node(nid).partition_strategy,
                                 seed=nid)
            p.restore(psnap)
            self._partitioners[nid] = p
        # adopt the checkpoint's operator versions and make it the reuse
        # base: an operator untouched after the restore hardlinks its
        # blob at the next checkpoint; a blob keeps its bytes, so a base
        # written under another compression is not reused
        file_versions = payload.get("op_file_versions")
        if (file_versions and payload.get("op_file_compression", "none")
                != self.config.get(CheckpointingOptions.COMPRESSION)):
            file_versions = None
        if file_versions:
            for nid, v in file_versions.items():
                if nid in self._ops and hasattr(
                        self._ops[nid], "state_version"):
                    self._ops[nid].state_version = v
            self._ckpt_base = {
                "files": dict(payload.get("op_files", {})),
                "versions": dict(file_versions),
                "aux": {nid: dict(m) for nid, m in
                        (payload.get("op_aux_paths") or {}).items()},
            }
        self.metrics.update(payload["metrics"])
        staged_sinks = payload.get("sinks", {})
        cid = int(payload.get("checkpoint_id", 0))
        for nid, n in self.plan.nodes.items():
            if n.kind != "sink":
                continue
            if nid in staged_sinks:
                # re-commit the epochs the completed checkpoint covers: a
                # crash between its manifest and the commit must not
                # lose them
                n.sink.restore_staged(staged_sinks[nid], cid)
            elif hasattr(n.sink, "abort_uncommitted"):
                n.sink.abort_uncommitted()

    def _abort_sinks(self) -> None:
        """Drop every sink's pending (never-committed) rows: a failed or
        superseded attempt's output must not leak into a later attempt
        that reuses the sink instances."""
        for n in self.plan.nodes.values():
            if n.kind == "sink" and hasattr(n.sink, "abort_uncommitted"):
                n.sink.abort_uncommitted()

    def checkpoint_now(self, savepoint: bool = False):
        """One synchronous checkpoint at the current batch boundary
        (``savepoint=True``: a retained savepoint); returns its handle
        once it is durable and committed."""
        if self._coordinator is None:
            raise RuntimeError(
                "checkpoint_now needs checkpointing: set "
                "execution.checkpointing.interval (or a restore)")
        # the checkpoint already in flight is a periodic one: its failure
        # is tolerable, this one's is not
        self._complete_pending_checkpoint(wait=True, tolerate=True)
        self._ckpt_pending = self._begin_checkpoint(savepoint=savepoint)
        return self._complete_pending_checkpoint(wait=True)

    def _begin_checkpoint(self, savepoint: bool = False):
        """The loop thread's part: deliver every fire so far (the staged
        epoch must hold them: a restore resets the emit rings, so a fire
        left on the device would be in neither the epoch nor the replay),
        stage the sinks' epoch and freeze the snapshot. Fetching,
        encoding and writing run on the checkpoint executor."""
        from flink_tpu_torch.obs.tracing import tracer

        # the drain waits for the steps in flight: the loop thread's part
        # of a checkpoint is this span and the coordinator's freeze span
        with tracer.span("checkpoint.barrier"):
            # async batches in flight are not in the snapshot, and their
            # source positions have advanced: their rows go downstream
            # first, so the staged epoch holds them
            for nid, op in self._ops.items():
                if self.plan.node(nid).kind == "async_io":
                    for b in op.poll(drain=True):
                        self._push_downstream(nid, b)
            self._drain_emits(barrier=True)
        sinks = [n.sink for n in self.plan.nodes.values() if n.kind == "sink"]
        commit_fns = [s.notify_checkpoint_complete for s in sinks]
        commit_fns.extend(self._source_offset_committers())
        pend = self._coordinator.trigger_async(
            lambda: self._snapshot(allow_reuse=not savepoint),
            commit_fns=commit_fns,
            prepare_fns=[s.prepare_commit for s in sinks],
            # a failed attempt's abandon() rolls this epoch back
            abort_fns=[s.notify_checkpoint_abort for s in sinks],
            executor=self._ckpt_executor,
            savepoint=savepoint,
        )
        pend.frozen_versions = dict(self._last_freeze_versions)
        pend.is_savepoint = savepoint
        return pend

    def _complete_pending_checkpoint(self, wait: bool = False,
                                     tolerate: bool = False):
        """Commit a finished background checkpoint's 2PC epoch on the
        loop thread; non-blocking unless ``wait``. ``tolerate``: a
        periodic checkpoint's persist or commit failure is ridden out up
        to ``execution.checkpointing.tolerable-failures`` consecutive
        times (its id left no manifest, and the staged epoch commits
        with the next checkpoint); savepoints and the final checkpoint
        never tolerate one."""
        p = self._ckpt_pending
        if p is None:
            return None
        if not wait and not p.done():
            return None
        try:
            handle = p.complete()
        except Exception as e:  # noqa: BLE001 — persist/commit failure
            self._ckpt_pending = None
            if p.is_savepoint:
                raise
            self._ckpt_failures += 1
            tol = int(self.config.get(
                CheckpointingOptions.TOLERABLE_FAILURES))
            if not tolerate or self._ckpt_failures > tol:
                raise
            from flink_tpu_torch.obs.tracing import tracer

            self.metrics["checkpoint_failures"] = (
                self.metrics.get("checkpoint_failures", 0) + 1)
            with tracer.span("checkpoint.failed",
                             checkpoint_id=p.checkpoint_id,
                             consecutive=self._ckpt_failures,
                             error=f"{type(e).__name__}: {e}"):
                pass
            return None
        if not p.is_savepoint:
            self._ckpt_failures = 0
        self._ckpt_pending = None
        if not p.is_savepoint:
            names = handle.op_files or {}
            aux_names = handle.op_aux or {}
            self._ckpt_base = {
                "files": {nid: os.path.join(
                    handle.path, names.get(str(nid), f"op-{nid}.blob"))
                    for nid in self._ops},
                "versions": dict(p.frozen_versions),
                "aux": {nid: {logical: os.path.join(handle.path, fn)
                              for logical, fn in
                              aux_names.get(str(nid), {}).items()}
                        for nid in self._ops
                        if aux_names.get(str(nid))},
            }
        return handle

    def _source_offset_committers(self):
        """One commit-round function a source that publishes committed
        offsets (a ``LogSource`` in a consumer group), run by the
        coordinator once the checkpoint is durable, with the positions
        frozen at this barrier: a group's floor never runs ahead of the
        checkpoint that proves its rows were consumed."""
        fns = []
        for sid in self.plan.sources:
            src = self.plan.node(sid).source
            if src is None or not hasattr(src, "commit_offsets"):
                continue
            frozen = dict(self._positions.get(sid, {}))

            def _commit(cid, _src=src, _frozen=frozen):
                _src.commit_offsets(cid, _frozen)

            fns.append(_commit)
        return fns

    def _commit_final_epoch(self) -> None:
        """The 2PC sinks' terminal commit of a bounded run without
        checkpointing: end of input is the terminal barrier. A ms
        timestamp for the epoch id cannot collide with an earlier run's
        ids in a reused sink directory. Consumer-group sources publish
        their final offsets under the same barrier."""
        final_epoch = int(time.time() * 1000)
        for n in self.plan.nodes.values():
            if n.kind == "sink":
                n.sink.prepare_commit(final_epoch)
                n.sink.notify_checkpoint_complete(final_epoch)
        for fn in self._source_offset_committers():
            fn(final_epoch)

    # -- the streaming loop -------------------------------------------------
    def run(self, job_name: str = "job", savepoint_request=None):
        """Run the job to the end of its input. ``savepoint_request``: a
        ``threading.Event``; once set, the loop takes a savepoint at the
        next batch boundary, clears it and keeps the savepoint's path in
        ``last_savepoint`` (a batch-mode run fails instead)."""
        from concurrent.futures import ThreadPoolExecutor

        from flink_tpu_torch import faults
        from flink_tpu_torch.fs import install_enospc_policy_from_config
        from flink_tpu_torch.obs.metrics import MetricsServer

        self._savepoint_request = savepoint_request
        self.last_savepoint = None
        if self.plan.runtime_mode == "batch":
            # a bounded run recovers by running again: nothing to
            # checkpoint, nothing to restore
            if self.config.get(CheckpointingOptions.INTERVAL) > 0:
                raise ValueError(
                    "execution.checkpointing.interval is incompatible "
                    "with execution.runtime-mode=batch (bounded-mode "
                    "recovery is re-execution; 2PC sinks commit once "
                    "at end of input)")
            restore = self.config.get(CheckpointingOptions.RESTORE)
            if restore == "latest":
                # a supervisor's retry asks for the latest checkpoint;
                # a batch job has none and reruns from the start
                self.config.set(CheckpointingOptions.RESTORE, "")
            elif restore:
                raise ValueError(
                    "execution.checkpointing.restore is incompatible "
                    "with execution.runtime-mode=batch (nothing "
                    "checkpoints in batch mode — re-run the job)")
        self._coordinator = self._setup_checkpointing(job_name)
        # the attempt's fencing epoch, announced to the sinks before any
        # restore or write: epoch-qualified staged names keep a deposed
        # attempt's late renames off a successor's output. It stays 0
        # until the coordinator that mints it (cluster.attempt, ROADMAP.md
        # queue 1 item 10) is ported, the reference's default. The host
        # pool rides the same announcement: a log sink writes its
        # partitions' segments and runs its group fsync through it.
        for n in self.plan.nodes.values():
            if n.kind == "sink":
                setter = getattr(n.sink, "set_attempt_epoch", None)
                if setter is not None:
                    setter(0)
                pool_setter = getattr(n.sink, "set_host_pool", None)
                if pool_setter is not None:
                    pool_setter(self.host_pool)
        # the job's disk-full policy, process-wide for every durable write
        install_enospc_policy_from_config(self.config)
        # the checkpoint executor serves this job's fault scope
        self._ckpt_executor = (ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt",
            initializer=faults.set_thread_scope,
            initargs=(faults.current_scope(),))
            if self._coordinator is not None else None)
        port = int(self.config.get(MetricsOptions.PORT))
        self._metrics_server = (
            MetricsServer(self.registry, port,
                          str(self.config.get(MetricsOptions.BIND)))
            if port else None)
        self._srcs: Dict[int, Dict[int, Any]] = {}
        self._cleaners = self._start_cleaners()
        try:
            return self._run_loop(job_name)
        except BaseException:
            # a failed attempt: its in-flight checkpoint must not commit
            # (the manifest may still land, which restore reads like a
            # crash between manifest and commit); wait a bounded time so
            # the next attempt does not race its writer on one id
            if self._ckpt_pending is not None:
                self._ckpt_pending.abandon()
                from concurrent.futures import wait as _fwait

                _fwait([self._ckpt_pending.future], timeout=30.0)
                self._ckpt_pending = None
            # rows delivered before the crash still sit in the sinks
            self._abort_sinks()
            raise
        finally:
            # cleaners end with the run on every exit path, releasing
            # their leases so a successor acquires at once
            for cleaner in self._cleaners:
                try:
                    cleaner.stop()
                except Exception:  # noqa: BLE001 — must not mask the outcome
                    pass
            self._cleaners = []
            # an endpoint alive past its attempt would hold a fixed
            # cluster.dcn-port: the next attempt's bind would fail
            if self._dcn is not None:
                self._dcn.close()
                self._dcn = None
            # feeder threads end with the attempt, before a restart
            # reopens the splits at their positions
            for its in self._srcs.values():
                for it in its.values():
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
            self._srcs = {}
            if self._metrics_server is not None:
                self._metrics_server.close()
                self._metrics_server = None
            if self._ckpt_executor is not None:
                # an abandoned persist may still be writing; letting it
                # finish is safe (manifest last)
                self._ckpt_executor.shutdown(wait=False)
                self._ckpt_executor = None
            # the host pool ends with the run (its shutdown does not
            # wait; a later call runs inline)
            self.host_pool.close()
            # so do the async I/O workers, on success and on failure
            for nid, op in self._ops.items():
                if self.plan.node(nid).kind == "async_io":
                    op.close()

    def _start_cleaners(self) -> list:
        """Under ``log.cleaner.enabled``, one leased background cleaner a
        ``LogSink`` topic of the job (compaction then retention at
        ``log.cleaner.interval-ms``). A topic whose cleaner lease another
        live service holds runs without one."""
        from flink_tpu_torch.config import LogOptions

        if not bool(self.config.get(LogOptions.CLEANER_ENABLED)):
            return []
        from flink_tpu_torch.log.cleaner import LogCleaner
        from flink_tpu_torch.log.connectors import LogSink
        from flink_tpu_torch.log.topic import LogError

        cleaners, seen = [], set()
        for n in self.plan.nodes.values():
            if (n.kind != "sink" or not isinstance(n.sink, LogSink)
                    or n.sink.path in seen):
                continue
            seen.add(n.sink.path)
            cleaner = LogCleaner(n.sink.path, self.config)
            try:
                cleaner.start()
            except LogError:
                continue  # a live cleaner service owns this topic
            cleaners.append(cleaner)
        return cleaners

    def _run_loop(self, job_name: str):
        from flink_tpu_torch.api.environment import JobResult

        t_start = time.perf_counter()
        interval_ms = int(self.config.get(CheckpointingOptions.INTERVAL))
        restore = self.config.get(CheckpointingOptions.RESTORE)
        for sid in self.plan.sources:
            n = self.plan.node(sid)
            strategy = n.watermark_strategy or self.plan.watermark_strategy
            # one watermark generator per split, combined with min
            self._wm_gens[sid] = [make_generator(strategy)
                                  for _ in n.source.splits()]
            self._max_ts[sid] = LONG_MIN
            self._positions[sid] = {i: 0 for i in
                                    range(len(n.source.splits()))}
        # across processes: the exchange comes up before the restore,
        # whose checkpoint id the processes negotiate (a crash can leave
        # one process a checkpoint ahead)
        if self._nproc > 1:
            if self.plan.runtime_mode == "batch":
                raise NotImplementedError(
                    "execution.runtime-mode=batch is single-process in "
                    "v1 — the DCN rendezvous is a per-step streaming "
                    "protocol; cross-host batch needs a partition-file "
                    "transfer plane (out of scope, see COMPONENTS #57)")
            self._dcn = self._dcn_connect()
        self._restored_sub_factors: Dict[int, int] = {}
        if restore:
            if restore == "latest":
                payload = (self._dcn_negotiated_restore()
                           if self._dcn is not None
                           else self._coordinator.restore_latest())
                # the rescale floor: a checkpoint older than the set that
                # cluster.rescale-from names predates the cut (at 1 -> 2
                # -> 1 the last process count reuses the first one's
                # directory, whose latest checkpoint is pre-rescale
                # state at another key-group geometry); the set wins
                # unless a checkpoint at least as new exists
                paths = self._rescale_from_paths()
                if paths:
                    floor = max(self._checkpoint_seq(p) for p in paths)
                    have = (int(payload.get("checkpoint_id", -1))
                            if payload is not None else -1)
                    if have < floor:
                        payload = self._load_repartitioned(paths[0])
                        self._coordinator.resume_numbering(payload)
            else:
                payload = self._load_repartitioned(restore)
                self._coordinator.resume_numbering(payload)
            if payload is not None:
                self._restore(payload)
            else:
                # nothing to restore (a crash before the first
                # checkpoint): a reused sink still holds the crashed
                # attempt's rows, which the full replay would repeat
                self._abort_sinks()
        srcs = self._srcs
        for sid in self.plan.sources:
            n = self.plan.node(sid)
            if self.plan.runtime_mode != "batch":
                # batch mode makes every batch on the host: the chain
                # fires per step, which the one final fire skips
                self._maybe_chain_device_source(sid, n)
            # positions were counted at the restored factor: re-base them
            # to this run's, or fail on a cut that does not align
            old_f = int(self._restored_sub_factors.get(sid, 1))
            new_f = int(self._sub_factor.get(sid, 1))
            if old_f != new_f:
                for i, pos in list(self._positions[sid].items()):
                    self._positions[sid][i] = _rebase_position(
                        int(pos), old_f, new_f, sid=sid, split_ix=i)
            srcs[sid] = {}
            splits = n.source.splits()
            for i in self._owned_splits(len(splits)):
                split = splits[i]
                start = self._positions[sid].get(i, 0)
                if sid in self._dev_chains:
                    # no records and no feeder thread: markers only
                    srcs[sid][i] = _dev_batch_markers(
                        self._dev_chains[sid][1], start)
                    continue
                it = n.source.open_split(split, start)
                srcs[sid][i] = (_Prefetcher(it, self._prefetch)
                                if self._prefetch > 0 else iter(it))
        if self.plan.runtime_mode == "batch":
            return self._run_batch(job_name, srcs, t_start)
        last_chk = time.time()
        active = {sid: sorted(its) for sid, its in srcs.items()}
        if self._dcn is not None:
            try:
                self._ingest_loop_dcn(srcs, interval_ms)
            finally:
                self._dcn.close()
                self._dcn = None
            active = {}
        while any(active.values()):
            for sid, alive in active.items():
                for split_ix in list(alive):
                    t0 = time.perf_counter()
                    nxt = next(srcs[sid][split_ix], None)
                    self.prof["source_next"] += time.perf_counter() - t0
                    if nxt is None:
                        alive.remove(split_ix)
                        continue
                    already_sub = False
                    if isinstance(nxt, _DevBatch):
                        if self._push_device_batch(sid, split_ix, nxt):
                            continue
                        nxt, already_sub = self._host_batch_for(sid, nxt)
                    data, ts = nxt
                    ts = np.asarray(ts, np.int64)
                    if self._sub_batches > 1 and not already_sub:
                        self._ingest_host_subbatched(sid, split_ix, alive,
                                                     data, ts)
                    else:
                        for data_c, ts_c in self._debloat_split(data, ts):
                            self._push_source_batch(sid, data_c, ts_c)
                    src = self.plan.node(sid).source
                    self._positions[sid][split_ix] = src.position_after(
                        self._positions[sid][split_ix], data, ts)
                    self._eps_meter.mark(len(ts))
                    if len(ts):
                        self._on_source_ts(sid, split_ix, int(ts.max()))
                # exhausted splits stop holding the watermark back
                self._recombine_source_wm(sid, alive)
                t3 = time.perf_counter()
                self._propagate_watermarks()
                self.prof["advance_wm"] += time.perf_counter() - t3
                self._drain_emits(barrier=False)
            self._debloat_adjust()
            # commit a finished background checkpoint (never blocks),
            # then start the next once the interval has passed and none
            # is in flight
            self._complete_pending_checkpoint(wait=False, tolerate=True)
            if (self._coordinator is not None and interval_ms > 0
                    and self._ckpt_pending is None
                    and (time.time() - last_chk) * 1000 >= interval_ms):
                t0 = time.perf_counter()
                self._ckpt_pending = self._begin_checkpoint()
                self.prof["checkpoint_freeze"] += time.perf_counter() - t0
                last_chk = time.time()
            self._maybe_take_savepoint()
        # end of input: the final watermark flushes every window
        self._quiesce_ops()
        for sid in self.plan.sources:
            self._out_wm[sid] = _FINAL
        self._propagate_watermarks(final=True)
        self._drain_emits(barrier=True)
        self._quiesce_ops()
        if self._coordinator is not None and interval_ms > 0:
            t0 = time.perf_counter()
            self.checkpoint_now()  # the final epoch's commit
            self.prof["checkpoint_final"] += time.perf_counter() - t0
        else:
            self._commit_final_epoch()
        for n in self.plan.nodes.values():
            if n.kind == "sink":
                n.sink.close()
        return JobResult(job_name, self._final_metrics(t_start))

    def _maybe_take_savepoint(self) -> None:
        """A requested savepoint, synchronous and retained, at this batch
        boundary (a job without checkpoint storage ignores the
        request)."""
        req = self._savepoint_request
        if req is None or not req.is_set():
            return
        req.clear()
        if self._coordinator is not None:
            self.last_savepoint = self.checkpoint_now(savepoint=True).path

    # -- batch mode ---------------------------------------------------------
    def _run_batch(self, job_name: str, srcs, t_start: float):
        """The bounded run: the waves in order, each blocking edge
        spooled in full before its consumer's wave, each stateful
        operator firing once, at its wave's end."""
        from flink_tpu_torch.api.environment import JobResult
        from flink_tpu_torch.config import ExecutionOptions
        from flink_tpu_torch.exchange.blocking import BlockingShuffle
        from flink_tpu_torch.runtime.scheduler import BatchStageScheduler

        cfg = self.config
        # a crashed earlier attempt may have left staged rows in a reused
        # sink directory: this run commits only its own output
        self._abort_sinks()
        sched = BatchStageScheduler(self.plan)
        shuffle = BlockingShuffle(
            str(cfg.get(ExecutionOptions.BATCH_SHUFFLE_DIR)), job_name,
            n_partitions=int(cfg.get(
                ExecutionOptions.BATCH_SHUFFLE_PARTITIONS)),
            cleanup=bool(cfg.get(ExecutionOptions.BATCH_SHUFFLE_CLEANUP)))
        # every spool opens up front (a union may merge producers of two
        # waves into one edge) and seals when its consumer's wave starts
        for u, v in self.plan.blocking_edges:
            self._batch_capture[(u, v)] = shuffle.open_edge(
                u, v, key_field=self._edge_key_field(u, v))
        t0 = time.perf_counter()
        try:
            for stage in sched.waves:
                self._batch_reject_savepoint()
                for edge in stage.in_edges:
                    self._batch_capture.pop(edge).seal()
                sched.start(stage)
                if stage.index == 0:
                    for sid in stage.heads:
                        self._batch_drain_source(sid, srcs[sid])
                else:
                    for v in stage.heads:
                        self._batch_feed_head(v, stage, shuffle)
                self._batch_finalize_wave(stage)
                sched.finish(stage)
                self.prof[f"batch_wave{stage.index}"] += (
                    stage.finished_at - stage.started_at)
            self.metrics["shuffle_bytes_spooled"] = shuffle.bytes_written
            self.metrics["shuffle_rows_spooled"] = shuffle.rows_spooled
            self.metrics["batch_waves"] = len(sched.waves)
            # a request armed during the last wave fails the run too
            self._batch_reject_savepoint()
        finally:
            self._batch_capture = {}
            shuffle.close()
        t1 = time.perf_counter()
        self._commit_final_epoch()
        self.prof["batch_commit"] += time.perf_counter() - t1
        self.metrics["batch_wall_s"] = round(time.perf_counter() - t0, 3)
        for n in self.plan.nodes.values():
            if n.kind == "sink":
                n.sink.close()
        return JobResult(job_name, self._final_metrics(t_start))

    def _batch_reject_savepoint(self) -> None:
        if (self._savepoint_request is not None
                and self._savepoint_request.is_set()):
            raise ValueError(
                "savepoints are not supported in "
                "execution.runtime-mode=batch (nothing checkpoints; "
                "recovery is re-execution)")

    def _edge_key_field(self, u: int, v: int) -> Optional[str]:
        """The key column routing a blocking edge's partitions (None: one
        partition); a join's edge keys on its side's column."""
        n = self.plan.node(v)
        if n.kind == "join":
            t = n.window_transform
            return t.left_key if u == n.left_input else t.right_key
        if n.kind in ("window", "session", "count_window", "process",
                      "cep", "evicting_window", "global_agg"):
            return n.key_field
        return None  # window_all, async_io, broadcast_connect

    def _batch_drain_source(self, sid: int, its) -> None:
        """Wave 0: each split of the source to its end, every batch
        whole through the wave's stateless chains into the spools; no
        watermark moves until the wave's end."""
        src = self.plan.node(sid).source
        for split_ix in sorted(its):
            it = its[split_ix]
            while True:
                t0 = time.perf_counter()
                nxt = next(it, None)
                self.prof["source_next"] += time.perf_counter() - t0
                if nxt is None:
                    break
                data, ts = nxt
                ts = np.asarray(ts, np.int64)
                self._push_source_batch(sid, data, ts)
                self._positions[sid][split_ix] = src.position_after(
                    self._positions[sid][split_ix], data, ts)
                self._eps_meter.mark(len(ts))
                if len(ts):
                    self._max_ts[sid] = max(self._max_ts[sid], int(ts.max()))
        self._out_wm[sid] = _FINAL

    def _batch_feed_head(self, v: int, stage, shuffle) -> None:
        """Replay a wave head's sealed partitions into its operator: a
        broadcast connect takes its control side first, a join its left
        side first (blind to time until the wave's end, so the order of
        the sides changes nothing)."""
        n = self.plan.node(v)
        edges = [e for e in stage.in_edges if e[1] == v]
        if n.kind == "broadcast_connect":
            edges.sort(key=lambda e: 0 if e[0] == n.right_input else 1)
        elif n.kind == "join":
            edges.sort(key=lambda e: 0 if e[0] == n.left_input else 1)
        op = self._ops.get(v)
        for u, _ in edges:
            for data, ts in shuffle.edge(u, v).read():
                t0 = time.perf_counter()
                self.metrics["shuffle_records_replayed"] = (
                    self.metrics.get("shuffle_records_replayed", 0) + len(ts))
                self._push(v, (data, ts, np.ones(len(ts), bool)), u)
                if n.kind == "async_io":
                    # nothing else polls it before the wave's end
                    for b in op.poll():
                        self._push_downstream(v, b)
                self._throttle_ops()
                self.prof["push"] += time.perf_counter() - t0

    def _batch_finalize_wave(self, stage) -> None:
        """The wave's end of input: its held-back steps folded in, one
        final watermark pass over its nodes (each stateful operator's
        one fire), a barrier drain that delivers the fires, into the
        next waves' spools where they lead there, and the wave's device
        work completed (its errors raised, its device time counted)."""
        ops = [op for nid, op in self._ops.items()
               if nid in stage.nodes and hasattr(op, "quiesce")]
        for op in ops:
            op.quiesce()
        t0 = time.perf_counter()
        self._propagate_watermarks(final=True, only=set(stage.nodes))
        self._drain_emits(barrier=True)
        for op in ops:
            op.quiesce()
        self.prof["batch_fire"] += time.perf_counter() - t0

    def _quiesce_ops(self) -> None:
        """Fold every held-back step in (the operators that hold any)."""
        for op in self._ops.values():
            if hasattr(op, "quiesce"):
                op.quiesce()

    def _owned_splits(self, n_splits: int) -> List[int]:
        """The split indices this process reads: all of them in one
        process; across processes a strided share, ``pid, pid + n,
        ...``, so the processes divide the source without overlap."""
        if self._nproc > 1:
            return list(range(self._pid, n_splits, self._nproc))
        return list(range(n_splits))

    # -- the cross-process data plane ---------------------------------------
    def _dcn_connect(self):
        """Build and connect this process's exchange endpoint, after the
        v1 topology checks: one source, one keyed window, the shards
        divisible by the processes, no allowed lateness."""
        from flink_tpu_torch.exchange.dcn import DcnExchange

        cfg = self.config
        n = self._nproc
        peers = [p.strip() for p in
                 str(cfg.get(ClusterOptions.DCN_PEERS)).split(",")
                 if p.strip()]
        if len(peers) != n:
            raise ValueError(
                f"cluster.dcn-peers must list {n} host:port entries, got "
                f"{len(peers)} (the coordinator rendezvous, "
                "cluster.dcn-rendezvous, is ROADMAP.md queue 1 item 10)")
        if len(self.plan.sources) != 1:
            raise NotImplementedError(
                "cross-process jobs support exactly one source in v1")
        keyed = [nd for nd in self.plan.nodes.values()
                 if nd.kind == "window"]
        if len(keyed) != 1:
            raise NotImplementedError(
                "cross-process jobs support exactly one keyed window "
                "stage in v1")
        num_shards = int(cfg.get(StateOptions.NUM_KEY_SHARDS))
        if num_shards % n:
            raise ValueError(
                f"state.num-key-shards ({num_shards}) must divide by "
                f"cluster.num-processes ({n}) — shards are the rescale "
                "unit (the key-group contract)")
        if keyed[0].window_transform.allowed_lateness_ms:
            raise NotImplementedError(
                "allowed lateness across processes needs a refire "
                "consensus the v1 exchange does not carry")
        bind = str(cfg.get(ClusterOptions.DCN_BIND)).strip()
        if bind == "auto":
            # widen past loopback only when a peer is on another host
            hosts = [p.rpartition(":")[0].strip() for p in peers]
            bind = ("0.0.0.0" if any(h and h not in ("127.0.0.1",
                                                     "localhost")
                                     for h in hosts) else "127.0.0.1")
        # attempt 1: the fencing epoch a coordinator mints per attempt
        # (cluster.attempt) comes with ROADMAP.md queue 1 item 10; the JAX
        # package's static-peers default is the same 1
        ex = DcnExchange(self._pid, n,
                         listen_port=int(cfg.get(ClusterOptions.DCN_PORT)),
                         bind_host=bind, attempt=1,
                         secret=str(cfg.get(ClusterOptions.DCN_SECRET)
                                    or "") or None,
                         io_threads=int(cfg.get(ClusterOptions.DCN_IO_THREADS)),
                         buffer_bytes=int(cfg.get(
                             ClusterOptions.DCN_BUFFER_BYTES)))
        try:
            ex.connect(peers)
        except BaseException:
            # a half-connected endpoint must not outlive the attempt: its
            # listener would hold a fixed cluster.dcn-port
            ex.close()
            raise
        self._dcn_key_field = keyed[0].key_field
        self._dcn_shards = num_shards
        return ex

    def _dcn_negotiated_restore(self) -> Optional[Dict[str, Any]]:
        """Agree on one checkpoint id across the processes (the least of
        every process's latest) and load it; None when a process has none:
        everyone then replays from the start together."""
        from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

        latest = self._coordinator.storage.latest()
        my_id = latest.checkpoint_id if latest is not None else -1
        _, metas = self._dcn.exchange({}, {"latest": int(my_id)})
        common = min(int(m["latest"]) for m in metas)
        if common < 0:
            return None
        # the last match: list_complete sorts by (id, epoch)
        match = [h for h in self._coordinator.storage.list_complete()
                 if h.checkpoint_id == common and not h.is_savepoint]
        if not match:
            raise RuntimeError(
                f"negotiated checkpoint id {common} is missing locally — "
                "retention removed it; raise "
                "execution.checkpointing.num-retained")
        payload = FsCheckpointStorage.load(match[-1])
        self._coordinator.resume_numbering(payload)
        return payload

    def _ingest_loop_dcn(self, srcs, interval_ms: int) -> None:
        """The cross-process step loop: ingest a local batch, route its
        records to the processes that own their shards, rendezvous (the
        step barrier, carrying the watermark, termination and checkpoint
        consensus), then run the local pipeline on this process's share.

        Step overlap (``cluster.dcn-overlap``, default on): step k+1's
        frames go out before step k's are consumed, so one step's
        exchange is always in flight while the card folds the previous
        share and the host routes the next. The consensus is untouched
        (metas are the same on every process, so every process makes the
        same checkpoint and termination decision one step later), and a
        checkpoint barrier first drains the step in flight
        (``cluster.dcn-overlap-drain``), so the cut covers every routed
        record.

        ``pipeline.sub-batches`` K > 1 pushes this process's merged share
        as K contiguous slices (``_push_dcn_merged``); the global
        watermark still advances once a rendezvous, so committed rows
        are the K = 1 run's."""
        cfg = self.config
        n, pid = self._nproc, self._pid
        key_field = self._dcn_key_field
        (sid,) = list(self.plan.sources)
        d = srcs[sid]
        order = sorted(d)
        src = self.plan.node(sid).source
        ex = self._dcn
        overlap = (bool(cfg.get(ClusterOptions.DCN_OVERLAP))
                   and ex.supports_async)
        drain_at_barrier = bool(cfg.get(ClusterOptions.DCN_OVERLAP_DRAIN))
        st = _DcnStepState(last_chk=time.time())
        pending_x = None    # the one overlapped step in flight
        # without the drain, the in-flight step's meta was dispatched
        # before the snapshot it rode behind: its ckpt flag is stale and
        # is absorbed once (every process absorbs the same one)
        stale_ckpt = False
        while True:
            batch = batch_ix = None
            while order:
                ix = order[0]
                t0 = time.perf_counter()
                nxt = next(d[ix], None)
                self.prof["source_next"] += time.perf_counter() - t0
                if nxt is None:
                    order.pop(0)
                    continue
                batch, batch_ix = nxt, ix
                self._positions[sid][ix] = src.position_after(
                    self._positions[sid][ix], nxt[0], nxt[1])
                break
            shares: Dict[int, Any] = {}
            if batch is not None:
                t0 = time.perf_counter()
                data, ts = batch
                ts = np.asarray(ts, np.int64)
                if len(ts):
                    self._on_source_ts(sid, batch_ix, int(ts.max()))
                keys = np.asarray(data[key_field], np.int64)
                # the process of each record by the one routing truth the
                # hybrid mesh plan shares: records of this process never
                # touch the wire
                dest, _ = hybrid_route(keys, self._dcn_shards, n)
                for j in range(n):
                    m = dest == j
                    if m.any():
                        shares[j] = {"data": {k: np.asarray(v)[m]
                                              for k, v in data.items()},
                                     "ts": ts[m]}
                self._dcn_stats["records_routed"] += len(ts)
                self._dcn_stats["records_sent"] += int(
                    np.count_nonzero(dest != pid))
                self.prof["dcn_route"] += time.perf_counter() - t0
            local_wm = (min(self._wm_gens[sid][i].current() for i in order)
                        if order else _FINAL)
            want_ckpt = (pid == 0 and self._coordinator is not None
                         and interval_ms > 0
                         and (time.time() - st.last_chk) * 1000
                         >= interval_ms)
            # savepoint requests (the reference's "sp" flag) come with
            # the control plane, ROADMAP.md queue 1 item 10
            meta = {"wm": int(local_wm), "done": batch is None,
                    "ckpt": bool(want_ckpt),
                    # the id this process holds durably: a checkpoint
                    # commits once every process has it (2PC phase 2)
                    "persisted": int(st.persisted_id)}
            h = ex.exchange_async(shares, meta)
            if overlap and pending_x is None:
                pending_x = h  # prime the double buffer
                continue
            target, pending_x = (pending_x, h) if overlap else (h, None)
            all_done, ckpt_req = self._dcn_consume_step(
                sid, target, st, deferred=overlap)
            if stale_ckpt:
                ckpt_req = stale_ckpt = False
            if not (all_done or ckpt_req):
                continue
            if pending_x is not None and (all_done or drain_at_barrier):
                # drain the step in flight so the cut (or the final
                # barrier) covers its records; its flags are absorbed,
                # the same on every process, except termination
                done2, _ = self._dcn_consume_step(sid, pending_x, st,
                                                  absorb=True, deferred=True)
                all_done = all_done or done2
                pending_x = None
            if ckpt_req:
                # process 0's clock decided and the flag rode the
                # rendezvous: every process snapshots at this same step
                # boundary, one consistent cut
                if self._coordinator is not None and st.pending is None:
                    t0 = time.perf_counter()
                    st.pending = self._begin_checkpoint()
                    self._ckpt_pending = st.pending
                    t1 = time.perf_counter()
                    st.pending.future.result()  # durable before the ack
                    self.prof["checkpoint_freeze"] += t1 - t0
                    self.prof["checkpoint_persist_wait"] += (
                        time.perf_counter() - t1)
                    st.pending_id = st.pending.checkpoint_id
                    st.persisted_id = st.pending_id
                st.last_chk = time.time()
                stale_ckpt = pending_x is not None
            if all_done:
                if st.pending is not None:
                    # end of input is the final barrier: every process
                    # reached it, so the last cut is global
                    st.pending.complete()
                    self._ckpt_pending = None
                return

    def _dcn_consume_step(self, sid: int, handle, st: "_DcnStepState",
                          absorb: bool = False, deferred: bool = False):
        """Consume one rendezvous step: the barrier on the handle, this
        process's merged share through the local pipeline, the global
        watermark, and the 2PC commit of a checkpoint every process
        holds. Returns (all done, checkpoint requested); ``absorb``
        drops the checkpoint flag (a drained step rides the barrier that
        drained it); ``deferred`` marks an overlapped consume, the one
        place the ``dcn.overlap.consume`` fault point fires."""
        if deferred:
            from flink_tpu_torch import faults

            faults.fire("dcn.overlap.consume", exc=ConnectionError)
        t0 = time.perf_counter()
        payloads, metas = handle.result()
        self._dcn_wait.update((time.perf_counter() - t0) * 1000.0)
        self._dcn_stats["bytes_sent"] = self._dcn.bytes_sent
        parts = [p for p in payloads if p is not None and len(p["ts"])]
        if parts:
            md = {k: np.concatenate([p["data"][k] for p in parts])
                  for k in parts[0]["data"]}
            mts = np.concatenate([p["ts"] for p in parts])
            self._push_dcn_merged(sid, md, mts)
            self._throttle_ops()
            self._eps_meter.mark(len(mts))
        # the same global watermark on every process: the min of the
        # piggybacked locals (an exhausted process reports _FINAL)
        gwm = min(int(m["wm"]) for m in metas)
        if gwm != _FINAL and gwm > self._out_wm[sid]:
            self._out_wm[sid] = gwm
        t3 = time.perf_counter()
        self._propagate_watermarks()
        self.prof["advance_wm"] += time.perf_counter() - t3
        self._drain_emits(barrier=False)
        if (st.pending is not None
                and all(int(m.get("persisted", -1)) >= st.pending_id
                        for m in metas)):
            st.pending.complete()
            self._ckpt_pending = None
            st.pending = None
        ckpt_req = (not absorb) and any(bool(m.get("ckpt")) for m in metas)
        return all(bool(m["done"]) for m in metas), ckpt_req

    def _push_dcn_merged(self, sid: int, md, mts: np.ndarray) -> None:
        """This process's merged share downstream: one batch at K = 1, or
        K contiguous slices with a watermark pass and a landed-fire
        delivery between them at ``pipeline.sub-batches`` = K. The caller
        applies the global watermark after the whole push, so late
        classification and the committed rows do not change with K."""
        t0 = time.perf_counter()
        nrec = len(mts)
        valid = np.ones(nrec, bool)
        self.metrics["records_in"] += nrec
        self.metrics["batches"] += 1
        k = self._sub_batches
        if k <= 1 or nrec <= k:
            self._push_downstream(sid, (md, mts, valid))
        else:
            sub = -(-nrec // k)  # ragged tails allowed across processes
            for lo in range(0, nrec, sub):
                hi = min(lo + sub, nrec)
                self._push_downstream(
                    sid, ({kk: v[lo:hi] for kk, v in md.items()},
                          mts[lo:hi], valid[lo:hi]))
                self._propagate_watermarks()
                self._drain_emits(barrier=False)
        self.prof["push"] += time.perf_counter() - t0

    def _on_source_ts(self, sid: int, split_ix: int, ts_max: int) -> None:
        """One consumed batch's newest timestamp: the split's watermark
        generator, the source's max timestamp and the lag gauge."""
        self._max_ts[sid] = max(self._max_ts[sid], ts_max)
        self._wm_gens[sid][split_ix].on_batch(ts_max)
        self._wm_lag.set(ts_max - self._out_wm[sid])

    def _final_metrics(self, t_start: float) -> Dict[str, Any]:
        out = dict(self.metrics)
        out.update(self.registry.snapshot())
        out["wall_s"] = time.perf_counter() - t_start
        if self._coordinator is not None:
            out["checkpoints_completed"] = len(self._coordinator.stats)
        out["device"] = str(self.device)
        for counter in ("late_records", "records_dropped_full",
                        "records_spilled", "exchange_overflow",
                        "exchange_bytes"):
            out[counter] = sum(getattr(op, counter, 0)
                               for op in self._ops.values())
        if self.mesh_plan is not None:
            out["mesh_devices"] = [str(d) for d in self.mesh_plan.devices]
        for k, v in self.prof.items():
            out[f"profile.driver.{k}"] = v
        for nid, op in self._ops.items():
            # the device operators: a window's own, a join's sides in
            # aggregate mode as opN.0 / opN.1; a host operator has none
            if hasattr(op, "timer"):
                devs = [(str(nid), op)]
            elif hasattr(op, "sides"):
                devs = [(f"{nid}.{i}", s) for i, s in enumerate(op.sides())]
            else:
                devs = []
            for name, dop in devs:
                for k, v in dop.prof.items():
                    out[f"profile.op{name}.{k}"] = v
                for k, v in dop.timer.busy_ms.items():
                    out[f"device_busy_ms.op{name}.{k}"] = v
        return out

    def _push_source_batch(self, sid: int, data, ts: np.ndarray) -> None:
        """Push one host-fed batch (or slice) downstream, then throttle."""
        t0 = time.perf_counter()
        self.metrics["records_in"] += len(ts)
        self.metrics["batches"] += 1
        self._push_downstream(sid, (dict(data), ts, np.ones(len(ts), bool)))
        self._throttle_ops()
        self.prof["push"] += time.perf_counter() - t0

    def _recombine_source_wm(self, sid: int, alive) -> None:
        """The source's watermark: the min over its live splits'
        generators (over all of them once every split is exhausted)."""
        gens = [self._wm_gens[sid][i] for i in alive] or self._wm_gens[sid]
        self._out_wm[sid] = min(g.current() for g in gens)

    def _ingest_host_subbatched(self, sid: int, split_ix: int, alive,
                                data, ts: np.ndarray) -> None:
        """Host-plane sub-batching (``pipeline.sub-batches`` = K > 1, the
        reference driver's ``_ingest_host_subbatched``): the logical batch
        is pushed as K contiguous slices (the last one ragged), and after
        each slice the split's watermark generator sees the slice's
        newest timestamp, the watermarks propagate (fires dispatch) and
        landed fires are delivered. Record order is untouched, so the
        watermark's meaning and the committed rows match the K = 1 run;
        the caller still takes the logical batch's max timestamp."""
        n = len(ts)
        sub = max(1, -(-n // self._sub_batches))
        for lo in range(0, n, sub):
            hi = min(lo + sub, n)
            for data_c, ts_c in self._debloat_split(
                    {k: v[lo:hi] for k, v in data.items()}, ts[lo:hi]):
                self._push_source_batch(sid, data_c, ts_c)
            if hi > lo:
                self._wm_gens[sid][split_ix].on_batch(int(ts[lo:hi].max()))
            self._recombine_source_wm(sid, alive)
            t3 = time.perf_counter()
            self._propagate_watermarks()
            self.prof["advance_wm"] += time.perf_counter() - t3
            self._drain_emits(barrier=False)

    def _push_downstream(self, nid: int, batch: Batch) -> None:
        for d in self.plan.node(nid).downstream:
            self._push(d, batch, nid)

    def _push(self, nid: int, batch: Batch, from_node: int) -> None:
        """Route one batch into node ``nid``, coming from node
        ``from_node`` (a join's side is the edge's). In batch mode a
        blocking edge's batch goes into its spool first of all."""
        if self._batch_capture:
            w = self._batch_capture.get((from_node, nid))
            if w is not None:
                w.write(*batch)
                return
        n = self.plan.node(nid)
        data, ts, valid = batch
        if n.kind == "chain":
            for fn in n.fns:
                data, ts, valid = fn(data, ts, valid)
            self._push_downstream(nid, (data, ts, valid))
        elif n.kind == "union":
            self._push_downstream(nid, batch)
        elif n.kind == "async_io":
            # never blocks: the capacity wait is the loop's throttle
            in_wm = min((self._out_wm[u] for u in self._upstream[nid]),
                        default=LONG_MIN)
            self._ops[nid].submit(batch, in_wm)
        elif n.kind == "partition":
            # one driver is parallelism 1: every strategy passes the batch
            # through, and its cursor or random stream advances (the
            # checkpointed state); the node id seeds a shuffle, so
            # stacked shuffles do not correlate
            part = self._partitioners.get(nid)
            if part is None:
                part = self._partitioners[nid] = make_partitioner(
                    n.partition_strategy, seed=nid)
            if not part.broadcast:
                part.advance(len(ts), 1)
            self._push_downstream(nid, batch)
        elif n.kind == "window":
            keys = np.asarray(data[n.key_field], np.int64)
            self._ops[nid].process_batch(keys, ts, data, valid)
        elif n.kind in ("count_window", "evicting_window") + _PER_BATCH:
            op = self._ops[nid]
            keys = np.asarray(data[n.key_field], np.int64)
            if n.kind != "count_window":
                # the element buffers, the session lanes, the running
                # aggregate and the process function take the numeric
                # columns only
                data = {k: v for k, v in data.items()
                        if np.asarray(v).dtype != object}
            op.process_batch(keys, ts, data, valid)
            fired = op.take_fired()
            if fired is not None and n.kind in _PER_BATCH:
                # per-batch rows (a session's retract -U rows, a running
                # aggregate's upserts, a process function's emissions)
                # queue behind the operator's earlier fires, which a
                # deferral may still hold
                self._pending_emits.append((nid, fired, time.time()))
                if self._deliver_at_fire:
                    self._drain_emits(barrier=True)
            elif fired is not None:
                self._deliver(nid, fired)
        elif n.kind == "window_all":
            self._ops[nid].process_batch(
                ts, {k: v for k, v in data.items()
                     if np.asarray(v).dtype != object}, valid)
        elif n.kind == "join":
            op = self._ops[nid]
            t = n.window_transform
            if from_node == n.left_input:
                op.process_left(np.asarray(data[t.left_key], np.int64),
                                ts, data, valid)
            else:
                op.process_right(np.asarray(data[t.right_key], np.int64),
                                 ts, data, valid)
        elif n.kind == "broadcast_connect":
            op = self._ops[nid]
            if from_node == n.right_input:
                op.process_broadcast(ts, data, valid)
            else:
                op.process_main(ts, data, valid)
            fired = op.take_fired()
            if fired is not None:
                self._deliver(nid, fired)
        elif n.kind == "sink":
            nrec = int(valid.sum())
            if nrec:
                self.metrics["records_out"] += nrec
                n.sink.write({k: np.asarray(v)[valid] for k, v in data.items()})
        else:
            raise AssertionError(f"unroutable node kind {n.kind}")

    # -- time plane ---------------------------------------------------------
    def _propagate_watermarks(self, final: bool = False,
                              only=None) -> None:
        """Advance node watermarks in topological order: each node takes
        the min over its inputs. ``final`` also advances operators whose
        watermark already stands there, so pending re-fires flush.
        ``only`` restricts the pass to a set of nodes (a batch wave's: a
        later wave's operators must not see the end before their
        input)."""
        for nid in self.plan.topo_order:
            if only is not None and nid not in only:
                continue
            n = self.plan.node(nid)
            if n.kind == "source":
                continue
            ups = self._upstream[nid]
            in_wm = min(self._out_wm[u] for u in ups) if ups else LONG_MIN
            # count_window is left out: it fires per batch, and an
            # advance would only queue empty fires
            if n.kind in _EVENT_TIME:
                op = self._ops[nid]
                if getattr(op, "uses_processing_time", False):
                    # the clock drives the fires; end of input fires
                    # everything seen
                    self._pending_emits.append((nid, (
                        op.advance_watermark(op.final_watermark())
                        if in_wm == _FINAL or final
                        else op.advance_processing_time()), time.time()))
                else:
                    wm = op.final_watermark() if in_wm == _FINAL else in_wm
                    if wm > op.watermark or final:
                        self._pending_emits.append(
                            (nid, op.advance_watermark(wm), time.time()))
                    # a process function's processing-time timers fire
                    # on the clock beside the event-time advance (all of
                    # them at end of input)
                    adv_proc = getattr(op, "advance_processing_time_timers",
                                       None)
                    if adv_proc is not None:
                        fired = adv_proc(fire_all=(in_wm == _FINAL or final))
                        if fired is not None:
                            self._pending_emits.append(
                                (nid, fired, time.time()))
                if self._deliver_at_fire:
                    self._drain_emits(barrier=True)
            elif n.kind == "async_io":
                op = self._ops[nid]
                final_in = in_wm == _FINAL
                if not final_in:
                    op.note_watermark(in_wm)
                for b in op.poll(drain=final_in):
                    self._push_downstream(nid, b)
                # a watermark never overtakes a batch still in flight
                self._out_wm[nid] = _FINAL if final_in else op.watermark
                continue
            self._out_wm[nid] = in_wm

    def _drain_emits(self, barrier: bool) -> None:
        """Deliver fired windows downstream, in fire order. A periodic
        drain reads the emit-ring copies that have already landed and
        stops at the first packed fire whose copy is still in flight or
        that is younger than ``pipeline.emit-defer`` (later drains pick
        it up); a barrier delivers every fire and every ring row so far.
        Fires still pending when an attempt fails die with its driver:
        a restarted attempt builds a new one."""
        from flink_tpu_torch.ops.window import FiredWindows

        t0 = time.perf_counter()
        pending = self._pending_emits
        if barrier:
            self._pending_emits = []
        else:
            # in fire order: a fire whose copy is in flight, or younger
            # than pipeline.emit-defer, holds back the fires after it
            k = 0
            now = time.time()
            while (k < len(pending) and pending[k][1].ready()
                   and now - pending[k][2] >= self._emit_defer_s):
                k += 1
            pending, self._pending_emits = pending[:k], pending[k:]
        if barrier:
            # a fire whose rows a periodic poll left on the device may
            # have no marker left: pin every ring operator's newest
            # version so nothing is left behind
            for nid, op in self._ops.items():
                if self.plan.node(nid).kind == "window" \
                        and op._emit_ring is not None and op._ring_version_no:
                    pending.append((nid, FiredWindows(
                        op=op, ring=True, ring_no=op._ring_version_no),
                        time.time()))
        FiredWindows.materialize_many([f for _, f, _ in pending],
                                      barrier=barrier)
        for nid, fired, t_fire in pending:
            if self._deliver(nid, fired):
                self._lat_hist.update((time.time() - t_fire) * 1000.0)
        self.prof["drain"] += time.perf_counter() - t0

    def _deliver(self, nid: int, fired) -> bool:
        """Push one fire's rows downstream, stamped at window end - 1, or
        at their own timestamps (``__ts__``: a running aggregate's and a
        process function's rows), materializing it first if it is still
        lazy; False when it has none."""
        out = dict(fired)
        if "__ts__" in out:
            ts = np.asarray(out.pop("__ts__"), np.int64)
        else:
            ts = np.asarray(out["window_end"], np.int64) - 1
        nrec = len(ts)
        if nrec == 0:
            return False
        self.metrics["fired_windows"] += nrec
        self._push_downstream(nid, (out, ts, np.ones(nrec, bool)))
        return True


@dataclasses.dataclass
class _DcnStepState:
    """The cross-process loop's mutable state a run, threaded through
    ``_dcn_consume_step`` so the overlapped and lockstep paths share one
    consume."""

    last_chk: float = 0.0
    pending: Any = None     # persisted, not yet committed checkpoint
    pending_id: int = -1
    persisted_id: int = -1  # the newest id this process holds durably


class _DevBatch:
    """Marker of one device-made batch: its index, its exact max
    timestamp (for the watermark clock) and its record count."""

    __slots__ = ("index", "ts_max", "n")

    def __init__(self, index: int, ts_max: int, n: int):
        self.index = index
        self.ts_max = ts_max
        self.n = n


def _dev_batch_markers(src: DeviceGeneratorSource, start: int = 0):
    """Markers of a device-made source's batches from position
    ``start`` on."""
    for i in range(start, src.n_batches):
        yield _DevBatch(i, int(src.ts_bounds(i)[1]), src.batch_size)


def _rebase_position(pos: int, old_f: int, new_f: int, *,
                     sid: int = 0, split_ix: int = 0) -> int:
    """A replay position counted in ``old_f`` sub-batches per logical
    batch, in ``new_f`` units. Only a position on a common sub-batch
    boundary converts (a cut in the middle of a logical batch at K = 4
    cannot resume at K = 3); otherwise it fails rather than replay a
    partial logical batch."""
    scaled = pos * new_f
    if scaled % old_f:
        raise ValueError(
            f"checkpoint position {pos} of source {sid} split "
            f"{split_ix} was taken at sub-batch factor {old_f} and "
            f"does not align to factor {new_f} — restore with the "
            "original pipeline.sub-batches, or from a logical-batch-"
            "aligned checkpoint")
    return scaled // old_f


class _Prefetcher:
    """Pulls source batches ahead on a feeder thread, so generation
    overlaps the loop's keying and dispatch. Source exceptions surface
    on the consuming side."""

    def __init__(self, it, depth: int = 2) -> None:
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._it = it
        self._done = False
        self._closed = False
        self._thread = threading.Thread(target=self._feed, daemon=True)
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
        # a wrapped iterator with background work of its own ends here too
        inner_close = getattr(self._it, "close", None)
        if inner_close is not None:
            try:
                inner_close()
            except ValueError:
                pass  # a generator still running on the feeder thread
                # refuses close(); the feeder is ending anyway

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
