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
``checkpoint_now(savepoint=True)``. The cross-host exchange, batch mode,
rescaling and the debloater are not ported (ROADMAP.md); the
configuration check and the driver refuse confs that ask for them.
"""
from __future__ import annotations

import collections
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.api.sources import DeviceGeneratorSource
from flink_tpu_torch.config import (
    CheckpointingOptions, ClusterOptions, Configuration, HostOptions,
    MemoryOptions, MetricsOptions, PipelineOptions, StateOptions)
from flink_tpu_torch.device import resolve_device
from flink_tpu_torch.graph.compiler import ExecutionPlan
from flink_tpu_torch.time.watermarks import LONG_MIN, make_generator

Batch = Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]  # data, ts, valid

_FINAL = int(np.iinfo(np.int64).max)  # end-of-input watermark
_STATEFUL = ("window", "evicting_window", "count_window", "session",
             "window_all", "join")
# the kinds the watermark advances (count windows fire per batch only)
_EVENT_TIME = ("window", "evicting_window", "session", "window_all", "join")


class Driver:
    """Single-process execution of a lowered plan on one device, or with
    ``mesh_plan`` its keyed windows over a mesh of device blocks."""

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
        self.prof: Dict[str, float] = collections.defaultdict(float)
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
        self._coordinator = None
        self._ckpt_executor = None
        self._ckpt_pending = None
        self._ckpt_base: Optional[Dict[str, Any]] = None
        self._ckpt_failures = 0
        self._last_freeze_versions: Dict[int, int] = {}
        self._metrics_server = None

    def _reaches_stateful(self, nid: int) -> bool:
        todo = list(self.plan.node(nid).downstream)
        seen = set()
        while todo:
            d = todo.pop()
            if d in seen:
                continue
            seen.add(d)
            if self.plan.node(d).kind in _STATEFUL:
                return True
            todo.extend(self.plan.node(d).downstream)
        return False

    def _build_ops(self) -> None:
        from flink_tpu_torch.ops.factory import (
            OperatorBuildContext, _count_window_factory,
            _evicting_window_factory, _join_factory, _session_factory,
            _window_all_factory, _window_factory)

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
            allow_drops=bool(self.config.get(StateOptions.ALLOW_DROPS)),
            mesh_plan=self.mesh_plan,
            exchange_capacity=int(self.config.get(
                PipelineOptions.EXCHANGE_CAPACITY)) or None,
            exchange_impl=str(self.config.get(ClusterOptions.EXCHANGE_IMPL)),
            host_pool=self.host_pool,
            fold_chunk_records=self._fold_chunk)
        factories = {"window": _window_factory,
                     "evicting_window": _evicting_window_factory,
                     "session": _session_factory,
                     "window_all": _window_all_factory,
                     "join": _join_factory}
        for n in self.plan.nodes.values():
            if n.kind in factories:
                self._ops[n.id] = factories[n.kind](n, ctx)
            elif n.kind == "count_window":
                if self.mesh_plan is not None:
                    raise NotImplementedError(
                        "count windows on a device mesh are not yet "
                        "supported; run without cluster.mesh-devices")
                self._ops[n.id] = _count_window_factory(n, ctx)

    def _maybe_chain_device_source(self, sid: int, n) -> None:
        """Chain a device-made source into its consuming window operator
        when it is the source's only consumer, keyed on the source's key
        field, and the operator can host it (its own gate). K > 1
        subdivides the source first, when it can re-slice itself."""
        src = n.source
        if (not isinstance(src, DeviceGeneratorSource)
                or src.device_keys_ts is None or len(n.downstream) != 1):
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
                ops[nid] = ReusedOpState(base["files"][nid], int(v))
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
            # the DataStream partitioners come with ROADMAP.md queue 1
            # item 9.3; none is stateful here
            "partitioners": {},
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
        num_shards = int(self.config.get(StateOptions.NUM_KEY_SHARDS))
        return {"nproc": 1, "pid": 0, "num_shards": num_shards,
                "shard_range": [0, num_shards]}

    def _load_restore_path(self, path: str) -> Dict[str, Any]:
        """An explicit restore path, written by a process of the same
        key-group identity; another identity is a rescale."""
        from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

        payload = FsCheckpointStorage.load(path)
        ident = payload.get("rescale")
        if ident is not None and (int(ident.get("nproc", 1)) != 1
                                  or int(ident.get("pid", 0)) != 0):
            raise NotImplementedError(
                f"checkpoint {path} was written by process "
                f"{ident.get('pid')} of {ident.get('nproc')}; restoring it "
                "into one process merges key-group ranges "
                "(checkpoint/repartition.py), which is still to port: "
                "ROADMAP.md queue 1 item 6")
        return payload

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
        if payload.get("partitioners"):
            raise NotImplementedError(
                "checkpoint carries DataStream partitioner state; the "
                "partitioners are still to port: ROADMAP.md queue 1 "
                "item 9.3")
        for nid, snap in payload["operators"].items():
            self._ops[nid].restore_state(snap)
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
            self._drain_emits(barrier=True)
        sinks = [n.sink for n in self.plan.nodes.values() if n.kind == "sink"]
        pend = self._coordinator.trigger_async(
            lambda: self._snapshot(allow_reuse=not savepoint),
            commit_fns=[s.notify_checkpoint_complete for s in sinks],
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
            self._ckpt_base = {
                "files": {nid: os.path.join(
                    handle.path, names.get(str(nid), f"op-{nid}.blob"))
                    for nid in self._ops},
                "versions": dict(p.frozen_versions),
            }
        return handle

    def _commit_final_epoch(self) -> None:
        """The 2PC sinks' terminal commit of a bounded run without
        checkpointing: end of input is the terminal barrier. A ms
        timestamp for the epoch id cannot collide with an earlier run's
        ids in a reused sink directory."""
        final_epoch = int(time.time() * 1000)
        for n in self.plan.nodes.values():
            if n.kind == "sink":
                n.sink.prepare_commit(final_epoch)
                n.sink.notify_checkpoint_complete(final_epoch)

    # -- the streaming loop -------------------------------------------------
    def run(self, job_name: str = "job"):
        from concurrent.futures import ThreadPoolExecutor

        from flink_tpu_torch import faults
        from flink_tpu_torch.obs.metrics import MetricsServer

        self._coordinator = self._setup_checkpointing(job_name)
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
        self._restored_sub_factors: Dict[int, int] = {}
        if restore:
            if restore == "latest":
                payload = self._coordinator.restore_latest()
            else:
                payload = self._load_restore_path(restore)
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
            for i, split in enumerate(n.source.splits()):
                start = self._positions[sid].get(i, 0)
                if sid in self._dev_chains:
                    # no records and no feeder thread: markers only
                    srcs[sid][i] = _dev_batch_markers(
                        self._dev_chains[sid][1], start)
                    continue
                it = n.source.open_split(split, start)
                srcs[sid][i] = (_Prefetcher(it, self._prefetch)
                                if self._prefetch > 0 else iter(it))
        last_chk = time.time()
        active = {sid: sorted(its) for sid, its in srcs.items()}
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
                        self._push_source_batch(sid, data, ts)
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
        # end of input: the final watermark flushes every window
        for op in self._ops.values():
            op.quiesce()
        for sid in self.plan.sources:
            self._out_wm[sid] = _FINAL
        self._propagate_watermarks(final=True)
        self._drain_emits(barrier=True)
        for op in self._ops.values():
            op.quiesce()
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
            self._push_source_batch(sid, {k: v[lo:hi] for k, v in data.items()},
                                    ts[lo:hi])
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
        ``from_node`` (a join's side is the edge's)."""
        n = self.plan.node(nid)
        data, ts, valid = batch
        if n.kind == "chain":
            for fn in n.fns:
                data, ts, valid = fn(data, ts, valid)
            self._push_downstream(nid, (data, ts, valid))
        elif n.kind == "union":
            self._push_downstream(nid, batch)
        elif n.kind == "window":
            keys = np.asarray(data[n.key_field], np.int64)
            self._ops[nid].process_batch(keys, ts, data, valid)
        elif n.kind in ("count_window", "evicting_window", "session"):
            op = self._ops[nid]
            keys = np.asarray(data[n.key_field], np.int64)
            if n.kind != "count_window":
                # the element buffers and the session lanes take the
                # numeric columns only
                data = {k: v for k, v in data.items()
                        if np.asarray(v).dtype != object}
            op.process_batch(keys, ts, data, valid)
            fired = op.take_fired()
            if fired is not None and n.kind == "session":
                # retract mode's -U rows queue behind the session's
                # earlier fires, which a deferral may still hold
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
        elif n.kind == "sink":
            nrec = int(valid.sum())
            if nrec:
                self.metrics["records_out"] += nrec
                n.sink.write({k: np.asarray(v)[valid] for k, v in data.items()})
        else:
            raise AssertionError(f"unroutable node kind {n.kind}")

    # -- time plane ---------------------------------------------------------
    def _propagate_watermarks(self, final: bool = False) -> None:
        """Advance node watermarks in topological order: each node takes
        the min over its inputs. ``final`` also advances operators whose
        watermark already stands there, so pending re-fires flush."""
        for nid in self.plan.topo_order:
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
                if self._deliver_at_fire:
                    self._drain_emits(barrier=True)
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
        """Push one fire's rows downstream, stamped at window end - 1
        (materializing it first, if it is still lazy); False when it has
        none."""
        out = dict(fired)
        nrec = len(out["window_end"])
        if nrec == 0:
            return False
        self.metrics["fired_windows"] += nrec
        ts = np.asarray(out["window_end"], np.int64) - 1
        self._push_downstream(nid, (out, ts, np.ones(nrec, bool)))
        return True


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
