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
per batch (its triggers, late re-fires) and on the watermark. A
processing-time window ignores the event watermark: each pass fires
what the operator's clock has passed, and the end of input fires
everything seen.

Fired windows are delivered from the same thread, in fire order: after
every loop pass the driver polls the operators' emit rings for copies
that have landed and delivers the packed fires whose copies have landed
(never waiting on the device); at end of input it drains everything
with a barrier (``pipeline.emit-defer`` above 0, which times the
reference's drain thread, is refused). Checkpointing, the cross-host
exchange, batch mode, rescaling, the debloater and savepoints are not
ported (ROADMAP.md); the configuration check and the driver refuse confs
that ask for them.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from flink_tpu_torch.api.sources import DeviceGeneratorSource
from flink_tpu_torch.config import (
    ClusterOptions, Configuration, PipelineOptions, StateOptions)
from flink_tpu_torch.device import resolve_device
from flink_tpu_torch.graph.compiler import ExecutionPlan
from flink_tpu_torch.time.watermarks import LONG_MIN, make_generator

Batch = Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]  # data, ts, valid

_FINAL = int(np.iinfo(np.int64).max)  # end-of-input watermark
_STATEFUL = ("window", "evicting_window", "count_window")


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
        self.metrics: Dict[str, Any] = {
            "records_in": 0, "records_out": 0, "batches": 0,
            "fired_windows": 0, "devgen_host_batches": 0,
        }
        self.prof: Dict[str, float] = collections.defaultdict(float)
        self._pending_emits: List[Tuple[int, Any]] = []
        self._ops: Dict[int, Any] = {}
        self._sub_batches = int(config.get(PipelineOptions.SUB_BATCHES))
        self._base_inflight = int(
            config.get(PipelineOptions.MAX_INFLIGHT_STEPS))
        self._readiness = str(
            config.get(PipelineOptions.READINESS)).strip().lower()
        # source batches each split generates ahead on its feeder thread
        self._prefetch = int(config.get(PipelineOptions.SOURCE_PREFETCH))
        self._build_ops()
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
        # sub-batch factor)
        self._dev_chains: Dict[int, Tuple[int, DeviceGeneratorSource, int]] = {}
        for sid in plan.sources:
            self._maybe_chain_device_source(sid, plan.node(sid))

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
            _evicting_window_factory, _window_factory)

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
            exchange_impl=str(self.config.get(ClusterOptions.EXCHANGE_IMPL)))
        for n in self.plan.nodes.values():
            if n.kind == "window":
                self._ops[n.id] = _window_factory(n, ctx)
            elif n.kind == "count_window":
                if self.mesh_plan is not None:
                    raise NotImplementedError(
                        "count windows on a device mesh are not yet "
                        "supported; run without cluster.mesh-devices")
                self._ops[n.id] = _count_window_factory(n, ctx)
            elif n.kind == "evicting_window":
                self._ops[n.id] = _evicting_window_factory(n, ctx)

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
            self._wm_gens[sid][split_ix].on_batch(marker.ts_max)
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

    # -- the streaming loop -------------------------------------------------
    def run(self, job_name: str = "job"):
        from flink_tpu_torch.api.environment import JobResult

        t_start = time.perf_counter()
        srcs: Dict[int, Dict[int, Any]] = {}
        try:
            for sid in self.plan.sources:
                n = self.plan.node(sid)
                strategy = n.watermark_strategy or self.plan.watermark_strategy
                splits = n.source.splits()
                # one watermark generator per split, combined with min
                self._wm_gens[sid] = [make_generator(strategy) for _ in splits]
                srcs[sid] = {}
                for i, split in enumerate(splits):
                    if sid in self._dev_chains:
                        # no records and no feeder thread: markers only
                        srcs[sid][i] = _dev_batch_markers(
                            self._dev_chains[sid][1])
                        continue
                    it = n.source.open_split(split, 0)
                    srcs[sid][i] = (_Prefetcher(it, self._prefetch)
                                    if self._prefetch > 0 else iter(it))
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
                        if len(ts):
                            self._wm_gens[sid][split_ix].on_batch(int(ts.max()))
                    # exhausted splits stop holding the watermark back
                    self._recombine_source_wm(sid, alive)
                    t3 = time.perf_counter()
                    self._propagate_watermarks()
                    self.prof["advance_wm"] += time.perf_counter() - t3
                    self._drain_emits(barrier=False)
            # end of input: the final watermark flushes every window
            for op in self._ops.values():
                op.quiesce()
            for sid in self.plan.sources:
                self._out_wm[sid] = _FINAL
            self._propagate_watermarks(final=True)
            self._drain_emits(barrier=True)
            for op in self._ops.values():
                op.quiesce()
        finally:
            for its in srcs.values():
                for it in its.values():
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
        for n in self.plan.nodes.values():
            if n.kind == "sink":
                n.sink.close()
        return JobResult(job_name, self._final_metrics(t_start))

    def _final_metrics(self, t_start: float) -> Dict[str, Any]:
        out = dict(self.metrics)
        out["wall_s"] = time.perf_counter() - t_start
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
            for k, v in op.prof.items():
                out[f"profile.op{nid}.{k}"] = v
            for k, v in op.timer.busy_ms.items():
                out[f"device_busy_ms.op{nid}.{k}"] = v
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
            self._push(d, batch)

    def _push(self, nid: int, batch: Batch) -> None:
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
        elif n.kind in ("count_window", "evicting_window"):
            op = self._ops[nid]
            keys = np.asarray(data[n.key_field], np.int64)
            if n.kind == "evicting_window":
                # the element buffers keep the numeric columns only
                data = {k: v for k, v in data.items()
                        if np.asarray(v).dtype != object}
            op.process_batch(keys, ts, data, valid)
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
            if n.kind in ("window", "evicting_window"):
                op = self._ops[nid]
                if getattr(op, "uses_processing_time", False):
                    # the clock drives the fires; end of input fires
                    # everything seen
                    self._pending_emits.append((nid, (
                        op.advance_watermark(op.final_watermark())
                        if in_wm == _FINAL or final
                        else op.advance_processing_time())))
                else:
                    wm = op.final_watermark() if in_wm == _FINAL else in_wm
                    if wm > op.watermark or final:
                        self._pending_emits.append(
                            (nid, op.advance_watermark(wm)))
                if self._deliver_at_fire:
                    self._drain_emits(barrier=True)
            self._out_wm[nid] = in_wm

    def _drain_emits(self, barrier: bool) -> None:
        """Deliver fired windows downstream, in fire order. A periodic
        drain reads the emit-ring copies that have already landed and
        stops at the first packed fire whose copy is still in flight
        (later drains pick it up); a barrier delivers every fire and
        every ring row so far."""
        from flink_tpu_torch.ops.window import FiredWindows

        t0 = time.perf_counter()
        pending = self._pending_emits
        if barrier:
            self._pending_emits = []
        else:
            k = 0
            while k < len(pending) and pending[k][1].ready():
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
                        op=op, ring=True, ring_no=op._ring_version_no)))
        FiredWindows.materialize_many([f for _, f in pending], barrier=barrier)
        for nid, fired in pending:
            self._deliver(nid, fired)
        self.prof["drain"] += time.perf_counter() - t0

    def _deliver(self, nid: int, fired) -> None:
        """Push one fire's rows downstream, stamped at window end - 1
        (materializing it first, if it is still lazy)."""
        out = dict(fired)
        nrec = len(out["window_end"])
        if nrec == 0:
            return
        self.metrics["fired_windows"] += nrec
        ts = np.asarray(out["window_end"], np.int64) - 1
        self._push_downstream(nid, (out, ts, np.ones(nrec, bool)))


class _DevBatch:
    """Marker of one device-made batch: its index, its exact max
    timestamp (for the watermark clock) and its record count."""

    __slots__ = ("index", "ts_max", "n")

    def __init__(self, index: int, ts_max: int, n: int):
        self.index = index
        self.ts_max = ts_max
        self.n = n


def _dev_batch_markers(src: DeviceGeneratorSource):
    for i in range(src.n_batches):
        yield _DevBatch(i, int(src.ts_bounds(i)[1]), src.batch_size)


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
