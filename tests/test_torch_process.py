"""``KeyedStream.process`` (``KeyedProcessFunction`` with keyed state and
timers; ``ops/process.py``, ``state/api.py``) in the port, against the
JAX package on the same inputs: ``tests/test_process.py``'s operator,
regression and end-to-end cases, each run on both packages.

Both packages run the function on host numpy, so rows compare exactly:
keys, timestamps, the float64 state values, and the order of the rows.
"""
import types

import numpy as np
import pytest

from test_torch_ckpt_pkgs import BOTH, PORT
from test_torch_threads import capped_torch_threads  # noqa: F401


def _pkg(P):
    """The process-function surface of package ``P``, with
    ``tests/test_process.py``'s functions built on it."""
    if P is PORT:
        from flink_tpu_torch.api.functions import KeyedProcessFunction
        from flink_tpu_torch.ops import process
        from flink_tpu_torch.state import api
    else:
        from flink_tpu.api.functions import KeyedProcessFunction
        from flink_tpu.ops import process
        from flink_tpu.state import api
    V = api.ValueStateDescriptor

    class RunningSum(KeyedProcessFunction):
        """Emit the running per-key sum after every batch."""

        def process_batch(self, ctx):
            vs = ctx.value_state(V("sum", 0.0))
            order = np.argsort(ctx.slots, kind="stable")
            sl, v = ctx.slots[order], ctx.data["v"][order]
            uniq, starts = np.unique(sl, return_index=True)
            totals = np.add.reduceat(v.astype(np.float64), starts)
            vs[uniq] = vs[uniq] + totals
            ctx.emit({"key": ctx.keys[order][starts], "total": vs[uniq]},
                     ts=ctx.timestamps[order][starts])

    class Dedup(KeyedProcessFunction):
        """First-occurrence filter via a seen flag."""

        def process_batch(self, ctx):
            seen = ctx.value_state(V("seen", 0.0))
            order = np.argsort(ctx.slots, kind="stable")
            sl = ctx.slots[order]
            first_in_batch = np.empty(len(sl), bool)
            first_in_batch[0:1] = True
            first_in_batch[1:] = sl[1:] != sl[:-1]
            fresh = first_in_batch & (seen[sl] == 0.0)
            seen[sl[fresh]] = 1.0
            keep = order[fresh]
            ctx.emit({"key": ctx.keys[keep]}, ts=ctx.timestamps[keep])

    class IdleTimeout(KeyedProcessFunction):
        """A timeout alert when a key sees no activity for ``gap`` ms."""

        def __init__(self, gap: int):
            self.gap = gap

        def process_batch(self, ctx):
            last = ctx.value_state(V("last_ts", -1.0))
            order = np.argsort(ctx.slots, kind="stable")
            sl, ts = ctx.slots[order], ctx.timestamps[order]
            uniq, starts = np.unique(sl, return_index=True)
            mx = np.maximum.reduceat(ts, starts)
            newer = mx > last[uniq]
            last[uniq[newer]] = mx[newer].astype(np.float64)
            ctx.register_event_time_timers(mx[newer] + self.gap,
                                           slots=uniq[newer])

        def on_timer(self, ctx):
            last = ctx.value_state(V("last_ts", -1.0))
            # fire only if the timer still matches the latest activity
            live = last[ctx.slots] + self.gap == ctx.timestamps
            ctx.emit({"key": ctx.keys[live],
                      "idle_since": last[ctx.slots[live]].astype(np.int64)},
                     ts=ctx.timestamps[live])

    return types.SimpleNamespace(
        P=P, KPF=KeyedProcessFunction, Op=process.KeyedProcessOperator,
        TimerService=process.TimerService, api=api,
        RunningSum=RunningSum, Dedup=Dedup, IdleTimeout=IdleTimeout,
        op=lambda fn, shards=4, slots=16: process.KeyedProcessOperator(
            fn, num_shards=shards, slots_per_shard=slots))


PKGS = {P.name: _pkg(P) for P in BOTH}


def on_both(case):
    """Run ``case(ns)`` on both packages; the results must be equal."""
    got = {name: case(ns) for name, ns in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def as_rows(f, *fields):
    d = dict(f) if f is not None else {}
    n = len(d.get("__ts__", ()))
    return [tuple(np.asarray(d[k])[i].item() for k in fields + ("__ts__",))
            for i in range(n)]


# -- TestOperatorDirect ----------------------------------------------------------

def test_running_sum():
    def case(ns):
        op = ns.op(ns.RunningSum())
        op.process_batch(np.array([1, 2, 1], np.int64),
                         np.array([10, 20, 30], np.int64),
                         {"v": np.array([1.0, 5.0, 2.0])})
        a = as_rows(op.take_fired(), "key", "total")
        op.process_batch(np.array([1], np.int64), np.array([40], np.int64),
                         {"v": np.array([4.0])})
        return a, as_rows(op.take_fired(), "key", "total")
    a, b = on_both(case)
    assert {k: t for k, t, _ in a} == {1: 3.0, 2: 5.0}
    assert b == [(1, 7.0, 40)]


def test_idle_timeout_timer():
    def case(ns):
        op = ns.op(ns.IdleTimeout(1000))
        op.process_batch(np.array([7], np.int64), np.array([100], np.int64),
                         {})
        out = [as_rows(op.advance_watermark(500), "key", "idle_since"),
               as_rows(op.advance_watermark(1100), "key", "idle_since")]
        # re-armed timer: new activity supersedes the old one
        op.process_batch(np.array([8], np.int64), np.array([2000], np.int64),
                         {})
        op.process_batch(np.array([8], np.int64), np.array([2500], np.int64),
                         {})
        out.append(as_rows(op.advance_watermark(3100), "key"))
        out.append(as_rows(op.advance_watermark(3600), "key"))
        return out
    assert on_both(case) == [[], [(7, 100, 1100)], [], [(8, 3500)]]


def test_list_and_map_state():
    def case(ns):
        class Collect(ns.KPF):
            def process_batch(self, ctx):
                ls = ctx.list_state(ns.api.ListStateDescriptor("vals"))
                ms = ctx.map_state(ns.api.MapStateDescriptor("attrs"))
                ls.append_batch(ctx.slots, ctx.data["v"])
                ms.put_batch(ctx.slots, ctx.timestamps.tolist(),
                             ctx.data["v"].tolist())

        op = ns.op(Collect())
        op.process_batch(np.array([1, 1, 2], np.int64),
                         np.array([10, 20, 30], np.int64),
                         {"v": np.array([1.0, 2.0, 3.0])})
        slot1 = int(op.directory.assign(np.array([1], np.int64))[0])
        return (op._states["vals"].get(slot1),
                op._states["attrs"].get(slot1))
    assert on_both(case) == ([1.0, 2.0], {10: 1.0, 20: 2.0})


def test_value_state_ttl_expires():
    def case(ns):
        desc = ns.api.ValueStateDescriptor(
            "x", 0.0, ttl=ns.api.StateTtlConfig(1000))

        class Ttl(ns.KPF):
            def process_batch(self, ctx):
                vs = ctx.value_state(desc)
                cur = vs.get(ctx.slots, int(ctx.timestamps.max()))
                vs.update(ctx.slots, cur + ctx.data["v"],
                          int(ctx.timestamps.max()))
                ctx.emit({"key": ctx.keys, "x": vs[ctx.slots]})

        op = ns.op(Ttl())
        op.process_batch(np.array([1], np.int64), np.array([100], np.int64),
                         {"v": np.array([5.0])})
        first = as_rows(op.take_fired(), "x")
        # the second write comes 2000 ms later: the old value expired
        op.process_batch(np.array([1], np.int64), np.array([2100], np.int64),
                         {"v": np.array([3.0])})
        return first, as_rows(op.take_fired(), "x")
    assert on_both(case) == ([(5.0, 100)], [(3.0, 2100)])


def test_per_element_adapter():
    def case(ns):
        V = ns.api.ValueStateDescriptor

        class Alternate(ns.KPF):
            """Every 2nd record a key, authored per element."""

            def process_element(self, key, ts, row, ctx, slot):
                vs = ctx.value_state(V("n", 0.0))
                vs[slot] = vs[slot] + 1
                if int(vs[slot]) % 2 == 0:
                    ctx.emit({"key": np.array([key], np.int64)},
                             ts=np.array([ts], np.int64))

        op = ns.op(Alternate())
        op.process_batch(np.array([1, 1, 1, 2], np.int64),
                         np.array([10, 20, 30, 40], np.int64), {})
        return as_rows(op.take_fired(), "key")
    assert on_both(case) == [(1, 20)]


def test_snapshot_restore_roundtrip():
    """A snapshot restores into a fresh operator of the same package and
    of the other one (state columns, timers, directory)."""
    snaps = {}

    def case(ns):
        a = ns.op(ns.RunningSum())
        a.process_batch(np.array([1, 3], np.int64), np.array([10, 11], np.int64),
                        {"v": np.array([5.0, 1.5])})
        a.take_fired()
        snaps[ns.P.name] = snap = a.snapshot_state()
        return (sorted(snap["states"]),
                snap["states"]["sum"][2]["col"].tolist(),
                {k: np.asarray(v).tolist()
                 for k, v in snap["directory"].items()})
    on_both(case)
    out = []
    for writer in ("jax", "port"):
        for ns in PKGS.values():
            b = ns.op(ns.RunningSum())
            b.restore_state(snaps[writer])
            b.process_batch(np.array([1], np.int64), np.array([20], np.int64),
                            {"v": np.array([2.0])})
            out.append(as_rows(b.take_fired(), "key", "total"))
    assert out == [[(1, 7.0, 20)]] * 4


# -- TestRegressions -------------------------------------------------------------

def test_restore_empty_timers_then_final_watermark():
    def case(ns):
        a = ns.op(ns.Dedup())
        b = ns.op(ns.Dedup())
        b.restore_state(a.snapshot_state())  # zero timers
        return b.final_watermark()  # must not crash on the empty set
    assert on_both(case) == 0


def test_ttl_state_rejects_unstamped_write():
    def case(ns):
        op = ns.op(ns.Dedup())
        vs = op._state(ns.api.ValueStateDescriptor(
            "t", 0.0, ttl=ns.api.StateTtlConfig(100)),
            ns.api.ValueStateVector)
        with pytest.raises(TypeError, match="update") as e:
            vs[np.array([0])] = 1.0
        return str(e.value)
    on_both(case)


def test_partial_emit_without_ts_raises():
    def case(ns):
        class Bad(ns.KPF):
            def process_batch(self, ctx):
                ctx.emit({"key": ctx.keys[:1]})  # 1 of 2 rows, no ts

        with pytest.raises(ValueError, match="full-batch") as e:
            ns.op(Bad()).process_batch(np.array([1, 2], np.int64),
                                       np.array([10, 20], np.int64), {})
        return str(e.value)
    on_both(case)


def test_filtered_records_consume_no_slots():
    def case(ns):
        op = ns.op(ns.Dedup(), shards=1, slots=2)
        keys = np.arange(100, dtype=np.int64)
        valid = np.zeros(100, bool)
        valid[:2] = True  # only keys 0 and 1 are real
        op.process_batch(keys, np.zeros(100, np.int64), {}, valid)
        return op.directory.num_keys(), op.records_dropped_full
    assert on_both(case) == (2, 0)


def test_mixed_emit_schemas_raise():
    def case(ns):
        class Mixed(ns.KPF):
            def process_batch(self, ctx):
                ctx.emit({"a": ctx.keys}, ts=ctx.timestamps)
                ctx.emit({"b": ctx.keys}, ts=ctx.timestamps)

        op = ns.op(Mixed())
        op.process_batch(np.array([1], np.int64), np.array([10], np.int64),
                         {})
        with pytest.raises(ValueError, match="schemas"):
            op.take_fired().materialize()
        return True
    on_both(case)


def test_timer_dedup_and_delete():
    def case(ns):
        t = ns.TimerService()
        t.register_batch(np.array([3, 3, 5]), np.array([100, 100, 200]))
        t.register_batch(np.array([5]), np.array([150]))
        t.delete_batch(np.array([5]), np.array([200]))
        s, ts = t.due(1000)
        return list(zip(s.tolist(), ts.tolist())), t.pending_count
    assert on_both(case) == ([(3, 100), (5, 150)], 0)


def test_processing_time_timers_fire_on_the_clock():
    """Processing-time timers fire once the operator's clock passes
    them, and all of them at end of input."""
    def case(ns):
        if ns.P is PORT:
            from flink_tpu_torch.time.clock import ManualProcessingTimeService
        else:
            from flink_tpu.time.clock import ManualProcessingTimeService

        class Ping(ns.KPF):
            def process_batch(self, ctx):
                ctx.register_processing_time_timers(
                    ctx.timestamps + 100)

            def on_timer(self, ctx):
                ctx.emit({"key": ctx.keys,
                          "domain": np.full(len(ctx.keys),
                                            ctx.time_domain == "processing")},
                         ts=ctx.timestamps)

        op = ns.op(Ping())
        op.clock = ManualProcessingTimeService(0)
        op.process_batch(np.array([4, 5], np.int64),
                         np.array([10, 500], np.int64), {})
        out = [op.advance_processing_time_timers()]
        op.clock.advance_to(200)
        out.append(as_rows(op.advance_processing_time_timers(),
                           "key", "domain"))
        out.append(as_rows(op.advance_processing_time_timers(fire_all=True),
                           "key", "domain"))
        return out
    assert on_both(case) == [None, [(4, True, 110)], [(5, True, 600)]]


# -- TestProcessE2E --------------------------------------------------------------

def run_job(ns, gen, fn, name):
    P = ns.P
    env = P.Env(P.Conf({"pipeline.microbatch-size": 8,
                        "state.num-key-shards": 4,
                        "state.slots-per-shard": 16}))
    sink = P.sinks.CollectSink()
    (env.from_source(P.GeneratorSource(gen), P.WM.for_monotonous_timestamps())
     .key_by("k").process(fn).add_sink(sink))
    P.execute(env, name)
    return [tuple(sorted((k, np.asarray(v).item()) for k, v in r.items()))
            for r in sink.rows]


def test_dedup_pipeline():
    def gen(split, i):
        if i >= 3:
            return None
        ks = np.array([[1, 2, 1], [2, 3, 3], [1, 4, 2]][i], np.int64)
        return {"k": ks}, np.full(3, i * 100, np.int64)

    rows = on_both(lambda ns: run_job(ns, gen, ns.Dedup(), "dedup"))
    assert sorted(dict(r)["key"] for r in rows) == [1, 2, 3, 4]


def test_timeout_pipeline_fires_on_watermark():
    def gen(split, i):
        if i >= 4:
            return None
        if i == 0:
            return {"k": np.array([5], np.int64)}, np.array([0], np.int64)
        # keep the watermark advancing with another key
        return {"k": np.array([9], np.int64)}, np.array([i * 1000], np.int64)

    rows = on_both(lambda ns: run_job(ns, gen, ns.IdleTimeout(1500),
                                      "timeout"))
    # key 5 idles after ts 0 and alerts at watermark 1500; key 9 alerts
    # at end of input, when every remaining timer fires
    assert [(dict(r)["key"], dict(r)["idle_since"]) for r in rows] == \
        [(5, 0), (9, 3000)]
