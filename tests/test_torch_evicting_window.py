"""The element path: the port's ``EvictingWindowOperator`` and the
evictor / custom-trigger jobs through ``env.execute(device="cpu")``,
against the JAX package fed the same batches (made from a seed with
numpy).

Every case of ``tests/test_evicting_window.py`` runs through both
packages, and every fired batch (or ``take_fired``'s None) must be equal
in order: the same columns in the same order, the same dtypes, keys,
window bounds and every integer or max/min field exactly (NaN-aware).
The seeded cases beside them drive the port's grouped batch path
(built-in triggers) and its per-element loop (a user trigger) over
tumbling and sliding windows, late records, lateness and eviction.

A lane aggregate's sum and avg fields: the reference reduces each
window with ``jnp.sum`` (XLA's association), the port adds in element
order (``segment_lanes``), so they are held to |port - ref| <= (2 *
count + 4) * 2^-24 * |ref| over positive values (the error of adding
the same terms in two orders, plus one rounding of the division),
written here before the first run."""
import types

import numpy as np
import pytest

from flink_tpu.api import windowing as jw
from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops import evicting_window as je
from flink_tpu.time.watermarks import WatermarkStrategy as JaxWatermarks
from flink_tpu_torch.api import windowing as tw
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops import evicting_window as te
from flink_tpu_torch.time.watermarks import WatermarkStrategy
from test_torch_threads import capped_torch_threads  # noqa: F401

U = 2.0 ** -24

JAX = types.SimpleNamespace(w=jw, e=je, a=ja, Env=JaxEnv,
                            Conf=JaxConfiguration, Wm=JaxWatermarks,
                            kw={}, exe={})
PORT = types.SimpleNamespace(w=tw, e=te, a=ta, Env=StreamExecutionEnvironment,
                             Conf=Configuration, Wm=WatermarkStrategy,
                             kw={"device": "cpu"}, exe={"device": "cpu"})


def count_fn(elements):
    return {"count": len(elements["__ts__"])}


def mean_v(elements):
    return {"mean": float(np.mean(elements["v"]))}


def assert_fired_equal(got, ref, max_count=None):
    """One fired batch (or None) of each package: equal in order. The
    sum bound takes each row's count, or ``max_count`` (at least every
    window's element count) where the rows carry none."""
    if ref is None:
        assert got is None
        return
    got, ref = dict(got), dict(ref)
    assert list(got) == list(ref)
    cnt = (np.asarray(ref["count"], np.float64) if "count" in ref
           else max_count)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype, (k, g.dtype, r.dtype)
        assert g.shape == r.shape, k
        if k.startswith(("sum", "avg")) and r.dtype.kind == "f":
            assert cnt is not None
            bound = (2 * cnt + 4) * U * np.abs(r.astype(np.float64))
            assert np.all(np.abs(g.astype(np.float64) - r) <= bound), k
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


def run_script(m, make_op, script):
    """Drive one package's operator through ``script``: ("pb", keys, ts,
    data), ("aw", wm), ("tf",) or ("snap",) (snapshot, restore into a
    fresh operator, continue there). Returns every step's output."""
    op = make_op(m)
    out = []
    for step in script:
        if step[0] == "pb":
            op.process_batch(step[1], step[2], step[3])
            out.append(op.take_fired())
        elif step[0] == "aw":
            out.append(op.advance_watermark(step[1]))
        elif step[0] == "tf":
            out.append(op.take_fired())
        else:
            snap = op.snapshot_state()
            op = make_op(m)
            op.restore_state(snap)
            out.append(None)
    return out, op


def both(make_op, script):
    ref, ref_op = run_script(JAX, make_op, script)
    got, got_op = run_script(PORT, make_op, script)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert_fired_equal(g, r)
    assert got_op.late_records == ref_op.late_records
    return got, ref, got_op, ref_op


def a(*x):
    return np.array(x)


# -- the reference's cases -----------------------------------------------------

def test_count_evictor_keeps_last_n():
    got, _, _, _ = both(
        lambda m: m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(1000), count_fn,
            evictor=m.e.CountEvictor.of(2), **m.kw),
        [("pb", a(1, 1, 1, 1), a(100, 200, 300, 400), {}), ("aw", 2000)])
    assert list(map(int, dict(got[1])["count"])) == [2]


def test_time_evictor_keeps_recent():
    got, _, _, _ = both(
        lambda m: m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(1000), count_fn,
            evictor=m.e.TimeEvictor.of_ms(150), **m.kw),
        [("pb", a(1, 1, 1), a(100, 600, 700), {}), ("aw", 2000)])
    assert list(map(int, dict(got[1])["count"])) == [2]


def test_evictor_with_value_aggregation():
    got, _, _, _ = both(
        lambda m: m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(1000), mean_v,
            evictor=m.e.CountEvictor.of(2), **m.kw),
        [("pb", a(1, 1, 1), a(10, 20, 30), {"v": a(100.0, 1.0, 3.0)}),
         ("aw", 2000)])
    assert dict(got[1])["mean"][0] == pytest.approx(2.0)


def test_count_trigger_fires_mid_window():
    got, _, _, _ = both(
        lambda m: m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(10_000), count_fn,
            trigger=m.w.CountTrigger.of(3), **m.kw),
        [("pb", np.ones(5, np.int64), a(10, 20, 30, 40, 50), {}),
         ("pb", a(1), a(60), {})])
    assert list(map(int, dict(got[0])["count"])) == [3]
    assert list(map(int, dict(got[1])["count"])) == [6]


def every_second(m):
    class EverySecond(m.w.Trigger):
        def on_element(self, ts, window, n):
            return (m.w.TriggerResult.FIRE_AND_PURGE if n >= 2
                    else m.w.TriggerResult.CONTINUE)

    return EverySecond()


def test_user_trigger_fire_and_purge():
    got, _, _, _ = both(
        lambda m: m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(10_000), count_fn,
            trigger=every_second(m), **m.kw),
        [("pb", np.ones(5, np.int64), np.arange(5), {})])
    assert list(map(int, dict(got[0])["count"])) == [2, 2]


def test_user_trigger_event_time_hold():
    def never(m):
        class Never(m.w.Trigger):
            def on_event_time(self, time, window):
                return m.w.TriggerResult.CONTINUE

        return Never()

    got, _, _, _ = both(
        lambda m: m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(1000), count_fn,
            trigger=never(m), **m.kw),
        [("pb", a(1, 1), a(10, 20), {}), ("aw", 5000)])
    assert len(dict(got[1])["key"]) == 0


def test_late_created_window_still_fires():
    got, _, _, _ = both(
        lambda m: m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(1000), count_fn,
            allowed_lateness_ms=5000, **m.kw),
        [("aw", 2500), ("pb", a(7), a(500), {})])
    f = dict(got[1])
    assert [int(k) for k in f["key"]] == [7] and [int(c) for c in f["count"]] == [1]


def test_late_refire_after_purge_has_fresh_contents_only():
    got, _, _, _ = both(
        lambda m: m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(1000), count_fn,
            trigger=m.w.PurgingTrigger.of(m.w.EventTimeTrigger.create()),
            allowed_lateness_ms=5000, **m.kw),
        [("pb", a(3, 3), a(100, 200), {}), ("aw", 1500),
         ("pb", a(3), a(300), {})])
    assert [int(c) for c in dict(got[1])["count"]] == [2]
    assert [int(c) for c in dict(got[2])["count"]] == [1]


def test_late_refire_without_purge_accumulates():
    got, _, _, _ = both(
        lambda m: m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(1000), count_fn,
            allowed_lateness_ms=5000, **m.kw),
        [("pb", a(3, 3), a(100, 200), {}), ("aw", 1500),
         ("pb", a(3), a(300), {})])
    assert [int(c) for c in dict(got[2])["count"]] == [3]


def test_past_lateness_horizon_still_dropped():
    got, _, got_op, _ = both(
        lambda m: m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(1000), count_fn,
            allowed_lateness_ms=500, **m.kw),
        [("aw", 2500), ("pb", a(7), a(500), {})])
    assert got[1] is None and got_op.late_records == 1


def test_mid_window_snapshot_restore():
    script = [("pb", a(1, 2), a(100, 200), {"v": a(1.0, 2.0)}), ("snap",),
              ("pb", a(1), a(300), {"v": a(3.0)}), ("aw", 2000)]

    def mk(m):
        return m.e.EvictingWindowOperator(
            m.w.TumblingEventTimeWindows.of(1000), count_fn,
            evictor=m.e.CountEvictor.of(10), **m.kw)

    got, _, _, _ = both(mk, script)
    f = dict(got[3])
    assert sorted(zip(f["key"].tolist(), f["count"].tolist())) == [(1, 2), (2, 1)]


def pipeline_rows(m, configure):
    env = m.Env(m.Conf({"pipeline.microbatch-size": 64}))
    keys = np.array([1] * 6 + [2] * 6, np.int64)
    ts = np.array([10, 20, 30, 40, 50, 60] * 2, np.int64)
    vals = np.arange(12, dtype=np.float64)
    s = (env.from_collection({"k": keys, "v": vals}, ts)
         .assign_timestamps_and_watermarks(m.Wm.for_monotonous_timestamps())
         .key_by("k")
         .window(m.w.TumblingEventTimeWindows.of(1000)))
    sink = configure(m, s).collect()
    env.execute("evict-job", **m.exe)
    return sink.rows


def rows_equal(configure):
    ref = pipeline_rows(JAX, configure)
    got = pipeline_rows(PORT, configure)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        # six records a key, all in one window
        assert_fired_equal({k: np.asarray([v]) for k, v in g.items()},
                           {k: np.asarray([v]) for k, v in r.items()},
                           max_count=6)
    return got


@pytest.mark.parametrize("name,configure", [
    ("evictor_count", lambda m, s: s.evictor(m.e.CountEvictor.of(3)).count()),
    ("evictor_avg", lambda m, s: s.evictor(m.e.CountEvictor.of(2)).aggregate(
        m.a.avg_of("v"))),
    ("count_trigger", lambda m, s: s.trigger(m.w.CountTrigger.of(4)).count()),
    ("time_evictor_max", lambda m, s: s.evictor(
        m.e.TimeEvictor.of_ms(25)).aggregate(m.a.max_of("v"))),
])
def test_pipeline_routes_to_the_element_path(name, configure):
    got = rows_equal(configure)
    by_key = {int(r["key"]): r for r in got}
    if name == "evictor_count":
        assert {k: int(r["count"]) for k, r in by_key.items()} == {1: 3, 2: 3}
    elif name == "evictor_avg":
        assert {k: float(r["avg_v"]) for k, r in by_key.items()} == {
            1: pytest.approx(4.5), 2: pytest.approx(10.5)}
    elif name == "time_evictor_max":
        assert {k: float(r["max_v"]) for k, r in by_key.items()} == {
            1: 5.0, 2: 11.0}
    else:
        assert {(int(r["key"]), int(r["count"])) for r in got} >= {(1, 4), (2, 4)}


@pytest.mark.parametrize("which", ["assigner", "trigger"])
def test_processing_time_refused_on_the_element_path(which):
    for m in (JAX, PORT):
        env = m.Env(m.Conf({"pipeline.microbatch-size": 64}))
        s = env.from_collection({"k": np.array([1], np.int64),
                                 "v": np.array([1.0])},
                                np.array([10], np.int64)).key_by("k")
        if which == "assigner":
            ws = s.window(m.w.TumblingProcessingTimeWindows.of(1000))
        else:
            ws = s.window(m.w.TumblingEventTimeWindows.of(1000)).trigger(
                m.w.ProcessingTimeTrigger.create())
        with pytest.raises(NotImplementedError, match="element-buffer"):
            ws.evictor(m.e.CountEvictor.of(3)).count()


# -- seeded parity: the grouped batch path and the per-element loop -------------

def seeded_script(seed, n_batches=3, per_batch=150, keys=6, span=2600,
                  late_share=0.15):
    """Batches of keyed records drifting forward in time, some of them
    late, each followed by a watermark advance; positive values."""
    rng = np.random.default_rng(seed)
    script, t0 = [], 0
    for b in range(n_batches):
        ts = t0 + rng.integers(0, span, per_batch)
        late = rng.random(per_batch) < late_share
        ts[late] -= rng.integers(500, 3000, int(late.sum()))
        k = rng.integers(0, keys, per_batch)
        v = rng.random(per_batch) * 100 + 1
        script.append(("pb", k, ts, {"v": v, "w": rng.integers(1, 50, per_batch)}))
        t0 += span // 2
        script.append(("aw", t0 + rng.integers(0, 400)))
    return script


def count_every(m, n):
    class CountEvery(m.w.Trigger):
        """A user trigger with the count trigger's rule: the per-element
        loop must fire where the grouped path would."""

        def on_element(self, ts, window, count):
            return (m.w.TriggerResult.FIRE if count >= n
                    else m.w.TriggerResult.CONTINUE)

        def on_event_time(self, time, window):
            return (m.w.TriggerResult.FIRE if time >= window.max_timestamp()
                    else m.w.TriggerResult.CONTINUE)

        def fires_on_watermark(self):
            return True

    return CountEvery()


CONFIGS = {
    "tumbling_count_evictor": dict(
        win=lambda m: m.w.TumblingEventTimeWindows.of(1000),
        evictor=lambda m: m.e.CountEvictor.of(4), lateness=1500),
    "sliding_time_evictor": dict(
        win=lambda m: m.w.SlidingEventTimeWindows.of(1500, 500),
        evictor=lambda m: m.e.TimeEvictor.of_ms(300), lateness=800),
    "count_trigger": dict(
        win=lambda m: m.w.TumblingEventTimeWindows.of(1000),
        trigger=lambda m: m.w.CountTrigger.of(5)),
    "purging_count_trigger_evictor": dict(
        win=lambda m: m.w.SlidingEventTimeWindows.of(1000, 500),
        trigger=lambda m: m.w.PurgingTrigger.of(m.w.CountTrigger.of(4)),
        evictor=lambda m: m.e.CountEvictor.of(2)),
    "purging_event_time_lateness": dict(
        win=lambda m: m.w.TumblingEventTimeWindows.of(1000),
        trigger=lambda m: m.w.PurgingTrigger.of(m.w.EventTimeTrigger.create()),
        lateness=2000),
    "user_trigger": dict(
        win=lambda m: m.w.SlidingEventTimeWindows.of(1000, 500),
        trigger=lambda m: count_every(m, 6),
        evictor=lambda m: m.e.CountEvictor.of(3), lateness=1000),
}


def make(cfg, window_fn):
    """The operator of ``cfg`` with ``window_fn(m)`` as its function."""
    def mk(m):
        return m.e.EvictingWindowOperator(
            cfg["win"](m), window_fn(m),
            trigger=cfg["trigger"](m) if "trigger" in cfg else None,
            evictor=cfg["evictor"](m) if "evictor" in cfg else None,
            allowed_lateness_ms=cfg.get("lateness", 0), **m.kw)
    return mk


def agg_fn(m):
    from flink_tpu.api.datastream import _element_window_fn as jfn
    from flink_tpu_torch.api.datastream import _element_window_fn as tfn

    agg = m.a.multi(m.a.count(), m.a.sum_of("v"), m.a.max_of("v"),
                    m.a.min_of("w"), m.a.avg_of("w"))
    return (jfn if m is JAX else tfn)(agg)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_seeded_user_function_parity(name):
    script = seeded_script(7) + [("snap",)] + seeded_script(8)[2:]
    got, ref, got_op, ref_op = both(make(CONFIGS[name], lambda m: count_fn), script)
    assert sum(len(dict(f)["key"]) for f in ref if f is not None) > 0
    sg, sr = got_op.snapshot_state(), ref_op.snapshot_state()
    assert [(b["key"], b["start"], b["fired"], b["trig_count"])
            for b in sg["bufs"]] == [(b["key"], b["start"], b["fired"],
                                      b["trig_count"]) for b in sr["bufs"]]
    for bg, br in zip(sg["bufs"], sr["bufs"]):
        np.testing.assert_array_equal(bg["ts"], br["ts"])
        assert sorted(bg["fields"]) == sorted(br["fields"])
        for f in br["fields"]:
            np.testing.assert_array_equal(bg["fields"][f], br["fields"][f])


@pytest.mark.parametrize("name", ["tumbling_count_evictor", "count_trigger",
                                  "user_trigger"])
def test_seeded_lane_aggregate_parity(name):
    wk.reset_launch_counts()
    both(make(CONFIGS[name], agg_fn),
         seeded_script(11, n_batches=2, per_batch=100))
    assert wk.LAUNCHES["segment_lanes"] == 0   # the CPU takes the plain version


def test_one_reduction_per_call():
    """A batch whose records fire several windows reduces them together:
    one ``reduce_windows`` per operator call, rows in fire order."""
    calls = []
    real = te.reduce_windows

    def spy(agg, offsets, fields, device):
        calls.append(len(offsets) - 1)
        return real(agg, offsets, fields, device)

    te.reduce_windows = spy
    try:
        op = te.EvictingWindowOperator(
            tw.TumblingEventTimeWindows.of(1000),
            agg_fn(PORT), trigger=tw.CountTrigger.of(2), device="cpu")
        op.process_batch(a(1, 2, 1, 2, 1, 1), a(1, 2, 3, 4, 5, 6),
                         {"v": a(1.0, 2.0, 3.0, 4.0, 5.0, 6.0),
                          "w": a(1, 1, 1, 1, 1, 1)})
        f = dict(op.take_fired())
    finally:
        te.reduce_windows = real
    assert calls == [3]
    assert f["key"].tolist() == [1, 2, 1] and f["count"].tolist() == [2, 2, 4]
    assert f["count"].dtype == np.int32 and f["sum_v"].dtype == np.float32


def test_device_defaults_to_cuda():
    import torch

    def build():
        return te.EvictingWindowOperator(
            tw.TumblingEventTimeWindows.of(1000), count_fn)

    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
