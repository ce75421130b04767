"""Processing-time windows in the port's ``WindowOperator`` (records
stamped with the operator's clock at ingest, fires on
``advance_processing_time``) and the trigger / window checks of the
DataStream API, against the JAX package: the window and validation
cases of ``tests/test_processing_time.py``, with a
``ManualProcessingTimeService`` injected as ``op.clock`` on both sides.

Every fired batch must be equal in order: the same columns, dtypes
(those of a fire with rows: the reference's empty fires carry f64
result lanes), keys, window bounds, counts, max and min exactly; the sliding case's f32 sums
come from one record each per pane and must be equal too. The
end-to-end job runs on the wall clock, so its windows differ from run
to run: each key's counts must add up to its records in both packages."""
import numpy as np
import pytest

from flink_tpu.api import windowing as jw
from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops.window import WindowOperator as JaxWindowOperator
from flink_tpu.time.clock import ManualProcessingTimeService as JaxClock
from flink_tpu_torch.api import windowing as tw
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.window import WindowOperator
from flink_tpu_torch.time.clock import ManualProcessingTimeService
from test_torch_threads import capped_torch_threads  # noqa: F401


def mk_ops(assigner, agg, **kw):
    """(reference op, port op), each with a manual clock at 0."""
    ref = JaxWindowOperator(getattr(jw, assigner[0]).of(*assigner[1:]),
                            agg(ja), num_shards=4, slots_per_shard=64, **kw)
    port = WindowOperator(getattr(tw, assigner[0]).of(*assigner[1:]),
                          agg(ta), num_shards=4, slots_per_shard=64,
                          device="cpu", **kw)
    ref.clock, port.clock = JaxClock(0), ManualProcessingTimeService(0)
    return ref, port


def assert_same(got, ref):
    got, ref = dict(got), dict(ref)
    assert list(got) == list(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        # the reference's empty fires carry f64 result lanes (JAX's x64
        # default; ROADMAP.md queue 3, not a fault): dtypes where rows are
        assert g.dtype == r.dtype or not len(r), k
        np.testing.assert_array_equal(g, r, err_msg=k)


def drive(ops, script):
    """Run ``script`` on both operators: ("clock", ms), ("pb", keys, ts,
    data) or ("fire",); returns the port's fires, each checked against
    the reference's."""
    fired = []
    for step in script:
        if step[0] == "clock":
            for op in ops:
                op.clock.advance_to(step[1])
        elif step[0] == "pb":
            for op in ops:
                op.process_batch(step[1], step[2], step[3])
        else:
            r, g = (op.advance_processing_time() for op in ops)
            assert_same(g, r)
            fired.append(dict(g))
    return fired


def rows(f):
    return sorted((int(k), int(ws), int(we), int(c)) for k, ws, we, c in zip(
        f["key"], f["window_start"], f["window_end"], f["count"]))


def test_assign_by_clock_and_fire_on_clock():
    ops = mk_ops(("TumblingProcessingTimeWindows", 1000), lambda m: m.count())
    f = drive(ops, [
        ("clock", 100), ("pb", np.array([1, 1, 2]), np.array([99999, 0, 5]), {}),
        ("clock", 900), ("pb", np.array([1]), np.array([0]), {}), ("fire",),
        ("clock", 1000), ("fire",),
        ("pb", np.array([2]), np.array([0]), {}), ("clock", 2500), ("fire",)])
    assert len(f[0]["key"]) == 0
    assert rows(f[1]) == [(1, 0, 1000, 3), (2, 0, 1000, 1)]
    assert rows(f[2]) == [(2, 1000, 2000, 1)]


def test_no_late_records_by_construction():
    ops = mk_ops(("TumblingProcessingTimeWindows", 1000), lambda m: m.count())
    f = drive(ops, [("clock", 5000), ("fire",),
                    ("pb", np.array([7]), np.array([0]), {}),
                    ("clock", 6000), ("fire",)])
    assert rows(f[1]) == [(7, 5000, 6000, 1)]
    assert ops[0].late_records == ops[1].late_records == 0


def test_lateness_rejected():
    for op_cls, m, kw in ((JaxWindowOperator, jw, {}),
                          (WindowOperator, tw, {"device": "cpu"})):
        with pytest.raises(ValueError, match="lateness"):
            op_cls(m.TumblingProcessingTimeWindows.of(1000),
                   (ja if m is jw else ta).count(), num_shards=4,
                   slots_per_shard=8, allowed_lateness_ms=100, **kw)


def test_sliding_panes_over_clock():
    ops = mk_ops(("SlidingProcessingTimeWindows", 2000, 1000),
                 lambda m: m.sum_of("v"))
    f = drive(ops, [
        ("clock", 500), ("pb", np.array([1]), np.array([0]), {"v": np.array([10.0])}),
        ("clock", 1500), ("pb", np.array([1]), np.array([0]), {"v": np.array([5.0])}),
        ("clock", 2000), ("fire",)])
    got = sorted((int(k), int(ws), float(s)) for k, ws, s in zip(
        f[0]["key"], f[0]["window_start"], f[0]["sum_v"]))
    assert got == [(1, -1000, 10.0), (1, 0, 15.0)]


def test_seeded_batches_over_a_manual_clock():
    """Keyed batches from a seed, the clock moved between them by uneven
    steps, a fire after each: every fire equal in order."""
    rng = np.random.default_rng(17)
    ops = mk_ops(("SlidingProcessingTimeWindows", 1000, 250), lambda m: m.multi(m.count(), m.max_of("v"),
                                             m.min_of("v")))
    script, now = [], 0
    for _ in range(5):
        n = int(rng.integers(50, 200))
        script.append(("pb", rng.integers(0, 40, n), rng.integers(0, 10**6, n),
                       {"v": rng.normal(0, 10, n).astype(np.float32)}))
        now += int(rng.integers(100, 900))
        script += [("clock", now), ("fire",)]
    script += [("clock", now + 5000), ("fire",)]
    fired = drive(ops, script)
    assert sum(int(f["count"].sum()) for f in fired) == sum(
        len(st[1]) for st in script if st[0] == "pb") * 4


def test_trigger_object_semantics():
    for m in (jw, tw):
        t = m.ProcessingTimeTrigger.create()
        w = m.TimeWindow(0, 1000)
        assert t.on_processing_time(998, w) == m.TriggerResult.CONTINUE
        assert t.on_processing_time(999, w) == m.TriggerResult.FIRE
        assert not t.fires_on_watermark()


def windowed(pkg, assigner):
    if pkg == "jax":
        env = JaxEnv(JaxConfiguration({}))
    else:
        env = StreamExecutionEnvironment(Configuration({}))
    s = env.from_collection({"k": np.array([1])}, np.array([0], np.int64))
    return s.key_by("k").window(assigner)


@pytest.mark.parametrize("pkg,m", [("jax", jw), ("port", tw)])
def test_api_validation(pkg, m):
    with pytest.raises(NotImplementedError, match="ProcessingTime"):
        windowed(pkg, m.TumblingEventTimeWindows.of(1000)).trigger(
            m.ProcessingTimeTrigger.create()).count()
    with pytest.raises(NotImplementedError, match="EventTimeTrigger"):
        windowed(pkg, m.TumblingProcessingTimeWindows.of(1000)).trigger(
            m.EventTimeTrigger.create()).count()
    with pytest.raises(NotImplementedError, match="lateness"):
        windowed(pkg, m.TumblingProcessingTimeWindows.of(1000)
                 ).allowed_lateness(10).count()
    # the processing-time trigger on its own assigners is accepted
    windowed(pkg, m.TumblingProcessingTimeWindows.of(1000)).trigger(
        m.ProcessingTimeTrigger.create()).count()


def proc_job(pkg):
    conf = {"state.num-key-shards": 4, "state.slots-per-shard": 32,
            "pipeline.microbatch-size": 64}
    keys = np.arange(100, dtype=np.int64) % 5
    ts = np.zeros(100, np.int64)
    if pkg == "jax":
        env = JaxEnv(JaxConfiguration(conf))
        sink = (env.from_collection({"k": keys}, ts).key_by("k")
                .window(jw.TumblingProcessingTimeWindows.of(50)).count()
                .collect())
        env.execute("proc-job")
    else:
        env = StreamExecutionEnvironment(Configuration(conf))
        sink = (env.from_collection({"k": keys}, ts).key_by("k")
                .window(tw.TumblingProcessingTimeWindows.of(50)).count()
                .collect())
        env.execute("proc-job", device="cpu")
    got = {}
    for r in sink.rows:
        got[int(r["key"])] = got.get(int(r["key"]), 0) + int(r["count"])
    return got, sink.rows


def test_pipeline_with_proc_windows():
    """The driver's clock branch: each pass fires what the clock passed,
    the end of input fires everything seen, every record once."""
    ref, ref_rows = proc_job("jax")
    got, got_rows = proc_job("port")
    assert got == ref == {k: 20 for k in range(5)}
    assert sorted(got_rows[0]) == sorted(ref_rows[0])
    assert all(type(g["count"]) is type(r["count"])
               for g, r in zip(got_rows, ref_rows))
