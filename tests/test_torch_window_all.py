"""The port's windowAll (flink_tpu_torch/ops/window_all.py) against the
JAX package's WindowAllOperator on the CPU, on the same numpy inputs:
the cases of tests/test_window_all.py, windowAll jobs and Nexmark Q7
through ``execute(device="cpu")`` against the JAX package's rows and a
numpy golden, and the per-record function interfaces of
``api/functions.py`` (``torch.func.vmap`` against ``jax.vmap``).

Tolerances: window bounds, counts, row order and the f32 max / min lanes
exactly equal. The f32 sum lane is held to 0 ulps (written before the
first run): both packages lift the same f32 values and add them with
numpy's ``add.at`` in record order, then combine panes in the same
order; an average divides bit-equal sums, held to 1 ulp (XLA's CPU
division against torch's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.api import functions as jf
from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import CollectSink as JaxCollectSink
from flink_tpu.api.sources import GeneratorSource as JaxGeneratorSource
from flink_tpu.api.windowing import (
    SlidingEventTimeWindows as JaxSliding,
    TumblingEventTimeWindows as JaxTumbling,
)
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.nexmark.queries import q7_highest_bid as jax_q7
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops.window_all import WindowAllOperator as JaxWindowAll
from flink_tpu.time.watermarks import WatermarkStrategy as JaxWatermarks
from flink_tpu_torch.api import functions as tf
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import CollectSink
from flink_tpu_torch.api.sources import GeneratorSource
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_batch
from flink_tpu_torch.nexmark.queries import q7_highest_bid
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.window_all import WindowAllOperator
from flink_tpu_torch.time.watermarks import WatermarkStrategy
from test_torch_session import assert_rows_equal
from test_torch_threads import capped_torch_threads  # noqa: F401


def source(n_batches=6, b=200):
    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng(3 + i)
        return ({"v": rng.integers(1, 1000, b).astype(np.int64)},
                np.sort(rng.integers(i * 700, i * 700 + 1400, b)).astype(np.int64))
    return gen


PKGS = {
    "port": (StreamExecutionEnvironment, Configuration, GeneratorSource,
             CollectSink, WatermarkStrategy, TumblingEventTimeWindows,
             SlidingEventTimeWindows, ta,
             lambda env, n: env.execute(n, device="cpu")),
    "jax": (JaxEnv, JaxConfiguration, JaxGeneratorSource, JaxCollectSink,
            JaxWatermarks, JaxTumbling, JaxSliding, ja,
            lambda env, n: env.execute(n)),
}


def run_job(pkg, window, agg, extra=None, lateness=0):
    Env, Conf, Gen, Sink, WM, Tumbling, Sliding, a, execute = PKGS[pkg]
    env = Env(Conf(dict({"pipeline.microbatch-size": 256}, **(extra or {}))))
    sink = Sink()
    w = (Tumbling.of(1_000) if window == "tumbling"
         else Sliding.of(2_000, 1_000))
    s = (env.from_source(Gen(source()), WM.for_bounded_out_of_orderness(800))
         .window_all(w).allowed_lateness(lateness))
    {"max": lambda: s.max("v"), "sum": lambda: s.sum("v"),
     "lanes": lambda: s.aggregate(a.multi(
         a.count(), a.sum_of("v"), a.max_of("v"), a.min_of("v"),
         a.avg_of("v")))}[agg]().add_sink(sink)
    execute(env, "wa")
    return sink.rows


def cols(rows):
    return {f: np.array([r[f] for r in rows]) for f in rows[0]}


def test_global_max_golden():
    """TestWindowAllE2E::test_global_max_golden on the port."""
    rows = run_job("port", "tumbling", "max")
    want = {}
    for i in range(6):
        rng = np.random.default_rng(3 + i)
        v = rng.integers(1, 1000, 200)
        ts = np.sort(rng.integers(i * 700, i * 700 + 1400, 200))
        for vv, t in zip(v, ts):
            w = (int(t) // 1000) * 1000 + 1000
            want[w] = max(want.get(w, 0), int(vv))
    got = {int(r["window_end"]): float(r["max_v"]) for r in rows}
    assert got == {w: float(m) for w, m in want.items()}


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("window,agg,lateness", [
    ("tumbling", "max", 0), ("sliding", "sum", 0), ("tumbling", "lanes", 0),
    ("sliding", "lanes", 1500)])
def test_window_all_job_rows_equal_the_reference(window, agg, lateness, w):
    """windowAll jobs (tumbling and sliding, the lane kinds, a lateness
    with late re-fires) at host.parallelism w, the tree fold's floor at
    100 records: rows equal to the JAX package's in order."""
    extra = {"host.parallelism": w, "host.fold-chunk-records": 100}
    got = run_job("port", window, agg, extra, lateness)
    want = run_job("jax", window, agg, extra, lateness)
    assert len(got) == len(want) > 0
    assert_rows_equal(cols(got), cols(want), f"{window}/{agg}")


def test_mesh_mode_no_hotspot_same_results():
    """TestWindowAllE2E::test_mesh_mode_no_hotspot_same_results: windowAll
    has no keyed exchange, so a mesh of blocks (here 4 on the CPU) gives
    the rows of local execution."""
    from flink_tpu_torch.parallel.mesh import make_mesh_plan

    res = {}
    for mesh in (None, make_mesh_plan(8, 64, [torch.device("cpu")] * 4)):
        env = StreamExecutionEnvironment(Configuration(
            {"pipeline.microbatch-size": 256}))
        sink = CollectSink()
        (env.from_source(GeneratorSource(source()),
                         WatermarkStrategy.for_bounded_out_of_orderness(800))
         .window_all(SlidingEventTimeWindows.of(2_000, 1_000))
         .sum("v").add_sink(sink))
        env.execute("wa-mesh", device="cpu", mesh_plan=mesh)
        res[mesh is None] = sorted((int(r["window_end"]), float(r["sum_v"]))
                                   for r in sink.rows)
    assert res[True] == res[False] and res[True]


class Twin:
    def __init__(self, agg, **kw):
        self.port = WindowAllOperator(TumblingEventTimeWindows.of(1_000),
                                      agg(ta), **kw)
        self.ref = JaxWindowAll(JaxTumbling.of(1_000), agg(ja), **kw)

    def batch(self, ts, v):
        for op in (self.port, self.ref):
            op.process_batch(np.array(ts, np.int64),
                             {"v": np.array(v, np.float32)})
        assert self.port.late_records == self.ref.late_records

    def wm(self, w):
        got = dict(self.port.advance_watermark(w))
        want = {k: np.asarray(v) for k, v in
                dict(self.ref.advance_watermark(w)).items()}
        assert_rows_equal(got, want, f"wm {w}")
        return want


def test_late_within_lateness_refires():
    """TestWindowAllE2E::test_late_within_lateness_refires in both."""
    t = Twin(lambda a: a.max_of("v"), allowed_lateness_ms=5_000)
    t.batch([500], [10.0])
    assert t.wm(1_500)["max_v"].tolist() == [10.0]
    t.batch([600], [99.0])
    assert t.wm(1_500)["max_v"].tolist() == [99.0]
    t.wm(20_000)
    t.batch([100], [1000.0])
    assert t.port.late_records == 1


def test_empty_fire_has_the_reference_fields():
    """A fire with no rows carries the reference's fields, no key."""
    t = Twin(lambda a: a.avg_of("v"))
    want = t.wm(1_000)
    assert len(want["window_end"]) == 0
    assert set(want) == {"window_start", "window_end", "count", "avg_v"}


@pytest.mark.parametrize("direction", ["port_to_port", "port_to_jax",
                                       "jax_to_port"])
def test_snapshot_restore_roundtrip(direction):
    """TestWindowAllE2E::test_snapshot_restore_roundtrip, within the port
    and across the packages."""
    def mk(pkg):
        return (WindowAllOperator(TumblingEventTimeWindows.of(1_000),
                                  ta.avg_of("v")) if pkg == "port"
                else JaxWindowAll(JaxTumbling.of(1_000), ja.avg_of("v")))

    straight = mk("jax")
    straight.process_batch(np.array([100]), {"v": np.array([4.0], np.float32)})
    straight.process_batch(np.array([700]), {"v": np.array([8.0], np.float32)})
    want = {k: np.asarray(v) for k, v in
            dict(straight.advance_watermark(2_000)).items()}
    src_pkg, dst_pkg = direction.split("_to_")
    a = mk(src_pkg)
    a.process_batch(np.array([100]), {"v": np.array([4.0], np.float32)})
    b = mk(dst_pkg)
    b.restore_state(a.snapshot_state())
    b.process_batch(np.array([700]), {"v": np.array([8.0], np.float32)})
    got = dict(b.advance_watermark(2_000))
    assert_rows_equal(got, want, direction)
    assert got["avg_v"].tolist() == [6.0]


# -- Nexmark Q7 through execute ---------------------------------------------------

Q7_CFG = dict(batch_size=2048, n_batches=6, events_per_ms=1,
              num_active_auctions=500, hot_ratio=4)


def q7_bids(split, i):
    """The port's numpy bid generator for both packages (the JAX
    package's own bid_stream takes its C generator where it is built)."""
    return (bid_batch(NexmarkConfig(**Q7_CFG), int(split), i)
            if i < Q7_CFG["n_batches"] else None)


@pytest.mark.parametrize("w", [1, 4])
def test_q7_through_execute(w):
    """Q7 at a small scale with 1 s windows: the port's rows equal the JAX
    package's in order, and each window's max price from numpy."""
    conf = {"pipeline.microbatch-size": 2048, "host.parallelism": w,
            "host.fold-chunk-records": 512}
    env = StreamExecutionEnvironment(Configuration(conf))
    sink = CollectSink()
    q7_highest_bid(env, GeneratorSource(q7_bids), sink, window_ms=1_000,
                   out_of_orderness_ms=300)
    env.execute("q7", device="cpu")
    jenv = JaxEnv(JaxConfiguration(conf))
    jsink = JaxCollectSink()
    jax_q7(jenv, JaxGeneratorSource(q7_bids), jsink, window_ms=1_000,
           out_of_orderness_ms=300)
    jenv.execute("q7")
    assert len(sink.rows) == len(jsink.rows) > 0
    assert_rows_equal(cols(sink.rows), cols(jsink.rows), "q7")
    parts = [q7_bids("0", i) for i in range(Q7_CFG["n_batches"])]
    price = np.concatenate([d["price"] for d, _ in parts])
    we = np.concatenate([ts for _, ts in parts]) // 1000 * 1000 + 1000
    golden = {int(e): float(price[we == e].max()) for e in np.unique(we)}
    assert {int(r["window_end"]): float(r["max_price"])
            for r in sink.rows} == golden


# -- api/functions.py: the per-record forms, vmapped -------------------------------

class _Double(tf.MapFunction):
    def map(self, value):
        return {"x": value["x"] * 2.0, "n": value["n"] + 1}


class _JDouble(jf.MapFunction):
    def map(self, value):
        return {"x": value["x"] * 2.0, "n": value["n"] + 1}


class _Pos(tf.FilterFunction):
    def filter(self, value):
        return value["x"] > 0.25


class _JPos(jf.FilterFunction):
    def filter(self, value):
        return value["x"] > 0.25


def _record_batch():
    rng = np.random.default_rng(2)
    return {"x": rng.random(64).astype(np.float32),
            "n": rng.integers(0, 100, 64).astype(np.int64)}


@pytest.mark.parametrize("form", ["subclass", "lambda"])
def test_map_and_filter_batch_equal_the_reference(form):
    """``map_batch`` / ``filter_batch`` of a per-record function
    (``torch.func.vmap``) equal the JAX package's (``jax.vmap``), on
    numpy fields (the driver's chains) and on torch tensors."""
    data = _record_batch()
    if form == "subclass":
        pm, pf, jm, jfl = _Double(), _Pos(), _JDouble(), _JPos()
    else:
        pm = tf.LambdaMap(lambda v: {"x": v["x"] * 2.0, "n": v["n"] + 1},
                          batch=False)
        pf = tf.LambdaFilter(lambda v: v["x"] > 0.25, batch=False)
        jm = jf.LambdaMap(lambda v: {"x": v["x"] * 2.0, "n": v["n"] + 1},
                          batch=False)
        jfl = jf.LambdaFilter(lambda v: v["x"] > 0.25, batch=False)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jout = jax.device_get(jm.map_batch(jdata))
    jkeep = np.asarray(jfl.filter_batch(jdata))
    out = pm.map_batch(data)
    assert isinstance(out["x"], np.ndarray)
    assert np.array_equal(out["x"], np.asarray(jout["x"]))
    assert np.array_equal(out["n"], np.asarray(jout["n"]))
    assert np.array_equal(pf.filter_batch(data), jkeep)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    tout = pm.map_batch(tdata)
    assert isinstance(tout["x"], torch.Tensor)
    assert np.array_equal(tout["x"].numpy(), np.asarray(jout["x"]))
    assert np.array_equal(pf.filter_batch(tdata).numpy(), jkeep)


def test_function_objects_run_in_a_job():
    """A MapFunction and a FilterFunction with per-record methods chain
    into a job (``map`` / ``filter`` take them) and feed a window."""
    env = StreamExecutionEnvironment(Configuration())
    data = _record_batch()
    data["k"] = np.arange(64) % 4
    sink = (env.from_collection(data, np.arange(64) * 10)
            .filter(_Pos()).map(tf.LambdaMap(
                lambda v: {"k": v["k"], "x": v["x"]}, batch=False))
            .window_all(TumblingEventTimeWindows.of(1_000)).count().collect())
    env.execute(device="cpu")
    assert sum(int(r["count"]) for r in sink.rows) == int(
        (data["x"] > 0.25).sum())
    with pytest.raises(TypeError, match="FilterFunction"):
        env.from_collection(data, np.arange(64)).filter(3)
