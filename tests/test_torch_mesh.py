"""The port's key-sharded window operator (``cluster.mesh-devices``)
against the JAX package's sharded operator on its eight forced CPU
devices: the port's mesh is eight blocks on ``cpu`` (``make_mesh_plan``
with one device named eight times).

Rows must equal the reference's sharded rows in order: keys, window
bounds, counts and max fields exactly; sum fields within |port - ref| <=
(2 * count + 4) * 2^-24 * |ref|, the bound of
tests/test_torch_window_aggregates.py (each block's scatter adds in the
reference's record order; the fire's column sum may associate
differently). Covered: tumbling ``multi(count, sum_of, max_of)`` and
sliding ``count()`` with lateness at operator level, a top-2 whose one drain
reads many fires (block-major rows), Q5 top-1 through the ``Driver``
(ties across blocks kept; rows compared in order within each window,
since the drivers drain at their own cadence), a skewed batch under a tiny
exchange capacity (split on the host, zero overflow), snapshot and
restore with a reshard from 8 to 4 blocks, and the reference's sharded
snapshot loaded into 8 and 4 blocks."""
import jax
import numpy as np
import pytest
import torch

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import CollectSink as JaxCollectSink
from flink_tpu.api.sources import GeneratorSource as JaxGeneratorSource
from flink_tpu.api.windowing import (
    SlidingEventTimeWindows as JaxSliding,
    TumblingEventTimeWindows as JaxTumbling,
)
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops.window import WindowOperator as JaxWindowOperator
from flink_tpu.parallel.mesh import make_mesh_plan as jax_mesh_plan
from flink_tpu.time.watermarks import WatermarkStrategy as JaxWatermarks
from flink_tpu_torch.api import environment
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import CollectSink
from flink_tpu_torch.api.sources import GeneratorSource
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.graph.compiler import compile_job
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.window import WindowOperator
from flink_tpu_torch.parallel.mesh import make_mesh_plan
from flink_tpu_torch.runtime.driver import Driver
from flink_tpu_torch.time.watermarks import WatermarkStrategy
from test_torch_threads import capped_torch_threads  # noqa: F401

U = 2.0 ** -24
N_DEV, SHARDS, SLOTS = 8, 32, 64
KW = dict(allowed_lateness_ms=1000, max_out_of_orderness_ms=2000)
CASES = {
    "tumbling": (lambda m, w: w[0].of(1000),
                 lambda m: m.multi(m.count(), m.sum_of("v"), m.max_of("v")),
                 None),
    "sliding": (lambda m, w: w[1].of(5000, 1000), lambda m: m.count(), None),
    # drained once at the end: every fire's rows, block by block
    "sliding_top2": (lambda m, w: w[1].of(5000, 1000), lambda m: m.count(),
                     ("count", 2)),
}
SNAP_AT = 3  # batches before the snapshot


def port_mesh(n=N_DEV, shards=SHARDS, slots=SLOTS):
    return make_mesh_plan(shards, slots, ["cpu"] * n)


def batches():
    """test_sharded.py's parity stream: 6 batches of 100 records over 50
    keys, out of order by up to 2 s, then a final watermark."""
    rng = np.random.default_rng(3)
    out, t = [], 0
    for _ in range(6):
        ts = rng.integers(max(0, t - 2000), t + 1200, 100)
        t = max(t, int(ts.max()))
        out.append((rng.integers(0, 50, 100), ts,
                     {"v": (rng.random(100) * 10).astype(np.float32)},
                     t - 2001))
    out.append((None, None, None, t + 20_000))
    return out


def feed(op, steps):
    """Each advance's rows; a top-n operator's fires are read only after
    the last advance, so its first read drains every fire's rows."""
    fired = []
    for keys, ts, data, wm in steps:
        if keys is not None:
            op.process_batch(keys, ts, data)
        fired.append(op.advance_watermark(wm))
        if op._topn is None:
            fired[-1] = dict(fired[-1])
    return [{k: np.asarray(v) for k, v in dict(f).items()} for f in fired]


def assert_rows_match(got, ref):
    assert sorted(got) == sorted(ref)
    n = len(ref["window_end"])
    assert len(got["window_end"]) == n
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        if k.startswith("sum"):
            bound = (2 * np.asarray(ref["count"], np.float64) + 4) * U \
                * np.abs(r.astype(np.float64))
            assert (np.abs(g.astype(np.float64) - r) <= bound).all(), k
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


@pytest.fixture(scope="module")
def reference():
    """Per case, the reference sharded operator's fires over the whole
    stream, and its snapshot after SNAP_AT batches (panes as numpy) with
    the fires that follow it."""
    mp = jax_mesh_plan(num_shards=SHARDS, slots_per_shard=SLOTS)
    assert mp.n_devices == N_DEV, "conftest forces 8 CPU devices"
    steps = batches()
    out = {}
    for case, (win, agg, top) in CASES.items():
        op = JaxWindowOperator(win(ja, (JaxTumbling, JaxSliding)), agg(ja),
                               mesh_plan=mp, top_n=top, **KW)
        head = feed(op, steps[:SNAP_AT])
        snap = op.snapshot_state()
        snap["panes"] = jax.tree_util.tree_map(np.asarray, snap["panes"])
        tail = feed(op, steps[SNAP_AT:])
        assert op.exchange_overflow == 0
        out[case] = (head + tail, snap)
    return out


def port_op(case, mesh=None, **kw):
    win, agg, top = CASES[case]
    return WindowOperator(
        win(ta, (TumblingEventTimeWindows, SlidingEventTimeWindows)), agg(ta),
        num_shards=SHARDS, slots_per_shard=SLOTS, device="cpu",
        mesh_plan=mesh, top_n=top, **KW, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_operator_matches_the_reference(reference, case):
    fires, _ = reference[case]
    op = port_op(case, port_mesh())
    steps = batches()
    # read at the reference's points: before its snapshot and at the end
    got = feed(op, steps[:SNAP_AT]) + feed(op, steps[SNAP_AT:])
    assert sum(len(f["key"]) for f in fires) > 30
    for g, r in zip(got, fires):
        assert_rows_match(g, r)
    assert op.exchange_overflow == 0 and op.exchange_bytes > 0


def test_sharded_topn_folds_the_global_threshold(reference, monkeypatch):
    """The sharded top-2 commits the reference's rows with no call of
    ``topn_global_threshold`` and no gather copy: every block writes its
    candidates into its columns of one (W, blocks * k) buffer, reused by
    every chunk of a width, and each block's select takes that buffer
    and k (the global k-th worked out inside it)."""
    from flink_tpu_torch.kernels import window_kernels as wk

    def never(*a, **k):
        raise AssertionError("topn_global_threshold called on the path")
    monkeypatch.setattr(wk, "topn_global_threshold", never)
    seen = []
    orig = wk.topn_select_given

    def spy(wcounts, used, ends, valid, anchor, cands, k, *a, **kw):
        seen.append((cands, k))
        return orig(wcounts, used, ends, valid, anchor, cands, k, *a, **kw)
    monkeypatch.setattr(wk, "topn_select_given", spy)
    fires, _ = reference["sliding_top2"]
    op = port_op("sliding_top2", port_mesh())
    steps = batches()
    got = feed(op, steps[:SNAP_AT]) + feed(op, steps[SNAP_AT:])
    for g, r in zip(got, fires):
        assert_rows_match(g, r)
    assert len(seen) % N_DEV == 0 and seen
    bufs = {id(c) for c, _ in seen}
    assert bufs == {id(b) for b in op._gathered_bufs.values()}
    for c, k in seen:
        assert k == 2 and c.shape[1] == N_DEV * k


@pytest.mark.parametrize("case", ["tumbling", "sliding"])
def test_ring_exchange_and_snapshot_reshard(case):
    """A mid-stream snapshot restores into a twin of 8 blocks (ring
    exchange), of 4 blocks and into one device, and each continues with
    the rows of the uninterrupted run."""
    steps = batches()
    op = port_op(case, port_mesh())
    feed(op, steps[:SNAP_AT])
    snap = op.snapshot_state()
    assert snap["n_dev"] == N_DEV
    assert snap["panes"].counts.shape[0] == N_DEV * (SHARDS * SLOTS // N_DEV + 1)
    want = feed(op, steps[SNAP_AT:])
    for twin in (port_op(case, port_mesh(), exchange_impl="ring"),
                 port_op(case, port_mesh(4)), port_op(case)):
        twin.restore_state(snap)
        for g, r in zip(feed(twin, steps[SNAP_AT:]), want):
            assert_rows_match(g, r)


@pytest.mark.parametrize("n_blocks", [N_DEV, 4])
def test_load_jax_sharded_snapshot(reference, n_blocks):
    fires, snap = reference["tumbling"]
    op = port_op("tumbling", port_mesh(n_blocks))
    op.load_jax_snapshot(snap)
    for g, r in zip(feed(op, batches()[SNAP_AT:]), fires[SNAP_AT:]):
        assert_rows_match(g, r)


# -- through the Driver ------------------------------------------------------------

def q5_gen(split, i):
    """tests/test_mesh_execute.py's Q5-shaped source: 8 batches of 192
    records over 100 keys."""
    if i >= 8:
        return None
    rng = np.random.default_rng(i)
    return ({"k": rng.integers(0, 100, 192).astype(np.int64)},
            np.sort(rng.integers(i * 700, i * 700 + 1400, 192)).astype(np.int64))


def ties_gen(split, i):
    """One batch: four keys of five records each (on four blocks), four
    of two: a top-1 keeps all four tying keys."""
    if i >= 1:
        return None
    rows = np.repeat(np.array([3, 40, 77, 90, 5, 21, 55, 68], np.int64),
                     [5, 5, 5, 5, 2, 2, 2, 2])
    return {"k": rows}, np.full(len(rows), 500, np.int64)


def skew_gen(split, i):
    """tests/test_mesh_execute.py's worst skew: every record one key."""
    if i >= 4:
        return None
    rng = np.random.default_rng(i)
    return ({"k": np.zeros(192, np.int64)},
            np.sort(rng.integers(i * 700, i * 700 + 1400, 192)).astype(np.int64))


JOBS = {
    "q5_top1": (q5_gen, 500, lambda w: w[1].of(4_000, 1_000), 1, {}),
    "ties_top1": (ties_gen, 0, lambda w: w[0].of(1_000), 1, {}),
    "skew_cap8": (skew_gen, 500, lambda w: w[0].of(1_000), None,
                  {"pipeline.exchange-capacity": 8}),
}
CONF = {"state.num-key-shards": 32, "state.slots-per-shard": 16,
        "pipeline.microbatch-size": 256}


def build(env, source, watermarks, sink, windows, job):
    gen, ooo, win, top, _ = JOBS[job]
    s = (env.from_source(source(gen),
                         watermarks.for_bounded_out_of_orderness(ooo))
         .key_by("k").window(win(windows)).count())
    if top:
        s = s.top(top, by="count")
    s.add_sink(sink)


def columns(sink):
    """The sink's rows as columns, stably in window order: how many fires
    one drain reads (block by block) is the drivers' cadence — the
    reference drains on a thread — so rows compare in order within each
    window."""
    we = np.asarray([r["window_end"] for r in sink.rows])
    order = np.argsort(we, kind="stable")
    return {k: np.asarray([r[k] for r in sink.rows])[order]
            for k in sink.rows[0]}


@pytest.fixture(scope="module")
def reference_jobs():
    out = {}
    for job, (*_, extra) in JOBS.items():
        env = JaxEnv(JaxConfiguration({**CONF, **extra,
                                       "cluster.mesh-devices": "all"}))
        sink = JaxCollectSink()
        build(env, JaxGeneratorSource, JaxWatermarks, sink,
              (JaxTumbling, JaxSliding), job)
        res = env.execute(job)
        out[job] = (columns(sink), res.metrics.get("exchange_overflow", 0))
    return out


def port_job(job, mesh):
    """The port's run of ``job`` through the ``Driver`` (over ``mesh``):
    (its rows, the driver)."""
    conf = Configuration({**CONF, **JOBS[job][-1]})
    env = StreamExecutionEnvironment(conf)
    sink = CollectSink()
    build(env, GeneratorSource, WatermarkStrategy, sink,
          (TumblingEventTimeWindows, SlidingEventTimeWindows), job)
    driver = Driver(compile_job(env._transforms, env._watermark_strategy),
                    conf, device="cpu", mesh_plan=mesh)
    driver.run(job)
    return columns(sink), driver


@pytest.mark.parametrize("job", list(JOBS))
def test_driver_jobs_match_the_reference(reference_jobs, job):
    want, ref_overflow = reference_jobs[job]
    got, driver = port_job(job, port_mesh(N_DEV, 32, 16))
    assert_rows_match(got, want)
    assert ref_overflow == 0
    (op,) = driver._ops.values()
    assert op.mesh_plan is not None and op.exchange_overflow == 0
    if job == "ties_top1":
        assert sorted(got["key"].tolist()) == [3, 40, 77, 90]
        # the tying keys sit on different blocks
        slots = op.directory.lookup(np.array([3, 40, 77, 90]))[0]
        assert len(set((slots // op.layout.slots).tolist())) > 1
    if job == "skew_cap8":
        assert int(got["count"].sum()) == 4 * 192
        local, _ = port_job(job, None)
        assert_rows_match(got, local)


def test_execute_builds_the_mesh(monkeypatch):
    """``cluster.mesh-devices`` through ``env.execute``: the mesh rules,
    and the sharded operator when more than one device is visible."""
    def env_with(mesh="", procs=1):
        return StreamExecutionEnvironment(Configuration(
            {**CONF, "cluster.mesh-devices": mesh,
             "cluster.num-processes": procs}))

    assert env_with().build_mesh_plan("cpu") is None
    assert env_with("all").build_mesh_plan("cpu") is None  # one CPU: local
    with pytest.raises(ValueError, match="only 1 devices"):
        env_with("2").build_mesh_plan("cpu")
    monkeypatch.setattr(environment, "visible_devices",
                        lambda device: [torch.device("cpu")] * N_DEV)
    assert env_with("4").build_mesh_plan("cpu").n_devices == 4
    assert env_with("1").build_mesh_plan("cpu") is None
    with pytest.raises(ValueError, match="positive integer"):
        env_with("0").build_mesh_plan("cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        env_with("all", procs=2).build_mesh_plan("cpu")
    env = env_with("all")
    sink = CollectSink()
    build(env, GeneratorSource, WatermarkStrategy, sink,
          (TumblingEventTimeWindows, SlidingEventTimeWindows), "q5_top1")
    res = env.execute("q5", device="cpu")
    assert res.metrics["mesh_devices"] == ["cpu"] * N_DEV
    assert res.metrics["exchange_overflow"] == 0
    got, _ = port_job("q5_top1", None)
    assert sorted(zip(*[columns(sink)[k] for k in sorted(got)])) == \
        sorted(zip(*[got[k] for k in sorted(got)]))


def test_refusals():
    mesh = port_mesh(N_DEV, 32, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        WindowOperator(TumblingEventTimeWindows.of(1000),
                       ta.multi(ta.count(), ta.max_of("v")),
                       top_n=("max_v", 1), mesh_plan=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        WindowOperator(TumblingEventTimeWindows.of(1000), ta.count(),
                       spill=True, mesh_plan=mesh, device="cpu")
    with pytest.raises(ValueError, match="unknown exchange"):
        WindowOperator(TumblingEventTimeWindows.of(1000), ta.count(),
                       mesh_plan=mesh, exchange_impl="bus", device="cpu")
    with pytest.raises(ValueError, match="exchange.capacity|exchange_capacity"):
        WindowOperator(TumblingEventTimeWindows.of(1000), ta.count(),
                       mesh_plan=mesh, exchange_capacity=-1, device="cpu")
    with pytest.raises(ValueError, match="exchange-capacity"):
        Configuration({"pipeline.exchange-capacity": -1}).validate()
    env = StreamExecutionEnvironment(Configuration(CONF))
    (env.from_source(GeneratorSource(q5_gen),
                     WatermarkStrategy.for_monotonous_timestamps())
     .key_by("k").count_window(3).count().add_sink(CollectSink()))
    with pytest.raises(NotImplementedError, match="count windows"):
        Driver(compile_job(env._transforms, env._watermark_strategy),
               env.config, device="cpu", mesh_plan=mesh)


def test_split_for_exchange_matches_the_reference():
    """The host splitter: the reference's chunks exactly, every chunk
    within capacity in its padded block layout, no record lost."""
    mp = port_mesh(N_DEV, 32, 16)
    op = WindowOperator(TumblingEventTimeWindows.of(1_000), ta.count(),
                        max_out_of_orderness_ms=500, mesh_plan=mp,
                        exchange_capacity=4, device="cpu")
    ref = JaxWindowOperator(JaxTumbling.of(1_000), ja.count(),
                            max_out_of_orderness_ms=500,
                            mesh_plan=jax_mesh_plan(32, 16),
                            exchange_capacity=4)
    rng = np.random.default_rng(7)
    ring, spd = op.plan.ring, mp.slots_per_device
    for _ in range(6):
        b = int(rng.integers(3, 400))
        slots = np.where(rng.random(b) < 0.8, 0, rng.integers(0, 32 * 16, b))
        pk = (slots * ring + rng.integers(0, ring, b)).astype(np.int32)
        got = op._split_for_exchange(pk, {"v": np.ones(b)}, N_DEV)
        want = ref._split_for_exchange(pk, {"v": np.ones(b)}, N_DEV)
        assert [(len(c), t) for c, _, t in got] == \
            [(len(c), t) for c, _, t in want]
        np.testing.assert_array_equal(np.concatenate([c for c, _, _ in got]),
                                      pk)
        for cpk, _, target in got:
            L = target // N_DEV
            flat = np.arange(len(cpk)) // L * N_DEV + (cpk // ring) // spd
            assert np.bincount(flat).max() <= 4 or len(cpk) == 1
