"""The port's windowed equi-join (flink_tpu_torch/ops/join.py) against the
JAX package's WindowJoinOperator on the CPU, on the same numpy inputs,
in both modes: the cases of tests/test_join_session.py's
TestWindowJoinOperator and TestWindowJoinPairs, the pair-explosion and
mode-mismatch refusals, pairs-mode snapshots across the packages, and
Nexmark Q8 through ``execute(device="cpu")`` against the JAX package's
rows and a numpy golden. Aggregate mode's snapshots cross the packages
through whole checkpoints (tests/test_torch_checkpoint.py, jobs
q8_aggregate and q8_pairs).

Tolerances: every field is exactly equal — keys, window bounds, counts,
row order, and the carried f32 fields (pairs copy the input values;
aggregate mode's max lanes are exact)."""
import numpy as np
import pytest

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import CollectSink as JaxCollectSink
from flink_tpu.api.sources import GeneratorSource as JaxGeneratorSource
from flink_tpu.api.windowing import TumblingEventTimeWindows as JaxTumbling
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.nexmark.queries import q8_monitor_new_users as jax_q8
from flink_tpu.ops.join import WindowJoinOperator as JaxJoin
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import CollectSink
from flink_tpu_torch.api.sources import GeneratorSource
from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.nexmark.generator import (
    NexmarkConfig, auction_batch, person_batch)
from flink_tpu_torch.nexmark.queries import q8_monitor_new_users
from flink_tpu_torch.ops.join import WindowJoinOperator
from test_torch_threads import capped_torch_threads  # noqa: F401

MODES = ("pairs", "aggregate")


def assert_fire_equal(got, want, label=""):
    got, want = dict(got), {k: np.asarray(v) for k, v in dict(want).items()}
    assert list(got) == list(want), (label, list(got), list(want))
    for f in want:
        g = np.asarray(got[f])
        assert g.shape == want[f].shape, (label, f)
        assert np.array_equal(g.astype(want[f].dtype), want[f]), (
            label, f, g, want[f])


class Twin:
    def __init__(self, mode, **kw):
        kw = dict(dict(num_shards=8, slots_per_shard=16), **kw)
        self.port = WindowJoinOperator(TumblingEventTimeWindows.of(1000),
                                       mode=mode, device="cpu", **kw)
        self.ref = JaxJoin(JaxTumbling.of(1000), mode=mode, **kw)

    def left(self, keys, ts, data=None):
        for op in (self.port, self.ref):
            op.process_left(np.asarray(keys), np.asarray(ts), data or {})

    def right(self, keys, ts, data=None):
        for op in (self.port, self.ref):
            op.process_right(np.asarray(keys), np.asarray(ts), data or {})

    def wm(self, w):
        p, j = self.port.advance_watermark(w), self.ref.advance_watermark(w)
        assert_fire_equal(p, j, f"wm {w}")
        assert self.port.late_records == self.ref.late_records
        return {k: np.asarray(v) for k, v in dict(j).items()}


def f32(*xs):
    return np.array(xs, np.float32)


def case_basic_equi_join(mode):
    t = Twin(mode, left_fields=("price",), right_fields=("name",))
    t.left([1, 2], [100, 200], {"price": f32(10.0, 20.0)})
    t.right([2, 3], [300, 400], {"name": f32(7.0, 8.0)})
    f = t.wm(1000)
    assert list(f["key"]) == [2] and list(f["left_price"]) == [20.0]
    assert list(f["right_name"]) == [7.0]


def case_join_counts_multiplicity(mode):
    t = Twin(mode)
    t.left([1, 1, 1], [10, 20, 30])
    t.right([1, 1], [40, 50])
    f = t.wm(1000)
    if mode == "aggregate":
        assert list(f["key"]) == [1]
        assert list(f["left_count"]) == [3] and list(f["right_count"]) == [2]
    else:
        assert list(f["key"]) == [1] * 6


def case_join_no_match_no_output(mode):
    t = Twin(mode)
    t.left([1], [10])
    t.right([2], [20])
    assert len(t.wm(1000)["key"]) == 0


def case_join_windows_isolated(mode):
    t = Twin(mode)
    t.left([1], [500])
    t.right([1], [1500])
    assert len(t.wm(3000)["key"]) == 0


def case_multi_auction_seller_emits_all_pairs(mode):
    t = Twin(mode, left_fields=("age",), right_fields=("reserve",))
    t.left([1], [100], {"age": f32(30.0)})
    t.right([1, 1, 1], [200, 300, 400], {"reserve": f32(5.0, 7.0, 9.0)})
    f = t.wm(1000)
    if mode == "pairs":
        assert sorted(zip(f["left_age"].tolist(),
                          f["right_reserve"].tolist())) == [
            (30.0, 5.0), (30.0, 7.0), (30.0, 9.0)]
    else:
        assert list(f["right_reserve"]) == [9.0]


def case_m_by_n_cross_product(mode):
    t = Twin(mode, left_fields=("a",), right_fields=("b",))
    t.left([7, 7, 9], [10, 20, 30], {"a": f32(1.0, 2.0, 3.0)})
    t.right([7, 7, 7, 9], [40, 50, 60, 70], {"b": f32(10.0, 20.0, 30.0, 40.0)})
    f = t.wm(1000)
    if mode == "pairs":
        got = sorted(zip(f["key"].tolist(), f["left_a"].tolist(),
                         f["right_b"].tolist()))
        assert got == sorted([(7, a, b) for a in (1.0, 2.0)
                              for b in (10.0, 20.0, 30.0)] + [(9, 3.0, 40.0)])


def case_late_record_refires_full_pair_set(mode):
    t = Twin(mode, right_fields=("v",), allowed_lateness_ms=5000)
    t.left([1], [100])
    t.right([1], [200], {"v": f32(5.0)})
    assert len(t.wm(1500)["key"]) == 1
    t.right([1], [300], {"v": f32(9.0)})
    f = t.wm(1500)
    if mode == "pairs":
        assert sorted(f["right_v"].tolist()) == [5.0, 9.0]
    else:
        assert list(f["right_count"]) == [2] and list(f["right_v"]) == [9.0]


def case_late_beyond_lateness_dropped(mode):
    t = Twin(mode, allowed_lateness_ms=500)
    t.left([1, 2], [100, 900])
    t.right([1], [400])
    t.wm(3000)
    t.left([1], [200])   # its window is past the lateness: dropped
    t.right([2], [950])
    assert t.port.late_records == 2
    assert len(t.wm(4000)["key"]) == 0


CASES = {f.__name__[5:]: f for f in (
    case_basic_equi_join, case_join_counts_multiplicity,
    case_join_no_match_no_output, case_join_windows_isolated,
    case_multi_auction_seller_emits_all_pairs, case_m_by_n_cross_product,
    case_late_record_refires_full_pair_set,
    case_late_beyond_lateness_dropped)}


# the pair-expansion cases run in pairs mode only (aggregate mode's
# multi-valued keys are in test_random_batches_fire_the_reference_rows)
PAIRS_ONLY = ("m_by_n_cross_product", "multi_auction_seller_emits_all_pairs")


@pytest.mark.parametrize("case,mode", [
    (c, m) for c in sorted(CASES) for m in MODES
    if m == "pairs" or c not in PAIRS_ONLY])
def test_join_operator_cases(case, mode):
    """TestWindowJoinOperator's and TestWindowJoinPairs' cases: every
    fire equal to the JAX package's in order."""
    CASES[case](mode)


@pytest.mark.parametrize("mode", MODES)
def test_random_batches_fire_the_reference_rows(mode):
    """Eight random batches on each side over 20 keys, 1 s windows with
    1 s lateness, rows up to 3 s late (re-fires and drops): every fire
    equal to the JAX package's, in order."""
    rng = np.random.default_rng(12)
    t = Twin(mode, left_fields=("a",), right_fields=("b",),
             allowed_lateness_ms=1000)
    wmark, rows = 0, 0
    for i in range(8):
        for side in (t.left, t.right):
            n = 48  # one batch shape: the reference compiles per shape
            ts = i * 600 + rng.integers(-3000, 500, n)
            side(rng.integers(0, 20, n).astype(np.int64),
                 np.maximum(ts, 0).astype(np.int64),
                 {"a": rng.integers(0, 99, n).astype(np.float32),
                  "b": rng.integers(0, 99, n).astype(np.float32)})
        wmark = i * 600
        rows += len(t.wm(wmark)["key"])
    rows += len(t.wm(1_000_000)["key"])
    assert rows > 10 and t.port.late_records > 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pair_explosion_refused(pkg, monkeypatch):
    cls = WindowJoinOperator if pkg == "port" else JaxJoin
    monkeypatch.setattr(cls, "MAX_PAIRS_PER_FIRE", 50)
    op = (cls(TumblingEventTimeWindows.of(1000), device="cpu")
          if pkg == "port" else cls(JaxTumbling.of(1000)))
    op.process_left(np.zeros(10, np.int64), np.arange(10), {})
    op.process_right(np.zeros(10, np.int64), np.arange(10), {})
    with pytest.raises(RuntimeError, match="pair explosion"):
        op.advance_watermark(1000)


def test_mode_mismatch_restore_refuses():
    a = WindowJoinOperator(TumblingEventTimeWindows.of(1000), device="cpu")
    b = WindowJoinOperator(TumblingEventTimeWindows.of(1000),
                           mode="aggregate", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        b.restore_state(a.snapshot_state())
    with pytest.raises(ValueError, match="join mode"):
        WindowJoinOperator(TumblingEventTimeWindows.of(1000), mode="x",
                           device="cpu")


@pytest.mark.parametrize("direction", ["port_to_port", "port_to_jax",
                                       "jax_to_port"])
def test_pairs_snapshot_restores_across_packages(direction):
    """test_snapshot_restore_roundtrip, across the packages: the buffered
    rows and the control plane move; the restored operator fires the
    rows of an uninterrupted one."""
    def mk(pkg):
        kw = dict(left_fields=("a",), right_fields=("b",),
                  allowed_lateness_ms=2000)
        return (WindowJoinOperator(TumblingEventTimeWindows.of(1000),
                                   device="cpu", **kw) if pkg == "port"
                else JaxJoin(JaxTumbling.of(1000), **kw))

    def first(op):
        op.process_left(np.array([1, 1, 2]), np.array([100, 200, 1500]),
                        {"a": f32(1.0, 2.0, 3.0)})
        op.process_right(np.array([2]), np.array([1600]), {"b": f32(4.0)})
        op.advance_watermark(1200)

    def rest(op):
        op.process_right(np.array([1, 2]), np.array([300, 1700]),
                         {"b": f32(5.0, 6.0)})
        return {k: np.asarray(v) for k, v in
                dict(op.advance_watermark(2500)).items()}

    straight = mk("jax")
    first(straight)
    want = rest(straight)
    src_pkg, dst_pkg = {"port_to_port": ("port", "port"),
                        "port_to_jax": ("port", "jax"),
                        "jax_to_port": ("jax", "port")}[direction]
    src = mk(src_pkg)
    first(src)
    dst = mk(dst_pkg)
    dst.restore_state(src.snapshot_state())
    got = rest(dst)
    assert_fire_equal(got, want, direction)
    # the late right row re-fires window 1000 (two pairs); window 2000
    assert len(want["key"]) == 4


def test_join_e2e_fluent():
    """test_join_e2e_fluent on the port, in both modes."""
    for mode, want in (("pairs", [(1, 0, 30.0, 5.0), (1, 0, 30.0, 7.0)]),
                       ("aggregate", [(1, 0, 30.0, 7.0)])):
        env = StreamExecutionEnvironment(Configuration({
            "state.num-key-shards": 8, "state.slots-per-shard": 64,
            "pipeline.microbatch-size": 256}))
        persons = env.from_collection(
            {"person": np.array([1, 2, 3], np.int64),
             "age": f32(30.0, 40.0, 50.0)}, np.array([100, 200, 1500]))
        auctions = env.from_collection(
            {"seller": np.array([1, 1, 3], np.int64),
             "reserve": f32(5.0, 7.0, 9.0)}, np.array([150, 250, 2500]))
        sink = (persons.join(auctions).where("person").equal_to("seller")
                .window(TumblingEventTimeWindows.of(1000))
                .apply(left_fields=("age",), right_fields=("reserve",),
                       mode=mode)
                .collect())
        env.execute(device="cpu")
        rows = sorted((int(r["key"]), int(r["window_start"]),
                       float(r["left_age"]), float(r["right_reserve"]))
                      for r in sink.rows)
        assert rows == want, mode


def test_self_join_is_refused():
    env = StreamExecutionEnvironment(Configuration())
    s = env.from_collection({"k": np.arange(4)}, np.arange(4))
    (s.join(s).where("k").equal_to("k")
     .window(TumblingEventTimeWindows.of(1000)).apply().collect())
    with pytest.raises(NotImplementedError, match="self-join"):
        env.execute(device="cpu")


# -- Nexmark Q8 through execute --------------------------------------------------

Q8_CFG = dict(batch_size=1024, n_batches=6, events_per_ms=1,
              num_active_people=300)


def q8_sources(Gen):
    cfg = NexmarkConfig(**Q8_CFG)

    def persons(split, i):
        return (person_batch(cfg, int(split), i)
                if i < cfg.n_batches else None)

    def auctions(split, i):
        return (auction_batch(cfg, int(split), i)
                if i < cfg.n_batches else None)
    return Gen(persons), Gen(auctions)


def run_q8(pkg, mode):
    conf = {"state.num-key-shards": 8, "state.slots-per-shard": 128,
            "pipeline.microbatch-size": Q8_CFG["batch_size"]}
    if pkg == "port":
        env = StreamExecutionEnvironment(Configuration(conf))
        sink = CollectSink()
        q8_monitor_new_users(env, *q8_sources(GeneratorSource), sink,
                             window_ms=1000, out_of_orderness_ms=200,
                             mode=mode)
        env.execute("q8", device="cpu")
    else:
        env = JaxEnv(JaxConfiguration(conf))
        sink = JaxCollectSink()
        p, a = q8_sources(JaxGeneratorSource)
        if mode == "pairs":
            jax_q8(env, p, a, sink, window_ms=1000, out_of_orderness_ms=200)
        else:
            from flink_tpu.time.watermarks import WatermarkStrategy as JW

            wm = JW.for_bounded_out_of_orderness(200)
            (env.from_source(p, wm).join(env.from_source(a, wm))
             .where("person").equal_to("seller")
             .window(JaxTumbling.of(1000))
             .apply(left_fields=("state_id",), right_fields=("reserve",),
                    mode="aggregate")
             .add_sink(sink))
        env.execute("q8")
    return sink.rows


def q8_golden(mode):
    """Per 1 s window: the exact person ⋈ seller pairs (as a sorted list
    of (window_end, person, state_id, reserve)), or per (person, window)
    both sides' counts and the max of each carried field."""
    cfg = NexmarkConfig(**Q8_CFG)
    L = [person_batch(cfg, 0, i) for i in range(cfg.n_batches)]
    R = [auction_batch(cfg, 0, i) for i in range(cfg.n_batches)]
    lk = np.concatenate([d["person"] for d, _ in L])
    lw = np.concatenate([ts // 1000 * 1000 + 1000 for _, ts in L])
    ls = np.concatenate([d["state_id"] for d, _ in L])
    rk = np.concatenate([d["seller"] for d, _ in R])
    rw = np.concatenate([ts // 1000 * 1000 + 1000 for _, ts in R])
    rv = np.concatenate([d["reserve"] for d, _ in R])
    left, right = {}, {}
    for k, w, s in zip(lk.tolist(), lw.tolist(), ls.tolist()):
        left.setdefault((k, w), []).append(s)
    for k, w, v in zip(rk.tolist(), rw.tolist(), rv.tolist()):
        right.setdefault((k, w), []).append(v)
    both = sorted(set(left) & set(right))
    if mode == "pairs":
        return sorted((w, k, s, v) for k, w in both
                      for s in left[(k, w)] for v in right[(k, w)])
    return sorted((w, k, len(left[(k, w)]), max(left[(k, w)]),
                   len(right[(k, w)]), max(right[(k, w)])) for k, w in both)


@pytest.mark.parametrize("mode", MODES)
def test_q8_through_execute(mode):
    """Q8 at a small scale: the port's committed rows equal the JAX
    package's in order, and the golden."""
    got, want = run_q8("port", mode), run_q8("jax", mode)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert all(np.asarray(g[f]) == np.asarray(w[f]) for f in w), (g, w)
    if mode == "pairs":
        view = sorted((int(r["window_end"]), int(r["key"]),
                       int(r["left_state_id"]), float(r["right_reserve"]))
                      for r in got)
    else:
        view = sorted((int(r["window_end"]), int(r["key"]),
                       int(r["left_count"]), int(r["left_state_id"]),
                       int(r["right_count"]), float(r["right_reserve"]))
                      for r in got)
    assert view == q8_golden(mode)


def test_plan_records_the_reference_out_schemas():
    """The lowering's ``out_schema`` of the join (both modes), session and
    windowAll nodes is the JAX package's, field by field."""
    from flink_tpu.api.windowing import EventTimeSessionWindows as JaxSessions
    from flink_tpu.graph.compiler import compile_job as jax_compile
    from flink_tpu.ops import aggregates as ja
    from flink_tpu_torch.api.windowing import EventTimeSessionWindows
    from flink_tpu_torch.graph.compiler import compile_job
    from flink_tpu_torch.ops import aggregates as ta

    def build(env, Tumbling, Sessions, a, Sink):
        cols = {"k": np.arange(4), "v": np.ones(4, np.float32)}
        l = env.from_collection(cols, np.arange(4))
        r = env.from_collection(cols, np.arange(4))
        for mode in MODES:
            (l.join(r).where("k").equal_to("k").window(Tumbling.of(1000))
             .apply(left_fields=("v",), right_fields=("v",), mode=mode)
             .add_sink(Sink()))
        (l.key_by("k").window(Sessions.with_gap(10))
         .aggregate(a.multi(a.count(), a.avg_of("v")), retract=True)
         .add_sink(Sink()))
        l.window_all(Tumbling.of(1000)).max("v").add_sink(Sink())

    env = StreamExecutionEnvironment(Configuration())
    build(env, TumblingEventTimeWindows, EventTimeSessionWindows, ta,
          CollectSink)
    jenv = JaxEnv(JaxConfiguration())
    build(jenv, JaxTumbling, JaxSessions, ja, JaxCollectSink)
    plan = compile_job(env._transforms, env._watermark_strategy)
    jplan = jax_compile(jenv._transforms, jenv.config,
                        jenv._watermark_strategy)

    def schemas(p):
        return sorted((n.kind, sorted(n.out_schema.items()))
                      for n in p.nodes.values()
                      if n.kind in ("join", "session", "window_all"))
    got = schemas(plan)
    assert got == schemas(jplan) and len(got) == 4
