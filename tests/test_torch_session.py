"""The port's session windows (flink_tpu_torch/ops/session.py) against
the JAX package's SessionOperator on the CPU, on the same numpy inputs:
the cases of tests/test_join_session.py's TestSessionOperator and its
fuzz against a brute-force sessionizer, the port at host.parallelism 1
and 4 against the reference's serial rows (its own gate holds them equal
at every parallelism), in retract mode and not, with late records inside
and beyond the lateness;
snapshots within the port and across the packages; and session jobs
through ``execute(device="cpu")``.

Tolerances: keys, window bounds, counts, row order, late counts, op
codes and the f32 max / min lanes must be exactly equal. The f32 sum
lanes must be bit-equal too (a bound of 0 ulps, written before the
first run): both packages lift the same f32 values and add them with
numpy ``reduceat`` in the same order, segment by segment and merge by
merge. An average (a sum divided by its count, XLA's CPU division
against torch's) is held to 1 ulp."""
import numpy as np
import pytest

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import CollectSink as JaxCollectSink
from flink_tpu.api.windowing import EventTimeSessionWindows as JaxSessions
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops.session import SessionOperator as JaxSessionOperator
from flink_tpu.time.watermarks import WatermarkStrategy as JaxWatermarks
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import CollectSink
from flink_tpu_torch.api.windowing import EventTimeSessionWindows
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.session import SessionOperator
from flink_tpu_torch.parallel.hostpool import HostPool
from flink_tpu_torch.records import OP_FIELD
from flink_tpu_torch.time.watermarks import WatermarkStrategy
from test_torch_threads import capped_torch_threads  # noqa: F401

SUM_ULPS = 0   # both packages add with numpy reduceat in one order
AVG_ULPS = 1   # a division of bit-equal sums: XLA CPU against torch


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def assert_rows_equal(got, want, label=""):
    """Fired rows: the same fields in both, each exactly equal, but for
    sums (SUM_ULPS) and averages (AVG_ULPS)."""
    assert set(got) == set(want), (label, set(got) ^ set(want))
    for f in want:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        assert g.shape == w.shape, (label, f)
        if f.startswith("avg_"):
            assert (ulps(g, w) <= AVG_ULPS).all(), (label, f, g, w)
        elif f.startswith("sum_"):
            assert (ulps(g, w) <= SUM_ULPS).all(), (label, f, g, w)
        else:
            assert np.array_equal(g.astype(w.dtype), w), (label, f, g, w)


class Twin:
    """The same session operator in both packages, driven in step: the
    port on a host pool of ``w`` workers, the reference serial (its own
    tests hold its rows equal at every parallelism)."""

    def __init__(self, gap, agg_name, w=1, retract=False, **kw):
        self.pool = HostPool(w) if w > 1 else None
        self.port = SessionOperator(gap, AGGS[agg_name](ta), retract=retract,
                                    host_pool=self.pool, **kw)
        self.ref = JaxSessionOperator(gap, AGGS[agg_name](ja),
                                      retract=retract, **kw)
        self.fired = []

    def batch(self, keys, ts, data=None):
        keys, ts = np.asarray(keys, np.int64), np.asarray(ts, np.int64)
        for op in (self.port, self.ref):
            op.process_batch(keys, ts, dict(data or {}))
        p, j = self.port.take_fired(), self.ref.take_fired()
        assert (p is None) == (j is None)
        if p is not None:
            assert_rows_equal(dict(p), dict(j), "take_fired")
            self.fired.append(("retract", dict(j)))
        assert self.port.late_records == self.ref.late_records

    def wm(self, w):
        p = dict(self.port.advance_watermark(w))
        j = {k: np.asarray(v) for k, v in dict(self.ref.advance_watermark(w)).items()}
        assert_rows_equal(p, j, f"wm {w}")
        self.fired.append(("fire", j))
        return j

    def close(self):
        if self.pool is not None:
            self.pool.close()


AGGS = {
    "count": lambda a: a.count(),
    "sum": lambda a: a.sum_of("v"),
    "lanes": lambda a: a.multi(a.count(), a.sum_of("v"), a.max_of("v"),
                               a.min_of("v"), a.avg_of("v")),
}


def v32(*xs):
    return {"v": np.array(xs, np.float32)}


def case_basic_session_merge(t):
    t.batch([1, 1, 1], [0, 500, 900])
    assert len(t.wm(1898)["key"]) == 0
    f = t.wm(1899)
    assert (list(f["key"]), list(f["window_start"]), list(f["window_end"]),
            list(f["count"])) == ([1], [0], [1900], [3])


def case_gap_splits_sessions(t):
    t.batch([1, 1], [0, 2000])
    f = t.wm(5000)
    assert sorted(zip(f["window_start"].tolist(), f["window_end"].tolist(),
                      f["count"].tolist())) == [(0, 1000, 1), (2000, 3000, 1)]


def case_cross_batch_merge(t):
    t.batch([1], [0], v32(1.0))
    t.batch([1], [800], v32(2.0))
    f = t.wm(2000)
    assert list(f["window_start"]) == [0] and list(f["window_end"]) == [1800]


def case_bridging_merge(t):
    t.batch([1, 1], [0, 1800])
    t.batch([1], [900])
    f = t.wm(4000)
    assert (list(f["window_start"]), list(f["window_end"]),
            list(f["count"])) == ([0], [2800], [3])


def case_late_merge_refires(t):
    t.batch([1], [0])
    assert list(t.wm(1500)["count"]) == [1]
    t.batch([1], [500])
    f = t.wm(1500)
    assert list(f["count"]) == [2] and list(f["window_end"]) == [1500]


def case_late_beyond_lateness_dropped(t):
    t.batch([1], [0])
    t.wm(5000)
    t.batch([1], [100])
    assert t.port.late_records == 1
    assert len(t.wm(6000)["key"]) == 0


def case_late_record_merges_into_retained_session(t):
    t.batch([1, 1], [0, 900])
    assert list(t.wm(6500)["count"]) == [2]
    t.batch([1], [100])
    assert t.port.late_records == 0
    assert list(t.wm(6500)["count"]) == [3]


CASES = {
    "basic_session_merge": (case_basic_session_merge, "count", 0),
    "gap_splits_sessions": (case_gap_splits_sessions, "count", 0),
    "cross_batch_merge": (case_cross_batch_merge, "sum", 0),
    "bridging_merge": (case_bridging_merge, "count", 0),
    "late_merge_refires": (case_late_merge_refires, "count", 5000),
    "late_beyond_lateness_dropped": (case_late_beyond_lateness_dropped,
                                     "count", 0),
    "late_record_merges_into_retained_session": (
        case_late_record_merges_into_retained_session, "count", 5000),
}


@pytest.mark.parametrize("retract", [False, True], ids=["plain", "retract"])
@pytest.mark.parametrize("w", [1, 4], ids=["w1", "w4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_session_operator_cases(case, w, retract):
    """TestSessionOperator's cases, every fire and -U row equal to the
    JAX package's (and to the values the reference's cases assert)."""
    fn, agg, lateness = CASES[case]
    t = Twin(1000, agg, w=w, retract=retract, allowed_lateness_ms=lateness,
             num_shards=8)
    try:
        fn(t)
    finally:
        t.close()
    if retract and case in ("late_merge_refires",
                            "late_record_merges_into_retained_session"):
        # the merge consumed a fired session: -U before the +U re-fire
        kinds = [k for k, _ in t.fired if k == "retract"]
        assert kinds and t.fired[-1][1][OP_FIELD].tolist() == [2]


def brute_sessions(recs, gap):
    by_key = {}
    for k, t in recs:
        by_key.setdefault(k, []).append(t)
    want = []
    for k, tss in by_key.items():
        tss.sort()
        start, last, cnt = tss[0], tss[0], 1
        for t in tss[1:]:
            if t - last > gap:
                want.append((k, start, last + gap, cnt))
                start, last, cnt = t, t, 1
            else:
                last, cnt = t, cnt + 1
        want.append((k, start, last + gap, cnt))
    return sorted(want)


def final_rows(got):
    """Each session's last emission: a (re)fire supersedes the rows of
    its key whose span it covers."""
    final = {}
    for k, s, e, c in got:
        final = {kk: v for kk, v in final.items()
                 if not (kk[0] == k and s <= v[0] < e)}
        final[(k, s, e)] = (s, e, c)
    return sorted((k, s, e, c) for (k, s, e), (_, _, c) in final.items())


@pytest.mark.parametrize("w", [1, 4], ids=["w1", "w4"])
def test_fuzz_vs_bruteforce_reference(w):
    """TestSessionScaleAndFuzz's fuzz: random batches, cross-batch merges,
    bridges and late re-fires; every fire equal to the JAX package's, and
    each session's final emission equal to a brute-force sessionizer."""
    rng = np.random.default_rng(7)
    gap, lateness = 100, 300
    t = Twin(gap, "count", w=w, allowed_lateness_ms=lateness, num_shards=8)
    recs, got, wmark = [], [], 0
    try:
        for _ in range(12):
            b = int(rng.integers(5, 40))
            keys = rng.integers(0, 6, b).astype(np.int64)
            ts = (wmark + rng.integers(0, 400, b)).astype(np.int64)
            recs += list(zip(keys.tolist(), ts.tolist()))
            t.batch(keys, ts)
            wmark += int(rng.integers(50, 250))
            f = t.wm(wmark)
            got += list(zip(*(f[c].tolist() for c in (
                "key", "window_start", "window_end", "count"))))
        f = t.wm(wmark + 10_000)
        got += list(zip(*(f[c].tolist() for c in (
            "key", "window_start", "window_end", "count"))))
        assert t.port.late_records == 0
    finally:
        t.close()
    assert final_rows(got) == brute_sessions(recs, gap)


@pytest.mark.parametrize("retract", [False, True], ids=["plain", "retract"])
@pytest.mark.parametrize("w", [1, 4], ids=["w1", "w4"])
def test_late_records_inside_and_beyond_the_lateness(w, retract):
    """Bursty batches over 50 keys with all five lane kinds, 10 % of the
    records up to 3 s late against a 1 s lateness: some merge into fired
    sessions (re-fires, -U rows in retract mode), some are dropped;
    every step's rows and the late count equal the JAX package's."""
    rng = np.random.default_rng(31)
    t = Twin(150, "lanes", w=w, retract=retract, allowed_lateness_ms=1000,
             num_shards=8)
    try:
        wmark = 0
        for i in range(7):
            keys = rng.integers(0, 50, 300).astype(np.int64)
            ts = i * 400 + rng.integers(0, 500, 300)
            late = rng.random(300) < 0.1
            ts = np.where(late, np.maximum(ts - rng.integers(0, 3000, 300), 0),
                          ts).astype(np.int64)
            v = np.round(rng.normal(50, 30, 300), 2).astype(np.float32)
            t.batch(keys, ts, {"v": v})
            wmark = max(wmark, int(ts.max()) - 300)
            t.wm(wmark)
        t.wm(t.port.final_watermark())
        assert t.port.late_records > 0
        fired = [r for k, r in t.fired if k == "fire" and len(r["key"])]
        assert len(fired) > 2
        if retract:
            assert any(k == "retract" for k, _ in t.fired)
    finally:
        t.close()


def _feed(op, batches):
    for keys, ts, v in batches:
        op.process_batch(keys, ts, {"v": v})


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 30, 200).astype(np.int64),
             (i * 300 + rng.integers(0, 400, 200)).astype(np.int64),
             rng.integers(0, 9, 200).astype(np.float32)) for i in range(n)]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port",
                                       "port_to_port_w4"])
def test_snapshot_restores_within_and_across_packages(direction):
    """Both packages' registries after the same four batches snapshot to
    the same columns; a snapshot restores into the other package (or
    into the port at host.parallelism 4) and, fed the same further
    batches, fires the rows of an uninterrupted run."""
    first, rest = _batches(3, 4), _batches(4, 3)
    agg = AGGS["lanes"]
    straight = JaxSessionOperator(100, agg(ja), allowed_lateness_ms=500)
    _feed(straight, first)
    straight.advance_watermark(600)
    _feed(straight, rest)
    want = {k: np.asarray(v) for k, v in dict(
        straight.advance_watermark(10_000_000)).items()}
    ops = {"port": SessionOperator(100, agg(ta), allowed_lateness_ms=500),
           "jax": JaxSessionOperator(100, agg(ja), allowed_lateness_ms=500)}
    for op in ops.values():
        _feed(op, first)
        op.advance_watermark(600)
    snaps = {k: op.snapshot_state() for k, op in ops.items()}
    assert snaps["port"]["watermark"] == snaps["jax"]["watermark"]
    for c, b in snaps["jax"]["columns"].items():
        a = snaps["port"]["columns"][c]
        assert a.dtype == b.dtype and np.array_equal(a, b), c
    pool = HostPool(4) if direction == "port_to_port_w4" else None
    try:
        dst = (JaxSessionOperator(100, agg(ja), allowed_lateness_ms=500)
               if direction == "port_to_jax" else
               SessionOperator(100, agg(ta), allowed_lateness_ms=500,
                               host_pool=pool))
        dst.restore_state(snaps["jax" if direction == "jax_to_port"
                                else "port"])
        _feed(dst, rest)
        got = {k: np.asarray(v) for k, v in dict(
            dst.advance_watermark(10_000_000)).items()}
    finally:
        if pool is not None:
            pool.close()
    assert_rows_equal(got, want, direction)


PKG = {
    "port": (StreamExecutionEnvironment, Configuration, CollectSink,
             WatermarkStrategy, EventTimeSessionWindows,
             lambda env: env.execute("sessions", device="cpu")),
    "jax": (JaxEnv, JaxConfiguration, JaxCollectSink, JaxWatermarks,
            JaxSessions, lambda env: env.execute("sessions")),
}


_JAX_JOBS = {}


def run_session_job(pkg, w, retract):
    Env, Conf, Sink, WM, Sessions, execute = PKG[pkg]
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 40, 1500).astype(np.int64)
    ts = np.sort(rng.integers(0, 10_000, 1500)).astype(np.int64)
    late = rng.random(1500) < 0.03
    ts = np.where(late, np.maximum(ts - 4000, 0), ts).astype(np.int64)
    env = Env(Conf({"state.num-key-shards": 8, "state.slots-per-shard": 64,
                    "pipeline.microbatch-size": 500,
                    "host.parallelism": w,
                    # the JAX package's analyzer refuses a retract stream
                    # into an append-only sink; the rows are compared here
                    "analysis.fail-on": "off"}))
    sink = Sink()
    (env.from_collection({"k": keys, "v": rng.random(1500).astype(np.float32)},
                         ts)
        .assign_timestamps_and_watermarks(
            WM.for_bounded_out_of_orderness(500))
        .key_by("k")
        .window(Sessions.with_gap(200))
        .allowed_lateness(2000)
        .aggregate(AGGS["lanes"](ta if pkg == "port" else ja),
                   retract=retract)
        .add_sink(sink))
    execute(env)
    return sink.rows


@pytest.mark.parametrize("retract", [False, True], ids=["plain", "retract"])
@pytest.mark.parametrize("w", [1, 4], ids=["w1", "w4"])
def test_session_job_through_execute(w, retract):
    """test_session_e2e_fluent's pipeline at a few thousand records: the
    port's committed rows at host.parallelism w equal the JAX package's
    serial rows, in order (-U rows before their +U re-fires in retract
    mode)."""
    if retract not in _JAX_JOBS:
        _JAX_JOBS[retract] = run_session_job("jax", 1, retract)
    got, want = run_session_job("port", w, retract), _JAX_JOBS[retract]
    assert len(got) == len(want) > 0
    cols = lambda rows: {f: np.array([r[f] for r in rows])  # noqa: E731
                         for f in rows[0]}
    assert_rows_equal(cols(got), cols(want), "execute")
    if retract:
        assert {int(r[OP_FIELD]) for r in got} >= {0, 1, 2}


def test_session_e2e_fluent():
    """tests/test_join_session.py::test_session_e2e_fluent on the port."""
    env = StreamExecutionEnvironment(Configuration({
        "state.num-key-shards": 8, "state.slots-per-shard": 64,
        "pipeline.microbatch-size": 256}))
    sink = (
        env.from_collection({"k": np.array([1, 1, 1, 2, 2], np.int64)},
                            np.array([0, 400, 3000, 100, 5000], np.int64))
        .assign_timestamps_and_watermarks(
            WatermarkStrategy.for_bounded_out_of_orderness(6000))
        .key_by("k")
        .window(EventTimeSessionWindows.with_gap(1000))
        .count()
        .collect())
    env.execute(device="cpu")
    got = sorted((int(r["key"]), int(r["window_start"]), int(r["window_end"]),
                  int(r["count"])) for r in sink.rows)
    assert got == [(1, 0, 1400, 2), (1, 3000, 4000, 1),
                   (2, 100, 1100, 1), (2, 5000, 6000, 1)]


def test_session_refusals():
    with pytest.raises(ValueError, match="gap"):
        SessionOperator(0, ta.count())
    with pytest.raises(TypeError, match="pane"):
        EventTimeSessionWindows.with_gap(100).pane_ms
