"""The DataStream surface of the port — map_with_timestamps, filter,
flat_map, assign_timestamps_and_watermarks (with ``ts_field``), union,
key_by with a key function, print and collect — through
``env.execute(device="cpu")``, against the JAX package running the same
job on the same seeded records (the cases of ``tests/test_pipeline.py``
that use only these transforms, and one each for the rest).

The collected rows must be equal in order: the same fields, the same
values and the same scalar types. Every aggregate here is a count, a
max or a sum of small integers, so every value is exact."""
import types

import numpy as np
import pytest

from flink_tpu.api import sinks as jsinks
from flink_tpu.api import windowing as jw
from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.records import hash_string_key
from flink_tpu.time.watermarks import WatermarkStrategy as JaxWatermarks
from flink_tpu_torch.api import sinks as tsinks
from flink_tpu_torch.api import windowing as tw
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.time.watermarks import WatermarkStrategy
from test_torch_threads import capped_torch_threads  # noqa: F401

JAX = types.SimpleNamespace(w=jw, s=jsinks, Env=JaxEnv, Conf=JaxConfiguration,
                            Wm=JaxWatermarks, exe={})
PORT = types.SimpleNamespace(w=tw, s=tsinks, Env=StreamExecutionEnvironment,
                             Conf=Configuration, Wm=WatermarkStrategy,
                             exe={"device": "cpu"})
CONF = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
        "pipeline.microbatch-size": 256}


def run(m, build):
    env = m.Env(m.Conf(CONF))
    sink = build(m, env)
    env.execute("dataflow", **m.exe)
    return sink.rows


def same_rows(build):
    ref, got = run(JAX, build), run(PORT, build)
    assert len(got) == len(ref) and len(ref) > 0
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k in r:
            assert type(g[k]) is type(r[k]), (k, type(g[k]), type(r[k]))
            assert g[k] == r[k] or (g[k] != g[k] and r[k] != r[k]), k
    return got


SENTENCES = [(0, "to be or not to be"), (500, "that is the question"),
             (1200, "to be is to do"), (1700, "do be do"),
             (2500, "question the question")]


def tokenize(data, ts, valid):
    words, wts = [], []
    for line, t in zip(data["line"], ts):
        for w in line.split():
            words.append(hash_string_key(w))
            wts.append(t)
    return ({"word": np.array(words, np.int64)}, np.array(wts, np.int64),
            np.ones(len(words), bool))


def test_wordcount_through_map_with_timestamps():
    def build(m, env):
        lines = {"line": np.array([s for _, s in SENTENCES], object)}
        ts = np.array([t for t, _ in SENTENCES], np.int64)
        return (env.from_collection(lines, ts)
                .map_with_timestamps(tokenize, name="tokenize")
                .key_by("word").window(m.w.TumblingEventTimeWindows.of(1000))
                .count().collect())

    got = same_rows(build)
    assert sum(int(r["count"]) for r in got) == 21


def seeded(n=400, keys=10, span=5000, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, keys, n).astype(np.int64),
            rng.integers(0, 100, n).astype(np.int64),
            np.sort(rng.integers(0, span, n)).astype(np.int64))


def test_map_filter_chain_and_sum():
    keys, vals, ts = seeded()

    def build(m, env):
        return (env.from_collection({"k": keys, "v": vals}, ts)
                .map(lambda d: {**d, "v2": d["v"] * 2})
                .filter(lambda d: d["v2"] >= 100)
                .key_by("k").window(m.w.TumblingEventTimeWindows.of(1000))
                .sum("v2").collect())

    got = same_rows(build)
    assert sum(float(r["sum_v2"]) for r in got) == float(
        (2 * vals[vals >= 50]).sum())


def test_flat_map_fans_out_and_drops():
    keys, vals, ts = seeded(seed=4)

    def explode(data, ts, valid):
        """Each valid record v times v % 3 (0, 1 or 2 copies)."""
        reps = np.where(valid, data["v"] % 3, 0)
        return ({k: np.repeat(v, reps) for k, v in data.items()},
                np.repeat(ts, reps), np.ones(int(reps.sum()), bool))

    def build(m, env):
        return (env.from_collection({"k": keys, "v": vals}, ts)
                .filter(lambda d: d["k"] != 3)
                .flat_map(explode)
                .key_by("k").window(m.w.TumblingEventTimeWindows.of(1000))
                .count().collect())

    got = same_rows(build)
    assert sum(int(r["count"]) for r in got) == int(
        (vals[keys != 3] % 3).sum())


def test_sliding_window_with_out_of_orderness():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 5, 600).astype(np.int64)
    ts = rng.integers(0, 8000, 600).astype(np.int64)

    def build(m, env):
        return (env.from_collection({"k": keys}, ts)
                .assign_timestamps_and_watermarks(
                    m.Wm.for_bounded_out_of_orderness(8000))
                .key_by("k").window(m.w.SlidingEventTimeWindows.of(2000, 1000))
                .count().collect())

    same_rows(build)


def test_timestamps_from_a_field():
    keys, vals, _ = seeded(seed=5)
    event_ms = np.sort(np.random.default_rng(6).integers(0, 4000, len(keys)))

    def build(m, env):
        return (env.from_collection({"k": keys, "at": event_ms},
                                    np.zeros(len(keys), np.int64))
                .assign_timestamps_and_watermarks(
                    m.Wm.for_bounded_out_of_orderness(0), ts_field="at")
                .key_by("k").window(m.w.TumblingEventTimeWindows.of(1000))
                .count().collect())

    got = same_rows(build)
    assert {int(r["window_start"]) for r in got} == {0, 1000, 2000, 3000}


def test_two_stage_windowing_with_a_key_function():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 20, 800).astype(np.int64)
    ts = np.sort(rng.integers(0, 4000, 800)).astype(np.int64)

    def build(m, env):
        counts = (env.from_collection({"k": keys}, ts).key_by("k")
                  .window(m.w.TumblingEventTimeWindows.of(1000)).count())
        return (counts
                .map(lambda d: {"wstart": d["window_start"], "cnt": d["count"]})
                .key_by(lambda d: np.asarray(d["wstart"], np.int64) // 1000)
                .window(m.w.TumblingEventTimeWindows.of(1000))
                .max("cnt").collect())

    got = same_rows(build)
    assert [int(r["key"]) for r in got] == [0, 1, 2, 3]


def test_union():
    def build(m, env):
        a = env.from_collection({"k": np.array([1, 1], np.int64)},
                                np.array([100, 200], np.int64))
        b = env.from_collection({"k": np.array([1, 2], np.int64)},
                                np.array([300, 1500], np.int64))
        c = env.from_collection({"k": np.array([2], np.int64)},
                                np.array([1700], np.int64))
        return (a.union(b, c).key_by("k")
                .window(m.w.TumblingEventTimeWindows.of(1000))
                .count().collect())

    got = same_rows(build)
    assert {(int(r["key"]), int(r["window_start"])): int(r["count"])
            for r in got} == {(1, 0): 3, (2, 1000): 2}


def test_print_and_collect(capsys):
    def build(m, env):
        s = (env.from_collection({"k": np.array([4, 4, 9], np.int64)},
                                 np.array([10, 20, 30], np.int64))
             .key_by("k").window(m.w.TumblingEventTimeWindows.of(1000))
             .count())
        s.print(prefix="row> ", limit=1)
        return s.collect()

    capsys.readouterr()
    run(JAX, build)
    ref = capsys.readouterr().out
    got_rows = run(PORT, build)
    got = capsys.readouterr().out
    assert got == ref and got.startswith("row> {") and got.count("\n") == 1
    assert [int(r["count"]) for r in got_rows] == [2, 1]


def test_two_key_functions_off_one_stream_keep_their_own_columns():
    """Each keyBy by a function writes a column of its own, in a chain
    step of its own when the stream has other consumers."""
    from flink_tpu_torch.graph.compiler import compile_job

    env = StreamExecutionEnvironment(Configuration(CONF))
    s = env.from_collection({"k": np.arange(4, dtype=np.int64)},
                            np.arange(4, dtype=np.int64))
    ka, kb = s.key_by(lambda d: d["k"] % 2), s.key_by(lambda d: d["k"] % 3)
    assert ka.transform.key_field != kb.transform.key_field
    a = ka.window(tw.TumblingEventTimeWindows.of(1000)).count()
    b = kb.window(tw.TumblingEventTimeWindows.of(1000)).count()
    a.union(b).collect()
    plan = compile_job(env._transforms, env._watermark_strategy)
    chains = [n for n in plan.nodes.values() if n.name == "key_extract"]
    windows = [n for n in plan.nodes.values() if n.kind == "window"]
    assert len(chains) == 2 and len(windows) == 2
    assert {w.key_field for w in windows} == {ka.transform.key_field,
                                              kb.transform.key_field}
    data = {"k": np.arange(4, dtype=np.int64)}
    out = [c.fns[0](data, None, None)[0] for c in chains]
    assert sorted(sorted(set(o) - {"k"}) for o in out) == sorted(
        [[ka.transform.key_field], [kb.transform.key_field]])


@pytest.mark.parametrize("kind", ["filter", "flatmap"])
def test_chain_kinds(kind):
    from flink_tpu_torch.graph.transformations import MapTransformation

    env = StreamExecutionEnvironment(Configuration(CONF))
    s = env.from_collection({"k": np.array([1], np.int64)},
                            np.array([0], np.int64))
    s = (s.filter(lambda d: d["k"] > 0) if kind == "filter"
         else s.flat_map(lambda d, t, v: (d, t, v)))
    assert isinstance(s.transform, MapTransformation)
    assert s.transform.kind == kind
