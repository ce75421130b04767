"""Count windows: the port's ``CountWindowOperator`` and
``count_window(n)`` jobs through ``env.execute(device="cpu")``, against
the JAX package fed the same batches (made from a seed with numpy).

Every fired batch must be equal in order: keys, counts, window bounds,
dtypes, integer fields and the max/min fields exactly (bit for bit, NaN
and signed zeros included). The sum and avg fields come from the same
record-order fold of one column and the same f32 finalize on both
sides, so they are expected to be equal too; they are held to
|port - ref| <= (2 * count + 34) * 2^-24 * |ref|, the bound of the
window-aggregate slice, written here before the first run.

By default both packages key through their C tables; the
``numpy_host_paths`` fixture gives both their numpy tables. Both
allocate slots alike, so fired rows (ascending slot order) line up."""
import numpy as np
import pytest
import torch

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import CollectSink as JaxCollectSink
from flink_tpu.api.sources import GeneratorSource as JaxGeneratorSource
from flink_tpu.api.windowing import TumblingEventTimeWindows as JaxTumbling
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops.count_window import (
    GLOBAL_WINDOW_END as JAX_GLOBAL_END,
    CountWindowOperator as JaxCountWindowOperator,
)
from flink_tpu.time.watermarks import WatermarkStrategy as JaxWatermarks
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import CollectSink
from flink_tpu_torch.api.sources import GeneratorSource
from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.kernels import count_window_kernels as cwk
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.count_window import (
    GLOBAL_WINDOW_END,
    CountWindowOperator,
)
from flink_tpu_torch.time.watermarks import WatermarkStrategy
from test_torch_threads import capped_torch_threads  # noqa: F401

U = 2.0 ** -24

AGGS = {
    "count": lambda m: m.count(),
    "sum": lambda m: m.sum_of("w"),
    "max": lambda m: m.max_of("v"),
    "min": lambda m: m.min_of("v"),
    "avg": lambda m: m.avg_of("p"),
    "multi": lambda m: m.multi(m.count("n"), m.sum_of("p"), m.max_of("v"),
                               m.min_of("v"), m.avg_of("w")),
}


@pytest.fixture
def numpy_host_paths(monkeypatch):
    """Both packages key through their numpy tables."""
    from flink_tpu import native_codec
    from flink_tpu_torch import native_codec as port_native_codec

    for mod in (native_codec, port_native_codec):
        monkeypatch.setattr(mod.NativeHashTable, "create",
                            classmethod(lambda cls, capacity_hint=1024: None))


def assert_fired_equal(got, ref):
    """One fired batch of each package, equal in order under the module's
    rules."""
    assert list(got) == list(ref)
    n = len(ref["key"])
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype, k
        assert g.shape == r.shape == (n,), k
        if k.startswith(("sum", "avg")):
            bound = (2 * np.asarray(ref["count"], np.float64) + 34) * U \
                * np.abs(r.astype(np.float64))
            assert (np.abs(g.astype(np.float64) - r) <= bound).all(), k
        elif g.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32), r.view(np.int32),
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


def make_pair(agg, size, purge):
    kw = dict(purge=purge, num_shards=4, slots_per_shard=32)
    return (JaxCountWindowOperator(AGGS[agg](ja), size, **kw),
            CountWindowOperator(AGGS[agg](ta), size, device="cpu", **kw))


def record_batch(rng, n, n_keys, hot=0):
    """``n`` records over ``n_keys`` keys (``hot`` of them on key 3),
    with an int field ``w``, a positive float field ``p`` and a float
    field ``v`` carrying NaN, -0 and +0."""
    keys = rng.integers(0, n_keys, n).astype(np.int64) * 7919 + 11
    keys[:hot] = 3
    rng.shuffle(keys)
    v = rng.normal(0.0, 100.0, n).astype(np.float32)
    special = rng.random(n)
    v[special < 0.05] = np.nan
    v[(special >= 0.05) & (special < 0.15)] = -0.0
    v[(special >= 0.15) & (special < 0.25)] = 0.0
    return keys, {"w": rng.integers(-50, 1000, n).astype(np.int64),
                  "p": np.round(np.exp(rng.normal(4.0, 1.0, n)),
                                2).astype(np.float32),
                  "v": v}


def batches(seed):
    """Batch size 1 (exact per-record semantics), batches where the hot
    key crosses the size several times, and batches with invalid rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(7):
        keys, data = record_batch(rng, 1, 5)
        out.append((keys, data, None))
    for n, hot in ((64, 20), (48, 0), (64, 31), (1, 0), (33, 9)):
        keys, data = record_batch(rng, n, 30, hot)
        valid = rng.random(n) < 0.85 if n > 1 else None
        out.append((keys, data, valid))
    return out


def drive(ref, port, steps):
    """Feed both operators, comparing every batch's fires; returns the
    number of fired rows."""
    n_rows = 0
    for keys, data, valid in steps:
        ts = np.zeros(len(keys), np.int64)
        ref.process_batch(keys, ts, data, valid)
        port.process_batch(keys, ts, data, valid)
        got, want = port.take_fired(), ref.take_fired()
        assert port.take_fired() is None and ref.take_fired() is None
        got, want = dict(got), dict(want)
        assert_fired_equal(got, want)
        n_rows += len(want["key"])
    return n_rows


def assert_state_equal(ref, port):
    want = [np.asarray(a) for a in ref.snapshot_state()["arrays"]]
    got = [a.numpy() for a in port.snapshot_state()["arrays"]]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("purge", [True, False])
@pytest.mark.parametrize("agg", list(AGGS))
def test_operator_matches_reference(agg, purge):
    ref, port = make_pair(agg, 3, purge)
    n_rows = drive(ref, port, batches(list(AGGS).index(agg) * 2 + purge))
    assert n_rows > 10
    assert_state_equal(ref, port)


@pytest.mark.parametrize("agg", ["count", "multi"])
def test_operator_matches_reference_numpy_tables(numpy_host_paths, agg):
    ref, port = make_pair(agg, 4, True)
    assert not port.directory.native()
    drive(ref, port, batches(5))
    assert_state_equal(ref, port)


def test_batched_crossing_fires_once_with_full_aggregate():
    """2N and more records of one key in one batch: one fire, count and
    sum over the whole batch; a second batch below N fires nothing."""
    _, port = make_pair("sum", 3, True)
    port.process_batch(np.zeros(7, np.int64), np.zeros(7, np.int64),
                       {"w": np.arange(1, 8, dtype=np.int64)})
    fired = dict(port.take_fired())
    assert fired["key"].tolist() == [0] and fired["count"].tolist() == [7]
    assert fired["sum_w"].tolist() == [28.0]
    assert fired["window_end"].tolist() == [GLOBAL_WINDOW_END]
    assert GLOBAL_WINDOW_END == JAX_GLOBAL_END
    port.process_batch(np.zeros(2, np.int64), np.zeros(2, np.int64),
                       {"w": np.ones(2, np.int64)})
    assert len(dict(port.take_fired())["key"]) == 0


def test_non_purging_keeps_lanes_and_restarts_the_trigger():
    _, port = make_pair("sum", 2, False)
    for vals in ([1, 2], [3, 4], [5]):
        port.process_batch(np.zeros(len(vals), np.int64),
                           np.zeros(len(vals), np.int64),
                           {"w": np.array(vals, np.int64)})
    fired = dict(port.take_fired())
    assert fired["sum_w"].tolist() == [3.0, 10.0]
    assert fired["count"].tolist() == [2, 4]
    arrays = port.snapshot_state()["arrays"]
    assert arrays[3].tolist()[0] == 5 and arrays[4].tolist()[0] == 1


@pytest.mark.parametrize("purge", [True, False])
def test_snapshot_restore_mid_run(purge):
    steps = batches(11)
    ref, port = make_pair("multi", 3, purge)
    drive(ref, port, steps[:9])
    snap = port.snapshot_state()
    _, twin = make_pair("multi", 3, purge)
    twin.restore_state(snap)
    assert drive(ref, twin, steps[9:]) > 0
    assert_state_equal(ref, twin)


@pytest.mark.parametrize("purge", [True, False])
def test_load_jax_snapshot_continues_to_the_reference_rows(purge):
    steps = batches(12)
    ref, port = make_pair("multi", 3, purge)
    for keys, data, valid in steps[:9]:
        ref.process_batch(keys, np.zeros(len(keys), np.int64), data, valid)
    ref.take_fired()
    snap = dict(ref.snapshot_state())
    snap["arrays"] = tuple(np.asarray(a) for a in snap["arrays"])
    port.load_jax_snapshot(snap)
    assert_state_equal(ref, port)
    assert drive(ref, port, steps[9:]) > 0


def test_restore_refuses_a_foreign_layout():
    ref, _ = make_pair("sum", 3, True)
    ref.process_batch(np.array([4, 4], np.int64), np.zeros(2, np.int64),
                      {"w": np.ones(2, np.int64)})
    snap = dict(ref.snapshot_state())
    snap["arrays"] = tuple(np.asarray(a) for a in snap["arrays"])
    _, other = make_pair("max", 3, True)
    with pytest.raises(ValueError, match="snapshot lane"):
        other.load_jax_snapshot(snap)
    since = snap["arrays"][4].copy()
    since[0] += 1
    snap["arrays"] = snap["arrays"][:4] + (since,)
    _, same = make_pair("sum", 3, True)
    with pytest.raises(ValueError, match="trigger count"):
        same.load_jax_snapshot(snap)


def test_event_time_plays_no_part():
    _, port = make_pair("count", 2, True)
    port.process_batch(np.array([1], np.int64), np.array([5], np.int64), {})
    fired = dict(port.advance_watermark(10_000))
    assert len(fired["key"]) == 0 and fired["count"].dtype == np.int32
    assert port.final_watermark() == 10_000
    assert len(dict(port.take_fired())["key"]) == 0


def test_count_fire_plain_on_a_state_made_by_hand():
    """The plain version on a state made by hand: fired rows ascending,
    the dump row never fires, purge resets every lane, the buffer
    carries the lanes' bits."""
    rows = 9
    counts = torch.tensor([3, 0, 5, 2, 3, 1, 9, 0, 7], dtype=torch.int32)
    sums = torch.arange(rows * 2, dtype=torch.float32).reshape(rows, 2)
    maxs = torch.full((rows, 1), -0.0)
    buf = cwk.count_fire(counts, None, sums, maxs, None, 3, 8)
    assert buf[0].tolist() == [4, 0, 0, 0, 0]
    assert buf[1:5, 0].tolist() == [0, 2, 4, 6]
    assert buf[1:5, 1].tolist() == [3, 5, 3, 9]
    assert buf[1:5, 2:4].contiguous().view(torch.float32).tolist() == [
        [0.0, 1.0], [4.0, 5.0], [8.0, 9.0], [12.0, 13.0]]
    assert buf[1, 4].item() == np.float32(-0.0).view(np.int32)
    assert counts.tolist() == [0, 0, 0, 2, 0, 1, 0, 0, 7]
    assert sums[0].tolist() == [0.0, 0.0] and maxs[2].item() == -np.inf
    with pytest.raises(IndexError, match="count_fire"):
        cwk.count_fire(torch.full((rows,), 5, dtype=torch.int32), None,
                       None, None, None, 3, 4)
    assert wk.LAUNCHES["count_fire"] == 0


def test_count_fire_is_one_lookback_launch():
    """The count-window fire compacts in one launch on lookback.cuh's
    decoupled look-back: its source includes it, and no source includes
    the two-launch compact.cuh, which is gone."""
    import os

    csrc = os.path.join(os.path.dirname(cwk.__file__), "csrc")
    with open(os.path.join(csrc, "count_window_kernels.cu")) as f:
        cu = f.read()
    assert '#include "lookback.cuh"' in cu
    assert cu.count("<<<") == 1 and "lookback_exclusive" in cu
    assert not os.path.exists(os.path.join(csrc, "compact.cuh"))
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            assert "compact.cuh" not in f.read(), name


# -- jobs through env.execute -------------------------------------------------

def _conf(cls):
    return cls({"state.num-key-shards": 4, "state.slots-per-shard": 32,
                "pipeline.microbatch-size": 64})


def single_record_source(keys, values):
    def gen(split, i):
        if i >= len(keys):
            return None
        return ({"k": np.array([keys[i]], np.int64),
                 "v": np.array([values[i]], np.int64)},
                np.array([i * 10], np.int64))
    return gen


def one_batch_source(split, i):
    if i >= 1:
        return None
    return ({"k": np.zeros(7, np.int64), "v": np.arange(1, 8, dtype=np.int64)},
            np.arange(7, dtype=np.int64) * 10)


def window_counts_source(split, i):
    if i >= 6:
        return None
    return ({"k": np.array([1, 1, 2], np.int64)},
            np.full(3, i * 1000 + 500, np.int64))


def random_source(split, i):
    if i >= 12:
        return None
    keys, data = record_batch(np.random.default_rng(100 + i), 64, 25, hot=8)
    return ({"k": keys, **data}, np.arange(64, dtype=np.int64) + 64 * i)


JOBS = {
    "every_n": (lambda: single_record_source(
        [7, 7, 9, 7, 9, 9, 7, 7, 7], [1, 2, 10, 3, 20, 30, 4, 5, 6]),
        lambda s, m: s.key_by("k").count_window(3).sum("v")),
    "incomplete": (lambda: single_record_source([1, 1, 2], [5, 6, 7]),
                   lambda s, m: s.key_by("k").count_window(3).count()),
    "batched_crossing": (lambda: one_batch_source,
                         lambda s, m: s.key_by("k").count_window(3).sum("v")),
    "downstream_of_time_window": (
        lambda: window_counts_source,
        lambda s, m: s.key_by("k").window(m.of(1_000)).count()
        .key_by("key").count_window(3).sum("count")),
    "lanes": (lambda: random_source,
              lambda s, m: s.key_by("k").count_window(5).aggregate(
                  m.aggs.multi(m.aggs.count(), m.aggs.sum_of("p"),
                               m.aggs.max_of("v"), m.aggs.min_of("v")))),
}


class _JaxSide:
    of = JaxTumbling.of
    aggs = ja


class _PortSide:
    of = TumblingEventTimeWindows.of
    aggs = ta


def run_job(name, port):
    make_gen, build = JOBS[name]
    if port:
        env, sink = StreamExecutionEnvironment(_conf(Configuration)), \
            CollectSink()
        src, wm, side = (GeneratorSource(make_gen()),
                         WatermarkStrategy.for_monotonous_timestamps(),
                         _PortSide)
    else:
        env, sink = JaxEnv(_conf(JaxConfiguration)), JaxCollectSink()
        src, wm, side = (JaxGeneratorSource(make_gen()),
                         JaxWatermarks.for_monotonous_timestamps(), _JaxSide)
    build(env.from_source(src, wm), side).add_sink(sink)
    if port:
        env.execute(name, device="cpu")
    else:
        env.execute(name)
    return sink.rows


@pytest.mark.parametrize("name", list(JOBS))
def test_jobs_match_reference(name):
    got, want = run_job(name, True), run_job(name, False)
    assert len(got) == len(want)
    if name == "incomplete":
        assert got == []
        return
    assert all(list(g) == list(w) for g, w in zip(got, want))
    assert_fired_equal({k: np.array([r[k] for r in got]) for k in got[0]},
                       {k: np.array([r[k] for r in want]) for k in want[0]})
    if name == "every_n":
        assert [(int(r["key"]), float(r["sum_v"]), int(r["count"]))
                for r in got] == [(7, 6.0, 3), (9, 60.0, 3), (7, 15.0, 3)]
