"""The port's shared host worker pool (flink_tpu_torch/parallel/
hostpool.py) against the JAX package's, on the CPU: the pool's
lifecycle, ordering and fault-seam contract, and the determinism gate —
the sessions, windowAll and spill pipelines commit byte-identical rows
(fields, dtypes, values, order) at host.parallelism 1, 2 and 4, and
those rows are the JAX package's at each. The aggregates are the exact
lane monoids (count, max, integer-valued sums below 2**24), so every
comparison here is exact: no ulp bound applies. Cases ported from
tests/test_hostpool.py."""
import os
import threading
import time

import numpy as np
import pytest

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import FnSink as JaxFnSink
from flink_tpu.api.sources import GeneratorSource as JaxGeneratorSource
from flink_tpu.api.windowing import (
    EventTimeSessionWindows as JaxSessions,
    TumblingEventTimeWindows as JaxTumbling,
)
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops.session import SessionOperator as JaxSessionOperator
from flink_tpu.parallel.hostpool import HostPool as JaxHostPool
from flink_tpu.time.watermarks import WatermarkStrategy as JaxWatermarks
from flink_tpu_torch import faults
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import FnSink
from flink_tpu_torch.api.sources import GeneratorSource
from flink_tpu_torch.api.windowing import (
    EventTimeSessionWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.config import (
    Configuration, HostOptions, default_host_parallelism)
from flink_tpu_torch.obs.metrics import MetricRegistry
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.session import SessionOperator
from flink_tpu_torch.parallel.hostpool import HostPool
from flink_tpu_torch.state.spill import HostSpillStore
from flink_tpu_torch.time.watermarks import WatermarkStrategy
from test_torch_threads import capped_torch_threads  # noqa: F401

PARALLELISMS = (1, 2, 4)


# -- the pool's unit contract ---------------------------------------------------

def test_parallelism_one_is_inline_and_threadless():
    pool = HostPool(1)
    assert pool._executor is None
    tids = []
    out = pool.run_tasks(
        [lambda i=i: (tids.append(threading.get_ident()), i)[1]
         for i in range(5)])
    assert out == [0, 1, 2, 3, 4]
    assert set(tids) == {threading.get_ident()}
    pool.close()


def test_results_in_submission_order():
    pool = HostPool(4)
    try:
        def task(i):
            time.sleep(0.02 * (4 - i % 5))  # finish out of order
            return i
        assert pool.run_tasks(
            [lambda i=i: task(i) for i in range(16)]) == list(range(16))
    finally:
        pool.close()


def test_first_exception_by_index_propagates():
    pool = HostPool(4)
    try:
        def task(i):
            if i in (3, 7):
                raise ValueError(f"boom-{i}")
            return i
        with pytest.raises(ValueError, match="boom-3"):
            pool.run_tasks([lambda i=i: task(i) for i in range(10)])
    finally:
        pool.close()


def test_close_degrades_to_inline():
    pool = HostPool(4)
    pool.close()
    assert pool.run_tasks([lambda: 1, lambda: 2]) == [1, 2]


@pytest.mark.parametrize("pool_cls", [HostPool, JaxHostPool],
                         ids=["port", "jax"])
def test_parallelism_below_one_rejected(pool_cls):
    with pytest.raises(ValueError, match="host.parallelism"):
        pool_cls(0)


def test_from_config_default_is_min_4_cores():
    from flink_tpu.config import HostOptions as JaxHostOptions

    pool = HostPool.from_config(Configuration())
    try:
        assert pool.parallelism == default_host_parallelism()
        assert pool.parallelism == min(4, os.cpu_count() or 1)
        assert pool.parallelism == JaxConfiguration().get(
            JaxHostOptions.PARALLELISM)
    finally:
        pool.close()
    assert (Configuration().get(HostOptions.FOLD_CHUNK_RECORDS)
            == JaxConfiguration().get(JaxHostOptions.FOLD_CHUNK_RECORDS)
            == 1 << 18)


def test_per_task_metrics():
    reg = MetricRegistry()
    pool = HostPool(2, registry=reg)
    try:
        pool.run_tasks([lambda: None] * 7)
    finally:
        pool.close()
    snap = reg.snapshot()
    assert snap["hostpool.tasks_total"] == 7
    assert snap["hostpool.task_ms.count"] == 7
    assert snap["hostpool.parallelism"] == 2.0


@pytest.mark.parametrize("w", [1, 4])
def test_fault_point_registered_and_fires_at_submit(w):
    """The seam behaves the same at any width: the third submission
    raises, tagged as injected, and no earlier task is left running."""
    assert "host.pool.task" in faults.KNOWN_FAULT_POINTS
    pool = HostPool(w)
    ran = []
    plan = faults.FaultPlan(seed=0).rule(
        "host.pool.task", "raise", count=1, after=2)
    try:
        with plan.activate():
            with pytest.raises(RuntimeError) as ei:
                pool.run_tasks([lambda i=i: ran.append(i)
                                for i in range(6)])
        assert faults.is_injected(ei.value)
        assert sorted(ran) == [0, 1]
    finally:
        pool.close()


# -- the serial / parallel determinism gate, against the reference ---------------

def collect_ordered(env, execute):
    """Run the pipeline built on ``env`` and return its sink's batches as
    one field -> array dict, in delivery order."""
    execute(env)
    batches = env._batches
    assert batches, "the gate must compare real output"
    return {k: np.concatenate([np.asarray(b[k]) for b in batches])
            for k in batches[0]}


def assert_byte_identical(ref, got, label):
    assert set(ref) == set(got), label
    for k in ref:
        assert ref[k].dtype == got[k].dtype, (label, k)
        assert np.array_equal(ref[k], got[k]), (label, k)
        assert len(ref[k])


PKGS = {
    "port": dict(Env=StreamExecutionEnvironment, Conf=Configuration,
                 Gen=GeneratorSource, Sink=FnSink, WM=WatermarkStrategy,
                 Tumbling=TumblingEventTimeWindows,
                 Sessions=EventTimeSessionWindows, agg=ta,
                 execute=lambda env: env.execute("pool", device="cpu")),
    "jax": dict(Env=JaxEnv, Conf=JaxConfiguration, Gen=JaxGeneratorSource,
                Sink=JaxFnSink, WM=JaxWatermarks, Tumbling=JaxTumbling,
                Sessions=JaxSessions, agg=ja,
                execute=lambda env: env.execute("pool")),
}


def _env(P, conf):
    env = P["Env"](P["Conf"](conf))
    env._batches = []
    sink = P["Sink"](lambda b: env._batches.append(
        {k: np.asarray(v).copy() for k, v in b.items()}))
    return env, sink


def sessions_job(P, w):
    """The sessions shape (bench config #4): bursty users, gap sessions,
    allowed lateness, ~5 % late records — merges, re-fires, drops beyond
    the lateness and expiry on every shard."""
    def gen(split, i):
        if i >= 6:
            return None
        rng = np.random.default_rng(11 + i)
        user = rng.integers(0, 300, 4096).astype(np.int64)
        ts = i * 512 + rng.integers(0, 700, 4096)
        late = rng.random(4096) < 0.05
        ts = np.where(late, np.maximum(ts - 2500, 0), ts).astype(np.int64)
        return ({"user": user}, ts)

    env, sink = _env(P, {"state.num-key-shards": 8,
                         "state.slots-per-shard": 64,
                         "pipeline.microbatch-size": 4096,
                         "host.parallelism": w})
    (env.from_source(P["Gen"](gen), P["WM"].for_bounded_out_of_orderness(800))
        .key_by("user")
        .window(P["Sessions"].with_gap(150))
        .allowed_lateness(3000)
        .count()
        .add_sink(sink))
    return env


def window_all_job(P, w, which):
    """The windowAll shape (Q7) with the tree fold's floor lowered, so
    the chunked fold runs on test-sized batches."""
    def gen(split, i):
        if i >= 6:
            return None
        rng = np.random.default_rng(23 + i)
        return ({"v": rng.integers(1, 100, 8192).astype(np.int64)},
                np.sort(rng.integers(i * 700, i * 700 + 1400,
                                     8192)).astype(np.int64))

    env, sink = _env(P, {"pipeline.microbatch-size": 8192,
                         "host.parallelism": w,
                         "host.fold-chunk-records": 2048})
    s = (env.from_source(P["Gen"](gen), P["WM"].for_bounded_out_of_orderness(800))
         .window_all(P["Tumbling"].of(1000)))
    a = P["agg"]
    (s.max("v") if which == "max"
     else s.aggregate(a.multi(a.sum_of("v"), a.count()))).add_sink(sink)
    return env


def spill_job(P, w):
    """The spill shape: 1600 keys into 32 resident slots, every batch
    overflowing into the host store's pane merges."""
    def gen(split, i):
        if i >= 6:
            return None
        rng = np.random.default_rng(42 + i)
        return ({"k": rng.integers(0, 1600, 512).astype(np.int64),
                 "v": rng.integers(1, 100, 512).astype(np.int64)},
                np.sort(rng.integers(i * 700, i * 700 + 1400,
                                     512)).astype(np.int64))

    env, sink = _env(P, {"state.num-key-shards": 8,
                         "state.slots-per-shard": 4,
                         "state.backend": "spill",
                         "pipeline.microbatch-size": 512,
                         "host.parallelism": w})
    (env.from_source(P["Gen"](gen), P["WM"].for_bounded_out_of_orderness(800))
        .key_by("k")
        .window(P["Tumbling"].of(1000))
        .count()
        .add_sink(sink))
    return env


JOBS = {
    "sessions": sessions_job,
    "window_all_max": lambda P, w: window_all_job(P, w, "max"),
    "window_all_int_sum": lambda P, w: window_all_job(P, w, "sum"),
    "spill": spill_job,
}

_REF = {}


def reference_rows(job):
    """The JAX package's rows at parallelism 1 (its own gate holds them
    equal at 2 and 4)."""
    if job not in _REF:
        P = PKGS["jax"]
        _REF[job] = collect_ordered(JOBS[job](P, 1), P["execute"])
    return _REF[job]


@pytest.mark.parametrize("w", PARALLELISMS)
@pytest.mark.parametrize("job", sorted(JOBS))
def test_parallel_rows_are_serial_and_reference_bytes(job, w):
    """TestSerialParallelParity: the port's rows at host.parallelism w
    equal the JAX package's serial rows byte for byte (so the port's are
    the same at every w). windowAll's int sums ride the chunked tree
    fold, whose tree differs from the serial one: integer-valued f32
    sums below 2**24 are exact in any order."""
    P = PKGS["port"]
    got = collect_ordered(JOBS[job](P, w), P["execute"])
    assert_byte_identical(reference_rows(job), got, f"{job} w={w}")


@pytest.mark.parametrize("w", PARALLELISMS)
def test_spill_tree_fold_bytes_at_every_parallelism(w):
    """The spill store's chunked tree fold (chunks of 500 records, a
    pool of w) against the JAX store's at the same w: the same panes
    and the same fired bytes, f32 sums included (integer values)."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 300, 4000).astype(np.int64)
    panes = rng.integers(0, 6, 4000).astype(np.int64)
    v = rng.integers(-50, 50, 4000).astype(np.float32)
    out = []
    for store_cls, pool_cls, a in ((HostSpillStore, HostPool, ta),
                                   (None, JaxHostPool, ja)):
        if store_cls is None:
            from flink_tpu.state.spill import HostSpillStore as store_cls
        pool = pool_cls(w)
        try:
            st = store_cls(a.multi(a.count(), a.sum_of("v"), a.max_of("v"),
                                   a.min_of("v")),
                           pool=pool, fold_chunk_records=500)
            for lo in range(0, 4000, 2000):
                st.absorb(keys[lo:lo + 2000], panes[lo:lo + 2000],
                          {"v": v[lo:lo + 2000]})
            out.append((st.snapshot(), st.fire([2, 4, 6], 2, 1000, 0, 2000)))
        finally:
            pool.close()
    (psnap, pfire), (jsnap, jfire) = out
    assert sorted(psnap["panes"]) == sorted(jsnap["panes"])
    for p, arrs in jsnap["panes"].items():
        for a, b in zip(psnap["panes"][p], arrs):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert list(pfire) == list(jfire)
    for f in jfire:
        assert np.asarray(pfire[f]).tobytes() == np.asarray(jfire[f]).tobytes()


# -- snapshots across parallelism ---------------------------------------------------

def _feed(op):
    rng = np.random.default_rng(7)
    for i in range(4):
        keys = rng.integers(0, 40, 512)
        ts = i * 300 + rng.integers(0, 400, 512)
        op.process_batch(keys, ts, {})
    return op


def _fire_all(op):
    f = op.advance_watermark(10_000_000)
    return {k: np.asarray(v) for k, v in dict(f).items()}


@pytest.mark.parametrize("direction", ["serial_to_parallel",
                                       "parallel_to_serial"])
def test_snapshot_restores_across_parallelism(direction):
    """TestSnapshotAcrossParallelism: the registry snapshots as one
    (key, start)-sorted block, so a snapshot of one host.parallelism
    restores at another and fires the rows of an uninterrupted serial
    run, which are the JAX package's."""
    agg = ta.count()
    pool = HostPool(4)
    try:
        def mk(par):
            return SessionOperator(gap_ms=100, agg=agg,
                                   allowed_lateness_ms=500,
                                   host_pool=pool if par else None)
        src_par = direction == "parallel_to_serial"
        snap = _feed(mk(src_par)).snapshot_state()
        dst = mk(not src_par)
        dst.restore_state(snap)
        assert len(dst._shards) == (1 if src_par else 4)
        got = _fire_all(dst)
    finally:
        pool.close()
    ref = _fire_all(_feed(JaxSessionOperator(
        gap_ms=100, agg=ja.count(), allowed_lateness_ms=500)))
    assert set(got) == set(ref)
    for k in ref:
        assert np.array_equal(ref[k], got[k]), k


def test_parallel_snapshot_equals_serial_and_reference_snapshot():
    agg = ta.count()
    serial = _feed(SessionOperator(gap_ms=100, agg=agg,
                                   allowed_lateness_ms=500))
    jpool = JaxHostPool(4)
    pool = HostPool(4)
    try:
        par = _feed(SessionOperator(gap_ms=100, agg=agg,
                                    allowed_lateness_ms=500, host_pool=pool))
        jpar = _feed(JaxSessionOperator(gap_ms=100, agg=ja.count(),
                                        allowed_lateness_ms=500,
                                        host_pool=jpool))
        snaps = [serial.snapshot_state(), par.snapshot_state(),
                 jpar.snapshot_state()]
    finally:
        pool.close()
        jpool.close()
    for s in snaps[1:]:
        assert s["watermark"] == snaps[0]["watermark"]
        assert set(s["columns"]) == set(snaps[0]["columns"])
        for c in s["columns"]:
            a, b = snaps[0]["columns"][c], s["columns"][c]
            assert a.dtype == b.dtype and np.array_equal(a, b), c
