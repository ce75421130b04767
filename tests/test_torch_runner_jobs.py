"""Deployable jobs of the port's control-plane tests — the "job jars" a
port task runner imports by name (``test_torch_runner_jobs:build``) and
calls with a ``StreamExecutionEnvironment``, as the reference's runners
import ``tests/runner_job*.py``. Each builds the same pipeline on the
same deterministic data as its reference counterpart, on the port's
modules; the goldens are those modules' own.

Job parameters ride in the submitted configuration under ``test.*``
keys. The port refuses keys it does not read, so ``params`` takes them
out of the environment's configuration before the job runs. The module
imports nothing of the JAX package: a runner process that loads it
stays on the port (tests/test_torch_runner_process.py holds its data
and goldens to the reference jobs')."""
import dataclasses
import os
import time

import numpy as np

from flink_tpu_torch.api.sinks import FileTransactionalSink, UpsertSink
from flink_tpu_torch.api.sources import GeneratorSource
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.config import LogOptions
from flink_tpu_torch.connectors import FileSink
from flink_tpu_torch.formats_columnar import ColumnarFormat
from flink_tpu_torch.log import LogSink, LogSource
from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_stream
from flink_tpu_torch.table.api import TableEnvironment
from flink_tpu_torch.time.watermarks import WatermarkStrategy


def params(env) -> dict:
    """The job's ``test.*`` parameters, taken out of its configuration."""
    values = env.config._values
    return {k: values.pop(k) for k in [k for k in values
                                        if k.startswith("test.")]}


def _pid(env) -> int:
    return int(env.config.to_dict().get("cluster.process-id", 0))


# -- runner_job: the windowed count into the 2PC file sink -------------------------

def batch_of(i: int):
    rng = np.random.default_rng(1234 + i)
    keys = rng.integers(0, 10, 64).astype(np.int64)
    ts = np.sort(rng.integers(i * 500, i * 500 + 1000, 64)).astype(np.int64)
    return keys, ts


def golden_counts(n_batches: int):
    expect = {}
    for i in range(n_batches):
        keys, ts = batch_of(i)
        for k, t in zip(keys.tolist(), ts.tolist()):
            kk = (int(k), t // 1000 * 1000)
            expect[kk] = expect.get(kk, 0) + 1
    return expect


def build(env):
    p = params(env)
    n_batches = int(p.get("test.n-batches", 40))
    sleep_ms = int(p.get("test.batch-sleep-ms", 0))
    sink_dir = p.get("test.sink-dir")
    assert sink_dir, "test.sink-dir must be set"

    def gen(split, i):
        if i >= n_batches:
            return None
        if sleep_ms:
            time.sleep(sleep_ms / 1000)  # a slow stream: killable mid-job
        keys, ts = batch_of(i)
        return {"k": keys}, ts

    (env.from_source(GeneratorSource(gen),
                     WatermarkStrategy.for_bounded_out_of_orderness(1000))
        .key_by("k")
        .window(TumblingEventTimeWindows.of(1000))
        .count()
        .add_sink(FileTransactionalSink(sink_dir)))


# -- runner_job_dcn: one job across two runner processes ---------------------------

def dcn_batch_of(split: int, i: int):
    rng = np.random.default_rng(77 + 1000 * split + i)
    keys = rng.integers(0, 40, 128).astype(np.int64)
    ts = np.sort(rng.integers(i * 500, i * 500 + 1000, 128)).astype(np.int64)
    return keys, ts


def dcn_golden_counts(n_batches: int):
    expect = {}
    for split in (0, 1):
        for i in range(n_batches):
            keys, ts = dcn_batch_of(split, i)
            for k, t in zip(keys.tolist(), ts.tolist()):
                kk = (int(k), t // 1000 * 1000)
                expect[kk] = expect.get(kk, 0) + 1
    return expect


def build_dcn(env):
    p = params(env)
    n_batches = int(p.get("test.n-batches", 20))
    sink_dir = p.get("test.sink-dir")
    assert sink_dir, "test.sink-dir must be set"

    def gen(split, i):
        if i >= n_batches:
            return None
        keys, ts = dcn_batch_of(int(split), i)
        return {"k": keys}, ts

    (env.from_source(GeneratorSource(gen, n_splits=2),
                     WatermarkStrategy.for_bounded_out_of_orderness(1000))
        .key_by("k")
        .window(TumblingEventTimeWindows.of(1000))
        .count()
        .add_sink(FileTransactionalSink(f"{sink_dir}-p{_pid(env)}")))


# -- runner_job_q5_rescale: Q5's count plane across a process rescale --------------

Q5_WINDOW_MS, Q5_SLIDE_MS = 2_000, 1_000


def q5_cfg(n_batches: int, batch_size: int) -> NexmarkConfig:
    return NexmarkConfig(batch_size=batch_size, n_batches=n_batches,
                         n_splits=2, events_per_ms=4,
                         num_active_auctions=64, num_active_people=32)


def q5_rescale_golden(n_batches: int, batch_size: int):
    """The per-(auction, window start) counts of the port's bid stream
    (the same numpy generator as the reference's)."""
    cfg = q5_cfg(n_batches, batch_size)
    src = bid_stream(cfg)
    expect = {}
    w, s = Q5_WINDOW_MS, Q5_SLIDE_MS
    for split in range(cfg.n_splits):
        for i in range(cfg.n_batches):
            data, ts = src.gen(str(split), i)
            for a, t in zip(data["auction"].tolist(), ts.tolist()):
                for start in range(t // s * s - w + s, t // s * s + 1, s):
                    kk = (int(a), int(start))
                    expect[kk] = expect.get(kk, 0) + 1
    return expect


def build_q5_rescale(env):
    p = params(env)
    n_batches = int(p.get("test.n-batches", 12))
    batch_size = int(p.get("test.batch-size", 512))
    sleep_ms = int(p.get("test.batch-sleep-ms", 0))
    sink_dir = p.get("test.sink-dir")
    assert sink_dir, "test.sink-dir must be set"
    src = bid_stream(q5_cfg(n_batches, batch_size))
    inner = src.gen

    def gen(split, i):
        b = inner(split, i)
        if b is not None and sleep_ms:
            time.sleep(sleep_ms / 1000.0)
        return b

    (env.from_source(dataclasses.replace(src, gen=gen),
                     WatermarkStrategy.for_bounded_out_of_orderness(1000))
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(Q5_WINDOW_MS, Q5_SLIDE_MS))
        .count()
        .add_sink(FileTransactionalSink(f"{sink_dir}-p{_pid(env)}")))


# -- runner_job_wordcount: bounded WordCount into a columnar FileSink ---------------

WC_SCHEMA = (("key", "i64"), ("window_end", "i64"), ("count", "i64"))


def wc_batch_of(i: int):
    rng = np.random.default_rng(7000 + i)
    words = (rng.random(128) ** 2 * 40).astype(np.int64)
    ts = (i * 128 + np.arange(128, dtype=np.int64)) * 10
    return {"word": words}, ts


def wordcount(env):
    p = params(env)
    n_batches = int(p.get("test.n-batches", 6))
    sink_dir = p.get("test.sink-dir")
    assert sink_dir, "test.sink-dir must be set"

    def gen(split, i):
        return wc_batch_of(i) if i < n_batches else None

    (env.from_source(GeneratorSource(gen),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("word")
        .window(TumblingEventTimeWindows.of(1000))
        .count()
        .add_sink(FileSink(sink_dir, ColumnarFormat(WC_SCHEMA))))


# -- runner_job_log_chain: two local runs chained through a log topic --------------

CHAIN_TOPIC = "chain-words"


def chain_batch_of(i: int):
    rng = np.random.default_rng(9100 + i)
    words = rng.integers(0, 12, 64).astype(np.int64)
    ts = (i * 64 + np.arange(64, dtype=np.int64)) * 10
    return {"word": words, "ts_ms": ts}, ts


def chain_expected_counts(n_batches: int):
    counts = {}
    for i in range(n_batches):
        data, ts = chain_batch_of(i)
        for w, t in zip(data["word"].tolist(), ts.tolist()):
            key = (int(w), (int(t) // 1000 + 1) * 1000)
            counts[key] = counts.get(key, 0) + 1
    return sorted((w, we, c) for (w, we), c in counts.items())

def produce(env):
    n_batches = int(params(env).get("test.n-batches", 5))

    def gen(split, i):
        return chain_batch_of(i) if i < n_batches else None

    env.from_source(GeneratorSource(gen)).add_sink(LogSink.from_config(
        env.config, CHAIN_TOPIC, key_field="word"))


def consume(env):
    sink_dir = params(env).get("test.sink-dir")
    assert sink_dir, "test.sink-dir must be set"
    topic = os.path.join(str(env.config.get(LogOptions.DIR)), CHAIN_TOPIC)
    (env.from_source(LogSource(topic, ts_field="ts_ms"),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("word")
        .window(TumblingEventTimeWindows.of(1000))
        .count()
        .add_sink(FileSink(sink_dir, ColumnarFormat(WC_SCHEMA))))


def read_committed_counts(sink_dir: str):
    sink = FileSink(sink_dir, ColumnarFormat(WC_SCHEMA))
    rows = []
    for b in sink.committed_batches():
        rows.extend(zip(b["key"].tolist(), b["window_end"].tolist(),
                        b["count"].tolist()))
    return sorted((int(k), int(w), int(c)) for k, w, c in rows)


# -- runner_job_changelog: the two SQL changelog shapes ------------------------------

CL_N, CL_NK = 400, 6


def left_events():
    rng = np.random.default_rng(99)
    k = rng.integers(0, CL_NK, CL_N).astype(np.int64)
    ts = np.sort(rng.integers(0, 4000, CL_N)).astype(np.int64)
    return k, ts


def right_events():
    rng = np.random.default_rng(100)
    k = rng.integers(0, CL_NK, CL_N).astype(np.int64)
    w = rng.integers(1, 50, CL_N).astype(np.int64)
    ts2 = np.sort(rng.integers(0, 4000, CL_N)).astype(np.int64)
    return k, w, ts2


def group_by_events():
    rng = np.random.default_rng(101)
    k = rng.integers(0, CL_NK, CL_N).astype(np.int64)
    v = rng.integers(1, 50, CL_N).astype(np.int64)
    return k, v, np.arange(CL_N, dtype=np.int64)

def build_join_agg(env):
    sink_dir = params(env).get("test.sink-dir")
    assert sink_dir, "test.sink-dir must be set"
    lk, lts = left_events()
    rk, rw, rts = right_events()
    t_env = TableEnvironment.create(env)
    left = env.from_collection({"k": lk, "ts": lts}, lts, batch_size=100)
    right = env.from_collection({"k2": rk, "w": rw, "ts2": rts}, rts,
                                batch_size=100)
    t_env.create_temporary_view("L", left, ["k", "ts"])
    t_env.create_temporary_view("R", right, ["k2", "w", "ts2"])
    t = t_env.sql_query(
        "SELECT L.k, window_start, COUNT(*) AS c, SUM(R.w) AS sw "
        "FROM TABLE(TUMBLE(TABLE L, DESCRIPTOR(ts), INTERVAL '1' SECOND)) "
        "JOIN TABLE(TUMBLE(TABLE R, DESCRIPTOR(ts2), INTERVAL '1' SECOND)) "
        "ON L.k = R.k2 GROUP BY k, window_start")
    t.stream.add_sink(FileTransactionalSink(sink_dir))


group_by_sink = UpsertSink(key_fields=("k",))


def build_group_by(env):
    group_by_sink.state.clear()
    k, v, ts = group_by_events()
    t_env = TableEnvironment.create(env)
    stream = env.from_collection({"k": k, "v": v}, ts, batch_size=100)
    t_env.create_temporary_view(
        "t", stream, schema=["k", "v", "ts"], time_attr="ts")
    tbl = t_env.sql_query(
        "SELECT k, COUNT(*) AS c, SUM(v) AS sv FROM t GROUP BY k")
    tbl.stream.add_sink(group_by_sink)
