"""Nexmark Q5 hot items end to end through the port's
``env.execute(device="cpu")``: committed rows equal the same job run
through the JAX package (in order) and the plain-Python golden of
tests/test_nexmark.py (as a set). All comparisons are exact."""
import os

import numpy as np
import pytest
import torch

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import CollectSink as JaxCollectSink
from flink_tpu.api.sources import GeneratorSource as JaxGeneratorSource
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.nexmark import generator as jax_generator
from flink_tpu.nexmark.queries import q5_hot_items as jax_q5
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import CollectSink
from flink_tpu_torch.api.sources import GeneratorSource
from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_stream
from flink_tpu_torch.nexmark.queries import q5_hot_items
from test_torch_threads import capped_torch_threads  # noqa: F401

SMALL_CONF = {
    "state.num-key-shards": 8,
    "state.slots-per-shard": 512,
    "pipeline.microbatch-size": 1024,
}


def seeded_bids(batch_size, n_batches, events_per_ms, n_auctions, seed):
    """gen(split, i) of seeded numpy bids, fed to both packages."""
    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng([seed, i])
        ids = i * batch_size + np.arange(batch_size, dtype=np.int64)
        hot = rng.integers(0, 4, batch_size) == 0
        auction = np.where(hot, rng.integers(0, 3, batch_size),
                           rng.integers(0, n_auctions, batch_size))
        return ({"auction": auction.astype(np.int64),
                 "bidder": rng.integers(0, 30, batch_size).astype(np.int64),
                 "price": rng.random(batch_size).astype(np.float32)},
                ids // events_per_ms)
    return gen


def golden(gen, window_ms, slide_ms):
    """Each window's top auctions by bid count (ties kept), as
    ``{(auction, window_end, count)}``, counted in numpy: every bid goes
    to the windows ``[ws, ws + window_ms)`` holding it."""
    auction, ts, i = [], [], 0
    while (b := gen("0", i)) is not None:
        auction.append(b[0]["auction"])
        ts.append(b[1])
        i += 1
    a, t = np.concatenate(auction), np.concatenate(ts)
    start = (t // slide_ms) * slide_ms
    k = -(-window_ms // slide_ms)
    ws = start[:, None] - slide_ms * np.arange(k)[None, :]
    keep = ws > t[:, None] - window_ms
    pairs = np.stack([np.repeat(a, k)[keep.reshape(-1)],
                      (ws + window_ms)[keep]], axis=1)
    keys, counts = np.unique(pairs, axis=0, return_counts=True)
    ends, inv = np.unique(keys[:, 1], return_inverse=True)
    best = np.zeros(len(ends), np.int64)
    np.maximum.at(best, inv, counts)
    top = counts == best[inv]
    return {(int(x), int(e), int(c))
            for (x, e), c in zip(keys[top].tolist(), counts[top].tolist())}


def run_both(gen, conf, window_ms, slide_ms, ooo_ms):
    env = JaxEnv(JaxConfiguration(dict(conf)))
    jsink = JaxCollectSink()
    jax_q5(env, JaxGeneratorSource(gen), jsink, window_ms=window_ms,
           slide_ms=slide_ms, out_of_orderness_ms=ooo_ms)
    env.execute("q5-jax")
    env = StreamExecutionEnvironment(Configuration(dict(conf)))
    sink = CollectSink()
    q5_hot_items(env, GeneratorSource(gen), sink, window_ms=window_ms,
                 slide_ms=slide_ms, out_of_orderness_ms=ooo_ms)
    res = env.execute("q5-port", device="cpu")

    def rows(s):
        return [(int(r["auction"]), int(r["window_end"]), int(r["bid_count"]))
                for r in s.rows]
    return rows(jsink), rows(sink), res


def test_q5_small_matches_jax_and_golden():
    """The tests/test_nexmark.py shape: 2 s / 1 s windows, 512-bid
    batches at 1 bid/ms over 50 auctions."""
    gen = seeded_bids(512, 8, 1, 50, seed=1)
    ref, got, res = run_both(gen, SMALL_CONF, 2_000, 1_000, 0)
    assert got == ref
    assert set(got) == golden(gen, 2_000, 1_000)
    assert res.metrics["records_in"] == 8 * 512
    assert res.metrics["device"] == "cpu"


def test_q5_sliding_10s_with_ring_growth_matches_jax_and_golden():
    """The Q5 window (10 s / 1 s, 1 s out-of-orderness) with batches of
    12 s of event time: the pane ring grows 16 → 32 on the first batch
    and every advance fires about 12 windows."""
    gen = seeded_bids(12_288, 4, 1, 200, seed=2)
    ref, got, _ = run_both(gen, SMALL_CONF, 10_000, 1_000, 1_000)
    assert got == ref
    assert set(got) == golden(gen, 10_000, 1_000)
    assert len({w for _, w, _ in got}) > 40


def test_bid_stream_is_the_reference_numpy_generator(monkeypatch):
    """The port's bid_stream is the reference's numpy RNG branch, bit for
    bit (the reference prefers its native generator when built)."""
    monkeypatch.setattr(jax_generator, "nexmark_bids_native",
                        lambda *a, **k: None, raising=False)
    from flink_tpu import native_codec
    monkeypatch.setattr(native_codec, "nexmark_bids_native",
                        lambda *a, **k: None)
    cfg = dict(batch_size=300, n_batches=3, events_per_ms=3, n_splits=2,
               num_active_auctions=70, num_active_people=20, hot_ratio=3)
    ours = bid_stream(NexmarkConfig(**cfg))
    theirs = jax_generator.bid_stream(jax_generator.NexmarkConfig(**cfg))
    for split in ours.splits():
        a = list(ours.open_split(split))
        b = list(theirs.open_split(split))
        assert len(a) == len(b) == 3
        for (da, ta), (db, tb) in zip(a, b):
            np.testing.assert_array_equal(ta, tb)
            for k in ("auction", "bidder", "price"):
                np.testing.assert_array_equal(da[k], db[k])


def test_execute_without_device_refuses_the_cpu(monkeypatch):
    """execute() defaults to the card: on a machine without CUDA it
    raises and nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = StreamExecutionEnvironment(Configuration(dict(SMALL_CONF)))
    sink = CollectSink()
    q5_hot_items(env, GeneratorSource(seeded_bids(512, 2, 1, 10, seed=3)),
                 sink, window_ms=2_000, slide_ms=1_000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        env.execute("q5")
    assert sink.rows == []


def test_bench_conf_loads_and_validates():
    """The reference's host-fed Q5 bench conf runs unchanged."""
    from flink_tpu_torch.config import PipelineOptions, StateOptions

    conf = Configuration.from_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "confs", "bench_q5_host_fed.conf"))
    conf.validate()
    assert conf.get(StateOptions.NUM_KEY_SHARDS) == 128
    assert conf.get(StateOptions.SLOTS_PER_SHARD) == 256
    assert conf.get(PipelineOptions.MICROBATCH_SIZE) == 1 << 20


@pytest.mark.parametrize("conf,err", [
    ({"state.backend": "rocksdb"}, ValueError),
    ({"pipeline.profile-steps": "2"}, NotImplementedError),
    ({"analysis.fail-on": "sometimes"}, ValueError),
    ({"pipeline.max-inflight-steps": 0}, ValueError),
])
def test_unknown_or_unported_options_raise(conf, err):
    env = StreamExecutionEnvironment(Configuration(conf))
    q5_hot_items(env, GeneratorSource(seeded_bids(64, 1, 1, 5, seed=4)),
                 CollectSink(), window_ms=2_000, slide_ms=1_000)
    with pytest.raises(err):
        env.execute("q5", device="cpu")


@pytest.mark.parametrize("extra", [
    {"pipeline.emit-defer": "100ms"},
    {"pipeline.emit-defer": "30ms", "pipeline.sub-batches": 4},
])
def test_emit_defer_commits_the_rows_at_zero(extra):
    """pipeline.emit-defer above 0 holds each fire back until it is that
    old (a barrier at end of input delivers the rest): the committed
    rows and their order equal the run at 0, here with a 100 ms batch
    pace so the deferral does hold fires back."""
    gen = seeded_bids(256, 6, 2, 40, seed=11)

    def slow(split, i):
        b = gen(split, i)
        if b is not None and i:
            import time

            time.sleep(0.1)
        return b

    rows, held = {}, None
    for defer in ("0ms", extra["pipeline.emit-defer"]):
        conf = dict(SMALL_CONF, **dict(extra, **{"pipeline.emit-defer": defer,
                                                 "pipeline.microbatch-size": 256,
                                                 "pipeline.source-prefetch": 0}))
        env = StreamExecutionEnvironment(Configuration(conf))
        sink = CollectSink()
        q5_hot_items(env, GeneratorSource(slow), sink, window_ms=600,
                     slide_ms=200)
        env.execute("q5-defer", device="cpu")
        rows[defer] = [tuple(sorted(r.items())) for r in sink.rows]
        held = env._driver._emit_defer_s
    assert rows["0ms"] == rows[extra["pipeline.emit-defer"]]
    assert len(rows["0ms"]) > 0 and held > 0


@pytest.mark.parametrize("steps", [None, 1, 7])
def test_max_inflight_steps_reaches_the_operator(steps):
    """pipeline.max-inflight-steps sets the window operator's in-flight
    bound; without it the operator takes the option's default."""
    from flink_tpu_torch.config import PipelineOptions
    from flink_tpu_torch.graph.compiler import compile_job
    from flink_tpu_torch.runtime.driver import Driver

    conf = dict(SMALL_CONF)
    if steps is not None:
        conf["pipeline.max-inflight-steps"] = steps
    env = StreamExecutionEnvironment(Configuration(conf))
    q5_hot_items(env, GeneratorSource(seeded_bids(64, 1, 1, 5, seed=6)),
                 CollectSink(), window_ms=2_000, slide_ms=1_000)
    plan = compile_job(env._transforms, env._watermark_strategy)
    ops = list(Driver(plan, env.config, device="cpu")._ops.values())
    want = PipelineOptions.MAX_INFLIGHT_STEPS.default if steps is None else steps
    assert [op.max_inflight_steps for op in ops] == [want]


def test_unported_pipeline_shapes_raise(tmp_path):
    from flink_tpu_torch.ops.aggregates import count, max_of, multi
    from flink_tpu_torch.parallel.mesh import make_mesh_plan

    # the disk-backed spill tier on a device mesh (queue 1 item 9.2) is
    # ported: the job runs there and commits the one-device rows
    rows = []
    for i, mesh in enumerate((make_mesh_plan(8, 512, ["cpu"] * 4), None)):
        env = StreamExecutionEnvironment(Configuration(
            dict(SMALL_CONF, **{"state.backend": "lsm",
                                "state.lsm.dir": str(tmp_path / str(i))})))
        sink = CollectSink()
        (env.from_source(GeneratorSource(seeded_bids(64, 1, 1, 5, seed=5)))
         .key_by("auction").window(TumblingEventTimeWindows.of(1_000))
         .aggregate(multi(count(), max_of("price")))
         .add_sink(sink))
        env.execute("lsm-on-a-mesh", device="cpu", mesh_plan=mesh)
        rows.append(sorted(tuple(sorted(r.items())) for r in sink.rows))
    assert rows[0] == rows[1] and rows[0]


def test_from_collection_batches_by_microbatch_size():
    """from_collection cuts batches of pipeline.microbatch-size, and the
    Q5 pipeline over it commits the reference's rows (in order)."""
    from flink_tpu.api.windowing import SlidingEventTimeWindows as JaxSliding
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows

    rng = np.random.default_rng(8)
    n = 5_000
    data = {"auction": rng.integers(0, 40, n).astype(np.int64)}
    ts = np.sort(rng.integers(0, 9_000, n)).astype(np.int64)
    out = []
    for env, sliding, sink in (
            (JaxEnv(JaxConfiguration(dict(SMALL_CONF))), JaxSliding,
             JaxCollectSink()),
            (StreamExecutionEnvironment(Configuration(dict(SMALL_CONF))),
             SlidingEventTimeWindows, CollectSink())):
        (env.from_collection(data, ts).key_by("auction")
         .window(sliding.of(2_000, 1_000)).count().top(1, by="count")
         .add_sink(sink))
        kw = {} if sliding is JaxSliding else {"device": "cpu"}
        res = env.execute("collection", **kw)
        out.append([(int(r["key"]), int(r["window_end"]), int(r["count"]))
                    for r in sink.rows])
    assert out[1] == out[0] and len(out[0]) >= 9
    assert res.metrics["batches"] == -(-n // 1024)
