"""The port's driver at ``pipeline.sub-batches`` K > 1 on host-fed
sources, its ``pipeline.readiness`` and its other driver-level pipeline
keys, against the JAX package on the CPU — the counterparts of
tests/test_subbatch.py's ``TestHostPlaneParity`` and ``TestValidation``
driver cases and tests/test_fire_gate.py's ``TestReadinessParity`` and
its driver and operator ``TestValidation`` cases.

Host-fed runs commit the same row set at every K, each key's rows in the
same order, and the same set as the reference's (a K = 1 advance packs
many window ends into one fire; K = 4 fires the same ends in groups, so
only the interleave across keys moves): ``TestHostPlaneParity``'s
WordCount and sessions runners. ``TestSubbatchChaosK4`` runs the
sessions job at K = 4 and ``host.parallelism`` 4 under a
``host.pool.task`` and a checkpoint-storage fault: its committed rows
equal the fault-free run's at the same K, and the reference's. Every
comparison is exact: integer counts. ``TestCliSmoke`` runs WordCount at
``pipeline.sub-batches=4`` through ``python -m flink_tpu_torch run
--local`` on the CPU; the analyzer cases wait for the analyzer
(ROADMAP.md queue 1 item 11)."""
import collections

import numpy as np
import pytest

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import CollectSink as JaxCollectSink
from flink_tpu.api.sources import GeneratorSource as JaxGeneratorSource
from flink_tpu.api.windowing import TumblingEventTimeWindows as JaxTumbling
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.nexmark.queries import q5_hot_items as jax_q5
from flink_tpu.time.watermarks import WatermarkStrategy as JaxWatermarks
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import CollectSink
from flink_tpu_torch.api.sources import GeneratorSource
from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
from flink_tpu_torch.config import Configuration, PipelineOptions
from flink_tpu_torch.graph.compiler import compile_job
from flink_tpu_torch.kernels import fused_kernels as fk
from flink_tpu_torch.nexmark import generator as pgen
from flink_tpu_torch.nexmark.queries import q5_hot_items
from flink_tpu_torch.ops.aggregates import count
from flink_tpu_torch.ops.window import WindowOperator
from flink_tpu_torch.runtime.driver import Driver
from flink_tpu_torch.time.watermarks import WatermarkStrategy
from test_torch_threads import capped_torch_threads  # noqa: F401

WC_CONF = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
           "pipeline.microbatch-size": 512}


def wc_gen(split, i):
    """tests/test_subbatch.py's WordCount source: 6 batches of 512 words,
    in time order (no record is late at any K)."""
    if i >= 6:
        return None
    rng = np.random.default_rng(i)
    w = (rng.random(512) ** 2 * 50).astype(np.int64)
    ts = (i * 512 + np.arange(512, dtype=np.int64)) * 4
    return {"word": w}, ts


def wordcount(env, src, wm, sink, windows):
    (env.from_source(src, wm).key_by("word").window(windows.of(500))
     .count().add_sink(sink))


def rows_of(sink, key):
    return [(int(r[key]), int(r["window_end"]), int(r["count"]))
            for r in sink.rows]


def per_key(rows):
    seq = collections.defaultdict(list)
    for k, e, c in rows:
        seq[k].append((e, c))
    return dict(seq)


def run_port_wc(k, extra=None):
    conf = dict(WC_CONF, **{"pipeline.sub-batches": k}, **(extra or {}))
    env = StreamExecutionEnvironment(Configuration(conf))
    sink = CollectSink()
    wordcount(env, GeneratorSource(wc_gen),
              WatermarkStrategy.for_bounded_out_of_orderness(0), sink,
              TumblingEventTimeWindows)
    res = env.execute(f"wc-sub{k}", device="cpu")
    return rows_of(sink, "key"), res


def run_ref_wc(k):
    env = JaxEnv(JaxConfiguration(dict(WC_CONF, **{"pipeline.sub-batches": k})))
    sink = JaxCollectSink()
    wordcount(env, JaxGeneratorSource(wc_gen),
              JaxWatermarks.for_bounded_out_of_orderness(0), sink, JaxTumbling)
    env.execute(f"wc-sub{k}-jax")
    return rows_of(sink, "key")


@pytest.fixture(scope="module")
def wc_reference():
    """The reference's WordCount rows at K = 1 and K = 4."""
    return {k: run_ref_wc(k) for k in (1, 4)}


@pytest.mark.parametrize("k", [1, 2, 4])
def test_wordcount_rows_and_per_key_order_at_every_k(wc_reference, k):
    """TestHostPlaneParity: the K slices of each batch commit the K = 1
    run's row set, each key's rows in the same order, equal to the
    reference's at K = 1 and (set and per-key order) at K = 4; batches
    count the slices, records the same."""
    got, res = run_port_wc(k)
    golden = wc_reference[1]
    assert len(golden) > 0
    assert sorted(got) == sorted(golden)
    assert per_key(got) == per_key(golden)
    assert sorted(got) == sorted(wc_reference[4])
    assert per_key(got) == per_key(wc_reference[4])
    assert res.metrics["records_in"] == 6 * 512
    assert res.metrics["batches"] == 6 * k


def q5_conf(k, extra=None):
    return dict({"state.num-key-shards": 16, "state.slots-per-shard": 64,
                 "pipeline.microbatch-size": 32768,
                 "pipeline.sub-batches": k}, **(extra or {}))


def q5_gen(split, i):
    """Q5 bids, 32,768 a batch over ~20 s of event time (about 20 window
    ends a K = 1 advance; a quarter slice still passes the native lane's
    gate, pairs decisively below records), 100 auctions, a quarter on 3
    hot ones."""
    if i >= 4:
        return None
    n = 32768
    rng = np.random.default_rng([19, i])
    hot = rng.integers(0, 4, n) == 0
    auction = np.where(hot, rng.integers(0, 3, n),
                       rng.integers(0, 100, n)).astype(np.int64)
    ts = (i * n + np.arange(n, dtype=np.int64)) * 20_000 // n
    return {"auction": auction}, ts + rng.integers(-500, 500, n)


def run_port_q5(k, extra=None):
    env = StreamExecutionEnvironment(Configuration(q5_conf(k, extra)))
    sink = CollectSink()
    q5_hot_items(env, GeneratorSource(q5_gen), sink, window_ms=10_000,
                 slide_ms=1_000, out_of_orderness_ms=1_000)
    res = env.execute(f"q5-sub{k}", device="cpu")
    return [(int(r["auction"]), int(r["window_end"]), int(r["bid_count"]))
            for r in sink.rows], res


@pytest.fixture(scope="module")
def q5_reference():
    """The reference's host-fed Q5 rows at K = 1 and K = 4 (both
    packages take their native lanes)."""
    out = {}
    for k in (1, 4):
        env = JaxEnv(JaxConfiguration(q5_conf(k)))
        sink = JaxCollectSink()
        jax_q5(env, JaxGeneratorSource(q5_gen), sink, window_ms=10_000,
               slide_ms=1_000, out_of_orderness_ms=1_000)
        env.execute(f"q5-sub{k}-jax")
        out[k] = [(int(r["auction"]), int(r["window_end"]),
                   int(r["bid_count"])) for r in sink.rows]
    return out


def by_window(rows):
    return sorted(rows, key=lambda r: r[1])


@pytest.mark.parametrize("k", [1, 2, 4])
def test_q5_host_fed_rows_at_every_k(q5_reference, monkeypatch, k):
    """Host-fed Q5 through the native lane: each slice is one fused step
    of its own (the slices' fires at sub-batch cadence), and the rows
    equal the K = 1 run's and the reference's window by window (each
    window's rows in one order), with no record late."""
    from flink_tpu.native_codec import native_available

    if not native_available():
        pytest.skip("the reference's codec library did not build")
    steps = collections.Counter()
    orig = fk.fused_step

    def spy(*a, **kw):
        steps[kw.get("form", fk.FORM_WORDS)] += 1
        return orig(*a, **kw)
    monkeypatch.setattr(fk, "fused_step", spy)
    got, res = run_port_q5(k)
    assert len(got) > 40 and res.metrics["late_records"] == 0
    assert by_window(got) == by_window(q5_reference[1])
    assert by_window(got) == by_window(q5_reference[4])
    if k == 4:
        assert got == q5_reference[4]
    assert res.metrics["batches"] == 4 * k
    # a fused step per slice after the first batch's
    assert sum(steps.values()) >= 4 * k - k


# -- readiness ---------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_piggyback_and_probe_commit_the_same_rows(k):
    """TestReadinessParity: pipeline.readiness changes how the throttle
    waits, nothing else — the devgen Q5 headline shape in miniature
    (a subdivided device chain at K = 4: the probe throttles at each
    logical batch's last sub-batch only) and host-fed WordCount commit
    the same rows in the same order."""
    out = {}
    for readiness in ("piggyback", "probe"):
        src = pgen.bid_stream_device(pgen.NexmarkConfig(
            batch_size=4096, n_batches=6, events_per_ms=4,
            num_active_auctions=500, hot_ratio=4))
        env = StreamExecutionEnvironment(Configuration({
            "state.num-key-shards": 8, "state.slots-per-shard": 128,
            "pipeline.microbatch-size": 4096, "pipeline.sub-batches": k,
            "pipeline.readiness": readiness}))
        sink = CollectSink()
        q5_hot_items(env, src, sink, window_ms=4_000, slide_ms=1_000,
                     out_of_orderness_ms=500)
        res = env.execute("q5-readiness", device="cpu")
        assert res.metrics["devgen_host_batches"] == 0
        wc, _ = run_port_wc(k, {"pipeline.readiness": readiness})
        out[readiness] = ([(int(r["auction"]), int(r["window_end"]),
                            int(r["bid_count"])) for r in sink.rows], wc)
    assert out["piggyback"] == out["probe"]
    assert len(out["probe"][0]) > 0 and len(out["probe"][1]) > 0


@pytest.mark.parametrize("readiness", ["piggyback", "probe"])
def test_driver_throttles_at_the_readiness_cadence(monkeypatch, readiness):
    """The driver throttles its window operators itself: after every
    host-fed slice, and on a subdivided device chain after every
    sub-batch under piggyback but after each logical batch's last under
    probe (the reference driver's cadence)."""
    calls = collections.Counter()
    orig = WindowOperator.throttle

    def spy(self):
        calls["throttle"] += 1
        return orig(self)
    monkeypatch.setattr(WindowOperator, "throttle", spy)
    src = pgen.bid_stream_device(pgen.NexmarkConfig(
        batch_size=4096, n_batches=3, events_per_ms=4,
        num_active_auctions=500, hot_ratio=4))
    env = StreamExecutionEnvironment(Configuration({
        "state.num-key-shards": 8, "state.slots-per-shard": 128,
        "pipeline.microbatch-size": 4096, "pipeline.sub-batches": 4,
        "pipeline.readiness": readiness}))
    q5_hot_items(env, src, CollectSink(), window_ms=4_000, slide_ms=1_000)
    res = env.execute("q5-cadence", device="cpu")
    assert res.metrics["batches"] == 12
    assert calls["throttle"] == (12 if readiness == "piggyback" else 3)
    calls.clear()
    _, res = run_port_wc(4, {"pipeline.readiness": readiness})
    assert calls["throttle"] == res.metrics["batches"] == 24


# -- a devgen gate's host batch under K = 4 ------------------------------------

def test_devgen_gate_host_sub_batch_is_not_sliced_again(monkeypatch):
    """A gate that sends a sub-batch of a subdivided device chain to the
    host: the subdivided source makes the bit-exact sub-batch, which is
    pushed as it is (not sliced K ways again); rows equal the run where
    every sub-batch was made on the card, records and batches too."""
    def run(refuse):
        orig = WindowOperator.process_batch_device

        def gate(self, index):
            return False if index in refuse else orig(self, index)
        monkeypatch.setattr(WindowOperator, "process_batch_device", gate)
        src = pgen.bid_stream_device(pgen.NexmarkConfig(
            batch_size=4096, n_batches=4, events_per_ms=4,
            num_active_auctions=500, hot_ratio=4))
        env = StreamExecutionEnvironment(Configuration({
            "state.num-key-shards": 8, "state.slots-per-shard": 128,
            "pipeline.microbatch-size": 4096, "pipeline.sub-batches": 4}))
        sink = CollectSink()
        q5_hot_items(env, src, sink, window_ms=4_000, slide_ms=1_000,
                     out_of_orderness_ms=500)
        res = env.execute("q5-gate", device="cpu")
        return [(int(r["auction"]), int(r["window_end"]), int(r["bid_count"]))
                for r in sink.rows], res

    want, res0 = run(())
    got, res = run((5, 6))
    assert res0.metrics["devgen_host_batches"] == 0
    assert res.metrics["devgen_host_batches"] == 2
    assert by_window(got) == by_window(want) and len(got) > 0
    assert res.metrics["records_in"] == res0.metrics["records_in"] == 4 * 4096
    assert res.metrics["batches"] == res0.metrics["batches"] == 16


def test_devgen_gate_logical_batch_is_sliced_k_ways(monkeypatch):
    """A device source that cannot subdivide keeps logical-batch steps
    under K = 4 (and the base in-flight credit); a batch its gate sends
    to the host is a logical batch, pushed as K slices like any
    host-fed one. Rows equal the run that made every batch on the card,
    window by window."""
    from flink_tpu_torch.api.sources import DeviceGeneratorSource

    base = pgen.bid_stream_device(pgen.NexmarkConfig(
        batch_size=4096, n_batches=4, events_per_ms=4,
        num_active_auctions=500, hot_ratio=4))

    def run(refuse):
        orig = WindowOperator.process_batch_device

        def gate(self, index):
            return False if index in refuse else orig(self, index)
        monkeypatch.setattr(WindowOperator, "process_batch_device", gate)
        src = DeviceGeneratorSource(
            device_keys_ts=base.device_keys_ts, gen=base.gen,
            keys_ts_host=base.keys_ts_host, ts_bounds=base.ts_bounds,
            key_field="auction", batch_size=4096, n_batches=4,
            key_domain=base.key_domain, keys_bounded=True)
        assert src.subdivide is None
        env = StreamExecutionEnvironment(Configuration({
            "state.num-key-shards": 8, "state.slots-per-shard": 128,
            "pipeline.microbatch-size": 4096, "pipeline.sub-batches": 4,
            "pipeline.max-inflight-steps": 2}))
        sink = CollectSink()
        q5_hot_items(env, src, sink, window_ms=4_000, slide_ms=1_000,
                     out_of_orderness_ms=500)
        plan = compile_job(env._transforms, env._watermark_strategy)
        drv = Driver(plan, env.config, device="cpu")
        ops = list(drv._ops.values())
        res = drv.run("q5-gate-logical")
        return ([(int(r["auction"]), int(r["window_end"]),
                  int(r["bid_count"])) for r in sink.rows], res,
                [op.max_inflight_steps for op in ops])

    want, res0, credit0 = run(())
    got, res, credit = run((2,))
    assert credit0 == credit == [2]
    assert res0.metrics["batches"] == 4 and res.metrics["batches"] == 3 + 4
    assert res.metrics["devgen_host_batches"] == 1
    assert by_window(got) == by_window(want) and len(got) > 0


# -- validation and the other pipeline keys -----------------------------------

@pytest.mark.parametrize("conf,err,match", [
    ({"pipeline.sub-batches": 0}, ValueError, "sub-batches"),
    ({"pipeline.microbatch-size": 512, "pipeline.sub-batches": 3},
     ValueError, "must divide"),
    ({"pipeline.readiness": "telepathy"}, ValueError, "pipeline.readiness"),
    ({"host.fold-chunk-records": 0}, ValueError, "fold-chunk-records"),
    ({"pipeline.emit-defer": -5}, ValueError, "emit-defer"),
    ({"pipeline.source-prefetch": -1}, ValueError, "source-prefetch"),
    ({"pipeline.auto-watermark-interval": "-1 s"}, ValueError,
     "auto-watermark-interval"),
])
def test_driver_rejects(conf, err, match):
    """TestValidation's driver cases (tests/test_subbatch.py,
    tests/test_fire_gate.py), and the driver keys' own checks (an emit
    deferral below -1, a tree-fold chunk below 1)."""
    env = StreamExecutionEnvironment(Configuration(conf))
    (env.from_source(GeneratorSource(wc_gen),
                     WatermarkStrategy.for_monotonous_timestamps())
        .key_by("word").window(TumblingEventTimeWindows.of(500))
        .count().add_sink(CollectSink()))
    with pytest.raises(err, match=match):
        env.execute("bad", device="cpu")


def test_operator_rejects_unknown_readiness():
    with pytest.raises(ValueError, match="pipeline.readiness"):
        WindowOperator(TumblingEventTimeWindows.of(1_000), count(),
                       readiness="bogus", device="cpu")


@pytest.mark.parametrize("conf", [
    {"pipeline.auto-watermark-interval": "50 ms"},
    {"pipeline.object-reuse": "false"},
    {"pipeline.source-prefetch": 0},
    {"pipeline.source-prefetch": 5},
    {"pipeline.emit-defer": "0 ms"},
    {"pipeline.emit-defer": -1},
    {"pipeline.emit-defer": "100ms"},
])
def test_driver_keys_run_and_commit_the_same_rows(wc_reference, conf):
    """The four driver-level keys a reference conf may carry: each runs
    and commits the reference's rows in order. The watermark interval
    and object reuse are read and checked, as the reference reads them,
    and change nothing in either package; the prefetch sets the feeder
    thread's depth (0: none); an emit deferral above 0 holds each fire
    back that long and changes only when rows arrive, not which rows or
    their order."""
    got, _ = run_port_wc(1, conf)
    assert got == wc_reference[1]


def test_driver_keys_parse_and_reach_the_driver():
    """Durations read as the reference reads them; the prefetch depth and
    the readiness reach the driver and its window operator."""
    c = Configuration({"pipeline.auto-watermark-interval": "1.5 s",
                       "pipeline.emit-defer": "0ms",
                       "pipeline.object-reuse": "false",
                       "pipeline.source-prefetch": "0",
                       "pipeline.readiness": " Probe "})
    c.validate()
    assert c.get(PipelineOptions.AUTO_WATERMARK_INTERVAL) == 1_500
    assert c.get(PipelineOptions.EMIT_DEFER_MS) == 0
    assert c.get(PipelineOptions.OBJECT_REUSE) is False
    assert c.get(PipelineOptions.SOURCE_PREFETCH) == 0
    env = StreamExecutionEnvironment(c)
    wordcount(env, GeneratorSource(wc_gen),
              WatermarkStrategy.for_bounded_out_of_orderness(0), CollectSink(),
              TumblingEventTimeWindows)
    plan = compile_job(env._transforms, env._watermark_strategy)
    drv = Driver(plan, env.config, device="cpu")
    (op,) = drv._ops.values()
    assert drv._prefetch == 0 and op.readiness == "probe"
    assert op.external_throttle


# -- sessions: TestHostPlaneParity's second runner and TestSubbatchChaosK4 ------

def sess_gen(split, i):
    """tests/test_subbatch.py's sessions source: 6 batches of 256 users'
    events, disordered within 600 ms (no record is late)."""
    if i >= 6:
        return None
    rng = np.random.default_rng(500 + i)
    u = rng.integers(0, 30, 256).astype(np.int64)
    ts = (i * 400 + rng.integers(0, 600, 256)).astype(np.int64)
    return {"u": u}, ts


def run_sessions(P, k):
    env = P.Env(P.Conf({"state.num-key-shards": 8,
                        "state.slots-per-shard": 64,
                        "pipeline.microbatch-size": 256,
                        "pipeline.sub-batches": k}))
    sink = P.sinks.CollectSink()
    (env.from_source(P.GeneratorSource(sess_gen),
                     P.WM.for_bounded_out_of_orderness(600))
     .key_by("u").window(P.Sessions.with_gap(150)).allowed_lateness(1000)
     .count().add_sink(sink))
    P.execute(env, f"sess-sub{k}")
    return [(int(r["key"]), int(r["window_start"]), int(r["window_end"]),
             int(r["count"])) for r in sink.rows]


def per_key_sessions(rows):
    seq = collections.defaultdict(list)
    for k, s, e, c in rows:
        seq[k].append((s, e, c))
    return dict(seq)


@pytest.fixture(scope="module")
def sessions_reference():
    from test_torch_ckpt_pkgs import JAX

    return run_sessions(JAX, 1)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sessions_rows_and_per_key_order_at_every_k(sessions_reference, k):
    """TestHostPlaneParity's sessions runner: at every K the port commits
    the reference's K = 1 session rows, each key's in the same order."""
    from test_torch_ckpt_pkgs import PORT

    got = run_sessions(PORT, k)
    assert len(sessions_reference) > 0
    assert sorted(got) == sorted(sessions_reference)
    assert per_key_sessions(got) == per_key_sessions(sessions_reference)


def sessions_chaos_source(split, i):
    """tests/test_chaos.py TestHostPoolChaos's sessions source."""
    if i >= 8:
        return None
    rng = np.random.default_rng(500 + 1000 * int(split) + i)
    user = rng.integers(0, 30, 256).astype(np.int64)
    ts = (i * 400 + rng.integers(0, 600, 256)).astype(np.int64)
    return {"u": user}, ts


def sessions_builder(P, sink):
    def build_env(conf):
        env = P.Env(conf)
        (env.from_source(P.GeneratorSource(sessions_chaos_source),
                         P.WM.for_bounded_out_of_orderness(500))
         .key_by("u").window(P.Sessions.with_gap(150))
         .allowed_lateness(1000).count().add_sink(sink))
        return env
    return build_env


def session_view(sink):
    return sorted((int(r["key"]), int(r["window_start"]),
                   int(r["window_end"]), int(r["count"]))
                  for r in sink.committed)


def sessions_golden(P, tmp_path):
    """Fault-free at K = 4 and host.parallelism 1, checkpointing every
    batch boundary."""
    sink = P.sinks.TransactionalCollectSink()
    conf = P.Conf({"state.num-key-shards": 8, "state.slots-per-shard": 64,
                   "pipeline.microbatch-size": 256,
                   "execution.checkpointing.dir": str(tmp_path / "golden"),
                   "execution.checkpointing.interval": 1,
                   "host.parallelism": 1, "pipeline.sub-batches": 4})
    P.execute(sessions_builder(P, sink)(conf), "hostpool-golden")
    return session_view(sink)


def test_sessions_chaos_exactly_once_at_k4(tmp_path):
    """TestSubbatchChaosK4: the sessions job at K = 4 and
    host.parallelism 4, with a host.pool.task fault and a
    checkpoint-storage fault armed, commits the fault-free run's rows at
    the same K (which are the reference's), after one or two
    recoveries."""
    from test_torch_ckpt_pkgs import JAX, PORT

    golden = sessions_golden(PORT, tmp_path / "port")
    assert golden == sessions_golden(JAX, tmp_path / "jax") and golden
    sink = PORT.sinks.TransactionalCollectSink()
    conf = PORT.Conf({
        "state.num-key-shards": 8, "state.slots-per-shard": 64,
        "pipeline.microbatch-size": 128,
        "execution.checkpointing.dir": str(tmp_path / "chaos-ckpt"),
        "execution.checkpointing.interval": 1,
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 20,
        "restart-strategy.fixed-delay.delay": 1,
        "pipeline.sub-batches": 4, "host.parallelism": 4})
    plan = (PORT.faults.FaultPlan(seed=4321)
            .rule("host.pool.task", "raise", count=1, after=6)
            .rule("checkpoint.storage.write", "raise", count=1, after=1))
    tracer = PORT.tracing.tracer
    tracer.clear()
    with plan.activate():
        PORT.recover(sessions_builder(PORT, sink), conf, "hostpool-chaos")
    assert session_view(sink) == golden
    assert len(tracer.spans("fault")) == len(plan.log) == 2
    assert 1 <= len(tracer.spans("recovery")) <= 2


class TestCliSmoke:
    def test_wordcount_sub_batches_via_cli(self, tmp_path):
        """Bounded WordCount end to end with ``pipeline.sub-batches=4``
        through ``python -m flink_tpu_torch run --local``: the same
        committed total the reference job's K = 1 golden computes."""
        import runner_job_wordcount as job
        from test_torch_batch_mode import cli_wordcount_total

        out, total = cli_wordcount_total(
            tmp_path, "--job-id", "cli-sub-wc",
            "--conf", "pipeline.sub-batches=4")
        assert out["state"] == "FINISHED"
        assert out["records_in"] == 6 * job.BATCH
        assert total == job.golden_total(6)
