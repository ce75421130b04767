"""The port's observability and configuration layer against the JAX
package's, on the CPU: metrics (counters, gauges, histograms, meters,
Prometheus text, the /metrics server), the tracer's spans and ring
(tests/test_metrics.py, test_tracing_debloat.py::TestTracer), the
driver's registry and checkpoint spans, the memory budget
(test_shuffle_memory.py::TestMemoryBudget), and the configuration keys
this slice ports — accepted with the reference's defaults — beside the
keys of later items, refused with the ROADMAP.md item that ports them."""
import threading
import urllib.request

import numpy as np
import pytest

from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id
from test_torch_threads import capped_torch_threads  # noqa: F401

both = pytest.mark.parametrize("P", BOTH, ids=pkg_id)


# -- metrics ------------------------------------------------------------------------

def drive_registry(P):
    m = P.metrics
    reg = m.MetricRegistry()
    g = reg.group("job", "task")
    c = g.counter("records")
    c.inc()
    c.inc(5)
    g.gauge("lag").set(42.0)
    h = g.histogram("lat")
    for v in range(100):
        h.update(float(v))
    state = {"v": 1.0}
    reg.group("g").gauge("x", lambda: state["v"])
    first = reg.snapshot()
    state["v"] = 7.0
    reg.group("driver").counter("records-in").inc(3)
    return (first, reg.snapshot(), reg.to_prometheus(),
            h.quantile_recent(0.5, window=10), h.mean)


def test_registry_matches_the_reference():
    got, want = drive_registry(PORT), drive_registry(JAX)
    assert got == want
    first, snap, text, recent, _ = got
    assert first["job.task.records"] == 6 and first["g.x"] == 1.0
    assert snap["g.x"] == 7.0 and snap["job.task.lat.count"] == 100
    assert 95 <= snap["job.task.lat.p99"] <= 99 and recent == 94.5
    assert "# TYPE flink_tpu_driver_records_in gauge" in text
    assert "flink_tpu_driver_records_in 3.0" in text


@both
def test_histogram_quantile_recent_window(P):
    """tests/test_tracing_debloat.py::TestHistogramRecent: the recent
    window's quantile follows the newest samples, the reservoir's the
    whole history."""
    h = P.metrics.Histogram(size=64)
    for _ in range(50):
        h.update(1000.0)
    for _ in range(16):
        h.update(10.0)
    assert h.quantile_recent(0.99, window=16) == pytest.approx(10.0)
    assert h.quantile(0.5) == pytest.approx(1000.0)


@both
def test_metrics_server_scrape(P):
    reg = P.metrics.MetricRegistry()
    reg.group("d").counter("n").inc(9)
    srv = P.metrics.MetricsServer(reg, 0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics").read().decode()
        assert "flink_tpu_d_n 9.0" in body
    finally:
        srv.close()


def test_the_driver_serves_metrics_while_it_runs():
    """``metrics.port``: the job's registry at /metrics while it runs,
    scraped from inside a sink; the server closes with the run and
    releases its port (the reference's close stops serving and leaves
    the socket to the collector), so a restarted attempt binds it."""
    import socket

    P = PORT

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    bodies = []

    def scrape(batch):
        bodies.append(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics").read().decode())

    env = P.Env(P.Conf({"state.num-key-shards": 8,
                        "state.slots-per-shard": 16,
                        "pipeline.microbatch-size": 64, "metrics.port": port}))
    (env.from_collection({"k": np.arange(200, dtype=np.int64) % 5},
                         np.arange(200, dtype=np.int64) * 20)
     .key_by("k").window(P.Tumbling.of(1000)).count()
     .add_sink(P.sinks.FnSink(scrape)))
    P.execute(env, "served")
    assert bodies and all("flink_tpu_driver_records_in" in b for b in bodies)
    with socket.socket() as again:  # the run released its port
        again.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        again.bind(("127.0.0.1", port))


def hammer(fn, threads=8, per_thread=5_000):
    start = threading.Barrier(threads)

    def work():
        start.wait()
        for _ in range(per_thread):
            fn()

    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def test_concurrent_writers_land_exactly():
    m = PORT.metrics
    c, h, g, mt = m.Counter(), m.Histogram(size=256), m.Gauge(), m.Meter()
    hammer(c.inc)
    hammer(lambda: h.update(1.0))
    assert c.value == 8 * 5_000 and h.count == 8 * 5_000
    assert h.quantile(0.5) == 1.0

    def touch():
        g.set(42.0)
        mt.mark()
        mt.rate  # a reader racing the marker's head-pop

    hammer(touch, per_thread=200)
    assert g.value == 42.0 and mt.rate > 0.0


def test_job_result_carries_the_reference_metrics():
    """The driver's registry lands in the JobResult under the
    reference's names."""
    out = {}
    for P in BOTH:
        env = P.Env(P.Conf({"state.num-key-shards": 8,
                            "state.slots-per-shard": 16,
                            "pipeline.microbatch-size": 64}))
        sink = P.sinks.CollectSink()
        (env.from_collection({"k": np.arange(100, dtype=np.int64) % 5},
                             np.arange(100, dtype=np.int64) * 20)
         .key_by("k").window(P.Tumbling.of(1000)).count().add_sink(sink))
        out[P.name] = P.execute(env, "m").metrics
    keys = ("records_in", "fired_windows", "driver.records_in",
            "driver.records_out", "driver.fired_windows",
            "driver.emit_latency_ms.count", "driver.records_dropped_full",
            "memory.hbm_state_bytes")
    for k in keys:
        assert k in out["port"], k
    for k in keys[:-2]:
        assert out["port"][k] == out["jax"][k], k
    assert out["port"]["records_in"] == 100
    assert "driver.emit_latency_ms.p99" in out["port"]
    assert out["port"]["memory.hbm_state_bytes"] > 0


# -- tracing ------------------------------------------------------------------------

@both
def test_tracer_spans_errors_and_ring(P):
    t = P.tracing.Tracer()
    seen = []
    t.add_reporter(seen.append)
    t.add_reporter(lambda s: 1 / 0)  # a failing reporter breaks nothing
    with t.span("checkpoint.freeze", checkpoint_id=7) as sp:
        sp.set("bytes", 123)
    (s,) = t.spans("checkpoint")
    assert s["name"] == "checkpoint.freeze"
    assert s["attributes"] == {"checkpoint_id": 7, "bytes": 123}
    assert s["duration_ms"] >= 0 and seen[0].name == "checkpoint.freeze"
    with pytest.raises(ValueError):
        with t.span("x"):
            raise ValueError("boom")
    assert "ValueError" in t.spans("x")[0]["attributes"]["error"]
    small = P.tracing.Tracer(capacity=8)
    for i in range(20):
        with small.span(f"s{i}"):
            pass
    assert [x["name"] for x in small.spans()] == [f"s{i}" for i in range(12, 20)]


@both
def test_checkpoints_emit_freeze_and_persist_spans(P, tmp_path):
    tracer = P.tracing.tracer
    tracer.clear()
    rng = np.random.default_rng(0)
    ts = np.sort(rng.integers(0, 4000, 1000)).astype(np.int64)
    env = P.Env(P.Conf({
        "state.num-key-shards": 4, "state.slots-per-shard": 16,
        "pipeline.microbatch-size": 250,
        "execution.checkpointing.dir": str(tmp_path),
        "execution.checkpointing.interval": 1}))
    (env.from_collection({"k": rng.integers(0, 5, 1000).astype(np.int64)},
                         ts, batch_size=250)
     .key_by("k").window(P.Tumbling.of(1000)).count()
     .add_sink(P.sinks.CollectSink()))
    P.execute(env, "traced")
    freezes = tracer.spans("checkpoint.freeze")
    persists = tracer.spans("checkpoint.persist")
    assert freezes and persists
    assert all(s["duration_ms"] is not None for s in freezes + persists)
    assert all(s["attributes"]["bytes"] > 0 for s in persists)
    stats = env._driver._coordinator.stats
    assert [s.checkpoint_id for s in stats] == \
        [s["attributes"]["checkpoint_id"] for s in persists]


# -- memory -------------------------------------------------------------------------

def test_memory_budget_matches_the_reference():
    from flink_tpu.memory import InsufficientMemoryError as JaxErr
    from flink_tpu.memory import MemoryBudget as JaxBudget
    from flink_tpu_torch.memory import InsufficientMemoryError, MemoryBudget

    b = MemoryBudget(0)
    b.register("w", 10 ** 12)
    b.check()
    msgs = []
    for budget, err in ((MemoryBudget(1000), InsufficientMemoryError),
                        (JaxBudget(1000), JaxErr)):
        budget.register("window:big", 900, "layout=...")
        budget.register("window:small", 200)
        with pytest.raises(err, match="window:big") as ei:
            budget.check()
        msgs.append(str(ei.value))
        assert budget.breakdown()[0]["name"] == "window:big"
    assert msgs[0] == msgs[1]


@both
def test_driver_budget_is_enforced_at_build(P):
    def build(budget):
        env = P.Env(P.Conf({"state.num-key-shards": 8,
                            "state.slots-per-shard": 128,
                            "memory.hbm-budget": budget}))
        ts = np.arange(100, dtype=np.int64)
        (env.from_collection({"k": np.zeros(100, np.int64)}, ts)
         .key_by("k").window(P.Tumbling.of(1000)).count()
         .add_sink(P.sinks.CollectSink()))
        return env

    P.execute(build(0), "fits")
    with pytest.raises(Exception, match="exceeds the memory.hbm-budget"):
        P.execute(build(100), "too-small")


def test_port_footprints_count_its_device_tensors():
    """The window operator's footprint: pane lanes and counts of a
    block, and with top-n its emit ring and the fused step's pair
    uploads; the count window's: its lanes and counts."""
    from flink_tpu_torch.ops import window as pw

    op = PORT.WindowOperator(PORT.Sliding.of(4000, 1000), PORT.agg.count(),
                             num_shards=4, slots_per_shard=32, device="cpu")
    lay = op.layout
    assert op.hbm_bytes() == (4 * 32 + 1) * lay.ring * 4 == lay.bytes()
    top = PORT.WindowOperator(PORT.Sliding.of(4000, 1000), PORT.agg.count(),
                              num_shards=4, slots_per_shard=32,
                              top_n=("count", 1), device="cpu")
    ring = (top.EMIT_RING_ROWS + 2) * 3 * 4
    assert top.hbm_bytes() == lay.bytes() + ring + \
        pw.PAIR_SLOTS * pw.PAIR_SLOT_BYTES
    cw = PORT.CountWindowOperator(PORT.agg.count(), 3, num_shards=4,
                                  slots_per_shard=32, device="cpu")
    assert cw.hbm_bytes() == (4 * 32 + 1) * 4


# -- configuration --------------------------------------------------------------------

PORTED = {
    "execution.checkpointing.interval": "10 s",
    "execution.checkpointing.dir": "/tmp/x",
    "execution.checkpointing.num-retained": 2,
    "execution.checkpointing.incremental": "false",
    "execution.checkpointing.compression": "zlib",
    "execution.checkpointing.restore": "latest",
    "execution.checkpointing.tolerable-failures": 3,
    "restart-strategy.type": "fixed-delay",
    "restart-strategy.fixed-delay.attempts": 5,
    "restart-strategy.fixed-delay.delay": "2 s",
    "metrics.port": 0,
    "metrics.bind-address": "0.0.0.0",
    "faults.seed": 9,
    "faults.inject": "checkpoint.upload=raise x1",
    "memory.hbm-budget": 1 << 30,
    "host.parallelism": 3,
    "host.fold-chunk-records": 4096,
    "cluster.num-processes": 3,
    "cluster.process-id": 2,
    "cluster.dcn-peers": "127.0.0.1:7001,127.0.0.1:7002,127.0.0.1:7003",
    "cluster.dcn-port": 7003,
    "cluster.dcn-secret": "s3cret",
    "cluster.dcn-overlap": "false",
    "cluster.dcn-overlap-drain": "false",
    "cluster.dcn-io-threads": 2,
    "cluster.dcn-buffer-bytes": 1 << 22,
    "cluster.dcn-bind": "0.0.0.0",
    "cluster.rescale-from": "/ckpt/job-p0/chk-4,/ckpt/job-p1/chk-4",
}


def test_ported_keys_read_as_the_reference_reads_them():
    from flink_tpu import config as jc
    from flink_tpu import faults as jf
    from flink_tpu.obs import metrics as jm
    from flink_tpu_torch import config as pc

    pairs = [
        (pc.CheckpointingOptions.INTERVAL, jc.CheckpointingOptions.INTERVAL),
        (pc.CheckpointingOptions.DIRECTORY, jc.CheckpointingOptions.DIRECTORY),
        (pc.CheckpointingOptions.RETAINED, jc.CheckpointingOptions.RETAINED),
        (pc.CheckpointingOptions.INCREMENTAL,
         jc.CheckpointingOptions.INCREMENTAL),
        (pc.CheckpointingOptions.COMPRESSION,
         jc.CheckpointingOptions.COMPRESSION),
        (pc.CheckpointingOptions.RESTORE, jc.CheckpointingOptions.RESTORE),
        (pc.CheckpointingOptions.TOLERABLE_FAILURES,
         jc.CheckpointingOptions.TOLERABLE_FAILURES),
        (pc.RestartOptions.STRATEGY, jc.ClusterOptions.RESTART_STRATEGY),
        (pc.RestartOptions.ATTEMPTS, jc.ClusterOptions.RESTART_ATTEMPTS),
        (pc.RestartOptions.DELAY, jc.ClusterOptions.RESTART_DELAY),
        (pc.MetricsOptions.PORT, jm.METRICS_PORT),
        (pc.MetricsOptions.BIND, jm.METRICS_BIND),
        (pc.FaultOptions.SEED, jf.FAULT_SEED),
        (pc.FaultOptions.INJECT, jf.FAULT_INJECT),
        (pc.MemoryOptions.HBM_BUDGET, jc.MemoryOptions.HBM_BUDGET),
        (pc.HostOptions.PARALLELISM, jc.HostOptions.PARALLELISM),
        (pc.HostOptions.FOLD_CHUNK_RECORDS, jc.HostOptions.FOLD_CHUNK_RECORDS),
        (pc.ClusterOptions.NUM_PROCESSES, jc.ClusterOptions.NUM_PROCESSES),
        (pc.ClusterOptions.PROCESS_ID, jc.ClusterOptions.PROCESS_ID),
        (pc.ClusterOptions.DCN_PEERS, jc.ClusterOptions.DCN_PEERS),
        (pc.ClusterOptions.DCN_PORT, jc.ClusterOptions.DCN_PORT),
        (pc.ClusterOptions.DCN_SECRET, jc.ClusterOptions.DCN_SECRET),
        (pc.ClusterOptions.DCN_OVERLAP, jc.ClusterOptions.DCN_OVERLAP),
        (pc.ClusterOptions.DCN_OVERLAP_DRAIN,
         jc.ClusterOptions.DCN_OVERLAP_DRAIN),
        (pc.ClusterOptions.DCN_IO_THREADS, jc.ClusterOptions.DCN_IO_THREADS),
        (pc.ClusterOptions.DCN_BUFFER_BYTES,
         jc.ClusterOptions.DCN_BUFFER_BYTES),
        (pc.ClusterOptions.DCN_BIND, jc.ClusterOptions.DCN_BIND),
        (pc.ClusterOptions.RESCALE_FROM, jc.ClusterOptions.RESCALE_FROM),
    ]
    assert {p.key for p, _ in pairs} == set(PORTED)
    pconf, jconf = pc.Configuration(dict(PORTED)), jc.Configuration(dict(PORTED))
    pconf.validate()
    for p, j in pairs:
        assert p.key == j.key and p.default == j.default, p.key
        assert pconf.get(p) == jconf.get(j), p.key
        assert pc.Configuration().get(p) == jc.Configuration().get(j)


@pytest.mark.parametrize("conf,err,match", [
    ({"execution.checkpointing.compression": "lz9"}, ValueError,
     "compression"),
    ({"execution.checkpointing.interval": -5}, ValueError, "interval"),
    ({"execution.checkpointing.tolerable-failures": -1}, ValueError,
     "tolerable-failures"),
    ({"restart-strategy.type": "sometimes"}, ValueError, "restart-strategy"),
    ({"memory.hbm-budget": -1}, ValueError, "hbm-budget"),
    ({"metrics.port": 70000}, ValueError, "metrics.port"),
    ({"cluster.num-processes": 2, "cluster.process-id": 2}, ValueError,
     "process-id"),
    ({"cluster.num-processes": 0}, ValueError, "num-processes"),
    ({"cluster.dcn-port": 70000}, ValueError, "dcn-port"),
    ({"cluster.dcn-io-threads": -1}, ValueError, "dcn-io-threads"),
])
def test_bad_values_of_ported_keys_are_refused(conf, err, match):
    from flink_tpu_torch.config import Configuration

    with pytest.raises(err, match=match):
        Configuration(conf).validate()


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_host_keys_are_read_and_take_effect(workers):
    """host.parallelism (once refused as a key of queue 1 item 5) sizes
    the driver's one host pool, which the spill store and the host
    operators share; host.fold-chunk-records reaches the stores. A value
    below 1 fails where the reference's does: when the pool is built
    (the reference leaves the config check to its plan analyzer)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import CollectSink
    from flink_tpu_torch.api.sources import GeneratorSource
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.graph.compiler import compile_job
    from flink_tpu_torch.runtime.driver import Driver

    def build(conf):
        env = StreamExecutionEnvironment(Configuration(conf))
        (env.from_source(GeneratorSource(lambda s, i: None))
         .key_by("k").window(TumblingEventTimeWindows.of(1000)).count()
         .add_sink(CollectSink()))
        (env.from_source(GeneratorSource(lambda s, i: None))
         .window_all(TumblingEventTimeWindows.of(1000)).count()
         .add_sink(CollectSink()))
        return Driver(compile_job(env._transforms, env._watermark_strategy),
                      env.config, device="cpu")

    drv = build({"host.parallelism": workers, "state.backend": "spill",
                 "host.fold-chunk-records": 1000})
    try:
        assert drv.host_pool.parallelism == workers
        assert (drv.host_pool._executor is None) == (workers == 1)
        win, wall = drv._ops.values()
        for store in (win._spill, wall.store):
            assert store._pool is (drv.host_pool if workers > 1 else None)
            assert store.fold_chunk_records == 1000
        assert drv.registry.snapshot()["hostpool.parallelism"] == workers
    finally:
        drv.host_pool.close()
    Configuration({"host.parallelism": 0}).validate()
    for bad, match in (({"host.parallelism": 0}, "host.parallelism"),
                       ({"host.fold-chunk-records": 0},
                        "host.fold-chunk-records")):
        with pytest.raises(ValueError, match=match):
            build(bad)


@pytest.mark.parametrize("key,item", [
    ("heartbeat.timeout", "queue 1 item 10"),
    ("source.enumeration", "queue 1 item 10"),
    ("rescale.mode", "queue 1 item 10"),
    ("analysis.max-state-bytes-per-key", "queue 1 item 11"),
    ("cluster.job-id", "queue 1 item 10"),
    ("heartbeat.interval", "queue 1 item 10"),
    ("pipeline.profile-steps", "queue 1 item 11"),
    ("cluster.dcn-host", "queue 1 item 10"),
    ("cluster.dcn-rendezvous", "queue 1 item 10"),
    ("session.slots-per-job", "queue 1 item 10"),
    ("high-availability.dir", "queue 1 item 10"),
    ("cluster.attempt", "queue 1 item 10"),
    ("pipeline.profile-dir", "queue 1 item 11"),
])
def test_keys_of_later_items_name_their_item(key, item):
    """A key the reference reads and the port does not yet is refused,
    naming the ROADMAP.md item that brings it; a key neither reads is
    refused as unknown."""
    from flink_tpu import config as jc
    from flink_tpu_torch.config import Configuration

    assert key in jc._REGISTRY or key == "cluster.attempt"
    with pytest.raises(NotImplementedError, match=f"{key} .*{item}"):
        Configuration({key: "1"}).validate()
    with pytest.raises(ValueError, match="not supported"):
        Configuration({"no.such.key": 1}).validate()


@pytest.mark.parametrize("key", [
    "pipeline.target-latency", "state.memory-budget-bytes",
    "state.lsm.dir", "state.lsm.compact-min-runs",
    "state.lsm.run-floor-bytes", "cluster.rescale-from", "plugins.modules",
    "execution.runtime-mode", "execution.batch.shuffle-dir",
    "execution.batch.shuffle-partitions", "execution.batch.shuffle-cleanup"])
def test_ported_keys_take_the_reference_default_and_text(key):
    """The keys of the debloater, the LSM tier, the rescale restore, the
    filesystem plugins and batch mode are read by the port, with the JAX
    package's default and description."""
    from flink_tpu import config as jc
    from flink_tpu_torch import config as pc

    ref, port = jc._REGISTRY[key], pc._REGISTRY[key]
    assert (port.default, port.description) == (ref.default,
                                                ref.description)
    pc.Configuration({key: ref.default}).validate()
    pc.Configuration({"state.backend": "lsm"}).validate()


LOG_KEYS = (
    "log.dir", "log.partitions", "log.segment-records", "log.fsync-mode",
    "log.zero-copy", "log.read-batch-records", "log.prefetch-segments",
    "log.compaction.key-field", "log.compaction.min-segments",
    "log.retention.ms", "log.retention.ts-field", "log.retention.bytes",
    "log.lease.ttl-ms", "log.group.name", "log.group.member",
    "log.group.members", "log.group.member-id", "log.cleaner.enabled",
    "log.cleaner.interval-ms", "log.cleaner.lease-ttl-ms",
    "storage.enospc-policy", "storage.enospc-retries",
    "storage.enospc-backoff-ms")


@pytest.mark.parametrize("key", LOG_KEYS)
def test_log_and_enospc_keys_are_read_with_the_reference_default(key):
    """The log tier's 20 ``log.*`` keys and the three
    ``storage.enospc-*`` keys are read by the port, with the JAX
    package's default, and no longer name an item."""
    from flink_tpu import config as jc
    from flink_tpu_torch import config as pc

    ref, port = jc._REGISTRY[key], pc._REGISTRY[key]
    assert port.default == ref.default and port.description
    assert pc.later_item(key) is None
    conf = pc.Configuration({key: ref.default})
    conf.validate()
    assert conf.get(port) == jc.Configuration({key: ref.default}).get(ref)


def test_every_log_key_of_the_reference_is_listed():
    from flink_tpu import config as jc

    assert sorted(LOG_KEYS) == sorted(
        k for k in jc._REGISTRY
        if k.startswith(("log.", "storage.enospc-")))


@pytest.mark.parametrize("conf,policy", [
    ({}, {"mode": "retry", "retries": 4, "backoff_ms": 50.0}),
    ({"storage.enospc-policy": "fail"},
     {"mode": "fail", "retries": 4, "backoff_ms": 50.0}),
    ({"storage.enospc-retries": "2", "storage.enospc-backoff-ms": "5"},
     {"mode": "retry", "retries": 2, "backoff_ms": 5.0}),
])
def test_the_driver_installs_the_enospc_policy_as_the_reference_does(
        conf, policy):
    """``install_enospc_policy_from_config`` reads the three keys as the
    reference's does, and a config that sets none of them leaves the
    process's policy as it is."""
    from flink_tpu import config as jc
    from flink_tpu import fs as jfs
    from flink_tpu_torch import config as pc
    from flink_tpu_torch import fs as pfs

    try:
        for fs, cfg in ((pfs, pc), (jfs, jc)):
            fs.install_enospc_policy()
            fs.install_enospc_policy_from_config(cfg.Configuration(conf))
            assert fs.enospc_policy() == policy
        with pytest.raises(ValueError, match="enospc-policy"):
            pfs.install_enospc_policy_from_config(pc.Configuration(
                {"storage.enospc-policy": "sometimes"}))
    finally:
        pfs.install_enospc_policy()
        jfs.install_enospc_policy()


def test_every_reference_key_is_ported_or_names_its_item():
    """Each key the JAX package registers is read by the port or is
    refused naming the ROADMAP.md item that ports it."""
    from flink_tpu import config as jc
    from flink_tpu import faults as _jf  # noqa: F401 (registers faults.*)
    from flink_tpu.obs import metrics as _jm  # noqa: F401 (metrics.*)
    from flink_tpu_torch import config as pc

    left = [k for k in sorted(jc._REGISTRY)
            if k not in pc._REGISTRY and pc.later_item(k) is None]
    assert left == []
