"""The adaptive microbatch debloater (``pipeline.target-latency``) in
the port, against the JAX package: ``tests/test_tracing_debloat.py``'s
``TestDebloater`` cases, each run on both packages. Off by default,
source batches pass whole; a target far below the fire-to-sink latency
re-chunks ingest without changing a committed row; the control law
halves the chunk on overshoot (down to its floor) and regrows it on
undershoot, step for step as the reference does."""
import time

import numpy as np
import pytest

from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id
from test_torch_threads import capped_torch_threads  # noqa: F401

both = pytest.mark.parametrize("P", BOTH, ids=pkg_id)


def slow_sink(P):
    """A collect sink whose every write takes 2 ms: each fire's
    fire-to-sink latency is then above a 1 ms target in either
    package, whatever the host's speed."""
    class SlowSink(P.sinks.CollectSink):
        def write(self, batch):
            time.sleep(0.002)
            super().write(batch)
    return SlowSink()


def run(P, conf_extra, sink=None):
    rng = np.random.default_rng(1)
    n = 120_000
    ts = np.sort(rng.integers(0, 60_000, n)).astype(np.int64)
    env = P.Env(P.Conf({
        "state.num-key-shards": 4, "state.slots-per-shard": 16,
        "pipeline.microbatch-size": 20_000, **conf_extra}))
    sink = sink or P.sinks.CollectSink()
    (env.from_collection({"k": rng.integers(0, 5, n).astype(np.int64)},
                         ts, batch_size=20_000)
     .key_by("k").window(P.Tumbling.of(1000)).count()
     .add_sink(sink))
    res = P.execute(env, "debloat")
    return res, sink, env


def key(rows):
    return sorted((int(r["key"]), int(r["window_end"]), int(r["count"]))
                  for r in rows)


@pytest.fixture(scope="module")
def plain_runs():
    """Each package's run without a target, once for the module."""
    return {P.name: run(P, {}) for P in BOTH}


@both
def test_off_by_default_single_batches(P, plain_runs):
    res, sink, _ = plain_runs[P.name]
    assert res.metrics["batches"] == 6  # source batches pass whole
    assert res.metrics["driver.debloat_chunk"] == 0


@both
def test_target_rechunk_exact_results(P, plain_runs):
    """An absurdly low target, below every fire's latency, drives the
    chunk down: the rows stay exactly those of the run without it, and
    the reference's."""
    _, sink_a, _ = plain_runs[P.name]
    res_b, sink_b, env = run(P, {"pipeline.target-latency": 1},
                             slow_sink(P))
    assert key(sink_a.rows) == key(sink_b.rows)
    assert key(sink_b.rows) == key(plain_runs[JAX.name][1].rows)
    # the chunk came down from the source batch, and the extra chunks
    # were pushed as batches
    assert 4096 <= env._driver._debloat_chunk < 20_000
    assert res_b.metrics["batches"] > 6


def make_driver(P):
    env = P.Env(P.Conf({"pipeline.target-latency": 100}))
    ts = np.arange(100, dtype=np.int64)
    (env.from_collection({"k": np.zeros(100, np.int64)}, ts)
     .key_by("k").window(P.Tumbling.of(10)).count()
     .add_sink(P.sinks.CollectSink()))
    if P is PORT:
        from flink_tpu_torch.graph.compiler import compile_job

        return P.driver.Driver(
            compile_job(env._transforms, env._watermark_strategy),
            env.config, device="cpu")
    from flink_tpu.graph.compiler import compile_job

    return P.driver.Driver(compile_job(env._transforms, env.config,
                                       env._watermark_strategy), env.config)


@both
def test_control_loop_halves_and_regrows(P):
    """Deterministic unit drive of the BufferDebloater control law:
    overshoot halves the chunk (floored), undershoot regrows it."""
    d = make_driver(P)
    d._debloat_min = 4
    data = {"k": np.arange(32, dtype=np.int64)}
    ts32 = np.arange(32, dtype=np.int64)
    seen = []

    # first batch seeds the chunk at the source batch size
    out = list(d._debloat_split(data, ts32))
    assert len(out) == 1 and d._debloat_chunk == 32
    seen.append(d._debloat_chunk)

    # overshoot: p99 of recent samples above target -> halve
    for _ in range(4):
        d._lat_hist.update(500.0)
    d._debloat_adjust()
    assert d._debloat_chunk == 16
    out = list(d._debloat_split(data, ts32))
    assert [len(t) for _, t in out] == [16, 16]
    # records preserved in order across chunks
    assert np.array_equal(np.concatenate([t for _, t in out]), ts32)
    assert np.array_equal(np.concatenate([c["k"] for c, _ in out]),
                          data["k"])

    # keep overshooting: floors at the minimum
    for _ in range(8):
        d._lat_hist.update(500.0)
        d._debloat_adjust()
        seen.append(d._debloat_chunk)
    assert d._debloat_chunk == 4

    # deep undershoot: regrows 2x per step
    for _ in range(16):
        d._lat_hist.update(1.0)
    d._debloat_adjust()
    assert d._debloat_chunk == 8
    seen.append(d._debloat_chunk)
    # one fresh sample is not enough to act on
    d._lat_hist.update(1.0)
    d._debloat_adjust()
    assert d._debloat_chunk == 8
    assert d.registry.snapshot()["driver.debloat_chunk"] == 8.0
    assert seen == [32, 16, 8, 8, 4, 4, 4, 4, 4, 8]
