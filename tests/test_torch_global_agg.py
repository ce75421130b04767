"""Unwindowed keyed running aggregation (``KeyedStream.running_aggregate``,
``ops/global_agg.py``) in the port, against the JAX package on the same
seeded inputs: ``tests/test_global_agg.py``'s ``TestDataStreamRunning``
and ``TestExactlyOnceRestore``, in upsert and in retract mode.
``TestSqlUnwindowed`` builds on Table/SQL, which is ROADMAP.md queue 1
item 7: it comes with that item.

Rows compare exactly and in order: keys, counts, op codes, and f32
max/min byte for byte. The ulp bound of the f32 sums is 0: both packages
lift to f32 and fold with the same numpy reduceat into float64
accumulators, then round to f32 at emission."""
import os

import numpy as np
import pytest

from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id
from test_torch_threads import capped_torch_threads  # noqa: F401

both = pytest.mark.parametrize("P", BOTH, ids=pkg_id)


def env_of(P, extra=None):
    return P.Env(P.Conf({
        "state.num-key-shards": 8, "state.slots-per-shard": 64,
        "pipeline.microbatch-size": 100, **(extra or {})}))


def data(n=1000, nk=20, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nk, n).astype(np.int64),
            rng.random(n).astype(np.float32),
            np.arange(n, dtype=np.int64))


def rows_bytes(rows):
    """Rows as (field, dtype, bytes) tuples, in order."""
    return [tuple((k, np.asarray(v).dtype.str, np.asarray(v).tobytes())
                  for k, v in sorted(r.items())) for r in rows]


def running(P, retract, seed=3):
    k, v, ts = data(seed=seed)
    env = env_of(P)
    raw = P.sinks.CollectSink()
    view = (P.sinks.RetractSink(key_fields=("key",)) if retract
            else P.sinks.UpsertSink(key_fields=("key",)))
    m = P.agg
    out = (env.from_collection({"k": k, "v": v}, ts, batch_size=100)
           .key_by("k")
           .running_aggregate(m.multi(m.count(), m.min_of("v"),
                                      m.max_of("v"), m.sum_of("v")),
                              retract=retract))
    out.add_sink(raw)
    out.add_sink(view)
    if retract:
        # the reference's analyzer refuses a retract stream into a
        # collect sink; the raw rows are what this case compares
        env.config.set("analysis.fail-on", "off")
    P.execute(env, "running-ds")
    return raw.rows, view.view(), (k, v)


@pytest.fixture(scope="module")
def runs():
    return {(P.name, retract): running(P, retract)
            for P in BOTH for retract in (False, True)}


@pytest.mark.parametrize("retract", [False, True], ids=["upsert", "retract"])
def test_running_aggregate_api(runs, retract):
    """Every emitted row (upserts, or -U/+U/+I changelog rows) equals
    the reference's in order and exactly; the materialized view is the
    oracle's per key."""
    raw, view, (k, v) = runs[("port", retract)]
    jraw, jview, _ = runs[("jax", retract)]
    assert rows_bytes(raw) == rows_bytes(jraw) and len(raw) > 0
    assert rows_bytes(sorted(view, key=lambda r: int(r["key"]))) == \
        rows_bytes(sorted(jview, key=lambda r: int(r["key"])))
    want = {}
    for kk, vv in zip(k, v):
        c, mn, mx = want.get(int(kk), (0, np.inf, -np.inf))
        want[int(kk)] = (c + 1, min(mn, float(vv)), max(mx, float(vv)))
    got = {int(r["key"]): (int(r["count"]), float(r["min_v"]),
                           float(r["max_v"])) for r in view}
    assert got == want
    if retract:
        ops = {int(r["__op__"]) for r in raw}
        assert ops == {0, 1, 2}  # +I, -U, +U


def crash_and_resume(P, root, restore_from=None):
    """TestExactlyOnceRestore: a poisoned sink fails the job at its 4th
    write; a second run resumes from the latest checkpoint (or the
    given one) and the upsert view holds every key's final aggregate."""
    n_batches, B, nk = 10, 256, 16

    def gen(split, i):
        if i >= n_batches:
            return None
        r = np.random.default_rng(40 + i)
        kk = r.integers(0, nk, B).astype(np.int64)
        vv = r.random(B).astype(np.float32)
        return ({"k": kk, "v": vv}, (i * B + np.arange(B)).astype(np.int64))

    base = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
            "pipeline.microbatch-size": B,
            "execution.checkpointing.dir": root}

    class Boom(Exception):
        pass

    sink = P.sinks.UpsertSink(key_fields=("key",))
    seen = [0]

    def poison(b):
        sink.write(b)
        seen[0] += 1
        if seen[0] == 4:
            raise Boom()

    def job(env, fn):
        m = P.agg
        (env.from_source(P.GeneratorSource(gen),
                         P.WM.for_monotonous_timestamps())
         .key_by("k")
         .running_aggregate(m.multi(m.count(), m.sum_of("v")))
         .add_sink(P.sinks.FnSink(fn)))

    if restore_from is None:
        env = P.Env(P.Conf({**base,
                            "execution.checkpointing.interval": "1ms"}))
        job(env, poison)
        with pytest.raises(Boom):
            P.execute(env, "crash")
        restore_from = "latest"
    env2 = P.Env(P.Conf({**base,
                         "execution.checkpointing.restore": restore_from}))
    job(env2, sink.write)
    P.execute(env2, "crash")
    all_k = np.concatenate([gen("0", i)[0]["k"] for i in range(n_batches)])
    all_v = np.concatenate([gen("0", i)[0]["v"] for i in range(n_batches)])
    return sorted(sink.view(), key=lambda r: int(r["key"])), (all_k, all_v)


def test_crash_resume_final_view_exact(tmp_path):
    """Each package's crash and resume ends on the same upsert view, key
    by key and byte for byte, and on the oracle's counts and sums (f64
    oracle sums within 1e-3 relative, as in the reference's case); the
    port resumes the JAX package's checkpoint to the same view."""
    got = {P.name: crash_and_resume(P, str(tmp_path / P.name))[0]
           for P in BOTH}
    assert rows_bytes(got["port"]) == rows_bytes(got["jax"])
    jroot = os.path.join(str(tmp_path / "jax"), "crash")
    chk = sorted((d for d in os.listdir(jroot) if d.startswith("chk-")),
                 key=lambda d: int(d.split("-")[1]))[0]
    crossed, (k, v) = crash_and_resume(PORT, str(tmp_path / "cross"),
                                       os.path.join(jroot, chk))
    assert rows_bytes(crossed) == rows_bytes(got["jax"])
    want = {}
    for kk, vv in zip(k, v):
        c, s = want.get(int(kk), (0, 0.0))
        want[int(kk)] = (c + 1, s + float(vv))
    view = {int(r["key"]): (int(r["count"]), float(r["sum_v"]))
            for r in got["port"]}
    assert set(view) == set(want)
    for kk, (c, s) in want.items():
        assert view[kk][0] == c
        assert view[kk][1] == pytest.approx(s, rel=1e-3)


@both
def test_running_aggregate_plan_node(P):
    """The plan's ``global_agg`` node and its row schema."""
    env = env_of(P)
    k, v, ts = data(n=10)
    (env.from_collection({"k": k, "v": v}, ts)
     .key_by("k").running_aggregate(P.agg.max_of("v"), retract=True)
     .add_sink(P.sinks.CollectSink()))
    if P is PORT:
        from flink_tpu_torch.graph.compiler import compile_job

        plan = compile_job(env._transforms, env._watermark_strategy)
    else:
        from flink_tpu.graph.compiler import compile_job

        plan = compile_job(env._transforms, env.config,
                           env._watermark_strategy)
    (node,) = [n for n in plan.nodes.values() if n.kind == "global_agg"]
    assert node.key_field == "k"
    assert node.out_schema == {"key": "int64", "count": "int64",
                               "max_v": "float32", "__op__": "int8"}
    if P is JAX:
        return
    assert node.window_transform.retract is True
