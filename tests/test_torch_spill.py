"""The host spill tier (``state.backend = spill``) and the drop policy
(``state.allow-drops``) in the port, against the JAX package on the same
seeded inputs: ``tests/test_spill.py``'s golden, coalesced-drain top-n
and checkpoint cases, on both key-table lanes (the C table, and the
numpy tables of ``numpy_host_paths``).

Rows must be equal in order and exactly: the spilled keys' lanes fold
on the host in numpy in both packages (the port's lift and finalize are
torch ops on the CPU), the device's fires here add integer-valued
floats only, and a top-n re-ranks the union of device winners and host
rows per fire."""
import numpy as np
import pytest

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import CollectSink as JaxCollectSink
from flink_tpu.api.sources import GeneratorSource as JaxGeneratorSource
from flink_tpu.api.windowing import (
    SlidingEventTimeWindows as JaxSliding,
    TumblingEventTimeWindows as JaxTumbling,
)
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops.window import FiredWindows as JaxFired
from flink_tpu.ops.window import WindowOperator as JaxWindowOperator
from flink_tpu.state.spill import HostSpillStore as JaxHostSpillStore
from flink_tpu.time.watermarks import WatermarkStrategy as JaxWatermarks
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import CollectSink
from flink_tpu_torch.api.sources import GeneratorSource
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.window import FiredWindows, WindowOperator
from flink_tpu_torch.state.spill import HostSpillStore
from flink_tpu_torch.time.watermarks import WatermarkStrategy
from test_torch_threads import capped_torch_threads  # noqa: F401

PORT = dict(env=StreamExecutionEnvironment, conf=Configuration,
            source=GeneratorSource, sink=CollectSink,
            wm=WatermarkStrategy, tumbling=TumblingEventTimeWindows,
            sliding=SlidingEventTimeWindows, aggs=ta, op=WindowOperator,
            fired=FiredWindows, run=dict(device="cpu"))
REF = dict(env=JaxEnv, conf=JaxConfiguration, source=JaxGeneratorSource,
           sink=JaxCollectSink, wm=JaxWatermarks, tumbling=JaxTumbling,
           sliding=JaxSliding, aggs=ja, op=JaxWindowOperator,
           fired=JaxFired, run={})


@pytest.fixture(params=["native", "numpy"])
def lane(request, monkeypatch):
    """Both packages on their C key tables, or both on their numpy
    tables."""
    if request.param == "numpy":
        from flink_tpu import native_codec
        from flink_tpu_torch import native_codec as port_native_codec

        for mod in (native_codec, port_native_codec):
            monkeypatch.setattr(
                mod.NativeHashTable, "create",
                classmethod(lambda cls, capacity_hint=1024: None))
    return request.param


def churn_source(n_batches=3, n_keys=1600, b=256):
    """``tests/test_spill.py``'s churn: ~100x the 16 resident slots."""
    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng(42 + i)
        return ({"k": rng.integers(0, n_keys, b).astype(np.int64),
                 "v": rng.integers(1, 100, b).astype(np.int64)},
                np.sort(rng.integers(i * 700, i * 700 + 1400, b))
                .astype(np.int64))
    return gen


def run_job(pkg, slots, build, window, src=None, backend="hbm", extra=None):
    conf = {"state.num-key-shards": 4, "state.slots-per-shard": slots,
            "state.backend": backend, "pipeline.microbatch-size": 256}
    conf.update(extra or {})
    env = pkg["env"](pkg["conf"](conf))
    sink = pkg["sink"]()
    s = (env.from_source(pkg["source"](src or churn_source()),
                         pkg["wm"].for_bounded_out_of_orderness(800))
         .key_by("k").window(window(pkg)))
    build(s, pkg["aggs"]).add_sink(sink)
    res = env.execute("spill-job", **pkg["run"])
    return sink.rows, res.metrics


def assert_rows_equal(got, want):
    """Sink rows equal in order, field by field, exactly."""
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.asarray(g[k]).tobytes() == np.asarray(w[k]).tobytes() \
                or g[k] == w[k], (k, g, w)


def canonical(rows):
    return sorted(tuple((k, float(v)) for k, v in sorted(r.items()))
                  for r in rows)


TUMBLING = lambda p: p["tumbling"].of(1_000)
SLIDING = lambda p: p["sliding"].of(2_000, 1_000)
LANES = lambda s, m: s.aggregate(m.multi(m.sum_of("v"), m.max_of("v"),
                                         m.avg_of("v")))


@pytest.mark.parametrize("job", ["count", "lanes"])
def test_spill_golden_matches_reference_and_roomy_run(lane, job):
    """16 resident slots, 1600 keys: the port's spill run equals the
    reference's spill run in order, and its own roomy run as a set."""
    build, window = ((lambda s, m: s.count()), TUMBLING) if job == "count" \
        else (LANES, SLIDING)
    want, wm = run_job(REF, 4, build, window, backend="spill")
    got, gm = run_job(PORT, 4, build, window, backend="spill")
    assert_rows_equal(got, want)
    assert gm["records_spilled"] == wm["records_spilled"] > 0
    assert gm["records_dropped_full"] == 0
    roomy, _ = run_job(PORT, 2048, build, window)
    assert canonical(roomy) == canonical(got)


def test_hbm_backend_refuses_then_drops_with_accounting(lane):
    build = lambda s, m: s.count()
    for pkg in (REF, PORT):
        with pytest.raises(RuntimeError, match="key directory shard full"):
            run_job(pkg, 4, build, TUMBLING)
    want, wm = run_job(REF, 4, build, TUMBLING,
                       extra={"state.allow-drops": True})
    got, gm = run_job(PORT, 4, build, TUMBLING,
                      extra={"state.allow-drops": True})
    assert_rows_equal(got, want)
    assert gm["records_dropped_full"] == wm["records_dropped_full"] > 0
    assert gm["records_spilled"] == 0


def test_late_within_lateness_refires_spilled_key(lane):
    def gen(split, i):
        if i == 0:  # 20 keys fill the 4 x 1 slots; most spill
            return ({"k": np.arange(20, dtype=np.int64)},
                    np.full(20, 500, np.int64))
        if i == 1:  # the watermark passes window [0, 1000): it fires
            return ({"k": np.array([100], np.int64)},
                    np.array([1_800], np.int64))
        if i == 2:  # late but allowed, for the spilled key 19
            return ({"k": np.array([19], np.int64)},
                    np.array([600], np.int64))
        return None

    def rows(pkg):
        conf = {"state.num-key-shards": 4, "state.slots-per-shard": 1,
                "state.backend": "spill", "pipeline.microbatch-size": 32}
        env = pkg["env"](pkg["conf"](conf))
        sink = pkg["sink"]()
        (env.from_source(pkg["source"](gen),
                         pkg["wm"].for_bounded_out_of_orderness(200))
         .key_by("k").window(pkg["tumbling"].of(1_000))
         .allowed_lateness(5_000).count().add_sink(sink))
        env.execute("late-spill", **pkg["run"])
        return sink.rows

    got, want = rows(PORT), rows(REF)
    assert_rows_equal(got, want)
    k19 = [int(r["count"]) for r in got
           if int(r["key"]) == 19 and int(r["window_end"]) == 1_000]
    assert k19 == [1, 2]


def test_topn_union_rerank_exact(lane):
    def gen(split, i):
        if i >= 4:
            return None
        rng = np.random.default_rng(9 + i)
        keys = rng.integers(0, 300, 200).astype(np.int64)
        return ({"k": keys, "v": np.ones(200, np.int64)},
                np.sort(rng.integers(i * 600, i * 600 + 1_200, 200))
                .astype(np.int64))

    build = lambda s, m: s.count().top(3, "count")
    want, wm = run_job(REF, 4, build, SLIDING, src=gen, backend="spill")
    got, gm = run_job(PORT, 4, build, SLIDING, src=gen, backend="spill")
    assert gm["records_spilled"] == wm["records_spilled"] > 0
    assert_rows_equal(got, want)
    roomy, _ = run_job(PORT, 2048, build, SLIDING, src=gen)
    assert canonical(roomy) == canonical(got)


def both_ops(agg, top_n, **kw):
    return [pkg["op"](pkg["tumbling"].of(1_000), agg(pkg["aggs"]),
                      top_n=top_n, spill=True, **kw, **(
                          {"device": "cpu"} if pkg is PORT else {}))
            for pkg in (REF, PORT)]


def test_union_rerank_survives_marker_coalescing(lane):
    rows = []
    for pkg, op in zip((REF, PORT), both_ops(
            lambda m: m.count(), ("count", 1), num_shards=1,
            slots_per_shard=1, max_out_of_orderness_ms=0)):
        # W1: resident key 7 (count 2) beats spilled key 50 (1)
        op.process_batch(np.array([7, 7, 50], np.int64),
                         np.array([100, 200, 300], np.int64), {})
        f1 = op.advance_watermark(1_500)
        # W2: spilled key 50 (count 5) beats resident 7 (1)
        op.process_batch(np.array([7, 50, 50, 50, 50, 50], np.int64),
                         np.array([1_100, 1_200, 1_200, 1_300, 1_300, 1_400],
                                  np.int64), {})
        f2 = op.advance_watermark(2_500)
        pkg["fired"].materialize_many([f1, f2])  # one coalesced poll
        rows.append([(int(k), int(w), int(c)) for f in (f1, f2)
                     for k, w, c in zip(f["key"], f["window_end"], f["count"])])
    assert rows[1] == rows[0] == [(7, 1_000, 2), (50, 2_000, 5)]


def test_refire_nonmonotone_rank_field_exact(lane):
    rows = []
    for pkg, op in zip((REF, PORT), both_ops(
            lambda m: m.avg_of("v"), ("avg_v", 1), num_shards=1,
            slots_per_shard=2, max_out_of_orderness_ms=0,
            allowed_lateness_ms=5_000)):
        # resident A=1 (avg 900), B=2 (600); spilled C=3 (100)
        op.process_batch(np.array([1, 2, 3], np.int64),
                         np.array([100, 200, 300], np.int64),
                         {"v": np.array([900, 600, 100], np.int64)})
        f1 = op.advance_watermark(1_500)
        # late within lateness: A drops to avg 500, the refire's winner
        # is B
        op.process_batch(np.array([1], np.int64), np.array([400], np.int64),
                         {"v": np.array([100], np.int64)})
        f2 = op.advance_watermark(1_500)
        pkg["fired"].materialize_many([f1, f2])
        rows.append([[(int(k), float(v)) for k, v in zip(f["key"], f["avg_v"])]
                     for f in (f1, f2)])
    assert rows[1] == rows[0] == [[(1, 900.0)], [(2, 600.0)]]


def test_misrouted_records_not_absorbed(monkeypatch):
    """A slot of -1 (a key outside the directory's range: the
    reference's misrouted record) is never absorbed by the store; it is
    dropped with accounting, as in the reference."""
    from flink_tpu.records import hash_keys_numpy

    ks = np.arange(200, dtype=np.int64)
    shards = hash_keys_numpy(ks) % 4
    inside, outside = ks[shards < 2][0], ks[shards >= 2][0]
    ref = JaxWindowOperator(JaxTumbling.of(1_000), ja.count(), num_shards=4,
                            slots_per_shard=8, shard_range=(0, 2), spill=True)
    port = WindowOperator(TumblingEventTimeWindows.of(1_000), ta.count(),
                          num_shards=4, slots_per_shard=8, spill=True,
                          device="cpu")
    assign = port.directory.assign
    monkeypatch.setattr(port.directory, "assign", lambda keys: np.where(
        keys == outside, -1, assign(keys)))
    for op in (ref, port):
        op.allow_drops = True
        op.process_batch(np.array([inside, outside], np.int64),
                         np.array([100, 100], np.int64), {})
        assert op.records_dropped_full == 1 and op.records_spilled == 0
        assert [int(k) for k in dict(op.advance_watermark(2_000))["key"]] \
            == [int(inside)]


def mk_pair(**kw):
    args = dict(num_shards=4, slots_per_shard=2, max_out_of_orderness_ms=500,
                spill=True, **kw)
    return (JaxWindowOperator(JaxTumbling.of(1_000), ja.count(), **args),
            WindowOperator(TumblingEventTimeWindows.of(1_000), ta.count(),
                           device="cpu", **args))


def test_snapshot_restore_roundtrip(lane):
    """Snapshot mid-stream with host-resident state, restore into a
    fresh operator and continue: rows equal the reference's
    uninterrupted run; the reference's snapshot loads into the port
    too."""
    import jax

    keys = np.arange(40, dtype=np.int64)
    ref, port = mk_pair()
    for op in (ref, port):
        op.process_batch(keys, np.full(40, 300, np.int64), {})
    snap = port.snapshot_state()
    assert snap["spill"]["records_spilled"] == 32
    jsnap = ref.snapshot_state()
    jsnap["panes"] = jax.tree_util.tree_map(np.asarray, jsnap["panes"])
    twins = [mk_pair()[1], mk_pair()[1]]
    twins[0].restore_state(snap)
    twins[1].load_jax_snapshot(jsnap)
    ref.process_batch(keys, np.full(40, 700, np.int64), {})
    want = dict(ref.advance_watermark(2_000))
    for t in twins:
        t.process_batch(keys, np.full(40, 700, np.int64), {})
        got = dict(t.advance_watermark(2_000))
        assert list(got) == list(want)
        for f in want:
            np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)
        assert t.records_spilled == ref.records_spilled == 64


def test_restore_into_hbm_backend_refuses_spill_state():
    a = WindowOperator(TumblingEventTimeWindows.of(1_000), ta.count(),
                       num_shards=1, slots_per_shard=1, spill=True,
                       device="cpu")
    a.process_batch(np.arange(10, dtype=np.int64), np.full(10, 100, np.int64),
                    {})
    b = WindowOperator(TumblingEventTimeWindows.of(1_000), ta.count(),
                       num_shards=1, slots_per_shard=1, device="cpu")
    with pytest.raises(ValueError, match="spill"):
        b.restore_state(a.snapshot_state())


def test_store_absorb_fire_purge_matches_reference():
    keys = np.array([5, 5, 9, 5, 11], np.int64)
    panes = np.array([0, 0, 0, 1, 1], np.int64)
    v = np.array([10.5, 20.0, 7.0, 3.25, -0.0], np.float32)
    out = []
    for st in (JaxHostSpillStore(ja.multi(ja.sum_of("v"), ja.max_of("v"),
                                          ja.avg_of("v"))),
               HostSpillStore(ta.multi(ta.sum_of("v"), ta.max_of("v"),
                                       ta.avg_of("v")))):
        st.absorb(keys, panes, {"v": v})
        out.append(st.fire([2], panes_per_window=2, pane_ms=1_000,
                           offset_ms=0, size_ms=2_000))
        st.purge_below(2)
        assert st.fire([2], 2, 1_000, 0, 2_000) is None
        assert st.records_spilled == 5
    want, got = out
    assert list(got) == list(want)
    for f in want:
        assert np.asarray(got[f]).tobytes() == np.asarray(want[f]).tobytes(), f
    # the store takes the driver's host pool: its chunked tree fold
    # (chunks of 2 records here) gives the same bytes
    from flink_tpu_torch.parallel.hostpool import HostPool

    pool = HostPool(2)
    try:
        st = HostSpillStore(ta.multi(ta.sum_of("v"), ta.max_of("v"),
                                     ta.avg_of("v")),
                            pool=pool, fold_chunk_records=2)
        st.absorb(keys, panes, {"v": v})
        par = st.fire([2], 2, 1_000, 0, 2_000)
    finally:
        pool.close()
    assert list(par) == list(want)
    for f in want:
        assert np.asarray(par[f]).tobytes() == np.asarray(want[f]).tobytes(), f


def test_device_made_source_is_fed_from_the_host_under_spill():
    """The reference declines to chain a device-made source into an
    operator with spill (its batches are made on the host instead); so
    does the port."""
    from flink_tpu_torch.nexmark.generator import (
        NexmarkConfig, bid_stream_device)

    src = bid_stream_device(NexmarkConfig(batch_size=256, n_batches=2,
                                          num_active_auctions=50))
    for spill in (False, True):
        op = WindowOperator(TumblingEventTimeWindows.of(1_000), ta.count(),
                            num_shards=8, slots_per_shard=16,
                            top_n=("count", 1), spill=spill, device="cpu")
        assert op.attach_device_source(src) is (not spill)


def test_count_window_drops_with_accounting_like_the_reference():
    """The drop policy on count windows: a full shard fails the batch by
    default; with drops allowed its records are dropped and counted,
    and the fires equal the reference's."""
    from flink_tpu.ops.count_window import CountWindowOperator as JaxCountWindow
    from flink_tpu_torch.ops.count_window import CountWindowOperator

    keys = np.repeat(np.arange(30, dtype=np.int64), 3)
    ts = np.arange(len(keys), dtype=np.int64)
    ops = (JaxCountWindow(ja.count(), 3, num_shards=2, slots_per_shard=4),
           CountWindowOperator(ta.count(), 3, num_shards=2, slots_per_shard=4,
                               device="cpu"))
    with pytest.raises(RuntimeError, match="key directory shard full"):
        ops[1].process_batch(keys, ts, {})
    ops = (JaxCountWindow(ja.count(), 3, num_shards=2, slots_per_shard=4),
           CountWindowOperator(ta.count(), 3, num_shards=2, slots_per_shard=4,
                               device="cpu"))
    fired = []
    for op in ops:
        op.allow_drops = True
        op.process_batch(keys, ts, {})
        fired.append(dict(op.take_fired()))
    assert ops[1].records_dropped_full == ops[0].records_dropped_full > 0
    want, got = fired
    for f in ("key", "count"):
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)
