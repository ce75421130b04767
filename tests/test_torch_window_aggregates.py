"""Keyed window aggregates without top-n — count (WordCount), sum, max,
min, avg and multi — through the port's WindowOperator and
``env.execute(device="cpu")``, against the JAX package fed the same
batches.

Rows must be equal in order: key, window bounds, count and every
integer or max/min field exactly (NaN-aware), every sum or avg field
within |port - ref| <= (2 * count + 4) * 2^-24 * |ref| (the error of
adding the same positive terms in another order, plus one rounding of
the division; the scatters add in the reference's order, the fire's
column sum may associate differently). Both packages run on their
numpy host paths (see tests/test_torch_window_operator.py);
tests/test_torch_native_lane.py runs the native lanes."""
import jax
import numpy as np
import pytest
import torch

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import CollectSink as JaxCollectSink
from flink_tpu.api.sources import GeneratorSource as JaxGeneratorSource
from flink_tpu.api.windowing import (
    SlidingEventTimeWindows as JaxSliding,
    TumblingEventTimeWindows as JaxTumbling,
)
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops.window import WindowOperator as JaxWindowOperator
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
from flink_tpu_torch.ops.window import WindowOperator
from flink_tpu_torch.time.watermarks import WatermarkStrategy
from test_torch_threads import capped_torch_threads  # noqa: F401

U = 2.0 ** -24
KEY_COLS = ("key", "window_start", "window_end", "count")


@pytest.fixture
def numpy_host_paths(monkeypatch):
    """Both packages on their numpy host paths: neither directory gets
    its C key table, so neither takes its native lane."""
    from flink_tpu import native_codec
    from flink_tpu_torch import native_codec as port_native_codec

    for mod in (native_codec, port_native_codec):
        monkeypatch.setattr(mod.NativeHashTable, "create",
                            classmethod(lambda cls, capacity_hint=1024: None))


AGGS = {
    "count": lambda m: m.count(),
    "count_named": lambda m: m.count("n"),
    "sum": lambda m: m.sum_of("price"),
    "lanes": lambda m: m.multi(m.count(), m.sum_of("price"),
                               m.max_of("price"), m.min_of("price")),
    "avg": lambda m: m.multi(m.count(), m.avg_of("price")),
    "max_min": lambda m: m.multi(m.max_of("price"), m.min_of("bid")),
}


def assert_rows_match(got, ref):
    """``got``/``ref``: dicts of columns (a fired batch or a sink's
    concatenated rows). Rows equal in order under the module's rules."""
    assert sorted(got) == sorted(ref)
    n = len(ref["window_end"])
    assert len(got["window_end"]) == n
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        if k.startswith(("sum", "avg")):
            cnt = np.asarray(ref["count"], np.float64) if "count" in ref \
                else np.zeros(n)
            bound = (2 * cnt + 4) * U * np.abs(r.astype(np.float64))
            assert (np.abs(g.astype(np.float64) - r) <= bound).all(), k
        else:
            # an empty batch's float fields are f64 in the reference (its
            # empty lanes are made with jnp's x64 default dtype)
            assert g.dtype == r.dtype or n == 0, k
            np.testing.assert_array_equal(g, r, err_msg=k)


def make_pair(agg, size, slide, *, shards=8, slots=64, ooo=0, lateness=0):
    kw = dict(num_shards=shards, slots_per_shard=slots,
              max_out_of_orderness_ms=ooo, allowed_lateness_ms=lateness)
    if slide is None:
        ref = JaxWindowOperator(JaxTumbling.of(size), AGGS[agg](ja), **kw)
        port = WindowOperator(TumblingEventTimeWindows.of(size), AGGS[agg](ta),
                              device="cpu", **kw)
    else:
        ref = JaxWindowOperator(JaxSliding.of(size, slide), AGGS[agg](ja),
                                **kw)
        port = WindowOperator(SlidingEventTimeWindows.of(size, slide),
                              AGGS[agg](ta), device="cpu", **kw)
    return ref, port


def bid_data(rng, n, n_keys):
    return {"price": np.round(np.exp(rng.normal(6.0, 1.0, n)),
                              2).astype(np.float32),
            "bid": rng.integers(0, 10**6, n).astype(np.int64)}


def drive(ref, port, steps):
    """Apply (batch | watermark) steps to both operators, comparing every
    advance's fired rows in order; then the end-of-input flush and the
    final state."""
    n_rows = 0
    for step in steps:
        if step[0] == "batch":
            _, keys, ts, data = step
            ref.process_batch(keys, ts, data)
            port.process_batch(keys, ts, data)
        else:
            b = dict(port.advance_watermark(step[1]))
            assert_rows_match(b, dict(ref.advance_watermark(step[1])))
            n_rows += len(b["window_end"])
    assert port.final_watermark() == ref.final_watermark()
    b = dict(port.advance_watermark(port.final_watermark()))
    assert_rows_match(b, dict(ref.advance_watermark(ref.final_watermark())))
    n_rows += len(b["window_end"])
    assert port.plan.ring == ref.plan.ring
    np.testing.assert_array_equal(port.state.counts.numpy(),
                                  np.asarray(ref.state.counts))
    for lane in ("maxs", "mins"):
        p, r = getattr(port.state, lane), getattr(ref.state, lane)
        assert (p is None) == (r is None)
        if p is not None:
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert port.late_records == ref.late_records
    return n_rows


def ooo_steps(rng, n_batches, batch, keys, span_ms, ooo_ms, start=50_000):
    steps, t, max_ts = [], start, start
    for _ in range(n_batches):
        ts = (t + rng.integers(-ooo_ms, span_ms, batch)).astype(np.int64)
        k = (rng.zipf(1.6, batch) % keys).astype(np.int64)
        steps.append(("batch", k, ts, bid_data(rng, batch, keys)))
        max_ts = max(max_ts, int(ts.max()))
        steps.append(("wm", max_ts - ooo_ms - 1))
        t += span_ms
    return steps


@pytest.mark.parametrize("agg", sorted(AGGS))
def test_sliding_out_of_order_matches_reference(numpy_host_paths, agg):
    """Sliding 10 s / 1 s, out-of-order batches of 2.5 s, a watermark
    after each: advances fire 2-4 windows, so some fires take one
    fire_pack chunk and the end flush several."""
    rng = np.random.default_rng(sorted(AGGS).index(agg))
    ref, port = make_pair(agg, 10_000, 1_000, ooo=1_000)
    assert drive(ref, port, ooo_steps(rng, 8, 3000, 80, 2_500, 1_000)) > 50


@pytest.mark.parametrize("agg", ["count", "lanes", "avg"])
def test_ring_growth_and_chunked_fires_match_reference(numpy_host_paths,
                                                       agg):
    """A 40 s batch grows the ring (every lane moves); the advance after
    it fires more than 4 windows, chunk after chunk (rows in order)."""
    rng = np.random.default_rng(3)
    ref, port = make_pair(agg, 10_000, 1_000, ooo=1_000)
    steps = ooo_steps(rng, 2, 2000, 40, 2_000, 500)
    ts = (54_000 + np.sort(rng.integers(0, 40_000, 6000))).astype(np.int64)
    steps += [("batch", rng.integers(0, 50, 6000).astype(np.int64), ts,
               bid_data(rng, 6000, 50)), ("wm", 90_000)]
    steps += ooo_steps(rng, 3, 2000, 40, 2_000, 500, start=94_000)
    drive(ref, port, steps)
    assert port.plan.ring > 16


@pytest.mark.parametrize("agg", ["count", "avg", "sum"])
def test_preagg_gate_both_branches(numpy_host_paths, agg):
    """A small batch takes the per-record upload, a large one over few
    keys the host-combined pairs (scatter_pair_lanes when there are sum
    lanes); both match."""
    rng = np.random.default_rng(5)
    ref, port = make_pair(agg, 1_000, None)
    keys, ts = rng.integers(0, 20, 50), rng.integers(0, 3000, 50)
    data = bid_data(rng, 50, 20)
    ref.process_batch(keys, ts, data)
    port.process_batch(keys, ts, data)
    assert "pb_pack" in port.prof and "preagg_combine" not in port.prof
    assert_rows_match(dict(port.advance_watermark(1_500)),
                      dict(ref.advance_watermark(1_500)))
    keys = rng.integers(0, 30, 20_000)
    ts = 2_000 + rng.integers(0, 3000, 20_000)
    data = bid_data(rng, 20_000, 30)
    ref.process_batch(keys, ts, data)
    port.process_batch(keys, ts, data)
    assert "preagg_combine" in port.prof
    drive(ref, port, [("wm", 4_200)])


def test_allowed_lateness_refires_with_lanes(numpy_host_paths):
    rng = np.random.default_rng(9)
    ref, port = make_pair("lanes", 1_000, None, lateness=2_000)

    def batch(n, lo, hi):
        return ("batch", rng.integers(0, 10, n), rng.integers(lo, hi, n),
                bid_data(rng, n, 10))

    steps = [batch(500, 0, 4_000), ("wm", 3_999), batch(200, 2_000, 5_000),
             ("wm", 4_999), batch(200, 0, 6_000), ("wm", 7_999)]
    drive(ref, port, steps)
    assert port.late_records > 0


def test_count_without_packed2_layout(numpy_host_paths):
    """A 300 s / 1 s window (ring + panes per window >= 256) takes the
    3-column count-only layout; rows match."""
    rng = np.random.default_rng(12)
    ref, port = make_pair("count", 300_000, 1_000, slots=32)
    assert not port._fire_packed2()
    steps = ooo_steps(rng, 3, 1000, 30, 20_000, 0)
    drive(ref, port, steps)


def _snapshot_run(agg):
    rng = np.random.default_rng(21)
    steps = ooo_steps(rng, 8, 2500, 60, 2_500, 1_000)
    ref, _ = make_pair(agg, 10_000, 1_000, ooo=1_000)
    for step in steps[:8]:
        if step[0] == "batch":
            ref.process_batch(*step[1:])
        else:
            ref.advance_watermark(step[1]).materialize()
    return ref, steps[8:]


@pytest.mark.parametrize("agg", ["lanes", "avg"])
def test_jax_snapshot_with_float_lanes_continues(numpy_host_paths, agg):
    """A mid-run reference snapshot with float lanes, loaded through
    load_jax_snapshot, continues to the reference's rows."""
    ref, rest = _snapshot_run(agg)
    snap = ref.snapshot_state()
    snap["panes"] = jax.tree_util.tree_map(np.asarray, snap["panes"])
    _, port = make_pair(agg, 10_000, 1_000, ooo=1_000)
    port.load_jax_snapshot(snap)
    assert port.plan.ring == ref.plan.ring
    np.testing.assert_array_equal(port.state.sums.numpy(),
                                  np.asarray(ref.state.sums))
    assert drive(ref, port, rest) > 10


def test_jax_snapshot_of_another_aggregate_is_refused(numpy_host_paths):
    ref, _ = _snapshot_run("lanes")
    snap = ref.snapshot_state()
    snap["panes"] = jax.tree_util.tree_map(np.asarray, snap["panes"])
    _, port = make_pair("avg", 10_000, 1_000, ooo=1_000)
    with pytest.raises(ValueError, match="lane maxs"):
        port.load_jax_snapshot(snap)


def test_port_snapshot_with_lanes_restores_into_a_twin():
    rng = np.random.default_rng(23)
    steps = ooo_steps(rng, 8, 2500, 60, 2_500, 1_000)
    _, a = make_pair("lanes", 10_000, 1_000, ooo=1_000)
    for step in steps[:8]:
        if step[0] == "batch":
            a.process_batch(*step[1:])
        else:
            a.advance_watermark(step[1]).materialize()
    _, b = make_pair("lanes", 10_000, 1_000, ooo=1_000)
    b.restore_state(a.snapshot_state())
    out = []
    for op in (a, b):
        rows = []
        for step in steps[8:]:
            if step[0] == "batch":
                op.process_batch(*step[1:])
            else:
                f = dict(op.advance_watermark(step[1]))
                rows += list(zip(*(f[k].tolist() for k in sorted(f))))
        f = dict(op.advance_watermark(op.final_watermark()))
        rows += list(zip(*(f[k].tolist() for k in sorted(f))))
        out.append(rows)
    assert out[0] == out[1] and len(out[0]) > 10
    for lane in ("counts", "sums", "maxs", "mins"):
        assert torch.equal(getattr(a.state, lane), getattr(b.state, lane))


def test_unported_aggregates_are_refused():
    bad = ta.LaneAggregate(0, 0, 0, ta.count().lift, ta.count().finalize,
                           name="opaque", fields=None)
    with pytest.raises(NotImplementedError, match="record fields"):
        WindowOperator(TumblingEventTimeWindows.of(1000), bad, device="cpu")
    # changelog max and min cannot retract, as in the reference
    with pytest.raises(NotImplementedError, match="MAX"):
        ta.changelog_max_of("x")
    with pytest.raises(NotImplementedError, match="MIN"):
        ta.changelog_min_of("x")
    # a top-n ranks by one of the aggregate's result fields
    with pytest.raises(ValueError, match="top-n"):
        WindowOperator(TumblingEventTimeWindows.of(1000), AGGS["avg"](ta),
                       top_n=("max_price", 1), device="cpu")


# -- end to end through env.execute ----------------------------------------------

def _collect(sink, port):
    rows = sink.rows
    if not rows:
        return {}
    return {k: np.asarray([r[k] for r in rows]) for k in rows[0]}


def run_both(build, gen, conf, ooo):
    """``build(env, source, watermarks, sink, aggs_module)`` wires one job;
    it runs through both packages on ``gen``'s batches."""
    env = JaxEnv(JaxConfiguration(dict(conf)))
    jsink = JaxCollectSink()
    build(env, JaxGeneratorSource(gen),
          JaxWatermarks.for_bounded_out_of_orderness(ooo), jsink, ja,
          (JaxTumbling, JaxSliding))
    env.execute("ref")
    env = StreamExecutionEnvironment(Configuration(dict(conf)))
    sink = CollectSink()
    build(env, GeneratorSource(gen),
          WatermarkStrategy.for_bounded_out_of_orderness(ooo), sink, ta,
          (TumblingEventTimeWindows, SlidingEventTimeWindows))
    res = env.execute("port", device="cpu")
    return _collect(jsink, False), _collect(sink, True), res


def wordcount_gen(batch, n_batches, vocab, ms_div):
    """bench.py run_wordcount's source at a small size."""
    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng(i)
        u = rng.random(batch)
        words = (u * u * vocab).astype(np.int64)
        ts = (i * batch + np.arange(batch, dtype=np.int64)) // ms_div
        return ({"word": words}, ts)
    return gen


def wordcount(env, src, wm, sink, aggs, windows):
    (env.from_source(src, wm).key_by("word")
     .window(windows[0].of(1000)).count().add_sink(sink))


def test_wordcount_end_to_end_matches_reference(numpy_host_paths):
    """WordCount (BASELINE config #0's job, bench.py:441-478) at 4096-word
    batches over a 300-word vocabulary, 1 s tumbling counts, in-flight
    steps 1: rows equal in order, and equal to a numpy golden."""
    gen = wordcount_gen(4096, 6, 300, 4)
    conf = {"state.num-key-shards": 16, "state.slots-per-shard": 64,
            "pipeline.max-inflight-steps": 1}
    ref, got, res = run_both(wordcount, gen, conf, 0)
    assert_rows_match(got, ref)
    per = {}
    for i in range(6):
        data, ts = gen("0", i)
        for w, t in zip(data["word"].tolist(), (ts // 1000).tolist()):
            per[(w, (t + 1) * 1000)] = per.get((w, (t + 1) * 1000), 0) + 1
    assert sorted(zip(got["key"].tolist(), got["window_end"].tolist(),
                      got["count"].tolist())) == sorted(
        (w, e, c) for (w, e), c in per.items())
    assert res.metrics["fired_windows"] == len(per)


def bids_gen(batch, n_batches, n_auctions, epm, seed):
    """Seeded bids (auction, price) fed to both packages, 1/4 hot."""
    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng([seed, i])
        hot = rng.integers(0, 4, batch) == 0
        auction = np.where(hot, rng.integers(0, 3, batch),
                           rng.integers(0, n_auctions, batch)).astype(np.int64)
        price = np.round(np.exp(rng.normal(6.0, 1.0, batch)),
                         2).astype(np.float32)
        ids = i * batch + np.arange(batch, dtype=np.int64)
        return {"auction": auction, "price": price}, ids // epm
    return gen


def bid_aggs(which):
    def build(env, src, wm, sink, aggs, windows):
        agg = (aggs.multi(aggs.count(), aggs.sum_of("price"),
                          aggs.max_of("price"), aggs.min_of("price"))
               if which == "a" else aggs.multi(aggs.count(),
                                               aggs.avg_of("price")))
        (env.from_source(src, wm).key_by("auction")
         .window(windows[1].of(10_000, 1_000)).aggregate(agg).add_sink(sink))
    return build


@pytest.mark.parametrize("which,n_auctions,path", [
    ("a", 200, "pb_pack"), ("b", 60, "preagg_combine")])
def test_bid_aggregates_end_to_end_match_reference(numpy_host_paths,
                                                   which, n_auctions, path):
    """Jobs (a) multi(count, sum, max, min) per record and (b) multi(count,
    avg) host-combined, sliding 10 s / 1 s with 1 s out-of-orderness on
    4096-bid batches of 4 s each (the ring grows 16 -> 32)."""
    gen = bids_gen(4096, 6, n_auctions, 1, seed=which == "a")
    conf = {"state.num-key-shards": 8, "state.slots-per-shard": 64}
    ref, got, res = run_both(bid_aggs(which), gen, conf, 1_000)
    assert_rows_match(got, ref)
    assert len(set(got["window_end"].tolist())) > 20
    assert any(k.endswith("." + path) for k in res.metrics), path
