"""Changelog lanes and ``lower_aggregate`` in the port, against the JAX
package on the same seeded inputs.

A changelog stream carries an int8 ``__op__`` column (+I, -U, +U, -D);
``changelog_count`` / ``changelog_sum_of`` / ``changelog_avg_of`` weight
each record by the sign of its op in the lift, which the port runs in
torch before ``scatter_lanes``. Their lifts are opaque, so records go
per record in both packages and on both key-table lanes.

Rows must be equal in order: key, window bounds, counts and the signed
count exactly; a signed sum within |port - ref| <= 2 * n * 2^-24 *
sum(|terms|) over its n terms (the error of adding the same terms in
another order: the scatters add in the reference's order, the fire's
column sum may associate differently), an average within that bound
over its divisor plus one rounding, 2^-23 * |ref|."""
import numpy as np
import pytest
import torch

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import FnSink as JaxFnSink
from flink_tpu.api.windowing import TumblingEventTimeWindows as JaxTumbling
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops.count_window import CountWindowOperator as JaxCountWindow
from flink_tpu.ops.window import WindowOperator as JaxWindowOperator
from flink_tpu.records import OP_FIELD as JAX_OP_FIELD
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.functions import AggregateFunction
from flink_tpu_torch.api.sinks import FnSink
from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.count_window import CountWindowOperator
from flink_tpu_torch.ops.window import WindowOperator
from flink_tpu_torch.records import (
    OP_DELETE, OP_FIELD, OP_INSERT, OP_UPDATE_AFTER, OP_UPDATE_BEFORE)
from test_torch_threads import capped_torch_threads  # noqa: F401

U = 2.0 ** -24
CONF = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
        "pipeline.microbatch-size": 100}


@pytest.fixture
def numpy_host_paths(monkeypatch):
    """Both packages key through their numpy tables."""
    from flink_tpu import native_codec
    from flink_tpu_torch import native_codec as port_native_codec

    for mod in (native_codec, port_native_codec):
        monkeypatch.setattr(mod.NativeHashTable, "create",
                            classmethod(lambda cls, capacity_hint=1024: None))


def changelog_stream(seed=7, n=400, nk=6):
    """``tests/test_changelog.py``'s stream: an insert-biased op mix with
    retractions in every window, timestamps sorted over 2 s."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, nk, n).astype(np.int64)
    v = rng.random(n).astype(np.float32)
    ops = rng.choice(np.array([OP_INSERT, OP_INSERT, OP_UPDATE_AFTER,
                               OP_UPDATE_BEFORE, OP_DELETE], np.int8), n)
    ts = np.sort(rng.integers(0, 2000, n)).astype(np.int64)
    return k, v, ops, ts


def signed_aggs(m):
    return m.multi(m.changelog_count("net"), m.changelog_sum_of("v"),
                   m.changelog_avg_of("v"))


def abs_terms(keys, ts, v, rows, size_ms):
    """(sum of |v|, record count) of each row's (key, window)."""
    out_s, out_n = [], []
    for key, start in zip(rows["key"], rows["window_start"]):
        m = (keys == key) & (ts >= start) & (ts < start + size_ms)
        out_s.append(np.abs(v[m].astype(np.float64)).sum())
        out_n.append(int(m.sum()))
    return np.array(out_s), np.array(out_n)


def assert_signed_rows(got, want, keys, ts, v, size_ms):
    assert list(got) == list(want)
    for k in ("key", "window_start", "window_end", "count", "net"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    s_abs, n = abs_terms(keys, ts, v, want, size_ms)
    bound = 2.0 * n * U * s_abs
    gs, ws = (np.asarray(got["sum_v"], np.float64),
              np.asarray(want["sum_v"], np.float64))
    assert (np.abs(gs - ws) <= bound).all(), (gs, ws, bound)
    div = np.maximum(np.round(np.asarray(want["net"], np.float64)), 1.0)
    ga, wa = (np.asarray(got["avg_v"], np.float64),
              np.asarray(want["avg_v"], np.float64))
    assert (np.abs(ga - wa) <= bound / div + 2 * U * np.abs(wa)).all()


def concat(batches):
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def test_op_codes_equal_the_reference():
    from flink_tpu import records as jr
    from flink_tpu_torch import records as tr

    assert (tr.OP_FIELD, tr.OP_DTYPE, tr.OP_NAMES) == \
        (jr.OP_FIELD, jr.OP_DTYPE, jr.OP_NAMES)
    assert (tr.OP_INSERT, tr.OP_UPDATE_BEFORE, tr.OP_UPDATE_AFTER,
            tr.OP_DELETE) == (jr.OP_INSERT, jr.OP_UPDATE_BEFORE,
                              jr.OP_UPDATE_AFTER, jr.OP_DELETE)


def test_signed_lifts_equal_the_reference():
    """The lifts and finalizes on the same records: equal bit for bit."""
    import jax.numpy as jnp

    k, v, ops, _ = changelog_stream(seed=3, n=64)
    jagg, tagg = signed_aggs(ja), signed_aggs(ta)
    valid = np.ones(64, bool)
    valid[5] = False
    js = jagg.lift_masked({"v": jnp.asarray(v), JAX_OP_FIELD: jnp.asarray(ops)},
                          jnp.asarray(valid))
    ts_ = tagg.lift_masked({"v": torch.from_numpy(v),
                            OP_FIELD: torch.from_numpy(ops)},
                           torch.from_numpy(valid))
    for a, b in zip(js, ts_):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    sums = np.asarray(js[0]).reshape(8, 8, 4).sum(axis=1)
    counts = np.full(8, 8, np.int32)
    jr = jagg.finalize(jnp.asarray(sums), jnp.zeros((8, 0)), jnp.zeros((8, 0)),
                       jnp.asarray(counts))
    tr = tagg.finalize(torch.from_numpy(sums), torch.zeros((8, 0)),
                       torch.zeros((8, 0)), torch.from_numpy(counts))
    assert sorted(tr) == sorted(jr)
    for f in jr:
        np.testing.assert_array_equal(tr[f].numpy(), np.asarray(jr[f]),
                                      err_msg=f)


def test_changelog_window_job_matches_the_reference():
    """``tests/test_changelog.py``'s signed-lanes job through
    ``env.execute`` in both packages: rows equal in order, and the
    signed count equal to the oracle's."""
    k, v, ops, ts = changelog_stream()

    def run(env_cls, conf_cls, tumbling, m, sink_cls, **kw):
        env = env_cls(conf_cls(dict(CONF)))
        out = []
        (env.from_collection({"key": k, "v": v, OP_FIELD: ops}, ts,
                             batch_size=100)
            .key_by("key").window(tumbling.of(500))
            .aggregate(signed_aggs(m))
            .add_sink(sink_cls(out.append)))
        env.execute("changelog-windows", **kw)
        return concat(out)

    want = run(JaxEnv, JaxConfiguration, JaxTumbling, ja, JaxFnSink)
    got = run(StreamExecutionEnvironment, Configuration,
              TumblingEventTimeWindows, ta, FnSink, device="cpu")
    assert_signed_rows(got, want, k, ts, v, 500)
    sign = np.where((ops == OP_UPDATE_BEFORE) | (ops == OP_DELETE), -1, 1)
    for key, start, net in zip(got["key"], got["window_start"], got["net"]):
        m = (k == key) & (ts >= start) & (ts < start + 500)
        assert net == int(sign[m].sum())


@pytest.mark.parametrize("lane", ["native", "numpy"])
def test_changelog_operator_with_late_refires(request, lane):
    """Operator level on both key-table lanes, with allowed lateness: a
    late batch inside it re-fires its windows with the signed lanes
    updated; rows equal in order, the late count equal."""
    if lane == "numpy":
        request.getfixturevalue("numpy_host_paths")
    k, v, ops, ts = changelog_stream(seed=11, n=600, nk=9)
    kw = dict(num_shards=4, slots_per_shard=16, allowed_lateness_ms=1_000)
    ref = JaxWindowOperator(JaxTumbling.of(500), signed_aggs(ja), **kw)
    port = WindowOperator(TumblingEventTimeWindows.of(500), signed_aggs(ta),
                          device="cpu", **kw)
    assert port._preagg_lanes() is None  # opaque lifts: per record
    batches = [slice(0, 250), slice(250, 450), slice(450, 600)]
    wms = [900, 1_400, 1_900]
    for sl, wm in zip(batches, wms):
        data = {"v": v[sl], OP_FIELD: ops[sl]}
        ref.process_batch(k[sl], ts[sl], data)
        port.process_batch(k[sl], ts[sl], data)
        assert_signed_rows(dict(port.advance_watermark(wm)),
                           dict(ref.advance_watermark(wm)), k, ts, v, 500)
    # late records: inside the lateness for the window [1000, 1500),
    # beyond it for [0, 500)
    late_k = np.array([1, 2, 2, 3], np.int64)
    late_ts = np.array([1_100, 1_200, 300, 1_499], np.int64)
    late = {"v": np.array([0.5, 0.25, 4.0, 1.0], np.float32),
            OP_FIELD: np.array([OP_INSERT, OP_DELETE, OP_INSERT,
                                OP_UPDATE_BEFORE], np.int8)}
    ref.process_batch(late_k, late_ts, late)
    port.process_batch(late_k, late_ts, late)
    assert port.late_records == ref.late_records == 1
    all_k = np.concatenate([k, late_k])
    all_ts = np.concatenate([ts, late_ts])
    all_v = np.concatenate([v, late["v"]])
    got = dict(port.advance_watermark(1_950))
    want = dict(ref.advance_watermark(1_950))
    assert len(want["key"]) > 0 and set(want["window_end"]) == {1_500}
    assert_signed_rows(got, want, all_k, all_ts, all_v, 500)
    got = dict(port.advance_watermark(port.final_watermark()))
    want = dict(ref.advance_watermark(ref.final_watermark()))
    assert_signed_rows(got, want, all_k, all_ts, all_v, 500)


def test_count_window_takes_the_signed_lanes(numpy_host_paths):
    """Count windows over a changelog stream: the port's count window
    equals the reference's, batch by batch, bit for bit (both fold a
    row's records in record order and fire no column sum)."""
    k, v, ops, ts = changelog_stream(seed=5, n=300, nk=5)
    agg = lambda m: m.multi(m.changelog_count("net"), m.changelog_sum_of("v"))
    ref = JaxCountWindow(agg(ja), 7, num_shards=4, slots_per_shard=8)
    port = CountWindowOperator(agg(ta), 7, num_shards=4, slots_per_shard=8,
                               device="cpu")
    n_rows = 0
    for lo in range(0, 300, 60):
        sl = slice(lo, lo + 60)
        data = {"v": v[sl], OP_FIELD: ops[sl]}
        ref.process_batch(k[sl], ts[sl], data)
        port.process_batch(k[sl], ts[sl], data)
        want, got = ref.take_fired(), port.take_fired()
        if want is None:
            assert got is None
            continue
        want, got = dict(want), dict(got)
        assert list(got) == list(want)
        for f in ("key", "count", "net", "sum_v"):
            np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)
        n_rows += len(want["key"])
    assert n_rows > 10


def test_max_and_min_lanes_refuse_changelog_with_the_reference_message():
    for name in ("changelog_max_of", "changelog_min_of"):
        with pytest.raises(NotImplementedError) as want:
            getattr(ja, name)("v")
        with pytest.raises(NotImplementedError) as got:
            getattr(ta, name)("v")
        assert str(got.value) == str(want.value)


class SumPeakLow:
    """One AggregateFunction body for both packages (``xp`` is jnp or
    torch): a sum leaf, a max leaf and a min leaf of ``v``."""

    def __init__(self, xp):
        self.xp = xp

    def create_accumulator(self):
        xp = self.xp
        return (xp.asarray(0.0, dtype=xp.float32),
                xp.asarray(-np.inf, dtype=xp.float32),
                xp.asarray(np.inf, dtype=xp.float32))

    def add(self, value, acc):
        xp = self.xp
        x = value["v"].astype(xp.float32) if hasattr(value["v"], "astype") \
            else value["v"].to(xp.float32)
        return (acc[0] + x, xp.maximum(acc[1], x), xp.minimum(acc[2], x))

    def merge(self, a, b):
        xp = self.xp
        return (a[0] + b[0], xp.maximum(a[1], b[1]), xp.minimum(a[2], b[2]))

    def get_result(self, acc):
        return {"total": acc[0], "peak": acc[1], "low": acc[2]}


class TorchSumPeakLow(SumPeakLow, AggregateFunction):
    def __init__(self):
        super().__init__(torch)


class ConcatFirst(AggregateFunction):
    """A merge that is none of sum, max and min."""

    def create_accumulator(self):
        return torch.tensor(0.0)

    def add(self, value, acc):
        return acc + value["v"]

    def merge(self, a, b):
        return a * 10 + b

    def get_result(self, acc):
        return acc


def test_lower_aggregate_matches_the_reference(numpy_host_paths):
    """A user AggregateFunction lowered in both packages: the same lane
    widths, and the window operator's rows equal in order (the max and
    min leaves exactly, the sum leaf within the bound)."""
    import jax.numpy as jnp

    jagg = ja.lower_aggregate(SumPeakLow(jnp), {"v": np.float32})
    tagg = ta.lower_aggregate(TorchSumPeakLow(), {"v": np.float32})
    assert (tagg.sum_width, tagg.max_width, tagg.min_width) == \
        (jagg.sum_width, jagg.max_width, jagg.min_width) == (1, 1, 1)
    assert tagg.fields == jagg.fields == ("v",)
    assert tagg.name == "TorchSumPeakLow"
    rng = np.random.default_rng(9)
    kw = dict(num_shards=4, slots_per_shard=16)
    ref = JaxWindowOperator(JaxTumbling.of(1_000), jagg, **kw)
    port = WindowOperator(TumblingEventTimeWindows.of(1_000), tagg,
                          device="cpu", **kw)
    keys = rng.integers(0, 20, 500).astype(np.int64)
    ts = np.sort(rng.integers(0, 3_000, 500)).astype(np.int64)
    v = rng.normal(10, 5, 500).astype(np.float32)
    v[:3] = [np.nan, -0.0, 0.0]
    ref.process_batch(keys, ts, {"v": v})
    port.process_batch(keys, ts, {"v": v})
    got = dict(port.advance_watermark(port.final_watermark()))
    want = dict(ref.advance_watermark(ref.final_watermark()))
    assert list(got) == list(want) and len(want["key"]) > 20
    for f in ("key", "window_start", "window_end", "count", "peak", "low"):
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f)
    s_abs, n = abs_terms(keys, ts, v, want, 1_000)
    gt, wt = np.asarray(got["total"], np.float64), np.asarray(want["total"])
    ok = (np.abs(gt - wt) <= 2.0 * n * U * s_abs) | (np.isnan(gt) & np.isnan(wt))
    assert ok.all()
    with pytest.raises(NotImplementedError, match="neither sum/max/min"):
        ta.lower_aggregate(ConcatFirst(), {"v": np.float32})
