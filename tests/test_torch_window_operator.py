"""The port's WindowOperator against the JAX one, fed the same batches:
fired rows must be equal in order (key, window_start, window_end, count
— all exact integers), and so must the pane state.

Both packages run on their numpy host paths (no C key table): general
ingest, the host pre-aggregation gate, and the chunked top-n fire. With
their C tables both take the native lane, which fuses apply + fire into
one step per batch and orders the rows of an advance that fires more
than 16 windows differently; tests/test_torch_native_lane.py holds the
two native lanes against each other."""
import jax
import numpy as np
import pytest
import torch

from flink_tpu.api.windowing import (
    SlidingEventTimeWindows as JaxSliding,
    TumblingEventTimeWindows as JaxTumbling,
)
from flink_tpu.ops.aggregates import count as jax_count
from flink_tpu.ops.window import WindowOperator as JaxWindowOperator
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.ops.aggregates import count
from flink_tpu_torch.ops.window import WindowOperator
from test_torch_threads import capped_torch_threads  # noqa: F401

COLS = ("key", "window_start", "window_end", "count")


@pytest.fixture
def numpy_host_paths(monkeypatch):
    """Both packages on their numpy host paths: neither directory gets
    its C key table, so neither takes its native lane."""
    from flink_tpu import native_codec
    from flink_tpu_torch import native_codec as port_native_codec

    for mod in (native_codec, port_native_codec):
        monkeypatch.setattr(mod.NativeHashTable, "create",
                            classmethod(lambda cls, capacity_hint=1024: None))


def rows_of(fired):
    f = dict(fired)
    return list(zip(*(np.asarray(f[k]).tolist() for k in COLS)))


def make_pair(size, slide, n, *, shards=8, slots=64, ooo=0, lateness=0):
    kw = dict(num_shards=shards, slots_per_shard=slots,
              max_out_of_orderness_ms=ooo, allowed_lateness_ms=lateness,
              top_n=("count", n))
    if slide is None:
        ref = JaxWindowOperator(JaxTumbling.of(size), jax_count(), **kw)
        port = WindowOperator(TumblingEventTimeWindows.of(size), count(),
                              device="cpu", **kw)
    else:
        ref = JaxWindowOperator(JaxSliding.of(size, slide), jax_count(), **kw)
        port = WindowOperator(SlidingEventTimeWindows.of(size, slide),
                              count(), device="cpu", **kw)
    return ref, port


def drive(ref, port, steps):
    """Apply (batch | watermark) steps to both operators, comparing the
    fired rows of every advance in order; then the end-of-input flush."""
    fired = []
    for step in steps:
        if step[0] == "batch":
            _, keys, ts = step
            ref.process_batch(keys, ts, {})
            port.process_batch(keys, ts, {})
        else:
            a = rows_of(ref.advance_watermark(step[1]))
            b = rows_of(port.advance_watermark(step[1]))
            assert b == a
            fired += b
    assert port.final_watermark() == ref.final_watermark()
    a = rows_of(ref.advance_watermark(ref.final_watermark()))
    b = rows_of(port.advance_watermark(port.final_watermark()))
    assert b == a
    fired += b
    assert port.plan.ring == ref.plan.ring
    np.testing.assert_array_equal(port.state.counts.numpy(),
                                  np.asarray(ref.state.counts))
    assert port.late_records == ref.late_records
    return fired


def ooo_steps(rng, n_batches, batch, keys, span_ms, ooo_ms, start=50_000):
    """Batches whose timestamps jitter up to ooo_ms behind the running
    max, each followed by a bounded-out-of-orderness watermark."""
    steps, t, max_ts = [], start, start
    for _ in range(n_batches):
        ts = t + rng.integers(-ooo_ms, span_ms, batch)
        k = rng.zipf(1.6, batch) % keys
        steps.append(("batch", k.astype(np.int64), ts.astype(np.int64)))
        max_ts = max(max_ts, int(ts.max()))
        steps.append(("wm", max_ts - ooo_ms - 1))
        t += span_ms
    return steps


@pytest.mark.parametrize("n", [1, 3])
def test_out_of_order_incremental_watermarks(numpy_host_paths, n):
    """Sliding 10 s / 1 s windows, out-of-order events, a watermark after
    every batch (rows equal in order, pane state equal)."""
    rng = np.random.default_rng(11 + n)
    ref, port = make_pair(10_000, 1_000, n, ooo=1_000)
    fired = drive(ref, port, ooo_steps(rng, 8, 3000, 80, 2_500, 1_000))
    assert len(fired) >= 30


def test_batch_that_grows_the_ring(numpy_host_paths):
    """A batch spanning 40 s grows the 16-column ring; the advance after
    it fires more than 16 windows, in chunks (rows equal in order)."""
    rng = np.random.default_rng(3)
    ref, port = make_pair(10_000, 1_000, 2, ooo=1_000)
    assert port.plan.ring == 16
    steps = ooo_steps(rng, 2, 2000, 40, 2_000, 500)
    ts = 54_000 + np.sort(rng.integers(0, 40_000, 6000))
    steps += [("batch", rng.integers(0, 50, 6000), ts), ("wm", 90_000)]
    steps += ooo_steps(rng, 3, 2000, 40, 2_000, 500, start=94_000)
    fired = drive(ref, port, steps)
    assert port.plan.ring > 16
    assert len({w for _, _, w, _ in fired}) > 40


def test_preagg_gate_both_branches(numpy_host_paths):
    """A batch too small to pass the host pre-aggregation gate takes the
    per-record upload, a large one the combined-pair upload; both match
    the reference (rows equal in order)."""
    rng = np.random.default_rng(5)
    ref, port = make_pair(1_000, None, 2)
    keys, ts = rng.integers(0, 20, 50), rng.integers(0, 3000, 50)
    ref.process_batch(keys, ts, {})
    port.process_batch(keys, ts, {})
    assert "pb_pack" in port.prof and "preagg_combine" not in port.prof
    assert rows_of(port.advance_watermark(1_500)) == \
        rows_of(ref.advance_watermark(1_500))
    keys, ts = rng.integers(0, 30, 20_000), 2_000 + rng.integers(0, 3000, 20_000)
    ref.process_batch(keys, ts, {})
    port.process_batch(keys, ts, {})
    assert "preagg_combine" in port.prof
    drive(ref, port, [("wm", 4_200)])


def test_allowed_lateness_refires_and_drops(numpy_host_paths):
    """Late-within-lateness records re-fire their windows; records past
    the lateness are dropped and counted (rows equal in order)."""
    rng = np.random.default_rng(9)
    ref, port = make_pair(1_000, None, 1, lateness=2_000)
    steps = [
        ("batch", rng.integers(0, 10, 500), rng.integers(0, 4_000, 500)),
        ("wm", 3_999),
        ("batch", rng.integers(0, 10, 200), rng.integers(2_000, 5_000, 200)),
        ("wm", 4_999),
        ("batch", rng.integers(0, 10, 200), rng.integers(0, 6_000, 200)),
        ("wm", 7_999),
    ]
    fired = drive(ref, port, steps)
    ends = [w for _, _, w, _ in fired]
    assert len(ends) > len(set(ends))  # some window fired more than once
    assert port.late_records > 0


def test_jax_snapshot_continues_identically(numpy_host_paths):
    """Snapshot the reference mid-stream, load it into the port, run both
    on: the rows after the load and the final pane state are equal."""
    rng = np.random.default_rng(21)
    steps = ooo_steps(rng, 8, 2500, 60, 2_500, 1_000)
    ref, _ = make_pair(10_000, 1_000, 2, ooo=1_000)
    for step in steps[:8]:
        if step[0] == "batch":
            ref.process_batch(step[1], step[2], {})
        else:
            ref.advance_watermark(step[1]).materialize()
    snap = ref.snapshot_state()
    snap["panes"] = jax.tree_util.tree_map(np.asarray, snap["panes"])
    _, port = make_pair(10_000, 1_000, 2, ooo=1_000)
    port.load_jax_snapshot(snap)
    assert port.plan.ring == ref.plan.ring
    assert port.watermark == ref.watermark
    np.testing.assert_array_equal(port.state.counts.numpy(),
                                  np.asarray(ref.state.counts))
    fired = drive(ref, port, steps[8:])
    assert len(fired) > 10


def test_jax_snapshot_with_dropped_records_is_refused(numpy_host_paths):
    """The port raises on a full key directory and never drops, so a
    reference snapshot that counts dropped records cannot be carried on."""
    rng = np.random.default_rng(22)
    steps = ooo_steps(rng, 2, 500, 30, 2_500, 1_000)
    ref, port = make_pair(10_000, 1_000, 2, ooo=1_000)
    ref.process_batch(steps[0][1], steps[0][2], {})
    snap = ref.snapshot_state()
    snap["panes"] = jax.tree_util.tree_map(np.asarray, snap["panes"])
    snap["records_dropped_full"] = 3
    with pytest.raises(ValueError, match="dropped"):
        port.load_jax_snapshot(snap)


def test_port_snapshot_restores_into_a_twin():
    """The port's own snapshot, restored into a fresh operator, continues
    exactly like the operator it was taken from (rows, state)."""
    rng = np.random.default_rng(23)
    steps = ooo_steps(rng, 8, 2500, 60, 2_500, 1_000)
    _, a = make_pair(10_000, 1_000, 2, ooo=1_000)
    for step in steps[:8]:
        if step[0] == "batch":
            a.process_batch(step[1], step[2], {})
        else:
            a.advance_watermark(step[1]).materialize()
    _, b = make_pair(10_000, 1_000, 2, ooo=1_000)
    b.restore_state(a.snapshot_state())
    out = []
    for op in (a, b):
        rows = []
        for step in steps[8:]:
            if step[0] == "batch":
                op.process_batch(step[1], step[2], {})
            else:
                rows += rows_of(op.advance_watermark(step[1]))
        rows += rows_of(op.advance_watermark(op.final_watermark()))
        out.append(rows)
    assert out[0] == out[1] and len(out[0]) > 10
    assert torch.equal(a.state.counts, b.state.counts)


# -- the reference's top-n cases (tests/test_window_operator.py TestTopN),
# held against their goldens -----------------------------------------------

def _topn_op(n):
    return WindowOperator(TumblingEventTimeWindows.of(1000), count(),
                          num_shards=8, slots_per_shard=64, top_n=("count", n),
                          device="cpu")


def test_topn_fewer_candidates_than_n_emits_all():
    op = _topn_op(5)
    op.process_batch(np.array([1, 2, 3]), np.array([100, 200, 300]), {})
    fired = op.advance_watermark(2000).materialize()
    got = {(int(k), int(c)) for k, c in zip(fired["key"], fired["count"])}
    assert got == {(1, 1), (2, 1), (3, 1)}


def test_topn_top1_picks_max_with_ties():
    op = _topn_op(1)
    op.process_batch(np.array([1, 1, 1, 2, 2, 2, 3]), np.full(7, 100), {})
    fired = op.advance_watermark(2000).materialize()
    got = {(int(k), int(c)) for k, c in zip(fired["key"], fired["count"])}
    assert got == {(1, 3), (2, 3)}


def test_topn_top2_across_windows():
    op = _topn_op(2)
    keys = np.array([1, 1, 1, 2, 2, 3, 4, 5, 5])
    ts = np.array([0, 1, 2, 3, 4, 5, 1500, 1501, 1502])
    op.process_batch(keys, ts, {})
    fired = op.advance_watermark(3000).materialize()
    got = {(int(k), int(e), int(c)) for k, e, c in
           zip(fired["key"], fired["window_end"], fired["count"])}
    assert got == {(1, 1000, 3), (2, 1000, 2), (4, 2000, 1), (5, 2000, 2)}


def test_topn_tie_explosion_raises_loudly():
    op = _topn_op(1)
    nk = op._topn_cap() + 40
    op.process_batch(np.arange(nk), np.full(nk, 100), {})
    with pytest.raises(RuntimeError, match="truncation"):
        op.advance_watermark(2000).materialize()


def test_operator_refuses_unported_shapes(monkeypatch):
    from flink_tpu_torch.ops.aggregates import max_of, multi

    from flink_tpu_torch.api.windowing import (
        GlobalWindows, TumblingProcessingTimeWindows)

    # processing time is ported (the clock's panes); a global window
    # has no panes and is refused
    op = WindowOperator(TumblingProcessingTimeWindows.of(1000),
                        multi(count(), max_of("price")),
                        top_n=("max_price", 1), device="cpu")
    assert op.uses_processing_time and op.clock is not None
    with pytest.raises(NotImplementedError, match="pane-decomposable"):
        WindowOperator(GlobalWindows.create(),
                       multi(count(), max_of("price")),
                       top_n=("max_price", 1), device="cpu")
    # the default device is the card; without one the operator refuses
    # instead of running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WindowOperator(TumblingEventTimeWindows.of(1000), count(),
                       top_n=("count", 1))
