"""Pane state past the port's cell-index limit, as the JAX package runs
it: at 2^31 cells and more the reference packs its per-record cells as
int64 (``flink_tpu/ops/window.py:1762``); the port uploads int64 cells
there too and its kernels take them (``scatter_counts`` and
``bucket_records`` as int64, ``scatter_lanes`` a block of rows at a
time, ``ring_columns`` a block of rows a launch).

The CPU cannot hold 2^31 cells, so these tests lower the port's limit,
``flink_tpu_torch.ops.window.CELL_INDEX_LIMIT``, to 2^12, and
``scatter_lanes``' row block (``lane_kernels.CELL_BLOCK``) to 2^10 cells:
a 513-row state then uploads int64 cells (past the limit the 3-byte
split upload gives way, which at the real limit it never has to) and
folds its lanes in several row blocks. Each case runs the plain path against the
reference's ``WindowOperator`` on the same numpy batches, under the
parity rules of tests/test_torch_window_aggregates.py (integers and
max/min exactly, sums and averages within their ordering bound): count
on the general path, a lane aggregate through a ring growth, top-n over
lanes, and the key-sharded operator on four CPU blocks (rows compared
window by window, since a mesh drains block by block). The card runs
the same path at 2^31 cells and more in tests/test_torch_cuda.py.

The forms whose reference is 32-bit (the host-combined pairs, the native
fused scan, the device-made ingest) are gated in both packages by the
pair domain (2^23 cells), far below 2^31: a test pins that both choose
alike at a size past 2^31."""
import dataclasses

import numpy as np
import pytest

from flink_tpu.api.windowing import (
    SlidingEventTimeWindows as JaxSliding,
    TumblingEventTimeWindows as JaxTumbling,
)
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops.window import WindowOperator as JaxWindowOperator
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.kernels import lane_kernels as lk
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops import window as pw
from flink_tpu_torch.parallel.mesh import make_mesh_plan
from test_torch_threads import capped_torch_threads  # noqa: F401
from test_torch_window_aggregates import assert_rows_match

SHARDS, SLOTS = 8, 64            # 512 slots: 513 rows a state
LOWERED_LIMIT = 2 ** 12
LOWERED_BLOCK = 2 ** 10
KW = dict(num_shards=SHARDS, slots_per_shard=SLOTS,
          max_out_of_orderness_ms=2000)


@pytest.fixture
def lowered(monkeypatch):
    monkeypatch.setattr(pw, "CELL_INDEX_LIMIT", LOWERED_LIMIT)
    monkeypatch.setattr(lk, "CELL_BLOCK", LOWERED_BLOCK)


@pytest.fixture
def uploads(monkeypatch):
    """The cell dtypes ``scatter_counts``, ``scatter_split_counts`` (the
    split upload's uint8 bytes) and ``scatter_lanes`` were handed (the
    per-record and per-block calls alike)."""
    seen = []
    for mod, name in ((wk, "scatter_counts"), (wk, "scatter_split_counts"),
                      (lk, "scatter_lanes")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            idx = a[4] if _name == "scatter_lanes" else a[1]
            seen.append((_name, idx.dtype))
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return seen


def batches(seed, n_batches=4, n=1024, n_keys=300, grow_at=None):
    """High-cardinality bids (the host combine's gate declines them, so
    each record goes up as a cell), 1.5 s of event time apart, out of
    order by up to 3 s; at ``grow_at`` an eighth of a batch lands 40 s
    ahead, which grows the ring. Steps: each batch, then an advance."""
    rng = np.random.default_rng(seed)
    steps, t = [], 3_000
    for i in range(n_batches):
        ts = t - rng.integers(0, 3_000, n)
        if grow_at == i:
            ts[: n // 8] += 40_000
        keys = rng.integers(0, n_keys, n)
        price = np.round(np.exp(rng.normal(6.0, 1.0, n)), 2).astype(np.float32)
        steps.append((keys, ts.astype(np.int64), {"price": price}, t - 2_001))
        t += 1_500
    return steps


def pair(agg, window, top=None, mesh=None):
    kind, size, slide = window
    jw = (JaxTumbling.of(size) if kind == "tumbling"
          else JaxSliding.of(size, slide))
    tw = (TumblingEventTimeWindows.of(size) if kind == "tumbling"
          else SlidingEventTimeWindows.of(size, slide))
    ref = JaxWindowOperator(jw, agg(ja), top_n=top, **KW)
    port = pw.WindowOperator(tw, agg(ta), top_n=top, device="cpu",
                             mesh_plan=mesh, **KW)
    return ref, port


def by_window(rows):
    """A fired batch's rows ordered by (window end, key): a mesh drains
    block by block, a single block row-major."""
    rows = {k: np.asarray(v) for k, v in dict(rows).items()}
    order = np.lexsort((rows["key"], rows["window_end"]))
    return {k: v[order] for k, v in rows.items()}


def drive(ref, port, steps, sort=False):
    """Both operators through the steps, every advance's rows compared,
    then the end-of-input flush; returns the rows the port fired."""
    fix = by_window if sort else (lambda r: {k: np.asarray(v)
                                             for k, v in dict(r).items()})
    n_rows = 0
    for keys, ts, data, wm in steps:
        ref.process_batch(keys, ts, data)
        port.process_batch(keys, ts, data)
        got = fix(port.advance_watermark(wm))
        assert_rows_match(got, fix(ref.advance_watermark(wm)))
        n_rows += len(got["window_end"])
    assert port.final_watermark() == ref.final_watermark()
    got = fix(port.advance_watermark(port.final_watermark()))
    assert_rows_match(got, fix(ref.advance_watermark(ref.final_watermark())))
    assert port.late_records == ref.late_records
    return n_rows + len(got["window_end"])


def test_count_general_path_past_the_limit(lowered, uploads):
    """count() per record (K1 ``scatter_counts``) with int64 cells, every
    fire equal to the reference's, and the state past the limit."""
    ref, port = pair(lambda m: m.count(), ("sliding", 10_000, 1_000))
    assert port._cell_dtype() is np.int64
    assert drive(ref, port, batches(1)) > 500
    assert ("scatter_counts", pw.torch.int64) in uploads
    np.testing.assert_array_equal(port.state.counts.numpy(),
                                  np.asarray(ref.state.counts))


def test_lane_aggregate_through_a_ring_growth_past_the_limit(lowered,
                                                             uploads):
    """multi(max_of, avg_of) per record: int64 cells folded by
    ``scatter_lanes`` a row block at a time, ``fire_pack`` fires, and a
    ring growth (``ring_columns``) whose state stays past the limit."""
    ref, port = pair(lambda m: m.multi(m.max_of("price"), m.avg_of("price")),
                     ("sliding", 10_000, 1_000))
    ring0 = port.plan.ring
    assert drive(ref, port, batches(2, grow_at=2)) > 500
    assert port.plan.ring == ref.plan.ring > ring0
    assert port._cell_dtype() is np.int64
    assert ("scatter_lanes", pw.torch.int64) in uploads
    np.testing.assert_array_equal(port.state.maxs.numpy(),
                                  np.asarray(ref.state.maxs))


def test_topn_over_lanes_past_the_limit(lowered, uploads):
    """``.top(2, by="max_price")`` over multi(max_of, avg_of):
    ``window_lanes`` and ``topn_select_lanes`` on a state past the
    limit, rows in the reference's order."""
    ref, port = pair(lambda m: m.multi(m.max_of("price"), m.avg_of("price")),
                     ("sliding", 10_000, 1_000), top=("max_price", 2))
    assert drive(ref, port, batches(3)) > 20
    assert ("scatter_lanes", pw.torch.int64) in uploads


def test_sharded_operator_on_four_blocks_past_the_limit(lowered, uploads):
    """The key-sharded operator on four CPU blocks: global int64 cells
    through ``bucket_records`` and each block's fold, against the
    reference's single operator window by window."""
    mesh = make_mesh_plan(SHARDS, SLOTS, ["cpu"] * 4)
    ref, port = pair(lambda m: m.multi(m.count(), m.sum_of("price"),
                                       m.max_of("price")),
                     ("tumbling", 1_000, None), mesh=mesh)
    assert port._cell_dtype() is np.int64
    assert drive(ref, port, batches(4), sort=True) > 500
    assert port.exchange_overflow == 0
    assert ("scatter_lanes", pw.torch.int64) in uploads


def test_cells_below_the_limit_upload_as_today(uploads):
    """At the real limit the same jobs upload as today: the 3-byte split
    while the rows fit 16 bits (count only, its bytes go straight to
    ``scatter_split_counts``), int32 cells past them."""
    ref, port = pair(lambda m: m.count(), ("sliding", 10_000, 1_000))
    assert port._cell_dtype() is np.int32 and port._split_upload
    drive(ref, port, batches(5, n_batches=2))
    assert uploads and set(uploads) == {("scatter_split_counts",
                                         pw.torch.uint8)}
    wide = pw.WindowOperator(TumblingEventTimeWindows.of(1_000), ta.count(),
                             num_shards=256, slots_per_shard=256, device="cpu")
    assert not wide._split_upload and wide._cell_dtype() is np.int32


def test_scatter_lanes_row_blocks_raise_on_a_cell_past_the_state(lowered):
    """An int64 cell past the state (or negative, without skip_negative)
    raises as one call would; skip_negative drops the negatives."""
    counts = pw.torch.zeros((9, 2 ** 14), dtype=pw.torch.int32)
    s = pw.torch.zeros((3, 0))
    for cell, skip in ((9 * 2 ** 14, True), (-1, False)):
        idx = pw.torch.tensor([5, cell, 2 ** 17], dtype=pw.torch.int64)
        with pytest.raises(IndexError, match="scatter_lanes"):
            lk.scatter_lanes(counts, None, None, None, idx, s, s, s,
                             skip_negative=skip)
    idx = pw.torch.tensor([5, -1, 2 ** 17, 2 ** 17], dtype=pw.torch.int64)
    s = pw.torch.zeros((4, 0))
    lk.scatter_lanes(counts, None, None, None, idx, s, s, s,
                     skip_negative=True)
    assert int(counts.sum()) == 3 and int(counts.view(-1)[2 ** 17]) == 2


class _Spec:
    key_domain = 1000


def test_the_32_bit_forms_are_chosen_alike_past_2_31_cells():
    """The host-combined pairs (L3, the reference's
    apply_preagg_i32_kernel), the native fused scan and the device-made
    ingest (whose reference casts cells to int32) are all gated on the
    (slot, ring column) pair domain, 2^23 cells. At 2^26 slots x 32
    columns (2^31 cells) neither package chooses any of them; at 2^23
    cells both choose the host combine. Checked on each operator's own
    gates with the layout widened in place (no state is allocated)."""
    def both(slots):
        ref, port = pair(lambda m: m.multi(m.count(), m.sum_of("price")),
                         ("sliding", 10_000, 1_000))
        cref, cport = pair(lambda m: m.count(), ("sliding", 10_000, 1_000),
                           top=("count", 1))
        for r, p in ((ref, port), (cref, cport)):
            ring = p.plan.ring
            assert ring == r.plan.ring
            r.layout = dataclasses.replace(r.layout, slots=slots // ring)
            r._build_local_kernels()
            p.layout = dataclasses.replace(p.layout, slots=slots // ring)
        return (ref, port), (cref, cport)

    (ref, port), (cref, cport) = both(2 ** 31)
    assert port._cell_dtype() is np.int64
    # L3: the sum lanes' host combine
    assert ref._preagg_lanes is None and port._preagg_lanes() is None
    # the fused scan runs only for a count-only pre-combinable aggregate
    assert cref._preagg_lanes is None and cport._preagg_lanes() is None
    # the device-made ingest attaches to neither
    assert not cref.attach_device_source(_Spec())
    assert not cport.attach_device_source(_Spec())
    (ref, port), (cref, cport) = both(2 ** 23)
    assert ref._preagg_lanes == port._preagg_lanes() == ("price",)
    assert cref._preagg_lanes == cport._preagg_lanes() == ()
