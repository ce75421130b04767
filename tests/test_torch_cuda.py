"""The port's CUDA kernels and its card path, held against the plain
PyTorch versions on the card (exact: integer work on the count lane).

Needs a CUDA device and nvcc; every test skips itself elsewhere. This
file imports neither jax nor flink_tpu, so it also runs where only the
port's dependencies are installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from flink_tpu_torch.kernels import window_kernels as wk
from test_torch_threads import capped_torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    return torch.device("cuda")


def _live_counts(rng, rows, ring, pane_lo, pane_hi, hi=50, density=0.4):
    counts = np.zeros((rows, ring), np.int32)
    for p in range(pane_lo, pane_hi + 1):
        counts[:, p % ring] = rng.integers(0, hi, rows) * (rng.random(rows) < density)
    return counts


def _t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


@pytest.mark.parametrize("with_cnt", [True, False])
def test_scatter_counts(dev, with_cnt):
    rng = np.random.default_rng(1)
    counts = _t(rng.integers(0, 9, (32769, 32)).astype(np.int32), dev)
    idx = _t(rng.integers(0, 32769 * 32, 300_000).astype(np.int32), dev)
    cnt = _t(rng.integers(1, 5000, 300_000).astype(np.int32), dev) if with_cnt else None
    a, b = counts.clone(), counts.clone()
    wk.scatter_counts(a, idx, cnt)
    wk.scatter_counts_plain(b, idx, cnt)
    assert torch.equal(a, b)


@pytest.mark.parametrize("ring,W", [(16, 1), (24, 16), (32, 64)])
def test_window_counts(dev, ring, W):
    rng = np.random.default_rng(ring + W)
    pane_lo, pane_hi, ppw = 500, 500 + ring - 3, 10
    counts = _t(_live_counts(rng, 4097, ring, pane_lo, pane_hi), dev)
    ends = rng.integers(pane_lo - 3, pane_hi + ppw + 2, W).astype(np.int64)
    valid = rng.random(W) < 0.8
    ends = np.where(valid, ends, -(2 ** 62))
    e, v = _t(ends, dev), _t(valid, dev)
    assert torch.equal(wk.window_counts(counts, e, v, pane_lo, pane_hi, ppw),
                       wk.window_counts_plain(counts, e, v, pane_lo, pane_hi, ppw))


@pytest.mark.parametrize("rows,ring,W,valid", [
    (32_769, 32, 11, "some"),    # the Q5 fire: 257 tiles, the last of one row
    (1000, 1, 1, "all"),         # ring 1, one window
    (4097, 64, 64, "some"),      # one pass of 64 windows
    (4097, 64, 65, "some"),      # a second pass of one window
    (777, 32, 11, "none"),       # every window invalid: all zeros
    (50, 40_000, 5, "all"),      # one row a tile, the live panes in segments
])
def test_window_counts_tiles_passes_and_segments(dev, rows, ring, W, valid):
    """K2 bit for bit against its plain version: rows not a multiple of
    the tile, W past the window table, rings 1 to past a staged row,
    ends below pane_lo and past hi_cap, sentinel ends; into a new tensor
    and into a reused out tensor."""
    rng = np.random.default_rng(rows + ring + W)
    # past a staged row, windows of 5,000 panes straddle the segments
    ppw = 5_000 if ring > 24_000 else min(10, ring)
    pane_lo = 10_000 + int(rng.integers(0, ring))
    pane_hi = pane_lo + max(ring - 2, 0)
    counts = _t(_live_counts(rng, rows, ring, pane_lo, pane_hi,
                             hi=1 << 16), dev)
    ends = rng.integers(pane_lo - 3, pane_hi + ppw + 3, W).astype(np.int64)
    ok = {"all": np.ones(W, bool), "none": np.zeros(W, bool),
          "some": rng.random(W) < 0.8}[valid]
    ends = np.where(ok, ends, -(2 ** 62))
    e, v = _t(ends, dev), _t(ok, dev)
    want = wk.window_counts_plain(counts, e, v, pane_lo, pane_hi, ppw)
    assert torch.equal(wk.window_counts(counts, e, v, pane_lo, pane_hi, ppw),
                       want)
    out = torch.full((rows, W), -7, dtype=torch.int32, device=dev)
    assert wk.window_counts(counts, e, v, pane_lo, pane_hi, ppw, out) is out
    assert torch.equal(out, want)
    if valid == "none":
        assert not want.any()


@pytest.mark.parametrize("n_ends", [0, 11])
def test_fused_step_window_counts_store_only_valid_windows(dev, monkeypatch,
                                                           n_ends):
    """F2's window counts in its scratch: with no valid end the gated
    kernel writes nothing; with ends, each valid window's column equals
    the plain counts and the invalid columns are never written (the top-n
    reads w_valid first)."""
    from flink_tpu_torch.kernels import fused_kernels as fk

    rng = np.random.default_rng(29 + n_ends)
    slots, ring, ppw, pane_lo, pane_hi = 4096, 32, 10, 500, 520
    counts = _t(_live_counts(rng, slots + 1, ring, pane_lo, pane_hi), dev)
    hdr = np.zeros(fk.FUSED_HDR, np.int32)
    hdr[:6] = np.array([pane_lo, pane_hi, pane_lo], np.int64).view(np.int32)
    deltas = np.full(fk.MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
    deltas[:n_ends] = np.arange(pane_hi + 2 - n_ends, pane_hi + 2) - pane_lo
    hdr[8:8 + fk.MIN_FIRE_PAD] = deltas.astype(np.int32)
    words = np.full(256, -1, np.int32)      # padding words only
    buf = _t(np.concatenate([hdr, words]), dev)
    used = torch.ones(slots + 1, dtype=torch.bool, device=dev)
    held = []
    real = wk.scratch

    def marked(device, n_words):
        t, ptr = real(device, n_words)
        t.fill_(-123)
        held.append(t)
        return t, ptr
    monkeypatch.setattr(wk, "scratch", marked)
    fire_pad = 16
    ring_buf = torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
    fk.fused_step(counts.clone(), ring_buf, buf, used, ppw=ppw, n=1,
                  sel_cap=256, dump_row=slots, fire_gate=True,
                  fire_pad=fire_pad)
    torch.cuda.synchronize()
    params = -(-fk._lib().ff_params_bytes() // 8) * 2
    wc = held[0][params:params + (slots + 1) * fire_pad].view(slots + 1,
                                                               fire_pad)
    e = _t(np.where(deltas[:fire_pad] > fk.DELTA_SENTINEL,
                    pane_lo + deltas[:fire_pad], -(2 ** 62)), dev)
    v = _t(deltas[:fire_pad] > fk.DELTA_SENTINEL, dev)
    want = wk.window_counts_plain(counts, e, v, pane_lo, pane_hi, ppw)
    assert torch.equal(wc[:, :n_ends], want[:, :n_ends])
    assert bool((wc[:, n_ends:] == -123).all())


@pytest.mark.parametrize("case", ["one_cell", "wordcount_head", "int64",
                                  "skip_negative", "straddle"])
def test_scatter_counts_per_record_forms(dev, case):
    """K1 per record bit for bit against its plain version: every record
    on one cell (the hot limit), WordCount's floor(u^2 * 30,000) head in
    one pane, int64 cells, the mesh's -1 padding, a batch over two panes
    (chunks whose records differ from their reference column); at 2^20
    + 5 records (8,192-record chunks and a short last one) and at 70,000
    (2,048-record chunks)."""
    rng = np.random.default_rng(len(case))
    rows, ring, n = 65_537, 16, (1 << 20) + 5
    if case == "one_cell":
        cells = np.full(n, 40_000 * ring + 3, np.int64)
    else:
        words = (rng.random(n) ** 2 * 30_000).astype(np.int64)
        slot = rng.permutation(rows - 1)[words]
        col = np.where(np.arange(n) < 700_000, 5, 6) if case == "straddle" \
            else np.full(n, 5)
        cells = slot * ring + col
    if case == "skip_negative":
        cells[rng.random(n) < 0.3] = -1
    idx = _t(cells.astype(np.int64 if case == "int64" else np.int32), dev)
    base = _t(rng.integers(0, 9, (rows, ring)).astype(np.int32), dev)
    want = wk.scatter_counts_plain(base.clone(), idx, None,
                                   skip_negative=case == "skip_negative")
    got = wk.scatter_counts(base.clone(), idx, None,
                            skip_negative=case == "skip_negative")
    assert torch.equal(got, want)
    few = idx[:70_000].contiguous()
    assert torch.equal(
        wk.scatter_counts(base.clone(), few, None,
                          skip_negative=case == "skip_negative"),
        wk.scatter_counts_plain(base.clone(), few, None,
                                skip_negative=case == "skip_negative"))
    wk.check_errors(dev)


def test_scatter_counts_per_record_out_of_range(dev):
    """An index outside the state sets bit 1 and is not written; the rest
    are counted."""
    wk.check_errors(dev)
    c = torch.zeros((300, 8), dtype=torch.int32, device=dev)
    idx = np.full(5000, 17, np.int32)
    idx[[3, 4000]] = [2400, -2]
    wk.scatter_counts(c, _t(idx, dev))
    assert int(c.view(-1)[17]) == 4998 and int(c.sum()) == 4998
    with pytest.raises(IndexError, match="scatter_counts"):
        wk.check_errors(dev)
    wk.check_errors(dev)


@pytest.mark.parametrize("ring", [1, 32, 256])
def test_scatter_split_counts(dev, ring):
    """The split upload's one-launch count bit for bit against its plain
    version (invalid slots add nothing, the dump row's own slot counts),
    and against split_cells + scatter_counts on the valid records; a slot
    past the dump row sets bit 64 and is not written."""
    from flink_tpu_torch.ops.window import split_encode

    rng = np.random.default_rng(ring + 5)
    n, dump_row = (1 << 20) + 3, 32_768
    sl = (rng.random(n) ** 2 * dump_row).astype(np.int64)
    sl[:5] = dump_row
    valid = rng.random(n) < 0.95
    sc = _t(split_encode(sl, rng.integers(0, ring, n).astype(np.uint8),
                         valid), dev)
    base = _t(rng.integers(0, 9, (dump_row + 1, ring)).astype(np.int32), dev)
    want = wk.scatter_split_counts_plain(base.clone(), sc, dump_row)
    assert torch.equal(wk.scatter_split_counts(base.clone(), sc, dump_row),
                       want)
    two = base.clone()
    ok = _t(valid, dev)
    wk.scatter_counts(two, wk.split_cells(sc, ring, dump_row)[ok])
    assert torch.equal(two, want)
    wk.check_errors(dev)
    bad = split_encode(np.array([3, dump_row + 1, 3]),
                       np.zeros(3, np.uint8), np.ones(3, bool))
    c = torch.zeros((dump_row + 1, ring), dtype=torch.int32, device=dev)
    try:
        wk.scatter_split_counts(c, _t(bad, dev), dump_row)
        assert int(c[3, 0]) == 2 and int(c.sum()) == 2
        with pytest.raises(IndexError, match="split_cells"):
            wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()


def _topn(dev, seed, rows, W, n, sel_cap, *, fill=0, hi=30, density=0.4,
          row_cap=2048):
    rng = np.random.default_rng(seed)
    wc = _t((rng.integers(0, hi, (rows, W)) * (rng.random((rows, W)) < density)
             ).astype(np.int32), dev)
    used = rng.random(rows) < 0.9
    used[-1] = False
    used = _t(used, dev)
    ends = _t(np.arange(100, 100 + W, dtype=np.int64), dev)
    valid = torch.ones(W, dtype=torch.bool, device=dev)
    r1 = torch.zeros((row_cap + 2, 3), dtype=torch.int32, device=dev)
    r1[0, 0] = fill
    r2 = r1.clone()
    wk.topn_select_append(wc, used, ends, valid, 90, n, sel_cap, r1)
    wk.topn_select_append_plain(wc, used, ends, valid, 90, n, sel_cap, r2)
    assert torch.equal(r1[:-1], r2[:-1])
    return r1


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("W", [1, 11, 64])
def test_topn_select_append(dev, n, W):
    """Many compaction tiles (32769 x W cells), ring wrap-around."""
    r = _topn(dev, n * 7 + W, 32769, W, n, 4096, fill=2000, hi=1_000_000)
    assert int(r[0, 1]) == 0 and int(r[0, 0]) > 2000


def test_topn_tie_explosion(dev):
    """Ties past sel_cap: the first sel_cap rows land in row-major order
    and the rest count as truncated."""
    r = _topn(dev, 3, 32769, 4, 1, 256, hi=2, density=0.5)
    assert int(r[0, 0]) == 256 and int(r[0, 1]) > 0


def test_topn_fewer_than_n_candidates(dev):
    r = _topn(dev, 4, 300, 3, 50, 256, density=0.05)
    assert int(r[0, 1]) == 0


def test_ring_columns_purge_and_growth(dev):
    rng = np.random.default_rng(5)
    a = _t(rng.integers(0, 100, (32769, 32)).astype(np.int32), dev)
    keep = _t(rng.random(32) < 0.6, dev)
    ident = torch.arange(32, dtype=torch.int32, device=dev)
    x, y = a.clone(), a.clone()
    wk.ring_columns(x, x, ident, keep)
    wk.ring_columns_plain(y, y, ident, keep)
    assert torch.equal(x, y)
    cmap = np.full(64, -1, np.int64)
    ps = np.arange(777, 777 + 30)
    cmap[ps % 64] = ps % 32
    src = _t(np.maximum(cmap, 0).astype(np.int32), dev)
    kp = _t(cmap >= 0, dev)
    g1 = torch.empty((32769, 64), dtype=torch.int32, device=dev)
    g2 = torch.full_like(g1, -7)
    wk.ring_columns(a, g1, src, kp)
    wk.ring_columns_plain(a, g2, src, kp)
    assert torch.equal(g1, g2)


def test_out_of_range_entries_set_the_error_word(dev):
    """The kernels skip (K1) or zero (K4) an out-of-range entry, apply
    the rest, and report it: check_errors raises once, then the word is
    clear."""
    wk.check_errors(dev)
    c = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    wk.scatter_counts(c, _t(np.array([3, -1, 32, 3], np.int32), dev))
    assert int(c.view(-1)[3]) == 2 and int(c.sum()) == 2
    with pytest.raises(IndexError, match="scatter_counts"):
        wk.check_errors(dev)
    wk.check_errors(dev)
    src_col = torch.arange(8, dtype=torch.int32, device=dev)
    src_col[5] = 8
    c[:] = 7
    wk.ring_columns(c, c, src_col, torch.ones(8, dtype=torch.bool, device=dev))
    assert int(c[:, 5].abs().sum()) == 0 and int(c.sum()) == 7 * 4 * 7
    with pytest.raises(IndexError, match="ring_columns"):
        wk.check_errors(dev)
    wk.check_errors(dev)


def test_operator_drain_raises_on_a_reported_error(dev):
    """A kernel error reaches the host with the next emit-ring copy."""
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.ops.aggregates import count
    from flink_tpu_torch.ops.window import WindowOperator

    op = WindowOperator(SlidingEventTimeWindows.of(2_000, 1_000), count(),
                        num_shards=8, slots_per_shard=64, top_n=("count", 1),
                        device=dev)
    op.process_batch(np.arange(50) % 7, np.arange(50) * 40, {})
    wk.scatter_counts(op.state.counts, _t(np.array([-5], np.int32), dev))
    try:
        with pytest.raises(IndexError, match="scatter_counts"):
            dict(op.advance_watermark(10_000))
    finally:
        wk.error_word(dev).zero_()


def test_window_operator_on_the_card_matches_the_cpu(dev):
    """The same batches through the operator on the card and on the CPU:
    the same fired rows in the same order, and the same pane state."""
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.ops.aggregates import count
    from flink_tpu_torch.ops.window import WindowOperator

    rng = np.random.default_rng(6)
    ops = [WindowOperator(SlidingEventTimeWindows.of(10_000, 1_000), count(),
                          num_shards=32, slots_per_shard=256,
                          max_out_of_orderness_ms=1_000, top_n=("count", 2),
                          device=d) for d in ("cpu", dev)]
    t = 0
    for _ in range(6):
        n = int(rng.integers(100, 40_000))
        keys = rng.zipf(1.5, n) % 3000
        ts = t + rng.integers(-900, 6_000, n)
        t += 6_000
        outs = []
        for op in ops:
            op.process_batch(keys, ts, {})
            f = dict(op.advance_watermark(int(ts.max()) - 1_001))
            outs.append([tuple(np.asarray(f[k]).tolist()) for k in
                         ("key", "window_end", "count")])
        assert outs[0] == outs[1]
    ends = [dict(op.advance_watermark(op.final_watermark())) for op in ops]
    assert np.array_equal(ends[0]["key"], ends[1]["key"])
    assert np.array_equal(ends[0]["count"], ends[1]["count"])
    assert torch.equal(ops[0].state.counts, ops[1].state.counts.cpu())
    # per record, the count takes the split upload's bytes in one launch
    assert all(wk.LAUNCHES[k] > 0 for k in (
        "scatter_split_counts", "window_counts", "topn_select_append",
        "ring_columns"))


def test_q5_on_the_card_matches_the_cpu(dev):
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import CollectSink
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_stream
    from flink_tpu_torch.nexmark.queries import q5_hot_items

    cfg = NexmarkConfig(batch_size=1 << 16, n_batches=5, events_per_ms=8,
                        num_active_auctions=2_000, hot_ratio=4)
    rows = []
    for d in ("cpu", dev):
        env = StreamExecutionEnvironment(Configuration(
            {"state.num-key-shards": 32, "state.slots-per-shard": 256}))
        sink = CollectSink()
        q5_hot_items(env, bid_stream(cfg), sink, out_of_orderness_ms=1_000)
        env.execute("q5", device=d)
        rows.append([(int(r["auction"]), int(r["window_end"]),
                      int(r["bid_count"])) for r in sink.rows])
    assert rows[0] == rows[1] and len(rows[0]) > 40


def test_sql_q5_launches_what_datastream_q5_launches(dev):
    """SQL Q5 (``Table.execute()`` at its default device, the card) and
    ``q5_hot_items`` on the same bids: the same rows in the same order,
    the same kernels the same number of times, and the CPU's rows."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import CollectSink
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_stream
    from flink_tpu_torch.nexmark.queries import q5_hot_items
    from flink_tpu_torch.table import TableEnvironment
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    cfg = NexmarkConfig(batch_size=1 << 16, n_batches=5, events_per_ms=8,
                        num_active_auctions=2_000, hot_ratio=4)
    conf = {"state.num-key-shards": 32, "state.slots-per-shard": 256}
    sql = ("SELECT auction, window_end, COUNT(*) AS bid_count "
           "FROM TABLE(HOP(TABLE bids, DESCRIPTOR(ts), "
           "INTERVAL '1' SECOND, INTERVAL '10' SECOND)) "
           "GROUP BY auction, window_start, window_end "
           "ORDER BY bid_count DESC LIMIT 1")

    def view(r):
        return [(int(x["auction"]), int(x["window_end"]),
                 int(x["bid_count"])) for x in r]

    env = StreamExecutionEnvironment(Configuration(conf))
    sink = CollectSink()
    q5_hot_items(env, bid_stream(cfg), sink, out_of_orderness_ms=1_000)
    wk.reset_launch_counts()
    env.execute("q5", device=dev)
    ds_launches, ds_rows = dict(wk.LAUNCHES), view(sink.rows)

    rows = {}
    for d in (None, "cpu"):
        env = StreamExecutionEnvironment(Configuration(conf))
        t_env = TableEnvironment.create(env)
        t_env.create_temporary_view(
            "bids", env.from_source(
                bid_stream(cfg),
                WatermarkStrategy.for_bounded_out_of_orderness(1_000)),
            schema=["auction", "bidder", "price"], time_attr="ts")
        table = t_env.sql_query(sql)
        wk.reset_launch_counts()
        res = table.execute("sql-q5") if d is None else table.execute(
            "sql-q5", device=d)
        rows[d] = view(res.rows)
        if d is None:
            sql_launches = dict(wk.LAUNCHES)
    assert sql_launches == ds_launches
    assert all(sql_launches[k] > 0 for k in (
        "fused_step", "window_counts", "topn_select_append", "ring_columns"))
    assert rows[None] == ds_rows == rows["cpu"] and len(ds_rows) > 40


# -- the device-made ingest (nexmark_bids, devgen_ingest) --------------------

@pytest.mark.parametrize("logical,off", [(0, 0), (5, 1 << 20), (77, 3 << 20)])
def test_nexmark_bids(dev, logical, off):
    from flink_tpu_torch.kernels import devgen_kernels as dk

    args = (logical, off, 1 << 20, 1 << 22, 100, 4, 100, 10_000)
    k1, t1 = dk.nexmark_bids(*args, dev)
    k2, t2 = dk.nexmark_bids_plain(*args, dev)
    assert torch.equal(k1, k2) and torch.equal(t1, t2)
    assert int(k1.min()) >= 0 and int(k1.max()) < 10_000


def _ingest_both(dev, keys, ts, **kw):
    from flink_tpu_torch.kernels import devgen_kernels as dk

    a = torch.zeros((32769, 64), dtype=torch.int32, device=dev)
    b = a.clone()
    sa = dk.devgen_ingest(a, keys, ts, **kw)
    sb = dk.devgen_ingest_plain(b, keys, ts, kw["key_domain"], kw["pane_ms"],
                                kw["offset_ms"], kw["dead_below"],
                                kw["refire_below"], kw["dump_row"],
                                torch.zeros_like(sa))
    assert torch.equal(a, b) and torch.equal(sa, sb)
    return a, sa


@pytest.mark.parametrize("late", [False, True])
def test_devgen_ingest(dev, late):
    """A 2^20 sub-batch of the headline stream; with ``late`` some keys
    leave the domain (or go negative) and some panes fall below the dead
    and fired frontiers, so the stats words and the bitmap are held to
    the plain version too."""
    from flink_tpu_torch.kernels import devgen_kernels as dk

    keys, ts = dk.nexmark_bids(3, 1 << 20, 1 << 20, 1 << 22, 100, 4, 100,
                               10_000, dev)
    lo = int(ts.min()) // 1000
    kw = dict(key_domain=10_000, pane_ms=1000, offset_ms=0, dead_below=lo,
              refire_below=-(2 ** 63), dump_row=32768)
    if late:
        rng = np.random.default_rng(9)
        pick = _t(rng.random(keys.numel()), dev)
        keys = keys.clone()
        keys[pick < 0.05] += 10_000
        keys[pick > 0.98] = -1
        kw.update(dead_below=lo + 2, refire_below=lo + 5)
    state, stats = _ingest_both(dev, keys, ts, **kw)
    head = stats[:8].tolist()
    assert head[0] + head[1] + head[2] == keys.numel()
    assert int(state.sum()) == keys.numel()
    if late:
        assert head[1] > 0 and head[2] > 0 and head[4] > 0
        assert int(stats[8:].sum()) == 3


def test_devgen_ingest_without_stats(dev):
    """The headline form (no stats vector): the same counts as the plain
    version and as the form with stats."""
    from flink_tpu_torch.kernels import devgen_kernels as dk

    keys, ts = dk.nexmark_bids(3, 0, 1 << 20, 1 << 22, 100, 4, 100, 10_000,
                               dev)
    kw = dict(key_domain=10_000, pane_ms=1000, offset_ms=0,
              dead_below=int(ts.min()) // 1000, refire_below=-(2 ** 63),
              dump_row=32768)
    with_stats, _ = _ingest_both(dev, keys, ts, **kw)
    a = torch.zeros_like(with_stats)
    b = torch.zeros_like(with_stats)
    assert dk.devgen_ingest(a, keys, ts, with_stats=False, **kw) is None
    assert dk.devgen_ingest_plain(
        b, keys, ts, kw["key_domain"], kw["pane_ms"], kw["offset_ms"],
        kw["dead_below"], kw["refire_below"], kw["dump_row"], None) is None
    assert torch.equal(a, b) and torch.equal(a, with_stats)


def test_pinned_stage_round_trips(dev):
    """More uploads than slots, while the stream is busy, of every dtype
    the operator stages and of an array past the slot size: each lands
    intact."""
    from flink_tpu_torch.ops.window import PinnedStage

    stage = PinnedStage(dev)
    rng = np.random.default_rng(3)
    busy = torch.randn(4096, 4096, device=dev)
    sent, got = [], []
    for i in range(3 * PinnedStage.SLOTS):
        busy = busy @ busy / 64  # keep the stream behind the host
        for arr in (rng.integers(-2 ** 40, 2 ** 40, 1 + i % 64),
                    rng.random(64 + i) < 0.5,
                    rng.integers(0, 2 ** 30, 700, dtype=np.int64)
                    .astype(np.int32)):
            sent.append(arr.copy())
            got.append(stage.upload(arr))
            arr[:] = 0  # the caller may reuse its array at once
    sent.append(np.arange(PinnedStage.SLOT_BYTES, dtype=np.int64))
    got.append(stage.upload(sent[-1]))
    torch.cuda.synchronize()
    for a, t in zip(sent, got):
        assert t.device.type == "cuda"
        np.testing.assert_array_equal(t.cpu().numpy(), a)


def test_devgen_ingest_error_word(dev):
    """A dump row outside the state: the invalid records are not written
    and the error word reports it."""
    from flink_tpu_torch.kernels import devgen_kernels as dk

    wk.check_errors(dev)
    c = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    keys = _t(np.array([1, 9, 2], np.int64), dev)
    ts = _t(np.array([5, 6, 7], np.int64), dev)
    dk.devgen_ingest(c, keys, ts, key_domain=3, pane_ms=1, offset_ms=0,
                     dead_below=0, refire_below=-(2 ** 63), dump_row=4)
    assert int(c.sum()) == 2
    with pytest.raises(IndexError, match="devgen_ingest"):
        wk.check_errors(dev)
    wk.check_errors(dev)


@pytest.mark.parametrize("k", [1, 4])
def test_devgen_q5_on_the_card_matches_the_cpu(dev, k):
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import CollectSink
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_stream_device
    from flink_tpu_torch.nexmark.queries import q5_hot_items

    cfg = NexmarkConfig(batch_size=1 << 18, n_batches=4, events_per_ms=8,
                        num_active_auctions=2_000, hot_ratio=4)
    rows = []
    for d in ("cpu", dev):
        env = StreamExecutionEnvironment(Configuration(
            {"state.num-key-shards": 32, "state.slots-per-shard": 256,
             "pipeline.microbatch-size": 1 << 18, "pipeline.sub-batches": k}))
        sink = CollectSink()
        q5_hot_items(env, bid_stream_device(cfg), sink,
                     out_of_orderness_ms=1_000)
        wk.reset_launch_counts()
        res = env.execute("q5-devgen", device=d)
        assert res.metrics["devgen_host_batches"] == 0
        rows.append([(int(r["auction"]), int(r["window_end"]),
                      int(r["bid_count"])) for r in sink.rows])
    assert rows[0] == rows[1] and len(rows[0]) > 100
    # each sub-batch's bids made inside its ingest: one launch a step
    assert wk.LAUNCHES["nexmark_bids"] == 0
    assert wk.LAUNCHES["devgen_ingest"] == 4 * k


def test_checkpoint_freeze_is_the_state_at_the_cut(dev):
    """A checkpoint's freeze is a clone enqueued on the operator's stream,
    with no synchronization: steps launched after it update the panes in
    place, and the snapshot materialized afterwards on another thread
    (the checkpoint executor's) still holds the panes at the cut — the
    copy taken after a synchronize() there."""
    from concurrent.futures import ThreadPoolExecutor

    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.checkpoint.coordinator import materialize_snapshot
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_stream_device
    from flink_tpu_torch.ops.aggregates import count
    from flink_tpu_torch.ops.window import WindowOperator

    src = bid_stream_device(NexmarkConfig(
        batch_size=1 << 18, n_batches=8, events_per_ms=8,
        num_active_auctions=2_000, hot_ratio=4)).subdivided(4)
    op = WindowOperator(SlidingEventTimeWindows.of(10_000, 1_000), count(),
                        num_shards=32, slots_per_shard=256,
                        max_out_of_orderness_ms=1_000, top_n=("count", 1),
                        device=dev)
    assert op.attach_device_source(src)

    def step(i):
        assert op.process_batch_device(i)
        op.advance_watermark(src.ts_bounds(i)[1] - 1_001)

    for i in range(13):  # the cut falls inside logical batch 3
        step(i)
    snap = op.snapshot_state()
    torch.cuda.synchronize()
    at_cut = op.state.counts.cpu().clone()
    for i in range(13, 32):
        step(i)
    with ThreadPoolExecutor(max_workers=1) as ex:
        mat = ex.submit(materialize_snapshot, snap).result()
    assert isinstance(mat["panes"].counts, np.ndarray)
    assert np.array_equal(mat["panes"].counts, at_cut.numpy())
    assert int(at_cut.sum()) > 0
    torch.cuda.synchronize()
    assert not torch.equal(op.state.counts.cpu(), at_cut)
    wk.check_errors(dev)


# -- the lane kernels (fire_pack, scatter_lanes, scatter_pair_lanes) ---------

def _lane_state(rng, rows, ring, pane_lo, pane_hi, sw, mw, nw):
    """Pane state with data only in the live panes' columns, identities
    elsewhere."""
    counts = np.zeros((rows, ring), np.int32)
    sums = np.zeros((rows, ring, sw), np.float32)
    maxs = np.full((rows, ring, mw), -np.inf, np.float32)
    mins = np.full((rows, ring, nw), np.inf, np.float32)
    for p in range(pane_lo, pane_hi + 1):
        c = p % ring
        hit = rng.random(rows) < 0.4
        k = int(hit.sum())
        counts[hit, c] = rng.integers(1, 30, k)
        sums[hit, c] = (rng.random((k, sw)) * 1e4).astype(np.float32)
        maxs[hit, c] = rng.standard_normal((k, mw)).astype(np.float32)
        mins[hit, c] = rng.standard_normal((k, nw)).astype(np.float32)
    return counts, sums, maxs, mins


def _same_bits(a, b):
    """Equal, NaN-aware and signed zeros distinct."""
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(
            a[~nan].view(torch.int32), b[~nan].view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("packed2,sw,mw,nw,W", [
    (True, 0, 0, 0, 4), (False, 0, 0, 0, 3), (False, 1, 1, 1, 4),
    (False, 2, 0, 1, 1)])
def test_fire_pack(dev, packed2, sw, mw, nw, W):
    """Kernel against the plain version on the card: rows, order, head and
    every lane bit for bit (both add the sums in column order)."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    rng = np.random.default_rng(W + sw)
    rows, ring, lo, hi, ppw = 32769, 32, 1000, 1020, 10
    c, s, mx, mn = _lane_state(rng, rows, ring, lo, hi, sw, mw, nw)
    c[3, :] = 0                               # a key with nothing live
    mx[5, lo % ring] = np.nan
    used = rng.random(rows) < 0.9
    used[-1] = False
    ends = _t(np.arange(hi - W + 2, hi + 2, dtype=np.int64), dev)
    valid = torch.ones(W, dtype=torch.bool, device=dev)
    args = [_t(c, dev)] + [_t(x, dev) if x.shape[2] else None
                           for x in (s, mx, mn)]
    cap = 1 << 17
    a_buf, a_lanes = lk.fire_pack(*args, ends, valid, _t(used, dev), lo, hi,
                                  ppw, cap, packed2)
    b_buf, b_lanes = lk.fire_pack_plain(*args, ends, valid, _t(used, dev), lo,
                                        hi, ppw, cap, packed2)
    n = int(b_buf[0, 0])
    assert 0 < n <= cap and int(a_buf[0, 0]) == n
    assert torch.equal(a_buf[:n + 1].cpu(), b_buf[:n + 1].cpu())
    if sw + mw + nw:
        assert _same_bits(a_lanes[:n], b_lanes[:n])
    else:
        assert a_lanes is None and b_lanes is None


def test_fire_pack_overflow_sets_the_error_word(dev):
    from flink_tpu_torch.kernels import lane_kernels as lk

    c = torch.ones((300, 8), dtype=torch.int32, device=dev)
    used = torch.ones(300, dtype=torch.bool, device=dev)
    ends = torch.tensor([5, 6], device=dev)
    try:
        buf, _ = lk.fire_pack(c, None, None, None, ends,
                              torch.ones(2, dtype=torch.bool, device=dev),
                              used, 0, 7, 1, 64, True)
        assert int(buf[0, 0]) == 600
        with pytest.raises(IndexError, match="fire_pack"):
            wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()


def _fire_case(dev, rng, rows, ring, W, widths, density=0.5):
    """Counts with empty and non-empty cells in every column, and
    ``_window_lanes_case``'s lanes (NaN, -NaN, +-inf, -0.0 in live and dead
    columns), windows (one that wraps the ring, invalid ones) and range;
    the last row unused. Returns the fire's arguments up to ``out_cap``."""
    lanes, ends, valid, lo, hi, ppw = _window_lanes_case(dev, rng, rows, ring,
                                                         W, widths)
    counts = (rng.integers(1, 5, (rows, ring))
              * (rng.random((rows, ring)) < density)).astype(np.int32)
    used = rng.random(rows) < 0.9
    used[-1] = False
    return [_t(counts, dev), *lanes, ends, valid, _t(used, dev), lo, hi, ppw]


def _fire_both(args, cap, packed2, row_offset=0):
    """fire_pack against its plain version: the head, the first
    min(n, cap) rows and their lanes bit for bit. Returns n."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    a_buf, a_lanes = lk.fire_pack(*args, cap, packed2, row_offset)
    b_buf, b_lanes = lk.fire_pack_plain(*args, cap, packed2, row_offset)
    n = int(b_buf[0, 0])
    m = min(n, cap)
    assert int(a_buf[0, 0]) == n
    assert torch.equal(a_buf[:m + 1].cpu(), b_buf[:m + 1].cpu())
    if b_lanes is None:
        assert a_lanes is None
    else:
        assert a_lanes.shape == b_lanes.shape
        assert _exact_bits(a_lanes[:m], b_lanes[:m])
    return n


FIRE_SHAPES = [(ring, W) for ring in (1, 16, 32, 37, 64, 1100)
               for W in (1, 4, 11, 64)]
FIRE_WIDTHS = [(0, 0, 0), (1, 0, 0), (1, 1, 1), (4, 0, 0)]


@pytest.mark.parametrize("shape", range(len(FIRE_SHAPES)))
def test_fire_pack_bit_for_bit(dev, shape):
    """The one-launch kernel against the plain version on the card, rows
    and lanes bit for bit: rings of 1, 16, 32, 37, 64 and 1100 columns
    (count and lane rows staged, count rows alone, or read where they
    lie), 1, 4, 11 and 64 windows, every lane layout of the main paths
    (none, one sum, sum + max + min, four sums), row counts that are no
    multiple of a tile, NaN, +-inf and -0.0 in live and dead columns, a
    window that wraps the ring and invalid ones; count-only in both
    layouts."""
    ring, W = FIRE_SHAPES[shape]
    widths = FIRE_WIDTHS[shape % len(FIRE_WIDTHS)]
    rows = 3001 if ring < 1100 else 203
    args = _fire_case(dev, np.random.default_rng(300 + shape), rows, ring, W,
                      widths)
    for packed2 in ((False, True) if not any(widths) else (False,)):
        assert _fire_both(args, 1 << 16, packed2) > 0


def test_fire_pack_one_row_tiles(dev):
    """Tiles shorter than a row (1100 columns and 64 windows stage two
    rows at most, W = 300 spans a tile over one or two rows) and a
    single-row state."""
    rng = np.random.default_rng(17)
    for rows, ring, W, widths in ((41, 1100, 64, (1, 0, 0)),
                                  (57, 40, 300, (1, 1, 1)),
                                  (1, 32, 4, (1, 1, 1))):
        args = _fire_case(dev, rng, rows, ring, W, widths, density=0.9)
        args[6][:] = True                        # every row in use
        _fire_both(args, 1 << 15, False)


def test_fire_pack_truncates_at_out_cap_with_a_row_offset(dev):
    """More selected cells than out_cap: the first out_cap rows and lanes,
    the head counting all, the error bit set; with a row offset, and in
    the packed2 layout."""
    rng = np.random.default_rng(23)
    args = _fire_case(dev, rng, 5000, 32, 11, (1, 1, 1))
    try:
        assert _fire_both(args, 1000, False, row_offset=4096) > 1000
        with pytest.raises(IndexError, match="fire_pack"):
            wk.check_errors(dev)
        count_only = [args[0], None, None, None, *args[4:]]
        assert _fire_both(count_only, 777, True) > 777
        with pytest.raises(IndexError, match="fire_pack"):
            wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()


def test_fire_pack_many_tiles_and_a_clean_workspace(dev):
    """A grid of ~1,200 tiles whose selected counts change band by band
    (empty, full, sparse, half), so the look-back adds aggregates and
    inclusive counts of every size; then smaller and larger fires in
    turn on the same stream, each on the workspace the one before left."""
    rng = np.random.default_rng(31)
    rows, ring, lo, hi = 300_001, 16, 7, 17
    counts = np.zeros((rows, ring), np.int32)
    density = np.array([0.0, 1.0, 0.01, 0.5])[(np.arange(rows) // 5000) % 4]
    for p in range(lo, hi + 1):
        counts[:, p % ring] = rng.integers(1, 9, rows) * (
            rng.random(rows) < density)
    used = _t(rng.random(rows) < 0.95, dev)
    ends = _t(np.arange(lo + 1, lo + 5, dtype=np.int64), dev)
    valid = torch.ones(4, dtype=torch.bool, device=dev)
    c = _t(counts, dev)
    big = [c, None, None, None, ends, valid, used, lo, hi, 1]
    small = [c[5000:5999], None, None, None, ends[:3], valid[:3],
             used[5000:5999], lo, hi, 3]
    sums = _t(rng.standard_normal((rows, ring, 1)).astype(np.float32), dev)
    lanes = [c, sums, None, None, ends, valid, used, lo, hi, 4]
    for args, packed2 in ((big, True), (small, False), (lanes, False),
                          (small, True), (big, False)):
        assert _fire_both(args, 1 << 20, packed2) > 0


@pytest.mark.parametrize("hot", [0.0, 0.3, 1.0])
def test_scatter_lanes(dev, hot):
    """2^20 records into 32,769 x 32 state: every lane equals the plain
    version on the CPU bit for bit (both add a cell's records in record
    order; index_add_ on the CPU adds in index order); counts and max/min
    equal the plain version on the card exactly, sums within the bound of
    another order (its index_add_ adds in no fixed order there); two
    kernel runs agree bit for bit."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    rng = np.random.default_rng(int(hot * 10))
    rows, ring, B = 32769, 32, 1 << 20
    c, s, mx, mn = _lane_state(rng, rows, ring, 0, 31, 1, 1, 1)
    cells = (rows - 1) * ring
    idx = np.where(rng.random(B) < hot, rng.integers(0, 3, B),
                   rng.integers(0, cells, B)).astype(np.int32)
    v = (rng.random(B) * 1e3).astype(np.float32)
    v[:4] = [np.nan, -0.0, 0.0, np.inf]
    x = _t(v[:, None], dev)
    state = [_t(a, dev) for a in (c, s, mx, mn)]
    runs = []
    for fn in (lk.scatter_lanes, lk.scatter_lanes, lk.scatter_lanes_plain):
        st = [t.clone() for t in state]
        fn(*st, _t(idx, dev), x, x, x)
        runs.append(st)
    for t0, t1 in zip(runs[0], runs[1]):
        assert _same_bits(t0, t1)
    for k in (0, 2, 3):
        assert _same_bits(runs[0][k], runs[2][k])
    cpu = [torch.from_numpy(a.copy()) for a in (c, s, mx, mn)]
    xc = torch.from_numpy(v[:, None].copy())
    lk.scatter_lanes_plain(*cpu, torch.from_numpy(idx), xc, xc, xc)
    for k in range(4):
        assert _same_bits(runs[0][k], cpu[k])
    got, want = runs[0][1].double(), runs[2][1].double()
    n = torch.zeros(rows * ring, dtype=torch.float64, device=dev)
    n.index_add_(0, _t(idx, dev).long(), torch.ones(B, dtype=torch.float64,
                                                    device=dev))
    mag = want.abs().reshape(-1) + 1.0
    bound = 2 * (n + 1) * 2.0 ** -24 * (mag + s.reshape(-1).max())
    ok = (got.reshape(-1) - want.reshape(-1)).abs() <= bound
    ok |= got.reshape(-1) == want.reshape(-1)          # the inf record's cell
    ok |= torch.isnan(got.reshape(-1)) & torch.isnan(want.reshape(-1))
    assert bool(ok.all())


def _scatter_both(dev, shape, widths, idx, vals=None, skip_negative=False,
                  seed=0, state=None):
    """``scatter_lanes`` twice on the card and ``scatter_lanes_plain`` on
    the CPU (record order) from one state; returns the card's first
    result after checking that every lane of all three is bit-equal.
    ``vals``: (B, sw + mw + nw) f32 record lanes (seeded when None)."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    rng = np.random.default_rng(seed)
    rows, ring = shape
    sw, mw, nw = widths
    if state is None:
        state = _lane_state(rng, rows, ring, 0, ring - 1, sw, mw, nw)
    B = len(idx)
    if vals is None:
        vals = (rng.standard_normal((B, sw + mw + nw)) * 1e3).astype(np.float32)
    parts = np.split(vals, [sw, sw + mw], axis=1)

    def run(device, fn):
        c, *lanes = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in state]
        lanes = [t if w else None for t, w in zip(lanes, widths)]
        recs = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in parts]
        fn(c, *lanes, torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(
            device), *recs, skip_negative=skip_negative)
        return [c] + [t for t in lanes if t is not None]

    a = run(dev, lk.scatter_lanes)
    b = run(dev, lk.scatter_lanes)
    cpu = run("cpu", lk.scatter_lanes_plain)
    for x, y, z in zip(a, b, cpu):
        assert _same_bits(x, y), "two runs differ"
        assert _same_bits(x, z), "differs from the plain version on the CPU"
    return a


@pytest.mark.parametrize("n", ["1", "tile-1", "tile", "tile+1"])
def test_scatter_lanes_tile_edges(dev, n):
    from flink_tpu_torch.kernels import lane_kernels as lk

    tile = lk._SORT_TILE
    B = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}[n]
    rng = np.random.default_rng(B)
    idx = rng.integers(0, 4097 * 32, B)
    idx[: B // 3] = 17                       # a run across the tile's spans
    _scatter_both(dev, (4097, 32), (1, 1, 1), idx, seed=B)


def test_scatter_lanes_one_cell_holds_every_record(dev):
    """2^16 records in one cell: the run crosses every fold span and every
    sort tile; its sum is one chain in record order."""
    B = 1 << 16
    out = _scatter_both(dev, (4097, 32), (1, 1, 1), np.full(B, 4097 * 16 + 5),
                        seed=3)
    assert int(out[0].view(-1)[4097 * 16 + 5]) >= B


@pytest.mark.parametrize("rows,passes", [((1 << 16) - 1, 2), (1 << 16, 3)])
def test_scatter_lanes_digit_boundary(dev, rows, passes):
    """The cell index's bits fall exactly on a digit boundary (16 bits: 2
    passes of 8) and one past it (17 bits: 3 passes)."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    B = 300_000
    assert lk._scatter_plan(B, rows).passes == passes
    rng = np.random.default_rng(rows)
    idx = rng.integers(0, rows, B)
    idx[:1000] = rows - 1                    # the top cell, every bit set
    idx[1000:2000] = 0
    _scatter_both(dev, (rows, 1), (1, 0, 1), idx, seed=rows)


def test_scatter_lanes_skip_negative_mesh_layout(dev):
    """The key-sharded owner's layout: 3/4 of the records are -1 (padded
    buckets) and touch nothing; no error."""
    rng = np.random.default_rng(5)
    B = 1 << 18
    idx = np.where(rng.random(B) < 0.75, -1, rng.integers(0, 8193 * 32, B))
    try:
        _scatter_both(dev, (8193, 32), (1, 1, 1), idx, skip_negative=True)
        assert int(wk.error_word(dev).item()) == 0
    finally:
        wk.error_word(dev).zero_()


@pytest.mark.parametrize("widths", [(0, 0, 0), (4, 0, 0), (2, 1, 3), (9, 0, 1)])
def test_scatter_lanes_widths(dev, widths):
    """Count only (zero-width lanes), four sum lanes (job C's changelog
    layout), and widths the kernel takes at run time."""
    rng = np.random.default_rng(sum(widths))
    idx = rng.integers(0, 2049 * 16, 100_000)
    idx[:5000] = 3
    _scatter_both(dev, (2049, 16), widths, idx, seed=len(widths))


def test_scatter_lanes_signed_zero_nan_inf(dev):
    """IEEE 754-2019 maximum / minimum: NaN wins, -0 < +0, +-inf; the
    state's own NaN and zeros too."""
    rng = np.random.default_rng(6)
    rows, ring, B = 65, 8, 20_000
    state = list(_lane_state(rng, rows, ring, 0, ring - 1, 1, 2, 2))
    state[2][1, 0] = [0.0, -0.0]
    state[3][1, 0] = [-0.0, 0.0]
    state[2][2, 0] = [np.nan, -np.inf]
    state[3][2, 0] = [np.inf, np.nan]
    idx = rng.integers(0, rows * ring, B)
    idx[:64] = np.repeat([ring + 0, 2 * ring + 0, 3 * ring, 4 * ring], 16)
    specials = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0,
                         -1.0], np.float32)
    vals = (rng.standard_normal((B, 5)) * 10).astype(np.float32)
    vals[:64] = rng.choice(specials, (64, 5))
    vals[rng.random((B, 5)) < 0.01] = -0.0
    _scatter_both(dev, (rows, ring), (1, 2, 2), idx, vals=vals, state=state)


def test_scatter_lanes_out_of_range_sets_error_and_folds_the_rest(dev):
    from flink_tpu_torch.kernels import lane_kernels as lk

    rng = np.random.default_rng(7)
    rows, ring, B = 1025, 8, 50_000
    state = _lane_state(rng, rows, ring, 0, ring - 1, 1, 1, 1)
    idx = rng.integers(0, rows * ring, B)
    bad = rng.random(B) < 0.01
    idx[bad] = np.where(rng.random(int(bad.sum())) < 0.5, -5, rows * ring + 9)
    vals = rng.standard_normal((B, 3)).astype(np.float32)
    t = [_t(a, dev) for a in state]
    recs = [_t(vals[:, k:k + 1], dev) for k in range(3)]
    try:
        lk.scatter_lanes(*t, _t(idx.astype(np.int32), dev), *recs)
        with pytest.raises(IndexError, match="scatter_lanes"):
            wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()
    ok = ~bad
    cpu = [torch.from_numpy(a.copy()) for a in state]
    lk.scatter_lanes_plain(*cpu, torch.from_numpy(idx[ok].astype(np.int32)),
                           *[torch.from_numpy(vals[ok, k:k + 1].copy())
                             for k in range(3)])
    for x, y in zip(t, cpu):
        assert _same_bits(x, y)


def test_scatter_pair_lanes(dev):
    from flink_tpu_torch.kernels import lane_kernels as lk

    rng = np.random.default_rng(3)
    rows, ring, P = 32769, 32, 110_000
    c, s, _, _ = _lane_state(rng, rows, ring, 0, 31, 2, 0, 0)
    pairs = rng.choice((rows - 1) * ring, P, replace=False).astype(np.int32)
    buf = np.zeros((131_072, 4), np.int32)
    buf[:, 0] = -1
    buf[:P, 0] = pairs
    buf[:P, 1] = rng.integers(1, 50, P)
    buf[:P, 2:] = (rng.random((P, 2)) * 1e4).astype(np.float32).view(np.int32)
    a = [_t(c, dev), _t(s, dev)]
    b = [t.clone() for t in a]
    lk.scatter_pair_lanes(*a, _t(buf, dev))
    lk.scatter_pair_lanes_plain(*b, _t(buf, dev))
    assert _same_bits(a[0], b[0]) and _same_bits(a[1], b[1])


def test_ring_columns_lanes(dev):
    rng = np.random.default_rng(4)
    _, s, mx, mn = _lane_state(rng, 4097, 16, 30, 40, 2, 1, 3)
    keep = rng.random(32) < 0.5
    src_col = rng.integers(0, 16, 32).astype(np.int32)
    for lane, fill in ((s, 0.0), (mx, -np.inf), (mn, np.inf)):
        src = _t(lane, dev)
        a = torch.empty((4097, 32, lane.shape[2]), device=dev)
        b = torch.empty_like(a)
        wk.ring_columns(src, a, _t(src_col, dev), _t(keep, dev), fill)
        wk.ring_columns_plain(src, b, _t(src_col, dev), _t(keep, dev), fill)
        assert _same_bits(a, b)


def test_lane_kernels_report_out_of_range_entries(dev):
    from flink_tpu_torch.kernels import lane_kernels as lk

    c = torch.zeros((3, 4), dtype=torch.int32, device=dev)
    s = torch.zeros((3, 4, 1), device=dev)
    try:
        lk.scatter_lanes(c, s, None, None,
                         torch.tensor([0, 12], dtype=torch.int32, device=dev),
                         torch.ones((2, 1), device=dev),
                         torch.zeros((2, 0), device=dev),
                         torch.zeros((2, 0), device=dev))
        with pytest.raises(IndexError, match="scatter_lanes"):
            wk.check_errors(dev)
        assert int(c.sum()) == 1
        lk.scatter_pair_lanes(c, s, torch.tensor(
            [[12, 1, 0], [-1, 5, 0]], dtype=torch.int32, device=dev))
        with pytest.raises(IndexError, match="scatter_pair_lanes"):
            wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()


# -- ring_columns_block and the redesigned scatter_pair_lanes ------------------

def _bits(t):
    """A tensor's 32-bit words on the CPU: bit-exact comparison, NaN
    payloads and signed zeros included."""
    t = t.cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _block_state(rng, rows, ring, widths):
    """A four-lane state block (numpy, PaneState order) with live data,
    NaNs with payloads, -NaN, +/-inf and -0.0 planted in its f32 lanes."""
    counts, sums, maxs, mins = _lane_state(rng, rows, ring, 0, ring - 1,
                                           *widths)
    specials = np.array([0x7FC01234, 0xFFC00001, 0x7F800000, 0xFF800000,
                         0x80000000, 0x7F800001], np.uint32).view(np.float32)
    for lane in (sums, maxs, mins):
        if lane.shape[2]:
            at = rng.integers(0, lane.size, 64)
            lane.reshape(-1)[at] = specials[at % len(specials)]
    return sums, maxs, mins, counts


def _block_case(dev, rows, ring, new_ring, widths, keep_np, src_np):
    """ring_columns_block against ring_columns_plain a lane, on the card:
    in place when new_ring is None (the purge), else into new tensors."""
    rng = np.random.default_rng(rows + ring + sum(widths))
    arrs = _block_state(rng, rows, ring, widths)
    src = tuple(_t(a, dev) if a.ndim == 2 or a.shape[2] else None for a in arrs)
    keep, src_col = _t(keep_np, dev), _t(src_np.astype(np.int32), dev)
    if new_ring is None:
        got = tuple(None if x is None else x.clone() for x in src)
        want = tuple(None if x is None else x.clone() for x in src)
        wk.ring_columns_block(got, got, src_col, keep)
        for w, f in zip(want, wk.LANE_FILLS):
            if w is not None:
                wk.ring_columns_plain(w, w, src_col, keep, f)
    else:
        def new():
            return tuple(None if x is None else torch.full(
                (rows, new_ring) + tuple(x.shape[2:]), 3, dtype=x.dtype,
                device=dev) for x in src)
        got, want = new(), new()
        wk.ring_columns_block(src, got, src_col, keep)
        for x, w, f in zip(src, want, wk.LANE_FILLS):
            if x is not None:
                wk.ring_columns_plain(x, w, src_col, keep, f)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("ring,widths", [
    (32, (1, 1, 1)), (16, (3, 0, 3)), (24, (4, 4, 0)), (32, (0, 0, 0)),
    (7, (2, 5, 1)), (1100, (1, 0, 1))])
def test_ring_columns_block_purge(dev, ring, widths):
    """The purge of every lane in one launch, bit for bit against the plain
    version a lane: a cleared run that wraps past the ring's end (and, at
    ring 1100, one past the kernel's 1024-column chunk)."""
    keep = np.ones(ring, bool)
    keep[np.arange(ring - 3, ring + max(ring // 3, 4)) % ring] = False
    if ring > 1024:
        keep[1000:1060] = False
    wk.reset_launch_counts()
    _block_case(dev, 4097 if ring < 1024 else 129, ring, None, widths, keep,
                np.arange(ring))
    assert wk.LAUNCHES["ring_columns"] == 1


@pytest.mark.parametrize("old,new,widths", [
    (6, 16, (1, 1, 1)), (16, 32, (3, 3, 3)), (32, 64, (4, 0, 0)),
    (24, 40, (1, 2, 0)), (5, 7, (0, 0, 0)), (1000, 2048, (1, 0, 0))])
def test_ring_columns_block_growth(dev, old, new, widths):
    """A growth of every lane into new tensors in one launch, bit for bit:
    each live pane p from column p % old to p % new (the 16-byte store
    path where a row's words allow it, the word path elsewhere)."""
    rows = 2049 if new < 1024 else 65
    lo = 7 * old + 3
    cmap = np.full(new, -1, np.int64)
    ps = np.arange(lo, lo + old - 1)
    cmap[ps % new] = ps % old
    wk.reset_launch_counts()
    _block_case(dev, rows, old, new, widths, cmap >= 0, np.maximum(cmap, 0))
    assert wk.LAUNCHES["ring_columns"] == 1


def test_ring_columns_block_bad_column_sets_the_error_word(dev):
    """A kept src_col outside the source: that column takes each lane's
    fill, the others move, and the error word raises once."""
    wk.check_errors(dev)
    rng = np.random.default_rng(11)
    arrs = _block_state(rng, 33, 8, (1, 1, 1))
    src = tuple(_t(a, dev) for a in arrs)
    dst = tuple(torch.empty_like(x) for x in src)
    src_col = torch.arange(8, dtype=torch.int32, device=dev)
    src_col[5] = 8
    try:
        wk.ring_columns_block(src, dst, src_col,
                              torch.ones(8, dtype=torch.bool, device=dev))
        torch.cuda.synchronize()
        for x, d, f in zip(src, dst, wk.LANE_FILLS):
            assert bool((d[:, 5] == f).all())
            assert torch.equal(_bits(d[:, :5]), _bits(x[:, :5]))
        with pytest.raises(IndexError, match="ring_columns"):
            wk.check_errors(dev)
        wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()


def test_lean_wrappers_launch_on_the_current_stream(dev):
    """Captured into a CUDA graph under torch.cuda.graph's own stream (a
    launch on any other stream would break the capture), then replayed:
    ring_columns_block and scatter_pair_lanes give the plain versions'
    bits; and under a non-default torch.cuda.stream the launch queues on
    that stream."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    rng = np.random.default_rng(12)
    arrs = _block_state(rng, 1025, 16, (1, 1, 1))
    lanes = tuple(_t(a, dev) for a in arrs)
    want = tuple(x.clone() for x in lanes)
    keep = _t(rng.random(16) < 0.5, dev)
    ident = torch.arange(16, dtype=torch.int32, device=dev)
    c, s = _t(arrs[3], dev), _t(arrs[0], dev)
    c2, s2 = c.clone(), s.clone()
    pairs = rng.choice(1024 * 16, 3000, replace=False).astype(np.int32)
    buf = np.zeros((3000, 3), np.int32)
    buf[:, 0], buf[:, 1] = pairs, rng.integers(1, 9, 3000)
    buf[:, 2] = (rng.random(3000) * 100).astype(np.float32).view(np.int32)
    buf = _t(buf, dev)
    # warm-up outside the capture: builds, loads, makes the error word
    wk.ring_columns_block(tuple(x.clone() for x in lanes),
                          tuple(x.clone() for x in lanes), ident, keep)
    lk.scatter_pair_lanes(c.clone(), s.clone(), buf)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        wk.ring_columns_block(lanes, lanes, ident, keep)
        lk.scatter_pair_lanes(c, s, buf)
    graph.replay()
    for w, f in zip(want, wk.LANE_FILLS):
        wk.ring_columns_plain(w, w, ident, keep, f)
    lk.scatter_pair_lanes_plain(c2, s2, buf)
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(x), _bits(w)) for x, w in zip(lanes, want))
    assert torch.equal(c, c2) and torch.equal(_bits(s), _bits(s2))
    # under torch.cuda.stream: the launch waits behind a sleep on that
    # stream, so the default stream still reads the old counts. Every
    # kernel of the check runs once before it: the first launch of a
    # kernel loads it, and that waits for the whole card.
    x = _t(arrs[3], dev)
    drop = ~keep
    torch.cuda._sleep(1000)
    x.clone()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        wk.ring_columns_block((None, None, None, x), (None, None, None, x),
                              ident, drop)
    early = x.clone()            # on the default stream: runs at once
    torch.cuda.synchronize()
    assert torch.equal(early.cpu(), torch.from_numpy(arrs[3]))
    cleared = keep.nonzero().view(-1)
    assert int(x[:, cleared].abs().sum()) == 0
    assert int(x.sum()) == int(arrs[3].sum() - arrs[3][:, cleared.cpu().numpy()].sum())


@pytest.mark.parametrize("sw,order", [(0, "first_seen"), (1, "first_seen"),
                                      (1, "ascending"), (2, "first_seen"),
                                      (4, "ascending"), (70, "first_seen")])
def test_scatter_pair_lanes_widths_and_orders(dev, sw, order):
    """Each compile-time width (0, 1, 4), the run-time path (2, and 70: a
    row too wide to stage), on both row orders, with padding rows and a
    partial last warp block: counts and sums bit for bit."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    rng = np.random.default_rng(sw)
    rows, ring, P = 4097, 32, 20_011
    c, s, _, _ = _lane_state(rng, rows, ring, 0, 31, sw, 0, 0)
    pairs = rng.choice((rows - 1) * ring, P, replace=False).astype(np.int32)
    if order == "ascending":
        pairs.sort()
    buf = np.zeros((P + 37, 2 + sw), np.int32)
    buf[:, 0] = -1
    buf[:P, 0] = pairs
    buf[:P, 1] = rng.integers(1, 50, P)
    buf[:P, 2:] = (rng.random((P, sw)) * 1e4).astype(np.float32).view(np.int32)
    a = [_t(c, dev), _t(s, dev) if sw else None]
    b = [x.clone() if x is not None else None for x in a]
    lk.scatter_pair_lanes(*a, _t(buf, dev))
    lk.scatter_pair_lanes_plain(*b, _t(buf, dev))
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
    assert sw == 0 or torch.equal(_bits(a[1]), _bits(b[1]))


def test_scatter_pair_lanes_edges(dev):
    """P = 0 launches nothing and changes nothing; rows at an offset that
    is not 16-byte aligned take the word copy; a pair outside the state
    sets the error word while the other rows fold."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    c = torch.zeros((65, 16), dtype=torch.int32, device=dev)
    s = torch.zeros((65, 16, 1), device=dev)
    wk.reset_launch_counts()
    lk.scatter_pair_lanes(c, s, torch.zeros((0, 3), dtype=torch.int32,
                                            device=dev))
    assert wk.LAUNCHES["scatter_pair_lanes"] == 0 and int(c.abs().sum()) == 0
    rows = np.zeros((301, 3), np.int32)
    rows[:, 0] = np.arange(301) * 3
    rows[:, 1] = 2
    rows[:, 2] = np.float32(1.5).view(np.int32)
    big = _t(np.concatenate([np.zeros((1, 3), np.int32), rows]), dev)
    lk.scatter_pair_lanes(c, s, big[1:])          # 12 bytes past the start
    torch.cuda.synchronize()
    assert int(c.sum()) == 602 and float(s.sum()) == 451.5
    try:
        wk.check_errors(dev)
        bad = _t(np.array([[4, 1, 0], [65 * 16, 7, 0], [-1, 9, 0], [5, 1, 0]],
                          np.int32), dev)
        lk.scatter_pair_lanes(c, s, bad)
        torch.cuda.synchronize()
        assert int(c.sum()) == 604
        with pytest.raises(IndexError, match="scatter_pair_lanes"):
            wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()


@pytest.mark.parametrize("agg_name", ["count", "lanes", "avg"])
def test_window_aggregates_on_the_card_match_the_cpu(dev, agg_name):
    """Packed fires through the operator on the card and on the CPU: rows
    in the same order, integers and max/min equal, sums within 2 * count
    roundings (both add in the same order, so they are usually equal)."""
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.ops.window import WindowOperator

    agg = {"count": ta.count(),
           "lanes": ta.multi(ta.count(), ta.sum_of("price"),
                             ta.max_of("price"), ta.min_of("price")),
           "avg": ta.multi(ta.count(), ta.avg_of("price"))}[agg_name]
    rng = np.random.default_rng(7)
    ops = [WindowOperator(SlidingEventTimeWindows.of(10_000, 1_000), agg,
                          num_shards=32, slots_per_shard=256,
                          max_out_of_orderness_ms=1_000, device=d)
           for d in ("cpu", dev)]
    wk.reset_launch_counts()
    t = 0
    outs = [[], []]
    for i in range(6):
        n = 40_000 if i % 2 else 3_000
        # few keys: the large batches take the host pre-combine
        keys = rng.zipf(1.5, n) % 300
        ts = t + rng.integers(-900, 6_000, n)
        price = (rng.random(n) * 100).astype(np.float32)
        t += 6_000
        for op, out in zip(ops, outs):
            op.process_batch(keys, ts, {"price": price})
            out.append(dict(op.advance_watermark(int(ts.max()) - 1_001)))
    for op, out in zip(ops, outs):
        out.append(dict(op.advance_watermark(op.final_watermark())))
    for a, b in zip(*outs):
        assert sorted(a) == sorted(b)
        for k in a:
            if k.startswith(("sum", "avg")):
                bound = (2 * a["count"] + 4) * 2.0 ** -24 * np.abs(a[k])
                assert (np.abs(a[k] - b[k]) <= bound).all()
            else:
                np.testing.assert_array_equal(a[k], b[k])
    assert wk.LAUNCHES["fire_pack"] > 0
    if agg_name == "lanes":
        assert wk.LAUNCHES["scatter_lanes"] > 0
    if agg_name == "avg":
        assert wk.LAUNCHES["scatter_pair_lanes"] > 0


# -- the native lane (apply_pairs_u32, apply_pairs_u16, fused_step) ----------

def _pair_words(rng, slots, ring, n, cap, extra=()):
    pairs = np.unique(rng.integers(0, slots * ring, n))
    cnts = rng.integers(1, 0xFFF, len(pairs))
    words = np.concatenate([((pairs << 12) | cnts), [(p << 12) | 3 for p in extra]])
    buf = np.full(cap, -1, np.int32)
    buf[:len(words)] = rng.permutation(words.astype(np.uint32).view(np.int32))
    return buf


@pytest.mark.parametrize("ring", [16, 32, 64])
def test_apply_pairs_u32(dev, ring):
    from flink_tpu_torch.kernels import fused_kernels as fk

    rng = np.random.default_rng(ring)
    slots = (1 << 20) // ring              # a pair domain of 2^20
    counts = _t(rng.integers(0, 9, (slots + 1, ring)).astype(np.int32), dev)
    buf = _t(_pair_words(rng, slots, ring, 120_000, 1 << 17,
                         extra=[slots * ring, (slots + 1) * ring + 5]), dev)
    a, b = counts.clone(), counts.clone()
    fk.apply_pairs_u32(a, buf, slots)
    fk.apply_pairs_u32_plain(b, buf, slots)
    assert torch.equal(a, b) and not torch.equal(a, counts)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 1025, 120_001])
def test_apply_pairs_u32_lengths_and_alignment(dev, n, offset):
    """Four words a thread by 16-byte loads, the scalar head up to the
    first 16-byte boundary and the ragged tail: n words at a view
    ``offset`` words into its storage (one word off the boundary), with
    repeated pairs, padding words and pairs at and past the limit among
    them; bit for bit against the plain version."""
    from flink_tpu_torch.kernels import fused_kernels as fk

    rng = np.random.default_rng(n * 2 + offset)
    slots, ring = 4096, 32
    counts = _t(rng.integers(0, 9, (slots + 1, ring)).astype(np.int32), dev)
    pairs = rng.integers(0, slots * ring, max(n, 1))
    pairs[: n // 4] = pairs[n // 4: 2 * (n // 4)]      # repeated pairs
    words = ((pairs << 12) | rng.integers(1, 0xFFF, len(pairs))).astype(
        np.uint32).view(np.int32)[:n].copy()
    if n >= 4:
        words[1] = -1                                     # padding
        words[2] = np.array([(slots * ring) << 12 | 5], np.uint32).view(np.int32)[0]
        words[3] = np.array([((slots + 1) * ring + 3) << 12 | 7],
                            np.uint32).view(np.int32)[0]
    held = torch.full((n + offset + 8,), 123, dtype=torch.int32, device=dev)
    view = held[offset:offset + n]
    view.copy_(_t(words, dev))
    if n:  # an empty view has no address
        assert (view.data_ptr() % 16 == 4) == (offset == 1)
    a, b = counts.clone(), counts.clone()
    fk.apply_pairs_u32(a, view, slots)
    fk.apply_pairs_u32_plain(b, view, slots)
    assert torch.equal(a, b)
    assert torch.equal(a, counts) == (n == 0)


def test_fused_step_header_form_with_no_pairs(dev, monkeypatch):
    """A fused step with a header and no pair words: the apply's header
    block still decodes the header into the parameter block (the
    scalars, end panes, valid flags, keep mask, identity columns and the
    gate words, as the plain decode reads them), and the step equals the
    plain version."""
    from flink_tpu_torch.kernels import fused_kernels as fk

    held = []
    orig = wk.scratch

    def spy(device, words):
        t, ptr = orig(device, words)
        held.append(t)
        return t, ptr
    monkeypatch.setattr(wk, "scratch", spy)
    rng = np.random.default_rng(31)
    slots, ring, ppw, pane_lo, pane_hi, anchor = 2048, 48, 10, 1000, 1030, 997
    counts = _t(_live_counts(rng, slots + 1, ring, pane_lo, pane_hi), dev)
    hdr = np.zeros(fk.FUSED_HDR, np.int32)
    hdr[:6] = np.array([pane_lo, pane_hi, anchor], np.int64).view(np.int32)
    clear = np.array([(1 << 3) | (1 << 31) | (1 << 40)], np.uint64).view(np.int32)
    hdr[7], hdr[6] = clear
    deltas = np.full(fk.MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
    deltas[[0, 2, 5]] = [12, 20, 31]
    hdr[8:8 + fk.MIN_FIRE_PAD] = deltas.astype(np.int32)
    buf = _t(hdr, dev)
    used = _t(rng.random(slots + 1) < 0.5, dev)
    fire_pad = 8
    kw = dict(ppw=ppw, n=1, sel_cap=256, dump_row=slots, fire_gate=True,
              fire_pad=fire_pad)
    rings = [torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
             for _ in range(2)]
    states = [counts.clone(), counts.clone()]
    fk.fused_step(states[0], rings[0], buf, used, **kw)
    torch.cuda.synchronize()
    params = held[-1][:fk._params_words].cpu().numpy().view(np.uint8)
    fk.fused_step_plain(states[1], rings[1], buf, used, **kw)
    assert torch.equal(states[0], states[1])
    assert torch.equal(rings[0][:-1], rings[1][:-1])
    # FusedParams: FireScalars (4 int64), fire, clear (int32), end_panes
    # (64 int64), src_col (64 int32), w_valid, keep (64 bytes each)
    lo, hi, anc, end_panes, w_valid, clr, any_clear = fk.decode_header(
        buf.cpu(), ring, fire_pad)
    scalars = params[:32].view(np.int64)
    assert scalars.tolist() == [lo, hi, anc, lo % ring]
    fire, clear_word = params[32:40].view(np.int32)
    assert fire == int(bool(w_valid.any())) and clear_word == int(any_clear)
    assert params[40:40 + 8 * fire_pad].view(np.int64).tolist() == end_panes.tolist()
    assert params[552:552 + 4 * ring].view(np.int32).tolist() == list(range(ring))
    assert params[808:808 + fire_pad].astype(bool).tolist() == w_valid.tolist()
    assert params[872:872 + ring].astype(bool).tolist() == (~clr).tolist()


def test_apply_pairs_u16(dev):
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.ops.window import preagg_encode_u16

    rng = np.random.default_rng(3)
    slots, ring = 32768, 32
    counts = _t(rng.integers(0, 9, (slots + 1, ring)).astype(np.int32), dev)
    pairs = np.concatenate([np.unique(rng.integers(0, slots * ring, 90_000)),
                            [slots * ring + 2, (slots + 1) * ring + 9]])
    cnts = rng.integers(0, 0x10000, len(pairs))
    cnts[:50] = 0xFFFF
    buf = _t(preagg_encode_u16(pairs, cnts, 1 << 17), dev)
    a, b = counts.clone(), counts.clone()
    fk.apply_pairs_u16(a, buf)
    fk.apply_pairs_u16_plain(b, buf)
    assert torch.equal(a, b)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 7, 31, 32, 33, 257, 11_001, 110_000])
def test_apply_pairs_u16_real_triples_lengths_and_alignment(dev, n, offset):
    """A warp's 32 triples staged by 16-byte loads, the scalar head up to
    the first 16-byte boundary and the ragged tail: n real triples at a
    view ``offset`` triples into its storage (6 bytes off the boundary),
    hot counts up to 0xFFFF, repeated pairs, padding triples and pairs in
    the dump row and past the state among them; bit for bit against the
    plain version."""
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.ops.window import preagg_encode_u16

    rng = np.random.default_rng(n * 2 + offset)
    slots, ring = 32768, 64
    counts = _t(rng.integers(0, 9, (slots + 1, ring)).astype(np.int32), dev)
    pairs = rng.integers(0, slots * ring, max(n, 1))
    pairs[: n // 4] = pairs[n // 4: 2 * (n // 4)]      # repeated pairs
    cnts = rng.integers(0, 0x10000, len(pairs))
    if n >= 4:
        pairs[1] = -1                                    # padding
        pairs[2] = slots * ring + 5                      # the dump row
        pairs[3] = (slots + 1) * ring + 3                # past the state
        cnts[0] = 0xFFFF
    tri = preagg_encode_u16(pairs[:n] & 0xFFFFFFFF, cnts[:n], n)
    held = torch.full((n + offset + 4, 3), 0x1234, dtype=torch.uint16,
                      device=dev)
    view = held[offset:offset + n]
    view.copy_(_t(tri, dev))
    if n:
        assert (view.data_ptr() % 16 == 6) == (offset == 1)
    a, b = counts.clone(), counts.clone()
    fk.apply_pairs_u16(a, view)
    fk.apply_pairs_u16_plain(b, view)
    assert torch.equal(a, b)
    assert torch.equal(a, counts) == (n == 0)


def _hot_wide_upload(rng, shape):
    """The fused step's triple-form upload at the host-fed Q5 shapes: the
    header (11 ends, one purged column) and the real triples of one
    2^20-bid batch's pairs — ``hot``: 1,000 auctions at ring 32, ten of
    them with half the bids (counts past 0xFFF); ``wide``: 10,000
    auctions at ring 64 (a pair domain of 2^21)."""
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.ops.window import preagg_encode_u16

    slots, pane_lo, pane_hi = 32768, 1000, 1020
    ring, n_keys = (32, 1000) if shape == "hot" else (64, 10_000)
    key_rows = rng.choice(slots, n_keys, replace=False)
    panes = np.arange(pane_hi - 10, pane_hi + 1)
    pairs = rng.permutation((key_rows[:, None] * ring
                             + panes[None, :] % ring).reshape(-1))
    cnts = rng.poisson((1 << 20) / len(pairs), len(pairs)) + 1
    if shape == "hot":
        cnts[:110] = rng.integers(0xFFF, 0x10000, 110)
    n = len(pairs)
    hdr = np.zeros(fk.FUSED_HDR, np.int32)
    hdr[:6] = np.array([pane_lo, pane_hi, pane_lo], np.int64).view(np.int32)
    cw = np.array([1 << ((pane_lo - 1) % ring)], np.uint64).view(np.int32)
    hdr[7], hdr[6] = cw[0], cw[1]
    deltas = np.full(fk.MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
    deltas[:11] = np.arange(pane_hi - 9, pane_hi + 2) - pane_lo
    hdr[8:8 + fk.MIN_FIRE_PAD] = deltas.astype(np.int32)
    t = np.full(2 * ((6 * n + 3) // 4), 0xFFFF, np.uint16)
    t[:3 * n] = preagg_encode_u16(pairs, cnts, n).reshape(-1)
    counts = _live_counts(rng, slots + 1, ring, pane_lo, pane_hi)
    return counts, np.concatenate([hdr, t.view(np.int32)]), key_rows


@pytest.mark.parametrize("shape", ["hot", "wide"])
@pytest.mark.parametrize("gate", [True, False])
def test_fused_step_triple_form(dev, shape, gate):
    """The fused step on the triple form at the hot-key and wide Q5
    shapes: state, emit ring (last row excepted) and the error word bit
    for bit against the plain version, and the same counts as the
    standalone F3 followed by the step on no pairs."""
    from flink_tpu_torch.kernels import fused_kernels as fk

    rng = np.random.default_rng(17 if shape == "hot" else 18)
    counts_np, buf_np, key_rows = _hot_wide_upload(rng, shape)
    counts, buf = _t(counts_np, dev), _t(buf_np, dev)
    slots = counts.shape[0] - 1
    used = torch.zeros(slots + 1, dtype=torch.bool, device=dev)
    used[_t(key_rows, dev)] = True
    kw = dict(ppw=10, n=1, sel_cap=256, dump_row=slots, fire_gate=gate,
              fire_pad=16 if gate else 64, form=fk.FORM_TRIPLES)
    rings = [torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
             for _ in range(3)]
    states = [counts.clone() for _ in range(3)]
    fk.fused_step(states[0], rings[0], buf, used, **kw)
    fk.fused_step_plain(states[1], rings[1], buf, used, **kw)
    fk.apply_pairs_u16(states[2], fk.pair_triples(buf))
    fk.fused_step(states[2], rings[2], buf[:fk.FUSED_HDR].contiguous(), used,
                  **dict(kw, form=fk.FORM_WORDS))
    assert torch.equal(states[0], states[1])
    assert torch.equal(rings[0][:-1], rings[1][:-1])
    assert torch.equal(states[0], states[2])
    assert torch.equal(rings[0][:-1], rings[2][:-1])
    assert int(rings[0][0, 0]) >= 11
    wk.check_errors(dev)


@pytest.mark.parametrize("ring,n_ends,gate", [
    (16, 1, True), (32, 11, True), (32, 11, False), (32, 0, True),
    (32, 0, False), (64, 64, True), (64, 17, False)])
def test_fused_step(dev, ring, n_ends, gate):
    """The kernel chain against the plain version on one upload: state,
    emit ring (last row excepted) and the error word."""
    from flink_tpu_torch.kernels import fused_kernels as fk

    rng = np.random.default_rng(ring * 100 + n_ends)
    slots, ppw = (1 << 20) // ring, 10     # a pair domain of 2^20
    pane_lo = 500
    pane_hi = pane_lo + min(ring - 2, 40)
    counts = _t(_live_counts(rng, slots + 1, ring, pane_lo, pane_hi), dev)
    hdr = np.zeros(fk.FUSED_HDR, np.int32)
    hdr[:6] = np.array([pane_lo, pane_hi, pane_lo - 3], np.int64).view(np.int32)
    clear = np.array([sum(1 << c for c in (0, 5, 31, 33, 63) if c < ring)],
                     np.uint64).view(np.int32)
    hdr[7], hdr[6] = clear
    ends = np.sort(rng.choice(np.arange(pane_lo - 20, pane_hi + ppw + 20),
                              n_ends, replace=False))
    deltas = np.full(fk.MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
    deltas[:n_ends] = ends - pane_lo
    hdr[8:8 + fk.MIN_FIRE_PAD] = deltas.astype(np.int32)
    words = _pair_words(rng, slots, ring, 110_000, 1 << 17)
    buf = _t(np.concatenate([hdr, words]), dev)
    used = _t(rng.random(slots + 1) < 0.5, dev)
    pad = min(64, 1 << max(n_ends - 1, 0).bit_length()) if gate else 64
    rings = [torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
             for _ in range(2)]
    states = [counts.clone(), counts.clone()]
    kw = dict(ppw=ppw, n=1, sel_cap=256, dump_row=slots, fire_gate=gate,
              fire_pad=max(pad, 1))
    fk.fused_step(states[0], rings[0], buf, used, **kw)
    fk.fused_step_plain(states[1], rings[1], buf, used, **kw)
    assert torch.equal(states[0], states[1])
    assert torch.equal(rings[0][:-1], rings[1][:-1])
    if n_ends == 0:
        assert not rings[0].any()
    wk.check_errors(dev)


@pytest.mark.parametrize("lane", ["native", "numpy"])
def test_host_fed_lanes_on_the_card_match_the_cpu(dev, monkeypatch, lane):
    """Q5-shaped batches (~12 window ends an advance) through the
    operator on the card and on the CPU, on the native lane (fused steps)
    and on the numpy lane (scatter_counts): the same rows in the same
    order and the same state."""
    from flink_tpu_torch import native_codec as nc
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.ops.aggregates import count
    from flink_tpu_torch.ops.window import WindowOperator

    if lane == "numpy":
        monkeypatch.setattr(nc.NativeHashTable, "create",
                            classmethod(lambda cls, capacity_hint=1024: None))
    rng = np.random.default_rng(8)
    ops = [WindowOperator(SlidingEventTimeWindows.of(10_000, 1_000), count(),
                          num_shards=128, slots_per_shard=256,
                          max_out_of_orderness_ms=1_000, top_n=("count", 1),
                          device=d) for d in ("cpu", dev)]
    wk.reset_launch_counts()
    t, outs = 0, [[], []]
    for _ in range(6):
        # 1,000 keys x a 32-column ring: the lane's pair bound (2^15)
        # stays decisively below the batch, and no pair reaches 0xFFF
        keys = rng.integers(0, 1_000, 200_000)
        ts = t + rng.integers(-900, 12_000, 200_000)
        t += 12_000
        for op, out in zip(ops, outs):
            op.process_batch(keys, ts, {})
            f = dict(op.advance_watermark(int(ts.max()) - 1_001))
            out.append([tuple(np.asarray(f[k]).tolist())
                        for k in ("key", "window_end", "count")])
    for op, out in zip(ops, outs):
        op.quiesce()
        f = dict(op.advance_watermark(op.final_watermark()))
        out.append([tuple(np.asarray(f[k]).tolist())
                    for k in ("key", "window_end", "count")])
    assert outs[0] == outs[1]
    assert torch.equal(ops[0].state.counts, ops[1].state.counts.cpu())
    if lane == "native":
        assert wk.LAUNCHES["fused_step"] >= 4
    else:
        assert wk.LAUNCHES["fused_step"] == 0 and wk.LAUNCHES["scatter_counts"] > 0


# -- count windows (count_fire) and the split upload (split_cells) -----------

@pytest.mark.parametrize("purge,widths", [
    (True, (0, 0, 0)), (True, (1, 0, 0)), (False, (1, 1, 1)),
    (True, (2, 1, 2))])
def test_count_fire(dev, purge, widths):
    """Kernel against the plain version on the card at WindowWordCount's
    65,537 rows: the packed rows and head, and the state after the
    resets, bit for bit."""
    from flink_tpu_torch.kernels import count_window_kernels as cwk

    rng = np.random.default_rng(sum(widths) + purge)
    rows, size = 65_537, 250
    counts = rng.integers(0, 400, rows).astype(np.int32)
    counts[-1] = 10_000                        # the dump row never fires
    base = None if purge else (counts - rng.integers(0, 300, rows)).astype(
        np.int32)
    lanes = [rng.standard_normal((rows, w)).astype(np.float32) if w else None
             for w in widths]
    if widths[1]:
        lanes[1][:5, 0] = [np.nan, -0.0, 0.0, np.inf, -np.inf]
    runs = []
    for fn in (cwk.count_fire, cwk.count_fire_plain):
        st = [_t(counts, dev), None if base is None else _t(base, dev)] + [
            None if x is None else _t(x, dev) for x in lanes]
        buf = fn(*st, size, 1 << 16)
        runs.append((buf, st))
    (a, sa), (b, sb) = runs
    n = int(b[0, 0])
    assert n > 1000 and int(a[0, 0]) == n
    assert _same_bits(a[:n + 1], b[:n + 1])
    for x, y in zip(sa, sb):
        assert (x is None) == (y is None)
        if x is not None:
            assert _same_bits(x, y)


def test_count_fire_overflow_sets_the_error_word(dev):
    """3,000 rows, every one but the dump row due: a cap of 2,999 is met
    exactly (no error), a cap of 1,024 is exceeded: the head counts them
    all, the first 1,024 rows are packed and reset as the plain
    version's, the rest are neither written nor reset, and the error word
    reports it."""
    from flink_tpu_torch.kernels import count_window_kernels as cwk

    wk.check_errors(dev)
    base = torch.full((3000,), 9, dtype=torch.int32, device=dev)
    met = _count_fire_both(dev, base, None, [None] * 3, 3, 2999)
    assert met == 2999
    wk.check_errors(dev)
    counts = base.clone()
    try:
        buf = cwk.count_fire(counts, None, None, None, None, 3, 1024)
        want = cwk.count_fire_plain(base.clone(), None, None, None, None, 3,
                                    2999)
        assert int(buf[0, 0]) == 2999
        assert torch.equal(buf[1:], want[1:1025])
        assert int(counts[:1024].abs().sum()) == 0
        assert bool((counts[1024:] == 9).all())
        with pytest.raises(IndexError, match="count_fire"):
            wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()


def _count_fire_both(dev, counts, base, lanes, size, cap):
    """``count_fire`` and its plain version on copies of one state: the
    packed rows, the head and the state after the resets bit for bit;
    returns the rows fired."""
    from flink_tpu_torch.kernels import count_window_kernels as cwk

    runs = []
    for fn in (cwk.count_fire, cwk.count_fire_plain):
        st = [x if x is None else x.clone() for x in [counts, base, *lanes]]
        runs.append((fn(*st, size, cap), st))
    torch.cuda.synchronize()
    (a, sa), (b, sb) = runs
    n = int(b[0, 0])
    assert int(a[0, 0]) == n
    assert _same_bits(a[:n + 1], b[:n + 1])
    for x, y in zip(sa, sb):
        assert (x is None) == (y is None)
        if x is not None:
            assert _same_bits(x, y)
    return n


@pytest.mark.parametrize("purge", [True, False])
@pytest.mark.parametrize("case", ["none", "all", "first_tile", "last_tile",
                                  "ragged_tile", "dump_only", "cap_met"])
def test_count_fire_tiles_and_edges(dev, purge, case):
    """Where rows fire against the kernel's tiles of ``FIRE_TILE`` rows:
    none, all, only in the first, the last full or the ragged last tile,
    only the dump row (which never fires), and exactly the cap's worth;
    purging or not, with a sum, a max and a min lane (NaN, signed zeros,
    infinities in them): bit for bit against the plain version."""
    from flink_tpu_torch.kernels import count_window_kernels as cwk

    tile = cwk.FIRE_TILE
    rng = np.random.default_rng(len(case) + 7 * purge)
    rows, size = 3 * tile + 517, 50
    since = rng.integers(0, size, rows).astype(np.int32)
    due = {"none": [], "all": np.arange(rows),
           "first_tile": rng.choice(tile, 40, replace=False),
           "last_tile": 2 * tile + rng.choice(tile, 40, replace=False),
           "ragged_tile": 3 * tile + np.r_[0, rng.choice(516, 30), 516],
           "dump_only": [rows - 1],
           "cap_met": rng.choice(rows - 1, 300, replace=False)}[case]
    since[np.asarray(due, np.int64)] = size + rng.integers(0, 9, len(due))
    base = None if purge else rng.integers(-5, 5000, rows).astype(np.int32)
    counts = since if purge else (base + since).astype(np.int32)
    lanes = [rng.standard_normal((rows, w)).astype(np.float32) for w in (1, 2, 1)]
    lanes[1][:8, 0] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-45, -1e38, 3]
    cap = 300 if case == "cap_met" else rows
    n = _count_fire_both(dev, _t(counts, dev), None if base is None
                         else _t(base, dev), [_t(x, dev) for x in lanes],
                         size, cap)
    want = len(set(np.asarray(due, np.int64).tolist()) - {rows - 1})
    assert n == want
    wk.check_errors(dev)


def test_count_fire_past_2_16_tiles(dev):
    """More than 2^16 tiles of ``FIRE_TILE`` rows (33,555,969 rows at
    512): rows fire in a scattered pattern through every tile range and
    in the last tile."""
    from flink_tpu_torch.kernels import count_window_kernels as cwk

    rows = (1 << 16) * cwk.FIRE_TILE + 3 * cwk.FIRE_TILE + 1
    counts = torch.zeros(rows, dtype=torch.int32, device=dev)
    counts[::4099] = 7
    counts[-300:] = 9
    want = int((counts[:-1] >= 5).sum())
    sums = torch.arange(rows, dtype=torch.float32, device=dev)[:, None]
    n = _count_fire_both(dev, counts, None, [sums, None, None], 5, 1 << 16)
    assert n == want > rows // 4099


@pytest.mark.parametrize("ring", [1, 32, 256])
def test_split_cells(dev, ring):
    from flink_tpu_torch.ops.window import split_encode

    rng = np.random.default_rng(ring)
    n, dump_row = (1 << 20) + 3, 32_768
    sc = split_encode(rng.integers(0, dump_row, n),
                      rng.integers(0, ring, n).astype(np.uint8),
                      rng.random(n) < 0.95)
    got = wk.split_cells(_t(sc, dev), ring, dump_row)
    want = wk.split_cells_plain(_t(sc, dev), ring, dump_row)
    assert torch.equal(got, want)
    bad = sc[:4].copy()
    # a slot past the dump row
    bad[1, :2] = np.array([dump_row + 1], np.uint16).view(np.uint8)
    try:
        out = wk.split_cells(_t(bad, dev), ring, dump_row)
        assert int(out[1]) == -1
        with pytest.raises(IndexError, match="split_cells"):
            wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()


def _split_records(rng, n, ring, rows, dump_row):
    from flink_tpu_torch.ops.window import split_encode

    slots = np.where(rng.random(n) < 0.2, rng.integers(0, 3, n),
                     rng.integers(0, rows, n))
    slots[1] = dump_row
    valid = rng.random(n) > 0.05
    valid[2] = False
    return split_encode(slots, rng.integers(0, ring, n).astype(np.uint8),
                        valid)


@pytest.mark.parametrize("ring", [1, 32, 256])
def test_split_scatter_lanes_matches_its_plain_version(dev, ring):
    """scatter_lanes' split form (the 3 bytes decoded in its own
    launches) against its plain version on the CPU, bit for bit (slot
    0xFFFF and the dump row's own slot fold into the dump row), and
    against the kernel on split_cells' cells; a slot past the dump row or
    a column past the ring sets split_cells' bit and the rest folds."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    rng = np.random.default_rng(ring + 1)
    rows, B = 4097, 300_000
    dump_row = rows - 1
    state = _lane_state(rng, rows, ring, 0, ring - 1, 1, 1, 1)
    sc = _split_records(rng, B, ring, rows, dump_row)
    v = (rng.random(B) * 1e3).astype(np.float32)
    v[:4] = [np.nan, -0.0, 0.0, np.inf]
    x, xc = _t(v[:, None], dev), torch.from_numpy(v[:, None].copy())
    wk.reset_launch_counts()
    got = [_t(a, dev) for a in state]
    lk.scatter_lanes(*got, _t(sc, dev), x, x, x, dump_row=dump_row)
    assert wk.LAUNCHES["scatter_lanes"] == 1 and wk.LAUNCHES["split_cells"] == 0
    flat = [_t(a, dev) for a in state]
    lk.scatter_lanes(*flat, wk.split_cells(_t(sc, dev), ring, dump_row), x, x, x)
    cpu = [torch.from_numpy(a.copy()) for a in state]
    lk.scatter_lanes(*cpu, torch.from_numpy(sc), xc, xc, xc, dump_row=dump_row)
    torch.cuda.synchronize()
    wk.check_errors(dev)
    for a, b, c in zip(got, flat, cpu):
        assert _same_bits(a, b) and _same_bits(a, c)
    bad = sc.copy()
    bad[5, :2] = np.array([dump_row + 1], np.uint16).view(np.uint8)
    if ring < 256:
        bad[9, 2] = ring
    ok = np.ones(B, bool)
    ok[[5, 9] if ring < 256 else [5]] = False
    got = [_t(a, dev) for a in state]
    try:
        lk.scatter_lanes(*got, _t(bad, dev), x, x, x, dump_row=dump_row)
        with pytest.raises(IndexError, match="split_cells"):
            wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()
    cpu = [torch.from_numpy(a.copy()) for a in state]
    lk.scatter_lanes(*cpu, torch.from_numpy(sc[ok]),
                     *[torch.from_numpy(v[ok, None].copy())] * 3,
                     dump_row=dump_row)
    for a, c in zip(got, cpu):
        assert _same_bits(a, c)


@pytest.mark.parametrize("C", [0, 3])
def test_bucket_records_split_form_matches_its_plain_version(dev, C):
    """bucket_records' split form (and bucket_records_into's) against its
    plain version, bit for bit: slot 0xFFFF and slot n_dest * spd go
    nowhere, int32 cells out, overflow at a small capacity; a slot past
    that row sets split_cells' bit in the device's error word and the
    record goes nowhere."""
    from flink_tpu_torch.kernels import exchange_kernels as xk

    rng = np.random.default_rng(40 + C)
    n_dest, spd, ring, B = 4, 8192, 32, (1 << 18) + 5
    sc = _split_records(rng, B, ring, n_dest * spd + 1, n_dest * spd)
    payload = _t(rng.random((B, C)).astype(np.float32), dev) if C else None
    for cap in (B, 4096):
        args = (_t(sc, dev), payload, n_dest, cap, spd, ring)
        got = xk.bucket_records(*args)
        want = xk.bucket_records_plain(*args)
        assert got[0].dtype == torch.int32
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
        assert (int(got[3].sum()) > 0) == (cap == 4096)
    n_src = 2
    recv = tuple(None if t is None else torch.full(
        (n_dest, n_src) + t.shape[1:], 5, dtype=t.dtype, device=dev)
        for t in got[:3])
    plain = tuple(None if t is None else t.clone() for t in recv)
    over = xk.bucket_records_into(*args, recv, 1)
    over_p = xk.bucket_records_into_plain(*args, plain, 1)
    assert torch.equal(over, over_p)
    for a, b in zip(recv, plain):
        assert (a is None and b is None) or torch.equal(a, b)
    bad = sc.copy()
    bad[7, :2] = np.array([n_dest * spd + 1], np.uint16).view(np.uint8)
    ok = np.ones(B, bool)
    ok[7] = False
    try:
        got = xk.bucket_records(_t(bad, dev), payload, n_dest, B, spd, ring)
        with pytest.raises(IndexError, match="split_cells"):
            wk.check_errors(dev)
    finally:
        wk.error_word(dev).zero_()
    flat = wk.split_cells_plain(torch.from_numpy(sc), ring, n_dest * spd)
    flat[7] = -1
    want = xk.bucket_records_plain(_t(flat.numpy(), dev), payload, n_dest, B,
                                   spd, ring)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("agg_name,purge", [("count", True), ("lanes", True),
                                            ("lanes", False)])
def test_count_window_on_the_card_matches_the_cpu(dev, agg_name, purge):
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.ops.count_window import CountWindowOperator

    agg = {"count": ta.count(),
           "lanes": ta.multi(ta.count(), ta.sum_of("price"),
                             ta.max_of("price"), ta.min_of("price"),
                             ta.avg_of("price"))}[agg_name]
    rng = np.random.default_rng(11)
    ops = [CountWindowOperator(agg, 50, purge=purge, num_shards=32,
                               slots_per_shard=256, device=d)
           for d in ("cpu", dev)]
    wk.reset_launch_counts()
    outs = [[], []]
    for i in range(5):
        n = 50_000
        keys = rng.zipf(1.4, n) % 5_000
        price = (rng.random(n) * 100).astype(np.float32)
        valid = rng.random(n) < 0.97
        for op, out in zip(ops, outs):
            op.process_batch(keys, np.zeros(n, np.int64), {"price": price},
                             valid)
            out.append(dict(op.take_fired()))
    for a, b in zip(*outs):
        assert list(a) == list(b) and len(a["key"]) > 0
        for k in a:
            x, y = a[k], b[k]
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            np.testing.assert_array_equal(x, y, err_msg=k)
    assert wk.LAUNCHES["count_fire"] == 5
    key = "scatter_lanes" if agg_name == "lanes" else "scatter_counts"
    assert wk.LAUNCHES[key] == 5


def test_split_upload_on_the_card_matches_the_cpu(dev):
    """Per-record lanes into 32,769 x 32 state: the card takes the split
    upload (decoded inside scatter_lanes, no split_cells launch), and its
    rows equal the CPU's."""
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.ops.window import WindowOperator

    agg = ta.multi(ta.count(), ta.max_of("price"), ta.min_of("price"))
    ops = [WindowOperator(SlidingEventTimeWindows.of(10_000, 1_000), agg,
                          num_shards=128, slots_per_shard=256,
                          max_out_of_orderness_ms=17_000, device=d)
           for d in ("cpu", dev)]
    assert all(op._split_upload for op in ops)
    rng = np.random.default_rng(12)
    wk.reset_launch_counts()
    outs = [[], []]
    for i in range(4):
        n = 100_000
        keys = rng.integers(0, 20_000, n)
        ts = 50_000 + i * 1_000 + rng.integers(0, 3_000, n)
        price = (rng.random(n) * 100).astype(np.float32)
        for op, out in zip(ops, outs):
            op.process_batch(keys, ts, {"price": price})
            out.append(dict(op.advance_watermark(int(ts.max()) - 1_000)))
    for op, out in zip(ops, outs):
        out.append(dict(op.advance_watermark(op.final_watermark())))
    for a, b in zip(*outs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert wk.LAUNCHES["split_cells"] == 0
    assert wk.LAUNCHES["scatter_lanes"] == 4


# -- top-n over lanes (window_lanes, topn_select_lanes) -------------------------

@pytest.mark.parametrize("sw,mw,nw,W", [(1, 1, 0, 16), (2, 1, 1, 5),
                                        (0, 0, 1, 1), (4, 0, 0, 64)])
def test_window_lanes(dev, sw, mw, nw, W):
    """Kernel against the plain version on the card, every cell bit for
    bit (both add the sums in column order): NaN and ±0 in the max/min
    lanes, windows past the live range, one invalid window."""
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk

    rng = np.random.default_rng(sw * 7 + W)
    rows, ring, lo, hi, ppw = 32769, 32, 1000, 1020, 10
    _, s, mx, mn = _lane_state(rng, rows, ring, lo, hi, sw, mw, nw)
    if mw:
        mx[5, lo % ring] = np.nan
        mx[6, :] = -0.0
        mx[6, (lo + 1) % ring] = 0.0
    if nw:
        mn[7, hi % ring] = np.nan
    ends = rng.integers(lo - 2, hi + ppw + 2, W).astype(np.int64)
    valid = np.ones(W, bool)
    valid[0] = W == 1
    args = [_t(x, dev) if x.shape[2] else None for x in (s, mx, mn)]
    e, v = _t(ends, dev), _t(valid, dev)
    a = tk.window_lanes(*args, e, v, lo, hi, ppw, rows)
    b = tk.window_lanes_plain(*args, e, v, lo, hi, ppw, rows)
    for x, y in zip(a, b):
        assert x.shape == y.shape and _same_bits(x, y)


def _exact_bits(a, b):
    """Equal bit for bit, NaN payloads and signed zeros included."""
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _window_lanes_case(dev, rng, rows, ring, W, widths):
    """Random lanes in every column (live and dead) with NaN, -NaN, +-inf
    and -0.0 planted in both; windows around the live range, one that
    wraps the ring's end, and invalid ones (not the first)."""
    lo = 1000 if ring <= 32 else 5000
    hi = lo + max(ring - 3, 0) if ring > 1 else lo
    ppw = 10 if ring <= 32 else 600
    specials = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0],
                        np.float32)
    lanes = []
    for k in widths:
        x = rng.standard_normal((rows, ring, k)).astype(np.float32)
        n = max(1, x.size // 50)
        flat = x.reshape(-1)
        if flat.size:
            flat[rng.integers(0, flat.size, n)] = rng.choice(specials, n)
        lanes.append(_t(x, dev) if k else None)
    ends = rng.integers(lo - 2, hi + ppw + 2, W).astype(np.int64)
    ends[0] = lo + ppw + (ring - lo % ring) % ring  # a span over the ring's end
    valid = rng.random(W) < 0.8
    valid[0] = True
    return lanes, _t(ends, dev), _t(valid, dev), lo, hi, ppw


@pytest.mark.parametrize("ring,W,widths,rows", [
    (32, 11, (1, 1, 0), 32769), (32, 1, (3, 0, 1), 1000),
    (32, 64, (0, 3, 3), 777), (1, 11, (1, 1, 1), 501),
    (1100, 64, (70, 70, 70), 37), (1100, 11, (1, 0, 3), 53),
    (32, 11, (70, 1, 0), 300), (1, 1, (0, 0, 70), 99),
    (1100, 1, (70, 70, 70), 29), (32, 11, (0, 0, 0), 100),
    (64, 11, (1, 2, 1), 777), (37, 64, (1, 1, 3), 333)])
def test_window_lanes_bit_for_bit(dev, ring, W, widths, rows):
    """The tiled kernel against the plain version on the card, every
    output bit for bit: rings of 1, 32, 37, 64 and 1100 columns (up to 64
    the register form, 1100 the staged tiles), 1, 11 and 64 windows, lane
    widths 0 / 1 / 3 / 70 in
    each family (70 in each family at W = 1 staging the 1100-column ring in
    chunks), row counts that are no multiple of the tile, NaN, +-inf
    and -0.0 in live and in dead columns (a NaN or inf in a dead column
    poisons the sum), invalid windows and a span that wraps the ring."""
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk

    rng = np.random.default_rng(ring * 131 + W * 7 + sum(widths))
    lanes, e, v, lo, hi, ppw = _window_lanes_case(dev, rng, rows, ring, W,
                                                  widths)
    wk.reset_launch_counts()
    a = tk.window_lanes(*lanes, e, v, lo, hi, ppw, rows)
    b = tk.window_lanes_plain(*lanes, e, v, lo, hi, ppw, rows)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["window_lanes"] == (1 if sum(widths) else 0)
    for x, y, k in zip(a, b, widths):
        assert x.shape == (rows, W, k)
        assert _exact_bits(x, y)


def test_window_lanes_on_a_stream_and_in_a_graph(dev):
    """Captured into a CUDA graph and replayed, window_lanes gives the
    plain version's bits; under a non-default torch.cuda.stream it
    queues on that stream (every kernel of the check warmed first: a
    kernel's first launch loads it and waits for the whole card)."""
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk

    rng = np.random.default_rng(44)
    lanes, e, v, lo, hi, ppw = _window_lanes_case(dev, rng, 4097, 32, 11,
                                                  (1, 2, 1))
    want = tk.window_lanes_plain(*lanes, e, v, lo, hi, ppw, 4097)
    tk.window_lanes(*lanes, e, v, lo, hi, ppw, 4097)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tk.window_lanes(*lanes, e, v, lo, hi, ppw, 4097)
    graph.replay()
    torch.cuda.synchronize()
    assert all(_exact_bits(x, y) for x, y in zip(got, want))
    # the side stream's next allocation of the outputs' size reuses a
    # block filled with -7.0 there
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        junk = torch.full((4097 * 11 * 4,), -7.0, device=dev)
    del junk
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        late = tk.window_lanes(*lanes, e, v, lo, hi, ppw, 4097)
    early = late[0].clone()      # on the default stream: runs at once
    torch.cuda.synchronize()
    assert bool((early == -7.0).all())
    assert all(_exact_bits(x, y) for x, y in zip(late, want))


def _topn_lanes(dev, seed, rows, W, n, sel_cap, F=2, fill=0, specials=True,
                spread=20_000):
    """Both versions on one random ranking grid; ``spread`` sets how
    often values tie (every selection must fit the 2048-row ring)."""
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk

    rng = np.random.default_rng(seed)
    wc = (rng.integers(0, 9, (rows, W))
          * (rng.random((rows, W)) < 0.4)).astype(np.int32)
    v = rng.integers(-spread, spread, (rows, W)).astype(np.float32)
    if specials:
        v[3, 0], v[4, 0] = np.nan, -np.nan        # +NaN on top, -NaN last
        v[5:9, W - 1] = [0.0, -0.0, -np.inf, spread - 1.0]
        wc[3:9] = np.maximum(wc[3:9], 1)
    used = rng.random(rows) < 0.9
    used[-1] = False
    cols = rng.integers(-2 ** 31, 2 ** 31 - 1, (rows, W, F)).astype(np.int32)
    ends = _t(np.arange(100, 100 + W, dtype=np.int64), dev)
    valid = torch.ones(W, dtype=torch.bool, device=dev)
    r1 = torch.zeros((2048 + 2, 3 + F), dtype=torch.int32, device=dev)
    r1[0, 0] = fill
    r2 = r1.clone()
    args = [_t(wc, dev), _t(v, dev), _t(cols, dev), _t(used, dev), ends, valid,
            90, n, sel_cap]
    tk.topn_select_lanes(*args, r1)
    tk.topn_select_lanes_plain(*args, r2)
    assert torch.equal(r1[:-1], r2[:-1])
    return r1


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("W", [1, 16])
def test_topn_select_lanes(dev, n, W):
    """Kernel ring equal to the plain version's: head, rows, order and
    the result columns, with ±NaN, ±0 and -inf in the ranking grid."""
    r = _topn_lanes(dev, n * 13 + W, 32769, W, n, 1 << 12, fill=2040)
    # window 0's top value is +NaN: at n = 1 its threshold is NaN and
    # selects nothing, so a one-window top-1 fire appends no row
    assert (int(r[0, 0]) > 2040) == (W > 1 or n > 1) and int(r[0, 1]) == 0


def test_topn_select_lanes_truncates_past_sel_cap(dev):
    """Ties beyond sel_cap: the first sel_cap rows land, the rest count
    in head[0, 1]."""
    r = _topn_lanes(dev, 3, 4097, 4, 1, 8, specials=False, spread=20)
    assert int(r[0, 0]) == 8 and int(r[0, 1]) > 0


@pytest.mark.parametrize("n,W", [(1, 11), (2, 11), (3, 11), (17, 4),
                                 (256, 4), (1, 100), (3, 100)])
def test_topn_select_lanes_radix_and_max(dev, n, W):
    """The whole-card threshold at n = 1 (one max pass) and above (four
    radix passes), on 11 windows (one block's table, one histogram group)
    and 100 (past both), into a ring that wraps, with +NaN on top, -NaN,
    -inf, +-0 ties in the ranked grid."""
    r = _topn_lanes(dev, 7 * n + W, 4097, W, n, 2048, fill=2040)
    assert int(r[0, 0]) > 2040 and int(r[0, 1]) == 0


def test_topn_select_lanes_n_at_or_past_the_rows(dev):
    """n >= rows: k = rows, so every window's threshold is its smallest
    key (-inf where a row is no candidate): every candidate but a NaN
    selects."""
    r = _topn_lanes(dev, 5, 50, 4, 256, 2048)
    assert int(r[0, 0]) > 0


def _topn_grid(dev, rows, W, v, n, sel_cap=256, valid=None, wc=None):
    """Both versions on a given ranking grid, every row in use; returns
    the kernel's ring."""
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk

    wc = np.ones((rows, W), np.int32) if wc is None else wc
    valid = np.ones(W, bool) if valid is None else valid
    cols = np.arange(rows * W * 2, dtype=np.int32).reshape(rows, W, 2)
    args = [_t(wc, dev), _t(v.astype(np.float32), dev), _t(cols, dev),
            torch.ones(rows, dtype=torch.bool, device=dev),
            _t(np.arange(100, 100 + W, dtype=np.int64), dev), _t(valid, dev),
            90, n, sel_cap]
    r1 = torch.zeros((2048 + 2, 5), dtype=torch.int32, device=dev)
    r2 = r1.clone()
    tk.topn_select_lanes(*args, r1)
    tk.topn_select_lanes_plain(*args, r2)
    assert torch.equal(r1[:-1], r2[:-1])
    return r1


def test_topn_select_lanes_ties_nan_at_the_kth_and_signed_zeros(dev):
    """All cells tied (every one selected); a -NaN at the k-th place
    (k = rows: the NaN threshold selects nothing in that window); a +0.0
    and a -0.0 at the top two places (k = 2: both select, IEEE >=)."""
    rows, W = 64, 3
    v = np.full((rows, W), 3.0, np.float32)
    v[10, 1] = -np.nan
    v[:, 2] = -1.0
    v[0, 2], v[1, 2] = 0.0, -0.0
    r = _topn_grid(dev, rows, W, v, 2)
    assert int(r[0, 0]) == 64 + 63 + 2        # window 1's -NaN row is out
    r = _topn_grid(dev, rows, W, v, rows)
    assert int(r[0, 0]) == 64 + 64            # window 1 selects nothing


def test_topn_select_lanes_invalid_windows_and_sparse_candidates(dev):
    """Invalid windows select nothing; a window with fewer candidates
    than n takes them all (its threshold is -inf)."""
    rng = np.random.default_rng(8)
    rows, W = 2000, 40
    v = rng.standard_normal((rows, W)).astype(np.float32)
    wc = (rng.random((rows, W)) < 0.002).astype(np.int32) * 3
    valid = rng.random(W) < 0.7
    for n in (1, 5):
        _topn_grid(dev, rows, W, v, n, sel_cap=2048, valid=valid, wc=wc)


@pytest.mark.parametrize("by", ["max_price", "avg_price", "count"])
def test_topn_lanes_operator_on_the_card_matches_the_cpu(dev, by):
    """The operator's lane route on the card and on the CPU: rows equal
    in order (the averages within 2 * count roundings), through
    window_lanes and topn_select_lanes; with spill, host rows re-rank
    into the same leaderboards."""
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.ops.window import WindowOperator

    agg = ta.multi(ta.count(), ta.max_of("price"), ta.avg_of("price"))
    rng = np.random.default_rng(21)
    for spill in (False, True):
        ops = [WindowOperator(SlidingEventTimeWindows.of(4_000, 1_000), agg,
                              num_shards=32, slots_per_shard=32 if spill else 256,
                              max_out_of_orderness_ms=1_000, top_n=(by, 2),
                              spill=spill, device=d) for d in ("cpu", dev)]
        wk.reset_launch_counts()
        outs = [[], []]
        for i in range(5):
            n = 20_000
            keys = rng.integers(0, 3_000, n)
            ts = i * 1_000 + rng.integers(0, 1_500, n)
            price = rng.integers(0, 1_000, n).astype(np.float32)
            price[:3] = [np.nan, -0.0, 0.0] if i == 2 else price[:3]
            for op, out in zip(ops, outs):
                op.process_batch(keys, ts, {"price": price})
                out.append(dict(op.advance_watermark(i * 1_000)))
        for op, out in zip(ops, outs):
            out.append(dict(op.advance_watermark(op.final_watermark())))
        for a, b in zip(*outs):
            assert list(a) == list(b)
            for k in a:
                x, y = np.asarray(a[k]), np.asarray(b[k])
                if x.dtype == np.float32:
                    x, y = x.view(np.int32), y.view(np.int32)
                np.testing.assert_array_equal(x, y, err_msg=k)
        assert wk.LAUNCHES["window_lanes"] > 0
        assert wk.LAUNCHES["topn_select_lanes"] == wk.LAUNCHES["window_counts"]
        assert wk.LAUNCHES["topn_select_append"] == 0
        assert (ops[1].records_spilled > 0) == spill


def test_changelog_lanes_on_the_card_match_the_cpu(dev):
    """Signed lanes per record on the card and on the CPU: rows equal
    (integer-valued prices, so the sums are exact)."""
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.ops.window import WindowOperator
    from flink_tpu_torch.records import OP_FIELD

    agg = ta.multi(ta.changelog_count("net"), ta.changelog_sum_of("price"),
                   ta.changelog_avg_of("price"))
    ops = [WindowOperator(TumblingEventTimeWindows.of(1_000), agg,
                          num_shards=32, slots_per_shard=256, device=d)
           for d in ("cpu", dev)]
    rng = np.random.default_rng(23)
    wk.reset_launch_counts()
    outs = [[], []]
    for i in range(3):
        n = 50_000
        keys = rng.integers(0, 5_000, n)
        ts = i * 1_000 + rng.integers(0, 1_000, n)
        data = {"price": rng.integers(0, 100, n).astype(np.float32),
                OP_FIELD: rng.choice(np.array([0, 0, 1, 2, 3], np.int8), n)}
        for op, out in zip(ops, outs):
            op.process_batch(keys, ts, data)
            out.append(dict(op.advance_watermark(i * 1_000 + 999)))
    for a, b in zip(*outs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert wk.LAUNCHES["scatter_lanes"] == 3


def _segment_case(rng, lengths, widths):
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    e = int(offsets[-1])
    lanes = [(rng.random((e, w)) * 900 + 50).astype(np.float32)
             for w in widths]
    return offsets, lanes


def _exact_bits(a, b):
    return a.shape == b.shape and np.array_equal(
        a.cpu().contiguous().view(torch.int32).numpy(),
        b.cpu().contiguous().view(torch.int32).numpy())


@pytest.mark.parametrize("widths", [(1, 1, 0), (0, 0, 0), (2, 1, 3)])
def test_segment_lanes_matches_its_plain_version(dev, widths):
    """Every output bit for bit against the plain version on the card and
    on the CPU (both add in element order), segments of 1 to 5,000."""
    from flink_tpu_torch.kernels import element_kernels as ek

    rng = np.random.default_rng(29)
    lengths = rng.integers(1, 200, 3000)
    lengths[[5, 77]] = [5000, 1]
    offsets, lanes = _segment_case(rng, lengths, widths)
    wk.reset_launch_counts()
    got = ek.segment_lanes(_t(offsets, dev), *[_t(x, dev) for x in lanes])
    plain = ek.segment_lanes_plain(_t(offsets, dev),
                                   *[_t(x, dev) for x in lanes])
    cpu = ek.segment_lanes(torch.from_numpy(offsets),
                           *[torch.from_numpy(x) for x in lanes])
    torch.cuda.synchronize()
    wk.check_errors(dev)
    assert wk.LAUNCHES["segment_lanes"] == 1
    for a, b, c in zip(got, plain, cpu):
        assert _exact_bits(a, b) and _exact_bits(a, c)
    assert got[3].tolist() == lengths.tolist()


def test_segment_lanes_edge_values(dev):
    """Planted NaN of both signs with payloads, infinities and signed
    zeros: the max keeps the last NaN, the min the first, -0 < +0."""
    from flink_tpu_torch.kernels import element_kernels as ek

    nan = lambda bits: np.array([bits], np.uint32).view(np.float32)[0]  # noqa: E731
    segs = [[1.0, nan(0x7FC00005), 2.0, nan(0xFFC00007)],
            [0.0, -0.0, 0.0], [-0.0, -0.0], [np.inf, -np.inf, 3.0],
            [nan(0xFFC0004D)], [5.0]]
    x = np.concatenate([np.asarray(s, np.float32) for s in segs])[:, None]
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in segs])])
    args = [_t(offsets.astype(np.int64), dev)] + [_t(x, dev)] * 3
    got = ek.segment_lanes(*args)
    plain = ek.segment_lanes_plain(*args)
    cpu = ek.segment_lanes(*[a.cpu() for a in args])
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert _exact_bits(a, b)
    # max, min and counts copy bits, so the CPU agrees bit for bit; a sum
    # with a NaN term is NaN everywhere, its bits the adder's (the card's
    # canonical NaN, the CPU's operand)
    for a, b in zip(got[1:], cpu[1:]):
        assert _exact_bits(a, b)
    s_card, s_cpu = got[0].cpu(), cpu[0]
    nan = torch.isnan(s_cpu)
    assert torch.equal(torch.isnan(s_card), nan)
    assert _exact_bits(s_card[~nan], s_cpu[~nan])
    bits = got[1][:, 0].view(torch.int32).cpu().numpy().view(np.uint32)
    assert bits.tolist()[:3] == [0xFFC00007, 0x00000000, 0x80000000]
    bits = got[2][:, 0].view(torch.int32).cpu().numpy().view(np.uint32)
    assert bits.tolist()[:3] == [0x7FC00005, 0x80000000, 0x80000000]
    assert float(got[1][3, 0]) == np.inf and float(got[2][3, 0]) == -np.inf


@pytest.mark.parametrize("group", [8, 32])
def test_segment_lanes_at_job_e_shape(dev, group, monkeypatch):
    """Job E's fire (~10,000 segments of 1 to 100 elements, a sum and a
    max lane) and job E2's (a few hundred prefixes of 1,000 to 6,000), in
    both group forms of the kernel (8 lanes a segment and a warp a
    segment, forced through SEGMENT_WARP_MEAN): every output bit for bit
    against the plain version on the card."""
    from flink_tpu_torch.kernels import element_kernels as ek

    monkeypatch.setattr(ek, "SEGMENT_WARP_MEAN", 1 << 30 if group == 8 else 0)
    rng = np.random.default_rng(60 + group)
    for lengths, widths in ((np.minimum(rng.integers(1, 160, 10_000), 100),
                             (1, 1, 0)),
                            (rng.integers(1, 7, 300) * 1000, (1, 0, 1))):
        offsets, lanes = _segment_case(rng, lengths, widths)
        assert ek.segment_group(len(lengths), int(offsets[-1]),
                                sum(widths)) == group
        args = [_t(offsets, dev)] + [_t(x, dev) for x in lanes]
        got = ek.segment_lanes(*args)
        plain = ek.segment_lanes_plain(*args)
        torch.cuda.synchronize()
        wk.check_errors(dev)
        for a, b in zip(got, plain):
            assert _exact_bits(a, b)


@pytest.mark.parametrize("group", [8, 32])
def test_segment_lanes_several_nans_in_one_segment(dev, group, monkeypatch):
    """Segments holding several NaNs of both signs with payloads, among
    infinities and signed zeros, long enough to span chunks and phases:
    bit for bit against the plain version; the max keeps the segment's
    last NaN, the min its first, and the sum is a NaN."""
    from flink_tpu_torch.kernels import element_kernels as ek

    monkeypatch.setattr(ek, "SEGMENT_WARP_MEAN", 1 << 30 if group == 8 else 0)
    rng = np.random.default_rng(70 + group)
    lengths = np.array([3, 40, 700, 5, 1, 2000, 64])
    e = int(lengths.sum())
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    x = (rng.standard_normal((e, 2)) * 10).astype(np.float32)
    b = x.view(np.uint32)
    plants = {0: [0x7FC00011, 0xFFC00022], 1: [0xFFC00003, 0x7FC00004,
                                                0xFFC00005],
              2: [0x7F800001, 0xFFC00777, 0x7FC00100], 5: [0xFFC00031,
                                                          0x7FC00032]}
    for w, vals in plants.items():
        pos = offsets[w] + np.linspace(1, lengths[w] - 1, len(vals)).astype(int)
        b[pos, :] = np.array(vals, np.uint32)[:, None]
        first, last = vals[0], vals[-1]
        plants[w] = (first, last)
    b[offsets[3]:offsets[4], 0] = 0x80000000
    b[offsets[6]:offsets[6] + 8, 1] = [0x7F800000, 0xFF800000, 0, 0x80000000] * 2
    xt = _t(x, dev)
    args = (_t(offsets, dev), xt, xt, xt)
    got = ek.segment_lanes(*args)
    plain = ek.segment_lanes_plain(*args)
    torch.cuda.synchronize()
    for g, p in zip(got, plain):
        assert _exact_bits(g, p)
    mx = got[1].cpu().view(torch.int32).numpy().view(np.uint32)
    mn = got[2].cpu().view(torch.int32).numpy().view(np.uint32)
    for w, (first, last) in plants.items():
        assert (mx[w] == last).all() and (mn[w] == first).all()
        assert torch.isnan(got[0][w]).all()


def test_segment_lanes_bad_offsets_set_the_error_word(dev):
    from flink_tpu_torch.kernels import element_kernels as ek

    x = torch.ones((4, 1), device=dev)
    wk.check_errors(dev)
    ek.segment_lanes(torch.tensor([0, 5], device=dev), x, x, x)
    with pytest.raises(IndexError, match="segment_lanes"):
        wk.check_errors(dev)


def test_element_window_on_the_card_matches_the_cpu(dev):
    """A count-evictor job's fires on the card and on the CPU: the same
    rows in the same order, every column bit for bit."""
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
    from flink_tpu_torch.api.datastream import _element_window_fn
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.ops.evicting_window import (
        CountEvictor, EvictingWindowOperator)

    agg = ta.multi(ta.count(), ta.avg_of("price"), ta.max_of("price"))
    ops = [EvictingWindowOperator(
        TumblingEventTimeWindows.of(1_000), _element_window_fn(agg),
        evictor=CountEvictor.of(50), device=d) for d in ("cpu", dev)]
    rng = np.random.default_rng(31)
    wk.reset_launch_counts()
    outs = [[], []]
    for i in range(3):
        n = 20_000
        keys = rng.integers(0, 300, n)
        ts = i * 1_000 + rng.integers(0, 1_000, n)
        data = {"price": rng.random(n) * 1000}
        for op, out in zip(ops, outs):
            op.process_batch(keys, ts, data)
            out.append(dict(op.advance_watermark(i * 1_000 + 999)))
    for a, b in zip(*outs):
        assert list(a) == list(b) and len(a["key"]) > 0
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype, k
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            np.testing.assert_array_equal(x, y, err_msg=k)
    assert wk.LAUNCHES["segment_lanes"] == 3


@pytest.mark.parametrize("C,capacity", [(0, 4096), (3, 4096), (2, 300)])
def test_bucket_records_matches_its_plain_version(dev, C, capacity):
    """Every output bit for bit, overflow included (capacity 300)."""
    from flink_tpu_torch.kernels import exchange_kernels as xk

    rng = np.random.default_rng(C + capacity)
    n_dest, spd, ring, B = 5, 700, 16, 4096
    cells = rng.integers(-1, n_dest * spd * ring + 40, B).astype(np.int32)
    payload = (_t(rng.random((B, C)).astype(np.float32), dev) if C else None)
    got = xk.bucket_records(_t(cells, dev), payload, n_dest, capacity, spd,
                            ring)
    want = xk.bucket_records_plain(_t(cells, dev), payload, n_dest, capacity,
                                   spd, ring)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert (int(got[3].sum()) > 0) == (capacity == 300)


@pytest.mark.parametrize("case", ["empty", "all_invalid", "one_dest",
                                  "max_dest", "capacity_1", "ragged",
                                  "many_tiles", "int64"])
def test_bucket_records_edges(dev, case):
    """The one-launch bucketing against its plain version, bit for bit: an
    empty block, every record invalid, one destination, 64 destinations,
    capacity 1, a ragged last tile, more tiles than the card holds blocks
    at once (each block walks several, the look-back across rounds) and
    int64 cells past 2^31; then the same launch into receive rows."""
    from flink_tpu_torch.kernels import exchange_kernels as xk

    rng = np.random.default_rng(len(case))
    n_dest, spd, ring, B, cap, C = 4, 8192, 32, 3 * 1024 + 37, 4096, 2
    dtype = np.int32
    if case == "empty":
        B = 0
    elif case == "one_dest":
        n_dest = 1
    elif case == "max_dest":
        n_dest, spd = xk.MAX_DEST, 512
    elif case == "capacity_1":
        cap = 1
    elif case == "ragged":
        B, cap = 1024 * 7 + 1, 3000
    elif case == "many_tiles":
        B, cap, C = 1 << 22, 1 << 20, 1
    elif case == "int64":
        spd, ring, dtype = 1 << 27, 32, np.int64
    cells = rng.integers(-1, n_dest * spd * ring + 40, B).astype(dtype)
    if case == "all_invalid":
        cells[:] = -1
    payload = _t(rng.random((B, C)).astype(np.float32), dev)
    args = (_t(cells, dev), payload, n_dest, cap, spd, ring)
    got = xk.bucket_records(*args)
    want = xk.bucket_records_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n_src = 3
    recv = (torch.full((n_dest, n_src, cap), 5, dtype=args[0].dtype, device=dev),
            torch.full((n_dest, n_src, cap, C), 5.0, device=dev),
            torch.ones((n_dest, n_src, cap), dtype=torch.bool, device=dev))
    plain = tuple(r.clone() for r in recv)
    over = xk.bucket_records_into(*args, recv, 1)
    over_p = xk.bucket_records_into_plain(*args, plain, 1)
    assert torch.equal(over, over_p) and torch.equal(over, want[3])
    for a, b in zip(recv, plain):
        assert torch.equal(a, b)   # rows 0 and 2 untouched in both


def test_one_card_exchange_launches_no_copy(dev):
    """keyby_exchange over four blocks of one card: one bucket_records
    launch a source block straight into the owners' receive rows and no
    device-to-device copy (profiled); the received blocks equal the CPU's
    exchange."""
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch.exchange import keyby

    rng = np.random.default_rng(4)
    n, spd, ring, L = 4, 8192, 32, 1 << 16
    src = [rng.integers(-1, n * spd * ring, L).astype(np.int32) for _ in range(n)]
    pay = [rng.random((L, 3)).astype(np.float32) for _ in range(n)]
    run = lambda: keyby.keyby_exchange(  # noqa: E731
        [_t(c, dev) for c in src], [_t(p, dev) for p in pay],
        devices=[dev] * n, capacity=L, spd=spd, ring=ring)
    run()
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = run()
        torch.cuda.synchronize()
    assert wk.LAUNCHES["bucket_records"] == n
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [k for k in names if "DtoD" in k], names
    assert sum(e.count for e in prof.key_averages()
               if "bucket_records_kernel" in e.key
               and e.device_type == torch.autograd.DeviceType.CUDA) == n
    want = keyby.keyby_exchange(
        [torch.from_numpy(c) for c in src], [torch.from_numpy(p) for p in pay],
        devices=[torch.device("cpu")] * n, capacity=L, spd=spd, ring=ring)
    assert got[2] == want[2]
    for a, b in zip(got[0] + [tuple(got[1])], want[0] + [tuple(want[1])]):
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("rows,W,k", [
    (8193, 11, 1), (8193, 11, 3),      # M1's fire: one launch each
    (8193, 11, 16),                    # the merge's largest k
    (8193, 11, 8193), (2000, 2, 2000),  # k = rows: the radix, one launch
    (300, 40, 3),                      # the merge past 32 windows
    (300, 40, 17), (100, 300, 5),      # the radix in six launches
    (5, 3, 2), (1, 1, 1)])
def test_topn_candidates_matches_its_plain_version(dev, rows, W, k):
    """Bit for bit against torch.topk on the masked grid, with ties at the
    k-th place, counts past 2^24 (which tie as f32), unused rows, an
    invalid window and a window without candidates, in every launch form
    (``candidates_plan``); twice, so the second call runs on the
    workspace the first left."""
    rng = np.random.default_rng(rows + W + k)
    wc = rng.integers(0, 6, (rows, W)).astype(np.int32)
    wc[: min(rows, 3), 0] = (1 << 24) + 1
    wc[rows // 2, W - 1] = 1 << 24
    used = rng.random(rows) < 0.9
    used[0] = True
    valid = np.ones(W, bool)
    if W > 2:
        valid[1] = False
        wc[:, 2] = 0
    args = (_t(wc, dev), _t(used, dev), _t(valid, dev), k)
    for _ in range(2):
        got = wk.topn_candidates(*args)
        want = wk.topn_candidates_plain(*args)
        assert torch.equal(got, want)
    v = torch.where(args[0] > 0, args[0].float(), torch.tensor(-float("inf"), device=dev))
    v = torch.where(args[1][:, None] & args[2][None, :], v,
                    torch.tensor(-float("inf"), device=dev))
    assert torch.equal(got, torch.topk(v.T, k, dim=1).values)


def _lane_grid(rng, rows, W, specials=True):
    """A lane top-n grid: counts with empty cells, integer ranking values
    with ties, and (``specials``) +NaN, -NaN, -0 / +0, +inf and -inf
    candidates, a window of -NaN candidates and an invalid window."""
    wc = np.where(rng.random((rows, W)) < 0.7,
                  rng.integers(1, 4, (rows, W)), 0).astype(np.int32)
    v = rng.integers(-6, 7, (rows, W)).astype(np.float32)
    used = rng.random(rows) < 0.9
    valid = np.ones(W, bool)
    if specials and rows >= 6 and W >= 4:
        v[0, 0], v[1, 0] = np.nan, -np.nan
        v[2, 1], v[3, 1] = -0.0, 0.0
        v[4, 2], v[5, 2] = np.inf, -np.inf
        v[:, 3] = -np.nan
        wc[:, 3] = 1
        valid[W - 1] = W < 5
    return wc, v, used, valid


@pytest.mark.parametrize("rows,W,k", [
    (8193, 11, 1), (8193, 11, 3), (8193, 11, 16),  # M5's block at top-1 / 3
    (2000, 8, 2000),                               # k = rows: the radix
    (300, 40, 3), (300, 40, 17), (100, 300, 5),    # the merge, the six launches
    (6, 4, 2), (1, 1, 1)])
def test_topn_candidates_lanes_matches_its_plain_version(dev, rows, W, k):
    """Bit for bit against the plain version (torch.topk on the
    total-order keys of the masked grid) in every launch form, with NaN,
    signed zeros and infinities among the candidates; twice, so the
    second call runs on the workspace the first left; then into a
    block's columns of a wider buffer."""
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk
    wc, v, used, valid = _lane_grid(np.random.default_rng(rows + W + k),
                                    rows, W)
    args = (_t(wc, dev), _t(v, dev), _t(used, dev), _t(valid, dev), k)
    want = tk.topn_candidates_lanes_plain(*[a.cpu() if isinstance(
        a, torch.Tensor) else a for a in args])
    for _ in range(2):
        got = tk.topn_candidates_lanes(*args)
        assert _exact_bits(got.cpu(), want)
    out = torch.full((W, 3 * k), 5.0, device=dev)
    tk.topn_candidates_lanes(*args, out=out[:, k:2 * k])
    assert _exact_bits(out[:, k:2 * k].cpu(), want)
    assert (out[:, :k] == 5.0).all() and (out[:, 2 * k:] == 5.0).all()


@pytest.mark.parametrize("rows,W,k,blocks", [
    (8193, 11, 1, 4), (8193, 11, 3, 4),   # M5's chunks: M <= 16 in registers
    (8193, 11, 5, 4),                     # M = 20: a warp a window
    (300, 64, 2, 8), (6, 4, 2, 2), (1, 1, 1, 1)])
def test_topn_select_lanes_given_matches_its_plain_version(dev, rows, W, k,
                                                           blocks):
    """Each block's selection against the gathered candidates of all
    blocks (the plain candidates), appended with its row offset to its
    own ring: ring and head bit for bit against the plain version, NaN
    thresholds, signed zeros and -NaN candidates included; twice."""
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk
    rng = np.random.default_rng(rows * W + k)
    grids = [_lane_grid(rng, rows, W) for _ in range(blocks)]
    cands = torch.cat([tk.topn_candidates_lanes_plain(
        torch.from_numpy(g[0]), torch.from_numpy(g[1]),
        torch.from_numpy(g[2]), torch.from_numpy(g[3]), k) for g in grids],
        dim=1)
    ends = np.arange(40, 40 + W, dtype=np.int64)
    F = 2
    for b, (wc, v, used, valid) in enumerate(grids):
        cols = rng.integers(-9, 9, (rows, W, F)).astype(np.int32)
        ring = np.zeros((4096 + 2, 3 + F), np.int32)
        ring[0, 0] = 4090  # the append wraps past the ring's end
        args = [wc, v, cols, used, ends, valid]
        rest = (37, cands, k, b * rows, 3000)
        want = tk.topn_select_lanes_given_plain(
            *[torch.from_numpy(a) for a in args], *rest,
            torch.from_numpy(ring.copy()))
        got = torch.from_numpy(ring.copy()).to(dev)
        for _ in range(2):
            tk.topn_select_lanes_given(*[_t(a, dev) for a in args], 37,
                                       cands.to(dev), k, b * rows, 3000, got)
            torch.cuda.synchronize()
            want2 = want if _ == 0 else tk.topn_select_lanes_given_plain(
                *[torch.from_numpy(a) for a in args], *rest, want.clone())
            assert torch.equal(got.cpu(), want2)
            want = want2


def test_hash_keys_matches_numpy(dev):
    from flink_tpu_torch.kernels import exchange_kernels as xk
    from flink_tpu_torch.records import hash_keys_numpy

    i64 = np.iinfo(np.int64)
    keys = np.concatenate([[0, -1, i64.max, i64.min], np.random.default_rng(
        3).integers(i64.min, i64.max, 10_000, dtype=np.int64)])
    assert np.array_equal(xk.hash_keys(_t(keys, dev)).cpu().numpy(),
                          hash_keys_numpy(keys))


def test_sharded_operator_on_the_card_matches_the_cpu(dev):
    """Four blocks on one card against four blocks on the CPU: Q5's top-2
    and a lane aggregate with a tiny exchange capacity and the ring."""
    from flink_tpu_torch.api.windowing import (
        SlidingEventTimeWindows, TumblingEventTimeWindows)
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.ops.window import WindowOperator
    from flink_tpu_torch.parallel.mesh import make_mesh_plan

    rng = np.random.default_rng(8)
    for assigner, agg, kw in (
            (SlidingEventTimeWindows.of(10_000, 1_000), ta.count(),
             dict(top_n=("count", 2))),
            (TumblingEventTimeWindows.of(2_000),
             ta.multi(ta.count(), ta.sum_of("v"), ta.max_of("v")),
             dict(exchange_capacity=64, exchange_impl="ring"))):
        wk.reset_launch_counts()
        ops = [WindowOperator(
            assigner, agg, max_out_of_orderness_ms=1_000, device=d,
            mesh_plan=make_mesh_plan(32, 256, [d] * 4), **kw)
            for d in ("cpu", "cuda:0")]
        t = 0
        for _ in range(5):
            n = int(rng.integers(100, 20_000))
            keys = rng.zipf(1.5, n) % 3000
            ts = t + rng.integers(-900, 4_000, n)
            t += 4_000
            data = {"v": rng.random(n).astype(np.float32)}
            outs = []
            for op in ops:
                op.process_batch(keys, ts, data)
                f = dict(op.advance_watermark(int(ts.max()) - 1_001))
                outs.append({k: np.asarray(v) for k, v in f.items()})
            for k in outs[0]:
                if k.startswith("sum"):
                    np.testing.assert_allclose(outs[1][k], outs[0][k],
                                               rtol=1e-5)
                else:
                    np.testing.assert_array_equal(outs[1][k], outs[0][k])
        # the split upload's bytes decoded inside bucket_records
        assert all(wk.LAUNCHES[k] > 0 for k in ("bucket_records",
                                                "ring_columns"))
        assert wk.LAUNCHES["split_cells"] == 0
        assert ops[1].exchange_overflow == 0


# -- pane state past 2^31 cells -------------------------------------------------

def test_pane_state_past_2_31_cells(dev):
    """count + sum over 1088 x 65,536 slots + 1 dump row and a 32-column
    ring (2.28 G cells): int64 cells from the upload on, three 2^20-bid
    batches over event time [0, 9 s) with half the keys on rows past
    2^26 (every cell of theirs past 2^31), a fire of window ends 1..12 s
    with its purge, a batch 40 s ahead that grows the ring 32 -> 64 (K4
    in blocks of rows), then the end-of-input fire: every row equal to a
    numpy golden (counts exactly, sums within their ordering bound)."""
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.ops.window import WindowOperator
    from flink_tpu_torch.records import hash_keys_numpy

    shards, spd, B = 1088, 65_536, 1 << 20
    cand = np.arange(1, 1 << 20, dtype=np.int64)
    shard = hash_keys_numpy(cand) % shards
    keys = np.concatenate([cand[shard < 1024][:1 << 15],
                           cand[shard >= 1024][:1 << 15]])
    rng = np.random.default_rng(31)
    batches = []
    for i in range(4):
        ts = (12_000 if i == 3 else 3_000 * i) + rng.integers(0, 3_000, B)
        if i == 3:
            ts[:B // 8] += 40_000
        batches.append((keys[rng.integers(0, len(keys), B)], ts,
                        (rng.integers(100, 100_000, B) / 100).astype(np.float32)))
    torch.cuda.empty_cache()
    wk.reset_launch_counts()
    op = WindowOperator(SlidingEventTimeWindows.of(10_000, 1_000),
                        ta.multi(ta.count(), ta.sum_of("price")),
                        num_shards=shards, slots_per_shard=spd,
                        max_out_of_orderness_ms=17_000, device="cuda")
    assert op.layout.rows * op.plan.ring >= 2 ** 31 and op.plan.ring == 32
    assert op._cell_dtype() is np.int64
    fired = []
    for i, (k, ts, price) in enumerate(batches):
        op.process_batch(k, ts, {"price": price})
        if i == 2:
            fired.append(dict(op.advance_watermark(12_000)))
    fired.append(dict(op.advance_watermark(op.final_watermark())))
    torch.cuda.synchronize()
    assert op.plan.ring == 64 and op.late_records == 0
    assert wk.LAUNCHES["ring_columns"] >= 3 and wk.LAUNCHES["scatter_lanes"] >= 8
    del op
    torch.cuda.empty_cache()
    got = {f: np.concatenate([np.asarray(d[f]) for d in fired])
           for f in ("window_end", "key", "count", "sum_price")}
    order = np.lexsort((got["key"], got["window_end"]))
    # golden: per (key, pane), then each pane into its 10 windows
    k = np.concatenate([b[0] for b in batches])
    pane = np.concatenate([b[1] for b in batches]) // 1000
    price = np.concatenate([b[2] for b in batches]).astype(np.float64)
    kp, inv = np.unique(k * 4096 + pane, return_inverse=True)
    cnt, tot = np.bincount(inv), np.bincount(inv, weights=price)
    ends = (kp % 4096)[:, None] + np.arange(1, 11)[None, :]
    ke, inv = np.unique(ends.reshape(-1) * (1 << 40) + np.repeat(kp // 4096, 10),
                        return_inverse=True)
    g_cnt = np.bincount(inv, weights=np.repeat(cnt, 10)).astype(np.int64)
    g_sum = np.bincount(inv, weights=np.repeat(tot, 10))
    np.testing.assert_array_equal(got["window_end"][order], (ke >> 40) * 1000)
    np.testing.assert_array_equal(got["key"][order], ke & ((1 << 40) - 1))
    np.testing.assert_array_equal(got["count"][order], g_cnt)
    bound = (2.0 * g_cnt + 34.0) * 2.0 ** -24 * np.abs(g_sum)
    assert (np.abs(got["sum_price"][order] - g_sum) <= bound).all()


# -- the lean launch path: every wrapper on a stream and in a graph ---------------

def _lean_cases(dev):
    """name -> (make, plain): ``make()`` returns a fresh launch of the
    wrapper (a closure over fresh inputs) that returns its outputs;
    ``plain`` the same call through the plain version. Small shapes; each
    wrapper's outputs are tensors (in-place wrappers return the state
    they wrote)."""
    from flink_tpu_torch.kernels import count_window_kernels as cw
    from flink_tpu_torch.kernels import devgen_kernels as dk
    from flink_tpu_torch.kernels import element_kernels as ek
    from flink_tpu_torch.kernels import exchange_kernels as xk
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.kernels import lane_kernels as lk
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk

    rng = np.random.default_rng(77)
    rows, ring, W, lo, hi, ppw = 1025, 16, 5, 1000, 1010, 4
    counts = _t(_live_counts(rng, rows, ring, lo, hi), dev)
    _, s1, mx1, mn1 = _lane_state(rng, rows, ring, lo, hi, 1, 1, 1)
    s1, mx1, mn1 = _t(s1, dev), _t(mx1, dev), _t(mn1, dev)
    ends = _t(np.arange(lo + 2, lo + 2 + W, dtype=np.int64), dev)
    valid = torch.ones(W, dtype=torch.bool, device=dev)
    used = _t(rng.random(rows) < 0.9, dev)
    idx = _t(rng.integers(0, rows * ring, 5000).astype(np.int32), dev)
    cnt = _t(rng.integers(1, 9, 5000).astype(np.int32), dev)
    rec = _t(rng.random((5000, 1)).astype(np.float32), dev)
    wc = wk.window_counts_plain(counts, ends, valid, lo, hi, ppw)
    ring0 = torch.zeros((256 + 2, 3), dtype=torch.int32, device=dev)
    ring5 = torch.zeros((256 + 2, 5), dtype=torch.int32, device=dev)
    sc = np.zeros((3000, 3), np.uint8)
    slots = rng.integers(0, rows - 1, 3000)
    sc[:, 0], sc[:, 1] = slots & 0xFF, slots >> 8
    sc[:, 2] = rng.integers(0, ring, 3000)
    sc = _t(sc, dev)
    words = np.full(4096, -1, np.int32)
    pairs = rng.choice((rows - 1) * ring, 3000, replace=False)
    words[:3000] = ((pairs << 12) | rng.integers(1, 4000, 3000)).astype(
        np.uint32).view(np.int32)
    words = _t(words, dev)
    tri = np.full((4096, 3), 0xFFFF, np.uint16)
    tri[:3000, 0], tri[:3000, 1] = pairs & 0xFFFF, pairs >> 16
    tri[:3000, 2] = rng.integers(1, 60000, 3000)
    tri = _t(tri, dev)
    hdr = np.zeros(fk.FUSED_HDR, np.int32)
    hdr[:6] = np.array([lo, hi, lo], np.int64).view(np.int32)
    hdr[7] = 0b111
    deltas = np.full(fk.MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
    deltas[:3] = [3, 5, 8]
    hdr[8:8 + fk.MIN_FIRE_PAD] = deltas
    fbuf = _t(np.concatenate([hdr, words.cpu().numpy()]), dev)
    keys = _t(rng.integers(0, 900, 4000).astype(np.int64), dev)
    kts = _t(rng.integers(lo * 1000, (hi + 1) * 1000, 4000).astype(np.int64), dev)
    offsets = _t(np.array([0, 7, 7, 300, 4000], np.int64), dev)
    el = [_t(rng.standard_normal((4000, k)).astype(np.float32), dev)
          for k in (2, 1, 1)]
    cw_counts = _t(rng.integers(0, 9, 2049).astype(np.int32), dev)
    cw_sums = _t(rng.random((2049, 1)).astype(np.float32), dev)
    cells = _t(np.where(rng.random(4096) < 0.9,
                        rng.integers(0, 4 * 256 * ring, 4096), -1).astype(np.int32), dev)
    payload = _t(rng.random((4096, 2)).astype(np.float32), dev)
    cands = wk.topn_candidates_plain(wc, used, valid, 3)
    v = _t(rng.random((rows, W)).astype(np.float32), dev)
    cols = _t(rng.integers(-9, 9, (rows, W, 2)).astype(np.int32), dev)
    lcands = torch.cat([tk.topn_candidates_lanes_plain(wc, v, used, valid, 3)] * 2,
                       dim=1)
    args_fp = (counts, s1, mx1, mn1, ends, valid, used, lo, hi, ppw, 4096, False)

    def inplace(fn, *state):
        def make():
            st = [x.clone() for x in state]
            return lambda: (fn(*st), st)
        return make

    def after(fn, *state):
        st = [x.clone() for x in state]
        return fn(*st), st

    def pure(fn):
        return lambda: fn

    return {
        "scatter_counts": (inplace(lambda c: wk.scatter_counts(c, idx, cnt), counts),
                           lambda: after(lambda c: wk.scatter_counts_plain(
                               c, idx, cnt), counts)),
        "split_cells": (pure(lambda: wk.split_cells(sc, ring, rows - 1)),
                        lambda: wk.split_cells_plain(sc, ring, rows - 1)),
        "scatter_split_counts": (
            inplace(lambda c: wk.scatter_split_counts(c, sc, rows - 1), counts),
            lambda: after(lambda c: wk.scatter_split_counts_plain(
                c, sc, rows - 1), counts)),
        "window_counts": (pure(lambda: wk.window_counts(counts, ends, valid, lo, hi, ppw)),
                          lambda: wc),
        "topn_select_append": (
            inplace(lambda r: wk.topn_select_append(wc, used, ends, valid, lo, 2, 200, r),
                    ring0),
            lambda: after(lambda r: wk.topn_select_append_plain(
                wc, used, ends, valid, lo, 2, 200, r), ring0)),
        "topn_candidates": (pure(lambda: wk.topn_candidates(wc, used, valid, 3)),
                            lambda: cands),
        "topn_global_threshold": (pure(lambda: wk.topn_global_threshold(cands, 3)),
                                  lambda: wk.topn_global_threshold_plain(cands, 3)),
        "topn_select_given": (
            inplace(lambda r: wk.topn_select_given(wc, used, ends, valid, lo, cands,
                                                   3, 7, 200, r), ring0),
            lambda: after(lambda r: wk.topn_select_given_plain(
                wc, used, ends, valid, lo, cands, 3, 7, 200, r), ring0)),
        "nexmark_bids": (pure(lambda: dk.nexmark_bids(3, 100, 5000, 1 << 20, 50, 4, 100,
                                                      10_000, dev)),
                         lambda: dk.nexmark_bids_plain(3, 100, 5000, 1 << 20, 50, 4,
                                                       100, 10_000, dev)),
        "devgen_ingest": (
            inplace(lambda c: dk.devgen_ingest(c, keys, kts, key_domain=1000,
                                               pane_ms=1000, offset_ms=0,
                                               dead_below=lo, refire_below=lo + 2,
                                               dump_row=rows - 1), counts),
            lambda: after(lambda c: dk.devgen_ingest_plain(
                c, keys, kts, 1000, 1000, 0, lo, lo + 2, rows - 1,
                torch.zeros(dk.STATS_WORDS, dtype=torch.int32, device=dev)),
                counts)),
        "devgen_ingest_nexmark": (
            inplace(lambda c: dk.devgen_ingest_nexmark(
                c, (3, 100, 5000, 1 << 20, 50, 4, 100, 1000), key_domain=900,
                pane_ms=1000, offset_ms=0, dead_below=lo, refire_below=lo + 2,
                dump_row=rows - 1), counts),
            lambda: after(lambda c: dk.devgen_ingest_nexmark_plain(
                c, (3, 100, 5000, 1 << 20, 50, 4, 100, 1000), 900, 1000, 0, lo,
                lo + 2, rows - 1,
                torch.zeros(dk.STATS_WORDS, dtype=torch.int32, device=dev)),
                counts)),
        "fire_pack": (pure(lambda: lk.fire_pack(*args_fp)),
                      lambda: lk.fire_pack_plain(*args_fp)),
        "scatter_lanes": (
            inplace(lambda c, s_: lk.scatter_lanes(c, s_, None, None, idx, rec,
                                                   rec[:, :0], rec[:, :0]),
                    counts, s1),
            # the plain version on the card adds with atomics: its order is
            # the CPU's
            lambda: after(lambda c, s_: lk.scatter_lanes_plain(
                c, s_, None, None, idx.cpu(), rec.cpu(), rec[:, :0].cpu(),
                rec[:, :0].cpu()), counts.cpu(), s1.cpu())),
        "apply_pairs_u32": (inplace(lambda c: fk.apply_pairs_u32(c, words, rows - 1),
                                    counts),
                            lambda: after(lambda c: fk.apply_pairs_u32_plain(
                                c, words, rows - 1), counts)),
        "apply_pairs_u16": (inplace(lambda c: fk.apply_pairs_u16(c, tri), counts),
                            lambda: after(lambda c: fk.apply_pairs_u16_plain(
                                c, tri), counts)),
        "fused_step": (
            inplace(lambda c, r: fk.fused_step(c, r, fbuf, used, ppw=ppw, n=2,
                                               sel_cap=200, dump_row=rows - 1,
                                               fire_gate=True, fire_pad=4),
                    counts, ring0),
            lambda: after(lambda c, r: fk.fused_step_plain(
                c, r, fbuf, used, ppw=ppw, n=2, sel_cap=200, dump_row=rows - 1,
                fire_gate=True, fire_pad=4), counts, ring0)),
        "count_fire": (
            inplace(lambda c, s_: cw.count_fire(c, None, s_, None, None, 5, 4096),
                    cw_counts, cw_sums),
            lambda: after(lambda c, s_: cw.count_fire_plain(
                c, None, s_, None, None, 5, 4096), cw_counts, cw_sums)),
        "segment_lanes": (pure(lambda: ek.segment_lanes(offsets, *el)),
                          lambda: ek.segment_lanes_plain(offsets, *el)),
        "bucket_records": (pure(lambda: xk.bucket_records(cells, payload, 4, 2048,
                                                          256, ring)),
                           lambda: xk.bucket_records_plain(cells, payload, 4, 2048,
                                                           256, ring)),
        "hash_keys": (pure(lambda: xk.hash_keys(keys)),
                      lambda: xk.hash_keys_plain(keys)),
        "topn_select_lanes": (
            inplace(lambda r: tk.topn_select_lanes(wc, v, cols, used, ends, valid,
                                                   lo, 2, 200, r), ring5),
            lambda: after(lambda r: tk.topn_select_lanes_plain(
                wc, v, cols, used, ends, valid, lo, 2, 200, r), ring5)),
        "topn_candidates_lanes": (
            pure(lambda: tk.topn_candidates_lanes(wc, v, used, valid, 3)),
            lambda: tk.topn_candidates_lanes_plain(wc, v, used, valid, 3)),
        "topn_select_lanes_given": (
            inplace(lambda r: tk.topn_select_lanes_given(
                wc, v, cols, used, ends, valid, lo, lcands, 3, 7, 200, r), ring5),
            lambda: after(lambda r: tk.topn_select_lanes_given_plain(
                wc, v, cols, used, ends, valid, lo, lcands, 3, 7, 200, r), ring5)),
    }


LEAN_WRAPPERS = ("scatter_counts", "split_cells", "scatter_split_counts",
                 "window_counts",
                 "topn_select_append", "topn_candidates", "topn_global_threshold",
                 "topn_select_given", "nexmark_bids", "devgen_ingest",
                 "devgen_ingest_nexmark", "fire_pack",
                 "scatter_lanes", "apply_pairs_u32", "apply_pairs_u16", "fused_step",
                 "count_fire", "segment_lanes", "bucket_records", "hash_keys",
                 "topn_select_lanes", "topn_candidates_lanes",
                 "topn_select_lanes_given")


def _flat(out):
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _flat(o)]


def _outputs_equal(got, want):
    got, want = _flat(got), _flat(want)
    return len(got) == len(want) and all(
        g.shape == w.shape and _exact_bits(g.float() if g.dtype == torch.bool
                                           else g, w.float() if w.dtype == torch.bool
                                           else w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", LEAN_WRAPPERS)
def test_lean_wrapper_queues_on_the_current_stream(dev, name, monkeypatch):
    """Under a non-default torch.cuda.stream each wrapper hands that
    stream's handle to its launch, and its outputs equal the plain
    version's (every kernel warmed first: a kernel's first launch loads it
    and waits for the whole card)."""
    make, plain = _lean_cases(dev)[name]
    make()()
    torch.cuda.synchronize()
    seen = []
    orig = wk.LeanEntry.__call__

    def spy(self, stream, *words):
        seen.append(stream)
        return orig(self, stream, *words)
    monkeypatch.setattr(wk.LeanEntry, "__call__", spy)
    launch = make()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(10_000_000)
        got = launch()
    torch.cuda.synchronize()
    assert seen and set(seen) == {side.cuda_stream}
    assert _outputs_equal(got, plain())


@pytest.mark.parametrize("name", LEAN_WRAPPERS)
def test_lean_wrapper_captures_into_a_graph(dev, name):
    """Captured into a CUDA graph (a launch on any other stream than the
    capture's would break it) and replayed once, each wrapper's outputs
    equal the plain version's."""
    make, plain = _lean_cases(dev)[name]
    make()()
    torch.cuda.synchronize()
    launch = make()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = launch()
    graph.replay()
    torch.cuda.synchronize()
    assert _outputs_equal(got, plain())


# -- K3's count top-n over the whole card, and K6's folded ingest -------------

def _count_topn_both(dev, wc, used, valid, n, sel_cap, row_cap=2048, fill=0,
                     given=None, row_offset=0):
    """``topn_select_append`` (or, with ``given`` thresholds,
    ``topn_select_given`` on them as (W, 1) gathered candidates at k = 1,
    whose k-th is each itself) and its plain version on one grid; the
    rings (their last row excepted) must be equal. Returns the kernel's
    ring."""
    rows, W = wc.shape
    ends = _t(np.arange(100, 100 + W, dtype=np.int64), dev)
    args = [_t(wc.astype(np.int32), dev), _t(used, dev), ends, _t(valid, dev),
            90]
    r1 = torch.zeros((row_cap + 2, 3), dtype=torch.int32, device=dev)
    r1[0, 0] = fill
    r2 = r1.clone()
    if given is None:
        wk.topn_select_append(*args, n, sel_cap, r1)
        wk.topn_select_append_plain(*args, n, sel_cap, r2)
    else:
        g = _t(np.asarray(given, np.float32)[:, None], dev)
        wk.topn_select_given(*args, g, 1, row_offset, sel_cap, r1)
        wk.topn_select_given_plain(*args, g, 1, row_offset, sel_cap, r2)
    assert torch.equal(r1[:-1], r2[:-1])
    return r1


@pytest.mark.parametrize("W", [1, 11, 64, 65])
@pytest.mark.parametrize("n", [1, 3, "rows+1"])
def test_count_topn_widths_and_n(dev, W, n):
    """The whole-card threshold at 1, 11 and 64 windows (one block's
    table) and 65 (past it: no table, a launch a radix pass), top-1 (the
    max), top-3 (the radix select) and n past the rows (k = rows)."""
    rng = np.random.default_rng(W * 10 + (n if isinstance(n, int) else 7))
    rows = 4097 if n != "rows+1" else 300
    wc = rng.integers(0, 40, (rows, W)) * (rng.random((rows, W)) < 0.4)
    used = rng.random(rows) < 0.9
    used[-1] = False
    nn = rows + 1 if n == "rows+1" else n
    # the ring wraps once (a second wrap would land two rows on one slot)
    r = _count_topn_both(dev, wc, used, np.ones(W, bool), nn, 1 << 16,
                         row_cap=1 << 16, fill=(1 << 16) - 100)
    assert int(r[0, 1]) == 0 and int(r[0, 0]) > (1 << 16) - 100


def test_count_topn_ties_past_2_24(dev):
    """Counts 2^24 and 2^24 + 1 are one f32 value: at top-1 both rows
    select, as the plain version's and the reference's f32 ranking has
    them, and a count just below (2^24 - 1) does not; 2^24 + 3 and
    2^24 + 4 round to one value too."""
    rows, W = 1000, 3
    wc = np.ones((rows, W), np.int64)
    wc[10, 0], wc[700, 0], wc[5, 0] = 2 ** 24, 2 ** 24 + 1, 2 ** 24 - 1
    wc[3, 1], wc[4, 1], wc[9, 1] = 2 ** 24 + 3, 2 ** 24 + 4, 2 ** 24 + 2
    r = _count_topn_both(dev, wc, np.ones(rows, bool), np.ones(W, bool), 1,
                         4096)
    got = r[1:1 + int(r[0, 0])].cpu().numpy()
    assert sorted(got[got[:, 1] == 10, 0].tolist()) == [10, 700]
    assert got[got[:, 1] == 11, 0].tolist() == [3, 4]
    assert int((got[:, 1] == 12).sum()) == rows        # all ones tie


def test_count_topn_sparse_invalid_and_unused(dev):
    """A window with fewer candidates than n takes them all; invalid
    windows and unused rows select nothing."""
    rng = np.random.default_rng(21)
    rows, W = 3000, 20
    wc = (rng.random((rows, W)) < 0.002) * rng.integers(1, 9, (rows, W))
    wc[:, 3] = rng.integers(1, 100, rows)
    used = rng.random(rows) < 0.7
    valid = rng.random(W) < 0.7
    valid[3] = False
    for n in (1, 5):
        r = _count_topn_both(dev, wc, used, valid, n, 2048)
        got = r[1:1 + int(r[0, 0])].cpu().numpy()
        assert not (got[:, 1] == 13).any()
        assert used[got[:, 0]].all() and valid[got[:, 1] - 10].all()


def test_count_topn_sel_cap_and_ring_wrap(dev):
    """Ties past sel_cap land the first sel_cap rows in row-major order
    and count the rest as truncated; appends wrap the ring."""
    rng = np.random.default_rng(22)
    rows, W = 32769, 4
    wc = rng.integers(1, 3, (rows, W))
    r = _count_topn_both(dev, wc, np.ones(rows, bool), np.ones(W, bool), 1,
                         300, row_cap=512, fill=400)
    assert int(r[0, 0]) == 700 and int(r[0, 1]) > 0


def test_count_topn_given_row_offsets_and_minus_inf(dev):
    """topn_select_given: the given thresholds, a block's row offset,
    and a -inf threshold (every candidate of that window selects)."""
    rng = np.random.default_rng(23)
    rows, W = 8193, 11
    wc = rng.integers(0, 60, (rows, W)) * (rng.random((rows, W)) < 0.5)
    used = rng.random(rows) < 0.8
    given = rng.integers(40, 60, W).astype(np.float32)
    given[4] = -np.inf
    for off in (0, 8193, 3 * 8193):
        r = _count_topn_both(dev, wc, used, np.ones(W, bool), 1, 1 << 16,
                             row_cap=1 << 16, given=given, row_offset=off)
        got = r[1:1 + int(r[0, 0])].cpu().numpy()
        assert int(got[:, 0].min()) >= off
        assert int((got[:, 1] == 14).sum()) == int(((wc[:, 4] > 0)
                                                    & used).sum())


@pytest.mark.parametrize("k,n_blocks,W", [
    (1, 1, 1), (1, 4, 11), (2, 8, 16), (3, 4, 11), (5, 3, 64), (8, 2, 16),
    (16, 4, 11), (16, 8, 64), (7, 5, 33), (1, 8, 64)])
def test_gathered_select_matches_its_composed_plain_version(dev, k, n_blocks, W):
    """topn_select_given against the gathered candidates of n_blocks
    blocks (their top k each, written into the block's columns of one
    buffer by topn_candidates): each block in turn, with its row offset,
    into one ring started near its capacity, bit for bit against
    topn_global_threshold_plain then the select's plain version; ties
    across blocks at the k-th (window 0), a window with fewer than k
    candidates in all (-inf: all its candidates), an invalid window."""
    rng = np.random.default_rng(k * 100 + n_blocks * 10 + W)
    rows = 4097
    ends = _t(np.arange(100, 100 + W, dtype=np.int64), dev)
    valid = np.ones(W, bool)
    if W > 2:
        valid[2] = False
    valid_t = _t(valid, dev)
    grids, useds = [], []
    for _ in range(n_blocks):
        wc = rng.integers(0, 30, (rows, W)) * (rng.random((rows, W)) < 0.3)
        wc[:k, 0] = 1000                 # every block's k tied at the top
        if W > 1:
            wc[:, 1] = 0
        used = rng.random(rows) < 0.9
        used[:k] = True
        grids.append(_t(wc.astype(np.int32), dev))
        useds.append(_t(used, dev))
    if W > 1:
        grids[-1][5, 1] = 4                  # one candidate in all
        useds[-1][5] = True
    gathered = torch.full((W, n_blocks * k), 7.0, device=dev)
    for b in range(n_blocks):
        wk.topn_candidates(grids[b], useds[b], valid_t, k,
                           out=gathered[:, b * k:(b + 1) * k])
        assert torch.equal(gathered[:, b * k:(b + 1) * k],
                           wk.topn_candidates_plain(grids[b], useds[b], valid_t, k))
    thresh = wk.topn_global_threshold_plain(gathered, k)
    assert float(thresh[0]) == 1000.0
    if W > 1 and k > 1:
        assert float(thresh[1]) == -float("inf")
    r1 = torch.zeros((1 << 12) + 2, 3, dtype=torch.int32, device=dev)
    r1[0, 0] = (1 << 12) - 50                # the appends wrap the ring
    r2 = r1.clone()
    for b in range(n_blocks):
        args = (grids[b], useds[b], ends, valid_t, 90, gathered, k, b * rows,
                1 << 12)
        wk.topn_select_given(*args, r1)
        wk.topn_select_given_plain(*args, r2)
    assert torch.equal(r1[:-1], r2[:-1])
    assert int(r1[0, 0]) - ((1 << 12) - 50) >= n_blocks * k
    wk.check_errors(dev)


@pytest.mark.parametrize("W,M,k", [
    (1, 1, 1), (11, 4, 1), (11, 12, 3), (64, 64, 16), (64, 128, 16),
    (33, 40, 40), (9, 100, 7), (64, 2, 2)])
def test_topn_global_threshold_matches_torch_topk(dev, W, M, k):
    """The warp-a-window kernel (several windows a block) against
    torch.topk(cands, k)'s k-th and its plain version: values with ties,
    -inf fills, rows with fewer than k finite values, a row of -inf."""
    rng = np.random.default_rng(W * M + k)
    c = rng.integers(0, 6, (W, M)).astype(np.float32)
    c[rng.random((W, M)) < 0.3] = -np.inf
    c[0] = -np.inf
    if W > 1:
        c[1, :] = 5.0                        # one value M times
    cands = _t(c, dev)
    got = wk.topn_global_threshold(cands, k)
    assert torch.equal(got, torch.topk(cands, k, dim=1).values[:, k - 1])
    assert torch.equal(got, wk.topn_global_threshold_plain(cands, k))


def test_count_topn_renews_its_workspace(dev, monkeypatch):
    """With WORKSPACE_CALLS lowered, the workspace is replaced by a
    zeroed one every few calls, and every call stays equal to the plain
    version (no descriptor or threshold of an older call counts)."""
    monkeypatch.setattr(wk, "WORKSPACE_CALLS", 3)
    rng = np.random.default_rng(24)
    rows, W = 20_000, 11
    seen = []
    for call in range(8):
        # few ties: each call's rows fit the ring without a second wrap
        wc = (rng.integers(0, 1_000_000, (rows, W))
              * (rng.random((rows, W)) < 0.5))
        _count_topn_both(dev, wc, np.ones(rows, bool), np.ones(W, bool),
                         1 + call % 3, 4096)
        seen.append(wk._workspaces[("topn_select_append", dev.index or 0,
                                    torch.cuda.current_stream().cuda_stream)])
    assert len({id(ws) for ws in seen}) >= 3


def _fused_gate_case(dev, n_ends, anchor):
    from flink_tpu_torch.kernels import fused_kernels as fk

    rng = np.random.default_rng(25)
    slots, ring, ppw, pane_lo = 4096, 32, 10, 500
    pane_hi = pane_lo + 20
    counts = _t(_live_counts(rng, slots + 1, ring, pane_lo, pane_hi), dev)
    hdr = np.zeros(fk.FUSED_HDR, np.int32)
    hdr[:6] = np.array([pane_lo, pane_hi, anchor], np.int64).view(np.int32)
    deltas = np.full(fk.MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
    deltas[:n_ends] = np.arange(pane_hi + 2 - n_ends, pane_hi + 2) - pane_lo
    hdr[8:8 + fk.MIN_FIRE_PAD] = deltas.astype(np.int32)
    words = _pair_words(rng, slots, ring, 20_000, 1 << 15)
    buf = _t(np.concatenate([hdr, words]), dev)
    used = _t(rng.random(slots + 1) < 0.6, dev)
    kw = dict(ppw=ppw, n=1, sel_cap=256, dump_row=slots, fire_gate=True,
              fire_pad=16)
    return counts, buf, used, kw


def test_fused_step_gate_off_leaves_ring_and_epoch(dev):
    """A fused step with no valid end (its fire word 0) writes nothing:
    the emit ring keeps its bytes and the step's workspace its epoch;
    a firing step after it (anchor from the device block, not pane_lo)
    still equals the plain version."""
    from flink_tpu_torch.kernels import fused_kernels as fk

    counts, buf, used, kw = _fused_gate_case(dev, 11, 493)
    ring = torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
    fk.fused_step(counts.clone(), ring, buf, used, **kw)
    key = ("fused_step", dev.index or 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    epoch = int(wk._workspaces[key].tensor[1]) >> 32
    assert epoch >= 1 and int(ring[0, 0]) >= 11
    before = ring.clone()
    off_counts, off_buf, off_used, _ = _fused_gate_case(dev, 0, 493)
    states = [off_counts.clone(), off_counts.clone()]
    rings = [ring, before.clone()]
    fk.fused_step(states[0], rings[0], off_buf, off_used, **kw)
    fk.fused_step_plain(states[1], rings[1], off_buf, off_used, **kw)
    torch.cuda.synchronize()
    assert torch.equal(rings[0], before) and torch.equal(states[0], states[1])
    assert int(wk._workspaces[key].tensor[1]) >> 32 == epoch
    states = [counts.clone(), counts.clone()]
    rings = [ring.clone(), ring.clone()]
    fk.fused_step(states[0], rings[0], buf, used, **kw)
    fk.fused_step_plain(states[1], rings[1], buf, used, **kw)
    assert torch.equal(states[0], states[1])
    assert torch.equal(rings[0][:-1], rings[1][:-1])
    got = rings[0][1:].cpu().numpy()
    assert int(got[:, 1].max()) == 521 - 493


def _ingest_case(dev, keys, ts, rows, ring, with_stats=True, **kw):
    from flink_tpu_torch.kernels import devgen_kernels as dk

    a = torch.zeros((rows, ring), dtype=torch.int32, device=dev)
    b = a.clone()
    k, t = _t(np.asarray(keys, np.int64), dev), _t(np.asarray(ts, np.int64), dev)
    sa = dk.devgen_ingest(a, k, t, with_stats=with_stats, **kw)
    sb = dk.devgen_ingest_plain(b, k, t, kw["key_domain"], kw["pane_ms"],
                                kw["offset_ms"], kw["dead_below"],
                                kw["refire_below"], kw["dump_row"],
                                torch.zeros_like(sa) if with_stats else None)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    if with_stats:
        assert torch.equal(sa, sb)
    return a, sa


def test_devgen_ingest_one_cell_takes_every_record(dev):
    """2^20 records on one cell: the block histograms fold them, and the
    cell holds the exact count."""
    n = 1 << 20
    a, stats = _ingest_case(dev, np.full(n, 7), np.full(n, 123_456), 32769,
                            64, key_domain=10_000, pane_ms=1000, offset_ms=0,
                            dead_below=0, refire_below=-(2 ** 63),
                            dump_row=32768)
    assert int(a[7, 123 % 64]) == n and int(stats[0]) == n


@pytest.mark.parametrize("ring,pane_ms,offset", [(64, 1000, 0), (48, 700, 333),
                                                 (37, 1, -5), (1, 999, 10)])
def test_devgen_ingest_chunks_panes_and_rings(dev, ring, pane_ms, offset):
    """Pane boundaries inside a block's chunk and between a thread's
    records (a pane of a few hundred records), chunk edges (a batch that
    is not a multiple of the chunk), a ring that is no power of two, an
    odd pane_ms, and ts below offset_ms (negative panes)."""
    rng = np.random.default_rng(ring + pane_ms)
    n = 3 * 8192 + 1234
    ts = np.sort(rng.integers(-3 * pane_ms, 40 * pane_ms, n)) + offset
    keys = rng.integers(0, 1000, n)
    keys[rng.random(n) < 0.3] = rng.integers(0, 5)
    lo = int(np.floor((ts.min() - offset) / pane_ms))
    _ingest_case(dev, keys, ts, 1001, ring, key_domain=1000, pane_ms=pane_ms,
                 offset_ms=offset, dead_below=lo, refire_below=-(2 ** 63),
                 dump_row=1000)


def test_devgen_ingest_late_miss_and_unsorted(dev):
    """Out-of-domain, negative and late keys with stats and the re-fire
    bitmap, on records out of time order."""
    rng = np.random.default_rng(26)
    n = 200_003
    ts = rng.integers(0, 60_000, n)
    keys = rng.integers(-50, 12_000, n)
    for stats in (True, False):
        a, s = _ingest_case(dev, keys, ts, 10_001, 64, with_stats=stats,
                            key_domain=10_000, pane_ms=1000, offset_ms=0,
                            dead_below=10, refire_below=30, dump_row=10_000)
        if stats:
            head = s[:8].tolist()
            assert head[1] > 0 and head[2] > 0 and head[4] > 0
            assert int(s[8:].sum()) == 20


def test_devgen_ingest_wide_key_domain(dev):
    """A key domain too wide for a block's histogram (60,001 slots past
    its 48 K words): one global atomic a record, the same counts."""
    from flink_tpu_torch.kernels import devgen_kernels as dk

    keys, ts = dk.nexmark_bids(3, 0, 1 << 18, 1 << 22, 100, 4, 600, 60_000,
                               dev)
    _ingest_case(dev, keys.cpu().numpy(), ts.cpu().numpy(), 60_001, 64,
                 key_domain=60_000, pane_ms=1000, offset_ms=0,
                 dead_below=int(ts.min()) // 1000, refire_below=-(2 ** 63),
                 dump_row=60_000)


def test_devgen_ingest_cell_outside_the_state_sets_the_error_word(dev):
    """A dump row past the state (through the table): the invalid
    records are not written and the error bit is set."""
    from flink_tpu_torch.kernels import devgen_kernels as dk

    wk.check_errors(dev)
    c = torch.zeros((40, 8), dtype=torch.int32, device=dev)
    keys = _t(np.r_[np.arange(20_000) % 30, [99, 98]].astype(np.int64), dev)
    ts = _t(np.arange(20_002, dtype=np.int64), dev)
    dk.devgen_ingest(c, keys, ts, key_domain=30, pane_ms=1000, offset_ms=0,
                     dead_below=0, refire_below=-(2 ** 63), dump_row=40)
    assert int(c.sum()) == 20_000
    with pytest.raises(IndexError, match="devgen_ingest"):
        wk.check_errors(dev)


# -- K6's Nexmark form: the bids made inside the ingest -----------------------

def _nexmark_ingest_both(dev, gen, rows, ring, with_stats=True, **kw):
    """``devgen_ingest_nexmark`` against ``nexmark_bids_plain`` then
    ``devgen_ingest_plain`` on the card: counts and stats bit for bit."""
    from flink_tpu_torch.kernels import devgen_kernels as dk

    a = torch.zeros((rows, ring), dtype=torch.int32, device=dev)
    b = a.clone()
    sa = dk.devgen_ingest_nexmark(a, gen, with_stats=with_stats, **kw)
    keys, ts = dk.nexmark_bids_plain(*gen, dev)
    sb = dk.devgen_ingest_plain(b, keys, ts, kw["key_domain"], kw["pane_ms"],
                                kw["offset_ms"], kw["dead_below"],
                                kw["refire_below"], kw["dump_row"],
                                torch.zeros_like(sa) if with_stats else None)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and int(a.sum()) == gen[2]
    if with_stats:
        assert torch.equal(sa, sb)
    else:
        assert sa is None
    return a, sa, ts


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("gen,domain,ring,pane_ms,offset", [
    # n not a multiple of the 8,192-record chunk
    ((3, 0, 3 * 8192 + 1234, 1 << 22, 100, 4, 100, 10_000), 10_000, 64, 1000, 0),
    # the headline's sub-batches 1 and 3 of a logical batch (K = 4)
    ((5, 1 << 20, 1 << 20, 1 << 22, 100, 4, 100, 10_000), 10_000, 64, 1000, 0),
    ((5, 3 << 20, 1 << 20, 1 << 22, 100, 4, 100, 10_000), 10_000, 1, 1000, 0),
    # a pane every 4,900 records: chunks straddle pane edges; offset_ms
    ((2, 5000, 200_003, 1 << 20, 7, 4, 10, 1_000), 1_000, 37, 700, 333),
    # every bid hot (5 auctions, 2 of them past a domain of 3: misses), a
    # pane every 13 records, ts below offset_ms
    ((1, 0, 100_000, 100_000, 1, 1, 5, 500), 3, 16, 13, 20_000),
    # events_per_ms past the fast division's reach; hot_ratio past 256
    ((0, 0, 50_000, 50_000, (1 << 31) - 1, 300, 7, 40), 40, 8, 1, 0),
])
def test_devgen_ingest_nexmark_form(dev, gen, domain, ring, pane_ms, offset,
                                    with_stats):
    """The Nexmark form against the composed plain version: chunk and
    pane edges, offsets, rings of 1 and 64, the K = 4 offsets, late and
    re-fire records (panes below the dead and fired frontiers), misses,
    with and without stats."""
    from flink_tpu_torch.kernels import devgen_kernels as dk

    keys, ts = dk.nexmark_bids_plain(*gen, dev)
    lo = (int(ts.min()) - offset) // pane_ms
    hi = (int(ts.max()) - offset) // pane_ms
    kw = dict(key_domain=domain, pane_ms=pane_ms, offset_ms=offset,
              dead_below=lo + (hi - lo) // 4, refire_below=lo + (hi - lo) // 2,
              dump_row=1000 if gen[-1] <= 1000 else 10_000)
    rows = kw["dump_row"] + 1
    _, stats, _ = _nexmark_ingest_both(dev, gen, rows, ring, with_stats, **kw)
    if with_stats and hi - lo >= 4:
        head = stats[:8].tolist()
        assert head[1] > 0 and head[4] > 0
        assert head[0] + head[1] + head[2] == gen[2]
    wk.check_errors(dev)


def test_devgen_ingest_nexmark_form_cell_outside_the_state(dev):
    """A dump row past the state: the misses are not written and the
    error word reports it, as the memory form does."""
    from flink_tpu_torch.kernels import devgen_kernels as dk

    wk.check_errors(dev)
    c = torch.zeros((301, 8), dtype=torch.int32, device=dev)
    gen = (2, 0, 20_000, 20_000, 10, 4, 5, 500)
    dk.devgen_ingest_nexmark(c, gen, key_domain=300, pane_ms=1000,
                             offset_ms=0, dead_below=0,
                             refire_below=-(2 ** 63), dump_row=301)
    keys, _ = dk.nexmark_bids_plain(*gen, dev)
    assert int(c.sum()) == int((keys < 300).sum()) < 20_000
    with pytest.raises(IndexError, match="devgen_ingest"):
        wk.check_errors(dev)
    wk.check_errors(dev)
