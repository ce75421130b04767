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
    assert all(wk.LAUNCHES[k] > 0 for k in (
        "scatter_counts", "window_counts", "topn_select_append",
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
    assert wk.LAUNCHES["nexmark_bids"] == 4 * k
    assert wk.LAUNCHES["devgen_ingest"] == 4 * k
