"""Top-n by any result field, over any lane aggregate: the port's
``window_lanes`` and ``topn_select_lanes`` (their plain versions, since
the tensors lie on the CPU) and the window operator's lane route,
against the JAX package's ``fire_kernel`` lanes, its
``_ring_append_topn_core`` and its operator on the same seeded inputs.
tests/test_torch_cuda.py holds the CUDA kernels against the same plain
versions on the card.

Integers, row order, max/min lanes and every ranking by max, min or
count must be exactly equal (NaN and signed zeros included: the
threshold ranks in IEEE total order as ``lax.top_k`` does, and a NaN
threshold selects nothing). A window's f32 sum lies within |port - ref|
<= 2 * n * 2^-24 * sum(|terms|) over its n = ring columns (the
reference's jitted fire lets XLA's GEMM associate by shape), an average
within that over its count plus 2 * 2^-24 * |ref|. A ranking by an
average follows the margin rule: where a window's n-th and (n+1)-th
reference values lie further apart than their two bounds, the port
must select exactly the reference's rows; where closer, the port's
picks must lie among the rows tied with the n-th value within the
bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.api.windowing import (
    SlidingEventTimeWindows as JaxSliding,
    TumblingEventTimeWindows as JaxTumbling,
)
from flink_tpu.ops import aggregates as ja
from flink_tpu.ops import window as jw
from flink_tpu.state.keyed import PaneState as JaxPaneState
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.kernels import lane_kernels as lk
from flink_tpu_torch.kernels import topn_lanes_kernels as tk
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.window import WindowOperator
from test_torch_threads import capped_torch_threads  # noqa: F401

U = 2.0 ** -24
ROWS, RING, LO, HI, PPW = 41, 16, 30, 41, 4
# the reference's device functions jitted, as its operator runs them
FIRE = jax.jit(jw.fire_kernel, static_argnames=("panes_per_window", "ring"))
ENDS = [33, 34, 35, 38]


def grid_agg(m):
    # lanes: sums [a (avg)], maxs [a], mins [b]
    return m.multi(m.count(), m.avg_of("a"), m.max_of("a"), m.min_of("b"))


def live_state(seed, specials):
    """Pane state obeying the ring invariant (data only in the columns of
    live panes [LO, HI]); with ``specials``: NaN in one window's max and
    min, and max/min columns of -0/+0 that tie."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((ROWS, RING), np.int32)
    sums = np.zeros((ROWS, RING, 1), np.float32)
    maxs = np.full((ROWS, RING, 1), -np.inf, np.float32)
    mins = np.full((ROWS, RING, 1), np.inf, np.float32)
    for p in range(LO, HI + 1):
        c = p % RING
        hit = rng.random(ROWS) < 0.6
        k = int(hit.sum())
        counts[hit, c] = rng.integers(1, 6, k)
        sums[hit, c, 0] = (rng.standard_normal(k) * 50).astype(np.float32)
        maxs[hit, c, 0] = rng.integers(-5, 6, k).astype(np.float32)
        mins[hit, c, 0] = rng.integers(-5, 6, k).astype(np.float32)
    if specials:
        # pane 41 lies only in the window ending 42+: NaN there spares
        # the windows of ENDS but 38's (panes 34..37) is clean too, so
        # put one NaN in pane 35 (windows 36..39: ends 38)
        c = 35 % RING
        counts[7, c] = max(counts[7, c], 1)
        maxs[7, c, 0] = np.nan
        mins[8, c, 0] = np.nan
        counts[8, c] = max(counts[8, c], 1)
        # signed zeros at the top of the max lane in window 34 (panes
        # 30..33) and at the bottom of the min lane
        for r, z in ((3, 0.0), (4, -0.0)):
            counts[r, 31 % RING] = max(counts[r, 31 % RING], 1)
            maxs[r, :, 0] = np.where(maxs[r, :, 0] > z, -1.0, maxs[r, :, 0])
            maxs[r, 31 % RING, 0] = 9.0 + z  # 9.0 ties with 9.0
            mins[r, 31 % RING, 0] = z
    used = rng.random(ROWS) < 0.85
    used[[3, 4, 7, 8]] = True
    used[-1] = False
    return counts, sums, maxs, mins, used


def jax_state(counts, sums, maxs, mins):
    return JaxPaneState(jnp.asarray(sums), jnp.asarray(maxs),
                        jnp.asarray(mins), jnp.asarray(counts))


def tensors(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a).copy()) for a in arrs]


def sum_bound(sums, ends):
    """(rows, W): 2 * ring * 2^-24 * sum(|terms|) of each cell's sum."""
    colmask = lk._live_columns(torch.tensor(ends), RING, LO, HI, PPW).numpy()
    a = np.abs(sums[:, :, 0].astype(np.float64))
    return 2.0 * RING * U * (a[:, None, :] * colmask[None]).sum(axis=2)


def test_window_lanes_plain_matches_fire_kernel_lanes():
    """Every (row, window) cell: max/min exactly (NaN, ±0), sums within
    the bound; and bit for bit what fire_pack gives its cells."""
    counts, sums, maxs, mins, used = live_state(1, specials=True)
    ends = np.array(ENDS, np.int64)
    rs, rx, rn, _ = (np.asarray(a) for a in FIRE(
        jax_state(counts, sums, maxs, mins), jnp.asarray(ends),
        jnp.ones(len(ends), bool), jnp.asarray(LO), jnp.asarray(HI),
        panes_per_window=PPW, ring=RING))
    ts_, tx, tn = tensors(sums, maxs, mins)
    w_valid = torch.ones(len(ends), dtype=torch.bool)
    gs, gx, gn = tk.window_lanes(ts_, tx, tn, torch.from_numpy(ends), w_valid,
                                 LO, HI, PPW, ROWS)
    np.testing.assert_array_equal(gx.numpy().view(np.int32), rx.view(np.int32))
    np.testing.assert_array_equal(gn.numpy().view(np.int32), rn.view(np.int32))
    assert np.isnan(gx.numpy()).any() and np.isnan(gn.numpy()).any()
    diff = np.abs(gs.numpy()[..., 0].astype(np.float64) - rs[..., 0])
    assert (diff <= sum_bound(sums, ENDS)).all()
    # fire_pack's lanes of the cells it selects are the same bits
    tc = torch.from_numpy(counts)
    buf, lanes = lk.fire_pack(tc, ts_, tx, tn, torch.from_numpy(ends),
                              w_valid, torch.from_numpy(used), LO, HI, PPW,
                              512, False)
    n = int(buf[0, 0])
    r = buf[1:n + 1, 0].long()
    w = torch.searchsorted(torch.from_numpy(ends), buf[1:n + 1, 1].long() + LO)
    grid = torch.cat([gs, gx, gn], dim=2)[r, w]
    np.testing.assert_array_equal(grid.numpy().view(np.int32),
                                  lanes[:n].numpy().view(np.int32))
    # an invalid window gets the identities
    w_valid[1] = False
    gs, gx, gn = tk.window_lanes(ts_, tx, tn, torch.from_numpy(ends), w_valid,
                                 LO, HI, PPW, ROWS)
    assert (gs[:, 1] == 0).all() and (gx[:, 1] == -np.inf).all() \
        and (gn[:, 1] == np.inf).all()


def port_ring(counts, sums, maxs, mins, used, ends, by, n, anchor, ring_buf,
              sel_cap):
    """The operator's lane route on a state: window_counts, window_lanes,
    the finalize on the grid, topn_select_lanes."""
    tc, ts_, tx, tn = tensors(counts, sums, maxs, mins)
    end_t = torch.from_numpy(ends)
    w_valid = torch.ones(len(ends), dtype=torch.bool)
    wc = wk.window_counts(tc, end_t, w_valid, LO, HI, PPW)
    s, x, m = tk.window_lanes(ts_, tx, tn, end_t, w_valid, LO, HI, PPW, ROWS)
    res = grid_agg(ta).finalize(s, x, m, wc)
    fields = sorted(f for f in res if f != "count")
    cols = torch.stack([res[f].to(torch.int32) if not torch.is_floating_point(
        res[f]) else res[f].to(torch.float32).view(torch.int32)
        for f in fields], dim=2).contiguous()
    return tk.topn_select_lanes(wc, res[by].to(torch.float32).contiguous(),
                                cols, torch.from_numpy(used), end_t, w_valid,
                                anchor, n, sel_cap,
                                torch.from_numpy(ring_buf.copy())).numpy()


def ref_ring(counts, sums, maxs, mins, used, ends, by, n, anchor, ring_buf,
             sel_cap):
    params = np.asarray([LO, HI, anchor] + list(ends) + [int(jw._END_SENTINEL)]
                        * (jw.MIN_FIRE_PAD - len(ends)), np.int64)
    return np.asarray(jw._JIT_RING_TOPN(
        jax_state(counts, sums, maxs, mins), jnp.asarray(ring_buf),
        jnp.asarray(params), jnp.asarray(used), agg=grid_agg(ja),
        panes_per_window=PPW, ring=RING, sel_cap=sel_cap, by=by, topn=n))


# result columns after [row, delta, count]: avg_a, max_a, min_b
EXACT_CASES = [("max_a", 1), ("min_b", 2), ("count", 2),
               ("count", 5)]


@pytest.mark.parametrize("by,n", EXACT_CASES)
def test_topn_select_lanes_plain_matches_ring_append_exactly(by, n):
    """Ranked by max, min or the count of a lane aggregate: the emit
    ring equal to the reference's, head and every data row (NaN
    thresholds, ±0 ties, wrap-around past the ring's end)."""
    counts, sums, maxs, mins, used = live_state(2 + n, specials=True)
    ends = np.array(ENDS, np.int64)
    ring_buf = np.zeros((64 + 2, 6), np.int32)
    ring_buf[0, 0] = 50  # appended so far: the rows wrap
    got = port_ring(counts, sums, maxs, mins, used, ends, by, n, LO - 3,
                    ring_buf, 256)
    want = ref_ring(counts, sums, maxs, mins, used, ends, by, n, LO - 3,
                    ring_buf, 256)
    assert got[0, 0] > 50 and got[0, 1] == 0
    # the reference's last row is its selection's scatter dump, which
    # the port reserves and never writes; the max/min columns compare
    # as f32 bits, the average column within its bound (not ranked on)
    np.testing.assert_array_equal(got[:-1, :3], want[:-1, :3])
    np.testing.assert_array_equal(got[:-1, 4:], want[:-1, 4:])
    ga, wa = (got[:-1, 3].view(np.float32).astype(np.float64),
              want[:-1, 3].view(np.float32).astype(np.float64))
    ok = (np.abs(ga - wa) <= 1e-4 * np.abs(wa)) | (ga == wa)
    assert ok.all()


def test_nan_threshold_selects_nothing_and_signed_zeros_tie():
    """By max, n = 1: the window holding a NaN max selects none of its
    rows; the window whose top is +0.0/-0.0 plus 9.0 keeps the tie at
    9.0 whatever the zero's sign."""
    counts, sums, maxs, mins, used = live_state(3, specials=True)
    ends = np.array(ENDS, np.int64)
    ring_buf = np.zeros((64 + 2, 6), np.int32)
    got = port_ring(counts, sums, maxs, mins, used, ends, "max_a", 1, LO,
                    ring_buf, 256)
    want = ref_ring(counts, sums, maxs, mins, used, ends, "max_a", 1, LO,
                    ring_buf, 256)
    np.testing.assert_array_equal(got[:-1, :3], want[:-1, :3])
    body = got[1:1 + got[0, 0]]
    # window 38 (delta 8) has the NaN: nothing of it was appended
    assert 38 - LO not in set(body[:, 1].tolist())
    w34 = body[body[:, 1] == 34 - LO]
    assert {3, 4} <= set(w34[:, 0].tolist())


@pytest.mark.parametrize("n", [1, 3])
def test_topn_by_average_follows_the_margin_rule(n):
    """Ranked by an average of f32 sums: per window, equal rows where
    the n-th and (n+1)-th reference values lie further apart than their
    bounds, picks among the tied rows where closer."""
    counts, sums, maxs, mins, used = live_state(20 + n, specials=False)
    # exact ties at the n-th place of every window: rows 5, 6 on top
    # (average 250), rows 9, 10 next (200), the same lanes in the same
    # live columns
    live = [p % RING for p in range(LO, HI + 1)]
    for r, val in ((5, 500.0), (6, 500.0), (9, 400.0), (10, 400.0)):
        counts[r, live] = 2
        sums[r, live, 0] = val
        used[r] = True
    ends = np.array(ENDS, np.int64)
    ring_buf = np.zeros((256 + 2, 6), np.int32)
    got = port_ring(counts, sums, maxs, mins, used, ends, "avg_a", n, LO,
                    ring_buf, 256)
    want = ref_ring(counts, sums, maxs, mins, used, ends, "avg_a", n, LO,
                    ring_buf, 256)
    # the reference's value of every cell, and its bound
    rs, _, _, rc = (np.asarray(a) for a in FIRE(
        jax_state(counts, sums, maxs, mins), jnp.asarray(ends),
        jnp.ones(len(ends), bool), jnp.asarray(LO), jnp.asarray(HI),
        panes_per_window=PPW, ring=RING))
    c = np.maximum(rc, 1).astype(np.float64)
    v = rs[..., 0].astype(np.float32) / c.astype(np.float32)
    bound = sum_bound(sums, ENDS) / c + 2 * U * np.abs(v)
    cand = (rc > 0) & used[:, None]

    def picks(ring):
        body = ring[1:1 + ring[0, 0]]
        return {w: set(body[body[:, 1] == e - LO, 0].tolist())
                for w, e in enumerate(ENDS)}

    gp, wp = picks(got), picks(want)
    tight = 0
    for w in range(len(ENDS)):
        rows = np.flatnonzero(cand[:, w])
        order = rows[np.argsort(-v[rows, w], kind="stable")]
        if len(order) <= n:
            assert gp[w] == wp[w] == set(order.tolist())
            continue
        t, u = order[n - 1], order[n]
        if v[t, w] - v[u, w] > bound[t, w] + bound[u, w]:
            assert gp[w] == wp[w]
        else:
            tight += 1
            tied = {r for r in rows
                    if v[r, w] >= v[t, w] - bound[r, w] - bound[t, w]}
            assert gp[w] <= tied and len(gp[w]) >= n
    assert tight == len(ENDS)  # the planted ties take the narrow branch


# -- the operator's lane route ---------------------------------------------------

LANE_AGG = lambda m: m.multi(m.count(), m.max_of("price"), m.min_of("price"),
                             m.avg_of("price"))


def op_pair(n, by, assigner=(1_000, None), **kw):
    size, slide = assigner
    args = dict(num_shards=8, slots_per_shard=64, top_n=(by, n), **kw)
    if slide is None:
        return (jw.WindowOperator(JaxTumbling.of(size), LANE_AGG(ja), **args),
                WindowOperator(TumblingEventTimeWindows.of(size),
                               LANE_AGG(ta), device="cpu", **args))
    return (jw.WindowOperator(JaxSliding.of(size, slide), LANE_AGG(ja), **args),
            WindowOperator(SlidingEventTimeWindows.of(size, slide),
                           LANE_AGG(ta), device="cpu", **args))


def assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=k)


def fire_both(ref, port, keys, ts, price, wm):
    data = {"price": np.asarray(price, np.float32)}
    ref.process_batch(np.asarray(keys), np.asarray(ts), data)
    port.process_batch(np.asarray(keys), np.asarray(ts), data)
    want = dict(ref.advance_watermark(wm))
    got = dict(port.advance_watermark(wm))
    assert_same(got, want)
    return got


def test_top_by_min_fewer_candidates_than_n_emits_all():
    ref, port = op_pair(2, "min_price")
    got = fire_both(ref, port, [1, 1, 1], [100, 200, 300], [5.0, 7.0, 6.0],
                    2_000)
    assert set(zip(got["key"].tolist(), got["min_price"].tolist())) == \
        {(1, 5.0)}


def test_top1_by_max_keeps_ties():
    ref, port = op_pair(1, "max_price")
    got = fire_both(ref, port, [1, 1, 1, 2, 2, 3, 4], [100] * 7,
                    [3.0, 9.0, 1.0, 9.0, 2.0, 8.0, -0.0], 2_000)
    assert set(zip(got["key"].tolist(), got["max_price"].tolist())) == \
        {(1, 9.0), (2, 9.0)}


def test_top2_by_min_across_windows():
    ref, port = op_pair(2, "min_price")
    got = fire_both(ref, port, [1, 1, 2, 2, 3, 4, 5, 5],
                    [0, 1, 2, 3, 4, 1_500, 1_501, 1_502],
                    [4.0, 1.0, 2.0, 8.0, 3.0, 0.0, -0.0, 6.0], 3_000)
    # window 1: mins 1, 2, 3 → {3: 3.0, 2: 2.0}; window 2: -0.0 and 0.0
    # tie at the top, both kept
    assert {(int(k), int(e)) for k, e in zip(got["key"], got["window_end"])} \
        == {(3, 1_000), (2, 1_000), (4, 2_000), (5, 2_000)}


def test_top1_by_count_of_a_lane_aggregate_keeps_ties():
    ref, port = op_pair(1, "count")
    got = fire_both(ref, port, [1, 1, 1, 2, 2, 2, 3], [100] * 7,
                    np.arange(7.0), 2_000)
    assert set(zip(got["key"].tolist(), got["count"].tolist())) == \
        {(1, 3), (2, 3)}
    assert not port._fused_ok()


def test_tie_explosion_raises_loudly():
    ref, port = op_pair(1, "max_price")
    nk = port._topn_cap() + 40
    keys, ts, price = np.arange(nk), np.full(nk, 100), np.ones(nk)
    for op in (ref, port):
        op.process_batch(keys, ts, {"price": price.astype(np.float32)})
        with pytest.raises(RuntimeError, match="truncation"):
            op.advance_watermark(2_000).materialize()


@pytest.mark.parametrize("by,n", [("max_price", 1), ("avg_price", 2)])
def test_sliding_stream_with_nan_and_signed_zeros(by, n):
    """Sliding 4 s / 1 s over six batches: rows equal in order after
    every advance (integer prices, so the averages are exact too), with
    NaN, inf and ±0 in one batch; the emit ring is 3 + F wide."""
    ref, port = op_pair(n, by, (4_000, 1_000), max_out_of_orderness_ms=1_000)
    rng = np.random.default_rng(1)
    rows = 0
    for i in range(6):
        keys = rng.integers(0, 40, 200)
        ts = i * 1_000 + rng.integers(0, 1_500, 200)
        price = rng.integers(0, 50, 200).astype(np.float32)
        if i == 2:
            price[:4] = [np.nan, -0.0, 0.0, np.inf]
        if i == 4:
            price[:3] = [-0.0, 0.0, 0.0]
        rows += len(fire_both(ref, port, keys, ts, price, i * 1_000)["key"])
    want = dict(ref.advance_watermark(ref.final_watermark()))
    got = dict(port.advance_watermark(port.final_watermark()))
    assert_same(got, want)
    assert rows + len(got["key"]) > 10
    assert port._emit_ring.shape[1] == 3 + 3


def test_snapshot_restores_into_a_twin_and_loads_the_reference():
    """A lane top-n operator snapshotted mid-stream: its own snapshot in
    a fresh operator and the reference's snapshot loaded into another
    both continue with the reference's rows."""
    ref, port = op_pair(2, "max_price", (2_000, 1_000))
    rng = np.random.default_rng(4)
    steps = []
    for i in range(5):
        steps.append((rng.integers(0, 30, 150), i * 1_000
                      + rng.integers(0, 1_000, 150),
                      rng.integers(0, 99, 150).astype(np.float32), i * 1_000))
    for keys, ts, price, wm in steps[:3]:
        fire_both(ref, port, keys, ts, price, wm)
    snap = port.snapshot_state()
    jsnap = ref.snapshot_state()
    jsnap["panes"] = jax.tree_util.tree_map(np.asarray, jsnap["panes"])
    twins = [op_pair(2, "max_price", (2_000, 1_000))[1] for _ in range(2)]
    twins[0].restore_state(snap)
    twins[1].load_jax_snapshot(jsnap)
    for keys, ts, price, wm in steps[3:] + [(np.zeros(0, np.int64),
                                             np.zeros(0, np.int64),
                                             np.zeros(0, np.float32), 10_000)]:
        data = {"price": price}
        ref.process_batch(keys, ts, data)
        want = dict(ref.advance_watermark(wm))
        for t in twins:
            t.process_batch(keys, ts, data)
            assert_same(dict(t.advance_watermark(wm)), want)


def test_emit_ring_overflow_raises_loudly():
    _, port = op_pair(3, "max_price")
    port.EMIT_RING_ROWS = 8
    keys = np.arange(40)
    # ten windows of four keys: 30 winners between two drains
    port.process_batch(keys, keys * 250, {"price": keys.astype(np.float32)})
    with pytest.raises(RuntimeError, match="emit ring overflow"):
        port.advance_watermark(12_000).materialize()


def _constexpr(text, name):
    import re
    return int(re.search(rf"constexpr (?:int|int64_t) {name} = ([\d *]+);",
                         text).group(1).replace(" ", "").split("*")[0])


def test_wrapper_constants_match_the_kernel_sources():
    """The wrappers' copies of the kernels' launch constants, read from
    the CUDA sources: the compaction tile the bucketing scratch is sized
    by, the row tile the count-window fire's workspace is sized by (its
    threads a block times its rows a thread), and window_lanes' windows a
    block and staged tile."""
    import os

    from flink_tpu_torch.kernels import count_window_kernels as cw
    from flink_tpu_torch.kernels import exchange_kernels as xk

    csrc = os.path.join(os.path.dirname(tk.__file__), "csrc")
    with open(os.path.join(csrc, "window_common.cuh")) as f:
        common = f.read()
    with open(os.path.join(csrc, "topn_lanes_kernels.cu")) as f:
        cu = f.read()
    with open(os.path.join(csrc, "count_window_kernels.cu")) as f:
        cw_cu = f.read()
    tile = _constexpr(common, "kThreads") * _constexpr(common, "kItems")
    assert "constexpr int kTile = kThreads * kItems;" in common
    assert tile == xk.BUCKET_TILE
    assert "constexpr int kFireTile = kThreads * kFireRowItems;" in cw_cu
    assert _constexpr(common, "kThreads") \
        * _constexpr(cw_cu, "kFireRowItems") == cw.FIRE_TILE
    assert _constexpr(cu, "kLanesWindows") == tk._LANES_WINDOWS
    assert _constexpr(cu, "kLanesSmemFloats") == tk._LANES_SMEM_FLOATS


@pytest.mark.parametrize("ring,W,L", [(32, 11, 2), (1, 11, 3), (64, 64, 6),
                                      (1100, 1, 210), (1100, 64, 210),
                                      (32, 1, 1), (5000, 3, 70)])
def test_window_lanes_plan_fits_the_kernel(ring, W, L):
    """Every plan stays inside the kernel's tables: at most 64 windows a
    block, 256 outputs a block (one a thread), a staged tile of the
    plan's rows within the shared memory it reserves, and chunks that
    cover the ring."""
    p = tk._lanes_plan(ring, W, L)
    assert 1 <= p.win_group <= min(W, tk._LANES_WINDOWS)
    assert 1 <= p.lane_group <= L
    assert p.tile_rows * p.win_group * p.lane_group <= 256
    assert p.tile_rows * (p.col_chunk * p.lane_group + 3) \
        <= tk._LANES_SMEM_FLOATS
    assert 1 <= p.col_chunk <= ring
