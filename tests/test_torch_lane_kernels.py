"""Parity of the port's lane kernels (``fire_pack``, ``scatter_lanes``,
``scatter_pair_lanes``, and ``ring_columns`` over f32 lanes) with the JAX
functions they replace (flink_tpu/ops/window.py), run as the JAX tests
run them (CPU XLA). The wrappers take their plain PyTorch versions here,
because the tensors lie on the CPU; tests/test_torch_cuda.py holds the
CUDA kernels against the same plain versions on the card.

Integers, row order, and max/min lanes (NaN and signed zeros included)
must be exactly equal. An f32 sum must lie within the error bound of
adding the same terms in another order: |port - ref| <= 2 * n * 2^-24 *
sum(|terms|) for n terms. (The scatters add in the reference's order on
the CPU; the reference's jitted fire lets XLA's GEMM pick its order by
shape. The bound counts on neither.)"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import aggregates as ja
from flink_tpu.ops import window as jw
from flink_tpu.state.keyed import PaneState as JaxPaneState
from flink_tpu_torch.kernels import lane_kernels as lk
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops import aggregates as ta
from test_torch_threads import capped_torch_threads  # noqa: F401

U = 2.0 ** -24


def assert_sums_within(got, ref, abs_terms, n_terms):
    """The sum bound of the module docstring, elementwise."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    both_nan = np.isnan(got) & np.isnan(ref)
    bound = 2.0 * np.asarray(n_terms, np.float64) * U * np.asarray(
        abs_terms, np.float64)
    ok = both_nan | (np.abs(got - ref) <= bound) | (got == ref)
    assert ok.all(), (got[~ok][:5], ref[~ok][:5], bound[~ok][:5])


def _live_state(rng, rows, ring, pane_lo, pane_hi, sw, mw, nw,
                specials=False):
    """Pane state obeying the operator's ring invariant: only the columns
    of live panes [pane_lo, pane_hi] hold data; the others hold the lane
    identities."""
    counts = np.zeros((rows, ring), np.int32)
    sums = np.zeros((rows, ring, sw), np.float32)
    maxs = np.full((rows, ring, mw), -np.inf, np.float32)
    mins = np.full((rows, ring, nw), np.inf, np.float32)
    for p in range(pane_lo, pane_hi + 1):
        c = p % ring
        hit = rng.random(rows) < 0.5
        counts[hit, c] = rng.integers(1, 9, int(hit.sum()))
        k = int(hit.sum())
        sums[hit, c] = (rng.standard_normal((k, sw)) * 100).astype(np.float32)
        maxs[hit, c] = rng.standard_normal((k, mw)).astype(np.float32)
        mins[hit, c] = rng.standard_normal((k, nw)).astype(np.float32)
    if specials:
        live = [p % ring for p in range(pane_lo, pane_hi + 1)]
        maxs[1, live[0]] = np.nan
        mins[2, live[-1]] = np.nan
        maxs[3, live] = 0.0
        maxs[3, live[1]] = -0.0
        mins[4, live] = -0.0
        mins[4, live[1]] = 0.0
        counts[1:5, live[0]] = np.maximum(counts[1:5, live[0]], 1)
    return counts, sums, maxs, mins


def _tensors(*arrs):
    return [None if a is None or (a.ndim == 3 and a.shape[2] == 0)
            else torch.from_numpy(np.ascontiguousarray(a).copy()) for a in arrs]


JAX_AGGS = {
    "count": ja.count(),
    "lanes": ja.multi(ja.count(), ja.sum_of("a"), ja.sum_of("b"),
                      ja.max_of("a"), ja.min_of("b")),
}
PORT_AGGS = {
    "count": ta.count(),
    "lanes": ta.multi(ta.count(), ta.sum_of("a"), ta.sum_of("b"),
                      ta.max_of("a"), ta.min_of("b")),
}


def _fire_both(kind, counts, sums, maxs, mins, used, ends, pane_lo, pane_hi,
               ppw, cap, packed2):
    ring = counts.shape[1]
    jagg = JAX_AGGS[kind]
    pad = [int(jw._END_SENTINEL)] * (max(len(ends), jw.MIN_FIRE_PAD)
                                     - len(ends))
    params = np.asarray([pane_lo, pane_hi, 0] + list(ends) + pad, np.int64)
    st = JaxPaneState(*(None if a.shape[-1] == 0 and a.ndim == 3
                        else jnp.asarray(a)
                        for a in (sums, maxs, mins)), jnp.asarray(counts))
    # jitted, as the reference operator runs it
    ref = np.asarray(jw._JIT_FIRE_PACK(
        st, jnp.asarray(params), jnp.asarray(used), agg=jagg,
        panes_per_window=ppw, ring=ring, out_cap=cap, packed2=packed2))
    tc, ts_, tm, tn = _tensors(counts, sums, maxs, mins)
    buf, lanes = lk.fire_pack(tc, ts_, tm, tn, torch.tensor(ends),
                              torch.ones(len(ends), dtype=torch.bool),
                              torch.from_numpy(used), pane_lo, pane_hi, ppw,
                              cap, packed2)
    return ref, buf.numpy(), lanes


# (ring, pane_lo, pane_hi, ends, ppw): sliding 10/1 with a ring wrap,
# tumbling (ppw 1), sliding 4/2, windows reaching past the live range
FIRE_CASES = [
    (16, 30, 41, [33, 34, 35, 38], 4),
    (16, 27, 38, [31, 33, 35, 37], 4),
    (32, 1000, 1020, [1011, 1012, 1013, 1014], 10),
    (8, 61, 66, [62, 63, 64, 65], 1),
    (6, 4, 8, [5, 6, 7, 8], 1),
    (16, 40, 47, [42, 44, 46, 48], 4),
    (16, 40, 47, [41, 49, 52], 10),
]


@pytest.mark.parametrize("case", range(len(FIRE_CASES)))
def test_fire_pack_packed2_matches_reference(case):
    """Count-only: the packed2 layout, rows equal in order."""
    ring, lo, hi, ends, ppw = FIRE_CASES[case]
    rng = np.random.default_rng(case)
    rows = 41
    counts, sums, maxs, mins = _live_state(rng, rows, ring, lo, hi, 0, 0, 0)
    used = rng.random(rows) < 0.8
    used[-1] = False
    cap = 256
    ref, got, lanes = _fire_both("count", counts, sums, maxs, mins, used,
                                 ends, lo, hi, ppw, cap, True)
    n = int(ref[0, 0])
    assert n > 0 and int(got[0, 0]) == n and lanes is None
    np.testing.assert_array_equal(got[:n + 1], ref[:n + 1])


@pytest.mark.parametrize("case", range(len(FIRE_CASES)))
def test_fire_pack_lanes_match_reference(case):
    """Count + sum/max/min lanes: rows equal in order, max/min exact, sums
    within the bound; NaN and signed zeros in the max/min lanes."""
    ring, lo, hi, ends, ppw = FIRE_CASES[case]
    rng = np.random.default_rng(100 + case)
    rows = 41
    counts, sums, maxs, mins = _live_state(rng, rows, ring, lo, hi, 2, 1, 1,
                                           specials=True)
    used = rng.random(rows) < 0.8
    used[[1, 2, 3, 4]] = True
    used[-1] = False
    cap = 256
    ref, got, lanes = _fire_both("lanes", counts, sums, maxs, mins, used,
                                 ends, lo, hi, ppw, cap, False)
    n = int(ref[0, 0])
    assert n > 0 and int(got[0, 0]) == n
    np.testing.assert_array_equal(got[:n + 1], ref[:n + 1, :3])
    res = PORT_AGGS["lanes"].finalize(lanes[:, :2], lanes[:, 2:3],
                                      lanes[:, 3:4], torch.from_numpy(got[1:, 2]))
    fields = [k for k in sorted(res) if k != "count"]
    assert fields == ["max_a", "min_b", "sum_a", "sum_b"]
    r = got[1:n + 1, 0]
    for j, k in enumerate(fields):
        want = ref[1:n + 1, 3 + j].view(np.float32)
        have = res[k][:n].numpy()
        if k.startswith("sum"):
            s = ["sum_a", "sum_b"].index(k)
            abs_terms = np.abs(sums[r, :, s]).sum(axis=1)
            assert_sums_within(have, want, abs_terms, ring)
        else:
            np.testing.assert_array_equal(have, want)


def test_fire_pack_unused_rows_and_cap_overflow():
    """Rows off the used mask never fire; more selected rows than the cap
    keep the first cap rows and count all in the head (as the
    reference)."""
    rng = np.random.default_rng(7)
    rows, ring = 33, 16
    counts, sums, maxs, mins = _live_state(rng, rows, ring, 10, 15, 0, 0, 0)
    counts[:, 10 % ring] = 1
    used = np.ones(rows, bool)
    used[::3] = False
    used[-1] = False
    ref, got, _ = _fire_both("count", counts, sums, maxs, mins, used,
                             [12, 13, 14, 15], 10, 15, 2, 16, False)
    n = int(ref[0, 0])
    assert n > 16 and int(got[0, 0]) == n
    np.testing.assert_array_equal(got, ref)
    assert not np.isin(got[1:, 0], np.flatnonzero(~used)).any()


# -- scatter_lanes ---------------------------------------------------------------

def _specials(a, b):
    a[5] = np.nan
    a[100:110] = -0.0
    b[7] = -0.0
    b[8] = 0.0
    b[9] = np.nan
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_lanes_matches_apply_kernel(seed):
    """Per-record lanes into (rows, ring) state with hot cells: counts and
    max/min exact (NaN, -0/+0 included), sums within the bound."""
    rng = np.random.default_rng(seed)
    rows, ring, B = 65, 16, 4096
    counts, sums, maxs, mins = _live_state(rng, rows, ring, 0, 15, 2, 1, 1)
    cells = rows * ring - ring          # the dump row takes nothing
    idx = np.where(rng.random(B) < 0.3, rng.integers(0, 5, B),
                   rng.integers(0, cells, B)).astype(np.int32)
    a = (rng.standard_normal(B) * 50).astype(np.float32)
    b = rng.standard_normal(B).astype(np.float32)
    if seed == 0:
        a, b = _specials(a, b)
    jagg, tagg = JAX_AGGS["lanes"], PORT_AGGS["lanes"]
    ref = jw.apply_kernel(
        JaxPaneState(jnp.asarray(sums), jnp.asarray(maxs), jnp.asarray(mins),
                     jnp.asarray(counts)), jnp.asarray(idx),
        {"a": jnp.asarray(a), "b": jnp.asarray(b)}, agg=jagg, ring=ring,
        dump_row=rows - 1)
    tc, ts_, tm, tn = _tensors(counts, sums, maxs, mins)
    s, mx, mn = tagg.lift_masked({"a": torch.from_numpy(a),
                                  "b": torch.from_numpy(b)},
                                 torch.ones(B, dtype=torch.bool))
    lk.scatter_lanes(tc, ts_, tm, tn, torch.from_numpy(idx), s, mx, mn)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(ref.maxs))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(ref.mins))
    lifted = np.stack([a, b], axis=1).astype(np.float64)
    abs_terms = np.abs(sums.reshape(-1, 2)).astype(np.float64)
    n_terms = np.ones(rows * ring)
    np.add.at(abs_terms, idx, np.abs(lifted))
    np.add.at(n_terms, idx, 1)
    assert_sums_within(ts_.numpy().reshape(-1, 2),
                       np.asarray(ref.sums).reshape(-1, 2), abs_terms,
                       n_terms[:, None])


def test_scatter_lanes_signed_zero_and_nan_order():
    """Max/min of -0/+0 and NaN arriving in every order at one cell match
    the reference's IEEE maximum/minimum."""
    vals = np.array([-0.0, 0.0, -0.0, 1.0, np.nan, -1.0], np.float32)
    agg = ja.multi(ja.max_of("v"), ja.min_of("v"))
    # the reference's apply, compiled once a batch length
    apply = jax.jit(functools.partial(jw.apply_kernel, agg=agg, ring=1,
                                      dump_row=1))
    for order in ([0, 1], [1, 0], [0, 2], [1, 1], [4, 3], [3, 4], [5, 0, 1],
                  [1, 5, 0], [2, 4, 5]):
        v = vals[order]
        idx = np.zeros(len(v), np.int32)
        for init in (-np.inf, -0.0, 0.0):
            st = JaxPaneState(None, jnp.full((2, 1, 1), init, jnp.float32),
                              jnp.full((2, 1, 1), -init, jnp.float32),
                              jnp.zeros((2, 1), jnp.int32))
            ref = apply(st, jnp.asarray(idx), {"v": jnp.asarray(v)})
            tm = torch.full((2, 1, 1), init)
            tn = torch.full((2, 1, 1), -init)
            tc = torch.zeros((2, 1), dtype=torch.int32)
            x = torch.from_numpy(v)[:, None]
            lk.scatter_lanes(tc, None, tm, tn, torch.from_numpy(idx),
                             torch.zeros((len(v), 0)), x, x)
            for got, want in ((tm, ref.maxs), (tn, ref.mins)):
                got, want = got.numpy(), np.asarray(want)
                assert np.array_equal(np.isnan(got), np.isnan(want))
                ok = ~np.isnan(want)
                np.testing.assert_array_equal(got[ok].view(np.int32),
                                              want[ok].view(np.int32))


def test_scatter_lanes_index_outside_state_raises():
    c = torch.zeros((3, 4), dtype=torch.int32)
    s = torch.zeros((3, 4, 1))
    with pytest.raises(IndexError, match="scatter_lanes"):
        lk.scatter_lanes(c, s, None, None, torch.tensor([0, 12], dtype=torch.int32),
                         torch.zeros((2, 1)), torch.zeros((2, 0)),
                         torch.zeros((2, 0)))


# -- scatter_pair_lanes ------------------------------------------------------------

@pytest.mark.parametrize("sw", [1, 2])
def test_scatter_pair_lanes_matches_apply_preagg_i32(sw):
    """Host-combined pair rows with padding: counts exact, sums within
    the bound of one add per cell."""
    rng = np.random.default_rng(sw)
    rows, ring, P = 257, 16, 900
    counts, sums, _, _ = _live_state(rng, rows, ring, 0, 15, sw, 0, 0)
    pairs = rng.choice((rows - 1) * ring, P, replace=False).astype(np.int32)
    cnts = rng.integers(1, 40, P).astype(np.int32)
    lanes = [(rng.standard_normal(P) * 1e3).astype(np.float32)
             for _ in range(sw)]
    lanes[0][:3] = [-0.0, 0.0, np.nan]
    buf = jw.preagg_encode_i32(pairs, cnts, lanes, 1024)
    ref = jw.apply_preagg_i32_kernel(
        JaxPaneState(jnp.asarray(sums), None, None, jnp.asarray(counts)),
        jnp.asarray(buf), sum_width=sw, ring=ring, dump_row=rows - 1)
    tc, ts_ = _tensors(counts, sums)
    lk.scatter_pair_lanes(tc, ts_, torch.from_numpy(buf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(ref.counts))
    got = ts_.numpy().reshape(-1, sw)
    want = np.asarray(ref.sums).reshape(-1, sw)
    abs_terms = np.abs(sums.reshape(-1, sw)).astype(np.float64)
    for i in range(sw):
        abs_terms[pairs, i] += np.abs(lanes[i])
    assert_sums_within(got, want, abs_terms, 2)


def test_port_encode_matches_reference_layout():
    """The port's pre-combine and encode give the reference's buffer rows
    (without its pow2 padding) bit for bit."""
    from flink_tpu_torch.ops.window import preagg_combine, preagg_encode_i32

    rng = np.random.default_rng(4)
    n, ring = 5000, 16
    slots = rng.integers(0, 300, n)
    cols = rng.integers(0, ring, n)
    valid = rng.random(n) < 0.9
    data = {"p": (rng.random(n) * 1e4).astype(np.float32),
            "q": rng.standard_normal(n)}
    rp, rc, rl = jw.preagg_combine(slots, cols, valid, data, ("p", "q"),
                                   ring=ring, domain=300 * ring)
    pp, pc, pl = preagg_combine(slots, cols, valid, ring, data, ("p", "q"))
    ref = jw.preagg_encode_i32(rp, rc, rl, len(rp))
    np.testing.assert_array_equal(preagg_encode_i32(pp, pc, pl), ref)


def test_scatter_pair_lanes_pair_outside_state_raises():
    c = torch.zeros((3, 4), dtype=torch.int32)
    s = torch.zeros((3, 4, 1))
    buf = torch.tensor([[-1, 0, 0], [12, 1, 0]], dtype=torch.int32)
    with pytest.raises(IndexError, match="scatter_pair_lanes"):
        lk.scatter_pair_lanes(c, s, buf)


# -- ring_columns over f32 lanes ----------------------------------------------------

def test_ring_columns_lanes_match_clear_and_remap():
    """The purge (clear_kernel) and a 16 -> 32 growth (ring_remap_kernel)
    over every lane, each with its identity fill: exact."""
    rng = np.random.default_rng(9)
    rows = 20
    counts, sums, maxs, mins = _live_state(rng, rows, 16, 30, 40, 2, 1, 3)
    st = JaxPaneState(jnp.asarray(sums), jnp.asarray(maxs), jnp.asarray(mins),
                      jnp.asarray(counts))
    clear = np.zeros(64, np.int32)
    clear[[30 % 16, 31 % 16, 32 % 16]] = 1
    ref = jw.clear_kernel(st, jnp.asarray(clear))
    keep = torch.from_numpy(clear[:16] == 0)
    ident = torch.arange(16, dtype=torch.int32)
    fills = (0.0, -np.inf, np.inf, 0)
    for lane, fill, want in zip(_tensors(sums, maxs, mins, counts), fills,
                                (ref.sums, ref.maxs, ref.mins, ref.counts)):
        wk.ring_columns(lane, lane, ident, keep, fill)
        np.testing.assert_array_equal(lane.numpy(), np.asarray(want))
    cmap = np.full(32, -1, np.int64)
    ps = np.arange(30, 41)
    cmap[ps % 32] = ps % 16
    src = np.maximum(cmap, 0).astype(np.int32)
    ref = jw.ring_remap_kernel(st, jnp.asarray(src), jnp.asarray(cmap >= 0))
    for lane, fill, want in zip(_tensors(sums, maxs, mins, counts), fills,
                                (ref.sums, ref.maxs, ref.mins, ref.counts)):
        dst = torch.empty((rows, 32) + tuple(lane.shape[2:]), dtype=lane.dtype)
        wk.ring_columns(lane, dst, torch.from_numpy(src),
                        torch.from_numpy(cmap >= 0), fill)
        np.testing.assert_array_equal(dst.numpy(), np.asarray(want))


# -- ring_columns_block: every lane of a state block in one call ---------------

# the reference's purge, growth and pair fold jitted once a shape, as its
# operator runs them (without donation, which the CPU does not take)
CLEAR = jax.jit(jw.clear_kernel)
REMAP = jax.jit(jw.ring_remap_kernel)
PREAGG_I32 = jax.jit(jw.apply_preagg_i32_kernel,
                     static_argnames=("sum_width", "ring", "dump_row"))

def _jax_block(counts, sums, maxs, mins):
    return JaxPaneState(jnp.asarray(sums), jnp.asarray(maxs), jnp.asarray(mins),
                        jnp.asarray(counts))


def _assert_block_equals(lanes, ref):
    """Every lane bit for bit (NaN payloads and signed zeros included)."""
    for got, want in zip(lanes, (ref.sums, ref.maxs, ref.mins, ref.counts)):
        g, w = got.numpy(), np.asarray(want)
        assert g.shape == w.shape
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("ring", [16, 32])
def test_ring_columns_block_purge_matches_clear_kernel(ring, width):
    """The purge of a four-lane state block in one call == clear_kernel on
    every lane (exact): a cleared run of 7 columns that wraps past the
    ring's end, NaN and -0.0 in kept cells."""
    rng = np.random.default_rng(ring + width)
    pane_lo = 3 * ring - 3                       # column ring - 3
    arrs = _live_state(rng, 33, ring, pane_lo, pane_lo + ring - 2, width,
                       width, width, specials=True)
    clear = np.zeros(64, np.int32)
    clear[np.arange(pane_lo, pane_lo + 7) % ring] = 1     # ring-3 .. 3
    ref = CLEAR(_jax_block(*arrs), jnp.asarray(clear))
    tc, ts_, tm, tn = _tensors(*arrs)
    lanes = (ts_, tm, tn, tc)
    out = wk.ring_columns_block(lanes, lanes, torch.arange(ring, dtype=torch.int32),
                                torch.from_numpy(clear[:ring] == 0))
    assert out is lanes
    _assert_block_equals(lanes, ref)


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("old_ring,new_ring", [(6, 16), (16, 32)])
def test_ring_columns_block_growth_matches_ring_remap(old_ring, new_ring,
                                                      width):
    """A growth of a four-lane state block into new tensors in one call ==
    ring_remap_kernel on every lane (exact): each live pane p moves from
    column p % old to p % new, the rest take the identities."""
    rng = np.random.default_rng(old_ring * width)
    lo = 5 * old_ring + 2
    hi = lo + old_ring - 2
    arrs = _live_state(rng, 33, old_ring, lo, hi, width, width, width,
                       specials=True)
    cmap = np.full(new_ring, -1, np.int64)
    ps = np.arange(lo, hi + 1)
    cmap[ps % new_ring] = ps % old_ring
    src = np.maximum(cmap, 0).astype(np.int32)
    ref = REMAP(_jax_block(*arrs), jnp.asarray(src), jnp.asarray(cmap >= 0))
    tc, ts_, tm, tn = _tensors(*arrs)
    lanes = (ts_, tm, tn, tc)
    dst = tuple(torch.full((33, new_ring) + tuple(t.shape[2:]), 7,
                           dtype=t.dtype) for t in lanes)
    out = wk.ring_columns_block(lanes, dst, torch.from_numpy(src),
                                torch.from_numpy(cmap >= 0))
    assert out is dst
    _assert_block_equals(dst, ref)


def test_ring_columns_block_rejects_mixed_lanes():
    """Every lane in place or none; src and dst name the same lanes; a
    bad kept column raises before any lane moves."""
    c = torch.zeros((3, 4), dtype=torch.int32)
    s = torch.zeros((3, 4, 1))
    ident = torch.arange(4, dtype=torch.int32)
    keep = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="in place or none"):
        wk.ring_columns_block((s, None, None, c), (torch.zeros_like(s), None,
                                                   None, c), ident, keep)
    with pytest.raises(ValueError, match="different lanes"):
        wk.ring_columns_block((s, None, None, c), (None, None, None, c),
                              ident, keep)
    with pytest.raises(TypeError):
        wk.ring_columns_block((s.double(), None, None, c),
                              (s.double(), None, None, c), ident, keep)
    bad = ident.clone()
    bad[2] = 4
    c[:] = 5
    with pytest.raises(IndexError, match="ring_columns"):
        wk.ring_columns_block((s, None, None, c), (s, None, None, c), bad, keep)
    assert int(c.sum()) == 5 * 12


# -- scatter_pair_lanes on both row orders --------------------------------------

@pytest.mark.parametrize("order", ["shuffled", "ascending"])
@pytest.mark.parametrize("sw", [0, 1, 4])
def test_scatter_pair_lanes_row_orders_match_apply_preagg_i32(sw, order):
    """Pair rows in the C combine's first-seen (here shuffled) order and in
    the numpy lane's ascending order, with padding rows: counts exact,
    sums within the bound of one add per cell."""
    rng = np.random.default_rng(10 * sw + (order == "ascending"))
    rows, ring, P = 129, 16, 700
    counts, sums, _, _ = _live_state(rng, rows, ring, 0, 15, sw, 0, 0)
    pairs = rng.choice((rows - 1) * ring, P, replace=False).astype(np.int32)
    if order == "ascending":
        pairs.sort()
    cnts = rng.integers(1, 40, P).astype(np.int32)
    lanes = [(rng.standard_normal(P) * 1e3).astype(np.float32)
             for _ in range(sw)]
    buf = jw.preagg_encode_i32(pairs, cnts, lanes, 768)
    ref = PREAGG_I32(
        JaxPaneState(jnp.asarray(sums) if sw else None, None, None,
                     jnp.asarray(counts)),
        jnp.asarray(buf), sum_width=sw, ring=ring, dump_row=rows - 1)
    tc, ts_ = _tensors(counts, sums)
    lk.scatter_pair_lanes(tc, ts_, torch.from_numpy(buf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(ref.counts))
    if not sw:
        assert ts_ is None
        return
    abs_terms = np.abs(sums.reshape(-1, sw)).astype(np.float64)
    for i in range(sw):
        abs_terms[pairs, i] += np.abs(lanes[i])
    assert_sums_within(ts_.numpy().reshape(-1, sw),
                       np.asarray(ref.sums).reshape(-1, sw), abs_terms, 2)


def test_scatter_pair_lanes_rejects_bad_inputs():
    """The lean path's one combined test falls back to the checks one by
    one, each with its own message."""
    c = torch.zeros((3, 4), dtype=torch.int32)
    s = torch.zeros((3, 4, 1))
    with pytest.raises(TypeError):
        lk.scatter_pair_lanes(c, s, torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="columns"):
        lk.scatter_pair_lanes(c, s, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        lk.scatter_pair_lanes(c, torch.zeros((3, 5, 1)),
                              torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        lk.scatter_pair_lanes(c, s, torch.zeros((3, 2), dtype=torch.int32).T)
