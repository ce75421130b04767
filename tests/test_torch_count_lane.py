"""The count lane's kernels as the card runs them, mirrored on the CPU:
``window_counts`` (K2), ``scatter_counts`` per record (K1) and the split
upload's one-launch count (``scatter_split_counts``).

The kernels run only on the card (``tests/test_torch_cuda.py`` holds them
bit for bit against their plain versions there). Here: the plain
versions and the wrappers' CPU path against the JAX package exactly
(integer sums do not depend on order); the launch plans
(``window_counts_plan``, ``count_plan``) and the per-record kernel's
division by the ring (``fast_div``, mirrored here) against the constants
and code of ``csrc/window_fire.cuh`` and ``csrc/window_kernels.cu``;
and numpy mirrors of the two kernels' algorithms — K2's window table,
staged prefix segments and window passes, K1's chunks and reference
column — at those plans, against the plain versions."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import window as jw
from flink_tpu.ops.aggregates import count as jax_count
from flink_tpu.state.keyed import PaneState as JaxPaneState
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops.window import split_encode
from test_torch_threads import capped_torch_threads  # noqa: F401

CSRC = os.path.join(os.path.dirname(wk.__file__), "csrc")
FIRE = jax.jit(jw.fire_kernel, static_argnames=("panes_per_window", "ring"))
SPLIT = jax.jit(jw.apply_kernel_split, static_argnames=("agg", "dump_row"))
SENTINEL = int(jw._END_SENTINEL)


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constexpr(text, name):
    m = re.search(rf"constexpr (?:int|int32_t|int64_t) {name} = ([^;]+);", text)
    return m.group(1).strip()


def _jax_state(counts):
    return JaxPaneState(None, None, None, jnp.asarray(counts))


# -- the plans against the sources -------------------------------------------

def test_plan_constants_match_the_sources():
    fire = _source("window_fire.cuh")
    assert int(_constexpr(fire, "kWcThreads")) == wk.WC_THREADS
    assert int(_constexpr(fire, "kWcRows")) == wk.WC_ROWS
    # a prefix thread a tile row; the stage's chunk columns divide the
    # threads
    assert wk.WC_ROWS <= wk.WC_THREADS and wk.WC_THREADS % 32 == 0
    assert int(_constexpr(fire, "kWcWindows")) == wk.WC_WINDOWS
    assert int(_constexpr(fire, "kWcSmemWords")) == wk.WC_SMEM_WORDS
    # the launch opts in to its dynamic shared memory, inside the card's
    # 227 KB a block
    assert 4 * wk.WC_SMEM_WORDS <= 232_448
    cu = _source("window_kernels.cu")
    assert int(_constexpr(cu, "kCountThreads")) == wk.COUNT_THREADS
    assert int(_constexpr(cu, "kCountMaxChunk")) == wk.COUNT_MAX_CHUNK
    assert int(_constexpr(cu, "kHistMaxRows")) == wk.HIST_MAX_ROWS
    assert int(_constexpr(cu, "kCountBlocks")) == wk.COUNT_BLOCKS
    # the histogram's opt-in covers the largest one, inside the card's
    # 227 KB a block
    assert 16 * ((wk.HIST_MAX_ROWS + 7) // 8) <= 232_448
    assert "16 * ((kHistMaxRows + 7) / 8)" in cu
    # the packed launch blocks: one word an argument of the C entries
    for fn, entry in (("fk_scatter_counts", wk._SCATTER_COUNTS),
                      ("fk_scatter_split_counts", wk._SCATTER_SPLIT_COUNTS),
                      ("fk_window_counts", wk._WINDOW_COUNTS)):
        sig = re.search(rf"int {fn}\((.*?)\) \{{", cu, re.S).group(1)
        assert sig.count(",") == entry._struct.size // 8, fn


RINGS = [1, 6, 16, 32, 37, 64, 105, 256, 1100, 24_500, 65_536]
WINDOWS = [1, 11, 16, 64, 65, 200]


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("W", WINDOWS)
def test_window_counts_plan_fits_the_kernel(ring, W):
    """Every plan stays inside the block's shared memory: at most kWcRows
    rows a tile (a prefix thread each), an odd prefix stride, a table
    pass of at most kWcWindows windows, and one segment whenever a tile
    holds more than one row."""
    p = wk.window_counts_plan(32_769, ring, W)
    assert 1 <= p.tile_rows <= wk.WC_ROWS
    assert p.tile_rows & (p.tile_rows - 1) == 0
    assert p.wchunk == min(W, wk.WC_WINDOWS)
    assert p.pstride % 2 == 1 and p.pstride >= p.seg + 1
    assert 1 <= p.seg <= ring
    assert p.smem_bytes <= 4 * wk.WC_SMEM_WORDS
    assert p.smem_bytes == 4 * (3 * wk.WC_WINDOWS + wk.WC_ROWS
                                + p.tile_rows * (p.pstride + p.wchunk))
    assert p.tiles * p.tile_rows >= 32_769 > (p.tiles - 1) * p.tile_rows
    # the staged offsets and output offsets of a tile fit 32 bits
    assert p.tile_rows * max(ring, W) < 2 ** 31
    if p.tile_rows > 1:
        assert p.seg == ring
    else:
        assert p.seg == ring or ring > 24_000


def test_window_counts_plan_at_the_main_path_shapes():
    # the Q5 fire, F2's fire of 11 ends (fire_pad 16), one pass of 64
    # ends after a devgen batch
    assert wk.window_counts_plan(32_769, 32, 11)[:4] == (128, 32, 33, 11)
    assert wk.window_counts_plan(32_769, 32, 16)[:4] == (128, 32, 33, 16)
    assert wk.window_counts_plan(32_769, 64, 64)[:4] == (128, 64, 65, 64)
    assert wk.window_counts_plan(32_769, 32, 11).tiles == 257


def fast_div(d):
    """csrc/window_common.cuh ``fast_div``, step by step: the multiplier
    and shift that divide ``0 <= n < 2^31`` by ``d`` as ``(n * m) >> 32
    >> s`` (``d == 1``: ``n`` itself)."""
    if d <= 1:
        return 0, 0
    lg = (d - 1).bit_length()            # ceil(log2 d)
    p = 31 + lg
    return ((1 << p) + d - 1) // d, p - 32


def test_fast_div_mirrors_the_source():
    cu = _source("window_common.cuh")
    body = re.search(r"inline FastDiv fast_div\(uint32_t d\) \{(.*?)\n\}", cu,
                     re.S).group(1)
    for line in ("while ((1ull << l) < d) ++l;",
                 "const uint32_t p = 31 + l;",
                 "f.m = (uint32_t)(((1ull << p) + d - 1) / d);",
                 "f.s = p - 32;"):
        assert line in body
    assert "return f.d > 1 ? __umulhi(n, f.m) >> f.s : n;" in cu


@pytest.mark.parametrize("d", list(range(1, 70)) + [97, 255, 256, 1000,
                                                     4095, 65_535, 65_536,
                                                     262_144])
def test_fast_div_is_floor_division(d):
    m, s = fast_div(d)
    rng = np.random.default_rng(d)
    n = np.concatenate([np.arange(0, 4 * d + 3), rng.integers(0, 2 ** 31, 4000),
                        np.array([2 ** 31 - 1, 2 ** 31 - d, (2 ** 31 // d) * d,
                                  (2 ** 31 // d) * d - 1])]).astype(object)
    got = n if d == 1 else (n * m) >> 32 >> s
    assert m < 2 ** 32 and (d == 1 or 0 <= s < 32)
    np.testing.assert_array_equal(got, n // d)


@pytest.mark.parametrize("n,rows", [(1, 10), (2048, 33), ((1 << 20), 65_537),
                                    ((1 << 20) + 3, 32_769), (1 << 24, 9)])
def test_count_plan_fits_the_kernel(n, rows):
    p = wk.count_plan(n, rows)
    assert p.chunk % (4 * wk.COUNT_THREADS) == 0
    assert 4 * wk.COUNT_THREADS <= p.chunk <= wk.COUNT_MAX_CHUNK
    assert p.chunks * p.chunk >= n > (p.chunks - 1) * p.chunk
    # a wave of the card, unless the chunks reach their longest
    assert p.chunks <= wk.COUNT_BLOCKS or p.chunk > wk.COUNT_MAX_CHUNK - \
        4 * wk.COUNT_THREADS
    assert 8 * p.groups >= rows > 8 * (p.groups - 1)
    assert wk.count_plan(1 << 20, 65_537).chunk == 8192


# -- K2: the kernel's algorithm, mirrored ----------------------------------------

def emulate_window_counts(counts, ends, valid, pane_lo, pane_hi, ppw):
    """window_fire.cuh's window_counts_kernel step by step at its plan:
    each tile's window table, its prefix rows staged a segment at a time
    with a running carry, each window pass's differences."""
    rows, ring = counts.shape
    W = len(ends)
    p = wk.window_counts_plan(rows, ring, W)
    hi_cap = min(pane_hi, pane_lo + ring - 1)
    nl = hi_cap - pane_lo + 1 if hi_cap >= pane_lo else 0
    c0 = pane_lo % ring
    nsegs = -(-nl // p.seg) if nl > p.seg else 1
    c = counts.astype(np.uint32)
    out = np.zeros((rows, W), np.uint32)
    for tile in range(p.tiles):
        r0 = tile * p.tile_rows
        T = min(p.tile_rows, rows - r0)
        for w0 in range(0, W, p.wchunk):
            Wn = min(p.wchunk, W - w0)
            A = np.zeros(Wn, np.int64)
            B = np.zeros(Wn, np.int64)
            for w in range(Wn):
                if valid[w0 + w]:
                    e = int(ends[w0 + w])
                    lo, hi = max(e - ppw, pane_lo), min(e - 1, hi_cap)
                    if lo <= hi:
                        A[w], B[w] = lo - pane_lo, hi - pane_lo + 1
            acc = np.zeros((T, Wn), np.uint32)
            carry = np.zeros(T, np.uint32)
            for sg in range(nsegs):
                s0 = sg * p.seg
                ns = min(p.seg, nl - s0)
                cols = (c0 + s0 + np.arange(ns)) % ring
                pre = np.zeros((T, ns + 1), np.uint32)
                pre[:, 1:] = np.cumsum(c[r0:r0 + T][:, cols], axis=1,
                                       dtype=np.uint32)
                last = sg == nsegs - 1
                for w in range(Wn):
                    for x, sign in ((B[w], 1), (A[w], -1)):
                        if x >= s0 and (x < s0 + ns or last):
                            v = carry + pre[:, x - s0]
                            acc[:, w] = acc[:, w] + v if sign > 0 else acc[:, w] - v
                carry = carry + pre[:, ns]
            out[r0:r0 + T, w0:w0 + Wn] = acc
    return out.view(np.int32)


def _state(rng, rows, ring, pane_lo, pane_hi, hi=50):
    """Counts in the live panes' columns only (the ring invariant)."""
    counts = np.zeros((rows, ring), np.int32)
    for p in range(pane_lo, min(pane_hi, pane_lo + ring - 1) + 1):
        counts[:, p % ring] = rng.integers(0, hi, rows) * (rng.random(rows) < 0.5)
    return counts


@pytest.mark.parametrize("ring,W,span", [
    (1, 5, 0),             # ring 1
    (32, 11, 20),          # the Q5 fire
    (64, 64, 51),          # one pass of 64 ends
    (64, 65, 63),          # W past the table's pass
    (16, 130, 15),         # three passes
    (24, 9, 40),           # pane_hi - pane_lo >= ring (capped at the ring)
    (37, 7, -3),           # pane_hi below pane_lo: no live pane
])
def test_window_counts_algorithm_matches_the_reference(ring, W, span):
    """The mirror and the plain version against fire_kernel's counts, with
    ends below pane_lo and past hi_cap, invalid (sentinel) ends."""
    rng = np.random.default_rng(ring * 7 + W)
    rows, ppw = 300, 10
    pane_lo = 1000 + int(rng.integers(0, ring))
    pane_hi = pane_lo + span
    counts = _state(rng, rows, ring, pane_lo, pane_hi)
    ends = rng.integers(pane_lo - 12, pane_lo + ring + ppw + 3, W)
    valid = rng.random(W) < 0.8
    valid[0] = True
    ends = np.where(valid, ends, SENTINEL).astype(np.int64)
    want = wk.window_counts_plain(torch.from_numpy(counts),
                                  torch.from_numpy(ends),
                                  torch.from_numpy(valid), pane_lo, pane_hi,
                                  ppw).numpy()
    np.testing.assert_array_equal(
        emulate_window_counts(counts, ends, valid, pane_lo, pane_hi, ppw), want)
    if span < ring:
        ref = FIRE(_jax_state(counts), jnp.asarray(ends), jnp.asarray(valid),
                   jnp.int64(pane_lo), jnp.int64(pane_hi),
                   panes_per_window=ppw, ring=ring)[3]
        np.testing.assert_array_equal(want, np.asarray(ref))


def test_window_counts_algorithm_in_segments():
    """A ring past what one staged row holds (T = 1, several segments),
    windows whose ends fall on segment edges and on the last pane."""
    rng = np.random.default_rng(3)
    rows, ring, ppw = 3, 50_000, 5_000
    p = wk.window_counts_plan(rows, ring, 9)
    assert p.tile_rows == 1 and p.seg < ring
    pane_lo, pane_hi = 123_456, 123_456 + ring - 1
    counts = rng.integers(0, 1 << 20, (rows, ring)).astype(np.int32)
    s = p.seg
    ends = np.array([pane_lo + s, pane_lo + s + 1, pane_lo + 2 * s,
                     pane_lo + ring, pane_lo + ring + 7, pane_lo + 1,
                     pane_lo + 3 * s - 1, SENTINEL, pane_lo + 2 * s + 4_999],
                    np.int64)
    valid = ends != SENTINEL
    want = wk.window_counts_plain(torch.from_numpy(counts),
                                  torch.from_numpy(ends),
                                  torch.from_numpy(valid), pane_lo, pane_hi,
                                  ppw).numpy()
    np.testing.assert_array_equal(
        emulate_window_counts(counts, ends, valid, pane_lo, pane_hi, ppw), want)


def test_window_counts_into_out_on_the_cpu():
    """The wrapper's out: filled and returned; a wrong shape raises."""
    rng = np.random.default_rng(4)
    counts = torch.from_numpy(_state(rng, 65, 16, 200, 210))
    ends = torch.arange(201, 213, dtype=torch.int64)
    valid = torch.ones(12, dtype=torch.bool)
    out = torch.full((65, 12), -5, dtype=torch.int32)
    got = wk.window_counts(counts, ends, valid, 200, 210, 4, out)
    assert got is out
    assert torch.equal(out, wk.window_counts_plain(counts, ends, valid, 200,
                                                   210, 4))
    with pytest.raises(ValueError, match="out must be"):
        wk.window_counts(counts, ends, valid, 200, 210, 4,
                         torch.empty((65, 11), dtype=torch.int32))


# -- K1 per record and the split upload ------------------------------------------

def emulate_count_records(rows, ring, cells):
    """window_kernels.cu's count_records_kernel at its plan: each chunk's
    histogram of its reference column, the other columns' records
    straight to their cells. ``cells``: flat cells, -1 for a record that
    adds nothing."""
    p = wk.count_plan(len(cells), rows)
    out = np.zeros(rows * ring, np.int64)
    for k in range(p.chunks):
        blk = cells[k * p.chunk:(k + 1) * p.chunk]
        mid = blk[len(blk) // 2]
        ref = mid % ring if mid >= 0 else 0
        ok = blk >= 0
        hist = np.bincount(blk[ok & (blk % ring == ref)] // ring,
                           minlength=8 * p.groups)
        assert hist.max(initial=0) < 1 << 16
        np.add.at(out, np.flatnonzero(hist) * ring + ref, hist[hist > 0])
        np.add.at(out, blk[ok & (blk % ring != ref)], 1)
    return out.reshape(rows, ring)


@pytest.mark.parametrize("n", [30_000, 300_000])
def test_count_records_algorithm_counts_each_record_once(n):
    """Records over two panes (a chunk straddling the edge), a hot cell,
    invalid records: the mirror equals a plain bincount."""
    rng = np.random.default_rng(n)
    rows, ring = 1025, 6
    rows_of = rng.integers(0, rows, n)
    rows_of[rng.random(n) < 0.2] = 17
    col = np.where(np.arange(n) < n // 3 + 77, 3, 4)
    cells = (rows_of * ring + col).astype(np.int64)
    cells[rng.random(n) < 0.05] = -1
    want = np.bincount(cells[cells >= 0], minlength=rows * ring)
    got = emulate_count_records(rows, ring, cells)
    np.testing.assert_array_equal(got.reshape(-1), want)


@pytest.mark.parametrize("ring", [1, 32, 256])
def test_scatter_split_counts_matches_apply_kernel_split(ring):
    """The one-launch count of a split upload == the reference's
    apply_kernel_split count lane (exact): invalid slots (0xFFFF) add
    nothing, the dump row's own slot counts."""
    rng = np.random.default_rng(ring)
    slots, n = 511, 20_000
    base = rng.integers(0, 10, (slots + 1, ring)).astype(np.int32)
    sl = rng.integers(0, slots + 1, n)        # slot == slots: the dump row
    sl[:7] = slots
    valid = rng.random(n) < 0.85
    sc = split_encode(sl, rng.integers(0, ring, n).astype(np.uint8), valid)
    ref = SPLIT(_jax_state(base), jnp.asarray(sc), {}, agg=jax_count(),
                dump_row=slots)
    got = wk.scatter_split_counts(torch.from_numpy(base.copy()),
                                  torch.from_numpy(sc), slots)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.counts))
    # the dump row's count: what the reference leaves there
    np.testing.assert_array_equal(got.numpy()[slots],
                                  np.asarray(ref.counts)[slots])
    cells = np.where(valid, sl * ring + sc[:, 2], -1).astype(np.int64)
    emu = emulate_count_records(slots + 1, ring, cells) + base
    np.testing.assert_array_equal(emu, got.numpy())


def test_scatter_split_counts_refuses_cells_outside_the_state():
    c = torch.zeros((101, 32), dtype=torch.int32)
    sc = split_encode(np.array([5, 101]), np.array([1, 2], np.uint8),
                      np.ones(2, bool))
    with pytest.raises(IndexError, match="split_cells"):
        wk.scatter_split_counts(c, torch.from_numpy(sc), 100)
    sc = split_encode(np.array([5]), np.array([40], np.uint8), np.ones(1, bool))
    with pytest.raises(IndexError, match="split_cells"):
        wk.scatter_split_counts(c, torch.from_numpy(sc), 100)
    with pytest.raises(ValueError, match="dump_row"):
        wk.scatter_split_counts(c, torch.from_numpy(sc), 101)
    with pytest.raises(ValueError, match="ring"):
        wk.scatter_split_counts(torch.zeros((101, 300), dtype=torch.int32),
                                torch.from_numpy(sc), 100)
    assert int(c.abs().sum()) == 0
