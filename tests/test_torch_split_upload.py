"""The split upload on the per-record path: 3 bytes a record (a
little-endian uint16 slot id and a uint8 ring column, 0xFFFF for an
invalid record) instead of an int32 flat cell, decoded on the device
inside ``scatter_lanes`` (with lanes) or ``scatter_split_counts`` (count
only), by ``split_cells``' rule. The port's host encode and device decode against the
JAX package's ``split_encode`` / ``split_decode``, and the window
operator's choice of upload against the reference's: the split while
the state's rows (dump row included) fit below 0xFFFF and the ring fits
256 columns, checked again after a ring growth. Rows must equal the
reference's in order, exactly (count, max and min only)."""
import functools
import os
import re

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
from flink_tpu.ops.window import WindowOperator as JaxWindowOperator
from flink_tpu.ops.window import split_decode as jax_split_decode
from flink_tpu.ops.window import split_encode as jax_split_encode
from flink_tpu.state.keyed import PaneState as JaxPaneState
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.kernels import lane_kernels as lk
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.window import WindowOperator, split_encode
from test_torch_threads import capped_torch_threads  # noqa: F401


@pytest.fixture
def numpy_host_paths(monkeypatch):
    """Both packages key through their numpy tables (so neither takes a
    native count-only lane)."""
    from flink_tpu import native_codec
    from flink_tpu_torch import native_codec as port_native_codec

    for mod in (native_codec, port_native_codec):
        monkeypatch.setattr(mod.NativeHashTable, "create",
                            classmethod(lambda cls, capacity_hint=1024: None))


@pytest.fixture
def split_calls(monkeypatch):
    """Records the (B, ring) of every split upload the port decodes on
    the device: ``scatter_lanes``' split form (lanes) and
    ``scatter_split_counts`` (count only), each decoding inside its own
    launch, and ``split_cells`` (the decode alone, which neither path
    calls)."""
    seen = []
    orig = wk.split_cells
    orig_count = wk.scatter_split_counts
    orig_lanes = lk.scatter_lanes

    def spy(sc, ring, dump_row):
        seen.append((sc.shape[0], ring))
        return orig(sc, ring, dump_row)

    def spy_count(counts, sc, dump_row):
        seen.append((sc.shape[0], counts.shape[1]))
        return orig_count(counts, sc, dump_row)

    def spy_lanes(counts, *args, **kwargs):
        idx = args[3]
        if idx.dtype == torch.uint8:
            seen.append((idx.shape[0], counts.shape[1]))
        return orig_lanes(counts, *args, **kwargs)
    monkeypatch.setattr(wk, "split_cells", spy)
    monkeypatch.setattr(wk, "scatter_split_counts", spy_count)
    monkeypatch.setattr(lk, "scatter_lanes", spy_lanes)
    return seen


def encode_case(seed, n=500, slots=32_768):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, slots, n).astype(np.int64),
            rng.integers(0, 32, n).astype(np.uint8),
            rng.random(n) < 0.9)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_encode_bytes_equal_the_reference(seed):
    slots, cols, valid = encode_case(seed)
    got = split_encode(slots, cols, valid)
    want = jax_split_encode(slots, cols, valid)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (len(slots), 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ring", [1, 32, 256])
def test_split_cells_plain_equals_split_decode(ring):
    slots, cols, valid = encode_case(ring, slots=65_534)
    cols = (cols.astype(np.int64) % ring).astype(np.uint8)
    slots[:3] = [0, 65_533, 65_534]
    sc = jax_split_encode(slots, cols, valid)
    slot, col = (np.asarray(a) for a in jax_split_decode(jnp.asarray(sc)))
    dump_row = 65_534
    row = np.where(slot == 0xFFFF, dump_row, slot.astype(np.int64))
    want = (row * ring + col).astype(np.int32)
    got = wk.split_cells(torch.from_numpy(sc), ring, dump_row)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_cells_refuses_cells_outside_the_state():
    sc = split_encode(np.array([5, 9]), np.array([1, 40], np.uint8),
                      np.ones(2, bool))
    with pytest.raises(IndexError, match="split_cells"):
        wk.split_cells(torch.from_numpy(sc), 32, 100)
    with pytest.raises(IndexError, match="split_cells"):
        wk.split_cells(torch.from_numpy(sc[:1]), 32, 4)
    with pytest.raises(ValueError):
        wk.split_cells(torch.from_numpy(sc), 512, 100)


# -- scatter_lanes' split form ----------------------------------------------------

SPLIT_AGGS = (ja.multi(ja.count(), ja.sum_of("a"), ja.max_of("a"),
                       ja.min_of("b")),
              ta.multi(ta.count(), ta.sum_of("a"), ta.max_of("a"),
                       ta.min_of("b")))


def split_lane_case(ring, rows=40, n=600):
    """A split upload into (rows, ring) lanes whose last row is the dump
    row: hot cells, invalid records (slot 0xFFFF), records on the dump
    row's own slot, signed zeros and a NaN; the lanes start from a few
    live values."""
    rng = np.random.default_rng(ring)
    dump_row = rows - 1
    slots = np.where(rng.random(n) < 0.3, rng.integers(0, 4, n),
                     rng.integers(0, rows, n))
    cols = rng.integers(0, ring, n).astype(np.uint8)
    valid = rng.random(n) > 0.1
    sc = split_encode(slots, cols, valid)
    a = (rng.standard_normal(n) * 50).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    a[:4] = [-0.0, 0.0, np.nan, 7.0]
    b[4:7] = [0.0, -0.0, np.nan]
    counts = rng.integers(0, 3, (rows, ring)).astype(np.int32)
    sums = (rng.standard_normal((rows, ring, 1)) * 10).astype(np.float32)
    maxs = np.full((rows, ring, 1), -np.inf, np.float32)
    mins = np.full((rows, ring, 1), np.inf, np.float32)
    return sc, dump_row, {"a": a, "b": b}, (counts, sums, maxs, mins)


def port_lanes(state, sc, dump_row, data, composed):
    """The port's state after one split upload: the split form, or
    ``split_cells_plain`` then ``scatter_lanes_plain`` (``composed``)."""
    st = [torch.from_numpy(x.copy()) for x in state]
    s, mx, mn = SPLIT_AGGS[1].lift_masked(
        {k: torch.from_numpy(v) for k, v in data.items()},
        torch.ones(len(sc), dtype=torch.bool))
    sc_t = torch.from_numpy(sc)
    if composed:
        lk.scatter_lanes_plain(*st, wk.split_cells_plain(
            sc_t, st[0].shape[1], dump_row), s, mx, mn)
    else:
        lk.scatter_lanes(*st, sc_t, s, mx, mn, dump_row=dump_row)
    return [x.numpy() for x in st]


def bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("ring", [1, 32, 256])
def test_split_scatter_lanes_is_split_cells_then_scatter_lanes(ring):
    """The split form's plain version equals the decode then the flat
    scatter bit for bit, dump row included (slot 0xFFFF folds there)."""
    sc, dump_row, data, state = split_lane_case(ring)
    assert (sc[:, :2].view(np.uint16) == wk.INVALID_SLOT_U16).any()
    assert (sc[:, :2].view(np.uint16) == dump_row).any()
    got = port_lanes(state, sc, dump_row, data, composed=False)
    want = port_lanes(state, sc, dump_row, data, composed=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(w))


@pytest.mark.parametrize("ring", [1, 32, 256])
def test_split_scatter_lanes_matches_apply_kernel_split(ring):
    """Against the reference's ``apply_kernel_split`` (jitted, as its
    operator runs it): counts, max and min exactly (NaN and signed zeros
    included), each sum within 2 n 2^-24 of its terms' absolute sum, on
    every row the records address. The dump row differs by design: the
    reference masks its invalid records to the lanes' identities there,
    while the port's one-card path never uploads them (its host drops
    them) and its decode folds any that arrive into that row as
    ``split_cells`` + ``scatter_lanes`` do."""
    sc, dump_row, data, state = split_lane_case(ring)
    jagg = SPLIT_AGGS[0]
    apply = jax.jit(functools.partial(jw.apply_kernel_split, agg=jagg,
                                      dump_row=dump_row))
    ref = apply(JaxPaneState(*(jnp.asarray(x) for x in state[1:]),
                             jnp.asarray(state[0])), jnp.asarray(sc),
                {k: jnp.asarray(v) for k, v in data.items()})
    got = port_lanes(state, sc, dump_row, data, composed=False)
    want = [np.asarray(x) for x in (ref.counts, ref.sums, ref.maxs, ref.mins)]
    live = slice(0, dump_row)
    for g, w in ((got[0], want[0]), (got[2], want[2]), (got[3], want[3])):
        np.testing.assert_array_equal(bits(g[live]), bits(w[live]))
    slot = sc[:, :2].view(np.uint16)[:, 0].astype(np.int64)
    cell = np.where(slot == wk.INVALID_SLOT_U16, dump_row, slot) * ring \
        + sc[:, 2]
    terms = np.abs(state[1].reshape(-1)).astype(np.float64)
    n_terms = np.ones(terms.size)
    a = np.nan_to_num(data["a"].astype(np.float64))
    np.add.at(terms, cell, np.abs(a))
    np.add.at(n_terms, cell, 1)
    g = got[1].reshape(-1).astype(np.float64)
    w = want[1].reshape(-1).astype(np.float64)
    ok = (np.isnan(g) & np.isnan(w)) | (np.abs(g - w)
                                        <= 2 * n_terms * 2.0 ** -24 * terms)
    assert ok[:dump_row * ring].all()


def test_split_scatter_lanes_refusals():
    """A slot past the dump row or a column past the ring raises naming
    ``split_cells``; a missing dump row, a ring past 256 columns or a
    record not 3 bytes wide is refused."""
    sc, dump_row, data, state = split_lane_case(32, rows=10, n=20)
    for slots, cols in (([2, dump_row + 1], [0, 1]), ([2, 3], [0, 32])):
        bad = split_encode(np.array(slots), np.array(cols, np.uint8),
                           np.ones(2, bool))
        with pytest.raises(IndexError, match="split_cells"):
            port_lanes(state, bad, dump_row, {k: v[:2] for k, v in
                                              data.items()}, composed=False)
    st = [torch.from_numpy(x.copy()) for x in state]
    x = torch.zeros((20, 1))
    with pytest.raises(ValueError, match="dump_row"):
        lk.scatter_lanes(*st, torch.from_numpy(sc), x, x, x)
    with pytest.raises(ValueError, match="3"):
        lk.scatter_lanes(*st, torch.zeros((20, 4), dtype=torch.uint8), x, x,
                         x, dump_row=dump_row)
    wide = [torch.zeros((10, 512) + t.shape[2:], dtype=t.dtype) for t in st]
    with pytest.raises(ValueError, match="256"):
        lk.scatter_lanes(*wide, torch.from_numpy(sc), x, x, x,
                         dump_row=dump_row)


def test_split_scatter_lanes_argument_block_matches_the_source():
    """The lean entry's packed block: one word an argument of
    ``lk_scatter_lanes`` (the stream beside it)."""
    path = os.path.join(os.path.dirname(lk.__file__), "csrc",
                        "lane_kernels.cu")
    with open(path) as f:
        src = f.read()
    sig = re.search(r"int lk_scatter_lanes\((.*?)\) \{", src, re.S).group(1)
    assert sig.count(",") == lk._SCATTER_LANES._struct.size // 8 == 27
    assert "(int32_t)a[25], (int32_t)a[26], stream" in src


AGGS = {"count": lambda m: m.count(),
        "lanes": lambda m: m.multi(m.count(), m.max_of("price"),
                                   m.min_of("price"))}


def make_port(agg, assigner, shards, slots, ooo):
    size, slide = assigner
    a = (TumblingEventTimeWindows.of(size) if slide is None
         else SlidingEventTimeWindows.of(size, slide))
    return WindowOperator(a, AGGS[agg](ta), device="cpu", num_shards=shards,
                          slots_per_shard=slots, max_out_of_orderness_ms=ooo)


def make_ref(assigner, shards, slots, ooo):
    size, slide = assigner
    a = JaxTumbling.of(size) if slide is None else JaxSliding.of(size, slide)
    return JaxWindowOperator(a, AGGS["lanes"](ja), num_shards=shards,
                             slots_per_shard=slots,
                             max_out_of_orderness_ms=ooo)


@pytest.fixture(scope="module")
def reference_run():
    """``run(case, ref, steps)``: the reference operator driven through
    ``steps`` once per module and case, on its numpy table: the upload
    choice after each batch, each advance's rows, the final flush and
    the final counts. The reference runs the lanes aggregate; its rows
    carry every column a count() run has (the same cells, in the same
    order), so the count and lanes cases of one layout share one run
    and its compiled programs."""
    from flink_tpu import native_codec

    cache = {}

    def run(case, ref, steps):
        if case in cache:
            return cache[case]
        out = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(native_codec.NativeHashTable, "create",
                       classmethod(lambda cls, capacity_hint=1024: None))
            for step in steps:
                if step[0] == "batch":
                    ref.process_batch(*step[1:])
                    out.append(ref._split_upload)
                else:
                    out.append(dict(ref.advance_watermark(step[1])))
            out.append(dict(ref.advance_watermark(ref.final_watermark())))
        cache[case] = (out, np.asarray(ref.state.counts), ref.plan.ring)
        return cache[case]

    return run


# the columns each aggregate's rows carry, in order: count() has the
# first four of the lanes aggregate's (the reference's run)
COLUMNS = {"count": ["key", "window_start", "window_end", "count"],
           "lanes": ["key", "window_start", "window_end", "count",
                     "max_price", "min_price"]}


def assert_same(got, want, columns):
    """The port's rows have exactly ``columns``, in order, each equal
    bit for bit to the reference's column of that name."""
    assert list(got) == columns
    for k in got:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=k)


def drive(port, steps, recorded, columns):
    """(batch | watermark) steps on the port against the reference's
    recorded run: the same upload choice after every batch, every
    advance's rows equal in order with exactly ``columns``, the final
    flush and the final counts. Returns the number of rows."""
    out, counts, _ = recorded
    assert list(out[-1]) == COLUMNS["lanes"]
    n = 0
    for step, want in zip(steps, out):
        if step[0] == "batch":
            port.process_batch(*step[1:])
            assert port._split_upload == want
        else:
            got = dict(port.advance_watermark(step[1]))
            assert_same(got, want, columns)
            n += len(got["key"])
    got = dict(port.advance_watermark(port.final_watermark()))
    assert_same(got, out[-1], columns)
    np.testing.assert_array_equal(port.state.counts.numpy(), counts)
    return n + len(got["key"])


def per_record_steps(rng, n_batches, batch, n_keys, pane_ms, spread,
                     start=100_000):
    """High-cardinality batches (the host pre-combine declines them, so
    they go per record), each followed by a watermark."""
    steps, t = [], start
    for _ in range(n_batches):
        keys = rng.integers(0, n_keys, batch).astype(np.int64) * 31 + 7
        ts = (t + rng.integers(0, spread, batch)).astype(np.int64)
        price = rng.normal(100, 30, batch).astype(np.float32)
        price[:3] = [-0.0, 0.0, np.nan]
        steps.append(("batch", keys, ts, {"price": price}))
        steps.append(("wm", int(ts.max()) - 1000))
        t += pane_ms
    return steps


@pytest.mark.parametrize("agg", list(AGGS))
def test_split_taken_at_32769_rows_and_ring_32(numpy_host_paths, split_calls,
                                                reference_run, agg):
    # the bid-aggregate jobs' state: 128 x 256 slots over a 32-column
    # ring (1 s windows, 26 s out of order); every fire of the run
    # completes at most one window per call of the reference's program
    layout = ((1_000, None), 128, 256, 26_000)
    port = make_port(agg, *layout)
    assert port.layout.rows == 32_769 and port.plan.ring == 32
    assert port._split_upload
    steps = per_record_steps(np.random.default_rng(3), 2, 512, 30_000,
                             1_000, 1_000)
    recorded = reference_run("32769", make_ref(*layout), steps)
    assert recorded[0][0] is True
    assert drive(port, steps, recorded, COLUMNS[agg]) > 0
    assert split_calls and all(r == 32 for _, r in split_calls)


def test_split_not_taken_at_65537_rows(numpy_host_paths, split_calls,
                                       reference_run):
    layout = ((1_000, None), 128, 512, 0)
    port = make_port("lanes", *layout)
    assert port.layout.rows == 65_537
    assert not port._split_upload
    steps = per_record_steps(np.random.default_rng(4), 2, 512, 30_000,
                             1_000, 1_000)
    recorded = reference_run("65537", make_ref(*layout), steps)
    assert recorded[0][0] is False
    assert drive(port, steps, recorded, COLUMNS["lanes"]) > 0
    assert split_calls == []


@pytest.mark.parametrize("agg", list(AGGS))
def test_ring_growth_past_256_switches_back(numpy_host_paths, split_calls,
                                            reference_run, agg):
    # 10 ms panes (gcd of 1000 and 990) in windows 990 ms apart: the
    # ring starts at 105 columns and a wide span of live panes fires
    # only a few windows
    layout = ((1_000, 990), 16, 32, 0)
    port = make_port(agg, *layout)
    assert port._split_upload and port.plan.ring <= 256
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 60, 256).astype(np.int64)
    data = {"price": rng.normal(50, 10, 256).astype(np.float32)}
    narrow = (1_000 + rng.integers(0, 40, 256)).astype(np.int64)
    # panes 100..506 live at once: the ring grows to 512 columns
    wide = (2_000 + np.arange(256) * 12).astype(np.int64)
    steps = [("batch", keys, narrow, data), ("batch", keys, wide, data),
             ("wm", 5_100)]
    steps += per_record_steps(rng, 2, 256, 60, 10, 30, start=5_200)
    recorded = reference_run("growth", make_ref(*layout), steps)
    assert drive(port, steps, recorded, COLUMNS[agg]) > 0
    assert port.plan.ring == recorded[2] == 512
    assert not port._split_upload
    # the first batch only, at the ring it started with
    assert len(split_calls) == 1 and split_calls[0][0] == 256
    assert split_calls[0][1] <= 256
