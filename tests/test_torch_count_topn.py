"""The count-form top-n and the device ingest as redesigned for the card:
the launch plan and workspace of the whole-card selection
(``window_kernels.topn_plan``, ``select_work_words``) read against the
CUDA sources' constants at the main path's shapes, and the plain
versions that the kernels are held to on the card
(``tests/test_torch_cuda.py``) against the JAX functions they replace,
on the cases the older parity tests leave out: window counts past 2^24,
a fire of 64 window ends, and a ring of 48 panes of 700 ms with records
before ``offset_ms``. The reference programs run as the JAX tests run
them (CPU XLA), each jitted once a shape."""
import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import window as jw
from flink_tpu.ops.aggregates import count as jax_count
from flink_tpu.state.keyed import PaneState as JaxPaneState
from flink_tpu_torch.kernels import devgen_kernels as dk
from flink_tpu_torch.kernels import fused_kernels as fk
from flink_tpu_torch.kernels import window_kernels as wk
from test_torch_threads import capped_torch_threads  # noqa: F401

CSRC = os.path.join(os.path.dirname(wk.__file__), "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constexpr(text, name):
    return re.search(rf"constexpr (?:int|uint32_t) {name} = ([^;]+);",
                     text).group(1).strip()


# -- the launch plan and the workspace -----------------------------------------

def test_plan_constants_match_the_sources():
    """The plan's tile, block, table and histogram sizes are the
    kernels'; the fused step's launches are its four stages (the header
    decode inside the apply's launch) with the top-n's two at top-1; the
    wrappers' argument blocks have a word a C argument."""
    common, sel = _source("window_common.cuh"), _source("topn_select.cuh")
    threads = int(_constexpr(common, "kThreads"))
    assert _constexpr(sel, "kSelCells") == "kThreads * kSelItems"
    assert _constexpr(sel, "kThrCells") == "kThreads * kThrItems"
    assert threads * int(_constexpr(sel, "kSelItems")) == wk.SEL_CELLS
    assert threads * int(_constexpr(sel, "kThrItems")) == wk.THR_CELLS
    assert int(_constexpr(sel, "kSelWinTable")) == wk.SEL_WIN_TABLE
    assert int(_constexpr(sel, "kRadixWindows")) == wk.RADIX_WINDOWS
    assert fk.FUSED_STEP_KERNELS == 3 + wk.topn_plan(32769, 11, 1).kernels
    win = _source("window_kernels.cu")
    for fn, entry in (("fk_topn_select_append", wk._TOPN_SELECT_APPEND),
                      ("fk_topn_select_given", wk._TOPN_SELECT_GIVEN)):
        sig = re.search(rf"int {fn}\((.*?)\)", win, re.S).group(1)
        assert sig.count(",") == entry._struct.size // 8   # + the stream
    fused = _source("fused_kernels.cu")
    sig = re.search(r"int ff_fused_step\((.*?)\)", fused, re.S).group(1)
    assert sig.count(",") == fk._FUSED_STEP._struct.size // 8
    dev = _source("devgen_kernels.cu")
    sig = re.search(r"int dg_devgen_ingest\((.*?)\)", dev, re.S).group(1)
    assert sig.count(",") == dk._DEVGEN_INGEST._struct.size // 8


def test_ingest_histogram_fits_a_block():
    """The devgen ingest's launch: a block's chunk is its threads x
    records a thread; its histogram (a slot a key of one pane and the
    dump's) and its per-warp partials fit the card's 227 KB of shared
    memory a block, with room for the headline's 10,000 auctions."""
    dev = _source("devgen_kernels.cu")
    threads = int(_constexpr(dev, "kIngestThreads"))
    assert _constexpr(dev, "kIngestChunk") == "kIngestThreads * kIngestItems"
    assert _constexpr(dev, "kHistWords") == "48 * 1024"
    assert 48 * 1024 * 4 + 4 * 4 * threads // 32 <= 232_448
    assert threads <= 1024 and 10_000 + 1 <= 48 * 1024


@pytest.mark.parametrize("rows,W,n,given,fits,want", [
    (32769, 11, 1, False, True, (353, 177, 2, True)),     # the kernels phase
    (32769, 16, 1, False, True, (513, 257, 2, True)),     # the fused step's pad
    (32769, 64, 1, False, True, (2049, 1025, 2, True)),   # devgen's one pass
    (32769, 65, 1, False, True, (2081, 1041, 2, False)),  # past the table
    (32769, 11, 3, False, True, (353, 177, 1, True)),     # cooperative
    (32769, 11, 3, False, False, (353, 177, 5, True)),    # a launch a pass
    (32769, 64, 3, False, True, (2049, 1025, 5, True)),   # past 32 windows
    (8193, 11, 1, True, True, (89, 45, 1, True)),         # M1's block, given
    (300, 4, 301, False, True, (2, 1, 1, True)),          # n past the rows
    (1, 1, 1, False, True, (1, 1, 2, True)),
])
def test_topn_plan_at_the_main_path_shapes(rows, W, n, given, fits, want):
    assert tuple(wk.topn_plan(rows, W, n, given=given, fits=fits)) == want


@pytest.mark.parametrize("W", [1, 11, 16, 33, 64, 65, 300])
@pytest.mark.parametrize("rows", [1, 8193, 32769])
def test_select_workspace_covers_the_fire(W, rows):
    """The workspace: the head, the done and epoch words, the grid
    barrier's words, a tagged threshold a window, each window's prefix,
    need, non-candidate count and 256 bins, and a descriptor a
    selection tile, each on its own 128-byte line (never fewer tiles
    than the threshold blocks, which the cooperative form selects a tile
    each)."""
    p = wk.topn_plan(rows, W, 1)
    assert p.tiles >= p.blocks
    words = wk.select_work_words(W, p.tiles)
    assert 8 * words >= 24 + 8 * W + 4 * W * (3 + 256) + 128 * p.tiles
    # the descriptors start on a 128-byte line
    assert (words - wk.LB_LINE * p.tiles) % wk.LB_LINE == 0


# -- the plain versions against the reference -----------------------------------

def _topn_against_reference(counts, used, ends, anchor, pane_lo, pane_hi, ppw,
                            n, sel_cap, fill):
    """window_counts + topn_select_append (the plain versions, CPU
    tensors) against the reference's ring_append_topn_kernel
    (_ring_append_topn_core) on the same state and fire."""
    ring = counts.shape[1]
    W = len(ends)
    pad = max(jw.MIN_FIRE_PAD, 1 << (W - 1).bit_length())
    params = np.asarray([pane_lo, pane_hi, anchor] + list(ends)
                        + [int(jw._END_SENTINEL)] * (pad - W), np.int64)
    ring_buf = np.zeros((2048 + 2, 3), np.int32)
    ring_buf[0, 0] = fill
    ref = np.asarray(jw._JIT_RING_TOPN(
        JaxPaneState(None, None, None, jnp.asarray(counts)),
        jnp.asarray(ring_buf), jnp.asarray(params), jnp.asarray(used),
        agg=jax_count(), panes_per_window=ppw, ring=ring, sel_cap=sel_cap,
        by="count", topn=n))
    w_valid = torch.ones(W, dtype=torch.bool)
    end_t = torch.from_numpy(np.asarray(ends, np.int64))
    wc = wk.window_counts(torch.from_numpy(counts), end_t, w_valid, pane_lo,
                          pane_hi, ppw)
    got = wk.topn_select_append(wc, torch.from_numpy(used), end_t, w_valid,
                                anchor, n, sel_cap,
                                torch.from_numpy(ring_buf)).numpy()
    # the last row is the reference's scatter dump, never written here
    np.testing.assert_array_equal(got[:-1], ref[:-1])
    return got, wc.numpy()


def test_topn_select_append_past_2_24_matches_the_reference():
    """State counts past 2^24: window counts that round to one f32 value
    tie at top-1 in both packages (2^24 and 2^24 + 1), and one that
    rounds above them (2^24 + 3) wins alone in another window."""
    rows, ring, ppw, pane_lo = 257, 16, 4, 200
    pane_hi = pane_lo + ring - 2
    rng = np.random.default_rng(31)
    counts = np.zeros((rows, ring), np.int32)
    for p in range(pane_lo, pane_hi + 1):
        counts[:, p % ring] = rng.integers(0, 1000, rows)
    # the window ending at pane_lo + 4 sums panes pane_lo .. pane_lo + 3
    cols = [(pane_lo + j) % ring for j in range(4)]
    counts[10, cols] = [2 ** 22] * 4                    # 2^24
    counts[200, cols] = [2 ** 22] * 3 + [2 ** 22 + 1]   # 2^24 + 1
    counts[7, cols] = [2 ** 22] * 3 + [2 ** 22 - 1]     # 2^24 - 1
    # the next window (its panes shifted one): 2^24 + 3 against 2^24 + 2
    nxt = [(pane_lo + 1 + j) % ring for j in range(4)]
    counts[3, nxt] = [2 ** 22] * 3 + [2 ** 22 + 3]
    counts[4, nxt] = [2 ** 22] * 3 + [2 ** 22 + 2]
    counts[[10, 200, 7], nxt[-1]] = 0
    used = np.ones(rows, bool)
    used[-1] = False
    ends = [pane_lo + 4, pane_lo + 5]
    got, wc = _topn_against_reference(counts, used, ends, pane_lo - 5,
                                      pane_lo, pane_hi, ppw, 1, 256, 0)
    assert wc.max() > 2 ** 24
    body = got[1:1 + got[0, 0]]
    assert sorted(body[body[:, 1] == 9, 0].tolist()) == [10, 200]
    assert body[body[:, 1] == 10, 0].tolist() == [3]


@pytest.mark.parametrize("n", [1, 3])
def test_topn_select_append_of_64_ends_matches_the_reference(n):
    """A fire of 64 window ends (the one pass after a device-made batch,
    one block's threshold table on the card), the ring wrapping."""
    rows, ring, ppw, pane_lo = 513, 64, 4, 300
    pane_hi = pane_lo + ring - 2
    rng = np.random.default_rng(32 + n)
    counts = np.zeros((rows, ring), np.int32)
    for p in range(pane_lo, pane_hi + 1):
        counts[:, p % ring] = rng.integers(0, 30, rows) * (rng.random(rows)
                                                           < 0.4)
    used = rng.random(rows) < 0.9
    used[-1] = False
    ends = list(range(pane_lo + 1, pane_lo + 65))
    got, _ = _topn_against_reference(counts, used, ends, pane_lo - 3, pane_lo,
                                     pane_hi, ppw, n, 1024, 1900)
    assert got[0, 0] > 1900 + 64 and got[0, 1] == 0


@dataclasses.dataclass(frozen=True)
class JaxEarlyGen:
    """A batch whose first records lie before ``offset_ms`` (negative
    panes), keys partly outside [0, domain)."""

    batch_size: int
    domain: int
    t0: int

    def __call__(self, batch_index):
        ids = batch_index * self.batch_size + jnp.arange(self.batch_size,
                                                         dtype=jnp.int64)
        keys = jnp.where(ids % 5 == 0, self.domain + ids % 7,
                         (ids * 7919) % self.domain)
        return keys, self.t0 + ids * 3


def test_devgen_ingest_matches_the_reference_on_a_48_pane_ring():
    """devgen_ingest (plain version) against the reference's
    devgen_step_kernel with nothing to fire or clear: a 48-column ring,
    700 ms panes, offset_ms 300 and records from 2,100 ms before it, some
    late, some re-fire candidates, some outside the key domain: the
    counts on every row and the whole stats vector equal."""
    domain, ring, slots, pane_ms, offset = 300, 48, 512, 700, 300
    batch, n = 2, 4096
    gen = JaxEarlyGen(n, domain, -1800 - 2 * n * 3)
    keys_j, ts_j = gen(batch)
    panes = (np.asarray(ts_j) - offset) // pane_ms
    assert panes.min() < 0
    dead, refire_below = int(panes.min()) + 2, int(panes.min()) + 6
    hdr = np.zeros(jw.FUSED_HDR, np.int32)
    hdr[:6] = np.array([0, -1, 0], np.int64).view(np.int32)
    hdr[8:8 + jw.MIN_FIRE_PAD] = jw._DELTA_SENTINEL
    hdr[jw.DEVGEN_HDR_OFF:jw.DEVGEN_HDR_OFF + 6] = np.array(
        [batch, dead, refire_below], np.int64).view(np.int32)
    rows = slots + 1
    counts0 = np.random.default_rng(33).integers(0, 9, (rows, ring)).astype(
        np.int32)
    used = np.zeros(rows, bool)
    used[:domain] = True
    st, _, stats_j = jw._JIT_DEVGEN_STEP(
        JaxPaneState(None, None, None, jnp.asarray(counts0)),
        jnp.zeros((2050, 3), jnp.int32), jnp.asarray(hdr), jnp.asarray(used),
        gen=gen, key_domain=domain, agg=jax_count(), panes_per_window=10,
        ring=ring, sel_cap=256, by="count", topn=1, dump_row=slots,
        pane_ms=pane_ms, offset_ms=offset, fire_gate=True)
    counts = torch.from_numpy(counts0.copy())
    stats = dk.devgen_ingest(
        counts, torch.from_numpy(np.array(keys_j)),
        torch.from_numpy(np.array(ts_j)), key_domain=domain,
        pane_ms=pane_ms, offset_ms=offset, dead_below=dead,
        refire_below=refire_below, dump_row=slots)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(st.counts))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(stats_j))
    head = stats.numpy()[:8]
    assert head[1] > 0 and head[2] > 0 and head[4] > 0
