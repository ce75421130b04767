"""Parity of the port's four window kernels with the JAX functions they
replace (flink_tpu/ops/window.py), run as the JAX tests run them (CPU
XLA). Here the wrappers take their plain PyTorch versions, because the
tensors lie on the CPU; tests/test_torch_cuda.py holds the CUDA kernels
against the same plain versions on the card.

Every comparison is exact: the functions work on the int32 count lane,
where integer sums do not depend on order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import window as jw
from flink_tpu.ops.aggregates import count as jax_count
from flink_tpu.state.keyed import PaneState as JaxPaneState
from flink_tpu_torch.kernels import window_kernels as wk
from test_torch_threads import capped_torch_threads  # noqa: F401

# the reference's fire jitted once a shape, as its operator runs it
FIRE = jax.jit(jw.fire_kernel, static_argnames=("panes_per_window", "ring"))

RING_ROWS = (16, 24)


def _jax_state(counts: np.ndarray) -> JaxPaneState:
    return JaxPaneState(None, None, None, jnp.asarray(counts))


def _live_counts(rng, rows, ring, pane_lo, pane_hi, hi=50):
    """Counts that satisfy the operator's ring invariant: only columns of
    live panes [pane_lo, pane_hi] (span < ring) hold data."""
    counts = np.zeros((rows, ring), np.int32)
    for p in range(pane_lo, pane_hi + 1):
        counts[:, p % ring] = rng.integers(0, hi, rows) * (rng.random(rows) < 0.4)
    return counts


# -- K1 ------------------------------------------------------------------------

@pytest.mark.parametrize("ring", RING_ROWS)
@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_counts_matches_preagg_u32(ring, seed):
    """K1 with per-pair counts == _apply_preagg_u32_core (exact)."""
    rng = np.random.default_rng(seed)
    slots = 1024
    rows = slots + 1
    base = rng.integers(0, 100, (rows, ring)).astype(np.int32)
    n_pairs = 3000
    pairs = rng.choice(slots * ring, n_pairs, replace=False).astype(np.int64)
    cnts = rng.integers(1, 0xFFF, n_pairs).astype(np.int64)
    buf = np.full(4096, -1, np.int32)  # padding words 0xFFFFFFFF
    buf[:n_pairs] = ((pairs << 12) | cnts).astype(np.uint32).view(np.int32)
    ref = jw.apply_preagg_u32_kernel(_jax_state(base), jnp.asarray(buf),
                                     ring=ring, dump_row=slots)
    got = wk.scatter_counts(torch.from_numpy(base.copy()),
                            torch.from_numpy(pairs.astype(np.int32)),
                            torch.from_numpy(cnts.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.counts))


@pytest.mark.parametrize("ring", RING_ROWS)
def test_scatter_counts_matches_apply_kernel_count_lane(ring):
    """K1 with +1 per record (invalid records compacted out on the host)
    == apply_kernel's count lane (exact, dump row included)."""
    rng = np.random.default_rng(7)
    slots = 512
    rows = slots + 1
    base = rng.integers(0, 10, (rows, ring)).astype(np.int32)
    b = 20_000
    packed = (rng.integers(0, slots, b) * ring
              + rng.integers(0, ring, b)).astype(np.int32)
    valid = rng.random(b) < 0.8
    packed_ref = np.where(valid, packed, -1).astype(np.int32)
    ref = jw.apply_kernel(_jax_state(base), jnp.asarray(packed_ref), {},
                          agg=jax_count(), ring=ring, dump_row=slots)
    got = wk.scatter_counts(torch.from_numpy(base.copy()),
                            torch.from_numpy(packed[valid]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.counts))


# -- K2 ------------------------------------------------------------------------

@pytest.mark.parametrize("ring", RING_ROWS)
@pytest.mark.parametrize("W", [1, 5, 16])
def test_window_counts_matches_fire_kernel(ring, W):
    """K2 == fire_kernel(...)[3] (exact), with invalid (sentinel) ends and
    windows reaching below pane_lo and above pane_hi."""
    rng = np.random.default_rng(ring * 100 + W)
    rows, ppw = 1025, 10
    pane_lo = 1000 + int(rng.integers(0, ring))
    pane_hi = pane_lo + ring - 3
    counts = _live_counts(rng, rows, ring, pane_lo, pane_hi)
    ends = rng.integers(pane_lo - 3, pane_hi + ppw + 2, W).astype(np.int64)
    w_valid = rng.random(W) < 0.8
    w_valid[0] = True
    ends = np.where(w_valid, ends, jw._END_SENTINEL)
    ref = FIRE(_jax_state(counts), jnp.asarray(ends), jnp.asarray(w_valid),
               jnp.int64(pane_lo), jnp.int64(pane_hi), panes_per_window=ppw,
               ring=ring)[3]
    got = wk.window_counts(torch.from_numpy(counts), torch.from_numpy(ends),
                           torch.from_numpy(w_valid), pane_lo, pane_hi, ppw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- K3 ------------------------------------------------------------------------

def _topn_case(seed, rows, ring, W, n, *, row_cap=256, fill=0, ties=False,
               sparse=False):
    rng = np.random.default_rng(seed)
    ppw = 4
    pane_lo, pane_hi = 200, 200 + ring - 2
    counts = _live_counts(rng, rows, ring, pane_lo, pane_hi,
                          hi=2 if ties else 30)
    if sparse:  # window 0 ends up with fewer than n candidates
        counts[:] = 0
        counts[rng.choice(rows - 1, n - 1, replace=False), pane_lo % ring] = 3
    used = rng.random(rows) < 0.9
    used[-1] = False  # the dump row never holds a key
    ends = (pane_lo + 1 + rng.choice(ring + ppw - 1, W, replace=False)).astype(np.int64)
    ends.sort()
    if sparse:
        used[:-1] = True
        ends[:] = pane_lo + 1 + np.arange(W)
    ring_buf = np.zeros((row_cap + 2, 3), np.int32)
    ring_buf[0, 0] = fill  # appended total so far: exercises wrap-around
    anchor = pane_lo - 5
    return counts, used, ends, ring_buf, anchor, pane_lo, pane_hi, ppw


def _check_topn(case, n, sel_cap, ring):
    counts, used, ends, ring_buf, anchor, pane_lo, pane_hi, ppw = case
    W = len(ends)
    pad = max(jw.MIN_FIRE_PAD, 1 << (W - 1).bit_length())
    params = np.asarray([pane_lo, pane_hi, anchor] + list(ends)
                        + [int(jw._END_SENTINEL)] * (pad - W), np.int64)
    ref = np.asarray(jw._JIT_RING_TOPN(
        _jax_state(counts), jnp.asarray(ring_buf), jnp.asarray(params),
        jnp.asarray(used), agg=jax_count(), panes_per_window=ppw, ring=ring,
        sel_cap=sel_cap, by="count", topn=n))
    w_valid = torch.ones(W, dtype=torch.bool)
    end_t = torch.from_numpy(ends)
    wc = wk.window_counts(torch.from_numpy(counts), end_t, w_valid, pane_lo,
                          pane_hi, ppw)
    got = wk.topn_select_append(wc, torch.from_numpy(used), end_t, w_valid,
                                anchor, n, sel_cap,
                                torch.from_numpy(ring_buf.copy())).numpy()
    # head row and every data row equal; the last row is the reference's
    # scatter dump (padding lanes of its fixed-size selection), which the
    # port reserves and never writes
    np.testing.assert_array_equal(got[:-1], ref[:-1])
    return got


@pytest.mark.parametrize("ring", RING_ROWS)
@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("W", [1, 7, 16])
def test_topn_select_append_matches_ring_append(ring, n, W):
    """K2 + K3 == ring_append_topn_kernel: same rows, same row-major
    order, same head counters (exact)."""
    case = _topn_case(n * 31 + W + ring, 1025, ring, W, n, fill=250)
    got = _check_topn(case, n, sel_cap=256, ring=ring)
    # rows were appended, wrapped past the ring's end at most once, and
    # none were truncated
    assert 250 < got[0, 0] <= 250 + 256 and got[0, 1] == 0


def test_topn_tie_explosion_past_sel_cap():
    """More tied winners than sel_cap: the first sel_cap selected rows
    land, the rest count as truncated in head[0, 1] (exact)."""
    case = _topn_case(5, 1025, 16, 4, 1, ties=True, fill=7)
    got = _check_topn(case, 1, sel_cap=16, ring=16)
    assert got[0, 0] == 7 + 16 and got[0, 1] > 0


def test_topn_window_with_fewer_than_n_candidates():
    """A window with fewer than n candidates selects all of them (the
    threshold is -inf) (exact)."""
    case = _topn_case(9, 257, 16, 1, 5, sparse=True)
    got = _check_topn(case, 5, sel_cap=256, ring=16)
    assert got[0, 0] == 4


# -- K4 ------------------------------------------------------------------------

@pytest.mark.parametrize("ring", RING_ROWS)
def test_ring_columns_purge_matches_clear_kernel(ring):
    """K4 in place (src is dst, identity map, keep = ~mask) ==
    clear_kernel (exact)."""
    rng = np.random.default_rng(ring)
    counts = rng.integers(0, 100, (1025, ring)).astype(np.int32)
    mask = np.zeros(max(ring, 64), np.int32)
    mask[rng.choice(ring, ring // 3, replace=False)] = 1
    ref = jw.clear_kernel(_jax_state(counts), jnp.asarray(mask))
    t = torch.from_numpy(counts.copy())
    out = wk.ring_columns(t, t, torch.arange(ring, dtype=torch.int32),
                          torch.from_numpy(mask[:ring] == 0))
    assert out is t
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref.counts))


@pytest.mark.parametrize("old_ring,new_ring", [(16, 32), (24, 64)])
def test_ring_columns_growth_matches_ring_remap(old_ring, new_ring):
    """K4 out of place at the new width == ring_remap_kernel (exact)."""
    rng = np.random.default_rng(old_ring)
    counts = rng.integers(0, 100, (1025, old_ring)).astype(np.int32)
    lo, hi = 1003, 1003 + old_ring - 2
    cmap = np.full(new_ring, -1, np.int64)
    ps = np.arange(lo, hi + 1)
    cmap[ps % new_ring] = ps % old_ring
    src = np.maximum(cmap, 0).astype(np.int32)
    keep = cmap >= 0
    ref = jw.ring_remap_kernel(_jax_state(counts), jnp.asarray(src),
                               jnp.asarray(keep))
    dst = torch.empty((1025, new_ring), dtype=torch.int32)
    wk.ring_columns(torch.from_numpy(counts), dst, torch.from_numpy(src),
                    torch.from_numpy(keep))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(ref.counts))


@pytest.mark.parametrize("ring", RING_ROWS)
@pytest.mark.parametrize("mode", ["purge", "growth"])
def test_ring_columns_block_count_only(mode, ring):
    """A count() job's state block (the count lane alone, the other lanes
    None) through ring_columns_block: the purge of a cleared run that
    wraps == clear_kernel, a growth to twice the ring == ring_remap_kernel
    (exact)."""
    rng = np.random.default_rng(7 * ring)
    counts = rng.integers(0, 100, (257, ring)).astype(np.int32)
    src = torch.from_numpy(counts.copy())
    lanes = (None, None, None, src)
    if mode == "purge":
        mask = np.zeros(64, np.int32)
        mask[np.arange(ring - 2, ring + 3) % ring] = 1
        ref = jw.clear_kernel(_jax_state(counts), jnp.asarray(mask))
        wk.ring_columns_block(lanes, lanes, torch.arange(ring, dtype=torch.int32),
                              torch.from_numpy(mask[:ring] == 0))
        np.testing.assert_array_equal(src.numpy(), np.asarray(ref.counts))
        return
    cmap = np.full(2 * ring, -1, np.int64)
    ps = np.arange(7 * ring + 3, 8 * ring + 1)
    cmap[ps % (2 * ring)] = ps % ring
    col = np.maximum(cmap, 0).astype(np.int32)
    ref = jw.ring_remap_kernel(_jax_state(counts), jnp.asarray(col),
                               jnp.asarray(cmap >= 0))
    dst = (None, None, None, torch.empty((257, 2 * ring), dtype=torch.int32))
    wk.ring_columns_block(lanes, dst, torch.from_numpy(col),
                          torch.from_numpy(cmap >= 0))
    np.testing.assert_array_equal(dst[3].numpy(), np.asarray(ref.counts))


def test_wrappers_reject_bad_inputs():
    c = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        wk.scatter_counts(c, torch.zeros(3, dtype=torch.int16))
    with pytest.raises(ValueError):
        wk.scatter_counts(c.T, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        wk.ring_columns(c, c, torch.arange(4, dtype=torch.int32),
                        torch.ones(8, dtype=torch.bool))


@pytest.mark.parametrize("case", ["scatter_negative", "scatter_past_end",
                                  "ring_past_source", "ring_negative"])
def test_out_of_range_entries_raise(case):
    """An index outside the tensor raises (the kernels report the same
    entries through their error word); an entry ring_columns does not
    keep is never read, so it may hold anything."""
    c = torch.zeros((4, 8), dtype=torch.int32)
    if case.startswith("scatter"):
        bad = -1 if case == "scatter_negative" else c.numel()
        with pytest.raises(IndexError, match="scatter_counts"):
            wk.scatter_counts(c, torch.tensor([0, bad], dtype=torch.int32))
        return
    bad = 8 if case == "ring_past_source" else -3
    keep = torch.ones(8, dtype=torch.bool)
    src_col = torch.arange(8, dtype=torch.int32)
    src_col[5] = bad
    with pytest.raises(IndexError, match="ring_columns"):
        wk.ring_columns(c, torch.empty_like(c), src_col, keep)
    keep[5] = False
    c[:] = 7
    dst = wk.ring_columns(c, torch.empty_like(c), src_col, keep)
    assert int(dst[:, 5].abs().sum()) == 0 and int(dst.sum()) == 7 * 4 * 7


def test_cpu_tensors_take_the_plain_version():
    """The launch counters move only when a kernel reaches the card."""
    wk.reset_launch_counts()
    c = torch.zeros((4, 8), dtype=torch.int32)
    wk.scatter_counts(c, torch.tensor([0, 9, 9], dtype=torch.int32))
    assert c.view(-1)[9] == 2
    assert all(v == 0 for v in wk.LAUNCHES.values())


def test_a_build_publishes_the_library_whole(monkeypatch, tmp_path):
    """Two processes on one card may both build a source at first use:
    each compiles into a name of its own (``<lib>.<pid>.tmp``) and
    publishes with ``os.replace``, so a loader only ever finds a whole
    library at the final name; a build that finds one there starts no
    compile."""
    import os
    import subprocess

    from flink_tpu_torch.kernels import build

    seen = []

    class FakeCompile:
        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            seen.append((out, os.path.exists(build.library_path("window_kernels"))))
            with open(out, "wb") as f:
                f.write(b"whole")
            self.returncode = 0

        def communicate(self):
            return "", ""

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeCompile)
    final = build.library_path("window_kernels")
    build.build_all(["window_kernels"])
    [(tmp, existed)] = seen
    assert tmp == f"{final}.{os.getpid()}.tmp" and not existed
    assert open(final, "rb").read() == b"whole" and not os.path.exists(tmp)
    build.build_all(["window_kernels"])   # published: no second compile
    assert len(seen) == 1
