"""Top-n by a result field over lanes on a device mesh: the port's
key-sharded operator (eight blocks on ``cpu``) against the JAX package's
sharded operator on its eight forced CPU devices, and the two kernels of
that path, ``topn_candidates_lanes`` and ``topn_select_lanes_given``
(their plain versions, since the tensors lie on the CPU), against the
reference's ``topn_shard`` steps (``lax.top_k`` over the -inf-masked
ranking grid, ``lax.top_k`` of the gathered candidates) on the same
seeded inputs. tests/test_torch_cuda.py holds the CUDA kernels against
the same plain versions on the card.

Rows must equal the reference's in order (block-major, as both drains
read): keys, window bounds, counts, max and min fields exactly, NaN and
signed zeros included (ranked in IEEE total order, selected by IEEE
``>=``). Prices are integers wherever a ranking is by an average, so
its sums are exact and the rows equal; ``test_float_average_follows_the
margin_rule`` ranks float averages and holds them to the margin rule of
tests/test_torch_topn_lanes.py, each value within (2 * count + 4) *
2^-24 of the reference's."""
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
from flink_tpu.ops.window import WindowOperator as JaxWindowOperator
from flink_tpu.parallel.mesh import make_mesh_plan as jax_mesh_plan
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.kernels import topn_lanes_kernels as tk
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.window import WindowOperator
from flink_tpu_torch.parallel.mesh import make_mesh_plan
from test_torch_threads import capped_torch_threads  # noqa: F401

U = 2.0 ** -24
N_DEV, SHARDS, SLOTS = 8, 16, 32
LANE_AGG = lambda m: m.multi(m.count(), m.max_of("price"), m.min_of("price"),
                             m.avg_of("price"))


def port_mesh(n=N_DEV):
    return make_mesh_plan(SHARDS, SLOTS, ["cpu"] * n)


def op_pair(by, n, assigner=(1_000, None), n_blocks=N_DEV, **kw):
    size, slide = assigner
    args = dict(num_shards=SHARDS, slots_per_shard=SLOTS, top_n=(by, n),
                max_out_of_orderness_ms=1_000, **kw)
    jwin = JaxTumbling.of(size) if slide is None else JaxSliding.of(size, slide)
    twin = (TumblingEventTimeWindows.of(size) if slide is None
            else SlidingEventTimeWindows.of(size, slide))
    ref = JaxWindowOperator(jwin, LANE_AGG(ja),
                            mesh_plan=jax_mesh_plan(SHARDS, SLOTS), **args)
    assert ref.mesh_plan.n_devices == N_DEV, "conftest forces 8 CPU devices"
    port = WindowOperator(twin, LANE_AGG(ta), device="cpu",
                          mesh_plan=port_mesh(n_blocks), **args)
    return ref, port


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=k)


def stream(seed, n_batches=6, keys=200, per=300, specials=()):
    """Sliding-friendly batches: ``per`` records over ``keys`` keys a
    second, integer prices, and ``specials`` (batch, values) planted at
    the head of a batch."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        k = rng.integers(0, keys, per)
        ts = i * 1_000 + rng.integers(0, 1_500, per)
        price = rng.integers(0, 60, per).astype(np.float32)
        for b, vals in specials:
            if b == i:
                price[:len(vals)] = vals
        out.append((k, ts, price, i * 1_000))
    return out


def run(op, steps, drain_each=True):
    fired = []
    for keys, ts, price, wm in steps:
        op.process_batch(np.asarray(keys), np.asarray(ts),
                         {"price": np.asarray(price, np.float32)})
        f = op.advance_watermark(wm)
        if drain_each:
            fired.append(dict(f))
    fired.append(dict(op.advance_watermark(op.final_watermark())))
    return fired


CASES = {
    # (by, n, assigner, specials)
    "top1_max": ("max_price", 1, (1_000, None), ()),
    "top3_avg": ("avg_price", 3, (4_000, 1_000), ()),
    "top2_min": ("min_price", 2, (4_000, 1_000), ()),
    "nan_top": ("max_price", 1, (1_000, None), ((2, [np.nan, np.inf]),)),
    "signed_zeros": ("min_price", 2, (1_000, None),
                     ((1, [-0.0, 0.0, -0.0, 0.0, -0.0]),)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_lane_topn_matches_the_reference(case):
    by, n, assigner, specials = CASES[case]
    ref, port = op_pair(by, n, assigner)
    steps = stream(11, specials=specials)
    want, got = run(ref, steps), run(port, steps)
    assert sum(len(f["key"]) for f in want) > 5
    for g, w in zip(got, want):
        assert_same(g, w)
    assert port.exchange_overflow == 0


def test_ties_across_blocks_are_kept():
    """Every key of a window has the same max: each block's top-1 ties
    the global one, and every candidate row of every block is kept (a
    window appends more than n rows)."""
    ref, port = op_pair("max_price", 1)
    keys = np.arange(64)
    steps = [(keys, np.full(64, 100), np.full(64, 7.0, np.float32), 0)]
    want, got = run(ref, steps), run(port, steps)
    for g, w in zip(got, want):
        assert_same(g, w)
    assert len(got[-1]["key"]) == 64
    blocks = {int(port.directory.assign(np.array([k]))[0])
              // port.mesh_plan.slots_per_device for k in keys}
    assert len(blocks) > 1


def test_window_with_fewer_candidates_than_k_emits_all():
    ref, port = op_pair("max_price", 3)
    steps = [(np.array([1, 2]), np.array([10, 20]),
              np.array([-np.inf, 4.0], np.float32), 0)]
    want, got = run(ref, steps), run(port, steps)
    for g, w in zip(got, want):
        assert_same(g, w)
    assert sorted(got[-1]["key"].tolist()) == [1, 2]


def test_one_drain_reads_many_fires():
    """Drained once at the end: every fire's rows, block by block."""
    ref, port = op_pair("max_price", 2, (4_000, 1_000))
    steps = stream(5)
    want = run(ref, steps, drain_each=False)
    got = run(port, steps, drain_each=False)
    assert_same(got[-1], want[-1])
    assert len(np.unique(got[-1]["window_end"])) > 3


def test_the_path_runs_the_lane_kernels(monkeypatch):
    """Each chunk runs ``topn_candidates_lanes`` and
    ``topn_select_lanes_given`` on every block against one gathered
    buffer, and neither the count form nor the one-device select."""
    seen = []
    for name in ("topn_candidates_lanes", "topn_select_lanes_given"):
        orig = getattr(tk, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(tk, name, spy)

    def never(*a, **k):
        raise AssertionError("count-form or one-device select on the path")
    for mod, name in ((wk, "topn_candidates"), (wk, "topn_select_given"),
                      (tk, "topn_select_lanes")):
        monkeypatch.setattr(mod, name, never)
    _, port = op_pair("max_price", 1)
    run(port, stream(2, n_batches=3))
    assert seen.count("topn_candidates_lanes") == \
        seen.count("topn_select_lanes_given") > 0
    assert seen.count("topn_candidates_lanes") % N_DEV == 0


def test_float_average_follows_the_margin_rule():
    """Float prices ranked by their average (top-3): per window, the
    port's rows equal the reference's where the 3rd and 4th reference
    values lie further apart than their bounds; where closer, its picks
    lie among the rows tied with the 3rd within the bounds."""
    ref, port = op_pair("avg_price", 3, (2_000, 1_000))
    rng = np.random.default_rng(9)
    steps = [(rng.integers(0, 120, 400), i * 1_000 + rng.integers(0, 1_500, 400),
              (rng.standard_normal(400) * 40).astype(np.float32), i * 1_000)
             for i in range(4)]
    want = run(ref, steps, drain_each=False)[-1]
    got = run(port, steps, drain_each=False)[-1]
    # every row's reference average from a top-n-free reference twin
    full = JaxWindowOperator(JaxSliding.of(2_000, 1_000), LANE_AGG(ja),
                             num_shards=SHARDS, slots_per_shard=SLOTS,
                             max_out_of_orderness_ms=1_000)
    allrows = run(full, steps, drain_each=False)
    allrows = {k: np.concatenate([f[k] for f in allrows]) for k in allrows[0]}
    for we in np.unique(allrows["window_end"]):
        m = allrows["window_end"] == we
        v = allrows["avg_price"][m].astype(np.float64)
        c = allrows["count"][m].astype(np.float64)
        keys = allrows["key"][m]
        bound = (2 * c + 4) * U * np.abs(v)
        gk = set(got["key"][got["window_end"] == we].tolist())
        wk_ = set(want["key"][want["window_end"] == we].tolist())
        order = np.argsort(-v, kind="stable")
        if len(order) <= 3:
            assert gk == wk_ == set(keys.tolist())
            continue
        t, u = order[2], order[3]
        if v[t] - v[u] > bound[t] + bound[u]:
            assert gk == wk_
        else:
            tied = {int(keys[i]) for i in range(len(v))
                    if v[i] >= v[t] - bound[i] - bound[t]}
            assert gk <= tied and len(gk) >= 3


def test_snapshot_restores_into_four_blocks_and_loads_the_reference():
    """A lane top-n mesh snapshotted mid-stream: its own snapshot in an
    operator of 4 blocks and the reference's sharded snapshot loaded
    into 8 and 4 blocks all continue with the reference's rows."""
    ref, port = op_pair("max_price", 2, (2_000, 1_000))
    steps = stream(4, n_batches=5)
    for s in steps[:3]:
        for op in (ref, port):
            op.process_batch(s[0], s[1], {"price": s[2]})
            dict(op.advance_watermark(s[3]))
    snap = port.snapshot_state()
    jsnap = ref.snapshot_state()
    jsnap["panes"] = jax.tree_util.tree_map(np.asarray, jsnap["panes"])
    twins = [op_pair("max_price", 2, (2_000, 1_000), n_blocks=b)[1]
             for b in (4, N_DEV, 4)]
    twins[0].restore_state(snap)
    twins[1].load_jax_snapshot(jsnap)
    twins[2].load_jax_snapshot(jsnap)
    want = run(ref, steps[3:])
    for t in twins:
        for g, w in zip(run(t, steps[3:]), want):
            assert_same(g, w)


# -- the two kernels' plain versions against the reference's steps -----------------

def grid(seed, rows=37, W=5, specials=True):
    rng = np.random.default_rng(seed)
    wc = np.where(rng.random((rows, W)) < 0.7,
                  rng.integers(1, 4, (rows, W)), 0).astype(np.int32)
    v = rng.integers(-6, 7, (rows, W)).astype(np.float32)
    if specials:
        v[0, 0], v[1, 0] = np.nan, -np.nan
        v[2, 1], v[3, 1] = -0.0, 0.0
        v[4, 2], v[5, 2] = np.inf, -np.inf
        v[:, 3] = -np.nan          # a window of -NaN candidates
        wc[:, 3] = 1
    used = rng.random(rows) < 0.9
    valid = np.array([True] * (W - 1) + [False])
    return wc, v, used, valid


def ref_candidates(wc, v, used, valid, k):
    nz = (wc > 0) & used[:, None] & valid[None, :]
    masked = jnp.where(jnp.asarray(nz), jnp.asarray(v), -jnp.inf)
    return np.asarray(jax.lax.top_k(masked.T, k)[0])


@pytest.mark.parametrize("k", [1, 3, 17])
def test_candidates_plain_matches_lax_top_k(k):
    wc, v, used, valid = grid(k)
    got = tk.topn_candidates_lanes(torch.from_numpy(wc), torch.from_numpy(v),
                                   torch.from_numpy(used),
                                   torch.from_numpy(valid), k)
    want = ref_candidates(wc, v, used, valid, k)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    out = torch.full((wc.shape[1], 2 * k), 5.0)
    tk.topn_candidates_lanes(torch.from_numpy(wc), torch.from_numpy(v),
                             torch.from_numpy(used), torch.from_numpy(valid),
                             k, out=out[:, k:])
    np.testing.assert_array_equal(out[:, k:].numpy().view(np.int32),
                                  want.view(np.int32))
    assert (out[:, :k] == 5.0).all()


@pytest.mark.parametrize("k", [1, 2, 4])
def test_select_given_plain_matches_the_reference_threshold(k):
    """Two blocks' candidates gathered, the reference's k-th of each
    window's gathered row (``lax.top_k``), and the rows with IEEE ``v >=
    k-th``, appended with block 1's row offset after block 0's."""
    blocks = [grid(40 + b) for b in range(2)]
    rows = blocks[0][0].shape[0]
    cands = np.concatenate([ref_candidates(*g, k) for g in blocks], axis=1)
    thresh = np.asarray(jax.lax.top_k(jnp.asarray(cands), k)[0][:, k - 1])
    ends = np.arange(10, 15, dtype=np.int64)
    F = 2
    ring = torch.zeros((300, 3 + F), dtype=torch.int32)
    want = []
    for b, (wc, v, used, valid) in enumerate(blocks):
        cols = np.random.default_rng(b).integers(0, 99, wc.shape + (F,)) \
            .astype(np.int32)
        tk.topn_select_lanes_given(
            torch.from_numpy(wc), torch.from_numpy(v), torch.from_numpy(cols),
            torch.from_numpy(used), torch.from_numpy(ends),
            torch.from_numpy(valid), 8, torch.from_numpy(cands), k, b * rows,
            256, ring)
        sel = ((wc > 0) & used[:, None] & valid[None, :]
               & (v >= thresh[None, :]))
        for r, w in zip(*np.nonzero(sel)):
            want.append([r + b * rows, ends[w] - 8, wc[r, w], *cols[r, w]])
    ring = ring.numpy()
    assert ring[0, 0] == len(want) and ring[0, 1] == 0
    np.testing.assert_array_equal(ring[1:1 + len(want)],
                                  np.asarray(want, np.int32).reshape(-1, 3 + F))
    # a +NaN k-th selects nothing in its window; window 3 (all -NaN) none
    assert not np.any(ring[1:1 + len(want), 1] == ends[3] - 8)


def test_select_given_refuses_bad_shapes():
    wc, v, used, valid = grid(1, specials=False)
    args = [torch.from_numpy(a) for a in (wc, v)]
    cols = torch.zeros(wc.shape + (1,), dtype=torch.int32)
    ring = torch.zeros((10, 4), dtype=torch.int32)
    ends = torch.arange(wc.shape[1], dtype=torch.int64)
    with pytest.raises(ValueError, match="1 <= k"):
        tk.topn_select_lanes_given(*args, cols, torch.from_numpy(used), ends,
                                   torch.from_numpy(valid), 0,
                                   torch.zeros((wc.shape[1], 2)), 3, 0, 4,
                                   ring)
    with pytest.raises(ValueError, match="emit_ring"):
        tk.topn_select_lanes_given(*args, cols, torch.from_numpy(used), ends,
                                   torch.from_numpy(valid), 0,
                                   torch.zeros((wc.shape[1], 2)), 1, 0, 4,
                                   torch.zeros((10, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="1 <= k"):
        tk.topn_candidates_lanes(*args, torch.from_numpy(used),
                                 torch.from_numpy(valid), wc.shape[0] + 1)
