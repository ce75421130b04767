"""The keyBy exchange of the port's key-sharded operator, against the JAX
package's: ``bucket_records``' plain version against
``bucket_by_destination`` (with the apply step's rebase to the owner's
block, and overflow), the port's exchange against ``keyby_exchange``
under ``shard_map`` on the reference's eight forced CPU devices, the ring
shuffle against the all-to-all, ``hash_keys`` against
``hash_keys_numpy`` / ``hash_keys_device`` on extreme keys, and the
plain versions of the distributed top-n modes, ``fire_pack``'s row
offset and the scatters' skip of invalid records; the exchange on blocks
of one device (``bucket_records_into``, each source block's buckets
straight into the owners' receive rows) against the reference's
``bucket_by_destination`` + ``all_to_all_records`` under ``shard_map``
on 1 and 3 devices, ``topn_candidates``' plain version against
``lax.top_k`` on the masked grid at k = 1, 3 and the rows, and the two
kernels' launch plans read against the CUDA sources. The split upload's
form of ``bucket_records`` (3 bytes a record, decoded in its launch)
against ``split_cells`` then the flat form and against the reference's
``apply_shard_split`` routing; the exchange receives int32 cells from
it, and a shuffle registered through the SPI still receives flat cells.
Everything here is integer work or copies: results must be equal
exactly."""
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flink_tpu.exchange.keyby import (
    all_to_all_records, bucket_by_destination, keyby_exchange)
from flink_tpu.parallel.mesh import AXIS
from flink_tpu.parallel.mesh import make_mesh_plan as jax_mesh_plan
from flink_tpu.records import hash_keys_device as jax_hash_keys_device
from flink_tpu.ops.window import split_decode as jax_split_decode
from flink_tpu.records import hash_keys_numpy as jax_hash_keys_numpy
from flink_tpu.utils.jaxcompat import shard_map
from flink_tpu_torch import records
from flink_tpu_torch.exchange import keyby, spi
from flink_tpu_torch.kernels import exchange_kernels as ek
from flink_tpu_torch.kernels import lane_kernels as lk
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.window import WindowOperator, split_encode
from flink_tpu_torch.parallel.mesh import (
    HybridMeshPlan, make_hybrid_mesh_plan, make_mesh_plan)
from test_torch_threads import capped_torch_threads  # noqa: F401

N_DEV, SHARDS, SLOTS, RING = 8, 32, 16, 8
SPD = SHARDS // N_DEV * SLOTS


def cells_case(seed, n, n_dest=N_DEV, spd=SPD, ring=RING, hot=0.0):
    """Packed global cells with ~10 % invalid (-1) records; a ``hot``
    share of them on slot 0."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, n_dest * spd, n)
    slots = np.where(rng.random(n) < hot, 0, slots)
    cells = (slots * ring + rng.integers(0, ring, n)).astype(np.int32)
    cells[rng.random(n) < 0.1] = -1
    return cells, rng.random((n, 3)).astype(np.float32)


@pytest.mark.parametrize("capacity,hot", [(64, 0.0), (5, 0.6)])
def test_bucket_records_plain_matches_bucket_by_destination(capacity, hot):
    n_dest, spd, ring = 3, 20, 4
    cells, lanes = cells_case(1, 64, n_dest, spd, ring, hot)
    valid = cells >= 0
    dest = np.where(valid, (np.maximum(cells, 0) // ring) // spd, 0)
    ref, ref_valid, ref_over = bucket_by_destination(
        jnp.asarray(dest, jnp.int32), jnp.asarray(valid),
        {"__sp__": jnp.asarray(cells),
         **{f"x{i}": jnp.asarray(lanes[:, i]) for i in range(3)}},
        n_dest=n_dest, capacity=capacity)
    got_cells, got_lanes, got_valid, got_over = ek.bucket_records(
        torch.from_numpy(cells), torch.from_numpy(lanes), n_dest, capacity,
        spd, ring)
    rv = np.asarray(ref_valid)
    np.testing.assert_array_equal(got_valid.numpy(), rv)
    np.testing.assert_array_equal(got_over.numpy(), np.asarray(ref_over))
    if hot:
        assert got_over.numpy().max() > 0
    # the sender writes each cell rebased to its owner's block, as the
    # reference's apply_shard rebases on receipt
    sp = np.asarray(ref["__sp__"])
    owner = np.arange(n_dest)[:, None]
    rebased = (sp // ring - owner * spd) * ring + sp % ring
    np.testing.assert_array_equal(got_cells.numpy(), np.where(rv, rebased, -1))
    ref_lanes = np.stack([np.asarray(ref[f"x{i}"]) for i in range(3)], -1)
    np.testing.assert_array_equal(got_lanes.numpy(),
                                  np.where(rv[..., None], ref_lanes, 0))


def test_bucket_records_edge_cases():
    """No records, every record invalid, a record on the row past every
    block (the split upload's invalid one), and argument checks."""
    empty = torch.zeros(0, dtype=torch.int32)
    c, p, v, o = ek.bucket_records(empty, None, 2, 3, 4, 2)
    assert c.shape == (2, 3) and p is None and not v.any()
    assert (c == -1).all() and o.tolist() == [0, 0]
    past = torch.tensor([-1, 2 * 4 * 2, 2 * 4 * 2 + 1, 5], dtype=torch.int32)
    c, _, v, o = ek.bucket_records(past, None, 2, 4, 4, 2)
    assert v.sum() == 1 and c[0, 0] == 5 and o.tolist() == [0, 0]
    with pytest.raises(ValueError, match="destinations"):
        ek.bucket_records(empty, None, ek.MAX_DEST + 1, 1, 1, 1)
    with pytest.raises(ValueError, match="payload"):
        ek.bucket_records(past, torch.zeros((4, 1), dtype=torch.int64), 2, 4,
                          4, 2)


@pytest.fixture(scope="module")
def jax_exchange():
    """The reference's exchange under shard_map on its 8 CPU devices:
    (the batch, per device its received (global packed cells, lanes,
    valid))."""
    mp = jax_mesh_plan(num_shards=SHARDS, slots_per_shard=SLOTS)
    assert mp.n_devices == N_DEV
    b_per_dev = 32
    cells, lanes = cells_case(2, N_DEV * b_per_dev)

    def step(sp, x):
        valid = sp >= 0
        dest = jnp.where(valid, (jnp.maximum(sp, 0) // RING) // SPD,
                         0).astype(jnp.int32)
        recv, rv, _ = keyby_exchange(
            dest, valid, {"sp": sp, **{f"x{i}": x[:, i] for i in range(3)}},
            n_devices=N_DEV, capacity=b_per_dev)
        return recv["sp"], jnp.stack([recv[f"x{i}"] for i in range(3)],
                                     -1), rv

    fn = jax.jit(shard_map(step, mesh=mp.mesh, in_specs=(P(AXIS), P(AXIS)),
                           out_specs=(P(AXIS), P(AXIS), P(AXIS))))
    sp, x, rv = (np.asarray(a) for a in fn(jnp.asarray(cells),
                                           jnp.asarray(lanes)))
    n = N_DEV * b_per_dev
    return (cells, lanes, b_per_dev,
            [(sp[d * n:(d + 1) * n], x[d * n:(d + 1) * n], rv[d * n:(d + 1) * n])
             for d in range(N_DEV)])


def port_exchange(impl, cells, lanes, L):
    devs = [torch.device("cpu")] * N_DEV
    return spi.get_shuffle(impl)(
        [torch.from_numpy(cells[j * L:(j + 1) * L]) for j in range(N_DEV)],
        [torch.from_numpy(lanes[j * L:(j + 1) * L]) for j in range(N_DEV)],
        devices=devs, capacity=L, spd=SPD, ring=RING)


@pytest.mark.parametrize("impl", ["all-to-all", "ring"])
def test_exchange_matches_keyby_exchange(jax_exchange, impl):
    """Every block receives the reference device's records, in its
    layout (row j from block j), each at its owner."""
    cells, lanes, L, ref = jax_exchange
    recv, overflow, _ = port_exchange(impl, cells, lanes, L)
    assert sum(int(o.sum()) for o in overflow) == 0
    n_recv = 0
    for d, ((r_cells, r_lanes, r_valid), (sp, x, rv)) in enumerate(
            zip(recv, ref)):
        np.testing.assert_array_equal(r_valid.numpy(), rv)
        local = r_cells.numpy()
        # every received record is at its owner: a cell of this block
        assert ((local[rv] >= 0) & (local[rv] < SPD * RING)).all()
        glob = (local // RING + d * SPD) * RING + local % RING
        np.testing.assert_array_equal(glob[rv], sp[rv])
        np.testing.assert_array_equal(r_lanes.numpy()[rv], x[rv])
        n_recv += int(rv.sum())
    assert n_recv == int((cells >= 0).sum())


def test_ring_shuffle_equals_all_to_all():
    cells, lanes = cells_case(3, N_DEV * 24, hot=0.3)
    a, oa, ma = port_exchange("all-to-all", cells, lanes, 24)
    b, ob, mb = port_exchange("ring", cells, lanes, 24)
    for x, y in zip(a + [tuple(oa)], b + [tuple(ob)]):
        for u, v in zip(x, y):
            assert torch.equal(u, v)
    # bytes between distinct blocks, one bucket being 24 cells (int32),
    # 24 x 3 lanes (f32) and 24 valid flags: all-to-all copies each
    # block's n - 1 foreign buckets once; ring hops each whole block of n
    # buckets n - 1 times
    bucket = 24 * (4 + 3 * 4 + 1)
    assert ma == N_DEV * (N_DEV - 1) * bucket
    assert mb == N_DEV * N_DEV * (N_DEV - 1) * bucket


def test_shuffle_registry():
    assert spi.get_shuffle("ring") is spi.ring_shuffle
    with pytest.raises(ValueError, match="unknown exchange"):
        spi.get_shuffle("carrier-pigeon")
    spi.register_shuffle("mine", spi.all_to_all_shuffle)
    try:
        assert spi.get_shuffle("mine") is spi.all_to_all_shuffle
    finally:
        spi._IMPLS.pop("mine")


def test_hash_keys_matches_the_reference():
    i64 = np.iinfo(np.int64)
    rng = np.random.default_rng(5)
    keys = np.concatenate([
        np.array([0, 1, -1, 2, -2, i64.max, i64.min, i64.min + 1,
                  i64.max - 1, 1 << 32, -(1 << 32), 0x7FFFFFFF], np.int64),
        rng.integers(i64.min, i64.max, 5000, dtype=np.int64)])
    want = jax_hash_keys_numpy(keys)
    np.testing.assert_array_equal(np.asarray(jax_hash_keys_device(
        jnp.asarray(keys))), want)
    np.testing.assert_array_equal(records.hash_keys_numpy(keys), want)
    got = ek.hash_keys(torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        records.hash_keys_device(torch.from_numpy(keys)).numpy(), want)
    assert (got >= 0).all()


def test_mesh_plan_matches_the_reference():
    ref = jax_mesh_plan(num_shards=SHARDS, slots_per_shard=SLOTS)
    mp = make_mesh_plan(SHARDS, SLOTS, ["cpu"] * N_DEV)
    for attr in ("n_devices", "shards_per_device", "slots_per_device",
                 "total_slots", "rows_per_device"):
        assert getattr(mp, attr) == getattr(ref, attr), attr
    assert [mp.shard_range(d) for d in range(N_DEV)] == \
        [ref.shard_range(d) for d in range(N_DEV)]
    slots = np.arange(mp.total_slots)
    np.testing.assert_array_equal(mp.device_of_slot(slots),
                                  ref.device_of_slot(slots))
    np.testing.assert_array_equal(mp.global_slot_to_row(slots),
                                  ref.global_slot_to_row(slots))
    with pytest.raises(ValueError, match="multiple of the device count"):
        make_mesh_plan(30, SLOTS, ["cpu"] * N_DEV)
    for make in (lambda: make_hybrid_mesh_plan(32, 16, 2, 0),
                 lambda: HybridMeshPlan((torch.device("cpu"),), 32, 16)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        keyby.intra_slice_exchange()


def split_grid(seed, rows=40, W=5, n_blocks=4):
    rng = np.random.default_rng(seed)
    wc = rng.integers(0, 6, (rows * n_blocks, W)).astype(np.int32)
    used = rng.random(rows * n_blocks) < 0.8
    return wc, used


@pytest.mark.parametrize("n", [1, 3])
def test_distributed_topn_plain_matches_the_reference_shard(n):
    """Block candidates, their global k-th and each block's select give
    the reference topn_shard's rows: lax.top_k per block, the k-th of the
    gathered candidates, ``v >= thresh`` per block, block-major."""
    rows, W, nb = 40, 5, 4
    wc, used = split_grid(7, rows, W, nb)
    w_valid = np.array([True, True, False, True, True])
    ends = torch.arange(100, 100 + W, dtype=torch.int64)
    k = min(n, rows)
    # each block's candidates in its columns of one gathered buffer
    gathered = torch.full((W, nb * k), 7.0)
    for b in range(nb):
        sl = slice(b * rows, (b + 1) * rows)
        c = wk.topn_candidates(torch.from_numpy(wc[sl]),
                               torch.from_numpy(used[sl]),
                               torch.from_numpy(w_valid), k,
                               out=gathered[:, b * k:(b + 1) * k])
        nz = (wc[sl] > 0) & used[sl][:, None] & w_valid[None, :]
        v = np.where(nz, wc[sl].astype(np.float32), -np.inf)
        np.testing.assert_array_equal(
            c.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(v.T), k)[0]))
    thresh = wk.topn_global_threshold(gathered, k)
    np.testing.assert_array_equal(
        thresh.numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(gathered.numpy()), k)[0])[:, k - 1])
    ring = torch.zeros((256 + 2, 3), dtype=torch.int32)
    want = []
    for b in range(nb):
        sl = slice(b * rows, (b + 1) * rows)
        wk.topn_select_given(torch.from_numpy(wc[sl]),
                             torch.from_numpy(used[sl]), ends,
                             torch.from_numpy(w_valid), 90, gathered, k,
                             b * rows, 256, ring)
        nz = (wc[sl] > 0) & used[sl][:, None] & w_valid[None, :]
        r, w = np.nonzero(nz & (wc[sl] >= thresh.numpy()[None, :]))
        want += [[b * rows + rr, 100 + ww - 90, wc[sl][rr, ww]]
                 for rr, ww in zip(r, w)]
    assert int(ring[0, 0]) == len(want) and int(ring[0, 1]) == 0
    np.testing.assert_array_equal(ring[1:1 + len(want)].numpy(),
                                  np.asarray(want, np.int32).reshape(-1, 3))


def _gathered_case(seed, n_blocks, k, rows=20, W=6):
    """Blocks of a (rows, W) count grid each: window 0 with the same top
    values in every block (ties across blocks at the k-th place), window
    1 with three candidates in all (fewer than k for k > 3: the global
    threshold -inf), window 2 invalid, the rest small counts with many
    ties; some rows unused."""
    rng = np.random.default_rng(seed)
    wc = rng.integers(0, 5, (n_blocks, rows, W)).astype(np.int32)
    used = rng.random((n_blocks, rows)) < 0.85
    used[:, :k] = True
    wc[:, :k, 0] = 9
    wc[:, :, 1] = 0
    wc[0, 2, 1], wc[-1, 5, 1], wc[-1, 6, 1] = 4, 4, 2
    used[0, 2] = used[-1, 5] = used[-1, 6] = True
    w_valid = np.ones(W, bool)
    w_valid[2] = False
    return wc, used, w_valid


@pytest.fixture(scope="module")
def gathered_reference():
    """The reference's topn_shard on every (blocks, k) case below, run
    op by op: lax.top_k of each block's masked values, their gather,
    lax.top_k(all_top, k)[0][:, k - 1], and _topn_select_append of each
    block in turn into one ring with its row offset."""
    from flink_tpu.ops import window as jw
    from flink_tpu.ops.aggregates import count as jax_count

    out = {}
    for nb in GATHER_BLOCKS:
        for k in GATHER_KS:
            wc, used, w_valid = _gathered_case(nb * 100 + k, nb, k)
            rows, W = wc.shape[1:]
            ends = jnp.arange(100, 100 + W, dtype=jnp.int64)
            nz = (wc > 0) & used[:, :, None] & w_valid[None, None, :]
            v = np.where(nz, wc.astype(np.float32), -np.inf)
            tops = [jax.lax.top_k(jnp.asarray(v[b].T), k)[0]
                    for b in range(nb)]
            all_top = jnp.concatenate(tops, axis=1)
            thresh = jax.lax.top_k(all_top, k)[0][:, k - 1]
            ring = jnp.zeros((512 + 2, 3), jnp.int32)
            empty = jnp.zeros((rows, W, 0), jnp.float32)
            for b in range(nb):
                ring = jw._topn_select_append(
                    ring, empty, empty, empty, jnp.asarray(wc[b]),
                    jnp.asarray(nz[b]), jnp.asarray(v[b]), thresh, ends, 90,
                    agg=jax_count(), sel_cap=256, row_offset=b * rows)
            out[nb, k] = (np.asarray(all_top), np.asarray(thresh),
                          np.asarray(ring))
    return out


GATHER_BLOCKS = (1, 2, 4)
GATHER_KS = (1, 3, 16)


@pytest.mark.parametrize("n_blocks", GATHER_BLOCKS)
@pytest.mark.parametrize("k", GATHER_KS)
def test_gathered_select_plain_matches_the_reference(gathered_reference,
                                                     n_blocks, k):
    """``topn_select_given``'s gathered form (each window's threshold the
    k-th of the gathered candidates, worked out inside the select) on
    each block in turn: the gathered buffer, the k-th (ties across
    blocks counted each time, -inf with fewer than k candidates in all)
    and the ring rows equal the reference's topn_shard."""
    all_top, thresh, ref_ring = gathered_reference[n_blocks, k]
    wc, used, w_valid = _gathered_case(n_blocks * 100 + k, n_blocks, k)
    rows, W = wc.shape[1:]
    ends = torch.arange(100, 100 + W, dtype=torch.int64)
    gathered = torch.empty((W, n_blocks * k), dtype=torch.float32)
    for b in range(n_blocks):
        wk.topn_candidates(torch.from_numpy(wc[b]), torch.from_numpy(used[b]),
                           torch.from_numpy(w_valid), k,
                           out=gathered[:, b * k:(b + 1) * k])
    np.testing.assert_array_equal(gathered.numpy(), all_top)
    np.testing.assert_array_equal(
        wk.topn_global_threshold(gathered, k).numpy(), thresh)
    assert thresh[0] == 9 and (k <= 3 or np.isneginf(thresh[1]))
    assert np.isneginf(thresh[2])
    ring = torch.zeros((512 + 2, 3), dtype=torch.int32)
    for b in range(n_blocks):
        wk.topn_select_given(torch.from_numpy(wc[b]), torch.from_numpy(used[b]),
                             ends, torch.from_numpy(w_valid), 90, gathered,
                             k, b * rows, 256, ring)
    n = int(ref_ring[0, 0])
    assert n > 0 and int(ring[0, 0]) == n and int(ring[0, 1]) == 0
    np.testing.assert_array_equal(ring[:1 + n].numpy(), ref_ring[:1 + n])
    # every block's tied 9s in window 0 select, block-major
    w0 = ring[1:1 + n].numpy()
    assert int((w0[:, 1] == 10).sum()) == n_blocks * k


def test_gathered_select_refusals():
    wc = torch.ones((4, 65), dtype=torch.int32)
    args = (torch.ones(4, dtype=torch.bool), torch.arange(65),
            torch.ones(65, dtype=torch.bool), 0)
    ring = torch.zeros((10, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 64 windows"):
        wk.topn_select_given(wc, *args, torch.ones((65, 2)), 1, 0, 8, ring)
    with pytest.raises(ValueError, match="1 <= k <= 2"):
        wk.topn_select_given(wc[:, :3].contiguous(), args[0], args[1][:3],
                             args[2][:3], 0, torch.ones((3, 2)), 3, 0, 8, ring)
    buf = torch.empty((3, 6))
    with pytest.raises(ValueError, match="out must be"):
        wk.topn_candidates(wc[:, :3].contiguous(), args[0], args[2][:3], 2,
                           out=buf[:, :3])


def test_fire_pack_row_offset_and_skipping_scatters():
    rng = np.random.default_rng(8)
    counts = torch.from_numpy(rng.integers(0, 3, (9, 4)).astype(np.int32))
    args = (counts, None, None, None, torch.tensor([3, 4], dtype=torch.int64),
            torch.ones(2, dtype=torch.bool), torch.ones(9, dtype=torch.bool),
            0, 3, 2, 64, False)
    base, _ = lk.fire_pack(*args)
    off, _ = lk.fire_pack(*args, row_offset=27)
    n = int(base[0, 0])
    assert torch.equal(off[0], base[0])
    assert torch.equal(off[1:1 + n, 0], base[1:1 + n, 0] + 27)
    assert torch.equal(off[1:1 + n, 1:], base[1:1 + n, 1:])
    with pytest.raises(ValueError, match="row offset"):
        lk.fire_pack(*args[:-1], True, row_offset=1)
    # a negative cell is an invalid record when asked, an error otherwise
    idx = torch.tensor([3, -1, 3, 5, -1], dtype=torch.int32)
    a, b = torch.zeros(16, dtype=torch.int32).view(4, 4), None
    wk.scatter_counts(a, idx, skip_negative=True)
    assert a.view(-1)[3] == 2 and a.view(-1)[5] == 1 and int(a.sum()) == 3
    with pytest.raises(IndexError):
        wk.scatter_counts(a, idx)
    sums = torch.zeros((4, 4, 1))
    b = torch.zeros((4, 4), dtype=torch.int32)
    s = torch.arange(5, dtype=torch.float32)[:, None]
    empty = torch.zeros((5, 0))
    lk.scatter_lanes(b, sums, None, None, idx, s, empty, empty,
                     skip_negative=True)
    assert torch.equal(b, a) and float(sums.view(-1)[3]) == 2.0
    with pytest.raises(IndexError):
        lk.scatter_lanes(b, sums, None, None, idx, s, empty, empty)


# -- the exchange on blocks of one device ----------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_exchange(n, capacity, block_cells, C):
    """The reference's bucket_by_destination + all_to_all_records under
    shard_map over the first ``n`` of the conftest's CPU devices: per
    device its received global cells, lanes and valid, and its overflow."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), (AXIS,))

    def step(sp, x):
        valid = (sp >= 0) & (sp < n * block_cells)
        dest = jnp.where(valid, sp // block_cells, 0).astype(jnp.int32)
        buckets, bv, over = bucket_by_destination(
            dest, valid, {"sp": sp, **{f"x{i}": x[:, i] for i in range(C)}},
            n_dest=n, capacity=capacity)
        recv, rv = all_to_all_records(buckets, bv)
        lanes = (jnp.stack([recv[f"x{i}"] for i in range(C)], -1) if C
                 else jnp.zeros((n * capacity, 0), jnp.float32))
        return recv["sp"], lanes, rv, over

    return jax.jit(shard_map(step, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
                             out_specs=(P(AXIS),) * 4))


@pytest.mark.parametrize("n,L,capacity,hot,wide,C", [
    (3, 48, 48, 0.0, False, 2),    # block-sized buckets
    (3, 48, 6, 0.6, False, 2),     # a small capacity, hot keys, overflow
    (3, 48, 48, 0.3, True, 0),     # int64 cells past 2^31
    (1, 40, 40, 0.0, False, 3),    # one destination
    (1, 40, 7, 0.0, True, 1),      # one destination, overflow, int64
])
def test_one_device_exchange_matches_the_reference(n, L, capacity, hot, wide,
                                                   C):
    """keyby_exchange over blocks of one device (``bucket_records_into``'s
    plain version a source block, no copy): every block's received cells
    (rebased), lanes and valid mask, each source's overflow and the bytes
    counted equal the reference's exchange and the copies' count."""
    spd, ring = (1 << 29, 4) if wide else (20, 4)
    rng = np.random.default_rng(L + capacity + n)
    slots = rng.integers(0, n * spd, n * L)
    slots = np.where(rng.random(n * L) < hot, slots[0], slots)
    cells = slots * ring + rng.integers(0, ring, n * L)
    cells[rng.random(n * L) < 0.1] = -1
    cells = cells.astype(np.int64 if wide else np.int32)
    lanes = rng.random((n * L, C)).astype(np.float32)
    sp, x, rv, over = (np.asarray(a) for a in _reference_exchange(
        n, capacity, spd * ring, C)(jnp.asarray(cells), jnp.asarray(lanes)))
    recv, overflow, moved = keyby.keyby_exchange(
        [torch.from_numpy(cells[j * L:(j + 1) * L]) for j in range(n)],
        [torch.from_numpy(lanes[j * L:(j + 1) * L]) if C else None
         for j in range(n)],
        devices=[torch.device("cpu")] * n, capacity=capacity, spd=spd,
        ring=ring)
    np.testing.assert_array_equal(
        np.concatenate([o.numpy() for o in overflow]), over)
    if capacity < L and not wide:
        assert over.max() > 0
    m = n * capacity
    for d, (r_cells, r_lanes, r_valid) in enumerate(recv):
        ok = rv[d * m:(d + 1) * m]
        np.testing.assert_array_equal(r_valid.numpy(), ok)
        assert r_cells.dtype == torch.from_numpy(cells).dtype
        want = np.where(ok, sp[d * m:(d + 1) * m] - d * spd * ring, -1)
        np.testing.assert_array_equal(r_cells.numpy(), want)
        if C:
            np.testing.assert_array_equal(
                r_lanes.numpy(), np.where(ok[:, None], x[d * m:(d + 1) * m], 0))
        else:
            assert r_lanes is None
    row = capacity * (cells.itemsize + 1 + 4 * C)
    assert moved == n * (n - 1) * row


def test_copy_exchange_equals_the_one_device_exchange():
    """The exchange between distinct devices (each block's buckets, then
    ``all_to_all_records``' row copies), run here on CPU blocks, receives
    what the one-device form writes straight into the receive rows, and
    counts the same bytes."""
    n, L, spd, ring = 3, 40, 20, 4
    cells, lanes = cells_case(6, n * L, n, spd, ring, hot=0.4)
    src = [torch.from_numpy(cells[j * L:(j + 1) * L]) for j in range(n)]
    pay = [torch.from_numpy(lanes[j * L:(j + 1) * L]) for j in range(n)]
    devs = [torch.device("cpu")] * n
    buckets = [keyby.bucket_by_destination(src[j], pay[j], n_dest=n,
                                           capacity=L, spd=spd, ring=ring)[0]
               for j in range(n)]
    copied, moved = keyby.all_to_all_records(buckets, devs)
    direct, _, direct_moved = keyby.keyby_exchange(
        src, pay, devices=devs, capacity=L, spd=spd, ring=ring)
    assert moved == direct_moved
    for a, b in zip(copied, direct):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_bucket_records_into_is_the_buckets_transposed():
    """Each source's direct form writes row j of every owner's block with
    what its bucket d holds, at the most destinations a launch takes; bad
    receive rows raise."""
    n, L, spd, ring = ek.MAX_DEST, 300, 3, 2
    rng = np.random.default_rng(11)
    recv = (torch.full((n, 2, L), 7, dtype=torch.int32),
            torch.full((n, 2, L, 1), 7, dtype=torch.int32),
            torch.zeros((n, 2, L), dtype=torch.bool))
    for j in range(2):
        cells = torch.from_numpy(rng.integers(-1, n * spd * ring + 5, L)
                                 .astype(np.int32))
        pay = torch.from_numpy(rng.integers(0, 9, (L, 1)).astype(np.int32))
        over = ek.bucket_records_into(cells, pay, n, L, spd, ring, recv, j)
        b_cells, b_pay, b_valid, b_over = ek.bucket_records(
            cells, pay, n, L, spd, ring)
        assert torch.equal(over, b_over)
        assert torch.equal(recv[0][:, j], b_cells)
        assert torch.equal(recv[1][:, j], b_pay)
        assert torch.equal(recv[2][:, j], b_valid)
    with pytest.raises(ValueError, match="recv"):
        ek.bucket_records_into(cells, None, n, L, spd, ring, recv, 0)
    with pytest.raises(ValueError, match="source block"):
        ek.bucket_records_into(cells, pay, n, L, spd, ring, recv, 2)


# -- the split upload's form of bucket_records ----------------------------------------

def split_case(seed, n, n_dest=3, spd=20, ring=4):
    """A source block's records as the split upload's bytes with ~10 %
    invalid (slot 0xFFFF), some on the row past every block (slot n_dest
    * spd) and a hot slot, its lifted lanes, and the global slots and
    columns they encode."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, n_dest * spd, n)
    slots = np.where(rng.random(n) < 0.2, slots[0], slots)
    slots[rng.random(n) < 0.05] = n_dest * spd
    slots[1] = n_dest * spd
    cols = rng.integers(0, ring, n).astype(np.uint8)
    valid = rng.random(n) > 0.1
    valid[:3] = [True, True, False]
    sc = split_encode(slots, cols, valid)
    assert (sc[:, :2].view(np.uint16) == 0xFFFF).any()
    assert (sc[:, :2].view(np.uint16) == n_dest * spd).any()
    return sc, rng.random((n, 3)).astype(np.float32)


@pytest.mark.parametrize("with_lanes,capacity", [(True, 64), (False, 64),
                                                 (True, 7)])
def test_bucket_records_split_form_is_the_decoded_form(with_lanes, capacity):
    """The split form's plain version, and ``bucket_records_into``'s, equal
    ``split_cells`` (the row past every block as the dump row) then the
    flat form, bit for bit: int32 cells, slot 0xFFFF and slot n_dest * spd
    going nowhere, overflow counted alike."""
    n_dest, spd, ring = 3, 20, 4
    sc, lanes = split_case(3, 64, n_dest, spd, ring)
    sc_t = torch.from_numpy(sc)
    pay = torch.from_numpy(lanes) if with_lanes else None
    flat = wk.split_cells_plain(sc_t, ring, n_dest * spd)
    got = ek.bucket_records(sc_t, pay, n_dest, capacity, spd, ring)
    want = ek.bucket_records(flat, pay, n_dest, capacity, spd, ring)
    assert got[0].dtype == torch.int32 == ek.bucket_cell_dtype(sc_t)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert int(got[2].sum()) < len(sc)   # the invalid and dump-row records
    recv = tuple(None if t is None else torch.full(
        (n_dest, 2) + t.shape[1:], 5, dtype=t.dtype) for t in got[:3])
    over = ek.bucket_records_into(sc_t, pay, n_dest, capacity, spd, ring,
                                  recv, 1)
    assert torch.equal(over, want[3])
    for r, b in zip(recv, want[:3]):
        if r is not None:
            assert torch.equal(r[:, 1], b)
            assert torch.equal(r[:, 0], torch.full_like(r[:, 0], 5))


def test_bucket_records_split_form_matches_apply_shard_split():
    """Against the reference's routing of a split upload
    (``apply_shard_split``: the decode to packed cells, -1 for slot
    0xFFFF, then ``apply_shard``'s destination and rebase over
    ``bucket_by_destination``): the same records in the same bucket
    positions; slot n_dest * spd goes nowhere in both."""
    n_dest, spd, ring, capacity = 3, 20, 4, 40
    sc, lanes = split_case(4, 64, n_dest, spd, ring)
    slot, col = (np.asarray(a) for a in jax_split_decode(jnp.asarray(sc)))
    packed = np.where(slot == 0xFFFF, -1, slot.astype(np.int32) * ring
                      + col.astype(np.int32)).astype(np.int32)
    valid = packed >= 0
    dest = np.where(valid, (np.maximum(packed, 0) // ring) // spd, 0)
    ref, ref_valid, ref_over = bucket_by_destination(
        jnp.asarray(dest, jnp.int32), jnp.asarray(valid),
        {"__sp__": jnp.asarray(packed),
         **{f"x{i}": jnp.asarray(lanes[:, i]) for i in range(3)}},
        n_dest=n_dest, capacity=capacity)
    got_cells, got_lanes, got_valid, got_over = ek.bucket_records(
        torch.from_numpy(sc), torch.from_numpy(lanes), n_dest, capacity, spd,
        ring)
    rv = np.asarray(ref_valid)
    np.testing.assert_array_equal(got_valid.numpy(), rv)
    np.testing.assert_array_equal(got_over.numpy(), np.asarray(ref_over))
    sp = np.asarray(ref["__sp__"])
    owner = np.arange(n_dest)[:, None]
    rebased = (sp // ring - owner * spd) * ring + sp % ring
    np.testing.assert_array_equal(got_cells.numpy(), np.where(rv, rebased, -1))
    ref_lanes = np.stack([np.asarray(ref[f"x{i}"]) for i in range(3)], -1)
    np.testing.assert_array_equal(got_lanes.numpy(),
                                  np.where(rv[..., None], ref_lanes, 0))


def test_bucket_records_split_form_refusals():
    """A slot past the row beyond every block, or a column past the ring,
    raises naming ``split_cells``; a split upload over 0xFFFF or more
    global slots, a ring past 256 columns or records not 3 bytes wide is
    refused."""
    n_dest, spd, ring = 3, 20, 4
    for slots, cols in (([1, n_dest * spd + 1], [0, 1]), ([1, 2], [0, ring])):
        bad = torch.from_numpy(split_encode(np.array(slots),
                                            np.array(cols, np.uint8),
                                            np.ones(2, bool)))
        with pytest.raises(IndexError, match="split_cells"):
            ek.bucket_records(bad, None, n_dest, 8, spd, ring)
    sc = torch.from_numpy(split_case(5, 16)[0])
    for args in ((3, 8, 0xFFFF // 3 + 1, 4), (3, 8, 20, 257)):
        with pytest.raises(ValueError, match="split upload"):
            ek.bucket_records(sc, None, *args)
    with pytest.raises(ValueError, match="split upload"):
        ek.bucket_records(torch.zeros((4, 2), dtype=torch.uint8), None, 3, 8,
                          20, 4)


def test_one_device_exchange_receives_int32_cells_from_split_bytes():
    """``keyby_exchange`` over blocks of one device fed the split upload's
    bytes receives int32 flat cells: what the exchange of the decoded
    cells receives, with the same bytes counted."""
    n, L, spd, ring = 3, 40, 20, 4
    parts = [split_case(10 + j, L, n, spd, ring) for j in range(n)]
    sc = [torch.from_numpy(p[0]) for p in parts]
    pay = [torch.from_numpy(p[1]) for p in parts]
    devs = [torch.device("cpu")] * n
    got = keyby.keyby_exchange(sc, pay, devices=devs, capacity=L, spd=spd,
                               ring=ring)
    want = keyby.keyby_exchange(
        [wk.split_cells_plain(c, ring, n * spd) for c in sc], pay,
        devices=devs, capacity=L, spd=spd, ring=ring)
    assert got[2] == want[2]
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    for a, b in zip(got[0], want[0]):
        assert a[0].dtype == torch.int32
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    ring_got = spi.ring_shuffle(sc, pay, devices=devs, capacity=L, spd=spd,
                                ring=ring)
    for a, b in zip(ring_got[0], want[0]):
        assert a[0].dtype == torch.int32
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_registered_shuffle_receives_flat_cells(monkeypatch):
    """A shuffle registered through the SPI still receives each source
    block's flat int32 cells (the operator decodes a split upload for it
    with ``split_cells``), while the built-in shuffle's bucketing takes
    the bytes themselves; both give the same rows."""
    seen, bucketed = [], []

    def flat_spy(cells, payload, **kw):
        seen.extend((c.dtype, c.dim()) for c in cells)
        return spi.all_to_all_shuffle(cells, payload, **kw)

    into = ek.bucket_records_into

    def into_spy(cells, *args):
        bucketed.append(cells.dtype)
        return into(cells, *args)

    monkeypatch.setattr(ek, "bucket_records_into", into_spy)
    spi.register_shuffle("flat-spy", flat_spy)
    try:
        rows = []
        for impl in ("all-to-all", "flat-spy"):
            op = WindowOperator(
                TumblingEventTimeWindows.of(1000),
                ta.multi(ta.count(), ta.max_of("v")), num_shards=SHARDS,
                slots_per_shard=SLOTS, device="cpu",
                mesh_plan=make_mesh_plan(SHARDS, SLOTS, ["cpu"] * 4),
                exchange_impl=impl)
            assert op._split_upload
            rng = np.random.default_rng(8)
            out = []
            for i in range(3):
                keys = rng.integers(0, 60, 200)
                ts = i * 1000 + rng.integers(0, 1000, 200)
                op.process_batch(keys, ts, {"v": rng.random(200).astype(
                    np.float32)})
                out.append(dict(op.advance_watermark(i * 1000 + 999)))
            rows.append(out)
    finally:
        spi._IMPLS.pop("flat-spy")
    assert seen and all(s == (torch.int32, 1) for s in seen)
    assert torch.uint8 in bucketed and torch.int32 in bucketed
    for a, b in zip(*rows):
        assert list(a) == list(b) and len(a["key"]) > 0
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# -- topn_candidates' plain version against lax.top_k ------------------------------

@pytest.fixture(scope="module")
def candidate_grid():
    """A (rows, W) count grid with unused rows and an invalid window: a
    window whose 3rd value is a three-way tie, one with counts past 2^24
    (2^24 + 1 and 2^24 tie as f32), one with two candidates, and the
    masked values lax.top_k ranks."""
    rows, W = 40, 6
    rng = np.random.default_rng(21)
    wc = rng.integers(0, 50, (rows, W)).astype(np.int32)
    used = rng.random(rows) < 0.85
    used[:8] = True
    w_valid = np.array([True, True, True, False, True, True])
    wc[:, 0] = np.minimum(wc[:, 0], 5)
    wc[:5, 0] = [9, 8, 6, 6, 6]
    wc[:4, 1] = [(1 << 24) + 1, 1 << 24, (1 << 24) + 3, 1 << 25]
    wc[:, 2] = 0
    wc[6:8, 2] = [3, 3]
    cand = (wc > 0) & used[:, None] & w_valid[None, :]
    v = np.where(cand, wc.astype(np.float32), -np.inf)
    return wc, used, w_valid, v


@pytest.mark.parametrize("k", [1, 3, 40])
def test_topn_candidates_plain_matches_lax_top_k(candidate_grid, k):
    wc, used, w_valid, v = candidate_grid
    got = wk.topn_candidates(torch.from_numpy(wc), torch.from_numpy(used),
                             torch.from_numpy(w_valid), k)
    want = np.asarray(jax.lax.top_k(jnp.asarray(v.T), k)[0])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (wc.shape[1], k)
    assert np.isneginf(want[3]).all() and np.isneginf(want[2, 2:]).all()


# -- the launch plans against the sources ------------------------------------------

def _csrc(name):
    with open(os.path.join(os.path.dirname(ek.__file__), "csrc", name)) as f:
        return f.read()


def test_bucket_and_candidate_plans_match_the_sources():
    """bucket_records: MAX_DEST and the tile are the kernel's, its
    workspace an epoch line and a tile's descriptors on whole 128-byte
    lines; topn_candidates one kernel at top-1 and up to top-16 (each
    block's top k, then the last block's merge), the radix select above
    (one cooperative launch, six past 32 windows or where it does not
    fit); both entry points' argument blocks a word a C argument."""
    xs, ws = _csrc("exchange_kernels.cu"), _csrc("window_kernels.cu")
    assert f"constexpr int kMaxDest = {ek.MAX_DEST};" in xs
    assert "constexpr int kLbLine = 16;" in _csrc("lookback.cuh")
    for tiles, n_dest, want in ((256, 4, 16 + 256 * 16), (1, 1, 32),
                                (2, 17, 16 + 2 * 32), (32, 64, 16 + 32 * 64)):
        assert ek.bucket_work_words(tiles, n_dest) == want
    for fn, entry in (("xk_bucket_records", ek._BUCKET_RECORDS),):
        sig = re.search(rf"int {fn}\((.*?)\)", xs, re.S).group(1)
        assert sig.count(",") == entry._struct.size // 8   # + the stream
    sig = re.search(r"int fk_topn_candidates\((.*?)\)", ws, re.S).group(1)
    assert sig.count(",") == wk._TOPN_CANDIDATES._struct.size // 8
    sel = _csrc("topn_select.cuh")
    assert f"constexpr int kCandItems = {wk.CAND_ITEMS};" in sel
    assert f"constexpr int kCandSmallK = {wk.CAND_SMALL_K};" in sel
    for rows, W, k, fits, want in (
            (8193, 11, 1, True, (90, 1, 0)),            # M1's fire
            (8193, 11, 3, True, (90, 1, 90 * 11 * 3)),  # its top-3: the merge
            (8193, 11, 17, True, (90, 1, 11 * 17)),     # the radix, one launch
            (8193, 11, 17, False, (90, 6, 11 * 17)),
            (8193, 33, 17, True, (293, 6, 33 * 17)),
            (300, 300, 3, True, (88, 6, 900)),          # past 256 windows
            (1, 40, 5, True, (1, 1, 0))):
        assert tuple(wk.candidates_plan(rows, W, k, fits=fits)) == want
