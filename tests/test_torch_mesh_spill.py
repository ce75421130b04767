"""``state.backend`` spill and lsm on a device mesh: the port's
key-sharded operator (eight blocks on ``cpu``) against the JAX package's
sharded operator on its eight forced CPU devices, on
``tests/test_spill.py``'s churn (1,600 keys against 16 resident slots,
two a block): shard-full keys aggregate in the host store, whose rows
ride the same fires, and a top-n (count form and lane form) drains the
emit rings at every fire and re-ranks the host rows against that fire's
device winners over every block's ring.

Rows must equal the reference's in order and exactly (integer values,
so every lane is exact); ``records_spilled`` must equal the reference's
and no record may be dropped. Also: a snapshot mid-stream restored into
4 blocks and into one device, an lsm rescale 2 -> 1 from a checkpoint
set (two spans of 4 blocks each, merged and restored into one mesh),
and the refusal of a RAM spill with live host panes."""
import os

import numpy as np
import pytest
import torch

from flink_tpu_torch.api import environment
from flink_tpu_torch.checkpoint import repartition
from flink_tpu_torch.checkpoint.repartition import RescaleError
from flink_tpu_torch.exchange.partitioners import hash_shards
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.window import WindowOperator
from flink_tpu_torch.parallel.mesh import make_mesh_plan
from flink_tpu_torch.state.lsm import LsmSpillStore
from test_torch_spill import (
    PORT, REF, SLIDING, TUMBLING, assert_rows_equal, canonical, churn_source,
    run_job)
from test_torch_threads import capped_torch_threads  # noqa: F401

N_DEV, SHARDS = 8, 8
COUNT = lambda s, m: s.count()  # noqa: E731
TOP_COUNT = lambda s, m: s.count().top(3, "count")  # noqa: E731
LANES = lambda s, m: s.aggregate(m.multi(m.count(), m.max_of("v"),  # noqa
                                         m.avg_of("v")))
TOP_LANES = lambda s, m: s.aggregate(m.multi(  # noqa: E731
    m.count(), m.max_of("v"), m.avg_of("v"))).top(2, "max_v")
JOBS = {"count": (COUNT, TUMBLING), "lanes": (LANES, SLIDING),
        "topn_count": (TOP_COUNT, SLIDING), "topn_lanes": (TOP_LANES, SLIDING)}


def mesh_conf(pkg, backend, root):
    conf = {"state.num-key-shards": SHARDS, "cluster.mesh-devices": "all"}
    if backend == "lsm":
        conf.update({"state.memory-budget-bytes": 4096,
                     "state.lsm.run-floor-bytes": 4096,
                     "state.lsm.dir": str(root)})
    return conf


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each (package, job, backend) run once for the module."""
    memo = {}

    def get(pkg, job, backend, slots=2):
        key = (id(pkg), job, backend, slots)
        if key not in memo:
            build, window = JOBS[job]
            root = tmp_path_factory.mktemp("mesh-lsm")
            # the port's mesh: eight blocks on the one CPU
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(environment, "visible_devices",
                           lambda device: [torch.device("cpu")] * N_DEV)
                memo[key] = run_job(pkg, slots, build, window,
                                    src=churn_source(4), backend=backend,
                                    extra=mesh_conf(pkg, backend, root))
        return memo[key]
    return get


@pytest.mark.parametrize("backend", ["spill", "lsm"])
@pytest.mark.parametrize("job", sorted(JOBS))
def test_mesh_with_a_host_store_matches_the_reference(runs, job, backend):
    want, wm = runs(REF, job, backend)
    got, gm = runs(PORT, job, backend)
    assert gm["mesh_devices"] == ["cpu"] * N_DEV
    assert gm["records_spilled"] == wm["records_spilled"] > 0
    assert gm.get("records_dropped_full", 0) == 0
    assert_rows_equal(got, want)


@pytest.mark.parametrize("job", ["count", "topn_lanes"])
def test_no_record_is_lost_to_the_mesh(runs, job):
    """The mesh's spill and lsm runs hold the rows of one device with
    every key resident."""
    roomy, rm = runs(PORT, job, "hbm", slots=512)
    assert rm["records_spilled"] == 0
    for backend in ("spill", "lsm"):
        assert canonical(runs(PORT, job, backend)[0]) == canonical(roomy)


def test_lsm_seals_on_the_mesh(tmp_path):
    """The mesh's store is the disk tier: it seals runs at a budget of
    0 and its fires equal the RAM store's."""
    ops = []
    for i, store in enumerate((True, False)):
        kw = {}
        if store:
            kw["spill_store"] = LsmSpillStore(
                ta.count(), store_dir=str(tmp_path / "s"),
                memory_budget_bytes=0, num_shards=SHARDS)
        else:
            kw["spill"] = True
        ops.append(WindowOperator(
            TUMBLING(PORT), ta.count(), num_shards=SHARDS, slots_per_shard=2,
            max_out_of_orderness_ms=800, device="cpu",
            mesh_plan=make_mesh_plan(SHARDS, 2, ["cpu"] * 4), **kw))
    gen = churn_source(4)
    rows = [[], []]
    for i in range(4):
        data, ts = gen(0, i)
        for j, op in enumerate(ops):
            op.process_batch(data["k"], ts, {})
            rows[j].append(dict(op.advance_watermark(int(ts.max()) - 801)))
    assert ops[0]._spill.seals > 0
    assert ops[0].records_spilled == ops[1].records_spilled > 0
    for a, b in zip(*rows):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- checkpoints -----------------------------------------------------------------

def mesh_op(n_blocks, backend, root=None, top=None, shard_range=None,
            shards=SHARDS):
    kw = {}
    if backend == "lsm":
        kw["spill_store"] = LsmSpillStore(
            ta.count(), store_dir=os.path.join(
                str(root), f"lsm-{os.urandom(4).hex()}"),
            memory_budget_bytes=0, num_shards=SHARDS)
    elif backend == "spill":
        kw["spill"] = True
    span = shards if shard_range is None else shard_range[1] - shard_range[0]
    mesh = (make_mesh_plan(span, 2, ["cpu"] * n_blocks) if n_blocks
            else None)
    return WindowOperator(SLIDING(PORT), ta.count(), num_shards=SHARDS,
                          slots_per_shard=2, max_out_of_orderness_ms=800,
                          device="cpu", mesh_plan=mesh, top_n=top,
                          shard_range=shard_range, **kw)


def feed(op, steps):
    out = []
    for keys, ts, wm in steps:
        if keys is not None:
            op.process_batch(keys, ts, {})
        out.append(dict(op.advance_watermark(wm)))
    return out


def steps():
    gen = churn_source(5)
    out = []
    for i in range(5):
        data, ts = gen(0, i)
        out.append((data["k"], ts, int(ts.max()) - 801))
    out.append((None, None, 20_000))
    return out


def rows_of(fires):
    return sorted((int(k), int(e), int(c)) for f in fires
                  for k, e, c in zip(f["key"], f["window_end"], f["count"]))


@pytest.mark.parametrize("backend", ["spill", "lsm"])
@pytest.mark.parametrize("top", [None, ("count", 2)])
def test_snapshot_mid_stream_restores_into_other_block_counts(
        tmp_path, backend, top):
    """A mesh of 8 blocks snapshotted with host-resident state restores
    into 4 blocks and into one device (each with a fresh store of its
    backend; the lsm runs through the snapshot's aux paths) and goes on
    with the uninterrupted run's rows; the flip to the other store and
    the refusal of the hbm backend hold as on one device."""
    st = steps()
    op = mesh_op(N_DEV, backend, tmp_path, top)
    feed(op, st[:3])
    snap = op.snapshot_state()
    assert op.records_spilled > 0
    # the run files ride the checkpoint as links (storage's aux plane),
    # so the store's later purges leave the checkpoint's copies
    aux = snap.pop("__aux_files__", None) or {}
    (tmp_path / "ckpt").mkdir()
    snap["__aux_paths__"] = {}
    for name, path in aux.items():
        os.link(path, tmp_path / "ckpt" / name)
        snap["__aux_paths__"][name] = str(tmp_path / "ckpt" / name)
    assert bool(aux) == (backend == "lsm")
    want = rows_of(feed(op, st[3:]))
    other = "lsm" if backend == "spill" else "spill"
    twins = [mesh_op(4, backend, tmp_path, top),
             mesh_op(0, backend, tmp_path, top)]
    if backend == "spill":
        twins.append(mesh_op(4, other, tmp_path, top))
    for twin in twins:
        twin.restore_state(snap)
        assert rows_of(feed(twin, st[3:])) == want
    if backend == "lsm":
        with pytest.raises(ValueError, match="sealed lsm"):
            mesh_op(4, other, tmp_path, top).restore_state(snap)
    with pytest.raises(ValueError, match="host-spill state"):
        mesh_op(4, "hbm", tmp_path, top).restore_state(snap)


def route(keys, ts, n_proc):
    owner = hash_shards(np.asarray(keys, np.int64), SHARDS) // (SHARDS // n_proc)
    return [(keys[owner == o], ts[owner == o]) for o in range(n_proc)]


def rescale_payload(op, pid, nproc):
    snap = op.snapshot_state()
    spp = SHARDS // nproc
    return {"sources": {}, "sub_factors": {}, "wm_gens": {}, "max_ts": {},
            "out_wm": {}, "operators": {"w": snap}, "op_versions": {"w": 1},
            "partitioners": {}, "sinks": {}, "metrics": {},
            "checkpoint_id": 3,
            "rescale": {"nproc": nproc, "pid": pid, "num_shards": SHARDS,
                        "shard_range": [pid * spp, (pid + 1) * spp]}}


def test_lsm_rescale_two_spans_to_one_mesh(tmp_path):
    """Two processes' meshes (shard spans of 4, 2 blocks each) cut at a
    checkpoint set, their lsm stores merged across the spans
    (``_merge_lsm_spill``) into one payload restored into a mesh of 4
    blocks: before the cut the fleet's rows, after it the new mesh's,
    equal one uninterrupted mesh's."""
    st = steps()
    ref = mesh_op(N_DEV, "lsm", tmp_path)
    olds = [mesh_op(2, "lsm", tmp_path, shard_range=(p * 4, p * 4 + 4))
            for p in range(2)]
    ref_pre = rows_of(feed(ref, st[:3]))
    old_pre = []
    for keys, ts, wm in st[:3]:
        for op, (k, t) in zip(olds, route(keys, ts, 2)):
            op.process_batch(k, t, {})
        for op in olds:
            old_pre.append(dict(op.advance_watermark(wm)))
    assert rows_of(old_pre) == ref_pre and ref_pre
    assert all(op._spill.seals > 0 for op in olds)
    payloads = [rescale_payload(op, p, 2) for p, op in enumerate(olds)]
    merged = repartition.merge_payloads(
        payloads, new_pid=0, new_nproc=1, num_shards=SHARDS,
        slots_per_shard=2, op_kinds={"w": "window"})
    new = mesh_op(4, "lsm", tmp_path)
    new.restore_state(merged["operators"]["w"])
    assert rows_of(feed(new, st[3:])) == rows_of(feed(ref, st[3:]))


def test_ram_spill_with_live_host_panes_refuses_to_rescale(tmp_path):
    st = steps()
    olds = [mesh_op(2, "spill", tmp_path, shard_range=(p * 4, p * 4 + 4))
            for p in range(2)]
    for keys, ts, _ in st[:2]:
        for op, (k, t) in zip(olds, route(keys, ts, 2)):
            op.process_batch(k, t, {})
    payloads = [rescale_payload(op, p, 2) for p, op in enumerate(olds)]
    with pytest.raises(RescaleError, match="live host pane"):
        repartition.merge_payloads(
            payloads, new_pid=0, new_nproc=1, num_shards=SHARDS,
            slots_per_shard=2, op_kinds={"w": "window"})
