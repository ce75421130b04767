"""The LSM state tier (``state.backend = lsm``, ``state/lsm.py``) in the
port, against the JAX package on the same seeded inputs:
``tests/test_lsm.py``'s golden, checkpoint, store and rescale cases.

Rows compare in order and exactly (integers and f32 lanes byte for
byte): both packages fold the spilled keys' lanes on the host in numpy
in one fold order (runs in seal order, the delta last), so the tier's
fired bytes equal the RAM spill tier's with and without sealing and
compaction. Run files are the reference's byte for byte, and a store
directory or snapshot written by either package is read by the
other."""
import os

import numpy as np
import pytest

from flink_tpu.ops import aggregates as ja
from flink_tpu.state.lsm import LsmSpillStore as JaxLsmSpillStore
from flink_tpu.state.lsm import merge_rescale_spill as jax_merge
from flink_tpu.state.spill import HostSpillStore as JaxHostSpillStore
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.window import WindowOperator
from flink_tpu_torch.state.lsm import LsmSpillStore, merge_rescale_spill
from flink_tpu_torch.state.spill import HostSpillStore
from test_torch_spill import (
    LANES, PORT, REF, SLIDING, TUMBLING, assert_rows_equal, canonical,
    churn_source)
from test_torch_threads import capped_torch_threads  # noqa: F401

COUNT = lambda s, m: s.count()  # noqa: E731
JOBS = {"count": (COUNT, TUMBLING), "lanes": (LANES, SLIDING)}


def run_job(pkg, root, job, backend, budget=4096, slots=4, n_batches=3):
    """``job`` over ``tests/test_spill.py``'s churn (1600 keys against
    16 resident slots); the sink's rows, the metrics and the LSM stores'
    (seals, compactions)."""
    build, window = JOBS[job]
    conf = {"state.num-key-shards": 4, "state.slots-per-shard": slots,
            "state.backend": backend, "pipeline.microbatch-size": 256}
    if backend == "lsm":
        conf.update({"state.memory-budget-bytes": budget,
                     "state.lsm.run-floor-bytes": min(budget, 65536),
                     "state.lsm.dir": str(root)})
    env = pkg["env"](pkg["conf"](conf))
    sink = pkg["sink"]()
    s = (env.from_source(pkg["source"](churn_source(n_batches)),
                         pkg["wm"].for_bounded_out_of_orderness(800))
         .key_by("k").window(window(pkg)))
    build(s, pkg["aggs"]).add_sink(sink)
    res = env.execute("lsm-job", **pkg["run"])
    stores = [op._spill for op in env._driver._ops.values()
              if hasattr(getattr(op, "_spill", None), "seals")]
    tiers = (sum(st.seals for st in stores),
             sum(st.compactions for st in stores))
    return sink.rows, res.metrics, tiers


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each (package, job, backend, budget) run once for the module."""
    memo = {}

    def get(pkg, job, backend, budget=4096, slots=4, n_batches=3):
        key = (id(pkg), job, backend, budget, slots, n_batches)
        if key not in memo:
            root = tmp_path_factory.mktemp("lsm")
            memo[key] = run_job(pkg, root, job, backend, budget, slots,
                                n_batches)
        return memo[key]
    return get


# -- TestLsmGolden ---------------------------------------------------------------

@pytest.mark.parametrize("job", sorted(JOBS))
def test_lsm_golden_matches_reference_spill_and_roomy_run(runs, job):
    """4 KiB of delta against ~100x the working set: the port's LSM run
    equals the reference's LSM run and the port's RAM spill run in order,
    byte for byte, and its roomy run as a set."""
    want, wm, wt = runs(REF, job, "lsm")
    got, gm, gt = runs(PORT, job, "lsm")
    assert_rows_equal(got, want)
    assert gm["records_spilled"] == wm["records_spilled"] > 0
    assert gt == wt and gt[0] > 0
    spill, _, _ = runs(PORT, job, "spill")
    assert_rows_equal(got, spill)
    roomy, _, _ = runs(PORT, job, "hbm", slots=2048)
    assert canonical(roomy) == canonical(got)


def test_budget_flip_is_byte_identical(runs):
    """A budget no batch reaches against one that seals constantly: the
    same bytes out, in both packages."""
    never, _, nt = runs(PORT, "count", "lsm", budget=1 << 30)
    always, _, at = runs(PORT, "count", "lsm")
    assert nt == (0, 0) and at[0] > 0
    assert_rows_equal(always, never)
    assert_rows_equal(never, runs(REF, "count", "lsm", budget=1 << 30)[0])


def test_compacting_run_matches_reference(runs):
    """At a budget of 0 every absorb seals and the fourth live run
    compacts (6 batches): the rows still equal the reference's and the
    spill tier's."""
    got, _, gt = runs(PORT, "lanes", "lsm", budget=0, n_batches=6)
    want, _, wt = runs(REF, "lanes", "lsm", budget=0, n_batches=6)
    assert gt == wt and gt[1] > 0
    assert_rows_equal(got, want)
    assert_rows_equal(got, runs(PORT, "lanes", "spill", n_batches=6)[0])


# -- TestLsmCheckpoint -----------------------------------------------------------

def lsm_op(pkg, root, name):
    aggs = pkg["aggs"]
    cls = LsmSpillStore if pkg is PORT else JaxLsmSpillStore
    store = cls(aggs.count(), store_dir=str(root / name),
                memory_budget_bytes=0, num_shards=4)
    return pkg["op"](pkg["tumbling"].of(1_000), aggs.count(), num_shards=4,
                     slots_per_shard=2, max_out_of_orderness_ms=500,
                     spill_store=store, **pkg["run"])


def plain_op(pkg, **kw):
    return pkg["op"](pkg["tumbling"].of(1_000), pkg["aggs"].count(),
                     num_shards=4, slots_per_shard=2,
                     max_out_of_orderness_ms=500, **kw, **pkg["run"])


def host_snapshot(op):
    """A reference operator's snapshot with its panes fetched to host
    arrays (what the port's restore takes)."""
    import jax

    snap = op.snapshot_state()
    snap["panes"] = jax.tree_util.tree_map(np.asarray, snap["panes"])
    return snap


def sorted_rows(fired):
    d = {k: np.asarray(v) for k, v in dict(fired).items()}
    o = np.lexsort((d["key"], d["window_end"]))
    return {k: v[o] for k, v in d.items()}


def test_snapshot_restore_roundtrip_with_runs(tmp_path):
    """Snapshot mid-stream with sealed runs on disk, restore into a
    fresh operator with a fresh store directory (the runs adopted
    through the aux paths), continue: the rows equal an uninterrupted
    twin's, for the port's snapshot and for the reference's."""
    keys = np.arange(40, dtype=np.int64)
    ts1, ts2 = np.full(40, 300, np.int64), np.full(40, 700, np.int64)
    straight = lsm_op(PORT, tmp_path, "straight")
    straight.process_batch(keys, ts1, {})
    straight.process_batch(keys, ts2, {})
    want = sorted_rows(straight.advance_watermark(2_000))
    ref = lsm_op(REF, tmp_path, "ref")
    ref.process_batch(keys, ts1, {})
    jsnap = host_snapshot(ref)
    port = lsm_op(PORT, tmp_path, "a")
    port.process_batch(keys, ts1, {})
    snap = port.snapshot_state()
    assert snap["__aux_files__"], "no sealed runs rode the snapshot"
    assert sorted(snap["__aux_files__"]) == sorted(jsnap["__aux_files__"])
    for name, path in snap["__aux_files__"].items():
        with open(path, "rb") as f, \
                open(jsnap["__aux_files__"][name], "rb") as g:
            assert f.read() == g.read(), name
    ref.process_batch(keys, ts2, {})
    jwant = sorted_rows(ref.advance_watermark(2_000))
    for i, s in enumerate((snap, jsnap)):
        # what storage.load() does: aux logical names -> on-disk paths
        s["__aux_paths__"] = s["__aux_files__"]
        twin = lsm_op(PORT, tmp_path, f"b{i}")
        twin.restore_state(s)
        twin.process_batch(keys, ts2, {})
        got = sorted_rows(twin.advance_watermark(2_000))
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
            np.testing.assert_array_equal(got[f], jwant[f], err_msg=f)


def test_restore_with_runs_into_ram_spill_refuses(tmp_path):
    for pkg in (REF, PORT):
        a = lsm_op(pkg, tmp_path, f"a-{id(pkg)}")
        a.process_batch(np.arange(10, dtype=np.int64),
                        np.full(10, 100, np.int64), {})
        snap = a.snapshot_state()
        assert snap["spill"]["runs"]
        with pytest.raises(ValueError, match="sealed lsm run"):
            plain_op(pkg, spill=True).restore_state(snap)


def test_restore_into_hbm_refuses(tmp_path):
    for pkg in (REF, PORT):
        a = lsm_op(pkg, tmp_path, f"a-{id(pkg)}")
        a.process_batch(np.arange(10, dtype=np.int64),
                        np.full(10, 100, np.int64), {})
        with pytest.raises(ValueError, match="'spill' or 'lsm'"):
            plain_op(pkg).restore_state(a.snapshot_state())


def test_ram_spill_snapshot_restores_into_lsm(tmp_path):
    """The spill→lsm flip: a RAM spill snapshot of either package
    restores into the port's disk tier (it becomes the delta)."""
    ref, port = plain_op(REF, spill=True), plain_op(PORT, spill=True)
    for op in (ref, port):
        op.process_batch(np.arange(40, dtype=np.int64),
                         np.full(40, 300, np.int64), {})
    for i, snap in enumerate((port.snapshot_state(), host_snapshot(ref))):
        assert snap["spill"]["panes"]
        b = lsm_op(PORT, tmp_path, f"b{i}")
        b.restore_state(snap)
        got = dict(b.advance_watermark(2_000))
        assert sorted(int(k) for k in got["key"]) == list(range(40))


# -- TestLsmStoreUnit ------------------------------------------------------------

def mk_store(pkg, root, name="store", budget=0, **kw):
    m = pkg["aggs"]
    cls = LsmSpillStore if pkg is PORT else JaxLsmSpillStore
    return cls(m.multi(m.sum_of("v"), m.max_of("v")),
               store_dir=str(root / name), memory_budget_bytes=budget,
               num_shards=4, **kw)


def churn(store, n_batches=6, n_keys=400, b=128):
    for i in range(n_batches):
        rng = np.random.default_rng(42 + i)
        store.absorb(rng.integers(0, n_keys, b).astype(np.int64),
                     rng.integers(0, 4, b).astype(np.int64),
                     {"v": rng.integers(1, 100, b).astype(np.float32)
                      / np.float32(7)})


def fired(store):
    rows = store.fire([4], panes_per_window=4, pane_ms=1000, offset_ms=0,
                      size_ms=4000)
    return {k: np.asarray(v) for k, v in dict(rows).items()}


def assert_fired_equal(got, want):
    assert list(got) == list(want)
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_tiered_fire_matches_ram_fire_and_reference_bitwise(tmp_path):
    """Every absorb seals (budget 0): the fire is bit-identical to the
    all-RAM store fed the same churn and to the reference's tier, and
    the run files and manifest are the reference's bytes."""
    m = ta.multi(ta.sum_of("v"), ta.max_of("v"))
    ram = HostSpillStore(m)
    port, ref = mk_store(PORT, tmp_path, "p"), mk_store(REF, tmp_path, "r")
    for st in (ram, port, ref):
        churn(st)
    assert port.seals == ref.seals > 0
    assert port.compactions == ref.compactions > 0
    assert_fired_equal(fired(port), fired(ram))
    assert_fired_equal(fired(port), fired(ref))
    names = sorted(os.listdir(port.dir))
    assert names == sorted(os.listdir(ref.dir))
    for n in names:
        with open(os.path.join(port.dir, n), "rb") as f, \
                open(os.path.join(ref.dir, n), "rb") as g:
            assert f.read() == g.read(), n
    assert port.key_count == ref.key_count
    assert port.bytes_used() == ref.bytes_used()


def test_compaction_preserves_fired_bytes(tmp_path):
    out = []
    for pkg in (REF, PORT):
        disk = mk_store(pkg, tmp_path, f"s-{pkg is PORT}",
                        compact_min_runs=99)
        churn(disk)
        before = fired(disk)
        n_before = len(disk._runs)
        assert disk.compact()
        assert len(disk._runs) < n_before
        after = fired(disk)
        assert_fired_equal(after, before)
        out.append(after)
    assert_fired_equal(out[1], out[0])


def test_purge_drops_dead_runs_and_floor_persists(tmp_path):
    disk = mk_store(PORT, tmp_path)
    churn(disk)
    disk.purge_below(4)
    assert disk.fire([4], 4, 1000, 0, 4000) is None
    # dead runs left the manifest; a warm restart keeps the floor, in
    # either package
    for pkg in (PORT, REF):
        again = mk_store(pkg, tmp_path)
        assert again._floor == 4
        assert again.fire([4], 4, 1000, 0, 4000) is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_warm_restart_adopts_either_packages_manifest(tmp_path, writer):
    """A store directory written by one package, opened by the other:
    the manifest is the truth, and the fire is the writer's."""
    a = mk_store(REF if writer == "jax" else PORT, tmp_path)
    churn(a)
    want = fired(a)
    b = mk_store(PORT if writer == "jax" else REF, tmp_path)
    assert_fired_equal(fired(b), want)


def test_orphan_run_swept_on_open(tmp_path):
    a = mk_store(PORT, tmp_path)
    churn(a, n_batches=2)
    orphan = os.path.join(a.dir, "run-000099.seg")
    with open(orphan, "wb") as f:
        f.write(b"crashed seal")
    mk_store(PORT, tmp_path)
    assert not os.path.exists(orphan)


# -- TestLsmRescale --------------------------------------------------------------

def merged_panes(merge, snap, lo, hi):
    out = merge([(snap, snap.get("aux_files") or {})], num_shards=4,
                shard_lo=lo, shard_hi=hi)
    return {int(p): tuple(np.asarray(a) for a in t)
            for p, t in out["delta"]["panes"].items()}


@pytest.mark.parametrize("lo,hi", [(0, 4), (0, 2)])
def test_rescale_merge_filters_by_stored_shard(tmp_path, lo, hi):
    """merge_rescale_spill over a shard range: the store's own fold
    restricted to the range's keys, bit for bit, and the reference's
    merge of the same snapshot (whose runs the reference wrote)."""
    from flink_tpu_torch.exchange.partitioners import hash_shards

    store = mk_store(PORT, tmp_path, budget=4096)
    ref = mk_store(REF, tmp_path, "ref", budget=4096)
    churn(store)
    churn(ref)
    assert store._runs, "churn never sealed: the case would be vacuous"
    got = merged_panes(merge_rescale_spill, store.snapshot(), lo, hi)
    assert got.keys() == merged_panes(jax_merge, ref.snapshot(), lo,
                                      hi).keys()
    for p, t in merged_panes(jax_merge, ref.snapshot(), lo, hi).items():
        for i in range(5):
            np.testing.assert_array_equal(got[p][i], t[i])
    own = store._fold_runs(store._live_runs(), include_delta=True)
    for p, want in own.panes.items():
        keep = (hash_shards(np.asarray(want[0]), 4) >= lo) \
            & (hash_shards(np.asarray(want[0]), 4) < hi)
        if not keep.any():
            assert p not in got or len(got[p][0]) == 0
            continue
        for i in range(5):
            np.testing.assert_array_equal(np.asarray(want[i])[keep],
                                          got[p][i], err_msg=f"{p} {i}")


def test_missing_aux_is_loud(tmp_path):
    store = mk_store(PORT, tmp_path)
    churn(store, n_batches=2)
    snap = store.snapshot()
    assert snap["runs"]
    with pytest.raises(ValueError, match="aux"):
        merge_rescale_spill([(snap, {})], num_shards=4, shard_lo=0,
                            shard_hi=4)


def test_lsm_on_a_mesh_names_its_item(tmp_path):
    from flink_tpu_torch.parallel.mesh import make_mesh_plan

    store = mk_store(PORT, tmp_path)
    with pytest.raises(NotImplementedError, match="queue 1 item 9.2"):
        WindowOperator(PORT["tumbling"].of(1_000), ta.count(),
                       spill_store=store,
                       mesh_plan=make_mesh_plan(8, 16, ["cpu"] * 4),
                       device="cpu")


def test_ram_store_accounting_is_the_reference_stores():
    """The spill store's bytes and keys, by which the LSM tier seals."""
    keys = np.arange(50, dtype=np.int64)
    a, b = HostSpillStore(ta.count()), JaxHostSpillStore(ja.count())
    assert a.bytes_used() == 0 and a.key_count == 0
    for st in (a, b):
        st.absorb(keys, keys % 3, {})
    assert (a.bytes_used(), a.key_count) == (b.bytes_used(), b.key_count)


@pytest.mark.parametrize("point", ["state.run.seal", "state.run.fsync",
                                   "state.compact.swap"])
def test_lsm_fault_points_fire_in_both_packages(tmp_path, point):
    """An injected fault at a seal or a compaction's swap fails the
    absorb with OSError in both packages, leaves the manifest's runs as
    they were, and a reopened store sweeps the debris."""
    from flink_tpu import faults as jf
    from flink_tpu_torch import faults as pf

    seen = []
    for pkg, faults in ((REF, jf), (PORT, pf)):
        name = f"s-{pkg is PORT}"
        store = mk_store(pkg, tmp_path, name, compact_min_runs=2)
        churn(store, n_batches=1)  # one sealed run
        plan = faults.FaultPlan(seed=3).rule(point, "raise", count=1)
        with plan.activate():
            with pytest.raises(OSError, match="injected"):
                churn(store, n_batches=1)
        assert [e[0] for e in plan.log] == [point]
        again = mk_store(pkg, tmp_path, name, compact_min_runs=2)
        files = sorted(os.listdir(again.dir))
        assert not any(f.endswith(".tmp") for f in files), files
        seen.append(([r["name"] for r in again._runs], files))
    assert seen[0] == seen[1]


def test_changelog_link_fault_fails_the_checkpoint(tmp_path):
    """``state.changelog.link`` fires while a checkpoint hardlinks a
    run; the checkpoint fails and leaves no complete checkpoint."""
    from flink_tpu_torch import faults as pf
    from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

    run = tmp_path / "run-000001.seg"
    run.write_bytes(b"sealed")
    st = FsCheckpointStorage(str(tmp_path / "ck"), "job")
    plan = pf.FaultPlan(seed=3).rule("state.changelog.link", "raise",
                                     count=1)
    with plan.activate():
        with pytest.raises(OSError, match="injected"):
            st.save_v2(1, {}, {}, {},
                       op_aux={"4": {"run-000001.seg": str(run)}})
    assert st.list_complete() == []
    h = st.save_v2(2, {}, {}, {}, op_aux={"4": {"run-000001.seg": str(run)}})
    assert h.op_aux == {"4": {"run-000001.seg": "st-4-run-000001.seg"}}
    assert FsCheckpointStorage.load(h)["op_aux_paths"] == {
        4: {"run-000001.seg": os.path.join(h.path, "st-4-run-000001.seg")}}
