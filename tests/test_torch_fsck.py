"""The port's storage fsck (``flink_tpu_torch/fsck.py``) against the JAX
package's, case by case of ``tests/test_fsck.py``: each seeded topic,
checkpoint directory or coordination record is built by one package
(parametrized over both) and checked by both fscks, whose findings —
rules, severities, paths, messages, repair flags — and exit codes must
be equal. A repair runs on a copy of its own for each fsck. The exit
codes come from each package's ``main`` with an ``argparse.Namespace``;
the ``fsck`` command line waits for ROADMAP.md queue 1 item 10."""
import argparse
import glob
import json
import os
import shutil
import time

import numpy as np
import pytest

from test_torch_file_pkgs import BOTH, J, P
from test_torch_threads import capped_torch_threads  # noqa: F401

BUILDERS = pytest.mark.parametrize("B", BOTH, ids=["jax-built", "port-built"])


@pytest.fixture(autouse=True)
def _restore_objstore_default():
    yield
    import flink_tpu.fs_objstore as jfso
    import flink_tpu_torch.fs_objstore as pfso

    jfso.install(inner_prefix="")
    pfso.install(inner_prefix="")


def make_topic(B, root, rows=8, partitions=2, commit=True):
    topic = os.path.join(str(root), "topic")
    ap = B.topic.TopicAppender(topic, partitions=partitions,
                               segment_records=4)
    b = {"k": np.arange(rows, dtype=np.int64),
         "v": np.arange(rows, dtype=np.float64)}
    ap.stage(1, {p: [b] for p in range(partitions)})
    if commit:
        ap.commit(1)
    return topic


def make_checkpoints(B, root):
    st = B.storage.FsCheckpointStorage(os.path.join(str(root), "chk"), "job")
    st.save(1, {"sources": {"0": 1}, "operators": {}})
    st.save_v2(2, {"op_versions": {"7": 1}}, {"7": b"legacy-opaque-bytes"},
               {})
    return os.path.join(str(root), "chk", "job")


def age(path, seconds=3600):
    t = time.time() - seconds
    os.utime(path, (t, t))


def fsck_both(path, repair=False):
    """Both packages' findings over ``path`` (equal), and each one's exit
    code and printed report (equal)."""
    got = {M.name: M.fsck.fsck_path(path, repair=repair) for M in BOTH}
    assert got["port"] == got["jax"]
    return got["port"]


def main_both(path, capsys, as_json=False):
    out = {}
    for M in BOTH:
        rc = M.fsck.main(argparse.Namespace(path=path, repair=False,
                                            json=as_json))
        out[M.name] = (rc, capsys.readouterr())
    assert out["port"] == out["jax"]
    return out["port"][0], out["port"][1].out


def rules_of(findings):
    return {f["rule"] for f in findings}


# -- clean storage -------------------------------------------------------------

@BUILDERS
def test_clean_topic_exits_0(B, tmp_path, capsys):
    rc, out = main_both(make_topic(B, tmp_path), capsys)
    assert rc == 0 and "clean" in out


@BUILDERS
def test_clean_checkpoint_dir_exits_0(B, tmp_path, capsys):
    jdir = make_checkpoints(B, tmp_path)
    assert main_both(jdir, capsys)[0] == 0
    assert main_both(os.path.dirname(jdir), capsys)[0] == 0


def test_unrecognizable_path_exits_2(tmp_path, capsys):
    assert main_both(str(tmp_path / "nope"), capsys)[0] == 2
    (tmp_path / "plain").mkdir()
    assert main_both(str(tmp_path / "plain"), capsys)[0] == 2


# -- seeded corruption ---------------------------------------------------------

@BUILDERS
def test_crc_flip_detected(B, tmp_path, capsys):
    topic = make_topic(B, tmp_path)
    seg = sorted(glob.glob(os.path.join(topic, "p0", "seg-*.colb")))[0]
    data = bytearray(open(seg, "rb").read())
    data[-20] ^= 0xFF
    open(seg, "wb").write(bytes(data))
    assert "SEGMENT_CRC" in rules_of(fsck_both(topic))
    rc, out = main_both(topic, capsys, as_json=True)
    assert rc == 1
    assert any(json.loads(ln)["rule"] == "SEGMENT_CRC"
               for ln in out.strip().splitlines())


@BUILDERS
def test_truncated_segment_detected(B, tmp_path, capsys):
    topic = make_topic(B, tmp_path)
    seg = sorted(glob.glob(os.path.join(topic, "p1", "seg-*.colb")))[0]
    data = open(seg, "rb").read()
    open(seg, "wb").write(data[:len(data) // 2])
    assert "SEGMENT_TRUNCATED" in rules_of(fsck_both(topic))
    assert main_both(topic, capsys)[0] == 1


@BUILDERS
def test_missing_checkpoint_manifest_detected_and_repaired(B, tmp_path,
                                                           capsys):
    jdir = make_checkpoints(B, tmp_path)
    os.remove(os.path.join(jdir, "chk-2", "MANIFEST.json"))
    assert "CHECKPOINT_MANIFEST_MISSING" in rules_of(fsck_both(jdir))
    assert main_both(jdir, capsys)[0] == 1
    for M in BOTH:
        copy = str(tmp_path / f"repair-{M.name}")
        shutil.copytree(jdir, copy)
        repaired = M.fsck.fsck_path(copy, repair=True)
        assert any(f["rule"] == "CHECKPOINT_MANIFEST_MISSING"
                   and f["repaired"] for f in repaired)
        assert not os.path.exists(os.path.join(copy, "chk-2"))
        assert M.fsck.fsck_path(copy) == []
        st = B.storage.FsCheckpointStorage(str(tmp_path), f"repair-{M.name}")
        assert st.latest().checkpoint_id == 1


@BUILDERS
def test_orphan_pre_marker_detected(B, tmp_path, capsys):
    topic = make_topic(B, tmp_path, commit=False)
    assert "ORPHAN_PRE_MARKER" in rules_of(fsck_both(topic))
    assert main_both(topic, capsys)[0] == 1


@BUILDERS
def test_stale_lease_detected(B, tmp_path, capsys):
    topic = make_topic(B, tmp_path)
    ldir = os.path.join(topic, "leases")
    os.makedirs(ldir)
    with open(os.path.join(ldir, "p0.json"), "w") as f:
        json.dump({"owner": "dead-producer", "epoch": 3, "acquired_ms": 1000,
                   "deadline_ms": int(time.time() * 1000) - 60_000}, f)
    assert "STALE_LEASE" in rules_of(fsck_both(topic))
    assert main_both(topic, capsys)[0] == 1


# -- repair safety -------------------------------------------------------------

def _repaired_alike(path, tmp_path):
    """A copy of ``path`` for each fsck, repaired; the findings (paths
    relative to the copy) and the trees left must be equal."""
    out = {}
    for M in BOTH:
        copy = str(tmp_path / f"repair-{M.name}")
        shutil.copytree(path, copy)
        for dirpath, _, files in os.walk(path):  # copytree keeps no mtime
            for name in files:
                src = os.path.join(dirpath, name)
                dst = os.path.join(copy, os.path.relpath(src, path))
                st = os.stat(src)
                os.utime(dst, (st.st_atime, st.st_mtime))
        findings = M.fsck.fsck_path(copy, repair=True)
        for f in findings:
            f["path"] = os.path.relpath(f["path"], copy)
            f["message"] = f["message"].replace(copy, "<root>")
        tree = sorted(os.path.relpath(os.path.join(d, n), copy)
                      for d, _, fs in os.walk(copy) for n in fs)
        out[M.name] = (findings, tree, copy)
    assert out["port"][:2] == out["jax"][:2]
    return out


@BUILDERS
def test_repair_sweeps_orphans_only(B, tmp_path, capsys):
    topic = make_topic(B, tmp_path)
    tmp_file = os.path.join(topic, "p0", "seg-junk.colb.tmp")
    open(tmp_file, "wb").write(b"torn")
    age(tmp_file)
    orphan = os.path.join(topic, "p0", "seg-000000000099-c0000000099-e0.colb")
    open(orphan, "wb").write(b"unreferenced")
    age(orphan)
    ap = B.topic.TopicAppender(topic, partitions=2, segment_records=4)
    ap.stage(2, {0: [{"k": np.arange(4, dtype=np.int64),
                      "v": np.arange(4, dtype=np.float64)}]})
    out = _repaired_alike(topic, tmp_path)
    findings, tree, copy = out["port"]
    swept = {f["path"] for f in findings if f["repaired"]}
    assert swept == {os.path.relpath(tmp_file, topic),
                     os.path.relpath(orphan, topic)}
    assert any(f["rule"] == "ORPHAN_PRE_MARKER" and not f["repaired"]
               for f in findings)
    for M in BOTH:
        c = out[M.name][2]
        assert B.topic.TopicReader(c).committed_offsets() == {0: 8, 1: 8}
        ap2 = B.topic.TopicAppender(c, partitions=2, segment_records=4)
        assert ap2.staged_ids() == [2]
        ap2.commit(2)
        assert M.fsck.main(argparse.Namespace(
            path=c, repair=False, json=False)) == 0
    capsys.readouterr()


@BUILDERS
def test_repair_after_compaction_crash_debris(B, tmp_path, capsys):
    topic = os.path.join(str(tmp_path), "keyed")
    B.topic.create_topic(topic, 1, key_field="k")
    ap = B.topic.TopicAppender(topic, partitions=1, segment_records=6)
    for cid in (1, 2):
        ap.stage(cid, {0: [{"k": np.arange(6, dtype=np.int64) % 3,
                            "v": np.arange(6, dtype=np.int64) + cid * 10}]})
        ap.commit(cid)
    B.bus.Compactor(topic, min_segments=2).compact()
    stray = os.path.join(topic, "p0", "seg-000000000000-c0000000001-e0.colb")
    open(stray, "wb").write(b"superseded debris")
    age(stray)
    out = _repaired_alike(topic, tmp_path)
    findings = out["port"][0]
    assert any(f["path"] == os.path.relpath(stray, topic) and f["repaired"]
               for f in findings)
    for M in BOTH:
        assert M.fsck.main(argparse.Namespace(
            path=out[M.name][2], repair=False, json=False)) == 0
    capsys.readouterr()


# -- detection -----------------------------------------------------------------

@BUILDERS
def test_kind_autodetection(B, tmp_path):
    topic = make_topic(B, tmp_path)
    jdir = make_checkpoints(B, tmp_path)
    for M in BOTH:
        assert M.fsck.detect_kind(topic) == "topic"
        assert M.fsck.detect_kind(jdir) == "checkpoint"
        assert M.fsck.detect_kind(os.path.dirname(jdir)) == "checkpoint"
        assert M.fsck.detect_kind(os.path.join(jdir, "chk-1")) == "checkpoint"
        assert M.fsck.detect_kind(str(tmp_path)) is None


@BUILDERS
def test_lsm_store_clean_then_damaged(B, tmp_path):
    """An LSM state store (``state/lsm.py``) of either package: clean,
    then with a run file cut short and a debris file — the same
    findings from both fscks."""
    import importlib

    lsm = importlib.import_module(f"{B.root}.state.lsm")

    class Agg:
        sum_width = max_width = min_width = 1

        def lift_masked(self, data, valid):
            if B is P:
                v = data["v"].float()[:, None]
            else:
                import jax.numpy as jnp
                v = jnp.asarray(data["v"], jnp.float32)[:, None]
            return v, v, v

    d = str(tmp_path / "store")
    store = lsm.LsmSpillStore(Agg(), store_dir=d, memory_budget_bytes=0,
                              num_shards=8, compact_min_runs=99)
    for i in range(3):
        store.absorb(np.arange(12, dtype=np.int64) % 5,
                     np.full(12, i, np.int64),
                     {"v": np.arange(12, dtype=np.float32) + i})
    assert all(M.fsck.detect_kind(d) == "lsm" for M in BOTH)
    assert fsck_both(d) == []
    runs = sorted(glob.glob(os.path.join(d, "run-*.seg")))
    raw = open(runs[0], "rb").read()
    open(runs[0], "wb").write(raw[:len(raw) - 10])
    open(os.path.join(d, "x.tmp"), "wb").write(b"debris")
    assert rules_of(fsck_both(d)) == {"SEGMENT_TRUNCATED", "ORPHAN_FILE"}


# -- coordination records ------------------------------------------------------

def _bus_topic(B, tmp_path, scheme_prefix=""):
    topic = scheme_prefix + os.path.join(str(tmp_path), "bus")
    ap = B.topic.TopicAppender(topic, partitions=2, segment_records=4,
                               key_field="k")
    ap.stage(1, {p: [{"k": np.arange(8, dtype=np.int64),
                      "v": np.arange(8, dtype=np.float64)}]
                 for p in range(2)})
    ap.commit(1)
    gen, _ix, _n = B.bus.ConsumerGroups.join(topic, "g", "m1")
    B.bus.ConsumerGroups.commit(topic, "g", {0: 8}, generation=gen)
    return topic


@BUILDERS
def test_coherent_bus_topic_is_clean(B, tmp_path):
    assert fsck_both(_bus_topic(B, tmp_path, "objstore://")) == []


@BUILDERS
def test_offset_generation_ahead_of_manifest(B, tmp_path, capsys):
    topic = _bus_topic(B, tmp_path)
    with open(os.path.join(topic, "groups", "g", "p1.json"), "w") as f:
        json.dump({"offset": 4, "generation": 7}, f)
    findings = fsck_both(topic)
    assert rules_of(findings) == {"GROUP_GENERATION_INCOHERENT"}
    assert "ahead" in findings[0]["message"]
    assert main_both(topic, capsys)[0] == 1


@BUILDERS
def test_generation_keyed_offset_without_manifest(B, tmp_path):
    topic = _bus_topic(B, tmp_path)
    os.unlink(os.path.join(topic, "groups", "g", "membership.json"))
    findings = fsck_both(topic)
    assert rules_of(findings) == {"GROUP_GENERATION_INCOHERENT"}
    assert "no membership manifest" in findings[0]["message"]


@BUILDERS
def test_torn_membership_manifest(B, tmp_path):
    topic = _bus_topic(B, tmp_path)
    with open(os.path.join(topic, "groups", "g", "membership.json"),
              "w") as f:
        f.write('{"generation": 1, "mem')
    assert "CORRUPT_CONTROL" in rules_of(fsck_both(topic))


@BUILDERS
def test_stale_cleaner_lease_flagged_live_and_released_quiet(B, tmp_path):
    topic = _bus_topic(B, tmp_path)
    lease = os.path.join(topic, "cleaner.lease")
    now = int(time.time() * 1000)
    rec = {"owner": "svc", "epoch": 1, "pid": os.getpid(),
           "acquired_ms": now, "deadline_ms": now + 60_000}
    for extra in ({}, {"released": True}):
        with open(lease, "w") as f:
            json.dump({**rec, **extra}, f)
        assert fsck_both(topic) == []
    with open(lease, "w") as f:
        json.dump({"owner": "svc", "epoch": 2, "pid": os.getpid(),
                   "acquired_ms": 0, "deadline_ms": 5}, f)
    findings = fsck_both(topic)
    assert rules_of(findings) == {"STALE_CLEANER_LEASE"}
    assert findings[0]["severity"] == "warn"
    assert "epoch+1" in findings[0]["message"]


@BUILDERS
def test_lock_debris_found_through_objstore_and_local(B, tmp_path):
    topic = _bus_topic(B, tmp_path, "objstore://")
    local = os.path.join(str(tmp_path), "bus")
    open(os.path.join(local, "groups", "g", "p0.json.lock~"), "w").close()
    for path in (topic, local):
        findings = fsck_both(path)
        assert rules_of(findings) == {"OBJSTORE_LOCK_DEBRIS"}
        assert findings[0]["repairable"]


@pytest.mark.parametrize("M", BOTH, ids=["jax-fsck", "port-fsck"])
def test_lock_debris_repair_respects_grace_and_maintenance_lock(M, tmp_path):
    topic = _bus_topic(P, tmp_path, "objstore://")
    local = os.path.join(str(tmp_path), "bus")
    debris = os.path.join(local, "cleaner.lease.lock~")
    open(debris, "w").close()
    findings = M.fsck.fsck_path(topic, repair=True)
    assert not findings[0]["repaired"] and os.path.exists(debris)
    age(debris)
    fd = M.topic.try_maintenance_lock(topic)
    assert fd is not None
    try:
        findings = M.fsck.fsck_path(topic, repair=True)
        assert not findings[0]["repaired"] and os.path.exists(debris)
    finally:
        M.topic.release_maintenance_lock(topic, fd)
    findings = M.fsck.fsck_path(topic, repair=True)
    assert findings[0]["repaired"] and not os.path.exists(debris)
    assert M.fsck.fsck_path(topic) == []
