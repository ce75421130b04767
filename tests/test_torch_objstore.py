"""The port's object store (``flink_tpu_torch/fs_objstore.py``) and the
maintenance lock's conditional-put branch (``log/bus.py``), against the
reference on the same operations: the ETag (the content's MD5),
``put_if`` and its conflicts, ``listdir`` hiding the ``*.lock~`` server
lock, the ``fs.cas.put`` fault, the store over ``crash://``, the CAS
lock (taken, held, broken when stale, one winner of two racing
breakers, released only by its holder, and the same record format as
the reference's), and an LSM store on ``objstore://`` compacting under
that lock."""
import hashlib
import json
import os
import random
import threading
import time

import numpy as np
import pytest

import flink_tpu.fs_objstore as jax_fso
from flink_tpu import faults as jax_faults
from flink_tpu.fs import CASConflictError as JaxCASConflictError
from flink_tpu.log import topic as jax_topic
from flink_tpu.state.lsm import LsmSpillStore as JaxLsmSpillStore
from flink_tpu_torch import faults, fs_crash
from flink_tpu_torch import fs_objstore as fso
from flink_tpu_torch.fs import CASConflictError, get_filesystem
from flink_tpu_torch.log import bus
from flink_tpu_torch.state.lsm import LsmSpillStore
from test_torch_threads import capped_torch_threads  # noqa: F401

PKGS = {"port": (fso, CASConflictError), "ref": (jax_fso, JaxCASConflictError)}


@pytest.fixture(autouse=True)
def _default_objstore():
    """Tests that re-register ``objstore`` over ``crash://`` put the
    default (prefix-free) registration back in both packages."""
    yield
    fso.install(inner_prefix="")
    jax_fso.install(inner_prefix="")


def _cas_script(mod, err, root):
    """One sequence of object operations; what each step returned."""
    fs = mod.ObjectStoreFileSystem()
    p = f"objstore://{root}/a/obj"
    out = [fs.etag(p)]
    fs.mkdirs(f"objstore://{root}/a")
    t1 = fs.put_if(p, b"v1", None)
    out += [t1, fs.etag(p)]
    for expected in (None, "0" * 32):
        try:
            fs.put_if(p, b"lost", expected)
            out.append("won")
        except err as e:
            out.append(str(e).replace(str(root), "<root>"))
    t2 = fs.put_if(p, b"v2", t1)
    out += [t2, fs.etag(p)]
    with fs.open_write(f"objstore://{root}/a/plain") as f:
        f.write(b"whole ")
        f.write(b"object")
    out.append(fs.etag(f"objstore://{root}/a/plain"))
    # a crashed put_if's server lock: never listed
    open(os.path.join(str(root), "a", "obj.lock~"), "wb").close()
    out.append(sorted(fs.listdir(f"objstore://{root}/a")))
    with fs.open_read(p) as f:
        out.append(f.read())
    return out


def test_etag_put_if_and_listdir_equal_the_reference(tmp_path):
    got = {name: _cas_script(mod, err, tmp_path / name)
           for name, (mod, err) in PKGS.items()}
    assert got["port"] == got["ref"]
    port = got["port"]
    assert port[0] is None
    assert port[1] == port[2] == hashlib.md5(b"v1").hexdigest()
    assert "expected etag" in port[3] and "expected etag" in port[4]
    assert port[5] == port[6] == hashlib.md5(b"v2").hexdigest()
    assert port[7] == hashlib.md5(b"whole object").hexdigest()
    assert port[8] == ["obj", "plain"]
    assert port[9] == b"v2"


def test_failed_put_publishes_nothing(tmp_path):
    fs = fso.ObjectStoreFileSystem()
    p = f"objstore://{tmp_path}/o"
    with pytest.raises(RuntimeError):
        with fs.open_write(p) as f:
            f.write(b"partial")
            raise RuntimeError("writer died")
    assert fs.etag(p) is None and not fs.exists(p)


def test_cas_put_fault_is_a_conflict(tmp_path):
    fs = fso.ObjectStoreFileSystem()
    p = f"objstore://{tmp_path}/o"
    assert "fs.cas.put" in faults.KNOWN_FAULT_POINTS
    assert "fs.cas.put" in jax_faults.KNOWN_FAULT_POINTS
    plan = faults.FaultPlan(seed=3).rule("fs.cas.put", "raise", count=1)
    with plan.activate():
        with pytest.raises(CASConflictError, match="injected fault"):
            fs.put_if(p, b"x", None)
        assert fs.etag(p) is None
        fs.put_if(p, b"x", None)  # one-shot: the retry wins
    assert fs.etag(p) == hashlib.md5(b"x").hexdigest()


def test_objstore_over_crashfs_is_journaled_and_whole(tmp_path):
    """``install(inner_prefix="crash://")``: every object put is a
    journaled atomic publish, so each crash image holds an object whole
    or not at all, and the last put whole once its directory is
    fsynced."""
    root = str(tmp_path / "root")
    cfs = fs_crash.install(root)
    try:
        fs = fso.install(inner_prefix="crash://")
        assert get_filesystem("objstore://x") is fs
        base = f"objstore://{root}"
        fs.mkdirs(base + "/d")
        tags = [None]
        payloads = [bytes([i]) * (fs_crash.BLOCK + 7 * i) for i in range(1, 4)]
        for data in payloads:
            tags.append(fs.put_if(base + "/d/lock", data, tags[-1]))
        kinds = {op.kind for op in cfs.journal}
        assert {"mkdir", "write", "rename", "fsync"} <= kinds
        img = str(tmp_path / "img")
        for seed in range(12):
            cfs.crash(img, rng=random.Random(seed), seed=seed)
            p = os.path.join(img, "d", "lock")
            if os.path.exists(p):
                with open(p, "rb") as f:
                    assert f.read() in payloads
        cfs.crash(img, at=len(cfs.journal), rng=random.Random(0))
        with open(os.path.join(img, "d", "lock"), "rb") as f:
            assert f.read() == payloads[-1]
    finally:
        cfs.close()


def _store_dir(tmp_path, name="store"):
    d = tmp_path / name
    d.mkdir()
    return f"objstore://{d}"


class TestCasMaintenanceLock:
    def test_taken_held_released(self, tmp_path):
        path = _store_dir(tmp_path)
        tok = bus.try_maintenance_lock(path)
        assert isinstance(tok, str) and len(tok) == 32
        rec = json.loads((tmp_path / "store" / bus.MAINT_LOCK).read_bytes())
        assert rec["nonce"] == tok and rec["owner"] == f"pid-{os.getpid()}"
        assert bus.try_maintenance_lock(path) is None
        with pytest.raises(bus.LogError, match="maintenance"):
            with bus.maintenance_pass(path):
                pass
        bus.release_maintenance_lock(path, tok)
        assert not (tmp_path / "store" / bus.MAINT_LOCK).exists()
        with bus.maintenance_pass(path):
            assert (tmp_path / "store" / bus.MAINT_LOCK).exists()
        assert not (tmp_path / "store" / bus.MAINT_LOCK).exists()

    def test_the_reference_sees_the_same_lock(self, tmp_path):
        """One record format: a lock either package takes, the other
        sees held; each releases its own."""
        path = _store_dir(tmp_path)
        tok = bus.try_maintenance_lock(path)
        assert jax_topic.try_maintenance_lock(path) is None
        bus.release_maintenance_lock(path, tok)
        ref_tok = jax_topic.try_maintenance_lock(path)
        assert isinstance(ref_tok, str)
        assert bus.try_maintenance_lock(path) is None
        jax_topic.release_maintenance_lock(path, ref_tok)
        assert bus.try_maintenance_lock(path) is not None

    def _plant_stale(self, tmp_path, path):
        fs = get_filesystem(path)
        stale = json.dumps({
            "owner": "pid-0", "nonce": "dead",
            "acquired_ms": int(time.time() * 1000)
            - bus.MAINT_LOCK_STALE_MS - 1000}, sort_keys=True).encode()
        fs.put_if(os.path.join(path, bus.MAINT_LOCK), stale, None)

    def test_stale_record_is_broken_and_old_holder_cannot_release(
            self, tmp_path):
        path = _store_dir(tmp_path)
        self._plant_stale(tmp_path, path)
        tok = bus.try_maintenance_lock(path)
        assert isinstance(tok, str)
        bus.release_maintenance_lock(path, "dead")  # the crashed holder
        assert bus.try_maintenance_lock(path) is None  # still ours
        bus.release_maintenance_lock(path, tok)
        assert bus.try_maintenance_lock(path) is not None

    def test_of_two_racing_breakers_exactly_one_wins(self, tmp_path,
                                                     monkeypatch):
        path = _store_dir(tmp_path)
        self._plant_stale(tmp_path, path)
        # both breakers read the stale record's ETag before either
        # replaces it
        gate = threading.Barrier(2, timeout=30)
        first = threading.local()
        etag = fso.ObjectStoreFileSystem.etag

        def racing_etag(self, p):
            tag = etag(self, p)
            if p.endswith(bus.MAINT_LOCK) and not getattr(first, "done",
                                                          False):
                first.done = True
                gate.wait()
            return tag

        monkeypatch.setattr(fso.ObjectStoreFileSystem, "etag", racing_etag)
        got = [None, None]

        def breaker(i):
            got[i] = bus.try_maintenance_lock(path)

        threads = [threading.Thread(target=breaker, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        winners = [g for g in got if g is not None]
        assert len(winners) == 1 and isinstance(winners[0], str)
        rec = json.loads((tmp_path / "store" / bus.MAINT_LOCK).read_bytes())
        assert rec["nonce"] == winners[0]

    def test_local_and_schemeless_paths_keep_their_locks(self, tmp_path):
        fd = bus.try_maintenance_lock(str(tmp_path))
        assert isinstance(fd, int) and fd >= 0
        bus.release_maintenance_lock(str(tmp_path), fd)

        class NoCas(type(get_filesystem(str(tmp_path)))):
            pass

        from flink_tpu_torch.fs import register_filesystem
        register_filesystem("nocas", NoCas)
        assert bus.try_maintenance_lock("nocas:///x") == -1


class _Agg:
    """One f32 lane in every lane group: the reference lifts numpy
    columns, the port torch tensors on the CPU."""
    sum_width = max_width = min_width = 1

    def lift_masked(self, data, valid):
        v = data["v"][:, None]
        return v, v, v


def _lsm_fold(cls, store_dir, n=5, hold=None):
    store = cls(_Agg(), store_dir=store_dir, memory_budget_bytes=0,
                num_shards=8, compact_min_runs=99)
    for i in range(n):
        k = (np.arange(24, dtype=np.int64) * (i + 3)) % 7
        p = np.full(24, i % 3, dtype=np.int64)
        v = np.arange(24, dtype=np.float32) * 0.37 + i
        store.absorb(k, p, {"v": v})
    skipped = None
    if hold is not None:
        tok = hold(store_dir)
        skipped = store.compact()
        bus.release_maintenance_lock(store_dir, tok)
    compacted = store.compact()
    scratch = store._fold_runs(store._live_runs(), include_delta=True)
    folded = {int(p): [np.asarray(x).tolist() for x in scratch.panes[p]]
              for p in sorted(scratch.panes)}
    return skipped, compacted, folded, store.compactions, len(
        store._live_runs())


def test_lsm_store_on_objstore_compacts_under_the_cas_lock(tmp_path):
    """Another pass holding the CAS lock makes compaction skip; free, it
    compacts; the folded panes equal the reference's store on the same
    objstore layout, and nothing is left of the lock."""
    port = _lsm_fold(LsmSpillStore, _store_dir(tmp_path, "port"),
                     hold=bus.try_maintenance_lock)
    ref = _lsm_fold(JaxLsmSpillStore, _store_dir(tmp_path, "ref"))
    assert port[0] is False and port[1] is True
    assert port[3] == 1 and port[4] == 1
    assert port[2] == ref[2]
    assert ref[1] is True
    for name in ("port", "ref"):
        names = os.listdir(tmp_path / name)
        assert bus.MAINT_LOCK not in names
        assert not any(n.endswith(".lock~") for n in names)
