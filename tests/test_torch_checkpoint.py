"""The port's exactly-once checkpoints against the JAX package's, on the
CPU: storage (layouts, retention, the incremental hardlink reuse,
compression, v1/v2/v3 loading), the blob format, the coordinator's
async commit, and whole jobs that crash and resume — Q5 with bids made
on the device at K = 4 sub-batches, Q5 host-fed, job S (Q5 host-fed
with most keys in the host spill store, and in the LSM tier, whose
sealed runs ride the checkpoints as hardlinks), a tumbling count
window, session windows on a host pool of 4 (with a pool task's fault
too), Nexmark Q7 (windowAll) and Q8 (the windowed join, both modes) —
whose committed rows must equal the reference's in order, and the
golden. Checkpoints cross between the packages both ways, and a
checkpoint of one job at one cut holds the same payload tree in both.

Cases ported from tests/test_checkpoint.py, test_checkpoint_async.py,
test_checkpoint_format.py, test_checkpoint_compression.py,
test_subbatch.py::TestCheckpointAcrossSubBatch and
test_devgen.py::TestCheckpointRestore; each runs in both packages.
Integers, row order and float32 count-window sums compare exactly
(the port's count lanes add in the reference's order)."""
import dataclasses
import json
import os
import pickle
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from flink_tpu.native_codec import native_available
from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id, row_view
from test_torch_threads import capped_torch_threads  # noqa: F401

needs_native = pytest.mark.skipif(
    not native_available(), reason="needs the C codec (devgen miss repair)")
both = pytest.mark.parametrize("P", BOTH, ids=pkg_id)


# -- storage ------------------------------------------------------------------

def storage_retention(P, root):
    st = P.storage.FsCheckpointStorage(root, "job1", retained=2)
    for i in range(1, 5):
        st.save(i, {"x": np.arange(i), "checkpoint_id": i})
    latest = st.latest()
    return ([h.checkpoint_id for h in st.list_complete()], latest.checkpoint_id,
            list(P.storage.FsCheckpointStorage.load(latest)["x"]))


def storage_savepoints(P, root):
    st = P.storage.FsCheckpointStorage(root, "job1", retained=1)
    st.save(1, {"a": 1}, savepoint=True)
    for i in range(2, 5):
        st.save(i, {"a": i})
    return [(h.checkpoint_id, h.is_savepoint) for h in st.list_complete()]


def storage_incomplete(P, root):
    st = P.storage.FsCheckpointStorage(root, "job1")
    st.save(1, {"a": 1})
    os.makedirs(os.path.join(root, "job1", "chk-2"))  # no manifest
    return st.latest().checkpoint_id


def storage_v1(P, root):
    d = os.path.join(root, "j", "chk-7")
    os.makedirs(d)
    with open(os.path.join(d, "state.pkl"), "wb") as f:
        pickle.dump({"checkpoint_id": 7, "operators": {0: {"a": 1}}}, f)
    with open(os.path.join(d, "MANIFEST.json"), "w") as f:
        json.dump({"checkpoint_id": 7, "timestamp_ms": 1, "job_id": "j",
                   "savepoint": False, "format_version": 1}, f)
    h = P.storage.FsCheckpointStorage(root, "j").latest()
    return h.checkpoint_id, P.storage.FsCheckpointStorage.load(h)["operators"]


def storage_legacy_v2(P, root):
    d = os.path.join(root, "job", "chk-9")
    os.makedirs(d)
    with open(os.path.join(d, "meta.pkl"), "wb") as f:
        pickle.dump({"watermark": 9}, f)
    with open(os.path.join(d, "op-3.pkl"), "wb") as f:
        pickle.dump({"counts": np.arange(4)}, f)
    with open(os.path.join(d, "MANIFEST.json"), "w") as f:
        json.dump({"checkpoint_id": 9, "timestamp_ms": 0, "job_id": "job",
                   "savepoint": False, "format_version": 2,
                   "compression": "none",
                   "ops": {"3": {"file": "op-3.pkl", "version": 1}}}, f)
    out = P.storage.FsCheckpointStorage.load(d)
    return out["watermark"], out["operators"][3]["counts"].tolist()


def storage_v3_single(P, root):
    st = P.storage.FsCheckpointStorage(root, "job")
    h = st.save(1, {"watermark": 5, "arr": np.arange(3)})
    m = json.loads(open(os.path.join(h.path, "MANIFEST.json")).read())
    return (m["format_version"], m["layout"],
            P.storage.FsCheckpointStorage.load(h)["arr"].tolist())


def storage_v2_blobs(P, root):
    st = P.storage.FsCheckpointStorage(root, "job")
    blob = P.blobformat.encode({"counts": np.ones(4, np.int32)})
    h = st.save_v2(1, {"op_versions": {"7": 1}}, {"7": blob}, {})
    out = P.storage.FsCheckpointStorage.load(h)
    raw = open(os.path.join(h.path, "op-7.blob"), "rb").read()
    return (out["operators"][7]["counts"].tolist(), P.blobformat.is_v3(raw),
            out["op_file_versions"])


def storage_hardlink(P, root):
    st = P.storage.FsCheckpointStorage(root, "j")
    blob = pickle.dumps({"state": np.arange(1000)})
    h1 = st.save_v2(1, {"op_versions": {"5": 3}}, {"5": blob}, {})
    f1 = os.path.join(h1.path, "op-5.blob")
    h2 = st.save_v2(2, {"op_versions": {"5": 3}}, {},
                    {"5": P.storage.ReusedOpState(f1, 3)})
    f2 = os.path.join(h2.path, "op-5.blob")
    same = os.path.samefile(f1, f2)
    st.retained = 1
    st._retire_old()  # retiring the base keeps the reused blob readable
    return (same, os.path.exists(h1.path),
            int(pickle.loads(open(f2, "rb").read())["state"][999]))


def storage_v2_base_reuse(P, root):
    base = os.path.join(root, "job", "chk-1")
    os.makedirs(base)
    legacy = os.path.join(base, "op-5.pkl")
    with open(legacy, "wb") as f:
        pickle.dump({"counts": np.arange(6)}, f)
    st = P.storage.FsCheckpointStorage(root, "job")
    h = st.save_v2(2, {}, {}, {"5": P.storage.ReusedOpState(legacy, 3)})
    return P.storage.FsCheckpointStorage.load(h)["operators"][5]["counts"].tolist()


STORAGE_CASES = [storage_retention, storage_savepoints, storage_incomplete,
                 storage_v1, storage_legacy_v2, storage_v3_single,
                 storage_v2_blobs, storage_hardlink, storage_v2_base_reuse]


@pytest.mark.parametrize("case", STORAGE_CASES, ids=lambda c: c.__name__)
def test_storage_cases_match_the_reference(case, tmp_path):
    """tests/test_checkpoint.py's, test_checkpoint_async.py's and
    test_checkpoint_format.py's storage cases: the port returns what the
    reference returns, in two fresh directories."""
    got = case(PORT, str(tmp_path / "port"))
    want = case(JAX, str(tmp_path / "jax"))
    assert repr(got) == repr(want)
    assert {
        storage_retention: ([3, 4], 4, [0, 1, 2, 3]),
        storage_savepoints: [(1, True), (4, False)],
        storage_incomplete: 1,
        storage_hardlink: (True, False, 999),
    }.get(case, got) == got


def test_bad_compression_is_refused():
    for P in BOTH:
        with pytest.raises(ValueError, match="compression"):
            P.storage.FsCheckpointStorage("/nonexistent-unused", "j",
                                          compression="lz9")


def test_epoch_qualified_directory_names(tmp_path):
    """Under an attempt epoch, checkpoint directories are named
    chk-<id>.e<epoch> and the newest timeline wins (storage.py's
    _dir); savepoints keep the plain name. Both packages."""
    for P in BOTH:
        root = str(tmp_path / P.name)
        st = P.storage.FsCheckpointStorage(root, "j", epoch=2)
        st.save(5, {"a": 1})
        st.save(6, {"a": 2}, savepoint=True)
        old = P.storage.FsCheckpointStorage(root, "j", epoch=1)
        with pytest.raises(P.storage.StaleCheckpointWriter):
            old.save(9, {"a": 3})
        assert sorted(os.listdir(os.path.join(root, "j"))) == [
            "chk-5.e2", "savepoint-6"]
        assert st.latest().checkpoint_id == 5 and st.latest().epoch == 2


def test_each_package_loads_the_others_directory(tmp_path):
    """A checkpoint directory written by one package's storage (v3, op
    blobs with a PaneState) loads in the other's, field for field."""
    def write(P, root):
        st = P.storage.FsCheckpointStorage(root, "x", compression="zlib")
        panes = P.PaneState(sums=None, maxs=None, mins=None,
                            counts=np.arange(12, dtype=np.int32).reshape(3, 4))
        op = P.blobformat.encode({"panes": panes, "watermark": 7,
                                  "refire": [3, 4]})
        return st.save_v2(4, {"sources": {0: {0: 5}}, "op_versions": {"2": 9}},
                          {"2": op}, {}).path

    for src, dst in ((JAX, PORT), (PORT, JAX)):
        path = write(src, str(tmp_path / src.name))
        out = dst.storage.FsCheckpointStorage.load(path)
        assert out["sources"] == {0: {0: 5}}
        assert out["op_file_versions"] == {2: 9}
        op = out["operators"][2]
        assert isinstance(op["panes"], dst.PaneState)
        assert op["panes"].sums is None and op["refire"] == [3, 4]
        np.testing.assert_array_equal(op["panes"].counts,
                                      np.arange(12).reshape(3, 4))


# -- the blob format ------------------------------------------------------------

def test_blob_round_trip_is_byte_identical():
    """test_checkpoint_format.py's round trip: both packages encode the
    same tree to the same bytes and decode each other's."""
    payload = {
        "watermark": 12345, "arr": np.arange(10, dtype=np.int64),
        "f32": np.ones((3, 2), np.float32),
        "nested": {"a": [1, 2.5, "x", None, True],
                   "t": (1, "two", np.float64(3.5))},
        "intkeys": {1: "one", (2, 3): "pair"}, "blob": b"\x00\x01\xff",
        "empty": np.zeros((0, 4), np.float32),
        "scalar0d": np.array(7, np.int32),
        "text": np.array(["a", "bb"], dtype=object),
    }
    raw = PORT.blobformat.encode(payload)
    assert raw == JAX.blobformat.encode(payload)
    out = PORT.blobformat.decode(raw)
    assert out["nested"]["t"] == (1, "two", np.float64(3.5))
    assert out["intkeys"][(2, 3)] == "pair" and out["blob"] == b"\x00\x01\xff"
    assert out["scalar0d"] == 7 and out["scalar0d"].shape == ()
    assert out["empty"].shape == (0, 4) and list(out["text"]) == ["a", "bb"]
    hlen = struct.unpack("<I", raw[8:12])[0]
    assert raw[:8] == b"FTCKPT3\n"
    assert json.loads(raw[12:12 + hlen])["pickle_escapes"] == 0


def test_blob_encodes_a_tensor_as_its_array():
    import torch

    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert PORT.blobformat.encode({"t": t}) == \
        JAX.blobformat.encode({"t": t.numpy()})


@both
def test_pickle_escape_is_refused_without_allow_pickle(P):
    """A ``__pickle__`` escape (an object-dtype array of non-strings)
    decodes by default and is refused with allow_pickle=False, in both
    packages."""
    blob = P.blobformat.encode({"lines": np.array(["a", None], dtype=object),
                                "num": np.arange(3)})
    assert P.blobformat.read_header(blob)[0]["pickle_escapes"] == 1
    assert list(P.blobformat.decode(blob)["lines"]) == ["a", None]
    with pytest.raises(ValueError, match="__pickle__ escape rejected"):
        P.blobformat.decode(blob, allow_pickle=False)


def test_operator_snapshots_have_no_pickle_escapes():
    """The port's own operator snapshots, materialized, encode without
    the pickle escape — and to the reference's bytes."""
    blobs = []
    for P in BOTH:
        op = P.WindowOperator(P.Sliding.of(4000, 2000), P.agg.count(),
                              num_shards=4, slots_per_shard=32, **P.kw)
        rng = np.random.default_rng(0)
        op.process_batch(rng.integers(0, 20, 500).astype(np.int64),
                         rng.integers(0, 6000, 500).astype(np.int64), {})
        op.advance_watermark(3000)
        raw = P.blobformat.encode(
            P.coordinator.materialize_snapshot(op.snapshot_state()))
        assert P.blobformat.read_header(raw)[0]["pickle_escapes"] == 0
        blobs.append(raw)
    assert blobs[0] == blobs[1]


# -- the coordinator --------------------------------------------------------------

@both
def test_commit_waits_for_persistence(P, tmp_path):
    """The 2PC commit runs only once the manifest is durable; an
    abandoned checkpoint never commits."""
    storage = P.storage.FsCheckpointStorage(str(tmp_path), "job")
    coord = P.coordinator.CheckpointCoordinator(storage)
    gate = threading.Event()
    committed = []
    real = storage.save_v2

    def slow_save_v2(*a, **kw):
        gate.wait(timeout=10)
        return real(*a, **kw)

    storage.save_v2 = slow_save_v2
    with ThreadPoolExecutor(max_workers=1) as ex:
        pend = coord.trigger_async(
            lambda: {"operators": {0: {"x": np.arange(4)}}},
            commit_fns=[committed.append], prepare_fns=[lambda cid: None],
            executor=ex)
        time.sleep(0.1)
        assert not pend.done() and committed == []
        assert storage.latest() is None
        gate.set()
        handle = pend.complete()
        assert committed == [pend.checkpoint_id]
        assert storage.latest().checkpoint_id == handle.checkpoint_id
        gate.clear()
        aborted = []
        pend2 = coord.trigger_async(
            lambda: {"operators": {0: {"x": 1}}}, commit_fns=[committed.append],
            prepare_fns=[], executor=ex, abort_fns=[aborted.append])
        pend2.abandon()
        gate.set()
    assert committed == [pend.checkpoint_id]
    assert aborted == [pend2.checkpoint_id]


def test_materialize_fetches_tensor_leaves():
    import torch

    snap = {"panes": PORT.PaneState(None, None, None,
                                    torch.ones(2, 3, dtype=torch.int32)),
            "t": (torch.arange(3),), "n": 4}
    out = PORT.coordinator.materialize_snapshot(snap)
    assert isinstance(out["panes"].counts, np.ndarray)
    assert out["t"][0].tolist() == [0, 1, 2] and out["n"] == 4


# -- jobs: a tumbling count over a failing source (tests/test_checkpoint.py) --

def failing_gen(n_batches, fail_after=None):
    def gen(split, i):
        if i >= n_batches:
            return None
        if fail_after is not None and i == fail_after:
            raise RuntimeError("injected failure")
        rng = np.random.default_rng(1000 * int(split) + i)
        keys = rng.integers(0, 10, 64).astype(np.int64)
        ts = np.sort(rng.integers(i * 500, i * 500 + 1000, 64)).astype(np.int64)
        return {"k": keys}, ts
    return gen


def golden_counts(n_batches):
    expect = {}
    for i in range(n_batches):
        rng = np.random.default_rng(i)
        keys = rng.integers(0, 10, 64)
        ts = np.sort(rng.integers(i * 500, i * 500 + 1000, 64))
        for k, t in zip(keys, ts):
            kk = (int(k), int(t) // 1000 * 1000)
            expect[kk] = expect.get(kk, 0) + 1
    return expect


def job_conf(P, root, extra=None):
    c = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
         "pipeline.microbatch-size": 128,
         "execution.checkpointing.dir": root,
         "execution.checkpointing.interval": 1}
    c.update(extra or {})
    return P.Conf(c)


def count_job(P, env, gen, sink):
    (env.from_source(P.GeneratorSource(gen),
                     P.WM.for_bounded_out_of_orderness(1000))
     .key_by("k").window(P.Tumbling.of(1000)).count().add_sink(sink))


def counts_of(sink):
    got = {}
    for r in sink.committed:
        kk = (int(r["key"]), int(r["window_start"]))
        assert kk not in got, f"duplicate emission for {kk}"
        got[kk] = int(r["count"])
    return got


@both
def test_fail_resume_exactly_once(P, tmp_path):
    """Run, crash mid-stream, resume from the latest checkpoint: the
    committed rows equal the golden (no loss, no duplicate)."""
    sink = P.sinks.TransactionalCollectSink()
    env = P.Env(job_conf(P, str(tmp_path)))
    count_job(P, env, failing_gen(12, fail_after=7), sink)
    with pytest.raises(RuntimeError, match="injected failure"):
        P.execute(env, "eo-job")
    before = len(sink.committed)
    env2 = P.Env(job_conf(P, str(tmp_path),
                          {"execution.checkpointing.restore": "latest"}))
    count_job(P, env2, failing_gen(12), sink)
    P.execute(env2, "eo-job")
    assert counts_of(sink) == golden_counts(12)
    assert before < len(sink.committed)


@both
def test_resume_from_the_final_checkpoint_adds_nothing(P, tmp_path):
    sink = P.sinks.TransactionalCollectSink()
    env = P.Env(job_conf(P, str(tmp_path)))
    count_job(P, env, failing_gen(4), sink)
    P.execute(env, "noop-job")
    n1 = len(sink.committed)
    assert counts_of(sink) == golden_counts(4)
    env2 = P.Env(job_conf(P, str(tmp_path),
                          {"execution.checkpointing.restore": "latest"}))
    count_job(P, env2, failing_gen(4), sink)
    P.execute(env2, "noop-job")
    assert len(sink.committed) == n1


@both
def test_job_checkpoints_are_v3_with_reuse_and_compression(P, tmp_path):
    """test_checkpoint_async.py / _compression.py on a real job: v3
    per-operator layout; zlib is smaller and restores; incremental off
    gives every op blob its own inode; a restore seeds the reuse base
    (op files and versions come back with the payload)."""
    def run(root, extra=None, restore=False, n=4):
        sink = P.sinks.CollectSink()
        c = {"state.num-key-shards": 4, "state.slots-per-shard": 32,
             "pipeline.microbatch-size": 64}
        c.update(extra or {})
        if restore:
            c["execution.checkpointing.restore"] = "latest"
        env = P.Env(job_conf(P, root, c))
        count_job(P, env, failing_gen(n), sink)
        P.execute(env, "comp-job")
        return P.storage.FsCheckpointStorage(root, "comp-job")

    def size(st):
        h = st.latest()
        return sum(os.path.getsize(os.path.join(h.path, f))
                   for f in os.listdir(h.path))

    plain = run(str(tmp_path / "plain"))
    hs = plain.list_complete()
    assert len(hs) >= 2
    for h in hs:
        mf = json.load(open(os.path.join(h.path, "MANIFEST.json")))
        assert mf["format_version"] == 3 and "ops" in mf
        assert os.path.exists(os.path.join(h.path, "meta.blob"))
    payload = P.storage.FsCheckpointStorage.load(plain.latest())
    assert payload["op_files"] and payload["op_file_versions"]
    zl = run(str(tmp_path / "zlib"),
             {"execution.checkpointing.compression": "zlib"})
    assert size(zl) < size(plain)
    # a zlib run restored from a plain checkpoint re-serializes: every
    # retained checkpoint stays decodable
    run(str(tmp_path / "plain"),
        {"execution.checkpointing.compression": "zlib"}, restore=True)
    for h in P.storage.FsCheckpointStorage(
            str(tmp_path / "plain"), "comp-job").list_complete():
        P.storage.FsCheckpointStorage.load(h)
    off = run(str(tmp_path / "off"),
              {"execution.checkpointing.incremental": False})
    files = [os.path.join(h.path, f) for h in off.list_complete()
             for f in os.listdir(h.path) if f.startswith("op-")]
    assert len({os.stat(f).st_ino for f in files}) == len(files)


@both
def test_an_idle_operator_hardlinks_its_blob_in_a_job(P, tmp_path):
    """Two windows on two sources, one of which ends early: once it has
    fired everything its state_version stops moving, and each later
    checkpoint hardlinks its blob (the version sites are the
    reference's; the payload-tree case compares them at one cut)."""
    root = str(tmp_path)
    env = P.Env(job_conf(P, root, {
        "state.num-key-shards": 4, "state.slots-per-shard": 32,
        "execution.checkpointing.num-retained": 100}))
    long_gen = failing_gen(10)

    def paced(split, i):  # a checkpoint can complete between batches
        time.sleep(0.01)
        return long_gen(split, i)

    count_job(P, env, failing_gen(2), P.sinks.CollectSink())
    count_job(P, env, paced, P.sinks.CollectSink())
    P.execute(env, "idle-job")
    seen = []
    for h in P.storage.FsCheckpointStorage(root, "idle-job").list_complete():
        mf = json.load(open(os.path.join(h.path, "MANIFEST.json")))
        seen.append({nid: (e["version"], os.path.join(h.path, e["file"]))
                     for nid, e in mf["ops"].items()})
    assert len(seen) >= 2
    short = min(seen[-1], key=lambda nid: seen[-1][nid][0])
    reused = 0
    for prev, cur in zip(seen, seen[1:]):
        same = cur[short][0] == prev[short][0]
        # linked exactly when unchanged
        assert os.path.samefile(cur[short][1], prev[short][1]) == same
        reused += same
    assert reused > 0, seen


# -- the 2PC sinks across a crash (tests/test_checkpoint.py) --------------------

def crash_on_commit_sink(P, crash_at):
    """A sink whose commit round for checkpoint ``crash_at`` dies once.
    It records the checkpoint each restore came from (``restored``) and
    every staged epoch as it turns visible (``commits``)."""
    class CrashOnCommit(P.sinks.TransactionalCollectSink):
        crashed = False

        def __post_init__(self):
            super().__post_init__()
            self.restored = []
            self.commits = []

        def notify_checkpoint_complete(self, checkpoint_id):
            if checkpoint_id == crash_at and not self.crashed:
                self.crashed = True
                raise RuntimeError("injected crash before commit")
            self.commits += sorted(c for c in self._staged
                                   if c <= checkpoint_id)
            super().notify_checkpoint_complete(checkpoint_id)

        def restore_staged(self, staged, checkpoint_id):
            self.restored.append(checkpoint_id)
            self.commits += sorted(
                c for c in staged
                if self._last_committed < c <= checkpoint_id)
            super().restore_staged(staged, checkpoint_id)
    return CrashOnCommit()


@both
@pytest.mark.parametrize("case", ["commit_crash", "no_checkpoint",
                                  "pending_rows"])
def test_two_phase_commit_recovery(P, case, tmp_path):
    """commit_crash: checkpoint 2 is durable but the process dies before
    the commit round; its staged epoch, persisted inside it, is
    re-committed on restore, once. Every run reaches checkpoint 2: at an
    interval of 1 ms checkpoint 1 starts on an early loop pass, and the
    final checkpoint comes after it, however long its persist lasts. no_checkpoint: the crash comes before the
    first checkpoint; the reused sink drops the crashed attempt's rows.
    pending_rows (test_crashed_attempt_drain_never_pollutes_next_attempt):
    the crashed attempt runs at pipeline.emit-defer 500 ms, so fires are
    still held back when it dies; none of them may reach the sink the
    next attempt (at 0 ms) reuses, and nothing is left pending."""
    extra = ({} if case == "commit_crash"
             else {"execution.checkpointing.interval": 10_000_000})
    first = (dict(extra, **{"pipeline.emit-defer": "500ms"})
             if case == "pending_rows" else extra)
    sink = (crash_on_commit_sink(P, 2) if case == "commit_crash"
            else P.sinks.TransactionalCollectSink())
    n = 12 if case == "commit_crash" else 6
    env = P.Env(job_conf(P, str(tmp_path), first))
    count_job(P, env, failing_gen(n, None if case == "commit_crash" else 4),
              sink)
    with pytest.raises(RuntimeError, match="injected"):
        P.execute(env, f"{case}-job")
    if case == "pending_rows" and P is PORT:
        # the deferral really held fires back at the crash
        assert env._driver._pending_emits
    env2 = P.Env(job_conf(P, str(tmp_path), dict(
        extra, **{"execution.checkpointing.restore": "latest",
                  "pipeline.emit-defer": "0ms"})))
    count_job(P, env2, failing_gen(n), sink)
    P.execute(env2, f"{case}-job")
    assert sink._pending == [] and sink._staged == {}
    assert counts_of(sink) == golden_counts(n)
    if case == "commit_crash":
        # the second run resumed from the checkpoint whose commit died,
        # and that checkpoint's epoch turned visible exactly once
        assert sink.restored == [2]
        assert sink.commits.count(2) == 1


# -- TestReshard: a snapshot across 1 and 4 device blocks ------------------------

@pytest.mark.shard_map
@pytest.mark.parametrize("direction", ["local_to_mesh", "mesh_to_local"])
def test_restore_across_device_blocks(direction):
    """tests/test_checkpoint.py's TestReshard with 4 blocks of the CPU:
    a local operator's snapshot restores into a 4-block one and back;
    the fired rows equal the unrestored operator's, in both packages."""
    import jax

    from flink_tpu.parallel.mesh import make_mesh_plan as jax_mesh
    from flink_tpu_torch.parallel.mesh import make_mesh_plan as port_mesh

    rng = np.random.default_rng(9)
    keys = rng.integers(0, 200, 500).astype(np.int64)
    ts = rng.integers(0, 3000, 500).astype(np.int64)
    rows = []
    for P, mesh in ((JAX, lambda: jax_mesh(8, 64, jax.devices()[:4])),
                    (PORT, lambda: port_mesh(8, 64, ["cpu"] * 4))):
        def make(sharded):
            kw = dict(P.kw, mesh_plan=mesh()) if sharded else dict(
                P.kw, num_shards=8, slots_per_shard=64)
            return P.WindowOperator(P.Sliding.of(2000, 1000), P.agg.count(),
                                    **kw)
        a = make(direction == "mesh_to_local")
        b = make(direction == "local_to_mesh")
        a.process_batch(keys, ts, {})
        b.restore_state(P.coordinator.materialize_snapshot(a.snapshot_state()))
        fa, fb = (dict(op.advance_watermark(5000)) for op in (a, b))
        ra = sorted(zip(*(np.asarray(fa[c]).tolist()
                          for c in ("key", "window_end", "count"))))
        rb = sorted(zip(*(np.asarray(fb[c]).tolist()
                          for c in ("key", "window_end", "count"))))
        assert ra == rb and len(ra) > 0
        rows.append(ra)
    assert rows[0] == rows[1]


# -- whole jobs: crash and resume in both packages ---------------------------------

Q5_CFG = dict(batch_size=4096, n_batches=6, events_per_ms=100,
              num_active_auctions=500, hot_ratio=4)
HOST_CFG = dict(batch_size=4096, n_batches=8, events_per_ms=4,
                num_active_auctions=500, hot_ratio=4)


class Poisoned(Exception):
    pass


def poisoned_sink(P, limit):
    """A transactional sink that fails its attempt once ``limit`` rows
    have been written (the first attempt only)."""
    class PoisonOnce(P.sinks.TransactionalCollectSink):
        seen = 0
        fired = False

        def write(self, batch):
            super().write(batch)
            self.seen += len(next(iter(batch.values())))
            if not self.fired and self.seen >= limit:
                self.fired = True
                raise Poisoned("poisoned sink")
    return PoisonOnce()


def build_q5_devgen(P, sink, k=4):
    def build(conf):
        env = P.Env(conf)
        P.q5(env, P.gen.bid_stream_device(P.gen.NexmarkConfig(**Q5_CFG)),
             sink, window_ms=2000, slide_ms=500, out_of_orderness_ms=100)
        return env
    conf = {"state.num-key-shards": 16, "state.slots-per-shard": 64,
            "pipeline.microbatch-size": Q5_CFG["batch_size"],
            "pipeline.sub-batches": k}
    return build, conf


def host_bids(split, i):
    """The same numpy bids for both packages (their own bid_stream
    differ: the reference's takes its C generator when it is built)."""
    if i >= HOST_CFG["n_batches"]:
        return None
    return PORT.gen.bid_batch(PORT.gen.NexmarkConfig(**HOST_CFG), int(split), i)


def build_q5_host(P, sink):
    def build(conf):
        env = P.Env(conf)
        P.q5(env, P.GeneratorSource(host_bids), sink,
             window_ms=4000, slide_ms=1000, out_of_orderness_ms=500)
        return env
    conf = {"state.num-key-shards": 8, "state.slots-per-shard": 128,
            "pipeline.microbatch-size": HOST_CFG["batch_size"]}
    return build, conf


def build_q5_tiered(backend):
    """Job S: the host-fed Q5 job with 128 device slots for its 500
    auctions, so most keys aggregate in the host store; under 'lsm' a
    4 KiB delta seals a run about every batch and four runs compact."""
    def jobs(P, sink):
        build, conf = build_q5_host(P, sink)
        conf = dict(conf, **{"state.slots-per-shard": 16,
                             "state.backend": backend,
                             "execution.checkpointing.num-retained": 100})
        if backend == "lsm":
            conf.update({"state.memory-budget-bytes": 4096,
                         "state.lsm.run-floor-bytes": 4096})
        return build, conf
    return jobs


def with_state_dir(conf, root):
    """The job's conf with the LSM tier's run files under ``root``."""
    if conf.get("state.backend") == "lsm":
        conf = dict(conf, **{"state.lsm.dir": root + "-state"})
    return conf


def wc_gen(split, i):
    if i >= 10:
        return None
    rng = np.random.default_rng(500 + i)
    return ({"k": rng.integers(0, 40, 256).astype(np.int64),
             "n": rng.integers(0, 9, 256).astype(np.int64)},
            np.arange(i * 256, (i + 1) * 256, dtype=np.int64))


def build_count_window(P, sink):
    def build(conf):
        env = P.Env(conf)
        (env.from_source(P.GeneratorSource(wc_gen),
                         P.WM.for_monotonous_timestamps())
         .key_by("k").count_window(5).sum("n").add_sink(sink))
        return env
    conf = {"state.num-key-shards": 4, "state.slots-per-shard": 32,
            "pipeline.microbatch-size": 256}
    return build, conf


SESSION_BATCHES = 8


def session_gen(split, i):
    """Bursty clicks of 80 users, 5 % of them up to 2 s late (inside the
    job's 10 s lateness: nothing is dropped, late records merge and
    re-fire their sessions)."""
    if i >= SESSION_BATCHES:
        return None
    rng = np.random.default_rng(900 + i)
    user = rng.integers(0, 80, 512).astype(np.int64)
    ts = i * 400 + rng.integers(0, 600, 512)
    late = rng.random(512) < 0.05
    ts = np.where(late, np.maximum(ts - rng.integers(0, 2000, 512), 0), ts)
    return {"user": user}, ts.astype(np.int64)


def build_sessions(P, sink):
    def build(conf):
        env = P.Env(conf)
        (env.from_source(P.GeneratorSource(session_gen),
                         P.WM.for_bounded_out_of_orderness(500))
         .key_by("user").window(P.Sessions.with_gap(120))
         .allowed_lateness(10_000).count().add_sink(sink))
        return env
    conf = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
            "pipeline.microbatch-size": 512, "host.parallelism": 4}
    return build, conf


Q78_CFG = dict(batch_size=512, n_batches=8, events_per_ms=1,
               num_active_auctions=200, num_active_people=150)


def q7_bids(split, i):
    if i >= Q78_CFG["n_batches"]:
        return None
    return PORT.gen.bid_batch(PORT.gen.NexmarkConfig(**Q78_CFG), int(split), i)


def build_q7(P, sink):
    def build(conf):
        env = P.Env(conf)
        (env.from_source(P.GeneratorSource(q7_bids),
                         P.WM.for_bounded_out_of_orderness(200))
         .window_all(P.Tumbling.of(1000)).max("price").add_sink(sink))
        return env
    conf = {"pipeline.microbatch-size": 512, "host.parallelism": 2,
            "host.fold-chunk-records": 128}
    return build, conf


def q8_side(which):
    make = PORT.gen.person_batch if which == "person" else PORT.gen.auction_batch

    def gen(split, i):
        if i >= Q78_CFG["n_batches"]:
            return None
        return make(PORT.gen.NexmarkConfig(**Q78_CFG), int(split), i)
    return gen


def build_q8(mode):
    def jobs(P, sink):
        def build(conf):
            env = P.Env(conf)
            wm = P.WM.for_bounded_out_of_orderness(200)
            (env.from_source(P.GeneratorSource(q8_side("person")), wm)
             .join(env.from_source(P.GeneratorSource(q8_side("auction")), wm))
             .where("person").equal_to("seller")
             .window(P.Tumbling.of(1000))
             .apply(left_fields=("state_id",), right_fields=("reserve",),
                    mode=mode)
             .add_sink(sink))
            return env
        conf = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
                "pipeline.microbatch-size": 512}
        return build, conf
    return jobs


CEP_BATCHES = 10


def cep_gen(split, i):
    """40 accounts, v in 0..9, timestamps rising batch by batch (so no
    event falls behind its key's frontier)."""
    if i >= CEP_BATCHES:
        return None
    rng = np.random.default_rng(1300 + i)
    return ({"acct": rng.integers(0, 40, 256).astype(np.int64),
             "v": rng.integers(0, 10, 256).astype(np.int64)},
            np.sort(i * 1000 + rng.integers(0, 1000, 256)).astype(np.int64))


def cep_pattern(P):
    return (P.cep.Pattern.begin("lo").where(lambda d: d["v"] < 2)
            .followed_by("hi").where(lambda d: d["v"] >= 8).within(300))


def build_cep(P, sink):
    def build(conf):
        env = P.Env(conf)
        stream = (env.from_source(P.GeneratorSource(cep_gen),
                                  P.WM.for_bounded_out_of_orderness(100))
                  .key_by("acct"))
        P.cep.CEP.pattern(stream, cep_pattern(P)).add_sink(sink)
        return env
    conf = {"state.num-key-shards": 8, "state.slots-per-shard": 16,
            "pipeline.microbatch-size": 256}
    return build, conf


def cep_golden():
    """The documented one-partial semantics per key, record by record."""
    out, state = [], {}
    for i in range(CEP_BATCHES):
        data, ts = cep_gen("0", i)
        order = np.lexsort((ts, data["acct"]))
        for k, v, t in zip(data["acct"][order].tolist(),
                           data["v"][order].tolist(), ts[order].tolist()):
            st = state.get(k)
            if st is not None and t - st > 300:
                st = state[k] = None
            if st is None:
                if v < 2:
                    state[k] = t
            elif v >= 8:
                out.append((k, st, t))
                state[k] = None
    return sorted(out)


BC_BATCHES, BC_CATS = 8, 16


def bc_data(split, i):
    if i >= BC_BATCHES:
        return None
    rng = np.random.default_rng(1400 + i)
    return ({"auction": rng.integers(0, 64, 512).astype(np.int64),
             "price": rng.integers(0, 1000, 512).astype(np.int64)},
            (i * 500 + rng.integers(0, 500, 512)).astype(np.int64))


def bc_thresholds():
    return np.random.default_rng(1499).integers(200, 900, BC_CATS)


def bc_control(split, i):
    """One batch: every category's threshold, timestamped past the data
    (a finished control stream holds no watermark back). The loop reads
    it after data batch 0, which meets no threshold yet and passes
    nothing."""
    if i >= 1:
        return None
    return ({"cat": np.arange(BC_CATS, dtype=np.int64),
             "thr": bc_thresholds()}, np.full(BC_CATS, 10 ** 9, np.int64))


def build_broadcast(P, sink):
    class OverThreshold(P.broadcast.BroadcastProcessFunction):
        def process_element(self, data, ts, state):
            if "thr" not in state:
                return None
            keep = data["price"] > state["thr"][data["auction"] % BC_CATS]
            return {"auction": data["auction"][keep],
                    "price": data["price"][keep], "__ts__": ts[keep]}

        def process_broadcast_element(self, data, ts, state):
            thr = state.setdefault("thr", np.zeros(BC_CATS, np.int64))
            thr[data["cat"]] = data["thr"]

    def build(conf):
        env = P.Env(conf)
        wm = P.WM.for_bounded_out_of_orderness(500)
        data = env.from_source(P.GeneratorSource(bc_data), wm)
        control = env.from_source(P.GeneratorSource(bc_control), wm)
        (data.connect(control).process(OverThreshold())
         .key_by("auction").window(P.Tumbling.of(1000)).count()
         .add_sink(sink))
        return env
    conf = {"state.num-key-shards": 8, "state.slots-per-shard": 16,
            "pipeline.microbatch-size": 512}
    return build, conf


def bc_golden():
    thr = bc_thresholds()
    a, ts = [], []
    for i in range(1, BC_BATCHES):
        data, t = bc_data("0", i)
        keep = data["price"] > thr[data["auction"] % BC_CATS]
        a.append(data["auction"][keep])
        ts.append(t[keep])
    a, ts = np.concatenate(a), np.concatenate(ts)
    ends = ts // 1000 * 1000 + 1000
    pairs, counts = np.unique(np.stack([a, ends], 1), axis=0,
                              return_counts=True)
    return sorted((int(k), int(e), int(c))
                  for (k, e), c in zip(pairs, counts))


def build_mesh_m1(P, sink):
    """Mesh job M1 (Q5 host-fed over four device blocks): the JAX
    package's ``cluster.mesh-devices: 4`` of its forced CPU devices; the
    port's four blocks of its one CPU (``make_mesh_plan``), the plan its
    environment then builds."""
    build, conf = build_q5_host(P, sink)
    if P is JAX:
        return build, dict(conf, **{"cluster.mesh-devices": "4"})
    from flink_tpu_torch.parallel.mesh import make_mesh_plan

    def build_port(c):
        env = build(c)
        env.build_mesh_plan = lambda device: make_mesh_plan(
            conf["state.num-key-shards"], conf["state.slots-per-shard"],
            [device] * 4)
        return env
    return build_port, conf


JOBS = {"q5_devgen_k4": build_q5_devgen, "q5_host": build_q5_host,
        "q5_spill": build_q5_tiered("spill"),
        "q5_lsm": build_q5_tiered("lsm"),
        "count_window": build_count_window, "sessions": build_sessions,
        "q7": build_q7, "q8_pairs": build_q8("pairs"),
        "q8_aggregate": build_q8("aggregate"), "cep": build_cep,
        "broadcast": build_broadcast, "mesh_m1": build_mesh_m1}

# each (package, job, mode)'s committed rows, shared by the cases that
# read the same run
_RUNS = {}


def run_job(P, job, tmp_root, mode):
    """Committed rows of ``job`` in package ``P``: 'clean' runs it once
    with checkpoints every pass; 'chaos' crashes it (a checkpoint-storage
    write fault after 2 writes, then a poisoned sink at a third of the
    rows) and recovers through run_with_recovery at fixed delay."""
    key = (P.name, job, mode)
    if key in _RUNS:
        return _RUNS[key]
    if job == "q5_devgen_k4" and not native_available():
        pytest.skip("needs the C codec (devgen miss repair)")
    clean_len = (len(_RUNS[(P.name, job, "clean")])
                 if mode == "chaos" else 0)
    sink = (poisoned_sink(P, max(clean_len // 3, 1)) if mode == "chaos"
            else P.sinks.TransactionalCollectSink())
    build, conf = JOBS[job](P, sink)
    root = os.path.join(tmp_root, f"{P.name}-{job}-{mode}")
    conf = P.Conf(dict(with_state_dir(conf, root), **{
        "execution.checkpointing.dir": root,
        "execution.checkpointing.interval": 1,
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 5,
        "restart-strategy.fixed-delay.delay": 1}))
    if mode == "chaos":
        plan = P.faults.FaultPlan(seed=77).rule(
            "checkpoint.storage.write", "raise", count=1, after=2)
        if job == "sessions":
            # and a pool task of the key-sharded registry dies mid-batch
            plan.rule("host.pool.task", "raise", count=1, after=20)
        with plan.activate():
            P.recover(build, conf, job)
        assert plan.log, "the storage fault never fired"
        if job == "sessions":
            assert {e[0] for e in plan.log} == {
                "host.pool.task", "checkpoint.storage.write"}, plan.log
    else:
        P.execute(build(conf), job)
    rows = row_view(sink.committed)
    positions, aux = [], []
    st = P.storage.FsCheckpointStorage(root, job)
    for h in st.list_complete():
        payload = P.storage.FsCheckpointStorage.load(h)
        positions.append((payload.get("sub_factors", {}),
                          [p for pos in payload["sources"].values()
                           for p in pos.values()]))
        aux.append(sum(len(m) for m in payload["op_aux_paths"].values()))
    _RUNS[key] = rows
    _RUNS[key + ("positions",)] = positions
    _RUNS[key + ("aux",)] = aux
    return rows


def q5_golden(parts, window_ms, slide_ms):
    a = np.concatenate([p[0] for p in parts])
    ts = np.concatenate([p[1] for p in parts])
    ppw = window_ms // slide_ms
    pane = ts // slide_ms
    n_a, n_p = int(a.max()) + 1, int(pane.max()) + 1
    per = np.bincount(a * n_p + pane, minlength=n_a * n_p).reshape(n_a, n_p)
    cs = np.concatenate([np.zeros((n_a, 1), np.int64), per.cumsum(1)], 1)
    out = set()
    for e in range(1, n_p + ppw):
        win = cs[:, min(e, n_p)] - cs[:, max(e - ppw, 0)]
        if win.max() > 0:
            out |= {(int(x), e * slide_ms, int(win.max()))
                    for x in np.flatnonzero(win == win.max())}
    return out


def golden_rows(job):
    if job == "q5_devgen_k4":
        src = PORT.gen.bid_stream_device(PORT.gen.NexmarkConfig(**Q5_CFG))
        return q5_golden([src.keys_ts_host(i)
                          for i in range(Q5_CFG["n_batches"])], 2000, 500)
    if job == "sessions":
        return brute_sessions(session_gen, SESSION_BATCHES, 120)
    if job == "q7":
        parts = [q7_bids("0", i) for i in range(Q78_CFG["n_batches"])]
        price = np.concatenate([d["price"] for d, _ in parts])
        we = np.concatenate([ts for _, ts in parts]) // 1000 * 1000 + 1000
        return sorted((int(e), float(price[we == e].max()))
                      for e in np.unique(we))
    if job.startswith("q8_"):
        return q8_golden(job[3:])
    if job == "cep":
        return cep_golden()
    if job == "broadcast":
        return bc_golden()
    if job in ("q5_host", "q5_spill", "q5_lsm", "mesh_m1"):
        return q5_golden([(d["auction"], ts) for d, ts in (
            host_bids("0", i) for i in range(HOST_CFG["n_batches"]))],
            4000, 1000)
    # a purging count window of 5: after each batch every key holding 5
    # or more records fires them all
    held = {}
    out = []
    for i in range(10):
        data, _ = wc_gen("0", i)
        for k, n in zip(data["k"].tolist(), data["n"].tolist()):
            held.setdefault(k, []).append(n)
        for k in sorted(held):
            if len(held[k]) >= 5:
                out.append((k, len(held[k]), float(sum(held.pop(k)))))
    return sorted(out)


def final_sessions(rows):
    """Each session's last row in commit order: a (re)fired session
    supersedes every earlier row of its key whose span it covers."""
    final = {}
    for r in rows:
        k, s, e = r["key"], r["window_start"], r["window_end"]
        final = {kk: v for kk, v in final.items()
                 if not (kk[0] == k and s <= kk[1] < e)}
        final[(k, s)] = (e, r["count"])
    return sorted((k, s, e, c) for (k, s), (e, c) in final.items())


def brute_sessions(gen, n_batches, gap):
    """Sessions of every record, merged per key by the gap."""
    by_key = {}
    for i in range(n_batches):
        data, ts = gen("0", i)
        for k, t in zip(data["user"].tolist(), ts.tolist()):
            by_key.setdefault(k, []).append(t)
    out = []
    for k, tss in by_key.items():
        tss.sort()
        start, last, cnt = tss[0], tss[0], 1
        for t in tss[1:]:
            if t - last > gap:
                out.append((k, start, last + gap, cnt))
                start, last, cnt = t, t, 1
            else:
                last, cnt = t, cnt + 1
        out.append((k, start, last + gap, cnt))
    return sorted(out)


def q8_golden(mode):
    n = Q78_CFG["n_batches"]
    left, right = {}, {}
    for side, gen, field in ((left, q8_side("person"), "state_id"),
                             (right, q8_side("auction"), "reserve")):
        key = "person" if side is left else "seller"
        for i in range(n):
            data, ts = gen("0", i)
            for k, t, v in zip(data[key].tolist(), ts.tolist(),
                               data[field].tolist()):
                side.setdefault((k, t // 1000 * 1000 + 1000), []).append(v)
    both = sorted(set(left) & set(right))
    if mode == "pairs":
        return sorted((k, w, a, b) for k, w in both
                      for a in left[(k, w)] for b in right[(k, w)])
    return sorted((k, w, len(left[(k, w)]), max(left[(k, w)]),
                   len(right[(k, w)]), max(right[(k, w)])) for k, w in both)


def golden_view(job, rows):
    d = [dict(r) for r in rows]
    if job == "sessions":
        return final_sessions(d)
    if job == "q7":
        return sorted((r["window_end"], r["max_price"]) for r in d)
    if job == "q8_pairs":
        return sorted((r["key"], r["window_end"], r["left_state_id"],
                       r["right_reserve"]) for r in d)
    if job == "q8_aggregate":
        return sorted((r["key"], r["window_end"], r["left_count"],
                       r["left_state_id"], r["right_count"],
                       r["right_reserve"]) for r in d)
    if job == "count_window":
        return sorted((r["key"], r["count"], r["sum_n"]) for r in d)
    if job == "cep":
        return sorted((r["key"], r["lo_ts"], r["hi_ts"]) for r in d)
    if job == "broadcast":
        return sorted((r["key"], r["window_end"], r["count"]) for r in d)
    return {(r["auction"], r["window_end"], r["bid_count"]) for r in d}


def commit_view(job, rows):
    """Committed rows as the packages agree on them: in commit order, or
    on a mesh (whose blocks' fires each driver drains at its own
    cadence) in commit order within each window."""
    if job != "mesh_m1":
        return rows
    return sorted(rows, key=lambda r: dict(r)["window_end"])


@pytest.mark.parametrize("job", sorted(JOBS))
def test_crash_and_resume_commits_the_reference_rows(job, tmp_path_factory):
    """The same crash and resume in both packages commits the same rows
    in the same order as each package's fault-free run, the golden's
    rows, and the other package's rows. On the K = 4 devgen chain
    positions count sub-batches, and some completed checkpoint cuts a
    logical batch."""
    tmp = str(tmp_path_factory.mktemp(job))
    clean = {P.name: commit_view(job, run_job(P, job, tmp, "clean"))
             for P in BOTH}
    chaos = {P.name: commit_view(job, run_job(P, job, tmp, "chaos"))
             for P in BOTH}
    assert clean["port"] == clean["jax"] == chaos["port"] == chaos["jax"]
    rows = clean["port"]
    assert len(rows) > 0
    assert golden_view(job, rows) == golden_rows(job)
    if job == "q5_devgen_k4":
        mid = 0
        for P in BOTH:
            for mode in ("clean", "chaos"):
                seen = _RUNS[(P.name, job, mode, "positions")]
                assert seen
                for factors, pos in seen:
                    assert all(int(v) == 4 for v in factors.values())
                    mid += sum(1 for p in pos if p % 4)
        assert mid > 0, "no checkpoint cut a logical batch"
    if job == "q5_lsm":
        # sealed runs rode the checkpoints as hardlinks, in both packages
        for P in BOTH:
            for mode in ("clean", "chaos"):
                assert max(_RUNS[(P.name, job, mode, "aux")]) > 0


def test_position_rebase_between_factors():
    rebase = PORT.driver._rebase_position
    for args, want in (((6, 4, 2), 3), ((8, 4, 1), 2), ((2, 1, 4), 8),
                       ((0, 4, 3), 0)):
        assert rebase(*args) == JAX.driver._rebase_position(*args) == want
    for args in ((5, 4, 2), (7, 4, 1)):
        with pytest.raises(ValueError, match="does not align"):
            rebase(*args)


@needs_native
def test_devgen_restore_continues_identically(tmp_path):
    """tests/test_devgen.py::TestCheckpointRestore on the port: a Q5 run
    on bids made on the device crashes at a third of its rows; a second
    run resumes from the latest checkpoint; the rows both delivered,
    merged by window, equal the uninterrupted run's. Rows of the two
    runs equal the reference's too."""
    cfg = PORT.gen.NexmarkConfig(batch_size=4096, n_batches=8,
                                 events_per_ms=4, num_active_auctions=500,
                                 hot_ratio=4)

    def rows_of(batches):
        return sorted((int(b["window_end"][i]), int(b["auction"][i]),
                       int(b["bid_count"][i]))
                      for b in batches for i in range(len(b["window_end"])))

    def conf(P, extra):
        return P.Conf(dict({"state.num-key-shards": 8,
                            "state.slots-per-shard": 128,
                            "pipeline.microbatch-size": 4096,
                            "execution.checkpointing.dir":
                                str(tmp_path / P.name)}, **extra))

    out = {}
    for P in BOTH:
        gcfg = P.gen.NexmarkConfig(**dataclasses.asdict(cfg))
        golden = []
        env = P.Env(conf(P, {}))
        P.q5(env, P.gen.bid_stream_device(gcfg), P.sinks.FnSink(golden.append),
             window_ms=4000, slide_ms=1000, out_of_orderness_ms=500)
        P.execute(env, "q5-golden")
        golden = rows_of(golden)
        limit = max(len(golden) // 3, 1)
        first, n_ok = [], [0]

        def poison(b):
            first.append(b)
            n_ok[0] += len(b["window_end"])
            if n_ok[0] >= limit:
                raise Poisoned()

        env = P.Env(conf(P, {"execution.checkpointing.interval": "1ms"}))
        P.q5(env, P.gen.bid_stream_device(gcfg), P.sinks.FnSink(poison),
             window_ms=4000, slide_ms=1000, out_of_orderness_ms=500)
        with pytest.raises(Poisoned):
            P.execute(env, "q5-crash")
        second = []
        env = P.Env(conf(P, {"execution.checkpointing.restore": "latest",
                             "execution.checkpointing.interval": "1ms"}))
        P.q5(env, P.gen.bid_stream_device(gcfg), P.sinks.FnSink(second.append),
             window_ms=4000, slide_ms=1000, out_of_orderness_ms=500)
        P.execute(env, "q5-crash")
        merged = {}
        for we, a, c in rows_of(first) + rows_of(second):
            merged[(we, a)] = max(merged.get((we, a), 0), c)
        assert merged == {(we, a): c for we, a, c in golden}
        out[P.name] = golden
    assert out["port"] == out["jax"]


# -- checkpoints across the packages, and their payload trees ----------------------

def cut_job(P, job, root, cut, interval=10 ** 9, restore="", savepoint=False,
            extra=None):
    """Run ``job`` with a checkpoint taken by ``checkpoint_now`` as its
    source reaches batch ``cut`` (checkpoint 1, or savepoint 1; the final
    checkpoint is 2), or, with ``restore``, resume from a checkpoint.
    Returns the committed rows."""
    sink = P.sinks.TransactionalCollectSink()
    build, conf = JOBS[job](P, sink)
    conf = with_state_dir(conf, os.path.join(root, job))
    env = build(P.Conf(dict(conf, **{
        "execution.checkpointing.dir": root,
        "execution.checkpointing.interval": interval,
        "execution.checkpointing.restore": restore,
        "pipeline.source-prefetch": 0}, **(extra or {}))))
    if not restore:
        # the first source's batch index triggers the cut (a join reads
        # two sources in step)
        src_t = [t for t in env._transforms
                 if getattr(t, "source", None) is not None][0]
        src = src_t.source
        hit = [False]

        def hook(i):
            if i == cut and not hit[0]:
                hit[0] = True
                env._driver.checkpoint_now(savepoint=savepoint)

        if hasattr(src, "ts_bounds"):
            def with_hook(s):
                bounds = s.ts_bounds

                def ts_bounds(i):
                    hook(i)
                    return bounds(i)
                return dataclasses.replace(s, ts_bounds=ts_bounds)
            sub = src.subdivide
            src_t.source = dataclasses.replace(
                with_hook(src), subdivide=lambda k: with_hook(sub(k)))
        else:
            gen = src.gen

            def hooked(split, i):
                hook(i)
                return gen(split, i)
            src.gen = hooked
    P.execute(env, job)
    return row_view(sink.committed)


CUTS = {"q5_devgen_k4": 9, "q5_host": 3, "q5_spill": 3, "q5_lsm": 3,
        "count_window": 4, "sessions": 3,
        "q7": 3, "q8_pairs": 3, "q8_aggregate": 3, "cep": 4,
        "broadcast": 3, "mesh_m1": 3}


@pytest.fixture(scope="module")
def cut_runs(tmp_path_factory):
    """Each package's run of each job with checkpoint 1 at the same cut."""
    root = str(tmp_path_factory.mktemp("cuts"))
    runs = {}

    def get(P, job):
        if (P.name, job) not in runs:
            if job == "q5_devgen_k4" and not native_available():
                pytest.skip("needs the C codec (devgen miss repair)")
            d = os.path.join(root, P.name)
            rows = cut_job(P, job, d, CUTS[job])
            runs[(P.name, job)] = (rows, os.path.join(d, job, "chk-1"))
        return runs[(P.name, job)]
    return get


def tree_equal(a, b, path="payload"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8) if a.size else a,
                              b.view(np.uint8) if b.size else b), path
        return
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            tree_equal(getattr(a, f.name), getattr(b, f.name),
                       f"{path}.{f.name}")
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            tree_equal(a[k], b[k], f"{path}[{k!r}]")
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            tree_equal(x, y, f"{path}[{i}]")
        return
    assert a == b and type(a) is type(b), (path, a, b)


PAYLOAD_FIELDS = ("sources", "sub_factors", "wm_gens", "max_ts", "out_wm",
                  "op_versions")


@pytest.mark.parametrize("job", sorted(JOBS))
def test_payload_trees_equal_at_the_same_cut(job, cut_runs):
    """Checkpoint 1 of the same job at the same cut, loaded back: the
    positions, sub-batch factors, watermark state, max timestamps,
    node watermarks, operator versions and every operator's arrays are
    the reference's, field by field."""
    (jrows, jpath), (prows, ppath) = cut_runs(JAX, job), cut_runs(PORT, job)
    assert commit_view(job, prows) == commit_view(job, jrows) and prows
    jp = JAX.storage.FsCheckpointStorage.load(jpath)
    pp = PORT.storage.FsCheckpointStorage.load(ppath)
    for f in PAYLOAD_FIELDS:
        tree_equal(pp[f], jp[f], f)
    assert pp["checkpoint_id"] == jp["checkpoint_id"] == 1
    assert set(pp["operators"]) == set(jp["operators"])
    for nid, jop in jp["operators"].items():
        pop = pp["operators"][nid]
        assert set(pop) >= set(jop) - {"__aux_paths__"}
        for k in set(jop) - {"__aux_paths__"}:
            tree_equal(pop[k], jop[k], f"operators[{nid}][{k!r}]")
    assert pp["op_file_versions"] == jp["op_file_versions"]
    # the LSM tier's hardlinked runs: the same names, the same bytes
    assert ({n: sorted(m) for n, m in pp["op_aux_paths"].items()}
            == {n: sorted(m) for n, m in jp["op_aux_paths"].items()})
    assert bool(pp["op_aux_paths"]) == (job == "q5_lsm")
    for nid, m in pp["op_aux_paths"].items():
        for name, path in m.items():
            with open(path, "rb") as f, \
                    open(jp["op_aux_paths"][nid][name], "rb") as g:
                assert f.read() == g.read(), (nid, name)
    assert pp["sinks"].keys() == jp["sinks"].keys()
    for nid in jp["sinks"]:
        assert ({c: row_view(r) for c, r in pp["sinks"][nid].items()}
                == {c: row_view(r) for c, r in jp["sinks"][nid].items()})


@pytest.mark.parametrize("job", sorted(JOBS))
def test_each_package_resumes_the_others_checkpoint(job, cut_runs, tmp_path):
    """A resume from checkpoint 1 (``execution.checkpointing.restore:
    <path>``) commits the same rows whichever package wrote it and
    whichever resumes it: the port reads the JAX package's checkpoint,
    and the JAX package reads the port's."""
    (jrows, jpath), (prows, ppath) = cut_runs(JAX, job), cut_runs(PORT, job)
    got = {}
    for reader in BOTH:
        for writer, path in (("jax", jpath), ("port", ppath)):
            got[(reader.name, writer)] = commit_view(job, cut_job(
                reader, job, str(tmp_path / f"{reader.name}-{writer}"), None,
                interval=1, restore=path))
    want = got[("jax", "jax")]
    assert all(v == want for v in got.values()) and len(want) > 0
    # the resumed rows are the tail of the uninterrupted run
    assert want == commit_view(job, jrows[len(jrows) - len(want):])


@pytest.mark.parametrize("P", BOTH, ids=pkg_id)
def test_a_savepoint_is_retained_and_resumes(P, tmp_path):
    """``checkpoint_now(savepoint=True)``: a self-contained savepoint-1
    that retention never retires and latest() skips; a resume from its
    path commits the uninterrupted run's rows."""
    root = str(tmp_path / "sp")
    rows = cut_job(P, "count_window", root, CUTS["count_window"],
                   savepoint=True)
    st = P.storage.FsCheckpointStorage(root, "count_window")
    hs = st.list_complete()
    assert [h.checkpoint_id for h in hs if h.is_savepoint] == [1]
    assert not st.latest().is_savepoint
    mf = json.load(open(os.path.join(root, "count_window", "savepoint-1",
                                     "MANIFEST.json")))
    assert all(not os.path.samefile(
        os.path.join(root, "count_window", "savepoint-1", e["file"]),
        os.path.join(h.path, e["file"]))
        for h in hs if not h.is_savepoint for e in mf["ops"].values()
        if os.path.exists(os.path.join(h.path, e["file"])))
    resumed = cut_job(P, "count_window", str(tmp_path / "r"), None,
                      interval=1, restore=os.path.join(
                          root, "count_window", "savepoint-1"))
    assert resumed == rows and len(rows) > 0


@needs_native
def test_restore_across_sub_batch_factors(cut_runs, tmp_path):
    """A checkpoint of the K = 4 devgen chain cut at sub-batch 9 (in the
    middle of logical batch 2) cannot resume at K = 1 or 2, in both
    packages; one cut at sub-batch 8 resumes at K = 2 (position 4) and
    commits, window by window, the rows of the run at K = 4."""
    for P in BOTH:
        path = cut_runs(P, "q5_devgen_k4")[1]
        for k in (1, 2):
            with pytest.raises(ValueError, match="does not align"):
                cut_job(P, "q5_devgen_k4", str(tmp_path / f"{P.name}{k}"),
                        None, interval=1, restore=path,
                        extra={"pipeline.sub-batches": k})
    out = {}
    for P in BOTH:
        root = str(tmp_path / f"{P.name}-8")
        full = cut_job(P, "q5_devgen_k4", root, 8)
        resumed = cut_job(P, "q5_devgen_k4", str(tmp_path / f"{P.name}-r"),
                          None, interval=1,
                          restore=os.path.join(root, "q5_devgen_k4", "chk-1"),
                          extra={"pipeline.sub-batches": 2})
        assert sorted(resumed) == sorted(full) and len(full) > 0
        out[P.name] = resumed
    assert out["port"] == out["jax"]


def test_a_checkpoint_of_another_process_names_the_rescale_item(tmp_path):
    """A checkpoint written by process 1 of 2 restores in one process only
    through the key-group merge of checkpoint/repartition.py, over the
    whole set of the old processes' checkpoints: named alone (no
    ``cluster.rescale-from``), the set is incomplete, and both packages
    refuse it with the merge's ``RescaleError``."""
    from flink_tpu.checkpoint.repartition import RescaleError as JaxRescale
    from flink_tpu_torch.checkpoint.repartition import RescaleError

    sink = PORT.sinks.TransactionalCollectSink()
    env = PORT.Env(job_conf(PORT, str(tmp_path), {
        "execution.checkpointing.interval": 10 ** 9}))
    count_job(PORT, env, failing_gen(2), sink)
    PORT.execute(env, "one")
    (h,) = PORT.storage.FsCheckpointStorage(str(tmp_path), "one").list_complete()
    meta = os.path.join(h.path, "meta.blob")
    payload = PORT.blobformat.decode(open(meta, "rb").read())
    assert payload["rescale"] == {"nproc": 1, "pid": 0, "num_shards": 8,
                                  "shard_range": [0, 8]}
    payload["rescale"] = {"nproc": 2, "pid": 1, "num_shards": 8,
                          "shard_range": [4, 8]}
    with open(meta, "wb") as f:
        f.write(PORT.blobformat.encode(payload))
    for P, err in ((PORT, RescaleError), (JAX, JaxRescale)):
        env2 = P.Env(job_conf(P, str(tmp_path / f"b-{P.name}"), {
            "execution.checkpointing.restore": h.path}))
        count_job(P, env2, failing_gen(2), P.sinks.TransactionalCollectSink())
        with pytest.raises(err, match="2-process fleet"):
            P.execute(env2, "two")
