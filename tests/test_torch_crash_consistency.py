"""The crash-state explorer against the port's durable tiers: for each
tier a mutation phase is journaled through the port's CrashFS
(``flink_tpu_torch/fs_crash.py``), POSIX-legal post-crash images are
sampled at seeded cuts, and each image's recovery — the tier's real
recovery machinery — must converge to output equal to the fault-free
golden, or fail loudly. A failing image prints (tier, seed, image,
cut, decisions) for exact replay.

Tiers: checkpoint storage (v1, v2/v3 blobs and the incremental
hardlink reuse), the LSM state tier (seals, a compaction's manifest
swap), the log tier's four (segments and 2PC markers, a compaction's
manifest swap, writer leases with group offsets, and the bus on
``objstore://`` over CrashFS), all as ``tests/test_crash_consistency.py``
has them, each log tier's golden equal to the reference's, the file
sink's staged and committed parts (``FileSinkTier``, recovered through
``restore_staged``, its golden equal to the reference's), and a whole
job: SQL Q5 host-fed checkpointing at every batch
boundary into ``crash://``, restored from each image with
``execution.checkpointing.restore: latest`` into the transactional
sink as the crash left it, whose committed rows must be the golden's,
once each. The job's golden equals the reference's same SQL job.

The durable session registry (``HaRegistryTier``, the HA job store of
``runtime/ha.py``) is a tier too, its golden equal to the reference's.

Tier-1 runs the reference's bounded schedule (3 seeds x 8 images per
tier); the ``slow`` soak runs 70 images a seed.
"""
import json
import os
import random
import time

import numpy as np
import pytest

from flink_tpu_torch import fs_crash
from flink_tpu_torch.checkpoint import blobformat
from flink_tpu_torch.checkpoint.storage import (
    FsCheckpointStorage, ReusedOpState)
from flink_tpu_torch.fs import get_filesystem
from flink_tpu_torch.log.bus import Compactor, ConsumerGroups, LeaseManager
from flink_tpu_torch.log.topic import (
    TopicAppender,
    TopicReader,
    create_topic,
    list_group_offsets,
    list_leases,
)
from flink_tpu_torch.runtime.ha import JobStore
from test_torch_ckpt_pkgs import JAX, PORT
from test_torch_threads import capped_torch_threads  # noqa: F401

pytestmark = pytest.mark.chaos

# recovery may FAIL LOUDLY on an image (ValueErrors, torn reads as
# OSErrors); it must never succeed with different output
LOUD = (ValueError, OSError)


def _canon(obj):
    """Numpy-free canonical form for golden comparison."""
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(
            obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [_canon(v) for v in obj.tolist()]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, bytes):
        return obj.hex()
    return obj


def _read_topic(topic: str):
    r = TopicReader(topic)
    out = {}
    for p in range(r.partitions):
        rows = []
        for off, block in r.read(p):
            rows.append([off, _canon(block)])
        out[p] = rows
    return {"rows": out,
            "committed": _canon(r.committed_offsets()),
            "compacted_end": _canon(r.compacted_ends()),
            "start": _canon(r.start_offsets())}


@pytest.fixture(autouse=True)
def _restore_objstore_default():
    """The objstore-bus tier registers ``objstore://`` over each crash
    image's root; put the default registration back afterwards."""
    yield
    import flink_tpu_torch.fs_objstore as fso

    fso.install(inner_prefix="")


# -- tier scenarios ---------------------------------------------------------
# Each tier: setup(root), where a tier has one, runs before the journal
# (the state the crash starts from); mutate(root) is the journaled phase
# and returns what recovery needs (the staged payload a checkpoint
# holds); recover(root, aux, cut) completes the protocol on a crashed
# image; observe(root) returns the committed, visible output.


class CheckpointTier:
    """Checkpoint storage: v1 single, v2/v3 per-op blobs, and the
    incremental link_or_copy reuse path."""

    name = "checkpoint"

    def mutate(self, root):
        st = FsCheckpointStorage(os.path.join(root, "chk"), "job")
        st.save(1, {"sources": {"0": 4}, "operators": {}})
        h2 = st.save_v2(
            2, {"op_versions": {"7": 1, "8": 1}},
            {"7": blobformat.encode(list(range(50))),
             "8": blobformat.encode({"table": ["a", "b"]})}, {})
        st.save_v2(
            3, {"op_versions": {"7": 2, "8": 1}},
            {"7": blobformat.encode(list(range(50, 120)))},
            {"8": ReusedOpState(
                file=os.path.join(h2.path, h2.op_files["8"]),
                version=1)})
        return None

    def recover(self, root, aux, cut):
        # restart-from-scratch recovery: re-running the deterministic
        # save sequence is what a restarted attempt does
        self.mutate(root)

    def observe(self, root):
        st = FsCheckpointStorage(os.path.join(root, "chk"), "job")
        h = st.latest()
        payload = FsCheckpointStorage.load(h)
        return {"id": h.checkpoint_id,
                "ops": _canon(payload.get("operators", {})),
                "versions": _canon(payload.get("op_file_versions", {}))}

    def check_image(self, root):
        """Before recovery re-runs anything: every checkpoint the store
        lists as complete must load — a durable manifest whose linked op
        blob vanished would be an acknowledged checkpoint the job cannot
        restore from (``save_v2``'s directory fsync after the reuse
        links guards it)."""
        st = FsCheckpointStorage(os.path.join(root, "chk"), "job")
        for h in st.list_complete():
            FsCheckpointStorage.load(h)


class _Agg:
    """One f32 lane in each lane group, lifted in torch on the CPU."""
    sum_width = max_width = min_width = 1

    def lift_masked(self, data, valid):
        v = data["v"].float()[:, None]
        return v, v, v


class LsmTier:
    """The LSM keyed-state tier (``state/lsm.py``): budget 0 seals one
    run a batch, so the durable manifest's ``seq`` is the applied-batch
    count; a final compaction exercises the manifest swap. Recovery
    adopts the manifest the cut left, re-absorbs the missing batches
    and re-compacts; the fold must equal the golden's."""

    name = "lsm-state"
    N = 5

    def _mk(self, root):
        from flink_tpu_torch.state.lsm import LsmSpillStore

        return LsmSpillStore(
            _Agg(), store_dir=os.path.join(root, "store"),
            memory_budget_bytes=0, num_shards=8, compact_min_runs=99)

    def _absorb(self, store, i):
        k = (np.arange(24, dtype=np.int64) * (i + 3)) % 7
        p = np.full(24, i % 3, dtype=np.int64)
        v = np.arange(24, dtype=np.float32) * 0.37 + i
        store.absorb(k, p, {"v": v})

    def mutate(self, root):
        store = self._mk(root)
        for i in range(self.N):
            self._absorb(store, i)
        store.compact()
        return None

    def recover(self, root, aux, cut):
        store = self._mk(root)
        for i in range(min(store._seq, self.N), self.N):
            self._absorb(store, i)
        store.compact()

    def observe(self, root):
        store = self._mk(root)
        scratch = store._fold_runs(store._live_runs(), include_delta=True)
        return {int(p): _canon(list(scratch.panes[p]))
                for p in sorted(scratch.panes)}

    def check_image(self, root):
        """Before recovery: a durable manifest parses, and every run it
        lists exists and decodes to its promised row count."""
        from flink_tpu_torch.state.lsm import _decode_run_panes

        sdir = os.path.join(root, "store")
        mpath = os.path.join(sdir, "MANIFEST.json")
        if not os.path.exists(mpath):
            return
        with open(mpath) as f:
            man = json.load(f)
        assert man.get("format") == "lsm-state"
        for meta in man.get("runs", []):
            rows = sum(len(t[0]) for _, t in _decode_run_panes(
                os.path.join(sdir, meta["name"]), 0))
            assert rows == int(meta["rows"]), (
                f"run {meta['name']}: {rows} rows != promised "
                f"{meta['rows']}")


Q5_SQL = ("SELECT auction, window_end, COUNT(*) AS bid_count "
          "FROM TABLE(HOP(TABLE bids, DESCRIPTOR(ts), "
          "INTERVAL '1' SECOND, INTERVAL '4' SECOND)) "
          "GROUP BY auction, window_start, window_end "
          "ORDER BY bid_count DESC LIMIT 1")
JOB_CFG = dict(batch_size=2048, n_batches=6, events_per_ms=1,
               num_active_auctions=300, hot_ratio=4)


def job_bids(pace_s=0.0):
    """The job's numpy bids, the same for both packages; ``pace_s``
    sleeps before each batch, so a checkpoint completes between
    batches."""
    def gen(split, i):
        if i >= JOB_CFG["n_batches"]:
            return None
        time.sleep(pace_s)
        return PORT.gen.bid_batch(PORT.gen.NexmarkConfig(**JOB_CFG),
                                  int(split), i)
    return gen


def sql_q5_job(P, conf, sink, pace_s=0.0):
    """SQL Q5 on ``job_bids`` through ``P``'s Table API, into ``sink``."""
    from importlib import import_module

    table = import_module(
        ("flink_tpu_torch" if P is PORT else "flink_tpu") + ".table")
    env = P.Env(P.Conf(conf))
    t_env = table.TableEnvironment.create(env)
    bids = env.from_source(P.GeneratorSource(job_bids(pace_s)),
                           P.WM.for_bounded_out_of_orderness(500))
    t_env.create_temporary_view("bids", bids,
                                schema=["auction", "price", "ts"],
                                time_attr="ts")
    t_env.sql_query(Q5_SQL).add_sink(sink)
    return env


class SqlQ5JobTier:
    """SQL Q5 host-fed, a checkpoint at every batch boundary, into a
    transactional sink. The sink is the external system: it survives
    the power cut with what it had committed when the cut struck (the
    commit log records each commit's journal position). Recovery
    restores the newest complete checkpoint of the image into that
    sink and runs to the end of input."""

    name = "sql-q5-job"

    def __init__(self):
        self._rows = None

    @staticmethod
    def _conf(root, restore):
        conf = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
                "pipeline.microbatch-size": JOB_CFG["batch_size"],
                "execution.checkpointing.interval": 1,
                "execution.checkpointing.dir": os.path.join(root, "chk")}
        if restore:
            conf["execution.checkpointing.restore"] = "latest"
        return conf

    def mutate(self, root):
        journal = getattr(get_filesystem(root), "journal", None)
        log = []

        class LoggedSink(PORT.sinks.TransactionalCollectSink):
            def notify_checkpoint_complete(self, checkpoint_id):
                super().notify_checkpoint_complete(checkpoint_id)
                log.append((len(journal) if journal is not None else 0,
                            len(self.committed), self._last_committed))

        sink = LoggedSink()
        PORT.execute(sql_q5_job(PORT, self._conf(root, False), sink,
                                pace_s=0.05), "sql-q5")
        assert len(log) > 2, "the job completed too few checkpoints"
        self._rows = list(sink.committed)
        return {"log": log, "rows": list(sink.committed)}

    def recover(self, root, aux, cut):
        sink = PORT.sinks.TransactionalCollectSink()
        done = [r for r in aux["log"] if r[0] <= cut]
        if done:
            _, n, last = done[-1]
            sink.committed.extend(aux["rows"][:n])
            sink._last_committed = last
        PORT.execute(sql_q5_job(PORT, self._conf(root, True), sink),
                     "sql-q5")
        self._rows = list(sink.committed)

    def observe(self, root):
        return sorted((int(r["auction"]), int(r["window_end"]),
                       int(r["bid_count"])) for r in self._rows)


class LogTxnTier:
    """Log segments + 2PC markers: two committed transactions across
    two partitions, recovered by rebuild-from-checkpoint-payload +
    idempotent re-commit (the restore_staged path)."""

    name = "log-2pc"

    def setup(self, root):
        pass

    def _batches(self):
        b1 = {"k": np.arange(8, dtype=np.int64),
              "v": np.arange(8, dtype=np.float64) * 1.5}
        b2 = {"k": np.arange(8, 13, dtype=np.int64),
              "v": np.arange(5, dtype=np.float64) - 2.0}
        return b1, b2

    def mutate(self, root):
        topic = os.path.join(root, "events")
        ap = TopicAppender(topic, partitions=2, segment_records=4)
        b1, b2 = self._batches()
        aux = {}
        ap.stage(1, {0: [b1], 1: [b1]})
        aux["1"] = ap.snapshot(1)
        ap.commit(1)
        ap.stage(2, {0: [b2], 1: [b2]})
        aux["2"] = ap.snapshot(2)
        ap.commit(2)
        return aux

    def recover(self, root, aux, cut=None):
        topic = os.path.join(root, "events")
        ap = TopicAppender(topic, partitions=2, segment_records=4)
        for cid in ("1", "2"):
            ap.rebuild(int(cid), aux[cid])
            ap.commit(int(cid))
        ap.sweep_orphans()

    def observe(self, root):
        return _read_topic(os.path.join(root, "events"))


class CompactionTier:
    """The compaction manifest swap: committed history exists BEFORE
    journaling (base snapshot); the journaled phase is one compaction
    pass; recovery re-runs the pass on whatever generation the crash
    left visible."""

    name = "compaction-swap"

    def _batch(self, lo):
        return {"k": (np.arange(lo, lo + 6, dtype=np.int64) % 4),
                "v": np.arange(lo, lo + 6, dtype=np.int64)}

    def setup(self, root):
        topic = os.path.join(root, "keyed")
        create_topic(topic, 1, key_field="k")
        ap = TopicAppender(topic, partitions=1, segment_records=6)
        for cid in (1, 2, 3):
            ap.stage(cid, {0: [self._batch(cid * 10)]})
            ap.commit(cid)

    def mutate(self, root):
        Compactor(os.path.join(root, "keyed"), min_segments=2).compact()
        return None

    def recover(self, root, aux, cut=None):
        topic = os.path.join(root, "keyed")
        Compactor(topic, min_segments=2).compact()
        TopicAppender(topic, partitions=1, segment_records=6).sweep_orphans()

    def observe(self, root):
        return _read_topic(os.path.join(root, "keyed"))


class LeaseGroupTier:
    """Writer leases + consumer-group offsets: both are control files
    published through write_atomic; recovery re-runs the idempotent
    acquire/commit sequence (max-merge, keep-epoch)."""

    name = "lease-group"

    def setup(self, root):
        create_topic(os.path.join(root, "t"), 2, key_field="k")

    def mutate(self, root):
        topic = os.path.join(root, "t")
        lm = LeaseManager(topic, "producer-a", [0, 1], ttl_ms=3_600_000)
        lm.acquire()
        ConsumerGroups.commit(topic, "g1", {0: 5, 1: 3})
        ConsumerGroups.commit(topic, "g1", {0: 9})
        ConsumerGroups.commit(topic, "g2", {0: 2, 1: 2})
        return None

    def recover(self, root, aux, cut=None):
        self.mutate(root)

    def observe(self, root):
        topic = os.path.join(root, "t")
        leases = {p: {"owner": rec.get("owner"),
                      "epoch": rec.get("epoch"),
                      "released": rec.get("released", False)}
                  for p, rec in list_leases(topic).items()}
        return {"groups": _canon(list_group_offsets(topic)),
                "leases": _canon(leases)}


class ObjstoreBusTier:
    """The bus tier served THROUGH the objstore CAS driver
    composed over CrashFS (``install(inner_prefix="crash://<root>/")``
    — every object put becomes a journaled atomic publish): a
    committed 2PC transaction, CAS writer leases, dynamic-group
    membership (two joins → generation 2) + a generation-keyed offset
    commit, and a compaction pass whose manifest swap is a
    conditional put. Recovery re-runs the idempotent sequence
    (rebuild+re-commit, keep-epoch re-acquire, idempotent re-join,
    max-merge re-commit at the CURRENT generation, re-compact) on
    whatever objects the cut left visible."""

    name = "objstore-bus"
    TOPIC = "objstore://t"

    def _install(self, root):
        import flink_tpu_torch.fs_objstore as fso

        fso.install(inner_prefix=root.rstrip("/") + "/")

    def _batch(self, lo):
        return {"k": (np.arange(lo, lo + 8, dtype=np.int64) % 4),
                "v": np.arange(lo, lo + 8, dtype=np.float64)}

    def setup(self, root):
        self._install(root)
        create_topic(self.TOPIC, 2, key_field="k")
        ap = TopicAppender(self.TOPIC, partitions=2, segment_records=4)
        for cid in (1, 2):
            b = self._batch(cid * 10)
            ap.stage(cid, {0: [b], 1: [b]})
            ap.commit(cid)

    def mutate(self, root):
        self._install(root)
        ap = TopicAppender(self.TOPIC, partitions=2, segment_records=4)
        b = self._batch(30)
        ap.stage(3, {0: [b], 1: [b]})
        aux = {"3": ap.snapshot(3)}
        ap.commit(3)
        LeaseManager(self.TOPIC, "producer-a", [0, 1],
                     ttl_ms=3_600_000).acquire()
        ConsumerGroups.join(self.TOPIC, "g1", "m1")
        ConsumerGroups.join(self.TOPIC, "g1", "m2")
        ConsumerGroups.commit(self.TOPIC, "g1", {0: 5, 1: 3},
                              generation=2)
        Compactor(self.TOPIC, min_segments=2).compact()
        return aux

    def recover(self, root, aux, cut=None):
        self._install(root)
        ap = TopicAppender(self.TOPIC, partitions=2, segment_records=4)
        ap.rebuild(3, aux["3"])
        ap.commit(3)
        LeaseManager(self.TOPIC, "producer-a", [0, 1],
                     ttl_ms=3_600_000).acquire()
        ConsumerGroups.join(self.TOPIC, "g1", "m1")
        ConsumerGroups.join(self.TOPIC, "g1", "m2")
        gen = ConsumerGroups.read_membership(
            self.TOPIC, "g1")["generation"]
        ConsumerGroups.commit(self.TOPIC, "g1", {0: 5, 1: 3},
                              generation=gen)
        Compactor(self.TOPIC, min_segments=2).compact()
        ap.sweep_orphans()

    def observe(self, root):
        self._install(root)
        view = _read_topic(self.TOPIC)
        leases = {p: {"owner": rec.get("owner"),
                      "epoch": rec.get("epoch"),
                      "released": rec.get("released", False)}
                  for p, rec in list_leases(self.TOPIC).items()}
        return {"topic": view,
                "groups": _canon(list_group_offsets(self.TOPIC)),
                "membership": _canon(ConsumerGroups.read_membership(
                    self.TOPIC, "g1")),
                "leases": _canon(leases)}

    def check_image(self, root):
        """PUT-is-durable, asserted BEFORE recovery: an object either
        exists whole or not at all — every .json object in the image
        must parse (a torn one would mean the buffered-put publish
        leaked a partial object through the crash)."""
        for dirpath, _dirs, files in os.walk(os.path.join(root, "t")):
            for name in files:
                if name.endswith(".json"):
                    with open(os.path.join(dirpath, name)) as f:
                        json.load(f)


class FileSinkTier:
    """``FileSink`` staged and committed parts (attempt-epoch names),
    recovered through the real ``restore_staged`` path."""

    name = "filesink"

    def _sink(self, root):
        from flink_tpu_torch.connectors import FileSink
        from flink_tpu_torch.formats import JsonLinesFormat

        return FileSink(os.path.join(root, "out"),
                        JsonLinesFormat([("k", "i64"), ("v", "str")]),
                        rolling_records=3)

    def _write(self, sink, lo, n):
        sink.write({"k": np.arange(lo, lo + n, dtype=np.int64),
                    "v": np.array([f"row-{i}" for i in range(lo, lo + n)],
                                  dtype=object)})

    def mutate(self, root):
        sink = self._sink(root)
        aux = {}
        self._write(sink, 0, 5)
        sink.prepare_commit(1)
        aux["1"] = sink.snapshot_transaction(1)
        sink.commit_transaction(1)
        self._write(sink, 5, 4)
        sink.prepare_commit(2)
        aux["2"] = sink.snapshot_transaction(2)
        sink.commit_transaction(2)
        return aux

    def recover(self, root, aux, cut):
        self._sink(root).restore_staged({"txn": dict(aux)}, 2)

    def observe(self, root):
        return _canon(self._sink(root).committed_batches())


class HaRegistryTier:
    """The durable session registry (runtime/ha.py JobStore): every
    put is atomic-durable, terminal states archive; recovery re-runs
    the lifecycle (idempotent same-content puts)."""

    name = "ha-registry"

    def setup(self, root):
        pass

    def mutate(self, root):
        js = JobStore(os.path.join(root, "ha"))
        js.put("job-a", entry="m:f", config={"x": 1}, state="WAITING",
               attempts=1, submitted_at=100.0)
        js.put("job-b", entry="m:g", config={}, state="WAITING",
               attempts=1, submitted_at=101.0)
        js.put("job-a", entry="m:f", config={"x": 1}, state="RUNNING",
               attempts=1, submitted_at=100.0,
               assigned_runners=["runner-1"])
        js.put("job-b", entry="m:g", config={}, state="FINISHED",
               attempts=1, submitted_at=101.0)
        return None

    def recover(self, root, aux, cut=None):
        self.mutate(root)

    def observe(self, root):
        js = JobStore(os.path.join(root, "ha"))
        recs = sorted(js.recoverable(), key=lambda r: r["job_id"])
        return {"active": _canon(recs),
                "archived_b": _canon(js.get("job-b"))}

    def check_image(self, root):
        """No-torn-record invariant, asserted BEFORE recovery: a
        power cut must never leave garbage at a registry record's
        final name (recoverable() silently skips parse failures — a
        torn record would be a SILENTLY lost job)."""
        for sub in ("jobs", "jobs-archive"):
            d = os.path.join(root, "ha", sub)
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                if not name.endswith(".json"):
                    continue
                with open(os.path.join(d, name)) as f:
                    json.load(f)  # raises on a torn record


TIERS = (CheckpointTier(), LsmTier(), SqlQ5JobTier(), LogTxnTier(),
         CompactionTier(), LeaseGroupTier(), ObjstoreBusTier(),
         FileSinkTier(), HaRegistryTier())
LOG_TIERS = ("log-2pc", "compaction-swap", "lease-group", "objstore-bus")


def explore(tier, tmp_path, seeds, images_per_seed):
    setup = getattr(tier, "setup", lambda root: None)
    groot = os.path.join(str(tmp_path), "golden")
    os.makedirs(groot)
    setup(groot)
    tier.mutate(groot)
    golden = tier.observe(groot)

    recovered = loud = 0
    for seed in seeds:
        root = os.path.join(str(tmp_path), f"run-{seed}")
        os.makedirs(root)
        setup(root)  # the state before the journaled phase
        cfs = fs_crash.install(root)
        try:
            aux = tier.mutate("crash://" + root)
            assert cfs.journal, (
                f"tier {tier.name}: journaled phase recorded no "
                "mutations — the tier is not routed through the seam")
            img = os.path.join(str(tmp_path), "img")
            for k in range(images_per_seed):
                rng = random.Random((seed << 20) ^ k)
                dec = cfs.crash(img, rng=rng, seed=seed)
                ctx = (f"tier={tier.name} seed={seed} image={k} "
                       f"cut={dec['cut']}/{len(cfs.journal)} "
                       f"decisions={dec['decisions']}")
                check = getattr(tier, "check_image", None)
                if check is not None:
                    check(img)  # pre-recovery invariants
                try:
                    tier.recover(img, aux, dec["cut"])
                    got = tier.observe(img)
                except LOUD:
                    loud += 1
                    continue
                assert _canon(got) == _canon(golden), (
                    f"SILENT DIVERGENCE after recovery — {ctx}\n"
                    f"got:    {got}\ngolden: {golden}")
                recovered += 1
        finally:
            cfs.close()
    # a recovery that always fails loudly would pass vacuously
    total = recovered + loud
    assert recovered >= max(1, total // 2), (
        f"tier {tier.name}: only {recovered}/{total} images recovered "
        f"cleanly ({loud} loud) — recovery is broken, not just loud")
    return recovered, loud


@pytest.mark.parametrize("tier", TIERS, ids=[t.name for t in TIERS])
def test_crash_images_recover_to_golden(tier, tmp_path):
    """3 seeds x 8 sampled crash images per tier, each recovering to the
    fault-free golden or failing loudly."""
    explore(tier, tmp_path, seeds=(0, 1, 2), images_per_seed=8)


@pytest.mark.slow
@pytest.mark.parametrize("tier", TIERS, ids=[t.name for t in TIERS])
def test_crash_soak(tier, tmp_path):
    """At least 200 sampled crash images per tier over 3 seeds."""
    recovered, loud = explore(tier, tmp_path, seeds=(0, 1, 2),
                              images_per_seed=70)
    assert recovered + loud >= 200


def test_sql_q5_job_golden_equals_the_reference(tmp_path):
    """The job tier's golden is the reference's: the same SQL text over
    the same bids commits the same rows, in the same order, in both
    packages."""
    rows = {}
    for P in (PORT, JAX):
        sink = P.sinks.TransactionalCollectSink()
        conf = SqlQ5JobTier._conf(str(tmp_path / P.name), False)
        P.execute(sql_q5_job(P, conf, sink), "sql-q5")
        rows[P.name] = [(int(r["auction"]), int(r["window_end"]),
                         int(r["bid_count"])) for r in sink.committed]
    assert rows["port"] == rows["jax"]
    assert len(rows["jax"]) > 0


@pytest.mark.parametrize("name", LOG_TIERS)
def test_log_tier_golden_equals_the_reference(name, tmp_path):
    """Each log tier's fault-free output is the reference's same tier's,
    run on the JAX package."""
    _golden_equals_the_reference(name, tmp_path)


def test_filesink_tier_golden_equals_the_reference(tmp_path):
    """The file sink tier's fault-free committed parts read back as the
    reference's same tier's."""
    _golden_equals_the_reference("filesink", tmp_path)


def test_ha_registry_tier_golden_equals_the_reference(tmp_path):
    """The session registry's fault-free records read back as the
    reference's same tier's."""
    _golden_equals_the_reference("ha-registry", tmp_path)


def _golden_equals_the_reference(name, tmp_path):
    import test_crash_consistency as ref

    port = next(t for t in TIERS if t.name == name)
    theirs = next(t for t in ref.TIERS if t.name == name)
    got = {}
    for key, tier, fso in (("port", port, "flink_tpu_torch.fs_objstore"),
                           ("jax", theirs, "flink_tpu.fs_objstore")):
        root = str(tmp_path / key)
        os.makedirs(root)
        try:
            getattr(tier, "setup", lambda root: None)(root)
            tier.mutate(root)
            got[key] = _canon(tier.observe(root))
        finally:
            import importlib

            importlib.import_module(fso).install(inner_prefix="")
    assert got["port"] == got["jax"]
