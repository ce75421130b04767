"""The crash-state explorer against the port's durable tiers: for each
tier a mutation phase is journaled through the port's CrashFS
(``flink_tpu_torch/fs_crash.py``), POSIX-legal post-crash images are
sampled at seeded cuts, and each image's recovery — the tier's real
recovery machinery — must converge to output equal to the fault-free
golden, or fail loudly. A failing image prints (tier, seed, image,
cut, decisions) for exact replay.

Tiers: checkpoint storage (v1, v2/v3 blobs and the incremental
hardlink reuse), the LSM state tier (seals, a compaction's manifest
swap), both as ``tests/test_crash_consistency.py`` has them, and a
third, a whole job: SQL Q5 host-fed checkpointing at every batch
boundary into ``crash://``, restored from each image with
``execution.checkpointing.restore: latest`` into the transactional
sink as the crash left it, whose committed rows must be the golden's,
once each. The job's golden equals the reference's same SQL job.

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


TIERS = (CheckpointTier(), LsmTier(), SqlQ5JobTier())


def explore(tier, tmp_path, seeds, images_per_seed):
    groot = os.path.join(str(tmp_path), "golden")
    os.makedirs(groot)
    tier.mutate(groot)
    golden = tier.observe(groot)

    recovered = loud = 0
    for seed in seeds:
        root = os.path.join(str(tmp_path), f"run-{seed}")
        os.makedirs(root)
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
