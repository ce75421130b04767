"""Chaos at the port's log seams against the JAX package's, on the CPU:
each case of ``tests/test_log_chaos.py`` runs on both packages — a
producer job writing a topic through ``LogSink`` under a fault at one
of the log's 2PC seams, chained into a fault-free consumer job; a
producer that dies for good; compaction and retention dying at each
maintenance point; leased producers dying at the lease seams; two
producers and two consumer groups under crashes; the prefetch seam;
and the object store's CAS, cleaner, rebalance and fence points — and
compares the consumers' committed rows, the faults that fired and the
topics' committed state.

The producer jobs checkpoint every millisecond, so how many epochs a
run commits depends on the host's speed; the cases compare what does
not (rows, offsets, the fault log's points). A successor whose
reference waits out a 1 ms lease instead takes the partition by its
clock (``now_fn``). ``TestLogChaosSoak`` is ``slow`` as the
reference's is."""
import os
import shutil
import threading

import numpy as np
import pytest

from test_torch_log_pkgs import LJ, LP, raised, run_both, topic_view
from test_torch_threads import capped_torch_threads  # noqa: F401

CHAOS_SEED = 1234
N_BATCHES = 12
BATCH = 64
VOCAB = 10
KV_BATCHES = 8
FAR = 10 ** 18


def word_gen(n_batches):
    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng(7100 + i)
        words = rng.integers(0, VOCAB, BATCH).astype(np.int64)
        ts = (i * BATCH + np.arange(BATCH, dtype=np.int64)) * 10
        return {"word": words, "ts_ms": ts}, ts

    return gen


def recovering_conf(L, ckpt, attempts=20, **extra):
    return L.Conf({
        "pipeline.microbatch-size": BATCH,
        "execution.checkpointing.dir": str(ckpt),
        "execution.checkpointing.interval": 1,
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": attempts,
        "restart-strategy.fixed-delay.delay": 1, **extra})


def produce(L, root, topic, tag):
    def build_env(conf):
        env = L.Env(conf)
        env.from_source(L.GeneratorSource(word_gen(N_BATCHES))).add_sink(
            L.log.LogSink(topic, key_field="word", partitions=2))
        return env

    L.recover(build_env, recovering_conf(L, root / f"ckpt-{tag}"),
              f"log-chaos-{tag}")


def consume(L, topic):
    sink = L.sinks.TransactionalCollectSink()
    env = L.Env(L.Conf({"state.num-key-shards": 8,
                        "state.slots-per-shard": 64}))
    (env.from_source(L.log.LogSource(topic, ts_field="ts_ms"),
                     L.WM.for_bounded_out_of_orderness(1000))
     .key_by("word").window(L.Tumbling.of(1000)).count()
     .add_sink(sink))
    L.execute(env, "log-chaos-consumer")
    return sorted((int(r["key"]), int(r["window_start"]), int(r["count"]))
                  for r in sink.committed)


def fired(plan):
    return [tuple(x[:2]) for x in plan.log]


@pytest.fixture(scope="module")
def golden_chain(tmp_path_factory):
    """The reference's fault-free chain, run once a module."""
    d = tmp_path_factory.mktemp("golden")
    topic = str(d / "topic")
    produce(LJ, d, topic, "golden")
    return consume(LJ, topic)


class TestLogChaosExactlyOnce:
    SCENARIOS = {
        "torn-append": ("log.segment.append", dict(count=1, after=3)),
        "fsync-fault": ("log.segment.fsync", dict(count=1, after=3)),
        "marker-write": ("log.txn.marker", dict(count=1, after=1)),
        "precommit-commit-crash": ("log.txn.commit",
                                   dict(count=1, after=1)),
    }

    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_fault_kind_chain_is_byte_identical(self, tmp_path, name,
                                                golden_chain):
        point, kw = self.SCENARIOS[name]

        def scenario(L, root):
            topic = str(root / "topic")
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                point, "raise", **kw)
            with plan.activate():
                produce(L, root, topic, name)
            d = L.log.describe_topic(topic)
            return (fired(plan), d["staged_transactions"],
                    d["committed_offsets"], consume(L, topic))

        log, staged, _, got = run_both(scenario, tmp_path)
        assert log == [(point, "raise")] and staged == []
        assert got == golden_chain and got

    def test_same_seed_same_commit_crash_recovery(self, tmp_path,
                                                  golden_chain):
        def scenario(L, root):
            logs = []
            for i in range(2):
                topic = str(root / f"topic{i}")
                plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                    "log.txn.commit", "raise", count=1, after=1)
                (root / f"r{i}").mkdir()
                with plan.activate():
                    produce(L, root / f"r{i}", topic, f"det{i}")
                assert consume(L, topic) == golden_chain
                logs.append(fired(plan))
            assert logs[0] == logs[1]
            return logs

        run_both(scenario, tmp_path)


class TestIsolationUnderPermanentFailure:
    def test_dead_producer_exposes_only_committed_prefix(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "topic")

            def build_env(conf):
                env = L.Env(conf)
                env.from_source(
                    L.GeneratorSource(word_gen(N_BATCHES))).add_sink(
                    L.log.LogSink(topic, key_field="word", partitions=2))
                return env

            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "log.txn.commit", "raise", after=1)
            with plan.activate():
                err = raised(lambda: L.recover(
                    build_env, recovering_conf(L, root / "ckpt", 2),
                    "log-dead"), OSError, "injected fault")
            r = L.topic.TopicReader(topic)
            committed = r.committed_offsets()
            seen = {}
            for p in sorted(committed):
                for _, b in r.read(p):
                    for w, t in zip(b["word"].tolist(),
                                    b["ts_ms"].tolist()):
                        seen[(w, t)] = seen.get((w, t), 0) + 1
            assert sum(seen.values()) == sum(committed.values())
            assert sum(seen.values()) < N_BATCHES * BATCH
            produced = {}
            for i in range(N_BATCHES):
                data, ts = word_gen(N_BATCHES)(None, i)
                for w, t in zip(data["word"].tolist(), ts.tolist()):
                    produced[(w, t)] = produced.get((w, t), 0) + 1
            for k, n in seen.items():
                assert n <= produced.get(k, 0), f"row {k} duplicated"
            # how far the producer got before its restarts ran out
            # depends on timing; that it died, and loudly, does not
            return err, sorted(set(fired(plan)))

        assert run_both(scenario, tmp_path) == ("OSError", [
            ("log.txn.commit", "raise")])


# -- the bus tier under faults ---------------------------------------------------

def kv_gen(n_batches, base=0):
    def gen(split, i):
        if i >= n_batches:
            return None
        seq = base + i * BATCH + np.arange(BATCH, dtype=np.int64)
        keys = seq % VOCAB + (base // 1000) * 100
        ts = seq * 10
        return {"k": keys, "seq": seq, "ts_ms": ts}, ts

    return gen


def produce_kv(L, root, topic, tag, owned=None, producer_id=None, base=0):
    def build_env(conf):
        env = L.Env(conf)
        env.from_source(L.GeneratorSource(kv_gen(KV_BATCHES, base))
                        ).add_sink(L.log.LogSink(
                            topic, key_field="k", partitions=2,
                            owned_partitions=owned,
                            producer_id=producer_id))
        return env

    L.recover(build_env, recovering_conf(L, root / f"ckpt-{tag}"),
              f"bus-chaos-{tag}")


def read_everything(L, topic):
    r = L.topic.TopicReader(topic)
    out = {}
    for p in range(r.partitions):
        rows = []
        for _off, _nxt, b in r.read3(p):
            rows.extend(zip(b["k"].tolist(), b["seq"].tolist(),
                            b["ts_ms"].tolist()))
        out[p] = rows
    return out


def latest_table(L, topic):
    table = {}
    for rows in read_everything(L, topic).values():
        for k, seq, _ts in rows:
            if k not in table or seq > table[k]:
                table[k] = seq
    return dict(sorted(table.items()))


def consume_group(L, topic, group, out_dir, ckpt_dir):
    def build_env(conf):
        env = L.Env(conf)
        env.from_source(L.log.LogSource(topic, ts_field="ts_ms",
                                        group=group)
                        ).add_sink(L.sinks.FileTransactionalSink(
                            str(out_dir)))
        return env

    L.recover(build_env, recovering_conf(L, ckpt_dir), f"group-{group}")
    return sorted((int(r["k"]), int(r["seq"]))
                  for r in L.sinks.FileTransactionalSink.committed_rows(
                      str(out_dir)))


@pytest.fixture(scope="module")
def kv_golden(tmp_path_factory):
    """One fault-free keyed topic a package, produced once a module;
    the maintenance cases copy the directory so each starts from the
    same bytes."""
    out = {}
    for L in (LJ, LP):
        d = tmp_path_factory.mktemp(f"kv-golden-{L.name}")
        topic = str(d / "topic")
        produce_kv(L, d, topic, "golden")
        out[L.name] = {"dir": topic, "full": read_everything(L, topic),
                       "latest": latest_table(L, topic)}
    assert out["port"]["full"] == out["jax"]["full"]
    return out


def _copy_topic(kv_golden, L, root):
    topic = str(root / "topic")
    shutil.copytree(kv_golden[L.name]["dir"], topic)
    return topic


class TestBusMaintenanceChaos:
    MAINT_POINTS = ("log.compact.rewrite", "log.compact.swap")

    @pytest.mark.parametrize("point", MAINT_POINTS)
    def test_compaction_crash_leaves_old_generation_whole(
            self, tmp_path, kv_golden, point):
        def scenario(L, root):
            g = kv_golden[L.name]
            topic = _copy_topic(kv_golden, L, root)
            L.bus.ConsumerGroups.commit(topic, "g", dict(
                L.topic.TopicReader(topic).committed_offsets()))
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                point, "raise", count=1)
            with plan.activate():
                err = raised(lambda: L.bus.Compactor(
                    topic, min_segments=1).compact(), OSError,
                    "injected fault")
            assert L.topic.TopicReader(topic).generation == 0
            assert read_everything(L, topic) == g["full"]
            swept = L.topic.TopicAppender(topic, 2).sweep_orphans()
            assert read_everything(L, topic) == g["full"]
            res = L.bus.Compactor(topic, min_segments=1).compact()
            assert latest_table(L, topic) == g["latest"]
            r = L.topic.TopicReader(topic)
            for p, end in r.committed_offsets().items():
                assert list(r.read3(p, end)) == []
            return err, fired(plan), swept, res, topic_view(L, topic)

        _, log, _, res, _ = run_both(scenario, tmp_path)
        assert log == [(point, "raise")] and res["gen"] == 1

    def test_retention_preswap_crash_drops_nothing(self, tmp_path,
                                                   kv_golden):
        def scenario(L, root):
            topic = _copy_topic(kv_golden, L, root)
            L.bus.ConsumerGroups.commit(topic, "g", dict(
                L.topic.TopicReader(topic).committed_offsets()))
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "log.compact.swap", "raise", count=1)
            with plan.activate():
                err = raised(lambda: L.bus.Retention(
                    topic, retention_ms=1, ts_field="ts_ms",
                    now_fn=lambda: 10 ** 13).apply(), OSError,
                    "injected fault")
            assert L.topic.TopicReader(topic).generation == 0
            assert read_everything(L, topic) == kv_golden[L.name]["full"]
            return err, fired(plan), topic_view(L, topic)

        assert run_both(scenario, tmp_path)[1] == [
            ("log.compact.swap", "raise")]

    def test_retention_postswap_crash_leaves_only_debris(self, tmp_path,
                                                         kv_golden):
        def scenario(L, root):
            topic = _copy_topic(kv_golden, L, root)
            end = dict(L.topic.TopicReader(topic).committed_offsets())
            L.bus.ConsumerGroups.commit(topic, "g", end)
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "log.retention.drop", "raise", count=1)
            with plan.activate():
                err = raised(lambda: L.bus.Retention(
                    topic, retention_ms=1, ts_field="ts_ms",
                    now_fn=lambda: 10 ** 13).apply(), OSError,
                    "injected fault")
            r = L.topic.TopicReader(topic)
            assert r.generation == 1 and r.start_offsets() == end
            assert r.committed_offsets() == end
            for p, e in end.items():
                assert list(r.read3(p, e)) == []
            removed = L.topic.TopicAppender(topic, 2).sweep_orphans()
            assert removed > 0
            return err, fired(plan), removed, topic_view(L, topic)

        assert run_both(scenario, tmp_path)[1] == [
            ("log.retention.drop", "raise")]


class TestLeaseChaos:
    @pytest.mark.parametrize("point,kw", [
        ("log.lease.acquire", dict(count=1)),
        ("log.lease.renew", dict(count=1, after=1)),
    ])
    def test_leased_producer_chain_byte_identical(self, tmp_path, kv_golden,
                                                  point, kw):
        def scenario(L, root):
            topic = str(root / "topic")
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                point, "raise", **kw)
            with plan.activate():
                produce_kv(L, root, topic, "lease", owned=[0, 1],
                           producer_id="prod")
            assert read_everything(L, topic) == kv_golden[L.name]["full"]
            d = L.log.describe_topic(topic)
            return (fired(plan), d["staged_transactions"],
                    d["writer_transactions"]["staged"],
                    d["committed_offsets"], d["leases"])

        log, staged, wstaged, _, leases = run_both(scenario, tmp_path)
        assert log == [(point, "raise")] and staged == [] and wstaged == {}
        assert {p: (l["owner"], l["epoch"]) for p, l in leases.items()} == {
            "0": ("prod", 1), "1": ("prod", 1)}


class TestTwoProducersTwoGroups:
    def _expected_rows(self):
        rows = []
        for base in (0, 1000):
            for i in range(KV_BATCHES):
                data, _ts = kv_gen(KV_BATCHES, base)(None, i)
                rows.extend(zip(data["k"].tolist(), data["seq"].tolist()))
        return sorted(rows)

    def test_exactly_once_per_group_under_crashes(self, tmp_path):
        expected = self._expected_rows()

        def scenario(L, root):
            topic = str(root / "topic")
            L.log.create_topic(topic, 2, key_field="k")
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "log.txn.commit", "raise", count=1, after=1)
            errors = []

            def run_producer(pid, owned, base):
                try:
                    produce_kv(L, root, topic, pid, owned=owned,
                               producer_id=pid, base=base)
                except BaseException as e:  # noqa: BLE001 — reported below
                    errors.append((pid, e))

            with plan.activate():
                threads = [threading.Thread(target=run_producer,
                                            args=("prod-a", [0], 0)),
                           threading.Thread(target=run_producer,
                                            args=("prod-b", [1], 1000))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            assert not errors, errors
            got = sorted((k, s) for rows in
                         read_everything(L, topic).values()
                         for k, s, _ in rows)
            assert got == expected
            cplan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "log.group.commit", "raise", count=1, after=1)
            with cplan.activate():
                got_a = consume_group(L, topic, "grp-a", root / "out-a",
                                      root / "ckpt-ga")
            got_b = consume_group(L, topic, "grp-b", root / "out-b",
                                  root / "ckpt-gb")
            assert got_a == expected and got_b == expected
            d = L.log.describe_topic(topic)
            return fired(plan), fired(cplan), d["groups"], got_a

        log, clog, groups, _ = run_both(scenario, tmp_path)
        assert log == [("log.txn.commit", "raise")]
        assert clog == [("log.group.commit", "raise")]
        assert groups["grp-a"] == groups["grp-b"]
        assert sum(groups["grp-a"].values()) == len(expected)


class TestPrefetchChaos:
    def test_prefetch_read_crash_recovers_exactly_once(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "topic")
            produce(L, root, topic, "prefetch")

            def consume_recovering(tag, plan=None):
                out = str(root / f"out-{tag}")

                def build_env(conf):
                    env = L.Env(conf)
                    env.from_source(L.log.LogSource(
                        topic, ts_field="ts_ms", prefetch_segments=2,
                        batch_records=96)).add_sink(
                        L.sinks.FileTransactionalSink(out))
                    return env

                conf = recovering_conf(L, root / f"ckpt-{tag}")
                if plan is None:
                    L.recover(build_env, conf, f"prefetch-{tag}")
                else:
                    with plan.activate():
                        L.recover(build_env, conf, f"prefetch-{tag}")
                return sorted((int(r["word"]), int(r["ts_ms"])) for r in
                              L.sinks.FileTransactionalSink.committed_rows(
                                  out))

            golden = consume_recovering("golden")
            assert len(golden) == N_BATCHES * BATCH
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "log.prefetch.read", "raise", count=1, after=2)
            got = consume_recovering("chaos", plan)
            assert got == golden
            return fired(plan), got

        assert run_both(scenario, tmp_path)[0] == [
            ("log.prefetch.read", "raise")]


class TestObjstoreCasChaos:
    @staticmethod
    def objstore_topic(L, kv_golden, root):
        back = str(root / "objstore-backing")
        shutil.copytree(kv_golden[L.name]["dir"], os.path.join(back, "topic"))
        L.fso.install(inner_prefix=back + "/")
        return "objstore://topic"

    @staticmethod
    def on_objstore(scenario, kv_golden):
        def wrapped(L, root):
            topic = TestObjstoreCasChaos.objstore_topic(L, kv_golden, root)
            try:
                return scenario(L, root, topic)
            finally:
                L.fso.install(inner_prefix="")
        return wrapped

    def test_cas_conflict_mid_lease_takeover(self, tmp_path, kv_golden):
        def scenario(L, root, topic):
            full = kv_golden[L.name]["full"]
            a = L.bus.LeaseManager(topic, "prod-a", [0, 1], ttl_ms=1)
            epochs_a = a.acquire()
            b = L.bus.LeaseManager(topic, "prod-b", [0, 1], ttl_ms=30_000,
                                   now_fn=lambda: FAR)
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "fs.cas.put", "raise", count=1)
            with plan.activate():
                err = raised(b.acquire, L.bus.LeaseError)
            assert read_everything(L, topic) == full
            held = L.log.list_leases(topic)
            epochs_b = b.acquire()
            assert all(epochs_b[p] > epochs_a[p] for p in (0, 1))
            assert read_everything(L, topic) == full
            b.release()
            return epochs_a, err, fired(plan), held, epochs_b

        obs = run_both(self.on_objstore(scenario, kv_golden), tmp_path)
        assert obs[2] == [("fs.cas.put", "raise")]
        assert obs[4] == {0: 2, 1: 2}

    def test_cleaner_crash_between_rewrite_and_swap(self, tmp_path,
                                                    kv_golden):
        def scenario(L, root, topic):
            cleaner = L.log.LogCleaner(
                topic, L.Conf({"log.compaction.min-segments": 1}),
                owner="svc")
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "log.compact.swap", "raise", count=1)
            with plan.activate():
                err = raised(cleaner.run_pass, OSError, "injected fault")
            assert L.topic.TopicReader(topic).generation == 0
            assert read_everything(L, topic) == kv_golden[L.name]["full"]
            assert L.log.cleaner_status(topic) is None
            res = cleaner.run_pass()
            assert latest_table(L, topic) == kv_golden[L.name]["latest"]
            cleaner.stop()
            return err, fired(plan), res, topic_view(L, topic)

        _, log, res, _ = run_both(self.on_objstore(scenario, kv_golden),
                                  tmp_path)
        assert ("log.compact.swap", "raise") in log
        assert res["compacted"]["gen"] == 1 and res["passes"] == 1

    def test_cleaner_pass_point_kills_before_mutation(self, tmp_path,
                                                      kv_golden):
        def scenario(L, root, topic):
            cleaner = L.log.LogCleaner(topic, L.Conf({}), owner="svc")
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "log.cleaner.pass", "raise", count=1)
            with plan.activate():
                err = raised(cleaner.run_pass, OSError, "injected fault")
            assert L.topic.TopicReader(topic).generation == 0
            assert read_everything(L, topic) == kv_golden[L.name]["full"]
            cleaner.stop()
            return err, fired(plan), topic_view(L, topic)

        assert run_both(self.on_objstore(scenario, kv_golden),
                        tmp_path)[1] == [("log.cleaner.pass", "raise")]

    def test_rebalance_crash_leaves_membership_whole(self, tmp_path,
                                                     kv_golden):
        def scenario(L, root):
            topic = _copy_topic(kv_golden, L, root)
            cg = L.bus.ConsumerGroups
            cg.join(topic, "g", "m1")
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "log.group.rebalance", "raise", count=1)
            with plan.activate():
                err = raised(lambda: cg.join(topic, "g", "m2"), OSError,
                             "injected fault")
            mid = cg.read_membership(topic, "g")
            return (err, fired(plan), mid, cg.join(topic, "g", "m2"),
                    cg.read_membership(topic, "g"))

        _, log, mid, joined, after = run_both(scenario, tmp_path)
        assert mid == {"generation": 1, "members": ["m1"]}
        assert (joined[0], joined[2]) == (2, 2)
        assert after == {"generation": 2, "members": ["m1", "m2"]}

    def test_fence_crash_leaves_offsets_whole(self, tmp_path, kv_golden):
        def scenario(L, root):
            topic = _copy_topic(kv_golden, L, root)
            cg = L.bus.ConsumerGroups
            cg.join(topic, "g", "m1")
            plan = L.faults.FaultPlan(seed=CHAOS_SEED).rule(
                "log.group.fence", "raise", count=1)
            with plan.activate():
                err = raised(lambda: cg.commit(topic, "g", {0: 5, 1: 7},
                                               generation=1),
                             OSError, "injected fault")
            mid = cg.committed(topic, "g")
            cg.commit(topic, "g", {0: 5, 1: 7}, generation=1)
            return err, fired(plan), mid, cg.committed(topic, "g")

        _, log, mid, after = run_both(scenario, tmp_path)
        assert ("log.group.fence", "raise") in log
        assert mid == {} and after == {0: 5, 1: 7}


@pytest.mark.slow
class TestLogChaosSoak:
    @pytest.mark.parametrize("seed", [11, 12, 13])
    def test_randomized_log_soak(self, tmp_path, seed, golden_chain):
        def scenario(L, root):
            topic = str(root / "topic")
            plan = (L.faults.FaultPlan(seed=seed)
                    .rule("log.segment.append", "raise", p=0.05, count=2)
                    .rule("log.segment.fsync", "raise", p=0.05, count=1)
                    .rule("log.segment.seal", "raise", p=0.05, count=1)
                    .rule("log.txn.marker", "raise", p=0.1, count=1)
                    .rule("log.txn.commit", "raise", p=0.1, count=2))

            def build_env(conf):
                env = L.Env(conf)
                env.from_source(
                    L.GeneratorSource(word_gen(N_BATCHES))).add_sink(
                    L.log.LogSink(topic, key_field="word", partitions=2))
                return env

            with plan.activate():
                L.recover(build_env, recovering_conf(
                    L, root / "ckpt", 40), f"log-soak-{seed}")
            return consume(L, topic)

        assert run_both(scenario, tmp_path) == golden_chain
