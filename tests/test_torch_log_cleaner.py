"""The port's leased background cleaner (``flink_tpu_torch/log/
cleaner.py``) against the JAX package's, on the CPU: each case of
``tests/test_log_cleaner.py`` runs on both packages — the cleaner
racing a live leased producer (reads above the group floor equal a
never-cleaned topic's, the latest row per key equal below it), the
cleaner lease (one owner, an epoch takeover, a deposed pass refused,
the manual-maintenance gate, ``describe_topic``), the driver-owned
cleaner, and members joining and leaving a consumer group mid-stream
with generation-fenced commits — and compares what each leaves behind.

The race waits for the cleaner's passes by its pass counter, never by
sleeping, and an expired lease expires by the successor's clock
(``now_fn``), so no case depends on how fast the host runs."""
import time

import numpy as np

from test_torch_log_pkgs import raised, run_both, topic_view
from test_torch_threads import capped_torch_threads  # noqa: F401

PARTS = 2
ROWS = 16
KEYS = 6
FAR = 10 ** 18


def _round_batch(r, p=0):
    seq = (r * PARTS + p) * ROWS + np.arange(ROWS, dtype=np.int64)
    return {"k": seq % KEYS + p * 100, "seq": seq, "ts_ms": seq * 10}


def _appender(L, topic, leased):
    lease = None
    if leased:
        lease = L.bus.LeaseManager(topic, "prod", [0, 1], ttl_ms=3_600_000)
        lease.acquire()
    ap = L.topic.TopicAppender(
        topic, PARTS, segment_records=8, key_field="k",
        writer_id="prod" if leased else None,
        owned_partitions=[0, 1] if leased else None, lease=lease)
    return ap, lease


def _produce_rounds(L, topic, rounds, leased=False, start=1, each=None):
    ap, lease = _appender(L, topic, leased)
    for cid in range(start, start + rounds):
        assert ap.stage(cid, {p: [_round_batch(cid, p)]
                              for p in range(PARTS)})
        ap.commit(cid)
        if each is not None:
            each()
    if lease is not None:
        lease.release()


def _read_from(L, topic, offsets):
    r = L.topic.TopicReader(topic)
    out = {}
    for p in range(r.partitions):
        rows = []
        for _off, _nxt, b in r.read3(p, int(offsets.get(p, 0))):
            rows.extend(zip(b["k"].tolist(), b["seq"].tolist()))
        out[p] = rows
    return out


def _latest(L, topic):
    table = {}
    for rows in _read_from(L, topic, {}).values():
        for k, seq in rows:
            if k not in table or seq > table[k]:
                table[k] = seq
    return dict(sorted(table.items()))


def wait_for(cond, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.002)


class TestCleanerRacesLiveProducer:
    ROUNDS = 5

    def test_reads_byte_identical_to_never_cleaned_golden(self, tmp_path):
        def scenario(L, root):
            golden, raced = str(root / "golden"), str(root / "raced")
            cfg = L.Conf({L.LogOptions.CLEANER_INTERVAL_MS.key: 5,
                          L.LogOptions.COMPACTION_MIN_SEGMENTS.key: 1})
            _produce_rounds(L, golden, 2, leased=True)
            _produce_rounds(L, raced, 2, leased=True)
            floor = dict(L.topic.TopicReader(raced).committed_offsets())
            L.bus.ConsumerGroups.commit(golden, "g", dict(floor))
            L.bus.ConsumerGroups.commit(raced, "g", dict(floor))
            _produce_rounds(L, golden, self.ROUNDS, leased=True, start=3)
            cleaner = L.log.LogCleaner(raced, cfg, owner="svc")
            cleaner.start()
            try:
                # after each round, at least one more pass lands
                def one_more_pass():
                    n = cleaner.passes
                    wait_for(lambda: cleaner.passes > n)

                wait_for(lambda: cleaner.passes >= 1)
                _produce_rounds(L, raced, self.ROUNDS, leased=True,
                                start=3, each=one_more_pass)
            finally:
                cleaner.stop()
            assert cleaner.passes >= self.ROUNDS + 1
            above = _read_from(L, raced, floor)
            assert above == _read_from(L, golden, floor)
            assert _latest(L, raced) == _latest(L, golden)
            ends = L.topic.TopicReader(raced).committed_offsets()
            assert ends == L.topic.TopicReader(golden).committed_offsets()
            st = L.log.cleaner_status(raced)
            assert st is not None and st["passes"] == cleaner.passes
            return (above, _latest(L, raced), ends,
                    L.log.live_cleaner_owner(raced),
                    topic_view(L, golden))

        assert run_both(scenario, tmp_path)[3] is None


def _lease_topic(L, root):
    topic = str(root / "t")
    _produce_rounds(L, topic, 2)
    return topic


class TestCleanerLeaseFencing:
    def test_single_owner_per_topic(self, tmp_path):
        def scenario(L, root):
            topic = _lease_topic(L, root)
            a = L.log.LogCleaner(topic, L.Conf({}), owner="svc-a")
            epoch = a.lease.acquire()
            err = raised(lambda: L.log.LogCleaner(
                topic, L.Conf({}), owner="svc-b").lease.acquire(),
                L.log.LogError, "owned by cleaner")
            a.stop()
            return epoch, err, L.cleaner.read_cleaner_lease(topic)

        epoch, _, lease = run_both(scenario, tmp_path)
        assert epoch == 1 and lease["released"]

    def test_expired_lease_takeover_bumps_epoch(self, tmp_path):
        def scenario(L, root):
            topic = _lease_topic(L, root)
            a = L.log.CleanerLease(topic, "svc-a", ttl_ms=1)
            e1 = a.acquire()
            b = L.log.CleanerLease(topic, "svc-b", ttl_ms=60_000,
                                   now_fn=lambda: FAR)
            e2 = b.acquire()
            return e1, e2, raised(a.verify, L.log.LogError, "DEPOSED")

        e1, e2, _ = run_both(scenario, tmp_path)
        assert e2 == e1 + 1

    def test_manual_maintenance_gate(self, tmp_path):
        def scenario(L, root):
            topic = _lease_topic(L, root)
            c = L.log.LogCleaner(topic, L.Conf({}), owner="svc")
            c.lease.acquire()
            err = raised(lambda: L.log.check_manual_maintenance(topic),
                         L.log.LogError, "live cleaner service")
            c.stop()
            L.log.check_manual_maintenance(topic)
            return err

        run_both(scenario, tmp_path)

    def test_describe_topic_surfaces_cleaner(self, tmp_path):
        def scenario(L, root):
            topic = _lease_topic(L, root)
            c = L.log.LogCleaner(topic, L.Conf(
                {L.LogOptions.COMPACTION_MIN_SEGMENTS.key: 1}), owner="svc")
            status = c.run_pass()
            during = L.log.describe_topic(topic)["cleaner"]
            c.stop()
            return (status, during, L.log.describe_topic(topic)["cleaner"],
                    topic_view(L, topic))

        _, during, after, _ = run_both(scenario, tmp_path)
        assert during["live_owner"] == "svc"
        assert during["status"]["passes"] == 1
        assert during["lease"]["epoch"] == 1
        assert after["live_owner"] is None


def _producer_env(L):
    return L.Env(L.Conf({L.LogOptions.CLEANER_ENABLED.key: True,
                         L.LogOptions.CLEANER_INTERVAL_MS.key: 10}))


class TestDriverOwnedCleaner:
    def test_cleaner_runs_and_releases_with_the_job(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")

            def gen(split, i):
                if i >= 6:
                    return None
                if i == 5:
                    # the job's last batch waits for the cleaner's first
                    # pass, so the job cannot end before one ran
                    wait_for(lambda: L.log.cleaner_status(topic) is not None)
                b = _round_batch(i + 1)
                return b, b["ts_ms"]

            env = _producer_env(L)
            env.from_source(L.GeneratorSource(gen)).add_sink(
                L.log.LogSink(topic, key_field="k", partitions=PARTS))
            L.execute(env, "producer-with-cleaner")
            st = L.log.cleaner_status(topic)
            assert st is not None and st["passes"] >= 1
            # how many passes compacted depends on timing: the latest
            # row per key and the committed ends do not
            return (L.log.live_cleaner_owner(topic), _latest(L, topic),
                    L.topic.TopicReader(topic).committed_offsets())

        assert run_both(scenario, tmp_path)[0] is None

    def test_second_driver_degrades_without_cleaner(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            _produce_rounds(L, topic, 1)
            held = L.log.LogCleaner(topic, L.Conf({}), owner="other-svc")
            held.lease.acquire()

            def gen(split, i):
                if i >= 2:
                    return None
                b = _round_batch(i + 10)
                return b, b["ts_ms"]

            env = _producer_env(L)
            env.from_source(L.GeneratorSource(gen)).add_sink(
                L.log.LogSink(topic, key_field="k", partitions=PARTS))
            L.execute(env, "producer-vs-held-lease")
            owner = L.log.live_cleaner_owner(topic)
            held.stop()
            return owner, L.log.cleaner_status(topic), _read_from(L, topic,
                                                                   {})

        owner, status, _ = run_both(scenario, tmp_path)
        assert owner == "other-svc" and status is None


def _consume(L, topic, out_dir, ckpt_dir, member):
    def build_env(conf):
        env = L.Env(conf)
        env.from_source(L.log.LogSource(topic, ts_field="ts_ms", group="g",
                                        member_id=member)
                        ).add_sink(L.sinks.FileTransactionalSink(
                            str(out_dir)))
        return env

    conf = L.Conf({
        "pipeline.microbatch-size": ROWS,
        "execution.checkpointing.dir": str(ckpt_dir),
        "execution.checkpointing.interval": 1,
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 10,
        "restart-strategy.fixed-delay.delay": 1,
    })
    L.recover(build_env, conf, f"member-{member}")
    return sorted((int(r["k"]), int(r["seq"]))
                  for r in L.sinks.FileTransactionalSink.committed_rows(
                      str(out_dir)))


class TestRebalanceMidStreamExactlyOnce:
    def test_join_and_leave_exactly_once(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            cg = L.bus.ConsumerGroups
            _produce_rounds(L, topic, 2)
            rows_a1 = _consume(L, topic, root / "out-a1", root / "ck-a1",
                               "a")
            obs = [cg.read_membership(topic, "g")]
            committed_after_1 = cg.committed(topic, "g")
            obs.append(cg.join(topic, "g", "b"))
            obs.append(raised(lambda: cg.commit(topic, "g", {0: 10 ** 6},
                                                generation=1),
                              L.log.LogError, "DEPOSED generation"))
            assert cg.committed(topic, "g") == committed_after_1
            _produce_rounds(L, topic, 2, start=3)
            rows_a2 = _consume(L, topic, root / "out-a2", root / "ck-a2",
                               "a")
            rows_b2 = _consume(L, topic, root / "out-b2", root / "ck-b2",
                               "b")
            obs.append(cg.read_membership(topic, "g"))
            obs.append(cg.leave(topic, "g", "a"))
            obs.append(raised(lambda: cg.commit(topic, "g", {0: 10 ** 6},
                                                generation=2),
                              L.log.LogError, "DEPOSED generation"))
            _produce_rounds(L, topic, 1, start=5)
            rows_b3 = _consume(L, topic, root / "out-b3", root / "ck-b3",
                               "b")
            golden = sorted((k, seq) for rows in
                            _read_from(L, topic, {}).values()
                            for k, seq in rows)
            got = sorted(rows_a1 + rows_a2 + rows_b2 + rows_b3)
            assert got == golden and len(got) == len(set(got))
            assert (cg.committed(topic, "g")
                    == dict(L.topic.TopicReader(topic).committed_offsets()))
            return obs, [rows_a1, rows_a2, rows_b2, rows_b3], cg.committed(
                topic, "g")

        obs, _, _ = run_both(scenario, tmp_path)
        assert obs[0] == {"generation": 1, "members": ["a"]}
        assert obs[1][0] == 2 and obs[1][2] == 2
        assert obs[3] == {"generation": 2, "members": ["a", "b"]}
        assert obs[4] == 3
