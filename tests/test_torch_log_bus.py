"""The port's message-bus tier (``flink_tpu_torch/log/bus.py``) against
the JAX package's, on the CPU: each case of ``tests/test_log_bus.py``
runs the same calls on both packages — key compaction with its offset
preservation and safety floor, the maintenance lock, time and size
retention, fenced writer leases, consumer groups across generations,
and the backfill-then-live shape — and compares committed rows in
order within each partition, offsets, generations, lease epochs, group
floors and the ``describe_topic`` fields that carry no time or id.

A lease that the reference lets expire by sleeping past a 1 ms ttl
expires here by the successor's clock (``LeaseManager(now_fn=...)``, or
the sink's lease's), so no case waits on the wall clock."""
import os

import numpy as np

from test_torch_log_pkgs import raised, run_both, topic_view
from test_torch_threads import capped_torch_threads  # noqa: F401

PARTS = 2
KEYS = 5
FAR = 10 ** 18  # a clock past every deadline


def fill_topic(L, topic, txns=4, rows=10, segment_records=8):
    ap = L.topic.TopicAppender(topic, PARTS, segment_records=segment_records,
                               key_field="k")
    for cid in range(1, txns + 1):
        batch = {}
        for p in range(PARTS):
            seq = (cid - 1) * rows + np.arange(rows, dtype=np.int64)
            batch[p] = [{"k": seq % KEYS + p * 100, "v": seq,
                         "ts": seq * 10}]
        assert ap.stage(cid, batch)
        ap.commit(cid)
    return ap


def full_rows(L, topic, p, start=0):
    out = []
    for _off, _nxt, b in L.topic.TopicReader(topic).read3(p, start):
        for i in range(len(b["k"])):
            out.append((int(b["k"][i]), int(b["v"][i]), int(b["ts"][i])))
    return out


def latest_per_key(rows):
    d = {}
    for k, v, ts in rows:
        d[k] = (v, ts)
    return dict(sorted(d.items()))


def kvt(n, lo=0):
    seq = lo + np.arange(n, dtype=np.int64)
    return {"k": seq, "v": seq, "ts": seq}


class TestCompaction:
    def test_latest_per_key_offsets_and_end_preserved(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            golden = {p: latest_per_key(full_rows(L, topic, p))
                      for p in range(PARTS)}
            end = L.topic.TopicReader(topic).committed_offsets()
            L.bus.ConsumerGroups.commit(topic, "g", dict(end))
            res = L.bus.Compactor(topic).compact()
            assert L.topic.TopicReader(topic).committed_offsets() == end
            for p in range(PARTS):
                assert latest_per_key(full_rows(L, topic, p)) == golden[p]
                assert res["partitions"][p]["rows_out"] == KEYS
            return res, topic_view(L, topic)

        res, view = run_both(scenario, tmp_path)
        assert res["gen"] == 1 and view["gen"] == 1

    def test_key_field_from_topic_meta(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            key = L.log.topic_key_field(topic)
            L.bus.ConsumerGroups.commit(topic, "g", dict(
                L.topic.TopicReader(topic).committed_offsets()))
            return key, L.bus.Compactor(topic).compact()

        key, res = run_both(scenario, tmp_path)
        assert key == "k" and res["gen"] == 1

    def test_group_floor_bounds_compaction(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            before = {p: full_rows(L, topic, p) for p in range(PARTS)}
            L.bus.ConsumerGroups.commit(topic, "slow", {0: 16, 1: 16})
            L.bus.ConsumerGroups.commit(topic, "fast", dict(
                L.topic.TopicReader(topic).committed_offsets()))
            res = L.bus.Compactor(topic, min_segments=1).compact()
            for p in range(PARTS):
                assert res["partitions"][p]["floor"] == 10
                assert full_rows(L, topic, p, 16) == before[p][16:]
                assert full_rows(L, topic, p, 10) == before[p][10:]
            return res, topic_view(L, topic)

        run_both(scenario, tmp_path)

    def test_staged_txn_bounds_compaction(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            ap = fill_topic(L, topic)
            staged_base = ap.next_offset(0)
            assert ap.stage(99, {0: [kvt(4)]})
            L.bus.ConsumerGroups.commit(topic, "g",
                                        {0: staged_base + 4, 1: 40})
            res = L.bus.Compactor(topic, min_segments=1).compact()
            assert res["partitions"][0]["floor"] == staged_base
            return res, topic_view(L, topic)

        run_both(scenario, tmp_path)

    def test_no_groups_compacts_to_committed_end(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            end = L.topic.TopicReader(topic).committed_offsets()
            res = L.bus.Compactor(topic).compact()
            assert {p: e["floor"] for p, e in
                    res["partitions"].items()} == end
            return res, topic_view(L, topic)

        run_both(scenario, tmp_path)

    def test_second_generation_supersedes(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            ap = fill_topic(L, topic)
            L.bus.Compactor(topic).compact()
            for cid in (10, 11):
                seq = cid * 100 + np.arange(10, dtype=np.int64)
                assert ap.stage(cid, {p: [{"k": seq % KEYS + p * 100,
                                           "v": seq, "ts": seq}]
                                      for p in range(PARTS)})
                ap.commit(cid)
            golden = {p: latest_per_key(full_rows(L, topic, p))
                      for p in range(PARTS)}
            res = L.bus.Compactor(topic, min_segments=1).compact()
            for p in range(PARTS):
                rows = full_rows(L, topic, p)
                assert latest_per_key(rows) == golden[p]
                assert rows == sorted(rows) and len(rows) == KEYS
            return res, topic_view(L, topic)

        res, _ = run_both(scenario, tmp_path)
        assert res["gen"] == 2

    def test_reused_committed_cid_refused_loudly(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            ap2 = L.topic.TopicAppender(topic, PARTS, segment_records=8)
            seq = np.arange(4, dtype=np.int64)
            err = raised(lambda: ap2.stage(1, {0: [{"k": seq, "v": seq,
                                                    "ts": seq}]}),
                         L.log.LogError, "reused checkpoint id")
            assert ap2.stage(10 ** 12, {0: [{"k": seq % KEYS, "v": seq,
                                             "ts": seq}]})
            ap2.commit(10 ** 12)
            return err, topic_view(L, topic)

        _, view = run_both(scenario, tmp_path)
        assert view["committed"][0] == 44

    def test_appender_continues_after_compaction(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            end = dict(L.topic.TopicReader(topic).committed_offsets())
            L.bus.Compactor(topic).compact()
            ap2 = L.topic.TopicAppender(topic, PARTS, segment_records=8)
            assert {p: ap2.next_offset(p) for p in range(PARTS)} == end
            seq = np.arange(6, dtype=np.int64)
            assert ap2.stage(50, {0: [{"k": seq % KEYS, "v": seq + 999,
                                       "ts": seq}]})
            ap2.commit(50)
            return end, topic_view(L, topic)

        end, view = run_both(scenario, tmp_path)
        assert view["committed"][0] == end[0] + 6


class TestMaintenanceLock:
    def test_concurrent_pass_refused(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            fd = L.topic.try_maintenance_lock(topic)
            assert fd is not None
            try:
                errs = [raised(lambda: L.bus.Compactor(topic).compact(),
                               L.log.LogError, "another maintenance pass"),
                        raised(lambda: L.bus.Retention(
                            topic, retention_ms=1, ts_field="ts",
                            now_fn=lambda: 10 ** 12).apply(),
                            L.log.LogError, "another maintenance pass")]
            finally:
                L.topic.release_maintenance_lock(topic, fd)
            return errs, L.bus.Compactor(topic).compact()["gen"]

        assert run_both(scenario, tmp_path)[1] == 1

    def test_sweep_keeps_cmp_files_while_pass_runs(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            ap = fill_topic(L, topic)
            debris = os.path.join(L.topic._partition_dir(topic, 0),
                                  "cmp-000001-000000000000.colb")
            with open(debris, "wb") as f:
                f.write(b"pre-swap output of a live pass")
            fd = L.topic.try_maintenance_lock(topic)
            try:
                ap.sweep_orphans()
                kept = os.path.exists(debris)
            finally:
                L.topic.release_maintenance_lock(topic, fd)
            removed = ap.sweep_orphans()
            return kept, removed, os.path.exists(debris)

        assert run_both(scenario, tmp_path) == (True, 1, False)


class TestRetention:
    def test_time_retention_below_group_floor_only(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            before = {p: full_rows(L, topic, p) for p in range(PARTS)}
            L.bus.ConsumerGroups.commit(topic, "g", {0: 16, 1: 16})
            res = L.bus.Retention(topic, retention_ms=1, ts_field="ts",
                                  now_fn=lambda: 10 ** 12).apply()
            for p in range(PARTS):
                assert full_rows(L, topic, p, 16) == before[p][16:]
                assert full_rows(L, topic, p) == before[p][10:]
            return res, topic_view(L, topic)

        res, view = run_both(scenario, tmp_path)
        assert res["start"] == {0: 10, 1: 10}
        assert view["starts"] == {0: 10, 1: 10}

    def test_size_retention_respects_budget(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic, txns=6)
            res = L.bus.Retention(topic, retention_bytes=1500).apply()
            return res, topic_view(L, topic)

        res, view = run_both(scenario, tmp_path)
        assert res["dropped"]
        assert view["committed"] == {p: 60 for p in range(PARTS)}

    def test_replay_position_below_floor_is_loud(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            L.bus.Retention(topic, retention_ms=1, ts_field="ts",
                            now_fn=lambda: 10 ** 12).apply()
            r = L.topic.TopicReader(topic)
            obs = [r.start_offsets()[0], list(r.read3(0, 0)),
                   raised(lambda: list(r.read3(0, 16)), L.log.LogError,
                          "below the retention floor")]
            src = L.log.LogSource(topic, ts_field="ts")
            obs.append(raised(lambda: list(src.open_split("0", 16)),
                              L.log.LogError, "below the retention floor"))
            return obs

        obs = run_both(scenario, tmp_path)
        assert obs[:2] == [40, []]

    def test_young_segments_survive(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            res = L.bus.Retention(topic, retention_ms=10 ** 15,
                                  ts_field="ts").apply()
            return res, topic_view(L, topic)

        res, view = run_both(scenario, tmp_path)
        assert res["dropped"] == {} and view["gen"] == 0

    def test_retention_of_compacted_segments(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            L.bus.Compactor(topic).compact()
            res = L.bus.Retention(topic, retention_ms=1, ts_field="ts",
                                  now_fn=lambda: 10 ** 12).apply()
            for p in range(PARTS):
                assert full_rows(L, topic, p) == []
            return res, topic_view(L, topic)

        res, view = run_both(scenario, tmp_path)
        assert res["gen"] == 2
        assert view["committed"] == {p: 40 for p in range(PARTS)}


def leased_sink(L, topic, owner, ttl_ms, clock=None):
    sink = L.log.LogSink(topic, key_field="k", partitions=2,
                         owned_partitions=[0], producer_id=owner,
                         lease_ttl_ms=ttl_ms)
    if clock is not None:
        sink._lease._now = clock
    return sink


class TestLeases:
    def test_acquire_renew_release_epochs(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            a = L.bus.LeaseManager(topic, "a", [0, 1], ttl_ms=60_000)
            obs = [a.acquire()]
            a.verify()
            a2 = L.bus.LeaseManager(topic, "a", [0, 1], ttl_ms=60_000)
            obs.append(a2.acquire())
            a2.release()
            obs.append(L.bus.LeaseManager(topic, "b", [0],
                                          ttl_ms=60_000).acquire())
            return obs, topic_view(L, topic)

        obs, _ = run_both(scenario, tmp_path)
        assert obs == [{0: 1, 1: 1}, {0: 1, 1: 1}, {0: 2}]

    def test_failed_acquire_rolls_back_partial_hold(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            L.bus.LeaseManager(topic, "a", [1], ttl_ms=60_000).acquire()
            err = raised(lambda: L.bus.LeaseManager(
                topic, "b", [0, 1], ttl_ms=60_000).acquire(),
                L.bus.LeaseError, "leased by 'a'")
            c = L.bus.LeaseManager(topic, "c", [0], ttl_ms=60_000)
            return err, c.acquire(), L.log.list_leases(topic)

        _, epochs, _ = run_both(scenario, tmp_path)
        assert epochs == {0: 2}

    def test_empty_owned_set_refused_at_construction(self, tmp_path):
        def scenario(L, root):
            return raised(lambda: L.log.LogSink(
                str(root / "t"), key_field="k", partitions=2,
                owned_partitions=[], producer_id="w"),
                L.log.LogError, "non-empty")

        run_both(scenario, tmp_path)

    def test_held_lease_rejects_second_owner(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            L.bus.LeaseManager(topic, "a", [0], ttl_ms=60_000).acquire()
            return raised(lambda: L.bus.LeaseManager(
                topic, "b", [0], ttl_ms=60_000).acquire(),
                L.bus.LeaseError, "leased by 'a'")

        run_both(scenario, tmp_path)

    def test_expired_takeover_deposes_by_epoch(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            a = L.bus.LeaseManager(topic, "a", [0], ttl_ms=60_000)
            a.acquire()
            b = L.bus.LeaseManager(topic, "b", [0], ttl_ms=60_000,
                                   now_fn=lambda: FAR)
            return b.acquire(), raised(a.verify, L.bus.LeaseError,
                                       "DEPOSED")

        epochs, _ = run_both(scenario, tmp_path)
        assert epochs == {0: 2}

    def test_deposed_writer_stage_rejected(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink_a = leased_sink(L, topic, "a", 1)
            sink_a.write(kvt(8))
            sink_b = leased_sink(L, topic, "b", 60_000, clock=lambda: FAR)
            sink_b.write(kvt(4))
            err = raised(lambda: sink_a.prepare_commit(1),
                         L.bus.LeaseError, "DEPOSED")
            sink_b.prepare_commit(1)
            sink_b.notify_checkpoint_complete(1)
            return err, topic_view(L, topic)

        _, view = run_both(scenario, tmp_path)
        assert view["committed"][0] == 4

    def test_legacy_recover_rolls_back_foreign_staged(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = leased_sink(L, topic, "dead", 1)
            sink.write(kvt(8))
            sink.prepare_commit(1)
            legacy = L.log.LogSink(topic, key_field="k", partitions=2)
            obs = [L.log.describe_topic(topic)["writer_transactions"],
                   legacy._appender.next_offset(0)]
            legacy.write(kvt(4))
            legacy.prepare_commit(1)
            legacy.notify_checkpoint_complete(1)
            assert sum(len(full_rows(L, topic, p))
                       for p in range(PARTS)) == 4
            return obs, topic_view(L, topic)

        obs, _ = run_both(scenario, tmp_path)
        assert obs[0]["staged"] == {} and obs[1] == 0

    def test_renew_skips_fresh_deadlines(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            now = [1000]
            lm = L.bus.LeaseManager(topic, "a", [0], ttl_ms=10_000,
                                    now_fn=lambda: now[0])
            lm.acquire()
            seen = [lm._read(0)["deadline_ms"]]
            now[0] += 1000
            lm.verify()
            seen.append(lm._read(0)["deadline_ms"])
            now[0] += 5000
            lm.verify()
            seen.append(lm._read(0)["deadline_ms"])
            return seen

        assert run_both(scenario, tmp_path) == [11_000, 11_000, 17_000]

    def test_takeover_aborts_deposed_staged_txn(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink_a = leased_sink(L, topic, "a", 1)
            sink_a.write(kvt(8))
            sink_a.prepare_commit(1)
            sink_b = leased_sink(L, topic, "b", 60_000, clock=lambda: FAR)
            sink_b.write(kvt(2))
            return (L.log.describe_topic(topic)["writer_transactions"],
                    sink_b._appender.next_offset(0), topic_view(L, topic))

        txns, nxt, _ = run_both(scenario, tmp_path)
        assert txns["staged"] == {} and nxt == 0


def consume_rows(L, topic, tag, group="g", **src_kw):
    sink = L.sinks.TransactionalCollectSink()
    env = L.Env(L.Conf({"pipeline.microbatch-size": 8}))
    env.from_source(L.log.LogSource(topic, ts_field="ts", group=group,
                                    **src_kw)).add_sink(sink)
    L.execute(env, tag)
    return [(int(r["k"]), int(r["v"])) for r in sink.committed]


class TestConsumerGroups:
    def test_invalid_group_name_refused_at_construction(self, tmp_path):
        def scenario(L, root):
            return raised(lambda: L.log.LogSource(str(root / "t"),
                                                  group="dash/boards"),
                          L.log.LogError, "consumer-group name")

        run_both(scenario, tmp_path)

    def test_static_assignment_disjoint(self, tmp_path):
        def scenario(L, root):
            cg = L.bus.ConsumerGroups
            return (cg.assignment(4, 0, 2), cg.assignment(4, 1, 2),
                    raised(lambda: cg.assignment(4, 2, 2), Exception))

        assert run_both(scenario, tmp_path)[:2] == ([0, 2], [1, 3])

    def test_commit_max_merges_never_regresses(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            L.bus.ConsumerGroups.commit(topic, "g", {0: 30})
            L.bus.ConsumerGroups.commit(topic, "g", {0: 10})
            return L.bus.ConsumerGroups.committed(topic, "g")

        assert run_both(scenario, tmp_path) == {0: 30}

    def test_two_members_split_partitions_and_commit(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic)
            rows = {}
            for member in range(2):
                src_splits = L.log.LogSource(
                    topic, group="g", member_index=member,
                    members=2).splits()
                assert src_splits == [str(member)]
                rows[member] = consume_rows(L, topic, f"member-{member}",
                                            member_index=member, members=2)
            return rows, topic_view(L, topic)

        rows, view = run_both(scenario, tmp_path)
        assert len(rows[0]) == 40 and len(rows[1]) == 40
        assert {k for k, _ in rows[0]}.isdisjoint(k for k, _ in rows[1])
        assert view["describe"]["groups"] == {"g": {"0": 40, "1": 40}}

    def test_generation_resume_reads_exactly_once(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            ap = fill_topic(L, topic)
            first = consume_rows(L, topic, "gen1")
            second = consume_rows(L, topic, "gen2")
            seq = 777 + np.arange(6, dtype=np.int64)
            assert ap.stage(9, {0: [{"k": seq % KEYS, "v": seq, "ts": seq}]})
            ap.commit(9)
            third = consume_rows(L, topic, "gen3")
            return first, second, third, topic_view(L, topic)

        first, second, third, _ = run_both(scenario, tmp_path)
        assert len(first) == 80 and second == []
        assert sorted(v for _, v in third) == list(range(777, 783))


class TestBackfillThenLive:
    def test_bootstrap_from_compacted_history_then_live_tail(
            self, tmp_path):
        def scenario(L, root):
            topic, ref_topic = str(root / "t"), str(root / "ref")
            ap = fill_topic(L, topic)
            fill_topic(L, ref_topic)
            L.bus.Compactor(topic).compact()
            backfill = consume_rows(L, topic, "backfill-job", group="job")
            for ap_ in (ap, L.topic.TopicAppender(ref_topic, PARTS,
                                                  segment_records=8)):
                seq = 900 + np.arange(8, dtype=np.int64)
                assert ap_.stage(77, {p: [{"k": seq % KEYS + p * 100,
                                           "v": seq, "ts": seq}]
                                      for p in range(PARTS)})
                ap_.commit(77)
            live = consume_rows(L, topic, "live-job", group="job")
            reference = consume_rows(L, ref_topic, "ref", group="ref")
            table, got = {}, {}
            for k, v in reference:
                table[k] = max(table.get(k, -1), v)
            for k, v in backfill + live:
                got[k] = max(got.get(k, -1), v)
            assert got == table
            return backfill, live, topic_view(L, topic)

        backfill, live, _ = run_both(scenario, tmp_path)
        assert len(backfill) == PARTS * KEYS and len(live) == PARTS * 8

    def test_driver_restore_mid_compacted_read(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            fill_topic(L, topic, txns=8, rows=10)
            L.bus.ConsumerGroups.commit(topic, "pin", dict(
                L.topic.TopicReader(topic).committed_offsets()))
            golden = {p: full_rows(L, topic, p) for p in range(PARTS)}
            L.bus.Compactor(topic).compact()
            src = L.log.LogSource(topic, ts_field="ts")
            out = {}
            for p in ("0", "1"):
                it = src.open_split(p)
                data, ts = next(it)
                it.close()  # its readahead thread ends here
                pos = src.position_after(0, data, ts)
                whole = list(zip(data["k"].tolist(), data["v"].tolist()))
                for data2, _ in src.open_split(p, pos):
                    whole.extend(zip(data2["k"].tolist(),
                                     data2["v"].tolist()))
                assert whole == [(k, v) for k, v, _ in
                                 full_rows(L, topic, int(p))]
                assert dict(whole) == {k: v for k, (v, _) in latest_per_key(
                    golden[int(p)]).items()}
                out[p] = (pos, whole)
            return out

        run_both(scenario, tmp_path)
