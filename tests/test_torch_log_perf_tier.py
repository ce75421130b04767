"""The port's fast log paths against the JAX package's, on the CPU:
each case of ``tests/test_log_perf_tier.py`` runs on both packages —
the group fsync pass (it ends before the pre-commit marker, fires once
a segment, writes what the per-segment mode writes), partition writes
through the host pool (the serial path's files, byte for byte), the
zero-copy reader (the copying reader's rows, views not copies, every
corruption loud), read coalescing (replay positions exact) and the
readahead thread (the same rows with it or without it, and ``close()``
ends it) — and compares rows with their dtypes, offsets, positions and
the faults that fired."""
import os
import time

import numpy as np
import pytest

from test_torch_log_pkgs import cols, raised, run_both
from test_torch_threads import capped_torch_threads  # noqa: F401


def _batch(rng, n, base=0):
    return {
        "k": (base + rng.integers(0, 50, n)).astype(np.int64),
        "seq": np.arange(base, base + n, dtype=np.int64),
        "v": rng.random(n).astype(np.float64),
        "tag": np.array([f"t{int(x)}" for x in rng.integers(0, 9, n)],
                        dtype=object),
    }


def _read_all(L, path, zero_copy):
    r = L.topic.TopicReader(path, zero_copy=zero_copy)
    return {p: [(off, cols(b)) for off, b in r.read(p)]
            for p in range(r.partitions)}


def fired(plan):
    return [tuple(x[:2]) for x in plan.log]


class TestGroupFsync:
    def test_fsync_fault_leaves_no_pre_marker(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            ap = L.topic.TopicAppender(topic, 2, fsync_mode="group")
            rng = np.random.default_rng(0)
            plan = L.faults.FaultPlan(seed=1).rule(
                "log.segment.fsync", "raise", count=1, after=0)
            with plan.activate():
                err = raised(lambda: ap.stage(1, {
                    0: [_batch(rng, 16)], 1: [_batch(rng, 16, base=100)]}),
                    OSError)
            pres = L.topic._list_markers(L.fs.get_filesystem(topic), topic,
                                         "pre")
            ap.recover()
            assert ap.stage(1, {0: [_batch(rng, 16)]})
            ap.commit(1)
            return err, fired(plan), pres, _read_all(L, topic, False)

        _, log, pres, _ = run_both(scenario, tmp_path)
        assert log == [("log.segment.fsync", "raise")] and pres == {}

    def test_group_fsync_fires_once_per_segment(self, tmp_path):
        def scenario(L, root):
            rng = np.random.default_rng(1)
            pending = {0: [_batch(rng, 40)], 1: [_batch(rng, 40, 100)]}
            counts = {}
            for mode in ("group", "segment"):
                ap = L.topic.TopicAppender(str(root / mode), 2,
                                           segment_records=16,
                                           fsync_mode=mode)
                plan = L.faults.FaultPlan(seed=2).rule(
                    "log.segment.fsync", "delay", delay_ms=0.0, after=0)
                with plan.activate():
                    assert ap.stage(1, pending)
                counts[mode] = len(plan.log)
            return counts

        counts = run_both(scenario, tmp_path)
        assert counts["group"] == counts["segment"] > 0

    def test_modes_produce_identical_bytes(self, tmp_path):
        def scenario(L, root):
            rng = np.random.default_rng(2)
            pending = {0: [_batch(rng, 33)], 1: [_batch(rng, 21, 500)]}
            reads = {}
            for mode in ("group", "segment"):
                topic = str(root / mode)
                ap = L.topic.TopicAppender(topic, 2, segment_records=16,
                                           fsync_mode=mode)
                assert ap.stage(1, pending)
                ap.commit(1)
                reads[mode] = _read_all(L, topic, zero_copy=False)
            assert reads["group"] == reads["segment"]
            return reads["group"]

        run_both(scenario, tmp_path)

    def test_bad_mode_rejected(self, tmp_path):
        def scenario(L, root):
            return raised(lambda: L.topic.TopicAppender(
                str(root / "t"), 1, fsync_mode="bogus"),
                L.log.LogError, "fsync-mode")

        run_both(scenario, tmp_path)


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


class TestParallelPartitionIO:
    def test_pool_stage_matches_serial(self, tmp_path):
        def scenario(L, root):
            rng = np.random.default_rng(3)
            pending = {p: [_batch(rng, 50, base=1000 * p)] for p in range(4)}
            pool = L.HostPool(4)
            try:
                ap_par = L.topic.TopicAppender(str(root / "par"), 4,
                                               segment_records=16,
                                               host_pool=pool)
                assert ap_par.stage(1, pending)
                ap_par.commit(1)
            finally:
                pool.close()
            ap_ser = L.topic.TopicAppender(str(root / "ser"), 4,
                                           segment_records=16)
            assert ap_ser.stage(1, pending)
            ap_ser.commit(1)
            par = _read_all(L, str(root / "par"), zero_copy=False)
            assert par == _read_all(L, str(root / "ser"), zero_copy=False)
            segs = {}
            for p in range(4):
                segs[p] = _files(root / "par" / f"p{p}")
                assert segs[p] == _files(root / "ser" / f"p{p}")
            return par, segs

        run_both(scenario, tmp_path)

    def test_logsink_host_pool_seam(self, tmp_path):
        def scenario(L, root):
            sink = L.log.LogSink(str(root / "t"), key_field="k",
                                 partitions=2)
            pool = L.HostPool(2)
            try:
                sink.set_host_pool(pool)
                assert sink._appender.host_pool is pool
                sink.write(_batch(np.random.default_rng(4), 64))
                assert sink.stage_transaction(1)
                sink.commit_transaction(1)
            finally:
                pool.close()
            return _read_all(L, str(root / "t"), zero_copy=True)

        got = run_both(scenario, tmp_path)
        assert sum(len(rows) for rows in got.values()) == 2


def zc_topic(L, root, compact=False):
    topic = str(root / "t")
    ap = L.topic.TopicAppender(topic, 2, segment_records=16, key_field="k")
    rng = np.random.default_rng(5)
    for cid in (1, 2, 3):
        assert ap.stage(cid, {0: [_batch(rng, 40)],
                              1: [_batch(rng, 24, base=777)]})
        ap.commit(cid)
    if compact:
        assert L.bus.Compactor(topic, min_segments=1).compact()["gen"] == 1
    return topic


class TestZeroCopyReader:
    @pytest.mark.parametrize("compact", [False, True])
    def test_randomized_round_trip_matches_legacy(self, tmp_path, compact):
        def scenario(L, root):
            topic = zc_topic(L, root, compact=compact)
            fast = _read_all(L, topic, True)
            assert fast == _read_all(L, topic, False)
            return fast

        run_both(scenario, tmp_path)

    def test_decode_performs_no_payload_copy(self, tmp_path):
        def scenario(L, root):
            topic = zc_topic(L, root)
            _, batch = next(iter(L.topic.TopicReader(
                topic, zero_copy=True).read(0)))
            views = {name: (batch[name].base is not None,
                            batch[name].flags.writeable)
                     for name in ("k", "seq", "v")}
            _, batch2 = next(iter(L.topic.TopicReader(
                topic, zero_copy=False).read(0)))
            return views, batch2["k"].base is None

        views, copied = run_both(scenario, tmp_path)
        assert all(v == (True, False) for v in views.values()) and copied

    def test_corruption_truncation_footer_loss_still_loud(self, tmp_path):
        def scenario(L, root):
            topic = zc_topic(L, root)
            pdir = root / "t" / "p0"
            seg = sorted(p for p in pdir.iterdir()
                         if p.name.endswith(".colb"))[0]
            golden = seg.read_bytes()

            def read_all():
                return _read_all(L, topic, zero_copy=True)

            errs = []
            seg.write_bytes(golden[:200] + bytes([golden[200] ^ 0xFF])
                            + golden[201:])
            errs.append(raised(read_all, L.columnar.ColumnarError, "CRC"))
            seg.write_bytes(golden[:len(golden) // 2])
            errs.append(raised(read_all, (L.columnar.ColumnarError,
                                          L.log.LogError)))
            seg.write_bytes(golden[:-16])
            errs.append(raised(read_all, L.columnar.ColumnarError))
            seg.write_bytes(golden)
            return errs, read_all()

        run_both(scenario, tmp_path)


def coalesce_topic(L, root, compact=False):
    topic = str(root / "t")
    ap = L.topic.TopicAppender(topic, 1, segment_records=8, key_field="k")
    rng = np.random.default_rng(6)
    for cid in (1, 2):
        assert ap.stage(cid, {0: [_batch(rng, 40)]})
        ap.commit(cid)
    if compact:
        assert L.bus.Compactor(topic, min_segments=1).compact()["gen"] == 1
    return topic


def _drain(src, start=0, stop_after=None):
    """(rows, position, batches), positions advanced per consumed batch
    as the driver advances them."""
    it = src.open_split("0", start)
    rows, pos, batches = [], start, 0
    try:
        for data, ts in it:
            pos = src.position_after(pos, data, ts)
            rows.extend(np.asarray(data["seq"]).tolist())
            batches += 1
            if stop_after is not None and batches >= stop_after:
                break
    finally:
        it.close()
    return rows, pos, batches


class TestCoalescingAndPrefetch:
    @pytest.mark.parametrize("compact", [False, True])
    def test_coalesced_resume_is_position_exact(self, tmp_path, compact):
        def scenario(L, root):
            topic = coalesce_topic(L, root, compact=compact)
            full = _drain(L.log.LogSource(topic, ts_field="seq",
                                          batch_records=0,
                                          prefetch_segments=0))
            head = _drain(L.log.LogSource(topic, ts_field="seq",
                                          batch_records=24,
                                          prefetch_segments=0),
                          stop_after=1)
            assert head[2] == 1 and len(head[0]) >= 24
            tail = _drain(L.log.LogSource(topic, ts_field="seq",
                                          batch_records=24,
                                          prefetch_segments=0),
                          start=head[1])
            assert head[0] + tail[0] == full[0]
            return full, head, tail

        run_both(scenario, tmp_path)

    def test_prefetch_on_off_identical(self, tmp_path):
        def scenario(L, root):
            topic = coalesce_topic(L, root)
            base = _drain(L.log.LogSource(topic, ts_field="seq",
                                          prefetch_segments=0))
            pref = _drain(L.log.LogSource(topic, ts_field="seq",
                                          prefetch_segments=2))
            assert base[:2] == pref[:2]
            return base, pref

        run_both(scenario, tmp_path)

    def test_readahead_close_joins_feeder(self, tmp_path):
        def scenario(L, root):
            topic = coalesce_topic(L, root)
            src = L.log.LogSource(topic, ts_field="seq", prefetch_segments=1)
            it = src.open_split("0", 0)
            next(it)
            feeder = it._readahead._thread
            assert feeder.is_alive() or feeder.ident is not None
            it.close()
            deadline = time.monotonic() + 5.0
            while feeder.is_alive() and time.monotonic() < deadline:
                feeder.join(timeout=0.05)
            return feeder.is_alive()

        assert run_both(scenario, tmp_path) is False

    def test_negative_knobs_rejected(self, tmp_path):
        def scenario(L, root):
            topic = coalesce_topic(L, root)
            return (raised(lambda: L.log.LogSource(topic, batch_records=-1),
                           L.log.LogError, "batch_records"),
                    raised(lambda: L.log.LogSource(topic,
                                                   prefetch_segments=-2),
                           L.log.LogError, "prefetch_segments"))

        run_both(scenario, tmp_path)
