"""``tests/test_ha.py`` against the port: leader election on a shared
directory, the takeover counter, the job store and its recovery by a
replacement coordinator, the runner following a new leader (on the CPU,
``device="cpu"``), and the checkpoint storage's epoch fence, every case
on the port's ``runtime/ha.py``, ``coordinator.py``, ``runner.py`` and
``checkpoint/storage.py``. ``TestAcrossThePackages`` holds the two
packages to one HA dir: a job store record written by either is read by
the other with equal dicts, a lease claimed by either names its leader
to the other, and a ``LeaderElection`` of each contending on one dir
gives at most one holder at a time and strictly rising epochs."""
import time

import pytest

from flink_tpu_torch.config import Configuration
from flink_tpu_torch.runtime.coordinator import start_coordinator
from flink_tpu_torch.runtime.ha import JobStore, LeaderElection, leader_address
from flink_tpu_torch.runtime.rpc import RpcClient, RpcEndpoint, RpcServer


class TestLeaderElection:
    def test_single_winner_and_address(self, tmp_path):
        d = str(tmp_path)
        a = LeaderElection(d, "127.0.0.1:1111", lease_timeout_s=0.5)
        b = LeaderElection(d, "127.0.0.1:2222", lease_timeout_s=0.5)
        try:
            a.start(); b.start()
            deadline = time.time() + 5
            while time.time() < deadline and not (a.is_leader or b.is_leader):
                time.sleep(0.02)
            assert a.is_leader != b.is_leader  # exactly one
            leader = a if a.is_leader else b
            assert leader_address(d) == leader.address
        finally:
            a.close(); b.close()

    def test_takeover_on_stale_lease(self, tmp_path):
        d = str(tmp_path)
        a = LeaderElection(d, "127.0.0.1:1111", lease_timeout_s=0.4)
        try:
            a.start()
            deadline = time.time() + 5
            while time.time() < deadline and not a.is_leader:
                time.sleep(0.02)
            assert a.is_leader
            epoch1 = a.epoch
            # incumbent dies WITHOUT cleanup (thread stops renewing)
            a._closed = True
            a._thread.join(timeout=2)
            b = LeaderElection(d, "127.0.0.1:2222", lease_timeout_s=0.4)
            try:
                b.start()
                deadline = time.time() + 5
                while time.time() < deadline and not b.is_leader:
                    time.sleep(0.02)
                assert b.is_leader
                assert b.epoch > epoch1  # fencing token advanced
                assert leader_address(d) == "127.0.0.1:2222"
            finally:
                b.close()
        finally:
            a.close()

    def test_clean_release_hands_over_fast(self, tmp_path):
        d = str(tmp_path)
        a = LeaderElection(d, "127.0.0.1:1111", lease_timeout_s=5.0)
        a.start()
        deadline = time.time() + 5
        while time.time() < deadline and not a.is_leader:
            time.sleep(0.02)
        a.close()  # removes the lease
        b = LeaderElection(d, "127.0.0.1:2222", lease_timeout_s=5.0)
        try:
            b.start()
            deadline = time.time() + 5
            while time.time() < deadline and not b.is_leader:
                time.sleep(0.02)
            assert b.is_leader  # no need to wait out the 5s timeout
        finally:
            b.close()


class TestRacingContenders:
    """The lease-steal follows the rename-first stale-lock-breaking
    discipline of the log's writer leases — two racing breakers must never unlink each other's FRESH lease,
    and release is inode/identity-checked."""

    def _stale_lease(self, d, epoch=3):
        import json as _json
        import os as _os

        lease = _os.path.join(d, "leader.lease")
        with open(lease, "w") as f:
            _json.dump({"leader_id": "dead", "address": "h:9",
                        "epoch": epoch, "claimed_at": time.time() - 60},
                       f)
        _os.utime(lease, (time.time() - 60, time.time() - 60))
        return lease

    def test_racing_breaker_cannot_unlink_fresh_lease(self, tmp_path):
        """The exact race the old tmp+replace steal lost: contender B
        reads the stale record, contender A completes its steal (fresh
        lease claimed), THEN B's steal fires with the stale record it
        observed. B must neither become leader nor destroy A's fresh
        lease."""
        d = str(tmp_path)
        self._stale_lease(d)
        a = LeaderElection(d, "127.0.0.1:1111", lease_timeout_s=0.3,
                           leader_id="breaker-a")
        b = LeaderElection(d, "127.0.0.1:2222", lease_timeout_s=0.3,
                           leader_id="breaker-b")
        try:
            stale_as_b_saw_it = b._read()
            a._steal_stale(a._read())
            assert a.is_leader and a.epoch == 4
            # B races in with its stale observation
            b._steal_stale(stale_as_b_saw_it)
            assert not b.is_leader
            survivor = a._read()
            assert survivor is not None, (
                "the racing breaker unlinked the fresh lease")
            assert survivor.leader_id == "breaker-a"
            assert leader_address(d) == "127.0.0.1:1111"
        finally:
            a.close()
            b.close()

    def test_concurrent_steals_exactly_one_winner(self, tmp_path):
        """N contenders breaking one stale lease concurrently: exactly
        one wins, the surviving lease is the winner's, and the epoch
        advanced past the stale incumbent's."""
        import threading as _threading

        d = str(tmp_path)
        self._stale_lease(d, epoch=7)
        contenders = [
            LeaderElection(d, f"127.0.0.1:{1000 + i}",
                           lease_timeout_s=0.3, leader_id=f"c{i}")
            for i in range(4)]
        try:
            stale = contenders[0]._read()
            barrier = _threading.Barrier(len(contenders))

            def steal(c):
                barrier.wait()
                c._steal_stale(stale)

            ts = [_threading.Thread(target=steal, args=(c,))
                  for c in contenders]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10)
            winners = [c for c in contenders if c.is_leader]
            assert len(winners) == 1, (
                f"split brain: {[c.leader_id for c in winners]}")
            rec = winners[0]._read()
            assert rec is not None
            assert rec.leader_id == winners[0].leader_id
            assert rec.epoch > 7
        finally:
            for c in contenders:
                c.close()

    def test_release_is_identity_checked(self, tmp_path):
        """close() of a leader whose lease was already stolen must NOT
        unlink the thief's fresh lease (inode-checked release)."""
        d = str(tmp_path)
        a = LeaderElection(d, "127.0.0.1:1111", lease_timeout_s=0.2,
                           leader_id="old")
        a.start()
        deadline = time.time() + 5
        while time.time() < deadline and not a.is_leader:
            time.sleep(0.02)
        assert a.is_leader
        # stop the renewal thread, age the lease, let a thief steal it
        a._closed = True
        a._thread.join(timeout=2)
        import os as _os

        lease = _os.path.join(d, "leader.lease")
        _os.utime(lease, (time.time() - 60, time.time() - 60))
        thief = LeaderElection(d, "127.0.0.1:2222", lease_timeout_s=0.2,
                               leader_id="thief")
        try:
            thief._steal_stale(thief._read())
            assert thief.is_leader
            # the deposed leader exits believing it still leads
            # (is_leader was never flipped): its release must no-op
            a.close()
            rec = thief._read()
            assert rec is not None and rec.leader_id == "thief", (
                "release unlinked the thief's fresh lease")
        finally:
            thief.close()


class TestTakeoverCount:
    """`takeovers` is a durable count of lease STEALS — a clean
    stop/restart advances the fencing epoch but is NOT a takeover
    (epoch-1 arithmetic would false-alarm on every routine
    restart)."""

    def _lead(self, d, addr, timeout=0.3):
        e = LeaderElection(d, addr, lease_timeout_s=timeout)
        e.start()
        deadline = time.time() + 5
        while time.time() < deadline and not e.is_leader:
            time.sleep(0.02)
        assert e.is_leader
        return e

    def test_clean_restart_is_not_a_takeover(self, tmp_path):
        from flink_tpu_torch.runtime.ha import takeover_count

        d = str(tmp_path)
        a = self._lead(d, "127.0.0.1:1111")
        a.close()  # clean handover
        b = self._lead(d, "127.0.0.1:2222")
        try:
            assert b.epoch > 1  # fencing epoch still advanced
            assert takeover_count(d) == 0  # but nothing was stolen
        finally:
            b.close()

    def test_steal_increments_the_counter(self, tmp_path):
        from flink_tpu_torch.runtime.ha import takeover_count

        d = str(tmp_path)
        a = self._lead(d, "127.0.0.1:1111")
        # incumbent dies WITHOUT cleanup
        a._closed = True
        a._thread.join(timeout=2)
        b = self._lead(d, "127.0.0.1:2222", timeout=0.3)
        try:
            assert takeover_count(d) == 1
        finally:
            b.close()
            a.close()


class TestJobStore:
    def test_roundtrip_and_recoverable_filter(self, tmp_path):
        s = JobStore(str(tmp_path))
        s.put("a", entry="m:f", config={"x": 1}, state="RUNNING", attempts=1)
        s.put("b", entry="m:g", config={}, state="FINISHED", attempts=1)
        s.put("c", entry=None, config={}, state="RUNNING", attempts=1)
        assert s.get("a")["config"] == {"x": 1}
        rec = s.recoverable()
        assert [r["job_id"] for r in rec] == ["a"]
        s.remove("a")
        assert s.recoverable() == []


class _FakeRunnerGateway(RpcEndpoint):
    def __init__(self):
        self.deployed = []

    def rpc_run_job(self, job_id, entry, config=None, attempt=1, **kw):
        self.deployed.append((job_id, attempt, dict(config or {})))
        return {"accepted": True}

    def rpc_cancel_job(self, job_id):
        return {"ok": True}


class TestCoordinatorFailover:
    def test_new_coordinator_recovers_and_redeploys(self, tmp_path):
        ha = str(tmp_path)
        conf = Configuration({"high-availability.dir": ha})
        # coordinator A accepts the job, deploys it, then dies
        srv_a = start_coordinator(conf)
        gw = RpcServer(_FakeRunnerGateway())
        try:
            c = RpcClient("127.0.0.1", srv_a.port)
            c.call("register_runner", runner_id="r1", host="127.0.0.1",
                   n_devices=4, port=gw.port)
            c.call("submit_job", job_id="j", entry="mod:build",
                   config={"cluster.mesh-devices": "2"})
            deadline = time.time() + 5
            while time.time() < deadline and not gw.endpoint.deployed:
                time.sleep(0.02)
            assert gw.endpoint.deployed[0][:2] == ("j", 1)
            c.close()
        finally:
            srv_a.close()

        # coordinator B on the same HA dir: recovers the job, and when
        # the runner re-registers, re-deploys with restore:latest
        srv_b = start_coordinator(Configuration({
            "high-availability.dir": ha}))
        try:
            c = RpcClient("127.0.0.1", srv_b.port)
            st = c.call("job_status", job_id="j")
            assert st["state"] == "WAITING_FOR_RESOURCES"
            assert st["attempts"] == 2
            c.call("register_runner", runner_id="r1", host="127.0.0.1",
                   n_devices=4, port=gw.port)
            deadline = time.time() + 5
            while time.time() < deadline and len(gw.endpoint.deployed) < 2:
                time.sleep(0.02)
            job_id, attempt, config = gw.endpoint.deployed[1]
            assert job_id == "j" and attempt == 2
            assert config.get("execution.checkpointing.restore") == "latest"
            # terminal state persists: finishing removes recoverability
            c.call("finish_job", job_id="j")
            assert JobStore(ha).recoverable() == []
            c.close()
        finally:
            srv_b.close()
            gw.close()


class TestRevokeAndFollow:
    def test_revoke_fires_when_lease_stolen(self, tmp_path):
        d = str(tmp_path)
        a = LeaderElection(d, "127.0.0.1:1111", lease_timeout_s=0.4)
        revoked = []
        a.on_revoke = lambda: revoked.append(True)
        try:
            a.start()
            deadline = time.time() + 5
            while time.time() < deadline and not a.is_leader:
                time.sleep(0.02)
            # simulate a contender stealing the lease out from under A
            import json as _json
            import os as _os

            lease = _os.path.join(d, "leader.lease")
            with open(lease + ".x", "w") as f:
                _json.dump({"leader_id": "other", "address": "h:1",
                            "epoch": 9, "claimed_at": time.time()}, f)
            _os.replace(lease + ".x", lease)
            deadline = time.time() + 5
            while time.time() < deadline and not revoked:
                time.sleep(0.02)
            assert revoked and not a.is_leader
        finally:
            a.close()

    def test_runner_follows_new_leader(self, tmp_path):
        """Heartbeat misses against a dead leader make the runner
        re-resolve the lease and register with the new one."""
        import json as _json
        import os as _os

        from flink_tpu_torch.runtime.runner import TaskRunner

        ha = str(tmp_path)
        srv_a = start_coordinator(Configuration({
            "high-availability.dir": ha, "heartbeat.interval": 100}))
        # lease file points at A
        with open(_os.path.join(ha, "leader.lease"), "w") as f:
            _json.dump({"leader_id": "A",
                        "address": f"127.0.0.1:{srv_a.port}",
                        "epoch": 1, "claimed_at": time.time()}, f)
        runner = TaskRunner("127.0.0.1", srv_a.port, runner_id="fr1",
                            ha_dir=ha, device="cpu")
        try:
            runner.start()
            assert "fr1" in RpcClient("127.0.0.1", srv_a.port).call(
                "list_runners")
            # A dies; B takes over with a new lease
            srv_a.close()
            srv_b = start_coordinator(Configuration({
                "high-availability.dir": ha}))
            with open(_os.path.join(ha, "leader.lease"), "w") as f:
                _json.dump({"leader_id": "B",
                            "address": f"127.0.0.1:{srv_b.port}",
                            "epoch": 2, "claimed_at": time.time()}, f)
            try:
                c = RpcClient("127.0.0.1", srv_b.port)
                # follow latency: 2 heartbeat misses x 5s client timeout
                deadline = time.time() + 30
                while time.time() < deadline:
                    if "fr1" in c.call("list_runners"):
                        break
                    time.sleep(0.2)
                assert "fr1" in c.call("list_runners")
                c.close()
            finally:
                srv_b.close()
        finally:
            runner.close()

    def test_terminal_put_archives(self, tmp_path):
        s = JobStore(str(tmp_path))
        s.put("j", entry="m:f", config={}, state="RUNNING", attempts=1)
        assert [r["job_id"] for r in s.recoverable()] == ["j"]
        s.put("j", entry="m:f", config={}, state="FINISHED", attempts=1)
        assert s.recoverable() == []
        assert s.get("j")["state"] == "FINISHED"  # archived, still readable

    def test_epoch_never_regresses_after_clean_handover(self, tmp_path):
        d = str(tmp_path)
        a = LeaderElection(d, "127.0.0.1:1111", lease_timeout_s=0.3)
        a.start()
        deadline = time.time() + 5
        while time.time() < deadline and not a.is_leader:
            time.sleep(0.02)
        e1 = a.epoch
        a.close()  # clean handover (removes lease)
        b = LeaderElection(d, "127.0.0.1:2222", lease_timeout_s=0.3)
        try:
            b.start()
            deadline = time.time() + 5
            while time.time() < deadline and not b.is_leader:
                time.sleep(0.02)
            assert b.epoch > e1  # fencing token monotone across handover
        finally:
            b.close()


class TestStorageWriteFencing:
    """A deposed leader's in-flight checkpoint write must not corrupt
    the store after a new
    leader (higher epoch) has taken over."""

    def test_deposed_writer_fenced_after_successor_writes(self, tmp_path):
        from flink_tpu_torch.checkpoint.storage import (
            FsCheckpointStorage, StaleCheckpointWriter)

        # old leader (epoch 1) completes checkpoint 4, then stalls
        # mid-checkpoint-5 (its writer paused past the lease)
        old = FsCheckpointStorage(str(tmp_path), "job", epoch=1)
        old.save(4, {"who": "old", "n": 4})
        # new leader (epoch 2) takes over and completes 5 and 6
        new = FsCheckpointStorage(str(tmp_path), "job", epoch=2)
        new.save(5, {"who": "new", "n": 5})
        new.save(6, {"who": "new", "n": 6})
        # the old writer resumes and tries to finish ITS checkpoint 5:
        # fenced — and the successor's data is untouched
        with pytest.raises(StaleCheckpointWriter):
            old.save(5, {"who": "old", "n": 5})
        with pytest.raises(StaleCheckpointWriter):
            old.save(7, {"who": "old", "n": 7})  # even a NEWER id
        latest = new.latest()
        assert latest.checkpoint_id == 6
        assert FsCheckpointStorage.load(latest)["who"] == "new"
        assert FsCheckpointStorage.load(
            new.list_complete()[-2])["who"] == "new"

    def test_deposed_v2_writer_fenced(self, tmp_path):
        from flink_tpu_torch.checkpoint import blobformat
        from flink_tpu_torch.checkpoint.storage import (
            FsCheckpointStorage, StaleCheckpointWriter)

        old = FsCheckpointStorage(str(tmp_path), "job", epoch=3)
        new = FsCheckpointStorage(str(tmp_path), "job", epoch=4)
        new.save_v2(1, {"meta": 1, "op_versions": {}},
                    {"0": blobformat.encode({"s": 1})}, {})
        with pytest.raises(StaleCheckpointWriter):
            old.save_v2(2, {"meta": 2, "op_versions": {}},
                        {"0": blobformat.encode({"s": 2})}, {})
        assert new.latest().checkpoint_id == 1

    def test_unfenced_local_storage_unchanged(self, tmp_path):
        from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

        st = FsCheckpointStorage(str(tmp_path), "job")  # epoch 0
        st.save(1, {"n": 1})
        st.save(2, {"n": 2})
        assert st.latest().checkpoint_id == 2


class TestEpochQualifiedFinalNames:
    """The storage.py fence race: _check_fence is check-then-rename —
    a deposed leader whose fence check passed just before the successor's first write landed could still
    delete-and-replace the successor's completed checkpoint of the same
    id. Final names are now epoch-qualified (chk-<id>.e<epoch>) under
    fencing, so the stale rename lands on a DIFFERENT path and the
    successor's directory is physically unclobberable."""

    def test_raced_stale_writer_cannot_clobber_successor(self, tmp_path):
        from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

        old = FsCheckpointStorage(str(tmp_path), "job", epoch=1)
        new = FsCheckpointStorage(str(tmp_path), "job", epoch=2)
        new.save(5, {"who": "new", "n": 5})
        # simulate the race: the old writer's fence check ran BEFORE the
        # successor's manifest landed (so it passed), and its rename
        # fires now — neutralize the re-check to model that exact window
        old._check_fence = lambda: None
        old.save(5, {"who": "old", "n": 5})
        # both directories exist under distinct epoch-qualified names...
        import os as _os

        names = sorted(n for n in _os.listdir(str(tmp_path / "job"))
                       if n.startswith("chk-5"))
        assert names == ["chk-5.e1", "chk-5.e2"]
        # ...and resolution picks the successor's (highest epoch)
        latest = new.latest()
        assert (latest.checkpoint_id, latest.epoch) == (5, 2)
        assert FsCheckpointStorage.load(latest)["who"] == "new"

    def test_latest_orders_by_epoch_then_id(self, tmp_path):
        """The epoch is the leadership fencing token: the newest
        timeline outranks ANY id from a dead one. A deposed leader that
        got further (higher ids) before losing the lease must not have
        its late checkpoints eclipse the successor's — restoring the
        dead timeline would rewind sources past output the live
        timeline's 2PC sinks already committed."""
        from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

        w1 = FsCheckpointStorage(str(tmp_path), "job", epoch=1)
        w2 = FsCheckpointStorage(str(tmp_path), "job", epoch=2)
        w2._check_fence = lambda: None  # keep both timelines writable
        w1._check_fence = lambda: None
        w1.save(1, {"n": 1})
        w2.save(1, {"n": 1, "who": "new"})
        w1.save(2, {"n": 2, "who": "old"})  # stale leader got further
        assert [(h.checkpoint_id, h.epoch)
                for h in w2.list_complete()] == [(1, 1), (2, 1), (1, 2)]
        # the live (highest-epoch) timeline wins, not the dead higher id
        assert (w2.latest().checkpoint_id, w2.latest().epoch) == (1, 2)
        assert FsCheckpointStorage.load(w2.latest())["who"] == "new"


class TestAcrossThePackages:
    """One HA dir, both packages: the reference's job store record read
    by the port and the other way round, with equal dicts; a lease of
    either package resolved by the other; and the two packages'
    elections contending on one dir."""

    def _record(self, i):
        return dict(entry=f"mod:build_{i}",
                    config={"session.slots-per-job": i + 1,
                            "execution.checkpointing.dir": f"/c/{i}"},
                    state=("RUNNING", "WAITING_FOR_RESOURCES",
                           "FINISHED")[i % 3],
                    attempts=i + 1, py_blobs=[{"name": "m.py",
                                               "digest": "ab" * 8}],
                    submitted_at=1000.5 + i,
                    assigned_runners=[f"r{i}"],
                    rescale=({"devices": 2, "processes": None,
                              "token": "t", "paths": [],
                              "started_at": 1.0, "drain_exclude": None}
                             if i == 0 else None))

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_job_store_records_read_across(self, tmp_path, writer):
        from flink_tpu.runtime.ha import JobStore as RefJobStore

        ha = str(tmp_path)
        w, r = ((RefJobStore(ha), JobStore(ha)) if writer == "reference"
                else (JobStore(ha), RefJobStore(ha)))
        for i in range(3):
            w.put(f"j{i}", **self._record(i))
        for i in range(3):
            assert r.get(f"j{i}") == w.get(f"j{i}")
            assert r.get(f"j{i}")["config"] == self._record(i)["config"]
        assert r.recoverable() == w.recoverable()
        assert [x["job_id"] for x in r.recoverable()] == ["j0", "j1"]
        # a terminal write by the reader archives the writer's record
        r.put("j0", entry="mod:build_0", config={}, state="CANCELED",
              attempts=1)
        assert [x["job_id"] for x in w.recoverable()] == ["j1"]
        assert w.get("j0")["state"] == "CANCELED"

    @pytest.mark.parametrize("holder", ["reference", "port"])
    def test_lease_and_takeover_count_read_across(self, tmp_path, holder):
        from flink_tpu.runtime import ha as ref_ha
        from flink_tpu_torch.runtime import ha as port_ha

        d = str(tmp_path)
        mine, other = ((ref_ha, port_ha) if holder == "reference"
                       else (port_ha, ref_ha))
        a = mine.LeaderElection(d, "127.0.0.1:1111", lease_timeout_s=0.3)
        a.start()
        deadline = time.time() + 5
        while time.time() < deadline and not a.is_leader:
            time.sleep(0.02)
        assert a.is_leader
        assert other.leader_address(d) == "127.0.0.1:1111"
        # the holder dies without cleanup: the other package steals
        a._closed = True
        a._thread.join(timeout=2)
        b = other.LeaderElection(d, "127.0.0.1:2222", lease_timeout_s=0.3)
        try:
            b.start()
            deadline = time.time() + 5
            while time.time() < deadline and not b.is_leader:
                time.sleep(0.02)
            assert b.is_leader and b.epoch == a.epoch + 1
            assert mine.leader_address(d) == "127.0.0.1:2222"
            assert mine.takeover_count(d) == other.takeover_count(d) == 1
        finally:
            b.close()
            a.close()

    def test_contenders_of_both_packages_one_holder_rising_epochs(
            self, tmp_path):
        """A contender of each package on one dir, each deposed in turn
        (renewal stopped, lease aged out): at every sample at most one
        holds the lease, and each grant's epoch is above every earlier
        one."""
        import threading

        from flink_tpu.runtime.ha import LeaderElection as RefElection

        d = str(tmp_path)
        grants = []
        lock = threading.Lock()

        def make(cls, name):
            e = cls(d, f"127.0.0.1:{len(name)}", lease_timeout_s=0.3,
                    leader_id=name)
            e.on_grant = lambda epoch: (lock.acquire(),
                                        grants.append((name, epoch)),
                                        lock.release())
            return e

        live = [make(RefElection, "ref-0"), make(LeaderElection, "port-0")]
        for e in live:
            e.start()
        try:
            for round_ in range(1, 4):
                deadline = time.time() + 10
                while time.time() < deadline and not any(
                        e.is_leader for e in live):
                    time.sleep(0.01)
                holders = [e for e in live if e.is_leader]
                assert len(holders) == 1, [e.leader_id for e in holders]
                # depose the holder: it stops renewing and never
                # releases; a fresh contender of its package replaces it
                dead = holders[0]
                dead._closed = True
                dead._thread.join(timeout=2)
                dead.is_leader = False
                live.remove(dead)
                cls = (RefElection if dead.leader_id.startswith("ref")
                       else LeaderElection)
                fresh = make(cls, dead.leader_id.split("-")[0]
                             + f"-{round_}")
                fresh.start()
                live.append(fresh)
                t_end = time.time() + 1.0
                while time.time() < t_end:
                    assert sum(e.is_leader for e in live) <= 1
                    time.sleep(0.01)
            epochs = [ep for _, ep in grants]
            assert len(epochs) >= 4
            assert epochs == sorted(set(epochs)), grants
            assert {n.split("-")[0] for n, _ in grants} <= {"ref", "port"}
        finally:
            for e in live:
                e.close()
