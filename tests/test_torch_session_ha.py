"""``tests/test_session_ha.py`` against the port: session dispatcher
failover with a durable session registry, epoch-fenced runners, and
kill-the-leader chaos, on the port's ``runtime/session.py``,
``runtime/ha.py``, ``coordinator.py`` and ``runner.py``. In-process
runners run their jobs on the CPU (``device="cpu"``); the command-line
smoke starts ``python -m flink_tpu_torch session start ... --device
cpu``.

The contract under test (the Dispatcher/ResourceManager HA of the
upstream project, here on the shared-filesystem lease of runtime/ha.py):

- every ``rpc_submit_session_job`` persists the job — entry, config,
  quota, FIFO position — BEFORE admission returns (a store failure
  loses the submission cleanly, never half-registers it);
- a standby granted leadership re-hydrates the registry, re-queues
  undeployed jobs in ORIGINAL FIFO order, and re-attaches RUNNING jobs
  that runners carry back (in place — no redeploy, so committed output
  stays exactly-once across the takeover);
- every dispatcher→runner RPC carries the leader epoch and a deposed
  leader's late deploy/cancel is REJECTED at the runner (the log's
  writer-lease fencing mirrored onto the control plane);
- jobs whose runner died in the failover window restart through the
  existing checkpoint-restore path.

The in-process "SIGKILL" models a leader crash faithfully at the
protocol level: the RPC endpoint vanishes mid-conversation and the
lease stops renewing WITHOUT a clean handover. The real-signal variant
(subprocess + os.kill SIGKILL) is the CLI smoke below.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from flink_tpu_torch import faults
from flink_tpu_torch.config import Configuration, HighAvailabilityOptions
from flink_tpu_torch.runtime.ha import JobStore, LeaderElection, leader_address
from flink_tpu_torch.runtime.rpc import RpcClient, RpcEndpoint, RpcServer
from flink_tpu_torch.runtime.session import (
    LocalSessionCluster,
    SessionDispatcher,
    _build_dispatcher,
)

from test_torch_runner_process import wait_until

pytestmark = [pytest.mark.session, pytest.mark.chaos]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cluster_conf(ha_dir, extra=None):
    conf = {
        "high-availability.dir": str(ha_dir),
        "high-availability.lease-timeout": "700ms",
        "heartbeat.interval": "150ms",
        # wide: the fake-gateway runners of the unit tests never beat,
        # and a loss-declared runner under full-suite load would park
        # the redeploy these tests wait on (real-runner scenarios
        # detect leader death via CLIENT-side misses, not this timeout)
        "heartbeat.timeout": "60s",
        "session.autoscale": False,
        "session.ha.reattach-grace": "6s",
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 3,
        "restart-strategy.fixed-delay.delay": "100ms",
    }
    conf.update(extra or {})
    return Configuration(conf)


def _job_conf(tmp_path, tag, n_batches, sleep_ms=0):
    return {
        "test.n-batches": n_batches,
        "test.batch-sleep-ms": sleep_ms,
        "test.sink-dir": str(tmp_path / f"sink-{tag}"),
        "execution.checkpointing.dir": str(tmp_path / "chk"),
        "execution.checkpointing.interval": "150ms",
        "state.num-key-shards": 8,
        "state.slots-per-shard": 16,
    }


def _has_checkpoint(tmp_path, job_id):
    """A completed checkpoint exists for the job (admission namespaces
    the dir by job id, then storage namespaces by job name again:
    <base>/<job_id>/<job_id>/chk-*)."""
    d = tmp_path / "chk" / job_id / job_id
    return d.is_dir() and any(n.startswith("chk-")
                              for n in os.listdir(d))


def _committed(sink_dir):
    from flink_tpu_torch.api.sinks import FileTransactionalSink

    return sorted(
        (int(r["key"]), int(r["window_start"]), int(r["count"]))
        for r in FileTransactionalSink.committed_rows(sink_dir))


def _assert_exactly_once(sink_dir, n_batches):
    import test_torch_runner_jobs as runner_job
    from flink_tpu_torch.api.sinks import FileTransactionalSink

    got = {}
    for r in FileTransactionalSink.committed_rows(sink_dir):
        kk = (int(r["key"]), int(r["window_start"]))
        assert kk not in got, f"duplicate emission for {kk}"
        got[kk] = int(r["count"])
    assert got == runner_job.golden_counts(n_batches)


class Contender:
    """One `session start [--standby]` process in miniature: election +
    (on grant) dispatcher + RPC server — the serve_session cycle with
    the process boundary removed so the test can SIGKILL it
    surgically."""

    def __init__(self, ha_dir, conf, name):
        self.conf = conf
        self.name = name
        self.port = _free_port()
        self.address = f"127.0.0.1:{self.port}"
        self.granted = threading.Event()
        self.revoked = threading.Event()
        self.election = LeaderElection(
            str(ha_dir), self.address,
            conf.get(HighAvailabilityOptions.LEASE_TIMEOUT) / 1000,
            leader_id=name)
        self.election.on_grant = lambda epoch: self.granted.set()
        self.election.on_revoke = self.revoked.set
        self.dispatcher = None
        self.server = None
        self.election.start()

    def serve(self, timeout=20.0) -> SessionDispatcher:
        assert self.granted.wait(timeout), f"{self.name} never granted"
        self.dispatcher = _build_dispatcher(self.conf)
        # stamped between construction and serving (serve_session's
        # discipline): no push can leave unstamped
        self.dispatcher.leader_epoch = self.election.epoch
        self.server = RpcServer(self.dispatcher, self.port)
        return self.dispatcher

    def sigkill(self):
        """Crash without cleanup: the lease is NOT released (no clean
        handover — a standby must wait it out and STEAL it) and the
        endpoint vanishes mid-conversation."""
        self.election._closed = True
        if self.election._thread is not None:
            self.election._thread.join(timeout=2)
        if self.server is not None:
            self.server.close()
        if self.dispatcher is not None:
            self.dispatcher.close()

    def close(self):
        if self.server is not None:
            self.server.close()
        if self.dispatcher is not None:
            self.dispatcher.close()
        self.election.close()


# ---------------------------------------------------------------------------
# durable session registry
# ---------------------------------------------------------------------------

class TestDurableRegistry:
    def test_fifo_order_quota_and_attempts_survive_recovery(
            self, tmp_path):
        """Queued (never-deployed) jobs recover at their ORIGINAL
        attempt and ORIGINAL submission order — the FIFO position is
        part of the durable record, not an accident of directory
        listing order."""
        conf = _cluster_conf(tmp_path / "ha")
        d1 = SessionDispatcher(conf)
        try:
            # no runners: every submission parks WAITING_FOR_RESOURCES
            for jid, extra in (("j-early", {}),
                               ("j-mid", {"session.slots-per-job": 2}),
                               ("j-late", {})):
                assert d1.rpc_submit_session_job(
                    jid, "test_torch_runner_jobs:build", extra)["admitted"]
            stamps = {j: d1.jobs[j].submitted_at
                      for j in ("j-early", "j-mid", "j-late")}
        finally:
            d1.close()
        d2 = _build_dispatcher(conf)
        try:
            assert d2.recovered_jobs == 3
            with d2._lock:
                assert d2._waiting_locked() == [
                    "j-early", "j-mid", "j-late"]
            for jid in stamps:
                j = d2.jobs[jid]
                assert j.attempts == 1  # never deployed: no restore bump
                assert j.submitted_at == stamps[jid]
                assert j.reattach_attempt is None
            assert d2.jobs["j-mid"].required_devices == 2  # quota kept
        finally:
            d2.close()

    def test_admission_persists_before_returning(self, tmp_path):
        """The durable write happens BEFORE rpc_submit_session_job
        returns: the store already holds the record (with its FIFO
        stamp) by the time the caller sees admitted=True."""
        ha = tmp_path / "ha"
        d = SessionDispatcher(_cluster_conf(ha))
        try:
            assert d.rpc_submit_session_job(
                "durable", "test_torch_runner_jobs:build", {})["admitted"]
            rec = JobStore(str(ha)).get("durable")
            assert rec is not None
            assert rec["state"] == "WAITING_FOR_RESOURCES"
            assert rec["submitted_at"] == d.jobs["durable"].submitted_at
            assert rec["config"]["session.slots-per-job"] == 1
        finally:
            d.close()

    def test_terminal_state_erased_from_active_registry(self, tmp_path):
        ha = tmp_path / "ha"
        d = SessionDispatcher(_cluster_conf(ha))
        try:
            assert d.rpc_submit_session_job(
                "gone", "test_torch_runner_jobs:build", {})["admitted"]
            assert d.rpc_cancel_job("gone")["ok"]
            store = JobStore(str(ha))
            assert store.recoverable() == []  # a new leader re-runs nothing
            assert store.get("gone")["state"] == "CANCELED"  # archived
        finally:
            d.close()


# ---------------------------------------------------------------------------
# re-attach mechanics (fake gateway: deterministic, no drivers)
# ---------------------------------------------------------------------------

class _GW(RpcEndpoint):
    def __init__(self):
        self.jobs = []

    def rpc_run_job(self, job_id, entry, config=None, attempt=1, **kw):
        self.jobs.append((job_id, attempt, dict(config or {})))
        return {"accepted": True}

    def rpc_cancel_job(self, job_id, attempt=None, **kw):
        return {"ok": True}


class TestReattach:
    def _running_job(self, tmp_path, gw_srv):
        """Leader 1: register a runner, deploy one job, then die.

        Waits for the deploy PUSH to land at the gateway, not the
        in-memory RUNNING flip: the durable record and the push both
        trail the (unlocked-readable) state assignment, and a leader
        killed in that gap correctly recovers the job as still-queued
        — which is not the scenario these tests stage."""
        conf = _cluster_conf(tmp_path / "ha")
        d1 = SessionDispatcher(conf)
        d1.leader_epoch = 1
        try:
            d1.rpc_register_runner("r1", "127.0.0.1", 1,
                                   port=gw_srv.port)
            assert d1.rpc_submit_session_job(
                "live", "test_torch_runner_jobs:build", {})["admitted"]
            wait_until(lambda: len(gw_srv.endpoint.jobs) >= 1, 10,
                       what="deploy pushed by leader 1")
        finally:
            d1.close()
        return conf

    def test_register_with_inventory_reattaches_in_place(
            self, tmp_path):
        gw = _GW()
        srv = RpcServer(gw)
        d2 = None
        try:
            conf = self._running_job(tmp_path, srv)
            d2 = _build_dispatcher(conf)
            d2.leader_epoch = 2
            j = d2.jobs["live"]
            assert j.state == "WAITING_FOR_RESOURCES"
            assert j.reattach_attempt == 1
            assert j.attempts == 2  # pre-bumped for the fallback path
            # the runner comes back CARRYING the live execution:
            # re-adopted in place — slot occupancy rebuilt from truth
            d2.rpc_register_runner("r1", "127.0.0.1", 1, port=srv.port,
                                   jobs=[{"job_id": "live",
                                          "attempt": 1}])
            assert d2.jobs["live"].state == "RUNNING"
            assert d2.jobs["live"].attempts == 1  # rolled back: no restore
            assert d2.jobs["live"].assigned_runners == ["r1"]
            assert d2._slots.used_devices("r1") == 1
            time.sleep(0.4)  # any stray deploy kick would land by now
            # the ONLY pushes ever: leader 1's original deploy (which
            # may land late). A re-attach must never push attempt 2.
            assert all(a == 1 for _, a, _ in gw.jobs), (
                f"re-attach must not redeploy: {gw.jobs}")
        finally:
            if d2 is not None:
                d2.close()
            srv.close()

    def test_runner_back_without_job_redeploys_with_restore(
            self, tmp_path):
        gw = _GW()
        srv = RpcServer(gw)
        d2 = None
        try:
            conf = self._running_job(tmp_path, srv)
            d2 = _build_dispatcher(conf)
            d2.leader_epoch = 2
            # the stored runner re-registers WITHOUT the job (it died
            # there): the window collapses early and the checkpoint-
            # restore redeploy fires without waiting out the grace
            d2.rpc_register_runner("r1", "127.0.0.1", 1, port=srv.port,
                                   jobs=[])
            wait_until(lambda: any(a == 2 for _, a, _ in gw.jobs), 10,
                       what="fallback redeploy pushed")
            job_id, attempt, config = next(
                e for e in gw.jobs if e[1] == 2)
            assert job_id == "live"
            assert config["execution.checkpointing.restore"] == "latest"
            assert config["cluster.attempt"] == 2
        finally:
            if d2 is not None:
                d2.close()
            srv.close()

    def test_cancel_during_window_is_not_resurrected(self, tmp_path):
        """A job canceled while its re-attach window is open must STAY
        canceled when its runner re-registers carrying it (an
        unconditional re-adopt would silently undo a cancel that had
        already returned ok=true)."""
        gw = _GW()
        srv = RpcServer(gw)
        d2 = None
        try:
            conf = self._running_job(tmp_path, srv)
            d2 = _build_dispatcher(conf)
            d2.leader_epoch = 2
            assert d2.jobs["live"].reattach_attempt == 1
            assert d2.rpc_cancel_job("live")["ok"]
            assert d2.jobs["live"].reattach_attempt is None
            d2.rpc_register_runner("r1", "127.0.0.1", 1, port=srv.port,
                                   jobs=[{"job_id": "live",
                                          "attempt": 1}])
            assert d2.jobs["live"].state == "CANCELED"
            # and the runner-side zombie is revocation-fenced
            hb = d2.rpc_heartbeat("r1", jobs=["live"])
            assert "live" in hb["revoked_jobs"]
            # the terminal state is durable (archived)
            assert JobStore(
                str(tmp_path / "ha")).get("live")["state"] == "CANCELED"
        finally:
            if d2 is not None:
                d2.close()
            srv.close()

    def test_second_failover_keeps_the_reattach_window(self, tmp_path):
        """Recovery must NOT overwrite the durable RUNNING record with
        its parked WAITING view: a second leader failing during the
        window would otherwise recover the job as never-deployed and
        blind-redeploy beside the live attempt."""
        gw = _GW()
        srv = RpcServer(gw)
        try:
            conf = self._running_job(tmp_path, srv)
            d2 = _build_dispatcher(conf)
            assert d2.jobs["live"].reattach_attempt == 1
            d2.close()  # leader 2 dies before any runner came back
            rec = JobStore(str(tmp_path / "ha")).get("live")
            assert rec["state"] == "RUNNING"  # durable truth survives
            assert rec["attempts"] == 1
            assert rec["assigned_runners"] == ["r1"]
            d3 = _build_dispatcher(conf)
            try:
                # leader 3 re-opens the window at the ORIGINAL attempt
                assert d3.jobs["live"].reattach_attempt == 1
                assert d3.jobs["live"].reattach_runners == ["r1"]
            finally:
                d3.close()
        finally:
            srv.close()

    def test_duplicate_submit_after_takeover_acks(self, tmp_path):
        """The HA client's retry of a submit whose response died with
        the leader re-sends the same (job_id, entry) to the new
        leader, which recovered the job — it must ack the duplicate,
        not fail a script whose job IS admitted."""
        conf = _cluster_conf(tmp_path / "ha")
        d1 = SessionDispatcher(conf)
        assert d1.rpc_submit_session_job(
            "retry-me", "test_torch_runner_jobs:build", {})["admitted"]
        d1.close()  # response lost with the leader
        d2 = _build_dispatcher(conf)
        try:
            r = d2.rpc_submit_session_job(
                "retry-me", "test_torch_runner_jobs:build", {})
            assert r["admitted"] and r.get("duplicate")
            # a DIFFERENT job under the recovered id is still refused
            r = d2.rpc_submit_session_job("retry-me", "other:entry", {})
            assert not r["admitted"]
        finally:
            d2.close()

    def test_cross_host_job_never_adopts_through_one_runner(
            self, tmp_path):
        """A cross-host (num-processes > 1) job is only whole with ALL
        its process allocations: one runner carrying it back must not
        re-adopt it single-runner — the window collapses into the
        restore redeploy path instead (which parks until enough
        distinct runners exist)."""
        ha = tmp_path / "ha"
        store = JobStore(str(ha))
        store.put("xh", entry="test_torch_runner_jobs:build",
                  config={"cluster.num-processes": 2},
                  state="RUNNING", attempts=1,
                  submitted_at=time.time(),
                  assigned_runners=["r1", "r2"])
        gw = _GW()
        srv = RpcServer(gw)
        d2 = None
        try:
            d2 = _build_dispatcher(_cluster_conf(ha))
            d2.leader_epoch = 2
            assert d2.jobs["xh"].reattach_attempt == 1
            d2.rpc_register_runner("r1", "127.0.0.1", 2, port=srv.port,
                                   jobs=[{"job_id": "xh",
                                          "attempt": 1}])
            j = d2.jobs["xh"]
            assert j.reattach_attempt is None  # collapsed, not adopted
            assert j.attempts == 2  # the restore redeploy's attempt
            # one runner cannot host a 2-process job: it parks instead
            # of being mis-adopted RUNNING on r1 alone
            time.sleep(0.3)
            assert j.state == "WAITING_FOR_RESOURCES"
            assert gw.jobs == []
        finally:
            if d2 is not None:
                d2.close()
            srv.close()

    def test_grace_expiry_redeploys_on_fresh_capacity(self, tmp_path):
        gw = _GW()
        srv = RpcServer(gw)
        d2 = None
        try:
            conf = self._running_job(tmp_path, srv)
            conf.set("session.ha.reattach-grace", "1500ms")
            d2 = _build_dispatcher(conf)
            d2.leader_epoch = 2
            deadline = time.time() + 1.0  # well inside the grace
            # a DIFFERENT runner registers (the stored one is gone for
            # good): the job must not deploy inside the grace window...
            d2.rpc_register_runner("r2", "127.0.0.1", 1, port=srv.port,
                                   jobs=[])
            time.sleep(0.15)
            if time.time() < deadline:  # loaded-host guard
                assert all(a == 1 for _, a, _ in gw.jobs), (
                    "redeployed inside the re-attach grace window")
            # ...but does once the window expires (monitor-loop kick)
            wait_until(lambda: any(a == 2 for _, a, _ in gw.jobs), 15,
                       what="post-grace redeploy")
            assert next(e for e in gw.jobs if e[1] == 2)[0] == "live"
        finally:
            if d2 is not None:
                d2.close()
            srv.close()


# ---------------------------------------------------------------------------
# the new fault points, each wired into a chaos schedule
# ---------------------------------------------------------------------------

class TestHaFaultPoints:
    def test_lease_renew_chaos_deposes_stalled_leader(self, tmp_path):
        """ha.lease.renew chaos: a leader whose renewals fail (frozen
        process, NFS blip) ages past its lease — the standby steals it
        with a bumped epoch and the incumbent sees a revoke, never a
        crash of its contender thread."""
        d = str(tmp_path)
        a = LeaderElection(d, "127.0.0.1:1111", lease_timeout_s=0.4,
                           leader_id="stall-a")
        b = LeaderElection(d, "127.0.0.1:2222", lease_timeout_s=0.4,
                           leader_id="steal-b")
        revoked = threading.Event()
        a.on_revoke = revoked.set
        plan = faults.FaultPlan(seed=11).rule("ha.lease.renew", "raise")
        try:
            with plan.activate():
                a.start()
                wait_until(lambda: a.is_leader, 10, what="a leads")
                epoch_a = a.epoch
                b.start()
                wait_until(lambda: b.is_leader, 15,
                           what="standby stole the stalled lease")
                assert b.epoch > epoch_a  # fencing token advanced
                assert revoked.wait(10), "deposed leader never revoked"
            assert any(p == "ha.lease.renew" for p, _, _ in plan.log)
        finally:
            a.close()
            b.close()

    def test_store_write_chaos_loses_submission_cleanly(self, tmp_path):
        """ha.store.write chaos at admission: persisted-BEFORE-
        registered means an injected store failure loses the
        submission whole — no half-admitted job in memory, nothing on
        disk, and the caller's retry admits normally."""
        ha = tmp_path / "ha"
        disp = SessionDispatcher(_cluster_conf(ha))
        plan = faults.FaultPlan(seed=7).rule("ha.store.write", "raise",
                                             count=1)
        try:
            with plan.activate():
                with pytest.raises(OSError) as e:
                    disp.rpc_submit_session_job(
                        "s1", "test_torch_runner_jobs:build", {})
                assert faults.is_injected(e.value)
                assert "s1" not in disp.jobs, (
                    "a failed durable write must not half-register")
                assert JobStore(str(ha)).get("s1") is None
                r = disp.rpc_submit_session_job(
                    "s1", "test_torch_runner_jobs:build", {})
                assert r["admitted"]
                assert JobStore(str(ha)).get("s1")["state"] == (
                    "WAITING_FOR_RESOURCES")
        finally:
            disp.close()

    def test_takeover_chaos_retries_construction(self, tmp_path):
        """session.failover.takeover chaos: a standby dying mid-
        re-hydration — the serve loop's bounded construction retry
        (serve_session/_build_dispatcher) absorbs it and the second
        pass recovers the full registry."""
        conf = _cluster_conf(tmp_path / "ha")
        d1 = SessionDispatcher(conf)
        assert d1.rpc_submit_session_job(
            "q1", "test_torch_runner_jobs:build", {})["admitted"]
        stamp = d1.jobs["q1"].submitted_at
        d1.close()
        plan = faults.FaultPlan(seed=3).rule(
            "session.failover.takeover", "raise", count=1)
        with plan.activate():
            d2 = _build_dispatcher(conf)
        try:
            assert plan.log and plan.log[0][0] == (
                "session.failover.takeover")
            assert d2.recovered_jobs == 1
            assert d2.jobs["q1"].submitted_at == stamp
        finally:
            d2.close()
    # runner.reattach is wired into the kill-the-leader schedule below
    # (a dropped re-registration rides the next heartbeat miss)


# ---------------------------------------------------------------------------
# THE acceptance scenario: kill the leader under load
# ---------------------------------------------------------------------------

class TestKillTheLeaderChaos:
    # tenant A is the shorter job (its checkpoints are mid-flight at
    # the kill), tenant B outlives A so the freed headroom admits the
    # queue strictly FIFO while B still runs
    N_A, N_B, N_Q = 50, 65, 6

    def _run_scenario(self, tmp_path, seed, kill_after_checkpoint=True):
        """Two tenants live (one mid-checkpoint) + two queued jobs;
        SIGKILL the leader; the standby takes over; everything
        finishes exactly-once; the deposed epoch is fenced at the
        runner. Returns the standby's dispatcher state for extra
        asserts (seed varies the reattach-drop schedule in the soak)."""
        from flink_tpu_torch.runtime.runner import TaskRunner

        ha = tmp_path / "ha"
        conf = _cluster_conf(ha, {"session.max-jobs": 2,
                                  "session.runner-slots": 2})
        A = Contender(ha, conf, "leader-a")
        disp_a = A.serve()
        assert disp_a.leader_epoch == 1
        B = Contender(ha, conf, "standby-b")  # hot standby: contends
        runner = TaskRunner("127.0.0.1", A.port, runner_id="r-ha",
                            ha_dir=str(ha), device="cpu")
        try:
            runner.start()
            wait_until(lambda: "r-ha" in disp_a.runners, 15,
                       what="runner registered with leader")
            for tag, n in (("a", self.N_A), ("b", self.N_B)):
                assert disp_a.rpc_submit_session_job(
                    f"job-{tag}", "test_torch_runner_jobs:build",
                    _job_conf(tmp_path, tag, n, sleep_ms=100)
                )["admitted"]
            wait_until(
                lambda: all(disp_a.jobs[f"job-{t}"].state == "RUNNING"
                            for t in ("a", "b")), 30,
                what="both tenants running")
            for tag in ("c", "d"):  # past max-jobs=2: queued FIFO
                assert disp_a.rpc_submit_session_job(
                    f"job-{tag}", "test_torch_runner_jobs:build",
                    _job_conf(tmp_path, tag, self.N_Q))["admitted"]
            jobs_view = {j["job_id"]: j for j in
                         disp_a.rpc_session_jobs()["jobs"]}
            assert jobs_view["job-c"]["queue_position"] == 0
            assert jobs_view["job-d"]["queue_position"] == 1
            if kill_after_checkpoint:
                # tenant A mid-checkpoint: at least one completed
                # checkpoint exists and more land every 150ms
                wait_until(
                    lambda: _has_checkpoint(tmp_path, "job-a"), 30,
                    what="tenant A checkpointing")

            # ---- SIGKILL the leader; the re-attach push itself is
            # under chaos (runner.reattach drop: the first
            # re-registration is lost and rides the next beat) -------
            plan = faults.FaultPlan(seed=seed).rule(
                "runner.reattach", "drop", count=1)
            with plan.activate():
                A.sigkill()
                disp_b = B.serve(timeout=25)
                assert disp_b.leader_epoch == 2
                assert disp_b.recovered_jobs == 4
                # the standby re-attaches the LIVE tenants in place:
                # same attempt (no redeploy), slots rebuilt from truth
                wait_until(
                    lambda: all(
                        disp_b.jobs[j].state in ("RUNNING", "FINISHED")
                        for j in ("job-a", "job-b")), 30,
                    what="tenants re-attached to the new leader")
            assert any(p == "runner.reattach" for p, _, _ in plan.log)
            for j in ("job-a", "job-b"):
                assert disp_b.jobs[j].attempts == 1, (
                    f"{j} was redeployed instead of re-attached")
            if disp_b.jobs["job-b"].state == "RUNNING":
                with disp_b._lock:
                    assert disp_b._slots.used_devices("r-ha") >= 1

            # ---- the deposed leader's late RPCs are fenced ----------
            c = RpcClient("127.0.0.1", runner._server.port)
            try:
                late = c.call("run_job", job_id="zombie-from-epoch-1",
                              entry="test_torch_runner_jobs:build",
                              config={}, attempt=1, leader_epoch=1)
                assert late["accepted"] is False
                assert "stale leader epoch" in late["reason"]
                late = c.call("cancel_job", job_id="job-b",
                              leader_epoch=1)
                assert late["ok"] is False
                assert "stale leader epoch" in late["reason"]
            finally:
                c.close()

            # ---- everything runs to completion, FIFO preserved ------
            wait_until(lambda: disp_b.jobs["job-a"].state == "FINISHED",
                       90, what="tenant A finished")
            # started_at is stamped at deploy: unlike a state poll it
            # cannot be missed when the short queued job races through
            # RUNNING between two polls
            wait_until(
                lambda: disp_b.jobs["job-c"].started_at is not None,
                30, what="queued job-c deployed on freed slot")
            if (disp_b.jobs["job-b"].state == "RUNNING"
                    and disp_b.jobs["job-c"].state == "RUNNING"):
                # strict FIFO: while B and C hold both slots, job-d
                # must not have jumped job-c's admission
                assert disp_b.jobs["job-d"].state == (
                    "WAITING_FOR_RESOURCES")
            for j in ("job-b", "job-c", "job-d"):
                wait_until(
                    lambda j=j: disp_b.jobs[j].state == "FINISHED",
                    120, what=f"{j} finished")
            assert disp_b.jobs["job-c"].started_at <= (
                disp_b.jobs["job-d"].started_at)
            # the fenced cancel never landed: job-b ran to completion
            assert disp_b.jobs["job-b"].state == "FINISHED"
            info = disp_b.rpc_session_info()
            assert info["leader_epoch"] == 2
            assert info["takeovers"] == 1
            return disp_b
        finally:
            runner.close()
            A.sigkill()
            B.close()

    def test_kill_leader_standby_takes_over_exactly_once(
            self, tmp_path):
        # the no-failover golden for tenant A (the mid-checkpoint
        # one): a fault-free run of the identical job on a plain
        # cluster — its committed rows are the byte-comparable bar
        with LocalSessionCluster(Configuration({
                "heartbeat.interval": "200ms",
                "session.autoscale": False}), runners=1,
                runner_prefix="golden", device="cpu") as g:
            r = g.submit("test_torch_runner_jobs:build",
                         config=_job_conf(tmp_path / "solo", "a",
                                          self.N_A),
                         job_id="golden-a")
            assert r["admitted"]
            assert g.wait("golden-a") == "FINISHED"
        golden_a = _committed(str(tmp_path / "solo" / "sink-a"))
        assert golden_a

        self._run_scenario(tmp_path, seed=1)

        # exactly-once across the takeover: tenant A's committed rows
        # are identical to the fault-free golden, row for row; every
        # other job matches the deterministic model
        assert _committed(str(tmp_path / "sink-a")) == golden_a
        _assert_exactly_once(str(tmp_path / "sink-a"), self.N_A)
        _assert_exactly_once(str(tmp_path / "sink-b"), self.N_B)
        _assert_exactly_once(str(tmp_path / "sink-c"), self.N_Q)
        _assert_exactly_once(str(tmp_path / "sink-d"), self.N_Q)
        # checkpoint subtrees stayed disjoint per tenant
        assert sorted(os.listdir(tmp_path / "chk")) == [
            "job-a", "job-b", "job-c", "job-d"]

    @pytest.mark.slow
    @pytest.mark.parametrize("seed", [2, 3, 5])
    def test_kill_leader_soak(self, tmp_path, seed):
        """Multi-seed soak: the same takeover under varied reattach-
        drop schedules (the seed drives the fault plan's per-point
        PRNG). Printed on failure for replay."""
        print(f"kill-the-leader soak seed={seed}")
        self._run_scenario(tmp_path, seed=seed,
                           kill_after_checkpoint=(seed % 2 == 0))
        for tag, n in (("a", self.N_A), ("b", self.N_B),
                       ("c", self.N_Q), ("d", self.N_Q)):
            _assert_exactly_once(str(tmp_path / f"sink-{tag}"), n)


# ---------------------------------------------------------------------------
# CLI smoke: real subprocesses, real SIGKILL
# ---------------------------------------------------------------------------

class TestSessionHaCliSmoke:
    """`session start` leader + `session start
    --standby` as REAL subprocesses sharing one --ha-dir; two jobs
    submitted through the lease; SIGKILL the leader mid-run; the
    standby is granted leadership, redeploys both jobs through
    checkpoint restore (the leader's in-process runner died with it),
    and both committed outputs match the no-failover golden.
    `session stop` against the NEW leader exits 0."""

    def _cli(self, env, *argv, timeout=120):
        p = subprocess.run([sys.executable, "-m", "flink_tpu_torch", *argv],
                           env=env, capture_output=True, text=True,
                           cwd=REPO, timeout=timeout)
        out = p.stdout.strip().splitlines()
        return p.returncode, (json.loads(out[-1]) if out else {})

    def _read_json_line(self, proc, want_key, deadline_s=60):
        deadline = time.time() + deadline_s
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError("process closed stdout early")
            line = line.strip()
            if line.startswith("{"):
                obj = json.loads(line)
                if want_key in obj:
                    return obj
        raise AssertionError(f"no {want_key!r} line within {deadline_s}s")

    def test_sigkill_leader_standby_finishes_both_jobs(self, tmp_path):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + os.path.join(
            REPO, "tests")
        env["OMP_NUM_THREADS"] = "2"
        ha = str(tmp_path / "ha")
        common = ["--ha-dir", ha, "--device", "cpu",
                  "--conf", "heartbeat.interval=200ms",
                  "--conf", "high-availability.lease-timeout=700ms",
                  "--conf", "session.ha.reattach-grace=1500ms",
                  "--conf", "session.autoscale=false"]
        leader = subprocess.Popen(
            [sys.executable, "-m", "flink_tpu_torch", "session", "start",
             "--local-runners", "1", *common],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        standby = None
        try:
            assert self._read_json_line(leader, "session")
            elected = self._read_json_line(leader, "elected")
            assert elected["epoch"] == 1
            standby = subprocess.Popen(
                [sys.executable, "-m", "flink_tpu_torch", "session", "start",
                 "--standby", "--local-runners", "1", *common],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            assert self._read_json_line(standby, "session")["standby"]

            n = 150  # ~7.5s+ of batches: still mid-run at the kill
            for tag in ("a", "b"):
                conf_args = []
                for k, v in _job_conf(tmp_path, tag, n,
                                      sleep_ms=50).items():
                    conf_args += ["--conf", f"{k}={v}"]
                rc, out = self._cli(
                    env, "session", "submit", "--ha-dir", ha,
                    "--entry", "test_torch_runner_jobs:build",
                    "--job-id", f"ha-{tag}", *conf_args)
                assert rc == 0 and out["admitted"], out
            # kill only once both jobs checkpointed: the redeploy must
            # travel the restore path, not a fresh re-execution
            for tag in ("a", "b"):
                wait_until(
                    lambda tag=tag: _has_checkpoint(tmp_path,
                                                    f"ha-{tag}"),
                    60, what=f"ha-{tag} first checkpoint")
            os.kill(leader.pid, signal.SIGKILL)
            leader.wait(timeout=10)

            deadline = time.time() + 180
            states = {}
            while time.time() < deadline:
                rc, out = self._cli(env, "session", "list",
                                    "--ha-dir", ha)
                if rc == 0 and out.get("jobs"):
                    states = {j["job_id"]: j["state"]
                              for j in out["jobs"]}
                    assert "FAILED" not in states.values(), states
                    if set(states.values()) == {"FINISHED"}:
                        break
                time.sleep(1.0)
            else:
                raise AssertionError(
                    f"jobs never finished after failover: {states}")
            assert out["leader_epoch"] == 2  # the standby's incumbency

            # exactly-once through the takeover: committed rows match
            # the no-failover golden model despite kill + restore
            _assert_exactly_once(str(tmp_path / "sink-a"), n)
            _assert_exactly_once(str(tmp_path / "sink-b"), n)

            rc, out = self._cli(env, "session", "info", "--ha-dir", ha)
            assert rc == 0
            assert out["leader_epoch"] == 2 and out["takeovers"] == 1
            rc, out = self._cli(env, "session", "stop", "--ha-dir", ha)
            assert rc == 0 and out["ok"]
            assert standby.wait(timeout=30) == 0
        finally:
            for p in (leader, standby):
                if p is not None and p.poll() is None:
                    p.kill()
