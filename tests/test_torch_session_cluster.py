"""``tests/test_session.py`` against the port's session cluster
(``flink_tpu_torch/runtime/session.py``): slot quotas and the FIFO
admission queue, fair drain scheduling, per-job isolation (checkpoint
dirs, metrics, fault plans), queue-depth autoscaling, and the ``python -m
flink_tpu_torch session ...`` command line (exit codes 0/1/2). In-process
runners run their jobs on the CPU (``device="cpu"``), the command line's
with ``--device cpu``. ``TestAgainstTheReference`` drives the reference's
dispatcher and the port's through the same submissions, ticks and turns
and holds the admission replies, the queue, the autoscaler's demands and
releases and the gate's grant order equal."""
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from flink_tpu_torch.config import Configuration
from flink_tpu_torch.runtime.coordinator import RunnerInfo
from flink_tpu_torch.runtime.rpc import RpcEndpoint, RpcServer
from flink_tpu_torch.runtime.session import (
    FairDrainGate,
    LocalSessionCluster,
    SessionDispatcher,
    SessionSlotPool,
)

from test_torch_runner_process import wait_until

pytestmark = pytest.mark.session

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cluster_conf(extra=None):
    conf = {
        "heartbeat.interval": "200ms",
        "heartbeat.timeout": "5s",
        "session.autoscale": False,
    }
    conf.update(extra or {})
    return Configuration(conf)


def _job_conf(tmp_path, tag, n_batches=6, extra=None):
    conf = {
        "test.n-batches": n_batches,
        "test.sink-dir": str(tmp_path / f"sink-{tag}"),
        "execution.checkpointing.dir": str(tmp_path / "chk"),
        "execution.checkpointing.interval": "200ms",
        "state.num-key-shards": 8,
        "state.slots-per-shard": 16,
    }
    conf.update(extra or {})
    return conf


def _golden(sink_dir, n_batches):
    import test_torch_runner_jobs as runner_job
    from flink_tpu_torch.api.sinks import FileTransactionalSink

    got = {}
    for r in FileTransactionalSink.committed_rows(sink_dir):
        kk = (int(r["key"]), int(r["window_start"]))
        assert kk not in got, f"duplicate emission for {kk}"
        got[kk] = int(r["count"])
    assert got == runner_job.golden_counts(n_batches)


class TestFairDrainGate:
    def test_solo_member_never_waits(self):
        g = FairDrainGate()
        g.register("a")
        t0 = time.perf_counter()
        for _ in range(1000):
            with g.turn("a"):
                pass
        assert time.perf_counter() - t0 < 1.0  # uncontended fast path
        g.unregister("a")
        assert g.members == 0

    def test_burst_requeues_behind_waiter(self):
        """THE fairness contract: a holder that releases and
        immediately re-requests goes BEHIND a waiting peer — a
        bursting job cannot starve another's drain."""
        g = FairDrainGate()
        g.register("burst")
        g.register("quiet")
        order = []
        inside = threading.Event()
        release = threading.Event()

        def burst():
            with g.turn("burst"):
                order.append("burst-1")
                inside.set()
                release.wait(5)
            with g.turn("burst"):  # immediate re-request
                order.append("burst-2")

        def quiet():
            inside.wait(5)
            # queue up WHILE burst holds the turn
            with g.turn("quiet"):
                order.append("quiet-1")

        tb = threading.Thread(target=burst)
        tq = threading.Thread(target=quiet)
        tb.start()
        tq.start()
        inside.wait(5)
        time.sleep(0.1)  # let quiet actually enqueue
        release.set()
        tb.join(5)
        tq.join(5)
        assert order == ["burst-1", "quiet-1", "burst-2"]

    def test_unregister_releases_held_turn(self):
        """A job whose drain thread dies while HOLDING the turn must
        not wedge its peers: unregister releases everything it held."""
        g = FairDrainGate()
        g.register("dead")
        g.register("live")
        got = threading.Event()
        cm = g.turn("dead")
        cm.__enter__()  # hold the turn, never cleanly release
        g.unregister("dead")

        def peer():
            with g.turn("live"):
                got.set()

        threading.Thread(target=peer).start()
        assert got.wait(5), "peer never acquired after unregister"


class TestSessionSlotPool:
    def _runner(self, rid, n=1):
        return RunnerInfo(rid, "127.0.0.1", n, time.time(), port=1)

    def test_capacity_is_logical_slots_not_devices(self):
        p = SessionSlotPool(4)
        r = self._runner("r1", n=1)  # 1 device, 4 session slots
        assert p.capacity(r) == 4
        assert p.free_slots(r) == 4
        p.allocate("j1", "r1", 1)
        p.allocate("j2", "r1", 2)
        assert p.free_slots(r) == 1
        assert p.pick("j3", 2, [r]) is None  # 2 > 1 free
        assert p.pick("j3", 1, [r]) is r
        p.release("j2")
        assert p.free_slots(r) == 3

    def test_best_fit_packs_shared_chips(self):
        p = SessionSlotPool(4)
        r1, r2 = self._runner("r1"), self._runner("r2")
        p.allocate("j1", "r1", 2)
        # r1 has 2 free, r2 has 4 free: best-fit picks the fuller one
        assert p.pick("j2", 2, [r1, r2]) is r1


class TestAdmission:
    """Quota validation + FIFO queueing against a fake runner gateway
    (the pattern of test_control_plane.TestActiveProvisioning — jobs
    deploy but never run, so the queue mechanics are deterministic)."""

    class _GW(RpcEndpoint):
        def __init__(self):
            self.jobs = []

        def rpc_run_job(self, job_id, entry, config=None, attempt=1,
                        **kw):
            self.jobs.append((job_id, dict(config or {})))
            return {"accepted": True}

        def rpc_cancel_job(self, job_id, attempt=None):
            return {"ok": True}

    def _register(self, disp, gw_port, rid):
        disp.rpc_register_runner(rid, "127.0.0.1", 1, port=gw_port)

    def test_quota_rejections(self):
        disp = SessionDispatcher(_cluster_conf({
            "session.runner-slots": 2}))
        try:
            r = disp.rpc_submit_session_job("a", "m:f",
                                            {"session.slots-per-job": 0})
            assert not r["admitted"] and "below 1" in r["reason"]
            r = disp.rpc_submit_session_job("b", "m:f",
                                            {"session.slots-per-job": 3})
            assert not r["admitted"] and "runner-slots" in r["reason"]
            r = disp.rpc_submit_session_job("c", "m:f", {})
            assert r["admitted"]
            # the SAME submission re-delivered (the HA client retries a
            # submit whose response died with the leader): ack'd as a
            # duplicate, never an error — the job IS admitted
            r = disp.rpc_submit_session_job("c", "m:f", {})
            assert r["admitted"] and r.get("duplicate")
            # a DIFFERENT job reusing an active id is still rejected
            r = disp.rpc_submit_session_job("c", "other:entry", {})
            assert not r["admitted"] and "already active" in r["reason"]
        finally:
            disp.close()

    def test_invalid_cluster_quotas_refuse_to_start(self):
        with pytest.raises(ValueError):
            SessionDispatcher(_cluster_conf({"session.max-jobs": 0}))
        with pytest.raises(ValueError):
            SessionDispatcher(_cluster_conf({"session.runner-slots": 0}))

    def test_max_jobs_queues_fifo_and_drains_on_finish(self):
        disp = SessionDispatcher(_cluster_conf({
            "session.max-jobs": 1, "session.runner-slots": 8}))
        gw = self._GW()
        srv = RpcServer(gw)
        try:
            self._register(disp, srv.port, "r1")
            for jid in ("j1", "j2", "j3"):
                assert disp.rpc_submit_session_job(
                    jid, "m:f", {})["admitted"]
            wait_until(lambda: disp.jobs["j1"].state == "RUNNING", 10,
                       what="j1 deployed")
            time.sleep(0.3)  # deploy kicks settle
            assert disp.jobs["j2"].state == "WAITING_FOR_RESOURCES"
            assert disp.jobs["j3"].state == "WAITING_FOR_RESOURCES"
            jobs = {j["job_id"]: j for j in
                    disp.rpc_session_jobs()["jobs"]}
            assert jobs["j2"]["queue_position"] == 0
            assert jobs["j3"]["queue_position"] == 1
            # finish j1 → FIFO admits j2, never j3 first
            disp.rpc_finish_job("j1", attempt=1)
            wait_until(lambda: disp.jobs["j2"].state == "RUNNING", 10,
                       what="j2 admitted after j1 finished")
            time.sleep(0.2)
            assert disp.jobs["j3"].state == "WAITING_FOR_RESOURCES"
            disp.rpc_finish_job("j2", attempt=1)
            wait_until(lambda: disp.jobs["j3"].state == "RUNNING", 10,
                       what="j3 admitted last")
        finally:
            disp.close()
            srv.close()

    def test_restarting_job_holds_its_admission(self):
        """max-jobs headroom counts RESTARTING jobs: an admitted
        tenant mid-recovery still owns its slot — a queued peer must
        not slip in during the restart window and over-admit the
        cluster."""
        disp = SessionDispatcher(_cluster_conf({
            "session.max-jobs": 1, "session.runner-slots": 8,
            "restart-strategy.type": "fixed-delay",
            "restart-strategy.fixed-delay.attempts": 3,
            "restart-strategy.fixed-delay.delay": "100ms"}))
        gw = self._GW()
        srv = RpcServer(gw)
        try:
            self._register(disp, srv.port, "r1")
            assert disp.rpc_submit_session_job("j1", "m:f", {})["admitted"]
            wait_until(lambda: disp.jobs["j1"].state == "RUNNING", 10,
                       what="j1 running")
            d = disp.rpc_report_failure("j1", "boom", attempt=1)
            assert d["action"] == "restart"
            assert disp.rpc_submit_session_job("j2", "m:f", {})["admitted"]
            # j1 recovers into its own admission; j2 stays queued
            wait_until(lambda: disp.jobs["j1"].state == "RUNNING", 10,
                       what="j1 recovered")
            time.sleep(0.3)
            assert disp.jobs["j2"].state == "WAITING_FOR_RESOURCES"
            disp.rpc_finish_job("j1", attempt=disp.jobs["j1"].attempts)
            wait_until(lambda: disp.jobs["j2"].state == "RUNNING", 10,
                       what="j2 admitted after j1 finished")
        finally:
            disp.close()
            srv.close()

    def test_slot_exhaustion_queues_even_under_max_jobs(self):
        disp = SessionDispatcher(_cluster_conf({
            "session.max-jobs": 8, "session.runner-slots": 1}))
        gw = self._GW()
        srv = RpcServer(gw)
        try:
            self._register(disp, srv.port, "r1")
            assert disp.rpc_submit_session_job("a", "m:f", {})["admitted"]
            wait_until(lambda: disp.jobs["a"].state == "RUNNING", 10,
                       what="a deployed")
            assert disp.rpc_submit_session_job("b", "m:f", {})["admitted"]
            time.sleep(0.3)
            assert disp.jobs["b"].state == "WAITING_FOR_RESOURCES"
            # capacity registers → the queued job deploys
            gw2 = self._GW()
            srv2 = RpcServer(gw2)
            self._register(disp, srv2.port, "r2")
            wait_until(lambda: disp.jobs["b"].state == "RUNNING", 10,
                       what="b deployed on new capacity")
            srv2.close()
        finally:
            disp.close()
            srv.close()

    def test_isolation_stamping(self):
        """Admission stamps the per-tenant isolation config: namespaced
        checkpoint dir, scoped faults, fair drain; the deploy stamps
        the resource-share denominator."""
        disp = SessionDispatcher(_cluster_conf({
            "session.runner-slots": 4}))
        gw = self._GW()
        srv = RpcServer(gw)
        try:
            self._register(disp, srv.port, "r1")
            disp.rpc_submit_session_job(
                "iso", "m:f",
                {"execution.checkpointing.dir": "/tmp/base",
                 "faults.inject": "checkpoint.storage.write=raise x1"})
            disp.rpc_submit_session_job("iso2", "m:f", {})
            wait_until(lambda: len(gw.jobs) == 2, 10,
                       what="both deploys pushed")
            pushed = dict(gw.jobs)
            assert pushed["iso"]["execution.checkpointing.dir"] == (
                "/tmp/base/iso")
            assert pushed["iso"]["session.scoped-faults"] is True
            assert pushed["iso"]["session.fair-drain"] is True
            assert "session.scoped-faults" not in pushed["iso2"]
            # the share denominator is STATIC and slot-proportional
            # (runner-slots // slots-per-job = 4), identical for every
            # tenant regardless of deploy order — a resident-count
            # stamp would hand the first tenant the whole host pool
            #
            assert pushed["iso"]["session.concurrent-jobs"] == 4
            assert pushed["iso2"]["session.concurrent-jobs"] == 4
        finally:
            disp.close()
            srv.close()


class TestAutoscaler:
    class _GW(TestAdmission._GW):
        pass

    def _mk(self, extra=None):
        conf = {"session.runner-slots": 1, "session.max-jobs": 8,
                "session.autoscale": False,  # drive ticks by hand
                "session.min-runners": 1,
                "session.scale-down-idle": "100ms"}
        conf.update(extra or {})
        return SessionDispatcher(_cluster_conf(conf))

    def test_queue_depth_pushes_provisioner_demand(self):
        disp = self._mk()
        gw = self._GW()
        srv = RpcServer(gw)
        try:
            disp.rpc_register_runner("r1", "127.0.0.1", 1, port=srv.port)
            assert disp.rpc_submit_session_job("a", "m:f", {})["admitted"]
            wait_until(lambda: disp.jobs["a"].state == "RUNNING", 10,
                       what="a running")
            assert disp.rpc_submit_session_job("b", "m:f", {})["admitted"]
            wait_until(
                lambda: disp.jobs["b"].state == "WAITING_FOR_RESOURCES",
                10, what="b queued")
            disp._autoscale_tick()
            assert disp.provisioner.requests, "no scale-out demand"
            assert disp.provisioner.requests[-1][0]["job_id"] == "b"
            snap = disp.registry.snapshot()
            assert snap["session.queued_jobs"] == 1.0
            assert snap["session.slot_pressure"] == 1.0
            assert snap["session.scale_up_requests"] >= 1
        finally:
            disp.close()
            srv.close()

    def test_full_slot_pressure_prewarms_capacity(self):
        disp = self._mk()
        gw = self._GW()
        srv = RpcServer(gw)
        try:
            disp.rpc_register_runner("r1", "127.0.0.1", 1, port=srv.port)
            assert disp.rpc_submit_session_job("a", "m:f", {})["admitted"]
            wait_until(lambda: disp.jobs["a"].state == "RUNNING", 10,
                       what="a running")
            disp._autoscale_tick()  # no queue, but every slot is used
            assert disp.provisioner.requests
            assert disp.provisioner.requests[-1][0]["job_id"] == (
                "(slot-pressure)")
        finally:
            disp.close()
            srv.close()

    def test_headroom_parked_jobs_drive_no_demand_and_allow_scale_in(
            self):
        """A job parked by max-jobs headroom cannot use new capacity:
        it must neither push provisioner demand nor pin idle runners
        alive (a tick that requested runners the admission gate would
        never let the queue use would then block their scale-in
        forever)."""
        disp = self._mk({"session.max-jobs": 1,
                         "session.runner-slots": 4})
        gw1, gw2 = self._GW(), self._GW()
        srv1, srv2 = RpcServer(gw1), RpcServer(gw2)
        try:
            disp.rpc_register_runner("r1", "127.0.0.1", 1, port=srv1.port)
            disp.rpc_register_runner("r2", "127.0.0.1", 1, port=srv2.port)
            assert disp.rpc_submit_session_job("a", "m:f", {})["admitted"]
            wait_until(lambda: disp.jobs["a"].state == "RUNNING", 10,
                       what="a running")
            assert disp.rpc_submit_session_job("b", "m:f", {})["admitted"]
            wait_until(
                lambda: disp.jobs["b"].state == "WAITING_FOR_RESOURCES",
                10, what="b parked by headroom")
            now = time.time()
            disp._autoscale_tick(now=now)
            assert not disp.provisioner.requests, (
                "headroom-parked job drove scale-out demand")
            disp._autoscale_tick(now=now + 1.0)
            # the idle runner is NOT pinned by the headroom queue
            assert len(disp.provisioner.releases) == 1
        finally:
            disp.close()
            srv1.close()
            srv2.close()

    def test_scale_out_demand_clamped_to_max_runners_budget(self):
        """session.max-runners clamps demand SIZE, not just whether a
        request fires: the provisioner is never asked for more slot
        capacity than the fleet may still grow by."""
        disp = self._mk({"session.max-jobs": 16,
                         "session.runner-slots": 1,
                         "session.max-runners": 2})
        gw = self._GW()
        srv = RpcServer(gw)
        try:
            disp.rpc_register_runner("r1", "127.0.0.1", 1, port=srv.port)
            assert disp.rpc_submit_session_job("a", "m:f", {})["admitted"]
            wait_until(lambda: disp.jobs["a"].state == "RUNNING", 10,
                       what="a running")
            for jid in ("b", "c", "d", "e"):
                assert disp.rpc_submit_session_job(
                    jid, "m:f", {})["admitted"]
            wait_until(
                lambda: disp.jobs["e"].state == "WAITING_FOR_RESOURCES",
                10, what="queue formed")
            disp._autoscale_tick()
            assert disp.provisioner.requests
            demanded = sum(d["required_devices"]
                           for d in disp.provisioner.requests[-1])
            # fleet may grow by (2 - 1) runner × 1 slot = 1
            assert demanded <= 1, disp.provisioner.requests[-1]
        finally:
            disp.close()
            srv.close()

    def test_idle_runner_drained_and_released_above_floor(self):
        disp = self._mk()
        gw1, gw2 = self._GW(), self._GW()
        srv1, srv2 = RpcServer(gw1), RpcServer(gw2)
        try:
            disp.rpc_register_runner("r1", "127.0.0.1", 1, port=srv1.port)
            disp.rpc_register_runner("r2", "127.0.0.1", 1, port=srv2.port)
            now = time.time()
            disp._autoscale_tick(now=now)          # marks idle_since
            assert not disp.provisioner.releases   # not idle long enough
            disp._autoscale_tick(now=now + 1.0)    # > 100ms idle
            # min-runners=1: exactly ONE runner drains, one stays
            assert len(disp.provisioner.releases) == 1
            drained = disp.provisioner.releases[0][0]
            assert disp.runners[drained].draining
            alive = [r for r in disp.runners.values() if not r.draining]
            assert len(alive) == 1
            # the floor holds: further ticks never drain the last one
            disp._autoscale_tick(now=now + 10.0)
            assert len(disp.provisioner.releases) == 1
        finally:
            disp.close()
            srv1.close()
            srv2.close()

    def test_busy_runner_never_drained(self):
        disp = self._mk()
        gw1, gw2 = self._GW(), self._GW()
        srv1, srv2 = RpcServer(gw1), RpcServer(gw2)
        try:
            disp.rpc_register_runner("r1", "127.0.0.1", 1, port=srv1.port)
            disp.rpc_register_runner("r2", "127.0.0.1", 1, port=srv2.port)
            assert disp.rpc_submit_session_job("a", "m:f", {})["admitted"]
            assert disp.rpc_submit_session_job("b", "m:f", {})["admitted"]
            wait_until(lambda: disp.jobs["a"].state == "RUNNING"
                       and disp.jobs["b"].state == "RUNNING", 10,
                       what="both running")
            now = time.time()
            disp._autoscale_tick(now=now)
            disp._autoscale_tick(now=now + 10.0)
            assert not disp.provisioner.releases
        finally:
            disp.close()
            srv1.close()
            srv2.close()


class TestSessionE2E:
    """Tier-1 e2e on the real plane: dispatcher + in-process runners,
    real RPC, real drivers — K=2 concurrent jobs on one shared runner
    run to completion with fully isolated checkpoints and outputs
    (the session cluster's correctness bar)."""

    def test_two_concurrent_jobs_one_runner_exactly_once(self, tmp_path):
        n = 6
        with LocalSessionCluster(_cluster_conf(), runners=1,
                                 device="cpu") as c:
            for tag in ("a", "b"):
                r = c.submit("test_torch_runner_jobs:build",
                             config=_job_conf(tmp_path, tag, n),
                             job_id=f"job-{tag}")
                assert r["admitted"], r
            # both must be RUNNING at once — concurrency, not serial
            wait_until(
                lambda: all(
                    c.dispatcher.jobs[f"job-{t}"].state == "RUNNING"
                    for t in ("a", "b")), 30,
                what="both jobs running concurrently")
            assert c.wait("job-a") == "FINISHED"
            assert c.wait("job-b") == "FINISHED"
            # one shared runner hosted both
            assert (c.dispatcher.jobs["job-a"].assigned_runners
                    == c.dispatcher.jobs["job-b"].assigned_runners)
        _golden(str(tmp_path / "sink-a"), n)
        _golden(str(tmp_path / "sink-b"), n)
        # checkpoint isolation: one namespaced subtree per tenant
        assert sorted(os.listdir(tmp_path / "chk")) == ["job-a", "job-b"]

    def test_run_session_attaches_to_running_cluster(self, tmp_path):
        """`run --session H:P` submits through the dispatcher and
        blocks until terminal — the job rides the shared cluster, not
        a private runtime."""
        from flink_tpu_torch.cli import main as cli_main

        n = 4
        with LocalSessionCluster(_cluster_conf(), runners=1,
                                 device="cpu") as c:
            conf_args = []
            for k, v in _job_conf(tmp_path, "att", n).items():
                conf_args += ["--conf", f"{k}={v}"]
            rc = cli_main(["run", "--session", c.address,
                           "--entry", "test_torch_runner_jobs:build",
                           "--job-id", "attached", *conf_args])
            assert rc == 0
            assert c.dispatcher.jobs["attached"].state == "FINISHED"
        _golden(str(tmp_path / "sink-att"), n)


class TestSessionCliContract:
    """`python -m flink_tpu_torch session ...` exit-code contract: 0 = ok,
    1 = cluster refused, 2 = usage error (argparse) — asserted like
    tests/test_cli.py TestExitCodeContract."""

    def test_usage_errors_exit_2(self, capsys):
        from flink_tpu_torch.cli import main as cli_main

        for argv in (["session"],
                     ["session", "submit"],              # no --session
                     ["session", "submit", "--session", "x:1"],  # no entry
                     ["session", "cancel", "--session", "x:1"]):  # no job
            with pytest.raises(SystemExit) as e:
                cli_main(argv)
            assert e.value.code == 2, argv
        capsys.readouterr()

    def test_ok_0_refused_1(self, tmp_path, capsys):
        from flink_tpu_torch.cli import main as cli_main

        with LocalSessionCluster(_cluster_conf(
                {"session.runner-slots": 2}), runners=1,
                device="cpu") as c:
            # 1: admission rejection (quota no runner can satisfy)
            rc = cli_main(["session", "submit", "--session", c.address,
                           "--entry", "test_torch_runner_jobs:build",
                           "--conf", "session.slots-per-job=99"])
            out = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
            assert rc == 1 and not out["admitted"]
            # 0: list
            assert cli_main(["session", "list", "--session",
                             c.address]) == 0
            out = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
            assert out["jobs"] == []
            # 1: cancel of an unknown job id is an ERROR, not a silent
            # no-op
            rc = cli_main(["session", "cancel", "--session", c.address,
                           "job-deadbeef"])
            out = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
            assert rc == 1 and not out["ok"]
            # 0: stop
            assert cli_main(["session", "stop", "--session",
                             c.address]) == 0
            capsys.readouterr()

    def test_local_cluster_honors_requested_port(self):
        """`session start --port N` must bind N, not an ephemeral
        port."""
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        with LocalSessionCluster(_cluster_conf(), runners=0,
                                 port=port, device="cpu") as c:
            assert c.port == port


class TestSessionCliSmoke:
    """CLI smoke: a REAL `session start
    --local-runners` subprocess, two bounded jobs submitted
    CONCURRENTLY via `python -m flink_tpu_torch session submit`, both
    committed outputs verified independently, then `session stop` —
    every exit code asserted."""

    def _cli(self, env, *argv):
        p = subprocess.run([sys.executable, "-m", "flink_tpu_torch", *argv],
                           env=env, capture_output=True, text=True,
                           cwd=REPO, timeout=120)
        out = p.stdout.strip().splitlines()
        return p.returncode, (json.loads(out[-1]) if out else {})

    def test_start_submit_concurrent_verify_stop(self, tmp_path):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + os.path.join(REPO, "tests")
        env["OMP_NUM_THREADS"] = "2"
        srv = subprocess.Popen(
            [sys.executable, "-m", "flink_tpu_torch", "session", "start",
             "--local-runners", "1", "--device", "cpu",
             "--conf", "heartbeat.interval=200ms"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            addr = json.loads(srv.stdout.readline())["session"]
            n = 5
            # submit both back-to-back: they run CONCURRENTLY on the
            # one local runner (runner-slots default 4)
            for tag in ("a", "b"):
                conf_args = []
                for k, v in _job_conf(tmp_path, tag, n).items():
                    conf_args += ["--conf", f"{k}={v}"]
                rc, out = self._cli(
                    env, "session", "submit", "--session", addr,
                    "--entry", "test_torch_runner_jobs:build",
                    "--job-id", f"cli-{tag}", *conf_args)
                assert rc == 0 and out["admitted"], out
            deadline = time.time() + 120
            while time.time() < deadline:
                rc, out = self._cli(env, "session", "list",
                                    "--session", addr)
                assert rc == 0
                states = {j["job_id"]: j["state"] for j in out["jobs"]}
                assert "FAILED" not in states.values(), states
                if set(states.values()) == {"FINISHED"}:
                    break
                time.sleep(0.5)
            else:
                raise AssertionError(f"jobs never finished: {states}")
            _golden(str(tmp_path / "sink-a"), n)
            _golden(str(tmp_path / "sink-b"), n)
            rc, out = self._cli(env, "session", "stop",
                                "--session", addr)
            assert rc == 0 and out["ok"]
            assert srv.wait(timeout=30) == 0
        finally:
            if srv.poll() is None:
                srv.kill()


class TestMetricsIsolation:
    """Per-job metrics isolation audit. Every
    job-facing metric registry/group is DRIVER-scoped — two concurrent
    jobs' snapshots are disjoint objects whose deterministic counters
    each match the single-job golden. The only module-level registries
    in the tree are process-PLANE observability (fault/recovery
    counters, per-topic log metrics), never job metrics; the
    structural audit below pins that allowlist so a shared counter
    cannot creep back in."""

    ALLOWED_MODULE_REGISTRIES = {
        # process-global by design: injections/recoveries are process
        # events (faults.py docstring), topic metrics are per-topic
        # groups and LOG_TOPIC_MULTI_WRITER forbids two jobs sharing a
        # topic writer; storage.enospc_retries counts a
        # PROCESS-level condition — the disk filling up is not
        # attributable to one tenant from inside the write seam
        "flink_tpu_torch.faults",
        "flink_tpu_torch.log.topic",
        "flink_tpu_torch.fs",
        # cleaner metrics are per-topic groups like log.topic's, and
        # the fenced cleaner.lease means at most one cleaner service
        # maintains a topic at a time — process-plane, not
        # per-job
        "flink_tpu_torch.log.cleaner",
    }

    def test_no_module_level_registry_outside_allowlist(self):
        import importlib
        import pkgutil

        import flink_tpu_torch
        from flink_tpu_torch.obs.metrics import MetricRegistry

        found = {}
        for m in pkgutil.walk_packages(flink_tpu_torch.__path__, "flink_tpu_torch."):
            if m.name.endswith("__main__"):
                continue  # importing it runs the CLI
            try:
                mod = importlib.import_module(m.name)
            except ImportError:
                continue  # optional-capability modules
            regs = [name for name, val in vars(mod).items()
                    if isinstance(val, MetricRegistry)]
            if regs:
                found[m.name] = regs
        stray = set(found) - self.ALLOWED_MODULE_REGISTRIES
        assert not stray, (
            f"module-level MetricRegistry outside the audited "
            f"allowlist: { {k: found[k] for k in stray} } — job metrics "
            "must live on the driver's own registry (per-job isolation)")

    DETERMINISTIC = ("records_in", "records_out", "batches",
                     "fired_windows")

    def _run_job(self, tag, results=None):
        import test_torch_runner_jobs as runner_job
        from flink_tpu_torch.api.environment import StreamExecutionEnvironment

        conf = Configuration({
            "test.n-batches": 5,
            "test.sink-dir": str(self._tmp / f"ms-{tag}"),
            "state.num-key-shards": 8,
            "state.slots-per-shard": 16,
        })
        env = StreamExecutionEnvironment(conf)
        runner_job.build(env)
        res = env.execute(f"metrics-{tag}", device="cpu")
        snap = {k: res.metrics[k] for k in self.DETERMINISTIC}
        if results is not None:
            results[tag] = snap
        return snap

    def test_concurrent_jobs_snapshots_match_single_job_golden(
            self, tmp_path):
        self._tmp = tmp_path
        golden = self._run_job("golden")
        assert golden["records_in"] > 0
        results = {}
        ts = [threading.Thread(target=self._run_job, args=(t, results))
              for t in ("c1", "c2")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert set(results) == {"c1", "c2"}
        # disjoint registries: neither job's counters absorbed the
        # other's records — each equals the single-job golden exactly
        assert results["c1"] == golden
        assert results["c2"] == golden


class TestAgainstTheReference:
    """The reference's dispatcher and the port's, driven through the
    same submissions, capacity and autoscaler ticks, reply and decide
    alike; the two packages' drain gates grant the same turns in the
    same order."""

    @staticmethod
    def _packages():
        from flink_tpu.runtime import session as ref_session
        from flink_tpu_torch.runtime import session as port_session

        return (("reference", ref_session), ("port", port_session))

    @staticmethod
    def _conf(mod, extra):
        cfg = {"heartbeat.interval": "200ms", "heartbeat.timeout": "60s",
               "session.autoscale": False}
        cfg.update(extra)
        conf_mod = __import__(mod.__name__.split(".")[0] + ".config",
                              fromlist=["Configuration"])
        return conf_mod.Configuration(cfg)

    SUBMISSIONS = (
        ("a", "m:f", {"session.slots-per-job": 0}),
        ("b", "m:f", {"session.slots-per-job": 3}),
        ("c", "m:f", {"session.slots-per-job": "two"}),
        ("d", "m:f", {}),
        ("d", "m:f", {}),
        ("d", "other:g", {}),
        ("e", "m:f", {"session.slots-per-job": 2,
                      "execution.checkpointing.dir": "/base"}),
        ("f", "m:f", {"faults.inject": "checkpoint.storage.write=raise x1"}),
        ("g", "m:f", {"session.fair-drain": False}),
    )

    def _admit(self, mod):
        disp = mod.SessionDispatcher(self._conf(mod, {
            "session.runner-slots": 2, "session.max-jobs": 2}))
        try:
            replies = [disp.rpc_submit_session_job(j, e, dict(c))
                       for j, e, c in self.SUBMISSIONS]
            with disp._lock:
                queue = disp._waiting_locked()
            view = [{k: v for k, v in j.items()
                     if k not in ("submitted_at", "started_at",
                                  "finished_at")}
                    for j in disp.rpc_session_jobs()["jobs"]]
            configs = {j: dict(disp.jobs[j].config) for j in disp.jobs}
            cancel = disp.rpc_cancel_job("e")
            stop = disp.rpc_stop_session()
            late = disp.rpc_submit_session_job("h", "m:f", {})
            info = disp.rpc_session_info()
            info.pop("metrics")
            return dict(replies=replies, queue=queue, view=view,
                        configs=configs, cancel=cancel, stop=stop,
                        late=late, info=info)
        finally:
            disp.close()

    def test_admission_replies_equal(self):
        (_, ref), (_, port) = self._packages()
        got_ref, got_port = self._admit(ref), self._admit(port)
        assert got_port == got_ref
        # the run reached every branch of the admission path
        reasons = [r.get("reason", "") for r in got_ref["replies"]]
        assert "below 1" in reasons[0] and "runner-slots" in reasons[1]
        assert "integer" in reasons[2] and got_ref["replies"][4].get(
            "duplicate")
        assert "already active" in reasons[5]
        assert got_ref["late"]["reason"] == "session cluster is stopping"

    def _autoscale(self, mod):
        disp = mod.SessionDispatcher(self._conf(mod, {
            "session.runner-slots": 1, "session.max-jobs": 3,
            "session.min-runners": 1, "session.max-runners": 3,
            "session.scale-down-idle": "100ms"}))
        gws = []
        try:
            for rid in ("r1", "r2"):
                gw = TestAdmission._GW()
                srv = RpcServer(gw)
                gws.append(srv)
                disp.rpc_register_runner(rid, "127.0.0.1", 1, port=srv.port)
            now = 1000.0
            trace = []

            def tick(dt):
                disp._autoscale_tick(now=now + dt)
                trace.append((dt, len(disp.provisioner.requests),
                              len(disp.provisioner.releases),
                              {k: v for k, v in
                               disp.registry.snapshot().items()
                               if k.startswith("session.")}))

            tick(0.0)
            for jid in ("a", "b"):
                assert disp.rpc_submit_session_job(jid, "m:f", {})[
                    "admitted"]
                wait_until(lambda: disp.jobs[jid].state == "RUNNING", 10,
                           what=f"{jid} running")
            tick(0.05)
            for jid in ("c", "d"):
                assert disp.rpc_submit_session_job(jid, "m:f", {})[
                    "admitted"]
            wait_until(lambda: disp.jobs["d"].state
                       == "WAITING_FOR_RESOURCES", 10, what="d queued")
            tick(0.2)
            disp.rpc_finish_job("a", attempt=1)
            wait_until(lambda: disp.jobs["c"].state == "RUNNING", 10,
                       what="c admitted")
            tick(0.4)
            disp.rpc_finish_job("b", attempt=1)
            wait_until(lambda: disp.jobs["d"].state == "RUNNING", 10,
                       what="d admitted")
            for jid in ("c", "d"):
                disp.rpc_finish_job(jid, attempt=1)
            for dt in (1.0, 1.05, 2.0, 3.0):
                tick(dt)
            placed = {j: list(disp.jobs[j].assigned_runners)
                      for j in ("a", "b", "c", "d")}
            return dict(requests=disp.provisioner.requests,
                        releases=disp.provisioner.releases,
                        trace=trace, placed=placed,
                        draining=sorted(r.runner_id for r in
                                        disp.runners.values()
                                        if r.draining))
        finally:
            disp.close()
            for srv in gws:
                srv.close()

    def test_autoscaler_decisions_equal_on_one_tick_sequence(self):
        (_, ref), (_, port) = self._packages()
        got_ref, got_port = self._autoscale(ref), self._autoscale(port)
        assert got_port == got_ref
        demands = [d["job_id"] for r in got_ref["requests"] for d in r]
        assert "(slot-pressure)" in demands and "c" in demands
        assert got_ref["releases"] == [["r1"]]

    def _grants(self, mod):
        """A holder, three waiters queued in a fixed order, two of them
        re-requesting at once after their turn: the gate's grant
        order."""
        import threading

        g = mod.FairDrainGate()
        for t in ("burst", "w1", "w2", "w3"):
            g.register(t)
        order, lock = [], threading.Lock()
        release = threading.Event()

        def take(token, times, hold=None):
            for _ in range(times):
                with g.turn(token):
                    with lock:
                        order.append(token)
                    if hold is not None:
                        hold.wait(5)
                        hold = None

        holder = threading.Thread(target=take, args=("burst", 3, release))
        holder.start()
        wait_until(lambda: g._holder == "burst", 5, what="burst holds")
        waiters = []
        for token, times in (("w1", 2), ("w2", 1), ("w3", 2)):
            n = len(g._queue)
            t = threading.Thread(target=take, args=(token, times))
            t.start()
            waiters.append(t)
            wait_until(lambda n=n: len(g._queue) == n + 1, 5,
                       what=f"{token} queued")
        release.set()
        for t in [holder, *waiters]:
            t.join(10)
        for t in ("burst", "w1", "w2", "w3"):
            g.unregister(t)
        assert g.members == 0
        return order

    def test_gate_grant_order_equal(self):
        (_, ref), (_, port) = self._packages()
        got_ref = self._grants(ref)
        assert self._grants(port) == got_ref
        assert got_ref[:4] == ["burst", "w1", "w2", "w3"]
        assert sorted(got_ref) == sorted(
            ["burst"] * 3 + ["w1"] * 2 + ["w2"] + ["w3"] * 2)
