"""``tests/test_control_plane.py`` against the port: RPC, heartbeats and
failure detection, restart strategies, supervised recovery, slot
allocation and the execution graph, active provisioning and the drain,
retry idempotence and the fault plan's config lifecycle, every case on
the port's ``runtime/rpc.py``, ``coordinator.py``, ``runner.py``,
``scheduler.py`` and ``provisioner.py`` (a task runner made in process
runs its jobs on the CPU, ``device="cpu"``). The reference runs the same
cases in that file; ``TestAcrossThePackages`` holds the two packages'
replies equal on one wire: a reference client driving a port
coordinator, a port runner registering with a reference coordinator."""
import time

import numpy as np
import pytest

from flink_tpu_torch.config import Configuration
from flink_tpu_torch.runtime.coordinator import JobCoordinator, start_coordinator
from flink_tpu_torch.runtime.restart import (
    ExponentialDelayRestartStrategy,
    FailureRateRestartStrategy,
    FixedDelayRestartStrategy,
    NoRestartStrategy,
)
from flink_tpu_torch.runtime.rpc import RpcClient, RpcEndpoint, RpcError, RpcServer


class TestRpc:
    def test_call_roundtrip_and_errors(self):
        class Echo(RpcEndpoint):
            def rpc_echo(self, x):
                return {"got": x}

            def rpc_boom(self):
                raise ValueError("nope")

        srv = RpcServer(Echo())
        try:
            c = RpcClient("127.0.0.1", srv.port)
            assert c.call("echo", x=[1, 2]) == {"got": [1, 2]}
            with pytest.raises(RpcError, match="nope"):
                c.call("boom")
            with pytest.raises(RpcError, match="no such method"):
                c.call("missing")
            c.close()
        finally:
            srv.close()

    def test_single_threaded_dispatch(self):
        """Concurrent calls serialize on the endpoint thread — the
        main-thread discipline means no endpoint locks needed."""
        import threading

        class Count(RpcEndpoint):
            def __init__(self):
                self.v = 0

            def rpc_bump(self):
                cur = self.v
                time.sleep(0.001)  # a data race would lose increments
                self.v = cur + 1
                return self.v

        ep = Count()
        srv = RpcServer(ep)
        try:
            def worker():
                c = RpcClient("127.0.0.1", srv.port)
                for _ in range(10):
                    c.call("bump")
                c.close()

            ts = [threading.Thread(target=worker) for _ in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert ep.v == 40
        finally:
            srv.close()


class TestCoordinator:
    def test_register_submit_status(self):
        srv = start_coordinator(Configuration({"heartbeat.timeout": 500}))
        try:
            c = RpcClient("127.0.0.1", srv.port)
            r = c.call("register_runner", runner_id="r1", host="h1", n_devices=8)
            assert r["heartbeat_interval_ms"] > 0
            assert c.call("submit_job", job_id="j1")["assigned"] == ["r1"]
            assert c.call("job_status", job_id="j1")["state"] == "RUNNING"
            c.call("finish_job", job_id="j1")
            assert c.call("job_status", job_id="j1")["state"] == "FINISHED"
        finally:
            srv.close()

    def test_heartbeat_timeout_marks_runner_dead_and_restarts_job(self):
        srv = start_coordinator(Configuration({"heartbeat.timeout": 300}))
        try:
            c = RpcClient("127.0.0.1", srv.port)
            c.call("register_runner", runner_id="r1", host="h1", n_devices=8)
            c.call("submit_job", job_id="j1")
            assert c.call("heartbeat", runner_id="r1")["known"]
            deadline = time.time() + 3
            while time.time() < deadline:
                rs = c.call("list_runners")
                if not rs["r1"]["alive"]:
                    break
                time.sleep(0.05)
            assert not c.call("list_runners")["r1"]["alive"]
            st = c.call("job_status", job_id="j1")
            assert st["state"] == "RESTARTING"
        finally:
            srv.close()

    def test_deploy_transport_drop_routes_failure(self):
        """Chaos-seam regression: faults `drop`-kind rules
        raise ConnectionError, NOT RpcError — the coordinator.deploy
        point fires before the client's RpcError wrapping, so the
        deploy catch must handle both or an injected transport drop
        kills the deploy thread silently and the job parks forever."""
        from flink_tpu_torch import faults

        class _Gw(RpcEndpoint):
            def __init__(self):
                self.jobs = []

            def rpc_run_job(self, **kw):
                self.jobs.append(kw)
                return {"accepted": True}

        # two gateways: the failure handler EXCLUDES the runner whose
        # push died, so the routed restart lands on the second
        gws = [_Gw(), _Gw()]
        gw_srvs = [RpcServer(g) for g in gws]
        srv = start_coordinator(Configuration({
            "heartbeat.timeout": 60_000,  # fake runners never beat
            "restart-strategy.type": "fixed-delay",
            "restart-strategy.fixed-delay.attempts": 3,
            "restart-strategy.fixed-delay.delay": 10}))
        plan = faults.FaultPlan(seed=1).rule(
            "coordinator.deploy", "drop", count=1)
        try:
            c = RpcClient("127.0.0.1", srv.port)
            for i, gs in enumerate(gw_srvs):
                c.call("register_runner", runner_id=f"r{i}",
                       host="127.0.0.1", n_devices=1, port=gs.port)
            with plan.activate():
                c.call("submit_job", job_id="j-drop",
                       entry="runner_job:build")
                deadline = time.time() + 5
                while (time.time() < deadline
                       and not any(g.jobs for g in gws)):
                    time.sleep(0.05)
            assert plan.log, "the drop never fired"
            landed = [kw for g in gws for kw in g.jobs]
            assert landed, (
                "deploy thread died on the injected ConnectionError — "
                "the failure was never routed to a restart")
            assert landed[0]["job_id"] == "j-drop"
        finally:
            srv.close()
            for gs in gw_srvs:
                gs.close()

    def test_report_failure_restart_then_fail(self):
        srv = start_coordinator(Configuration({
            "restart-strategy.type": "fixed-delay",
            "restart-strategy.fixed-delay.attempts": 2,
            "restart-strategy.fixed-delay.delay": 10}))
        try:
            c = RpcClient("127.0.0.1", srv.port)
            c.call("register_runner", runner_id="r1", host="h", n_devices=1)
            c.call("submit_job", job_id="j")
            a1 = c.call("report_failure", job_id="j", error="e1")
            assert a1["action"] == "restart" and a1["restore"] == "latest"
            a2 = c.call("report_failure", job_id="j", error="e2")
            assert a2["action"] == "restart"
            a3 = c.call("report_failure", job_id="j", error="e3")
            assert a3["action"] == "fail"
            assert c.call("job_status", job_id="j")["state"] == "FAILED"
        finally:
            srv.close()


class TestRestartStrategies:
    def test_fixed_delay(self):
        s = FixedDelayRestartStrategy(max_attempts=2, delay_ms=5)
        assert s.can_restart() and s.next_delay_ms() == 5
        assert s.can_restart() and s.next_delay_ms() == 5
        assert not s.can_restart()

    def test_exponential(self):
        s = ExponentialDelayRestartStrategy(initial_ms=100, max_ms=400)
        assert s.next_delay_ms() == 100
        assert s.next_delay_ms() == 200
        assert s.next_delay_ms() == 400
        assert s.next_delay_ms() == 400  # capped

    def test_failure_rate(self):
        s = FailureRateRestartStrategy(max_failures=2, interval_ms=60_000,
                                       delay_ms=1)
        assert s.can_restart(); s.next_delay_ms()
        assert s.can_restart(); s.next_delay_ms()
        assert not s.can_restart()

    def test_none(self):
        assert not NoRestartStrategy().can_restart()


class TestSupervisedRecovery:
    def test_run_with_recovery_resumes_exactly_once(self, tmp_path):
        from flink_tpu_torch.api.environment import StreamExecutionEnvironment
        from flink_tpu_torch.api.sinks import TransactionalCollectSink
        from flink_tpu_torch.api.sources import GeneratorSource
        from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
        from flink_tpu_torch.runtime.supervisor import run_with_recovery
        from flink_tpu_torch.time.watermarks import WatermarkStrategy

        sink = TransactionalCollectSink()
        crashes = {"left": 2}

        def gen(split, i):
            if i >= 8:
                return None
            if i == 5 and crashes["left"] > 0:
                crashes["left"] -= 1
                raise RuntimeError("flaky task")
            rng = np.random.default_rng(i)
            return ({"k": rng.integers(0, 4, 64).astype(np.int64)},
                    np.sort(rng.integers(i * 300, i * 300 + 600, 64)).astype(np.int64))

        conf = Configuration({
            "state.num-key-shards": 8, "state.slots-per-shard": 32,
            "pipeline.microbatch-size": 64,
            "execution.checkpointing.dir": str(tmp_path),
            "execution.checkpointing.interval": 1,
            "restart-strategy.type": "fixed-delay",
            "restart-strategy.fixed-delay.attempts": 3,
            "restart-strategy.fixed-delay.delay": 1,
        })

        def build(c):
            env = StreamExecutionEnvironment(c)
            (env.from_source(GeneratorSource(gen),
                             WatermarkStrategy.for_bounded_out_of_orderness(600))
             .key_by("k").window(TumblingEventTimeWindows.of(1000)).count()
             .add_sink(sink))
            return env

        res = run_with_recovery(build, conf, "supervised", device="cpu")
        golden = {}
        for i in range(8):
            rng = np.random.default_rng(i)
            ks = rng.integers(0, 4, 64).astype(np.int64)
            ts = np.sort(rng.integers(i * 300, i * 300 + 600, 64)).astype(np.int64)
            for k, t in zip(ks, ts):
                kk = (int(k), (int(t) // 1000) * 1000)
                golden[kk] = golden.get(kk, 0) + 1
        got = {}
        for r in sink.committed:
            kk = (int(r["key"]), int(r["window_start"]))
            assert kk not in got, f"duplicate {kk}"
            got[kk] = int(r["count"])
        assert got == golden
        assert crashes["left"] == 0  # actually crashed twice


class TestRunnerLossRestartBudget:
    def test_runner_loss_respects_restart_budget(self):
        """Heartbeat-timeout failovers must consume the same restart
        budget as reported failures — with attempts exhausted, runner
        loss FAILs the job instead of restarting unboundedly (ref:
        ExecutionFailureHandler routing every failure through the
        RestartBackoffTimeStrategy)."""
        import time as _t

        from flink_tpu_torch.runtime.coordinator import start_coordinator
        from flink_tpu_torch.runtime.rpc import RpcClient

        srv = start_coordinator(Configuration({
            "heartbeat.timeout": 500,
            "restart-strategy.type": "fixed-delay",
            "restart-strategy.fixed-delay.attempts": 1,
            "restart-strategy.fixed-delay.delay": 10}))
        try:
            c = RpcClient("127.0.0.1", srv.port)
            c.call("register_runner", runner_id="r1", host="h1", n_devices=8)
            c.call("submit_job", job_id="j1")
            # burn the single allowed restart via a reported failure,
            # heartbeating first so the monitor can't race us to it
            c.call("heartbeat", runner_id="r1")
            assert c.call("report_failure", job_id="j1",
                          error="boom")["action"] == "restart"
            # job back to RUNNING for the next attempt (under the
            # endpoint lock — the monitor thread reads this state)
            with srv.endpoint._lock:
                srv.endpoint.jobs["j1"].state = "RUNNING"
            deadline = _t.time() + 5
            while _t.time() < deadline:
                if c.call("job_status", job_id="j1")["state"] == "FAILED":
                    break
                _t.sleep(0.05)
            assert c.call("job_status", job_id="j1")["state"] == "FAILED"
        finally:
            srv.close()


class TestSchedulerExecutionGraph:
    """Slot allocation + ExecutionGraph (ref: DefaultScheduler /
    ExecutionSlotAllocator / ExecutionGraph attempt bookkeeping)."""

    class _FakeRunnerGateway(RpcEndpoint):
        """Accepts run_job and records deployments (the
        TestingTaskExecutorGateway pattern)."""

        def __init__(self):
            self.deployed = []

        def rpc_run_job(self, job_id, entry, config=None, attempt=1, **kw):
            self.deployed.append((job_id, attempt))
            return {"accepted": True}

        def rpc_cancel_job(self, job_id):
            return {"ok": True}

    def _register(self, coord_client, gw_port, rid, n_devices):
        coord_client.call("register_runner", runner_id=rid,
                          host="127.0.0.1", n_devices=n_devices,
                          port=gw_port)

    def test_best_fit_slot_allocation(self):
        srv = start_coordinator(Configuration({}))
        gw_small = RpcServer(self._FakeRunnerGateway())
        gw_big = RpcServer(self._FakeRunnerGateway())
        try:
            c = RpcClient("127.0.0.1", srv.port)
            self._register(c, gw_small.port, "small", 2)
            self._register(c, gw_big.port, "big", 8)
            # a 2-device job best-fits the SMALL runner, leaving the big
            # one free for big jobs
            c.call("submit_job", job_id="j2", entry="x:y",
                   config={"cluster.mesh-devices": "2"})
            deadline = time.time() + 5
            while time.time() < deadline and not gw_small.endpoint.deployed:
                time.sleep(0.02)
            assert gw_small.endpoint.deployed == [("j2", 1)]
            assert not gw_big.endpoint.deployed
            # an 8-device job only fits the big runner
            c.call("submit_job", job_id="j8", entry="x:y",
                   config={"cluster.mesh-devices": "8"})
            deadline = time.time() + 5
            while time.time() < deadline and not gw_big.endpoint.deployed:
                time.sleep(0.02)
            assert gw_big.endpoint.deployed == [("j8", 1)]
            c.close()
        finally:
            srv.close(); gw_small.close(); gw_big.close()

    def test_waiting_for_resources_then_deploy_on_register(self):
        srv = start_coordinator(Configuration({}))
        gw = RpcServer(self._FakeRunnerGateway())
        try:
            c = RpcClient("127.0.0.1", srv.port)
            c.call("submit_job", job_id="j", entry="x:y",
                   config={"cluster.mesh-devices": "4"})
            deadline = time.time() + 5
            while time.time() < deadline:
                st = c.call("job_status", job_id="j")
                if st["state"] == "WAITING_FOR_RESOURCES":
                    break
                time.sleep(0.02)
            assert st["state"] == "WAITING_FOR_RESOURCES"
            # capacity arrives -> deploys
            self._register(c, gw.port, "r1", 8)
            deadline = time.time() + 5
            while time.time() < deadline and not gw.endpoint.deployed:
                time.sleep(0.02)
            assert gw.endpoint.deployed == [("j", 1)]
            deadline = time.time() + 5
            while time.time() < deadline:
                if c.call("job_status", job_id="j")["state"] == "RUNNING":
                    break
                time.sleep(0.02)
            assert c.call("job_status", job_id="j")["state"] == "RUNNING"
            c.close()
        finally:
            srv.close(); gw.close()

    def test_execution_graph_materializes_from_reported_plan(self):
        srv = start_coordinator(Configuration({}))
        gw = RpcServer(self._FakeRunnerGateway())
        try:
            c = RpcClient("127.0.0.1", srv.port)
            self._register(c, gw.port, "r1", 4)
            c.call("submit_job", job_id="j", entry="x:y",
                   config={"cluster.mesh-devices": "2"})
            deadline = time.time() + 5
            while time.time() < deadline and not gw.endpoint.deployed:
                time.sleep(0.02)
            # the runner reports its compiled stages
            c.call("report_plan", job_id="j",
                   stages=["source:bids", "window:hot", "sink:out"])
            eg = c.call("execution_graph", job_id="j")
            assert eg["found"]
            assert eg["stages"] == ["source:bids", "window:hot", "sink:out"]
            assert eg["parallelism"] == 2
            assert len(eg["vertices"]) == 6  # 3 stages x 2 subtasks
            states = {a["state"] for v in eg["vertices"]
                      for a in v["attempts"]}
            assert states <= {"RUNNING", "DEPLOYING"}
            runners = {a["runner"] for v in eg["vertices"]
                       for a in v["attempts"]}
            assert runners == {"r1"}
            c.close()
        finally:
            srv.close(); gw.close()

    def test_slots_released_on_finish(self):
        srv = start_coordinator(Configuration({}))
        gw = RpcServer(self._FakeRunnerGateway())
        try:
            c = RpcClient("127.0.0.1", srv.port)
            self._register(c, gw.port, "r1", 2)
            c.call("submit_job", job_id="a", entry="x:y",
                   config={"cluster.mesh-devices": "2"})
            deadline = time.time() + 5
            while time.time() < deadline and not gw.endpoint.deployed:
                time.sleep(0.02)
            # second 2-device job cannot fit until the first finishes
            c.call("submit_job", job_id="b", entry="x:y",
                   config={"cluster.mesh-devices": "2"})
            time.sleep(0.3)
            assert c.call("job_status",
                          job_id="b")["state"] == "WAITING_FOR_RESOURCES"
            c.call("finish_job", job_id="a")  # freed slots kick the queue
            deadline = time.time() + 5
            while time.time() < deadline:
                if ("b", 1) in gw.endpoint.deployed:
                    break
                time.sleep(0.02)
            assert ("b", 1) in gw.endpoint.deployed
            c.close()
        finally:
            srv.close(); gw.close()

    def test_mesh_devices_all_reserves_whole_runner(self):
        srv = start_coordinator(Configuration({}))
        gw = RpcServer(self._FakeRunnerGateway())
        try:
            c = RpcClient("127.0.0.1", srv.port)
            self._register(c, gw.port, "r1", 8)
            c.call("submit_job", job_id="whole", entry="x:y",
                   config={"cluster.mesh-devices": "all"})
            deadline = time.time() + 5
            while time.time() < deadline and not gw.endpoint.deployed:
                time.sleep(0.02)
            assert ("whole", 1) in gw.endpoint.deployed
            # runner is fully reserved: a 1-device job must now wait
            c.call("submit_job", job_id="one", entry="x:y",
                   config={"cluster.mesh-devices": "1"})
            time.sleep(0.3)
            assert c.call("job_status",
                          job_id="one")["state"] == "WAITING_FOR_RESOURCES"
            c.close()
        finally:
            srv.close(); gw.close()


class TestActiveProvisioning:
    """Provisioner seam + scale-in drain (ref: ActiveResourceManager,
    SURVEY §3.5)."""

    class _GW(RpcEndpoint):
        def __init__(self):
            self.deployed = []
            self.savepoints = []

        def rpc_run_job(self, job_id, entry, config=None, attempt=1, **kw):
            self.deployed.append((job_id, attempt))
            return {"accepted": True}

        def rpc_cancel_job(self, job_id, attempt=None):
            return {"ok": True}

        def rpc_trigger_savepoint(self, job_id, stop=False, token=None):
            self.savepoints.append((job_id, stop, token))
            return {"ok": True}

    def _register(self, c, port, rid, n):
        c.call("register_runner", runner_id=rid, host="127.0.0.1",
               n_devices=n, port=port)

    def test_unmet_demand_reaches_provisioner(self):
        from flink_tpu_torch.runtime.provisioner import KubectlScaleProvisioner

        srv = start_coordinator(Configuration({}))
        prov = KubectlScaleProvisioner(dry_run=True)
        srv.endpoint.provisioner = prov
        try:
            c = RpcClient("127.0.0.1", srv.port)
            c.call("submit_job", job_id="jw", entry="x:y",
                   config={"cluster.mesh-devices": "4"})
            deadline = time.time() + 5
            while time.time() < deadline and not prov.commands:
                time.sleep(0.02)
            assert prov.commands, "provisioner never saw the demand"
            assert prov.commands[0][:2] == ["kubectl", "-n"]
            assert any("--replicas=" in a for a in prov.commands[0])
            c.close()
        finally:
            srv.close()

    def test_drain_moves_job_via_stop_with_savepoint(self):
        """Drain r1: its job stop-with-savepoints; on savepoint
        completion it redeploys on r2 (never back on the draining
        runner) restoring from the savepoint."""
        srv = start_coordinator(Configuration({}))
        gw1, gw2 = RpcServer(self._GW()), RpcServer(self._GW())
        try:
            c = RpcClient("127.0.0.1", srv.port)
            self._register(c, gw1.port, "r1", 4)
            c.call("submit_job", job_id="jd", entry="x:y",
                   config={"cluster.mesh-devices": "2"})
            deadline = time.time() + 5
            while time.time() < deadline and not gw1.endpoint.deployed:
                time.sleep(0.02)
            assert gw1.endpoint.deployed == [("jd", 1)]
            # second runner appears; drain the first
            self._register(c, gw2.port, "r2", 4)
            resp = c.call("drain_runner", runner_id="r1")
            assert resp["ok"] and resp["moving_jobs"] == ["jd"]
            deadline = time.time() + 5
            while time.time() < deadline and not gw1.endpoint.savepoints:
                time.sleep(0.02)
            jid, stop, token = gw1.endpoint.savepoints[0]
            assert (jid, stop) == ("jd", True) and token.startswith("drain-")
            # the runner reports the savepoint durable -> redeploy on r2
            c.call("savepoint_complete", job_id="jd",
                   path="/tmp/sp-jd", token=token)
            deadline = time.time() + 5
            while time.time() < deadline and not gw2.endpoint.deployed:
                time.sleep(0.02)
            assert gw2.endpoint.deployed == [("jd", 2)]
            assert not gw1.endpoint.deployed[1:], \
                "job must not redeploy on the draining runner"
            st = c.call("job_status", job_id="jd")
            assert st["state"] in ("RESTARTING", "RUNNING")
            # a drained runner receives no NEW jobs either
            c.call("submit_job", job_id="jn", entry="x:y",
                   config={"cluster.mesh-devices": "2"})
            deadline = time.time() + 5
            while time.time() < deadline and \
                    ("jn", 1) not in gw2.endpoint.deployed:
                time.sleep(0.02)
            assert ("jn", 1) in gw2.endpoint.deployed
            assert all(j != "jn" for j, _ in gw1.endpoint.deployed)
            c.close()
        finally:
            srv.close(); gw1.close(); gw2.close()


class TestRetryIdempotence:
    """The RpcClient transport retry re-delivers requests whose response
    was lost; the deploy/savepoint surfaces must absorb duplicates, not
    re-execute or fail them."""

    def test_run_job_duplicate_of_completed_push_not_reexecuted(self):
        from flink_tpu_torch.runtime.runner import TaskRunner

        r = TaskRunner("127.0.0.1", 1, runner_id="idem", device="cpu")
        # the push ran to completion and its record was popped; the
        # token-keyed tombstone is what's left
        r._done_attempts[("j1", 3, "tok-abc")] = True
        resp = r.rpc_run_job(job_id="j1", entry="x:y", attempt=3,
                             deploy_token="tok-abc")
        assert resp == {"accepted": True, "runner_id": "idem",
                        "duplicate": True}
        assert "j1" not in r._jobs  # nothing re-spawned

    def test_fresh_submission_of_finished_job_id_still_runs(self):
        """A NEW submission reusing a finished job's id carries a fresh
        deploy token and must execute, not be swallowed by the old
        push's tombstone."""
        from flink_tpu_torch.runtime.runner import TaskRunner

        r = TaskRunner("127.0.0.1", 1, runner_id="idem4", device="cpu")
        r._done_attempts[("nightly", 1, "tok-old")] = True
        resp = r.rpc_run_job(job_id="nightly", entry="x:y", attempt=1,
                             deploy_token="tok-new")
        assert resp["accepted"] and not resp.get("duplicate")
        assert "nightly" in r._jobs  # a real worker thread was spawned
        r._jobs["nightly"]["cancel"].set()
        r._jobs["nightly"]["thread"].join(timeout=30)

    def test_run_job_duplicate_of_running_attempt_accepted(self):
        import threading

        from flink_tpu_torch.runtime.runner import SavepointRequest, TaskRunner

        r = TaskRunner("127.0.0.1", 1, runner_id="idem2", device="cpu")
        r._jobs["j2"] = {"cancel": threading.Event(), "attempt": 2,
                         "savepoint": SavepointRequest(r, "j2"),
                         "config": {}}
        resp = r.rpc_run_job(job_id="j2", entry="x:y", attempt=2)
        assert resp["accepted"] and resp.get("duplicate")
        # a STALE attempt is still rejected
        assert not r.rpc_run_job(job_id="j2", entry="x:y",
                                 attempt=1)["accepted"]

    def test_trigger_savepoint_duplicate_request_is_ok(self):
        import threading

        from flink_tpu_torch.runtime.runner import SavepointRequest, TaskRunner

        r = TaskRunner("127.0.0.1", 1, runner_id="idem3", device="cpu")
        r._jobs["j3"] = {
            "cancel": threading.Event(), "attempt": 1,
            "savepoint": SavepointRequest(r, "j3"),
            "config": {"execution.checkpointing.interval": 1000},
        }
        assert r.rpc_trigger_savepoint("j3", stop=True,
                                       token="tok-1")["ok"]
        # same request re-delivered (transport retry): absorbed as ok
        dup = r.rpc_trigger_savepoint("j3", stop=True, token="tok-1")
        assert dup["ok"] and dup.get("duplicate")
        # a DIFFERENT request while one is pending: still refused
        assert not r.rpc_trigger_savepoint("j3", stop=False,
                                           token="tok-2")["ok"]


class TestFaultPlanConfigLifecycle:
    def test_empty_spec_uninstalls_config_plan(self):
        from flink_tpu_torch import faults

        chaos = Configuration({"faults.inject": "rpc.client.send=drop x1",
                               "faults.seed": 5})
        clean = Configuration({})
        try:
            assert faults.install_from_config(chaos) is not None
            assert faults.active_plan() is not None
            # the next job's config has no faults.*: the plan must not
            # leak into it
            assert faults.install_from_config(clean) is None
            assert faults.active_plan() is None
        finally:
            faults.clear()

    def test_empty_spec_leaves_test_activated_plan_alone(self):
        from flink_tpu_torch import faults

        plan = faults.FaultPlan(seed=1).rule("x.y", "raise")
        with plan.activate():
            assert faults.install_from_config(Configuration({})) is None
            assert faults.active_plan() is plan


class TestAcrossThePackages:
    """One wire: the reference's RPC client against the port's
    coordinator, and the port's task runner against the reference's
    coordinator, each reply equal to the same package's own."""

    def _script(self, c):
        replies = [c.call("register_runner", runner_id="r1", host="h1",
                          n_devices=8)]
        replies.append(c.call("submit_job", job_id="j1"))
        replies.append(c.call("job_status", job_id="j1")["state"])
        replies.append(c.call("heartbeat", runner_id="r1", jobs=["j1"]))
        replies.append(c.call("report_failure", job_id="j1", error="e"))
        replies.append(c.call("finish_job", job_id="j1"))
        replies.append(c.call("job_status", job_id="j1")["state"])
        replies.append(sorted(c.call("list_jobs")))
        with pytest.raises(Exception, match="no such method"):
            c.call("missing")
        return replies

    def test_a_reference_client_drives_a_port_coordinator(self):
        from flink_tpu.config import Configuration as JaxConfiguration
        from flink_tpu.runtime.coordinator import (
            start_coordinator as jax_start_coordinator)
        from flink_tpu.runtime.rpc import RpcClient as JaxRpcClient

        conf = {"restart-strategy.type": "fixed-delay",
                "restart-strategy.fixed-delay.attempts": 2,
                "restart-strategy.fixed-delay.delay": 10}
        got = {}
        for name, srv in (
                ("port", start_coordinator(Configuration(conf))),
                ("jax", jax_start_coordinator(JaxConfiguration(conf)))):
            try:
                c = JaxRpcClient("127.0.0.1", srv.port)
                got[name] = self._script(c)
                c.close()
            finally:
                srv.close()
        assert got["port"] == got["jax"]
        assert got["port"][2] == "RUNNING" and got["port"][6] == "FINISHED"

    def test_a_port_runner_registers_with_a_reference_coordinator(self):
        """A port task runner (on the CPU) registers with either
        package's coordinator, heartbeats, answers its ping and is
        listed alike by both."""
        from flink_tpu.config import Configuration as JaxConfiguration
        from flink_tpu.runtime.coordinator import (
            start_coordinator as jax_start_coordinator)
        from flink_tpu_torch.runtime.runner import TaskRunner

        conf = {"heartbeat.interval": "100ms", "heartbeat.timeout": "5s"}
        got = {}
        for name, srv in (
                ("port", start_coordinator(Configuration(conf))),
                ("jax", jax_start_coordinator(JaxConfiguration(conf)))):
            runner = TaskRunner("127.0.0.1", srv.port, runner_id="pr",
                                device="cpu")
            try:
                gw = runner.start()
                c = RpcClient("127.0.0.1", srv.port)
                deadline = time.time() + 10
                while time.time() < deadline:
                    beat = srv.endpoint.runners["pr"].last_heartbeat
                    time.sleep(0.25)
                    if srv.endpoint.runners["pr"].last_heartbeat > beat:
                        break
                info = c.call("list_runners")["pr"]
                g = RpcClient("127.0.0.1", gw)
                got[name] = (
                    {k: v for k, v in info.items()
                     if k not in ("last_heartbeat", "port")},
                    g.call("ping"), c.call("heartbeat", runner_id="pr"))
                g.close()
                c.close()
            finally:
                runner.close()
                srv.close()
        assert got["port"] == got["jax"]
        assert got["port"][0]["n_devices"] == 1 and got["port"][0]["alive"]
