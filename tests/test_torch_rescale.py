"""``tests/test_rescale.py`` against the port: live rescale at a new mesh width through the port's coordinator against
a real port runner process (``--device cpu --cpu-devices 8``: eight
blocks of the one CPU, the reference's forced host devices), Q5's count
plane rescaled 1 -> 2 -> 1 processes exactly once (the savepoint set cut
at one rendezvous step, key-group ranges repartitioned at restore), a
runner killed mid-rescale, the rescale lifecycle, the reactive
controller under a fake clock, the chaos phases of the handshake and a
leader takeover that resumes an armed rescale from the HA job store."""
import os
import signal
import subprocess
import sys
import time

import pytest

from flink_tpu_torch.api.sinks import FileTransactionalSink
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.runtime.coordinator import JobCoordinator
from flink_tpu_torch.runtime.rpc import RpcServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn_mesh_runner(coord_port: int, runner_id: str,
                      devices: int = 8) -> subprocess.Popen:
    """A port runner offering ``devices`` blocks of the one CPU."""
    return spawn_runner(coord_port, runner_id, devices)


def wait_until(pred, timeout=120.0, interval=0.2, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def test_live_rescale_exactly_once(tmp_path):
    import test_torch_runner_jobs as runner_job

    coord = JobCoordinator(Configuration({
        "heartbeat.interval": 500,
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 3,
        "restart-strategy.fixed-delay.delay": 200,
    }))
    srv = RpcServer(coord)
    runner = None
    n_batches = 60
    try:
        runner = spawn_mesh_runner(srv.port, "mesh-r1")
        wait_until(lambda: "mesh-r1" in coord.runners, what="registration")

        sink_dir = str(tmp_path / "sink")
        coord.rpc_submit_job(
            "rescale-job", entry="test_torch_runner_jobs:build",
            config={
                "cluster.mesh-devices": "2",
                "state.num-key-shards": 8,
                "state.slots-per-shard": 16,
                "pipeline.microbatch-size": 64,
                "execution.checkpointing.dir": str(tmp_path / "ckpt"),
                "execution.checkpointing.interval": 500,
                "test.n-batches": str(n_batches),
                "test.batch-sleep-ms": "200",
                "test.sink-dir": sink_dir,
            })
        wait_until(lambda: coord.rpc_job_status("rescale-job")["state"]
                   == "RUNNING", what="deploy")
        # let it make checkpointed progress at width 2
        time.sleep(4.0)

        resp = coord.rpc_rescale_job("rescale-job", devices=4)
        assert resp["ok"], resp

        # the rescale lands: attempt 2 at the new width
        wait_until(lambda: coord.rpc_job_status("rescale-job")["attempts"]
                   >= 2, what="rescale redeploy")
        wait_until(lambda: coord.rpc_job_status("rescale-job")["state"]
                   == "FINISHED", what="job finish")

        eg = coord.rpc_execution_graph("rescale-job")
        assert eg["parallelism"] == 4  # physical graph re-widened

        # exactly-once across the rescale boundary
        got = {}
        for r in FileTransactionalSink.committed_rows(sink_dir):
            k = (int(r["key"]), int(r["window_start"]))
            assert k not in got, f"duplicate window {k}"
            got[k] = int(r["count"])
        assert got == runner_job.golden_counts(n_batches)
    finally:
        if runner is not None:
            runner.terminate()
            runner.wait(timeout=15)
        srv.close()
        coord.close()


class TestRescaleLifecycle:
    """Rescale arming must not leak (review regressions)."""

    def _mk(self):
        from flink_tpu_torch.runtime.rpc import RpcEndpoint

        class Gw(RpcEndpoint):
            def __init__(self):
                self.deployed = []
                self.savepoint_ok = True
                self.cancels = []

            def rpc_run_job(self, job_id, entry, config=None, attempt=1,
                            py_blobs=None, **kw):
                self.deployed.append((job_id, attempt))
                return {"accepted": True}

            def rpc_cancel_job(self, job_id, attempt=None):
                self.cancels.append((job_id, attempt))
                return {"ok": True}

            def rpc_trigger_savepoint(self, job_id, stop=False, token=None):
                self.savepoints = getattr(self, "savepoints", [])
                self.savepoints.append((job_id, stop, token))
                return {"ok": self.savepoint_ok}

        return Gw()

    def test_rejected_savepoint_disarms_rescale(self):
        gw = self._mk()
        gw.savepoint_ok = False  # job has no checkpointing configured
        gwsrv = RpcServer(gw)
        coord = JobCoordinator(Configuration({}))
        srv = RpcServer(coord)
        try:
            coord.rpc_register_runner("r1", "127.0.0.1", 8, port=gwsrv.port)
            coord.rpc_submit_job("j", entry="x:y",
                                 config={"cluster.mesh-devices": "2"})
            wait_until(lambda: gw.deployed, what="deploy")
            resp = coord.rpc_rescale_job("j", devices=4)
            assert resp["ok"]  # dispatched — rejection is async
            wait_until(lambda: coord.jobs["j"].pending_rescale is None,
                       what="disarm after rejected savepoint")
            # a new rescale is possible again (not 'already in flight')
            gw.savepoint_ok = True
            assert coord.rpc_rescale_job("j", devices=4)["ok"]
        finally:
            srv.close(); gwsrv.close(); coord.close()

    def test_failure_disarms_pending_rescale(self):
        gw = self._mk()
        gwsrv = RpcServer(gw)
        coord = JobCoordinator(Configuration({}))
        srv = RpcServer(coord)
        try:
            coord.rpc_register_runner("r1", "127.0.0.1", 8, port=gwsrv.port)
            coord.rpc_submit_job("j", entry="x:y", config={})
            wait_until(lambda: gw.deployed, what="deploy")
            coord.jobs["j"].pending_rescale = 4  # armed, savepoint pending
            coord.rpc_report_failure("j", "task crashed")
            assert coord.jobs["j"].pending_rescale is None
        finally:
            srv.close(); gwsrv.close(); coord.close()

    def test_rescale_cancel_is_attempt_fenced(self):
        gw = self._mk()
        gwsrv = RpcServer(gw)
        coord = JobCoordinator(Configuration({}))
        srv = RpcServer(coord)
        try:
            coord.rpc_register_runner("r1", "127.0.0.1", 8, port=gwsrv.port)
            coord.rpc_submit_job("j", entry="x:y",
                                 config={"cluster.mesh-devices": "2"})
            wait_until(lambda: gw.deployed, what="deploy")
            coord.rpc_rescale_job("j", devices=4)
            wait_until(lambda: getattr(gw, "savepoints", []),
                       what="savepoint dispatch")
            job_id, stop, token = gw.savepoints[0]
            assert stop  # stop-with-savepoint: old attempt halts at SP
            # completion must carry the rescale's token to be consumed
            coord.rpc_savepoint_complete("j", "/sp/path", token=token)
            wait_until(lambda: len(gw.deployed) >= 2, what="redeploy")
            wait_until(lambda: gw.cancels, what="cancel push")
            # the cancel carried the OLD attempt as its fence
            assert gw.cancels[0] == ("j", 1)
            assert gw.deployed[1] == ("j", 2)
        finally:
            srv.close(); gwsrv.close(); coord.close()

    def test_unrelated_savepoint_does_not_consume_rescale(self):
        gw = self._mk()
        gwsrv = RpcServer(gw)
        coord = JobCoordinator(Configuration({}))
        srv = RpcServer(coord)
        try:
            coord.rpc_register_runner("r1", "127.0.0.1", 8, port=gwsrv.port)
            coord.rpc_submit_job("j", entry="x:y", config={})
            wait_until(lambda: gw.deployed, what="deploy")
            coord.rpc_rescale_job("j", devices=4)
            # a ROUTINE savepoint (no token) completes while the rescale
            # savepoint is still in flight: it must not fire the rescale
            coord.rpc_savepoint_complete("j", "/routine/sp")
            assert coord.jobs["j"].pending_rescale == 4  # still armed
            assert len(gw.deployed) == 1  # no redeploy
            assert coord.jobs["j"].last_savepoint == "/routine/sp"
        finally:
            srv.close(); gwsrv.close(); coord.close()


# ---------------------------------------------------------------------------
# process-level rescale (N -> M key-group repartition) — the tentpole e2e
# ---------------------------------------------------------------------------

def spawn_runner(coord_port: int, runner_id: str,
                 cpu_devices: int = 1) -> subprocess.Popen:
    """A port runner on the CPU (one block by default: a process-level
    rescale moves processes, not mesh width)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + os.path.join(REPO, "tests")
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.Popen(
        [sys.executable, "-m", "flink_tpu_torch.runtime.runner",
         "--coordinator", f"127.0.0.1:{coord_port}",
         "--runner-id", runner_id, "--device", "cpu",
         "--cpu-devices", str(cpu_devices)],
        env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _committed_union(sink_dir: str) -> dict:
    """Union of every process's committed rows; asserts exactly-once
    (no (key, window) committed twice across any rescale cut)."""
    got = {}
    for pid in (0, 1):
        for r in FileTransactionalSink.committed_rows(f"{sink_dir}-p{pid}"):
            kk = (int(r["key"]), int(r["window_start"]))
            assert kk not in got, f"duplicate emission for {kk}"
            got[kk] = int(r["count"])
    return got


def test_q5_process_rescale_one_to_two_to_one_exactly_once(tmp_path):
    """THE acceptance run: the Q5 hot path rescaled 1→2→1 PROCESSES
    mid-run. Each cut is a savepoint-set barrier; restore repartitions
    every keyed op's key-group ranges to the new process set; committed
    output must be byte-identical to the unrescaled golden."""
    import test_torch_runner_jobs as runner_job_q5_rescale

    coord = JobCoordinator(Configuration({
        "heartbeat.interval": "300ms",
        "heartbeat.timeout": "8s",
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 6,
        "restart-strategy.fixed-delay.delay": "100ms",
    }))
    srv = RpcServer(coord)
    procs = {}
    n_batches, batch_size = 28, 512
    try:
        procs["r1"] = spawn_runner(srv.port, "r1")
        procs["r2"] = spawn_runner(srv.port, "r2")
        wait_until(lambda: len(coord.runners) == 2, 90,
                   what="both runners registered")
        sink_dir = str(tmp_path / "sink")
        coord.rpc_submit_job(
            "q5-rescale", entry="test_torch_runner_jobs:build_q5_rescale",
            config={
                "test.n-batches": n_batches,
                "test.batch-size": batch_size,
                "test.batch-sleep-ms": 120,
                "test.sink-dir": sink_dir,
                "execution.checkpointing.dir": str(tmp_path / "chk"),
                "execution.checkpointing.interval": "300ms",
                "state.num-key-shards": 8,
                "state.slots-per-shard": 64,
            })
        # phase 1 (nproc=1): real committed progress first
        wait_until(
            lambda: len(FileTransactionalSink.committed_rows(
                f"{sink_dir}-p0")) > 0,
            90, what="first committed epoch at nproc=1")

        # cut 1: 1 -> 2 processes (key-group ranges split)
        resp = coord.rpc_rescale_job("q5-rescale", devices=1, processes=2)
        assert resp["ok"], resp
        wait_until(
            lambda: (coord.jobs["q5-rescale"].state == "RUNNING"
                     and int(coord.jobs["q5-rescale"].config.get(
                         "cluster.num-processes", 1)) == 2),
            120, what="running at 2 processes")
        # proof the SECOND process owns live state now: it commits
        wait_until(
            lambda: len(FileTransactionalSink.committed_rows(
                f"{sink_dir}-p1")) > 0,
            120, what="process 1 committing after the split")

        # cut 2: 2 -> 1 processes (key-group ranges merge back)
        resp = coord.rpc_rescale_job("q5-rescale", devices=1, processes=1)
        assert resp["ok"], resp
        wait_until(
            lambda: (coord.jobs["q5-rescale"].state in
                     ("RUNNING", "FINISHED")
                     and int(coord.jobs["q5-rescale"].config.get(
                         "cluster.num-processes", 1)) == 1),
            120, what="running at 1 process again")

        wait_until(lambda: coord.jobs["q5-rescale"].state == "FINISHED",
                   180, what="job FINISHED after both cuts")

        # byte-identical to the unrescaled golden, exactly-once
        got = _committed_union(sink_dir)
        assert got == runner_job_q5_rescale.q5_rescale_golden(
            n_batches, batch_size)

        # time-to-rescale observability: both rescales recorded
        st = coord.rpc_job_status("q5-rescale")
        metrics = st["rescale"]["metrics"]
        assert metrics.get("coordinator.rescale.armed") >= 2
        assert metrics.get("coordinator.rescale.redeploy") >= 2
        assert metrics.get("coordinator.rescale.duration_ms.count") >= 2
        assert metrics.get("coordinator.rescale.duration_ms.max") > 0
        assert st["rescale"]["last_completed_at"] is not None
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        srv.close()
        coord.close()


def test_runner_kill_during_process_rescale_never_strands(tmp_path):
    """Chaos: SIGKILL the runner hosting the old attempt right after the
    rescale is armed (the savepoint may or may not have landed — both
    races are legal). Invariant: the job always ends FINISHED with
    golden output, either rescaled or with the intent cleanly disarmed
    — never stranded mid-handshake."""
    import test_torch_runner_jobs as runner_job_q5_rescale

    coord = JobCoordinator(Configuration({
        "heartbeat.interval": "200ms",
        "heartbeat.timeout": "1500ms",
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 6,
        "restart-strategy.fixed-delay.delay": "100ms",
    }))
    srv = RpcServer(coord)
    procs = {}
    n_batches, batch_size = 16, 512
    try:
        # 3 runners: after the SIGKILL the fleet must still be able to
        # host a 2-process redeploy (savepoint-landed race branch)
        for rid in ("r1", "r2", "r3"):
            procs[rid] = spawn_runner(srv.port, rid)
        wait_until(lambda: len(coord.runners) == 3, 90,
                   what="all runners registered")
        sink_dir = str(tmp_path / "sink")
        coord.rpc_submit_job(
            "chaos-rescale", entry="test_torch_runner_jobs:build_q5_rescale",
            config={
                "test.n-batches": n_batches,
                "test.batch-size": batch_size,
                "test.batch-sleep-ms": 120,
                "test.sink-dir": sink_dir,
                "execution.checkpointing.dir": str(tmp_path / "chk"),
                "execution.checkpointing.interval": "300ms",
                "state.num-key-shards": 8,
                "state.slots-per-shard": 64,
            })
        wait_until(
            lambda: len(FileTransactionalSink.committed_rows(
                f"{sink_dir}-p0")) > 0,
            90, what="committed progress before the kill")
        victim_id = coord.jobs["chaos-rescale"].assigned_runners[0]

        resp = coord.rpc_rescale_job("chaos-rescale", devices=1,
                                     processes=2)
        assert resp["ok"], resp
        procs[victim_id].send_signal(signal.SIGKILL)
        procs[victim_id].wait(timeout=10)

        wait_until(lambda: coord.jobs["chaos-rescale"].state == "FINISHED",
                   180, what="job FINISHED despite the mid-rescale kill")
        j = coord.jobs["chaos-rescale"]
        assert j.pending_rescale is None          # never stranded armed
        assert j.rescale_token is None
        got = _committed_union(sink_dir)
        assert got == runner_job_q5_rescale.q5_rescale_golden(
            n_batches, batch_size)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        srv.close()
        coord.close()


# ---------------------------------------------------------------------------
# reactive controller (fake clock — _rescale_tick(now=...) is injectable)
# ---------------------------------------------------------------------------

class _Gw:
    """Fake runner gateway; **kw-tolerant so HA leader-epoch fences and
    future wire fields never break it."""

    def __init__(self):
        self.deployed = []       # (job_id, attempt, config)
        self.cancels = []
        self.savepoints = []     # (job_id, stop, token)
        self.savepoint_ok = True

    def rpc_run_job(self, job_id, entry, config=None, attempt=1,
                    py_blobs=None, **kw):
        self.deployed.append((job_id, attempt, dict(config or {})))
        return {"accepted": True}

    def rpc_cancel_job(self, job_id, attempt=None, **kw):
        self.cancels.append((job_id, attempt))
        return {"ok": True}

    def rpc_trigger_savepoint(self, job_id, stop=False, token=None, **kw):
        self.savepoints.append((job_id, stop, token))
        return {"ok": self.savepoint_ok}


def _quiet_coordinator(config=None):
    """Coordinator whose monitor loop is STOPPED: the loop drives
    _rescale_tick with REAL time, which would race a fake-clock test.
    _closed is flipped before the first iteration can observe metrics;
    the 1.2s drain outlasts one full sleep(<=1.0) cycle."""
    coord = JobCoordinator(config or Configuration({}))
    coord._closed = True
    time.sleep(1.2)
    return coord


class TestReactiveController:
    """The pressure-driven policy loop, demonstrated under a fake clock:
    sustained out-of-band pressure arms, hysteresis never flaps."""

    def _up(self, config=None):
        gw = _Gw()
        gwsrv = RpcServer(gw)
        coord = _quiet_coordinator(config)
        srv = RpcServer(coord)
        coord.rpc_register_runner("r1", "127.0.0.1", 8, port=gwsrv.port)
        return gw, gwsrv, coord, srv

    def _submit(self, coord, job_id="j", **over):
        cfg = {"cluster.mesh-devices": "2", "rescale.mode": "reactive",
               "rescale.sustained-window": "1s",
               "rescale.cooldown": "0ms"}
        cfg.update(over)
        coord.rpc_submit_job(job_id, entry="x:y", config=cfg)
        wait_until(lambda: coord.jobs[job_id].state == "RUNNING",
                   what="deploy")

    def test_sustained_high_pressure_arms_scale_out(self):
        gw, gwsrv, coord, srv = self._up()
        try:
            self._submit(coord)
            coord.jobs["j"].last_metrics = {"backpressure_pct": 95.0}
            t0 = time.time()
            coord._rescale_tick(now=t0)        # leaves the band: clock starts
            coord._rescale_tick(now=t0 + 0.5)  # not sustained yet
            assert coord.jobs["j"].pending_rescale is None
            coord._rescale_tick(now=t0 + 1.1)  # sustained >= 1s: arm
            j = coord.jobs["j"]
            assert j.pending_rescale == 4      # doubling, 128 % 4 == 0
            assert j.rescale_token is not None
            # the arm ran the REAL handshake: stop-with-savepoint out
            wait_until(lambda: gw.savepoints, what="stop-with-savepoint")
            assert gw.savepoints[0] == ("j", True, j.rescale_token)
        finally:
            srv.close(); gwsrv.close(); coord.close()

    def test_one_in_band_sample_resets_the_clock(self):
        gw, gwsrv, coord, srv = self._up()
        try:
            self._submit(coord)
            j = coord.jobs["j"]
            t0 = time.time()
            j.last_metrics = {"backpressure_pct": 95.0}
            coord._rescale_tick(now=t0)
            j.last_metrics = {"backpressure_pct": 45.0}  # transient dip
            coord._rescale_tick(now=t0 + 0.6)            # resets the clock
            j.last_metrics = {"backpressure_pct": 95.0}
            coord._rescale_tick(now=t0 + 0.7)
            coord._rescale_tick(now=t0 + 1.5)  # only 0.8s sustained
            assert j.pending_rescale is None
            coord._rescale_tick(now=t0 + 1.8)  # 1.1s sustained now
            assert j.pending_rescale == 4
        finally:
            srv.close(); gwsrv.close(); coord.close()

    def test_oscillating_pressure_never_flaps(self):
        gw, gwsrv, coord, srv = self._up()
        try:
            self._submit(coord)
            j = coord.jobs["j"]
            t0 = time.time()
            # violent oscillation ACROSS the band, sampled faster than
            # the sustained window — each side flip restarts the clock
            for i in range(40):
                j.last_metrics = {"backpressure_pct":
                                  95.0 if i % 2 == 0 else 5.0}
                coord._rescale_tick(now=t0 + i * 0.3)
            assert j.pending_rescale is None
            assert not gw.savepoints
        finally:
            srv.close(); gwsrv.close(); coord.close()

    def test_cooldown_gates_rearm_after_a_completed_rescale(self):
        gw, gwsrv, coord, srv = self._up()
        try:
            self._submit(coord, **{"rescale.cooldown": "60s"})
            j = coord.jobs["j"]
            t0 = time.time()
            j.last_rescale_done_at = t0  # a rescale just completed
            j.last_metrics = {"backpressure_pct": 95.0}
            for i in range(10):
                coord._rescale_tick(now=t0 + i)  # sustained, but cooling
            assert j.pending_rescale is None
            coord._rescale_tick(now=t0 + 61)
            coord._rescale_tick(now=t0 + 62.5)   # sustained past cooldown
            assert j.pending_rescale == 4
        finally:
            srv.close(); gwsrv.close(); coord.close()

    def test_sustained_low_pressure_arms_scale_in(self):
        gw, gwsrv, coord, srv = self._up()
        try:
            self._submit(coord)
            j = coord.jobs["j"]
            t0 = time.time()
            j.last_metrics = {"backpressure_pct": 3.0,
                              "drain_busy_pct": 4.0}
            coord._rescale_tick(now=t0)
            coord._rescale_tick(now=t0 + 1.1)
            assert j.pending_rescale == 1  # halving from 2
        finally:
            srv.close(); gwsrv.close(); coord.close()

    def test_queued_fleet_demand_defers_scale_out(self):
        gw, gwsrv, coord, srv = self._up()
        try:
            self._submit(coord)
            # a parked job is unmet fleet demand: scaling OUT now would
            # starve it further — the controller waits its turn
            coord.rpc_submit_job("parked", entry="x:y",
                                 config={"cluster.mesh-devices": "64"})
            wait_until(lambda: coord.jobs["parked"].state ==
                       "WAITING_FOR_RESOURCES", what="parked job")
            j = coord.jobs["j"]
            t0 = time.time()
            j.last_metrics = {"backpressure_pct": 95.0}
            coord._rescale_tick(now=t0)
            coord._rescale_tick(now=t0 + 2.0)
            assert j.pending_rescale is None  # deferred, not armed
            # scale-IN is still allowed under queued demand
            j.last_metrics = {"backpressure_pct": 3.0}
            coord._rescale_tick(now=t0 + 3.0)
            coord._rescale_tick(now=t0 + 4.5)
            assert j.pending_rescale == 1
        finally:
            srv.close(); gwsrv.close(); coord.close()


# ---------------------------------------------------------------------------
# chaos: a fault at every phase of the handshake (arm/savepoint/redeploy)
# ---------------------------------------------------------------------------

class TestRescaleChaosPhases:
    """The job must end rescaled or cleanly disarmed — never stranded —
    whichever phase of the handshake the fault lands in."""

    def test_arm_fault_fails_the_rpc_and_leaves_job_clean(self):
        from flink_tpu_torch import faults

        gw = _Gw()
        gwsrv = RpcServer(gw)
        coord = JobCoordinator(Configuration({}))
        srv = RpcServer(coord)
        try:
            coord.rpc_register_runner("r1", "127.0.0.1", 8, port=gwsrv.port)
            coord.rpc_submit_job("j", entry="x:y",
                                 config={"cluster.mesh-devices": "2"})
            wait_until(lambda: gw.deployed, what="deploy")
            plan = faults.FaultPlan.from_spec("rescale.arm=raise x1",
                                              seed=7)
            with plan.activate():
                resp = coord.rpc_rescale_job("j", devices=4)
                assert not resp["ok"] and "arm failed" in resp["reason"]
                j = coord.jobs["j"]
                assert j.pending_rescale is None      # disarmed
                assert j.rescale_token is None
                assert j.state == "RUNNING"           # job untouched
                assert not gw.savepoints              # never dispatched
                # x1 consumed: the retry goes through
                assert coord.rpc_rescale_job("j", devices=4)["ok"]
                wait_until(lambda: gw.savepoints, what="retry savepoint")
        finally:
            srv.close(); gwsrv.close(); coord.close()

    def test_savepoint_fault_disarms_async_and_retry_succeeds(self):
        from flink_tpu_torch import faults

        gw = _Gw()
        gwsrv = RpcServer(gw)
        coord = JobCoordinator(Configuration({}))
        srv = RpcServer(coord)
        try:
            coord.rpc_register_runner("r1", "127.0.0.1", 8, port=gwsrv.port)
            coord.rpc_submit_job("j", entry="x:y",
                                 config={"cluster.mesh-devices": "2"})
            wait_until(lambda: gw.deployed, what="deploy")
            plan = faults.FaultPlan.from_spec("rescale.savepoint=raise x1",
                                              seed=7)
            with plan.activate():
                resp = coord.rpc_rescale_job("j", devices=4)
                assert resp["ok"]  # ack = DISPATCHED; the fault is async
                wait_until(lambda: coord.jobs["j"].pending_rescale is None,
                           what="async disarm after savepoint fault")
                assert coord.jobs["j"].state == "RUNNING"
                assert not gw.savepoints  # push died before any trigger
                assert coord.rpc_rescale_job("j", devices=4)["ok"]
                wait_until(lambda: gw.savepoints, what="retry savepoint")
        finally:
            srv.close(); gwsrv.close(); coord.close()

    def test_redeploy_fault_retries_onto_surviving_runner(self):
        from flink_tpu_torch import faults

        gw1, gw2 = _Gw(), _Gw()
        gwsrv1, gwsrv2 = RpcServer(gw1), RpcServer(gw2)
        coord = JobCoordinator(Configuration({
            "restart-strategy.type": "fixed-delay",
            "restart-strategy.fixed-delay.attempts": 3,
            "restart-strategy.fixed-delay.delay": "50ms",
        }))
        srv = RpcServer(coord)
        try:
            coord.rpc_register_runner("r1", "127.0.0.1", 8,
                                      port=gwsrv1.port)
            coord.rpc_register_runner("r2", "127.0.0.1", 8,
                                      port=gwsrv2.port)
            coord.rpc_submit_job("j", entry="x:y",
                                 config={"cluster.mesh-devices": "2"})
            wait_until(lambda: gw1.deployed or gw2.deployed, what="deploy")
            plan = faults.FaultPlan.from_spec("rescale.redeploy=raise x1",
                                              seed=7)
            with plan.activate():
                assert coord.rpc_rescale_job("j", devices=4)["ok"]
                wait_until(lambda: gw1.savepoints or gw2.savepoints,
                           what="stop-with-savepoint")
                tok = (gw1.savepoints or gw2.savepoints)[0][2]
                coord.rpc_savepoint_complete("j", "/sp/p0", token=tok)
                # first rescale redeploy raises; the failure routes
                # through restart and lands on the OTHER runner
                wait_until(
                    lambda: coord.jobs["j"].state == "RUNNING"
                    and coord.jobs["j"].config.get(
                        "cluster.mesh-devices") == "4",
                    what="job running at the new width after the retry")
            j = coord.jobs["j"]
            assert j.pending_rescale is None       # handshake fully done
            assert j.last_rescale_done_at is not None
            snap = coord.registry.snapshot()
            assert snap["coordinator.rescale.duration_ms.count"] >= 1
            # the rescaled topology reached a gateway (retry path)
            new_deploys = [d for d in gw1.deployed + gw2.deployed
                           if d[2].get("cluster.mesh-devices") == "4"]
            assert new_deploys
        finally:
            srv.close(); gwsrv1.close(); gwsrv2.close(); coord.close()


# ---------------------------------------------------------------------------
# leader takeover with an armed rescale (the satellite bugfix regression)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# leader takeover with an armed rescale
# ---------------------------------------------------------------------------

class TestRescaleTakeover:
    """A dispatcher takeover must not forget an armed rescale: the
    intent rides the JobStore record, and re-adoption re-triggers the
    stop-with-savepoint under the stored token (an intent held in memory
    only would leave the handshake armed forever)."""

    def test_takeover_preserves_and_resumes_armed_rescale(self, tmp_path):
        gw = _Gw()
        gwsrv = RpcServer(gw)
        ha_cfg = Configuration(
            {"high-availability.dir": str(tmp_path / "ha")})
        coord_a = JobCoordinator(ha_cfg)
        srv_a = RpcServer(coord_a)
        coord_b = None
        srv_b = None
        try:
            coord_a.rpc_register_runner("r1", "127.0.0.1", 8,
                                        port=gwsrv.port)
            coord_a.rpc_submit_job("j", entry="x:y",
                                   config={"cluster.mesh-devices": "2"})
            wait_until(lambda: gw.deployed, what="deploy on leader A")
            assert coord_a.rpc_rescale_job("j", devices=4,
                                           processes=1)["ok"]
            wait_until(lambda: gw.savepoints, what="savepoint dispatch")
            tok = gw.savepoints[0][2]
            assert tok is not None

            # leader A dies mid-handshake: intent armed, savepoint
            # dispatched but NEVER completed
            srv_a.close()
            coord_a.close()

            coord_b = JobCoordinator(ha_cfg)
            srv_b = RpcServer(coord_b)
            j = coord_b.jobs["j"]
            # the durable intent survived the takeover verbatim
            assert j.pending_rescale == 4
            assert j.rescale_token == tok

            # the runner re-registers CARRYING the live execution: it is
            # re-adopted in place AND the armed rescale's
            # stop-with-savepoint re-fires under the SAME token
            n_sp = len(gw.savepoints)
            coord_b.rpc_register_runner(
                "r1", "127.0.0.1", 8, port=gwsrv.port,
                jobs=[{"job_id": "j", "attempt": 1}])
            wait_until(lambda: coord_b.jobs["j"].state == "RUNNING",
                       what="re-adoption")
            assert coord_b.jobs["j"].attempts == 1  # no redeploy
            wait_until(lambda: len(gw.savepoints) > n_sp,
                       what="re-triggered stop-with-savepoint")
            assert gw.savepoints[-1] == ("j", True, tok)

            # completion on the NEW leader consumes the recovered intent
            coord_b.rpc_savepoint_complete("j", "/sp/p0", token=tok)
            wait_until(
                lambda: any(a == 2 for _, a, _c in gw.deployed),
                what="redeploy at the new width")
            jid, att, conf = gw.deployed[-1]
            assert conf["cluster.mesh-devices"] == "4"
            assert conf["execution.checkpointing.restore"] == "/sp/p0"
            assert conf["cluster.rescale-from"] == "/sp/p0"
            assert coord_b.jobs["j"].pending_rescale is None
        finally:
            if srv_b is not None:
                srv_b.close()
            if coord_b is not None:
                coord_b.close()
            gwsrv.close()
            coord_a.close()
