"""``tests/test_runner_process.py`` against the port: real runner
processes (``python -m flink_tpu_torch.runtime.runner --device cpu``),
a real SIGKILL, coordinator-driven recovery and exactly-once output.

Topology: the port's coordinator (an in-test RpcServer) and two port
runner subprocesses on the CPU. A job is submitted with a deployment
descriptor (``test_torch_runner_jobs:build``); the assigned runner is
SIGKILLed mid-job; heartbeat expiry routes the loss through the restart
budget; the coordinator re-deploys to the surviving runner with
``restore: latest``; the file-backed 2PC sink must show every window
exactly once. A port runner imports torch before it registers, so each
case waits for registration (the heartbeat timeouts are the
reference's). The jobs' data and goldens are the reference jobs'
(``test_the_jobs_are_the_reference_jobs``)."""
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


def spawn_runner(coord_port: int, runner_id: str,
                 cpu_devices: int = 1) -> subprocess.Popen:
    """A port task runner process on the CPU (``cpu_devices`` blocks of
    it as its slots), its output to a file beside the test's."""
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


def wait_until(pred, timeout=60.0, interval=0.1, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def test_runner_kill_recovery_exactly_once(tmp_path):
    import test_torch_runner_jobs as runner_job

    coord = JobCoordinator(Configuration({
        "heartbeat.interval": "200ms",
        "heartbeat.timeout": "1200ms",
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 3,
        "restart-strategy.fixed-delay.delay": "100ms",
    }))
    srv = RpcServer(coord)
    procs = {}
    try:
        procs["r1"] = spawn_runner(srv.port, "r1")
        procs["r2"] = spawn_runner(srv.port, "r2")
        wait_until(lambda: len(coord.runners) == 2, 90,
                   what="both runners registered")

        n_batches = 40
        sink_dir = str(tmp_path / "sink")
        coord.rpc_submit_job(
            "kill-job",
            entry="test_torch_runner_jobs:build",
            config={
                "test.n-batches": n_batches,
                "test.batch-sleep-ms": 150,
                "test.sink-dir": sink_dir,
                "execution.checkpointing.dir": str(tmp_path / "chk"),
                "execution.checkpointing.interval": "200ms",
                "state.num-key-shards": 8,
                "state.slots-per-shard": 16,
            })

        # wait for real progress: at least one COMMITTED epoch on disk
        wait_until(
            lambda: len(FileTransactionalSink.committed_rows(sink_dir)) > 0,
            90, what="first committed epoch")
        assigned = coord.jobs["kill-job"].assigned_runners[0]
        victim = procs[assigned]
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=10)

        # coordinator notices the silence, burns one restart attempt,
        # re-deploys to the survivor with restore=latest
        wait_until(lambda: coord.jobs["kill-job"].state == "FINISHED",
                   120, what="job FINISHED after recovery")
        assert coord.jobs["kill-job"].attempts >= 2
        survivor = coord.jobs["kill-job"].assigned_runners[0]
        assert survivor != assigned

        got = {}
        for r in FileTransactionalSink.committed_rows(sink_dir):
            kk = (int(r["key"]), int(r["window_start"]))
            assert kk not in got, f"duplicate emission for {kk}"
            got[kk] = int(r["count"])
        assert got == runner_job.golden_counts(n_batches)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        coord.close()
        srv.close()


def test_runner_registers_runs_and_finishes(tmp_path):
    """Happy path: register → push deploy → run → FINISHED, output
    committed exactly once (the submitTask round trip)."""
    import test_torch_runner_jobs as runner_job

    coord = JobCoordinator(Configuration({
        "heartbeat.interval": "200ms",
        "heartbeat.timeout": "5s",
    }))
    srv = RpcServer(coord)
    proc = None
    try:
        proc = spawn_runner(srv.port, "solo")
        wait_until(lambda: len(coord.runners) == 1, 90,
                   what="runner registered")
        n_batches = 6
        sink_dir = str(tmp_path / "sink")
        coord.rpc_submit_job(
            "ok-job",
            entry="test_torch_runner_jobs:build",
            config={
                "test.n-batches": n_batches,
                "test.sink-dir": sink_dir,
                "execution.checkpointing.dir": str(tmp_path / "chk"),
                "execution.checkpointing.interval": "100ms",
                "state.num-key-shards": 8,
                "state.slots-per-shard": 16,
            })
        wait_until(lambda: coord.jobs["ok-job"].state == "FINISHED", 90,
                   what="job FINISHED")
        got = {}
        for r in FileTransactionalSink.committed_rows(sink_dir):
            kk = (int(r["key"]), int(r["window_start"]))
            assert kk not in got
            got[kk] = int(r["count"])
        assert got == runner_job.golden_counts(n_batches)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
        coord.close()
        srv.close()


def test_cancel_job_stops_runner_and_state_sticks(tmp_path):
    """Cancel flows coordinator → runner gateway → driver batch
    boundary; the job stops producing, CANCELED is terminal (a late
    finish/failure report must not resurrect it)."""
    coord = JobCoordinator(Configuration({
        "heartbeat.interval": "200ms",
        "heartbeat.timeout": "5s",
    }))
    srv = RpcServer(coord)
    proc = None
    try:
        proc = spawn_runner(srv.port, "c1")
        wait_until(lambda: len(coord.runners) == 1, 90,
                   what="runner registered")
        sink_dir = str(tmp_path / "sink")
        coord.rpc_submit_job(
            "cancel-job",
            entry="test_torch_runner_jobs:build",
            config={
                "test.n-batches": 200,           # would run ~30s
                "test.batch-sleep-ms": 150,
                "test.sink-dir": sink_dir,
                "execution.checkpointing.dir": str(tmp_path / "chk"),
                "execution.checkpointing.interval": "200ms",
                "state.num-key-shards": 8,
                "state.slots-per-shard": 16,
            })
        wait_until(
            lambda: len(FileTransactionalSink.committed_rows(sink_dir)) > 0,
            90, what="job producing output")
        coord.rpc_cancel_job("cancel-job")
        # the runner drops the job within a couple of batch boundaries
        from flink_tpu_torch.runtime.rpc import RpcClient
        r = coord.runners["c1"]
        c = RpcClient(r.host, r.port)
        wait_until(lambda: c.call("ping")["jobs"] == [], 30,
                   what="runner dropped the cancelled job")
        c.close()
        assert coord.jobs["cancel-job"].state == "CANCELED"
        # no further commits after cancellation settles
        n0 = len(FileTransactionalSink.committed_rows(sink_dir))
        time.sleep(1.0)
        assert len(FileTransactionalSink.committed_rows(sink_dir)) == n0
        time.sleep(0.5)
        assert coord.jobs["cancel-job"].state == "CANCELED"
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
        coord.close()
        srv.close()


def test_coordinator_deploys_one_job_across_two_runners(tmp_path):
    """ONE submitted job spans TWO runner processes — the coordinator
    allocates a distinct runner per process, the DCN exchange ports
    rendezvous through rpc_dcn_register/peers (the driver's
    ``cluster.dcn-rendezvous: coordinator``), keyed records cross
    processes, and the union of both processes' committed output equals
    the golden run."""
    import test_torch_runner_jobs as runner_job_dcn

    coord = JobCoordinator(Configuration({
        "heartbeat.interval": "200ms",
        "heartbeat.timeout": "5000ms",
    }))
    srv = RpcServer(coord)
    procs = {}
    try:
        procs["r1"] = spawn_runner(srv.port, "r1")
        procs["r2"] = spawn_runner(srv.port, "r2")
        wait_until(lambda: len(coord.runners) == 2, 90,
                   what="both runners registered")
        n_batches = 16
        sink_dir = str(tmp_path / "sink")
        coord.rpc_submit_job(
            "dcn-job",
            entry="test_torch_runner_jobs:build_dcn",
            config={
                "test.n-batches": n_batches,
                "test.sink-dir": sink_dir,
                "cluster.num-processes": 2,
                "execution.checkpointing.dir": str(tmp_path / "chk"),
                "execution.checkpointing.interval": "300ms",
                "state.num-key-shards": 8,
                "state.slots-per-shard": 32,
            })
        wait_until(lambda: coord.jobs["dcn-job"].state == "FINISHED",
                   180, what="cross-runner job FINISHED")
        assert sorted(coord.jobs["dcn-job"].assigned_runners) == [
            "r1", "r2"]
        got = {}
        for pid in (0, 1):
            for r in FileTransactionalSink.committed_rows(
                    f"{sink_dir}-p{pid}"):
                kk = (int(r["key"]), int(r["window_start"]))
                assert kk not in got, f"duplicate emission for {kk}"
                got[kk] = int(r["count"])
        assert got == runner_job_dcn.dcn_golden_counts(n_batches)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        srv.close()


def test_the_jobs_are_the_reference_jobs():
    """The port's job entries build the reference jobs' data: the same
    batches and the same goldens."""
    import numpy as np

    import runner_job
    import runner_job_dcn
    import test_torch_runner_jobs as jobs

    assert jobs.golden_counts(40) == runner_job.golden_counts(40)
    assert jobs.dcn_golden_counts(16) == runner_job_dcn.golden_counts(16)
    for i in (0, 7):
        assert np.array_equal(jobs.batch_of(i)[1], runner_job.batch_of(i)[1])
