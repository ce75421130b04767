"""``tests/test_cli.py`` against the port's command line
(``flink_tpu_torch/cli.py``): ``run --local`` (on ``--device cpu``) and
``run --coordinator`` with ``status`` / ``list`` / ``runners`` /
``savepoint`` / ``cancel`` against a port runner process, ``rescale``'s
exit contract, the ``log`` command, a ``run --local`` chain through an
``objstore://`` topic and ``fsck``'s exit contract (0 = ok or clean, 1 =
findings or refused, 2 = usage or path error), the session commands
resolving their leader through ``--ha-dir`` and ``session rescale``'s
contract. ``analyze`` and ``lint`` exit 2 naming their ROADMAP.md item;
the commands once refused the same way (``session``, ``run --session`` /
``--ha-dir``, ``coordinator --ha-dir`` / ``--rest-port``, ``runner
--ha-dir``) now run."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from flink_tpu_torch.cli import main as cli_main
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.runtime.coordinator import JobCoordinator
from flink_tpu_torch.runtime.rpc import RpcServer
from test_torch_runner_process import REPO, spawn_runner, wait_until


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def cli(capsys, *argv):
    rc = cli_main(list(argv))
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else {}


class TestExitCodeContract:
    """``fsck``'s CI contract: 0 = clean, 1 = findings remain, 2 =
    usage/path error, with one JSON finding object per line under
    ``--json``."""

    def test_fsck_clean_is_0_findings_1_bad_path_2(self, tmp_path,
                                                   capsys):
        """The storage fsck joins the CI exit contract: 0 =
        clean, 1 = findings remain, 2 = usage/path error — with one
        JSON finding object per line under --json."""
        import numpy as np

        from flink_tpu_torch.log.topic import TopicAppender

        topic = str(tmp_path / "topic")
        ap = TopicAppender(topic, partitions=1, segment_records=4)
        b = {"k": np.arange(4, dtype=np.int64),
             "v": np.arange(4, dtype=np.float64)}
        ap.stage(1, {0: [b]})
        ap.commit(1)
        assert cli_main(["fsck", topic]) == 0
        # seed a finding: tmp debris (back-dated past --repair's
        # live-stage grace window)
        debris = os.path.join(topic, "p0", "seg-x.colb.tmp")
        with open(debris, "wb") as f:
            f.write(b"torn")
        old = time.time() - 3600
        os.utime(debris, (old, old))
        assert cli_main(["fsck", topic]) == 1
        capsys.readouterr()
        cli_main(["fsck", topic, "--json"])
        lines = capsys.readouterr().out.strip().splitlines()
        for line in lines:
            f = json.loads(line)
            assert {"rule", "severity", "path", "message",
                    "repairable", "repaired"} <= set(f)
        # repair sweeps it; the topic is clean again
        assert cli_main(["fsck", topic, "--repair"]) == 0
        assert cli_main(["fsck", topic]) == 0
        assert cli_main(["fsck", str(tmp_path / "absent")]) == 2
        capsys.readouterr()

    def test_fsck_lsm_store_exit_contract(self, tmp_path, capsys):
        """The lsm state tier joins the same fsck contract —
        a healthy store is 0, seeded debris (orphan run + tmp, both
        back-dated past the live-seal grace) is 1, --repair sweeps the
        debris back to 0, and a run the manifest promises but the disk
        lost stays a non-repairable 1."""
        import numpy as np

        from flink_tpu_torch.state.lsm import LsmSpillStore

        class _Agg:
            sum_width = max_width = min_width = 1

            def lift_masked(self, data, valid):
                # the port's lift contract: torch lanes on the CPU
                v = data["v"].to(torch.float32)[:, None]
                return v, v, v

        store_dir = str(tmp_path / "store")
        store = LsmSpillStore(_Agg(), store_dir=store_dir,
                              memory_budget_bytes=0, num_shards=8,
                              compact_min_runs=99)
        store.absorb(np.arange(8, dtype=np.int64),
                     np.zeros(8, dtype=np.int64),
                     {"v": np.arange(8, dtype=np.float32)})
        assert cli_main(["fsck", store_dir]) == 0
        # seed repairable debris: an unreferenced run + seal tmp
        old = time.time() - 3600
        for name in ("run-000099.seg", "run-000100.seg.tmp"):
            p = os.path.join(store_dir, name)
            with open(p, "wb") as f:
                f.write(b"debris")
            os.utime(p, (old, old))
        assert cli_main(["fsck", store_dir]) == 1
        capsys.readouterr()
        cli_main(["fsck", store_dir, "--json"])
        for line in capsys.readouterr().out.strip().splitlines():
            f = json.loads(line)
            assert {"rule", "severity", "path", "message",
                    "repairable", "repaired"} <= set(f)
        assert cli_main(["fsck", store_dir, "--repair"]) == 0
        assert cli_main(["fsck", store_dir]) == 0
        # a manifest-promised run the disk lost is loud and NOT
        # repairable — fsck must never "fix" state loss by forgetting
        live_run = store._runs[0]["name"]
        os.unlink(os.path.join(store_dir, live_run))
        assert cli_main(["fsck", store_dir]) == 1
        assert cli_main(["fsck", store_dir, "--repair"]) == 1
        capsys.readouterr()


class TestLogCli:
    """`flink_tpu_torch log TOPIC_DIR` prints the message-bus view
    — compaction generation, retention floor, active leases with
    epochs, per-consumer-group committed offsets — and honors the
    0/1/2 exit-code contract (0 = ok, 1 = topic/maintenance error,
    2 = usage/path error)."""

    def _seed_topic(self, tmp_path):
        import numpy as np

        from flink_tpu_torch.log import (ConsumerGroups, LeaseManager,
                                   TopicAppender)

        topic = str(tmp_path / "topic")
        ap = TopicAppender(topic, 2, segment_records=8, key_field="k")
        for cid in (1, 2, 3):
            batch = {p: [{"k": np.arange(8, dtype=np.int64) % 4,
                          "ts": np.arange(8, dtype=np.int64) + cid}]
                     for p in range(2)}
            assert ap.stage(cid, batch)
            ap.commit(cid)
        ConsumerGroups.commit(topic, "readers", {0: 24, 1: 24})
        lease = LeaseManager(topic, "prod-a", [0], ttl_ms=60_000)
        lease.acquire()
        return topic

    def test_describe_prints_bus_state_exit_0(self, tmp_path, capsys):
        topic = self._seed_topic(tmp_path)
        rc, out = cli(capsys, "log", topic)
        assert rc == 0
        assert out["compaction_generation"] == 0
        assert out["retention_floor"] == {"0": 0, "1": 0}
        assert out["leases"]["0"]["owner"] == "prod-a"
        assert out["leases"]["0"]["epoch"] == 1
        assert out["groups"] == {"readers": {"0": 24, "1": 24}}
        assert out["key_field"] == "k"

    def test_compact_flag_runs_a_pass_and_describes(self, tmp_path,
                                                    capsys):
        topic = self._seed_topic(tmp_path)
        rc, out = cli(capsys, "log", topic, "--compact")
        assert rc == 0
        assert out["compaction_generation"] == 1
        assert out["compaction"]["gen"] == 1
        # latest-per-key survivors only, committed end preserved
        assert out["compaction"]["partitions"]["0"]["rows_out"] == 4
        assert out["committed_offsets"] == {"0": 24, "1": 24}
        assert out["compacted_end"] == {"0": 24, "1": 24}

    def test_retain_flag_advances_the_floor(self, tmp_path, capsys):
        topic = self._seed_topic(tmp_path)
        rc, out = cli(capsys, "log", topic, "--retain",
                      "--conf", "log.retention.ms=1",
                      "--conf", "log.retention.ts-field=ts")
        assert rc == 0
        assert out["retention"]["gen"] == 1
        assert out["retention_floor"] == {"0": 24, "1": 24}

    def test_missing_topic_exits_2(self, tmp_path, capsys):
        assert cli_main(["log", str(tmp_path / "absent")]) == 2
        err = capsys.readouterr().err
        assert "no such log topic" in err

    def test_maintenance_error_exits_1(self, tmp_path, capsys):
        import numpy as np

        from flink_tpu_torch.log import TopicAppender

        # a topic created WITHOUT a key_field: --compact has no key
        # column to compact by — a maintenance error, not a path error
        topic = str(tmp_path / "nokey")
        ap = TopicAppender(topic, 1, segment_records=8)
        for cid in (1, 2):
            assert ap.stage(cid, {0: [{"k": np.arange(
                8, dtype=np.int64)}]})
            ap.commit(cid)
        assert cli_main(["log", topic, "--compact"]) == 1
        assert "key" in capsys.readouterr().err

    def test_live_cleaner_lease_refuses_manual_maintenance(
            self, tmp_path, capsys):
        """The exit contract: while a live cleaner service owns the
        topic (cleaner.lease unexpired, unreleased), a manual
        --compact/--retain exits 1 instead of fighting the service
        for the maintenance lock; a released lease lifts the gate."""
        topic = self._seed_topic(tmp_path)
        now = int(time.time() * 1000)
        lease = os.path.join(topic, "cleaner.lease")
        with open(lease, "w") as f:
            json.dump({"owner": "cleaner-svc", "epoch": 1,
                       "pid": os.getpid(), "acquired_ms": now,
                       "deadline_ms": now + 60_000}, f)
        assert cli_main(["log", topic, "--compact"]) == 1
        err = capsys.readouterr().err
        assert "cleaner" in err and "cleaner-svc" in err
        # plain describe (no maintenance) still works and surfaces it
        rc, out = cli(capsys, "log", topic)
        assert rc == 0
        assert out["cleaner"]["live_owner"] == "cleaner-svc"
        assert out["cleaner"]["lease"]["epoch"] == 1
        # released lease: the manual pass proceeds
        with open(lease, "w") as f:
            json.dump({"owner": "cleaner-svc", "epoch": 1,
                       "pid": os.getpid(), "acquired_ms": now,
                       "deadline_ms": now + 60_000,
                       "released": True}, f)
        rc, out = cli(capsys, "log", topic, "--compact")
        assert rc == 0
        assert out["compaction_generation"] == 1

    def test_describe_surfaces_group_generations(self, tmp_path,
                                                 capsys):
        from flink_tpu_torch.log import ConsumerGroups

        topic = self._seed_topic(tmp_path)
        gen, _ix, _n = ConsumerGroups.join(topic, "dyn", "m1")
        ConsumerGroups.join(topic, "dyn", "m2")
        rc, out = cli(capsys, "log", topic)
        assert rc == 0
        # static group "readers" (no manifest) is absent; the dynamic
        # group reports its current membership generation
        assert out["group_generations"] == {"dyn": 2}


class TestObjstoreCliChain:
    """Two ``run --local`` jobs chained
    through an ``objstore://`` topic — every commit marker, lease,
    group offset, and manifest rides the conditional-put driver — with
    the background cleaner enabled on the producing job (lease
    acquired, passes published, released with the job)."""

    def test_chain_with_cleaner_enabled(self, tmp_path, capsys):
        import test_torch_runner_jobs as jobs

        log_dir = "objstore://" + str(tmp_path / "logroot")
        sink_dir = str(tmp_path / "sink")
        n = 5
        rc, out = cli(
            capsys, "run", "--local",
            "--entry", "test_torch_runner_jobs:produce", "--device", "cpu",
            "--job-id", "obj-chain-a",
            "--conf", f"log.dir={log_dir}",
            "--conf", "log.partitions=2",
            "--conf", "log.cleaner.enabled=true",
            "--conf", "log.cleaner.interval-ms=10",
            "--conf", f"test.n-batches={n}")
        assert rc == 0 and out["state"] == "FINISHED"
        assert out["records_in"] == n * 64

        # the driver-owned cleaner ran under its lease and released
        # it at job teardown — no live owner survives the process
        from flink_tpu_torch.log.cleaner import (cleaner_status,
                                           live_cleaner_owner,
                                           read_cleaner_lease)

        topic = os.path.join(log_dir, jobs.CHAIN_TOPIC)
        status = cleaner_status(topic)
        assert status is not None and status["passes"] >= 1
        assert live_cleaner_owner(topic) is None
        assert read_cleaner_lease(topic)["released"]

        rc, out = cli(
            capsys, "run", "--local",
            "--entry", "test_torch_runner_jobs:consume", "--device", "cpu",
            "--job-id", "obj-chain-b",
            "--conf", f"log.dir={log_dir}",
            "--conf", f"test.sink-dir={sink_dir}",
            "--conf", "state.num-key-shards=8",
            "--conf", "state.slots-per-shard=64")
        assert rc == 0 and out["state"] == "FINISHED"
        assert out["records_in"] == n * 64

        # the log CLI reads the object-store topic and surfaces the
        # cleaner lifecycle next to the bus state
        rc, info = cli(capsys, "log", topic)
        assert rc == 0
        assert info["partitions"] == 2
        assert info["committed_records"] == n * 64
        assert info["cleaner"]["status"]["passes"] >= 1
        assert info["cleaner"]["live_owner"] is None

        # consumer output diffs clean against the independent golden
        got = jobs.read_committed_counts(sink_dir)
        assert got == jobs.chain_expected_counts(n) and len(got) > 0

        # and fsck blesses the whole topic through the driver
        assert cli_main(["fsck", topic]) == 0
        capsys.readouterr()


class TestLocalRun:
    def test_run_local_executes_entry(self, tmp_path, capsys):
        sink_dir = str(tmp_path / "sink")
        rc, out = cli(
            capsys, "run", "--local", "--entry", "test_torch_runner_jobs:build",
            "--device", "cpu",
            "--job-id", "local-1",
            "--conf", "test.n-batches=5",
            "--conf", f"test.sink-dir={sink_dir}",
            "--conf", "state.num-key-shards=4",
            "--conf", "state.slots-per-shard=16",
            "--conf", "pipeline.microbatch-size=64")
        assert rc == 0
        assert out["state"] == "FINISHED"
        assert out["records_in"] == 5 * 64

    def test_conf_parsing_rejects_bad_pair(self):
        with pytest.raises(SystemExit):
            cli_main(["run", "--local", "--entry", "x:y", "--conf", "oops"])


class TestClusterFlow:
    def test_run_status_list_savepoint_cancel(self, tmp_path, capsys):
        coord = JobCoordinator(Configuration({
            "heartbeat.interval": "200ms",
            "heartbeat.timeout": "2000ms",
        }))
        srv = RpcServer(coord)
        addr = f"127.0.0.1:{srv.port}"
        proc = None
        try:
            proc = spawn_runner(srv.port, "cli-r1")
            wait_until(lambda: len(coord.runners) == 1, 90,
                       what="runner registered")

            sink_dir = str(tmp_path / "sink")
            chk_dir = str(tmp_path / "chk")
            rc, out = cli(
                capsys, "run", "--coordinator", addr,
                "--entry", "test_torch_runner_jobs:build", "--job-id", "cli-job",
                "--conf", "test.n-batches=60",
                "--conf", "test.batch-sleep-ms=50",
                "--conf", f"test.sink-dir={sink_dir}",
                "--conf", f"execution.checkpointing.dir={chk_dir}",
                "--conf", "execution.checkpointing.interval=200",
                "--conf", "state.num-key-shards=4",
                "--conf", "state.slots-per-shard=16",
                "--conf", "pipeline.microbatch-size=64")
            assert rc == 0 and out["job_id"] == "cli-job"

            rc, out = cli(capsys, "status", "--coordinator", addr, "cli-job")
            assert out["state"] in ("RUNNING", "RESTARTING")

            rc, out = cli(capsys, "list", "--coordinator", addr)
            assert [j["job_id"] for j in out["jobs"]] == ["cli-job"]

            rc, out = cli(capsys, "runners", "--coordinator", addr)
            assert len(out) == 1 and "cli-r1" in out

            # savepoint mid-run lands as a savepoint-N directory
            wait_until(lambda: os.path.isdir(os.path.join(chk_dir, "cli-job")),
                       60, what="first checkpoint")

            def try_savepoint():
                rc2, out2 = cli(capsys, "savepoint", "--coordinator",
                                addr, "cli-job")
                return rc2 == 0 and out2.get("ok")

            wait_until(try_savepoint, 30, interval=0.5,
                       what="savepoint accepted")
            job_dir = os.path.join(chk_dir, "cli-job")
            wait_until(
                lambda: any(d.startswith("savepoint-")
                            for d in os.listdir(job_dir)),
                30, what="savepoint directory")
            # the runner reports the completed path; status surfaces it
            wait_until(
                lambda: cli(capsys, "status", "--coordinator", addr,
                            "cli-job")[1].get("last_savepoint"),
                30, what="savepoint path in status")

            # a job WITHOUT checkpoint storage must reject savepoints
            # loudly instead of acking a savepoint that can never land
            rc, out = cli(
                capsys, "run", "--coordinator", addr,
                "--entry", "test_torch_runner_jobs:build", "--job-id", "no-chk",
                "--conf", "test.n-batches=40",
                "--conf", "test.batch-sleep-ms=50",
                "--conf", f"test.sink-dir={sink_dir}2",
                "--conf", "state.num-key-shards=4",
                "--conf", "state.slots-per-shard=16",
                "--conf", "pipeline.microbatch-size=64")

            def rejected():
                rc2, out2 = cli(capsys, "savepoint", "--coordinator",
                                addr, "no-chk")
                # dispatched ack is ok=True; the rejection is visible as
                # status never gaining a savepoint — but the RUNNER-side
                # validation makes the next poll report no path; verify
                # the job reports none after a grace period
                return rc2 == 0
            time.sleep(1.0)
            rejected()
            rc, out = cli(capsys, "status", "--coordinator", addr, "no-chk")
            assert out.get("last_savepoint") is None
            cli(capsys, "cancel", "--coordinator", addr, "no-chk")

            rc, out = cli(capsys, "cancel", "--coordinator", addr, "cli-job")
            assert out["ok"]
            wait_until(lambda: coord.rpc_job_status("cli-job")["state"]
                       == "CANCELED", 30, what="cancel acknowledged")
        finally:
            if proc is not None:
                proc.kill()
                proc.wait(timeout=10)
            srv.close()
            coord.close()


class TestRescaleCli:
    """`flink_tpu_torch rescale JOB --devices N [--processes M]`, the
    same 0/1/2 exit contract as every other verb: 0 = dispatched, 1 =
    the coordinator refused (divisibility / unknown job / not running),
    2 = usage error. (``session rescale`` is ROADMAP.md queue 1 item
    10.2.)"""

    def _coord(self):
        class Gw:
            def __init__(self):
                self.deployed = []
                self.savepoints = []

            def rpc_run_job(self, job_id, entry, config=None, attempt=1,
                            py_blobs=None, **kw):
                self.deployed.append((job_id, attempt))
                return {"accepted": True}

            def rpc_cancel_job(self, job_id, attempt=None, **kw):
                return {"ok": True}

            def rpc_trigger_savepoint(self, job_id, stop=False,
                                      token=None, **kw):
                self.savepoints.append((job_id, stop, token))
                return {"ok": True}

        gw = Gw()
        gwsrv = RpcServer(gw)
        coord = JobCoordinator(Configuration({}))
        srv = RpcServer(coord)
        coord.rpc_register_runner("r1", "127.0.0.1", 8, port=gwsrv.port)
        coord.rpc_register_runner("r2", "127.0.0.1", 8, port=gwsrv.port)
        return gw, gwsrv, coord, srv

    def test_dispatched_0_refused_1_usage_2(self, capsys):
        gw, gwsrv, coord, srv = self._coord()
        addr = f"127.0.0.1:{srv.port}"
        try:
            coord.rpc_submit_job(
                "j", entry="x:y",
                config={"cluster.mesh-devices": "2",
                        "state.num-key-shards": "8"})
            wait_until(lambda: gw.deployed, what="deploy")

            # 1: refused — 8 shards are not divisible by 3 processes
            # (key-group ranges could not be contiguous)
            rc, out = cli(capsys, "rescale", "--coordinator", addr,
                          "--devices", "1", "--processes", "3", "j")
            assert rc == 1 and not out["ok"]
            assert "divisible" in out["reason"]

            # 1: refused — unknown job
            rc, out = cli(capsys, "rescale", "--coordinator", addr,
                          "--devices", "2", "ghost")
            assert rc == 1 and not out["ok"]

            # 0: a process rescale dispatches (8 shards / 2 procs = 4,
            # 4 % 4 devices == 0) and the wire carried --processes
            rc, out = cli(capsys, "rescale", "--coordinator", addr,
                          "--devices", "4", "--processes", "2", "j")
            assert rc == 0 and out["ok"] and out["processes"] == 2
            wait_until(lambda: gw.savepoints, what="stop-with-savepoint")

            # 2: usage — --devices is required
            with pytest.raises(SystemExit) as e:
                cli_main(["rescale", "--coordinator", addr, "j"])
            assert e.value.code == 2
        finally:
            srv.close(); gwsrv.close(); coord.close()


    def test_session_rescale_same_contract(self, tmp_path, capsys):
        from flink_tpu_torch.runtime.session import LocalSessionCluster

        with LocalSessionCluster(Configuration(
                {"session.autoscale": False}), device="cpu") as c:
            sink = str(tmp_path / "sink")
            r = c.submit("test_torch_runner_jobs:build", job_id="sj",
                         config={
                             "test.n-batches": "60",
                             "test.batch-sleep-ms": "100",
                             "test.sink-dir": sink,
                             "execution.checkpointing.dir":
                                 str(tmp_path / "chk"),
                             "execution.checkpointing.interval": "300ms",
                             "state.num-key-shards": "4",
                             "state.slots-per-shard": "16",
                             "pipeline.microbatch-size": "64"})
            assert r.get("admitted")
            wait_until(lambda: c.dispatcher.jobs["sj"].state == "RUNNING",
                       60, what="session job running")
            # 0: dispatched against the session leader
            rc, out = cli(capsys, "session", "rescale",
                          "--session", c.address, "--devices", "1", "sj")
            assert rc == 0 and out["ok"]
            # 1: refused — unknown job
            rc, out = cli(capsys, "session", "rescale",
                          "--session", c.address, "--devices", "1",
                          "ghost")
            assert rc == 1 and not out["ok"]
            # 2: usage — --devices required
            with pytest.raises(SystemExit) as e:
                cli_main(["session", "rescale", "--session", c.address,
                          "sj"])
            assert e.value.code == 2
            c.dispatcher.rpc_cancel_job("sj")


class TestSessionHaCli:
    """The session CLI resolves the leader through --ha-dir
    (runtime/ha.leader_address) and RE-resolves on connection failure
    with a bounded retry budget — exit codes 0/1/2 as the reference's:
    0 = ok, 1 = refused / no reachable leader (clean error, never a
    traceback), 2 = usage error."""

    def _lease(self, d, address, epoch=1):
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "leader.lease"), "w") as f:
            json.dump({"leader_id": "L", "address": address,
                       "epoch": epoch, "claimed_at": time.time()}, f)

    def test_no_leader_exits_1_cleanly(self, tmp_path, capsys,
                                       monkeypatch):
        import flink_tpu_torch.cli as cli_mod

        monkeypatch.setattr(cli_mod, "_HA_RETRIES", 3)
        monkeypatch.setattr(cli_mod, "_HA_RETRY_DELAY_S", 0.05)
        rc = cli_main(["session", "list", "--ha-dir",
                       str(tmp_path / "empty")])
        err = capsys.readouterr().err
        assert rc == 1
        assert "error:" in err and "Traceback" not in err

    def test_lease_resolution_without_session_flag(self, tmp_path,
                                                   capsys):
        from flink_tpu_torch.runtime.session import LocalSessionCluster

        with LocalSessionCluster(Configuration(
                {"session.autoscale": False}), device="cpu") as c:
            self._lease(str(tmp_path), c.address)
            rc, out = cli(capsys, "session", "list",
                          "--ha-dir", str(tmp_path))
            assert rc == 0 and out["jobs"] == []
            # `session info` prints the leadership view
            rc, out = cli(capsys, "session", "info",
                          "--ha-dir", str(tmp_path))
            assert rc == 0
            assert "leader_epoch" in out and "takeovers" in out

    def test_refused_connection_re_resolves_mid_retry(
            self, tmp_path, capsys, monkeypatch):
        """The failover flow a client sees: the lease points at a DEAD
        leader; the new leader's lease lands DURING the retry budget —
        the call re-resolves and succeeds (exit 0)."""
        import threading

        import flink_tpu_torch.cli as cli_mod
        from flink_tpu_torch.runtime.session import LocalSessionCluster

        monkeypatch.setattr(cli_mod, "_HA_RETRIES", 30)
        monkeypatch.setattr(cli_mod, "_HA_RETRY_DELAY_S", 0.1)
        self._lease(str(tmp_path), f"127.0.0.1:{_free_port()}", epoch=1)
        with LocalSessionCluster(Configuration(
                {"session.autoscale": False}), device="cpu") as c:
            def takeover():
                time.sleep(0.5)
                self._lease(str(tmp_path), c.address, epoch=2)

            threading.Thread(target=takeover, daemon=True).start()
            rc, out = cli(capsys, "session", "list",
                          "--ha-dir", str(tmp_path))
            assert rc == 0 and out["jobs"] == []

    def test_standby_without_ha_dir_exits_2(self, capsys):
        assert cli_main(["session", "start", "--standby"]) == 2
        assert "standby" in capsys.readouterr().err

    def test_neither_session_nor_ha_dir_exits_2(self, capsys):
        with pytest.raises(SystemExit) as e:
            cli_main(["session", "list"])
        assert e.value.code == 2
        assert "--ha-dir" in capsys.readouterr().err


class TestCommandsStillToPort:
    @pytest.mark.parametrize("argv,item", [
        (["session", "list", "--session", "127.0.0.1:1"], "10.2"),
        (["run", "--session", "127.0.0.1:1", "--entry", "x:y"], "10.2"),
        (["run", "--ha-dir", "/nowhere", "--entry", "x:y"], "10.2"),
        (["coordinator", "--ha-dir", "/nowhere"], "10.2"),
        (["coordinator", "--rest-port", "8081"], "10.2"),
        (["runner", "--ha-dir", "/nowhere"], "10.2"),
        (["analyze", "--entry", "x:y"], "11"),
        (["lint"], "11"),
    ])
    def test_exit_2_naming_the_item(self, capsys, monkeypatch, tmp_path,
                                    argv, item):
        """Item 11's commands exit 2 naming it. The rows of item 10.2,
        which these commands once named, now run: a session client
        with no cluster to reach is refused with exit 1 and a clean
        error; the coordinator contends for an HA dir and wins it, or
        serves REST; the runner finds its coordinator through the
        lease."""
        if item == "11":
            assert cli_main(argv) == 2
            err = capsys.readouterr().err
            assert f"ROADMAP.md queue 1 item {item}" in err
            return
        import flink_tpu_torch.cli as cli_mod

        monkeypatch.setattr(cli_mod, "_HA_RETRIES", 2)
        monkeypatch.setattr(cli_mod, "_HA_RETRY_DELAY_S", 0.05)
        argv = [str(tmp_path / "ha") if a == "/nowhere" else a
                for a in argv]
        if argv[0] in ("session", "run"):
            assert cli_main(argv) == 1
            err = capsys.readouterr().err
            assert "error:" in err and "still to port" not in err
        elif argv[0] == "coordinator" and "--ha-dir" in argv:
            self._serves(argv, "elected leader (epoch 1)")
            assert "127.0.0.1" in json.load(
                open(tmp_path / "ha" / "leader.lease"))["address"]
        elif argv[0] == "coordinator":
            port = _free_port()
            argv[argv.index("8081")] = str(port)

            def overview():
                import urllib.request

                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/overview") as r:
                    return json.loads(r.read())

            body = self._serves(argv, f"rest on :{port}", then=overview)
            assert body == {"taskmanagers": 0, "taskmanagers-alive": 0,
                            "jobs": {}}
        else:
            from flink_tpu_torch.runtime.coordinator import start_coordinator

            srv = start_coordinator(Configuration({}))
            try:
                os.makedirs(tmp_path / "ha")
                with open(tmp_path / "ha" / "leader.lease", "w") as f:
                    json.dump({"leader_id": "L", "epoch": 1,
                               "address": f"127.0.0.1:{srv.port}",
                               "claimed_at": time.time()}, f)
                self._serves(argv + ["--device", "cpu",
                                     "--runner-id", "via-lease"],
                             "gateway on")
                assert "via-lease" in srv.endpoint.runners
            finally:
                srv.close()

    @staticmethod
    def _serves(argv, want, then=None, timeout=60.0):
        """Start ``python -m flink_tpu_torch ARGV``, wait for a line
        holding ``want``, call ``then`` while it serves, stop it."""
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.path.join(REPO, "tests"), OMP_NUM_THREADS="2")
        proc = subprocess.Popen(
            [sys.executable, "-m", "flink_tpu_torch", *argv], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            seen = []
            deadline = time.time() + timeout
            while time.time() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
                seen.append(line)
                if want in line:
                    return then() if then is not None else None
            raise AssertionError(f"no {want!r} from {argv}: {seen}")
        finally:
            proc.kill()
            proc.wait(timeout=10)

    def test_python_dash_m_runs_the_port(self, tmp_path):
        """``python -m flink_tpu_torch`` is this command line: a local
        run on the CPU prints its one JSON line and exits 0, without
        loading jax."""
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.path.join(REPO, "tests"), OMP_NUM_THREADS="2")
        code = ("import runpy, sys; sys.argv = ['flink_tpu_torch'] + "
                "sys.argv[1:]\n"
                "try:\n    runpy.run_module('flink_tpu_torch', "
                "run_name='__main__')\n"
                "finally:\n    assert not [m for m in sys.modules "
                "if m.split('.')[0] in ('jax', 'flink_tpu')]\n")
        proc = subprocess.run(
            [sys.executable, "-c", code, "run", "--local", "--device", "cpu",
             "--entry", "test_torch_runner_jobs:build", "--job-id", "m1",
             "--conf", "test.n-batches=3",
             "--conf", f"test.sink-dir={tmp_path / 'sink'}",
             "--conf", "state.num-key-shards=4",
             "--conf", "state.slots-per-shard=16"],
            capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out == {"job_id": "m1", "state": "FINISHED",
                       "records_in": 3 * 64, "records_out": out["records_out"]}
