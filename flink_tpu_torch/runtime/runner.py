"""Task runner — the worker process that executes jobs (the JAX
package's ``runtime/runner.py``, with the same RPC surface and reports).

The port's runner runs its jobs on one kind of device, ``--device``
(``cuda`` by default; the CPU only when asked, as the tests ask), and
reports as its devices (its slots) the CUDA cards this process sees,
``torch.cuda.device_count()``, or on the CPU ``--cpu-devices`` blocks of
the one CPU (1 by default). A runner asked for
``cuda`` without a card exits non-zero at start. Started as its own
process (``python -m``, never forked from a process that has touched
CUDA). With ``--ha-dir`` it finds the coordinator through the HA
leader lease and, after two missed heartbeats, re-reads the lease and
re-registers with the new leader carrying its jobs.

ref: runtime/taskexecutor/TaskExecutor.java (registration with the
ResourceManager, heartbeats, ``submitTask`` receiving a deployment
descriptor, task lifecycle + cancellation) and
TaskManagerRunner.java (the process entrypoint).

TPU-first shape: one runner per HOST, owning that host's devices; a
"task deployment" is a job ENTRY POINT (``module:function`` building a
pipeline on a ``StreamExecutionEnvironment``) plus a configuration —
the analogue of shipping a job jar + JobGraph to a TaskExecutor. The
runner builds the env (including its device mesh from
``cluster.mesh-devices``), runs the driver loop, and reports
finish/failure back to the coordinator, which owns the restart
decision (SURVEY §4.A deploy flow, §4.E failover).

Run as a process::

    python -m flink_tpu_torch.runtime.runner --coordinator HOST:PORT \
        [--device cuda|cpu]
"""
from __future__ import annotations

import collections
import importlib
import threading
import time
import traceback
import uuid
from typing import Any, Dict, Optional

from flink_tpu_torch.runtime.rpc import RpcClient, RpcEndpoint, RpcError, RpcServer


class SavepointRequest(threading.Event):
    """Savepoint trigger flag + completion callback: the driver calls
    ``on_complete(path, stop_after, token)`` after the savepoint is durable, and the runner
    reports the path to the coordinator (the async
    acknowledgeSavepoint leg of the reference's savepoint flow).

    ``stop_after`` = stop-with-savepoint (ref: `flink stop
    --savepoint`): the job's cancel flag is set the moment the
    savepoint is durable, so the old attempt cannot keep committing
    past the savepoint it just took (the rescale handoff). ``token``
    identifies WHICH request this was — the coordinator matches it so
    an unrelated savepoint's completion can never be mistaken for the
    rescale's."""

    def __init__(self, runner: "TaskRunner", job_id: str) -> None:
        super().__init__()
        self._runner = runner
        self._job_id = job_id
        self.stop_after = False
        self.token: Optional[str] = None

    def on_complete(self, path: str, stop_after: bool,
                    token: Optional[str]) -> None:
        # the driver passes the (stop_after, token) it captured at
        # request PICKUP — the instance attributes may already belong to
        # a newer request by completion time
        # report FIRST, stop only if the report was delivered: stopping
        # on a lost report would leave the job halted here but RUNNING
        # forever on the coordinator (no redeploy, no failure routing) —
        # better to keep running at the old width and let the operator
        # retry the rescale
        delivered = self._runner._report("savepoint_complete",
                                         job_id=self._job_id, path=path,
                                         token=token)
        if stop_after and delivered:
            with self._runner._lock:
                j = self._runner._jobs.get(self._job_id)
                if j is not None:
                    j["cancel"].set()


class TaskRunner(RpcEndpoint):
    """RPC surface (single dispatch thread): run_job / cancel_job /
    ping. Job execution happens on a worker thread so the RPC endpoint
    stays responsive to cancel + health while a job runs."""

    def __init__(self, coordinator_host: str, coordinator_port: int,
                 runner_id: Optional[str] = None,
                 device: str = "cuda", cpu_devices: int = 1,
                 ha_dir: Optional[str] = None) -> None:
        self.runner_id = runner_id or f"runner-{uuid.uuid4().hex[:8]}"
        self._coord_addr = (coordinator_host, coordinator_port)
        self._ha_dir = ha_dir
        # the device kind its jobs run on, resolved here so that a runner
        # asked for the card fails at start without one
        from flink_tpu_torch.device import resolve_device

        self.device = str(resolve_device(device))
        if cpu_devices > 1 and self.device != "cpu":
            raise ValueError("cpu_devices is for a runner on the CPU")
        self.n_devices = (int(cpu_devices) if self.device == "cpu"
                          else device_count(self.device))
        # modest timeout + NO transport retries: heartbeats are tiny and
        # the beat loop is already periodic retry — transparent
        # reconnect attempts would multiply the timeout against a
        # frozen/partitioned leader and stall failover (leader
        # re-resolution waits out 2 misses)
        self._coord = RpcClient(coordinator_host, coordinator_port,
                                timeout_s=5.0, retries=0)
        self._jobs: Dict[str, Dict[str, Any]] = {}  # job_id -> {cancel, thread}
        # highest leader epoch this runner has acknowledged (register /
        # heartbeat responses carry it under HA): deploy/cancel/
        # savepoint RPCs stamped with a LOWER epoch come from a deposed
        # leader and are rejected — the control-plane fencing mirror of
        # the bus writer-lease epochs. 0 = non-HA (unstamped RPCs pass).
        self._leader_epoch = 0
        # (job_id, attempt, deploy_token) triples whose execution
        # already COMPLETED on this runner: a deploy RPC retried after
        # the response was lost re-sends the SAME token and must be
        # answered accepted, never re-executed — the job record is
        # popped at completion, so the duplicate guard needs this
        # tombstone. Keyed by the per-push token so a legitimate
        # RE-SUBMISSION of the same job id (fresh token) still runs.
        # Bounded FIFO: the ambiguity window is seconds, not hours.
        self._done_attempts: collections.OrderedDict = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        self._closed = False
        self._server: Optional[RpcServer] = None
        self._hb_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------
    def start(self, port: int = 0) -> int:
        """Serve the runner gateway, register with the coordinator,
        start heartbeating. Returns the gateway port."""
        self._server = RpcServer(self, port)
        # register the address the gateway is REACHABLE at (RpcServer
        # binds loopback; a multi-host transport registers its bind addr)
        resp = self._coord.call(
            "register_runner",
            runner_id=self.runner_id,
            host="127.0.0.1",
            n_devices=self.n_devices,
            port=self._server.port,
            jobs=self._carried_jobs(),
        )
        self._note_epoch(resp)
        interval = resp.get("heartbeat_interval_ms", 10_000) / 1000
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, args=(interval,), daemon=True)
        self._hb_thread.start()
        return self._server.port

    def _carried_jobs(self) -> list:
        """In-flight inventory shipped with every (re-)registration:
        the new leader rebuilds slot occupancy from it and re-adopts
        live executions instead of redeploying them blind."""
        with self._lock:
            return [{"job_id": jid, "attempt": rec["attempt"]}
                    for jid, rec in self._jobs.items()]

    def _note_epoch(self, resp: dict) -> None:
        try:
            e = int(resp.get("leader_epoch", 0) or 0)
        except (TypeError, ValueError):
            return
        if e > self._leader_epoch:
            self._leader_epoch = e

    def _heartbeat_loop(self, interval: float) -> None:
        misses = 0
        while not self._closed:
            time.sleep(interval)
            try:
                with self._lock:
                    running = list(self._jobs)
                    recs = dict(self._jobs)
                metrics = {}
                for jid, jrec in recs.items():
                    drv = getattr(jrec.get("env"), "_driver", None)
                    if drv is not None:
                        try:
                            metrics[jid] = drv.live_metrics()
                        except Exception:  # noqa: BLE001 racy reads
                            pass
                from flink_tpu_torch import faults

                faults.fire("runner.heartbeat", exc=RpcError,
                            runner=self.runner_id)
                r = self._coord.call("heartbeat", runner_id=self.runner_id,
                                     jobs=running, metrics=metrics)
                misses = 0
                self._note_epoch(r)
                # revocation: jobs the coordinator no longer considers
                # ours (reassigned after a false-positive loss, or
                # terminal) must stop producing output here — the
                # zombie-attempt fence (ref: fencing tokens /
                # TaskExecutor disconnectJobManager)
                for job_id in r.get("revoked_jobs", []):
                    with self._lock:
                        j = self._jobs.get(job_id)
                        if j is not None:
                            j["cancel"].set()
                if not r.get("known"):
                    # coordinator restarted: re-register CARRYING the
                    # in-flight jobs (ref: TaskExecutor re-connect to
                    # ResourceManager; a new leader on the same address
                    # re-attaches them from this inventory)
                    faults.fire("runner.reattach", exc=RpcError,
                                runner=self.runner_id)
                    self._note_epoch(self._coord.call(
                        "register_runner", runner_id=self.runner_id,
                        host="127.0.0.1",
                        n_devices=self.n_devices,
                        port=self._server.port if self._server else 0,
                        jobs=self._carried_jobs()))
            except (RpcError, ConnectionError):
                # transient (ConnectionError: an injected transport
                # drop fires BEFORE the client's RpcError wrapping —
                # the beat loop must survive it, a dead heartbeat
                # thread never follows a new leader). Next beat
                # retries. In HA mode a coordinator that stays
                # unreachable has likely lost leadership — re-resolve
                # the lease and follow the new leader (ref:
                # TaskExecutor re-connecting after JM leader change)
                misses += 1
                if self._ha_dir and misses >= 2:
                    misses = 0
                    self._follow_leader()

    def _follow_leader(self) -> None:
        from flink_tpu_torch.runtime.ha import leader_address

        addr = leader_address(self._ha_dir)
        if addr is None:
            return
        host, _, port = addr.partition(":")
        if (host, int(port)) == self._coord_addr:
            return  # same leader; outage was transient
        try:
            from flink_tpu_torch import faults

            # the takeover re-attach seam: an injected failure here is
            # a lost re-registration — the next heartbeat miss retries
            # it, so the inventory eventually lands on the new leader
            faults.fire("runner.reattach", exc=RpcError,
                        runner=self.runner_id)
            new = RpcClient(host, int(port), timeout_s=5.0, retries=0)
            self._note_epoch(new.call(
                "register_runner", runner_id=self.runner_id,
                host="127.0.0.1", n_devices=self.n_devices,
                port=self._server.port if self._server else 0,
                jobs=self._carried_jobs()))
        except (RpcError, ConnectionError):
            # new leader not serving yet, or the re-attach push was
            # dropped (runner.reattach chaos): retry next beat — the
            # inventory eventually lands
            return
        old = self._coord
        self._coord_addr = (host, int(port))
        self._coord = new
        # the blob cache captured the old client at first fetch — point
        # it at the new leader (its store shares the durable HA dir)
        cache = getattr(self, "_blob_cache", None)
        if cache is not None:
            cache.rebind(new)
        try:
            old.close()
        except OSError:
            pass

    def close(self) -> None:
        self._closed = True
        if self._server is not None:
            self._server.close()
        self._coord.close()

    # -- rpc methods -----------------------------------------------------
    def rpc_ping(self) -> dict:
        return {"runner_id": self.runner_id, "jobs": list(self._jobs)}

    def _fence_leader_epoch(self, leader_epoch: Optional[int]
                            ) -> Optional[str]:
        """Leader-epoch gate (caller holds the lock): a control RPC
        stamped with a LOWER epoch than this runner has acknowledged
        comes from a deposed leader — reject it so a stale dispatcher's
        late deploy/cancel can never land after a takeover (mirrors
        the bus writer-lease fencing). Unstamped RPCs (non-HA, tests)
        pass; a HIGHER epoch is adopted (the push may arrive before
        the first heartbeat response from the new leader)."""
        if leader_epoch is None:
            return None
        e = int(leader_epoch)
        if e < self._leader_epoch:
            return (f"stale leader epoch {e} < {self._leader_epoch} "
                    "(deposed leader fenced)")
        if e > self._leader_epoch:
            self._leader_epoch = e
        return None

    def rpc_run_job(self, job_id: str, entry: str,
                    config: Optional[dict] = None,
                    attempt: int = 1,
                    py_blobs: Optional[list] = None,
                    deploy_token: Optional[str] = None,
                    leader_epoch: Optional[int] = None) -> dict:
        """Deploy a job: import ``module:function``, build the pipeline,
        execute. The entry-point contract is the job-jar analogue — the
        job's code must be importable on the runner host (ref:
        TaskExecutor.submitTask + TaskDeploymentDescriptor)."""
        with self._lock:
            stale = self._fence_leader_epoch(leader_epoch)
            if stale is not None:
                return {"accepted": False, "reason": stale}
            if (deploy_token is not None and (job_id, attempt,
                                              deploy_token)
                    in self._done_attempts):
                # retried delivery of a push whose attempt already ran
                # to completion here: its outcome was (or is being)
                # reported through _report — re-executing would commit
                # the whole job's output a second time. Token-less
                # callers (tests, direct RPC) keep re-execute
                # semantics.
                return {"accepted": True, "runner_id": self.runner_id,
                        "duplicate": True}
            old = self._jobs.get(job_id)
            if old is not None and old["attempt"] == attempt:
                # duplicate delivery of the SAME attempt (the deploy
                # RPC retried after losing the first response): the job
                # is already running exactly as requested — answer
                # accepted so the retrying coordinator doesn't fail
                # over a healthy deployment
                return {"accepted": True, "runner_id": self.runner_id,
                        "duplicate": True}
            if old is not None and old["attempt"] > attempt:
                return {"accepted": False, "reason": "already running"}
            if old is not None:
                # a NEWER attempt supersedes the stale one still winding
                # down (its failure report can arrive before its thread
                # exits): cancel it here, join it on the NEW worker
                # thread — never on the single RPC dispatch thread,
                # which must stay responsive within the deploy timeout
                old["cancel"].set()
            cancel = threading.Event()
            savepoint = SavepointRequest(self, job_id)
            rec: Dict[str, Any] = {"cancel": cancel, "attempt": attempt,
                                   "savepoint": savepoint,
                                   "config": dict(config or {}),
                                   "deploy_token": deploy_token,
                                   "py_blobs": list(py_blobs or [])}
            t = threading.Thread(
                target=self._run_job,
                args=(job_id, entry, dict(config or {}), attempt, cancel,
                      rec, old),
                daemon=True)
            rec["thread"] = t
            self._jobs[job_id] = rec
            t.start()
        return {"accepted": True, "runner_id": self.runner_id}

    def rpc_cancel_job(self, job_id: str,
                       attempt: Optional[int] = None,
                       leader_epoch: Optional[int] = None) -> dict:
        """``attempt`` is a fencing token: a cancel aimed at attempt N
        must not kill attempt N+1 that superseded it on this runner
        (the rescale stop→redeploy race; ref: execution attempt ids
        fencing cancelTask). None = cancel whatever runs (user cancel).
        ``leader_epoch`` fences a deposed leader's late cancel the same
        way run_job's is fenced."""
        with self._lock:
            stale = self._fence_leader_epoch(leader_epoch)
            if stale is not None:
                return {"ok": False, "reason": stale}
            j = self._jobs.get(job_id)
            if j is None:
                return {"ok": False, "reason": "unknown job"}
            if attempt is not None and j["attempt"] != attempt:
                return {"ok": False, "reason": "attempt superseded"}
            j["cancel"].set()
        return {"ok": True}

    def rpc_trigger_savepoint(self, job_id: str, stop: bool = False,
                              token: Optional[str] = None,
                              leader_epoch: Optional[int] = None) -> dict:
        """Request a savepoint at the job's next batch boundary (ref:
        the CLI `flink savepoint` → JobMaster.triggerSavepoint path).
        Rejected up front when the job has no checkpoint storage — a
        savepoint that could never be written must not report ok. The
        completed path flows back asynchronously via the coordinator's
        savepoint_complete (see SavepointRequest)."""
        from flink_tpu_torch.config import CheckpointingOptions, Configuration

        with self._lock:
            stale = self._fence_leader_epoch(leader_epoch)
            if stale is not None:
                return {"ok": False, "reason": stale}
            j = self._jobs.get(job_id)
            if j is None:
                return {"ok": False, "reason": "unknown job"}
            conf = Configuration(j.get("config", {}))
            if (conf.get(CheckpointingOptions.INTERVAL) <= 0
                    and not conf.get(CheckpointingOptions.RESTORE)):
                return {"ok": False,
                        "reason": "job has no checkpointing configured "
                                  "(execution.checkpointing.interval)"}
            if j["savepoint"].is_set():
                if (j["savepoint"].token == token
                        and j["savepoint"].stop_after == stop):
                    # the SAME request re-delivered (transport retry
                    # after a lost response): it is armed exactly as
                    # asked — ok, or the retrying caller would wrongly
                    # treat an in-flight savepoint as failed (and a
                    # rescale would disarm while its savepoint runs)
                    return {"ok": True, "dispatched": True,
                            "duplicate": True}
                # a DIFFERENT pending request's stop/token must not be
                # overwritten (a routine savepoint racing a rescale's
                # would strip the rescale token and strand it armed
                # forever)
                return {"ok": False, "reason": "savepoint already pending"}
            j["savepoint"].stop_after = stop
            j["savepoint"].token = token
            j["savepoint"].set()
        return {"ok": True, "dispatched": True}

    # -- execution -------------------------------------------------------
    def _run_job(self, job_id: str, entry: str, config: dict,
                 attempt: int, cancel: threading.Event,
                 rec: Dict[str, Any],
                 old: Optional[Dict[str, Any]] = None) -> None:
        from flink_tpu_torch.api.environment import StreamExecutionEnvironment
        from flink_tpu_torch.config import Configuration
        import torch

        from flink_tpu_torch.runtime.driver import JobCancelledError

        if old is not None:
            # bounded wait for the superseded attempt (already
            # cancelled) — it stops at its next batch boundary; if it is
            # wedged past this, its cancel flag still discards output
            old["thread"].join(timeout=30.0)
        jobdir = None
        try:
            jobdir = self._stage_blobs(job_id, attempt,
                                       rec.get("py_blobs") or [])
            mod_name, _, fn_name = entry.partition(":")
            mod = importlib.import_module(mod_name)
            build = getattr(mod, fn_name)
            # identity injection: the driver's coordinator-side split
            # enumeration (source.enumeration=coordinator) needs to know
            # which runner it is and where the enumerator lives
            config.setdefault("cluster.job-id", job_id)
            config.setdefault("cluster.runner-id", self.runner_id)
            config.setdefault(
                "cluster.coordinator",
                f"{self._coord_addr[0]}:{self._coord_addr[1]}")
            from flink_tpu_torch import faults

            # session tenant isolation: a session-deployed job's
            # faults.* plan installs keyed to ITS job id, never in the
            # process-global slot — co-resident jobs on this runner are
            # invisible to it. Idempotent across recovery re-deploys
            # (counters persist, so count-limited rules don't re-fire
            # forever). Non-session deploys keep the documented
            # process-global posture: chaos runs get their own runner.
            scoped = bool(config.get("session.scoped-faults"))
            if scoped:
                # attempt 1 = a NEW submission: always a fresh plan (a
                # prior FAILED tenant with this id may have left
                # exhausted counters behind); attempt >= 2 = recovery
                # of THIS submission: keep counters
                faults.install_scoped(job_id, Configuration(config),
                                      fresh=attempt <= 1)
            with faults.job_scope(job_id if scoped else None):
                env = StreamExecutionEnvironment(Configuration(config))
                if self.device == "cpu" and self.n_devices > 1:
                    env.mesh_devices = [torch.device("cpu")] * self.n_devices
                build(env)
                rec["env"] = env  # live-metrics seam for heartbeats
                self._report_plan(job_id, env)
                env.execute(job_id, device=self.device, cancel=cancel,
                            savepoint_request=rec.get("savepoint"))
            self._report("finish_job", job_id=job_id, attempt=attempt,
                         runner_id=self.runner_id)
            if scoped:
                faults.uninstall_scoped(job_id)
        except JobCancelledError:
            # the canceller (coordinator) already owns the state; a
            # cancelled tenant's scoped plan leaves with it
            from flink_tpu_torch import faults

            faults.uninstall_scoped(job_id)
        except BaseException:  # noqa: BLE001 — every fault goes upstream
            self._report("report_failure", job_id=job_id, attempt=attempt,
                         error=traceback.format_exc(limit=5))
        finally:
            if jobdir is not None:
                import sys

                try:
                    sys.path.remove(jobdir)
                except ValueError:
                    pass
            with self._lock:
                # pop only OUR record — a superseding attempt may have
                # already replaced it
                if self._jobs.get(job_id) is rec:
                    self._jobs.pop(job_id)
                # tombstone the completed push so a late deploy-RPC
                # retry can't re-execute it (see rpc_run_job)
                if rec.get("deploy_token") is not None:
                    self._done_attempts[
                        (job_id, attempt, rec["deploy_token"])] = True
                    while len(self._done_attempts) > 64:
                        self._done_attempts.popitem(last=False)

    def _stage_blobs(self, job_id: str, attempt: int,
                     py_blobs: list) -> Optional[str]:
        """Fetch job-code artifacts from the coordinator's blob store
        and stage them into a per-attempt import dir (ref:
        BlobCacheService + per-job classloader isolation: each attempt
        gets its own view of the code, so a re-submission with changed
        code cannot be shadowed by a stale cache entry). EVERY shipped
        module name is dropped from sys.modules — popping just the entry
        would leave its shipped imports (helper modules) cached from a
        prior attempt. Returns the import dir; the caller removes it
        from sys.path when the job ends. Known limit: sys.path is
        process-global, so two CONCURRENT jobs shipping the same module
        name can still cross-import — full isolation needs per-job
        processes (the per-job classloader analogue)."""
        if not py_blobs:
            return None
        import os
        import sys

        from flink_tpu_torch.runtime.blob import BlobCache

        if getattr(self, "_blob_cache", None) is None:
            self._blob_cache = BlobCache(self._coord)
        jobdir = os.path.join(self._blob_cache.dir,
                              f"job-{job_id}-a{attempt}")
        for b in py_blobs:
            self._blob_cache.materialize(b["digest"], jobdir, b["name"])
            if b["name"].endswith(".py"):
                sys.modules.pop(b["name"][:-3], None)
        if jobdir not in sys.path:
            sys.path.insert(0, jobdir)
        return jobdir

    def _report_plan(self, job_id: str, env) -> None:
        """Report the compiled plan's stages so the coordinator's
        ExecutionGraph materializes real vertices (graph lowering is
        pure Python — compiling here costs microseconds and keeps job
        code off the coordinator)."""
        try:
            from flink_tpu_torch.graph.compiler import compile_job

            plan = compile_job(env._transforms, env._watermark_strategy,
                               env.config)
            stages = [
                f"{plan.node(nid).kind}:{plan.node(nid).name or nid}"
                for nid in plan.topo_order]
            self._report("report_plan", job_id=job_id, stages=stages)
        except Exception:  # noqa: BLE001 — reporting is best-effort
            pass

    def _report(self, method: str, **kw: Any) -> bool:
        """One-shot lifecycle reports (finish/failure/savepoint/plan).
        Unlike heartbeats these have NO periodic retry behind them — a
        single dropped connection would wedge the job on the
        coordinator (RUNNING forever after a lost finish_job, found by
        the chaos drive) — so the report itself retries a few times
        before giving up to the coordinator's own recovery resync."""
        for i in range(3):
            try:
                self._coord.call(method, **kw)
                return True
            except RpcError:
                if i < 2:
                    time.sleep(0.2 * (i + 1))
        return False  # coordinator down: its recovery re-syncs state


def device_count(device: str) -> int:
    """The devices (slots) a runner on ``device``'s kind reports: the
    CUDA cards this process sees, or the one CPU."""
    import torch

    return torch.cuda.device_count() if device.startswith("cuda") else 1


def arg_parser():
    """The runner process's command line."""
    import argparse

    p = argparse.ArgumentParser(description="flink_tpu_torch task runner")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--ha-dir", default=None,
                   help="resolve the coordinator via the HA leader "
                        "lease instead of a fixed address")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--runner-id", default=None)
    p.add_argument("--device", default="cuda",
                   help="the device kind this runner's jobs run on: "
                        "'cuda' (default; fails without a card) or 'cpu'")
    p.add_argument("--cpu-devices", type=int, default=1, metavar="N",
                   help="with --device cpu: offer N blocks of the one CPU "
                        "as this runner's devices (a mesh job's blocks)")
    return p


def main(argv: Optional[list] = None) -> None:
    p = arg_parser()
    args = p.parse_args(argv)
    addr = args.coordinator
    if addr is None:
        if not args.ha_dir:
            p.error("one of --coordinator or --ha-dir is required")
        from flink_tpu_torch.runtime.ha import leader_address

        deadline = time.time() + 60
        while (addr := leader_address(args.ha_dir)) is None:
            if time.time() > deadline:
                raise SystemExit("no leader found in --ha-dir within 60s")
            time.sleep(0.5)
    host, _, port = addr.partition(":")
    runner = TaskRunner(host, int(port), runner_id=args.runner_id,
                        device=args.device, cpu_devices=args.cpu_devices,
                        ha_dir=args.ha_dir)
    gateway = runner.start(args.port)
    print(f"runner {runner.runner_id} gateway on :{gateway} "
          f"({runner.device}, {runner.n_devices} device(s))", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        runner.close()


if __name__ == "__main__":
    main()
