"""Job coordinator — the control-plane master process (the JAX
package's ``runtime/coordinator.py``; its RPC methods and replies are
the reference's, so a client or runner of either package talks to a
coordinator of the other). With ``high-availability.dir`` it writes
every deployable job through to the HA job store (``runtime/ha.py``),
re-hydrates the store when it takes leadership, re-adopts the live
executions that re-registering runners carry, and stamps its leader
epoch on every push; ``main`` contends for the lease (``--ha-dir``) and
serves the REST API (``--rest-port``, ``obs/rest.py``).

ref: runtime/dispatcher/Dispatcher.java (submission + bookkeeping),
runtime/jobmaster/JobMaster.java (per-job control), runtime/heartbeat/
{HeartbeatManagerImpl,HeartbeatMonitorImpl}.java (failure detection),
runtime/resourcemanager (runner inventory).

TPU-first shape (SURVEY §3.6 mapping): the coordinator is a HOST-level
concept — one per job cluster, tracking per-host runners. Data-plane
exchange never touches it (keyed repartition is an in-step ICI
all_to_all); it carries only job lifecycle, heartbeats, checkpoint
control, and rescale decisions, so message volume is tiny and a single
endpoint thread suffices (the RpcEndpoint discipline).
"""
from __future__ import annotations

import dataclasses
import os
import secrets
import threading
import time
from typing import Any, Dict, List, Optional

from flink_tpu_torch.config import ClusterOptions, Configuration
from flink_tpu_torch.runtime.restart import RestartStrategy, from_config
from flink_tpu_torch.runtime.rpc import RpcEndpoint, RpcServer
from flink_tpu_torch.runtime.scheduler import ExecutionGraph, SlotPool


@dataclasses.dataclass
class RunnerInfo:
    runner_id: str
    host: str
    n_devices: int
    last_heartbeat: float
    alive: bool = True
    port: int = 0  # runner gateway (0 = bookkeeping-only registration)
    # scale-in drain: no NEW allocations land here; existing jobs
    # stop-with-savepoint and redeploy elsewhere (rpc_drain_runner)
    draining: bool = False


@dataclasses.dataclass
class JobInfo:
    job_id: str
    state: str = "CREATED"  # CREATED RUNNING RESTARTING FAILED FINISHED CANCELED
    attempts: int = 0
    assigned_runners: List[str] = dataclasses.field(default_factory=list)
    failure: Optional[str] = None
    # deployment descriptor (None = bookkeeping-only submission): the
    # job-jar analogue — an importable ``module:function`` that builds
    # the pipeline on an env, plus its configuration
    entry: Optional[str] = None
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # newest completed savepoint path (reported by the runner)
    last_savepoint: Optional[str] = None
    # device-slot demand (cluster.mesh-devices; "all" resolves at pick)
    required_devices: int = 1
    # job-code artifacts: [{"name": "mod.py", "digest": sha256}] the
    # runner fetches from the blob store before importing the entry
    py_blobs: List[Dict[str, str]] = dataclasses.field(default_factory=list)
    # live-rescale handshake (ref: AdaptiveScheduler + REST rescale):
    # target width while the pre-rescale savepoint is in flight, the
    # token identifying THAT savepoint (an unrelated savepoint's
    # completion must not consume the rescale), and the one-shot
    # restore path the next deploy consumes
    pending_rescale: Optional[int] = None
    rescale_token: Optional[str] = None
    restore_path: Optional[str] = None
    # process-level rescale: target host-process count (None = keep the
    # current cluster.num-processes), and the per-process savepoint
    # paths collected so far — a cross-host rescale consumes only once
    # EVERY process's savepoint has landed (the paths travel to the new
    # topology via cluster.rescale-from for the key-group repartition)
    pending_rescale_procs: Optional[int] = None
    rescale_paths: List[str] = dataclasses.field(default_factory=list)
    # time-to-rescale clock: stamped at arm, observed into the
    # rescale.duration_ms histogram when the redeploy lands
    rescale_started_at: Optional[float] = None
    last_rescale_done_at: Optional[float] = None
    # reactive controller bookkeeping: when the pressure signal left
    # the target band, and on which side (one in-band sample resets it)
    pressure_out_since: Optional[float] = None
    pressure_side: Optional[str] = None
    # scale-in drain: runner the post-savepoint redeploy must avoid
    drain_exclude: Optional[str] = None
    # per-runner completion of the CURRENT attempt: the job finishes
    # when every assigned runner reports done (an empty-split-share
    # runner finishing early must not end the whole job)
    finished_runners: List[str] = dataclasses.field(default_factory=list)
    # physical graph: stages × parallelism, per-attempt execution states
    egraph: Optional[ExecutionGraph] = None
    # newest heartbeat-carried driver metrics (web UI gauges)
    last_metrics: Optional[Dict[str, Any]] = None
    # lifecycle stamps (session registry / bench wall clocks): submit
    # receipt, first successful deploy, terminal transition
    submitted_at: float = dataclasses.field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    # leader-takeover re-attach window (HA recovery of a job the store
    # says was RUNNING): until ``reattach_until`` the new leader waits
    # for a runner to re-register carrying (job_id, reattach_attempt)
    # and re-adopts the live execution in place instead of redeploying
    # blind; the window collapses early when one of the job's stored
    # runners comes back WITHOUT it (the job died there). attempts is
    # pre-bumped for the fallback redeploy; re-attach rolls it back.
    reattach_until: Optional[float] = None
    reattach_attempt: Optional[int] = None
    reattach_runners: List[str] = dataclasses.field(default_factory=list)


class JobCoordinator(RpcEndpoint):
    """RPC surface (all single-threaded via RpcServer dispatch):
    register_runner / heartbeat / submit_job / job_status / cancel_job /
    report_failure / list_runners. A monitor thread expires runners whose
    heartbeats stop (ref: heartbeat.timeout, default 50s)."""

    def __init__(self, config: Optional[Configuration] = None) -> None:
        from flink_tpu_torch.config import HighAvailabilityOptions

        self.config = config or Configuration()
        self.runners: Dict[str, RunnerInfo] = {}
        self.jobs: Dict[str, JobInfo] = {}
        # leadership fencing token (HA serve loops stamp the election
        # epoch here before the RPC server starts): every deploy/cancel/
        # savepoint push to a runner carries it, and the runner rejects
        # a lower epoch — a deposed leader's late RPCs land dead (the
        # writer-lease fencing discipline of the bus, log/bus.py).
        # 0 = non-HA single coordinator (pushes stay unstamped).
        self.leader_epoch = 0
        self._slots = SlotPool()
        # active-resource seam (ref: ActiveResourceManager): unmet slot
        # demand is pushed here; standalone mode just records it
        from flink_tpu_torch.runtime.provisioner import StandaloneProvisioner

        self.provisioner = StandaloneProvisioner()
        # coordinator-scoped metrics (the SessionDispatcher adds its
        # session-plane gauges to the SAME registry, so session info /
        # REST surface both). Time-to-rescale + per-phase counters live
        # here: the handshake spans attempts and runners, so only the
        # coordinator can clock it end to end.
        from flink_tpu_torch.obs.metrics import MetricRegistry

        self.registry = MetricRegistry()
        g = self.registry.group("coordinator", "rescale")
        self._m_rescale = {
            "armed": g.counter("armed"),
            "savepoint": g.counter("savepoint"),
            "redeploy": g.counter("redeploy"),
            "disarmed": g.counter("disarmed"),
            "duration_ms": g.histogram("duration_ms"),
        }
        # (job_id, attempt) -> {process_id: "host:port"} — the DCN
        # exchange rendezvous for cross-host jobs
        self._dcn_table: Dict[tuple, Dict[int, str]] = {}
        self._strategies: Dict[str, RestartStrategy] = {}
        # HA job store: non-terminal deployable jobs survive coordinator
        # loss — a new leader re-deploys them with restore:latest (ref:
        # JobGraphStore + Dispatcher recovery)
        self._store = None
        ha_dir = str(self.config.get(HighAvailabilityOptions.HA_DIR)).strip()
        # blob store: job-code artifacts, content-addressed (ref:
        # BlobServer). Under HA it shares the durable HA dir so a new
        # leader still serves old submissions' code.
        from flink_tpu_torch.runtime.blob import BlobStore

        self._blobs = BlobStore(
            os.path.join(ha_dir, "blobs") if ha_dir else None)
        if ha_dir:
            from flink_tpu_torch.runtime.ha import JobStore

            self._store = JobStore(ha_dir)
            self._recover_from_store()
        self._hb_timeout = self.config.get(ClusterOptions.HEARTBEAT_TIMEOUT) / 1000
        self._lock = threading.Lock()  # monitor thread + rpc thread
        self._closed = False
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True)
        self._monitor.start()

    def _required_devices_from_config(self, conf: Dict[str, Any]) -> int:
        """Slot demand of a stored job record (the SessionDispatcher
        overrides this to read the session slot quota instead)."""
        spec = str(conf.get("cluster.mesh-devices", "") or "").strip()
        return (SlotPool.ALL if spec == "all"
                else max(1, int(spec)) if spec.isdigit() else 1)

    def _recover_from_store(self) -> None:
        """Re-hydrate every non-terminal deployable job from the HA
        store (ref: Dispatcher.recoverJobs → JobMaster restore from the
        CompletedCheckpointStore; checkpoint manifests are already
        durable under the job's checkpoint dir). Two classes:

        - stored RUNNING/RESTARTING: the execution may STILL be live on
          its runner (leader loss is not runner loss) — park with a
          re-attach window so the runner re-registering with its
          in-flight job ids re-adopts the attempt in place; only after
          the window (or the runner coming back without the job) does
          the bumped-attempt redeploy with restore:latest fire.
        - stored WAITING_FOR_RESOURCES/CREATED: never deployed — re-
          queue at the ORIGINAL attempt and the original submitted_at,
          so the FIFO submission order survives the takeover.
        """
        from flink_tpu_torch.config import SessionOptions

        grace = self.config.get(SessionOptions.HA_REATTACH_GRACE) / 1000
        now = time.time()
        for rec in self._store.recoverable():
            job_id = rec["job_id"]
            stored_attempts = int(rec.get("attempts", 1))
            conf = dict(rec.get("config", {}))
            required = self._required_devices_from_config(conf)
            was_live = rec.get("state") in ("RUNNING", "RESTARTING")
            j = JobInfo(
                job_id, state="WAITING_FOR_RESOURCES",
                attempts=stored_attempts + 1 if was_live
                else stored_attempts,
                entry=rec.get("entry"), config=conf,
                failure=("recovered by new leader; awaiting runner "
                         "re-attach" if was_live
                         else "recovered by new leader; re-queued"),
                required_devices=required,
                py_blobs=list(rec.get("py_blobs", [])),
                egraph=ExecutionGraph(job_id, required))
            if rec.get("submitted_at") is not None:
                j.submitted_at = float(rec["submitted_at"])
            rsc = rec.get("rescale")
            if rsc and was_live:
                # re-arm the stored in-flight rescale: once the runner
                # re-attaches the live execution, _reattach_locked
                # re-triggers the stop-with-savepoint under the SAME
                # token (the runner's dedup absorbs the duplicate); a
                # redeploy path instead disarms it in _deploy — the
                # savepoint died with the attempt
                j.pending_rescale = (int(rsc["devices"])
                                     if rsc.get("devices") else None)
                j.pending_rescale_procs = rsc.get("processes")
                j.rescale_token = rsc.get("token")
                j.rescale_paths = list(rsc.get("paths") or [])
                j.rescale_started_at = rsc.get("started_at")
                j.drain_exclude = rsc.get("drain_exclude")
            if was_live:
                j.reattach_attempt = stored_attempts
                j.reattach_until = now + grace
                j.reattach_runners = list(rec.get("assigned_runners", []))
                # keep the stored assignment visible through the window:
                # a cancel during it still routes to the runner that may
                # hold the live execution
                j.assigned_runners = list(j.reattach_runners)
            self.jobs[job_id] = j
            self._strategies[job_id] = from_config(self.config)
            if not was_live:
                self._persist_locked(j)
            # was_live jobs are NOT re-persisted here: the stored
            # RUNNING record (original attempt + runner) IS the durable
            # truth that the execution may still be live — overwriting
            # it with this leader's parked WAITING view would make a
            # SECOND failover during the window recover the job as
            # never-deployed and blind-redeploy beside the live
            # attempt. The record advances only when something real
            # happens: re-attach, redeploy, or a terminal transition.

    def _persist_locked(self, j: JobInfo) -> None:
        """Write-through to the HA job store (caller holds the lock or
        is in single-threaded init)."""
        if self._store is None:
            return
        if j.entry is None:
            return  # bookkeeping-only jobs are not recoverable
        # an armed rescale rides the record: a dispatcher takeover must
        # resume (or cleanly disarm) the in-flight handshake, never
        # forget it with the dead leader's memory
        rescale = None
        if j.pending_rescale is not None:
            rescale = {"devices": j.pending_rescale,
                       "processes": j.pending_rescale_procs,
                       "token": j.rescale_token,
                       "paths": list(j.rescale_paths),
                       "started_at": j.rescale_started_at,
                       "drain_exclude": j.drain_exclude}
        self._store.put(j.job_id, entry=j.entry, config=j.config,
                        state=j.state, attempts=j.attempts,
                        py_blobs=j.py_blobs,
                        submitted_at=j.submitted_at,
                        assigned_runners=j.assigned_runners,
                        rescale=rescale)

    def _disarm_rescale_locked(self, j: JobInfo,
                               persist: bool = True) -> None:
        """Clear an armed-but-unconsumed rescale (lock held). Every
        disarm path funnels here so the phase counter and the durable
        record stay truthful; a consumed rescale (savepoints landed,
        redeploy dispatched) is NOT a disarm and never calls this."""
        if j.pending_rescale is None and j.rescale_token is None:
            return
        j.pending_rescale = None
        j.rescale_token = None
        j.pending_rescale_procs = None
        j.rescale_paths = []
        j.rescale_started_at = None
        j.drain_exclude = None
        self._m_rescale["disarmed"].inc()
        if persist:
            self._persist_locked(j)

    # -- rpc methods -----------------------------------------------------
    def rpc_register_runner(self, runner_id: str, host: str, n_devices: int,
                            port: int = 0,
                            jobs: Optional[List[Dict[str, Any]]] = None
                            ) -> dict:
        """``jobs`` is the runner's in-flight inventory
        (``[{"job_id", "attempt"}, ...]``): after a leader takeover the
        runner re-registers CARRYING it, so slot-pool occupancy is
        rebuilt from truth — a live execution is re-adopted in place
        (never redeployed blind) and its slots are re-allocated before
        any queued job can claim them. Legacy registrations omit it
        (None), which reads as 'carrying nothing'."""
        waiting: List[str] = []
        with self._lock:
            self.runners[runner_id] = RunnerInfo(
                runner_id, host, n_devices, time.time(), port=port)
            carried = {str(e.get("job_id")): int(e.get("attempt", 1))
                       for e in (jobs or [])}
            self._reattach_locked(runner_id, carried)
            # new capacity: kick jobs parked on WAITING_FOR_RESOURCES
            # (ref: AdaptiveScheduler WaitingForResources → Executing on
            # new slots)
            waiting = self._waiting_locked()
        for job_id in waiting:
            self._deploy_async(job_id)
        return {"heartbeat_interval_ms":
                self.config.get(ClusterOptions.HEARTBEAT_INTERVAL),
                "leader_epoch": self.leader_epoch}

    def _reattach_locked(self, runner_id: str,
                         carried: Dict[str, int]) -> None:
        """Re-adopt recovered jobs a (re-)registering runner still
        runs. For each job in its takeover re-attach window:

        - the runner carries (job_id, attempt == reattach_attempt):
          the execution is LIVE — re-allocate its slots on that runner,
          roll the pre-bumped attempt back, mark RUNNING. No redeploy,
          so committed output stays exactly-once across the takeover.
        - the runner is one of the job's stored hosts but does NOT
          carry it: the execution died there — collapse the window so
          the checkpoint-restore redeploy fires now instead of waiting
          out the grace.

        Jobs the runner carries that this leader does not know (or
        knows under a different attempt) are left to the heartbeat
        revocation fence."""
        for j in self.jobs.values():
            if j.reattach_attempt is None:
                continue
            if j.state != "WAITING_FOR_RESOURCES":
                # the window only re-adopts a job still PARKED by
                # recovery: one canceled (or otherwise transitioned)
                # during the window must never be resurrected to
                # RUNNING by its returning runner — the heartbeat
                # revocation fence stops the runner-side zombie
                j.reattach_attempt = None
                j.reattach_until = None
                j.reattach_runners = []
                continue
            att = carried.get(j.job_id)
            nproc = max(1, int(j.config.get("cluster.num-processes", 1)))
            if nproc > 1:
                # a cross-host job is only whole with ALL its process
                # allocations; re-adopting through one runner's
                # inventory would mis-account the rest — collapse to
                # the restore redeploy once ANY stored runner returns
                if runner_id in j.reattach_runners:
                    j.reattach_attempt = None
                    j.reattach_until = None
                    j.reattach_runners = []
                    j.assigned_runners = []
                continue
            if att is not None and att == j.reattach_attempt:
                r = self.runners[runner_id]
                resolved = (r.n_devices
                            if j.required_devices == SlotPool.ALL
                            else j.required_devices)
                self._slots.release(j.job_id)
                self._slots.allocate(j.job_id, runner_id, resolved)
                j.attempts = j.reattach_attempt
                j.state = "RUNNING"
                j.failure = None
                j.assigned_runners = [runner_id]
                j.finished_runners = []
                if j.started_at is None:
                    j.started_at = time.time()
                j.reattach_attempt = None
                j.reattach_until = None
                j.reattach_runners = []
                if j.egraph is not None:
                    j.egraph.start_attempt(j.attempts, runner_id)
                    j.egraph.transition("RUNNING", attempt=j.attempts)
                self._persist_locked(j)
                if j.pending_rescale is not None and j.rescale_token:
                    # resume the takeover-recovered rescale: re-trigger
                    # the stop-with-savepoint under the stored token
                    # once the re-adopted execution is RUNNING. Same
                    # token pending on the runner → idempotent ack; an
                    # already-completed-but-unreported savepoint →
                    # a fresh one supersedes it. Off-thread: we hold
                    # the coordinator lock here.
                    tok = j.rescale_token
                    t = threading.Timer(
                        0.3, self.rpc_trigger_savepoint,
                        args=(j.job_id,),
                        kwargs={"stop": True, "token": tok})
                    t.daemon = True
                    t.start()
            elif runner_id in j.reattach_runners:
                j.reattach_attempt = None
                j.reattach_until = None
                j.reattach_runners = []
                j.assigned_runners = []

    def _waiting_locked(self) -> List[str]:
        return [j.job_id for j in self.jobs.values()
                if j.state == "WAITING_FOR_RESOURCES"
                and j.entry is not None]

    def rpc_heartbeat(self, runner_id: str, metrics: Optional[dict] = None,
                      jobs: Optional[List[str]] = None) -> dict:
        """Heartbeat + job-lease check: ``jobs`` the runner reports
        running but that are no longer assigned to it (reassigned after
        a false-positive loss, cancelled, terminal) come back as
        ``revoked_jobs`` — the runner must cancel them before they
        produce output (the fencing-token role, ref: JobMaster fencing /
        TaskExecutor disconnect)."""
        revoked: List[str] = []
        with self._lock:
            r = self.runners.get(runner_id)
            if r is None:
                # re-register (coordinator restarted / new leader)
                return {"known": False, "leader_epoch": self.leader_epoch}
            r.last_heartbeat = time.time()
            r.alive = True
            for jid, m in (metrics or {}).items():
                jm = self.jobs.get(jid)
                # same zombie fence as the revocation below: a runner
                # this job is no longer assigned to must not repaint
                # the live attempt's metrics
                if (jm is not None and jid in (jobs or [])
                        and runner_id in jm.assigned_runners):
                    jm.last_metrics = {**m, "runner": runner_id,
                                       "stamp": time.time()}
            for job_id in jobs or []:
                j = self.jobs.get(job_id)
                # RESTARTING revokes too: the coordinator already
                # declared this attempt dead — a falsely-lost runner
                # must stop committing during the restart delay
                if j is None or j.state in (
                        "CANCELED", "FAILED", "RESTARTING") or (
                        runner_id not in j.assigned_runners):
                    revoked.append(job_id)
        return {"known": True, "revoked_jobs": revoked,
                "leader_epoch": self.leader_epoch}

    def rpc_submit_job(self, job_id: str, runners: Optional[List[str]] = None,
                       entry: Optional[str] = None,
                       config: Optional[dict] = None,
                       py_blobs: Optional[List[Dict[str, str]]] = None) -> dict:
        """Submit a job. With an ``entry`` (module:function deployment
        descriptor) the plan is PUSHED to a chosen runner's gateway —
        the Dispatcher.submitJob → JobMaster → TaskExecutor.submitTask
        flow; without one it is bookkeeping-only (legacy tests)."""
        conf = dict(config or {})
        spec = str(conf.get("cluster.mesh-devices", "") or "").strip()
        if spec == "all":
            required = SlotPool.ALL  # whole-runner: resolved at pick
        else:
            required = max(1, int(spec)) if spec.isdigit() else 1
        with self._lock:
            alive = [r.runner_id for r in self.runners.values() if r.alive]
            chosen = runners or alive
            job = JobInfo(job_id, state="RUNNING", attempts=1,
                          assigned_runners=chosen, entry=entry,
                          config=conf, required_devices=required,
                          py_blobs=list(py_blobs or []),
                          egraph=ExecutionGraph(job_id, required))
            self.jobs[job_id] = job
            self._strategies[job_id] = from_config(self.config)
            self._persist_locked(job)
        if entry is not None:
            self._deploy_async(job_id)
        return {"assigned": chosen}

    # -- deployment ------------------------------------------------------
    def _admit_locked(self, j: JobInfo) -> bool:
        """Admission gate consulted by _deploy under the lock before any
        slot is allocated. The base coordinator admits everything; the
        SessionDispatcher overrides it with the max-jobs headroom check
        (queued jobs park in WAITING_FOR_RESOURCES until a running job
        frees headroom — the finish/cancel capacity kicks re-deploy
        them in submission order)."""
        return True

    def _admit_refusal(self, j: JobInfo) -> str:
        """Human-readable parking reason when _admit_locked refuses."""
        return "queued by the admission gate"

    def _deploy_config_locked(self, j: JobInfo, config: Dict[str, Any],
                              target: "RunnerInfo") -> Dict[str, Any]:
        """Per-deploy config injection (lock held, slots allocated):
        the SessionDispatcher stamps admission-decided resource shares
        here; the base coordinator pushes the job's config untouched."""
        return config

    def _deploy_async(self, job_id: str, delay_s: float = 0.0,
                      exclude: Optional[List[str]] = None) -> None:
        """Push the job's deployment descriptor to an alive runner on a
        side thread — dispatch RPCs must not block the endpoint's single
        dispatch thread (heartbeats ride it)."""
        t = threading.Timer(delay_s, self._deploy, args=(job_id, exclude or []))
        t.daemon = True
        t.start()

    def _deploy(self, job_id: str, exclude: List[str]) -> None:
        from flink_tpu_torch.runtime.rpc import RpcClient, RpcError

        with self._lock:
            j = self.jobs.get(job_id)
            if j is None or j.entry is None or j.state not in (
                    "RUNNING", "RESTARTING", "WAITING_FOR_RESOURCES"):
                return
            # racing capacity kicks (register + finish can each wake the
            # same WAITING job): a job that is RUNNING with a live
            # allocation is already deployed — the second kick must not
            # re-deploy it onto another runner
            if (j.state == "RUNNING"
                    and self._slots.allocation(job_id) is not None):
                return
            # takeover re-attach window: the execution may still be
            # LIVE on its pre-takeover runner — a blind redeploy here
            # would run the job twice. Deploy kicks defer until the
            # runner re-attaches it, comes back without it, or the
            # grace expires (the monitor loop re-kicks then).
            if j.reattach_until is not None:
                if time.time() < j.reattach_until:
                    j.state = "WAITING_FOR_RESOURCES"
                    j.failure = ("awaiting runner re-attach after "
                                 "leader takeover")
                    return
                j.reattach_attempt = None
                j.reattach_until = None
                j.reattach_runners = []
                j.assigned_runners = []
            # session-mode admission seam (runtime/session.py): the
            # base coordinator admits every deploy; a SessionDispatcher
            # parks jobs past its max-jobs headroom back on the queue.
            # Checked UNDER the lock so racing capacity kicks cannot
            # admit two jobs into one remaining slot of headroom.
            if not self._admit_locked(j):
                j.state = "WAITING_FOR_RESOURCES"
                j.failure = self._admit_refusal(j)
                return
            # a rescale still ARMED when a redeploy proceeds is stale:
            # the stop-with-savepoint it was waiting on died with the
            # old attempt (runner loss, reattach expiry) — recovery
            # keeps the old width and the intent disarms cleanly
            if j.pending_rescale is not None:
                self._disarm_rescale_locked(j, persist=False)
            # slot allocation: best-fit over free device counts; a retry
            # releases the previous allocation first (ref:
            # ExecutionSlotAllocator + FineGrainedSlotManager matching).
            # Draining runners and a drain's source runner never
            # receive the allocation.
            self._slots.release(job_id)
            full_exclude = list(exclude) + [
                r.runner_id for r in self.runners.values() if r.draining]
            if j.drain_exclude:
                full_exclude.append(j.drain_exclude)
            nproc = max(1, int(j.config.get("cluster.num-processes", 1)))
            if nproc > 1:
                # cross-host job: one DISTINCT runner per process, each
                # with the per-process device demand; all-or-nothing
                targets = []
                ex2 = list(full_exclude)
                for _ in range(nproc):
                    t = self._slots.pick(
                        job_id + f"#p{len(targets)}", j.required_devices,
                        list(self.runners.values()), exclude=ex2)
                    if t is None:
                        targets = None
                        break
                    targets.append(t)
                    ex2.append(t.runner_id)
                target = targets[0] if targets else None
            else:
                targets = None
                target = self._slots.pick(
                    job_id, j.required_devices,
                    list(self.runners.values()), exclude=full_exclude)
            if target is None:
                # park until capacity registers (ref: AdaptiveScheduler
                # WaitingForResources); a lost-runner retry with no
                # fallback runner waits here too instead of failing.
                # Unmet demand reaches the provisioner seam (ref:
                # ActiveResourceManager requesting new workers).
                j.state = "WAITING_FOR_RESOURCES"
                j.failure = (
                    f"waiting for a runner with {j.required_devices} "
                    "free device(s)")
                demands = [
                    {"job_id": w, "required_devices":
                     self.jobs[w].required_devices}
                    for w in self._waiting_locked()]
                prov = self.provisioner
                threading.Thread(
                    target=lambda: prov.request_capacity(demands),
                    daemon=True).start()
                return
            j.drain_exclude = None
            resolved = (target.n_devices
                        if j.required_devices == SlotPool.ALL
                        else j.required_devices)
            if targets is not None:
                self._slots.allocate_multi(
                    job_id, [(t.runner_id, resolved) for t in targets])
                self._dcn_table.pop((job_id, j.attempts), None)
            else:
                self._slots.allocate(job_id, target.runner_id, resolved)
            if j.egraph is not None and j.egraph.parallelism != resolved:
                # 'all' resolves only now that a runner is chosen — the
                # physical graph's subtask width follows the allocation
                j.egraph.set_parallelism(resolved)
            j.state = "RUNNING"
            j.failure = None
            if j.started_at is None:
                j.started_at = time.time()
            j.assigned_runners = ([t.runner_id for t in targets]
                                  if targets is not None
                                  else [target.runner_id])
            j.finished_runners = []
            if j.egraph is not None:
                j.egraph.start_attempt(j.attempts, target.runner_id)
            self._persist_locked(j)
            entry, attempt = j.entry, j.attempts
            # per-deploy config injection seam (runtime/session.py
            # stamps the resource-share denominator here); base = the
            # job's own config, untouched
            config = self._deploy_config_locked(j, dict(j.config), target)
            blobs = list(j.py_blobs)
            rescale_deploy = j.rescale_started_at is not None
            if j.restore_path:
                # one-shot explicit restore (rescale savepoint); a later
                # crash-recovery falls back to 'latest' as usual — and
                # cluster.rescale-from (stamped at consume) floors that
                # fallback at the savepoint, so a crash in this window
                # can never resurrect a pre-rescale checkpoint
                config["execution.checkpointing.restore"] = j.restore_path
                j.restore_path = None
            elif attempt > 1:
                # recovery attempt resumes from the newest checkpoint
                config["execution.checkpointing.restore"] = "latest"
        try:
            extra = {"py_blobs": blobs} if blobs else {}
            push_targets = targets if targets is not None else [target]
            # per-attempt exchange secret for cross-host jobs: every
            # process of THIS attempt shares it, nothing else does — the
            # DCN hello HMAC (exchange/dcn.py) rejects everyone else,
            # closing the open-listener RCE on 0.0.0.0 deployments
            dcn_secret = (secrets.token_hex(16)
                          if targets is not None else None)
            # the runner the failure handler blames/excludes must be the
            # one whose push actually failed, not the primary
            deploy_target = target
            # the LEADER epoch fences the control plane the way the
            # attempt epoch fences storage: a deposed leader's late
            # deploy is rejected at the runner. Only stamped under HA
            # (epoch > 0) so non-HA wire traffic is unchanged.
            fence = ({"leader_epoch": self.leader_epoch}
                     if self.leader_epoch > 0 else {})
            if rescale_deploy:
                from flink_tpu_torch import faults

                # the redeploy phase of the rescale handshake: a crash
                # here is the coordinator dying between consuming the
                # savepoints and pushing the new topology — the durable
                # RESTARTING record + cluster.rescale-from carry the
                # takeover; a raise routes through the normal deploy
                # failure handling (retry / park)
                faults.fire("rescale.redeploy", exc=RpcError, job=job_id)
            for i, t in enumerate(push_targets):
                deploy_target = t
                pconf = dict(config)
                # the attempt epoch fences the driver's checkpoint
                # STORAGE writes (FsCheckpointStorage._check_fence):
                # every deploy carries it, not just cross-host ones
                pconf["cluster.attempt"] = attempt
                if targets is not None:
                    # per-process identity; the exchange ports
                    # rendezvous through rpc_dcn_register/peers
                    pconf["cluster.process-id"] = i
                    pconf["cluster.dcn-rendezvous"] = "coordinator"
                    pconf["cluster.dcn-secret"] = dcn_secret
                    pconf.setdefault("source.enumeration", "local")
                from flink_tpu_torch import faults

                faults.fire("coordinator.deploy", exc=RpcError,
                            job=job_id, runner=t.runner_id)
                c = RpcClient(t.host, t.port, timeout_s=5.0)
                try:
                    # per-push token: a TRANSPORT retry of this call
                    # re-sends the same token (the runner absorbs the
                    # duplicate even if the attempt already completed);
                    # a genuine re-deploy generates a fresh one and
                    # executes
                    resp = c.call("run_job", job_id=job_id, entry=entry,
                                  config=pconf, attempt=attempt,
                                  deploy_token=secrets.token_hex(8),
                                  **fence, **extra)
                finally:
                    c.close()
                if not resp.get("accepted"):
                    raise RpcError(f"runner rejected job: {resp}")
            with self._lock:
                jj = self.jobs.get(job_id)
                if jj is not None and jj.egraph is not None:
                    jj.egraph.transition("RUNNING", attempt=attempt)
                if jj is not None and jj.rescale_started_at is not None:
                    # time-to-rescale: arm → new topology accepted
                    self._m_rescale["duration_ms"].update(
                        (time.time() - jj.rescale_started_at) * 1000.0)
                    jj.rescale_started_at = None
                    jj.last_rescale_done_at = time.time()
        except (RpcError, ConnectionError) as e:
            # ConnectionError too (a parked-job flake otherwise): faults
            # `drop`-kind rules raise ConnectionError, NOT RpcError —
            # the coordinator.deploy point fires BEFORE the client's
            # RpcError wrapping, so an RpcError-only catch here let an
            # injected transport drop kill the deploy thread silently
            # and park the job forever (regression:
            # tests/test_control_plane.py
            # test_deploy_transport_drop_routes_failure)
            decision: Dict[str, Any] = {}
            with self._lock:
                jj = self.jobs.get(job_id)
                if jj is not None:
                    decision = self._route_failure(
                        jj,
                        f"deploy to {deploy_target.runner_id} failed: {e}")
            if decision.get("action") == "restart":
                self._deploy_async(
                    job_id, decision.get("delay_ms", 0) / 1000,
                    exclude=[deploy_target.runner_id])

    def rpc_job_status(self, job_id: str) -> dict:
        with self._lock:
            j = self.jobs.get(job_id)
            if j is None:
                # terminal jobs aren't re-loaded by a new leader, but
                # their final state is in the store — answer from there
                # (ref: ExecutionGraphInfoStore serving archived jobs)
                if self._store is not None:
                    rec = self._store.get(job_id)
                    if rec is not None:
                        return {"state": rec.get("state", "UNKNOWN"),
                                "attempts": rec.get("attempts", 0),
                                "failure": None, "archived": True}
                return {"state": "UNKNOWN"}
            rescale = {
                "pending_devices": j.pending_rescale,
                "pending_processes": j.pending_rescale_procs,
                "savepoints_collected": len(j.rescale_paths),
                "last_completed_at": j.last_rescale_done_at,
                "metrics": {
                    k: v for k, v in self.registry.snapshot().items()
                    if k.startswith("coordinator.rescale.")},
            }
            return {"state": j.state, "attempts": j.attempts,
                    "failure": j.failure,
                    "last_savepoint": getattr(j, "last_savepoint", None),
                    "rescale": rescale,
                    "metrics": getattr(j, "last_metrics", None)}

    def _job_runners_locked(self, j: "JobInfo") -> List["RunnerInfo"]:
        """Reachable gateways of a job's assigned runners (one policy
        for cancel + savepoint: a runner in a heartbeat blip is still
        attempted — the RPC itself decides reachability)."""
        return [r for rid in j.assigned_runners
                if (r := self.runners.get(rid)) is not None and r.port]

    def rpc_cancel_job(self, job_id: str) -> dict:
        targets: List[RunnerInfo] = []
        with self._lock:
            j = self.jobs.get(job_id)
            if j is None:
                # unknown id is an ERROR, not a silent no-op: the CLI
                # exit contract (0 = canceled, 1 = refused) must let a
                # script distinguish a typo'd job id from a real cancel
                return {"ok": False, "reason": f"unknown job {job_id!r}"}
            if j.state in (
                    "RUNNING", "RESTARTING", "WAITING_FOR_RESOURCES"):
                j.state = "CANCELED"
                j.finished_at = time.time()
                self._disarm_rescale_locked(j, persist=False)
                # a cancel during the takeover re-attach window closes
                # it: the returning runner's inventory must not
                # resurrect the job, and the monitor must not kick a
                # redeploy for it
                j.reattach_attempt = None
                j.reattach_until = None
                j.reattach_runners = []
                self._slots.release(job_id)
                if j.egraph is not None:
                    j.egraph.transition("CANCELED")
                self._persist_locked(j)
                targets = self._job_runners_locked(j)
        for r in targets:
            self._push_cancel_async(r, job_id)
        with self._lock:
            waiting = self._waiting_locked()
        for wid in waiting:
            self._deploy_async(wid)
        return {"ok": True}

    def _push_cancel_async(self, runner: RunnerInfo, job_id: str,
                           attempt: Optional[int] = None) -> None:
        """Tell the runner's gateway to stop the job now (heartbeat
        revocation is the backstop if this push is lost). ``attempt``
        fences the cancel to one attempt — a rescale's stop must not
        race ahead and kill the redeployed attempt on the same runner."""
        from flink_tpu_torch.runtime.rpc import RpcClient, RpcError

        epoch = self.leader_epoch

        def push() -> None:
            try:
                c = RpcClient(runner.host, runner.port, timeout_s=5.0)
                try:
                    kw = {"attempt": attempt} if attempt is not None else {}
                    if epoch > 0:
                        kw["leader_epoch"] = epoch
                    c.call("cancel_job", job_id=job_id, **kw)
                finally:
                    c.close()
            except RpcError:
                pass

        t = threading.Thread(target=push, daemon=True)
        t.start()

    def rpc_finish_job(self, job_id: str,
                       attempt: Optional[int] = None,
                       runner_id: Optional[str] = None) -> dict:
        with self._lock:
            j = self.jobs.get(job_id)
            # attempt fencing: a zombie attempt finishing late must not
            # terminate the CURRENT attempt (ref: Execution attempt ids
            # gating updateTaskExecutionState)
            if (j is not None and attempt is not None
                    and attempt != j.attempts):
                return {"ok": False, "reason": "stale attempt"}
            # multi-runner jobs: one runner done ≠ job done — wait for
            # every assigned runner (a runner with an empty split share
            # finishes instantly; the peers are still reading)
            if (j is not None and runner_id is not None
                    and len(j.assigned_runners) > 1):
                if runner_id not in j.finished_runners:
                    j.finished_runners.append(runner_id)
                if set(j.assigned_runners) - set(j.finished_runners):
                    return {"ok": True, "pending_runners": sorted(
                        set(j.assigned_runners) - set(j.finished_runners))}
            # terminal states stand: a runner that missed its cancel and
            # ran to completion does not flip CANCELED back to FINISHED
            if j is not None and j.state in ("RUNNING", "RESTARTING"):
                j.state = "FINISHED"
                j.finished_at = time.time()
                self._disarm_rescale_locked(j, persist=False)
                self._slots.release(job_id)
                if j.egraph is not None:
                    j.egraph.transition("FINISHED")
                self._persist_locked(j)
            waiting = self._waiting_locked()
        # freed capacity is a scheduling event like registration
        for wid in waiting:
            self._deploy_async(wid)
        return {"ok": True}

    def rpc_report_failure(self, job_id: str, error: str,
                           attempt: Optional[int] = None) -> dict:
        """Task failure → restart decision (ref: DefaultScheduler.
        updateTaskExecutionState → ExecutionFailureHandler →
        RestartBackoffTimeStrategy). Deployable jobs are re-deployed by
        the coordinator itself — the control loop CLOSES here."""
        with self._lock:
            j = self.jobs.get(job_id)
            if j is None:
                return {"action": "unknown-job"}
            if attempt is not None and attempt != j.attempts:
                # a stale attempt's crash is not the CURRENT attempt's
                # problem — burning a restart-budget slot for it would
                # punish a healthy successor
                return {"action": "stale-attempt"}
            decision = self._route_failure(j, error)
            deployable = j.entry is not None
        if deployable and decision.get("action") == "restart":
            self._deploy_async(job_id, decision.get("delay_ms", 0) / 1000)
        return decision

    def _route_failure(self, j: JobInfo, error: str) -> dict:
        """Single failure-routing point (lock held): consult the job's
        restart budget, transition state, report the decision. Both
        reported failures and runner-loss detection land here. Terminal
        states are sinks — a late failure report must never resurrect a
        CANCELED/FINISHED/FAILED job."""
        if j.state in ("CANCELED", "FINISHED", "FAILED"):
            return {"action": "none", "state": j.state}
        # an armed-but-unfinished rescale dies with the attempt: the
        # recovery deploy keeps the old width, and a routine savepoint
        # days later must not consume a stale rescale request
        self._disarm_rescale_locked(j, persist=False)
        if j.state == "RESTARTING" and j.entry is not None:
            # one incident, one restart (coordinator-DEPLOYED jobs only —
            # _deploy owns the RESTARTING→RUNNING transition): the
            # monitor's runner-loss route and the runner's own failure
            # report must not each burn an attempt and schedule a deploy
            # for the same crash. Bookkeeping-only jobs are restarted by
            # an external supervisor, so each report IS a new incident.
            return {"action": "restart-pending", "state": j.state}
        j.failure = error
        if j.egraph is not None:
            j.egraph.transition("FAILED", attempt=j.attempts)
        strat = self._strategies.get(j.job_id)
        if strat is not None and strat.can_restart():
            delay = strat.next_delay_ms()
            j.state = "RESTARTING"
            j.attempts += 1
            j.finished_runners = []  # the new attempt starts from zero
            self._persist_locked(j)
            return {"action": "restart", "delay_ms": delay,
                    "restore": "latest"}
        j.state = "FAILED"
        j.finished_at = time.time()
        self._slots.release(j.job_id)
        self._persist_locked(j)
        return {"action": "fail"}

    def rpc_list_jobs(self) -> dict:
        with self._lock:
            return {"jobs": [
                {"job_id": j.job_id, "state": j.state,
                 "attempts": j.attempts,
                 "runners": list(j.assigned_runners)}
                for j in self.jobs.values()]}

    def rpc_trigger_savepoint(self, job_id: str, stop: bool = False,
                              token: Optional[str] = None) -> dict:
        """Dispatch a savepoint request to the job's runner gateway on a
        worker thread — forwarding must not block the single dispatch
        thread (heartbeats ride it; same discipline as _deploy_async /
        _push_cancel_async). The ack means DISPATCHED; completion (and
        the savepoint path) arrives via rpc_savepoint_complete and shows
        up in rpc_job_status (ref: CliFrontend savepoint → JobMaster
        .triggerSavepoint + acknowledgeSavepoint)."""
        with self._lock:
            j = self.jobs.get(job_id)
            if j is None or j.state not in ("RUNNING", "RESTARTING"):
                return {"ok": False, "reason": "job not running"}
            targets = self._job_runners_locked(j)
        if not targets:
            return {"ok": False, "reason": "no reachable runner"}

        fence = ({"leader_epoch": self.leader_epoch}
                 if self.leader_epoch > 0 else {})

        def push() -> None:
            from flink_tpu_torch.runtime.rpc import RpcClient, RpcError

            # a cross-host job's savepoint must trigger on EVERY
            # process (the DCN all-set consensus fires it only once all
            # of them carry the request; a first-acceptor return would
            # leave N-1 untriggered and the savepoint would never
            # fire). Single-runner jobs keep first-acceptor semantics —
            # the two are the same thing at N=1.
            require_all = len(targets) > 1
            accepted = 0
            try:
                if token is not None:
                    from flink_tpu_torch import faults

                    # the savepoint phase of the rescale handshake: a
                    # crash here is the coordinator dying with the
                    # intent durable but the triggers (partially)
                    # undispatched — takeover re-triggers under the
                    # same token
                    faults.fire("rescale.savepoint", exc=RpcError,
                                job=job_id)
                for r in targets:
                    try:
                        c = RpcClient(r.host, r.port, timeout_s=5.0)
                        try:
                            resp = c.call(
                                "trigger_savepoint", job_id=job_id,
                                stop=stop, token=token, **fence)
                        finally:
                            c.close()
                        if resp.get("ok"):
                            accepted += 1
                            if not require_all:
                                return
                    except RpcError:
                        if require_all:
                            break
                        continue
            except (RpcError, ConnectionError):
                accepted = 0
            if require_all and accepted == len(targets):
                return
            # not every needed runner accepted (e.g. checkpointing not
            # configured): savepoint_complete will never arrive (or
            # never on all processes). Disarm ONLY when this push WAS
            # the rescale's own savepoint (token match) — an unrelated
            # routine savepoint failing must not kill an in-flight
            # rescale
            if token is None:
                return
            with self._lock:
                jj = self.jobs.get(job_id)
                if jj is not None and jj.rescale_token == token:
                    self._disarm_rescale_locked(jj)

        threading.Thread(target=push, daemon=True).start()
        return {"ok": True, "dispatched": True,
                "runners": [r.runner_id for r in targets]}

    # -- blobs (ref: BlobServer put/get) --------------------------------
    def rpc_put_blob(self, data_b64: str) -> dict:
        import base64

        digest = self._blobs.put(base64.b64decode(data_b64))
        return {"digest": digest}

    def rpc_get_blob(self, digest: str) -> dict:
        import base64

        data = self._blobs.get(digest)
        if data is None:
            return {"found": False}
        return {"found": True, "data_b64": base64.b64encode(data).decode()}

    def rpc_list_blobs(self) -> dict:
        return {"digests": self._blobs.list()}

    def rpc_enumerate_splits(self, job_id: str, source_id: int,
                             n_splits: int, runner_id: str) -> dict:
        """Split enumerator (ref: FLIP-27 SplitEnumerator /
        SourceCoordinator on the JM): deterministic contiguous shares
        by the runner's position among the job's assigned runners —
        every runner computes a disjoint slice and the union covers all
        splits. A runner not assigned to the job gets none (a zombie
        attempt must not re-read splits its successor owns)."""
        with self._lock:
            j = self.jobs.get(job_id)
            if j is None or runner_id not in j.assigned_runners:
                # ERROR, not an empty share: a zombie attempt handed []
                # would run to completion instantly and report finish —
                # failing its enumeration kills it through the normal
                # failure routing instead (fencing)
                raise RuntimeError(
                    f"runner {runner_id} is not assigned to {job_id} "
                    "(stale attempt)")
            runners = list(j.assigned_runners)
        k = len(runners)
        p = runners.index(runner_id)
        # strided shares: imbalance <= 1 split; with fewer splits than
        # runners some runners legitimately own none of THIS source
        # (the per-runner finish tracking in rpc_finish_job keeps an
        # empty-share runner's completion from ending the whole job)
        return {"splits": list(range(p, n_splits, k))}

    def rpc_report_plan(self, job_id: str, stages: List[str]) -> dict:
        """Runner reports its compiled plan's stage names — the
        coordinator never imports job code, so the physical graph's
        stages materialize from this report (ref: ExecutionGraph built
        from the submitted JobGraph; here the 'JobGraph' is compiled
        runner-side from the entry point)."""
        with self._lock:
            j = self.jobs.get(job_id)
            if j is None or j.egraph is None:
                return {"ok": False}
            j.egraph.set_stages(stages)
        return {"ok": True}

    def rpc_execution_graph(self, job_id: str) -> dict:
        """Physical-graph detail for REST/CLI (ref: the REST job-detail
        vertices/subtasks endpoints off ExecutionGraphInfo)."""
        with self._lock:
            j = self.jobs.get(job_id)
            if j is None or j.egraph is None:
                return {"found": False}
            snap = j.egraph.snapshot()
        snap["found"] = True
        return snap

    @staticmethod
    def _savepoint_pid(path: str) -> int:
        """Process id a per-process savepoint path belongs to (the
        driver's per-pid storage name ``<job>-p<K>``; a single-process
        savepoint has no suffix → pid 0)."""
        import re as _re

        m = _re.findall(r"-p(\d+)/", path.replace(os.sep, "/"))
        return int(m[-1]) if m else 0

    def rpc_savepoint_complete(self, job_id: str, path: str,
                               token: Optional[str] = None) -> dict:
        rescale_targets: List[RunnerInfo] = []
        with self._lock:
            j = self.jobs.get(job_id)
            if j is None:
                return {"ok": True}
            j.last_savepoint = path
            if (j.pending_rescale is not None and j.state == "RUNNING"
                    and token is not None and token == j.rescale_token):
                # rescale savepoint landed on ONE process. A cross-host
                # job consumes only once every process's savepoint is
                # durable — each process snapshots its own key-group
                # range, and the repartition needs all of them
                self._m_rescale["savepoint"].inc()
                if path not in j.rescale_paths:
                    j.rescale_paths.append(path)
                nproc_old = max(
                    1, int(j.config.get("cluster.num-processes", 1)))
                if len(j.rescale_paths) < nproc_old:
                    self._persist_locked(j)  # partial set is durable
                    return {"ok": True, "pending_savepoints":
                            nproc_old - len(j.rescale_paths)}
                # rescale phase 2: all savepoints durable → stop the
                # old topology, redeploy at the new one restoring from
                # them (ref: AdaptiveScheduler rescale = savepoint +
                # restart with re-split key-group ranges; the reshard
                # happens in the state restore path)
                new = j.pending_rescale
                new_procs = j.pending_rescale_procs or nproc_old
                paths = sorted(j.rescale_paths, key=self._savepoint_pid)
                j.pending_rescale = None
                j.rescale_token = None
                j.pending_rescale_procs = None
                j.rescale_paths = []
                j.required_devices = new
                j.config["cluster.mesh-devices"] = str(new)
                j.config["cluster.num-processes"] = new_procs
                # every new process restores from paths[0] and finds
                # its siblings (old pids 1..N-1) here; doubles as the
                # restore=latest fallback FLOOR for a crash before the
                # first post-rescale checkpoint publishes
                j.config["cluster.rescale-from"] = ",".join(paths)
                j.restore_path = paths[0]
                j.state = "RESTARTING"
                old_attempt = j.attempts
                j.attempts += 1
                j.finished_runners = []
                self._slots.release(job_id)
                if j.egraph is not None:
                    j.egraph.set_parallelism(max(1, new))
                rescale_targets = self._job_runners_locked(j)
                self._persist_locked(j)
                redeploy = True
            else:
                redeploy = False
        for r in rescale_targets:
            # fenced to the OLD attempt: the redeploy may land on the
            # same runner before this cancel does
            self._push_cancel_async(r, job_id, attempt=old_attempt)
        if redeploy:
            self._m_rescale["redeploy"].inc()
            self._deploy_async(job_id, delay_s=0.2)
        return {"ok": True}

    def rpc_rescale_job(self, job_id: str, devices: int,
                        processes: Optional[int] = None) -> dict:
        """Live rescale: savepoint → stop → restore at the new width
        (ref: the REST rescale endpoint / reactive mode). ``devices``
        is the PER-PROCESS mesh width; ``processes`` changes the
        host-process count (N→M key-group repartition on restore),
        None keeps it. The ack means the rescale is DISPATCHED;
        progress shows in job_status (state RESTARTING once the
        savepoints land, RUNNING at the new topology after redeploy).
        The target must keep the key-group discipline legal:
        num-key-shards % processes == 0 and the per-process shard
        share % devices == 0 — the same contract hybrid_route enforces
        at runtime, refused here before any state moves."""
        from flink_tpu_torch import faults
        from flink_tpu_torch.runtime.rpc import RpcError

        if devices < 1:
            return {"ok": False, "reason": "devices must be >= 1"}
        if processes is not None and processes < 1:
            return {"ok": False, "reason": "processes must be >= 1"}
        with self._lock:
            j = self.jobs.get(job_id)
            if j is None or j.entry is None or j.state != "RUNNING":
                return {"ok": False,
                        "reason": "job not running (or not deployable)"}
            if j.pending_rescale is not None:
                return {"ok": False, "reason": "rescale already in flight"}
            nproc_old = max(
                1, int(j.config.get("cluster.num-processes", 1)))
            procs = int(processes) if processes is not None else nproc_old
            try:
                shards = int(j.config.get("state.num-key-shards", 128)
                             or 128)
            except (TypeError, ValueError):
                shards = 128
            if shards % procs != 0:
                return {"ok": False, "reason":
                        f"state.num-key-shards ({shards}) is not "
                        f"divisible by {procs} processes — key-group "
                        "ranges cannot be contiguous"}
            if (shards // procs) % devices != 0:
                return {"ok": False, "reason":
                        f"per-process shard share ({shards // procs}) "
                        f"is not divisible by {devices} devices"}
            if procs > 1:
                fleet = [r for r in self.runners.values()
                         if r.alive and not r.draining
                         and r.n_devices >= devices]
                if len(fleet) < procs:
                    return {"ok": False, "reason":
                            f"need {procs} runners with >= {devices} "
                            f"devices, have {len(fleet)}"}
            import uuid as _uuid

            token = f"rescale-{_uuid.uuid4().hex[:12]}"
            j.pending_rescale = devices
            j.pending_rescale_procs = procs
            j.rescale_token = token
            j.rescale_paths = []
            j.rescale_started_at = time.time()
            self._m_rescale["armed"].inc()
            # durable BEFORE the trigger dispatch: a takeover from here
            # on resumes (or cleanly disarms) the handshake
            self._persist_locked(j)
        try:
            # the arm phase of the handshake: a crash here is the
            # coordinator dying right after the intent became durable
            faults.fire("rescale.arm", exc=RpcError, job=job_id)
        except (RpcError, ConnectionError) as e:
            with self._lock:
                jj = self.jobs.get(job_id)
                if jj is not None and jj.rescale_token == token:
                    self._disarm_rescale_locked(jj)
            return {"ok": False, "reason": f"arm failed: {e}"}
        # stop-with-savepoint (ref: `flink stop --savepoint`): the old
        # attempt halts the moment the savepoint is durable, so it
        # cannot keep committing past the state the new width restores
        resp = self.rpc_trigger_savepoint(job_id, stop=True, token=token)
        if not resp.get("ok"):
            with self._lock:
                jj = self.jobs.get(job_id)
                if jj is not None and jj.rescale_token == token:
                    self._disarm_rescale_locked(jj)
            return resp
        return {"ok": True, "dispatched": True, "devices": devices,
                "processes": procs}

    def rpc_dcn_register(self, job_id: str, attempt: int, process_id: int,
                         host: str, port: int) -> dict:
        """DCN exchange rendezvous (cross-host jobs): each process
        reports its ephemeral listener; peers poll rpc_dcn_peers until
        the table is complete. Keyed by attempt so a restarted job's
        stale registrations can never mix into the new fleet."""
        with self._lock:
            tbl = self._dcn_table.setdefault((job_id, int(attempt)), {})
            tbl[int(process_id)] = f"{host}:{int(port)}"
        return {"ok": True}

    def rpc_dcn_peers(self, job_id: str, attempt: int,
                      n_processes: int) -> dict:
        with self._lock:
            tbl = dict(self._dcn_table.get((job_id, int(attempt)), {}))
        if len(tbl) < int(n_processes):
            return {"ready": False}
        return {"ready": True,
                "peers": [tbl[i] for i in range(int(n_processes))]}

    def rpc_drain_runner(self, runner_id: str) -> dict:
        """Scale-in drain (ref: ActiveResourceManager releasing a
        TaskManager): mark the runner unschedulable, then move every
        job it hosts elsewhere via stop-with-savepoint → redeploy
        (state travels through the savepoint; the rescale handshake is
        reused with the SAME width and the drained runner excluded
        from the reallocation). Once job_status shows the jobs RUNNING
        elsewhere the machine can be removed."""
        import uuid as _uuid

        with self._lock:
            r = self.runners.get(runner_id)
            if r is None:
                return {"ok": False, "reason": "unknown runner"}
            r.draining = True
            victims = []
            for job_id in list(self._slots._allocations):
                # a cross-host job may touch the drained runner through
                # ANY of its process allocations, not just the head
                if all(r != runner_id
                       for r, _ in self._slots.allocations(job_id)):
                    continue
                j = self.jobs.get(job_id)
                if j is None or j.entry is None or j.state != "RUNNING":
                    continue
                if j.pending_rescale is not None:
                    continue  # an in-flight rescale already moves it
                token = f"drain-{_uuid.uuid4().hex[:12]}"
                j.pending_rescale = j.required_devices  # same width
                j.pending_rescale_procs = None  # keep process count
                j.rescale_token = token
                j.rescale_paths = []
                j.rescale_started_at = time.time()
                j.drain_exclude = runner_id
                self._persist_locked(j)
                victims.append((job_id, token))
        dispatched = []
        for job_id, token in victims:
            resp = self.rpc_trigger_savepoint(job_id, stop=True,
                                              token=token)
            if resp.get("ok"):
                dispatched.append(job_id)
            else:
                with self._lock:
                    jj = self.jobs.get(job_id)
                    if jj is not None and jj.rescale_token == token:
                        self._disarm_rescale_locked(jj)
        return {"ok": True, "draining": runner_id,
                "moving_jobs": dispatched}

    def rpc_list_runners(self) -> dict:
        with self._lock:
            return {rid: {"host": r.host, "n_devices": r.n_devices,
                          "alive": r.alive}
                    for rid, r in self.runners.items()}

    # -- failure detection ----------------------------------------------
    def _monitor_loop(self) -> None:
        while not self._closed:
            time.sleep(min(self._hb_timeout / 5, 1.0))
            now = time.time()
            redeploys = []  # (job_id, delay_ms, lost_runner)
            expired: List[str] = []
            with self._lock:
                # takeover re-attach windows that ran out: the stored
                # runner never came back — fall through to the normal
                # checkpoint-restore redeploy (attempt is pre-bumped)
                for j in self.jobs.values():
                    if (j.reattach_until is not None
                            and now >= j.reattach_until):
                        j.reattach_attempt = None
                        j.reattach_until = None
                        j.reattach_runners = []
                        j.assigned_runners = []
                        expired.append(j.job_id)
            for job_id in expired:
                self._deploy_async(job_id)
            with self._lock:
                for r in self.runners.values():
                    if r.alive and now - r.last_heartbeat > self._hb_timeout:
                        r.alive = False
                        # runner loss fails its jobs through the SAME
                        # routing as rpc_report_failure (a lost runner must
                        # not bypass restart-strategy attempt limits)
                        for j in self.jobs.values():
                            if (j.state == "RUNNING"
                                    and r.runner_id in j.assigned_runners):
                                d = self._route_failure(
                                    j, f"runner {r.runner_id} lost")
                                if (j.entry is not None
                                        and d.get("action") == "restart"):
                                    redeploys.append((
                                        j.job_id, d.get("delay_ms", 0),
                                        r.runner_id))
            for job_id, delay_ms, lost in redeploys:
                self._deploy_async(job_id, delay_ms / 1000, exclude=[lost])
            self._rescale_tick()

    # -- reactive rescale controller --------------------------------------
    def _rescale_tick(self, now: Optional[float] = None) -> None:
        """One evaluation of the reactive rescale policy (ref: the
        AdaptiveScheduler / reactive mode resource-driven rescaling,
        driven here by OBSERVED load): for every RUNNING job whose
        config opts in (rescale.mode: reactive), compare the heartbeat-
        carried pressure signal — max(backpressure_pct, drain_busy_pct),
        the driver's phase accounting — against the target band.

        No flapping by construction: (1) the two-sided band is a
        hysteresis dead zone — a signal oscillating inside it never
        triggers, and ONE in-band sample resets the sustained clock;
        (2) pressure must stay outside the band continuously for
        rescale.sustained-window; (3) rescale.cooldown gates re-arming
        from the last COMPLETED rescale; (4) scale-out targets the next
        divisibility-legal width (doubling) and defers while the fleet
        has queued demand (the autoscaler's queue-depth signal — a
        scale-out that would starve parked jobs waits its turn).

        ``now`` is injectable for deterministic controller tests."""
        from flink_tpu_torch.config import RescaleOptions

        now = time.time() if now is None else now
        arm: List[tuple] = []
        with self._lock:
            queued = len(self._waiting_locked())
            for j in self.jobs.values():
                if j.entry is None or j.state != "RUNNING":
                    continue
                conf = Configuration(j.config)
                if str(conf.get(RescaleOptions.MODE)).strip() != "reactive":
                    continue
                if j.pending_rescale is not None:
                    continue  # handshake already in flight
                m = j.last_metrics or {}
                try:
                    pressure = max(
                        float(m.get("backpressure_pct") or 0.0),
                        float(m.get("drain_busy_pct") or 0.0))
                except (TypeError, ValueError):
                    pressure = None
                if not m or pressure is None:
                    j.pressure_out_since = None
                    j.pressure_side = None
                    continue
                hi = float(conf.get(RescaleOptions.TARGET_PRESSURE_HIGH))
                lo = float(conf.get(RescaleOptions.TARGET_PRESSURE_LOW))
                side = ("high" if pressure > hi
                        else "low" if pressure < lo else None)
                if side is None:
                    j.pressure_out_since = None
                    j.pressure_side = None
                    continue
                if side != j.pressure_side:
                    j.pressure_side = side
                    j.pressure_out_since = now
                    continue
                sustained = conf.get(
                    RescaleOptions.SUSTAINED_WINDOW) / 1000.0
                if now - (j.pressure_out_since or now) < sustained:
                    continue
                cooldown = conf.get(RescaleOptions.COOLDOWN) / 1000.0
                anchor = (j.last_rescale_done_at or j.started_at
                          or j.submitted_at)
                if now - anchor < cooldown:
                    continue
                cur = j.required_devices
                if cur == SlotPool.ALL:
                    continue  # 'all' width is not reactively resizable
                nproc = max(
                    1, int(j.config.get("cluster.num-processes", 1)))
                try:
                    shards = int(j.config.get("state.num-key-shards",
                                              128) or 128)
                except (TypeError, ValueError):
                    shards = 128
                share = shards // max(1, nproc)
                mn = max(1, int(conf.get(RescaleOptions.MIN_DEVICES)))
                mx = int(conf.get(RescaleOptions.MAX_DEVICES)) or max(
                    (r.n_devices for r in self.runners.values()
                     if r.alive), default=cur)
                if side == "high":
                    if queued > 0:
                        continue
                    target = cur * 2
                    if target > mx or share % target != 0:
                        continue
                else:
                    target = max(1, cur // 2)
                    if (target < mn or target == cur
                            or share % target != 0):
                        continue
                j.pressure_out_since = None
                j.pressure_side = None
                arm.append((j.job_id, target))
        for job_id, target in arm:
            # outside the lock: arming runs the full manual-RPC path
            # (validation, durable intent, stop-with-savepoint)
            self.rpc_rescale_job(job_id, devices=target)

    def close(self) -> None:
        self._closed = True


def start_coordinator(config: Optional[Configuration] = None,
                      port: int = 0) -> RpcServer:
    return RpcServer(JobCoordinator(config), port)


def arg_parser():
    """The coordinator process's command line."""
    import argparse

    p = argparse.ArgumentParser(description="flink_tpu_torch job coordinator")
    p.add_argument("--port", type=int, default=6123)
    p.add_argument("--rest-port", type=int, default=0,
                   help="HTTP REST/UI port (0 = disabled)")
    p.add_argument("--rest-bind", default="127.0.0.1")
    p.add_argument("--ha-dir", default="",
                   help="shared HA directory: contend for leadership "
                        "and recover jobs from its store (standby "
                        "coordinators block here until elected)")
    p.add_argument("--conf", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="coordinator configuration (heartbeat.*, "
                        "high-availability.lease-timeout, "
                        "session.ha.reattach-grace, restart-strategy.*)")
    return p


def main(argv: Optional[list] = None) -> None:
    """Coordinator process entrypoint (ref: the cluster entrypoints in
    runtime/entrypoint/*ClusterEntrypoint.java)::

        python -m flink_tpu_torch.runtime.coordinator --port 6123
    """
    import time as _time

    from flink_tpu_torch.cli import _parse_conf

    args = arg_parser().parse_args(argv)
    conf = Configuration(_parse_conf(args.conf))
    conf.validate()

    def serve_forever(server):
        rest = None
        if args.rest_port:
            from flink_tpu_torch.obs.rest import RestServer

            rest = RestServer(server, port=args.rest_port,
                              bind=args.rest_bind)
            print(f"rest on :{rest.port}", flush=True)
        print(f"coordinator on :{server.port}", flush=True)
        return rest

    if not args.ha_dir:
        server = start_coordinator(conf, port=args.port)
        rest = serve_forever(server)
        try:
            while True:
                _time.sleep(3600)
        except KeyboardInterrupt:
            if rest is not None:
                rest.close()
            server.close()
        return

    # HA mode: contend → serve while leader → on revoke STOP SERVING
    # (a stalled leader that lost its lease must not keep accepting
    # work — split-brain; ref: leadership revocation closing the
    # Dispatcher's RPC) → re-contend. Jobs re-load from the store on
    # the next grant, so dropping in-memory state is safe.
    import threading as _threading

    from flink_tpu_torch.config import HighAvailabilityOptions
    from flink_tpu_torch.runtime.ha import LeaderElection

    conf.set("high-availability.dir", args.ha_dir)
    grant_evt = _threading.Event()
    revoke_evt = _threading.Event()
    election = LeaderElection(
        args.ha_dir, f"127.0.0.1:{args.port}",
        conf.get(HighAvailabilityOptions.LEASE_TIMEOUT) / 1000)
    election.on_grant = lambda epoch: grant_evt.set()
    election.on_revoke = revoke_evt.set
    election.start()
    try:
        while True:
            print("contending for leadership...", flush=True)
            grant_evt.wait()
            grant_evt.clear()
            revoke_evt.clear()
            print(f"elected leader (epoch {election.epoch})", flush=True)
            # fencing: every runner push from this incumbency carries
            # the election epoch; a deposed leader's late RPCs are
            # rejected at the runner. Stamped BETWEEN construction and
            # serving, so no push can ever leave unstamped.
            endpoint = JobCoordinator(conf)
            endpoint.leader_epoch = election.epoch
            server = RpcServer(endpoint, args.port)
            rest = serve_forever(server)
            revoke_evt.wait()  # leadership lost: stop serving
            print("leadership revoked; closing", flush=True)
            if rest is not None:
                rest.close()
            # close the ENDPOINT too: its monitor thread must stop
            # writing to the shared job store the new leader now owns
            # (the split-brain this loop exists to prevent)
            server.endpoint.close()
            server.close()
    except KeyboardInterrupt:
        election.close()


if __name__ == "__main__":
    main()
