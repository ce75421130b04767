"""Session-cluster runtime mode — N concurrent jobs on a shared fleet
(the JAX package's ``runtime/session.py``; its RPC methods, replies and
durable records are the reference's).

ref: the session deployment mode of the upstream project: a
long-lived Dispatcher accepts job submissions against a standing
TaskManager fleet, the ResourceManager's slot pool multiplexes jobs
onto shared workers (slot sharing + quotas), and an active
resource manager grows/shrinks the fleet with demand. The per-job
submit path (``python -m flink_tpu_torch run``) spins a private runtime per
job; this module is the shared-service alternative — many jobs per
card, each job's runner a process that owns the card's one CUDA
context. In-process runners (``LocalSessionCluster``,
``serve_session``) run their jobs on ``device`` (``"cuda"`` by default,
the CPU only when asked); nothing falls back to the CPU.

Pieces:

- :class:`SessionDispatcher` — a :class:`JobCoordinator` specialization
  holding a per-job registry (id, status, config, quota, lifecycle
  stamps, heartbeat-carried metrics handle) and a **logical slot pool**
  (:class:`SessionSlotPool`): each runner contributes
  ``session.runner-slots``; each job occupies ``session.slots-per-job``.
  Admission (``rpc_submit_session_job``) validates quotas, enforces
  **per-job isolation** — checkpoint directory namespaced by job id,
  ``faults.*`` plans installed job-scoped on the runner, fair-drain
  stamped on — and parks submissions past ``session.max-jobs`` on a
  FIFO queue that drains as running jobs finish (the coordinator's
  WAITING_FOR_RESOURCES machinery doubles as the submission queue; the
  ``_admit_locked`` seam gates headroom under the lock).
- :class:`FairDrainGate` — a process-global round-robin turnstile over
  co-resident jobs' emit-ring drain fetches: one job's fire/drain
  burst re-queues BEHIND any waiting peer, so no tenant can starve
  another's emit ring on the shared device→host link (the driver takes
  a turn around each drain materialization when ``session.fair-drain``
  is stamped; solo jobs pass through a no-contention fast path).
- the **autoscaler loop** — submission-queue depth and aggregate slot
  pressure push scale-OUT demand through the provisioner seam
  (``runtime/provisioner.py request_capacity``); runners idle past
  ``session.scale-down-idle`` (above ``session.min-runners``) drain
  via the existing stop-with-savepoint path and are released
  (``release_capacity``).
- :class:`LocalSessionCluster` — dispatcher + RPC server + N
  in-process runners in one object: the `session start
  --local-runners` backing and the tests' e2e surface.

HA: with ``high-availability.dir`` set, ``serve_session``
runs the contend → serve → revoke leader cycle over the shared-file
lease (``runtime/ha.py``); every admission persists the job — entry,
config, quota, FIFO position — to the durable registry BEFORE it
returns, a standby (``session start --standby``) takes over on lease
lapse, re-queues undeployed jobs in original order, and re-attaches
still-live executions that runners carry back (epoch-fenced: a deposed
leader's late deploy/cancel is rejected at the runner).

Honest scope: consensus is the shared filesystem (one lease directory
all contenders and runners can reach — no quorum protocol, no
cross-region HA); failover latency is bounded below by the lease
timeout + runner heartbeat re-resolution; slots are logical admission
units, not cgroup/HBM partitions — the enforced shares are the
host-pool worker count and in-flight step credit
(``session.concurrent-jobs`` division in the driver) plus the fair
drain turnstile; session jobs are single-runner
(``cluster.num-processes > 1`` stays on the per-job submit path).
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

from flink_tpu_torch.config import (
    CheckpointingOptions,
    ClusterOptions,
    Configuration,
    SessionOptions,
)
from flink_tpu_torch.runtime.coordinator import JobCoordinator, JobInfo, RunnerInfo
from flink_tpu_torch.runtime.rpc import RpcServer
from flink_tpu_torch.runtime.scheduler import ExecutionGraph, SlotPool

__all__ = ["FairDrainGate", "drain_gate", "SessionSlotPool",
           "SessionDispatcher", "LocalSessionCluster"]


# ---------------------------------------------------------------------------
# fair drain scheduling
# ---------------------------------------------------------------------------

class FairDrainGate:
    """Round-robin turnstile over co-resident jobs' drain fetches.

    Each driver's drain thread takes a ``turn(token)`` around its
    device→host materialization. Turns grant FIFO over the waiter
    queue, and a releasing holder re-queues BEHIND every waiter — so a
    job whose windows fire in bursts gets exactly one fetch per round
    while a quiet peer waits at most one fetch for its own ring
    (starvation-freedom, the fairness half of the session contract).
    A solo job (no other member registered) never waits: its turn is
    one uncontended lock acquire — the measured cost on the pre-session
    single-job path is noise.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._members: set = set()
        self._queue: collections.deque = collections.deque()
        self._holder: Optional[object] = None

    def register(self, token) -> None:
        with self._cond:
            self._members.add(token)

    def unregister(self, token) -> None:
        """Drop a member (its drain thread exited). Any state it still
        holds — a queued request, the turn itself — is released so
        peers never wait on a dead job."""
        with self._cond:
            self._members.discard(token)
            try:
                self._queue.remove(token)
            except ValueError:
                pass
            if self._holder == token:
                self._holder = None
            self._cond.notify_all()

    @property
    def members(self) -> int:
        with self._cond:
            return len(self._members)

    @contextlib.contextmanager
    def turn(self, token):
        with self._cond:
            self._queue.append(token)
            self._cond.wait_for(
                lambda: self._holder is None and self._queue[0] == token)
            self._queue.popleft()
            self._holder = token
        try:
            yield
        finally:
            with self._cond:
                if self._holder == token:
                    self._holder = None
                self._cond.notify_all()


# ONE gate per runner process: co-resident drivers share it, exactly
# like they share the physical device→host link it arbitrates
_GATE = FairDrainGate()


def drain_gate() -> FairDrainGate:
    return _GATE


# ---------------------------------------------------------------------------
# logical slot pool
# ---------------------------------------------------------------------------

class SessionSlotPool(SlotPool):
    """Slot accounting in LOGICAL session slots instead of exclusive
    devices (ref: taskmanager.numberOfTaskSlots + SlotSharingGroup):
    every registered runner contributes ``session.runner-slots``; a job
    occupies ``session.slots-per-job`` of ONE runner. Placement stays
    the inherited best-fit (fewest free slots that still fit), which
    packs co-resident jobs onto shared cards."""

    def __init__(self, runner_slots: int) -> None:
        super().__init__()
        self.runner_slots = int(runner_slots)

    def capacity(self, runner: RunnerInfo) -> int:
        return self.runner_slots

    def free_slots(self, runner: RunnerInfo) -> int:
        return self.capacity(runner) - self.used_devices(runner.runner_id)

    def pick(self, job_id: str, devices: int, runners: List,
             exclude: Optional[List[str]] = None):
        exclude = exclude or []
        fits = []
        for r in runners:
            if not (r.alive and r.port) or r.runner_id in exclude:
                continue
            need = self.capacity(r) if devices == self.ALL else devices
            if self.free_slots(r) >= need:
                fits.append(r)
        if not fits:
            return None
        return min(fits, key=self.free_slots)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

class SessionDispatcher(JobCoordinator):
    """Long-lived multi-job coordinator (ref: Dispatcher + JobMaster +
    slot pool in session deployment mode). Inherits the whole control
    plane — runner registration/heartbeats/loss detection, deploy/
    restart routing, savepoints, rescale, drain, blob store, HA store —
    and adds admission quotas, the FIFO submission queue, per-job
    isolation stamping, and the autoscaler."""

    def __init__(self, config: Optional[Configuration] = None) -> None:
        config = config or Configuration()
        self.runner_slots = int(config.get(SessionOptions.RUNNER_SLOTS))
        self.max_jobs = int(config.get(SessionOptions.MAX_JOBS))
        self.default_slots = int(config.get(SessionOptions.SLOTS_PER_JOB))
        if self.runner_slots < 1 or self.max_jobs < 1:
            raise ValueError(
                "session.runner-slots and session.max-jobs must be >= 1 "
                f"(got {self.runner_slots}, {self.max_jobs})")
        # set BEFORE super().__init__: _recover_from_store runs inside
        # it and records how many jobs this incumbency re-hydrated
        self.recovered_jobs = 0
        super().__init__(config)
        # takeover count comes from the durable HA-dir counter bumped
        # at each lease STEAL — NOT from epoch arithmetic, which would
        # count clean stop/restart cycles as takeovers
        from flink_tpu_torch.config import HighAvailabilityOptions

        ha_dir = str(config.get(HighAvailabilityOptions.HA_DIR)).strip()
        if ha_dir:
            from flink_tpu_torch.runtime.ha import takeover_count

            self.takeovers = takeover_count(ha_dir)
        else:
            self.takeovers = 0
        # swap the device-exclusive pool for the logical-slot pool; the
        # inherited deploy/drain machinery only sees the SlotPool shape
        self._slots = SessionSlotPool(self.runner_slots)
        self.stop_event = threading.Event()
        self._closing = False
        self._idle_since: Dict[str, float] = {}
        # session-plane gauges ride the coordinator's own registry
        # (created in JobCoordinator.__init__) so one snapshot serves
        # both planes — rescale phase counters next to slot pressure;
        # per-JOB metrics stay on each driver's own registry and arrive
        # here only as heartbeat-carried snapshots on JobInfo.last_metrics
        g = self.registry.group("session")
        self._g_running = g.gauge("running_jobs")
        self._g_queued = g.gauge("queued_jobs")
        self._g_pressure = g.gauge("slot_pressure")
        self._c_admitted = g.counter("jobs_admitted")
        self._c_rejected = g.counter("jobs_rejected")
        self._c_scale_up = g.counter("scale_up_requests")
        self._c_scale_down = g.counter("scale_down_releases")
        self._autoscale_thread: Optional[threading.Thread] = None
        if bool(config.get(SessionOptions.AUTOSCALE)):
            self._autoscale_thread = threading.Thread(
                target=self._autoscale_loop, daemon=True)
            self._autoscale_thread.start()

    # -- HA takeover -----------------------------------------------------
    def _required_devices_from_config(self, conf: dict) -> int:
        """Recovered session jobs demand their SLOT quota, not a
        device count (the stored config carries the admission-stamped
        session.slots-per-job)."""
        if "session.slots-per-job" in conf:
            return max(1, int(conf["session.slots-per-job"]))
        return super()._required_devices_from_config(conf)

    def _recover_from_store(self) -> None:
        """Takeover re-hydration (the Dispatcher.recoverJobs leg of a
        failover): the inherited recovery re-queues undeployed jobs in
        original FIFO order (durable submitted_at) and opens re-attach
        windows for jobs whose executions may still be live on their
        runners. The fault point is the chaos gate for a standby dying
        mid-takeover — the serve loop retries construction."""
        from flink_tpu_torch import faults

        faults.fire("session.failover.takeover")
        super()._recover_from_store()
        self.recovered_jobs = len(self.jobs)

    # -- admission -------------------------------------------------------
    @staticmethod
    def _is_session_job(j: JobInfo) -> bool:
        return "session.slots-per-job" in j.config

    def rpc_submit_session_job(self, job_id: str, entry: str,
                               config: Optional[dict] = None,
                               py_blobs: Optional[List[Dict[str, str]]]
                               = None) -> dict:
        """Admit one job into the session cluster. Quota validation and
        isolation stamping happen HERE, before the registry insert:

        - ``session.slots-per-job`` (job config override, else the
          cluster default) must be >= 1 and fit one runner's
          ``session.runner-slots`` — a quota no runner can satisfy is
          rejected, never queued forever;
        - the checkpoint directory is namespaced ``<dir>/<job_id>`` so
          two tenants can never read each other's manifests;
        - a job-carried ``faults.*`` plan is marked for JOB-SCOPED
          install on the runner (faults.install_scoped) — one tenant's
          chaos schedule cannot inject into a co-resident job;
        - ``session.fair-drain`` is stamped on so the job's drain
          fetches go through the round-robin gate.

        Admitted jobs enter the queue as WAITING_FOR_RESOURCES and
        deploy immediately if ``session.max-jobs`` headroom and slots
        exist (the ``_admit_locked`` gate + slot pick decide under the
        coordinator lock)."""
        from flink_tpu_torch import faults
        from flink_tpu_torch.runtime.restart import from_config

        faults.fire("session.admit", job=job_id)
        conf = dict(config or {})
        try:
            slots = int(conf.get("session.slots-per-job",
                                 self.default_slots))
        except (TypeError, ValueError):
            self._c_rejected.inc()
            return {"admitted": False,
                    "reason": "session.slots-per-job must be an integer"}
        if slots < 1:
            self._c_rejected.inc()
            return {"admitted": False,
                    "reason": f"session.slots-per-job={slots} is below 1"}
        if slots > self.runner_slots:
            self._c_rejected.inc()
            return {"admitted": False,
                    "reason": (
                        f"session.slots-per-job={slots} exceeds "
                        f"session.runner-slots={self.runner_slots} — no "
                        "runner in this cluster can ever satisfy the "
                        "quota")}
        with self._lock:
            if self._closing:
                self._c_rejected.inc()
                return {"admitted": False,
                        "reason": "session cluster is stopping"}
            existing = self.jobs.get(job_id)
            if existing is not None and existing.state in (
                    "RUNNING", "RESTARTING", "WAITING_FOR_RESOURCES",
                    "CREATED"):
                if existing.entry == entry:
                    # the same submission re-delivered: the HA client
                    # retries a submit whose RESPONSE died with the
                    # leader (the admission itself was durably
                    # persisted before the crash), and a takeover-
                    # recovered job re-submitted through the new
                    # leader is the same case — ack it instead of
                    # failing a script whose job is in fact admitted
                    # and running. A job id is an identity: same id +
                    # same entry IS the same job.
                    return {"admitted": True, "job_id": job_id,
                            "slots": int(existing.config.get(
                                "session.slots-per-job", slots)),
                            "duplicate": True, "queued_behind": []}
                self._c_rejected.inc()
                return {"admitted": False,
                        "reason": f"job id {job_id!r} is already active "
                                  f"({existing.state}) with a different "
                                  "entry point"}
            conf["session.slots-per-job"] = slots
            # checkpoint isolation: every tenant gets its own directory
            # subtree — a job restoring 'latest' can only ever see its
            # own manifests
            base = str(conf.get("execution.checkpointing.dir",
                                CheckpointingOptions.DIRECTORY.default))
            conf["execution.checkpointing.dir"] = os.path.join(
                base, job_id)
            # fault isolation: the runner installs this job's plan
            # scoped to its job id instead of process-globally
            if str(conf.get("faults.inject", "") or "").strip():
                conf["session.scoped-faults"] = True
            # fair drain: co-resident emit rings share the link through
            # the round-robin gate
            conf.setdefault("session.fair-drain", True)
            job = JobInfo(job_id, state="WAITING_FOR_RESOURCES",
                          attempts=1, entry=entry, config=conf,
                          required_devices=slots,
                          py_blobs=list(py_blobs or []),
                          egraph=ExecutionGraph(job_id, slots))
            # the DURABLE registry write comes FIRST: admission only
            # returns (and the registry only gains the job) once the
            # entry/config/quota AND its FIFO queue position
            # (submitted_at) are on disk — a store failure here loses
            # the submission cleanly, never half-registers it, and a
            # leader crash one instruction later still recovers the job
            self._persist_locked(job)
            self.jobs[job_id] = job
            self._strategies[job_id] = from_config(self.config)
            queued_behind = [
                j.job_id for j in self.jobs.values()
                if j.entry is not None and j.job_id != job_id
                and j.state == "WAITING_FOR_RESOURCES"]
        self._c_admitted.inc()
        self._deploy_async(job_id)
        return {"admitted": True, "job_id": job_id, "slots": slots,
                "queued_behind": queued_behind}

    def _admit_locked(self, j: JobInfo) -> bool:
        """max-jobs headroom + FIFO position, under the coordinator
        lock. A RESTARTING job was already admitted — its recovery
        never re-queues behind new submissions."""
        if not self._is_session_job(j):
            return True
        if j.state == "RESTARTING":
            return True
        # RESTARTING jobs COUNT toward headroom: an admitted job mid-
        # recovery still owns its admission — a queued peer slipping in
        # during the restart window would over-admit past max-jobs the
        # moment the recovery deploy (which bypasses the gate above)
        # lands
        running = sum(1 for x in self.jobs.values()
                      if x.entry is not None
                      and x.state in ("RUNNING", "RESTARTING"))
        headroom = self.max_jobs - running
        if headroom <= 0:
            return False
        waiting = sorted(
            (x for x in self.jobs.values()
             if x.entry is not None
             and x.state == "WAITING_FOR_RESOURCES"),
            key=lambda x: x.submitted_at)
        return j.job_id in {x.job_id for x in waiting[:headroom]}

    def _admit_refusal(self, j: JobInfo) -> str:
        return (f"queued: session.max-jobs={self.max_jobs} reached "
                "(deploys FIFO as running jobs finish)")

    def _waiting_locked(self) -> List[str]:
        """Submission-order queue: capacity kicks walk it FIFO, so the
        oldest queued job gets first claim on freed headroom/slots."""
        ws = [j for j in self.jobs.values()
              if j.state == "WAITING_FOR_RESOURCES" and j.entry is not None]
        ws.sort(key=lambda j: j.submitted_at)
        return [j.job_id for j in ws]

    def _deploy_config_locked(self, j: JobInfo, config: dict,
                              target) -> dict:
        """Per-deploy config injection (lock held, allocation done):
        stamp the resource-share denominator. The share is SLOT-
        PROPORTIONAL and STATIC — K = how many jobs of this quota fit
        one runner (runner-slots // slots-per-job, clamped by
        max-jobs), NOT the momentary resident count: a deploy-order-
        dependent denominator would hand the first tenant the whole
        host pool forever while later tenants get fractions (and the
        combined usage would oversubscribe). Same discipline as the
        reference's per-slot managed-memory split: a slot's share of
        the TaskManager is fixed by the slot count, not by occupancy.
        The driver divides its host-pool workers and in-flight credit
        by K."""
        if not self._is_session_job(j):
            return config
        slots = max(1, int(j.config.get("session.slots-per-job", 1)))
        config["session.concurrent-jobs"] = max(
            1, min(self.max_jobs, self.runner_slots // slots))
        return config

    # -- registry / lifecycle -------------------------------------------
    def rpc_session_jobs(self) -> dict:
        """The per-job registry view: id, state, quota, attempts,
        runners, queue position (FIFO index among waiting jobs),
        lifecycle stamps, and the newest heartbeat-carried metrics
        snapshot."""
        with self._lock:
            queue_pos = {jid: i for i, jid in
                         enumerate(self._waiting_locked())}
            jobs = []
            for j in self.jobs.values():
                jobs.append({
                    "job_id": j.job_id,
                    "state": j.state,
                    "slots": int(j.config.get("session.slots-per-job", 0))
                    if self._is_session_job(j) else None,
                    "attempts": j.attempts,
                    "runners": list(j.assigned_runners),
                    "queue_position": queue_pos.get(j.job_id),
                    "submitted_at": j.submitted_at,
                    "started_at": j.started_at,
                    "finished_at": j.finished_at,
                    "failure": j.failure,
                    "metrics": j.last_metrics,
                })
        jobs.sort(key=lambda r: r["submitted_at"])
        return {"jobs": jobs, "leader_epoch": self.leader_epoch,
                "takeovers": self.takeovers}

    def rpc_session_info(self) -> dict:
        with self._lock:
            runners = {
                r.runner_id: {
                    "alive": r.alive, "draining": r.draining,
                    "slots_total": self._slots.capacity(r),
                    "slots_free": self._slots.free_slots(r),
                } for r in self.runners.values()}
            running = sum(1 for j in self.jobs.values()
                          if j.entry is not None and j.state == "RUNNING")
            queued = len(self._waiting_locked())
        return {
            "runners": runners,
            "running_jobs": running,
            "queued_jobs": queued,
            "quotas": {"slots-per-job": self.default_slots,
                       "runner-slots": self.runner_slots,
                       "max-jobs": self.max_jobs},
            # leadership view: the fencing epoch of this incumbency,
            # how many lease STEALS the HA domain has seen (clean
            # restarts advance the epoch but are not takeovers), and
            # how many jobs THIS leader re-hydrated at grant
            "leader_epoch": self.leader_epoch,
            "takeovers": self.takeovers,
            "recovered_jobs": self.recovered_jobs,
            "metrics": self.registry.snapshot(),
        }

    def rpc_stop_session(self) -> dict:
        """Shut the cluster down: refuse new submissions, cancel every
        non-terminal job (queued AND running — `flink stop` on the
        whole session), and signal the serving loop to exit once the
        cancels settle."""
        with self._lock:
            self._closing = True
            victims = [j.job_id for j in self.jobs.values()
                       if j.state in ("RUNNING", "RESTARTING",
                                      "WAITING_FOR_RESOURCES")]
        for jid in victims:
            self.rpc_cancel_job(jid)
        self.stop_event.set()
        return {"ok": True, "stopping": True, "canceled": victims}

    # -- autoscaling -----------------------------------------------------
    def _autoscale_loop(self) -> None:
        interval = self.config.get(
            SessionOptions.AUTOSCALE_INTERVAL) / 1000
        # sleep in <=1s slices so close() is honored promptly, but tick
        # only once per CONFIGURED interval — a 30s interval must not
        # fire the provisioner every second
        next_tick = time.time() + interval
        while not self._closed:
            time.sleep(min(max(next_tick - time.time(), 0.05), 1.0))
            if self._closed or time.time() < next_tick:
                continue
            next_tick = time.time() + interval
            try:
                self._autoscale_tick()
            except Exception:  # noqa: BLE001 — scaling is best-effort;
                pass           # the next tick re-evaluates from scratch

    def _autoscale_tick(self, now: Optional[float] = None) -> None:
        """One evaluation: queue depth / slot pressure → scale-out
        demand through the provisioner; idle runners above the floor →
        drain + release. Split out (with an injectable clock) so tests
        drive ticks deterministically."""
        now = time.time() if now is None else now
        min_runners = int(self.config.get(SessionOptions.MIN_RUNNERS))
        max_runners = int(self.config.get(SessionOptions.MAX_RUNNERS))
        idle_ms = self.config.get(SessionOptions.SCALE_DOWN_IDLE)
        with self._lock:
            waiting = self._waiting_locked()
            alive = [r for r in self.runners.values()
                     if r.alive and not r.draining]
            capacity = sum(self._slots.capacity(r) for r in alive)
            used = sum(self._slots.used_devices(r.runner_id)
                       for r in alive)
            running = sum(1 for j in self.jobs.values()
                          if j.entry is not None
                          and j.state in ("RUNNING", "RESTARTING"))
            headroom = max(0, self.max_jobs - running)
            # only jobs the admission gate WOULD let through can use
            # new capacity: a job parked by the max-jobs headroom
            # cannot deploy no matter how many runners register, so it
            # must neither drive scale-out nor pin idle runners alive
            admissible = waiting[:headroom]
            pressure = (used / capacity) if capacity else 1.0
            self._g_running.set(float(running))
            self._g_queued.set(float(len(waiting)))
            self._g_pressure.set(round(pressure, 3))
            demands: List[Dict[str, Any]] = []
            if len(alive) < max_runners:
                # grow on ADMISSIBLE queue depth, or on full slot
                # pressure with admission headroom left (the next
                # submission would have to wait — pre-warm one
                # runner's worth of slots). Demand is CLAMPED to the
                # slot capacity the fleet may still grow by
                # (session.max-runners × runner-slots), honoring the
                # option's ceiling contract — the provisioner must
                # never be asked for more than the cluster would use.
                budget = (max_runners - len(alive)) * self.runner_slots
                if admissible:
                    for w in admissible:
                        need = self.jobs[w].required_devices
                        if need > budget:
                            break
                        budget -= need
                        demands.append(
                            {"job_id": w, "required_devices": need})
                elif (capacity and pressure >= 1.0 and headroom > 0
                      and budget >= self.runner_slots):
                    demands = [{"job_id": "(slot-pressure)",
                                "required_devices": self.runner_slots}]
            # idle tracking for scale-in
            victims: List[str] = []
            spare = len(alive) - min_runners
            for r in alive:
                if self._slots.used_devices(r.runner_id) > 0:
                    self._idle_since.pop(r.runner_id, None)
                    continue
                since = self._idle_since.setdefault(r.runner_id, now)
                if (spare > len(victims) and not admissible
                        and now - since >= idle_ms / 1000):
                    victims.append(r.runner_id)
            prov = self.provisioner
        if demands:
            self._c_scale_up.inc()
            prov.request_capacity(demands)
        for rid in victims:
            # the inherited drain path: unschedulable + stop-with-
            # savepoint any stragglers (there are none — the runner was
            # idle); the provisioner may then remove the machine
            self._idle_since.pop(rid, None)
            self.rpc_drain_runner(rid)
            prov.release_capacity([rid])
            self._c_scale_down.inc()


# ---------------------------------------------------------------------------
# local cluster harness (CLI `session start --local-runners`, tests)
# ---------------------------------------------------------------------------

class LocalSessionCluster:
    """Dispatcher + RPC server + N in-process runners, one object —
    the MiniCluster analogue for session mode. Everything rides the
    real RPC plane (runner registration, heartbeats, deploy pushes),
    only the processes are threads. The runners run their jobs on
    ``device``."""

    def __init__(self, config: Optional[Configuration] = None,
                 runners: int = 1, runner_prefix: str = "local",
                 port: int = 0, device: str = "cuda") -> None:
        from flink_tpu_torch.runtime.runner import TaskRunner

        self.dispatcher = SessionDispatcher(config)
        self.server = RpcServer(self.dispatcher, port)
        self.port = self.server.port
        self.address = f"127.0.0.1:{self.port}"
        self.runners: List[Any] = []
        for i in range(runners):
            r = TaskRunner("127.0.0.1", self.port,
                           runner_id=f"{runner_prefix}-{i}", device=device)
            r.start()
            self.runners.append(r)
        deadline = time.time() + 30
        while len(self.dispatcher.runners) < runners:
            if time.time() > deadline:
                raise TimeoutError("local session runners never "
                                   "registered")
            time.sleep(0.05)

    def submit(self, entry: str, config: Optional[dict] = None,
               job_id: Optional[str] = None) -> dict:
        import uuid

        job_id = job_id or f"job-{uuid.uuid4().hex[:8]}"
        return self.dispatcher.rpc_submit_session_job(
            job_id, entry=entry, config=dict(config or {}))

    def wait(self, job_id: str, timeout: float = 180.0) -> str:
        """Block until the job reaches a terminal state; returns it."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            j = self.dispatcher.jobs.get(job_id)
            if j is not None and j.state in ("FINISHED", "FAILED",
                                             "CANCELED"):
                return j.state
            time.sleep(0.05)
        j = self.dispatcher.jobs.get(job_id)
        raise TimeoutError(
            f"job {job_id} not terminal after {timeout}s "
            f"(state={j.state if j else 'UNKNOWN'!r}, "
            f"failure={getattr(j, 'failure', None)!r})")

    def close(self) -> None:
        for r in self.runners:
            try:
                r.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self.dispatcher.close()
        self.server.close()

    def __enter__(self) -> "LocalSessionCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _drain_stop(disp: SessionDispatcher) -> None:
    """Stop acknowledged: give the in-flight RPC response and the
    runners' cancel pushes a moment to settle before teardown."""
    deadline = time.time() + 15
    while time.time() < deadline:
        with disp._lock:
            busy = any(j.state in ("RUNNING", "RESTARTING")
                       for j in disp.jobs.values())
        if not busy:
            break
        time.sleep(0.1)
    time.sleep(0.3)


def _build_dispatcher(config: Configuration,
                      retries: int = 3) -> SessionDispatcher:
    """Construct the dispatcher with bounded retries: takeover
    re-hydration reads shared storage (and hosts the
    ``session.failover.takeover`` fault point) — a transient failure
    there must not burn the whole incumbency. Quota errors are
    permanent and re-raise immediately."""
    last: Optional[Exception] = None
    for i in range(retries):
        try:
            return SessionDispatcher(config)
        except ValueError:
            raise  # bad quotas: retrying cannot help
        except Exception as e:  # noqa: BLE001 — shared-fs transients
            last = e
            time.sleep(0.2 * (i + 1))
    raise last  # type: ignore[misc]


def serve_session(config: Configuration, port: int = 0,
                  local_runners: int = 0, standby: bool = False,
                  device: str = "cuda") -> int:
    """`python -m flink_tpu_torch session start` body: serve a dispatcher
    (optionally with in-process local runners on ``device``) until `session stop`
    arrives or the process is interrupted. Prints ONE json line with
    the serving address first — scripts read it to find the port.

    With ``high-availability.dir`` set, the process runs the
    contend → serve-while-leader → revoke-and-stop-serving cycle
    (the coordinator.py main() discipline): N contenders (``--standby``
    documents the intent) share one lease directory; on grant the new
    leader re-hydrates the durable session registry, re-queues
    undeployed jobs in original FIFO order, and waits for runners to
    re-attach live executions before any redeploy. A revoked leader
    tears its endpoint down — a stalled process that lost its lease
    must not keep accepting work (split-brain)."""
    import json
    import socket
    import sys
    import uuid

    from flink_tpu_torch.config import HighAvailabilityOptions

    ha_dir = str(config.get(HighAvailabilityOptions.HA_DIR)).strip()
    standby = bool(standby or config.get(SessionOptions.HA_STANDBY))
    if standby and not ha_dir:
        print("error: --standby needs high-availability.dir (the "
              "shared lease + durable-registry directory all "
              "contenders point at)", file=sys.stderr)
        return 2

    if not ha_dir:
        cluster = LocalSessionCluster(config, runners=local_runners,
                                      port=port, device=device)
        print(json.dumps({"session": cluster.address,
                          "port": cluster.port,
                          "runners": local_runners}), flush=True)
        disp = cluster.dispatcher
        try:
            while not disp.stop_event.wait(0.2):
                pass
            _drain_stop(disp)
        except KeyboardInterrupt:
            pass
        finally:
            cluster.close()
        return 0

    # -- HA mode ---------------------------------------------------------
    # the lease must carry this contender's address BEFORE it can win,
    # so an ephemeral port is resolved up front
    if port == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    address = f"127.0.0.1:{port}"
    print(json.dumps({"session": address, "port": port,
                      "runners": local_runners, "ha_dir": ha_dir,
                      "standby": standby}), flush=True)

    from flink_tpu_torch.runtime.ha import LeaderElection
    from flink_tpu_torch.runtime.runner import TaskRunner, device_count

    if local_runners:
        # the runners' device is resolved before this process contends:
        # loading the CUDA runtime and counting the cards holds the GIL
        # for long enough to stall the lease's renewals past a short
        # high-availability.lease-timeout, and a standby would steal the
        # lease of a leader that is only starting its runner
        from flink_tpu_torch.device import resolve_device

        device_count(str(resolve_device(device)))
    grant_evt = threading.Event()
    revoke_evt = threading.Event()
    election = LeaderElection(
        ha_dir, address,
        config.get(HighAvailabilityOptions.LEASE_TIMEOUT) / 1000)
    election.on_grant = lambda epoch: grant_evt.set()
    election.on_revoke = revoke_evt.set
    election.start()
    runners: List[Any] = []
    try:
        while True:
            print("contending for session leadership...", flush=True)
            grant_evt.wait()
            grant_evt.clear()
            revoke_evt.clear()
            disp = _build_dispatcher(config)
            # fencing: stamped between construction and serving so no
            # runner push can ever leave unstamped
            disp.leader_epoch = election.epoch
            server = RpcServer(disp, port)
            print(json.dumps({"elected": True, "epoch": election.epoch,
                              "recovered_jobs": disp.recovered_jobs}),
                  flush=True)
            if local_runners and not runners:
                # spawned at FIRST grant (a standby's fleet must not
                # sit registered to a peer before it leads); unique ids
                # so a takeover's fleet can never be mistaken for the
                # dead leader's stored runners
                tag = uuid.uuid4().hex[:6]
                for i in range(local_runners):
                    r = TaskRunner("127.0.0.1", port,
                                   runner_id=f"local-{tag}-{i}",
                                   ha_dir=ha_dir, device=device)
                    r.start()
                    runners.append(r)
            stopped = False
            while True:
                if disp.stop_event.wait(0.1):
                    stopped = True
                    break
                if revoke_evt.is_set():
                    break
            if stopped:
                _drain_stop(disp)
                disp.close()
                server.close()
                return 0
            # leadership lost: STOP SERVING (jobs re-load from the
            # durable registry on the next grant, so dropping the
            # in-memory state is safe); local runners stay up — they
            # follow the new leader through the lease
            print("session leadership revoked; closing", flush=True)
            disp.close()
            server.close()
    except KeyboardInterrupt:
        return 0
    finally:
        for r in runners:
            try:
                r.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        election.close()
