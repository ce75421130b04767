"""Deterministic fault injection at named recovery seams.

A **fault point** is a named call site at a recovery-critical seam,
``faults.fire("checkpoint.storage.rename", exc=OSError)``. With no plan
active the call is one module attribute read and a ``None`` check.

A **FaultPlan** decides, per invocation of a point, whether to inject:

- ``raise``: raise the site's declared exception type (``exc=``),
  tagged ``injected fault at <point>`` (``is_injected``);
- ``drop``: raise ``ConnectionError``;
- ``delay``: sleep ``delay_ms``, then continue;
- ``crash``: ``os._exit(137)``, for subprocess chaos only.

Every decision is a pure function of (seed, point name, per-point
invocation index): each point has its own counter and its own PRNG
stream seeded by ``f"{seed}:{point}"``, so the same seed and the same
per-point call sequence give the same schedule. Rules may also be exact
(``after``/``count``).

Configuration (``faults.*``)::

    faults.seed:   1234
    faults.inject: checkpoint.storage.write=raise x1 +2

Rule grammar: ``point=kind`` with optional ``@prob``, ``xCOUNT`` (max
injections), ``+AFTER`` (skip the first AFTER invocations) and
``~DELAY_MS``; rules separated by ``;``. The point may be an ``fnmatch``
glob (``checkpoint.*``). Every injection is a ``fault`` span on the
process-global tracer and a ``faults.<point>.<kind>`` counter in this
module's ``registry``; the supervisor counts restarts there
(``recovery.attempts``).

The plan is process-global, or scoped to a job id (``install_scoped``,
``job_scope``): a scoped thread uses its job's plan exclusively.

The port's points (``KNOWN_FAULT_POINTS``)::

    fs.write.enospc / fs.fsync / fs.rename                 fs.py
    checkpoint.storage.stall / .write / .fsync / .rename   checkpoint/storage.py
    checkpoint.upload                                      checkpoint/coordinator.py
    supervisor.restart                                     runtime/supervisor.py
    host.pool.task                                         parallel/hostpool.py
    dcn.accept / dcn.send / dcn.send.partial / dcn.recv    exchange/dcn.py
    dcn.frame.encode                                       exchange/frames.py
    dcn.overlap.consume                                    runtime/driver.py
    state.run.seal / state.run.fsync / state.compact.swap  state/lsm.py
    state.changelog.link                                   checkpoint/storage.py
    changelog.retract.emit                                 ops/global_agg.py

The reference's other points (RPC, the log tier, sessions, HA, rescale)
come with the modules that fire them (ROADMAP.md queue 1 items 6 to
10).
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import random
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.config import FaultOptions
from flink_tpu_torch.obs.metrics import MetricRegistry

FAULT_SEED = FaultOptions.SEED
FAULT_INJECT = FaultOptions.INJECT

# every point this package fires (see the module docstring)
KNOWN_FAULT_POINTS = frozenset((
    "fs.write.enospc",
    "fs.fsync",
    "fs.rename",
    "checkpoint.storage.stall",
    "checkpoint.storage.write",
    "checkpoint.storage.fsync",
    "checkpoint.storage.rename",
    "checkpoint.upload",
    "supervisor.restart",
    "host.pool.task",
    "dcn.accept",
    "dcn.send",
    "dcn.send.partial",
    "dcn.recv",
    "dcn.frame.encode",
    "dcn.overlap.consume",
    "state.run.seal",
    "state.run.fsync",
    "state.compact.swap",
    "state.changelog.link",
    "changelog.retract.emit",
))

# process-global fault/recovery metrics — chaos tests assert every
# injection and every recovery attempt is visible here and on the tracer
registry = MetricRegistry()

_INJECTED_TAG = "injected fault at "


def is_injected(exc: BaseException) -> bool:
    """True when an exception was raised by a fault point (the message
    tag survives str()/re-wrapping in error reports)."""
    return _INJECTED_TAG in str(exc)


@dataclasses.dataclass
class FaultRule:
    """One injection rule; ``point`` may be an fnmatch glob."""

    point: str
    kind: str = "raise"           # raise | drop | delay | crash
    probability: float = 1.0
    count: int = -1               # max injections by this rule; -1 = inf
    after: int = 0                # skip the first N invocations
    delay_ms: float = 0.0
    injected: int = 0             # runtime: injections so far

    def __post_init__(self) -> None:
        if self.kind not in ("raise", "drop", "delay", "crash"):
            raise ValueError(
                f"fault kind must be raise|drop|delay|crash, "
                f"got {self.kind!r}")


class FaultPlan:
    """Seed-driven injection schedule over named fault points.

    Build programmatically (``plan.rule(...)`` chains) or from config
    (``FaultPlan.from_spec``); activate process-globally with the
    context manager::

        with FaultPlan(seed=7).rule("checkpoint.storage.write",
                                    "raise", count=1).activate():
            run_with_recovery(build, conf)

    ``plan.log`` records every injection as (point, kind, seq) — the
    replayable schedule a failing chaos test prints with its seed.
    """

    def __init__(self, seed: int = 0,
                 rules: Optional[List[FaultRule]] = None,
                 spec: str = "") -> None:
        self.seed = int(seed)
        self.rules: List[FaultRule] = list(rules or [])
        self.spec = spec
        self.log: List[Tuple[str, str, int]] = []
        self._counts: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._lock = threading.RLock()

    def rule(self, point: str, kind: str = "raise", p: float = 1.0,
             count: int = -1, after: int = 0,
             delay_ms: float = 0.0) -> "FaultPlan":
        self.rules.append(FaultRule(point, kind, p, count, after, delay_ms))
        return self

    _HEAD_RE = re.compile(
        r"(?P<point>[\w.\-*?\[\]]+)\s*=\s*(?P<kind>raise|drop|delay|crash)")
    _MOD_RE = re.compile(r"\s*(?P<op>[@x+~])\s*(?P<val>[\d.]+)")

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        plan = cls(seed=seed, spec=spec)
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            head = cls._HEAD_RE.match(part)
            mods: Dict[str, float] = {}
            pos = head.end() if head else 0
            while head and pos < len(part):
                m = cls._MOD_RE.match(part, pos)
                if m is None:
                    head = None
                    break
                mods[m["op"]] = float(m["val"])
                pos = m.end()
            if head is None:
                raise ValueError(
                    f"bad faults.inject rule {part!r} (grammar: "
                    "'point=kind [@prob] [xCOUNT] [+AFTER] [~DELAY_MS]', "
                    "modifiers in any order)")
            plan.rule(head["point"], head["kind"],
                      p=mods.get("@", 1.0),
                      count=int(mods.get("x", -1)),
                      after=int(mods.get("+", 0)),
                      delay_ms=mods.get("~", 0.0))
        return plan

    def decide(self, point: str) -> Optional[Tuple[FaultRule, int]]:
        """One invocation of ``point``: the matching rule to apply (and
        the invocation index), or None. Thread-safe; deterministic per
        (seed, point, invocation index)."""
        with self._lock:
            n = self._counts.get(point, 0)
            self._counts[point] = n + 1
            for r in self.rules:
                if not fnmatch.fnmatchcase(point, r.point):
                    continue
                if n < r.after:
                    continue
                if 0 <= r.count <= r.injected:
                    continue
                if r.probability < 1.0:
                    rng = self._rngs.get(point)
                    if rng is None:
                        rng = self._rngs[point] = random.Random(
                            f"{self.seed}:{point}")
                    if rng.random() >= r.probability:
                        continue
                r.injected += 1
                self.log.append((point, r.kind, n))
                return r, n
            return None

    @contextlib.contextmanager
    def activate(self):
        """Install as the process-global plan for the with-block (tests);
        nesting restores the previous plan on exit."""
        global _active
        prev = _active
        _active = self
        try:
            yield self
        finally:
            _active = prev


_active: Optional[FaultPlan] = None
_active_from_config = False
_counter_lock = threading.Lock()
_counters: Dict[Tuple[str, str], Any] = {}

# job-scoped plans (session-cluster isolation): job_id -> plan, plus
# the thread-local scope marking which job the current thread serves
_scoped: Dict[str, FaultPlan] = {}
_scope_tls = threading.local()


def active_plan() -> Optional[FaultPlan]:
    return _active


def current_scope() -> Optional[str]:
    """Job id the current thread is scoped to (None = unscoped)."""
    return getattr(_scope_tls, "job", None)


def set_thread_scope(job_id: Optional[str]) -> None:
    """Pin THIS thread's scope permanently — the executor-initializer
    form of ``job_scope`` (a driver's checkpoint worker thread serves
    exactly one job for its whole life)."""
    _scope_tls.job = job_id


@contextlib.contextmanager
def job_scope(job_id: Optional[str]):
    """Mark the current thread as serving ``job_id`` for the block;
    ``fire`` resolves that job's scoped plan first. None is a no-op
    passthrough (callers thread an optional scope without branching)."""
    prev = getattr(_scope_tls, "job", None)
    _scope_tls.job = job_id
    try:
        yield
    finally:
        _scope_tls.job = prev


def install_scoped(job_id: str, config,
                   fresh: bool = False) -> Optional[FaultPlan]:
    """Install the config's fault plan scoped to ``job_id`` — the
    session-cluster deploy path (one plan per tenant, never the
    process-global slot). Same idempotence contract as
    ``install_from_config``: an identical (spec, seed) keeps the
    existing plan's counters, so count-limited rules survive recovery
    re-deploys instead of re-firing forever; an empty spec uninstalls.

    ``fresh=True`` (the runner passes it on attempt 1) REPLACES any
    existing plan regardless: a brand-new submission reusing a job id
    must never inherit the exhausted counters of a prior tenant that
    FAILED terminally (the terminal-failure path cannot reliably
    uninstall — the runner doesn't see the coordinator's fail/restart
    decision)."""
    spec = str(config.get(FAULT_INJECT) or "").strip()
    with _counter_lock:
        if not spec:
            _scoped.pop(job_id, None)
            return None
        seed = int(config.get(FAULT_SEED))
        cur = _scoped.get(job_id)
        if (not fresh and cur is not None and cur.spec == spec
                and cur.seed == seed):
            return cur
        plan = FaultPlan.from_spec(spec, seed=seed)
        _scoped[job_id] = plan
        return plan


def uninstall_scoped(job_id: str) -> None:
    """Drop a job's scoped plan (terminal completion / cancel — the
    tenant left; its schedule must not leak to a job id reuse)."""
    with _counter_lock:
        _scoped.pop(job_id, None)


def install_from_config(config) -> Optional[FaultPlan]:
    """Install the config's fault plan process-globally (the deploy/CLI
    path — tests prefer ``plan.activate()``). Idempotent for an
    identical (spec, seed): counters must persist across recovery
    attempts or count-limited rules would re-fire forever and the job
    could never complete. An EMPTY spec uninstalls a previously
    config-installed plan — a chaos job's schedule must not leak into
    the next, fault-free job sharing the runner process (a test's
    context-managed plan is left alone)."""
    global _active, _active_from_config
    spec = str(config.get(FAULT_INJECT) or "").strip()
    if not spec:
        if _active_from_config:
            _active = None
            _active_from_config = False
        return None
    seed = int(config.get(FAULT_SEED))
    if (_active is not None and _active.spec == spec
            and _active.seed == seed):
        return _active
    _active = FaultPlan.from_spec(spec, seed=seed)
    _active_from_config = True
    return _active


def clear() -> None:
    """Drop the process-global plan AND every scoped plan (teardown
    safety)."""
    global _active, _active_from_config
    _active = None
    _active_from_config = False
    with _counter_lock:
        _scoped.clear()


def fire(point: str, exc: type = RuntimeError, **attrs: Any) -> None:
    """A fault point. ``exc`` is the exception type a ``raise`` rule
    uses — the site declares what a real failure there would look like
    (OSError for storage, ConnectionError for transports) so injected
    faults travel the production error paths."""
    plan = _active
    if _scoped:
        # a scoped thread uses its job's plan EXCLUSIVELY (tenant
        # isolation); a scope with no plan of its own falls back to the
        # global plan (tests' activate()); unscoped threads (heartbeat,
        # RPC dispatch — process-shared seams) stay on the global plan
        sid = getattr(_scope_tls, "job", None)
        if sid is not None:
            sp = _scoped.get(sid)
            if sp is not None:
                plan = sp
    if plan is None:
        return
    hit = plan.decide(point)
    if hit is None:
        return
    rule, seq = hit
    _record(point, rule.kind, seq, attrs)
    if rule.kind == "delay":
        time.sleep(rule.delay_ms / 1000.0)
        return
    if rule.kind == "crash":
        import os

        os._exit(137)
    base = ConnectionError if rule.kind == "drop" else exc
    raise base(f"{_INJECTED_TAG}{point} "
               f"(kind={rule.kind}, seq={seq}, seed={plan.seed})")


def _record(point: str, kind: str, seq: int,
            attrs: Dict[str, Any]) -> None:
    from flink_tpu_torch.obs.tracing import tracer

    with tracer.span("fault", point=point, kind=kind, seq=seq, **attrs):
        pass
    key = (point, kind)
    c = _counters.get(key)
    if c is None:
        with _counter_lock:
            c = _counters.get(key)
            if c is None:
                c = registry.group("faults", point).counter(kind)
                _counters[key] = c
    c.inc()


_recovery_counter = None


def record_recovery(job: str) -> None:
    """Count one supervised restart in the process-global registry (the
    metrics half of 'every recovery attempt is visible'; the tracing
    half is the supervisor's ``recovery`` span)."""
    global _recovery_counter
    if _recovery_counter is None:
        with _counter_lock:
            if _recovery_counter is None:
                _recovery_counter = registry.group(
                    "recovery").counter("attempts")
    _recovery_counter.inc()


def snapshot() -> Dict[str, Any]:
    """Flat view of the fault/recovery counters (test assertions)."""
    return registry.snapshot()
