"""Job supervision — run with automatic failure recovery.

ref: the region-failover flow (SURVEY §4.E): task failure → restart
strategy consulted → cancel region → restore from the latest checkpoint
→ redeploy. The driver's pipeline is one pipelined region, so recovery =
rebuild the driver and resume from the newest complete checkpoint with
replayable sources (exactly-once end to end with 2PC sinks)."""
from __future__ import annotations

import time
from typing import Any, Callable

from flink_tpu_torch.config import Configuration
from flink_tpu_torch.runtime.restart import from_config


def run_with_recovery(
    build_env: Callable[[Configuration], Any],
    config: Configuration,
    job_name: str = "job",
    sleep_fn: Callable[[float], None] = time.sleep,
    device: Any = "cuda",
):
    """``build_env(config)`` must construct a FRESH
    StreamExecutionEnvironment (sources/sinks re-created per attempt —
    the redeploy step). First attempt starts fresh (or per config
    restore); every retry restores from the latest checkpoint. Each
    attempt runs on ``device`` ("cuda" by default; pass "cpu"
    explicitly)."""
    from flink_tpu_torch import faults
    from flink_tpu_torch.obs.tracing import tracer

    # chaos deploys configure injection through faults.* — install once
    # per process (idempotent for an unchanged spec+seed, so rule
    # counters survive the restarts the plan itself causes)
    faults.install_from_config(config)
    strategy = from_config(config)
    attempt_conf = config
    attempt = 1
    while True:
        try:
            # build INSIDE the retry scope: constructing sources/sinks
            # is part of the redeploy step (a lease acquisition losing
            # a fencing race, a dirty-topic recovery sweep failing — a
            # deploy-time death restarts like any task failure, the
            # cluster path's coordinator.deploy discipline)
            env = build_env(attempt_conf)
            return env.execute(job_name, device=device)
        except Exception as e:  # noqa: BLE001 — any task failure
            if not strategy.can_restart():
                raise
            delay = strategy.next_delay_ms()
            # recovery span: failure → backoff → redeployed (the restore
            # itself is the 'restore' span inside the next execute; ref:
            # job recovery spans, SURVEY §6.1). The metrics half rides
            # the process-global recovery.attempts counter.
            attempt += 1
            faults.record_recovery(job_name)
            with tracer.span("recovery", job=job_name, attempt=attempt,
                             delay_ms=delay,
                             error=f"{type(e).__name__}: {e}",
                             injected=faults.is_injected(e)):
                faults.fire("supervisor.restart", exc=RuntimeError,
                            job=job_name, attempt=attempt)
                sleep_fn(delay / 1000.0)
            attempt_conf = Configuration(config.to_dict()).set(
                "execution.checkpointing.restore", "latest")
