"""Active resource provisioning seam (the JAX package's
``runtime/provisioner.py``).

ref: runtime/resourcemanager/active/ActiveResourceManager.java — the
reference's active mode REQUESTS new TaskManagers from YARN/K8s when
slot demand outstrips supply and RELEASES idle ones. Here the
coordinator owns the slot inventory (scheduler.SlotPool); this seam is
how unmet demand reaches whatever actually provisions machines:

- ``request_capacity(demands)`` fires whenever a job parks in
  WAITING_FOR_RESOURCES, with one entry per waiting job
  ({job_id, required_devices}). Implementations scale the runner
  fleet out; the coordinator deploys automatically when the new
  runner registers (the existing capacity-kick path).
- Scale-IN goes through ``JobCoordinator.rpc_drain_runner``: jobs on
  the drained runner stop-with-savepoint and redeploy elsewhere with
  their state; once the runner holds nothing, the provisioner may
  remove the machine.

The default is the recording no-op (standalone mode — capacity is
whatever registers, ref StandaloneResourceManager); the kubectl stub
shows the k8s wiring without assuming a cluster exists in CI.
"""
from __future__ import annotations

import subprocess
from typing import Any, Dict, List


class Provisioner:
    def request_capacity(self, demands: List[Dict[str, Any]]) -> None:
        raise NotImplementedError

    def release_capacity(self, runner_ids: List[str]) -> None:
        """Scale-IN: the named runners hold nothing (the coordinator
        already drained them via ``rpc_drain_runner``) and may be
        removed. Default no-op — standalone mode leaves machine
        lifecycle to whoever started the runner."""


class StandaloneProvisioner(Provisioner):
    """No active provisioning (ref: StandaloneResourceManager): demand
    is recorded for observability; capacity arrives when someone starts
    a runner."""

    def __init__(self) -> None:
        self.requests: List[List[Dict[str, Any]]] = []
        self.releases: List[List[str]] = []

    def request_capacity(self, demands: List[Dict[str, Any]]) -> None:
        self.requests.append(list(demands))

    def release_capacity(self, runner_ids: List[str]) -> None:
        self.releases.append(list(runner_ids))


class KubectlScaleProvisioner(Provisioner):
    """Scale-out stub for the kubernetes deployment
    (deploy/kubernetes.yaml runs runners as a scalable workload):
    translates unmet demand into a ``kubectl scale`` call. ``dry_run``
    (default) only records the command — CI has no cluster; the
    deployment docs show the live wiring."""

    def __init__(self, workload: str = "deployment/flink-tpu-runner",
                 namespace: str = "default", max_replicas: int = 32,
                 dry_run: bool = True) -> None:
        self.workload = workload
        self.namespace = namespace
        self.max_replicas = max_replicas
        self.dry_run = dry_run
        self.commands: List[List[str]] = []
        self._target = 0

    def request_capacity(self, demands: List[Dict[str, Any]]) -> None:
        want = sum(max(1, int(d.get("required_devices", 1)))
                   for d in demands)
        target = min(self.max_replicas, max(self._target, want))
        if target <= self._target:
            return
        self._target = target
        self._scale(target)

    def release_capacity(self, runner_ids: List[str]) -> None:
        """Scale-in targeting THE DRAINED PODS, not an arbitrary one:
        a bare replica decrement lets the Deployment controller pick
        its victim, which can kill a BUSY runner while the drained
        idle pod keeps running (its jobs would ride loss-detection
        restarts for nothing). The drained pod is marked cheapest to
        evict via ``controller.kubernetes.io/pod-deletion-cost`` first,
        THEN the replica target drops — requires runner_id == pod name
        (deploy/kubernetes.yaml wires ``--runner-id`` from the
        downward-API pod name)."""
        target = max(0, self._target - len(runner_ids))
        if target == self._target:
            return
        self._target = target
        for rid in runner_ids:
            self._run(["kubectl", "-n", self.namespace, "annotate",
                       "pod", rid, "--overwrite",
                       "controller.kubernetes.io/pod-deletion-cost=-1"])
        self._scale(target)

    def _scale(self, target: int) -> None:
        self._run(["kubectl", "-n", self.namespace, "scale",
                   self.workload, f"--replicas={target}"])

    def _run(self, cmd: List[str]) -> None:
        self.commands.append(cmd)
        if not self.dry_run:
            subprocess.run(cmd, check=False, capture_output=True)
