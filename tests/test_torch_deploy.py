"""``deploy/kubernetes-gpu.yaml``, the port's GPU manifest: every
container's command line is accepted by the port's own parser (the
coordinator's, the runner's, the client's), names the port's modules
only, and runs the HA pieces the manifest promises — the coordinator and
the session cluster on a shared HA dir, each runner following the lease
on ``--device cuda`` with one card."""
import os
import shlex

import pytest
import yaml

from flink_tpu_torch import cli
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.runtime import coordinator, runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(REPO, "deploy", "kubernetes-gpu.yaml")


def _containers():
    with open(MANIFEST) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    out = []
    for d in docs:
        spec = d.get("spec", {}).get("template", {}).get("spec")
        for c in (spec or {}).get("containers", []):
            cmd = list(c["command"])
            if cmd[:2] == ["sh", "-c"]:
                cmd = shlex.split(cmd[2].replace("$(POD_NAME)", "pod-0"))
            out.append((d["metadata"]["name"], c, cmd))
    return out


CONTAINERS = _containers()


def test_manifest_runs_the_port_only():
    names = {n for n, _, _ in CONTAINERS}
    assert names == {"flink-torch-coordinator", "flink-torch-runner",
                     "flink-torch-session"}
    for _, _, cmd in CONTAINERS:
        assert cmd[:2] == ["python", "-m"]
        assert cmd[2].split(".")[0] == "flink_tpu_torch", cmd


@pytest.mark.parametrize("name", [n for n, _, _ in CONTAINERS])
def test_command_line_accepted_by_the_port(name):
    _, container, cmd = next(c for c in CONTAINERS if c[0] == name)
    module, argv = cmd[2], cmd[3:]
    gpus = container.get("resources", {}).get("limits", {}).get(
        "nvidia.com/gpu")
    if module == "flink_tpu_torch.runtime.coordinator":
        args = coordinator.arg_parser().parse_args(argv)
        assert args.ha_dir == "/ha" and args.rest_port == 8081
        assert gpus is None  # the coordinator runs no job
    elif module == "flink_tpu_torch.runtime.runner":
        args = runner.arg_parser().parse_args(argv)
        assert args.ha_dir == "/ha" and args.coordinator is None
        assert args.device == "cuda" and args.runner_id == "pod-0"
        assert gpus == 1
    else:
        assert module == "flink_tpu_torch"
        args = cli.arg_parser().parse_args(argv)
        assert (args.cmd, args.session_cmd) == ("session", "start")
        assert args.ha_dir and args.device == "cuda"
        assert args.local_runners == 1 and gpus == 1
        Configuration(cli._parse_conf(args.conf)).validate()
