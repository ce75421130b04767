"""The port stands alone: no module of flink_tpu_torch, nor
chip_smoke.py, imports jax or anything of the flink_tpu package (which
imports jax and switches on x64 for every importer)."""
import ast
import os

import pytest
from test_torch_threads import capped_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "flink_tpu_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "jaxlib", "flink_tpu"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_covers_the_package():
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "flink_tpu_torch/ops/window.py" in files
    assert "flink_tpu_torch/kernels/window_kernels.py" in files
    assert "flink_tpu_torch/kernels/devgen_kernels.py" in files
    assert "flink_tpu_torch/kernels/fused_kernels.py" in files
    assert "flink_tpu_torch/kernels/count_window_kernels.py" in files
    assert "flink_tpu_torch/ops/count_window.py" in files
    assert "flink_tpu_torch/kernels/topn_lanes_kernels.py" in files
    assert "flink_tpu_torch/state/spill.py" in files
    assert "flink_tpu_torch/kernels/element_kernels.py" in files
    assert "flink_tpu_torch/ops/evicting_window.py" in files
    assert "flink_tpu_torch/api/datastream.py" in files
    assert "flink_tpu_torch/api/windowing.py" in files
    assert "flink_tpu_torch/api/sinks.py" in files
    assert "flink_tpu_torch/native_codec.py" in files
    assert "flink_tpu_torch/nexmark/generator.py" in files
    for mod in ("checkpoint/coordinator.py", "checkpoint/storage.py",
                "checkpoint/blobformat.py", "obs/metrics.py",
                "obs/tracing.py", "faults.py", "fs.py", "memory.py",
                "runtime/restart.py", "runtime/supervisor.py",
                "parallel/hostpool.py", "ops/host_control.py",
                "ops/window_all.py", "ops/session.py", "ops/join.py",
                "api/functions.py", "nexmark/queries.py",
                "exchange/dcn.py", "exchange/frames.py",
                "exchange/partitioners.py", "parallel/mesh.py",
                "formats_columnar.py", "log/bus.py", "log/topic.py",
                "log/cleaner.py", "log/connectors.py", "log/__init__.py",
                "state/lsm.py",
                "ops/global_agg.py", "state/api.py", "ops/process.py",
                "ops/broadcast.py", "ops/async_io.py", "cep.py",
                "checkpoint/repartition.py", "state_processor.py",
                "fs_crash.py", "fs_objstore.py", "table/__init__.py",
                "table/expressions.py", "table/api.py", "table/sql.py",
                "connectors.py", "formats.py", "fsck.py",
                "exchange/blocking.py", "runtime/scheduler.py",
                "runtime/rpc.py", "runtime/blob.py",
                "runtime/provisioner.py", "runtime/coordinator.py",
                "runtime/runner.py", "cli.py", "__main__.py"):
        assert f"flink_tpu_torch/{mod}" in files
    assert "chip_smoke.py" in files


def test_native_codec_builds_only_the_port_source(monkeypatch, tmp_path):
    """The port's host codec compiles flink_tpu_torch/native/codec.cc
    alone, into flink_tpu_torch/_build/ — never the reference's
    native/codec.cc or its library."""
    import subprocess

    from flink_tpu_torch import native_codec as nc

    assert nc.SOURCE == os.path.join(ROOT, "flink_tpu_torch", "native", "codec.cc")
    assert os.path.dirname(nc.library_path()) == os.path.join(
        ROOT, "flink_tpu_torch", "_build")
    cmds = []
    real_run = subprocess.run

    def run(cmd, *a, **k):
        cmds.append(list(cmd))
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(nc.subprocess, "run", run)
    monkeypatch.setattr(nc, "BUILD_DIR", str(tmp_path))
    path = nc.build()
    assert os.path.dirname(path) == str(tmp_path) and os.path.exists(path)
    [cmd] = cmds
    inputs = [a for a in cmd if a.endswith((".cc", ".cpp", ".c", ".so"))]
    assert inputs == [nc.SOURCE]
    with open(os.path.join(ROOT, "flink_tpu_torch", "native_codec.py")) as f:
        text = f.read()
    assert "libflinktpucodec" not in text


def test_the_hybrid_worker_path_imports_no_jax():
    """``chip_smoke.py --hybrid-worker``'s path, run in a fresh
    interpreter: the script and every module its worker imports load
    without jax or flink_tpu, and without a card the entry refuses (a
    non-zero exit, no result)."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r); import chip_smoke\n"
        "import flink_tpu_torch.api.environment, flink_tpu_torch.api.sinks\n"
        "import flink_tpu_torch.checkpoint.storage\n"
        "import flink_tpu_torch.exchange.dcn, flink_tpu_torch.exchange.keyby\n"
        "import flink_tpu_torch.nexmark.generator\n"
        "import flink_tpu_torch.parallel.mesh, flink_tpu_torch.runtime.driver\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flink_tpu'))\n"
        "assert not bad, bad\n"
        "sys.argv = ['chip_smoke.py', '--hybrid-worker', '{}']\n"
        "sys.exit(chip_smoke.main())\n" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_the_rescale_worker_path_imports_no_jax():
    """``chip_smoke.py --rescale-worker``'s path and the modules of the
    host-patterns phase load without jax or flink_tpu; without a card
    the entry refuses."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r); import chip_smoke\n"
        "import flink_tpu_torch.cep, flink_tpu_torch.ops.async_io\n"
        "import flink_tpu_torch.ops.broadcast, flink_tpu_torch.state_processor\n"
        "import flink_tpu_torch.checkpoint.repartition\n"
        "import flink_tpu_torch.runtime.driver\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flink_tpu'))\n"
        "assert not bad, bad\n"
        "sys.argv = ['chip_smoke.py', '--rescale-worker', '{}']\n"
        "sys.exit(chip_smoke.main())\n" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_the_control_plane_imports_no_jax_and_a_card_runner_refuses():
    """The coordinator, the runner and the command line load without jax
    or flink_tpu; a runner asked for ``cuda`` without a card exits
    non-zero at start, before it registers anywhere."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import flink_tpu_torch.cli, flink_tpu_torch.runtime.coordinator\n"
        "import flink_tpu_torch.runtime.runner, flink_tpu_torch.runtime.blob\n"
        "import flink_tpu_torch.runtime.provisioner\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flink_tpu'))\n"
        "assert not bad, bad\n" % ROOT)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    proc = subprocess.run(
        [sys.executable, "-m", "flink_tpu_torch.runtime.runner",
         "--coordinator", "127.0.0.1:9"], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
