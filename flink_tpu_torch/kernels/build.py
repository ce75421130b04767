"""Build the CUDA kernel sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with one ``nvcc`` call into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries land in ``flink_tpu_torch/_build/`` under a name
that carries a hash of the source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source or header never loads a stale build. Nothing here runs at import time: the CPU tests
import every module of the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"cmd": [...], "seconds": float, "ptxas": str, "cached": bool}
BUILD_LOG: Dict[str, dict] = {}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda,
    then PATH. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels build only where the CUDA toolkit is "
        "installed")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_command(name: str, out: str) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, name + ".cu")]


def build_all(names: Sequence[str]) -> None:
    """Compile every named source that has no current build — one nvcc
    process per source, all started together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            BUILD_LOG.setdefault(name, {"cmd": None, "seconds": 0.0,
                                        "ptxas": "", "cached": True})
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = build_command(name, tmp)
        procs.append((name, out, tmp, cmd, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, out, tmp, cmd, t0, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = {"cmd": cmd, "seconds": time.perf_counter() - t0,
                           "ptxas": stdout + stderr, "cached": False}
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = _loaded[name] = ctypes.CDLL(library_path(name))
        return lib
