"""``tests/test_blob.py`` against the port: the content-addressed store,
the runner cache, and job code shipped to a real port runner process
(on the CPU) via ``--py-file``; plus the two packages' stores read by
each other (a digest means the same bytes in both)."""
import base64
import os
import subprocess
import sys
import time

import pytest

from flink_tpu_torch.config import Configuration
from flink_tpu_torch.runtime.blob import BlobCache, BlobStore, digest_of
from flink_tpu_torch.runtime.coordinator import start_coordinator
from flink_tpu_torch.runtime.rpc import RpcClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestBlobStore:
    def test_put_get_idempotent(self, tmp_path):
        s = BlobStore(str(tmp_path))
        d1 = s.put(b"hello")
        d2 = s.put(b"hello")
        assert d1 == d2 == digest_of(b"hello")
        assert s.get(d1) == b"hello"
        assert s.get("0" * 64) is None
        assert s.list() == [d1]

    def test_bad_digest_rejected(self, tmp_path):
        s = BlobStore(str(tmp_path))
        with pytest.raises(ValueError):
            s.get("../../etc/passwd")


class TestBlobRpc:
    def test_put_get_roundtrip_over_rpc(self):
        srv = start_coordinator(Configuration({}))
        try:
            c = RpcClient("127.0.0.1", srv.port)
            data = os.urandom(4096)
            r = c.call("put_blob", data_b64=base64.b64encode(data).decode())
            got = c.call("get_blob", digest=r["digest"])
            assert got["found"]
            assert base64.b64decode(got["data_b64"]) == data
            assert r["digest"] in c.call("list_blobs")["digests"]
            assert not c.call("get_blob", digest="f" * 64)["found"]
            c.close()
        finally:
            srv.close()

    def test_cache_fetch_and_materialize(self, tmp_path):
        srv = start_coordinator(Configuration({}))
        try:
            c = RpcClient("127.0.0.1", srv.port)
            d = c.call("put_blob", data_b64=base64.b64encode(
                b"x = 41\n").decode())["digest"]
            cache = BlobCache(c, str(tmp_path / "cache"))
            p1 = cache.fetch(d)
            p2 = cache.fetch(d)  # second hit: no RPC needed
            assert p1 == p2
            job = cache.materialize(d, str(tmp_path / "job"), "m.py")
            with open(job) as f:
                assert f.read() == "x = 41\n"
            c.close()
        finally:
            srv.close()

    def test_two_versions_same_name_do_not_shadow(self, tmp_path):
        srv = start_coordinator(Configuration({}))
        try:
            c = RpcClient("127.0.0.1", srv.port)
            d1 = c.call("put_blob", data_b64=base64.b64encode(
                b"v = 1\n").decode())["digest"]
            d2 = c.call("put_blob", data_b64=base64.b64encode(
                b"v = 2\n").decode())["digest"]
            cache = BlobCache(c, str(tmp_path / "cache"))
            j1 = cache.materialize(d1, str(tmp_path / "a1"), "job.py")
            j2 = cache.materialize(d2, str(tmp_path / "a2"), "job.py")
            assert open(j1).read() == "v = 1\n"
            assert open(j2).read() == "v = 2\n"
            c.close()
        finally:
            srv.close()


class TestBlobShippedJob:
    def test_py_file_job_runs_on_runner_process(self, tmp_path):
        """End to end: job code the runner host has never seen ships
        via the blob store and executes (the job-jar flow)."""
        out_file = tmp_path / "out.txt"
        job_src = f'''
import numpy as np

def build(env):
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows

    rng = np.random.default_rng(0)
    n = 2000
    ts = np.sort(rng.integers(0, 5000, n)).astype(np.int64)
    total = [0]
    def write(b):
        total[0] += sum(int(x) for x in b.get("count", []))
        with open({str(out_file)!r}, "w") as f:
            f.write(str(total[0]))
    (env.from_collection({{"k": rng.integers(0, 10, n).astype(np.int64)}}, ts,
                         batch_size=500)
     .key_by("k").window(TumblingEventTimeWindows.of(1000)).count()
     .add_sink(FnSink(write)))
'''
        job_path = tmp_path / "shipjob.py"
        job_path.write_text(job_src)

        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        srv = start_coordinator(Configuration({}))
        runner = None
        try:
            runner = subprocess.Popen(
                [sys.executable, "-m", "flink_tpu_torch.runtime.runner",
                 "--coordinator", f"127.0.0.1:{srv.port}",
                 "--runner-id", "blob-r1", "--device", "cpu"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                cwd=str(tmp_path))
            c = RpcClient("127.0.0.1", srv.port)
            deadline = time.time() + 90
            while time.time() < deadline:
                if "blob-r1" in c.call("list_runners"):
                    break
                time.sleep(0.2)
            # submit THROUGH the CLI path: upload + reference by digest
            from flink_tpu_torch.cli import main as cli_main

            rc = cli_main([
                "run", "--coordinator", f"127.0.0.1:{srv.port}",
                "--job-id", "shipped", "--entry", "shipjob:build",
                "--py-file", str(job_path)])
            assert rc == 0
            # the runner-hosted job takes 70-90s on a loaded CPU
            # container; the deadline bounds a hang, not the run time
            deadline = time.time() + 240
            state = None
            while time.time() < deadline:
                state = c.call("job_status", job_id="shipped")["state"]
                if state in ("FINISHED", "FAILED"):
                    break
                time.sleep(0.5)
            assert state == "FINISHED", c.call("job_status", job_id="shipped")
            assert out_file.exists() and int(out_file.read_text()) == 2000
            c.close()
        finally:
            if runner is not None:
                runner.terminate()
                runner.wait(timeout=10)
            srv.close()


def test_each_package_reads_the_others_store(tmp_path):
    """A blob put by either package's store is found by digest in the
    other's over the same directory, byte for byte."""
    from flink_tpu.runtime.blob import BlobStore as JaxBlobStore
    from flink_tpu.runtime.blob import digest_of as jax_digest_of

    port, ref = BlobStore(str(tmp_path)), JaxBlobStore(str(tmp_path))
    a, b = port.put(b"from the port"), ref.put(b"from the reference")
    assert a == jax_digest_of(b"from the port") == digest_of(b"from the port")
    assert ref.get(a) == b"from the port" and port.get(b) == b"from the reference"
    assert port.list() == ref.list() == sorted([a, b])
