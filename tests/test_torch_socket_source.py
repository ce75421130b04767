"""The port's socket source (``connectors.SocketSource`` on the host
codec's C reader, ``native_codec.NativeSocketReader``) against its
plain version in Python (``connectors._PySocketReader``) and against the
JAX package's, case by case of ``tests/test_socket_source.py``: the same
payload, cut in awkward chunks, comes back whole from every reader, and
a windowed count over TCP commits the reference's rows. Every listener
is closed by the end of its case.

``test_finished_runners_reset_on_restart`` holds the port's job
coordinator to the reference's: a job split over two runners finishes
once both report done, and a restart clears the runners that had."""
import socket
import threading
import time

import numpy as np
import pytest

from test_torch_file_pkgs import BOTH, J, P
from test_torch_threads import capped_torch_threads  # noqa: F401


def _feed(port, payload: bytes, chunk=7):
    """A producer thread writing ``payload`` in chunks of ``chunk`` bytes
    (the partial-line carry), then disconnecting."""
    def run():
        s = socket.create_connection(("127.0.0.1", port))
        for lo in range(0, len(payload), chunk):
            s.sendall(payload[lo:lo + chunk])
        s.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _drain(reader, payload, cap=64):
    t = _feed(reader.port, payload)
    deadline = time.time() + 30
    try:
        while reader.accept(100) == 0:
            assert time.time() < deadline, "producer never connected"
        got = b""
        while True:
            b = reader.read_block(cap, timeout_ms=200)
            if b is None:
                break
            got += b
            assert b == b"" or b.endswith(b"\n")
            assert time.time() < deadline, "reader never saw EOF"
    finally:
        t.join()
        reader.close()
    return got


PAYLOAD = b"".join(f"{i},{i * 3}\n".encode() for i in range(100))


@pytest.mark.parametrize("make", [
    lambda: P.nc.NativeSocketReader.create(),
    lambda: P.connectors._PySocketReader(),
    lambda: J.connectors._PySocketReader(),
], ids=["port-native", "port-python", "jax-python"])
def test_readers_reassemble_lines(make):
    assert _drain(make(), PAYLOAD) == PAYLOAD


@pytest.mark.parametrize("make", [
    lambda: P.nc.NativeSocketReader.create(),
    lambda: P.connectors._PySocketReader(),
], ids=["native", "python"])
def test_unterminated_tail_discarded(make):
    assert _drain(make(), b"1,2\n3,4") == b"1,2\n"


@pytest.mark.parametrize("make", [
    lambda: P.nc.NativeSocketReader.create(),
    lambda: P.connectors._PySocketReader(),
], ids=["native", "python"])
def test_oversized_line_raises_in_both_readers(make):
    r = make()
    t = _feed(r.port, b"x" * 500 + b"\n")
    try:
        while r.accept(1000) == 0:
            pass
        with pytest.raises(IOError, match="exceeded"):
            while r.read_block(64, timeout_ms=200) is not None:
                pass
    finally:
        t.join()
        r.close()


def test_accept_wait_yields_typed_empty_batches():
    src = P.connectors.SocketSource(
        format=P.formats.CsvFormat([("k", "i64"), ("ts", "i64")]),
        ts_field="ts", poll_ms=20)
    it = src.open_split("socket")
    data, ts = next(it)  # nobody connected: a typed empty batch
    assert set(data) == {"k", "ts"}
    assert len(ts) == 0 and data["k"].dtype == np.int64
    it.close()  # the split's end closes the listener
    assert src._reader._h is None


def test_windowed_count_over_tcp():
    """A windowed count fed over TCP, in each package: the committed
    rows equal each other's and the golden."""
    rng = np.random.default_rng(0)
    n = 4000
    keys = rng.integers(0, 6, n)
    ts = np.sort(rng.integers(0, 8000, n))
    payload = b"".join(f"{k},{t}\n".encode() for k, t in zip(keys, ts))
    got = {}
    for M in BOTH:
        src = M.connectors.SocketSource(
            format=M.formats.CsvFormat([("k", "i64"), ("ts", "i64")]),
            ts_field="ts", poll_ms=50)
        env = M.Env(M.Conf({"state.num-key-shards": 8,
                            "state.slots-per-shard": 16}))
        sink = M.sinks.CollectSink()
        (env.from_source(src, M.WM.for_bounded_out_of_orderness(0))
         .key_by("k").window(M.Tumbling.of(1000)).count().add_sink(sink))
        t = _feed(src.port, payload, chunk=1024)
        M.execute(env, "socket-count")
        t.join()
        got[M.name] = {(int(r["key"]), int(r["window_end"])): int(r["count"])
                       for r in sink.rows}
    golden = {}
    for k, t in zip(keys, ts):
        kk = (int(k), (int(t) // 1000 + 1) * 1000)
        golden[kk] = golden.get(kk, 0) + 1
    assert got["port"] == got["jax"] == golden


@pytest.mark.parametrize("pkg", ["flink_tpu", "flink_tpu_torch"])
def test_finished_runners_reset_on_restart(pkg):
    import importlib

    coordinator = importlib.import_module(f"{pkg}.runtime.coordinator")
    config = importlib.import_module(f"{pkg}.config")
    coord = coordinator.JobCoordinator(config.Configuration({}))
    try:
        for r in ("a", "b"):
            coord.rpc_register_runner(r, "h", 1)
        coord.rpc_submit_job("j", runners=["a", "b"])
        coord.rpc_finish_job("j", runner_id="a")
        assert coord.rpc_job_status("j")["state"] == "RUNNING"
        coord.rpc_report_failure("j", "b crashed")
        assert coord.jobs["j"].finished_runners == []
        # attempt 2: BOTH must finish again
        coord.jobs["j"].state = "RUNNING"
        coord.rpc_finish_job("j", runner_id="b")
        assert coord.rpc_job_status("j")["state"] == "RUNNING"
        coord.rpc_finish_job("j", runner_id="a")
        assert coord.rpc_job_status("j")["state"] == "FINISHED"
    finally:
        coord.close()
