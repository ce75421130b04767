"""Control-plane RPC — length-prefixed JSON over TCP (the JAX
package's ``runtime/rpc.py``, the same wire: a client of either package
calls an endpoint of the other).

ref: flink-rpc/flink-rpc-core/.../runtime/rpc/{RpcEndpoint,RpcService,
RpcGateway}.java with Pekko remoting as transport. The control plane
moves few, coarse messages (submit, heartbeat, checkpoint trigger/ack),
so a compact stdlib transport suffices; the seam is the ``RpcService``
interface — a gRPC/C++ transport drops in behind it without touching
endpoints (SURVEY §3.10 item 4).

Concurrency discipline reproduced from the reference: every endpoint's
state is touched ONLY from its single dispatch thread (ref:
RpcEndpoint main-thread executor, MainThreadValidatorUtil) — requests
queue and run serially, so endpoints need no locks.
"""
from __future__ import annotations

import json
import queue
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from flink_tpu_torch import faults

_LEN = struct.Struct(">I")


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_msg(sock: socket.socket) -> Optional[Any]:
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return json.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class RpcEndpoint:
    """Subclass and define ``rpc_<name>(self, **kwargs)`` methods."""


class RpcServer:
    """Serves one endpoint; all calls dispatch on ONE thread (the
    main-thread executor discipline)."""

    def __init__(self, endpoint: RpcEndpoint, port: int = 0) -> None:
        self.endpoint = endpoint
        self._calls: "queue.Queue" = queue.Queue()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()
        calls = self._calls

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    msg = _recv_msg(self.request)
                    if msg is None:
                        return
                    done = threading.Event()
                    box: Dict[str, Any] = {}
                    calls.put((msg, box, done))
                    done.wait()
                    try:
                        _send_msg(self.request, box["resp"])
                    except (BrokenPipeError, ConnectionResetError):
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._serve_thread.start()

    def dispatch(self, method: str, **args: Any) -> Any:
        """Run an endpoint method ON the dispatch thread and return its
        result — the seam co-located protocol fronts (REST) use so the
        single-dispatch-thread discipline holds for every caller, not
        just TCP clients. Raises RpcError on endpoint faults."""
        done = threading.Event()
        box: Dict[str, Any] = {}
        self._calls.put(({"method": method, "args": args}, box, done))
        done.wait()
        resp = box["resp"]
        if "error" in resp:
            raise RpcError(resp["error"])
        return resp["result"]

    def _dispatch_loop(self) -> None:
        while True:
            item = self._calls.get()
            if item is None:
                return
            msg, box, done = item
            try:
                faults.fire("rpc.server.dispatch", exc=RuntimeError,
                            method=msg.get("method"))
                fn = getattr(self.endpoint, "rpc_" + msg["method"], None)
                if fn is None:
                    box["resp"] = {"error": f"no such method {msg['method']}"}
                else:
                    box["resp"] = {"result": fn(**msg.get("args", {}))}
            except Exception as e:  # noqa: BLE001 — faults go to caller
                box["resp"] = {"error": f"{type(e).__name__}: {e}"}
            finally:
                done.set()

    def close(self) -> None:
        self._server.shutdown()
        # close the LISTENER too: shutdown() only stops the accept
        # loop, leaving the bound socket accepting connections that no
        # one will ever answer — peers of a dead endpoint would hang
        # out their full RPC timeout instead of failing fast
        # (connection refused), stretching HA failover detection from
        # milliseconds to multiples of the timeout, and a revoked
        # leader could never rebind its own port on re-grant
        self._server.server_close()
        self._calls.put(None)


class RpcError(RuntimeError):
    pass


class RpcClient:
    """Transport-fault tolerance: a failed send/recv (socket error or a
    peer that closed mid-call, e.g. a restarting server) RECONNECTS and
    retries with exponential backoff before surfacing RpcError — a
    single dropped TCP connection must not register as a peer failure
    (ref: Pekko remoting's transparent reconnect under the reference's
    RPC). Control-plane calls are idempotent by design (register /
    heartbeat / report_* / trigger re-sends are absorbed), so a retry
    after an ambiguous send is safe. ``retries=0`` restores the old
    fail-fast behavior."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0,
                 retries: int = 2, retry_backoff_s: float = 0.05) -> None:
        self._addr = (host, port)
        self._timeout = timeout_s
        self._retries = max(0, int(retries))
        self._backoff = retry_backoff_s
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self._addr, timeout=self._timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def call(self, method: str, **args: Any) -> Any:
        delay = self._backoff
        for attempt in range(self._retries + 1):
            try:
                with self._lock:
                    # the dead socket is torn down INSIDE the lock: a
                    # concurrent caller must never have its in-flight
                    # recv's socket closed out from under it
                    try:
                        faults.fire("rpc.client.send", exc=ConnectionError,
                                    method=method)
                        sock = self._connect()
                        _send_msg(sock, {"method": method, "args": args})
                        faults.fire("rpc.client.recv", exc=ConnectionError,
                                    method=method)
                        resp = _recv_msg(sock)
                        if resp is None:
                            raise ConnectionError(
                                "connection closed by peer")
                    except OSError:
                        self.close()
                        raise
            except OSError as e:
                if attempt >= self._retries:
                    raise RpcError(
                        f"rpc transport failure after {attempt + 1} "
                        f"attempt(s): {e}") from e
                time.sleep(delay)
                delay *= 2
                continue
            if "error" in resp:
                raise RpcError(resp["error"])
            return resp["result"]

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
