"""The cross-process data plane: a synchronous all-to-all exchange a step.

Each process of a job owns a contiguous span of key shards
(``partitioners.hybrid_route``). Every step, each process routes the
records it ingested to their owners and the N-way rendezvous
synchronizes the step across the fleet. That barrier carries three
things a streaming runtime otherwise needs machinery for:

- flow control: a slow process holds everyone back at the next
  rendezvous (credit windows collapse into the step cadence);
- watermark propagation: each frame carries the sender's source
  watermark, and every process computes the same global minimum;
- checkpoint alignment: a snapshot at a step boundary has no record in
  flight anywhere, so process-local snapshots taken at the same step
  compose into one consistent cut.

The plane is TCP between host processes, as in the JAX package (whose
frames this one reads and writes, ``exchange/frames.py``): the shares
are host numpy columns routed before ingest, together with the per-step
consensus metadata (watermark, done, ckpt, persisted), and two
processes of a job may share one card.

- **Wire format**: binary frames (magic, version, sender, step,
  watermark, per-array dtype/shape/CRC'd raw sections), decoded as
  zero-copy numpy views. ``codec="legacy"`` keeps the v0 checkpoint-blob
  framing (synchronous ``exchange`` only), decoded with the
  ``__pickle__`` escape refused.
- **Parallel peer I/O**: the N−1 sends and N−1 receives of one
  rendezvous overlap on per-peer I/O threads (``cluster.dcn-io-threads``
  caps the sender workers; receivers are per peer), payload bytes
  shipped by ``socket.sendmsg`` scatter buffers.
- **Step overlap**: ``exchange_async`` returns a handle whose
  ``result()`` is the barrier, so the driver routes step N+1's records
  while step N's are consumed (``runtime/driver.py``
  ``_ingest_loop_dcn``).

Admission: the hello is ``[magic b"D2"][sender:1][attempt:4][codec:1]
[auth_flag:1]``; with a ``secret`` (``cluster.dcn-secret``) the flag is
1 and an HMAC-SHA256 over the 9 hello bytes follows. A keyed listener
closes any connection whose flag or MAC does not match; an unkeyed
listener closes a keyed dialer. The magic and the codec byte fence out a
peer of another wire version or codec at the hello, never mid-frame,
and the attempt fences out a process of an earlier attempt. Fault
points: ``dcn.accept``, ``dcn.send``, ``dcn.send.partial`` and
``dcn.recv`` (``faults.py``).
"""
from __future__ import annotations

import hmac as _hmac
import queue as _queue
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch import faults
from flink_tpu_torch.checkpoint import blobformat
from flink_tpu_torch.exchange import frames
from flink_tpu_torch.exchange.frames import FrameError

_MAC_LEN = 32  # HMAC-SHA256 digest appended to the hello when keyed

#: versioned hello: magic, sender, attempt, codec, auth flag
_HELLO = struct.Struct(">2sBIBB")
_HELLO_MAGIC = b"D2"
_CODEC_IDS = {"legacy": 0, "binary": 1}


class DcnExchange:
    """N-process synchronous all-to-all (one instance per process per
    job). ``port`` is ready after construction; ``connect`` blocks
    until the full mesh is up.

    ``codec="binary"`` (default, the production wire): parallel per-peer
    I/O threads + ``exchange_async``. ``codec="legacy"``: the v0 serial
    blobformat path, the JAX package's legacy wire byte for byte,
    synchronous ``exchange`` only."""

    def __init__(self, process_id: int, n_processes: int,
                 listen_port: int = 0,
                 bind_host: str = "127.0.0.1",
                 attempt: int = 0,
                 secret: Optional[str] = None,
                 codec: str = "binary",
                 io_threads: int = 0,
                 buffer_bytes: int = 0) -> None:
        if codec not in _CODEC_IDS:
            raise ValueError(
                f"dcn codec must be 'binary' or 'legacy', got {codec!r}")
        self.pid = process_id
        self.n = n_processes
        self.codec = codec
        self._io_threads = int(io_threads)
        self._buffer_bytes = int(buffer_bytes)
        # per-job shared secret (cluster.dcn-secret): hellos must carry
        # a matching HMAC or the accept loop drops the connection
        self._secret = (secret.encode() if isinstance(secret, str)
                        else secret) or None
        # attempt-epoch fence: the connect handshake carries the
        # dialer's attempt id and the accept loop rejects mismatches,
        # so a stale process from a previous attempt can never join the
        # rendezvous of the static cluster.dcn-peers mode (ref: Flink
        # fences RPCs with the fencing token / leader epoch)
        self.attempt = attempt
        #: hello rejections (reason strings) — the mixed-version /
        #: wrong-codec / unauthenticated fleet tripwire, visible to
        #: tests and operators without scraping logs
        self.hello_rejects: List[str] = []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # loopback by DEFAULT (an open listener is an admission surface;
        # the driver widens to 0.0.0.0 only when the configured peers
        # are actually off-host — cluster.dcn-bind overrides either way)
        self._srv.bind((bind_host, listen_port))
        self._srv.listen(n_processes)
        self.port = self._srv.getsockname()[1]
        self._in: Dict[int, socket.socket] = {}
        self._out: Dict[int, socket.socket] = {}
        # binary-codec I/O plane (built in connect(), once the mesh is
        # complete): per-peer receive threads/queues, grouped sender
        # workers, first-error-wins fault cell
        self._closing = False
        self._send_workers: List["_SendWorker"] = []
        self._worker_of: Dict[int, "_SendWorker"] = {}
        self._recvq: Dict[int, "_queue.Queue"] = {}
        self._recv_threads: List[threading.Thread] = []
        self._io_err: Optional[BaseException] = None
        self._io_err_lock = threading.Lock()
        self._legacy_sent = 0
        self._step = 0          # next step to dispatch
        self._result_step = 0   # next step to collect (ordering guard)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    @property
    def supports_async(self) -> bool:
        return self.codec == "binary"

    @property
    def bytes_sent(self) -> int:
        """Frame bytes this endpoint has handed to its sockets."""
        return self._legacy_sent + sum(w.sent_bytes
                                       for w in self._send_workers)

    # -- admission -------------------------------------------------------
    def _reject(self, conn: socket.socket, reason: str) -> None:
        self.hello_rejects.append(reason)
        conn.close()

    def _accept_loop(self) -> None:
        while len(self._in) < self.n - 1:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # a connect-and-close probe (port scan) must not kill the
            # accept thread — the real peer's dial is still coming; a
            # connection that stalls mid-hello is cut by the timeout so
            # it cannot park the accept loop forever either
            try:
                faults.fire("dcn.accept", exc=ConnectionError)
                conn.settimeout(10.0)
                hello = _read_exact(conn, _HELLO.size)
                peer_keyed = hello[8] == 1
                # drain the MAC whenever the dialer sent one, keyed or
                # not — leftover MAC bytes must never be parsed as a
                # frame header later
                mac = _read_exact(conn, _MAC_LEN) if peer_keyed else b""
                conn.settimeout(None)
            except (ConnectionError, socket.timeout, OSError):
                conn.close()
                continue
            if hello[:2] != _HELLO_MAGIC:
                # a pre-binary-wire peer (v0 hello had no magic) or
                # garbage: the mixed-version fleet fails HERE, at the
                # hello — never by misparsing a foreign frame header
                self._reject(conn, "bad hello magic (peer speaks a "
                                   "different DCN wire version)")
                continue
            if peer_keyed != bool(self._secret):
                self._reject(conn, "asymmetric secret config")
                continue
            if self._secret and not _hmac.compare_digest(
                    mac, _hmac.new(self._secret, hello, "sha256").digest()):
                self._reject(conn, "unauthenticated hello (bad MAC)")
                continue
            _, sender, peer_attempt, peer_codec, _ = _HELLO.unpack(hello)
            if peer_codec != _CODEC_IDS[self.codec]:
                # a frame-format split brain would corrupt mid-stream;
                # fence it out where it is cheap and attributable
                self._reject(conn, f"codec mismatch (peer={peer_codec}, "
                                   f"local={_CODEC_IDS[self.codec]})")
                continue
            if sender >= self.n or peer_attempt != self.attempt:
                self._reject(conn, "stale attempt or bogus peer id")
                continue
            if self._buffer_bytes > 0:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                self._buffer_bytes)
            self._in[sender] = conn

    def connect(self, peers: List[str], timeout_s: float = 30.0) -> None:
        """``peers[j]`` = "host:port" of process j's listener (the entry
        for self is ignored). Dials every peer and waits until every
        inbound connection arrived; with the binary codec the per-peer
        I/O threads start here, once the mesh is complete."""
        deadline = time.time() + timeout_s
        for j, addr in enumerate(peers):
            if j == self.pid:
                continue
            host, _, port = addr.partition(":")
            while True:
                try:
                    s = socket.create_connection((host, int(port)),
                                                 timeout=2.0)
                    break
                except OSError:
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"p{self.pid}: cannot reach peer {j} at {addr}")
                    time.sleep(0.05)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._buffer_bytes > 0:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                             self._buffer_bytes)
            hello = _HELLO.pack(_HELLO_MAGIC, self.pid, self.attempt,
                                _CODEC_IDS[self.codec],
                                1 if self._secret else 0)
            if self._secret:
                hello += _hmac.new(self._secret, hello, "sha256").digest()
            s.sendall(hello)
            self._out[j] = s
        while len(self._in) < self.n - 1:
            if time.time() > deadline:
                raise TimeoutError(
                    f"p{self.pid}: only {len(self._in)} of "
                    f"{self.n - 1} inbound peers connected")
            time.sleep(0.02)
        if self.codec == "binary":
            self._start_io()

    # -- binary I/O plane ------------------------------------------------
    def _start_io(self) -> None:
        peers_out = sorted(self._out)
        cap = self._io_threads if self._io_threads > 0 else len(peers_out)
        cap = max(1, min(cap, max(len(peers_out), 1)))
        self._send_workers = [_SendWorker(self) for _ in range(cap)]
        for i, j in enumerate(peers_out):
            # a peer sticks to ONE worker so its frame order is FIFO
            self._worker_of[j] = self._send_workers[i % cap]
        for j, conn in sorted(self._in.items()):
            q: "_queue.Queue" = _queue.Queue()
            self._recvq[j] = q
            t = threading.Thread(target=self._recv_loop, args=(j, conn, q),
                                 daemon=True)
            t.start()
            self._recv_threads.append(t)

    def _recv_loop(self, j: int, conn: socket.socket,
                   q: "_queue.Queue") -> None:
        """One frame stream: fixed-header read, one body read, zero-copy
        decode — each frame gets its OWN body buffer, so payload views
        stay valid while later frames stream in (double-buffered
        overlap)."""
        try:
            while True:
                hdr = _read_exact(conn, frames.HEADER_LEN)
                (sender, flags, step, wm, persisted, n_arrays,
                 body_len) = frames.decode_header(hdr)
                if sender != j:
                    raise FrameError(
                        f"frame from peer {j} claims sender {sender}")
                body = _read_exact_mv(conn, body_len)
                meta, payload = frames.decode_body(
                    flags, wm, persisted, n_arrays, body)
                q.put((step, meta, payload))
        except BaseException as e:  # noqa: BLE001 — surfaced at result()
            if not self._closing:
                q.put(e)

    def _record_io_err(self, e: BaseException) -> None:
        with self._io_err_lock:
            if self._io_err is None:
                self._io_err = e

    def _check_io_err(self) -> None:
        e = self._io_err
        if e is not None:
            raise e

    # -- the rendezvous --------------------------------------------------
    def exchange_async(self, shares: Dict[int, Any],
                       meta: Dict[str, Any]) -> "_ExchangeHandle":
        """Dispatch one rendezvous step WITHOUT waiting for the peers'
        frames: encodes + enqueues a frame per peer (the per-peer
        sender workers ship them concurrently) and returns a handle
        whose ``result()`` is the step barrier. At most a couple of
        steps should be in flight — the driver double-buffers."""
        if self.codec != "binary":
            raise RuntimeError(
                "exchange_async requires the binary codec (the legacy "
                "wire is synchronous)")
        step = self._step
        self._step += 1
        for j in sorted(self._out):
            faults.fire("dcn.send", exc=ConnectionError, peer=j)
            # encode IN the worker, not here: the per-array CRC pass is
            # the dominant per-byte cost and runs GIL-free — on the
            # caller it would serialize all N-1
            # outbound checksums on one thread, exactly what the
            # worker fan-out exists to overlap. An encode failure
            # (FrameError) parks in the first-error cell and surfaces
            # at the step barrier like any send death.
            self._worker_of[j].q.put(
                (j, (self.pid, step, meta, shares.get(j))))
        return _ExchangeHandle(self, step, shares.get(self.pid),
                               dict(meta))

    def exchange(self, shares: Dict[int, Any],
                 meta: Dict[str, Any]) -> Tuple[List[Any], List[Dict]]:
        """One rendezvous: send ``shares[j]`` + ``meta`` to each peer j,
        receive each peer's share-for-me + meta. Returns
        (payloads_by_process, metas_by_process); the self entries are
        ``shares.get(pid)`` and ``meta``. Blocks until every peer's
        frame arrives — the step barrier."""
        if self.codec == "binary":
            return self.exchange_async(shares, meta).result()
        return self._exchange_legacy(shares, meta)

    def _exchange_legacy(self, shares: Dict[int, Any],
                         meta: Dict[str, Any]) -> Tuple[List[Any],
                                                        List[Dict]]:
        """The v0 wire, unchanged: serial send-then-recv per peer,
        8-byte length + blobformat payload, kept so a fleet pinned to
        the legacy codec still forms its mesh (the codec byte of the
        hello keeps the two wires apart)."""
        for j, s in self._out.items():
            faults.fire("dcn.send", exc=ConnectionError, peer=j)
            raw = blobformat.encode(
                {"data": shares.get(j), "meta": meta})
            s.sendall(struct.pack(">Q", len(raw)) + raw)
            self._legacy_sent += 8 + len(raw)
        payloads: List[Any] = [None] * self.n
        metas: List[Dict] = [dict() for _ in range(self.n)]
        payloads[self.pid] = shares.get(self.pid)
        metas[self.pid] = meta
        for j, s in self._in.items():
            faults.fire("dcn.recv", exc=ConnectionError, peer=j)
            # allow_pickle=False: a hostile frame carrying a __pickle__
            # escape fails loudly instead of deserializing foreign code
            frame = blobformat.decode(_read_frame(s), allow_pickle=False)
            payloads[j] = frame["data"]
            metas[j] = frame["meta"]
        return payloads, metas

    def close(self) -> None:
        self._closing = True
        # FLUSH before closing: the last step's frames may still sit in
        # the sender queues (a process that just consumed its final
        # barrier exits while its own frame is in flight) — closing the
        # sockets first would cut a PEER's final drain mid-frame. The
        # join is bounded: a worker wedged on a dead peer must not turn
        # close into a hang.
        for w in self._send_workers:
            w.q.put(None)
        for w in self._send_workers:
            w.thread.join(timeout=5.0)
        for s in list(self._out.values()) + list(self._in.values()):
            try:
                s.close()
            except OSError:
                pass
        try:
            # wake an accept() still blocked on the listener: a blocked
            # accept holds a kernel reference that keeps the socket in
            # LISTEN past close() — the next attempt's rebind of a
            # fixed cluster.dcn-port would die with EADDRINUSE
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)


class _SendWorker:
    """One sender thread shipping frames for its assigned peers (FIFO
    per peer — a peer maps to exactly one worker). Errors park in the
    exchange's first-error cell; the worker keeps draining its queue so
    producers never block behind a dead socket."""

    def __init__(self, ex: DcnExchange) -> None:
        self.ex = ex
        self.sent_bytes = 0  # written by this worker's thread only
        self.q: "_queue.Queue" = _queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        ex = self.ex
        while True:
            item = self.q.get()
            if item is None:
                return
            j, frame_args = item
            if ex._io_err is not None:
                continue  # drain: the step already failed
            try:
                faults.fire("dcn.send.partial", exc=ConnectionError,
                            peer=j)
                self.sent_bytes += _sendmsg_all(ex._out[j],
                                                frames.encode(*frame_args))
            except BaseException as e:  # noqa: BLE001
                if not ex._closing:
                    ex._record_io_err(e)


class _ExchangeHandle:
    """The deferred half of one rendezvous step. ``result()`` blocks
    until every peer's step-matching frame arrived (or an I/O error
    surfaced) — the barrier the driver moves from dispatch to
    consumption for step overlap."""

    def __init__(self, ex: DcnExchange, step: int,
                 self_payload: Any, self_meta: Dict[str, Any]) -> None:
        self._ex = ex
        self.step = step
        self._self_payload = self_payload
        self._self_meta = self_meta
        self._res: Optional[Tuple[List[Any], List[Dict]]] = None

    def result(self) -> Tuple[List[Any], List[Dict]]:
        if self._res is not None:
            return self._res
        ex = self._ex
        if ex._result_step != self.step:
            raise FrameError(
                f"exchange results must be collected in dispatch order "
                f"(expected step {ex._result_step}, asked {self.step})")
        payloads: List[Any] = [None] * ex.n
        metas: List[Dict] = [dict() for _ in range(ex.n)]
        payloads[ex.pid] = self._self_payload
        metas[ex.pid] = self._self_meta
        for j in sorted(ex._recvq):
            faults.fire("dcn.recv", exc=ConnectionError, peer=j)
            step_r, meta_j, payload_j = self._take(j)
            if step_r != self.step:
                raise FrameError(
                    f"peer {j} frame step {step_r} != expected "
                    f"{self.step} — rendezvous desync")
            payloads[j] = payload_j
            metas[j] = meta_j
        ex._result_step = self.step + 1
        self._res = (payloads, metas)
        return self._res

    def _take(self, j: int):
        q = self._ex._recvq[j]
        while True:
            # the barrier blocks indefinitely, like the v0 recv — a slow
            # peer backpressures the fleet by design — but polls the
            # I/O-error cell so a LOCAL send failure (our frame never
            # left) surfaces instead of deadlocking on a peer that is
            # itself waiting for us
            self._ex._check_io_err()
            try:
                item = q.get(timeout=0.2)
            except _queue.Empty:
                continue
            if isinstance(item, BaseException):
                raise item
            return item


_IOV_MAX = 1024  # kernel iovec limit per sendmsg (POSIX floor)


def _sendmsg_all(s: socket.socket, buffers: List[Any]) -> int:
    """Scatter-send a buffer list without concatenating (the payload
    arrays ship straight from their numpy memory); loops on partial
    sends and never hands the kernel more than IOV_MAX iovecs per call
    (a ~512-array frame would otherwise die EMSGSIZE on every attempt
    — deterministically, so recovery could never progress). Returns the
    bytes sent."""
    bufs = [b if isinstance(b, memoryview) else memoryview(b)
            for b in buffers]
    bufs = [b.cast("B") if b.format != "B" else b for b in bufs]
    bufs = [b for b in bufs if b.nbytes]
    total = sum(b.nbytes for b in bufs)
    while bufs:
        sent = s.sendmsg(bufs[:_IOV_MAX])
        while bufs and sent:
            if bufs[0].nbytes <= sent:
                sent -= bufs[0].nbytes
                bufs.pop(0)
            else:
                bufs[0] = bufs[0][sent:]
                sent = 0
    return total


def _read_frame(s: socket.socket) -> bytes:
    hdr = _read_exact(s, 8)
    n = struct.unpack(">Q", hdr)[0]
    return _read_exact(s, n)


def _read_exact(s: socket.socket, n: int) -> bytes:
    return bytes(_read_exact_mv(s, n))


def _read_exact_mv(s: socket.socket, n: int) -> memoryview:
    """Read exactly n bytes into ONE fresh buffer (recv_into — no
    per-chunk bytes objects to join) and return it as a memoryview the
    zero-copy decoder can slice. np.empty, not bytearray: bytearray(n)
    ZERO-FILLS, a wasted full-buffer memset per megabyte frame."""
    buf = np.empty(n, np.uint8)
    view = memoryview(buf).cast("B") if n else memoryview(b"")
    got = 0
    while got < n:
        r = s.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return view
