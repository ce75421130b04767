"""Command-line frontend — the CliFrontend analogue (the JAX package's
``cli.py``, with the same commands, flags, JSON replies and exit codes:
0 = ok or clean, 1 = findings or refused, 2 = usage or path error)::

    python -m flink_tpu_torch run --coordinator H:P --entry pkg.mod:build \
        [--job-id id] [--conf key=value ...] [--py-file PATH ...]
    python -m flink_tpu_torch run --local --entry pkg.mod:build \
        [--device cuda|cpu] [...]
    python -m flink_tpu_torch run --session H:P [--ha-dir D] --entry mod:build
    python -m flink_tpu_torch session start [--port P] [--local-runners N] \
        [--device cuda|cpu] [--ha-dir D] [--standby] [--conf key=value ...]
    python -m flink_tpu_torch session submit --session H:P --entry mod:build
    python -m flink_tpu_torch session list|info|cancel|rescale|stop \
        (--session H:P | --ha-dir D) [...]
    python -m flink_tpu_torch coordinator [--port P] [--ha-dir D] \
        [--rest-port P]
    python -m flink_tpu_torch runner (--coordinator H:P | --ha-dir D) \
        [--device cuda|cpu]
    python -m flink_tpu_torch log TOPIC_DIR [--compact] [--retain] \
        [--conf key=value ...]
    python -m flink_tpu_torch fsck PATH [--repair] [--json]
    python -m flink_tpu_torch list --coordinator H:P
    python -m flink_tpu_torch status --coordinator H:P JOB_ID
    python -m flink_tpu_torch cancel --coordinator H:P JOB_ID
    python -m flink_tpu_torch savepoint --coordinator H:P JOB_ID
    python -m flink_tpu_torch rescale --coordinator H:P --devices N JOB_ID
    python -m flink_tpu_torch runners --coordinator H:P

``run --local`` runs the job in this process on ``--device`` (``cuda`` by
default; the CPU only when asked). ``coordinator`` and ``runner`` start
the job coordinator and a task runner (``runtime/coordinator.py``,
``runtime/runner.py``); ``session start`` serves a session cluster
(``runtime/session.py``) whose ``--local-runners`` run their jobs on
``--device``. Not here yet, and refused with exit 2 naming their
ROADMAP.md item: ``analyze`` and ``lint`` (queue 1 item 11).

The entry point contract is the job-jar analogue: ``module:function``
importable on the RUNNER host, taking a StreamExecutionEnvironment and
building the pipeline on it (see runtime/runner.py).
"""
from __future__ import annotations

import argparse
import json
import sys
import uuid
from typing import List, Optional


def _coord_client(spec: str, flag: str = "--coordinator"):
    from flink_tpu_torch.runtime.rpc import RpcClient

    host, _, port = spec.partition(":")
    if not port:
        raise SystemExit(f"{flag} must be HOST:PORT, got {spec!r}")
    return RpcClient(host or "127.0.0.1", int(port))


# leader re-resolution budget of the HA-aware session client: with
# --ha-dir, a connection-refused (the leader died / a standby is mid-
# takeover) re-reads the lease and retries up to this many times
# before surfacing the failure (exit 1, never a traceback). Module
# constants so tests can shrink the budget.
_HA_RETRIES = 24
_HA_RETRY_DELAY_S = 0.25


class _SessionClient:
    """Session-cluster RPC client that survives dispatcher failover.

    Address resolution: an explicit ``--session HOST:PORT`` wins for
    the FIRST attempt; with ``--ha-dir`` every retry re-resolves the
    current leader from the lease file (``runtime/ha.leader_address``),
    so a submit/list/poll issued against a dead leader lands on the
    standby that took over. Without ``--ha-dir`` transport errors
    surface immediately (the pre-HA behavior)."""

    def __init__(self, session: Optional[str], ha_dir: Optional[str],
                 flag: str = "--session") -> None:
        if not session and not ha_dir:
            # usage error, same class as a missing required flag —
            # the documented exit-2 leg of the session CLI contract
            print(f"error: {flag} HOST:PORT or --ha-dir is required",
                  file=sys.stderr)
            raise SystemExit(2)
        self._session = session
        self._ha_dir = ha_dir
        self._flag = flag
        self._client = None
        self._addr: Optional[str] = session

    def _resolve(self) -> Optional[str]:
        if self._addr:
            return self._addr
        from flink_tpu_torch.runtime.ha import leader_address

        self._addr = leader_address(self._ha_dir)
        return self._addr

    def call(self, method: str, **kw):
        import time as _time

        from flink_tpu_torch.runtime.rpc import RpcError

        last: Optional[Exception] = None
        attempts = (_HA_RETRIES + 1) if self._ha_dir else 1
        for i in range(attempts):
            if i:
                _time.sleep(_HA_RETRY_DELAY_S)
            addr = self._resolve()
            if addr is None:
                last = RpcError(
                    f"no session leader lease in --ha-dir "
                    f"{self._ha_dir!r}")
                continue
            if self._client is None:
                self._client = _coord_client(addr, flag=self._flag)
            try:
                return self._client.call(method, **kw)
            except RpcError as e:
                last = e
                self.close()
                if self._ha_dir:
                    # drop the cached address: the next attempt
                    # re-reads the lease (a takeover moves it)
                    self._addr = None
        raise last  # type: ignore[misc]

    def close(self) -> None:
        if self._client is not None:
            try:
                self._client.close()
            finally:
                self._client = None


def _parse_conf(pairs: List[str]) -> dict:
    conf = {}
    for p in pairs:
        k, sep, v = p.partition("=")
        if not sep:
            raise SystemExit(f"--conf expects key=value, got {p!r}")
        # config values are typed by the option registry at load time;
        # pass numbers through as numbers for convenience
        try:
            conf[k] = int(v)
        except ValueError:
            try:
                conf[k] = float(v)
            except ValueError:
                conf[k] = v
    return conf


_PASS_ON = ("analyze", "lint", "coordinator", "runner")


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is still to port: ROADMAP.md queue 1 item {item}")


def _run_local(entry: str, conf: dict, job_id: str,
               device: str = "cuda") -> int:
    import importlib

    from flink_tpu_torch import faults
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration

    mod_name, _, fn_name = entry.partition(":")
    build = getattr(importlib.import_module(mod_name), fn_name)
    config = Configuration(conf)
    # the faults.* grammar is live on the local path too — a chaos conf
    # passed to `run --local` must inject, not silently no-op
    faults.install_from_config(config)
    if "restart-strategy.type" in conf:
        # an EXPLICIT restart strategy runs under the supervisor:
        # failures restore from the latest checkpoint and replay (the
        # chained-jobs chaos drive). Without one, a local job stays
        # fail-fast — wrapping unconditionally would silently
        # restart-with-restore on any failure (the config default is
        # exponential-delay), changing plain `run --local` semantics.
        from flink_tpu_torch.runtime.supervisor import run_with_recovery

        def build_env(attempt_conf):
            env = StreamExecutionEnvironment(attempt_conf)
            build(env)
            return env

        result = run_with_recovery(build_env, config, job_name=job_id,
                                   device=device)
    else:
        env = StreamExecutionEnvironment(config)
        build(env)
        result = env.execute(job_id, device=device)
    print(json.dumps({"job_id": job_id, "state": "FINISHED",
                      "records_in": result.metrics.get("records_in"),
                      "records_out": result.metrics.get("records_out")}))
    return 0


def _run_attached(session: Optional[str], entry: str, conf: dict,
                  job_id: str, ha_dir: Optional[str] = None) -> int:
    """``run --session H:P``: attach the job to a RUNNING session
    cluster instead of spinning a private runtime — submit through the
    dispatcher's admission gate, then block until the job is terminal
    (the `flink run` against a session cluster flow). With --ha-dir
    the attach survives a dispatcher failover: submit and every status
    poll re-resolve the leader through the lease."""
    import time as _time

    from flink_tpu_torch.runtime.rpc import RpcError

    c = _SessionClient(session, ha_dir)
    try:
        resp = c.call("submit_session_job", job_id=job_id, entry=entry,
                      config=conf)
        if not resp.get("admitted"):
            print(json.dumps({"job_id": job_id, **resp}))
            return 1
        while True:
            st = c.call("job_status", job_id=job_id)
            state = st.get("state")
            if state in ("FINISHED", "FAILED", "CANCELED", "UNKNOWN"):
                print(json.dumps({"job_id": job_id, **st}))
                return 0 if state == "FINISHED" else 1
            _time.sleep(0.3)
    except RpcError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        c.close()


def _session(args) -> int:
    """``flink_tpu session ...``: the session-cluster control surface
    (runtime/session.py SessionDispatcher). Exit-code contract
    (the reference's; asserted in tests/test_torch_session_cluster.py
    and tests/test_torch_cli.py): 0 = ok
    (started / admitted / listed / stopped), 1 = the cluster refused
    (admission rejection, unknown job, no reachable leader), 2 = usage
    error (argparse / --standby without an HA dir)."""
    from flink_tpu_torch.runtime.rpc import RpcError

    if args.session_cmd == "start":
        from flink_tpu_torch.config import Configuration
        from flink_tpu_torch.runtime.session import serve_session

        conf = _parse_conf(args.conf)
        if args.ha_dir:
            conf["high-availability.dir"] = args.ha_dir
        return serve_session(Configuration(conf),
                             port=args.port,
                             local_runners=args.local_runners,
                             standby=args.standby,
                             device=args.device)
    c = _SessionClient(args.session, args.ha_dir)
    try:
        if args.session_cmd == "submit":
            job_id = args.job_id or f"job-{uuid.uuid4().hex[:8]}"
            resp = c.call("submit_session_job", job_id=job_id,
                          entry=args.entry,
                          config=_parse_conf(args.conf))
            print(json.dumps({"job_id": job_id, **resp}))
            return 0 if resp.get("admitted") else 1
        if args.session_cmd == "list":
            print(json.dumps(c.call("session_jobs")))
            return 0
        if args.session_cmd == "info":
            print(json.dumps(c.call("session_info")))
            return 0
        if args.session_cmd == "cancel":
            resp = c.call("cancel_job", job_id=args.job_id)
            print(json.dumps(resp))
            return 0 if resp.get("ok") else 1
        if args.session_cmd == "rescale":
            resp = c.call("rescale_job", job_id=args.job_id,
                          devices=args.devices,
                          processes=args.processes)
            print(json.dumps(resp))
            return 0 if resp.get("ok") else 1
        # stop
        resp = c.call("stop_session")
        print(json.dumps(resp))
        return 0 if resp.get("ok") else 1
    except RpcError as e:
        # no reachable leader (after the --ha-dir retry budget): the
        # cluster refused — a clean 1, never a traceback, so scripts
        # can distinguish it from a usage error
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        c.close()


def main(argv: Optional[List[str]] = None) -> int:
    try:
        return _main(argv)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def arg_parser() -> argparse.ArgumentParser:
    """The client's command line (the ``_PASS_ON`` commands hand their
    arguments to their own module's parser)."""
    p = argparse.ArgumentParser(prog="flink_tpu_torch",
                                description="flink_tpu_torch client")
    sub = p.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="submit a job")
    runp.add_argument("--entry", required=True, metavar="MODULE:FUNCTION")
    runp.add_argument("--coordinator", metavar="HOST:PORT")
    runp.add_argument("--local", action="store_true",
                      help="execute in this process (LocalExecutor)")
    runp.add_argument("--device", default="cuda",
                      help="with --local: the device the job runs on, "
                           "'cuda' (default; fails without a card) or "
                           "'cpu'")
    runp.add_argument("--session", metavar="HOST:PORT",
                      help="attach the job to a RUNNING session "
                           "cluster (`session start`) instead of "
                           "spinning a private runtime; blocks until "
                           "the job is terminal (exit 0 = FINISHED)")
    runp.add_argument("--ha-dir", default=None, metavar="DIR",
                      help="with --session (or alone): resolve the "
                           "session leader through the HA lease in "
                           "DIR; the submit and every status poll "
                           "re-resolve on connection failure, so the "
                           "attach survives a dispatcher failover")
    runp.add_argument("--job-id", default=None)
    runp.add_argument("--runtime-mode", choices=("streaming", "batch"),
                      default=None,
                      help="execution.runtime-mode: 'batch' runs a "
                           "fully bounded job in topological stage "
                           "waves over blocking columnar exchanges "
                           "(shorthand for --conf "
                           "execution.runtime-mode=...)")
    runp.add_argument("--conf", action="append", default=[],
                      metavar="KEY=VALUE")
    runp.add_argument("--py-file", action="append", default=[],
                      metavar="PATH",
                      help="ship this Python file to the runner via the "
                           "coordinator's blob store (the job-jar "
                           "analogue); repeatable")

    # the _PASS_ON commands (listed here for --help; _main hands them
    # their arguments before parsing)
    for name, help_ in (("analyze", "plan analysis (still to port)"),
                        ("lint", "repo AST lints (still to port)"),
                        ("coordinator", "serve a job coordinator "
                                        "(runtime/coordinator.py)"),
                        ("runner", "serve a task runner (runtime/runner.py)")):
        sub.add_parser(name, help=help_, add_help=False)

    sess = sub.add_parser(
        "session",
        help="session-cluster mode (runtime/session.py): one "
             "long-lived dispatcher hosting N concurrent jobs on a "
             "shared runner fleet — slot quotas, FIFO submission "
             "queue, fair drain scheduling, queue-depth autoscaling",
        epilog="exit codes: 0 = ok, 1 = the cluster refused "
               "(admission rejection / unknown job), 2 = usage error.")
    ssub = sess.add_subparsers(dest="session_cmd", required=True)
    st = ssub.add_parser(
        "start", help="serve a session dispatcher until `session "
                      "stop` (prints one JSON line with the address, "
                      "then blocks)")
    st.add_argument("--port", type=int, default=0,
                    help="dispatcher RPC port (0 = ephemeral, read it "
                         "from the printed JSON line)")
    st.add_argument("--local-runners", type=int, default=0,
                    metavar="N",
                    help="also start N in-process runners registered "
                         "to this dispatcher (a self-contained local "
                         "cluster; 0 = external runners register "
                         "themselves via python -m "
                         "flink_tpu_torch.runtime.runner)")
    st.add_argument("--device", default="cuda",
                    help="the device kind the --local-runners run their "
                         "jobs on: 'cuda' (default; fails without a "
                         "card) or 'cpu'")
    st.add_argument("--ha-dir", default=None, metavar="DIR",
                    help="shared HA directory (shorthand for --conf "
                         "high-availability.dir=DIR): contend for the "
                         "leadership lease and serve only while "
                         "holding it; the durable session registry "
                         "lives here too, so a standby takeover "
                         "recovers every admitted job")
    st.add_argument("--standby", action="store_true",
                    help="hot-standby contender: block on the "
                         "leadership lease in --ha-dir and take over "
                         "(re-hydrating the session registry) when "
                         "the incumbent's lease lapses")
    st.add_argument("--conf", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="session.* quotas / autoscale knobs and any "
                         "other cluster config")
    _HA_HELP = ("resolve the session leader through the HA lease in "
                "DIR instead of (or as failover for) a fixed "
                "--session address; connection failures re-resolve "
                "and retry with a bounded budget")
    sb = ssub.add_parser(
        "submit", help="submit a job to a running session cluster "
                       "(exit 0 = admitted or queued, 1 = rejected)")
    sb.add_argument("--session", metavar="HOST:PORT")
    sb.add_argument("--ha-dir", default=None, metavar="DIR",
                    help=_HA_HELP)
    sb.add_argument("--entry", required=True, metavar="MODULE:FUNCTION")
    sb.add_argument("--job-id", default=None)
    sb.add_argument("--conf", action="append", default=[],
                    metavar="KEY=VALUE")
    sl = ssub.add_parser(
        "list", help="per-job registry: state, slots, queue position, "
                     "attempts, heartbeat-carried metrics, leader "
                     "epoch + takeover count")
    sl.add_argument("--session", metavar="HOST:PORT")
    sl.add_argument("--ha-dir", default=None, metavar="DIR",
                    help=_HA_HELP)
    si = ssub.add_parser(
        "info", help="cluster view: runners with slot occupancy, "
                     "quotas, leader epoch, takeover count, jobs "
                     "recovered by the current leader")
    si.add_argument("--session", metavar="HOST:PORT")
    si.add_argument("--ha-dir", default=None, metavar="DIR",
                    help=_HA_HELP)
    sc = ssub.add_parser("cancel", help="cancel one session job")
    sc.add_argument("--session", metavar="HOST:PORT")
    sc.add_argument("--ha-dir", default=None, metavar="DIR",
                    help=_HA_HELP)
    sc.add_argument("job_id")
    sr = ssub.add_parser(
        "rescale", help="live-rescale one session job: savepoint + "
                        "restart at a new device width / process count "
                        "(exit 0 = dispatched, 1 = refused)")
    sr.add_argument("--session", metavar="HOST:PORT")
    sr.add_argument("--ha-dir", default=None, metavar="DIR",
                    help=_HA_HELP)
    sr.add_argument("--devices", type=int, required=True,
                    help="per-process mesh width after the rescale")
    sr.add_argument("--processes", type=int, default=None, metavar="M",
                    help="host-process count after the rescale "
                         "(default: keep the current count)")
    sr.add_argument("job_id")
    sp_ = ssub.add_parser(
        "stop", help="shut the cluster down (cancels every "
                     "non-terminal job, then the dispatcher exits)")
    sp_.add_argument("--session", metavar="HOST:PORT")
    sp_.add_argument("--ha-dir", default=None, metavar="DIR",
                     help=_HA_HELP)

    fsck = sub.add_parser(
        "fsck",
        help="offline storage integrity check: walk a log topic or a "
             "checkpoint directory verifying segment CRCs/footers, "
             "marker/manifest/lease coherence, and orphan debris "
             "(flink_tpu_torch/fsck.py)",
        epilog="exit codes: 0 = clean, 1 = findings remain, 2 = "
               "usage/path error (not a recognizable topic or "
               "checkpoint dir). --json prints one finding object per "
               "line (rule, severity, path, message, repairable, "
               "repaired).")
    fsck.add_argument("path", metavar="PATH",
                      help="topic dir (meta.json) or checkpoint dir "
                           "(chk-*/savepoint-* children; a single "
                           "checkpoint or a whole storage root also "
                           "work) — autodetected")
    fsck.add_argument("--repair", action="store_true",
                      help="apply the already-safe sweeps only "
                           "(delete .tmp debris, unreferenced "
                           "segments, orphaned in-progress checkpoint "
                           "dirs); never touches markers, leases, or "
                           "referenced files")
    fsck.add_argument("--json", action="store_true",
                      help="one JSON object per finding")

    logp = sub.add_parser(
        "log",
        help="inspect a durable log topic (committed offsets, staged "
             "transactions, segments, compaction generation, "
             "retention floor, active writer leases with epochs, "
             "per-consumer-group committed offsets + membership "
             "generations, background-cleaner lease/status) — "
             "optionally run a maintenance pass first",
        epilog="exit codes: 0 = ok, 1 = topic/maintenance error "
               "(corrupt state, compaction failure, or a live "
               "background cleaner owns the topic and --compact/"
               "--retain must not race it), 2 = usage/path error "
               "(no such topic).")
    logp.add_argument("topic", metavar="TOPIC_DIR",
                      help="topic directory (<log.dir>/<name>)")
    logp.add_argument("--compact", action="store_true",
                      help="run one key-compaction pass before "
                           "describing (log.compaction.* grammar via "
                           "--conf; key defaults to the topic's "
                           "recorded key_field)")
    logp.add_argument("--retain", action="store_true",
                      help="run one retention pass before describing "
                           "(log.retention.ms / .bytes / .ts-field "
                           "via --conf)")
    logp.add_argument("--conf", action="append", default=[],
                      metavar="KEY=VALUE",
                      help="log.compaction.* / log.retention.* "
                           "maintenance knobs")

    for name, help_ in (("list", "list jobs"), ("runners", "list runners")):
        sp = sub.add_parser(name, help=help_)
        sp.add_argument("--coordinator", required=True, metavar="HOST:PORT")

    for name, help_ in (("status", "job status"), ("cancel", "cancel job"),
                        ("savepoint", "trigger a savepoint")):
        sp = sub.add_parser(name, help=help_)
        sp.add_argument("--coordinator", required=True, metavar="HOST:PORT")
        sp.add_argument("job_id")

    rs = sub.add_parser("rescale",
                        help="savepoint + restart the job at a new "
                             "device width (and optionally a new "
                             "process count — the restore repartitions "
                             "every keyed op's key-group ranges)")
    rs.add_argument("--coordinator", required=True, metavar="HOST:PORT")
    rs.add_argument("--devices", type=int, required=True,
                    help="per-process mesh width after the rescale")
    rs.add_argument("--processes", type=int, default=None, metavar="M",
                    help="host-process count after the rescale "
                         "(default: keep the current count)")
    rs.add_argument("job_id")
    return p


def _main(argv: Optional[List[str]] = None) -> int:
    p = arg_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _PASS_ON:
        # the commands that hand their arguments on (or refuse them
        # whole) take whatever follows them, options too
        args = argparse.Namespace(cmd=argv[0], rest=argv[1:])
    else:
        args = p.parse_args(argv)

    if args.cmd in ("analyze", "lint"):
        raise _later(f"`{args.cmd}` (the plan analyzer and the repo "
                     "lints)", "11")
    if args.cmd == "session":
        return _session(args)
    if args.cmd == "coordinator":
        from flink_tpu_torch.runtime.coordinator import main as coord_main

        coord_main(args.rest)
        return 0
    if args.cmd == "runner":
        from flink_tpu_torch.runtime.runner import main as runner_main

        runner_main(args.rest)
        return 0

    if args.cmd == "fsck":
        from flink_tpu_torch.fsck import main as fsck_main

        return fsck_main(args)

    if args.cmd == "log":
        import os

        from flink_tpu_torch.fs import get_filesystem
        from flink_tpu_torch.log.topic import LogError, describe_topic

        # path errors are exit 2 (the analyze/lint contract: a typo'd
        # TOPIC_DIR — or an unregistered scheme — must not read like
        # corrupt topic state)
        try:
            missing = not get_filesystem(args.topic).exists(
                os.path.join(args.topic, "meta.json"))
        except ValueError as e:  # no filesystem for the scheme
            print(f"error: {e}", file=sys.stderr)
            return 2
        if missing:
            print(f"error: no such log topic: {args.topic!r} "
                  "(no meta.json)", file=sys.stderr)
            return 2
        try:
            out = {}
            if args.compact or args.retain:
                from flink_tpu_torch.config import Configuration
                from flink_tpu_torch.log.bus import TopicMaintenance
                from flink_tpu_torch.log.cleaner import check_manual_maintenance

                # a live background cleaner service owns maintenance
                # on this topic — a manual pass must refuse loudly
                # (exit 1) instead of fighting it for the maintenance
                # lock mid-cadence
                check_manual_maintenance(args.topic)
                config = Configuration(_parse_conf(args.conf))
                if args.compact:
                    out["compaction"] = (
                        TopicMaintenance.compact_from_config(
                            config, args.topic))
                if args.retain:
                    out["retention"] = (
                        TopicMaintenance.retain_from_config(
                            config, args.topic))
            print(json.dumps({**out,
                              **describe_topic(args.topic)}))
        except LogError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        return 0

    if args.cmd == "run":
        job_id = args.job_id or f"job-{uuid.uuid4().hex[:8]}"
        conf = _parse_conf(args.conf)
        if args.runtime_mode:
            conf["execution.runtime-mode"] = args.runtime_mode
        if args.local:
            return _run_local(args.entry, conf, job_id, args.device)
        if args.session or args.ha_dir:
            return _run_attached(args.session, args.entry, conf, job_id,
                                 ha_dir=args.ha_dir)
        if not args.coordinator:
            raise SystemExit(
                "run needs --coordinator, --session, or --local")
        c = _coord_client(args.coordinator)
        try:
            blobs = []
            for path in args.py_file:
                import base64
                import os

                with open(path, "rb") as f:
                    data = f.read()
                r = c.call("put_blob",
                           data_b64=base64.b64encode(data).decode())
                blobs.append({"name": os.path.basename(path),
                              "digest": r["digest"]})
            resp = c.call("submit_job", job_id=job_id, entry=args.entry,
                          config=conf, py_blobs=blobs)
        finally:
            c.close()
        print(json.dumps({"job_id": job_id, **resp}))
        return 0

    c = _coord_client(args.coordinator)
    try:
        if args.cmd == "list":
            resp = c.call("list_jobs")
        elif args.cmd == "runners":
            resp = c.call("list_runners")
        elif args.cmd == "status":
            resp = c.call("job_status", job_id=args.job_id)
        elif args.cmd == "cancel":
            resp = c.call("cancel_job", job_id=args.job_id)
        elif args.cmd == "savepoint":
            resp = c.call("trigger_savepoint", job_id=args.job_id)
        elif args.cmd == "rescale":
            resp = c.call("rescale_job", job_id=args.job_id,
                          devices=args.devices,
                          processes=args.processes)
        else:  # pragma: no cover
            raise SystemExit(f"unknown command {args.cmd}")
    finally:
        c.close()
    print(json.dumps(resp))
    return 0 if resp.get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
