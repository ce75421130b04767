"""Command-line frontend — the CliFrontend analogue (the JAX package's
``cli.py``, with the same commands, flags, JSON replies and exit codes:
0 = ok or clean, 1 = findings or refused, 2 = usage or path error)::

    python -m flink_tpu_torch run --coordinator H:P --entry pkg.mod:build \
        [--job-id id] [--conf key=value ...] [--py-file PATH ...]
    python -m flink_tpu_torch run --local --entry pkg.mod:build \
        [--device cuda|cpu] [...]
    python -m flink_tpu_torch coordinator [--port P]
    python -m flink_tpu_torch runner --coordinator H:P [--device cuda|cpu]
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
``runtime/runner.py``). Not here yet, and refused with exit 2 naming
their ROADMAP.md item: ``session`` and ``run --session`` / ``--ha-dir``
(queue 1 item 10.2), ``analyze`` and ``lint`` (queue 1 item 11).

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


_PASS_ON = ("analyze", "lint", "session", "coordinator", "runner")


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


def main(argv: Optional[List[str]] = None) -> int:
    try:
        return _main(argv)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _main(argv: Optional[List[str]] = None) -> int:
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
                      help="attach to a session cluster (still to port)")
    runp.add_argument("--ha-dir", default=None, metavar="DIR",
                      help="resolve the session leader through an HA "
                           "lease (still to port)")
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
                        ("session", "session-cluster mode (still to port)"),
                        ("coordinator", "serve a job coordinator "
                                        "(runtime/coordinator.py)"),
                        ("runner", "serve a task runner (runtime/runner.py)")):
        sub.add_parser(name, help=help_, add_help=False)

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
    if args.cmd == "session" or (args.cmd == "run" and (args.session
                                                        or args.ha_dir)):
        raise _later("the session cluster and --session / --ha-dir",
                     "10.2")
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
        if not args.coordinator:
            raise SystemExit("run needs --coordinator or --local")
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
