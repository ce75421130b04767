"""The port's two-phase-commit sinks, fault plans, restart strategies
and recovery supervisor against the JAX package's, on the CPU.

Each case runs the same calls on both packages' classes and compares
what becomes visible: the 2PC protocol (stage at the barrier, commit
once the checkpoint is durable, re-commit from the checkpoint's payload
on restore, roll back the rest), the file sink's rename-on-commit, the
upsert and retract tables, the fault plan's schedule
(tests/test_chaos.py's TestFaultPlanDeterminism), the backoff strategies
(tests/test_restart_strategies.py), and a windowed job under
run_with_recovery with storage faults (TestChaosRecoveryExactlyOnce),
whose committed rows, fault spans, recovery spans and counters must be
the reference's."""
import os
import time

import numpy as np
import pytest

from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id, row_view
from test_torch_threads import capped_torch_threads  # noqa: F401

both = pytest.mark.parametrize("P", BOTH, ids=pkg_id)


# -- the 2PC protocol ------------------------------------------------------------

def mem_txn_sink(P):
    """A TwoPhaseCommitSink over an in-memory 'durable' medium."""
    class MemTxn(P.sinks.TwoPhaseCommitSink):
        def __init__(self, medium):
            self.medium = medium  # {"staged": {cid: rows}, "visible": [...]}
            self.buf = []

        def write(self, batch):
            self.buf.extend(P.sinks.rows_of(batch))

        def drop_pending(self):
            self.buf = []

        def stage_transaction(self, cid):
            if not self.buf:
                return False
            self.medium["staged"][cid] = self.buf
            self.buf = []
            return True

        def staged_transaction_ids(self):
            return sorted(self.medium["staged"])

        def commit_transaction(self, cid):
            rows = self.medium["staged"].pop(cid, None)
            if rows is not None:
                self.medium["visible"].append((cid, rows))

        def abort_transaction(self, cid):
            self.medium["staged"].pop(cid, None)

        def snapshot_transaction(self, cid):
            return list(self.medium["staged"][cid])

        def rebuild_transaction(self, cid, payload):
            if all(c != cid for c, _ in self.medium["visible"]):
                self.medium["staged"].setdefault(cid, list(payload))
    return MemTxn


def drive_2pc(P):
    medium = {"staged": {}, "visible": []}
    sink = mem_txn_sink(P)(medium)
    log = [P.sinks.sink_is_transactional(sink),
           P.sinks.sink_is_transactional(P.sinks.CollectSink())]
    for i in range(3):
        sink.write({"k": np.arange(i, i + 2)})
        sink.prepare_commit(i + 1)
    sink.notify_checkpoint_complete(1)
    log.append(sorted(medium["staged"]))
    staged = sink.snapshot_staged()
    sink.notify_checkpoint_abort(3)
    log.append(sorted(medium["staged"]))
    # a restart: the checkpoint of id 2 proved epoch 2, the medium lost it
    medium["staged"].clear()
    sink2 = mem_txn_sink(P)(medium)
    sink2.write({"k": np.arange(9, 10)})
    sink2.restore_staged(staged, 2)
    log.append(sorted(medium["staged"]))
    sink2.write({"k": np.arange(5, 6)})
    sink2.prepare_commit(4)
    sink2.abort_uncommitted()
    log.append([(c, row_view(r)) for c, r in medium["visible"]])
    return log


def test_two_phase_commit_protocol_matches_the_reference():
    got, want = drive_2pc(PORT), drive_2pc(JAX)
    assert got == want
    assert got[:2] == [True, False]
    assert [c for c, _ in got[-1]] == [1, 2]


def drive_collect(P):
    sink = P.sinks.TransactionalCollectSink()
    sink.write({"a": np.array([1, 2])})
    sink.prepare_commit(1)
    sink.write({"a": np.array([3])})
    sink.prepare_commit(2)
    staged = sink.snapshot_staged()
    sink.notify_checkpoint_complete(1)
    out = [row_view(sink.committed)]
    sink.restore_staged(staged, 2)  # re-commit 2, not 1 again
    sink.restore_staged(staged, 2)  # idempotent
    out.append(row_view(sink.committed))
    sink.write({"a": np.array([4])})
    sink.abort_uncommitted()
    out.append((sink._pending, sink._staged))
    return out


def test_transactional_collect_sink_matches_the_reference():
    got = drive_collect(PORT)
    assert got == drive_collect(JAX)
    assert got[1] == [(("a", 1),), (("a", 2),), (("a", 3),)]


def test_file_transactional_sink_matches_the_reference(tmp_path):
    """Epochs stage as files and become visible by an atomic rename; a
    new instance (a new process) restores and re-commits from the
    checkpoint's payload and drops what the checkpoint did not cover."""
    out = {}
    for P in BOTH:
        d = str(tmp_path / P.name)
        s = P.sinks.FileTransactionalSink(d)
        s.write({"k": np.array([1, 2], np.int64),
                 "v": np.array([0.5, 1.5], np.float32)})
        s.prepare_commit(1)
        s.write({"k": np.array([3], np.int64), "v": np.array([2.5], np.float32)})
        s.prepare_commit(2)
        staged = s.snapshot_staged()
        s.notify_checkpoint_complete(1)
        s.write({"k": np.array([7], np.int64), "v": np.array([0.0], np.float32)})
        s.prepare_commit(3)
        s.abort_uncommitted()  # the crashed attempt's cleanup
        s2 = P.sinks.FileTransactionalSink(d)
        s2.restore_staged(staged, 2)
        out[P.name] = (P.sinks.FileTransactionalSink.committed_rows(d),
                       sorted(os.listdir(os.path.join(d, "committed"))),
                       sorted(os.listdir(os.path.join(d, "staged"))),
                       P.sinks.sink_is_transactional(s2))
    assert out["port"] == out["jax"]
    assert [r["k"] for r in out["port"][0]] == [1, 2, 3]


def test_upsert_and_retract_sinks_match_the_reference():
    from flink_tpu_torch.records import (
        OP_DELETE, OP_FIELD, OP_INSERT, OP_UPDATE_AFTER, OP_UPDATE_BEFORE)

    ops = np.array([OP_INSERT, OP_INSERT, OP_UPDATE_BEFORE, OP_UPDATE_AFTER,
                    OP_DELETE], np.int8)
    batch = {"key": np.array([1, 2, 1, 1, 2]),
             "v": np.array([10, 20, 10, 11, 20]), OP_FIELD: ops}
    out = {}
    for P in BOTH:
        up = P.sinks.UpsertSink()
        up.write(dict(batch))
        rs = P.sinks.RetractSink()
        rs.write(dict(batch))
        rs.prepare_commit(1)
        before = rs.view()
        staged = rs.snapshot_staged()
        rs.notify_checkpoint_complete(1)
        rs2 = P.sinks.RetractSink()
        rs2.restore_staged(staged, 1)
        out[P.name] = (row_view(up.view()), row_view(before),
                       row_view(rs.view()), row_view(rs2.view()),
                       up.changelog_capable, rs.changelog_capable)
    assert out["port"] == out["jax"]
    assert out["port"][2] == [(("key", 1), ("v", 11))]


# -- fault plans -------------------------------------------------------------------

SPEC = ("checkpoint.storage.write=raise@0.3; checkpoint.upload=drop@0.5 x3; "
        "checkpoint.storage.stall=delay~1@0.2")
SEQ = (["checkpoint.storage.write"] * 30 + ["checkpoint.upload"] * 20
       + ["checkpoint.storage.stall"] * 30)


def drive_plan(P, seed):
    plan = P.faults.FaultPlan.from_spec(SPEC, seed=seed)
    with plan.activate():
        for pt in SEQ:
            try:
                P.faults.fire(pt, exc=OSError)
            except Exception:
                pass
    return plan.log


def test_fault_schedule_matches_the_reference():
    """Same seed, same schedule — and the reference's schedule."""
    for seed in (7, 8):
        assert drive_plan(PORT, seed) == drive_plan(JAX, seed)
    assert drive_plan(PORT, 7) != drive_plan(PORT, 8)


@both
def test_fault_rules_count_after_and_grammar(P):
    plan = P.faults.FaultPlan(seed=0).rule("p.x", "raise", count=2, after=3)
    hits = []
    with plan.activate():
        for i in range(10):
            try:
                P.faults.fire("p.x")
            except RuntimeError:
                hits.append(i)
    assert hits == [3, 4]
    assert plan.log == [("p.x", "raise", 3), ("p.x", "raise", 4)]
    a = P.faults.FaultPlan.from_spec("a.b=delay x3 ~5 +1").rules[0]
    b = P.faults.FaultPlan.from_spec("a.b=delay ~5 +1 x3").rules[0]
    assert (a.count, a.after, a.delay_ms) == (b.count, b.after, b.delay_ms) \
        == (3, 1, 5.0)
    with pytest.raises(ValueError, match="bad faults.inject rule"):
        P.faults.FaultPlan.from_spec("a.b=explode")
    with P.faults.FaultPlan().rule("p.io", "raise").activate():
        with pytest.raises(OSError) as ei:
            P.faults.fire("p.io", exc=OSError)
    assert P.faults.is_injected(ei.value)


@both
def test_scoped_plans_and_config_install(P):
    """A job-scoped plan serves only its scope's threads; a config plan
    installs once per (spec, seed), keeping its counters across
    attempts, and an empty spec uninstalls it."""
    conf = P.Conf({"faults.inject": "s.p=raise x1", "faults.seed": 3})
    try:
        P.faults.install_scoped("job-a", conf)
        with P.faults.job_scope("job-b"):
            P.faults.fire("s.p")  # no plan for job-b, none global
        with P.faults.job_scope("job-a"):
            with pytest.raises(RuntimeError, match="injected fault at s.p"):
                P.faults.fire("s.p")
            P.faults.fire("s.p")  # x1 spent
        P.faults.uninstall_scoped("job-a")
        plan = P.faults.install_from_config(conf)
        assert P.faults.install_from_config(conf) is plan
        assert P.faults.active_plan() is plan
        P.faults.install_from_config(P.Conf({}))
        assert P.faults.active_plan() is None
    finally:
        P.faults.clear()


def test_the_port_fires_only_known_points():
    """Every ``faults.fire`` literal in the port is in its
    KNOWN_FAULT_POINTS, and every known point is fired somewhere."""
    import ast

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "flink_tpu_torch")
    fired = set()
    for base, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(base, f)).read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and getattr(node.func, "attr", None) == "fire"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    fired.add(node.args[0].value)
    assert fired == set(PORT.faults.KNOWN_FAULT_POINTS)
    assert fired <= set(JAX.faults.KNOWN_FAULT_POINTS)


# -- restart strategies --------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 1_000_000.0

    def __call__(self):
        return self.t


def drive_strategies(P):
    r = P.restart
    out = []
    clk = FakeClock()
    s = r.FailureRateRestartStrategy(max_failures=3, interval_ms=60_000,
                                     delay_ms=100, now_fn=clk)
    for _ in range(3):
        out.append((s.can_restart(), s.next_delay_ms()))
        clk.t += 1.0
    out.append(s.can_restart())
    clk.t += 58.0
    out.append(s.can_restart())
    clk = FakeClock()
    s = r.ExponentialDelayRestartStrategy(initial_ms=1000, max_ms=8000,
                                          reset_after_ms=3_600_000, now_fn=clk)
    for _ in range(5):
        out.append(s.next_delay_ms())
        clk.t += 60.0
    clk.t += 3600.0
    out.append(s.next_delay_ms())
    f = r.FixedDelayRestartStrategy(2, 5)
    out.append([(f.can_restart(), f.next_delay_ms()) for _ in range(2)])
    out.append(f.can_restart())
    for conf in ({}, {"restart-strategy.type": "none"},
                 {"restart-strategy.type": "failure-rate"},
                 {"restart-strategy.type": "fixed-delay",
                  "restart-strategy.fixed-delay.attempts": 7,
                  "restart-strategy.fixed-delay.delay": "2 s"}):
        st = r.from_config(P.Conf(conf))
        out.append((type(st).__name__, getattr(st, "max_attempts", None),
                    getattr(st, "delay_ms", None)))
    return out


def test_restart_strategies_match_the_reference():
    got = drive_strategies(PORT)
    assert got == drive_strategies(JAX)
    assert got[5:10] == [1000, 2000, 4000, 8000, 8000] and got[10] == 1000
    assert got[-1] == ("FixedDelayRestartStrategy", 7, 2000)


# -- run_with_recovery under storage faults (tests/test_chaos.py) ----------------------

N_BATCHES = 16


def det_gen(split, i):
    if i >= N_BATCHES:
        return None
    rng = np.random.default_rng(1000 * int(split) + i)
    keys = rng.integers(0, 10, 64).astype(np.int64)
    ts = np.sort(rng.integers(i * 500, i * 500 + 1000, 64)).astype(np.int64)
    return {"k": keys}, ts


def chaos_plan(P, tolerable):
    if tolerable:
        return P.faults.FaultPlan(seed=1234).rule(
            "checkpoint.storage.write", "raise", count=2, after=1)
    # exactly these five injections, three fatal: the upload kills
    # attempt 1 before any checkpoint, the write kills attempt 2 after
    # its first checkpoint, the torn rename kills attempt 3
    return (P.faults.FaultPlan(seed=1234)
            .rule("checkpoint.upload", "raise", count=1)
            .rule("checkpoint.storage.write", "raise", count=1, after=1)
            .rule("checkpoint.storage.rename", "raise", count=1, after=1)
            .rule("checkpoint.storage.stall", "delay", count=2, delay_ms=20))


def run_chaos(P, root, tolerable):
    sink = P.sinks.TransactionalCollectSink()

    def build(conf):
        env = P.Env(conf)

        def paced(split, i):
            # the source (on the loop thread: no prefetch) waits for the
            # checkpoint in flight, so every batch boundary takes one
            # whatever the host's load, and each injection lands on the
            # same checkpoint in every run: never on the final one
            p = getattr(getattr(env, "_driver", None), "_ckpt_pending", None)
            while p is not None and not p.done():
                time.sleep(0.001)
            return det_gen(split, i)

        (env.from_source(P.GeneratorSource(paced),
                         P.WM.for_bounded_out_of_orderness(1000))
         .key_by("k").window(P.Tumbling.of(1000)).count().add_sink(sink))
        return env

    conf = P.Conf({
        "state.num-key-shards": 8, "state.slots-per-shard": 64,
        "pipeline.microbatch-size": 128,
        "pipeline.source-prefetch": 0,
        "execution.checkpointing.dir": root,
        "execution.checkpointing.interval": 1,
        "execution.checkpointing.tolerable-failures": 5 if tolerable else 0,
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 20,
        "restart-strategy.fixed-delay.delay": 1})
    plan = chaos_plan(P, tolerable)
    tracer = P.tracing.tracer
    tracer.clear()
    before = P.faults.snapshot()
    with plan.activate():
        P.recover(build, conf, "chaos-job")
    after = P.faults.snapshot()
    return {
        "rows": sorted((int(r["key"]), int(r["window_start"]), int(r["count"]))
                       for r in sink.committed),
        "log": sorted(x[:2] for x in plan.log),
        "recoveries": [s["attributes"]["injected"]
                       for s in tracer.spans("recovery")],
        "faults": sorted((s["attributes"]["point"], s["attributes"]["kind"])
                         for s in tracer.spans("fault")),
        "failed": len(tracer.spans("checkpoint.failed")),
        "delta": {k: after.get(k, 0) - before.get(k, 0)
                  for k in set(after) | set(before)
                  if after.get(k, 0) != before.get(k, 0)},
    }


@pytest.mark.parametrize("tolerable", [False, True],
                         ids=["restarts", "tolerated"])
def test_recovery_under_storage_faults_matches_the_reference(tolerable,
                                                             tmp_path):
    """restarts: three fatal injections, three supervised restarts, the
    fault-free rows committed exactly once. tolerated: with
    tolerable-failures the two persist failures restart nothing and show
    as checkpoint.failed spans. Every figure equals the reference's."""
    got = run_chaos(PORT, str(tmp_path / "port"), tolerable)
    want = run_chaos(JAX, str(tmp_path / "jax"), tolerable)
    golden = {}
    for i in range(N_BATCHES):
        data, ts = det_gen("0", i)
        for k, t in zip(data["k"], ts):
            kk = (int(k), int(t) // 1000 * 1000)
            golden[kk] = golden.get(kk, 0) + 1
    assert got["rows"] == sorted((k, w, c) for (k, w), c in golden.items())
    assert got == want
    if tolerable:
        assert got["recoveries"] == [] and got["failed"] == 2
    else:
        assert got["recoveries"] == [True] * 3
        assert got["delta"]["recovery.attempts"] == 3


def test_torn_rename_leaves_no_visible_checkpoint(tmp_path):
    for P in BOTH:
        st = P.storage.FsCheckpointStorage(str(tmp_path / P.name), "torn")
        st.save(1, {"a": 1, "checkpoint_id": 1})
        with P.faults.FaultPlan().rule("checkpoint.storage.rename", "raise",
                                       count=1).activate():
            with pytest.raises(OSError, match="injected fault"):
                st.save(2, {"a": 2, "checkpoint_id": 2})
        assert [h.checkpoint_id for h in st.list_complete()] == [1]
        st.save(3, {"a": 3, "checkpoint_id": 3})
        assert not [n for n in os.listdir(str(tmp_path / P.name / "torn"))
                    if ".inprogress" in n]


def test_write_atomic_retries_a_full_disk(tmp_path):
    """fs.write_atomic under an injected ENOSPC retries the whole file
    (the reference's default policy) and counts each retry."""
    from flink_tpu_torch import fs

    path = str(tmp_path / "f.json")
    before = fs.registry.snapshot().get("storage.enospc_retries", 0)
    with PORT.faults.FaultPlan().rule("fs.write.enospc", "raise",
                                      count=2).activate():
        fs.write_atomic(fs.get_filesystem(path), path, b"{}")
    assert open(path, "rb").read() == b"{}"
    assert fs.registry.snapshot()["storage.enospc_retries"] - before == 2
    with PORT.faults.FaultPlan().rule("fs.write.enospc", "raise").activate():
        with pytest.raises(OSError, match="fs.write.enospc"):
            fs.write_atomic(fs.get_filesystem(path), path, b"[]")
    assert open(path, "rb").read() == b"{}"
