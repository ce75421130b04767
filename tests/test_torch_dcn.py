"""Jobs across processes in the port against the JAX package's, on the
CPU: the cross-process exchange endpoint (``exchange/dcn.py``), the
driver's step loop, the hybrid plan and ``intra_slice_exchange``.

- The reference's endpoint cases (``tests/test_dcn.py`` ``TestExchange``,
  ``TestAttemptFencing``, ``TestExchangeSecurity``) run against the
  port's ``DcnExchange``, its frames and its blob decode; and one mixed
  fleet: a port endpoint and a reference endpoint with one secret run a
  three-step rendezvous.
- Jobs across two processes, as threads of this process (``device=
  "cpu"``, peers on loopback): the union of both processes' rows equals
  the port's single-process run, the reference's single-process run and
  the reference's two-process run, process by process; K = 4 gives each
  process the K = 1 rows; overlap on and off give the same rows; overlap
  without the barrier drain completes; a top-n ranks within each
  process's span, as the reference's does; two blocks a process on a
  hybrid plan give the single-process rows.
- ``intra_slice_exchange`` over one process's two CPU blocks against the
  reference's under ``shard_map`` on a 2 x 2 hybrid CPU mesh.
- The misrouted-key rule of an operator that owns a span of the shards.
- One subprocess pair that crashes after a checkpoint and resumes with
  the negotiated restore into ``FileTransactionalSink``s.

Each thread or process is joined with a timeout and a hang fails the
test. Rows are integers: everything compares exactly."""
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import test_dcn as ref_dcn
from flink_tpu_torch.checkpoint import blobformat as port_blobformat
from flink_tpu_torch.exchange import frames as port_frames
from flink_tpu_torch.exchange import keyby
from flink_tpu_torch.exchange.dcn import DcnExchange
from flink_tpu_torch.parallel.mesh import make_hybrid_mesh_plan
from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id
from test_torch_threads import capped_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the endpoint: the reference's cases on the port's DcnExchange -------------

@pytest.fixture
def port_endpoint(monkeypatch):
    """The reference cases' module names bound to the port's exchange,
    frames and blob format for one test."""
    monkeypatch.setattr(ref_dcn, "DcnExchange", DcnExchange)
    monkeypatch.setattr(ref_dcn, "frames", port_frames)
    monkeypatch.setattr(ref_dcn, "blobformat", port_blobformat)


@pytest.mark.usefixtures("port_endpoint")
class TestPortExchange(ref_dcn.TestExchange):
    pass


@pytest.mark.usefixtures("port_endpoint")
class TestPortAttemptFencing(ref_dcn.TestAttemptFencing):
    pass


@pytest.mark.usefixtures("port_endpoint")
class TestPortExchangeSecurity(ref_dcn.TestExchangeSecurity):
    pass


def test_the_reference_cases_run_on_the_port(port_endpoint):
    assert ref_dcn.DcnExchange is DcnExchange
    assert ref_dcn.frames is port_frames


def run_threads(fns, timeout=60.0):
    """Run each fn on a thread; the results, or raise the first error.
    A thread still alive after ``timeout`` fails the test."""
    out, errs = [None] * len(fns), [None] * len(fns)

    def wrap(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 — raised below
            errs[i] = e

    ths = [threading.Thread(target=wrap, args=(i,)) for i in range(len(fns))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout)
    assert not any(t.is_alive() for t in ths), "a thread hung"
    for e in errs:
        if e is not None:
            raise e
    return out


def test_mixed_fleet_rendezvous():
    """A port endpoint (process 0) and a reference endpoint (process 1),
    keyed with one secret, complete three rendezvous steps: each gets the
    other's share and meta at every step."""
    from flink_tpu.exchange.dcn import DcnExchange as JaxDcnExchange

    exs = [DcnExchange(0, 2, attempt=1, secret="fleet-secret"),
           JaxDcnExchange(1, 2, attempt=1, secret="fleet-secret")]
    peers = [f"127.0.0.1:{e.port}" for e in exs]

    def run(i):
        exs[i].connect(peers, timeout_s=10)
        got = []
        for step in range(3):
            shares = {j: {"data": {"v": np.arange(4, dtype=np.int64)
                                   + 100 * i + 10 * j + step,
                                   "w": np.array(["a", "bé"], dtype=object)},
                          "ts": np.full(4, step, np.int64)}
                      for j in range(2)}
            payloads, metas = exs[i].exchange(
                shares, {"wm": 1000 * step + i, "done": step == 2,
                         "ckpt": False, "persisted": step - 1})
            got.append((payloads, metas))
        return got

    try:
        results = run_threads([lambda: run(0), lambda: run(1)], timeout=30)
    finally:
        for e in exs:
            e.close()
    for i, got in enumerate(results):
        other = 1 - i
        for step, (payloads, metas) in enumerate(got):
            np.testing.assert_array_equal(
                payloads[other]["data"]["v"],
                np.arange(4) + 100 * other + 10 * i + step)
            assert list(payloads[other]["data"]["w"]) == ["a", "bé"]
            assert metas[other] == {"wm": 1000 * step + other,
                                    "done": step == 2, "ckpt": False,
                                    "persisted": step - 1}
    assert not exs[0].hello_rejects and not exs[1].hello_rejects
    assert exs[0].bytes_sent > 0


# -- jobs across processes, as threads ----------------------------------------------

N_BATCHES, B = 8, 64


def gen(split, i):
    if i >= N_BATCHES:
        return None
    rng = np.random.default_rng(500 * int(split) + i)
    return ({"k": rng.integers(0, 32, B).astype(np.int64)},
            i * 1000 + rng.integers(0, 1000, B).astype(np.int64))


BASE = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
        "pipeline.microbatch-size": B}


def free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def count_job(P, conf, top=None, mesh_plan=None):
    """The keyed 1 s tumbling count (or its top-n) of ``gen``: (its rows
    as sorted tuples, its JobResult)."""
    rows = []

    def sink(b):
        if b:
            cols = sorted(b)
            rows.extend(zip(*[np.asarray(b[c]).tolist() for c in cols]))

    env = P.Env(P.Conf(conf))
    w = (env.from_source(P.GeneratorSource(gen, n_splits=2),
                         P.WM.for_bounded_out_of_orderness(1000))
         .key_by("k").window(P.Tumbling.of(1000)).count())
    if top is not None:
        w = w.top(top)
    w.add_sink(P.sinks.FnSink(sink))
    kw = dict(P.kw)
    if mesh_plan is not None:
        kw["mesh_plan"] = mesh_plan
    res = env.execute("dcn-job", **kw)
    return sorted(rows), res


def two_process(P, extra=None, top=None, mesh_plans=None):
    """Each process's rows and JobResult of a two-process run."""
    ports = free_ports(2)
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)

    def run(pid):
        conf = dict(BASE, **{"cluster.num-processes": 2,
                             "cluster.process-id": pid,
                             "cluster.dcn-peers": peers,
                             "cluster.dcn-port": ports[pid]}, **(extra or {}))
        return count_job(P, conf, top,
                         None if mesh_plans is None else mesh_plans[pid])

    return run_threads([lambda: run(0), lambda: run(1)], timeout=120)


_RUNS = {}


def cached(key, fn):
    if key not in _RUNS:
        _RUNS[key] = fn()
    return _RUNS[key]


def single(P, top=None):
    return cached((P.name, "single", top), lambda: count_job(P, BASE, top)[0])


def test_two_processes_match_every_reference_run():
    """The union of the port's two processes equals the port's and the
    reference's single-process runs, and each process's rows equal the
    reference's same process's: every key fires on the process that
    owns its shard."""
    port = cached(("port", "two"), lambda: two_process(PORT))
    ref = cached(("jax", "two"), lambda: two_process(JAX))
    union = sorted(port[0][0] + port[1][0])
    assert union == single(PORT) == single(JAX) and union
    assert [r[0] for r in port] == [r[0] for r in ref]
    assert port[0][0] and port[1][0]
    m = port[0][1].metrics
    assert m["dcn.records_routed"] == N_BATCHES * B  # its one split
    assert 0 < m["dcn.records_sent"] < N_BATCHES * B
    assert m["dcn.bytes_sent"] > 0 and m["dcn.wait_ms.count"] > 0


def test_sub_batches_give_each_process_the_k1_rows():
    k1 = cached(("port", "two"), lambda: two_process(PORT))
    k4 = two_process(PORT, {"pipeline.sub-batches": 4})
    assert [r[0] for r in k4] == [r[0] for r in k1]
    assert k4[0][1].metrics["batches"] > k1[0][1].metrics["batches"] - 1


def test_overlap_off_matches_overlap_on():
    on = cached(("port", "two"), lambda: two_process(PORT))
    off = two_process(PORT, {"cluster.dcn-overlap": False})
    assert [r[0] for r in off] == [r[0] for r in on]


def test_overlap_without_the_drain_completes(tmp_path):
    """Overlap on, barrier drain off, checkpoints every 25 ms: no fault,
    so nothing is in flight at end of input and the rows are the
    golden's; the undrained step's stale checkpoint flag is absorbed."""
    got = two_process(PORT, {
        "cluster.dcn-overlap-drain": False,
        "execution.checkpointing.interval": 25,
        "execution.checkpointing.dir": str(tmp_path / "ckpt")})
    assert sorted(got[0][0] + got[1][0]) == single(PORT)
    assert os.path.isdir(tmp_path / "ckpt" / "dcn-job-p0")
    assert os.path.isdir(tmp_path / "ckpt" / "dcn-job-p1")


def test_top_n_ranks_within_each_process_span_as_the_reference():
    """The JAX package runs ``.top(1)`` across processes without refusal
    and ranks within each process's span of the shards, so the union
    carries a row per window per process, unlike the single-process run.
    The port does the same, process by process."""
    port = two_process(PORT, top=1)
    ref = two_process(JAX, top=1)
    assert [r[0] for r in port] == [r[0] for r in ref]
    union = sorted(port[0][0] + port[1][0])
    assert union != single(PORT, top=1)
    assert single(PORT, top=1) == single(JAX, top=1)
    assert set(single(PORT, top=1)) <= set(union)


def test_hybrid_plan_two_blocks_a_process():
    """Each process runs its keyed window over two CPU blocks of its
    ``HybridMeshPlan``; the exchange among them is
    ``intra_slice_exchange``; the union is the single-process run."""
    plans = [make_hybrid_mesh_plan(8, 64, 2, pid, ["cpu", "cpu"])
             for pid in range(2)]
    got = two_process(PORT, mesh_plans=plans)
    assert sorted(got[0][0] + got[1][0]) == single(PORT)
    for pid, (_, res) in enumerate(got):
        assert res.metrics["mesh_devices"] == ["cpu", "cpu"]
        assert res.metrics["exchange_overflow"] == 0
        assert res.metrics["exchange_bytes"] > 0


def test_v1_checks_refuse_what_the_loop_cannot_carry():
    from flink_tpu_torch.api.sinks import CollectSink

    def env_with(extra, build):
        env = PORT.Env(PORT.Conf({
            **BASE, "cluster.num-processes": 2, "cluster.process-id": 0,
            "cluster.dcn-peers": "127.0.0.1:1,127.0.0.1:2", **extra}))
        build(env)
        return env

    def src(env):
        return env.from_source(PORT.GeneratorSource(gen),
                               PORT.WM.for_monotonous_timestamps())

    def one(env, lateness=0):
        (src(env).key_by("k").window(PORT.Tumbling.of(1000))
         .allowed_lateness(lateness).count().add_sink(CollectSink()))

    cases = [
        ({}, lambda e: (one(e), one(e)), NotImplementedError,
         "exactly one source"),
        ({}, lambda e: one(e, 500), NotImplementedError, "allowed lateness"),
        ({"state.num-key-shards": 7}, one, ValueError, "must divide by"),
        ({"cluster.dcn-peers": "127.0.0.1:1"}, one, ValueError,
         "must list 2 host:port entries"),
    ]
    for extra, build, err, match in cases:
        with pytest.raises(err, match=match):
            env_with(extra, build).execute("refused", device="cpu")


# -- intra_slice_exchange against the reference -------------------------------------

SHARDS, SLOTS, RING = 16, 4, 8
N_LOCAL, L, CAP = 2, 40, 16


@pytest.mark.shard_map
def test_intra_slice_exchange_matches_the_reference_under_shard_map():
    """Records of 2 processes x 2 blocks. The reference buckets each
    device's records by the owner block (``dest_local``) and runs its
    all-to-all over the inner axis of a (DCN, ICI) mesh; the port runs
    ``intra_slice_exchange`` over each process's two CPU blocks on cells
    whose owner block is that ``dest_local``. Each block's received
    cells (rebased to the block), row ids and valid mask equal the
    reference's in order, the overflow counts are equal, and no record
    crosses between the processes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from flink_tpu.exchange.keyby import intra_slice_exchange as jax_intra
    from flink_tpu.parallel.mesh import AXIS, DCN_AXIS
    from flink_tpu.utils.jaxcompat import hybrid_device_mesh, shard_map

    rng = np.random.default_rng(21)
    n = 4 * L
    spd = SHARDS // 2 // N_LOCAL * SLOTS
    dest = rng.integers(0, N_LOCAL, n).astype(np.int32)
    valid = rng.random(n) >= 0.1
    cells = ((dest * spd + rng.integers(0, spd, n)) * RING
             + rng.integers(0, RING, n))
    cells = np.where(valid, cells, -1).astype(np.int32)
    rows = np.arange(n, dtype=np.int32)

    mesh = Mesh(hybrid_device_mesh((1, N_LOCAL), (2, 1), jax.devices()[:4]),
                (DCN_AXIS, AXIS))
    spec = P((DCN_AXIS, AXIS))

    def step(d, v, payload):
        recv, rv, ov = jax_intra(d, v, payload, n_local=N_LOCAL,
                                 capacity=CAP)
        return recv["row"], recv["cell"], rv, ov

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(
        spec, spec, {"row": spec, "cell": spec}),
        out_specs=(spec, spec, spec, spec)))
    j_row, j_cell, j_valid, j_over = (np.asarray(x) for x in fn(
        jnp.asarray(dest), jnp.asarray(valid),
        {"row": jnp.asarray(rows), "cell": jnp.asarray(cells)}))
    per_dev = N_LOCAL * CAP
    assert int(j_over.sum()) > 0  # the capacity binds somewhere
    for p in range(2):
        plan = make_hybrid_mesh_plan(SHARDS, SLOTS, 2, p, ["cpu"] * N_LOCAL)
        assert plan.slots_per_device == spd
        src = [p * N_LOCAL + j for j in range(N_LOCAL)]
        recv, overflow, moved = keyby.intra_slice_exchange(
            [torch.from_numpy(cells[b * L:(b + 1) * L]) for b in src],
            [torch.from_numpy(rows[b * L:(b + 1) * L]).reshape(-1, 1)
             for b in src], devices=plan.devices, capacity=CAP, spd=spd,
            ring=RING)
        assert moved > 0
        for j, b in enumerate(src):
            np.testing.assert_array_equal(
                overflow[j].numpy(), j_over[b * N_LOCAL:(b + 1) * N_LOCAL])
        for d in range(N_LOCAL):
            blk = slice((p * N_LOCAL + d) * per_dev,
                        (p * N_LOCAL + d + 1) * per_dev)
            r_cells, r_rows, r_valid = (t.numpy() for t in recv[d])
            ok = j_valid[blk]
            np.testing.assert_array_equal(r_valid, ok)
            np.testing.assert_array_equal(r_rows[:, 0][ok], j_row[blk][ok])
            np.testing.assert_array_equal(r_cells[ok],
                                          j_cell[blk][ok] - d * spd * RING)
            assert (r_cells[~ok] == -1).all()
            # no record crossed between the processes
            lo, hi = p * N_LOCAL * L, (p + 1) * N_LOCAL * L
            assert ((r_rows[:, 0][ok] >= lo) & (r_rows[:, 0][ok] < hi)).all()
            assert ((j_row[blk][ok] >= lo) & (j_row[blk][ok] < hi)).all()


def test_intra_slice_exchange_is_the_hybrid_all_to_all():
    """A window operator on a hybrid plan exchanges through
    ``intra_slice_exchange`` (on the split upload's bytes); on a plain
    mesh through the all-to-all, and an explicit ``ring`` stays."""
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
    from flink_tpu_torch.exchange import spi
    from flink_tpu_torch.ops.aggregates import count
    from flink_tpu_torch.ops.window import WindowOperator
    from flink_tpu_torch.parallel.mesh import make_mesh_plan

    plan = make_hybrid_mesh_plan(SHARDS, SLOTS, 2, 1, ["cpu"] * N_LOCAL)
    flat = make_mesh_plan(SHARDS, SLOTS, ["cpu"] * N_LOCAL)

    def shuffle(mesh_plan, impl="all-to-all"):
        lo = plan.shard_lo if mesh_plan is plan else None
        return WindowOperator(
            TumblingEventTimeWindows.of(1000), count(), num_shards=SHARDS,
            slots_per_shard=SLOTS, device="cpu",
            mesh_plan=mesh_plan, exchange_impl=impl,
            shard_range=None if lo is None else (lo, lo + plan.num_shards)
        )._shuffle

    fn = shuffle(plan)
    assert fn is keyby.intra_slice_exchange and spi.takes_split_bytes(fn)
    assert shuffle(flat) is spi.all_to_all_shuffle
    assert shuffle(plan, "ring") is spi.ring_shuffle


# -- the span of one process ---------------------------------------------------------

@pytest.mark.parametrize("P", BOTH, ids=pkg_id)
def test_a_key_outside_the_span_fails_or_is_dropped(P):
    """An operator owning shards [0, 4) of 8: a key of another shard is a
    routing error. It fails the job by default, even with the spill
    store (which never takes it); with ``allow_drops`` it is dropped and
    counted, and the rows of the span's keys are the other package's."""
    from flink_tpu.records import hash_keys_numpy

    keys = np.arange(64, dtype=np.int64)
    inside = (hash_keys_numpy(keys) % 8) < 4
    ts = np.arange(64, dtype=np.int64) * 10

    def op(**kw):
        o = P.WindowOperator(P.Tumbling.of(1000), P.agg.count(),
                             num_shards=8, slots_per_shard=16,
                             shard_range=(0, 4), **P.kw, **kw)
        return o

    for kw in ({}, {"spill": True}):
        with pytest.raises(RuntimeError, match="shard range"):
            op(**kw).process_batch(keys, ts, {})
    o = op()
    o.allow_drops = True
    o.process_batch(keys, ts, {})
    assert o.records_dropped_full == int((~inside).sum())
    fired = dict(o.advance_watermark(10_000))
    got = sorted(zip(np.asarray(fired["key"]).tolist(),
                     np.asarray(fired["count"]).tolist()))
    assert got == [(int(k), 1) for k in keys[inside]]
    assert o.directory.local_slots == 4 * 16


# -- crash and resume: one subprocess pair --------------------------------------------

WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import FileTransactionalSink
from flink_tpu_torch.api.sources import GeneratorSource
from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.time.watermarks import WatermarkStrategy

pid, n, peers, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            int(sys.argv[4]), sys.argv[5])
crash_at = int(sys.argv[6])
restore = len(sys.argv) > 7 and sys.argv[7] == "restore"

def gen(split, i):
    if i >= 24:
        return None
    # the crash: the source dies at batch crash_at or later, once a
    # checkpoint of this process is complete
    if crash_at >= 0 and i >= crash_at and FsCheckpointStorage(
            out + "/ckpt", "dcnq5-p%d" % pid).latest() is not None:
        os._exit(43)
    rng = np.random.default_rng(1000 * int(split) + i)
    keys = rng.integers(0, 64, 512).astype(np.int64)
    ts = i * 1000 + rng.integers(0, 1000, 512).astype(np.int64)
    return {{"auction": keys}}, ts

conf = {{
    "state.num-key-shards": 8, "state.slots-per-shard": 32,
    "pipeline.microbatch-size": 512,
    "cluster.num-processes": n, "cluster.process-id": pid,
    "cluster.dcn-peers": peers, "cluster.dcn-port": port,
    "execution.checkpointing.interval": 1,
    "execution.checkpointing.dir": out + "/ckpt",
}}
if restore:
    conf["execution.checkpointing.restore"] = "latest"
env = StreamExecutionEnvironment(Configuration(conf))
(env.from_source(GeneratorSource(gen, n_splits=2),
                 WatermarkStrategy.for_bounded_out_of_orderness(1000))
 .key_by("auction").window(SlidingEventTimeWindows.of(4000, 2000)).count()
 .add_sink(FileTransactionalSink(out + "/sink-p%d" % pid)))
env.execute("dcnq5", device="cpu")
print("WORKER_DONE", flush=True)
"""


def crash_golden():
    """The single-process port run of the workers' job."""
    from flink_tpu_torch.api.sinks import CollectSink

    def wgen(split, i):
        if i >= 24:
            return None
        rng = np.random.default_rng(1000 * int(split) + i)
        return ({"auction": rng.integers(0, 64, 512).astype(np.int64)},
                i * 1000 + rng.integers(0, 1000, 512).astype(np.int64))

    sink = CollectSink()
    env = PORT.Env(PORT.Conf({"state.num-key-shards": 8,
                              "state.slots-per-shard": 32,
                              "pipeline.microbatch-size": 512}))
    (env.from_source(PORT.GeneratorSource(wgen, n_splits=2),
                     PORT.WM.for_bounded_out_of_orderness(1000))
     .key_by("auction").window(PORT.Sliding.of(4000, 2000)).count()
     .add_sink(sink))
    env.execute("golden", device="cpu")
    return sorted((int(r["key"]), int(r["window_end"]), int(r["count"]))
                  for r in sink.rows)


def spawn(tmp, pid, peers, port, crash_at=-1, restore=False):
    script = tmp / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    args = [sys.executable, str(script), str(pid), "2", peers, str(port),
            str(tmp), str(crash_at)] + (["restore"] if restore else [])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env)


def test_crash_after_a_checkpoint_resumes_with_the_negotiated_restore(
        tmp_path):
    """Process 1 exits (``os._exit``) once a checkpoint of its own is
    complete; process 0 fails on the broken exchange. Both restart with
    ``restore: latest``, agree on one checkpoint id, and the union of
    their ``FileTransactionalSink``s' committed rows is the golden, no
    row twice."""
    from flink_tpu_torch.api.sinks import FileTransactionalSink

    golden = crash_golden()
    ports = free_ports(2)
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    ps = [spawn(tmp_path, 0, peers, ports[0]),
          spawn(tmp_path, 1, peers, ports[1], crash_at=10)]
    outs = [p.communicate(timeout=240)[0].decode() for p in ps]
    assert ps[1].returncode == 43, outs[1][-3000:]
    assert ps[0].returncode != 0, outs[0][-3000:]
    # both hold a completed checkpoint, so the restore resumes one (a
    # replay from the start would repeat any epoch committed already)
    for pid in range(2):
        assert PORT.storage.FsCheckpointStorage(
            str(tmp_path / "ckpt"), f"dcnq5-p{pid}").latest() is not None
    ports = free_ports(2)
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    ps = [spawn(tmp_path, i, peers, ports[i], restore=True) for i in range(2)]
    outs = [p.communicate(timeout=240)[0].decode() for p in ps]
    for i, p in enumerate(ps):
        assert p.returncode == 0, f"p{i} failed:\n{outs[i][-3000:]}"
    rows = sorted(
        (r["key"], r["window_end"], r["count"]) for pid in range(2)
        for r in FileTransactionalSink.committed_rows(
            str(tmp_path / f"sink-p{pid}")))
    assert rows == golden and len(rows) > 100
