"""Key-group repartition (``checkpoint/repartition.py``) and rescale from
a checkpoint set (``cluster.rescale-from``) in the port, against the JAX
package: ``tests/test_repartition.py``'s cases by its scheme of
equivalence by routing, in both packages.

- Per operator kind (the device window, the window with an LSM store,
  the process function's state and its timers, the count window, the
  running aggregate, session windows, CEP in its one-partial and its
  NO_SKIP engines), 2 -> 1 and 1 -> 2: a reference operator fed every
  record emits what a fleet of per-process operators fed hash-routed
  shares emits, before the cut and, through ``merge_payloads``, after it
  (the union of the new processes' rows is the reference's, none twice).
- The port's ``merge_payloads`` over the port's payloads gives the
  reference's tree over the reference's payloads, field by field.
- Each package restores the other's merged payload (through the
  checkpoint blob format) and emits the same rows.
- Every refusal of the reference, with its ``RescaleError``.
- The driver: a two-process job on loopback stops after a checkpoint
  through a fault; one process restores the set through
  ``cluster.rescale-from``; and the reverse, 1 -> 2. The committed rows
  of both halves are the unrescaled run's, each (key, window) once. So
  are they under ``restore: latest`` with the set named (the rescale
  floor), with no checkpoint of the new fleet's or only an older one.

Rows are integers, and f32 sums of the same records in the same order on
both sides of a cut: everything compares exactly (floats rounded to 6
places, the reference test's normal form)."""
import os
import time

import numpy as np
import pytest

from test_torch_checkpoint import tree_equal
from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id
from test_torch_dcn import free_ports, run_threads
from test_torch_threads import capped_torch_threads  # noqa: F401

NS, SPS = 8, 16           # num_shards, slots_per_shard
R = NS * SPS


def _ns(P):
    """Package ``P``'s repartition surface and operators."""
    import types

    if P is PORT:
        from flink_tpu_torch import cep
        from flink_tpu_torch.api.functions import KeyedProcessFunction
        from flink_tpu_torch.checkpoint import repartition
        from flink_tpu_torch.exchange.partitioners import hash_shards
        from flink_tpu_torch.ops.count_window import CountWindowOperator
        from flink_tpu_torch.ops.global_agg import GlobalAggregateOperator
        from flink_tpu_torch.ops.process import KeyedProcessOperator
        from flink_tpu_torch.ops.session import SessionOperator
        from flink_tpu_torch.state.api import ValueStateDescriptor
        from flink_tpu_torch.state.lsm import LsmSpillStore
    else:
        from flink_tpu import cep
        from flink_tpu.api.functions import KeyedProcessFunction
        from flink_tpu.checkpoint import repartition
        from flink_tpu.exchange.partitioners import hash_shards
        from flink_tpu.ops.count_window import CountWindowOperator
        from flink_tpu.ops.global_agg import GlobalAggregateOperator
        from flink_tpu.ops.process import KeyedProcessOperator
        from flink_tpu.ops.session import SessionOperator
        from flink_tpu.state.api import ValueStateDescriptor
        from flink_tpu.state.lsm import LsmSpillStore
    V = ValueStateDescriptor

    class RunningSum(KeyedProcessFunction):
        def process_batch(self, ctx):
            vs = ctx.value_state(V("sum", 0.0))
            order = np.argsort(ctx.slots, kind="stable")
            sl, v = ctx.slots[order], ctx.data["v"][order]
            uniq, starts = np.unique(sl, return_index=True)
            totals = np.add.reduceat(v.astype(np.float64), starts)
            vs[uniq] = vs[uniq] + totals
            ctx.emit({"key": ctx.keys[order][starts], "total": vs[uniq]},
                     ts=ctx.timestamps[order][starts])

    class IdleTimeout(KeyedProcessFunction):
        def process_batch(self, ctx):
            last = ctx.value_state(V("last_ts", -1.0))
            order = np.argsort(ctx.slots, kind="stable")
            sl, ts = ctx.slots[order], ctx.timestamps[order]
            uniq, starts = np.unique(sl, return_index=True)
            mx = np.maximum.reduceat(ts, starts)
            newer = mx > last[uniq]
            last[uniq[newer]] = mx[newer].astype(np.float64)
            ctx.register_event_time_timers(mx[newer] + 1000,
                                           slots=uniq[newer])

        def on_timer(self, ctx):
            last = ctx.value_state(V("last_ts", -1.0))
            live = last[ctx.slots] + 1000 == ctx.timestamps
            ctx.emit({"key": ctx.keys[live],
                      "idle_since": last[ctx.slots[live]].astype(np.int64)},
                     ts=ctx.timestamps[live])

    return types.SimpleNamespace(
        P=P, rp=repartition, hash_shards=hash_shards, cep=cep,
        CountWindow=CountWindowOperator, GlobalAgg=GlobalAggregateOperator,
        Process=KeyedProcessOperator, Session=SessionOperator,
        Lsm=LsmSpillStore, RunningSum=RunningSum, IdleTimeout=IdleTimeout)


NSP = {P.name: _ns(P) for P in BOTH}


# -- the operator kinds ------------------------------------------------------------------

def _batch(seed, t0, n=64, n_keys=24):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n).astype(np.int64)
    ts = rng.integers(t0, t0 + 1000, n).astype(np.int64)
    return ("batch", keys, ts, {"v": rng.random(n)})


def cep_pattern(Pt, mode=None):
    p = (Pt.begin("lo").where(lambda d: d["v"] < 0.3)
         .followed_by("hi").where(lambda d: d["v"] > 0.7))
    return p.after_match(mode) if mode else p


def _mk_window(lsm=False):
    def mk(n, span, tmp):
        P = n.P
        kw = dict(P.kw, num_shards=NS, slots_per_shard=SPS,
                  shard_range=span)
        if lsm:
            kw["spill_store"] = n.Lsm(
                P.agg.sum_of("v"), memory_budget_bytes=0, num_shards=NS,
                store_dir=os.path.join(tmp, f"lsm-{span}-{os.urandom(4).hex()}"))
        return P.WindowOperator(P.Tumbling.of(1000), P.agg.sum_of("v"), **kw)
    return mk


# kind name -> (plan kind, make(ns, shard span, tmp), whether the target
# window takes a span, steps before the cut, steps after it)
KINDS = {
    "window": ("window", _mk_window(), True,
               [_batch(1, 0), _batch(2, 1000), ("wm", 1500)],
               [_batch(3, 2000), ("wm", 5000)]),
    "window_lsm": ("window", _mk_window(lsm=True), True,
                   [_batch(1, 0, 512, 600), _batch(2, 1000, 512, 600)],
                   [_batch(3, 2000, 512, 600), ("wm", 5000)]),
    "process_state": (
        "process", lambda n, span, tmp: n.Process(
            n.RunningSum(), num_shards=NS, slots_per_shard=SPS), False,
        [_batch(10, 10000), _batch(11, 11000)], [_batch(12, 12000)]),
    "process_timers": (
        "process", lambda n, span, tmp: n.Process(
            n.IdleTimeout(), num_shards=NS, slots_per_shard=SPS), False,
        [("batch", np.arange(20, dtype=np.int64),
          (100 + 17 * np.arange(20)).astype(np.int64), {})],
        [("wm", 5000)]),
    "count_window": (
        "count_window", lambda n, span, tmp: n.CountWindow(
            n.P.agg.sum_of("v"), 3, num_shards=NS, slots_per_shard=SPS,
            **n.P.kw), False,
        [("batch", np.tile(np.arange(16, dtype=np.int64), 2),
          np.arange(32, dtype=np.int64),
          {"v": np.arange(32, dtype=np.float64)})],
        [("batch", np.arange(16, dtype=np.int64), np.full(16, 99, np.int64),
          {"v": np.full(16, 0.5)})]),
    "global_agg": (
        "global_agg", lambda n, span, tmp: n.GlobalAgg(
            n.P.agg.sum_of("v"), num_shards=NS, slots_per_shard=SPS), False,
        [_batch(20, 0, n_keys=16)], [_batch(21, 1000, n_keys=16)]),
    "session": (
        "session", lambda n, span, tmp: n.Session(1000, n.P.agg.count()),
        False, [_batch(30, 0, n_keys=16), ("wm", 500)],
        [_batch(31, 800, n_keys=16), ("wm", 10_000)]),
    "cep": (
        "cep", lambda n, span, tmp: n.cep.CepOperator(
            cep_pattern(n.cep.Pattern), num_shards=NS, slots_per_shard=SPS),
        False, [_batch(40, 0), _batch(41, 1000)],
        [_batch(42, 2000), _batch(43, 3000)]),
    "cep_no_skip": (
        "cep", lambda n, span, tmp: n.cep.CepOperator(
            cep_pattern(n.cep.Pattern, "NO_SKIP"), num_shards=NS,
            slots_per_shard=SPS), False,
        [_batch(44, 0, n_keys=48)], [_batch(45, 1000, n_keys=48)]),
}


def _norm(v):
    if isinstance(v, (float, np.floating)):
        return round(float(v), 6)
    return int(v)


def _rows(fired):
    """A fire's rows as sorted tuples of its non-internal fields."""
    if fired is None:
        return []
    fired = dict(fired)
    names = sorted(k for k in fired if not k.startswith("__"))
    if not names:
        return []
    cols = [np.asarray(fired[f]) for f in names]
    return sorted(tuple(_norm(c[i]) for c in cols)
                  for i in range(len(cols[0])))


def route(n, keys, ts, data, n_proc):
    """One batch's per-process shares along the shard spans, as
    ``hybrid_route`` splits it across the exchange."""
    owner = n.hash_shards(np.asarray(keys, np.int64), NS) // (NS // n_proc)
    return [(keys[owner == o], ts[owner == o],
             {f: v[owner == o] for f, v in data.items()})
            for o in range(n_proc)]


def drive(n, ops, steps):
    """Feed a fleet of ``len(ops)`` processes (records routed to their
    owners); the rows it emits, sorted."""
    out = []
    for st in steps:
        if st[0] == "batch":
            shares = route(n, st[1], st[2], st[3], len(ops))
            for op, (k, t, d) in zip(ops, shares):
                op.process_batch(k, t, d)
                if hasattr(op, "take_fired"):
                    out += _rows(op.take_fired())
        else:
            for op in ops:
                out += _rows(op.advance_watermark(st[1]))
    return sorted(out)


def payload(ops_snap, pid, nproc, ckpt=3):
    """A driver-shaped checkpoint payload around real operator snapshots
    (``tests/test_repartition.py``'s ``_payload``)."""
    spp = NS // nproc
    return {
        "sources": {"src": {i: 100 * pid + i for i in range(2)}},
        "sub_factors": {"src": 1},
        "wm_gens": {"src": [("gen", pid, i) for i in range(2)]},
        "max_ts": {"src": 1000 + pid},
        "out_wm": {"src": 900 - pid},
        "operators": ops_snap,
        "op_versions": {"w": 1},
        "partitioners": {"rr": 7},
        "sinks": {},
        "metrics": {"records": 10 * (pid + 1), "name": f"p{pid}"},
        "checkpoint_id": ckpt + pid,
        "rescale": {"nproc": nproc, "pid": pid, "num_shards": NS,
                    "shard_range": [pid * spp, (pid + 1) * spp]},
    }


def merge(n, payloads, new_pid, new_nproc, kinds):
    return n.rp.merge_payloads(payloads, new_pid=new_pid,
                               new_nproc=new_nproc, num_shards=NS,
                               slots_per_shard=SPS, op_kinds=kinds)


def span(pid, nproc, ranged):
    return ((pid * NS // nproc, (pid + 1) * NS // nproc)
            if ranged and nproc > 1 else None)


DIRECTIONS = {"2to1": (2, 1), "1to2": (1, 2)}


def rescale_case(P, kind, direction, tmp):
    """One package's run of a kind across a cut: (the reference
    operator's rows before and after, the old fleet's rows before, the
    merged payloads, the new fleet's rows after)."""
    n = NSP[P.name]
    plan_kind, mk, ranged, pre, post = KINDS[kind]
    n_old, n_new = DIRECTIONS[direction]
    ref = mk(n, None, tmp)
    olds = [mk(n, span(p, n_old, ranged), tmp) for p in range(n_old)]
    ref_pre, old_pre = drive(n, [ref], pre), drive(n, olds, pre)
    payloads = [payload({"w": op.snapshot_state()}, pid, n_old)
                for pid, op in enumerate(olds)]
    merged = [merge(n, payloads, pid, n_new, {"w": plan_kind})
              for pid in range(n_new)]
    news = [mk(n, span(p, n_new, ranged), tmp) for p in range(n_new)]
    for op, m in zip(news, merged):
        op.restore_state(m["operators"]["w"])
    return (ref_pre, drive(n, [ref], post), old_pre, merged,
            drive(n, news, post))


_CASES = {}


def case(P, kind, direction, tmp_factory):
    key = (P.name, kind, direction)
    if key not in _CASES:
        _CASES[key] = rescale_case(P, kind, direction,
                                   str(tmp_factory.mktemp(kind)))
    return _CASES[key]


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("P", BOTH, ids=pkg_id)
def test_rescale_is_equivalent_by_routing(P, kind, direction,
                                          tmp_path_factory):
    """Before the cut the fleet emits the reference operator's rows;
    after it the new fleet, restored from the merged payloads, emits the
    reference's rows: their union, with no row twice."""
    ref_pre, ref_post, old_pre, _, new_post = case(P, kind, direction,
                                                   tmp_path_factory)
    assert old_pre == ref_pre
    assert new_post == ref_post and ref_post, "vacuous: no row after the cut"


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_merged_trees_equal_across_the_packages(kind, direction,
                                                tmp_path_factory):
    """The port's ``merge_payloads`` over the port's payloads gives the
    reference's tree over the reference's, field by field (the LSM
    tier's spill snapshot names its own files, so its runs compare by
    content), and both fleets emit the same rows."""
    pc = case(PORT, kind, direction, tmp_path_factory)
    jc = case(JAX, kind, direction, tmp_path_factory)
    assert pc[0] == jc[0] and pc[1] == jc[1] and pc[4] == jc[4]
    for pm, jm in zip(pc[3], jc[3]):
        pm, jm = dict(pm), dict(jm)
        pop, jop = dict(pm.pop("operators")["w"]), dict(
            jm.pop("operators")["w"])
        tree_equal(pm, jm, "payload")
        if kind == "window_lsm":
            tree_equal(spill_content(pop.pop("spill")),
                       spill_content(jop.pop("spill")), "spill")
        tree_equal(pop, jop, "operators['w']")


def spill_content(sp):
    """An LSM spill snapshot without its file names (each package's
    store names its own run files)."""
    if sp is None:
        return None
    return {k: v for k, v in sp.items()
            if k not in ("aux_files", "runs", "dir", "store_dir")}


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
@pytest.mark.parametrize("kind", sorted(set(KINDS) - {"window_lsm"}))
@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_each_package_restores_the_others_merged_payload(
        src, dst, kind, direction, tmp_path_factory):
    """A merged payload, through the checkpoint blob format of the
    package that merged it, restores into the other package's new fleet,
    which emits the reference operator's rows after the cut."""
    sc = case(src, kind, direction, tmp_path_factory)
    n = NSP[dst.name]
    _, mk, ranged, _, post = KINDS[kind]
    n_new = DIRECTIONS[direction][1]
    tmp = str(tmp_path_factory.mktemp(f"x-{kind}"))
    news = []
    for pid, m in enumerate(sc[3]):
        snap = dst.blobformat.decode(src.blobformat.encode(
            m["operators"]["w"]))
        op = mk(n, span(pid, n_new, ranged), tmp)
        op.restore_state(snap)
        news.append(op)
    assert drive(n, news, post) == sc[1]


# -- the driver plane and the refusals ------------------------------------------------

def process_payloads(n):
    ops = [n.Process(n.RunningSum(), num_shards=NS, slots_per_shard=SPS)
           for _ in range(2)]
    drive(n, ops, [_batch(40, 0)])
    return [payload({"p": op.snapshot_state()}, pid, 2)
            for pid, op in enumerate(ops)]


@pytest.mark.parametrize("P", BOTH, ids=pkg_id)
def test_driver_state_merges_by_rule(P):
    n = NSP[P.name]
    merged = merge(n, process_payloads(n), 0, 1, {"p": "process"})
    assert merged["sources"]["src"] == {0: 0, 1: 101}  # each split's owner
    assert merged["wm_gens"]["src"] == [("gen", 0, 0), ("gen", 1, 1)]
    assert merged["max_ts"]["src"] == 1001 and merged["out_wm"]["src"] == 899
    assert merged["metrics"] == {"records": 30, "name": "p0"}
    assert merged["checkpoint_id"] == 4
    assert merged["partitioners"] == {} and merged["sinks"] == {}
    assert merged["rescale"] == {"nproc": 1, "pid": 0, "num_shards": NS,
                                 "shard_range": [0, NS]}


def _spilled(n, payloads):
    payloads[1]["operators"]["p"] = dict(
        payloads[1]["operators"]["p"], spill={"panes": [("pane", 0)]})
    return payloads


def _lsm_mismatch(n, payloads, tmp):
    store = n.Lsm(n.P.agg.sum_of("v"), store_dir=os.path.join(tmp, "s"),
                  memory_budget_bytes=1 << 30, num_shards=NS * 2)
    payloads[1]["operators"]["p"] = dict(
        payloads[1]["operators"]["p"], spill=store.snapshot())
    return payloads


def _window_payloads(n, tmp, edit):
    ops = [_mk_window()(n, span(p, 2, True), tmp) for p in range(2)]
    snaps = [op.snapshot_state() for op in ops]
    edit(n, snaps, tmp)
    return [payload({"p": s}, pid, 2) for pid, s in enumerate(snaps)]


def _spill_edit(n, snaps, tmp):
    snaps[1]["spill"] = {"panes": [("pane", 0)]}


def _lsm_edit(n, snaps, tmp):
    snaps[1]["spill"] = n.Lsm(
        n.P.agg.sum_of("v"), store_dir=os.path.join(tmp, "s"),
        memory_budget_bytes=1 << 30, num_shards=NS * 2).snapshot()


def _ring_edit(n, snaps, tmp):
    snaps[1]["ring"] = snaps[1]["ring"] + 8


def _nproc_edit(payloads):
    payloads[0]["rescale"]["nproc"] = 4
    return payloads


def _missing_edit(payloads):
    del payloads[1]["operators"]["p"]
    return payloads


REFUSALS = {
    "ram_spill": ("window", lambda n, tmp: _window_payloads(
        n, tmp, _spill_edit), 1, "spill"),
    "lsm_num_shards": ("window", lambda n, tmp: _window_payloads(
        n, tmp, _lsm_edit), 1, "num_shards"),
    "diverged_rings": ("window", lambda n, tmp: _window_payloads(
        n, tmp, _ring_edit), 1, "ring"),
    "fleet_size_does_not_divide": (
        "process", lambda n, tmp: process_payloads(n), 3, "divide"),
    "foreign_fleet_size": (
        "process", lambda n, tmp: _nproc_edit(process_payloads(n)), 1,
        "4-process"),
    "out_of_order_set": (
        "process", lambda n, tmp: process_payloads(n)[::-1], 1,
        "out of order"),
    "incomplete_set": (
        "process", lambda n, tmp: _missing_edit(process_payloads(n)), 1,
        "missing"),
    "empty_set": ("process", lambda n, tmp: [], 1, "empty"),
    "unknown_keyed_kind": (
        "quantum_window", lambda n, tmp: process_payloads(n), 1,
        "no repartition rule"),
}


@pytest.mark.parametrize("refusal", sorted(REFUSALS))
@pytest.mark.parametrize("P", BOTH, ids=pkg_id)
def test_refusals_raise_rescale_error(P, refusal, tmp_path):
    kind, make, new_nproc, msg = REFUSALS[refusal]
    n = NSP[P.name]
    with pytest.raises(n.rp.RescaleError, match=msg):
        merge(n, make(n, str(tmp_path)), 0, new_nproc, {"p": kind})


@pytest.mark.parametrize("P", BOTH, ids=pkg_id)
def test_keyless_kinds_are_taken_verbatim(P):
    n = NSP[P.name]
    payloads = process_payloads(n)
    for pid, p in enumerate(payloads):
        for nid in ("a", "b", "c"):
            p["operators"][nid] = {"marker": pid}
    merged = merge(n, payloads, 0, 1, {
        "p": "process", "a": "window_all", "b": "async_io",
        "c": "broadcast_connect"})
    assert all(merged["operators"][nid] == {"marker": 0}
               for nid in ("a", "b", "c"))


def test_the_routing_truth_is_shared():
    keys = np.random.default_rng(5).integers(-10 ** 12, 10 ** 12, 10_000)
    assert np.array_equal(NSP["port"].hash_shards(keys, NS),
                          NSP["jax"].hash_shards(keys, NS))


# -- the driver: rescale a job from a checkpoint set ---------------------------------

N_BATCHES, B, CUT = 16, 64, 8


def gen(split, i):
    if i >= N_BATCHES:
        return None
    rng = np.random.default_rng(700 * int(split) + i)
    return ({"k": rng.integers(0, 48, B).astype(np.int64)},
            i * 1000 + rng.integers(0, 1000, B).astype(np.int64))


BASE = {"state.num-key-shards": NS, "state.slots-per-shard": 32,
        "pipeline.microbatch-size": B}


def count_job(conf, sink, stop=None, name="rescale", seen=None):
    """The keyed 1 s tumbling count of ``gen``'s two splits into
    ``sink``. ``stop(env, i)`` runs as the source reads batch ``i`` and
    may end the run; ``seen`` collects the batch indices read."""
    env = PORT.Env(PORT.Conf(conf))

    def src(split, i):
        if stop is not None:
            stop(env, i)
        if seen is not None and i < N_BATCHES:
            seen.append(i)
        return gen(split, i)

    (env.from_source(PORT.GeneratorSource(src, n_splits=2),
                     PORT.WM.for_bounded_out_of_orderness(1000))
     .key_by("k").window(PORT.Tumbling.of(1000)).count().add_sink(sink))
    return PORT.execute(env, name)


def rows_of(sink):
    return sorted((int(r["key"]), int(r["window_end"]), int(r["count"]))
                  for r in sink.committed)


def fleet_conf(pid, nproc, ports, extra):
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    conf = dict(BASE, **extra)
    if nproc > 1:
        conf.update({"cluster.num-processes": nproc,
                     "cluster.process-id": pid, "cluster.dcn-peers": peers,
                     "cluster.dcn-port": ports[pid]})
    return conf


def commit_cut(storages, sinks):
    """The cut: the newest checkpoint every old process holds (the
    negotiated restore's rule). Each old process's sink commits the
    epochs that checkpoint staged, as that process's own restore would:
    the merged payload carries no staged epoch (the reference's rule for
    a savepoint set, whose savepoints commit theirs). The set's paths
    and each split's position in the set."""
    cut = min(st.latest().checkpoint_id for st in storages)
    paths, positions = [], {}
    for pid, (st, sink) in enumerate(zip(storages, sinks)):
        (h,) = [h for h in st.list_complete() if h.checkpoint_id == cut]
        payload = PORT.storage.FsCheckpointStorage.load(h)
        (staged,) = payload["sinks"].values()
        sink.restore_staged(staged, cut)
        paths.append(h.path)
        for pos in payload["sources"].values():
            for split, p in pos.items():
                # a split's position from the process that reads it
                if int(split) % len(storages) == pid:
                    positions[int(split)] = p
    return paths, positions


@pytest.fixture(scope="module")
def golden():
    sink = PORT.sinks.TransactionalCollectSink()
    count_job(BASE, sink, name="golden")
    rows = rows_of(sink)
    assert len({r[:2] for r in rows}) == len(rows) > 100
    return rows


def old_storage(root, pid, n_old):
    """Old process ``pid``'s checkpoint storage."""
    job = "rescale" + (f"-p{pid}" if n_old > 1 else "")
    return PORT.storage.FsCheckpointStorage(os.path.join(root, "old"), job)


def stop_old_fleet(root, n_old):
    """The old fleet (two processes on loopback in lockstep steps, or
    one) checkpoints every step and stops through a fault after batch 8.
    Its sinks commit the cut's epochs. The cut's set of paths, in process
    order, and the old sinks."""
    old_sinks = [PORT.sinks.TransactionalCollectSink() for _ in range(n_old)]
    ports = free_ports(n_old)

    def storage(pid):
        return old_storage(root, pid, n_old)

    def stop(pid):
        """Batches are read on demand (no prefetch). Alone, the process
        checkpoints synchronously at the cut and fails. Across
        processes the steps run in lockstep, each taking a durable
        checkpoint (a read takes 2 ms, past the 1 ms interval, so every
        step asks for one): process 1 fails at the cut once process 0
        holds the checkpoint of the step before, and process 0 fails on
        the exchange."""
        def at(env, i):
            if i < CUT:
                time.sleep(0.002)
                return
            if n_old == 1:
                env._driver.checkpoint_now()
            elif pid == 0:
                return
            else:
                mine = storage(1).latest().checkpoint_id
                deadline = time.time() + 60
                while (storage(0).latest() is None
                       or storage(0).latest().checkpoint_id < mine):
                    assert time.time() < deadline, "process 0 never caught up"
                    time.sleep(0.01)
            raise RuntimeError("stop after the cut")
        return at

    def old(pid):
        conf = fleet_conf(pid, n_old, ports, {
            "execution.checkpointing.dir": os.path.join(root, "old"),
            "execution.checkpointing.interval": 1,
            "pipeline.source-prefetch": 0, "cluster.dcn-overlap": False})
        with pytest.raises(Exception):
            count_job(conf, old_sinks[pid], stop=stop(pid))
    run_threads([lambda p=p: old(p) for p in range(n_old)], timeout=120)
    paths, positions = commit_cut([storage(p) for p in range(n_old)],
                                  old_sinks)
    assert positions == {0: CUT, 1: CUT}
    return paths, old_sinks


def resume_new_fleet(root, n_new, restore, paths):
    """The new fleet restores (``restore``: a path or ``latest``) with
    ``cluster.rescale-from`` naming ``paths`` and finishes the job. Its
    sinks and the batch indices its sources read."""
    new_sinks = [PORT.sinks.TransactionalCollectSink() for _ in range(n_new)]
    ports = free_ports(n_new)
    seen = []

    def new(pid):
        conf = fleet_conf(pid, n_new, ports, {
            "execution.checkpointing.dir": os.path.join(root, "new"),
            "execution.checkpointing.interval": 1,
            "execution.checkpointing.restore": restore,
            "cluster.rescale-from": ",".join(paths)})
        return count_job(conf, new_sinks[pid], seen=seen)
    run_threads([lambda p=p: new(p) for p in range(n_new)], timeout=120)
    return new_sinks, seen


def assert_rows_once(golden, old_sinks, new_sinks, seen):
    """The committed rows of both halves are the golden's, each (key,
    window) once, and the resumed half read from the cut on."""
    before = [r for s in old_sinks for r in rows_of(s)]
    after = [r for s in new_sinks for r in rows_of(s)]
    assert before and after, "vacuous: one half committed nothing"
    assert sorted(before + after) == golden
    # the resumed half read from the cut on, not from the start
    assert min(seen) >= 1 and max(seen) == N_BATCHES - 1


@pytest.mark.parametrize("n_old,n_new", [(2, 1), (1, 2)],
                         ids=["2to1", "1to2"])
def test_a_job_rescales_from_a_checkpoint_set(tmp_path, golden, n_old,
                                              n_new):
    """The old fleet stops after the cut; the new fleet restores the set
    through ``cluster.rescale-from`` (a one-process restore merges both
    spans; two processes take each its span of one checkpoint) and
    finishes the job. The committed rows of both halves are the
    unrescaled run's, each (key, window) once."""
    root = str(tmp_path)
    paths, old_sinks = stop_old_fleet(root, n_old)
    new_sinks, seen = resume_new_fleet(root, n_new, paths[0], paths)
    assert_rows_once(golden, old_sinks, new_sinks, seen)


@pytest.mark.parametrize("stale", [False, True], ids=["empty", "stale"])
@pytest.mark.parametrize("n_old,n_new", [(2, 1), (1, 2)],
                         ids=["2to1", "1to2"])
def test_restore_latest_does_not_go_behind_the_rescale_set(
        tmp_path, golden, n_old, n_new, stale):
    """The rescale floor: ``restore: latest`` with
    ``cluster.rescale-from`` naming the cut's crash checkpoints
    (``chk-<n>``) restores the set when the new fleet's directory holds
    no checkpoint, or only one older than the cut (``stale``: an earlier
    checkpoint of the old geometry in each new process's job
    directory). Alone the process takes the single-process restore,
    across processes the negotiated one; each commits the golden's rows
    once."""
    import shutil

    root = str(tmp_path)
    paths, old_sinks = stop_old_fleet(root, n_old)
    if stale:
        older = [h for h in old_storage(root, 0, n_old).list_complete()
                 if h.checkpoint_id < PORT.storage.FsCheckpointStorage
                 .load(paths[0])["checkpoint_id"]]
        assert older, "vacuous: no checkpoint older than the cut"
        for pid in range(n_new):
            job = "rescale" + (f"-p{pid}" if n_new > 1 else "")
            dst = os.path.join(root, "new", job,
                               os.path.basename(older[0].path))
            shutil.copytree(older[0].path, dst)
    new_sinks, seen = resume_new_fleet(root, n_new, "latest", paths)
    assert_rows_once(golden, old_sinks, new_sinks, seen)
