"""The port's stream partitioners against the JAX package's, on the CPU:
each strategy's ``assign`` / ``advance`` / ``snapshot`` / ``restore`` over
a seeded run of batch sizes, ``hash_shards`` / ``hybrid_route`` /
``cross_slice_fraction`` on seeded keys, the lowering of a
``PartitionTransformation`` to a node of its own (node ids equal in both
packages, since a shuffle's seed is its node id), every strategy run
end to end, and a job with ``.shuffle()`` and ``.rebalance().key_by()``
checkpointed in each package and resumed in the other. Integers, row
order and partitioner state must be equal exactly."""
import numpy as np
import pytest

from flink_tpu.exchange import partitioners as jp
from flink_tpu.graph.compiler import compile_job as jax_compile
from flink_tpu_torch.exchange import partitioners as tp
from flink_tpu_torch.graph.compiler import compile_job as port_compile
from test_torch_ckpt_pkgs import BOTH, JAX, PORT, row_view
from test_torch_threads import capped_torch_threads  # noqa: F401

STRATEGIES = ("rebalance", "rescale", "shuffle", "broadcast", "global",
              "forward")


def batch_sizes(seed, n=12):
    return np.random.default_rng(seed).integers(0, 300, n).tolist()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_assign_advance_snapshot_match_the_reference(strategy):
    """Over a seeded run of batch sizes and subtask counts, each
    strategy assigns the reference's subtasks, and ``advance`` and
    ``snapshot`` / ``restore`` leave the reference's state."""
    rng = np.random.default_rng(11)
    for seed in (0, 7):
        j = jp.make_partitioner(strategy, seed=seed)
        p = tp.make_partitioner(strategy, seed=seed)
        assert p.broadcast == j.broadcast
        for b in batch_sizes(seed):
            n = int(rng.integers(1, 9))
            if j.broadcast:
                with pytest.raises(RuntimeError, match="broadcast"):
                    p.assign(b, n)
                continue
            want = j.assign(b, n)
            got = p.assign(b, n)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            assert p.snapshot() == j.snapshot()
            j.advance(b + 1, n)
            p.advance(b + 1, n)
            assert p.snapshot() == j.snapshot()
        # a restored partitioner continues the stream where it stood
        q = tp.make_partitioner(strategy, seed=seed)
        q.restore(j.snapshot())
        if not j.broadcast:
            np.testing.assert_array_equal(q.assign(37, 5), j.assign(37, 5))


def test_rescale_group_and_shuffle_seeds_match_the_reference():
    j, p = jp.RescalePartitioner(group=(2, 5)), tp.RescalePartitioner(
        group=(2, 5))
    for b in batch_sizes(3):
        np.testing.assert_array_equal(p.assign(b, 8), j.assign(b, 8))
    a = tp.ShufflePartitioner(seed=1).assign(1000, 8)
    assert not np.array_equal(a, tp.ShufflePartitioner(seed=2).assign(1000, 8))
    np.testing.assert_array_equal(a, jp.ShufflePartitioner(seed=1).assign(
        1000, 8))
    # a snapshot written under the old "draws" name restores too
    q = tp.ShufflePartitioner()
    q.restore({"seed": 4, "draws": 3})
    assert q.snapshot() == {"seed": 4, "calls": 3}


@pytest.mark.parametrize("shape", [(128, 4, 8), (64, 2, 4), (32, 1, 1),
                                   (96, 3, 2)])
def test_hybrid_route_matches_the_reference(shape):
    num_shards, nproc, local = shape
    rng = np.random.default_rng(num_shards)
    i64 = np.iinfo(np.int64)
    keys = np.concatenate([
        np.array([0, -1, i64.max, i64.min], np.int64),
        rng.integers(i64.min, i64.max, 4096, dtype=np.int64)])
    np.testing.assert_array_equal(tp.hash_shards(keys, num_shards),
                                  jp.hash_shards(keys, num_shards))
    got = tp.hybrid_route(keys, num_shards, nproc, local_devices=local)
    want = jp.hybrid_route(keys, num_shards, nproc, local_devices=local)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    for pid in range(nproc):
        assert tp.cross_slice_fraction(got[0], pid) == \
            jp.cross_slice_fraction(want[0], pid)
    assert tp.cross_slice_fraction(np.zeros(0, np.int32), 0) == 0.0


def test_hybrid_route_divisibility_errors_match_the_reference():
    keys = np.arange(10, dtype=np.int64)
    for args, kw, match in (((100, 3), {}, "n_processes"),
                            ((128, 4), {"local_devices": 3}, "device count")):
        for mod in (jp, tp):
            with pytest.raises(ValueError, match=match):
                mod.hybrid_route(keys, *args, **kw)


# -- through the DataStream API -------------------------------------------------

N_BATCHES, B = 8, 64


def gen(split, i):
    if i >= N_BATCHES:
        return None
    rng = np.random.default_rng(100 * int(split) + i)
    return ({"k": rng.integers(0, 24, B).astype(np.int64),
             "v": rng.integers(0, 1000, B).astype(np.int64)},
            i * 500 + rng.integers(0, 500, B).astype(np.int64))


def double_v(d):
    return {**d, "v": d["v"] * 2}


def build_job(P, sink, strategy="shuffle"):
    """source → a partitioner → map → rebalance → keyBy → 1 s tumbling
    count → sink."""
    def build(conf):
        env = P.Env(conf)
        s = env.from_source(P.GeneratorSource(gen, n_splits=2),
                            P.WM.for_bounded_out_of_orderness(500))
        s = getattr(s, strategy + ("_" if strategy == "global" else ""))()
        (s.map(double_v).rebalance().key_by("k")
         .window(P.Tumbling.of(1000)).count().add_sink(sink))
        return env
    return build, {"state.num-key-shards": 4, "state.slots-per-shard": 32,
                   "pipeline.microbatch-size": B}


def test_partition_lowers_to_a_node_of_its_own_in_both_packages():
    plans = []
    for P, compile_job in ((JAX, lambda e: jax_compile(
            e._transforms, e.config, e._watermark_strategy)),
            (PORT, lambda e: port_compile(e._transforms,
                                          e._watermark_strategy))):
        build, conf = build_job(P, P.sinks.CollectSink())
        plan = compile_job(build(P.Conf(conf)))
        plans.append({nid: (n.kind, n.partition_strategy, sorted(n.downstream))
                      for nid, n in plan.nodes.items()})
    assert plans[0] == plans[1]
    kinds = [v[:2] for v in plans[1].values()]
    assert ("partition", "shuffle") in kinds and \
        ("partition", "rebalance") in kinds


@pytest.mark.parametrize("strategy", ["rebalance", "rescale", "shuffle",
                                      "broadcast", "global"])
def test_every_strategy_passes_records_through_as_the_reference(strategy):
    """At parallelism 1 every strategy is a pass-through: the committed
    rows equal the reference's in order, and the partitioners' state at
    the end is the reference's."""
    rows, states = {}, {}
    for P in BOTH:
        sink = P.sinks.CollectSink()
        build, conf = build_job(P, sink, strategy)
        env = build(P.Conf(conf))
        P.execute(env, f"part-{strategy}")
        rows[P.name] = row_view(sink.rows)
        states[P.name] = {nid: p.snapshot()
                          for nid, p in env._driver._partitioners.items()}
    assert rows["port"] == rows["jax"] and rows["port"]
    assert states["port"] == states["jax"] and len(states["port"]) == 2
    assert sum(dict(r)["count"] for r in rows["port"]) == 2 * N_BATCHES * B


# -- partitioner state across the packages' checkpoints ---------------------------

CUT = 3


def run_cut(P, root, restore=""):
    """The shuffle job with checkpoint 1 taken by ``checkpoint_now`` as the
    source reaches batch CUT, or resumed from ``restore``; (committed rows,
    the last checkpoint's partitioner state)."""
    sink = P.sinks.TransactionalCollectSink()
    build, conf = build_job(P, sink)
    env = build(P.Conf(dict(conf, **{
        "execution.checkpointing.dir": root,
        "execution.checkpointing.interval": 10 ** 9 if not restore else 1,
        "execution.checkpointing.restore": restore,
        "pipeline.source-prefetch": 0})))
    if not restore:
        src = [t for t in env._transforms
               if getattr(t, "source", None) is not None][0].source
        inner, hit = src.gen, [False]

        def hooked(split, i):
            if i == CUT and not hit[0]:
                hit[0] = True
                env._driver.checkpoint_now()
            return inner(split, i)
        src.gen = hooked
    P.execute(env, "parts")
    st = P.storage.FsCheckpointStorage(root, "parts")
    last = P.storage.FsCheckpointStorage.load(st.list_complete()[-1])
    return row_view(sink.committed), last["partitioners"]


def test_partitioner_state_crosses_the_packages_checkpoints(tmp_path):
    """Checkpoint 1 of the job holds the same partitioner state in both
    packages; each package resumes the other's checkpoint and commits the
    same rows, ending with the same partitioner state."""
    cuts = {}
    for P in BOTH:
        rows, final = run_cut(P, str(tmp_path / f"cut-{P.name}"))
        path = str(tmp_path / f"cut-{P.name}" / "parts" / "chk-1")
        cuts[P.name] = (rows, final, path,
                        P.storage.FsCheckpointStorage.load(path)["partitioners"])
    (jrows, jfinal, jpath, jstate), (prows, pfinal, ppath, pstate) = (
        cuts["jax"], cuts["port"])
    assert prows == jrows and pfinal == jfinal
    assert pstate == jstate and len(pstate) == 2
    assert all(s for s in pstate.values())
    got = {}
    for reader in BOTH:
        for writer, path in (("jax", jpath), ("port", ppath)):
            got[(reader.name, writer)] = run_cut(
                reader, str(tmp_path / f"{reader.name}-{writer}"),
                restore=path)
    want_rows, want_state = got[("jax", "jax")]
    assert want_rows and want_rows == jrows[len(jrows) - len(want_rows):]
    for k, (rows, state) in got.items():
        assert rows == want_rows, k
        assert state == want_state == jfinal, k
