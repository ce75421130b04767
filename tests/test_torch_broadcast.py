"""Broadcast state (``DataStream.connect(control).process(fn)``,
``ops/broadcast.py``) in the port, against the JAX package on the same
inputs: ``tests/test_broadcast.py``'s cases, each run on both packages.
The function runs on host numpy in both, so rows compare exactly and in
order; a snapshot of either package's operator restores into the
other's."""
import types

import numpy as np
import pytest

from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id
from test_torch_threads import capped_torch_threads  # noqa: F401

both = pytest.mark.parametrize("P", BOTH, ids=pkg_id)


def _bc(P):
    """Package ``P``'s broadcast surface, with the reference test's
    dynamic-filter function built on it."""
    if P is PORT:
        from flink_tpu_torch.ops import broadcast
    else:
        from flink_tpu.ops import broadcast

    class RuleFilter(broadcast.BroadcastProcessFunction):
        """Control rows carry (key, allowed) rules; data rows pass only
        while their key is allowed."""

        def process_element(self, data, ts, state):
            allowed = state.get("allowed", set())
            if not len(ts):
                return None
            mask = np.array([int(k) in allowed for k in data["k"]], bool)
            return {"k": data["k"][mask], "v": data["v"][mask],
                    "__ts__": ts[mask]}

        def process_broadcast_element(self, data, ts, state):
            allowed = state.setdefault("allowed", set())
            for k, on in zip(data["rule_key"], data["enable"]):
                (allowed.add if int(on) else allowed.discard)(int(k))

    return types.SimpleNamespace(
        Fn=broadcast.BroadcastProcessFunction,
        Op=broadcast.BroadcastConnectOperator, RuleFilter=RuleFilter)


BC = {P.name: _bc(P) for P in BOTH}


def data_gen(split, i):
    if i >= 4:
        return None
    rng = np.random.default_rng(i)
    return ({"k": np.full(100, i % 2, np.int64),
             "v": rng.integers(0, 10, 100).astype(np.int64)},
            np.full(100, i * 1000, np.int64))


def rule_gen(split, i):
    # batch 0: enable key 0; batch 1: enable key 1, disable key 0
    rules = [([0], [1]), ([1, 0], [1, 0])]
    if i >= len(rules):
        return None
    ks, en = rules[i]
    return ({"rule_key": np.asarray(ks, np.int64),
             "enable": np.asarray(en, np.int64)},
            np.full(len(ks), i * 1000, np.int64))


def rules_job(P):
    env = P.Env(P.Conf({}))
    data = env.from_source(P.GeneratorSource(data_gen),
                           P.WM.for_bounded_out_of_orderness(0))
    control = env.from_source(P.GeneratorSource(rule_gen),
                              P.WM.for_bounded_out_of_orderness(0))
    sink = P.sinks.CollectSink()
    data.connect(control).process(BC[P.name].RuleFilter()).add_sink(sink)
    res = P.execute(env, "broadcast-rules")
    return [(int(r["k"]), int(r["v"])) for r in sink.rows], res


def test_dynamic_rules_apply_in_arrival_order():
    """Rules arrive between data batches and change what passes next:
    the port's rows are the reference's, in order; key 0's batch passes
    while it is enabled and key 1's once the second rule batch enabled
    it."""
    got, res = rules_job(PORT)
    want, _ = rules_job(JAX)
    assert got == want and got
    assert {k for k, _ in got} <= {0, 1}
    assert res.metrics["records_out"] == len(got)


@both
def test_state_rides_checkpoints(P):
    """Rules applied before a snapshot still filter after a restore, and
    the mutation bumped the incremental-checkpoint version."""
    b = BC[P.name]
    op = b.Op(b.RuleFilter())
    op.process_broadcast(np.array([0]), {"rule_key": np.array([7]),
                                         "enable": np.array([1])},
                         np.array([True]))
    assert op.state_version == 1
    op2 = b.Op(b.RuleFilter())
    op2.restore_state(op.snapshot_state())
    op2.process_main(np.array([5, 6]),
                     {"k": np.array([7, 8]), "v": np.array([1, 2])},
                     np.array([True, True]))
    out = op2.take_fired()
    assert out["k"].tolist() == [7] and out["__ts__"].tolist() == [5]
    assert op2.take_fired() is None


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_snapshot_crosses_the_packages(src, dst):
    """One package's snapshot, through the checkpoint blob format,
    restores into the other's operator and filters alike."""
    a = BC[src.name].Op(BC[src.name].RuleFilter())
    a.process_broadcast(np.array([0, 0]), {"rule_key": np.array([3, 4]),
                                           "enable": np.array([1, 1])},
                        np.array([True, True]))
    snap = dst.blobformat.decode(src.blobformat.encode(a.snapshot_state()))
    b = BC[dst.name].Op(BC[dst.name].RuleFilter())
    b.restore_state(snap)
    b.process_main(np.array([9, 9, 9]),
                   {"k": np.array([3, 5, 4]), "v": np.array([1, 2, 3])},
                   np.array([True, True, False]))
    out = dict(b.take_fired())
    assert out["k"].tolist() == [3] and out["v"].tolist() == [1]


@both
def test_ragged_output_rejected(P):
    class Bad(BC[P.name].Fn):
        def process_element(self, data, ts, state):
            return {"a": np.arange(3), "b": np.arange(2)}

        def process_broadcast_element(self, data, ts, state):
            pass

    op = BC[P.name].Op(Bad())
    with pytest.raises(ValueError, match="ragged"):
        op.process_main(np.array([1]), {"x": np.array([1])},
                        np.array([True]))


@both
def test_rows_without_ts_carry_the_batch_max(P):
    """Rows the function returns without ``__ts__`` carry the batch's
    newest valid timestamp, as the reference stamps them."""
    class PassAll(BC[P.name].Fn):
        def process_element(self, data, ts, state):
            return {"x": data["x"] * 2}

        def process_broadcast_element(self, data, ts, state):
            pass

    op = BC[P.name].Op(PassAll())
    op.process_main(np.array([4, 9, 7]), {"x": np.array([1, 2, 3])},
                    np.array([True, False, True]))
    op.process_main(np.array([11]), {"x": np.array([5])}, np.array([True]))
    out = dict(op.take_fired())
    assert out["x"].tolist() == [2, 6, 10]
    assert out["__ts__"].tolist() == [7, 7, 11]
