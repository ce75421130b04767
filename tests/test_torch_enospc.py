"""Disk-full handling (``storage.enospc-policy``) on the port against the
JAX package, case by case of ``tests/test_enospc.py``: ENOSPC injected
mid-checkpoint and mid-segment-write under ``retry`` ends with committed
output equal to the fault-free golden and to the reference's (the
retries show on ``storage.enospc_retries``); under ``fail`` the run
fails loudly and the port's fsck finds no error in what it left, as the
reference's does."""
import os

import numpy as np
import pytest

from test_torch_file_pkgs import BOTH, J, P
from test_torch_threads import capped_torch_threads  # noqa: F401

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _default_policy():
    yield
    for M in BOTH:
        M.fs.install_enospc_policy("retry")


def _source(n_batches, batch=64, n_keys=8):
    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng(7000 + i)
        keys = rng.integers(0, n_keys, batch).astype(np.int64)
        ts = np.sort(rng.integers(i * 500, i * 500 + 1000,
                                  batch)).astype(np.int64)
        return {"k": keys}, ts

    return gen


def _run(M, tmp_path, sub, extra=None, plan=None):
    c = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
         "pipeline.microbatch-size": 128,
         "execution.checkpointing.dir": str(tmp_path / f"{sub}-{M.name}"),
         "execution.checkpointing.interval": 1}
    c.update(extra or {})
    sink = M.sinks.TransactionalCollectSink()
    env = M.Env(M.Conf(c))
    (env.from_source(M.GeneratorSource(_source(6)),
                     M.WM.for_bounded_out_of_orderness(1000))
     .key_by("k").window(M.Tumbling.of(1000)).count().add_sink(sink))
    if plan is None:
        M.execute(env, "enospc-job")
    else:
        with plan.activate():
            M.execute(env, "enospc-job")
    return sorted((int(r["key"]), int(r["window_start"]), int(r["count"]))
                  for r in sink.committed)


def _retries(M) -> int:
    return int(M.fs.registry.snapshot().get("storage.enospc_retries", 0))


def test_mid_checkpoint_enospc_retries_to_golden(tmp_path):
    got = {}
    for M in BOTH:
        golden = _run(M, tmp_path, "golden")
        before = _retries(M)
        plan = M.faults.FaultPlan(seed=3).rule(
            "fs.write.enospc", "raise", count=2, after=2)
        got[M.name] = _run(M, tmp_path, "retry", extra={
            "storage.enospc-policy": "retry",
            "storage.enospc-backoff-ms": 1}, plan=plan)
        assert got[M.name] == golden
        assert len(plan.log) == 2, "schedule injected nothing"
        assert _retries(M) >= before + 2
    assert got["port"] == got["jax"]


def _stage_all(M, topic_dir, plan=None):
    M.fs.install_enospc_policy("retry", retries=4, backoff_ms=1)
    ap = M.topic.TopicAppender(topic_dir, partitions=2, segment_records=4)
    b = {"k": np.arange(10, dtype=np.int64),
         "v": np.arange(10, dtype=np.float64)}
    if plan is None:
        ap.stage(1, {0: [b], 1: [b]})
        ap.commit(1)
    else:
        with plan.activate():
            ap.stage(1, {0: [b], 1: [b]})
            ap.commit(1)
    r = M.topic.TopicReader(topic_dir)
    return {p: [(o, {k: v.tolist() for k, v in blk.items()})
                for o, blk in r.read(p)] for p in range(2)}


def test_mid_segment_write_enospc_retries_to_golden(tmp_path):
    got = {}
    for M in BOTH:
        golden = _stage_all(M, os.path.join(str(tmp_path), f"g-{M.name}"))
        before = _retries(M)
        plan = M.faults.FaultPlan(seed=5).rule(
            "fs.write.enospc", "raise", count=1, after=3)
        got[M.name] = _stage_all(
            M, os.path.join(str(tmp_path), f"c-{M.name}"), plan)
        assert got[M.name] == golden
        assert plan.log, "schedule injected nothing"
        assert _retries(M) >= before + 1
    assert got["port"] == got["jax"]


def test_invalid_policy_is_loud():
    for M in BOTH:
        with pytest.raises(ValueError):
            M.fs.install_enospc_policy("yolo")
        with pytest.raises(ValueError):
            M.fs.install_enospc_policy_from_config(M.Conf(
                {"storage.enospc-policy": "bogus"}))


def _errors(path):
    """Error findings of both fscks over ``path`` (equal)."""
    got = {M.name: [f for f in M.fsck.fsck_path(path)
                    if f["severity"] == "error"] for M in BOTH}
    assert got["port"] == got["jax"]
    return got["port"]


def test_mid_checkpoint_enospc_fails_loud_and_fsck_clean(tmp_path):
    for M in BOTH:
        plan = M.faults.FaultPlan(seed=3).rule(
            "fs.write.enospc", "raise", count=1, after=2)
        with pytest.raises(Exception) as ei:
            _run(M, tmp_path, "fail",
                 extra={"storage.enospc-policy": "fail"}, plan=plan)
        assert "enospc" in str(ei.value).lower()
        ckpt = str(tmp_path / f"fail-{M.name}")
        if os.path.isdir(ckpt):
            assert _errors(ckpt) == []


def test_mid_segment_write_enospc_fails_loud_and_fsck_clean(tmp_path):
    for M in BOTH:
        M.fs.install_enospc_policy("fail")
        topic = os.path.join(str(tmp_path), f"t-{M.name}")
        ap = M.topic.TopicAppender(topic, partitions=1, segment_records=4)
        b = {"k": np.arange(6, dtype=np.int64),
             "v": np.arange(6, dtype=np.float64)}
        ap.stage(1, {0: [b]})
        ap.commit(1)
        plan = M.faults.FaultPlan(seed=9).rule(
            "fs.write.enospc", "raise", count=1)
        with plan.activate():
            with pytest.raises(OSError):
                ap.stage(2, {0: [b]})
        M.topic.TopicAppender(topic, partitions=1, segment_records=4).recover()
        assert _errors(topic) == []
        assert M.topic.TopicReader(topic).committed_offsets() == {0: 6}
