"""The port's durable log (``flink_tpu_torch/log/``) against the JAX
package's, on the CPU: each case of ``tests/test_log.py`` but the CLI
smoke runs the same calls on both packages and compares what they
leave behind — committed rows in order within each partition, offsets,
staged and committed transactions, segment counts and file names, and
the rows of the jobs chained through a topic. Then the cross-package
cases: a topic written by either package is read by the other, plain,
compacted and on ``objstore://``, and a port job consumes a topic the
reference produced.

``TestCliChainSmoke``: two ``run --local`` jobs of the port's command
line (on the CPU) chained through a topic, and its ``log`` command; the
consumer's committed output equals the reference job's golden."""
import os

import numpy as np
import pytest

from test_torch_log_pkgs import (BOTH, LJ, LP, cols, raised, run_both,
                                 scrub, topic_rows, topic_view)
from test_torch_threads import capped_torch_threads  # noqa: F401


def word_gen(n_batches, batch=64, vocab=10):
    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng(500 + i)
        words = rng.integers(0, vocab, batch).astype(np.int64)
        ts = (i * batch + np.arange(batch, dtype=np.int64)) * 10
        return {"word": words, "ts_ms": ts}, ts

    return gen


def committed_view(sink):
    return sorted((int(r["key"]), int(r["window_start"]), int(r["count"]))
                  for r in sink.committed)


def run_consumer(L, topic, shards=8):
    sink = L.sinks.TransactionalCollectSink()
    env = L.Env(L.Conf({"state.num-key-shards": shards,
                        "state.slots-per-shard": 64}))
    (env.from_source(L.log.LogSource(topic, ts_field="ts_ms"),
                     L.WM.for_bounded_out_of_orderness(1000))
     .key_by("word").window(L.Tumbling.of(1000)).count()
     .add_sink(sink))
    L.execute(env, "log-consumer")
    return committed_view(sink)


@pytest.fixture(scope="module")
def golden_fused():
    """The reference's fused job over the same words: the chain's
    golden, run once a module."""
    sink = LJ.sinks.TransactionalCollectSink()
    env = LJ.Env(LJ.Conf({"state.num-key-shards": 8,
                          "state.slots-per-shard": 64}))
    (env.from_source(LJ.GeneratorSource(word_gen(TestChainedJobs.N)),
                     LJ.WM.for_bounded_out_of_orderness(1000))
     .key_by("word").window(LJ.Tumbling.of(1000)).count()
     .add_sink(sink))
    LJ.execute(env, "log-golden")
    return committed_view(sink)


def flat_k(L, topic, p=0, col="k"):
    return [x for _, b in L.topic.TopicReader(topic).read(p)
            for x in b[col].tolist()]


def _batch(lo, n):
    return {"k": np.arange(lo, lo + n, dtype=np.int64),
            "v": np.arange(n, dtype=np.int64) * 10}


class TestTopicCore:
    def test_stage_commit_offsets_and_segment_roll(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1, segment_records=5)
            sink.write(_batch(0, 12))
            sink.prepare_commit(1)
            before = L.topic.TopicReader(topic).committed_offsets()
            sink.notify_checkpoint_complete(1)
            d = L.log.describe_topic(topic)
            assert d["segments"] == {"0": 3}
            assert flat_k(L, topic) == list(range(12))
            return before, topic_view(L, topic)

        before, view = run_both(scenario, tmp_path)
        assert before == {0: 0} and view["committed"] == {0: 12}

    def test_commit_idempotent_and_staged_stack(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1)
            sink.write(_batch(0, 4))
            sink.prepare_commit(1)
            sink.write(_batch(4, 4))
            sink.prepare_commit(2)
            staged = sink.staged_transaction_ids()
            sink.notify_checkpoint_complete(2)
            sink.notify_checkpoint_complete(2)
            assert flat_k(L, topic) == list(range(8))
            return staged, topic_view(L, topic)

        staged, view = run_both(scenario, tmp_path)
        assert staged == [1, 2] and view["committed"] == {0: 8}

    def test_abort_rolls_segments_and_offsets_back(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1)
            sink.write(_batch(0, 4))
            sink.prepare_commit(1)
            sink.notify_checkpoint_complete(1)
            sink.write(_batch(4, 4))
            sink.prepare_commit(2)
            obs = [sink._appender.next_offset(0)]
            sink.abort_uncommitted()
            obs += [sink.staged_transaction_ids(),
                    sink._appender.next_offset(0),
                    sorted(os.listdir(root / "t" / "p0"))]
            sink.write(_batch(100, 2))
            sink.prepare_commit(3)
            sink.notify_checkpoint_complete(3)
            assert flat_k(L, topic) == [0, 1, 2, 3, 100, 101]
            return obs, topic_view(L, topic)

        obs, _ = run_both(scenario, tmp_path)
        assert obs[:3] == [8, [], 4] and len(obs[3]) == 1

    def test_partition_count_is_fixed(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            L.log.create_topic(topic, 2)
            return raised(lambda: L.log.LogSink(topic, key_field="k",
                                                partitions=3),
                          L.log.LogError, "refusing to reopen")

        assert run_both(scenario, tmp_path) == "LogError"

    def test_schema_drift_rejected(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1)
            sink.write(_batch(0, 2))
            sink.prepare_commit(1)
            sink.notify_checkpoint_complete(1)
            sink.write({"other": np.arange(2, dtype=np.int64)})
            return (raised(lambda: sink.prepare_commit(2), L.log.LogError,
                           "schema drift"), topic_view(L, topic))

        run_both(scenario, tmp_path)

    def test_multi_partition_routing_preserves_per_key_order(
            self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, key_field="k", partitions=4,
                                 segment_records=7)
            rng = np.random.default_rng(3)
            keys = rng.integers(0, 20, 200).astype(np.int64)
            sink.write({"k": keys, "seq": np.arange(200, dtype=np.int64)})
            sink.prepare_commit(1)
            sink.notify_checkpoint_complete(1)
            per_key = {}
            for p in range(4):
                for k, s in zip(flat_k(L, topic, p),
                                flat_k(L, topic, p, "seq")):
                    per_key.setdefault(k, []).append(s)
            for k, seqs in per_key.items():
                assert seqs == sorted(seqs), f"key {k} out of order"
            return topic_view(L, topic)

        view = run_both(scenario, tmp_path)
        assert sum(view["committed"].values()) == 200


class TestCommittedOffsetIsolation:
    def test_staged_is_never_observable(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1)
            sink.write({"k": np.arange(6, dtype=np.int64)})
            sink.prepare_commit(1)
            obs = [L.topic.TopicReader(topic).committed_offsets(),
                   list(L.log.LogSource(topic).open_split("0")),
                   L.log.describe_topic(topic)["staged_transactions"],
                   topic_view(L, topic)]
            sink.notify_checkpoint_complete(1)
            assert flat_k(L, topic) == list(range(6))
            return obs

        obs = run_both(scenario, tmp_path)
        assert obs[:3] == [{0: 0}, [], [1]]

    def test_orphan_segments_are_swept_not_read(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1)
            sink.write({"k": np.arange(3, dtype=np.int64)})
            sink.prepare_commit(1)
            sink.notify_checkpoint_complete(1)
            pdir = root / "t" / "p0"
            orphan = pdir / "seg-000000000099-c0000000099-e0.colb"
            orphan.write_bytes((pdir / os.listdir(pdir)[0]).read_bytes())
            got = flat_k(L, topic)
            L.log.LogSink(topic, partitions=1)  # recovery sweeps at init
            return got, orphan.exists(), topic_view(L, topic)

        got, exists, _ = run_both(scenario, tmp_path)
        assert got == [0, 1, 2] and not exists

    def test_truncated_committed_segment_fails_loudly(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1)
            sink.write({"k": np.arange(50, dtype=np.int64)})
            sink.prepare_commit(1)
            sink.notify_checkpoint_complete(1)
            pdir = root / "t" / "p0"
            (seg,) = [n for n in os.listdir(pdir) if n.endswith(".colb")]
            raw = (pdir / seg).read_bytes()
            (pdir / seg).write_bytes(raw[:len(raw) - 9])
            return raised(lambda: list(L.topic.TopicReader(topic).read(0)),
                          L.columnar.ColumnarError)

        assert run_both(scenario, tmp_path) == "ColumnarError"


def replay_topic(L, root, n=20, segment_records=6):
    topic = str(root / "t")
    sink = L.log.LogSink(topic, partitions=1,
                         segment_records=segment_records)
    sink.write({"k": np.arange(n, dtype=np.int64),
                "ts_ms": np.arange(n, dtype=np.int64) * 100})
    sink.prepare_commit(1)
    sink.notify_checkpoint_complete(1)
    return topic


class TestLogSourceReplay:
    def test_positions_are_offsets(self, tmp_path):
        def scenario(L, root):
            topic = replay_topic(L, root)
            src = L.log.LogSource(topic, ts_field="ts_ms")
            pos, rows, trail = 0, [], []
            for data, ts in src.open_split("0"):
                pos = src.position_after(pos, data, ts)
                trail.append((pos, ts.tolist()))
                rows.extend(data["k"].tolist())
            return rows, pos, trail

        rows, pos, _ = run_both(scenario, tmp_path)
        assert rows == list(range(20)) and pos == 20

    def test_replay_resumes_mid_segment_mid_block(self, tmp_path):
        def scenario(L, root):
            topic = replay_topic(L, root)
            src = L.log.LogSource(topic, ts_field="ts_ms")
            out = {}
            for start in (0, 1, 5, 6, 7, 13, 19, 20):
                got = [x for data, _ in src.open_split("0", start_pos=start)
                       for x in data["k"].tolist()]
                assert got == list(range(start, 20)), start
                out[start] = got
            return out

        run_both(scenario, tmp_path)

    def test_missing_ts_field_is_loud(self, tmp_path):
        def scenario(L, root):
            topic = replay_topic(L, root)
            src = L.log.LogSource(topic, ts_field="nope")
            return raised(lambda: list(src.open_split("0")),
                          L.log.LogError, "ts_field")

        run_both(scenario, tmp_path)

    def test_missing_topic_is_loud(self, tmp_path):
        def scenario(L, root):
            return raised(lambda: L.log.LogSource(str(root / "absent"))
                          .splits(), L.log.LogError, "no such log topic")

        run_both(scenario, tmp_path)


class TestLogSink2pcRecovery:
    def test_restore_rebuilds_and_commits_covered_epoch(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1)
            sink.write({"k": np.arange(4, dtype=np.int64)})
            sink.prepare_commit(7)
            snap = sink.snapshot_staged()
            sink.abort_uncommitted()
            mid = L.topic.TopicReader(topic).committed_offsets()
            L.log.LogSink(topic, partitions=1).restore_staged(snap, 7)
            assert flat_k(L, topic) == [0, 1, 2, 3]
            return mid, topic_view(L, topic)

        mid, _ = run_both(scenario, tmp_path)
        assert mid == {0: 0}

    def test_restore_rolls_uncovered_epochs_back(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1)
            sink.write({"k": np.arange(4, dtype=np.int64)})
            sink.prepare_commit(1)
            sink.notify_checkpoint_complete(1)
            sink.write({"k": np.arange(4, 8, dtype=np.int64)})
            sink.prepare_commit(2)
            snap = sink.snapshot_staged()
            sink2 = L.log.LogSink(topic, partitions=1)
            sink2.restore_staged(snap, 1)
            return (sink2.staged_transaction_ids(),
                    sink2._appender.next_offset(0), topic_view(L, topic))

        staged, nxt, view = run_both(scenario, tmp_path)
        assert staged == [] and nxt == 4 and view["committed"] == {0: 4}

    def test_fresh_sink_rolls_dead_attempts_staged_back(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1)
            sink.write({"k": np.arange(4, dtype=np.int64)})
            sink.prepare_commit(1)
            sink2 = L.log.LogSink(topic, partitions=1)
            return sink2.staged_transaction_ids(), topic_view(L, topic)

        staged, view = run_both(scenario, tmp_path)
        assert staged == [] and view["committed"] == {0: 0}

    def test_successor_epoch_rolls_lower_epoch_staged_back(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            dead = L.log.LogSink(topic, partitions=1)
            dead.set_attempt_epoch(1)
            dead.write({"k": np.arange(4, dtype=np.int64)})
            dead.prepare_commit(1)
            succ = L.log.LogSink(topic, partitions=1)
            succ.set_attempt_epoch(2)
            return (succ.staged_transaction_ids(),
                    succ._appender.next_offset(0), topic_view(L, topic))

        staged, nxt, _ = run_both(scenario, tmp_path)
        assert staged == [] and nxt == 0

    def test_deposed_abort_cannot_roll_back_successor_staged(
            self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            deposed = L.log.LogSink(topic, partitions=1)
            deposed.set_attempt_epoch(1)
            succ = L.log.LogSink(topic, partitions=1)
            succ.set_attempt_epoch(2)
            succ.write({"k": np.arange(4, dtype=np.int64)})
            succ.prepare_commit(5)
            deposed.abort_uncommitted()
            staged = succ.staged_transaction_ids()
            succ.notify_checkpoint_complete(5)
            assert flat_k(L, topic) == [0, 1, 2, 3]
            return staged, topic_view(L, topic)

        staged, _ = run_both(scenario, tmp_path)
        assert staged == [5]

    def test_vanished_precommit_marker_is_loud(self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            sink = L.log.LogSink(topic, partitions=1)
            sink.write({"k": np.arange(4, dtype=np.int64)})
            sink.prepare_commit(1)
            os.remove(root / "t" / "txn" / "pre-0000000001.json")
            return raised(lambda: sink.notify_checkpoint_complete(1),
                          L.log.LogError, "vanished")

        run_both(scenario, tmp_path)

    def test_deposed_commit_cannot_publish_successor_staged(
            self, tmp_path):
        def scenario(L, root):
            topic = str(root / "t")
            deposed = L.log.LogSink(topic, partitions=1)
            deposed.set_attempt_epoch(1)
            succ = L.log.LogSink(topic, partitions=1)
            succ.set_attempt_epoch(2)
            succ.write({"k": np.arange(4, dtype=np.int64)})
            succ.prepare_commit(5)
            deposed.commit_transaction(5)
            obs = [L.log.describe_topic(topic)["committed_transactions"],
                   succ.staged_transaction_ids()]
            succ.notify_checkpoint_complete(5)
            obs.append(L.log.describe_topic(topic)["committed_transactions"])
            return obs, topic_view(L, topic)

        obs, _ = run_both(scenario, tmp_path)
        assert obs == [[], [5], [5]]


class TestChainedJobs:
    N = 6

    def test_chain_matches_fused_job(self, tmp_path, golden_fused):
        def scenario(L, root):
            topic = str(root / "words")
            env = L.Env(L.Conf({}))
            env.from_source(L.GeneratorSource(word_gen(self.N))).add_sink(
                L.log.LogSink(topic, key_field="word", partitions=2))
            L.execute(env, "log-producer")
            return run_consumer(L, topic), topic_rows(L, topic)

        got, _ = run_both(scenario, tmp_path)
        assert got == golden_fused and got

    def test_chain_with_checkpointed_producer(self, tmp_path, golden_fused):
        """Checkpoints every millisecond commit a timing-dependent number
        of epochs, so the packages are held to the same rows and the
        same offsets, not to the same transactions."""
        def scenario(L, root):
            topic = str(root / "words")
            env = L.Env(L.Conf({
                "execution.checkpointing.dir": str(root / "ckpt"),
                "execution.checkpointing.interval": 1}))
            env.from_source(L.GeneratorSource(word_gen(self.N))).add_sink(
                L.log.LogSink(topic, key_field="word", partitions=2))
            L.execute(env, "log-producer-chk")
            d = L.log.describe_topic(topic)
            assert d["staged_transactions"] == []
            assert len(d["committed_transactions"]) >= 1
            rows = {p: [(c["word"], c["ts_ms"]) for _, _, c in blocks]
                    for p, blocks in topic_rows(L, topic).items()}
            flat = {p: [x for w, t in b for x in zip(w[1], t[1])]
                    for p, b in rows.items()}
            return (run_consumer(L, topic), d["committed_offsets"], flat)

        got, _, _ = run_both(scenario, tmp_path)
        assert got == golden_fused


# -- one package writes, the other reads ------------------------------------------

def kv_topic(L, topic, compact=False, parts=2, txns=3):
    ap = L.topic.TopicAppender(topic, parts, segment_records=8,
                               key_field="k")
    for cid in range(1, txns + 1):
        seq = (cid - 1) * 10 + np.arange(10, dtype=np.int64)
        assert ap.stage(cid, {p: [{
            "k": seq % 5 + 100 * p, "v": seq.astype(np.float32) / 3,
            "w": seq.astype(np.float64) / 7, "ts": seq * 10,
            "tag": np.array([f"r{int(s)}" for s in seq], dtype=object)}]
            for p in range(parts)})
        ap.commit(cid)
    if compact:
        L.bus.ConsumerGroups.commit(
            topic, "g", dict(L.topic.TopicReader(topic).committed_offsets()))
        assert L.bus.Compactor(topic, min_segments=1).compact()["gen"] == 1
    return topic


def concat(batches):
    return {k: np.concatenate([np.asarray(b[k]) for b in batches])
            for k in batches[0]}


def topic_bytes(topic):
    out = {}
    for base, _, files in os.walk(topic):
        for f in sorted(files):
            if f.endswith(".colb"):
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, topic)] = fh.read()
    return out


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compacted"])
@pytest.mark.parametrize("writer,reader", [(LJ, LP), (LP, LJ)],
                         ids=["jax-to-port", "port-to-jax"])
def test_a_topic_one_package_writes_the_other_reads(tmp_path, writer,
                                                    reader, compact):
    """The segments are the same bytes whichever package writes them,
    and the reader sees the writer's own rows, offsets and floors."""
    topic = kv_topic(writer, str(tmp_path / "t"), compact=compact)
    twin = kv_topic(reader, str(tmp_path / "twin"), compact=compact)
    assert topic_bytes(topic) == topic_bytes(twin)
    for zc in (False, True):
        assert topic_rows(reader, topic, zero_copy=zc) == topic_rows(
            writer, topic, zero_copy=zc)
    assert topic_view(reader, topic) == topic_view(writer, topic)
    src = reader.log.LogSource(topic, ts_field="ts", group="g2")
    pos, got = 0, []
    for data, ts in src.open_split("1"):
        pos = src.position_after(pos, data, ts)
        got.append(data)
    want = [b for _, b in writer.topic.TopicReader(topic).read(1)]
    assert cols(concat(got)) == cols(concat(want))
    assert pos == writer.topic.TopicReader(topic).committed_offsets()[1]


@pytest.mark.parametrize("writer,reader", [(LJ, LP), (LP, LJ)],
                         ids=["jax-to-port", "port-to-jax"])
def test_a_topic_on_the_object_store_crosses_packages(tmp_path, writer,
                                                      reader):
    """The same on ``objstore://``: the writer's topic, compacted under
    the CAS-held maintenance lock, reads back whole in the other."""
    back = str(tmp_path / "objstore-backing")
    os.makedirs(back)
    for L in BOTH:
        L.fso.install(inner_prefix=back + "/")
    try:
        topic = kv_topic(writer, "objstore://t", compact=True)
        assert topic_rows(reader, topic) == topic_rows(writer, topic)
        assert topic_view(reader, topic) == topic_view(writer, topic)
        seq = 900 + np.arange(4, dtype=np.int64)
        ap = reader.topic.TopicAppender(topic, 2, segment_records=8)
        assert ap.stage(50, {0: [{
            "k": seq % 5, "v": seq.astype(np.float32), "w": seq / 7.0,
            "ts": seq, "tag": np.array(["x"] * 4, dtype=object)}]})
        ap.commit(50)
        assert topic_rows(writer, topic) == topic_rows(reader, topic)
        assert writer.topic.TopicReader(topic).committed_offsets()[0] == 34
    finally:
        for L in BOTH:
            L.fso.install(inner_prefix="")


def test_a_port_job_consumes_a_reference_topic_through_a_group(
        tmp_path, golden_fused):
    """A job of the port reads a topic the reference produced, commits
    its group's offsets at the final barrier, and a reference consumer
    of the same group then finds nothing left to read."""
    topic = str(tmp_path / "words")
    env = LJ.Env(LJ.Conf({}))
    env.from_source(LJ.GeneratorSource(word_gen(TestChainedJobs.N))).add_sink(
        LJ.log.LogSink(topic, key_field="word", partitions=2))
    LJ.execute(env, "ref-producer")
    sink = LP.sinks.TransactionalCollectSink()
    env = LP.Env(LP.Conf({"state.num-key-shards": 8,
                          "state.slots-per-shard": 64}))
    (env.from_source(LP.log.LogSource(topic, ts_field="ts_ms", group="g"),
                     LP.WM.for_bounded_out_of_orderness(1000))
     .key_by("word").window(LP.Tumbling.of(1000)).count()
     .add_sink(sink))
    res = LP.execute(env, "port-consumer")
    assert committed_view(sink) == golden_fused
    assert res.metrics["records_in"] == 6 * 64
    end = LJ.topic.TopicReader(topic).committed_offsets()
    assert LJ.bus.ConsumerGroups.committed(topic, "g") == end
    rest = LJ.log.LogSource(topic, ts_field="ts_ms", group="g")
    assert all(list(rest.open_split(s)) == [] for s in rest.splits())


def test_a_log_fed_job_asked_for_the_card_without_one_raises(tmp_path):
    """No fallback: without a card, a LogSource-fed job asked for the
    card fails in ``resolve_device`` instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    topic = replay_topic(LP, tmp_path)
    env = LP.Env(LP.Conf({}))
    env.from_source(LP.log.LogSource(topic, ts_field="ts_ms")).add_sink(
        LP.sinks.TransactionalCollectSink())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        env.execute("log-on-cuda")
    assert scrub(LP.log.describe_topic(topic))["groups"] == {}


class TestCliChainSmoke:
    """Two ``flink_tpu_torch run --local`` jobs chained through a log
    topic; the consumer's committed FileSink output is diffed against
    independently computed counts (the reference job's)."""

    def _cli(self, capsys, *argv):
        import json

        from flink_tpu_torch.cli import main as cli_main

        rc = cli_main(list(argv))
        out = capsys.readouterr().out.strip().splitlines()
        return rc, json.loads(out[-1]) if out else {}

    def test_two_local_jobs_chained_through_topic(self, tmp_path, capsys):
        import runner_job_log_chain as ref_jobs
        import test_torch_runner_jobs as jobs

        log_dir = str(tmp_path / "logroot")
        sink_dir = str(tmp_path / "sink")
        n = 5
        rc, out = self._cli(
            capsys, "run", "--local", "--device", "cpu",
            "--entry", "test_torch_runner_jobs:produce",
            "--job-id", "chain-a",
            "--conf", f"log.dir={log_dir}",
            "--conf", "log.partitions=2",
            "--conf", f"test.n-batches={n}")
        assert rc == 0 and out["state"] == "FINISHED"
        assert out["records_in"] == n * ref_jobs.BATCH

        rc, out = self._cli(
            capsys, "run", "--local", "--device", "cpu",
            "--entry", "test_torch_runner_jobs:consume",
            "--job-id", "chain-b",
            "--conf", f"log.dir={log_dir}",
            "--conf", f"test.sink-dir={sink_dir}",
            "--conf", "state.num-key-shards=8",
            "--conf", "state.slots-per-shard=64")
        assert rc == 0 and out["state"] == "FINISHED"
        assert out["records_in"] == n * ref_jobs.BATCH

        rc, topic_info = self._cli(
            capsys, "log", os.path.join(log_dir, ref_jobs.TOPIC))
        assert rc == 0
        assert topic_info["partitions"] == 2
        assert topic_info["committed_records"] == n * ref_jobs.BATCH
        assert topic_info["staged_transactions"] == []

        got = jobs.read_committed_counts(sink_dir)
        assert got == ref_jobs.expected_counts(n) and len(got) > 0
