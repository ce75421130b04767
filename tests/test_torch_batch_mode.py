"""The port's batch mode (``execution.runtime-mode: batch``) against the
JAX package's, case by case of ``tests/test_batch_mode.py``: stage
planning and the wave scheduler, the refusals, WordCount's committed
output in both modes, a three-wave job, the hash-partitioned shuffle and
the columnar file round trip, each compared with the reference's run of
the same job on the same seeded words (``batch_waves`` and the shuffle's
row count too). Cross-package: the blocking shuffle's partition files
are equal in bytes and each package reads the other's, and committed
columnar parts of either package's batch job feed the other's.

``TestGoldenParity``'s parity is ported, its timing assertion is not:
whether batch mode beats streaming is measured on the card, in
``chip_smoke.py``'s ``batch`` phase. The jobs run at 40–60 batches
where the reference runs 300, and the reference's runs are shared
between cases. ``TestCliSmoke`` runs the bounded WordCount through
``python -m flink_tpu_torch run --local --runtime-mode batch`` on the
CPU and holds its committed columnar total to the reference job's
golden."""
import os
import re
import threading

import numpy as np
import pytest

from test_torch_file_pkgs import BOTH, J, P
from test_torch_threads import capped_torch_threads  # noqa: F401

BATCH, VOCAB = 128, 64
N_GOLDEN = 40
OUT_SCHEMA = (("key", "i64"), ("window_end", "i64"), ("count", "i64"))


def word_batch(i, n_batches):
    if i >= n_batches:
        return None
    rng = np.random.default_rng(i)
    words = (rng.random(BATCH) ** 2 * VOCAB).astype(np.int64)
    ts = (i * BATCH + np.arange(BATCH, dtype=np.int64)) * 10
    return {"word": words}, ts


def make_env(M, mode, tmp_path=None, **conf):
    base = {"state.num-key-shards": 8, "state.slots-per-shard": 64,
            "pipeline.microbatch-size": BATCH,
            "execution.runtime-mode": mode}
    if tmp_path is not None:
        base["execution.batch.shuffle-dir"] = str(tmp_path / "shuffle")
    base.update(conf)
    return M.Env(M.Conf(base))


def build_wordcount(M, env, sink, n_batches=N_GOLDEN, **src_kw):
    (env.from_source(M.GeneratorSource(
        lambda split, i: word_batch(i, n_batches), **src_kw),
        M.WM.for_bounded_out_of_orderness(0))
        .key_by("word").window(M.Tumbling.of(1000)).count().add_sink(sink))
    return env


def _null(M):
    return M.sinks.FnSink(lambda b: None)


def _plan_shape(plan):
    kinds = {nid: n.kind for nid, n in plan.nodes.items()}
    return (plan.runtime_mode,
            sorted((kinds[n], s) for n, s in plan.stage_of.items()),
            sorted((kinds[u], kinds[v]) for u, v in plan.blocking_edges))


# -- stage planning ------------------------------------------------------------

def test_batch_plan_levels_and_blocking_edges():
    shapes = {}
    for M in BOTH:
        plan = build_wordcount(M, make_env(M, "batch"), _null(M)).compile_plan()
        (win,) = [n.id for n in plan.nodes.values() if n.kind == "window"]
        (src,) = plan.sources
        (sink,) = [n.id for n in plan.nodes.values() if n.kind == "sink"]
        assert all(v == win for _, v in plan.blocking_edges)
        assert (plan.stage_of[src], plan.stage_of[win],
                plan.stage_of[sink]) == (0, 1, 1)
        shapes[M.name] = _plan_shape(plan)
    assert shapes["port"] == shapes["jax"]


def test_streaming_plan_has_no_stages():
    for M in BOTH:
        plan = build_wordcount(M, make_env(M, "streaming"),
                               _null(M)).compile_plan()
        assert plan.runtime_mode == "streaming"
        assert plan.stage_of == {} and plan.blocking_edges == []


def test_scheduler_waves():
    snaps = {}
    for M in BOTH:
        sched = M.scheduler.BatchStageScheduler(build_wordcount(
            M, make_env(M, "batch"), _null(M)).compile_plan())
        assert len(sched.waves) == 2
        assert sched.waves[0].in_edges == []
        assert len(sched.waves[1].in_edges) == 1
        snaps[M.name] = sched.snapshot()
    assert snaps["port"] == snaps["jax"]
    assert [w["state"] for w in snaps["port"]["waves"]] == ["CREATED"] * 2


# -- refusals ------------------------------------------------------------------

def _refused_alike(run, exc, match):
    msgs = {}
    for M in BOTH:
        with pytest.raises(exc, match=match) as ei:
            run(M)
        msgs[M.name] = str(ei.value)
    assert msgs["port"] == msgs["jax"]


def test_unbounded_source_rejected():
    _refused_alike(lambda M: build_wordcount(
        M, make_env(M, "batch"), _null(M), is_bounded=False).compile_plan(),
        ValueError, "bounded")


def test_unknown_mode_rejected():
    _refused_alike(lambda M: build_wordcount(
        M, make_env(M, "BATCHY"), _null(M)).compile_plan(),
        ValueError, "runtime-mode")


def test_checkpoint_interval_rejected(tmp_path):
    _refused_alike(lambda M: M.execute(build_wordcount(
        M, make_env(M, "batch", **{
            "execution.checkpointing.interval": 100,
            "execution.checkpointing.dir": str(tmp_path)}),
        _null(M), n_batches=2), "batch-ckpt"), ValueError, "incompatible")


def test_explicit_restore_path_rejected(tmp_path):
    _refused_alike(lambda M: M.execute(build_wordcount(
        M, make_env(M, "batch", **{
            "execution.checkpointing.restore": str(tmp_path / "x"),
            "execution.checkpointing.dir": str(tmp_path)}),
        _null(M), n_batches=2), "batch-restore"), ValueError, "incompatible")


def test_recovery_injected_restore_latest_degrades_to_rerun(tmp_path):
    got = {}
    for M in BOTH:
        rows = []
        env = build_wordcount(
            M, make_env(M, "batch", tmp_path, **{
                "execution.checkpointing.restore": "latest",
                "execution.checkpointing.dir": str(tmp_path / M.name)}),
            M.sinks.FnSink(lambda b: rows.extend(
                zip(*(np.asarray(b[c]).tolist()
                      for c in ("key", "window_end", "count"))))),
            n_batches=4)
        res = M.execute(env, "batch-retry")
        assert res.metrics["records_in"] == 4 * BATCH and rows
        got[M.name] = sorted(rows)
    assert got["port"] == got["jax"]


def test_self_join_rejected():
    def run(M):
        env = make_env(M, "batch")
        s = env.from_source(M.GeneratorSource(lambda sp, i: word_batch(i, 2)),
                            M.WM.for_bounded_out_of_orderness(0))
        (s.key_by("word").window(M.Tumbling.of(1000)).count()
         .add_sink(_null(M)))
        (s.join(s).where("word").equal_to("word")
         .window(M.Tumbling.of(1000)).apply().add_sink(_null(M)))
        env.compile_plan()
    _refused_alike(run, NotImplementedError, "same upstream")


def test_armed_savepoint_request_rejected(tmp_path):
    def run(M):
        req = threading.Event()
        req.set()
        M.execute(build_wordcount(M, make_env(M, "batch", tmp_path), _null(M),
                                  n_batches=2), "batch-sp",
                  savepoint_request=req)
    _refused_alike(run, ValueError, "savepoint")


def test_cross_process_rejected(tmp_path):
    _refused_alike(lambda M: M.execute(build_wordcount(
        M, make_env(M, "batch", tmp_path, **{"cluster.num-processes": 2,
                                   "cluster.process-id": 0}),
        _null(M), n_batches=2), "batch-dcn"),
        NotImplementedError, "single-process")


# -- WordCount in both modes ---------------------------------------------------

def _committed_sorted_bytes(sink_dir):
    lines = []
    committed = os.path.join(sink_dir, "committed")
    for name in sorted(os.listdir(committed)):
        with open(os.path.join(committed, name), "rb") as f:
            lines.extend(f.read().splitlines())
    return b"\n".join(sorted(lines))


def _run_golden(M, mode, root, parts=1):
    d = str(root / f"{M.name}-{mode}-{parts}")
    env = build_wordcount(
        M, make_env(M, mode, root, **{
            "execution.batch.shuffle-partitions": parts}),
        M.connectors.FileSink(d, M.formats.CsvFormat(OUT_SCHEMA)))
    res = M.execute(env, f"wc-{mode}")
    return _committed_sorted_bytes(d), res.metrics


@pytest.fixture(scope="module")
def reference_wordcount(tmp_path_factory):
    """The reference's batch run of the golden WordCount, shared by the
    cases below."""
    return _run_golden(J, "batch", tmp_path_factory.mktemp("ref"))


def test_batch_equals_streaming(reference_wordcount, tmp_path):
    """Bounded WordCount into a CSV ``FileSink``: the port's committed
    lines in batch and streaming mode equal each other and the
    reference's batch run; the batch run reports two waves and spools
    every word."""
    ref_out, ref_m = reference_wordcount
    out_s, m_s = _run_golden(P, "streaming", tmp_path)
    out_b, m_b = _run_golden(P, "batch", tmp_path)
    assert out_b == out_s == ref_out and len(out_b) > 0
    assert (m_b["records_in"] == m_s["records_in"] == ref_m["records_in"]
            == N_GOLDEN * BATCH)
    assert m_b["batch_waves"] == ref_m["batch_waves"] == 2
    assert (m_b["shuffle_rows_spooled"] == ref_m["shuffle_rows_spooled"]
            == N_GOLDEN * BATCH)
    assert m_b["shuffle_bytes_spooled"] == ref_m["shuffle_bytes_spooled"]


def test_hash_partitioned_edge_matches_single_partition(
        reference_wordcount, tmp_path):
    """``execution.batch.shuffle-partitions`` 4: rows hash-route by key
    into disjoint partition files; the output is the reference's single
    partition's, and every word is spooled. (The reference's own run at
    4 partitions compiles a program a partition block's length; its
    partition files are compared byte for byte below.)"""
    ref_out, ref_m = reference_wordcount
    out4, m4 = _run_golden(P, "batch", tmp_path, parts=4)
    assert out4 == ref_out
    assert m4["shuffle_rows_spooled"] == ref_m["shuffle_rows_spooled"]
    assert m4["batch_waves"] == 2


def test_three_wave_pipeline_matches_streaming(tmp_path):
    """Words -> 1 s count per word (wave 1) -> 10 s sum of the counts per
    word (wave 2): three waves, the rows of the streaming schedule and
    of the reference's batch run."""
    def run(M, mode):
        rows = []
        env = make_env(M, mode, tmp_path)
        (env.from_source(M.GeneratorSource(lambda s, i: word_batch(i, 60)),
                         M.WM.for_bounded_out_of_orderness(0))
         .key_by("word").window(M.Tumbling.of(1000)).count()
         .key_by("key").window(M.Tumbling.of(10_000)).sum("count")
         .add_sink(M.sinks.FnSink(lambda b: rows.extend(
             zip(*(np.asarray(b[c]).tolist() for c in sorted(b)))))))
        res = M.execute(env, f"ms-{mode}")
        return res, sorted(rows)

    res_j, rows_j = run(J, "batch")
    res_b, rows_b = run(P, "batch")
    _, rows_s = run(P, "streaming")
    assert rows_b == rows_s == rows_j and rows_b
    assert res_b.metrics["batch_waves"] == res_j.metrics["batch_waves"] == 3
    assert (res_b.metrics["shuffle_rows_spooled"]
            == res_j.metrics["shuffle_rows_spooled"])


# -- the columnar connectors ---------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(P, P), (J, P), (P, J)],
                         ids=["port", "jax-to-port", "port-to-jax"])
def test_file_sink_to_file_source_round_trip(writer, reader, tmp_path):
    """A batch WordCount commits columnar parts; a second batch job, of
    the same or the other package, reads them back through
    ``FileSource`` and sums the counts to every word; a reader of
    another schema fails loudly."""
    d = str(tmp_path / "colb")
    env = build_wordcount(writer, make_env(writer, "batch", tmp_path),
                          writer.connectors.FileSink(
                              d, writer.columnar.ColumnarFormat(OUT_SCHEMA)))
    writer.execute(env, "wc-colb")

    total = [0]
    fmt = reader.columnar.ColumnarFormat(OUT_SCHEMA)
    env2 = make_env(reader, "batch", tmp_path)
    (env2.from_source(reader.connectors.FileSource(
        os.path.join(d, "committed"), fmt, ts_field="window_end"))
     .key_by("key").window(reader.Tumbling.of(3600_000)).sum("count")
     .add_sink(reader.sinks.FnSink(lambda b: total.__setitem__(
         0, total[0] + int(np.sum(b["sum_count"]))))))
    reader.execute(env2, "wc-colb-read")
    assert total[0] == N_GOLDEN * BATCH

    bad = reader.columnar.ColumnarFormat((("key", "i64"),
                                          ("window_end", "i64"),
                                          ("count", "f64")))
    env3 = make_env(reader, "batch", tmp_path)
    (env3.from_source(reader.connectors.FileSource(
        os.path.join(d, "committed"), bad, ts_field="window_end"))
     .key_by("key").window(reader.Tumbling.of(3600_000)).sum("count")
     .add_sink(_null(reader)))
    with pytest.raises(reader.columnar.ColumnarError, match="schema mismatch"):
        reader.execute(env3, "wc-colb-bad")


def test_no_pyarrow_or_fastavro_anywhere():
    root = os.path.join(os.path.dirname(__file__), "..", "flink_tpu_torch")
    pat = re.compile(r"^\s*(import|from)\s+(pyarrow|fastavro)\b", re.M)
    hits = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                with open(p, "r", encoding="utf-8") as fh:
                    if pat.search(fh.read()):
                        hits.append(p)
    assert hits == []


# -- the blocking shuffle across the packages ----------------------------------

def _spool(M, root, parts):
    rng = np.random.default_rng(5)
    shuffle = M.blocking.BlockingShuffle(str(root), "job/x", n_partitions=parts,
                                         cleanup=False)
    ew = shuffle.open_edge(0, 3, key_field="k")
    for i in range(4):
        n = 50 + 7 * i
        valid = rng.random(n) > 0.2
        ew.write({"k": rng.integers(0, 30, n).astype(np.int64),
                  "v": rng.random(n).astype(np.float32),
                  "s": np.array([f"x{j}" for j in range(n)], dtype=object)},
                 np.arange(n, dtype=np.int64) + 100 * i, valid)
    ew.seal()
    files = {n: open(os.path.join(ew.dir, n), "rb").read()
             for n in sorted(os.listdir(ew.dir))}
    return shuffle, ew, files


def _replayed(ew):
    return [({k: np.asarray(v).tolist() for k, v in d.items()}, t.tolist())
            for d, t in ew.read()]


@pytest.mark.parametrize("parts", [1, 4])
def test_partition_files_equal_and_read_across_packages(parts, tmp_path):
    """The same batches through each package's ``EdgeWriter``: partition
    files equal byte for byte (the run directory's name carries a random
    part), the same replay, and each package's ``iter_file_blocks``
    reads the other's files."""
    spools = {M.name: _spool(M, tmp_path / M.name, parts) for M in BOTH}
    (sj, ej, fj), (sp, ep, fp) = spools["jax"], spools["port"]
    assert fj == fp and len(fp) == parts
    assert _replayed(ej) == _replayed(ep)
    assert ej.rows == ep.rows and sj.bytes_written == sp.bytes_written
    for reader, ew in ((P, ej), (J, ep)):
        for name in sorted(os.listdir(ew.dir)):
            with open(os.path.join(ew.dir, name), "rb") as f:
                blocks = list(reader.columnar.iter_file_blocks(
                    f, expect_schema=ew._schema))
            assert sum(len(b["k"]) for b in blocks) > 0
    for s in (sj, sp):
        s._cleanup = True
        s.close()
        assert not os.path.exists(s.dir)


# -- no fallback ---------------------------------------------------------------

def test_batch_job_asked_for_the_card_without_one_raises(monkeypatch,
                                                         tmp_path):
    """A batch-mode job defaults to the card: without CUDA it raises and
    nothing runs, nothing is committed, no shuffle is spooled."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "out")
    env = build_wordcount(P, make_env(P, "batch", tmp_path),
                          P.connectors.FileSink(
                              d, P.formats.CsvFormat(OUT_SCHEMA)),
                          n_batches=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        env.execute("batch-cuda")
    assert os.listdir(os.path.join(d, "committed")) == []
    assert not os.path.exists(tmp_path / "shuffle")


def test_csv_without_the_codec_raises(monkeypatch, tmp_path):
    """The CSV format's C parser and encoder come from the host codec: a
    build that fails raises, and nothing parses in Python instead."""
    nc = P.nc
    monkeypatch.setattr(nc, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(nc, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nc, "_lib", None)
    fmt = P.formats.CsvFormat((("a", "i64"), ("b", "i64")))
    with pytest.raises(RuntimeError, match="host codec build failed"):
        fmt.deserialize(b"1,2\n")
    with pytest.raises(RuntimeError, match="host codec build failed"):
        fmt.serialize({"a": np.arange(2), "b": np.arange(2)})
    with pytest.raises(RuntimeError, match="host codec build failed"):
        P.connectors.SocketSource()


CLI_ENV = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
    [os.path.dirname(__file__), os.path.join(os.path.dirname(__file__), ".."),
     os.environ.get("PYTHONPATH", "")]))


def cli_wordcount_total(tmp_path, *extra):
    """``python -m flink_tpu_torch run --local`` of the bounded
    WordCount on the CPU: its JSON line and its committed count total."""
    import json
    import subprocess
    import sys

    from flink_tpu_torch.formats_columnar import ColumnarFormat
    from test_torch_runner_jobs import WC_SCHEMA

    sink_dir = str(tmp_path / "sink")
    proc = subprocess.run(
        [sys.executable, "-m", "flink_tpu_torch", "run", "--local",
         "--device", "cpu", "--entry", "test_torch_runner_jobs:wordcount",
         "--conf", "test.n-batches=6", "--conf", f"test.sink-dir={sink_dir}",
         "--conf", "state.num-key-shards=4",
         "--conf", "state.slots-per-shard=32", *extra],
        capture_output=True, text=True, timeout=240, env=CLI_ENV,
        cwd=os.path.dirname(__file__))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    fmt = ColumnarFormat(WC_SCHEMA)
    total = 0
    committed = os.path.join(sink_dir, "committed")
    for name in sorted(os.listdir(committed)):
        with open(os.path.join(committed, name), "rb") as f:
            total += int(np.sum(fmt.deserialize(f.read())["count"]))
    return out, total


class TestCliSmoke:
    def test_bounded_wordcount_via_cli_batch_mode(self, tmp_path):
        """A bounded WordCount runs end to end through ``python -m
        flink_tpu_torch run --local --runtime-mode batch`` and commits
        columnar output: every word counted once, the reference job's
        golden total."""
        import runner_job_wordcount as job

        out, total = cli_wordcount_total(
            tmp_path, "--runtime-mode", "batch", "--job-id", "cli-batch-wc")
        assert out["state"] == "FINISHED" and out["job_id"] == "cli-batch-wc"
        assert out["records_in"] == 6 * job.BATCH
        assert total == job.golden_total(6)
