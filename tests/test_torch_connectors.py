"""The port's formats and file connectors (``flink_tpu_torch/formats.py``,
``connectors.py``) against the JAX package's, case by case of
``tests/test_connectors.py``: each case runs in both packages on the
same seeded input, and the bytes written, the batches read back, the
part names and the committed rows must agree (a part name carries the
checkpoint id, so a bounded run's final epoch, a millisecond time, is
compared by its rows). Cross-package cases: CSV, JSON lines and columnar
parts, committed and staged, written by either package are read by the
other's ``FileSink`` and ``FileSource``."""
import os

import numpy as np
import pytest

from test_torch_file_pkgs import BOTH, J, P
from test_torch_threads import capped_torch_threads  # noqa: F401


def _cols(b):
    return {k: (np.asarray(v).dtype.str, np.asarray(v).tolist())
            for k, v in b.items()}


def _both(fn):
    got = {M.name: fn(M) for M in BOTH}
    assert got["port"] == got["jax"]
    return got["port"]


def _csv(M, schema):
    return M.formats.CsvFormat(schema)


# -- formats -------------------------------------------------------------------

def test_csv_i64_roundtrip_native():
    batch = {"a": np.array([1, -2, 3], np.int64),
             "b": np.array([10, 20, 30], np.int64)}

    def case(M):
        f = _csv(M, [("a", "i64"), ("b", "i64")])
        data = f.serialize(batch)
        assert _cols(f.deserialize(data)) == _cols(batch)
        return data
    assert _both(case) == b"1,10\n-2,20\n3,30\n"


def test_csv_f32_and_mixed():
    batch = {"x": np.array([1.5, 2.25], np.float32),
             "y": np.array([-0.5, 3.0], np.float32)}

    def case(M):
        f = _csv(M, [("x", "f32"), ("y", "f32")])
        data = f.serialize(batch)
        back = f.deserialize(data)
        m = _csv(M, [("k", "i64"), ("name", "str"), ("v", "f32")])
        mixed = m.deserialize(b"7,alpha,1.5\n8,beta,2.5\n")
        assert mixed["name"].tolist() == ["alpha", "beta"]
        return data, _cols(back), _cols(mixed), m.serialize(mixed)
    _both(case)


def test_csv_bad_type_rejected():
    for M in BOTH:
        with pytest.raises(ValueError, match="unknown column type"):
            _csv(M, [("a", "u8")])


def test_jsonlines_roundtrip_and_missing_keys():
    batch = {"k": np.array([1, 2], np.int64),
             "v": np.array([0.5, 1.5], np.float32),
             "s": np.array(["x", "y"], dtype=object)}

    def case(M):
        f = M.formats.JsonLinesFormat([("k", "i64"), ("v", "f32"),
                                       ("s", "str")])
        data = f.serialize(batch)
        sparse = f.deserialize(b'{"k": 9}\n')
        assert sparse["v"].tolist() == [0.0]
        return data, _cols(f.deserialize(data)), _cols(sparse)
    _both(case)


@pytest.mark.parametrize("seed", [0, 1])
def test_csv_random_tables_equal_bytes(seed):
    """Random all-i64 and mixed tables: both packages render the same
    bytes and parse them back to the same columns."""
    rng = np.random.default_rng(seed)
    n = 500
    ints = {"a": rng.integers(-2 ** 62, 2 ** 62, n).astype(np.int64),
            "b": rng.integers(0, 10, n).astype(np.int64)}
    mixed = {"a": ints["a"], "s": np.array(
        [f"w{i}" for i in rng.integers(0, 50, n)], dtype=object)}

    def case(M):
        fi = _csv(M, [("a", "i64"), ("b", "i64")])
        fm = _csv(M, [("a", "i64"), ("s", "str")], )
        di, dm = fi.serialize(ints), fm.serialize(mixed)
        return di, dm, _cols(fi.deserialize(di)), _cols(fm.deserialize(dm))
    _both(case)


# -- FileSource ----------------------------------------------------------------

def _write_rows(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")


def _read_split(src, split, start=0):
    return [(_cols(d), t.tolist()) for d, t in src.open_split(split, start)]


def test_file_source_glob_splits_and_event_time(tmp_path):
    _write_rows(tmp_path / "a.csv", [(1, 100), (2, 200)])
    _write_rows(tmp_path / "b.csv", [(3, 300)])

    def case(M):
        src = M.connectors.FileSource(
            str(tmp_path / "*.csv"), _csv(M, [("k", "i64"), ("ts", "i64")]),
            ts_field="ts")
        splits = src.splits()
        return ([os.path.basename(s) for s in splits],
                [_read_split(src, s) for s in splits])
    names, batches = _both(case)
    assert names == ["a.csv", "b.csv"]
    assert batches[0][0][1] == [100, 200]


def test_file_source_replay_position_skips_consumed_batches(tmp_path):
    _write_rows(tmp_path / "x.csv", [(i, i * 10) for i in range(10)])
    path = str(tmp_path / "x.csv")

    def case(M):
        src = M.connectors.FileSource(
            path, _csv(M, [("k", "i64"), ("ts", "i64")]), ts_field="ts",
            batch_size=4)
        return _read_split(src, path), _read_split(src, path, 2)
    whole, resumed = _both(case)
    assert [len(t) for _, t in whole] == [4, 4, 2]
    assert len(resumed) == 1 and resumed[0][0]["k"][1] == [8, 9]


def test_file_source_directory(tmp_path):
    d = tmp_path / "input"
    d.mkdir()
    _write_rows(d / "0001", [(5, 1)])
    (d / ".hidden").write_text("9,9\n")

    def case(M):
        src = M.connectors.FileSource(str(d), _csv(M, [("k", "i64"),
                                                       ("ts", "i64")]))
        return [os.path.basename(s) for s in src.splits()]
    assert _both(case) == ["0001"]


def test_file_source_columnar_blocks_and_replay(tmp_path):
    """A binary format's batches are its stored blocks, and a replay
    position skips whole blocks."""
    schema = (("k", "i64"), ("ts", "i64"))
    path = str(tmp_path / "x.colb")
    with open(path, "wb") as f:
        w = P.columnar.ColumnarWriter(f, schema)
        for i in range(3):
            w.write_batch({"k": np.arange(i * 5, i * 5 + 5),
                           "ts": np.arange(5) + 100 * i})
        w.close()

    def case(M):
        src = M.connectors.FileSource(path, M.columnar.ColumnarFormat(schema),
                                      ts_field="ts")
        return _read_split(src, path), _read_split(src, path, 2)
    whole, resumed = _both(case)
    assert len(whole) == 3 and resumed == whole[2:]


# -- FileSink ------------------------------------------------------------------

def _tree(d):
    """Each subdirectory's files with their bytes."""
    return {sub: {n: open(os.path.join(d, sub, n), "rb").read()
                  for n in sorted(os.listdir(os.path.join(d, sub)))}
            for sub in ("staged", "committed")}


def test_file_sink_rolling_parts_and_commit(tmp_path):
    def case(M):
        d = str(tmp_path / M.name)
        sink = M.connectors.FileSink(d, _csv(M, [("k", "i64"), ("c", "i64")]),
                                     rolling_records=2)
        sink.write({"k": np.arange(5, dtype=np.int64),
                    "c": np.arange(5, dtype=np.int64) * 10})
        sink.prepare_commit(1)
        staged = _tree(d)
        assert len(staged["staged"]) == 3 and not staged["committed"]
        sink.notify_checkpoint_complete(1)
        return staged, _tree(d), [_cols(b) for b in sink.committed_batches()]
    staged, done, rows = _both(case)
    assert done["staged"] == {} and len(done["committed"]) == 3


def test_file_sink_abort_discards_staged(tmp_path):
    def case(M):
        d = str(tmp_path / M.name)
        sink = M.connectors.FileSink(d, _csv(M, [("k", "i64")]))
        sink.write({"k": np.array([1, 2], np.int64)})
        sink.prepare_commit(1)
        sink.abort_uncommitted()
        sink.notify_checkpoint_complete(1)
        return _tree(d), sink.committed_batches()
    assert _both(case) == ({"staged": {}, "committed": {}}, [])


def test_file_sink_deposed_attempt_cannot_clobber_committed_part(tmp_path):
    def case(M):
        d = str(tmp_path / M.name)
        f = _csv(M, [("k", "i64")])
        deposed = M.connectors.FileSink(d, f)
        deposed.set_attempt_epoch(1)
        deposed.write({"k": np.array([1, 2], np.int64)})
        deposed.prepare_commit(1)
        succ = M.connectors.FileSink(d, f)
        succ.set_attempt_epoch(2)
        succ.write({"k": np.array([1, 2], np.int64)})
        succ.prepare_commit(1)
        succ.notify_checkpoint_complete(1)
        first = _tree(d)
        deposed.notify_checkpoint_complete(1)
        return first, _tree(d), [_cols(b) for b in succ.committed_batches()]
    first, after, rows = _both(case)
    assert list(after["committed"]) == ["part-0000000001-0000.e2"]
    assert after["staged"] == {} and len(rows) == 1


def test_file_sink_deposed_abort_cannot_delete_successor_staged(tmp_path):
    def case(M):
        d = str(tmp_path / M.name)
        f = _csv(M, [("k", "i64")])
        deposed = M.connectors.FileSink(d, f)
        deposed.set_attempt_epoch(1)
        succ = M.connectors.FileSink(d, f)
        succ.set_attempt_epoch(2)
        succ.write({"k": np.array([7], np.int64)})
        succ.prepare_commit(3)
        deposed.abort_uncommitted()
        staged = _tree(d)
        succ.notify_checkpoint_complete(3)
        return staged, [_cols(b) for b in succ.committed_batches()]
    staged, rows = _both(case)
    assert list(staged["staged"]) == ["part-0000000003-0000.e2"]
    assert rows[0]["k"][1] == [7]


def test_file_sink_epochless_legacy_part_names_still_read(tmp_path):
    def case(M):
        d = tmp_path / M.name
        sink = M.connectors.FileSink(str(d), _csv(M, [("k", "i64")]))
        (d / "committed" / "part-0000000001-0000").write_text("5\n")
        (d / "committed" / "part-0000000001-0001.e3").write_text("6\n")
        (d / "committed" / "part-0000000001-0001.e1").write_text("0\n")
        (d / "committed" / "part-junk").write_text("0\n")
        return [_cols(b) for b in sink.committed_batches()]
    rows = _both(case)
    assert [r["k"][1] for r in rows] == [[5], [6]]


def test_file_sink_snapshot_restore_reconstructs_staged(tmp_path):
    def case(M):
        d = str(tmp_path / M.name)
        f = _csv(M, [("k", "i64")])
        sink = M.connectors.FileSink(d, f)
        sink.write({"k": np.array([7], np.int64)})
        sink.prepare_commit(3)
        snap = sink.snapshot_staged()
        sink.abort_uncommitted()
        sink2 = M.connectors.FileSink(d, f)
        sink2.restore_staged(snap, 3)
        sink2.notify_checkpoint_complete(3)
        return snap, _tree(d)
    snap, tree = _both(case)
    assert list(tree["committed"]) == ["part-0000000003-0000.e0"]


# -- end to end ----------------------------------------------------------------

def _committed_lines(d):
    out = []
    for name in sorted(os.listdir(os.path.join(d, "committed"))):
        with open(os.path.join(d, "committed", name), "rb") as f:
            out.extend(f.read().splitlines())
    return sorted(out)


def test_csv_in_window_csv_out(tmp_path):
    rng = np.random.default_rng(0)
    n = 5000
    ts = np.sort(rng.integers(0, 10_000, n))
    keys = rng.integers(0, 8, n)
    inp = tmp_path / "in.csv"
    _write_rows(inp, zip(keys, ts))

    def case(M):
        env = M.Env(M.Conf({"state.num-key-shards": 8,
                            "state.slots-per-shard": 16}))
        src = M.connectors.FileSource(
            str(inp), _csv(M, [("k", "i64"), ("ts", "i64")]), ts_field="ts",
            batch_size=1000)
        d = str(tmp_path / f"out-{M.name}")
        sink = M.connectors.FileSink(d, _csv(M, [
            ("key", "i64"), ("window_end", "i64"), ("count", "i64")]))
        (env.from_source(src, M.WM.for_bounded_out_of_orderness(0))
         .key_by("k").window(M.Tumbling.of(1000)).count().add_sink(sink))
        M.execute(env, "files")
        return _committed_lines(d)
    lines = _both(case)
    golden = {}
    for k, t in zip(keys, ts):
        we = (int(t) // 1000 + 1) * 1000
        golden[(int(k), we)] = golden.get((int(k), we), 0) + 1
    assert sorted(lines) == sorted(f"{k},{e},{c}".encode()
                                   for (k, e), c in golden.items())


def test_exactly_once_across_crash(tmp_path):
    """A flaky source into a ``FileSink`` under supervised recovery: the
    committed parts hold each window once, in both packages alike."""
    def case(M):
        d = str(tmp_path / f"out-{M.name}")
        sink = M.connectors.FileSink(d, _csv(M, [
            ("key", "i64"), ("window_end", "i64"), ("count", "i64")]))
        crashes = {"left": 1}

        def gen(split, i):
            if i >= 6:
                return None
            if i == 4 and crashes["left"] > 0:
                crashes["left"] -= 1
                raise RuntimeError("flaky")
            rng = np.random.default_rng(i)
            return ({"k": rng.integers(0, 4, 64).astype(np.int64)},
                    np.sort(rng.integers(i * 500, i * 500 + 900, 64))
                    .astype(np.int64))

        conf = M.Conf({
            "state.num-key-shards": 4, "state.slots-per-shard": 32,
            "pipeline.microbatch-size": 64,
            "execution.checkpointing.dir": str(tmp_path / f"ckpt-{M.name}"),
            "execution.checkpointing.interval": 1,
            "restart-strategy.type": "fixed-delay",
            "restart-strategy.fixed-delay.attempts": 2,
            "restart-strategy.fixed-delay.delay": 1,
        })

        def build(c):
            env = M.Env(c)
            (env.from_source(M.GeneratorSource(gen),
                             M.WM.for_bounded_out_of_orderness(900))
             .key_by("k").window(M.Tumbling.of(500)).count().add_sink(sink))
            return env

        M.recover(build, conf, "files-recovery")
        got = {}
        for b in sink.committed_batches():
            for k, e, c in zip(b["key"], b["window_end"], b["count"]):
                assert (int(k), int(e)) not in got, "duplicate window"
                got[(int(k), int(e))] = int(c)
        return got
    got = _both(case)
    golden = {}
    for i in range(6):
        rng = np.random.default_rng(i)
        ks = rng.integers(0, 4, 64)
        tss = np.sort(rng.integers(i * 500, i * 500 + 900, 64))
        for k, t in zip(ks, tss):
            we = (int(t) // 500 + 1) * 500
            golden[(int(k), we)] = golden.get((int(k), we), 0) + 1
    assert got == golden


# -- across the packages -------------------------------------------------------

SCHEMA = (("k", "i64"), ("v", "f32"), ("s", "str"))


def _formats(M):
    return {"csv": M.formats.CsvFormat(SCHEMA),
            "csv_i64": M.formats.CsvFormat((("k", "i64"), ("t", "i64"))),
            "jsonl": M.formats.JsonLinesFormat(SCHEMA),
            "columnar": M.columnar.ColumnarFormat(SCHEMA)}


def _rows(fmt_name, n, seed):
    rng = np.random.default_rng(seed)
    if fmt_name == "csv_i64":
        return {"k": rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int64),
                "t": rng.integers(0, 10 ** 6, n).astype(np.int64)}
    return {"k": rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int64),
            "v": (rng.integers(-1000, 1000, n) / 8).astype(np.float32),
            "s": np.array([f"s{i}" for i in rng.integers(0, 40, n)],
                          dtype=object)}


@pytest.mark.parametrize("fmt_name", ["csv", "csv_i64", "jsonl", "columnar"])
@pytest.mark.parametrize("writer,reader", [(P, J), (J, P)],
                         ids=["port-to-jax", "jax-to-port"])
def test_parts_read_across_packages(fmt_name, writer, reader, tmp_path):
    """Parts one package's ``FileSink`` stages and commits are equal in
    bytes to the other's, read back by the other's sink (committed) and
    ``FileSource`` (committed directory), and its staged parts commit
    through the other's sink."""
    data = [_rows(fmt_name, n, s) for s, n in ((1, 7), (2, 5))]
    trees = {}
    for M in (writer, reader):
        d = str(tmp_path / f"{M.name}")
        sink = M.connectors.FileSink(d, _formats(M)[fmt_name],
                                     rolling_records=4)
        for cid, b in enumerate(data, 1):
            sink.write(b)
            sink.prepare_commit(cid)
        trees[M.name] = _tree(d)
        sink.notify_checkpoint_complete(1)  # epoch 2 stays staged
    assert trees[writer.name] == trees[reader.name]
    wd = str(tmp_path / writer.name)
    other = reader.connectors.FileSink(wd, _formats(reader)[fmt_name],
                                       rolling_records=4)
    want = [_cols({k: v[lo:lo + 4] for k, v in data[0].items()})
            for lo in (0, 4)]
    assert [_cols(b) for b in other.committed_batches()] == want
    other.notify_checkpoint_complete(2)  # commits the writer's staged parts
    want += [_cols({k: v[lo:lo + 4] for k, v in data[1].items()})
             for lo in (0, 4)]
    assert [_cols(b) for b in other.committed_batches()] == want
    src = reader.connectors.FileSource(os.path.join(wd, "committed"),
                                       _formats(reader)[fmt_name],
                                       batch_size=4)
    got = [_cols(d) for s in src.splits() for d, _ in src.open_split(s)]
    assert got == want
