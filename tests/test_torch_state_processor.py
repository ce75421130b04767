"""The state processor (``state_processor.py``: ``SavepointReader``,
``window_keyed_rows``, ``SavepointWriter``, ``load_savepoint``) in the
port, against the JAX package: ``tests/test_state_processor.py``'s
cases, each on a checkpoint the port wrote, read by both packages'
readers; savepoints the port's writer wrote restore in both packages'
jobs, and the reference's writer's in the port's.

Rows are integer keys and window ends with sums of small integers:
everything compares exactly."""
import os

import numpy as np
import pytest

from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id
from test_torch_threads import capped_torch_threads  # noqa: F401

both = pytest.mark.parametrize("P", BOTH, ids=pkg_id)


def sp(P):
    if P is PORT:
        from flink_tpu_torch import state_processor
    else:
        from flink_tpu import state_processor
    return state_processor


def gen(split, i):
    if i >= 4:
        return None
    rng = np.random.default_rng(i)
    return ({"k": rng.integers(0, 8, 64).astype(np.int64),
             "v": rng.integers(1, 9, 64).astype(np.int64)},
            np.sort(rng.integers(i * 500, i * 500 + 900, 64)).astype(np.int64))


def run_job(P, root, restore_path=None):
    conf = {"state.num-key-shards": 4, "state.slots-per-shard": 32,
            "pipeline.microbatch-size": 64,
            "execution.checkpointing.dir": root,
            "execution.checkpointing.interval": 1}
    if restore_path:
        conf["execution.checkpointing.restore"] = restore_path
    env = P.Env(P.Conf(conf))
    sink = P.sinks.CollectSink()
    (env.from_source(P.GeneratorSource(gen),
                     P.WM.for_bounded_out_of_orderness(400))
     .key_by("k").window(P.Tumbling.of(1_000)).sum("v").add_sink(sink))
    P.execute(env, "sp-job")
    return sorted((int(r["key"]), int(r["window_end"]), float(r["sum_v"]))
                  for r in sink.rows)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's run of the job, with its checkpoints."""
    root = str(tmp_path_factory.mktemp("port"))
    return root, run_job(PORT, root)


def chk(root, which):
    st = PORT.storage.FsCheckpointStorage(root, "sp-job")
    return st.list_complete()[0] if which == "first" else st.latest()


@both
def test_read_operators_and_keyed_rows(P, port_run):
    """Either package's reader over the port's first (mid-stream)
    checkpoint: one window operator, its keyed rows; the latest one's
    end-of-stream positions."""
    root, _ = port_run
    r = sp(P).load_savepoint(chk(root, "first").path)
    (nid,) = r.operator_ids()
    rows = r.window_keyed_rows(nid)
    assert set(rows) == {"key", "ring_pane", "sums", "maxs", "mins",
                         "count"}
    assert len(rows["key"]) > 0 and rows["count"].sum() > 0
    assert set(rows["key"].tolist()) <= set(range(8))
    assert r.checkpoint_id == 1
    assert sp(P).load_savepoint(
        chk(root, "latest").path).source_positions() == {0: {0: 4}}


def test_both_readers_see_the_same_keyed_rows(port_run):
    root, _ = port_run
    path = chk(root, "first").path
    got = []
    for P in BOTH:
        r = sp(P).SavepointReader(path)
        rows = r.window_keyed_rows(r.operator_ids()[0])
        got.append({k: np.asarray(v) for k, v in rows.items()})
    assert sorted(got[0]) == sorted(got[1])
    for k in got[0]:
        assert np.array_equal(got[0][k], got[1][k]), k


@both
def test_non_window_snapshot_rejected(P, port_run):
    root, _ = port_run
    r = sp(P).load_savepoint(chk(root, "latest").path)
    r.payload["operators"]["fake"] = {"x": 1}
    with pytest.raises(ValueError, match="not a window"):
        r.window_keyed_rows("fake")


def rewound(root, include_operators=True):
    """The port's writer: the latest checkpoint with its source positions
    rewound to 0 and its watermarks reset; the savepoint's path."""
    r = sp(PORT).load_savepoint(chk(root, "latest").path)
    return (sp(PORT).SavepointWriter(r)
            .set_source_positions({0: {0: 0}})
            .reset_watermarks(include_operators=include_operators)
            .write(root, "sp-job"))


@both
def test_a_rewind_keeping_state_replays_fully(P, port_run, tmp_path):
    """A savepoint the port wrote, with operator clocks reset, replays
    the whole stream over the retained (purged) state: either package's
    job recomputes every window; with the driver clocks alone reset the
    replay drops as late instead."""
    root, base = port_run
    assert run_job(P, str(tmp_path / "full"), rewound(root)) == base
    short = run_job(P, str(tmp_path / "drv"),
                    rewound(root, include_operators=False))
    assert len(short) < len(base)


@pytest.mark.parametrize("writer,reader", [(PORT, JAX), (PORT, PORT),
                                           (JAX, PORT)],
                         ids=["port-to-jax", "port-to-port",
                              "jax-to-port"])
def test_transform_and_restore(writer, reader, port_run, tmp_path):
    """The bootstrap flow: the writer replaces the window operator's
    state with a fresh operator's, rewinds the positions and resets the
    clocks; the savepoint restores in the reader's job, which recomputes
    the full output."""
    root, base = port_run
    r = sp(writer).load_savepoint(chk(root, "latest").path)
    (nid,) = r.operator_ids()
    fresh = writer.WindowOperator(
        writer.Tumbling.of(1_000), writer.agg.sum_of("v"), num_shards=4,
        slots_per_shard=32, max_out_of_orderness_ms=400, **writer.kw)
    snap = writer.coordinator.materialize_snapshot(fresh.snapshot_state())
    path = (sp(writer).SavepointWriter(r)
            .transform_operator(nid, lambda _: snap)
            .set_source_positions({0: {0: 0}})
            .reset_watermarks()
            .write(str(tmp_path), "sp-job"))
    assert os.path.basename(path).startswith("savepoint-")
    assert run_job(reader, str(tmp_path / "r"), path) == base
