"""Async I/O (``DataStream.async_io``, ``ops/async_io.py``) in the port,
against the JAX package on the same inputs: ``tests/test_async_io.py``'s
cases (ordered and unordered release, capacity backpressure, the
watermark never overtaking a batch in flight, the 1:1 contract, the
user's exception), each on both packages, with a timeout failing the
job, the checkpoint barrier's drain, a crash and resume, and the worker
pool ended with the job.

Sleeps are short (this suite runs beside the reference's wall-clock lint
gate). Rows are integers and f32 sums of small integers: they compare
exactly. A job's row order is not a fact of the async stage in either
package: how many completed batches one watermark pass releases, and so
how a window's fire groups its windows, depends on when the lookups
return. Job rows therefore compare as sorted lists (exactly once: no row
lost, none twice); the operator's own release order compares exactly."""
import threading
import time

import numpy as np
import pytest

from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id, row_view
from test_torch_threads import capped_torch_threads  # noqa: F401

both = pytest.mark.parametrize("P", BOTH, ids=pkg_id)


def Op(P):
    if P is PORT:
        from flink_tpu_torch.ops.async_io import AsyncIOOperator
    else:
        from flink_tpu.ops.async_io import AsyncIOOperator
    return AsyncIOOperator


def one(i, wm=None):
    return ({"i": np.array([i])}, np.array([i]), np.ones(1, bool))


def async_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("async-io") and t.is_alive()]


# -- the operator ---------------------------------------------------------------

@both
def test_ordered_release(P):
    """Batch 0 is the slowest; ordered mode still releases 0, 1, 2."""
    def slow_first(data, ts):
        time.sleep(0.1 if data["i"][0] == 0 else 0.005)
        return dict(data)

    op = Op(P)(slow_first, capacity=4, ordered=True)
    for i in range(3):
        op.submit(one(i), i)
    assert [int(b[0]["i"][0]) for b in op.poll(drain=True)] == [0, 1, 2]
    op.close()


@both
def test_unordered_release_as_completed_and_the_watermark_held(P):
    """Unordered mode releases batches 1 and 2 while batch 0 blocks, and
    the released watermark stays at batch 0's submit (it never
    overtakes a batch in flight); the drain then releases batch 0 and
    the input watermark."""
    ev = threading.Event()

    def blocky(data, ts):
        if data["i"][0] == 0:
            ev.wait(5)
        return dict(data)

    op = Op(P)(blocky, capacity=4, ordered=False)
    for i in range(3):
        op.submit(one(i), i * 10)
    op.note_watermark(25)
    deadline = time.time() + 5
    got = []
    while len(got) < 2 and time.time() < deadline:
        got += op.poll()
        time.sleep(0.005)
    assert sorted(int(b[0]["i"][0]) for b in got) == [1, 2]
    assert op.watermark == 0 and op.pending == 1
    ev.set()
    got += op.poll(drain=True)
    assert sorted(int(b[0]["i"][0]) for b in got) == [0, 1, 2]
    assert op.watermark == 25 and op.pending == 0
    op.close()


@both
def test_ordered_watermark_waits_for_the_head(P):
    """Ordered mode: a completed batch behind a pending head is held,
    and so is the watermark, at the head's submit."""
    ev = threading.Event()

    def gate_first(data, ts):
        if data["i"][0] == 0:
            ev.wait(5)
        return dict(data)

    op = Op(P)(gate_first, capacity=4, ordered=True)
    op.submit(one(0), 100)
    op.submit(one(1), 200)
    op.note_watermark(300)
    time.sleep(0.02)
    assert op.poll() == [] and op.watermark == 100
    ev.set()
    assert [int(b[0]["i"][0]) for b in op.poll(drain=True)] == [0, 1]
    assert op.watermark == 300
    op.close()


@both
def test_capacity_backpressure_via_throttle(P):
    """``submit`` never blocks; ``throttle`` blocks while more than
    ``capacity`` batches still run."""
    release = threading.Event()

    def gate(data, ts):
        release.wait(10)
        return dict(data)

    op = Op(P)(gate, capacity=2, ordered=True, workers=4)
    t0 = time.time()
    for i in range(3):
        op.submit(one(i), i)
    assert time.time() - t0 < 0.1  # submits do not block
    timer = threading.Timer(0.1, release.set)
    timer.start()
    op.throttle()  # 3 running > capacity 2: waits for the release
    assert time.time() - t0 >= 0.09
    op.poll(drain=True)
    op.close()
    timer.join()


@both
def test_length_change_rejected(P):
    op = Op(P)(lambda d, ts: {"x": np.zeros(3)}, capacity=2)
    op.submit(({"x": np.zeros(2)}, np.zeros(2, np.int64),
               np.ones(2, bool)), 0)
    with pytest.raises(ValueError, match="1:1"):
        op.poll(drain=True)
    op.close()


@both
def test_user_exception_propagates(P):
    def boom(data, ts):
        raise RuntimeError("lookup failed")

    op = Op(P)(boom, capacity=2)
    op.submit(({"x": np.zeros(1)}, np.zeros(1, np.int64),
               np.ones(1, bool)), 0)
    with pytest.raises(RuntimeError, match="lookup failed"):
        op.poll(drain=True)
    op.close()


@both
def test_timeout_raises(P):
    op = Op(P)(lambda d, ts: (time.sleep(0.2), dict(d))[1], capacity=1,
               timeout_ms=20)
    op.submit(one(0), 0)
    with pytest.raises(TimeoutError, match="timeout"):
        op.poll(drain=True)
    op.close()


def test_close_leaves_no_worker_thread():
    """The port's close cancels what has not started, waits for what
    runs within its timeout, and joins the pool's threads."""
    before = set(async_threads())
    op = Op(PORT)(lambda d, ts: (time.sleep(0.02), dict(d))[1], capacity=2)
    for i in range(6):
        op.submit(one(i), i)
    assert set(async_threads()) - before
    op.close()
    assert not set(async_threads()) - before and op.pending == 0


# -- jobs -------------------------------------------------------------------------

def source(n_batches=6, b=64):
    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng(i)
        return ({"k": rng.integers(0, 10, b).astype(np.int64),
                 "x": np.full(b, i, np.int64)},
                np.sort(rng.integers(i * 500, i * 500 + 900, b)
                        ).astype(np.int64))
    return gen


CONF = {"pipeline.microbatch-size": 64, "state.num-key-shards": 4,
        "state.slots-per-shard": 32}


def enrich_job(P, mode, sink=None, conf=None, fn=None, ordered=True,
               capacity=3):
    """``source()`` enriched with v = 10x + 1 (``mode`` 'async': through
    ``async_io``, else a map) into a keyed 1 s tumbling sum of v."""
    def enrich(data, ts):
        time.sleep(0.002 * (1 + int(data["x"][0]) % 3))
        return {**dict(data), "v": data["x"] * 10 + 1}

    env = P.Env(P.Conf(dict(CONF, **(conf or {}))))
    s = env.from_source(P.GeneratorSource(source()),
                        P.WM.for_bounded_out_of_orderness(500))
    if mode == "async":
        s = s.async_io(fn or enrich, capacity=capacity, ordered=ordered)
    else:
        s = s.map(lambda d: {**d, "v": d["x"] * 10 + 1})
    sink = sink if sink is not None else P.sinks.CollectSink()
    (s.key_by("k").window(P.Tumbling.of(1_000)).sum("v").add_sink(sink))
    res = P.execute(env, f"async-{mode}")
    return sink, res


def rows_of(sink):
    return [(int(r["key"]), int(r["window_end"]), float(r["sum_v"]))
            for r in sink.rows]


@pytest.fixture(scope="module")
def sync_rows():
    return {P.name: rows_of(enrich_job(P, "map")[0]) for P in BOTH}


@pytest.mark.parametrize("ordered", [True, False], ids=["ordered",
                                                         "unordered"])
def test_enrichment_into_window(sync_rows, ordered):
    """The enriched field feeds a keyed window: the rows equal the
    synchronous map's in both packages and the reference's async run's,
    and no record is late."""
    got = {}
    for P in BOTH:
        sink, res = enrich_job(P, "async", ordered=ordered)
        assert res.metrics.get("late_records", 0) == 0
        got[P.name] = rows_of(sink)
    assert sorted(got["port"]) == sorted(sync_rows["port"]) \
        == sorted(sync_rows["jax"]) == sorted(got["jax"])
    assert got["port"]


@both
def test_a_timeout_fails_the_job(P):
    """A lookup slower than ``timeout_ms`` fails the job with a
    TimeoutError (the reference's default). The port's job is not held
    by the lookup past its timeout, and leaves no async worker thread
    behind once that lookup returns."""
    before = set(async_threads())

    def slow(data, ts):
        time.sleep(0.3)
        return dict(data)

    env = P.Env(P.Conf(CONF))
    (env.from_source(P.GeneratorSource(source(2)),
                     P.WM.for_bounded_out_of_orderness(500))
     .async_io(slow, capacity=1, timeout_ms=30)
     .add_sink(P.sinks.CollectSink()))
    with pytest.raises(TimeoutError, match="timeout"):
        P.execute(env, "async-timeout")
    if P is PORT:
        for t in set(async_threads()) - before:
            t.join(5)
        assert not set(async_threads()) - before


def test_a_lookup_that_never_returns_does_not_hold_the_failure():
    """A lookup that blocks far past ``timeout_ms`` (a socket with no
    timeout of its own) fails the job within a bound: closing the
    worker pool does not wait for it. Its thread ends when it returns."""
    before = set(async_threads())
    release = threading.Event()

    def stuck(data, ts):
        release.wait(60)
        return dict(data)

    env = PORT.Env(PORT.Conf(CONF))
    (env.from_source(PORT.GeneratorSource(source(2)),
                     PORT.WM.for_bounded_out_of_orderness(500))
     .async_io(stuck, capacity=1, timeout_ms=50)
     .add_sink(PORT.sinks.CollectSink()))
    t0 = time.monotonic()
    try:
        with pytest.raises(TimeoutError, match="timeout"):
            PORT.execute(env, "async-stuck")
        assert time.monotonic() - t0 < 5
    finally:
        release.set()
        for t in set(async_threads()) - before:
            t.join(5)
    assert not set(async_threads()) - before


def test_the_job_ends_its_worker_pool():
    before = set(async_threads())
    enrich_job(PORT, "async")
    assert not set(async_threads()) - before


@both
def test_checkpoint_barrier_drains_in_flight_batches(P, tmp_path):
    """Checkpoints every pass beside slow lookups: each barrier drains
    the batches in flight downstream before the snapshot (the operator
    snapshots empty, its position covered), and the committed rows equal
    the run without checkpoints."""
    sink = P.sinks.TransactionalCollectSink()
    _, res = enrich_job(P, "async", sink=sink, conf={
        "execution.checkpointing.dir": str(tmp_path),
        "execution.checkpointing.interval": 1,
        "execution.checkpointing.num-retained": 100})
    plain, _ = enrich_job(P, "async")
    assert sorted(row_view(sink.committed)) == sorted(row_view(plain.rows))
    assert sink.committed
    st = P.storage.FsCheckpointStorage(str(tmp_path), "async-async")
    hs = st.list_complete()
    assert len(hs) >= 2
    for h in hs:
        ops = P.storage.FsCheckpointStorage.load(h)["operators"]
        assert {"kind": "async_io"} in list(ops.values())


def cut_job(P, root, restore=""):
    """``enrich_job``'s async form with slow lookups and four in flight:
    a checkpoint taken by ``checkpoint_now`` as the source reaches batch
    3 (or, with ``restore``, a resume). The committed rows."""
    def enrich(data, ts):
        time.sleep(0.01)
        return {**dict(data), "v": data["x"] * 10 + 1}

    sink = P.sinks.TransactionalCollectSink()
    env = P.Env(P.Conf(dict(CONF, **{
        "execution.checkpointing.dir": root,
        "execution.checkpointing.interval": 1 if restore else 10 ** 9,
        "execution.checkpointing.restore": restore,
        "pipeline.source-prefetch": 0})))
    gen = source()
    hit = []

    def hooked(split, i):
        if i == 3 and not restore and not hit:
            hit.append(i)
            env._driver.checkpoint_now()
        return gen(split, i)

    (env.from_source(P.GeneratorSource(hooked),
                     P.WM.for_bounded_out_of_orderness(500))
     .async_io(enrich, capacity=4)
     .key_by("k").window(P.Tumbling.of(1_000)).sum("v").add_sink(sink))
    P.execute(env, "cut")
    return sorted(row_view(sink.committed))


def test_a_resume_from_a_barrier_commits_every_row_once(tmp_path):
    """Lookups slower than the loop leave batches in flight at the cut.
    The barrier pushes them downstream before the sinks stage their
    epoch, so checkpoint 1 (positions at batch 3) holds every record its
    positions cover: each package's resume from either package's
    checkpoint commits the uninterrupted run's rows, once each."""
    full, paths = {}, {}
    for P in BOTH:
        root = str(tmp_path / P.name)
        full[P.name] = cut_job(P, root)
        (h, *_) = P.storage.FsCheckpointStorage(root, "cut").list_complete()
        payload = P.storage.FsCheckpointStorage.load(h)
        assert [p for pos in payload["sources"].values()
                for p in pos.values()] == [3]
        paths[P.name] = h.path
    assert full["port"] == full["jax"] and full["port"]
    for reader in BOTH:
        for writer, path in paths.items():
            got = cut_job(reader, str(tmp_path / f"{reader.name}-{writer}"),
                          restore=path)
            assert got == full["port"], (reader.name, writer)


@both
def test_crash_and_resume_commits_the_fault_free_rows(P, tmp_path):
    """A poisoned sink fails the first attempt mid-stream; the
    supervisor resumes from the last checkpoint, and the committed rows
    are the fault-free run's."""
    class PoisonOnce(P.sinks.TransactionalCollectSink):
        fired = False

        def write(self, batch):
            super().write(batch)
            if not self.fired and len(self._pending) >= 8:
                self.fired = True
                raise RuntimeError("poisoned sink")

    def enrich(data, ts):
        time.sleep(0.002)
        return {**dict(data), "v": data["x"] * 10 + 1}

    def builder(sink):
        def build(conf):
            env = P.Env(conf)
            (env.from_source(P.GeneratorSource(source(8)),
                             P.WM.for_bounded_out_of_orderness(500))
             .async_io(enrich, capacity=3)
             .key_by("k").window(P.Tumbling.of(1_000)).sum("v")
             .add_sink(sink))
            return env
        return build

    def conf(root):
        return P.Conf(dict(CONF, **{
            "execution.checkpointing.dir": root,
            "execution.checkpointing.interval": 1,
            "restart-strategy.type": "fixed-delay",
            "restart-strategy.fixed-delay.attempts": 3,
            "restart-strategy.fixed-delay.delay": 1}))

    poisoned = PoisonOnce()
    P.recover(builder(poisoned), conf(str(tmp_path / "crash")), "crash")
    assert poisoned.fired
    clean = P.sinks.TransactionalCollectSink()
    P.execute(builder(clean)(conf(str(tmp_path / "clean"))), "clean")
    assert sorted(row_view(poisoned.committed)) == \
        sorted(row_view(clean.committed))
    assert clean.committed
