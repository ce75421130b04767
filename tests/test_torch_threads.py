"""An autouse fixture for the port's test modules: torch's intra-op
threads capped at 1 while a module runs, and restored after it.

Tier-1 runs six pytest workers on one host, each of whose torch would
otherwise start a thread per core; capped, the workers contend less
with each other and with the reference's wall-clock lint gate (a second
intra-op thread waits and spins more than it computes on the port's
small test shapes). A test module takes it with ``from
test_torch_threads import capped_torch_threads``.

The port's own threads end with their job: an ``async_io`` node's worker
pool closes when its job ends and when an attempt fails.
"""
import pytest
import torch

TORCH_TEST_THREADS = 1


@pytest.fixture(autouse=True, scope="module")
def capped_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(TORCH_TEST_THREADS)
    yield
    torch.set_num_threads(old)


def test_torch_runs_on_the_capped_thread_count():
    assert torch.get_num_threads() == TORCH_TEST_THREADS


def _async_threads():
    import threading

    return {t for t in threading.enumerate()
            if t.name.startswith("async-io") and t.is_alive()}


@pytest.mark.parametrize("fail", [False, True], ids=["done", "failed"])
def test_an_async_io_job_leaves_no_worker_thread(fail):
    """The driver closes an ``async_io`` node's worker pool when its job
    ends and when an attempt fails: no ``async-io`` thread of the job
    outlives ``execute``."""
    import numpy as np

    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import CollectSink
    from flink_tpu_torch.api.sources import GeneratorSource
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    def gen(split, i):
        if i >= 4:
            return None
        return {"x": np.arange(8, dtype=np.int64)}, np.full(8, i, np.int64)

    def lookup(data, ts):
        if fail and int(ts[0]) == 2:
            raise RuntimeError("lookup failed")
        return dict(data)

    before = _async_threads()
    env = StreamExecutionEnvironment(Configuration({}))
    (env.from_source(GeneratorSource(gen),
                     WatermarkStrategy.for_monotonous_timestamps())
     .async_io(lookup, capacity=2).add_sink(CollectSink()))
    if fail:
        with pytest.raises(RuntimeError, match="lookup failed"):
            env.execute("threads", device="cpu")
    else:
        env.execute("threads", device="cpu")
    assert not _async_threads() - before
