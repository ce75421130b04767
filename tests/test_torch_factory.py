"""The port's operator factory SPI (``flink_tpu_torch/ops/factory.py``:
``register_operator_factory``, ``unregister_operator_factory``,
``lookup_operator_factory``), the cases of
``tests/test_factory_enumerator.py::TestOperatorFactory`` run in both
packages. ``TestSplitEnumerator`` (the job coordinator's split
assignment) waits for ROADMAP.md queue 1 item 10."""
import numpy as np
import pytest

from test_torch_file_pkgs import BOTH, P
from test_torch_threads import capped_torch_threads  # noqa: F401

PKGS = pytest.mark.parametrize("M", BOTH, ids=["jax", "port"])


@PKGS
def test_builtin_window_goes_through_registry(M):
    assert M.factory.lookup_operator_factory("window") is not None
    assert M.factory.lookup_operator_factory("no-such-kind") is None


def test_port_registers_every_builtin_factory():
    for kind in ("window", "evicting_window", "count_window", "session",
                 "window_all", "join"):
        assert P.factory.lookup_operator_factory(kind) is not None, kind


@PKGS
def test_override_swaps_the_hot_path(M):
    """A factory registered for 'window' builds every job's window
    operator; the rows stay the built-in's."""
    f = M.factory
    default = f.lookup_operator_factory("window")
    built = []

    def spy_factory(node, ctx):
        op = default(node, ctx)
        built.append((node.kind, type(op).__name__, ctx.num_shards))
        return op

    f.register_operator_factory("window", spy_factory)
    try:
        env = M.Env(M.Conf({"state.num-key-shards": 4,
                            "state.slots-per-shard": 16}))
        sink = M.sinks.CollectSink()
        (env.from_collection({"k": np.arange(200, dtype=np.int64) % 5},
                             np.arange(200, dtype=np.int64) * 10)
         .key_by("k").window(M.Tumbling.of(1000)).count().add_sink(sink))
        M.execute(env, "spy")
        assert built == [("window", "WindowOperator", 4)]
        assert len(sink.rows) == 10
    finally:
        f.register_operator_factory("window", default)


@PKGS
def test_unregister_restores_builtin_error(M):
    f = M.factory
    default = f.lookup_operator_factory("window")
    f.unregister_operator_factory("window")
    try:
        assert f.lookup_operator_factory("window") is None
    finally:
        f.register_operator_factory("window", default)
