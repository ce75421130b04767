"""The port's operator factory SPI (``flink_tpu_torch/ops/factory.py``:
``register_operator_factory``, ``unregister_operator_factory``,
``lookup_operator_factory``), the cases of
``tests/test_factory_enumerator.py::TestOperatorFactory`` run in both
packages, and ``TestSplitEnumerator``: the job coordinator's split
assignment (``source.enumeration: coordinator``) against the port's
coordinator, shares equal to the reference's, and two port drivers
dividing a file source between them."""
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


class TestSplitEnumerator:
    def test_disjoint_cover(self):
        from flink_tpu.config import Configuration as JaxConfiguration
        from flink_tpu.runtime.coordinator import (
            JobCoordinator as JaxJobCoordinator)
        from flink_tpu_torch.config import Configuration
        from flink_tpu_torch.runtime.coordinator import JobCoordinator

        shares = {}
        for name, coord in (("port", JobCoordinator(Configuration({}))),
                            ("jax", JaxJobCoordinator(JaxConfiguration({})))):
            try:
                coord.rpc_register_runner("a", "h", 1)
                coord.rpc_register_runner("b", "h", 1)
                coord.rpc_submit_job("j", runners=["a", "b"])
                sa = coord.rpc_enumerate_splits("j", 0, 10, "a")["splits"]
                sb = coord.rpc_enumerate_splits("j", 0, 10, "b")["splits"]
                assert sorted(sa + sb) == list(range(10))
                assert not set(sa) & set(sb)
                # a zombie runner gets an ERROR (an empty share would let
                # a stale attempt finish instantly and report finish_job)
                with pytest.raises(RuntimeError, match="stale attempt"):
                    coord.rpc_enumerate_splits("j", 0, 10, "z")
                shares[name] = (sa, sb)
            finally:
                coord.close()
        assert shares["port"] == shares["jax"]

    def test_two_drivers_divide_a_file_source(self, tmp_path):
        """Two in-process port drivers with coordinator enumeration read
        disjoint file splits whose union is the whole source."""
        from flink_tpu_torch.api.environment import StreamExecutionEnvironment
        from flink_tpu_torch.api.sinks import CollectSink
        from flink_tpu_torch.config import Configuration
        from flink_tpu_torch.connectors import FileSource
        from flink_tpu_torch.formats import CsvFormat
        from flink_tpu_torch.runtime.coordinator import JobCoordinator
        from flink_tpu_torch.runtime.rpc import RpcServer

        for f in range(4):
            with open(tmp_path / f"part{f}.csv", "w") as fh:
                for r in range(25):
                    fh.write(f"{f * 100 + r},{r}\n")

        coord = JobCoordinator(Configuration({}))
        srv = RpcServer(coord)
        try:
            coord.rpc_register_runner("r1", "h", 1)
            coord.rpc_register_runner("r2", "h", 1)
            coord.rpc_submit_job("j", runners=["r1", "r2"])

            def run(runner_id):
                env = StreamExecutionEnvironment(Configuration({
                    "source.enumeration": "coordinator",
                    "cluster.coordinator": f"127.0.0.1:{srv.port}",
                    "cluster.job-id": "j",
                    "cluster.runner-id": runner_id,
                }))
                sink = CollectSink()
                src = FileSource(str(tmp_path / "*.csv"),
                                 CsvFormat([("v", "i64"), ("ts", "i64")]),
                                 ts_field="ts")
                env.from_source(src).add_sink(sink)
                env.execute(f"enum-{runner_id}", device="cpu")
                return {int(r["v"]) for r in sink.rows}

            got1 = run("r1")
            got2 = run("r2")
            everything = {f * 100 + r for f in range(4) for r in range(25)}
            assert not got1 & got2          # disjoint
            assert got1 | got2 == everything  # complete
        finally:
            srv.close()
            coord.close()
