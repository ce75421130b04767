"""The two packages' checkpoint surfaces side by side, for the port's
checkpoint, 2PC-sink and observability parity tests: ``JAX`` and
``PORT`` name the same classes and functions in ``flink_tpu`` and
``flink_tpu_torch``, and ``execute`` runs a job in either (the port on
the CPU, as every test here asks for explicitly)."""
import types

from test_torch_threads import capped_torch_threads  # noqa: F401


def _jax():
    from flink_tpu import cep, faults
    from flink_tpu.api import sinks
    from flink_tpu.api.environment import StreamExecutionEnvironment
    from flink_tpu.api.sources import GeneratorSource
    from flink_tpu.api.windowing import (
        EventTimeSessionWindows, SlidingEventTimeWindows,
        TumblingEventTimeWindows)
    from flink_tpu.checkpoint import blobformat, coordinator, storage
    from flink_tpu.config import Configuration
    from flink_tpu.nexmark import generator
    from flink_tpu.nexmark.queries import q5_hot_items
    from flink_tpu.obs import metrics, tracing
    from flink_tpu.ops import aggregates, broadcast
    from flink_tpu.ops.count_window import CountWindowOperator
    from flink_tpu.ops.window import WindowOperator
    from flink_tpu.runtime import driver, restart
    from flink_tpu.runtime.supervisor import run_with_recovery
    from flink_tpu.state.keyed import PaneState
    from flink_tpu.time.watermarks import WatermarkStrategy

    return types.SimpleNamespace(
        name="jax", faults=faults, sinks=sinks, Env=StreamExecutionEnvironment,
        GeneratorSource=GeneratorSource, Sliding=SlidingEventTimeWindows,
        Tumbling=TumblingEventTimeWindows, Sessions=EventTimeSessionWindows,
        blobformat=blobformat,
        coordinator=coordinator, storage=storage, Conf=Configuration,
        gen=generator, q5=q5_hot_items, metrics=metrics, tracing=tracing,
        agg=aggregates, CountWindowOperator=CountWindowOperator,
        cep=cep, broadcast=broadcast,
        WindowOperator=WindowOperator, driver=driver, restart=restart,
        run_with_recovery=run_with_recovery, PaneState=PaneState,
        WM=WatermarkStrategy, kw={},
        execute=lambda env, name: env.execute(name),
        recover=lambda build, conf, name: run_with_recovery(
            build, conf, job_name=name))


def _port():
    from flink_tpu_torch import cep, faults
    from flink_tpu_torch.api import sinks
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sources import GeneratorSource
    from flink_tpu_torch.api.windowing import (
        EventTimeSessionWindows, SlidingEventTimeWindows,
        TumblingEventTimeWindows)
    from flink_tpu_torch.checkpoint import blobformat, coordinator, storage
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.nexmark import generator
    from flink_tpu_torch.nexmark.queries import q5_hot_items
    from flink_tpu_torch.obs import metrics, tracing
    from flink_tpu_torch.ops import aggregates, broadcast
    from flink_tpu_torch.ops.count_window import CountWindowOperator
    from flink_tpu_torch.ops.window import WindowOperator
    from flink_tpu_torch.runtime import driver, restart
    from flink_tpu_torch.runtime.supervisor import run_with_recovery
    from flink_tpu_torch.state.keyed import PaneState
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    return types.SimpleNamespace(
        name="port", faults=faults, sinks=sinks,
        Env=StreamExecutionEnvironment, GeneratorSource=GeneratorSource,
        Sliding=SlidingEventTimeWindows, Tumbling=TumblingEventTimeWindows,
        Sessions=EventTimeSessionWindows,
        blobformat=blobformat, coordinator=coordinator, storage=storage,
        Conf=Configuration, gen=generator, q5=q5_hot_items, metrics=metrics,
        tracing=tracing, agg=aggregates,
        CountWindowOperator=CountWindowOperator, WindowOperator=WindowOperator,
        cep=cep, broadcast=broadcast,
        driver=driver, restart=restart, run_with_recovery=run_with_recovery,
        PaneState=PaneState, WM=WatermarkStrategy, kw={"device": "cpu"},
        execute=lambda env, name: env.execute(name, device="cpu"),
        recover=lambda build, conf, name: run_with_recovery(
            build, conf, job_name=name, device="cpu"))


JAX = _jax()
PORT = _port()
BOTH = (JAX, PORT)


def pkg_id(p):
    return p.name


def row_view(rows):
    """Committed rows as hashable tuples of Python values, in order."""
    return [tuple(sorted((k, v.item() if hasattr(v, "item") else v)
                         for k, v in r.items())) for r in rows]


def test_the_namespaces_name_the_same_surface():
    assert set(vars(JAX)) == set(vars(PORT))
    assert JAX.sinks.TransactionalCollectSink is not \
        PORT.sinks.TransactionalCollectSink
    assert PORT.WindowOperator.__module__.startswith("flink_tpu_torch.")
