"""The two packages' file connectors, formats, batch mode and fsck side
by side, for the port's tests of them: ``J`` and ``P`` name the same
modules and classes in ``flink_tpu`` and ``flink_tpu_torch``, and
``P.execute`` runs a job on the CPU (the port's default is the card).
"""
import importlib
import types



def _ns(root):
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    port = root == "flink_tpu_torch"
    kw = {"device": "cpu"} if port else {}
    env_mod = m("api.environment")
    sup = m("runtime.supervisor")
    return types.SimpleNamespace(
        name="port" if port else "jax", root=root,
        formats=m("formats"), columnar=m("formats_columnar"),
        connectors=m("connectors"), nc=m("native_codec"),
        sinks=m("api.sinks"), sources=m("api.sources"),
        fsck=m("fsck"), topic=m("log.topic"), bus=m("log.bus"),
        storage=m("checkpoint.storage"), faults=m("faults"), fs=m("fs"),
        blocking=m("exchange.blocking"), scheduler=m("runtime.scheduler"),
        factory=m("ops.factory"),
        Env=env_mod.StreamExecutionEnvironment,
        Conf=m("config").Configuration,
        GeneratorSource=m("api.sources").GeneratorSource,
        Tumbling=m("api.windowing").TumblingEventTimeWindows,
        WM=m("time.watermarks").WatermarkStrategy,
        execute=lambda env, name, **k: env.execute(name, **kw, **k),
        recover=lambda build, conf, name: sup.run_with_recovery(
            build, conf, name, **kw))


J = _ns("flink_tpu")
P = _ns("flink_tpu_torch")
BOTH = (J, P)
