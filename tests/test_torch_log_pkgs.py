"""The two packages' log tiers side by side, for the port's log tests:
``LJ`` and ``LP`` name the same modules and classes in ``flink_tpu``
and ``flink_tpu_torch``, and ``run_both`` runs one scenario in each,
in directories of its own, and holds the port's observations to the
reference's.

An observation is plain data: committed rows as Python lists with
their dtypes, offsets, generations, lease epochs, group floors and the
``describe_topic`` fields. ``scrub`` takes out what differs between two
runs by nature: wall-clock times (millisecond timestamps, also as the
ids of a bounded run's final epoch), process ids and absolute paths."""
import importlib
import os
import re
import threading
import types

import numpy as np

from test_torch_threads import capped_torch_threads  # noqa: F401


def _ns(root):
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    port = root == "flink_tpu_torch"
    env_mod = m("api.environment")
    sup = m("runtime.supervisor")
    kw = {"device": "cpu"} if port else {}
    return types.SimpleNamespace(
        name="port" if port else "jax",
        log=m("log"), topic=m("log.topic"), bus=m("log.bus"),
        cleaner=m("log.cleaner"), connectors=m("log.connectors"),
        faults=m("faults"), fs=m("fs"), fso=m("fs_objstore"),
        columnar=m("formats_columnar"), sinks=m("api.sinks"),
        Env=env_mod.StreamExecutionEnvironment,
        Conf=m("config").Configuration, LogOptions=m("config").LogOptions,
        GeneratorSource=m("api.sources").GeneratorSource,
        Tumbling=m("api.windowing").TumblingEventTimeWindows,
        WM=m("time.watermarks").WatermarkStrategy,
        HostPool=m("parallel.hostpool").HostPool,
        execute=lambda env, name: env.execute(name, **kw),
        recover=lambda build, conf, name: sup.run_with_recovery(
            build, conf, job_name=name, **kw))


LJ = _ns("flink_tpu")
LP = _ns("flink_tpu_torch")
BOTH = (LJ, LP)

_TS = re.compile(r"\d{12,}")
# keys whose values are wall-clock or process facts, not protocol state
_DROP = {"topic", "pid", "last_pass_ms", "last_pass_at_ms",
         "next_deadline_ms", "acquired_ms", "deadline_ms"}


def scrub(v):
    """``v`` without wall-clock times, process ids and paths."""
    if isinstance(v, dict):
        return {scrub(k): scrub(x) for k, x in v.items()
                if k not in _DROP}
    if isinstance(v, (list, tuple)):
        return type(v)(scrub(x) for x in v)
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, (int, np.integer)):
        return "<ts>" if int(v) >= 10 ** 12 else int(v)
    if isinstance(v, str):
        return _TS.sub("<ts>", v)
    return v


def cols(batch):
    """A batch as {column: (dtype, values)}."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        out[k] = (a.dtype.str, a.tolist())
    return out


def topic_rows(L, topic, start=None, zero_copy=False):
    """Every committed block of every partition: (offset, next position,
    columns), in offset order."""
    r = L.topic.TopicReader(topic, zero_copy=zero_copy)
    return {p: [(off, nxt, cols(b)) for off, nxt, b in
                r.read3(p, int((start or {}).get(p, 0)))]
            for p in range(r.partitions)}


def topic_files(topic):
    """The topic directory's files, relative, sorted (locks aside)."""
    out = []
    for base, _, files in os.walk(topic):
        for f in files:
            if f.endswith(".lock"):
                continue
            out.append(os.path.relpath(os.path.join(base, f), topic))
    return sorted(scrub(out))


def topic_view(L, topic, files=True):
    """What a topic holds: its described state, its committed rows, its
    offsets, generation and floors, and (``files``) its file names."""
    r = L.topic.TopicReader(topic)
    view = {"describe": scrub(L.log.describe_topic(topic)),
            "rows": topic_rows(L, topic),
            "committed": r.committed_offsets(),
            "starts": r.start_offsets(),
            "compacted": r.compacted_ends(),
            "gen": r.generation}
    if files and "://" not in topic:
        view["files"] = topic_files(topic)
    return view


def raised(fn, exc, match=None):
    """Call ``fn``; the name of the ``exc`` it raised (and, with
    ``match``, whether the message matched), or a failure."""
    try:
        fn()
    except exc as e:
        if match is not None:
            assert re.search(match, str(e)), (match, str(e))
        return type(e).__name__
    raise AssertionError(f"{fn} did not raise {exc}")


def run_both(scenario, tmp_path, *args):
    """Run ``scenario(L, root, *args)`` for the reference, then for the
    port, each in its own directory; the port's observations must be
    the reference's. Returns them."""
    before = set(log_threads())
    got = {}
    for L in BOTH:
        root = tmp_path / L.name
        root.mkdir()
        got[L.name] = scrub(scenario(L, root, *args))
    assert got["port"] == got["jax"]
    # no readahead or cleaner thread outlives its scenario
    for t in set(log_threads()) - before:
        t.join(timeout=5.0)
        assert not t.is_alive(), f"{t.name} outlived its scenario"
    return got["port"]


def log_threads():
    return [t for t in threading.enumerate() if t.is_alive()
            and t.name.startswith(("log-readahead", "log-cleaner"))]


def test_the_namespaces_name_the_same_surface():
    assert set(vars(LJ)) == set(vars(LP))
    assert LP.log.LogSink.__module__ == "flink_tpu_torch.log.connectors"
    assert LJ.log.LogSink.__module__ == "flink_tpu.log.connectors"
    assert sorted(LP.log.__all__) == sorted(LJ.log.__all__)
