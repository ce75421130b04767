"""Lower the transformation DAG to the plan the driver walks per batch:
source → chain (fused host map, filter and flat-map functions) → window,
element-path window, count window, session window, windowAll or
windowed join → chain → sink, with union nodes merging streams and
partition nodes (``rebalance`` and the like) as pass-through exchange
boundaries. KeyBy
folds into the stateful node that consumes it; a key function becomes a
chain function that writes the derived key column. A join node records
which upstream node feeds its left and its right input (``left_input``,
``right_input``), and refuses one node feeding both. Each stateful node
records the schema of the rows it emits (``out_schema``) where that is
a plan fact. A transformation the port does not have yet raises,
naming its ROADMAP.md item."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.graph.transformations import (
    CountWindowAggregateTransformation,
    EvictingWindowTransformation,
    KeyByTransformation,
    MapTransformation,
    PartitionTransformation,
    SessionAggregateTransformation,
    SinkTransformation,
    SourceTransformation,
    Transformation,
    UnionTransformation,
    WindowAggregateTransformation,
    WindowAllAggregateTransformation,
    WindowJoinTransformation,
)
from flink_tpu_torch.time.watermarks import WatermarkStrategy


@dataclasses.dataclass
class ExecNode:
    id: int
    # source | chain | union | partition | window | evicting_window |
    # count_window | session | window_all | join | sink
    kind: str
    downstream: List[int] = dataclasses.field(default_factory=list)
    source: Any = None
    watermark_strategy: Optional[WatermarkStrategy] = None
    fns: List[Callable] = dataclasses.field(default_factory=list)
    key_field: str = "key"
    window_transform: Any = None
    sink: Any = None
    # join: the upstream node of each input edge
    left_input: Optional[int] = None
    right_input: Optional[int] = None
    # partition: the non-keyed redistribution strategy
    partition_strategy: Optional[str] = None
    # the fired rows' schema (field -> numpy dtype name) where it is a
    # plan fact, else None
    out_schema: Optional[Dict[str, str]] = None
    name: str = ""


@dataclasses.dataclass
class ExecutionPlan:
    nodes: Dict[int, ExecNode]
    sources: List[int]
    topo_order: List[int]
    watermark_strategy: WatermarkStrategy

    def node(self, nid: int) -> ExecNode:
        return self.nodes[nid]


def compile_job(transforms: Sequence[Transformation],
                default_wm: WatermarkStrategy) -> ExecutionPlan:
    consumers: Dict[int, List[Transformation]] = {}
    for t in transforms:
        for up in t.inputs:
            consumers.setdefault(up.id, []).append(t)
    nodes: Dict[int, ExecNode] = {}
    t2node: Dict[int, int] = {}

    def new_node(kind: str, name: str, **kw) -> ExecNode:
        n = ExecNode(id=len(nodes), kind=kind, name=name, **kw)
        nodes[n.id] = n
        return n

    def node_for(t: Transformation) -> int:
        if t.id in t2node:
            return t2node[t.id]
        if isinstance(t, SourceTransformation):
            n = new_node("source", t.name, source=t.source,
                         watermark_strategy=t.watermark_strategy)
        elif isinstance(t, MapTransformation):
            up = node_for(t.inputs[0])
            upn = nodes[up]
            if upn.kind == "chain" and len(consumers.get(t.inputs[0].id, [])) == 1:
                upn.fns.append(t.fn)
                t2node[t.id] = upn.id
                return upn.id
            n = new_node("chain", t.name, fns=[t.fn])
            upn.downstream.append(n.id)
        elif isinstance(t, KeyByTransformation):
            up = node_for(t.inputs[0])
            t2node[t.id] = up
            if t.key_fn is None:
                return up

            # the key column, written by a chain function: fused into the
            # upstream chain when this keyBy is its only consumer (a
            # sibling branch must not see the column), else its own node
            def add_key(data, ts, valid, _fn=t.key_fn, _kf=t.key_field):
                data = dict(data)
                data[_kf] = np.asarray(_fn(data), np.int64)
                return data, ts, valid

            upn = nodes[up]
            if upn.kind == "chain" and len(consumers.get(t.inputs[0].id, [])) == 1:
                upn.fns.append(add_key)
                return up
            n = new_node("chain", "key_extract", fns=[add_key])
            upn.downstream.append(n.id)
        elif isinstance(t, (WindowAggregateTransformation,
                            EvictingWindowTransformation)):
            if not isinstance(t.inputs[0], KeyByTransformation):
                raise NotImplementedError(
                    "a window aggregate must follow key_by in this port")
            up = node_for(t.inputs[0])
            kind = ("window" if isinstance(t, WindowAggregateTransformation)
                    else "evicting_window")
            n = new_node(kind, t.name, window_transform=t,
                         key_field=t.key_field)
            nodes[up].downstream.append(n.id)
        elif isinstance(t, CountWindowAggregateTransformation):
            if not isinstance(t.inputs[0], KeyByTransformation):
                raise NotImplementedError(
                    "a count window must follow key_by in this port")
            up = node_for(t.inputs[0])
            n = new_node("count_window", t.name, window_transform=t,
                         key_field=t.key_field)
            nodes[up].downstream.append(n.id)
        elif isinstance(t, SessionAggregateTransformation):
            up = node_for(t.inputs[0])
            n = new_node("session", t.name, window_transform=t,
                         key_field=t.key_field)
            nodes[up].downstream.append(n.id)
        elif isinstance(t, WindowAllAggregateTransformation):
            up = node_for(t.inputs[0])
            n = new_node("window_all", t.name, window_transform=t)
            nodes[up].downstream.append(n.id)
        elif isinstance(t, WindowJoinTransformation):
            lup = node_for(t.inputs[0])
            rup = node_for(t.inputs[1])
            if lup == rup:
                # the driver routes a batch to a side by its upstream
                # node, which cannot tell the two edges apart
                raise NotImplementedError(
                    f"a join ({t.name!r}) fed twice by the same upstream "
                    "node (a self-join) is not supported: materialize one "
                    "side through a distinct map first")
            n = new_node("join", t.name, window_transform=t,
                         left_input=lup, right_input=rup)
            nodes[lup].downstream.append(n.id)
            nodes[rup].downstream.append(n.id)
        elif isinstance(t, PartitionTransformation):
            # an exchange boundary: always a node of its own
            up = node_for(t.inputs[0])
            n = new_node("partition", t.name, partition_strategy=t.strategy)
            nodes[up].downstream.append(n.id)
        elif isinstance(t, SinkTransformation):
            up = node_for(t.inputs[0])
            n = new_node("sink", t.name, sink=t.sink)
            nodes[up].downstream.append(n.id)
        elif isinstance(t, UnionTransformation):
            n = new_node("union", t.name)
            for inp in t.inputs:
                nodes[node_for(inp)].downstream.append(n.id)
        else:
            raise NotImplementedError(
                f"transformation {type(t).__name__} is not ported yet "
                "(ROADMAP.md queue 1)")
        t2node[t.id] = n.id
        return n.id

    for t in transforms:
        node_for(t)
    sources = [n.id for n in nodes.values() if n.kind == "source"]
    if not sources:
        raise ValueError("job has no sources")
    if not any(n.kind == "sink" for n in nodes.values()):
        raise ValueError("job has no sinks (add_sink/print/collect)")
    for n in nodes.values():
        n.out_schema = _op_out_schema(n)
    return ExecutionPlan(nodes=nodes, sources=sources,
                         topo_order=_topo_order(nodes),
                         watermark_strategy=default_wm)


def _probe_result_schema(agg) -> Dict[str, str]:
    """An aggregate's result fields with coarse dtypes: integer results
    int64, the rest float32 (the JAX package's rule)."""
    from flink_tpu_torch.ops.aggregates import probe_finalize

    return {k: ("float32" if v.is_floating_point() else "int64")
            for k, v in probe_finalize(agg).items()}


def _op_out_schema(node: ExecNode) -> Optional[Dict[str, str]]:
    """The fired-row schema of a stateful node, where the plan fixes it
    (the JAX package's ``_op_out_schema``); None for chains, the element
    path's window functions and the rest."""
    wt = node.window_transform
    try:
        if node.kind in ("window", "session", "count_window"):
            out = {"key": "int64", "window_start": "int64",
                   "window_end": "int64", "count": "int64"}
            out.update(_probe_result_schema(wt.aggregate))
            if getattr(wt, "retract", False):
                out["__op__"] = "int8"
            return out
        if node.kind == "window_all":
            out = {"window_start": "int64", "window_end": "int64",
                   "count": "int64"}
            out.update(_probe_result_schema(wt.aggregate))
            return out
        if node.kind == "join":
            out = {"key": "int64", "window_start": "int64",
                   "window_end": "int64"}
            if wt.mode == "aggregate":
                out["left_count"] = "int64"
                out["right_count"] = "int64"
            for f in wt.left_fields:
                out[f"left_{f}"] = "float32"
            for f in wt.right_fields:
                out[f"right_{f}"] = "float32"
            return out
    except Exception:
        # a user aggregate whose finalize refuses empty lanes must not
        # fail a lowering the runtime accepts
        return None
    return None


def _topo_order(nodes: Dict[int, ExecNode]) -> List[int]:
    indeg = {nid: 0 for nid in nodes}
    for n in nodes.values():
        for d in n.downstream:
            indeg[d] += 1
    order: List[int] = []
    ready = [nid for nid, d in indeg.items() if d == 0]
    while ready:
        nid = ready.pop()
        order.append(nid)
        for d in nodes[nid].downstream:
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    if len(order) != len(nodes):
        raise ValueError("cycle in transformation graph")
    return order
