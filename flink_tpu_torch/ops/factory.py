"""Operator factories: build the runtime operator of a plan node. The
window, element-path window, count-window, session, windowAll and
windowed-join operators are ported; the state backend (``hbm`` or
``spill``), the drop policy, the driver's host pool and, for a keyed
window over a mesh of device blocks, the mesh plan and its exchange's
capacity and pattern, and across processes the process's span of the
key shards, reach them through the context."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class OperatorBuildContext:
    """Everything a factory needs, resolved once from the configuration."""

    device: torch.device
    num_shards: int
    slots_per_shard: int
    max_inflight_steps: int
    max_out_of_orderness_ms: int
    fire_gate: bool
    # state.backend: 'hbm' (device slots only) or 'spill' (keys past
    # them aggregate in a host store)
    backend: str = "hbm"
    # state.allow-drops: drop and count a full shard's records instead
    # of failing the job
    allow_drops: bool = False
    # cluster.mesh-devices: the mesh of device blocks a keyed window runs
    # over (None = one device), pipeline.exchange-capacity (None = auto)
    # and exchange.impl
    mesh_plan: Optional[Any] = None
    exchange_capacity: Optional[int] = None
    exchange_impl: str = "all-to-all"
    # pipeline.readiness: how a window's throttle waits on a step
    readiness: str = "piggyback"
    # the driver's shared host pool (host.parallelism) and the spill
    # store's tree-fold floor (host.fold-chunk-records)
    host_pool: Optional[Any] = None
    fold_chunk_records: Optional[int] = None
    # a job across processes: this process's contiguous span of the key
    # shards (None = every shard)
    shard_range: Optional[Any] = None


def _window_factory(node, ctx: OperatorBuildContext):
    from flink_tpu_torch.ops.window import WindowOperator

    t = node.window_transform
    op = WindowOperator(
        t.assigner, t.aggregate,
        num_shards=ctx.num_shards,
        slots_per_shard=ctx.slots_per_shard,
        allowed_lateness_ms=t.allowed_lateness_ms,
        max_out_of_orderness_ms=max(ctx.max_out_of_orderness_ms, 0),
        top_n=t.top_n,
        spill=ctx.backend == "spill",
        max_inflight_steps=ctx.max_inflight_steps,
        fire_gate=ctx.fire_gate,
        device=ctx.device,
        mesh_plan=ctx.mesh_plan,
        exchange_capacity=ctx.exchange_capacity,
        exchange_impl=ctx.exchange_impl,
        readiness=ctx.readiness,
        host_pool=ctx.host_pool,
        fold_chunk_records=ctx.fold_chunk_records,
        shard_range=ctx.shard_range,
    )
    op.allow_drops = ctx.allow_drops
    return op


def _count_window_factory(node, ctx: OperatorBuildContext):
    from flink_tpu_torch.ops.count_window import CountWindowOperator

    t = node.window_transform
    op = CountWindowOperator(
        t.aggregate, t.size, purge=t.purge,
        num_shards=ctx.num_shards,
        slots_per_shard=ctx.slots_per_shard,
        device=ctx.device,
    )
    op.allow_drops = ctx.allow_drops
    return op


def _evicting_window_factory(node, ctx: OperatorBuildContext):
    from flink_tpu_torch.ops.evicting_window import EvictingWindowOperator

    t = node.window_transform
    return EvictingWindowOperator(
        t.assigner, t.window_fn, trigger=t.trigger, evictor=t.evictor,
        allowed_lateness_ms=t.allowed_lateness_ms, device=ctx.device)


def _session_factory(node, ctx: OperatorBuildContext):
    from flink_tpu_torch.ops.session import SessionOperator

    t = node.window_transform
    return SessionOperator(
        gap_ms=t.gap_ms, agg=t.aggregate,
        allowed_lateness_ms=t.allowed_lateness_ms,
        num_shards=ctx.num_shards, slots_per_shard=ctx.slots_per_shard,
        max_out_of_orderness_ms=max(ctx.max_out_of_orderness_ms, 0),
        host_pool=ctx.host_pool, retract=t.retract)


def _window_all_factory(node, ctx: OperatorBuildContext):
    from flink_tpu_torch.ops.window_all import WindowAllOperator

    t = node.window_transform
    return WindowAllOperator(
        t.assigner, t.aggregate,
        allowed_lateness_ms=t.allowed_lateness_ms,
        max_out_of_orderness_ms=max(ctx.max_out_of_orderness_ms, 0),
        host_pool=ctx.host_pool,
        fold_chunk_records=ctx.fold_chunk_records)


def _join_factory(node, ctx: OperatorBuildContext):
    from flink_tpu_torch.ops.join import WindowJoinOperator

    t = node.window_transform
    # aggregate mode's two sides run on the driver's device, one block
    # each, mesh or not, as in the JAX package
    return WindowJoinOperator(
        t.assigner, left_fields=t.left_fields, right_fields=t.right_fields,
        num_shards=ctx.num_shards, slots_per_shard=ctx.slots_per_shard,
        max_out_of_orderness_ms=max(ctx.max_out_of_orderness_ms, 0),
        mode=t.mode, device=ctx.device)
