"""Operator factories: build the runtime operator of a plan node. The
window and count-window operators are ported."""
from __future__ import annotations

import dataclasses

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


def _window_factory(node, ctx: OperatorBuildContext):
    from flink_tpu_torch.ops.window import WindowOperator

    t = node.window_transform
    return WindowOperator(
        t.assigner, t.aggregate,
        num_shards=ctx.num_shards,
        slots_per_shard=ctx.slots_per_shard,
        max_out_of_orderness_ms=max(ctx.max_out_of_orderness_ms, 0),
        top_n=t.top_n,
        max_inflight_steps=ctx.max_inflight_steps,
        fire_gate=ctx.fire_gate,
        device=ctx.device,
    )


def _count_window_factory(node, ctx: OperatorBuildContext):
    from flink_tpu_torch.ops.count_window import CountWindowOperator

    t = node.window_transform
    return CountWindowOperator(
        t.aggregate, t.size, purge=t.purge,
        num_shards=ctx.num_shards,
        slots_per_shard=ctx.slots_per_shard,
        device=ctx.device,
    )
