"""Aggregates as dense accumulator lanes: a window aggregation is a set
of f32 sum, max and min lanes beside the always-present int32 count
lane. ``lift`` maps a batch's record fields (torch tensors on the
operator's device) to per-record lane values; the window kernels fold
them into ``(rows, ring, width)`` lane state with add / max / min, and
``finalize`` maps a fired cell's lanes to the user-visible result
fields.

Ported: ``count``, ``sum_of``, ``max_of``, ``min_of``, ``avg_of`` and
``multi``. The changelog lanes and ``lower_aggregate`` are in
ROADMAP.md; the window operator refuses them.

Identities: sum 0, max -inf, min +inf, so padding rows lift to no-ops.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]

F32_NEG_INF = float("-inf")
F32_POS_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class LaneAggregate:
    """A windowed aggregation as sum/max/min lanes plus the count lane.

    ``lift(data) -> (sums (B, S), maxs (B, M), mins (B, m))`` per-record
    lane values; ``finalize(sums, maxs, mins, counts)`` maps lane values
    (shape ``(..., width)``, counts ``(...,)``) to the result fields.

    ``fields``: the record fields ``lift`` reads — the operator uploads
    only these (None = unknown, which the port refuses). ``sum_fields``:
    record fields whose identity lifts the sum lanes are, so the host
    can pre-combine a batch per (key, pane) pair (None = opaque)."""

    sum_width: int
    max_width: int
    min_width: int
    lift: Callable[[Tensors], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    finalize: Callable[..., Dict[str, torch.Tensor]]
    name: str = "agg"
    fields: Optional[Tuple[str, ...]] = None
    sum_fields: Optional[Tuple[str, ...]] = None

    def lift_masked(self, data: Tensors, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Lift a batch, mapping invalid rows to identity elements;
        every lane comes back as ``(B, width)`` f32, even when ``lift``
        cannot know B (count() reads no field)."""
        b = valid.shape[0]
        s, mx, mn = self.lift(data)
        v = valid[:, None]

        def norm(x, width, fill):
            if width == 0:
                return torch.full((b, 0), fill, dtype=torch.float32,
                                  device=valid.device)
            if x is None or x.dim() != 2 or x.shape[0] != b \
                    or x.shape[-1] != width:
                raise ValueError(
                    f"aggregate '{self.name}': lift returned shape "
                    f"{None if x is None else tuple(x.shape)}, expected "
                    f"({b}, {width})")
            return torch.where(v, x, torch.full_like(x, fill))

        return (norm(s, self.sum_width, 0.0),
                norm(mx, self.max_width, F32_NEG_INF),
                norm(mn, self.min_width, F32_POS_INF))


def _empty_lanes(b: torch.Tensor) -> torch.Tensor:
    return torch.zeros(b.shape[:1] + (0,), dtype=torch.float32, device=b.device)


def probe_finalize(agg: LaneAggregate) -> Dict[str, torch.Tensor]:
    """``finalize`` on empty CPU lanes — the result-field probe (names
    and dtypes)."""
    return agg.finalize(
        torch.zeros((0, agg.sum_width), dtype=torch.float32),
        torch.zeros((0, agg.max_width), dtype=torch.float32),
        torch.zeros((0, agg.min_width), dtype=torch.float32),
        torch.zeros((0,), dtype=torch.int32))


def result_fields(agg: LaneAggregate) -> Tuple[str, ...]:
    return tuple(sorted(probe_finalize(agg)))


_cached = functools.lru_cache(maxsize=None)


def _f32_column(data: Tensors, field: str) -> torch.Tensor:
    return data[field].to(torch.float32)[:, None]


@_cached
def count(result_field: str = "count") -> LaneAggregate:
    """COUNT(*) per (key, window): the count lane as is."""

    def lift(data: Tensors):
        b = next(iter(data.values())) if data else torch.zeros((0,))
        z = _empty_lanes(b)
        return z, z, z

    def finalize(sums, maxs, mins, counts):
        return {result_field: counts}

    return LaneAggregate(0, 0, 0, lift, finalize, name="count", fields=(),
                         sum_fields=())


@_cached
def sum_of(field: str, result_field: Optional[str] = None) -> LaneAggregate:
    out = result_field or f"sum_{field}"

    def lift(data: Tensors):
        z = _empty_lanes(data[field])
        return _f32_column(data, field), z, z

    def finalize(sums, maxs, mins, counts):
        return {out: sums[..., 0]}

    return LaneAggregate(1, 0, 0, lift, finalize, name=f"sum({field})",
                         fields=(field,), sum_fields=(field,))


@_cached
def max_of(field: str, result_field: Optional[str] = None) -> LaneAggregate:
    out = result_field or f"max_{field}"

    def lift(data: Tensors):
        z = _empty_lanes(data[field])
        return z, _f32_column(data, field), z

    def finalize(sums, maxs, mins, counts):
        return {out: maxs[..., 0]}

    return LaneAggregate(0, 1, 0, lift, finalize, name=f"max({field})",
                         fields=(field,))


@_cached
def min_of(field: str, result_field: Optional[str] = None) -> LaneAggregate:
    out = result_field or f"min_{field}"

    def lift(data: Tensors):
        z = _empty_lanes(data[field])
        return z, z, _f32_column(data, field)

    def finalize(sums, maxs, mins, counts):
        return {out: mins[..., 0]}

    return LaneAggregate(0, 0, 1, lift, finalize, name=f"min({field})",
                         fields=(field,))


@_cached
def avg_of(field: str, result_field: Optional[str] = None) -> LaneAggregate:
    out = result_field or f"avg_{field}"

    def lift(data: Tensors):
        z = _empty_lanes(data[field])
        return _f32_column(data, field), z, z

    def finalize(sums, maxs, mins, counts):
        c = torch.clamp(counts, min=1).to(torch.float32)
        return {out: sums[..., 0] / c}

    return LaneAggregate(1, 0, 0, lift, finalize, name=f"avg({field})",
                         fields=(field,), sum_fields=(field,))


@_cached
def multi(*aggs: LaneAggregate) -> LaneAggregate:
    """Several aggregations over one window in one lane layout: lanes
    concatenate in argument order, results merge."""
    sw = sum(a.sum_width for a in aggs)
    mw = sum(a.max_width for a in aggs)
    nw = sum(a.min_width for a in aggs)

    def lift(data: Tensors):
        ss, ms, ns = [], [], []
        for a in aggs:
            s, m, n = a.lift(data)
            ss.append(s)
            ms.append(m)
            ns.append(n)
        return (torch.cat(ss, dim=-1) if ss else None,
                torch.cat(ms, dim=-1) if ms else None,
                torch.cat(ns, dim=-1) if ns else None)

    def finalize(sums, maxs, mins, counts):
        out: Dict[str, torch.Tensor] = {}
        so = mo = no = 0
        for a in aggs:
            out.update(a.finalize(sums[..., so:so + a.sum_width],
                                  maxs[..., mo:mo + a.max_width],
                                  mins[..., no:no + a.min_width], counts))
            so += a.sum_width
            mo += a.max_width
            no += a.min_width
        return out

    comp_fields: Optional[Tuple[str, ...]] = ()
    for a in aggs:
        if a.fields is None:
            comp_fields = None
            break
        comp_fields = tuple(dict.fromkeys(comp_fields + a.fields))
    comp_sum: Optional[Tuple[str, ...]] = ()
    for a in aggs:
        if a.sum_fields is None:
            comp_sum = None
            break
        comp_sum = comp_sum + a.sum_fields
    return LaneAggregate(sw, mw, nw, lift, finalize,
                         name="+".join(a.name for a in aggs),
                         fields=comp_fields, sum_fields=comp_sum)
