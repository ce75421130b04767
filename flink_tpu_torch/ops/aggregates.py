"""Aggregates as dense accumulator lanes: a window aggregation is a set
of f32 sum, max and min lanes beside the always-present int32 count
lane. ``lift`` maps a batch's record fields (torch tensors on the
operator's device) to per-record lane values; the window kernels fold
them into ``(rows, ring, width)`` lane state with add / max / min, and
``finalize`` maps a fired cell's lanes to the user-visible result
fields.

Ported: ``count``, ``sum_of``, ``max_of``, ``min_of``, ``avg_of`` and
``multi``; the changelog lanes ``changelog_count``, ``changelog_sum_of``
and ``changelog_avg_of``, which weight each record by the sign of its
op (``records.OP_FIELD``) in the lift (``changelog_max_of`` and
``changelog_min_of`` refuse, as the JAX package's do); and
``lower_aggregate``, which adapts a user ``AggregateFunction`` to the
lanes.

Identities: sum 0, max -inf, min +inf, so padding rows lift to no-ops.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from flink_tpu_torch.records import OP_DELETE, OP_FIELD, OP_UPDATE_BEFORE

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


# ---------------------------------------------------------------------------
# Changelog lanes: windowed aggregation over op-typed input.
# ---------------------------------------------------------------------------

def _op_sign(data: Tensors) -> torch.Tensor:
    """(B,) f32 +1/-1 from the changelog op column: +I/+U add, -U/-D
    subtract."""
    ops = data[OP_FIELD].to(torch.int32)
    neg = (ops == OP_UPDATE_BEFORE) | (ops == OP_DELETE)
    return torch.where(neg, -1.0, 1.0).to(torch.float32)


@_cached
def changelog_count(result_field: str = "count") -> LaneAggregate:
    """COUNT(*) over a changelog stream: the sum of the records' signs
    (the count lane counts rows, retractions included). The lift is
    opaque (``sum_fields`` None), so the host never pre-combines it."""

    def lift(data: Tensors):
        s = _op_sign(data)[:, None]
        z = _empty_lanes(s[:, 0])
        return s, z, z

    def finalize(sums, maxs, mins, counts):
        return {result_field: torch.round(sums[..., 0]).to(torch.int32)}

    return LaneAggregate(1, 0, 0, lift, finalize, name="changelog_count",
                         fields=(OP_FIELD,))


@_cached
def changelog_sum_of(field: str,
                     result_field: Optional[str] = None) -> LaneAggregate:
    """SUM(field) over a changelog stream: sign-weighted values."""
    out = result_field or f"sum_{field}"

    def lift(data: Tensors):
        s = (data[field].to(torch.float32) * _op_sign(data))[:, None]
        z = _empty_lanes(data[field])
        return s, z, z

    def finalize(sums, maxs, mins, counts):
        return {out: sums[..., 0]}

    return LaneAggregate(1, 0, 0, lift, finalize,
                         name=f"changelog_sum({field})",
                         fields=(field, OP_FIELD))


@_cached
def changelog_avg_of(field: str,
                     result_field: Optional[str] = None) -> LaneAggregate:
    """AVG(field) over a changelog stream: the signed sum over a signed
    count lane of its own, its divisor clamped at 1."""
    out = result_field or f"avg_{field}"

    def lift(data: Tensors):
        sign = _op_sign(data)
        s = torch.stack([data[field].to(torch.float32) * sign, sign], dim=-1)
        z = _empty_lanes(data[field])
        return s, z, z

    def finalize(sums, maxs, mins, counts):
        c = torch.clamp(torch.round(sums[..., 1]), min=1.0)
        return {out: sums[..., 0] / c}

    return LaneAggregate(2, 0, 0, lift, finalize,
                         name=f"changelog_avg({field})",
                         fields=(field, OP_FIELD))


def changelog_max_of(field: str, result_field: Optional[str] = None) -> None:
    """Refused: a max lane cannot retract a value it has taken."""
    raise NotImplementedError(
        "MAX over a changelog stream cannot retract: max(a, b) forgets "
        "the loser, so a -U row cannot undo its +U. Materialize the "
        "stream first (RetractSink / UpsertSink) or keep the raw rows "
        "with an evicting window.")


def changelog_min_of(field: str, result_field: Optional[str] = None) -> None:
    """Refused for the same reason as :func:`changelog_max_of`."""
    raise NotImplementedError(
        "MIN over a changelog stream cannot retract: min(a, b) forgets "
        "the loser, so a -U row cannot undo its +U. Materialize the "
        "stream first (RetractSink / UpsertSink) or keep the raw rows "
        "with an evicting window.")


# ---------------------------------------------------------------------------
# Lowering user AggregateFunction classes.
# ---------------------------------------------------------------------------

def lower_aggregate(fn: Any, probe_fields: Dict[str, Any]) -> LaneAggregate:
    """Adapt a user ``AggregateFunction`` (``create_accumulator`` /
    ``add`` / ``merge`` / ``get_result``, written in torch) to the lanes.

    Each accumulator leaf is classed sum-, max- or min-merged by running
    ``merge`` on probe values (merge(3, 5) and merge(5, 3)); a leaf that
    merges as none of them raises. The lift runs ``add`` on a fresh
    accumulator per record (``torch.func.vmap``); the finalize rebuilds
    the accumulator from the lanes and calls ``get_result`` (a non-dict
    result becomes ``{"result": ...}``). ``probe_fields``: field name →
    dtype of the records the aggregate reads (the fields uploaded)."""
    acc0 = fn.create_accumulator()
    leaves0, treedef = pytree.tree_flatten(acc0)

    def probe(x: float, y: float):
        a = pytree.tree_unflatten(
            [torch.tensor(x, dtype=torch.float64)] * len(leaves0), treedef)
        b = pytree.tree_unflatten(
            [torch.tensor(y, dtype=torch.float64)] * len(leaves0), treedef)
        return [float(v) for v in pytree.tree_leaves(fn.merge(a, b))]

    kinds = []
    for m in probe(3.0, 5.0):
        if abs(m - 8.0) < 1e-9:
            kinds.append("sum")
        elif abs(m - 5.0) < 1e-9:
            kinds.append("max")
        elif abs(m - 3.0) < 1e-9:
            kinds.append("min")
        else:
            raise NotImplementedError(
                f"accumulator leaf merges as neither sum/max/min (got {m} "
                "from merge(3,5)); compose flink_tpu_torch.ops built-in lane "
                "aggregates instead")
    for k, v in zip(kinds, probe(5.0, 3.0)):
        if (k == "max" and abs(v - 5.0) > 1e-9) \
                or (k == "min" and abs(v - 3.0) > 1e-9):
            raise NotImplementedError("non-commutative merge")
    sum_ix = [i for i, k in enumerate(kinds) if k == "sum"]
    max_ix = [i for i, k in enumerate(kinds) if k == "max"]
    min_ix = [i for i, k in enumerate(kinds) if k == "min"]

    def lift(data: Tensors):
        def one(row: Tensors):
            return fn.add(row, fn.create_accumulator())

        leaves = pytree.tree_leaves(torch.func.vmap(one)(data))
        cols = [leaf.to(torch.float32).reshape(leaf.shape[0], -1)
                for leaf in leaves]

        def gather(ix):
            if not ix:
                return torch.zeros((cols[0].shape[0], 0), dtype=torch.float32,
                                   device=cols[0].device)
            return torch.cat([cols[i] for i in ix], dim=-1)

        return gather(sum_ix), gather(max_ix), gather(min_ix)

    def finalize(sums, maxs, mins, counts):
        leaves: list = [None] * len(leaves0)
        for j, i in enumerate(sum_ix):
            leaves[i] = sums[..., j]
        for j, i in enumerate(max_ix):
            leaves[i] = maxs[..., j]
        for j, i in enumerate(min_ix):
            leaves[i] = mins[..., j]
        res = fn.get_result(pytree.tree_unflatten(leaves, treedef))
        return res if isinstance(res, dict) else {"result": res}

    return LaneAggregate(len(sum_ix), len(max_ix), len(min_ix), lift, finalize,
                         name=type(fn).__name__, fields=tuple(probe_fields))
