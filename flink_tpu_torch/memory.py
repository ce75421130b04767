"""Memory accounting: plan-time device-memory budgeting.

ref: runtime/memory/MemoryManager.java — managed memory is budgeted per
slot and a deployment that cannot meet its budget fails at once,
instead of an operator running out of memory mid-job. The operators'
device state is dense and statically shaped (pane lanes, emit rings,
step buffers), so its footprint is known at build time from the
layouts: a job that cannot fit ``memory.hbm-budget`` fails at build
with the per-operator breakdown, not mid-run in the CUDA allocator.
Pinned host buffers are not counted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

__all__ = ["MemoryBudget", "OperatorFootprint", "InsufficientMemoryError"]


class InsufficientMemoryError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class OperatorFootprint:
    name: str
    hbm_bytes: int
    detail: str = ""


class MemoryBudget:
    """Collects per-operator static HBM footprints and checks them
    against a configured budget (0 = unlimited)."""

    def __init__(self, hbm_budget_bytes: int = 0) -> None:
        self.hbm_budget_bytes = hbm_budget_bytes
        self.footprints: List[OperatorFootprint] = []

    def register(self, name: str, hbm_bytes: int, detail: str = "") -> None:
        self.footprints.append(OperatorFootprint(name, hbm_bytes, detail))

    @property
    def hbm_total(self) -> int:
        return sum(f.hbm_bytes for f in self.footprints)

    def check(self) -> None:
        if self.hbm_budget_bytes <= 0:
            return
        total = self.hbm_total
        if total > self.hbm_budget_bytes:
            lines = "\n".join(
                f"  {f.name}: {f.hbm_bytes:,} B  {f.detail}"
                for f in sorted(self.footprints,
                                key=lambda f: -f.hbm_bytes))
            raise InsufficientMemoryError(
                f"planned device state {total:,} B exceeds the "
                f"memory.hbm-budget of {self.hbm_budget_bytes:,} B:\n"
                f"{lines}\n"
                "Reduce state.num-key-shards/slots-per-shard, shorten "
                "windows (fewer ring panes), or raise the budget.")

    def breakdown(self) -> List[Dict]:
        return [dataclasses.asdict(f) for f in self.footprints]
