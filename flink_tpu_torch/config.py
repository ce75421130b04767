"""Typed configuration: the options this port reads, under the JAX
package's keys and with its defaults, so a conf written for
``flink_tpu`` runs here unchanged as long as it only uses what is
ported. A key the port does not know raises (``Configuration.validate``)
— it is never silently ignored.

Values come from ``key: value`` / ``key=value`` files or JSON objects
(``from_file``) and from explicit ``set``/constructor values, which
win.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Generic, Mapping, Optional, TypeVar

T = TypeVar("T")

_REGISTRY: Dict[str, "ConfigOption[Any]"] = {}


@dataclasses.dataclass(frozen=True)
class ConfigOption(Generic[T]):
    key: str
    default: T
    description: str = ""

    def __post_init__(self) -> None:
        _REGISTRY[self.key] = self

    def coerce(self, raw: Any) -> T:
        """File values arrive as strings; the default's type decides."""
        if not isinstance(raw, str):
            return raw
        if isinstance(self.default, bool):
            return raw.strip().lower() in ("1", "true", "yes", "on")  # type: ignore[return-value]
        if isinstance(self.default, int):
            return int(raw)  # type: ignore[return-value]
        return raw.strip()  # type: ignore[return-value]


class PipelineOptions:
    MICROBATCH_SIZE = ConfigOption(
        "pipeline.microbatch-size", 8192,
        "Records per batch for sources that batch a collection "
        "(from_collection).")
    SUB_BATCHES = ConfigOption(
        "pipeline.sub-batches", 1,
        "Sub-batch steps per logical batch: a device-made source chained "
        "into its window operator runs each logical batch as this many "
        "steps, each with its own watermark advance and fires. Must "
        "divide pipeline.microbatch-size. Host-fed sources take only 1 "
        "(host-plane sub-batching is still to port).")
    MAX_INFLIGHT_STEPS = ConfigOption(
        "pipeline.max-inflight-steps", 3,
        "Device steps (uploads + apply launches) allowed in flight "
        "before ingest waits on the oldest one's CUDA event.")
    FIRE_GATE = ConfigOption(
        "pipeline.fire-gate", True,
        "Fire-gated fused steps: a host-fed top-n batch's one-upload "
        "fused step skips its fire on the card when its header lists no "
        "window end, and its purge when the clear mask is empty, and "
        "sizes its fire to the ends it has. Committed output is the same "
        "either way; false runs the fire and purge at full width on every "
        "step.")
    EXCHANGE_CAPACITY = ConfigOption(
        "pipeline.exchange-capacity", 0,
        "Per-(source, destination) bucket capacity of the keyBy "
        "exchange of a key-sharded operator, in records. Bounds the "
        "exchange buffer to devices x capacity per device. 0 = auto "
        "(per-device block size: can never overflow). When set, batches "
        "are SPLIT on the host so no bucket can exceed it — skewed keys "
        "cost extra steps, never data (ref: credit-based flow control's "
        "no-loss property).")


class StateOptions:
    NUM_KEY_SHARDS = ConfigOption(
        "state.num-key-shards", 128,
        "Fixed hash space of key shards (key = splitmix64 % shards).")
    SLOTS_PER_SHARD = ConfigOption(
        "state.slots-per-shard", 4096,
        "Distinct keys a shard can hold; shards x slots bounds the "
        "resident key count on the device.")
    BACKEND = ConfigOption(
        "state.backend", "hbm",
        "Keyed state backend: 'hbm' (dense pane tensors on the device) "
        "or 'spill' (keys past the device's slots aggregate exactly in a "
        "host store, state/spill.py). 'lsm', the disk-backed spill tier, "
        "is still to port.")
    ALLOW_DROPS = ConfigOption(
        "state.allow-drops", False,
        "When a key shard is full under state.backend='hbm', the default "
        "fails the job; true drops the overflow keys' records and counts "
        "them (records_dropped_full).")


BACKENDS = ("hbm", "spill", "lsm")


class ClusterOptions:
    MESH_DEVICES = ConfigOption(
        "cluster.mesh-devices", "",
        "Operator parallelism over a mesh of device blocks: '' = "
        "single-device local execution, 'all' = every visible device, "
        "an integer N = the first N devices. Each block owns "
        "num-key-shards/N contiguous key shards (the key-group range of "
        "its 'subtask'); keyed records reach their owner through the "
        "keyBy exchange (ref: parallelism.default + slot assignment, "
        "KeyGroupRangeAssignment).")
    NUM_PROCESSES = ConfigOption(
        "cluster.num-processes", 1,
        "Host-process count of ONE job. Only 1 is ported: the hybrid "
        "mesh across processes (the DCN tier) is still to port.")
    EXCHANGE_IMPL = ConfigOption(
        "exchange.impl", "all-to-all",
        "Keyed-exchange pattern (the Shuffle SPI seam, ref: "
        "runtime/shuffle ShuffleMaster/ShuffleEnvironment): "
        "'all-to-all' = every block's buckets straight to their owners; "
        "'ring' = N neighbour hops around the ring of blocks. "
        "Third-party implementations register via "
        "exchange.spi.register_shuffle.")


class AnalysisOptions:
    FAIL_ON = ConfigOption(
        "analysis.fail-on", "error",
        "'error' | 'warn' | 'off'. The plan analyzer is not ported yet "
        "(ROADMAP); the port checks the value and otherwise rejects "
        "every unsupported plan or option at build time, whatever the "
        "threshold.")


FAIL_ON_VALUES = ("error", "warn", "off")


class Configuration:
    """Key→value store over the registered options."""

    def __init__(self, values: Optional[Mapping[str, Any]] = None) -> None:
        self._values: Dict[str, Any] = dict(values or {})

    @classmethod
    def from_file(cls, path: str) -> "Configuration":
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        if text.lstrip().startswith("{"):
            return cls(json.loads(text))
        values: Dict[str, Any] = {}
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            sep = ":" if ":" in line else "=" if "=" in line else None
            if sep is None:
                continue
            k, _, v = line.partition(sep)
            values[k.strip()] = v.strip()
        return cls(values)

    def get(self, option: ConfigOption[T]) -> T:
        if option.key in self._values:
            return option.coerce(self._values[option.key])
        return option.default

    def set(self, option: "ConfigOption[Any] | str", value: Any) -> "Configuration":
        key = option.key if isinstance(option, ConfigOption) else option
        self._values[key] = value
        return self

    def validate(self) -> None:
        """Raise on any key the port does not read, and on values it
        cannot run."""
        unknown = [k for k in self._values if k not in _REGISTRY]
        if unknown:
            raise ValueError(
                f"configuration keys not supported by flink_tpu_torch: "
                f"{sorted(unknown)} (ported options: {sorted(_REGISTRY)}; "
                "see ROADMAP.md for what is still to port)")
        fail_on = str(self.get(AnalysisOptions.FAIL_ON)).strip().lower()
        if fail_on not in FAIL_ON_VALUES:
            raise ValueError(
                f"analysis.fail-on must be one of {FAIL_ON_VALUES}, "
                f"got {fail_on!r}")
        backend = str(self.get(StateOptions.BACKEND)).strip().lower()
        if backend not in BACKENDS:
            raise ValueError(f"state.backend must be 'hbm', 'spill' or "
                             f"'lsm', got {backend!r}")
        if backend == "lsm":
            raise NotImplementedError(
                "state.backend='lsm' (the disk-backed spill tier, "
                "state/lsm.py) is still to port: ROADMAP.md queue 1 item "
                "4.5; use 'spill'")
        k = int(self.get(PipelineOptions.SUB_BATCHES))
        if k < 1:
            raise ValueError(f"pipeline.sub-batches must be >= 1, got {k}")
        mb = int(self.get(PipelineOptions.MICROBATCH_SIZE))
        if mb % k:
            raise ValueError(
                f"pipeline.sub-batches ({k}) must divide "
                f"pipeline.microbatch-size ({mb}): sub-batches are equal "
                "slices of the logical batch")
        xcap = int(self.get(PipelineOptions.EXCHANGE_CAPACITY))
        if xcap < 0:
            raise ValueError(
                f"pipeline.exchange-capacity must be >= 0 (0 = auto), "
                f"got {xcap}")
        for opt in (PipelineOptions.MICROBATCH_SIZE,
                    PipelineOptions.MAX_INFLIGHT_STEPS,
                    StateOptions.NUM_KEY_SHARDS,
                    StateOptions.SLOTS_PER_SHARD):
            if int(self.get(opt)) < 1:
                raise ValueError(f"{opt.key} must be >= 1")

    def __repr__(self) -> str:  # pragma: no cover
        return f"Configuration({self._values!r})"
