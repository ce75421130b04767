"""Typed configuration: the options this port reads, under the JAX
package's keys and with its defaults, so a conf written for
``flink_tpu`` runs here unchanged as long as it only uses what is
ported. A key the port does not know raises (``Configuration.validate``)
— it is never silently ignored.

Values come from ``key: value`` / ``key=value`` files or JSON objects
(``from_file``) and from explicit ``set``/constructor values, which
win. A key of a module still to port raises with the ``ROADMAP.md``
item that brings it (``LATER_KEYS``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Generic, Mapping, Optional, TypeVar

T = TypeVar("T")

_REGISTRY: Dict[str, "ConfigOption[Any]"] = {}


@dataclasses.dataclass(frozen=True)
class ConfigOption(Generic[T]):
    key: str
    default: T
    description: str = ""
    # how a string value reads (a duration); else the default's type
    parse: Optional[Callable[[str], T]] = None

    def __post_init__(self) -> None:
        _REGISTRY[self.key] = self

    def coerce(self, raw: Any) -> T:
        """File values arrive as strings; ``parse``, else the default's
        type, decides."""
        if not isinstance(raw, str):
            return raw
        if self.parse is not None:
            return self.parse(raw)
        if isinstance(self.default, bool):
            return raw.strip().lower() in ("1", "true", "yes", "on")  # type: ignore[return-value]
        if isinstance(self.default, int):
            return int(raw)  # type: ignore[return-value]
        return raw.strip()  # type: ignore[return-value]


def parse_duration_ms(raw: str) -> int:
    """'10 s', '500ms', '1 min' style durations in milliseconds; a bare
    number is milliseconds (the JAX package's reading of Flink's
    TimeUtils)."""
    raw = raw.strip().lower()
    units = (("milliseconds", 1), ("seconds", 1000), ("minutes", 60_000),
             ("hours", 3_600_000), ("days", 86_400_000), ("min", 60_000),
             ("sec", 1000), ("ms", 1), ("s", 1000), ("h", 3_600_000),
             ("d", 86_400_000))
    # the longest suffix first, so "ms" is not read as "s"
    for suffix, mult in units:
        if raw.endswith(suffix):
            return int(float(raw[:-len(suffix)].strip()) * mult)
    return int(float(raw))


def duration_option(key: str, default_ms: int,
                    description: str = "") -> ConfigOption[int]:
    return ConfigOption(key, default_ms, description, parse=parse_duration_ms)


READINESS_VALUES = ("piggyback", "probe")


class PipelineOptions:
    MICROBATCH_SIZE = ConfigOption(
        "pipeline.microbatch-size", 8192,
        "Records per batch for sources that batch a collection "
        "(from_collection).")
    SUB_BATCHES = ConfigOption(
        "pipeline.sub-batches", 1,
        "Sub-batch steps per logical batch: a device-made source chained "
        "into its window operator runs each logical batch as this many "
        "steps, each with its own watermark advance and fires; a host-fed "
        "batch is pushed as this many contiguous slices, each followed by "
        "a watermark advance and its fires (the same records in the same "
        "order, so the same committed rows). Must divide "
        "pipeline.microbatch-size.")
    MAX_INFLIGHT_STEPS = ConfigOption(
        "pipeline.max-inflight-steps", 3,
        "Device steps (uploads + apply launches) allowed in flight "
        "before ingest waits on the oldest one's CUDA event; scaled by "
        "pipeline.sub-batches, so the depth in logical batches stays.")
    READINESS = ConfigOption(
        "pipeline.readiness", "piggyback",
        "How the ingest throttle learns that an in-flight step completed, "
        "both by the CUDA event recorded behind the step: 'piggyback' "
        "blocks on it (Event.synchronize) and rate-matches after every "
        "sub-batch; 'probe' polls it (Event.query) and rate-matches a "
        "device-made chain at the last sub-batch of each logical batch "
        "only. Committed rows are the same either way.")
    AUTO_WATERMARK_INTERVAL = duration_option(
        "pipeline.auto-watermark-interval", 200,
        "Read and checked (a duration >= 0) as the JAX package declares "
        "it; neither driver reads it further: the watermark clock "
        "advances after every (sub-)batch.")
    OBJECT_REUSE = ConfigOption(
        "pipeline.object-reuse", True,
        "Read as the JAX package declares it (ingest buffers reused "
        "between steps); in both packages it changes nothing: the native "
        "lane's pinned buffers are reused either way, and a step's "
        "upload is the device's once it is queued.")
    SOURCE_PREFETCH = ConfigOption(
        "pipeline.source-prefetch", 2,
        "Batches each source split pulls ahead on a feeder thread, so "
        "record generation overlaps the loop's keying, upload and "
        "dispatch. 0 pulls each batch on the loop thread.")
    EMIT_DEFER_MS = duration_option(
        "pipeline.emit-defer", -1,
        "The least age of a fired batch before the loop delivers it, "
        "counted from the advance that fired it; a batch is delivered at "
        "the first loop pass after its device-to-host copy has landed and "
        "it has aged this long, in fire order, so only the time of "
        "delivery moves, never the rows or their order. A checkpoint "
        "barrier or end of input delivers at once. -1 (auto) and 0: no "
        "deferral (the JAX package's auto value times its drain thread's "
        "poll, 10 ms on an accelerator; the port delivers from the loop "
        "thread and has no such thread).")
    FIRE_GATE = ConfigOption(
        "pipeline.fire-gate", True,
        "Fire-gated fused steps: a host-fed top-n batch's one-upload "
        "fused step skips its fire on the card when its header lists no "
        "window end, and its purge when the clear mask is empty, and "
        "sizes its fire to the ends it has. Committed output is the same "
        "either way; false runs the fire and purge at full width on every "
        "step.")
    TARGET_LATENCY = duration_option(
        "pipeline.target-latency", 0,
        "Adaptive microbatch debloater (ref: BufferDebloater — auto-"
        "size in-flight buffers to hit a latency target): when > 0, the "
        "driver re-chunks source batches at ingest, halving the chunk "
        "while recent emit p99 exceeds the target and growing it back "
        "toward the source batch size while p99 sits under half the "
        "target. 0 = off (source batch size rules, maximum throughput).")
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
        "Keyed state backend: 'hbm' (dense pane tensors on the device), "
        "'spill' (keys past the device's slots aggregate exactly in a "
        "host store, state/spill.py) or 'lsm' (the disk-backed spill "
        "tier: memtable delta bounded by state.memory-budget-bytes, "
        "sealed into CRC'd columnar runs with changelog checkpoints, "
        "state/lsm.py).")
    MEMORY_BUDGET_BYTES = ConfigOption(
        "state.memory-budget-bytes", 64 * 1024 * 1024,
        "RAM ceiling for the in-memory delta (memtable) of the 'lsm' "
        "backend, per windowed operator; when the delta's pane tables "
        "exceed it, the delta is sealed into a sorted on-disk run. "
        "Ignored by 'hbm' and 'spill' (those hold all state resident). "
        "Must be at least state.lsm.run-floor-bytes.")
    LSM_DIR = ConfigOption(
        "state.lsm.dir", "/tmp/flink-tpu-state",
        "Root directory for 'lsm' backend run files; each operator "
        "instance gets a unique store subdirectory. Local filesystem "
        "only (runs are mmap'd for zero-copy scans).")
    LSM_COMPACT_MIN_RUNS = ConfigOption(
        "state.lsm.compact-min-runs", 4,
        "Sealed-run count that triggers a leveled compaction pass "
        "(k-way monoid merge of all live runs into one higher-level "
        "run, under the store's maintenance lock). Minimum 2.")
    # the plan analyzer's STATE_BUDGET_INVALID check of this floor comes
    # with ROADMAP.md queue 1 item 11; until then the key is read only
    LSM_RUN_FLOOR_BYTES = ConfigOption(
        "state.lsm.run-floor-bytes", 65536,
        "Smallest useful sealed-run size; a memory budget below this "
        "floor would seal degenerate runs on nearly every batch and is "
        "rejected at analysis time (STATE_BUDGET_INVALID).")
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
        "Host-process count of ONE job (the cross-process data plane): "
        "each process owns num-key-shards/N contiguous key shards; keyed "
        "records route to their owner through the per-step all-to-all "
        "(exchange/dcn.py), whose rendezvous also carries the global "
        "watermark, termination and checkpoint-alignment consensus.")
    PROCESS_ID = ConfigOption(
        "cluster.process-id", 0,
        "This process's index in [0, cluster.num-processes).")
    DCN_PEERS = ConfigOption(
        "cluster.dcn-peers", "",
        "Comma-separated host:port of every process's exchange "
        "listener, indexed by process id.")
    DCN_PORT = ConfigOption(
        "cluster.dcn-port", 0,
        "This process's exchange listen port (0 = ephemeral).")
    DCN_SECRET = ConfigOption(
        "cluster.dcn-secret", "",
        "Per-job shared secret authenticating the exchange handshake "
        "(HMAC over the hello; exchange/dcn.py). Empty = "
        "unauthenticated (single-host loopback only).")
    DCN_OVERLAP = ConfigOption(
        "cluster.dcn-overlap", True,
        "Step-overlapped exchange (exchange_async): the driver dispatches "
        "step N+1's frames before it consumes step N's, so the "
        "rendezvous overlaps the device work and the next step's routing. "
        "Committed output is identical; false consumes at dispatch (the "
        "lockstep loop).")
    DCN_OVERLAP_DRAIN = ConfigOption(
        "cluster.dcn-overlap-drain", True,
        "Drain the one in-flight overlapped step before snapshotting at "
        "a checkpoint barrier (the exactly-once contract: the cut covers "
        "every routed record). False skips the drain: a restore from "
        "such a checkpoint loses that step's records (at-most-once for "
        "it).")
    DCN_IO_THREADS = ConfigOption(
        "cluster.dcn-io-threads", 0,
        "Sender-worker threads of the exchange. 0 = one per peer; a "
        "positive value caps them, peers assigned round-robin, each "
        "peer's frames FIFO on one worker. Receive threads are always "
        "one per peer.")
    DCN_BUFFER_BYTES = ConfigOption(
        "cluster.dcn-buffer-bytes", 0,
        "SO_SNDBUF/SO_RCVBUF of every exchange socket, in bytes; 0 = the "
        "OS default.")
    RESCALE_FROM = ConfigOption(
        "cluster.rescale-from", "",
        "Deploy-injected by the coordinator after a process-level "
        "rescale: the savepoint path (p0's, for multi-process "
        "savepoints) the new topology was restored from. When a later "
        "attempt restores with execution.checkpointing.restore=latest "
        "and finds NO checkpoint newer than this savepoint (or none at "
        "all — the crash landed before the first post-rescale "
        "checkpoint published), the driver falls back to this path so "
        "recovery never resurrects a pre-rescale checkpoint written "
        "for the OLD key-group ownership, and never replays from "
        "scratch duplicating committed output. User configs never set "
        "it.")
    DCN_BIND = ConfigOption(
        "cluster.dcn-bind", "auto",
        "Address the exchange listener binds. 'auto' stays on 127.0.0.1 "
        "unless cluster.dcn-peers names another host, then 0.0.0.0; an "
        "explicit address overrides.")
    EXCHANGE_IMPL = ConfigOption(
        "exchange.impl", "all-to-all",
        "Keyed-exchange pattern (the Shuffle SPI seam, ref: "
        "runtime/shuffle ShuffleMaster/ShuffleEnvironment): "
        "'all-to-all' = every block's buckets straight to their owners; "
        "'ring' = N neighbour hops around the ring of blocks. "
        "Third-party implementations register via "
        "exchange.spi.register_shuffle.")


def default_host_parallelism() -> int:
    """``min(4, os.cpu_count())``, the JAX package's declared default."""
    return min(4, os.cpu_count() or 1)


class HostOptions:
    PARALLELISM = ConfigOption(
        "host.parallelism", default_host_parallelism(),
        "Worker threads of the driver's shared host pool "
        "(parallel/hostpool.py) running the host-resident operator "
        "paths: the key-sharded session span registry, the spill "
        "store's per-pane merges and per-window fires, and its chunked "
        "tree fold (windowAll's). 1 = the exact serial path (no pool "
        "threads). Default min(4, os.cpu_count()); a value below 1 fails "
        "when the driver builds its pool.")
    FOLD_CHUNK_RECORDS = ConfigOption(
        "host.fold-chunk-records", 1 << 18,
        "Batch-size floor (and chunk size) of the host spill store's "
        "tree fold: a batch below it absorbs in one pass; at or above it "
        "the batch splits into chunks of this many records whose pane "
        "partials combine in chunk order. The chunk size does not depend "
        "on host.parallelism, so the reduction tree and the output bytes "
        "do not change with the worker count. Must be >= 1.")


class CheckpointingOptions:
    INTERVAL = duration_option(
        "execution.checkpointing.interval", 0,
        "Checkpoint period in ms; 0 disables. The loop takes a checkpoint "
        "at the first batch boundary after the period, and a bounded job "
        "takes a final one at end of input.")
    DIRECTORY = ConfigOption(
        "execution.checkpointing.dir", "/tmp/flink-tpu-checkpoints",
        "Checkpoint storage root: <dir>/<job name>/chk-<id>/.")
    RETAINED = ConfigOption(
        "execution.checkpointing.num-retained", 3,
        "Completed checkpoints kept.")
    INCREMENTAL = ConfigOption(
        "execution.checkpointing.incremental", True,
        "Hardlink the previous checkpoint's blob for an operator whose "
        "state_version is unchanged since it; false re-serializes every "
        "operator at every checkpoint.")
    COMPRESSION = ConfigOption(
        "execution.checkpointing.compression", "none",
        "Compress checkpoint files: 'none' or 'zlib'. Applied on the "
        "checkpoint executor's thread and recorded in the manifest.")
    RESTORE = ConfigOption(
        "execution.checkpointing.restore", "",
        "'' (fresh start), 'latest' (the newest complete checkpoint of "
        "this job) or a checkpoint/savepoint directory.")
    TOLERABLE_FAILURES = ConfigOption(
        "execution.checkpointing.tolerable-failures", 0,
        "Consecutive periodic checkpoint persist/commit failures the job "
        "rides out; the staged 2PC epoch commits with the next checkpoint "
        "that succeeds. Savepoints and the final checkpoint never "
        "tolerate a failure.")


COMPRESSIONS = ("none", "zlib")


class RestartOptions:
    STRATEGY = ConfigOption(
        "restart-strategy.type", "exponential-delay",
        "fixed-delay | exponential-delay | failure-rate | none "
        "(runtime/restart.py; read by runtime/supervisor.py).")
    ATTEMPTS = ConfigOption(
        "restart-strategy.fixed-delay.attempts", 3,
        "Max restarts for the fixed-delay strategy.")
    DELAY = duration_option(
        "restart-strategy.fixed-delay.delay", 1_000,
        "Delay between restarts for the fixed-delay strategy.")


RESTART_STRATEGIES = ("fixed-delay", "exponential-delay", "failure-rate",
                      "none")


class MetricsOptions:
    PORT = ConfigOption(
        "metrics.port", 0,
        "Serve /metrics (Prometheus text) on this port while a job runs; "
        "0 disables.")
    BIND = ConfigOption(
        "metrics.bind-address", "127.0.0.1",
        "Interface the /metrics endpoint binds; loopback by default.")


class FaultOptions:
    SEED = ConfigOption(
        "faults.seed", 0,
        "Seed of the fault plan's per-point PRNG streams (faults.py).")
    INJECT = ConfigOption(
        "faults.inject", "",
        "Fault rules, ';'-separated: 'point=kind [@prob] [xCOUNT] "
        "[+AFTER] [~DELAY_MS]', kind raise|drop|delay|crash. Empty = no "
        "injection.")


class MemoryOptions:
    HBM_BUDGET = ConfigOption(
        "memory.hbm-budget", 0,
        "Plan-time per-device budget in bytes for the operators' device "
        "tensors (pane lanes, emit rings, step buffers); a job over it "
        "fails at build with a per-operator breakdown. 0 = unlimited.")


class AnalysisOptions:
    FAIL_ON = ConfigOption(
        "analysis.fail-on", "error",
        "'error' | 'warn' | 'off'. The plan analyzer is not ported yet "
        "(ROADMAP); the port checks the value and otherwise rejects "
        "every unsupported plan or option at build time, whatever the "
        "threshold.")


FAIL_ON_VALUES = ("error", "warn", "off")

# keys of modules still to port, by prefix (or whole key), with the
# ROADMAP.md item that brings each
LATER_KEYS = (
    ("plugins.modules", "queue 1 item 6"),
    ("table.", "queue 1 item 7"),
    ("sql.", "queue 1 item 7"),
    ("log.", "queue 1 item 8"),
    ("storage.enospc-", "queue 1 item 8"),
    ("execution.runtime-mode", "queue 1 item 8"),
    ("execution.batch.", "queue 1 item 8"),
    ("cluster.dcn-host", "queue 1 item 10"),
    ("cluster.dcn-rendezvous", "queue 1 item 10"),
    ("session.", "queue 1 item 10"),
    ("heartbeat.", "queue 1 item 10"),
    ("high-availability.", "queue 1 item 10"),
    ("rescale.", "queue 1 item 10"),
    ("source.enumeration", "queue 1 item 10"),
    ("cluster.attempt", "queue 1 item 10"),
    ("cluster.coordinator", "queue 1 item 10"),
    ("cluster.job-id", "queue 1 item 10"),
    ("cluster.runner-id", "queue 1 item 10"),
    ("analysis.max-state-bytes-per-key", "queue 1 item 11"),
    ("pipeline.profile-", "queue 1 item 11"),
)


def later_item(key: str) -> Optional[str]:
    """The ROADMAP.md item that ports ``key``'s module, or None."""
    for prefix, item in LATER_KEYS:
        if key == prefix or (prefix.endswith((".", "-"))
                             and key.startswith(prefix)):
            return item
    return None


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

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def set(self, option: "ConfigOption[Any] | str", value: Any) -> "Configuration":
        key = option.key if isinstance(option, ConfigOption) else option
        self._values[key] = value
        return self

    def validate(self) -> None:
        """Raise on any key the port does not read, and on values it
        cannot run."""
        later = {k: later_item(k) for k in self._values
                 if k not in _REGISTRY and later_item(k)}
        if later:
            raise NotImplementedError(
                "configuration keys of modules still to port: " + "; ".join(
                    f"{k} (ROADMAP.md {item})"
                    for k, item in sorted(later.items())))
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
        k = int(self.get(PipelineOptions.SUB_BATCHES))
        if k < 1:
            raise ValueError(f"pipeline.sub-batches must be >= 1, got {k}")
        mb = int(self.get(PipelineOptions.MICROBATCH_SIZE))
        if mb % k:
            raise ValueError(
                f"pipeline.sub-batches ({k}) must divide "
                f"pipeline.microbatch-size ({mb}): sub-batches are equal "
                "slices of the logical batch")
        readiness = str(self.get(PipelineOptions.READINESS)).strip().lower()
        if readiness not in READINESS_VALUES:
            raise ValueError(
                f"pipeline.readiness must be 'piggyback' or 'probe', "
                f"got {readiness!r}")
        if int(self.get(PipelineOptions.AUTO_WATERMARK_INTERVAL)) < 0:
            raise ValueError("pipeline.auto-watermark-interval must be a "
                             "duration >= 0")
        if int(self.get(PipelineOptions.SOURCE_PREFETCH)) < 0:
            raise ValueError("pipeline.source-prefetch must be >= 0 "
                             "(0 = no feeder thread)")
        defer = int(self.get(PipelineOptions.EMIT_DEFER_MS))
        if defer < -1:
            raise ValueError(f"pipeline.emit-defer must be -1 (auto) or a "
                             f"duration >= 0, got {defer} ms")
        xcap = int(self.get(PipelineOptions.EXCHANGE_CAPACITY))
        if xcap < 0:
            raise ValueError(
                f"pipeline.exchange-capacity must be >= 0 (0 = auto), "
                f"got {xcap}")
        comp = str(self.get(CheckpointingOptions.COMPRESSION))
        if comp not in COMPRESSIONS:
            raise ValueError(f"execution.checkpointing.compression must be "
                             f"'none' or 'zlib', got {comp!r}")
        if int(self.get(CheckpointingOptions.INTERVAL)) < 0:
            raise ValueError("execution.checkpointing.interval must be a "
                             "duration >= 0 (0 disables)")
        if int(self.get(CheckpointingOptions.TOLERABLE_FAILURES)) < 0:
            raise ValueError(
                "execution.checkpointing.tolerable-failures must be >= 0")
        strategy = str(self.get(RestartOptions.STRATEGY))
        if strategy not in RESTART_STRATEGIES:
            raise ValueError(f"restart-strategy.type must be one of "
                             f"{RESTART_STRATEGIES}, got {strategy!r}")
        if int(self.get(MemoryOptions.HBM_BUDGET)) < 0:
            raise ValueError("memory.hbm-budget must be >= 0 (0 = unlimited)")
        nproc = int(self.get(ClusterOptions.NUM_PROCESSES))
        if nproc < 1:
            raise ValueError("cluster.num-processes must be >= 1")
        pid = int(self.get(ClusterOptions.PROCESS_ID))
        if not 0 <= pid < nproc:
            raise ValueError(f"cluster.process-id ({pid}) must be in [0, "
                             f"cluster.num-processes={nproc})")
        if not 0 <= int(self.get(ClusterOptions.DCN_PORT)) < 65536:
            raise ValueError("cluster.dcn-port must be a port number "
                             "(0 = ephemeral)")
        for opt in (ClusterOptions.DCN_IO_THREADS,
                    ClusterOptions.DCN_BUFFER_BYTES):
            if int(self.get(opt)) < 0:
                raise ValueError(f"{opt.key} must be >= 0 (0 = auto)")
        if not 0 <= int(self.get(MetricsOptions.PORT)) < 65536:
            raise ValueError("metrics.port must be a port number (0 = off)")
        for opt in (PipelineOptions.MICROBATCH_SIZE,
                    PipelineOptions.MAX_INFLIGHT_STEPS,
                    StateOptions.NUM_KEY_SHARDS,
                    StateOptions.SLOTS_PER_SHARD):
            if int(self.get(opt)) < 1:
                raise ValueError(f"{opt.key} must be >= 1")

    def __repr__(self) -> str:  # pragma: no cover
        return f"Configuration({self._values!r})"
