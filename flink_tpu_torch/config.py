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


class CoreOptions:
    PLUGINS = ConfigOption(
        "plugins.modules", "",
        "Comma-separated module names loaded at environment creation; "
        "each must expose register(registry) extending the FileSystem "
        "scheme registry (ref: core/plugin/PluginManager + "
        "FileSystemFactory SPI; see flink_tpu/fs.py).")


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


class ExecutionOptions:
    RUNTIME_MODE = ConfigOption(
        "execution.runtime-mode", "streaming",
        "'streaming' (default): one pipelined region, per-microbatch "
        "watermark advance, continuous window fires. 'batch': bounded "
        "execution (ref: execution.runtime-mode=BATCH, SURVEY §3.7) — "
        "requires every source to report bounded=True; the compiler "
        "marks stage-boundary edges BLOCKING, stages run in topological "
        "waves (runtime/scheduler.py), each upstream stage materializes "
        "its full output to columnar partition files "
        "(exchange/blocking.py + formats_columnar.py), and stateful "
        "operators fire exactly once at end-of-input (no per-step fire "
        "scans). Recovery is re-execution: checkpointing/restore are "
        "rejected in this mode. Honest scope: no sort-merge spill, no "
        "speculative execution (SURVEY §3.7 SPMD rationale).")
    BATCH_SHUFFLE_DIR = ConfigOption(
        "execution.batch.shuffle-dir", "/tmp/flink-tpu-shuffle",
        "Root directory for blocking-shuffle partition files of batch "
        "(bounded-mode) jobs. Node-local scratch space — the analogue "
        "of io.tmp.dirs for BoundedBlockingSubpartition spill files; "
        "each run spools under a unique subdirectory.")
    BATCH_SHUFFLE_PARTITIONS = ConfigOption(
        "execution.batch.shuffle-partitions", 1,
        "Partition files per KEYED blocking edge: records hash-route "
        "by key (the same hash as the runtime exchange) so each file "
        "holds a disjoint key range, preserving per-key record order. "
        "Non-keyed edges always spool to a single file.")
    BATCH_SHUFFLE_CLEANUP = ConfigOption(
        "execution.batch.shuffle-cleanup", True,
        "Delete the run's shuffle spool directory when the job ends "
        "(success or failure). Set false to keep partition files for "
        "inspection.")


class LogOptions:
    DIR = ConfigOption(
        "log.dir", "/tmp/flink-tpu-log",
        "Root directory for embedded durable-log topics (log/"
        "— the job-chaining exchange plane, the Kafka role without a "
        "broker process). LogSink.from_config resolves a topic name "
        "under this root; any registered FileSystem scheme works. Jobs "
        "chained through one topic must share this filesystem.")
    PARTITIONS = ConfigOption(
        "log.partitions", 1,
        "Default partition count for topics created by "
        "LogSink.from_config. Partitions are the source-split unit of "
        "LogSource (one replayable split per partition); records "
        "hash-route by the sink's key_field, so each partition holds a "
        "disjoint key range and per-key order is preserved. Fixed at "
        "topic creation — reopening with a different count fails "
        "loudly (offsets are per-partition).")
    SEGMENT_RECORDS = ConfigOption(
        "log.segment-records", 65536,
        "Records per appended log segment before the appender rolls to "
        "a new file within one transaction. Every segment is written "
        "sealed (columnar footer + fsync) at pre-commit, so this is "
        "also the recovery/replay granularity of a topic partition.")
    FSYNC_MODE = ConfigOption(
        "log.fsync-mode", "group",
        "Segment durability discipline at transaction pre-commit: "
        "'group' (default) writes every staged segment first and runs "
        "ONE group-commit fsync pass over all of them strictly before "
        "the pre-commit marker publishes (fsyncs overlap through the "
        "host pool on multi-partition topics); 'segment' is the legacy "
        "fsync-per-file-at-write discipline. The 2PC crash-window "
        "semantics are identical: the marker rename — the point after "
        "which a transaction is recoverable — always strictly follows "
        "every segment fsync.")
    ZERO_COPY = ConfigOption(
        "log.zero-copy", True,
        "LogSource decode mode: true mmaps sealed local-fs segments "
        "and returns fixed-width columns as read-only np.frombuffer "
        "views (no read() image copy, no per-column decode copy; "
        "block CRCs still verified, corruption/truncation exactly as "
        "loud). false is the legacy copying decode. Non-local schemes "
        "and big-endian hosts degrade to copying automatically.")
    READ_BATCH_RECORDS = ConfigOption(
        "log.read-batch-records", 262_144,
        "LogSource read-batch coalescing target: on-disk blocks merge "
        "until a batch holds at least this many rows before entering "
        "the pipeline — small sealed blocks otherwise starve the "
        "device path with tiny dispatches. Replay "
        "positions advance at merged-batch boundaries and stay "
        "checkpoint-exact. 0 = per-block reads (the legacy "
        "granularity).")
    PREFETCH_SEGMENTS = ConfigOption(
        "log.prefetch-segments", 1,
        "Merged read batches the LogSource decodes ahead on a feeder "
        "thread while the pipeline consumes the current one (the "
        "cluster.dcn-overlap shape at the segment-read seam; 1 = "
        "double-buffered). 0 disables — reads run inline on the "
        "consuming thread. Positions stay checkpoint-exact: only "
        "consumed batches advance them, a restore re-reads from the "
        "frozen offset.")
    COMPACTION_KEY_FIELD = ConfigOption(
        "log.compaction.key-field", "",
        "Key column for latest-wins key compaction (log/bus.py "
        "Compactor): sealed committed segments below the safety floor "
        "are rewritten keeping only the latest committed row per key, "
        "original offsets preserved. Empty = the key_field recorded in "
        "the topic's meta.json at creation (the sink's routing key).")
    COMPACTION_MIN_SEGMENTS = ConfigOption(
        "log.compaction.min-segments", 2,
        "Only compact a partition when at least this many sealed "
        "committed segments sit wholly below the safety floor — a "
        "single segment gains nothing from a rewrite; raising it "
        "amortizes rewrite I/O over more input (the Kafka "
        "min.cleanable.dirty.ratio role, count-based).")
    RETENTION_MS = ConfigOption(
        "log.retention.ms", 0,
        "Retention window: whole sealed segments whose newest row is "
        "older than this (by the topic's ts column) are dropped, but "
        "NEVER above the safety floor (lowest consumer-group committed "
        "offset / open pre-commit marker). 0 = keep forever.")
    RETENTION_TS_FIELD = ConfigOption(
        "log.retention.ts-field", "",
        "Event-time column used by log.retention.ms: a segment's age "
        "is now minus its newest row's value in this column. Required "
        "whenever log.retention.ms > 0 — a time-retention pass "
        "without it fails loudly (size-only retention leaves both "
        "unset).")
    RETENTION_BYTES = ConfigOption(
        "log.retention.bytes", 0,
        "Per-partition size budget: oldest whole sealed segments are "
        "dropped until the partition fits, subject to the same safety "
        "floor as log.retention.ms. 0 = unbounded.")
    LEASE_TTL_MS = ConfigOption(
        "log.lease.ttl-ms", 30_000,
        "Per-partition writer-lease time-to-live (log/bus.py "
        "LeaseManager). A producer renews its leases at every stage/"
        "commit; a lease this stale is expired and another producer "
        "may take the partition over with a bumped fencing epoch — "
        "the deposed holder's late writes are rejected by epoch.")
    GROUP_NAME = ConfigOption(
        "log.group.name", "",
        "Consumer-group name for LogSource.from_config: members share "
        "a topic with per-partition committed offsets published at "
        "checkpoint complete (the compaction/retention safety floor "
        "and the cross-generation resume point). Empty = no group "
        "(anonymous reader, offsets live only in the job checkpoint).")
    GROUP_MEMBER = ConfigOption(
        "log.group.member", 0,
        "This reader's member index within log.group.members: static "
        "partition assignment p % members == member (disjoint, "
        "deterministic — no broker to rebalance).")
    GROUP_MEMBERS = ConfigOption(
        "log.group.members", 1,
        "Total members in the consumer group; together with "
        "log.group.member this fixes the partition assignment. All "
        "members of one group must agree on this count.")
    GROUP_MEMBER_ID = ConfigOption(
        "log.group.member-id", "",
        "DYNAMIC membership: a non-empty id makes LogSource.from_config "
        "join the group's durable membership manifest at open "
        "(idempotent re-join on restart) and derive its partition "
        "assignment from the manifest's sorted member list — the "
        "generation-fenced rebalance protocol, instead of the static "
        "log.group.member/members pair. Offset commits are keyed by "
        "the joined generation; a member deposed by a rebalance it "
        "missed has its late commit rejected at the fence. Members "
        "leave explicitly (ConsumerGroups.leave / the log CLI), not on "
        "close — a restart must keep its seat.")
    CLEANER_ENABLED = ConfigOption(
        "log.cleaner.enabled", False,
        "Run the driver-owned background cleaner service "
        "(log/cleaner.py): one maintenance thread per log topic the "
        "job writes, executing compaction + retention per the "
        "log.compaction.*/log.retention.* grammar at "
        "log.cleaner.interval-ms cadence under a fenced cleaner lease "
        "and the per-topic maintenance lock. False (default) keeps "
        "maintenance an explicit CLI invocation (`log TOPIC --compact/"
        "--retain`).")
    CLEANER_INTERVAL_MS = ConfigOption(
        "log.cleaner.interval-ms", 30_000,
        "Cadence of the background cleaner's maintenance passes per "
        "topic (the Kafka log.cleaner backoff role). Each pass runs "
        "compaction then retention below the safety floor; readers "
        "and leased producers race it freely — the manifest-swap "
        "discipline keeps their reads byte-identical.")
    CLEANER_LEASE_TTL_MS = ConfigOption(
        "log.cleaner.lease-ttl-ms", 60_000,
        "Time-to-live of the fenced cleaner lease (cleaner.lease in "
        "the topic dir): exactly one cleaner service owns a topic's "
        "maintenance at a time, a crashed cleaner's lease expires "
        "after this, and a deposed cleaner's late pass dies at its "
        "next lease verify (the writer-lease epoch discipline).")



class StorageOptions:
    """The durable-storage degradation grammar (fs.py): how
    the FileSystem seam behaves when the disk itself fails under a
    write — the crash-consistency plane's runtime half."""

    ENOSPC_POLICY = ConfigOption(
        "storage.enospc-policy", "retry",
        "How a durable write seam (checkpoint persist, log segment "
        "stage, sink part write — everything routed through "
        "fs.write_atomic/enospc_retry) handles OSError(ENOSPC): "
        "'retry' (default) re-attempts the whole-file write with "
        "bounded backoff (retention/rotation may free space between "
        "attempts; every re-attempt counts on the "
        "storage.enospc_retries metric, exhausted budgets count toward "
        "execution.checkpointing.tolerable-failures like any persist "
        "failure) or 'fail' (propagate immediately). Either way the "
        "tmp+fsync+rename discipline guarantees no torn file at a "
        "final name.")
    ENOSPC_RETRIES = ConfigOption(
        "storage.enospc-retries", 4,
        "Bounded retry budget per whole-file write under "
        "storage.enospc-policy=retry (0 behaves like 'fail').")
    ENOSPC_BACKOFF_MS = ConfigOption(
        "storage.enospc-backoff-ms", 50.0,
        "First retry delay in ms under storage.enospc-policy=retry; "
        "doubles per attempt.")


FAIL_ON_VALUES = ("error", "warn", "off")

# keys of modules still to port, by prefix (or whole key), with the
# ROADMAP.md item that brings each
LATER_KEYS = (
    ("cluster.dcn-host", "queue 1 item 10"),
    ("cluster.dcn-rendezvous", "queue 1 item 10"),
    ("session.", "queue 1 item 10"),
    ("heartbeat.", "queue 1 item 10"),
    ("high-availability.", "queue 1 item 10"),
    ("rescale.", "queue 1 item 10"),
    ("source.enumeration", "queue 1 item 10"),
    # the attempt's fencing epoch; until it comes the driver announces
    # epoch 0 to the sinks, the reference's default
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
