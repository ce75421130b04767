"""StreamExecutionEnvironment: program entry; ``execute()`` lowers the
DAG and runs it on the local driver, on the card unless the caller asks
for the CPU. With ``cluster.mesh-devices`` set and more than one device
visible, the driver runs each keyed window over a mesh of device blocks
(``build_mesh_plan``). With ``cluster.num-processes`` > 1 the job spans
processes: each runs this program with its ``cluster.process-id`` and
the fleet's ``cluster.dcn-peers``, and owns its span of the key shards
(``runtime/driver.py``'s cross-process loop). ``set_runtime_mode("batch")``
(``execution.runtime-mode``) runs a bounded job in waves over blocking
exchanges, each stateful operator firing once. ``plugins.modules`` is
loaded when the environment is made, so a plugin's filesystem schemes
resolve for every path the job names."""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from flink_tpu_torch.api.datastream import DataStream
from flink_tpu_torch.api.sources import CollectionSource, Source
from flink_tpu_torch.config import (
    ClusterOptions, Configuration, CoreOptions, PipelineOptions, StateOptions)
from flink_tpu_torch.device import resolve_device
from flink_tpu_torch.graph.transformations import SourceTransformation, Transformation
from flink_tpu_torch.time.watermarks import WatermarkStrategy


class StreamExecutionEnvironment:
    def __init__(self, config: Optional[Configuration] = None):
        self.config = config or Configuration()
        self._transforms: List[Transformation] = []
        self._watermark_strategy = WatermarkStrategy.for_monotonous_timestamps()
        # plugin loading happens at env creation, where filesystem
        # schemes must be ready (ref: FileSystem.initialize at the
        # cluster entrypoint)
        mods = self.config.get(CoreOptions.PLUGINS)
        if mods:
            from flink_tpu_torch.fs import load_plugins

            load_plugins(mods.split(","))

    def from_source(self, source: Source,
                    watermark_strategy: Optional[WatermarkStrategy] = None,
                    name: str = "source") -> DataStream:
        t = SourceTransformation(name, (), source=source,
                                 watermark_strategy=watermark_strategy)
        self._register(t)
        return DataStream(self, t)

    def from_collection(self, data: Mapping[str, np.ndarray],
                        timestamps: np.ndarray,
                        batch_size: Optional[int] = None,
                        name: str = "collection") -> DataStream:
        bs = batch_size or self.config.get(PipelineOptions.MICROBATCH_SIZE)
        return self.from_source(
            CollectionSource(dict(data), np.asarray(timestamps, np.int64), bs),
            name=name)

    def _register(self, t: Transformation) -> None:
        self._transforms.append(t)

    def set_runtime_mode(self, mode: str) -> "StreamExecutionEnvironment":
        """'streaming' or 'batch' (``execution.runtime-mode``). Batch
        runs a bounded job, every source bounded, in topological waves
        over blocking columnar exchanges, each window firing once at the
        end of input; the plan's compilation checks it."""
        from flink_tpu_torch.config import ExecutionOptions

        self.config.set(ExecutionOptions.RUNTIME_MODE, mode)
        return self

    def compile_plan(self):
        """The lowered plan of the registered graph, without running it."""
        from flink_tpu_torch.graph.compiler import compile_job

        return compile_job(self._transforms, self._watermark_strategy,
                           self.config)

    def execute(self, job_name: str = "job",
                device: "str | torch.device" = "cuda",
                mesh_plan=None, transforms=None,
                savepoint_request=None) -> "JobResult":
        """Lower and run to completion on ``device`` ("cuda" by default;
        raises when there is no CUDA device — pass "cpu" explicitly).
        ``mesh_plan`` (``parallel.mesh.make_mesh_plan``, or across
        processes ``make_hybrid_mesh_plan``) places the keyed windows'
        device blocks explicitly, several on one device if need
        be; without it ``cluster.mesh-devices`` decides. ``transforms``
        restricts the run to a subset of the registered graph (the
        Table API runs one query's lineage, not every pipeline built on
        this environment). ``savepoint_request``: a ``threading.Event``
        the run polls at batch boundaries (``Driver.run``)."""
        from flink_tpu_torch.graph.compiler import compile_job
        from flink_tpu_torch.runtime.driver import Driver

        plan = compile_job(
            self._transforms if transforms is None else transforms,
            self._watermark_strategy, self.config)
        if mesh_plan is None:
            mesh_plan = self.build_mesh_plan(device)
        driver = Driver(plan, self.config, device=device, mesh_plan=mesh_plan)
        # the last run's driver (its checkpoint coordinator, registry)
        self._driver = driver
        return driver.run(job_name, savepoint_request=savepoint_request)

    def build_mesh_plan(self, device: "str | torch.device" = "cuda"):
        """The mesh of ``cluster.mesh-devices`` over the devices of
        ``device``'s kind that this process sees (``visible_devices``):
        None for local execution (the option empty, or one device); with
        ``cluster.num-processes`` > 1 this process's ``HybridMeshPlan``."""
        from flink_tpu_torch.parallel.mesh import (
            make_hybrid_mesh_plan, make_mesh_plan)

        spec = str(self.config.get(ClusterOptions.MESH_DEVICES)).strip()
        if not spec:
            return None
        devices = visible_devices(device)
        if spec != "all":
            n = int(spec)
            if n < 1:
                raise ValueError(
                    f"cluster.mesh-devices must be 'all' or a positive "
                    f"integer, got {spec!r}")
            if n > len(devices):
                raise ValueError(
                    f"cluster.mesh-devices={n} but only {len(devices)} "
                    "devices are visible")
            devices = devices[:n]
        if len(devices) == 1:
            return None  # a one-device mesh is local execution
        num_shards = int(self.config.get(StateOptions.NUM_KEY_SHARDS))
        slots = int(self.config.get(StateOptions.SLOTS_PER_SHARD))
        nproc = int(self.config.get(ClusterOptions.NUM_PROCESSES))
        if nproc > 1:
            # across processes: this process's blocks cover only its
            # span of the shards; records arrive already routed through
            # the cross-process exchange (the key directory keeps the
            # global shard space)
            return make_hybrid_mesh_plan(
                num_shards, slots, nproc,
                int(self.config.get(ClusterOptions.PROCESS_ID)), devices)
        return make_mesh_plan(num_shards, slots, devices)


def visible_devices(device: "str | torch.device" = "cuda"
                    ) -> List[torch.device]:
    """Every device of ``device``'s kind this process sees: each CUDA card,
    or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class JobResult:
    def __init__(self, job_name: str, metrics: Dict[str, Any]):
        self.job_name = job_name
        self.metrics = metrics

    def __repr__(self) -> str:
        return f"JobResult({self.job_name}, {self.metrics})"
