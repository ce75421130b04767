"""Sources: numbered host numpy batches per split, replayable from a
position (the batch index by default, ``Source.position_after``): a
checkpoint records each split's position, and a restore reopens the
split there. A source declares whether it ends (``bounded``, read
through ``source_is_bounded``); batch mode runs bounded sources only."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

Batch = Tuple[Dict[str, np.ndarray], np.ndarray]  # (data fields, timestamps)


def source_is_bounded(source: "Source") -> bool:
    """Whether ``source`` ends. ``bounded`` is a property on the
    package's sources; a user's source may spell it as a method, which
    is called rather than read as a truthy bound method."""
    b = source.bounded
    return bool(b() if callable(b) else b)


class Source:
    def splits(self) -> List[str]:
        return ["0"]

    def open_split(self, split: str, start_pos: int = 0) -> Iterator[Batch]:
        raise NotImplementedError

    def position_after(self, pos: int, data, ts) -> int:
        """Replay position after consuming one batch that started at
        ``pos``. Positions are the source's to define; the default
        counts batches (an offset-addressed source would count
        records)."""
        return pos + 1

    @property
    def bounded(self) -> bool:
        return True


@dataclasses.dataclass
class CollectionSource(Source):
    """In-memory bounded source cut into batches of ``batch_size``."""

    data: Mapping[str, np.ndarray]
    timestamps: np.ndarray
    batch_size: int = 8192

    def open_split(self, split: str, start_pos: int = 0) -> Iterator[Batch]:
        n = len(self.timestamps)
        for s in range(start_pos * self.batch_size, n, self.batch_size):
            e = min(s + self.batch_size, n)
            yield ({k: np.asarray(v[s:e]) for k, v in self.data.items()},
                   np.asarray(self.timestamps[s:e], dtype=np.int64))


@dataclasses.dataclass
class GeneratorSource(Source):
    """``gen(split, batch_index)`` returns a batch, or None at the end of
    the split; deterministic in (split, index), so replay reproduces the
    stream."""

    gen: Callable[[str, int], Optional[Batch]]
    n_splits: int = 1
    # False declares a generator that never ends (refused in batch mode)
    is_bounded: bool = True

    def splits(self) -> List[str]:
        return [str(i) for i in range(self.n_splits)]

    @property
    def bounded(self) -> bool:
        return self.is_bounded

    def open_split(self, split: str, start_pos: int = 0) -> Iterator[Batch]:
        i = start_pos
        while True:
            b = self.gen(split, i)
            if b is None:
                return
            yield b
            i += 1


@dataclasses.dataclass
class DeviceGeneratorSource(GeneratorSource):
    """A generator source whose batches can be made on the card, inside
    the consuming window operator's step (the driver chains it there),
    so no record crosses to the host.

    Contract:

    - ``device_keys_ts(batch_index, device)`` returns the batch's int64
      ``(keys, ts)`` tensors on ``device``; ``keys_ts_host(batch_index)``
      returns the same two arrays in numpy, bit for bit (the host copy
      repairs device-side key misses).
    - ``ts_bounds(batch_index)`` is the batch's exact ``(min_ts,
      max_ts)``, so the driver runs the watermark clock without the
      device.
    - ``gen(split, batch_index)`` materializes the full record batch for
      when the chain cannot take it (a devgen gate closed).
    - ``key_domain``: keys in ``[0, key_domain)`` map to slot == key on
      the device (``KeyDirectory.register_dense``); others are repaired
      on the host. ``None`` disables the chain. ``keys_bounded``
      declares that every key lies in the domain by construction, which
      lets the operator skip the per-step stats copy when no late or
      re-fire work is possible either.
    - ``subdivide(k)`` returns the same record stream at
      ``batch_size / k`` granularity (sub-batch ``j`` of logical batch
      ``i`` is batch ``i * k + j``); ``None`` = cannot re-slice.
    """

    device_keys_ts: Optional[Callable] = None
    keys_ts_host: Optional[Callable] = None
    ts_bounds: Optional[Callable] = None
    key_field: str = "key"
    batch_size: int = 8192
    n_batches: int = 0
    key_domain: Optional[int] = None
    keys_bounded: bool = False
    subdivide: Optional[Callable[[int], "DeviceGeneratorSource"]] = None

    def subdivided(self, k: int) -> "DeviceGeneratorSource":
        """The same stream at ``batch_size / k`` granularity. Raises when
        the source declares no subdivision or ``k`` does not divide the
        batch size."""
        if k < 1:
            raise ValueError(f"sub-batch count must be >= 1, got {k}")
        if k == 1:
            return self
        if self.subdivide is None:
            raise ValueError(
                "this DeviceGeneratorSource declares no subdivide "
                "callable — it cannot re-slice its stream")
        if self.batch_size % k:
            raise ValueError(
                f"pipeline.sub-batches={k} does not divide the device "
                f"source's batch_size={self.batch_size}")
        return self.subdivide(k)

    def splits(self) -> List[str]:
        return ["0"]  # device chaining is single-split by construction
