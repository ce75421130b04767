"""Host record helpers: the timestamp convention, the changelog op
column, the key hash that routes keys to key shards (bit-identical to
``flink_tpu.records.hash_keys_numpy``, so both packages assign the same
slots to the same keys; ``hash_keys_device`` is the same mix on the
card), the 63-bit FNV-1a hash of string keys (``hash_string_key``, which
the host codec's tokenizer and string hashes match bit for bit) and the
cast of record fields for upload."""
from __future__ import annotations

import numpy as np
import torch

# Timestamps are epoch milliseconds, int64. MIN_TS marks "no timestamp".
MIN_TS = np.int64(np.iinfo(np.int64).min)

# The changelog plane: a row's kind (Flink's RowKind) rides an ordinary
# int8 data column, ``__op__``, that only changelog streams carry. The
# codes are the JAX package's.
OP_FIELD = "__op__"
OP_DTYPE = np.int8
OP_INSERT = 0         # +I  first result for its key
OP_UPDATE_BEFORE = 1  # -U  retraction of the previously emitted row
OP_UPDATE_AFTER = 2   # +U  the replacement row
OP_DELETE = 3         # -D  final deletion for its key
OP_NAMES = ("+I", "-U", "+U", "-D")


def hash_keys_numpy(keys: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer of int64 keys, masked to 63 bits."""
    with np.errstate(over="ignore"):
        x = np.asarray(keys).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x & np.uint64(0x7FFFFFFFFFFFFFFF)).astype(np.int64)


def hash_string_key(s: str) -> int:
    """63-bit FNV-1a of a string key's UTF-8 bytes (the JAX package's
    ``hash_string_key``)."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


def hash_keys_device(keys: torch.Tensor) -> torch.Tensor:
    """``hash_keys_numpy`` on a tensor of int64 keys, on its device: the
    ``hash_keys`` kernel on the card, its plain version on the CPU."""
    from flink_tpu_torch.kernels.exchange_kernels import hash_keys

    return hash_keys(keys.contiguous())


def device_cast(arr: np.ndarray) -> np.ndarray:
    """A record field as it travels to the device: float64 becomes
    float32 (the lanes are f32); integer widths are kept."""
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        return arr.astype(np.float32)
    return arr
