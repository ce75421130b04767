"""Self-describing checkpoint blob format (format_version 3), byte for
byte the JAX package's, so a checkpoint written by either package loads
in the other. Snapshots stay readable across code changes and from
tooling that is not this package. v3 is:

    [8B magic b"FTCKPT3\\n"][u32 header_len][header JSON][array section]

The header's ``tree`` mirrors the payload structure as plain JSON with
tagged placeholders; numpy array leaves (and torch tensors, fetched
to the host) live in the array section
(raw C-order bytes, 64-byte-aligned offsets, dtype+shape in the
header's ``arrays`` table). Schema evolution = dict-field evolution:
readers use .get with defaults, unknown fields are preserved, and any
tool that can parse JSON + memmap raw arrays can read a savepoint.

Tags (JSON objects with one reserved key):
    {"__nd__": i}                     array-section index i
    {"__tup__": [...]}                tuple
    {"__kdict__": [[k, v], ...]}      dict with non-string keys
    {"__np__": [dtype, value]}        numpy scalar
    {"__bytes__": base64}             bytes
    {"__strs__": [shape, [str, ...]]} all-string object-dtype array
                                      (text columns; no pickle needed)
    {"__panestate__": {...}}          state.keyed.PaneState (the same
                                      four lanes in both packages)
    {"__pickle__": base64}            escape hatch for foreign objects
                                      (framework snapshots produce none
                                      — tests assert the counter stays
                                      zero; user-defined operator state
                                      may still need it)
"""
from __future__ import annotations

import base64
import json
import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

MAGIC = b"FTCKPT3\n"
_ALIGN = 64


class _Encoder:
    def __init__(self) -> None:
        self.arrays: List[np.ndarray] = []
        self.pickle_escapes = 0

    def enc(self, v: Any) -> Any:
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, bytes):
            return {"__bytes__": base64.b64encode(v).decode()}
        if isinstance(v, np.generic):
            return {"__np__": [str(v.dtype), v.item()]}
        if isinstance(v, np.ndarray):
            # object-dtype arrays have no raw-byte form — np.frombuffer
            # can't decode them, so the array section would produce an
            # unrestorable checkpoint. ALL-STRING object arrays (the
            # common case: text columns from socket/file sources) get a
            # native JSON tag, so they stay readable by foreign tooling
            # AND cross the pickle-rejecting DCN decoder
            # (allow_pickle=False); anything else still takes the
            # counted pickle escape hatch.
            if v.dtype.hasobject:
                flat = v.ravel()
                if all(isinstance(x, str) for x in flat):
                    return {"__strs__": [list(v.shape), list(flat)]}
                import pickle

                self.pickle_escapes += 1
                return {"__pickle__": base64.b64encode(pickle.dumps(
                    v, protocol=pickle.HIGHEST_PROTOCOL)).decode()}
            # ascontiguousarray promotes 0-d to (1,) — restore the shape
            self.arrays.append(np.ascontiguousarray(v).reshape(v.shape))
            return {"__nd__": len(self.arrays) - 1}
        if isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            self.arrays.append(np.ascontiguousarray(a).reshape(a.shape))
            return {"__nd__": len(self.arrays) - 1}
        if isinstance(v, tuple):
            return {"__tup__": [self.enc(x) for x in v]}
        if isinstance(v, list):
            return [self.enc(x) for x in v]
        if isinstance(v, dict):
            if all(isinstance(k, str) and not k.startswith("__") for k in v):
                return {k: self.enc(x) for k, x in v.items()}
            return {"__kdict__": [[self.enc(k), self.enc(x)]
                                  for k, x in v.items()]}
        pane = _as_panestate_fields(v)
        if pane is not None:
            return {"__panestate__": {k: self.enc(x)
                                      for k, x in pane.items()}}
        import pickle

        self.pickle_escapes += 1
        return {"__pickle__": base64.b64encode(
            pickle.dumps(v, protocol=pickle.HIGHEST_PROTOCOL)).decode()}


def _as_panestate_fields(v: Any):
    from flink_tpu_torch.state.keyed import PaneState

    if isinstance(v, PaneState):
        return {"sums": v.sums, "maxs": v.maxs, "mins": v.mins,
                "counts": v.counts}
    return None


def encode(payload: Any) -> bytes:
    """Payload tree → self-describing v3 bytes."""
    e = _Encoder()
    tree = e.enc(payload)
    offsets = []
    pos = 0
    for a in e.arrays:
        pos = (pos + _ALIGN - 1) // _ALIGN * _ALIGN
        offsets.append(pos)
        pos += a.nbytes
    header = json.dumps({
        "tree": tree,
        "arrays": [{"dtype": str(a.dtype), "shape": list(a.shape),
                    "offset": off, "nbytes": a.nbytes}
                   for a, off in zip(e.arrays, offsets)],
        "pickle_escapes": e.pickle_escapes,
    }).encode()
    # one copy of each array's bytes, in the join: the encode runs on the
    # checkpoint executor's thread holding the GIL, so every further pass
    # over the arrays stalls the driver loop
    parts = [MAGIC, struct.pack("<I", len(header)), header]
    end = 0
    for a, off in zip(e.arrays, offsets):
        parts.append(b"\0" * (off - end))
        parts.append(memoryview(a.reshape(-1).view(np.uint8)))
        end = off + a.nbytes
    return b"".join(parts)


class _Decoder:
    def __init__(self, arrays: List[np.ndarray],
                 allow_pickle: bool = True) -> None:
        self.arrays = arrays
        self.allow_pickle = allow_pickle

    def dec(self, v: Any) -> Any:
        if isinstance(v, list):
            return [self.dec(x) for x in v]
        if not isinstance(v, dict):
            return v
        if "__nd__" in v:
            return self.arrays[v["__nd__"]]
        if "__tup__" in v:
            return tuple(self.dec(x) for x in v["__tup__"])
        if "__kdict__" in v:
            # a tuple key round-trips through __tup__, so stays hashable
            return {self.dec(k): self.dec(x) for k, x in v["__kdict__"]}
        if "__np__" in v:
            dt, val = v["__np__"]
            return np.dtype(dt).type(val)
        if "__bytes__" in v:
            return base64.b64decode(v["__bytes__"])
        if "__panestate__" in v:
            from flink_tpu_torch.state.keyed import PaneState

            f = {k: self.dec(x) for k, x in v["__panestate__"].items()}
            return PaneState(sums=f.get("sums"), maxs=f.get("maxs"),
                             mins=f.get("mins"), counts=f.get("counts"))
        if "__strs__" in v:
            shape, items = v["__strs__"]
            a = np.empty(len(items), dtype=object)
            a[:] = items
            return a.reshape(shape)
        if "__pickle__" in v:
            if not self.allow_pickle:
                # a decoder fed from the network must never unpickle:
                # an attacker-controlled __pickle__ tag is arbitrary
                # code execution on load
                raise ValueError(
                    "__pickle__ escape rejected (allow_pickle=False): "
                    "payload carries a foreign object where only "
                    "framework-built arrays are expected")
            import pickle

            return pickle.loads(base64.b64decode(v["__pickle__"]))
        return {k: self.dec(x) for k, x in v.items()}


def read_header(raw: bytes) -> Tuple[Dict[str, Any], int]:
    """Parse just the JSON header without touching the array section.
    Returns (header, array_section_base_offset)."""
    if len(raw) < len(MAGIC) + 4 or raw[:len(MAGIC)] != MAGIC:
        raise ValueError("not a FTCKPT3 blob (bad magic)")
    hstart = len(MAGIC) + 4
    hlen = struct.unpack("<I", raw[len(MAGIC):hstart])[0]
    return json.loads(raw[hstart:hstart + hlen].decode()), hstart + hlen


def decode(raw: bytes, allow_pickle: bool = True) -> Any:
    """v3 bytes → payload tree (arrays are read-only views when the
    input buffer allows zero-copy). ``allow_pickle=False`` rejects the
    ``__pickle__`` escape — required for any decoder fed from the
    network (the cross-process exchange, ROADMAP.md queue 1 item 9.3)."""
    header, base = read_header(raw)
    arrays: List[np.ndarray] = []
    for spec in header["arrays"]:
        off = base + spec["offset"]
        a = np.frombuffer(raw, dtype=np.dtype(spec["dtype"]),
                          count=int(np.prod(spec["shape"], dtype=np.int64))
                          if spec["shape"] else 1,
                          offset=off).reshape(spec["shape"])
        arrays.append(a)
    return _Decoder(arrays, allow_pickle=allow_pickle).dec(header["tree"])


def is_v3(raw: bytes) -> bool:
    return raw[:len(MAGIC)] == MAGIC
