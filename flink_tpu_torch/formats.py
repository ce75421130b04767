"""Record formats: text bytes to typed column batches and back, the JAX
package's ``formats`` (the CSV and JSON-lines halves of the file
connectors). A format's unit is a column batch, never a record: CSV
parses a whole block of lines in one pass of the host codec's C parsers
when every column is i64 or every column is f32, and renders all-i64
batches through its row encoder, so the bytes equal the JAX package's
for the same batch. ``ColumnarFormat`` (``formats_columnar.py``) is the
binary format.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np

__all__ = ["Format", "CsvFormat", "JsonLinesFormat"]

Batch = Dict[str, np.ndarray]

_TYPES = ("i64", "f32", "str")


class Format:
    """A (de)serialization schema: ``fields`` names the columns in order,
    ``deserialize`` parses a block of bytes, ``serialize`` renders a
    batch. ``binary`` is False for line-framed text (a file source cuts
    it on newlines) and True for a self-framing format, which iterates
    its own blocks (``iter_batches``)."""

    fields: Tuple[str, ...]
    binary = False

    def deserialize(self, data: bytes) -> Batch:  # pragma: no cover
        raise NotImplementedError

    def serialize(self, batch: Batch) -> bytes:  # pragma: no cover
        raise NotImplementedError


def _schema(schema) -> Tuple[Tuple[str, str], ...]:
    return tuple((n, t) for n, t in schema)


def _text_lines(lines) -> bytes:
    return ("\n".join(lines) + ("\n" if lines else "")).encode()


@dataclasses.dataclass(frozen=True)
class CsvFormat(Format):
    """Delimited text with a schema of (name, 'i64' | 'f32' | 'str')
    columns. All-i64 and all-f32 schemas parse in C; a mixed schema
    parses column by column in Python."""

    schema: Tuple[Tuple[str, str], ...]
    delimiter: str = ","

    def __init__(self, schema, delimiter: str = ",") -> None:
        object.__setattr__(self, "schema", _schema(schema))
        object.__setattr__(self, "delimiter", delimiter)
        for _, t in self.schema:
            if t not in _TYPES:
                raise ValueError(f"unknown column type {t!r} "
                                 f"(i64/f32/str)")

    @property
    def fields(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.schema)

    def _types(self):
        return [t for _, t in self.schema]

    def deserialize(self, data: bytes) -> Batch:
        from flink_tpu_torch import native_codec

        types = self._types()
        names = self.fields
        for t, parse in (("i64", native_codec.parse_i64_table),
                         ("f32", native_codec.parse_f32_table)):
            if all(x == t for x in types):
                table = parse(data, len(names), delim=self.delimiter)
                return {n: table[:, i].copy() for i, n in enumerate(names)}
        rows = [ln.split(self.delimiter)
                for ln in data.decode("utf-8").splitlines() if ln]
        out: Batch = {}
        for i, (n, t) in enumerate(self.schema):
            col = [r[i] if i < len(r) else "" for r in rows]
            if t == "i64":
                out[n] = np.array([int(c or 0) for c in col], np.int64)
            elif t == "f32":
                out[n] = np.array([float(c or 0) for c in col], np.float32)
            else:
                out[n] = np.array(col, dtype=object)
        return out

    def serialize(self, batch: Batch) -> bytes:
        from flink_tpu_torch import native_codec

        names = self.fields
        if all(t == "i64" for t in self._types()):
            table = np.stack(
                [np.asarray(batch[c], np.int64) for c in names], axis=1)
            return native_codec.encode_i64_rows(table, self.delimiter)
        cols = [batch[c] for c in names]
        n = len(cols[0]) if cols else 0
        return _text_lines([self.delimiter.join(str(col[i]) for col in cols)
                            for i in range(n)])


@dataclasses.dataclass(frozen=True)
class JsonLinesFormat(Format):
    """One JSON object a line, with a schema as ``CsvFormat``'s; a missing
    key reads as its type's zero."""

    schema: Tuple[Tuple[str, str], ...]

    def __init__(self, schema) -> None:
        object.__setattr__(self, "schema", _schema(schema))

    @property
    def fields(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.schema)

    def deserialize(self, data: bytes) -> Batch:
        objs = [json.loads(ln) for ln in data.splitlines() if ln.strip()]
        out: Batch = {}
        for n, t in self.schema:
            if t == "i64":
                out[n] = np.array([int(o.get(n, 0)) for o in objs], np.int64)
            elif t == "f32":
                out[n] = np.array([float(o.get(n, 0.0)) for o in objs],
                                  np.float32)
            else:
                out[n] = np.array([str(o.get(n, "")) for o in objs],
                                  dtype=object)
        return out

    def serialize(self, batch: Batch) -> bytes:
        cast = {"i64": int, "f32": float}
        names = self.fields
        n = len(batch[names[0]]) if names else 0
        return _text_lines([
            json.dumps({name: cast.get(t, str)(batch[name][i])
                        for name, t in self.schema})
            for i in range(n)])
