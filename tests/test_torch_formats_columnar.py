"""The port's columnar file format (``flink_tpu_torch/formats_columnar.py``)
against the JAX package's, case by case of ``tests/test_formats_columnar.py``:
each case runs in both packages on the same seeded batches and the
files, the decoded columns and the errors must agree, the bytes equal.
Cross-package cases: a file either package writes, the other reads
(``ColumnarFormat`` and the streaming file reader)."""
import io
import json
import struct
import zlib

import numpy as np
import pytest

from test_torch_file_pkgs import BOTH, J, P
from test_torch_threads import capped_torch_threads  # noqa: F401

SCHEMA = (("k", "i64"), ("x", "f32"), ("d", "f64"), ("s", "str"))


def _batch(rng, n):
    return {
        "k": rng.integers(-2**40, 2**40, n).astype(np.int64),
        "x": rng.random(n).astype(np.float32),
        "d": rng.random(n).astype(np.float64),
        "s": np.array(["w" + str(int(v)) + ("é" if v % 3 == 0 else "")
                       for v in rng.integers(0, 1000, n)], dtype=object),
    }


def _cols(b):
    return {k: (np.asarray(v).dtype.str, np.asarray(v).tolist())
            for k, v in b.items()}


def _write(M, batches, schema=SCHEMA, close=True):
    buf = io.BytesIO()
    w = M.columnar.ColumnarWriter(buf, schema)
    for b in batches:
        w.write_batch(b)
    if close:
        w.close()
    return buf.getvalue(), w


def _both(fn):
    """``fn(M)`` in each package; the port's result must equal the
    reference's."""
    got = {M.name: fn(M) for M in BOTH}
    assert got["port"] == got["jax"]
    return got["port"]


def _raises_alike(fn, match):
    msgs = {}
    for M in BOTH:
        with pytest.raises(M.columnar.ColumnarError, match=match) as ei:
            fn(M)
        msgs[M.name] = str(ei.value)
    assert msgs["port"] == msgs["jax"]


# -- round trips ---------------------------------------------------------------

def test_single_block_round_trip():
    b = _batch(np.random.default_rng(0), 257)

    def case(M):
        fmt = M.columnar.ColumnarFormat(SCHEMA)
        data = fmt.serialize(b)
        out = fmt.deserialize(data)
        assert _cols(out) == _cols(b)
        return data
    _both(case)


def test_multi_block_writer_preserves_block_structure():
    rng = np.random.default_rng(1)
    batches = [_batch(rng, n) for n in (3, 1, 128)]

    def case(M):
        data, _ = _write(M, batches)
        got = list(M.columnar.iter_blocks(data, expect_schema=SCHEMA))
        assert [_cols(g) for g in got] == [_cols(b) for b in batches]
        return data
    _both(case)


def test_zero_row_batch_round_trips_typed():
    def case(M):
        empty = M.columnar.ColumnarFormat(SCHEMA).empty_batch()
        data, _ = _write(M, [empty])
        (got,) = M.columnar.iter_blocks(data)
        assert len(got["k"]) == 0 and got["k"].dtype == np.int64
        assert got["s"].dtype == object
        return data
    _both(case)


def test_zero_row_serialize():
    def case(M):
        fmt = M.columnar.ColumnarFormat(SCHEMA)
        data = fmt.serialize({n: np.array([], np.int64) for n, _ in SCHEMA})
        out = fmt.deserialize(data)
        assert len(out["k"]) == 0 and out["x"].dtype == np.float32
        return data
    _both(case)


def test_property_round_trip_vs_jsonlines():
    """Random batches through the columnar and the JSON-lines format of
    each package: the same columns come back, and the bytes of each
    format equal across the packages."""
    schema = (("k", "i64"), ("x", "f32"), ("s", "str"))
    rng = np.random.default_rng(42)
    for _ in range(20):
        n = int(rng.integers(0, 200))
        b = {"k": rng.integers(-2**31, 2**31, n).astype(np.int64),
             "x": rng.random(n).astype(np.float32),
             "s": np.array([f"w{i}" for i in rng.integers(0, 99, n)],
                           dtype=object)}

        def case(M):
            col = M.columnar.ColumnarFormat(schema)
            jl = M.formats.JsonLinesFormat(schema)
            cb, jb = col.serialize(b), jl.serialize(b)
            via_col, via_jl = col.deserialize(cb), jl.deserialize(jb)
            for name in b:
                np.testing.assert_array_equal(via_col[name], b[name])
                np.testing.assert_array_equal(via_col[name], via_jl[name])
            return cb, jb
        _both(case)


def test_bytes_values_decode_as_text():
    def case(M):
        fmt = M.columnar.ColumnarFormat((("s", "str"),))
        out = fmt.deserialize(fmt.serialize(
            {"s": np.array([b"abc", "café".encode("utf-8")], dtype=object)}))
        out2 = fmt.deserialize(fmt.serialize(
            {"s": np.array([b"x", b"yy"], dtype="S2")}))
        assert list(out["s"]) == ["abc", "café"]
        assert list(out2["s"]) == ["x", "yy"]
        return list(out["s"]), list(out2["s"])
    _both(case)


def test_streaming_file_reader_matches_bytes_reader(tmp_path):
    rng = np.random.default_rng(9)
    batches = [_batch(rng, n) for n in (5, 64)]

    def case(M):
        p = tmp_path / f"{M.name}.colb"
        with open(p, "wb") as f:
            w = M.columnar.ColumnarWriter(f, SCHEMA)
            for b in batches:
                w.write_batch(b)
            w.close()
        with open(p, "rb") as f:
            got = list(M.columnar.iter_file_blocks(f, expect_schema=SCHEMA))
        assert [_cols(g) for g in got] == [_cols(b) for b in batches]
        raw = p.read_bytes()
        p.write_bytes(raw[:-8])
        with pytest.raises(M.columnar.ColumnarError, match="truncated|footer"):
            with open(p, "rb") as f:
                list(M.columnar.iter_file_blocks(f))
        return raw
    _both(case)


def test_skip_elides_decoding_but_still_validates():
    rng = np.random.default_rng(11)
    batches = [_batch(rng, n) for n in (4, 8, 16)]

    def case(M):
        data, _ = _write(M, batches)
        got = list(M.columnar.iter_blocks(data, expect_schema=SCHEMA, skip=2))
        assert [_cols(g) for g in got] == [_cols(batches[2])]
        with pytest.raises(M.columnar.ColumnarError, match="truncated|footer"):
            list(M.columnar.iter_blocks(data[:-6], skip=3))
        return data
    _both(case)


def test_infer_schema():
    b = {"a": np.arange(3, dtype=np.int32), "b": np.zeros(3, np.float32),
         "c": np.array(["x", "y", "z"], dtype=object)}
    assert _both(lambda M: M.columnar.infer_schema(b)) == (
        ("a", "i64"), ("b", "f32"), ("c", "str"))


# -- zero-copy decode ----------------------------------------------------------

def test_zero_copy_round_trip_matches_copying_reader():
    rng = np.random.default_rng(9)
    batches = [_batch(rng, n) for n in (64, 1, 0, 257)]

    def case(M):
        image, _ = _write(M, batches)
        copy = list(M.columnar.iter_blocks(image, expect_schema=SCHEMA))
        zc = list(M.columnar.iter_blocks(memoryview(image),
                                         expect_schema=SCHEMA, zero_copy=True))
        assert [_cols(a) for a in copy] == [_cols(b) for b in zc]
        return image
    _both(case)


def test_zero_copy_views_not_copies():
    b = _batch(np.random.default_rng(10), 100)

    def case(M):
        image = M.columnar.ColumnarFormat(SCHEMA).serialize(b)
        (blk,) = M.columnar.iter_blocks(memoryview(image), zero_copy=True)
        for name, typ in SCHEMA:
            if typ != "str":
                assert blk[name].base is not None, f"{name} was copied"
                assert not blk[name].flags.writeable
        (copy_blk,) = M.columnar.iter_blocks(image)
        assert copy_blk["k"].base is None
        return image
    _both(case)


def test_zero_copy_mmap_image_survives_closed_handle(tmp_path):
    b = _batch(np.random.default_rng(11), 500)

    def case(M):
        path = tmp_path / f"{M.name}.colb"
        path.write_bytes(M.columnar.ColumnarFormat(SCHEMA).serialize(b))
        view = M.columnar.map_file_image(str(path))
        (blk,) = M.columnar.iter_blocks(view, expect_schema=SCHEMA,
                                        zero_copy=True)
        del view
        assert _cols(blk) == _cols(b)
        return path.read_bytes()
    _both(case)


def test_zero_copy_corruption_exactly_as_loud():
    b = _batch(np.random.default_rng(12), 200)

    def case(M):
        image = bytearray(M.columnar.ColumnarFormat(SCHEMA).serialize(b))
        image[len(image) // 2] ^= 0xFF
        list(M.columnar.iter_blocks(memoryview(bytes(image)), zero_copy=True))
    _raises_alike(case, "CRC")


@pytest.mark.parametrize("cut", ["half", "footer"])
def test_zero_copy_truncation_and_footer_loss_exactly_as_loud(cut):
    b = _batch(np.random.default_rng(13), 200)

    def case(M):
        image = M.columnar.ColumnarFormat(SCHEMA).serialize(b)
        image = image[:len(image) // 2] if cut == "half" else image[:-16]
        list(M.columnar.iter_blocks(memoryview(image), zero_copy=True))
    _raises_alike(case, "truncated" if cut == "half" else None)


def test_scatter_writer_bytes_identical_to_legacy_writer():
    """Both packages' writers against the copying writer's image, built
    here from the layout (tobytes, join, ``zlib.crc32``)."""
    rng = np.random.default_rng(14)
    batches = [_batch(rng, n) for n in (33, 128)]
    header = json.dumps({"fields": [[n, t] for n, t in SCHEMA]},
                        separators=(",", ":")).encode()
    want = (b"FTPC" + struct.pack("<BBH", 1, 0, len(SCHEMA))
            + struct.pack("<I", len(header)) + header
            + struct.pack("<I", zlib.crc32(header)))
    fixed = {"i64": "<i8", "f32": "<f4", "f64": "<f8"}
    for b in batches:
        payload = b""
        for n, t in SCHEMA:
            if t == "str":
                items = [str(x).encode() for x in b[n]]
                offs = np.zeros(len(items) + 1, np.uint32)
                offs[1:] = np.cumsum([len(i) for i in items])
                payload += offs.astype("<u4").tobytes() + b"".join(items)
            else:
                payload += np.ascontiguousarray(b[n], fixed[t]).tobytes()
        want += (b"BLK\x00" + struct.pack("<II", len(b["k"]), len(payload))
                 + payload + struct.pack("<I", zlib.crc32(payload)))
    want += b"END\x00" + struct.pack("<IQ", 2, 161)

    def case(M):
        data, w = _write(M, batches)
        assert w.bytes_written == len(data)
        return data
    assert _both(case) == want


# -- loud failures -------------------------------------------------------------

def test_empty_file_rejected():
    _raises_alike(lambda M: M.columnar.ColumnarFormat(SCHEMA).deserialize(b""),
                  "empty columnar file")


def test_bad_magic_rejected():
    _raises_alike(lambda M: M.columnar.ColumnarFormat(SCHEMA).deserialize(
        b"NOPE" + b"\x00" * 64), "not a flink-tpu")


def test_truncated_block_rejected():
    b = _batch(np.random.default_rng(2), 64)

    def case(M):
        fmt = M.columnar.ColumnarFormat(SCHEMA)
        data = fmt.serialize(b)
        fmt.deserialize(data[:len(data) // 2])
    _raises_alike(case, "truncated")


def test_missing_footer_rejected():
    b = _batch(np.random.default_rng(3), 16)

    def case(M):
        data, _ = _write(M, [b], close=False)
        list(M.columnar.iter_blocks(data))
    _raises_alike(case, "truncated")


def test_corrupt_payload_rejected_by_crc():
    b = _batch(np.random.default_rng(4), 64)

    def case(M):
        fmt = M.columnar.ColumnarFormat(SCHEMA)
        data = bytearray(fmt.serialize(b))
        data[len(data) // 2] ^= 0xFF
        fmt.deserialize(bytes(data))
    _raises_alike(case, "CRC mismatch")


def test_reader_schema_mismatch_rejected():
    b = _batch(np.random.default_rng(5), 8)

    def case(M):
        written = M.columnar.ColumnarFormat(SCHEMA).serialize(b)
        M.columnar.ColumnarFormat((("k", "i64"), ("x", "f64"), ("d", "f64"),
                                   ("s", "str"))).deserialize(written)
    _raises_alike(case, "schema mismatch")


@pytest.mark.parametrize("schema,batch,match", [
    ((("a", "i64"), ("b", "i64")),
     {"a": np.arange(4), "WRONG": np.arange(4)}, "schema mismatch"),
    ((("a", "i64"),), {"a": np.zeros(4, np.float32)}, "declared i64"),
    ((("a", "i64"), ("b", "i64")),
     {"a": np.arange(4), "b": np.arange(3)}, "ragged"),
], ids=["columns", "dtype", "ragged"])
def test_writer_mismatch_rejected(schema, batch, match):
    _raises_alike(
        lambda M: M.columnar.ColumnarFormat(schema).serialize(batch), match)


# -- across the packages -------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(P, J), (J, P)],
                         ids=["port-to-jax", "jax-to-port"])
def test_files_read_across_packages(writer, reader, tmp_path):
    """A multi-block file one package writes decodes in the other, by the
    format and by the streaming reader, to the same columns."""
    rng = np.random.default_rng(21)
    batches = [_batch(rng, n) for n in (7, 0, 90)]
    data, _ = _write(writer, batches)
    fmt = reader.columnar.ColumnarFormat(SCHEMA)
    whole = fmt.deserialize(data)
    assert _cols(whole) == _cols({n: np.concatenate([b[n] for b in batches])
                                  for n, _ in SCHEMA})
    p = tmp_path / "x.colb"
    p.write_bytes(data)
    with open(p, "rb") as f:
        got = list(reader.columnar.iter_file_blocks(f, expect_schema=SCHEMA))
    assert [_cols(g) for g in got] == [_cols(b) for b in batches]
    assert reader.columnar.read_schema(data) == SCHEMA
    assert [_cols(g) for g in fmt.iter_batches(data, skip=1)] == [
        _cols(b) for b in batches[1:]]
