"""The port's binary frame codec (``flink_tpu_torch/exchange/frames.py``)
against the JAX package's: the same payload and meta encode to the same
bytes (string columns, nested and odd column names, bare arrays, None,
zero rows, extras), each package decodes the other's frames to the same
meta and arrays, and corrupt, truncated, hostile, foreign-version and
``__pickle__``-carrying frames are refused loudly by the port. A
frame's bytes are integers: everything compares exactly."""
import struct

import numpy as np
import pytest

from flink_tpu.checkpoint import blobformat as jax_blobformat
from flink_tpu.exchange import frames as jf
from flink_tpu_torch import faults
from flink_tpu_torch.checkpoint import blobformat as port_blobformat
from flink_tpu_torch.exchange import frames as pf
from test_torch_threads import capped_torch_threads  # noqa: F401

PROD_META = {"wm": 12345, "done": False, "ckpt": True, "persisted": -1}


def share(seed, n):
    """The exchange's payload: routed record columns and timestamps,
    with a text column."""
    rng = np.random.default_rng(seed)
    return {
        "data": {
            "auction": rng.integers(-2**40, 2**40, n).astype(np.int64),
            "price": rng.random(n).astype(np.float32),
            "d": rng.random(n).astype(np.float64),
            "flag": rng.integers(0, 2, n).astype(bool),
            "small": rng.integers(0, 200, n).astype(np.uint8),
            "line": np.array(
                ["w" + str(int(v)) + ("é" if v % 3 == 0 else "")
                 for v in rng.integers(0, 1000, n)], dtype=object),
        },
        "ts": rng.integers(0, 2**42, n).astype(np.int64),
    }


CASES = {
    "production": (3, 9, PROD_META, share(0, 257)),
    "zero_rows": (0, 0, {"wm": 0}, share(1, 0)),
    "extras": (1, 2**40, {"wm": -2**62, "persisted": 10, "latest": -1,
                          "sp": False}, share(2, 33)),
    "none": (1, 5, {"done": True}, None),
    "empty_dict": (0, 1, {}, {}),
    "bare_array": (2, 3, {"wm": 7}, np.arange(5, dtype=np.int64)),
    "names": (0, 4, {"wm": 1}, {"data": {
        "meta/id": np.arange(3, dtype=np.int64),
        "a/b/c": np.arange(3, dtype=np.int16), "": np.zeros((3, 2))},
        "ts": np.arange(3, dtype=np.int64)}),
    "bytes_text": (0, 0, {}, {"s": np.array(
        [b"abc", "caf\xc3\xa9".encode("latin-1")], dtype=object)}),
}


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_encodings_are_byte_identical(case):
    sender, step, meta, payload = CASES[case]
    raw = pf.encode_bytes(sender, step, meta, payload)
    assert raw == jf.encode_bytes(sender, step, meta, payload)
    # the scatter list is the same bytes
    assert b"".join(bytes(b) for b in pf.encode(sender, step, meta,
                                                payload)) == raw


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer,reader", [(jf, pf), (pf, jf), (pf, pf)],
                         ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_each_package_decodes_the_others_frames(case, writer, reader):
    sender, step, meta, payload = CASES[case]
    got = reader.decode(writer.encode_bytes(sender, step, meta, payload))
    want = jf.decode(jf.encode_bytes(sender, step, meta, payload))
    assert got[:3] == want[:3] == (sender, step, meta)
    assert_tree_equal(got[3], want[3])


def test_header_layout_matches_the_reference():
    assert (pf.MAGIC, pf.VERSION, pf.HEADER.format, pf.HEADER_LEN) == (
        jf.MAGIC, jf.VERSION, jf.HEADER.format, jf.HEADER_LEN)
    raw = pf.encode_bytes(0, 0, PROD_META, None)
    (extras_len,) = struct.unpack_from(">I", raw, pf.HEADER_LEN)
    assert extras_len == 0  # the hot path parses no JSON


def test_numeric_leaves_are_views_of_the_received_buffer():
    raw = pf.encode_bytes(0, 0, {"wm": 1},
                          {"ts": np.arange(64, dtype=np.int64)})
    _, _, _, payload = pf.decode(raw)
    assert np.shares_memory(payload["ts"], np.frombuffer(raw, np.uint8))


def test_round_trip_agrees_with_the_blob_oracle():
    """The binary frame and the legacy blob wire rebuild the same arrays
    from the same share (the port's blob format decoding the JAX
    package's blob, with the pickle escape refused)."""
    for trial in range(6):
        payload = share(10 + trial, 17 * trial)
        meta = dict(PROD_META, persisted=trial)
        _, _, bmeta, via_bin = pf.decode(pf.encode_bytes(0, trial, meta,
                                                         payload))
        legacy = port_blobformat.decode(jax_blobformat.encode(
            {"data": payload, "meta": meta}), allow_pickle=False)
        assert bmeta == meta == legacy["meta"]
        assert_tree_equal(via_bin, legacy["data"])


def frame(n=64):
    return jf.encode_bytes(0, 0, PROD_META, share(3, n))


def flipped(raw, at):
    b = bytearray(raw)
    b[at] ^= 0xFF
    return bytes(b)


def with_field(raw, fmt, offset, value):
    b = bytearray(raw)
    struct.pack_into(fmt, b, offset, value)
    return bytes(b)


def shrunk_shape():
    raw = jf.encode_bytes(0, 0, {"wm": 0}, {"ts": np.arange(8, dtype=np.int64)})
    desc = pf.HEADER_LEN + 4
    name_len, dtype_len = struct.unpack_from(">HB", raw, desc)
    return with_field(raw, ">I", desc + 17 + name_len + dtype_len, 4)


BAD_FRAMES = {
    "truncated_header": (lambda: frame()[:pf.HEADER_LEN // 2], "truncated"),
    "truncated_descriptor": (lambda: frame()[:pf.HEADER_LEN + 12],
                             "truncated"),
    "truncated_array": (lambda: frame()[:-17], "truncated"),
    "crc": (lambda: flipped(frame(), -5), "CRC mismatch"),
    "magic": (lambda: b"NOPE" + frame()[4:], "magic"),
    "legacy_blob": (lambda: struct.pack(">Q", 99) + jax_blobformat.encode(
        {"data": None, "meta": {}}), "legacy blobformat"),
    "version": (lambda: with_field(frame(), ">H", 4, pf.VERSION + 1),
                "mixed-version"),
    "hostile_body_len": (lambda: with_field(frame(), ">Q",
                                            pf.HEADER_LEN - 8, 1 << 60),
                         "hostile|corrupt"),
    "size_mismatch": (shrunk_shape, "needs"),
}


@pytest.mark.parametrize("case", sorted(BAD_FRAMES))
def test_corrupt_frames_fail_loudly_in_both(case):
    make, match = BAD_FRAMES[case]
    raw = make()
    for mod in (pf, jf):
        with pytest.raises(mod.FrameError, match=match):
            mod.decode(raw)
    assert issubclass(pf.FrameError, ValueError)


@pytest.mark.parametrize("bad,match", [
    (np.array([{"x": 1}], dtype=object), "no pickle escape"),
    (np.array([b"\xff\xfe"], dtype=object), "non-UTF8"),
])
def test_foreign_objects_are_refused_at_encode(bad, match):
    for mod in (pf, jf):
        with pytest.raises(mod.FrameError, match=match):
            mod.encode_bytes(0, 0, {}, {"data": {"line": bad}})


def test_the_pickle_escape_is_refused_on_the_legacy_wire():
    """A blob smuggling a ``__pickle__`` escape (what an object array
    encodes to in the blob format) is refused by the port's network
    decode, which the legacy codec uses."""
    raw = jax_blobformat.encode({"data": np.array([{"x": 1}], dtype=object),
                                 "meta": {}})
    assert b"__pickle__" in raw
    with pytest.raises(ValueError, match="__pickle__ escape rejected"):
        port_blobformat.decode(raw, allow_pickle=False)


def test_the_encode_fault_point_fires():
    plan = faults.FaultPlan(seed=1).rule("dcn.frame.encode", "raise",
                                         count=1, after=1)
    with plan.activate():
        pf.encode_bytes(0, 0, {}, None)
        with pytest.raises(ValueError, match="injected fault"):
            pf.encode_bytes(0, 1, {}, None)
        pf.encode_bytes(0, 2, {}, None)
    assert [e[0] for e in plan.log] == ["dcn.frame.encode"]
