"""The port's host codec (``flink_tpu_torch/native/codec.cc`` through
``flink_tpu_torch.native_codec``) against its numpy key table and
against the reference's codec (``flink_tpu.native_codec``) on the same
inputs: table lookups and inserts, the splitmix64 hash, the host
combine, the fused ingest scan with its miss list, and its three
finalizes (the triple form against the reference's encoder) — all
exact, bit for bit. A failed build raises."""
import os

import numpy as np
import pytest

from flink_tpu import native_codec as ref_nc
from flink_tpu_torch import native_codec as nc
from flink_tpu_torch.records import hash_keys_numpy
from flink_tpu_torch.state.keyed import KeyDirectory, _NumpyHashTable
from test_torch_threads import capped_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def reference_codec():
    if not ref_nc.native_available():
        pytest.skip("the reference's codec library did not build")


def test_hash_matches_numpy():
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(-2 ** 63, 2 ** 63 - 1, 5000,
                                        dtype=np.int64),
                           np.array([0, -1, 2 ** 63 - 1, -2 ** 63], np.int64)])
    np.testing.assert_array_equal(nc.hash_keys_native(keys),
                                  hash_keys_numpy(keys))


@pytest.mark.parametrize("hint", [1, 1024])
def test_table_matches_numpy_table(hint):
    """Batches of inserts (growing the table from its hint), updates and
    lookups of present and absent keys: the C table and the numpy table
    answer alike."""
    rng = np.random.default_rng(hint)
    c_tab = nc.NativeHashTable.create(hint)
    np_tab = _NumpyHashTable(hint)
    seen = np.zeros(0, np.int64)
    for _ in range(6):
        new = np.unique(rng.integers(-10 ** 12, 10 ** 12, 700))
        vals = rng.integers(-5, 1 << 40, len(new))
        c_tab.insert_batch(new, None, vals)
        np_tab.insert_batch(new, hash_keys_numpy(new), vals)
        seen = np.concatenate([seen, new])
        probe = np.concatenate([rng.choice(seen, 900),
                                rng.integers(-10 ** 12, 10 ** 12, 300)])
        for got, want in zip(c_tab.lookup_keys(probe), np_tab.lookup_keys(probe)):
            np.testing.assert_array_equal(got, want)
    # an update of present keys
    upd = seen[::3]
    c_tab.insert_batch(upd, None, np.full(len(upd), 7))
    np_tab.insert_batch(upd, hash_keys_numpy(upd), np.full(len(upd), 7))
    for got, want in zip(c_tab.lookup_keys(seen), np_tab.lookup_keys(seen)):
        np.testing.assert_array_equal(got, want)
    assert c_tab._count == np_tab._count == len(np.unique(seen))


def _tables(keys, vals):
    ours = nc.NativeHashTable.create()
    theirs = ref_nc.NativeHashTable.create()
    ours.insert_batch(keys, None, vals)
    theirs.insert_batch(keys, None, vals)
    return ours, theirs


def _batch(seed, n, n_keys, span_ms, pane_ms):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n).astype(np.int64)
    ts = (rng.integers(0, span_ms, n) - 3 * pane_ms).astype(np.int64)
    return keys, ts


@pytest.mark.parametrize("seed,dead,refire", [(0, -10 ** 9, -2 ** 63),
                                              (1, 2, 6), (2, -1, 4)])
def test_fused_scan_and_finalizes_match_the_reference(seed, dead, refire):
    """One scan with misses, the continued scan over the missed records
    once registered, then both finalizes: pairs, stats, re-fire bitmap,
    miss list and the u32 buffer equal the reference's."""
    pane_ms, ring, n = 100, 16, 20_000
    keys, ts = _batch(seed, n, 900, 1_200, pane_ms)
    known = np.arange(0, 900, 2, dtype=np.int64)      # half the keys
    vals = (known * 7) % 600
    vals[::11] = KeyDirectory.FULL                    # refused keys
    bits = max(refire - dead, 0) if refire > dead else 0
    out = []
    for mod, tab in zip((nc, ref_nc), _tables(known, vals)):
        ws = mod.PreaggWorkspace(601 * ring, 0)
        res, miss = mod.ingest_fused_scan_native(
            keys, ts, tab, pane_ms, 0, ring, ws, 1 << 14, dead, refire,
            bits, miss_cap=n)
        first = (res.npairs, res.out_pairs[:res.npairs].copy(),
                 res.stats.copy(), res.bitmap.copy(), miss.copy())
        new = np.unique(keys[miss])
        tab.insert_batch(new, None, 300 + (new % 300))
        res, miss2 = mod.ingest_fused_scan_native(
            keys[miss], ts[miss], tab, pane_ms, 0, ring, ws, 1 << 14, dead,
            refire, bits, cont=res, miss_cap=1)
        assert len(miss2) == 0
        snap = (res.npairs, res.out_pairs[:res.npairs].copy(),
                res.stats.copy(), res.bitmap.copy(), ws.hist.copy())
        if int(res.stats[7]) < 0xFFF:
            u32 = mod.ingest_fused_finalize_u32_native(res, ws, 128, 1 << 14)
        else:
            u32 = None
        assert not ws.hist.any()
        out.append((first, snap, u32))
    (f_a, s_a, u_a), (f_b, s_b, u_b) = out
    for a, b in zip(f_a + s_a, f_b + s_b):
        np.testing.assert_array_equal(a, b)
    assert f_a[2][6] > 0 and s_a[2][0] > 0       # misses, then valid records
    if dead > -10 ** 9:
        assert s_a[2][1] > 0                     # late records
    assert s_a[2][2] > 0                         # refused keys count as bad
    np.testing.assert_array_equal(u_a, u_b)


def test_finalize_pairs_and_u32_into_a_given_buffer():
    pane_ms, ring = 10, 8
    keys, ts = _batch(5, 5_000, 50, 200, pane_ms)
    keys[:4500] = 3                                   # one pair past 0xFFF
    ts[:4500] = 40
    known = np.arange(50, dtype=np.int64)
    res_all = []
    for mod, tab in zip((nc, ref_nc), _tables(known, known)):
        ws = mod.PreaggWorkspace(50 * ring, 0)
        res, _ = mod.ingest_fused_scan_native(
            keys, ts, tab, pane_ms, 0, ring, ws, 1024, -10 ** 9, -2 ** 63, 0)
        assert int(res.stats[7]) >= 0xFFF
        pairs, cnts = mod.ingest_fused_finalize_pairs_native(res, ws)
        assert not ws.hist.any()
        res_all.append((pairs.copy(), cnts.copy()))
    for a, b in zip(*res_all):
        np.testing.assert_array_equal(a, b)
    # the u32 finalize writes into a caller's buffer, header first
    keys2, ts2 = _batch(6, 3_000, 50, 200, pane_ms)
    bufs = []
    for mod, tab in zip((nc, ref_nc), _tables(known, known)):
        ws = mod.PreaggWorkspace(50 * ring, 0)
        res, _ = mod.ingest_fused_scan_native(
            keys2, ts2, tab, pane_ms, 0, ring, ws, 1024, -10 ** 9, -2 ** 63, 0)
        if mod is nc:
            out = np.full(128 + 4096, 77, np.int32)
            buf = mod.ingest_fused_finalize_u32_native(res, ws, 128, 1024, out)
            assert buf.base is out or buf.base is out.base
            assert (out[128 + 1024:] == 77).all()
        else:
            buf = mod.ingest_fused_finalize_u32_native(res, ws, 128, 1024)
        bufs.append(buf)
    np.testing.assert_array_equal(*bufs)
    assert (bufs[0][:128] == -1).all()


@pytest.mark.parametrize("odd", [False, True])
def test_finalize_u16_writes_the_real_triples_of_the_reference_encoder(odd):
    """The triple finalize against the reference's scan and its
    ``preagg_encode_u16`` on the same (real) pairs, byte for byte: FUSED_HDR
    words of -1, then ``[pair lo16, pair hi16, count]`` per pair in the
    scan's order with no padding (a hot key past 0xFFF, counts up to
    0xFFFF), the last word's upper half 0xFFFF for an odd pair count, the
    caller's buffer untouched past them and the histogram left at
    zero."""
    from flink_tpu.ops.window import preagg_encode_u16 as ref_encode_u16

    pane_ms, ring = 10, 8
    keys, ts = _batch(8, 80_000, 45, 200, pane_ms)
    keys += 5                                         # 45 x 8 pairs
    keys[:0xFFFF] = 3                                 # one pair at 0xFFFF
    ts[:0xFFFF] = 40
    keys[0xFFFF:0xFFFF + 0x1000] = 4                  # one at 0x1000
    ts[0xFFFF:0xFFFF + 0x1000] = 50
    if odd:
        keys[-1], ts[-1] = 2, 0                       # one pair more
    known = np.arange(50, dtype=np.int64)
    ours, theirs = _tables(known, known)
    ws_ref = ref_nc.PreaggWorkspace(50 * ring, 0)
    res, _ = ref_nc.ingest_fused_scan_native(
        keys, ts, theirs, pane_ms, 0, ring, ws_ref, 1024, -10 ** 9, -2 ** 63, 0)
    pairs, cnts = ref_nc.ingest_fused_finalize_pairs_native(res, ws_ref)
    n = len(pairs)
    assert n % 2 == odd and cnts.max() == 0xFFFF and 0x1000 in cnts
    want = ref_encode_u16(pairs, cnts, n)
    ws = nc.PreaggWorkspace(50 * ring, 0)
    res, _ = nc.ingest_fused_scan_native(
        keys, ts, ours, pane_ms, 0, ring, ws, 1024, -10 ** 9, -2 ** 63, 0)
    out = np.full(128 + 4096, 77, np.int32)
    buf = nc.ingest_fused_finalize_u16_native(res, ws, 128, out)
    assert not ws.hist.any()
    assert buf.base is out or buf.base is out.base
    assert len(buf) == 128 + (6 * n + 3) // 4 and (buf[:128] == -1).all()
    assert (out[len(buf):] == 77).all()
    tail = buf[128:].view(np.uint16)
    np.testing.assert_array_equal(tail[:3 * n], want.reshape(-1))
    assert tail[3 * n:].tolist() == ([0xFFFF] if odd else [])
    # a new array when no buffer is given, with the same words
    res, _ = nc.ingest_fused_scan_native(
        keys, ts, ours, pane_ms, 0, ring, ws, 1024, -10 ** 9, -2 ** 63, 0)
    np.testing.assert_array_equal(
        nc.ingest_fused_finalize_u16_native(res, ws, 128), buf)


def test_scan_overflow_declines_and_rezeroes():
    pane_ms, ring = 10, 8
    keys, ts = _batch(7, 4_000, 200, 400, pane_ms)
    tab = nc.NativeHashTable.create()
    tab.insert_batch(np.arange(200), None, np.arange(200))
    ws = nc.PreaggWorkspace(200 * ring, 0)
    assert nc.ingest_fused_scan_native(keys, ts, tab, pane_ms, 0, ring, ws,
                                       64, -10 ** 9, -2 ** 63, 0) is None
    assert not ws.hist.any()
    # a miss list past its capacity declines too
    tab2 = nc.NativeHashTable.create()
    assert nc.ingest_fused_scan_native(keys, ts, tab2, pane_ms, 0, ring, ws,
                                       1 << 12, -10 ** 9, -2 ** 63, 0,
                                       miss_cap=10) is None


@pytest.mark.parametrize("nlanes", [0, 2])
def test_preagg_combine_matches_the_reference(nlanes):
    rng = np.random.default_rng(nlanes)
    n, slots, ring = 30_000, 700, 16
    sl = rng.integers(0, slots, n).astype(np.int64)
    panes = rng.integers(-40, 90, n).astype(np.int64)
    valid = rng.random(n) < 0.9
    lanes = [rng.random(n).astype(np.float32) * 100 for _ in range(nlanes)]
    out = []
    for mod in (nc, ref_nc):
        ws = mod.PreaggWorkspace(slots * ring, nlanes)
        out.append(mod.preagg_combine_native(sl, panes, valid, lanes, ring,
                                             ws, 1 << 14))
        assert not ws.hist.any() and not ws.lane_acc.any()
    (pa, ca, la), (pb, cb, lb) = out
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ca, cb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))
    ws = nc.PreaggWorkspace(slots * ring, nlanes)
    assert nc.preagg_combine_native(sl, panes, valid, lanes, ring, ws, 16) is None
    assert not ws.hist.any()


def test_directory_register_misses_allocates_like_assign():
    """A key set registered through the scan's miss path gets the slots
    the general path's assign gives it, in the port and the reference."""
    from flink_tpu.state.keyed import KeyDirectory as RefDirectory

    rng = np.random.default_rng(3)
    keys = rng.integers(0, 10 ** 9, 5_000)
    later = rng.integers(0, 10 ** 9, 2_000)
    a, b, r = KeyDirectory(16, 512), KeyDirectory(16, 512), RefDirectory(16, 512)
    assert a.native() and b.native()
    a.register_misses(keys)
    r.register_misses(keys)
    b.assign(keys)
    probe = np.concatenate([keys, later])
    np.testing.assert_array_equal(a.assign(probe), b.assign(probe))
    np.testing.assert_array_equal(a.assign(probe), r.assign(probe))
    np.testing.assert_array_equal(a.used_mask(), r.used_mask())


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(nc, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(nc, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nc, "_lib", None)
    with pytest.raises(RuntimeError, match="host codec build failed"):
        nc.NativeHashTable.create()
    with pytest.raises(RuntimeError, match="host codec build failed"):
        KeyDirectory(4, 16)


def test_a_compile_error_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "codec.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nc, "SOURCE", str(bad))
    monkeypatch.setattr(nc, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nc, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        nc.load()


def test_library_builds_from_the_port_source_into_its_build_dir():
    nc.load()
    path = nc.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "flink_tpu_torch", "_build")
    assert os.path.exists(path)
    assert nc.SOURCE == os.path.join(ROOT, "flink_tpu_torch", "native", "codec.cc")


# -- the text plane (file formats, socket source) ----------------------------

LINES = ["to be or not to be", "  leading  and   double spaces ", "",
         "tab\tseparated words", "unicode café naïve"]


def test_tokenize_hash_matches_its_plain_version_and_the_reference():
    from flink_tpu_torch.records import hash_string_key

    ids, lix = nc.tokenize_hash(LINES)
    pids, plix = nc._tokenize_hash_numpy(LINES)
    rids, rlix = ref_nc.tokenize_hash(LINES)
    for got in ((pids, plix), (rids, rlix)):
        np.testing.assert_array_equal(ids, got[0])
        np.testing.assert_array_equal(lix, got[1])
    assert ids[0] == hash_string_key("to")


def test_hash_strings_matches_the_reference():
    from flink_tpu.records import hash_string_key as ref_hash
    from flink_tpu_torch.records import hash_string_key

    ss = ["alpha", "beta", "café", "", "x" * 300]
    got = nc.hash_strings(ss)
    assert got.tolist() == [hash_string_key(s) for s in ss]
    assert got.tolist() == ref_nc.hash_strings(ss).tolist()
    assert [hash_string_key(s) for s in ss] == [ref_hash(s) for s in ss]


@pytest.mark.parametrize("data,n_cols", [
    (b"1,2,3\n-4,5,6\n7,8,9\n", 3),
    (b"1,2\n3\n,\nx,7,9\n-,-8\n12", 2),  # ragged, empty, junk, no newline
])
def test_parse_i64_table_matches_the_reference(data, n_cols):
    np.testing.assert_array_equal(nc.parse_i64_table(data, n_cols),
                                  ref_nc.parse_i64_table(data, n_cols))
    np.testing.assert_array_equal(
        nc.parse_i64_table(data, n_cols, max_rows=1),
        ref_nc.parse_i64_table(data, n_cols, max_rows=1))


def test_parse_f32_table_matches_the_reference():
    rng = np.random.default_rng(3)
    vals = rng.normal(0, 1e3, (200, 3)).astype(np.float32)
    data = ("\n".join(";".join(f"{v:.5f}" for v in row) for row in vals)
            + "\n").encode()
    for d, cols in ((b"1.5,2\n-0.25,4.125\n", 2), (data, 3)):
        delim = ";" if d is data else ","
        got = nc.parse_f32_table(d, cols, delim=delim)
        want = ref_nc.parse_f32_table(d, cols, delim=delim)
        assert got.tobytes() == want.tobytes()
    assert nc.parse_f32_table(b"1.5,2\n-0.25,4.125\n", 2).tolist() == [
        [1.5, 2.0], [-0.25, 4.125]]


def test_encode_i64_rows_bytes_match_the_reference_and_round_trip():
    vals = np.array([[10, -20, 3], [0, 99999999999, -1],
                     [np.iinfo(np.int64).max, -(2 ** 62), 7]], np.int64)
    enc = nc.encode_i64_rows(vals)
    assert enc == ref_nc.encode_i64_rows(vals)
    assert nc.encode_i64_rows(vals, "|") == ref_nc.encode_i64_rows(vals, "|")
    np.testing.assert_array_equal(nc.parse_i64_table(enc, 3), vals)
