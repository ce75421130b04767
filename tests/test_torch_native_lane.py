"""The native lane: the port with its C key table against the reference
with its C library, fed the same batches. Both then take the fused
count-only ingest scan; with top-n both stash the pair words and run the
next advance as one fused step (apply + fire of up to 64 window ends,
row-major over all of them, + purge), and without top-n both fold the
words in at once. Rows must be equal in order (every column exact; sums
within the stated bound of tests/test_torch_window_aggregates.py), and
so must the pane state.

Covered: an advance firing 16, 17, 64 and 65 windows (65 overflows the
fused step's header, so both flush the stash and fire in chunks of 16),
rings of 32 and 64 (at 64 the pair domain outgrows the u32 word: the
reference sends the batch up as u16 triples and fires in chunks, the
port stashes the triples for one fused step), pair counts past 0xFFF
(the same split; without top-n both fold the triples in at once), late
records with re-fires, ring growth inside the scan with a
stash pending, snapshot and restore with a stash pending, the fire gate
on and off, and Q5, WordCount and bid-aggregate jobs through
``env.execute``."""
import collections

import numpy as np
import pytest

from flink_tpu.api.windowing import (
    SlidingEventTimeWindows as JaxSliding,
    TumblingEventTimeWindows as JaxTumbling,
)
from flink_tpu.ops.aggregates import count as jax_count
from flink_tpu.ops.window import WindowOperator as JaxWindowOperator
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.kernels import fused_kernels as fk
from flink_tpu_torch.ops.aggregates import count
from flink_tpu_torch.ops.window import WindowOperator
from test_torch_threads import capped_torch_threads  # noqa: F401

COLS = ("key", "window_start", "window_end", "count")


@pytest.fixture(autouse=True)
def reference_codec():
    from flink_tpu import native_codec

    if not native_codec.native_available():
        pytest.skip("the reference's codec library did not build")


@pytest.fixture
def calls(monkeypatch):
    """Counts of the port's native-lane device calls."""
    seen = collections.Counter()
    for name in ("fused_step", "apply_pairs_u32", "apply_pairs_u16"):
        orig = getattr(fk, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(fk, name, spy)
    return seen


def rows_of(fired):
    f = dict(fired)
    return list(zip(*(np.asarray(f[k]).tolist() for k in COLS)))


def make_pair(size, slide, n, *, shards=8, slots=64, ooo=0, lateness=0,
              fire_gate=True):
    kw = dict(num_shards=shards, slots_per_shard=slots,
              max_out_of_orderness_ms=ooo, allowed_lateness_ms=lateness,
              top_n=("count", n) if n else None)
    jagg, agg = jax_count(), count()
    if slide is None:
        ref = JaxWindowOperator(JaxTumbling.of(size), jagg, fire_gate=fire_gate, **kw)
        port = WindowOperator(TumblingEventTimeWindows.of(size), agg,
                              device="cpu", fire_gate=fire_gate, **kw)
    else:
        ref = JaxWindowOperator(JaxSliding.of(size, slide), jagg,
                                fire_gate=fire_gate, **kw)
        port = WindowOperator(SlidingEventTimeWindows.of(size, slide), agg,
                              device="cpu", fire_gate=fire_gate, **kw)
    assert port.directory.native()
    return ref, port


def step_both(ref, port, step):
    if step[0] == "batch":
        ref.process_batch(step[1], step[2], {})
        port.process_batch(step[1], step[2], {})
        # both stash the u32 words alike; where the reference sends u16
        # triples straight up, the port may stash them for a fused step
        if ref._stash_u32 is not None:
            assert port._stash is not None
            assert port._stash.form == fk.FORM_WORDS
        else:
            assert port._stash is None or port._stash.form == fk.FORM_TRIPLES
        return []
    a = rows_of(ref.advance_watermark(step[1]))
    b = rows_of(port.advance_watermark(step[1]))
    assert b == a
    return b


def drive(ref, port, steps):
    fired = []
    for step in steps:
        fired += step_both(ref, port, step)
    a = rows_of(ref.advance_watermark(ref.final_watermark()))
    b = rows_of(port.advance_watermark(port.final_watermark()))
    assert b == a
    fired += b
    ref.quiesce()
    port.quiesce()
    assert port.plan.ring == ref.plan.ring
    np.testing.assert_array_equal(port.state.counts.numpy(),
                                  np.asarray(ref.state.counts))
    assert port.late_records == ref.late_records
    return fired


def span_batch(rng, n, keys, pane_lo, pane_hi, pane_ms=100):
    k = rng.integers(0, keys, n).astype(np.int64)
    ts = rng.integers(pane_lo * pane_ms, (pane_hi + 1) * pane_ms, n)
    return ("batch", k, ts.astype(np.int64))


@pytest.mark.parametrize("n_ends", [16, 17, 64, 65])
def test_one_advance_fires_many_windows_in_the_reference_order(calls, n_ends):
    """Sliding 1 s / 100 ms windows; a warm-up batch registers the keys
    and grows the ring, then a batch over the same panes is stashed and
    the advance fires n_ends windows: through one fused step up to 64
    (rows row-major over all ends), in chunks of 16 beyond."""
    rng = np.random.default_rng(n_ends)
    s = n_ends - 10
    ref, port = make_pair(1_000, 100, 3)
    steps = [span_batch(rng, 8192, 50, 0, s), span_batch(rng, 8192, 50, 0, s),
             ("wm", (s + 10) * 100)]
    for st in steps[:2]:
        step_both(ref, port, st)
    assert port.plan.ring <= 64 and port._stash is not None
    fired = step_both(ref, port, steps[2])
    assert len({w for _, _, w, _ in fired}) == n_ends
    assert calls["fused_step"] == (1 if n_ends <= 64 else 0)
    drive(ref, port, [])


@pytest.mark.parametrize("gate", [True, False])
def test_q5_shaped_stream_in_order(calls, gate):
    """Sliding 10 s / 1 s with 1 s out-of-orderness, batches of ~20 s of
    event time (about 20 ends an advance, so the fused step's row order
    differs from chunks of 16), 100 keys, the fire gate on and off: u32
    words and one fused step per batch at ring 32. (Q5's own 128 x 256
    slots, where ring 32 makes the pair domain exactly 2^20, run in
    test_q5_end_to_end_in_order.)"""
    rng = np.random.default_rng(3)
    ref, port = make_pair(10_000, 1_000, 2, ooo=1_000, fire_gate=gate,
                          shards=16, slots=64)
    steps, t = [], 0
    for _ in range(4):
        steps.append(("batch", (rng.zipf(1.5, 12_000) % 100).astype(np.int64),
                      (t + rng.integers(-1_000, 20_000, 12_000)).astype(np.int64)))
        t += 20_000
        steps.append(("wm", t - 1_000 - 1))
    fired = drive(ref, port, steps)
    assert calls["fused_step"] >= 2 and len(fired) > 100
    assert port.plan.ring == 32 and calls["apply_pairs_u16"] == 0


@pytest.mark.parametrize("advances", ["one_of_30_ends", "three_of_10_ends"])
def test_ring_64_stashes_triples_for_fused_steps_of_up_to_16_ends(calls,
                                                                  advances):
    """At ring 64 Q5's pair domain (32,768 slots x 64 = 2^21) outgrows the
    u32 word's 20 bits: the reference sends the batch as u16 triples and
    fires in chunks of 16 ends; the port stashes the C-written triples.
    An advance of up to 16 ends fires them in one fused step (rows
    row-major over its ends: the chunk's order); a wider one flushes them
    through ``apply_pairs_u16`` and fires in chunks, as the reference
    does. Rows equal the reference's in order either way."""
    rng = np.random.default_rng(4)
    ref, port = make_pair(1_000, 100, 1, shards=128, slots=256)
    batches = [span_batch(rng, 20_000, 100, 0, 30),
               span_batch(rng, 20_000, 100, 0, 30)]
    if advances == "one_of_30_ends":
        steps = batches + [("wm", 2_000)]
    else:
        steps = [batches[0], ("wm", 1_000), batches[1], ("wm", 2_000),
                 ("wm", 2_999)]
    fired = drive(ref, port, steps)
    assert port.plan.ring == 64 and port.layout.slots * 64 == 1 << 21
    if advances == "one_of_30_ends":
        assert calls["apply_pairs_u16"] >= 1 and calls["fused_step"] == 0
    else:
        assert calls["fused_step"] >= 1 and calls["apply_pairs_u16"] == 0
    assert len(fired) > 20


def hot_key_steps(rng):
    """Four batches with one key holding more than 0xFFF records in a
    pane, each followed by an advance."""
    steps = []
    for i in range(4):
        k = rng.integers(0, 40, 14_000).astype(np.int64)
        ts = i * 3_000 + rng.integers(0, 3_000, 14_000)
        k[:10_000] = 7
        ts[:10_000] = i * 3_000 + rng.integers(0, 2_000, 10_000)
        steps += [("batch", k, ts.astype(np.int64)), ("wm", i * 3_000 + 2_999)]
    return steps


def test_pair_counts_past_0xfff_take_triples_in_a_fused_step(calls):
    """A hot key with more than 0xFFF records in one pane: the reference
    sends u16 triples and fires in chunks, the port fires the stashed
    triples in one fused step a batch."""
    rng = np.random.default_rng(5)
    ref, port = make_pair(1_000, None, 2)
    drive(ref, port, hot_key_steps(rng))
    assert calls["fused_step"] >= 3 and calls["apply_pairs_u16"] == 0


def test_pair_counts_past_0xfff_without_top_n_take_u16(calls):
    """The same hot key on a count-only operator without top-n: no fused
    step, so both fold the triples in at once (``apply_pairs_u16`` on
    the C-written real triples)."""
    rng = np.random.default_rng(5)
    ref, port = make_pair(1_000, None, 0)
    drive(ref, port, hot_key_steps(rng))
    assert calls["apply_pairs_u16"] >= 3 and calls["fused_step"] == 0


def test_late_records_refire_on_the_lane(calls):
    """Allowed lateness 3 s: late-within-lateness records re-fire their
    windows (the scan's re-fire bitmap), later ones are dropped."""
    rng = np.random.default_rng(6)
    ref, port = make_pair(1_000, None, 2, lateness=3_000)
    steps = [("batch", rng.integers(0, 30, 4_000), rng.integers(0, 5_000, 4_000)),
             ("wm", 4_999),
             ("batch", rng.integers(0, 30, 4_000), rng.integers(0, 7_000, 4_000)),
             ("wm", 6_999),
             ("batch", rng.integers(0, 30, 4_000), rng.integers(2_000, 9_000, 4_000)),
             ("wm", 8_999)]
    steps = [(s[0], np.asarray(s[1], np.int64), np.asarray(s[2], np.int64))
             if s[0] == "batch" else s for s in steps]
    fired = drive(ref, port, steps)
    ends = [w for _, _, w, _ in fired]
    assert len(ends) > len(set(ends)) and port.late_records > 0
    assert calls["fused_step"] >= 1


def test_ring_growth_inside_the_scan_with_a_stash_pending(calls):
    """A stashed batch, then one whose span outgrows the ring before any
    advance: the scan grows the ring (the stash lands in the old layout
    first) and scans again."""
    rng = np.random.default_rng(7)
    ref, port = make_pair(10_000, 1_000, 1, ooo=1_000)
    steps = [span_batch(rng, 20_000, 100, 0, 8, 1_000),
             span_batch(rng, 20_000, 100, 0, 8, 1_000),
             span_batch(rng, 40_000, 100, 5, 40, 1_000),
             ("wm", 30_000)]
    step_both(ref, port, steps[0])
    step_both(ref, port, steps[1])
    assert port._stash is not None
    ring0 = port.plan.ring
    drive(ref, port, steps[2:])
    assert port.plan.ring > ring0


def test_snapshot_with_a_stash_pending_restores_into_a_twin():
    """snapshot_state folds a pending stash in first: a twin restored
    from it continues exactly as the original and as the reference."""
    rng = np.random.default_rng(8)
    ref, port = make_pair(10_000, 1_000, 2, ooo=1_000)
    pre = [span_batch(rng, 20_000, 100, 0, 12, 1_000), ("wm", 5_000),
           span_batch(rng, 20_000, 100, 4, 16, 1_000)]
    for st in pre:
        step_both(ref, port, st)
    assert port._stash is not None
    snap = port.snapshot_state()
    ref.snapshot_state()
    assert port._stash is None
    _, twin = make_pair(10_000, 1_000, 2, ooo=1_000)
    twin.restore_state(snap)
    assert twin.directory.native()
    post = [("wm", 12_000), span_batch(rng, 20_000, 100, 10, 24, 1_000),
            ("wm", 20_000)]
    out = []
    for st in post:
        if st[0] == "batch":
            twin.process_batch(st[1], st[2], {})
        else:
            out += rows_of(twin.advance_watermark(st[1]))
    out += rows_of(twin.advance_watermark(twin.final_watermark()))
    fired = drive(ref, port, post)
    assert out == fired and len(out) > 20


def test_wordcount_shape_without_top_n(calls):
    """Count without top-n: the words are folded in at once (no stash)
    and the fires go through packed buffers."""
    rng = np.random.default_rng(9)
    ref, port = make_pair(1_000, None, 0, shards=16, slots=64)
    steps = []
    for i in range(6):
        u = rng.random(16_384)
        ts = (i * 16_384 + np.arange(16_384)) // 4
        steps += [("batch", (u * u * 300).astype(np.int64), ts.astype(np.int64)),
                  ("wm", int(ts.max()))]
    drive(ref, port, steps)
    assert calls["apply_pairs_u32"] >= 4 and calls["fused_step"] == 0


@pytest.mark.parametrize("n", [0, 2])
def test_uploads_and_applies_take_the_real_pairs_only(monkeypatch, n):
    """The finalize writes the header and the real pairs, no power-of-two
    padding: each upload of the lane (``PinnedStage.upload_slot``) moves
    4 * (FUSED_HDR + npairs) bytes for a fused step (top-n) or 4 * npairs
    for ``apply_pairs_u32`` (none), and the device call takes that many
    words; the general path's C combine (``_apply_combined``) hands
    ``apply_pairs_u32`` a word a pair too. Rows and state equal the
    reference's, which pads."""
    from flink_tpu_torch import native_codec
    from flink_tpu_torch.ops import window as pw

    pairs, uploads, words = [], [], []
    orig_final = native_codec.ingest_fused_finalize_u32_native

    def final_spy(res, ws, hdr, cap_out, out=None):
        pairs.append(res.npairs)
        return orig_final(res, ws, hdr, cap_out, out)
    monkeypatch.setattr(native_codec, "ingest_fused_finalize_u32_native",
                        final_spy)
    orig_upload = pw.PinnedStage.upload_slot

    def upload_spy(self, i, lo, hi):
        uploads.append(hi - lo)
        return orig_upload(self, i, lo, hi)
    monkeypatch.setattr(pw.PinnedStage, "upload_slot", upload_spy)
    for name in ("fused_step", "apply_pairs_u32"):
        orig = getattr(fk, name)

        def spy(counts, *a, _orig=orig, _name=name, **k):
            buf = a[1] if _name == "fused_step" else a[0]
            words.append(buf.numel())
            return _orig(counts, *a, **k)
        monkeypatch.setattr(fk, name, spy)
    rng = np.random.default_rng(11)
    ref, port = make_pair(10_000, 1_000, n, ooo=1_000)
    # the first batch registers the keys (the general path); the next
    # three take the lane, the last growing the ring in its scan
    steps = []
    for i in range(4):
        steps += [span_batch(rng, 20_000, 300, 4 * i, 4 * i + 7, 1_000),
                  ("wm", (4 * i + 4) * 1_000 - 1)]
    fired = drive(ref, port, steps)
    assert len(fired) > 20 and len(pairs) == 3
    want = [fk.FUSED_HDR + p if n else p for p in pairs]
    # the general path's C combine of the first batch: a word a pair too
    combined = words.pop(0)
    assert words == want and uploads == [4 * w for w in want]
    # not powers of two: padding would have shown
    assert all(p & (p - 1) for p in pairs + [combined])


# -- end to end through env.execute ---------------------------------------------

def test_q5_end_to_end_in_order(calls):
    """Q5 hot items on Q5's slots, ~20 s of event time a batch (about 20
    window ends an advance): committed rows equal the reference's native
    run in order, and the golden as a set; every batch after the first
    runs one fused step."""
    from test_torch_q5 import golden, run_both, seeded_bids

    gen = seeded_bids(20_480, 4, 1, 200, seed=12)
    conf = {"state.num-key-shards": 128, "state.slots-per-shard": 256,
            "pipeline.microbatch-size": 20_480}
    ref, got, res = run_both(gen, conf, 10_000, 1_000, 1_000)
    assert got == ref
    assert set(got) == golden(gen, 10_000, 1_000)
    assert calls["fused_step"] == 3
    assert any(k.endswith(".pb_preagg") for k in res.metrics)


def test_wordcount_end_to_end_matches_reference(calls):
    from test_torch_window_aggregates import (
        assert_rows_match, run_both, wordcount, wordcount_gen)

    gen = wordcount_gen(16_384, 6, 300, 4)
    conf = {"state.num-key-shards": 16, "state.slots-per-shard": 64,
            "pipeline.max-inflight-steps": 1}
    ref, got, _ = run_both(wordcount, gen, conf, 0)
    assert_rows_match(got, ref)
    assert calls["apply_pairs_u32"] >= 4 and calls["fused_step"] == 0


def test_bid_aggregates_host_combined_in_c_match_reference(calls, monkeypatch):
    """Job (b), multi(count, avg): the host combine runs in C on the
    native lane (the C combine hands back pairs for every batch, so
    nothing took the numpy combine); sums within the ordering bound."""
    from flink_tpu_torch import native_codec
    from test_torch_window_aggregates import assert_rows_match, bid_aggs, bids_gen, run_both

    combined = []
    orig = native_codec.preagg_combine_native

    def spy(*a, **k):
        out = orig(*a, **k)
        combined.append(out is not None)
        return out
    monkeypatch.setattr(native_codec, "preagg_combine_native", spy)
    gen = bids_gen(4096, 6, 60, 1, seed=False)
    conf = {"state.num-key-shards": 8, "state.slots-per-shard": 64}
    ref, got, res = run_both(bid_aggs("b"), gen, conf, 1_000)
    assert_rows_match(got, ref)
    assert len(set(got["window_end"].tolist())) > 20
    assert len(combined) >= 6 and all(combined)
    assert any(k.endswith(".preagg_combine") for k in res.metrics)
    assert not calls
