"""The port's device-made Q5 path (bids made on the card) against the JAX
package's, on the CPU: the bid generator bit for bit, the ingest step's
pane counts and stats vector, the operator's fired rows and state, and
``env.execute()`` at 1, 2 and 4 sub-batches — integers all, so every comparison is exact. Here the
kernel wrappers take their plain PyTorch versions (the tensors lie on
the CPU); tests/test_torch_cuda.py holds the kernels to the same plain
versions on the card.

The reference's device-made path needs its C codec (its attach gate
requires the C hash table for miss repair), so the cases that run it
carry tests/test_devgen.py's skip; the port-only cases do not."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.api.environment import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.sinks import CollectSink as JaxCollectSink
from flink_tpu.api.sources import DeviceGeneratorSource as JaxDeviceSource
from flink_tpu.api.windowing import SlidingEventTimeWindows as JaxSliding
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.native_codec import native_available
from flink_tpu.nexmark import generator as jgen
from flink_tpu.nexmark.queries import q5_hot_items as jax_q5
from flink_tpu.ops import window as jw
from flink_tpu.ops.aggregates import count as jax_count
from flink_tpu.state.keyed import PaneState as JaxPaneState
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import CollectSink
from flink_tpu_torch.api.sources import DeviceGeneratorSource, GeneratorSource
from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.kernels import devgen_kernels as dk
from flink_tpu_torch.nexmark import generator as pgen
from flink_tpu_torch.nexmark.queries import q5_hot_items
from flink_tpu_torch.ops import window as pw
from flink_tpu_torch.ops.aggregates import count
from test_torch_threads import capped_torch_threads  # noqa: F401

needs_native = pytest.mark.skipif(
    not native_available(), reason="needs the C codec (miss repair)")

# tests/test_devgen.py's shape: batch 4096, 4 bids/ms, 500 auctions
CFG = dict(batch_size=4096, n_batches=6, events_per_ms=4,
           num_active_auctions=500, hot_ratio=4)
# one batch spans 16 s of event time: a K = 1 advance fires ~16 windows
WIDE = dict(batch_size=16384, n_batches=3, events_per_ms=1,
            num_active_auctions=300, hot_ratio=4)
SLOTS = {"state.num-key-shards": 8, "state.slots-per-shard": 128}
COLS = ("key", "window_start", "window_end", "count")


def both_sources(cfg, k=1):
    ref = jgen.bid_stream_device(jgen.NexmarkConfig(**cfg))
    port = pgen.bid_stream_device(pgen.NexmarkConfig(**cfg))
    return (ref.subdivided(k), port.subdivided(k)) if k > 1 else (ref, port)


def rows_of(fired):
    f = dict(fired)
    return list(zip(*(np.asarray(f[c]).tolist() for c in COLS)))


def golden(parts, window_ms, slide_ms):
    """{(auction, window_end, count)}: each window's max-count auctions,
    from (auction, ts) arrays."""
    a = np.concatenate([p[0] for p in parts])
    ts = np.concatenate([p[1] for p in parts])
    ppw = window_ms // slide_ms
    pane = ts // slide_ms
    n_a, n_p = int(a.max()) + 1, int(pane.max()) + 1
    per = np.bincount(a * n_p + pane, minlength=n_a * n_p).reshape(n_a, n_p)
    cs = np.concatenate([np.zeros((n_a, 1), np.int64), per.cumsum(1)], 1)
    out = set()
    for e in range(1, n_p + ppw):
        win = cs[:, min(e, n_p)] - cs[:, max(e - ppw, 0)]
        if win.max() > 0:
            out |= {(int(x), e * slide_ms, int(win.max()))
                    for x in np.flatnonzero(win == win.max())}
    return out


# -- (a) the generator, bit for bit -----------------------------------------

@needs_native
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("i", [0, 3, 17])
def test_generator_matches_the_reference(i, k):
    """Port K5 (plain) = JAX ``jax.jit(device_keys_ts)`` = port and JAX
    ``keys_ts_host``; ``ts_bounds`` and the ``gen`` fallback agree too.
    At K = 4 index ``i`` is a sub-batch of the subdivided stream."""
    ref, port = both_sources(dict(CFG, n_batches=24), k)
    dk_, dts = jax.jit(ref.device_keys_ts)(np.int64(i))
    pk, pts = port.device_keys_ts(i, torch.device("cpu"))
    hk, hts = port.keys_ts_host(i)
    rk, rts = ref.keys_ts_host(i)
    for keys, ts in ((pk.numpy(), pts.numpy()), (hk, hts), (rk, rts)):
        np.testing.assert_array_equal(keys, np.asarray(dk_))
        np.testing.assert_array_equal(ts, np.asarray(dts))
    assert port.ts_bounds(i) == ref.ts_bounds(i) == (int(hts[0]), int(hts[-1]))
    pdata, pts2 = port.gen("0", i)
    rdata, rts2 = ref.gen("0", i)
    np.testing.assert_array_equal(pts2, rts2)
    for lane in ("auction", "bidder"):
        np.testing.assert_array_equal(pdata[lane], rdata[lane])
    # price: the same float32 fast_exp formula; a compiler may contract
    # its multiply-add into an FMA, which moves the pre-cast sum by at
    # most one float32 ulp at 2^30 (128 units of the int32 bits), i.e.
    # a relative error under 128 / 2^23
    np.testing.assert_allclose(pdata["price"], rdata["price"],
                               rtol=128 / 2 ** 23, atol=0)
    assert port.batch_size == ref.batch_size
    assert port.n_batches == ref.n_batches
    assert port.gen("0", port.n_batches) is None
    assert ref.gen("0", ref.n_batches) is None


@pytest.mark.parametrize("k", [2, 4])
def test_subdivided_stream_is_a_bit_exact_slice(k):
    """Sub-batch j of logical batch i (of the K-subdivided source) is
    records [j * b, (j + 1) * b) of logical batch i, on the device path
    and the host path alike."""
    src = pgen.bid_stream_device(pgen.NexmarkConfig(**CFG))
    sub = src.subdivided(k)
    b = src.batch_size // k
    assert sub.batch_size == b and sub.n_batches == src.n_batches * k
    for i in range(2):
        k1, t1 = src.keys_ts_host(i)
        for j in range(k):
            s = k * i + j
            dk_, dts = sub.device_keys_ts(s, "cpu")
            kh, th = sub.keys_ts_host(s)
            sl = slice(j * b, (j + 1) * b)
            np.testing.assert_array_equal(dk_.numpy(), k1[sl])
            np.testing.assert_array_equal(dts.numpy(), t1[sl])
            np.testing.assert_array_equal(kh, k1[sl])
            np.testing.assert_array_equal(th, t1[sl])
            assert sub.ts_bounds(s) == (int(th[0]), int(th[-1]))


@needs_native
@pytest.mark.parametrize("seed,start,n", [(0, 0, 4096), (9, 1000, 3000),
                                          (123456, 1 << 20, 5000)])
def test_numpy_bids_match_the_native_codec(seed, start, n):
    """The port's numpy copy of native/codec.cc nexmark_bids: auction and
    bidder bit for bit, price under the FMA tolerance stated above."""
    from flink_tpu.native_codec import nexmark_bids_native

    a, b, p = nexmark_bids_native(seed, start + n, 4, 7, 700, 900)
    got = pgen.nexmark_bids(seed, start, n, 4, 7, 700, 900)
    np.testing.assert_array_equal(got["auction"], a[start:])
    np.testing.assert_array_equal(got["bidder"], b[start:])
    np.testing.assert_allclose(got["price"], p[start:], rtol=128 / 2 ** 23,
                               atol=0)


# -- (b) one ingest step against _JIT_DEVGEN_STEP ---------------------------

# batch ``late_batch`` of the odd stream lies this far back in event time
LATE_SHIFT_MS = -30_000


@dataclasses.dataclass(frozen=True)
class JaxOddGen:
    """Keys partly outside [0, domain) (negative too; the three hot keys
    domain..domain+2 all outside), in jnp; batch ``late_batch`` shifted
    LATE_SHIFT_MS back."""

    batch_size: int
    events_per_ms: int
    domain: int
    late_batch: int = -1

    def __call__(self, batch_index):
        ids = batch_index * self.batch_size + jnp.arange(self.batch_size,
                                                         dtype=jnp.int64)
        shift = jnp.where(batch_index == self.late_batch, LATE_SHIFT_MS, 0)
        keys = jnp.where(ids % 3 == 0, self.domain + (ids // 3) % 3,
                         (ids * 7919) % (self.domain + 64) - 16)
        return keys, ids // self.events_per_ms + shift


@dataclasses.dataclass(frozen=True)
class PortOddGen:
    """The same formula in torch (device path) and numpy (host copy)."""

    batch_size: int
    events_per_ms: int
    domain: int
    late_batch: int = -1

    def _shift(self, batch_index):
        return LATE_SHIFT_MS if batch_index == self.late_batch else 0

    def __call__(self, batch_index, device):
        ids = batch_index * self.batch_size + torch.arange(
            self.batch_size, dtype=torch.int64, device=device)
        keys = torch.where(ids % 3 == 0, self.domain + (ids // 3) % 3,
                           torch.remainder(ids * 7919, self.domain + 64) - 16)
        return (keys, torch.div(ids, self.events_per_ms, rounding_mode="floor")
                + self._shift(batch_index))

    def host(self, batch_index):
        ids = batch_index * self.batch_size + np.arange(self.batch_size,
                                                        dtype=np.int64)
        keys = np.where(ids % 3 == 0, self.domain + (ids // 3) % 3,
                        (ids * 7919) % (self.domain + 64) - 16)
        return keys, ids // self.events_per_ms + self._shift(batch_index)


def step_header(batch_index, dead, refire_below):
    """The reference's step header with no window to fire and an empty
    clear mask: its step is then the ingest alone."""
    hdr = np.zeros(jw.FUSED_HDR, np.int32)
    hdr[:6] = np.array([0, -1, 0], np.int64).view(np.int32)
    hdr[8:8 + jw.MIN_FIRE_PAD] = jw._DELTA_SENTINEL
    hdr[jw.DEVGEN_HDR_OFF:jw.DEVGEN_HDR_OFF + 6] = np.array(
        [batch_index, dead, refire_below], np.int64).view(np.int32)
    return hdr


INT64_MIN = int(np.iinfo(np.int64).min)
# batch 5 of the CFG stream at 1 bid/ms covers ts 20480..24575: panes
# 20..24 at 1 s panes
STEP_CASES = {
    "steady": dict(batch=5, dead=10, refire_below=INT64_MIN),
    "late": dict(batch=5, dead=22, refire_below=INT64_MIN),
    "refire": dict(batch=5, dead=18, refire_below=23),
    "out_of_domain": dict(batch=5, dead=21, refire_below=22, odd=True),
}


def step_generators(case, epm=1, domain=400):
    """(JAX generator, port generator, batch, dead, refire_below)."""
    c = dict(STEP_CASES[case])
    if c.get("odd"):
        return (JaxOddGen(4096, epm, domain), PortOddGen(4096, epm, domain),
                c["batch"], c["dead"], c["refire_below"])
    cfg = dict(CFG, events_per_ms=epm, num_active_auctions=domain)
    jgen_fn, pgen_fn = (s.device_keys_ts for s in both_sources(cfg))
    return jgen_fn, pgen_fn, c["batch"], c["dead"], c["refire_below"]


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_devgen_step_matches_jit_devgen_step(case):
    """The port's make + ingest (the source's ``device_keys_ts``, then
    ``devgen_ingest``) against the reference's step with nothing to fire
    or clear: counts on every row (the dump row too) and the whole stats
    vector equal, the emit ring's head words 3 and 5 at 0 in both."""
    jgen_fn, pgen_fn, batch, dead, refire_below = step_generators(case)
    domain, ring, ppw = 400, 16, 10
    slots = 1024
    rows = slots + 1
    hdr = step_header(batch, dead, refire_below)
    rng = np.random.default_rng(len(case))
    used = np.zeros(rows, bool)
    used[:domain] = True
    # live columns for panes 14..19 before the batch (ring invariant)
    counts0 = np.zeros((rows, ring), np.int32)
    for p in range(14, 20):
        counts0[:domain, p % ring] = rng.integers(0, 40, domain)
    st, ring_j, stats_j = jw._JIT_DEVGEN_STEP(
        JaxPaneState(None, None, None, jnp.asarray(counts0)),
        jnp.zeros((2050, 3), jnp.int32), jnp.asarray(hdr), jnp.asarray(used),
        gen=jgen_fn, key_domain=domain, agg=jax_count(),
        panes_per_window=ppw, ring=ring, sel_cap=256, by="count", topn=1,
        dump_row=slots, pane_ms=1000, offset_ms=0, fire_gate=True)
    counts = torch.from_numpy(counts0.copy())
    keys, ts = pgen_fn(batch, torch.device("cpu"))
    stats = dk.devgen_ingest(
        counts, keys, ts, key_domain=domain, pane_ms=1000, offset_ms=0,
        dead_below=dead, refire_below=refire_below, dump_row=slots)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(st.counts))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(stats_j))
    head = stats.numpy()[:8]
    assert head[3] == head[5] == 0
    if case in ("late", "out_of_domain"):
        assert head[1] > 0
    if case in ("refire", "out_of_domain"):
        assert head[4] > 0 and stats.numpy()[8:].sum() > 0
    if case == "out_of_domain":
        assert head[2] > 0 and counts.numpy()[slots].sum() == head[1] + head[2]


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_devgen_ingest_without_stats_folds_the_same_counts(case):
    """``with_stats=False`` (a batch that cannot be late, re-fire or
    miss) writes the same pane counts and returns no stats vector."""
    _, pgen_fn, batch, dead, refire_below = step_generators(case)
    keys, ts = pgen_fn(batch, torch.device("cpu"))
    kw = dict(key_domain=400, pane_ms=1000, offset_ms=0, dead_below=dead,
              refire_below=refire_below, dump_row=1024)
    a = torch.zeros((1025, 16), dtype=torch.int32)
    b = a.clone()
    assert dk.devgen_ingest(a, keys, ts, **kw) is not None
    assert dk.devgen_ingest(b, keys, ts, with_stats=False, **kw) is None
    assert torch.equal(a, b) and int(a.sum()) == len(keys)


# -- (b') the Nexmark form: the bids made inside the ingest ------------------

# the same stream at 1 bid/ms: sub-batch s of K covers ts s * 4096 / K
# onwards; panes below 21 are late, below 23 re-fire candidates
NEXMARK_STEPS = [(1, 5), (4, 20), (4, 21), (4, 23)]


@pytest.mark.parametrize("k,batch", NEXMARK_STEPS)
def test_nexmark_form_matches_jit_devgen_step(k, batch):
    """The Nexmark form of ``devgen_ingest`` (the generator's
    ``ingest_into``, its plain version here) against the reference's
    step with its ``_NexmarkDeviceBidGen`` traced in, at K = 1 and at
    sub-batches 0, 1 and 3 of a logical batch at K = 4: counts on every
    row and the whole stats vector equal, late and re-fire records in
    the mix."""
    cfg = dict(CFG, events_per_ms=1, num_active_auctions=400)
    ref_src, port_src = both_sources(cfg, k)
    domain, ring, slots, dead, refire_below = 400, 16, 1024, 21, 23
    hdr = step_header(batch, dead, refire_below)
    used = np.zeros(slots + 1, bool)
    used[:domain] = True
    counts0 = np.zeros((slots + 1, ring), np.int32)
    counts0[:domain, 21 % ring] = np.arange(domain) % 7
    st, _, stats_j = jw._JIT_DEVGEN_STEP(
        JaxPaneState(None, None, None, jnp.asarray(counts0)),
        jnp.zeros((2050, 3), jnp.int32), jnp.asarray(hdr), jnp.asarray(used),
        gen=ref_src.device_keys_ts, key_domain=domain, agg=jax_count(),
        panes_per_window=10, ring=ring, sel_cap=256, by="count", topn=1,
        dump_row=slots, pane_ms=1000, offset_ms=0, fire_gate=True)
    counts = torch.from_numpy(counts0.copy())
    stats = port_src.device_keys_ts.ingest_into(
        counts, batch, key_domain=domain, pane_ms=1000, offset_ms=0,
        dead_below=dead, refire_below=refire_below, dump_row=slots)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(st.counts))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(stats_j))
    head = stats.numpy()[:8]
    assert head[0] + head[1] == 4096 // k and head[2] == 0
    # the memory form on the generator's own records folds the same
    mem = torch.from_numpy(counts0.copy())
    keys, ts = port_src.device_keys_ts(batch, torch.device("cpu"))
    dk.devgen_ingest(mem, keys, ts, key_domain=domain, pane_ms=1000,
                     offset_ms=0, dead_below=dead, refire_below=refire_below,
                     dump_row=slots)
    assert torch.equal(mem, counts)


def test_nexmark_form_refuses_bad_generator_arguments():
    counts = torch.zeros((11, 4), dtype=torch.int32)
    kw = dict(key_domain=10, pane_ms=1000, offset_ms=0, dead_below=0,
              refire_below=0, dump_row=10)
    for gen in ((0, 0, 100, 100, 0, 4, 1, 10), (0, -1, 100, 100, 1, 4, 1, 10),
                (0, 0, 100, 100, 1, 4, 0, 10), (0, 0, 100, 100, 1, 4, 1, 2 ** 31)):
        with pytest.raises(ValueError, match="devgen_ingest_nexmark"):
            dk.devgen_ingest_nexmark(counts, gen, **kw)
    with pytest.raises(ValueError, match="pane_ms"):
        dk.devgen_ingest_nexmark(counts, (0, 0, 100, 100, 1, 4, 1, 10),
                                 **dict(kw, pane_ms=0))


def test_devgen_sources_share_one_generator():
    """``nexmark_bids``' kernel and the ingest's Nexmark form make their
    records with the same device functions (csrc/nexmark_gen.cuh)."""
    import os

    csrc = os.path.join(os.path.dirname(dk.__file__), "csrc")
    with open(os.path.join(csrc, "devgen_kernels.cu")) as f:
        cu = f.read()
    assert '#include "nexmark_gen.cuh"' in cu
    k5 = cu[cu.index("__global__ void nexmark_bids_kernel"):]
    k6 = cu[cu.index("devgen_ingest_kernel(const IngestParams p)"):]
    for body in (k5, k6):
        assert "nexmark_key" in body[:body.index("\n}\n")]
    assert "0x9E3779B97F4A7C15ULL" not in cu


# -- (d) the operator, both packages attached to one stream -----------------

def make_ops(k=1, ooo=1_000, slots=128):
    kw = dict(num_shards=8, slots_per_shard=slots, top_n=("count", 1),
              max_out_of_orderness_ms=ooo)
    ref = jw.WindowOperator(JaxSliding.of(10_000, 1_000), jax_count(), **kw)
    port = pw.WindowOperator(SlidingEventTimeWindows.of(10_000, 1_000),
                             count(), device="cpu", **kw)
    return ref, port


def drive_devgen(ref, port, srcs, batches, advance_after, ooo=1_000):
    """process_batch_device on both; advance both after the listed
    batches (the others stay stashed and flush fire-less); then the
    end-of-input flush. Rows of every advance compared in order."""
    fired = []
    for i in batches:
        assert ref.process_batch_device(i) == port.process_batch_device(i)
        if i in advance_after:
            wm = srcs[1].ts_bounds(i)[1] - ooo - 1
            a = rows_of(ref.advance_watermark(wm))
            b = rows_of(port.advance_watermark(wm))
            assert b == a
            fired.append(b)
    ref.quiesce()
    port.quiesce()
    assert port.final_watermark() == ref.final_watermark()
    a = rows_of(ref.advance_watermark(ref.final_watermark()))
    b = rows_of(port.advance_watermark(port.final_watermark()))
    assert b == a
    fired.append(b)
    assert port.plan.ring == ref.plan.ring
    assert port.late_records == ref.late_records
    np.testing.assert_array_equal(port.state.counts.numpy(),
                                  np.asarray(ref.state.counts))
    return fired


@needs_native
def test_operator_rows_and_state_match_the_reference():
    """Six 8.2 s batches; advances after batches 0 and 1, then none until
    batch 5, whose step fires ~33 windows at once (more than the
    host-fed path's chunk of 16) and purges ring columns on both sides
    of column 32, after the ring grew 16 -> 32 -> 64 columns (each growth
    flushing a stashed batch first)."""
    cfg = dict(CFG, batch_size=8192, events_per_ms=1)
    srcs = both_sources(cfg)
    ref, port = make_ops()
    assert ref.attach_device_source(srcs[0])
    assert port.attach_device_source(srcs[1])
    fired = drive_devgen(ref, port, srcs, range(6), {0, 1, 5})
    assert max(len({r[2] for r in f}) for f in fired) > 16
    assert port.plan.ring == 64


@needs_native
@pytest.mark.parametrize("n_ends", [pw.MIN_FIRE_PAD, pw.MIN_FIRE_PAD + 1])
def test_one_fire_pair_holds_up_to_min_fire_pad_ends(n_ends, monkeypatch):
    """One stashed batch spanning n_ends - 9 one-second panes, then the
    final advance: its n_ends windows fire in one window_counts +
    topn_select_append pair up to MIN_FIRE_PAD ends, in chunks of
    MAX_FIRE_CHUNK_RING above it; rows equal the reference's in order
    either way."""
    cfg = dict(CFG, batch_size=(n_ends - 9) * 1000, n_batches=1,
               events_per_ms=1)
    srcs = both_sources(cfg)
    ref, port = make_ops()
    assert ref.attach_device_source(srcs[0])
    assert port.attach_device_source(srcs[1])
    assert ref.process_batch_device(0) and port.process_batch_device(0)
    pairs = []
    real = pw.wk.window_counts
    monkeypatch.setattr(pw.wk, "window_counts",
                        lambda c, e, *a: pairs.append(len(e)) or real(c, e, *a))
    wm = port.final_watermark()
    assert wm == ref.final_watermark()
    b = rows_of(port.advance_watermark(wm))
    a = rows_of(ref.advance_watermark(wm))
    assert b == a
    assert len({r[2] for r in b}) == n_ends == sum(pairs)
    if n_ends <= pw.MIN_FIRE_PAD:
        assert pairs == [n_ends]
    else:
        assert max(pairs) == pw.MAX_FIRE_CHUNK_RING


@pytest.mark.parametrize("dead_shift,queued", [(0, False), (1, True)])
def test_stats_come_back_only_when_a_batch_can_be_late(dead_shift, queued):
    """A batch of the bounded Nexmark domain wholly above the purge and
    fire frontiers makes no stats vector; one reaching below the purge
    frontier queues its stats for reconciliation."""
    src = pgen.bid_stream_device(pgen.NexmarkConfig(**CFG))
    _, port = make_ops()
    assert port.attach_device_source(src)
    assert port.process_batch_device(0)
    port.advance_watermark(src.ts_bounds(0)[1] - 1_001)
    port.quiesce()
    lo = (src.ts_bounds(1)[0]) // 1000
    port._cleared_below = lo + dead_shift
    port._fired_below_end = lo + dead_shift
    assert port.process_batch_device(1)
    port._flush_devgen()
    assert len(port._devstats_pending) == int(queued)
    port.quiesce()
    assert (port.late_records > 0) == queued


# -- (e) Q5 through env.execute() at K = 1, 2, 4 ----------------------------

# run_q5_both's runs of the seeded sources, shared by the cases that
# compare the same job (each package's run is deterministic)
_Q5_RUNS = {}


def run_q5_both(cfg, k, window_ms, ooo, source_fn=None):
    if source_fn is None:
        key = (tuple(sorted(cfg.items())), k, window_ms, ooo)
        if key not in _Q5_RUNS:
            _Q5_RUNS[key] = _run_q5_both(cfg, k, window_ms, ooo, None)
        return _Q5_RUNS[key]
    return _run_q5_both(cfg, k, window_ms, ooo, source_fn)


def _run_q5_both(cfg, k, window_ms, ooo, source_fn):
    conf = dict(SLOTS, **{"pipeline.microbatch-size": cfg["batch_size"],
                          "pipeline.sub-batches": k})
    jsrc, psrc = source_fn() if source_fn else both_sources(cfg)
    env = JaxEnv(JaxConfiguration(dict(conf)))
    jsink = JaxCollectSink()
    jax_q5(env, jsrc, jsink, window_ms=window_ms, slide_ms=1_000,
           out_of_orderness_ms=ooo)
    jres = env.execute("q5-devgen-jax")
    env = StreamExecutionEnvironment(Configuration(dict(conf)))
    sink = CollectSink()
    q5_hot_items(env, psrc, sink, window_ms=window_ms, slide_ms=1_000,
                 out_of_orderness_ms=ooo)
    res = env.execute("q5-devgen-port", device="cpu")

    def rows(s):
        return [(int(r["auction"]), int(r["window_end"]), int(r["bid_count"]))
                for r in s.rows]
    return rows(jsink), rows(sink), jres, res


@needs_native
@pytest.mark.parametrize("shape", ["steady", "wide"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_q5_devgen_matches_the_reference_and_golden(k, shape):
    cfg, window_ms, ooo = ((CFG, 4_000, 500) if shape == "steady"
                           else (WIDE, 10_000, 1_000))
    ref, got, jres, res = run_q5_both(cfg, k, window_ms, ooo)
    assert got == ref and len(got) > 0
    assert res.metrics["records_in"] == jres.metrics["records_in"] \
        == cfg["batch_size"] * cfg["n_batches"]
    assert res.metrics["devgen_host_batches"] == 0
    src = pgen.bid_stream_device(pgen.NexmarkConfig(**cfg))
    want = golden([src.keys_ts_host(i) for i in range(cfg["n_batches"])],
                  window_ms, 1_000)
    assert set(got) == want and len(got) == len(want)


@needs_native
def test_rows_agree_window_by_window_across_k():
    """A fire appends rows row-major over all its window ends, so a K = 1
    advance over many ends and the K = 4 advances over the same ends
    commit the same rows in another interleave — in the reference as in
    the port. Each window's rows keep one order."""
    by_k = {}
    for k in (1, 4):
        ref, got, _, _ = run_q5_both(WIDE, k, 10_000, 1_000)
        assert got == ref
        by_k[k] = got
    assert by_k[1] != by_k[4]
    assert sorted(by_k[1], key=lambda r: r[1]) == \
        sorted(by_k[4], key=lambda r: r[1])


# -- (f) gates and refusals -------------------------------------------------

@needs_native
def test_attach_refuses_a_registered_prefix_of_the_domain():
    """tests/test_devgen.py's gate: a restored directory holding only an
    identity prefix of the domain refuses the chain; the exact domain is
    taken. Both packages agree."""
    small = both_sources(CFG)                                  # domain 500
    big = both_sources(dict(CFG, num_active_auctions=1000))    # domain 1000
    for pkg in (0, 1):
        a = make_ops(slots=256)[pkg]
        assert a.attach_device_source(small[pkg])
        b = make_ops(slots=256)[pkg]
        b.restore_state(a.snapshot_state())
        assert not b.attach_device_source(big[pkg])
        assert b.attach_device_source(small[pkg])


def test_attach_refuses_what_the_step_cannot_host():
    port = make_ops()[1]
    src = pgen.bid_stream_device(pgen.NexmarkConfig(**CFG))
    assert not port.attach_device_source(
        dataclasses.replace(src, key_domain=None))
    assert not port.attach_device_source(
        dataclasses.replace(src, key_domain=8 * 128 + 1))
    wide = pw.WindowOperator(SlidingEventTimeWindows.of(10_000, 1_000),
                             count(), num_shards=8, slots_per_shard=128,
                             max_out_of_orderness_ms=60_000,
                             top_n=("count", 1), device="cpu")
    assert wide.plan.ring > 64
    assert not wide.attach_device_source(src)
    assert port.attach_device_source(src)
    assert port.directory.num_keys() == 500
    np.testing.assert_array_equal(port.directory.lookup(np.arange(500))[0],
                                  np.arange(500))


def test_register_dense_needs_an_empty_directory():
    port = make_ops()[1]
    port.directory.assign(np.array([12345], np.int64))
    with pytest.raises(ValueError, match="empty"):
        port.directory.register_dense(10)


def test_source_refusals():
    with pytest.raises(ValueError, match="n_splits"):
        pgen.bid_stream_device(pgen.NexmarkConfig(batch_size=1024,
                                                  n_batches=2, n_splits=2))
    with pytest.raises(ValueError, match="divide"):
        pgen.bid_stream_device(pgen.NexmarkConfig(**CFG), sub_batches=3)
    src = pgen.bid_stream_device(pgen.NexmarkConfig(**CFG))
    with pytest.raises(ValueError, match="does not divide"):
        src.subdivided(3)
    with pytest.raises(ValueError, match="no subdivide"):
        src.subdivided(2).subdivided(2)
    assert src.subdivided(1) is src


@pytest.mark.parametrize("conf,err,match", [
    ({"pipeline.sub-batches": 0}, ValueError, ">= 1"),
    ({"pipeline.sub-batches": 3}, ValueError, "divide"),
    ({"pipeline.sub-batches": 4, "pipeline.readiness": "telepathy"},
     ValueError, "pipeline.readiness"),
])
def test_sub_batches_checks(conf, err, match):
    """K must be >= 1 and divide the microbatch size, and the throttle's
    readiness must be one the driver knows (a host-fed source with K > 1
    runs: tests/test_torch_subbatch.py)."""
    gen_ = GeneratorSource(lambda split, i: None if i else (
        {"auction": np.arange(8)}, np.arange(8)))
    env = StreamExecutionEnvironment(Configuration(dict(
        SLOTS, **{"pipeline.microbatch-size": 4096}, **conf)))
    q5_hot_items(env, gen_, CollectSink(), window_ms=2_000, slide_ms=1_000)
    with pytest.raises(err, match=match):
        env.execute("q5", device="cpu")


def test_device_source_with_sub_batches_runs():
    """The headline conf shape in miniature: a chained device source at
    K = 4 runs (microbatch-size 4 x the sub-batch)."""
    src = pgen.bid_stream_device(pgen.NexmarkConfig(**CFG))
    env = StreamExecutionEnvironment(Configuration(dict(
        SLOTS, **{"pipeline.microbatch-size": 4096,
                  "pipeline.sub-batches": 4})))
    sink = CollectSink()
    q5_hot_items(env, src, sink, window_ms=4_000, slide_ms=1_000,
                 out_of_orderness_ms=500)
    res = env.execute("q5", device="cpu")
    assert res.metrics["batches"] == 4 * CFG["n_batches"]
    assert res.metrics["records_in"] == 4096 * CFG["n_batches"]
    assert len(sink.rows) > 0


# -- (g) miss repair and the host fallback ----------------------------------

@pytest.fixture
def reference_reconciles_every_step(monkeypatch):
    """The reference folds a step's stats in once their copy has landed
    (``is_ready``), up to DEVSTATS_MAX_LAG steps late — on the CPU a
    race, so a window may fire before or after its repaired records.
    The port on the CPU always has its stats at hand and reconciles at
    the next advance; lag 0 makes the reference do the same."""
    monkeypatch.setattr(jw.WindowOperator, "DEVSTATS_MAX_LAG", 0)


def odd_sources(bs=2048, epm=2, domain=100, n_batches=5, late_batch=-1):
    """JAX and port sources over keys partly outside the domain. With
    ``late_batch``, that batch's timestamps fall 30 s back — past the
    watermark, so the devgen gate sends it to the host in both."""
    pg = PortOddGen(bs, epm, domain, late_batch)

    def bounds(i):
        t = pg.host(i)[1]
        return int(t.min()), int(t.max())

    def gen(split, i):
        if i >= n_batches:
            return None
        k, t = pg.host(i)
        return {"auction": k}, t

    common = dict(gen=gen, keys_ts_host=pg.host, ts_bounds=bounds,
                  key_field="auction", batch_size=bs, n_batches=n_batches,
                  key_domain=domain, keys_bounded=False)
    return (JaxDeviceSource(
                device_keys_ts=JaxOddGen(bs, epm, domain, late_batch),
                **common),
            DeviceGeneratorSource(device_keys_ts=pg, **common))


@needs_native
def test_miss_repair_matches_the_reference(reference_reconciles_every_step):
    """Keys outside [0, domain) miss on the device; the host makes the
    batch again, registers them, and re-applies those records. Rows in
    order and records_in equal the reference's."""
    ref, got, jres, res = run_q5_both(
        dict(batch_size=2048, n_batches=5), 1, 4_000, 500,
        source_fn=odd_sources)
    assert got == ref and len(got) > 0
    keys = np.concatenate([odd_sources()[1].keys_ts_host(i)[0]
                           for i in range(5)])
    assert {a for a, _, _ in got} - set(range(100))  # repaired keys fire
    assert (keys < 0).any() and (keys >= 100).any()
    assert res.metrics["records_in"] == jres.metrics["records_in"]
    assert res.metrics["devgen_host_batches"] == 0


@needs_native
def test_late_batch_goes_to_the_host_like_the_reference(
        reference_reconciles_every_step):
    """A batch entirely behind the dead frontier closes the devgen gate:
    it is made on the host and fed normally (its records count as late),
    counted in devgen_host_batches; rows equal the reference's."""
    ref, got, jres, res = run_q5_both(
        dict(batch_size=2048, n_batches=5), 1, 4_000, 500,
        source_fn=lambda: odd_sources(late_batch=3))
    assert got == ref and len(got) > 0
    assert res.metrics["devgen_host_batches"] == 1
    assert res.metrics["late_records"] == jres.metrics["late_records"] > 0


# -- (g') which ingest form a device source takes -----------------------------

@needs_native
@pytest.mark.parametrize("k", [1, 4])
def test_operator_makes_nexmark_bids_inside_the_ingest(k, monkeypatch):
    """The operator on a Nexmark device source takes the Nexmark form:
    its plain version runs once a step (a stashed batch, flushed once),
    neither ``nexmark_bids`` nor the memory form's ``devgen_ingest`` is
    called, and the rows, state and ring equal the reference's."""
    cfg = dict(CFG, batch_size=8192, events_per_ms=1)
    srcs = both_sources(cfg, k)
    ref, port = make_ops()
    assert ref.attach_device_source(srcs[0])
    assert port.attach_device_source(srcs[1])
    steps, fused = [], dk.devgen_ingest_nexmark_plain

    def spy(*args):
        steps.append(args[1])
        return fused(*args)

    def refuse(*args, **kw):
        raise AssertionError("the Nexmark source went through memory")

    monkeypatch.setattr(dk, "devgen_ingest_nexmark_plain", spy)
    monkeypatch.setattr(dk, "nexmark_bids", refuse)
    monkeypatch.setattr(dk, "devgen_ingest", refuse)
    stashed, take = [], port.process_batch_device
    monkeypatch.setattr(port, "process_batch_device",
                        lambda i: stashed.append(i) or take(i))
    fired = drive_devgen(ref, port, srcs, range(3 * k), {k - 1, 3 * k - 2})
    assert sum(len(f) for f in fired) > 10
    assert len(steps) == len(stashed) == 3 * k
    assert [g[:3] for g in steps] == [
        (i // k, (i % k) * 8192 // k, 8192 // k) for i in range(3 * k)]


def test_other_device_sources_keep_the_memory_form(monkeypatch):
    """A device source whose generator has no ``ingest_into``
    (``PortOddGen``) makes its batch first (``device_keys_ts``) and folds
    it with ``devgen_ingest``'s memory form, once a step."""
    port = make_ops()[1]
    src = odd_sources()[1]
    assert port.attach_device_source(src)
    calls, mem = [], dk.devgen_ingest

    def refuse(*args, **kw):
        raise AssertionError("the Nexmark form ran on another source")

    monkeypatch.setattr(dk, "devgen_ingest",
                        lambda *a, **kw: calls.append(1) or mem(*a, **kw))
    monkeypatch.setattr(dk, "devgen_ingest_nexmark", refuse)
    for i in range(3):
        assert port.process_batch_device(i)
    port.advance_watermark(src.ts_bounds(2)[1] - 1_001)
    assert len(calls) == 3


# -- (h) a reference snapshot carried across mid-stream ---------------------

@needs_native
def test_jax_devgen_snapshot_continues_in_the_port():
    cfg = dict(CFG, batch_size=5120, events_per_ms=1, n_batches=8)
    srcs = both_sources(cfg)
    ref = make_ops()[0]
    assert ref.attach_device_source(srcs[0])
    for i in range(3):
        ref.process_batch_device(i)
        ref.advance_watermark(srcs[1].ts_bounds(i)[1] - 1_001).materialize()
    ref.process_batch_device(3)            # stashed when the snapshot runs
    snap = ref.snapshot_state()
    snap["panes"] = jax.tree_util.tree_map(np.asarray, snap["panes"])
    port = make_ops()[1]
    port.load_jax_snapshot(snap)
    assert port.attach_device_source(srcs[1])
    np.testing.assert_array_equal(port.state.counts.numpy(),
                                  np.asarray(ref.state.counts))
    fired = drive_devgen(ref, port, srcs, range(4, 8), {4, 5, 7})
    assert sum(len(f) for f in fired) > 10
