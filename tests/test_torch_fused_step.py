"""Parity of the native lane's fused step (F2, ``fused_step``) with the
JAX function it replaces (``_JIT_FUSED_STEP``, flink_tpu/ops/window.py),
run as the JAX tests run it (CPU XLA). On CPU tensors the wrapper takes
its plain PyTorch version; tests/test_torch_cuda.py holds the CUDA
kernels against the same plain version on the card. The lane's two
pair applies (F1, F3) are in tests/test_torch_apply_pairs.py; the fused
step's triple form (F3's triples behind the header) is held here against
the reference's u16 apply followed by its step.

Every comparison is exact (integer work on the count lane): the pane
state and the emit ring, head row included, but for its last row — the
reference's scatter dump for the padding lanes of its fixed-size
selection, which the port never writes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import window as jw
from flink_tpu.ops.aggregates import count as jax_count
from flink_tpu.state.keyed import PaneState as JaxPaneState
from flink_tpu_torch.kernels import fused_kernels as fk
from flink_tpu_torch.ops.window import preagg_encode_u16
from test_torch_threads import capped_torch_threads  # noqa: F401

HDR = fk.FUSED_HDR
ROW_CAP = 256


def _state(rng, rows, ring, pane_lo, pane_hi, hi=40):
    counts = np.zeros((rows, ring), np.int32)
    for p in range(pane_lo, pane_hi + 1):
        counts[:, p % ring] = rng.integers(0, hi, rows) * (rng.random(rows) < 0.5)
    return counts


def _words(rng, slots, ring, n_pairs, cap, *, pane_lo, pane_hi, extra=()):
    """u32 pair words into live columns, a few aimed at the dump row and
    beyond the state, -1 padding up to ``cap``."""
    live = np.arange(pane_lo, pane_hi + 1) % ring
    rows = rng.choice(slots, n_pairs)
    cols = rng.choice(live, n_pairs)
    pairs = np.unique(rows.astype(np.int64) * ring + cols)
    cnts = rng.integers(1, 0xFFF, len(pairs))
    words = list(((pairs << 12) | cnts).astype(np.uint32).view(np.int32))
    for p in extra:
        words.append(np.array([(p << 12) | 5], np.uint32).view(np.int32)[0])
    buf = np.full(cap, -1, np.int32)
    buf[:len(words)] = rng.permutation(np.asarray(words, np.int32))
    return buf


def _header(pane_lo, pane_hi, anchor, ends, clear_cols):
    hdr = np.zeros(HDR, np.int32)
    hdr[:6] = np.array([pane_lo, pane_hi, anchor], np.int64).view(np.int32)
    word = 0
    for c in clear_cols:
        word |= 1 << c
    cw = np.array([word], np.uint64).view(np.int32)
    hdr[7], hdr[6] = cw[0], cw[1]
    deltas = np.full(fk.MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
    deltas[:len(ends)] = np.asarray(ends, np.int64) - pane_lo
    hdr[8:8 + fk.MIN_FIRE_PAD] = deltas.astype(np.int32)
    return hdr


# -- F2 ------------------------------------------------------------------------

def _fused_pair(*, ring, n_ends, fire_pad, gate, n_top=2, seed=0, clear=(),
                fill=0, slots=600, ppw=10):
    """(reference counts, ring) and (port counts, ring) after one fused
    step on the same state, upload and emit ring. Every case shares one
    state, upload and emit shape and n_top, so the reference compiles one
    program per (ring, fire_pad, gate) and the cases below reuse them:
    ring 64 at every bucket gated plus 64 ungated, rings 16 and 32 at 8
    gated and 64 ungated."""
    rng = np.random.default_rng(seed)
    rows = slots + 1
    pane_lo = 1000 + seed
    pane_hi = pane_lo + min(ring - 1, 60)
    base = _state(rng, rows, ring, pane_lo, pane_hi)
    words = _words(rng, slots, ring, 3000, 4096, pane_lo=pane_lo,
                   pane_hi=pane_hi, extra=[slots * ring + 1])
    ends = sorted(rng.choice(np.arange(pane_lo - 2, pane_hi + ppw + 3),
                             n_ends, replace=False).tolist())
    anchor = pane_lo - 7
    buf = np.concatenate([_header(pane_lo, pane_hi, anchor, ends, clear), words])
    used = rng.random(rows) < 0.9
    used[slots] = False
    emit = np.zeros((ROW_CAP + 2, 3), np.int32)
    emit[0, 0] = fill
    emit[1:ROW_CAP + 1] = rng.integers(-5, 5, (ROW_CAP, 3))
    sel_cap = 256
    st, ref_ring, head = jw._JIT_FUSED_STEP(
        JaxPaneState(None, None, None, jnp.asarray(base)), jnp.asarray(emit),
        jnp.asarray(buf), jnp.asarray(used), agg=jax_count(),
        panes_per_window=ppw, ring=ring, sel_cap=sel_cap, by="count",
        topn=n_top, dump_row=slots, fire_gate=gate, fire_pad=fire_pad)
    counts = torch.from_numpy(base.copy())
    port_ring = torch.from_numpy(emit.copy())
    fk.fused_step(counts, port_ring, torch.from_numpy(buf), torch.from_numpy(used),
                  ppw=ppw, n=n_top, sel_cap=sel_cap, dump_row=slots,
                  fire_gate=gate, fire_pad=fire_pad)
    np.testing.assert_array_equal(np.asarray(head), np.asarray(ref_ring)[0])
    return ((np.asarray(st.counts), np.asarray(ref_ring)),
            (counts.numpy(), port_ring.numpy()), base, emit)


def _assert_same(pair):
    (rc, rr), (pc, pr), _, _ = pair
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(pr[:-1], rr[:-1])


@pytest.mark.parametrize("ring,clear", [
    (16, [0, 3, 15]),
    (32, [5, 6, 31]),
    (64, [1, 31, 32, 33, 63]),     # both clear words
    (64, list(range(32, 40))),     # the high word alone
])
@pytest.mark.parametrize("gate", [True, False])
def test_fused_step_rings_and_clear_words(ring, clear, gate):
    pair = _fused_pair(ring=ring, n_ends=5, fire_pad=8 if gate else 64,
                       gate=gate, clear=clear, seed=ring + len(clear))
    _assert_same(pair)
    (rc, rr), _, base, emit = pair
    assert (rc[:, clear] == 0).all() and rr[0, 0] > 0


@pytest.mark.parametrize("fire_pad", [1, 2, 4, 8, 16, 32, 64])
def test_fused_step_every_fire_pad_bucket(fire_pad):
    n_ends = max(1, fire_pad // 2 + 1) if fire_pad > 1 else 1
    _assert_same(_fused_pair(ring=64, n_ends=min(n_ends, fire_pad),
                             fire_pad=fire_pad, gate=True,
                             seed=fire_pad, clear=[7, 40]))


def test_fused_step_fire_sized_to_its_ends():
    """The operator sizes a gated step's fire to its end count (11 here,
    where the reference rounds up to 16): the same state and rows as the
    reference's step at that width and as the port's at 16."""
    exact = _fused_pair(ring=64, n_ends=11, fire_pad=11, gate=True, seed=23,
                        clear=[2, 50])
    _assert_same(exact)
    bucket = _fused_pair(ring=64, n_ends=11, fire_pad=16, gate=True, seed=23,
                         clear=[2, 50])
    np.testing.assert_array_equal(exact[1][0], bucket[1][0])
    np.testing.assert_array_equal(exact[1][1], bucket[1][1])


@pytest.mark.parametrize("n_ends", [0, 1, 64])
@pytest.mark.parametrize("clear", [(), (4, 5)])
def test_fused_step_gate_on_and_off_are_byte_identical(n_ends, clear):
    """Gate on (sized to its ends) and off (all 64 slots): the same
    bytes, equal to the reference's; with no end nothing fires and with
    no clear bit nothing is purged."""
    pad_on = min(64, 1 << max(n_ends - 1, 0).bit_length()) if n_ends else 1
    on = _fused_pair(ring=64, n_ends=n_ends, fire_pad=pad_on, gate=True,
                     seed=11, clear=clear, fill=ROW_CAP - 3)
    off = _fused_pair(ring=64, n_ends=n_ends, fire_pad=64, gate=False,
                      seed=11, clear=clear, fill=ROW_CAP - 3)
    _assert_same(on)
    _assert_same(off)
    np.testing.assert_array_equal(on[1][0], off[1][0])
    np.testing.assert_array_equal(on[1][1], off[1][1])
    (_, rr), _, base, emit = on
    if n_ends == 0:
        np.testing.assert_array_equal(rr[:-1], emit[:-1])
    else:
        assert rr[0, 0] > emit[0, 0]      # rows appended, wrapping the ring


# -- F2 in the triple form ------------------------------------------------------

def _triple_words(pairs, cnts):
    """The C finalize's triple form after the header: ``[pair lo16, pair
    hi16, count]`` uint16 a pair, as int32 words (0xFFFF fills the last
    word's upper half for an odd count)."""
    n = len(pairs)
    t = np.full(2 * ((6 * n + 3) // 4), 0xFFFF, np.uint16)
    t[:3 * n] = preagg_encode_u16(pairs, cnts, n).reshape(-1)
    return t.view(np.int32)


@pytest.mark.parametrize("ring,fire_pad,gate,n_pairs", [
    (32, 8, True, 1201),       # an odd count: a 2-byte tail
    (64, 16, True, 1200),
    (64, 64, False, 1200)])
def test_fused_step_triple_form_matches_preagg_u16_then_the_step(
        ring, fire_pad, gate, n_pairs):
    """The triple form (``FORM_TRIPLES``, the real triples behind the
    header) against the reference's ``apply_preagg_u16_kernel`` on the
    same triples padded as it pads them (flink_tpu/ops/window.py:145),
    then its fused step with no pairs (:587): state and emit ring exact.
    Counts of 0xFFF, 0xFFFE and 0xFFFF; a pair in the dump row (the u16
    form adds it there) and one past the state (dropped). The reference
    programs are the shapes ``_fused_pair`` compiles."""
    rng = np.random.default_rng(ring + n_pairs)
    slots, ppw, n_top = 600, 10, 2
    rows = slots + 1
    pane_lo = 1000 + ring
    pane_hi = pane_lo + min(ring - 1, 60)
    base = _state(rng, rows, ring, pane_lo, pane_hi)
    live = np.arange(pane_lo, pane_hi + 1) % ring
    cells = np.unique(rng.choice(slots, 4 * n_pairs).astype(np.int64) * ring
                      + rng.choice(live, 4 * n_pairs))
    pairs = rng.permutation(cells)[:n_pairs - 2]
    cnts = rng.integers(1, 0x10000, len(pairs))
    cnts[:3] = [0xFFF, 0xFFFE, 0xFFFF]
    pairs = np.concatenate([pairs, [slots * ring + 1, rows * ring + 3]])
    cnts = np.concatenate([cnts, [9, 9]])
    order = rng.permutation(n_pairs)
    pairs, cnts = pairs[order], cnts[order]
    ends = sorted(rng.choice(np.arange(pane_lo - 2, pane_hi + ppw + 3),
                             min(5, fire_pad), replace=False).tolist())
    hdr = _header(pane_lo, pane_hi, pane_lo - 7, ends, [3, ring - 1])
    used = rng.random(rows) < 0.9
    used[slots] = False
    emit = np.zeros((ROW_CAP + 2, 3), np.int32)
    emit[1:ROW_CAP + 1] = rng.integers(-5, 5, (ROW_CAP, 3))
    kw = dict(agg=jax_count(), panes_per_window=ppw, ring=ring, sel_cap=256,
              by="count", topn=n_top, dump_row=slots, fire_gate=gate,
              fire_pad=fire_pad)
    st = jw._JIT_PREAGG_U16(JaxPaneState(None, None, None, jnp.asarray(base)),
                            jnp.asarray(preagg_encode_u16(pairs, cnts, 4096)),
                            ring=ring, dump_row=slots)
    st, ref_ring, _ = jw._JIT_FUSED_STEP(
        st, jnp.asarray(emit),
        jnp.asarray(np.concatenate([hdr, np.full(4096, -1, np.int32)])),
        jnp.asarray(used), **kw)
    buf = np.concatenate([hdr, _triple_words(pairs, cnts)])
    assert fk.pair_triples(torch.from_numpy(buf)).shape == (n_pairs, 3)
    counts = torch.from_numpy(base.copy())
    port_ring = torch.from_numpy(emit.copy())
    fk.fused_step(counts, port_ring, torch.from_numpy(buf),
                  torch.from_numpy(used), ppw=ppw, n=n_top, sel_cap=256,
                  dump_row=slots, fire_gate=gate, fire_pad=fire_pad,
                  form=fk.FORM_TRIPLES)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(st.counts))
    np.testing.assert_array_equal(port_ring.numpy()[:-1],
                                  np.asarray(ref_ring)[:-1])
    assert counts.numpy()[slots, 1] == base[slots, 1] + 9  # the dump row
    assert np.asarray(ref_ring)[0, 0] > 0


def test_decode_header_reads_the_fields():
    hdr = _header(-5, 2 ** 40, 7, [3, 9, -2], [0, 31, 32, 63])
    buf = torch.from_numpy(np.concatenate([hdr, np.full(8, -1, np.int32)]))
    lo, hi, anchor, ends, valid, clear, any_clear = fk.decode_header(buf, 64, 4)
    assert (lo, hi, anchor) == (-5, 2 ** 40, 7)
    assert ends.tolist() == [3, 9, -2, fk.END_SENTINEL]
    assert valid.tolist() == [True, True, True, False]
    assert torch.nonzero(clear).reshape(-1).tolist() == [0, 31, 32, 63]
    assert any_clear


def test_fused_step_refuses_what_the_header_cannot_carry():
    counts = torch.zeros((9, 128), dtype=torch.int32)
    ring = torch.zeros((10, 3), dtype=torch.int32)
    buf = torch.full((HDR + 4,), -1, dtype=torch.int32)
    used = torch.ones(9, dtype=torch.bool)
    kw = dict(ppw=2, n=1, sel_cap=8, dump_row=8, fire_gate=True, fire_pad=4)
    with pytest.raises(ValueError, match="clear mask"):
        fk.fused_step(counts, ring, buf, used, **kw)
    with pytest.raises(ValueError, match="fire_pad"):
        fk.fused_step(counts[:, :16].contiguous(), ring, buf, used,
                      **dict(kw, fire_pad=65))
    with pytest.raises(ValueError, match="form"):
        fk.fused_step(counts[:, :16].contiguous(), ring, buf, used,
                      **dict(kw, form=2))
