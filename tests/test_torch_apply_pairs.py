"""Parity of the native lane's two pair applies with the JAX functions
they replace (flink_tpu/ops/window.py), run as the JAX tests run them
(CPU XLA): F1 ``apply_pairs_u32`` against ``_JIT_PREAGG_U32`` and F3
``apply_pairs_u16`` against ``_JIT_PREAGG_U16``. On CPU tensors the
wrappers take their plain PyTorch versions; tests/test_torch_cuda.py
holds the CUDA kernels against the same plain versions on the card.
Every comparison is exact (integer counts)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import window as jw
from flink_tpu.state.keyed import PaneState as JaxPaneState
from flink_tpu_torch.kernels import fused_kernels as fk
from test_torch_fused_step import _state, _words
from test_torch_threads import capped_torch_threads  # noqa: F401


# -- F1 ------------------------------------------------------------------------

@pytest.mark.parametrize("ring", [16, 32, 64])
def test_apply_pairs_u32_matches_preagg_u32(ring):
    """Padding words (0xFFFFFFFF) and pairs in the dump row or beyond the
    state go to no cell, as in _JIT_PREAGG_U32."""
    rng = np.random.default_rng(ring)
    slots = 1000
    base = _state(rng, slots + 1, ring, 40, 40 + ring - 2)
    extra = [slots * ring, slots * ring + ring - 1, (slots + 3) * ring,
             (1 << 20) - 1]
    buf = _words(rng, slots, ring, 6000, 8192, pane_lo=40, pane_hi=40 + ring - 2,
                 extra=extra)
    ref = jw._JIT_PREAGG_U32(JaxPaneState(None, None, None, jnp.asarray(base)),
                             jnp.asarray(buf), ring=ring, dump_row=slots)
    got = fk.apply_pairs_u32(torch.from_numpy(base.copy()),
                             torch.from_numpy(buf), slots)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.counts))
    assert not np.array_equal(got.numpy(), base)


@pytest.fixture(scope="module")
def real_words_case():
    """One state and 1,025 real pair words (repeated pairs, pairs in the
    dump row and past the state among them) padded to 2,048 with -1, and
    the reference's counts after each prefix the cases below take, from
    _JIT_PREAGG_U32 on the padded buffer (one compiled shape)."""
    rng = np.random.default_rng(17)
    slots, ring, cap = 500, 32, 2048
    base = _state(rng, slots + 1, ring, 40, 40 + ring - 2)
    pairs = rng.integers(0, slots * ring, 1025)
    pairs[:40] = pairs[40:80]                     # each of these twice
    pairs[[3, 500, 1024]] = [slots * ring, slots * ring + ring - 1,
                             (slots + 2) * ring]  # the dump row and past
    cnts = rng.integers(1, 0xFFF, 1025)
    words = ((pairs << 12) | cnts).astype(np.uint32).view(np.int32)
    ref = {}
    for n in REAL_WORDS:
        buf = np.full(cap, -1, np.int32)
        buf[:n] = words[:n]
        ref[n] = np.asarray(jw._JIT_PREAGG_U32(
            JaxPaneState(None, None, None, jnp.asarray(base)),
            jnp.asarray(buf), ring=ring, dump_row=slots).counts)
    return base, words, slots, cap, ref


REAL_WORDS = (0, 1, 3, 4, 1025)


@pytest.mark.parametrize("n", REAL_WORDS)
def test_apply_pairs_u32_real_words_match_the_padded_reference(
        real_words_case, n):
    """The native lane passes the real words only: the first n words,
    as a view one word into its storage (off a 16-byte boundary, as the
    kernel's scalar head takes it), give the reference's counts on the
    same words padded to a power of two; so do the words with their
    padding passed too (the plain version skips 0xFFFFFFFF and pairs at
    the limit), and repeated pairs add up."""
    base, words, slots, cap, ref = real_words_case
    held = np.full(n + 1, 7, np.int32)
    held[1:] = words[:n]
    view = torch.from_numpy(held)[1:]
    assert view.storage_offset() == 1 and view.numel() == n
    got = fk.apply_pairs_u32(torch.from_numpy(base.copy()), view, slots)
    np.testing.assert_array_equal(got.numpy(), ref[n])
    padded = np.full(cap, -1, np.int32)
    padded[:n] = words[:n]
    got_padded = fk.apply_pairs_u32_plain(torch.from_numpy(base.copy()),
                                          torch.from_numpy(padded), slots)
    np.testing.assert_array_equal(got_padded.numpy(), ref[n])
    if n == 1025:
        assert not np.array_equal(ref[n], base)


# -- F3 ------------------------------------------------------------------------

def test_apply_pairs_u16_matches_preagg_u16():
    """Counts past 0xFFF, padding rows, and pairs in the dump row (which
    the u16 form writes) and beyond the state (dropped)."""
    rng = np.random.default_rng(5)
    slots, ring = 3000, 32
    rows = slots + 1
    base = _state(rng, rows, ring, 10, 30)
    pairs = np.unique(rng.integers(0, slots * ring, 5000))
    cnts = rng.integers(0, 0xFFFF + 1, len(pairs))
    cnts[:10] = 0xFFFF
    pairs = np.concatenate([pairs, [slots * ring + 3, rows * ring + 17,
                                    (1 << 31) - 5]])
    cnts = np.concatenate([cnts, [9, 9, 9]])
    cap = 8192
    buf = np.full((cap, 3), 0xFFFF, np.uint16)
    pu = pairs.astype(np.uint32)
    buf[:len(pairs), 0] = pu & 0xFFFF
    buf[:len(pairs), 1] = pu >> 16
    buf[:len(pairs), 2] = cnts
    buf[:len(pairs)] = buf[rng.permutation(len(pairs))]
    ref = jw._JIT_PREAGG_U16(JaxPaneState(None, None, None, jnp.asarray(base)),
                             jnp.asarray(buf), ring=ring, dump_row=slots)
    got = fk.apply_pairs_u16(torch.from_numpy(base.copy()), torch.from_numpy(buf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.counts))
    assert got.numpy()[slots].sum() > base[slots].sum()


@pytest.mark.parametrize("n", [0, 1, 7, 257, 5003])
def test_apply_pairs_u16_real_triples_match_the_padded_reference(n):
    """The native lane passes the real triples only: the first n triples,
    as a view one triple into its storage (off a 16-byte boundary, as the
    kernel's scalar head takes it), give the reference's counts on the
    same triples padded as it pads them (one compiled shape, that of
    test_apply_pairs_u16_matches_preagg_u16)."""
    from flink_tpu_torch.ops.window import preagg_encode_u16

    rng = np.random.default_rng(n + 1)
    slots, ring, cap = 3000, 32, 8192
    base = _state(rng, slots + 1, ring, 10, 30)
    pairs = rng.integers(0, (slots + 1) * ring + 50, max(n, 1))
    cnts = rng.integers(0, 0x10000, len(pairs))
    held = np.full((n + 1, 3), 0x7777, np.uint16)
    held[1:] = preagg_encode_u16(pairs[:n], cnts[:n], n)
    view = torch.from_numpy(held)[1:]
    assert view.storage_offset() == 3 and view.shape == (n, 3)
    ref = jw._JIT_PREAGG_U16(JaxPaneState(None, None, None, jnp.asarray(base)),
                             jnp.asarray(preagg_encode_u16(pairs[:n], cnts[:n],
                                                           cap)),
                             ring=ring, dump_row=slots)
    got = fk.apply_pairs_u16(torch.from_numpy(base.copy()), view)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.counts))
