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
