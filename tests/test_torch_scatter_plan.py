"""The plan behind the ``scatter_lanes`` kernel (``lane_kernels.py``
``_scatter_plan``): digit passes, launch shapes and the workspace the
wrapper hands the kernel. The kernel runs only on the card
(``tests/test_torch_cuda.py``); its launch shapes and scratch sizes are
plain Python, checked here for every batch size and state the port can
give it."""
import os
import re

import pytest
import torch

from flink_tpu_torch.kernels import lane_kernels as lk

CSRC = os.path.join(os.path.dirname(lk.__file__), "csrc")
NS = [1, 2, 255, 2047, 2048, 2049, 3 * 2048 + 17, 1 << 18, (1 << 20) - 1,
      1 << 20, (1 << 20) + 1, 1 << 22, 1 << 24]
N_CELLS = [2, 3, 255, 256, 257, (1 << 16) - 1, 1 << 16, (1 << 16) + 1,
           65_537, 32_769 * 32, 1 << 21, (1 << 21) + 1]


def _constexpr(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_plan_constants_match_the_kernel_source():
    """The wrapper's copy of the kernel's constants, read from the
    sources."""
    with open(os.path.join(CSRC, "lane_kernels.cu")) as f:
        cu = f.read()
    with open(os.path.join(CSRC, "window_common.cuh")) as f:
        common = f.read()
    threads = _constexpr(common, "kThreads")
    items = _constexpr(cu, "kSortItems")
    digit_bits = _constexpr(cu, "kMaxDigitBits")
    passes = _constexpr(cu, "kMaxPasses")
    assert threads == lk._THREADS
    assert threads * items == lk._SORT_TILE
    assert digit_bits == lk._MAX_DIGIT_BITS and 1 << digit_bits == threads
    assert passes == lk._MAX_PASSES
    assert _constexpr(cu, "kFoldSpan") == lk._FOLD_SPAN
    # the ctrl block: each pass's histogram, each pass's tile counter and
    # the valid count, rounded up to 64 words
    assert lk._CTRL_INTS == -(-(passes * (1 << digit_bits) + passes + 1)
                              // 64) * 64


@pytest.mark.parametrize("n_cells", N_CELLS)
@pytest.mark.parametrize("n", NS)
def test_plan_covers_the_batch(n, n_cells):
    plan = lk._scatter_plan(n, n_cells)
    bits = n_cells.bit_length()
    # the passes cover every bit of a cell index, none of them idle, each
    # digit at most 8 bits, as few passes as 8-bit digits allow
    assert plan.key_bits == bits
    assert plan.passes * plan.digit_bits >= bits
    assert (plan.passes - 1) * plan.digit_bits < bits
    assert 1 <= plan.digit_bits <= lk._MAX_DIGIT_BITS
    assert plan.passes == -(-bits // lk._MAX_DIGIT_BITS) <= lk._MAX_PASSES
    # one sort block a tile, every record in a tile
    assert plan.tiles * lk._SORT_TILE >= n > (plan.tiles - 1) * lk._SORT_TILE
    # the fold's grid-stride loop reaches every span of _FOLD_SPAN places
    spans = -(-n // lk._FOLD_SPAN)
    assert 1 <= plan.fold_blocks <= lk._MAX_BLOCKS
    assert (plan.fold_blocks * lk._THREADS >= spans
            or plan.fold_blocks == lk._MAX_BLOCKS)
    # the zeroed region: the ctrl block, then each pass's look-back words,
    # one a (tile, digit)
    assert plan.zero_ints >= lk._CTRL_INTS + plan.passes * plan.tiles * (
        1 << plan.digit_bits)
    # keys0, vals0, keys1, vals1 (n each), in order, 256-byte aligned,
    # apart, after the zeroed region
    sizes = (n, n, n, n)
    assert plan.key_ints == n
    ends = [plan.zero_ints] + [o + s for o, s in zip(plan.offsets, sizes)]
    for off, end_before in zip(plan.offsets, ends):
        assert off % lk._ALIGN == 0 and off >= end_before
    assert plan.total_ints >= ends[-1]


def test_plan_digits_at_the_main_path_shapes():
    # bid aggregates: 32,769 x 32 cells, 21 bits in 3 passes of 7
    p = lk._scatter_plan(1 << 20, 32_769 * 32)
    assert (p.key_bits, p.passes, p.digit_bits, p.tiles) == (21, 3, 7, 256)
    # window-wordcount's count windows: 65,537 x 1 cells, 17 bits
    p = lk._scatter_plan(1 << 20, 65_537)
    assert (p.key_bits, p.passes, p.digit_bits) == (17, 3, 6)
    # on a digit boundary and one past it
    assert lk._scatter_plan(10, (1 << 16) - 1).passes == 2
    assert lk._scatter_plan(10, 1 << 16).passes == 3


@pytest.mark.parametrize("n", [0, 1 << 30])
def test_plan_refuses_batches_outside_its_counts(n):
    with pytest.raises(ValueError, match="records"):
        lk._scatter_plan(n, 100)


def test_workspace_grows_and_is_reused():
    dev, stream = torch.device("cpu"), -1
    try:
        a = lk._workspace(dev, stream, 1000)
        assert a.numel() == 1000 and a.dtype == torch.int32
        assert lk._workspace(dev, stream, 10) is a
        b = lk._workspace(dev, stream, 5000)
        assert b.numel() == 5000 and lk._workspace(dev, stream, 1000) is b
        assert lk._workspace(dev, stream + 1, 10) is not b
    finally:
        for key in [(dev, stream), (dev, stream + 1)]:
            lk._workspaces.pop(key, None)
