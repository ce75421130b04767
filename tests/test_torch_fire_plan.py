"""The plans behind the one-launch fire kernels: ``fire_pack``'s tiles
(``lane_kernels.py`` ``_fire_plan``) and the top-n selections'
workspace (``window_kernels.py`` ``select_work_words``). The
kernels run only on the card (``tests/test_torch_cuda.py``); their tile
shapes and shared-memory and workspace sizes are plain Python, checked
here against the sources' constants for the shapes the port gives
them."""
import os
import re

import pytest

from flink_tpu_torch.kernels import lane_kernels as lk
from flink_tpu_torch.kernels import topn_lanes_kernels as tk
from flink_tpu_torch.kernels import window_kernels as wk

CSRC = os.path.join(os.path.dirname(lk.__file__), "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constexpr(text, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    return m.group(1).strip()


def test_plan_constants_match_the_kernel_sources():
    common, cu = _source("window_common.cuh"), _source("lane_kernels.cu")
    threads = int(_constexpr(common, "kThreads"))
    assert _constexpr(cu, "kFireCells") == "kThreads * kFireItems"
    assert threads * int(_constexpr(cu, "kFireItems")) == lk._FIRE_CELLS
    assert _constexpr(cu, "kFireSmem") == "44 * 1024"
    assert lk._FIRE_SMEM == 44 * 1024
    # the wrapper's argument block: one word a FireArgs field
    fields = re.search(r"struct FireArgs \{(.*?)\};", cu, re.S).group(1)
    assert len(re.findall(r"\w+(?=[,;])", fields)) == lk._FIRE_PACK._struct.size // 8
    sel = _source("topn_select.cuh")
    assert _constexpr(sel, "kSelCells") == "kThreads * kSelItems"
    assert threads * int(_constexpr(sel, "kSelItems")) == wk.SEL_CELLS
    tl = _source("topn_lanes_kernels.cu")
    fields = re.search(r"struct SelectArgs \{(.*?)\};", tl, re.S).group(1)
    assert len(re.findall(r"\w+(?=[,;])", fields)) == \
        tk._TOPN_SELECT_LANES._struct.size // 8
    assert ("return (3 + Wc + (Wc * (3 + 256) + 1) / 2 + kLbLine - 1) / kLbLine * kLbLine;"
            in sel)
    assert "return select_desc_word(Wc) + kLbLine * Tc;" in sel
    assert _constexpr(_source("lookback.cuh"), "kLbLine") == str(wk.LB_LINE)


RINGS = [1, 16, 32, 37, 64, 1100]
WINDOWS = [1, 4, 11, 64, 300]
WIDTHS = [0, 1, 3, 4, 210]


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("L", WIDTHS)
def test_fire_plan_fits_the_kernel(ring, W, L):
    """Every plan stays inside the kernel: at most 1024 cells a tile,
    tile_rows rows spanned by any run of tile_cells consecutive cells,
    the staged rows within the shared memory the kernel reserves, lanes
    staged only with the count rows."""
    for cols in (2, 3) if not L else (3,):
        p = lk._fire_plan(ring, W, L, cols)
        assert 1 <= p.tile_cells <= lk._FIRE_CELLS
        assert p.tile_rows == (p.tile_cells + W - 2) // W + 1
        # the rows a run of tile_cells cells spans, from every first window
        spans = max((off + p.tile_cells - 1) // W + 1 for off in range(W))
        assert spans <= p.tile_rows
        assert 4 * lk._fire_smem_words(
            p.tile_cells, p.tile_rows, ring, L, cols, bool(p.stage_counts),
            bool(p.stage_lanes)) <= lk._FIRE_SMEM
        assert p.stage_counts or not p.stage_lanes
        assert not (p.stage_lanes and not L)
        if p.stage_counts:
            assert p.tile_cells >= lk._FIRE_MIN_STAGED
        else:
            assert p.tile_cells == lk._FIRE_CELLS


def test_fire_plan_at_the_main_path_shapes():
    """WordCount's packed2 fire stages 1024 cells a tile; the bid
    aggregates' four-lane and one-lane fires stage their lane rows in
    smaller tiles; a 1100-column ring reads its rows where they lie."""
    assert lk._fire_plan(16, 4, 0, 2) == lk.FirePlan(1024, 257, 1, 0)
    assert lk._fire_plan(32, 4, 3, 3) == lk.FirePlan(256, 65, 1, 1)
    assert lk._fire_plan(32, 4, 1, 3) == lk.FirePlan(512, 129, 1, 1)
    assert lk._fire_plan(1100, 1, 4, 3) == lk.FirePlan(1024, 1024, 0, 0)
    assert lk._fire_plan(1100, 64, 4, 3).stage_lanes == 0


@pytest.mark.parametrize("W,rows", [(1, 1), (11, 32_769), (64, 4097),
                                    (16, 71_303_169)])
def test_select_workspace_covers_the_fire(W, rows):
    """The workspace: the head, the done and epoch words, the grid
    barrier's words, a tagged threshold a window, each window's prefix,
    need, non-candidate count and 256 bins, and a descriptor a selection
    tile, each on its own 128-byte line."""
    tiles = -(-rows * W // wk.SEL_CELLS)
    words = wk.select_work_words(W, tiles)
    assert 8 * words >= 24 + 8 * W + 4 * W * (3 + 256) + 128 * tiles
    assert lk._fire_work_words(tiles) == 1 + tiles
