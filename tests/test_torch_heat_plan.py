"""The host side of the local heat model's two redesigned kernels
(``csrc/heat.cu``): the form, rows a warp, load width, tile and grid that
``ops.heat.dense_plan`` picks for heat_dense_substep, and the grid and
partial sums of heat_cg_begin (``ops.heat.cg_begin_grid``, ``workspace``).

Each kernel's assignment of rows and columns to blocks, warps and lanes is
written out here in numpy from the source's rule and its constants (read
from ``csrc/heat.cu``), and every row and column must come out covered once,
the launch's constraints met and the partial sums sized for the grid.  No
card is needed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from devicekmc_tpu_torch.ops import _build
from devicekmc_tpu_torch.ops import heat as heat_ops

SOURCE = (Path(_build.CSRC) / "heat.cu").read_text()


def _const(name):
    m = re.findall(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert len(m) == 1, name
    return m[0]


THREADS = int(_const("kThreads"))
WARPS = THREADS // 32
MAX_CLUSTER = int(_const("kMaxCluster"))
SMALL_STEPS = int(_const("kSmallSteps"))
GRID_LOADS = int(_const("kGridLoads"))
MAX_TILE_BYTES = eval(_const("kMaxTileBytes"))
MAX_SMALL_NI = int(_const("kMaxSmallNi"))
BEGIN_LANES = int(_const("kBeginLanes"))
BEGIN_PASSES = int(_const("kBeginPasses"))

#: ni of the dense plans: tiny, odd, each side of the switch between the
#: forms, the small stack's 192, the probe's sizes and past one tile of f64
DENSE_NI = (1, 2, 31, 64, 192, 193, 256, 257, 511, 512, 513, 1000, 2048, 4097, 8192, 12289,
            30001)


def _dense_rows(plan, ni):
    """How many times heat_dense_substep writes each row: in the form of a
    row a block, block b its row b, then the rows grid, grid + 1, ... drawn
    from the counter one each; else block b takes the sets b, b + grid, ...
    of WARPS * rows rows, warp w of a set its rows w * rows + q."""
    hits = np.zeros(ni, dtype=np.int64)
    if plan.form == "rows":
        np.add.at(hits, np.arange(min(plan.grid, ni)), 1)
        np.add.at(hits, np.arange(min(plan.grid, ni), ni), 1)
        return hits
    sets = -(-ni // (WARPS * plan.rows))
    for b in range(plan.grid):
        for s in range(b, sets, plan.grid):
            r = s * WARPS * plan.rows + np.arange(WARPS * plan.rows)
            np.add.at(hits, r[r < ni], 1)
    return hits


def _dense_cols(plan, ni):
    """How many times a row's columns are read: in the form of a row a
    block, warp w the slice [w span, (w + 1) span) (span ni / WARPS rounded
    up to vec), lane l from l * vec in steps of 32 vec, GRID_LOADS steps a
    pass; else a warp's lanes the same way over tiles of ``tile`` columns, U
    steps a pass; vec entries a load where its first column is inside the
    slice or tile."""
    hits = np.zeros(ni, dtype=np.int64)
    if plan.form == "rows":
        span = -(-ni // (WARPS * plan.vec)) * plan.vec
        for w in range(WARPS):
            lo, hi = min(ni, w * span), min(ni, w * span + span)
            for lane in range(32):
                c = lo + lane * plan.vec + 32 * plan.vec * np.arange(-(-span // 32) + 1)
                c = c[c < hi]
                np.add.at(hits, (c[:, None] + np.arange(plan.vec)).ravel(), 1)
        return hits
    U = SMALL_STEPS if plan.form == "cluster" else GRID_LOADS // plan.rows
    tile = ni if plan.form == "cluster" else plan.tile
    for c_lo in range(0, ni, tile):
        length = min(tile, ni - c_lo)
        for lane in range(32):
            for c0 in range(lane * plan.vec, length, 32 * plan.vec * U):
                c = c0 + 32 * plan.vec * np.arange(U)
                c = c[c < length]
                cols = (c_lo + c[:, None] + np.arange(plan.vec)).ravel()
                assert cols.max(initial=-1) < ni
                np.add.at(hits, cols, 1)
    return hits


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("ni", DENSE_NI)
def test_dense_plan_covers_once(ni, itemsize, aligned):
    """Every row written once and every column read once a row, for the
    H100's 132 SMs and a card of 16; the launch's limits (a cluster of at
    most 16 blocks, each with a set of rows, ni within the cluster form's;
    the grid no more blocks than rows or sets; the tile within the shared
    memory allowed, a multiple of the load width, which divides ni); the
    grid form's sets over tiles too."""
    for sms in (_build.H100_SMS, 16):
        plan = heat_ops.dense_plan(ni, itemsize, aligned, sms)
        sets = -(-ni // (WARPS * plan.rows))
        assert plan.rows in (1, 2, 4)
        assert 1 <= plan.grid <= (ni if plan.form == "rows" else sets)
        assert (plan.form == "cluster") == (ni <= heat_ops.DENSE_SMALL_MAX_NI)
        if plan.form == "rows":
            assert plan.tile == ni >= heat_ops.DENSE_ROWS_MIN_NI and plan.rows == 1
        if plan.vec > 1:
            assert aligned and plan.vec == 16 // itemsize and ni % plan.vec == 0
        if plan.form == "cluster":
            assert plan.grid <= MAX_CLUSTER and plan.tile == ni <= MAX_SMALL_NI
        else:
            assert plan.grid <= heat_ops.DENSE_BLOCKS_PER_SM * sms
            assert plan.tile % plan.vec == 0 and 0 < plan.tile <= ni
            assert plan.tile * itemsize <= min(heat_ops.DENSE_TILE_BYTES, MAX_TILE_BYTES)
        assert (_dense_rows(plan, ni) == 1).all()
        assert (_dense_cols(plan, ni) == 1).all()
        # the sets of rows over tiles, as the grid form takes a right-hand
        # side larger than one tile
        if plan.form != "cluster" and ni > 1:
            tiled = heat_ops.DensePlan("sets", 2, plan.vec,
                                       max(plan.vec, ni // 3 // plan.vec * plan.vec), plan.grid)
            assert (_dense_rows(tiled, ni) == 1).all()
            assert (_dense_cols(tiled, ni) == 1).all()


def test_dense_plan_forms():
    """The small stack's 192 sites take one pass of one cluster of 12 blocks,
    2 rows a warp, 16-byte loads; 2,048 sites of f64 sets of a row a warp on
    256 blocks; 8,192 a row a block on two blocks an SM, the right-hand side
    in one tile; 30,001 sets of 4 rows a warp over tiles of 12,288 columns,
    1-entry loads."""
    assert heat_ops.dense_plan(192, 8) == heat_ops.DensePlan("cluster", 2, 2, 192, 12)
    assert heat_ops.dense_plan(2048, 8) == heat_ops.DensePlan("sets", 1, 2, 2048, 256)
    assert heat_ops.dense_plan(8192, 8) == heat_ops.DensePlan("rows", 1, 2, 8192, 264)
    assert heat_ops.dense_plan(8192, 4, False) == heat_ops.DensePlan("rows", 1, 1, 8192, 264)
    assert heat_ops.dense_plan(30001, 8) == heat_ops.DensePlan("sets", 4, 1, 12288, 264)


def _begin_rows(n):
    """How many times heat_cg_begin writes each row: every chunk of
    PASSES x WARPS x (32 / LANES) rows is taken once (block b the chunks b,
    b + grid, ...), its pass q's row group of warp w the rows ((chunk PASSES
    + q) WARPS + w) 32 / LANES + sub."""
    per_warp = 32 // BEGIN_LANES
    chunk = BEGIN_PASSES * WARPS * per_warp
    hits = np.zeros(n, dtype=np.int64)
    sub = np.arange(per_warp)
    for c in range(-(-n // chunk)):
        for q in range(BEGIN_PASSES):
            for w in range(WARPS):
                r = ((c * BEGIN_PASSES + q) * WARPS + w) * per_warp + sub
                np.add.at(hits, r[r < n], 1)
    return hits


@pytest.mark.parametrize("n", [1, 63, 64, 65, 256, 1000, 4097, 108944])
def test_cg_begin_grid_covers_once(n):
    """cg_begin_grid gives a chunk of BEGIN_CHUNK rows a block at most (the
    source's passes x warps x rows a warp); every row written once."""
    assert heat_ops.BEGIN_CHUNK == BEGIN_PASSES * WARPS * (32 // BEGIN_LANES)
    assert heat_ops.cg_begin_grid(n) == -(-n // heat_ops.BEGIN_CHUNK)
    assert (_begin_rows(n) == 1).all()


@pytest.mark.parametrize("n", [5, 64, 130])
def test_cg_workspace_partials_fit_grid(n):
    """The matrix-free workspace's partial sums hold the (b.b, r.r) pair of
    every block of cg_begin_grid."""
    nb = torch.full((n, 3), -1)
    nb[1:, 0] = torch.arange(n - 1)
    mask = torch.ones(n, dtype=torch.bool)
    ws = heat_ops.workspace("cg", torch.float64, "cpu", torch.arange(n), neigh_idx=nb,
                            mask=mask, diag_base=torch.full((n,), 3.0), nb_int=nb >= 0,
                            n_int_nb=(nb >= 0).sum(1), step_scale=0.1)
    assert ws.part.numel() == 2 * heat_ops.cg_begin_grid(n)
