"""The tile plan of K17, the top-band engine's Chebyshev filter step
(``driftscan_tpu_torch.ops.cheb.plan``): host arithmetic only, no kernel.

Each output tile of (M, n, k) is covered by exactly one block, the depth
split of a block's warps partitions [0, K) in a fixed order, the plans at
the bench cylinder's slice, its escalated width and the ns2 telescope's
full size are pinned, and no plan asks for more shared memory, threads or
grid than an H100 allows.
"""

import numpy as np
import pytest

from driftscan_tpu_torch.ops import cheb

SMS = 132  # the H100's SMs
SLICE = (8, 352, 352, 44)  # the bench cylinder: n 352, starting basis 44
ESCALATED = (8, 352, 352, 88)  # its basis after one escalation
NS2 = (1, 3200, 3200, 400)  # the ns2 telescope at full size
RAGGED = [(1, 5, 3, 2), (2, 70, 33, 17), (3, 130, 200, 45), (1, 64, 16, 32),
          (2, 1000, 1001, 131), (1, 3203, 3205, 403), (2, 333, 517, 83), (5, 17, 1, 9),
          (1, 1, 1, 1), (300, 40, 40, 8)]
SHAPES = [SLICE, ESCALATED, NS2] + RAGGED


def _id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_tiles_cover_each_output_once(shape):
    M, n, K, k = shape
    p = cheb.plan(M, n, K, k, SMS)
    hits = np.zeros((M, n, k), dtype=np.int32)
    for z, rows, cols in p.tiles(n, k):
        # no block lies wholly past the edge
        assert len(rows) and len(cols)
        hits[z, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (hits == 1).all()
    assert sum(1 for _ in p.tiles(n, k)) == p.blocks


@pytest.mark.parametrize("K", [1, 7, 8, 33, 352, 3205])
@pytest.mark.parametrize("tile", cheb.TILES, ids=_id)
def test_depth_split_partitions_k(tile, K):
    """Every depth index in exactly one group, each group's slices in
    increasing order, DK deep (the last one clipped), the same every call."""
    p = cheb.ChebPlan(*tile, (1, 1, 1))
    parts = p.k_parts(K)
    assert len(parts) == p.wks
    seen = [d for group in parts for r in group for d in r]
    assert sorted(seen) == list(range(K))
    for g, group in enumerate(parts):
        assert [r.start for r in group] == sorted(r.start for r in group)
        for r in group:
            assert r.start % p.depth == g * cheb.DK
            assert len(r) == min(cheb.DK, K - r.start)
    assert parts == p.k_parts(K)


@pytest.mark.parametrize("shape,tile,grid", [
    # 88 blocks: 11 row tiles of 32 x 8 m, the 44 columns padded to 48
    (SLICE, (1, 6, 2, 1, 4), (1, 11, 8)),
    # 264 blocks of 32 x 32: 96 columns for 88
    (ESCALATED, (1, 4, 2, 1, 4), (3, 11, 8)),
    # 125 blocks of 128 x 80 for 132 SMs: one wave
    (NS2, (2, 5, 4, 2, 1), (5, 25, 1)),
], ids=["slice", "escalated", "ns2"])
def test_plans_pinned(shape, tile, grid):
    p = cheb.plan(*shape, SMS)
    assert tuple(p[:5]) == tile and p.grid == grid


def test_slice_pads_columns_to_eight():
    p = cheb.plan(*SLICE, SMS)
    assert p.bn * p.grid[0] == 48


@pytest.mark.parametrize("tile", cheb.TILES, ids=_id)
def test_tiles_within_the_card(tile):
    p = cheb.ChebPlan(*tile, (1, 1, 1))
    assert p.threads % 32 == 0 and p.threads <= cheb.THREADS_MAX
    assert p.smem <= cheb.SMEM_MAX
    assert p.bm % 16 == 0 and p.bn % 8 == 0 and p.depth % 8 == 0


@pytest.mark.parametrize("M", [1, 8, 300, 65535])
def test_plans_within_the_card(M):
    for n in (1, 17, 352, 3200, 20000):
        for K in (1, 352, 3200):
            for k in (1, 44, 400, 1000):
                p = cheb.plan(M, n, K, k, SMS)
                assert tuple(p[:5]) in cheb.TILES
                assert p.smem <= cheb.SMEM_MAX and p.threads <= cheb.THREADS_MAX
                assert p.grid[2] == M <= cheb.GRID_YZ_MAX
                assert p.grid[1] <= cheb.GRID_YZ_MAX
                assert p.grid[0] * p.bn >= k and p.grid[1] * p.bm >= n


def test_plan_refuses_a_batch_past_the_grid():
    with pytest.raises(ValueError):
        cheb.plan(cheb.GRID_YZ_MAX + 1, 8, 8, 8, SMS)
