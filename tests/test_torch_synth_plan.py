"""The tile walk and the step-coefficient table of the K14 kernel
(csrc/legendre_synth.cu) on the CPU.

The kernel runs only on the card.  Its decomposition is checked here: a
block takes an m pair (m, nm - 1 - m) of ``sht.m_schedule``, a tile of 128
rings and a tile of 8 units, and walks the multipoles l >= m of its two m
in tiles of 32; each Lambda tile (rings x multipoles) is multiplied by the
block's alm columns (the units' re and im of a[:, l, m], then of a[:, l, -m]
in the complex form) in k-steps of 4 multipoles, and the negative block's
outputs take the sign (-1)^m.  The walk is emulated in float64 and held
against the plain version; the tiles must cover every (l, m) with l >= m
once, and every block walk about the same number of tiles.
Test-only code: no path runs the emulation.
"""

import math

import numpy as np
import pytest
import torch

from driftscan_tpu_torch.ops import healpix, sht

RT, TL, BT = 128, 32, 8  # rings, multipoles and units a block, as the kernel defines them


def _tiles(row, nl):
    """(m, l0, multipoles) of the tiles a block with schedule row (m1, m2)
    walks, in its order: those of m1, then those of m2."""
    return [(int(m), l0, min(TL, nl - l0)) for m in row if m >= 0 for l0 in range(m, nl, TL)]


@pytest.mark.parametrize("lmax,nm", [(10, 11), (20, 7), (20, 8), (31, 32), (32, 33), (229, 230),
                                     (494, 350)])
def test_synth_tiles_cover_each_multipole_once(lmax, nm):
    nl = lmax + 1
    sched = sht.m_schedule(nm)
    seen = np.zeros((nl, nm), dtype=int)
    walks = []
    for row in sched:
        tiles = _tiles(row, nl)
        walks.append(len(tiles))
        for m, l0, n in tiles:
            seen[l0:l0 + n, m] += 1
    lower = np.arange(nl)[:, None] >= np.arange(nm)[None, :]
    assert (seen[lower] == 1).all() and (seen[~lower] == 0).all()
    # a pair walks 2 nl - (nm - 1) multipoles: its tiles are that over TL,
    # or one more (the partial last tile of each m)
    full = -(-(2 * nl - (nm - 1)) // TL)
    assert max(walks) <= full + 1


def _emulate(pos, neg, cos_t, sin_t):
    """The kernel's blocks, tiles and k-steps in float64 numpy."""
    B, nl, nm = pos.shape
    nring = cos_t.shape[0]
    lam = sht.legendre_table(torch.arange(nm), cos_t, sin_t, nl - 1,
                             torch.as_tensor(sht._log_lambda_mm_prefactor(nl - 1))).numpy()
    pos, cos_t = pos.numpy(), cos_t.numpy()
    neg = None if neg is None else neg.numpy()
    tpos = np.full((B, nm, nring), np.nan, dtype=complex)
    tneg = np.full_like(tpos, np.nan)
    for row in sht.m_schedule(nm):
        for r0 in range(0, nring, RT):
            rings = np.arange(r0, min(r0 + RT, nring))
            for b0 in range(0, B, BT):
                units = np.arange(b0, min(b0 + BT, B))
                acc = None
                for m, l0, n in _tiles(row, nl):
                    if l0 == m:
                        acc = np.zeros((RT, (4 if neg is not None else 2) * BT))
                    a = np.zeros((TL, acc.shape[1]))  # the alm columns of the tile
                    ls = np.arange(l0, l0 + n)
                    a[:n, 0:2 * len(units):2] = pos[units][:, ls, m].T.real
                    a[:n, 1:2 * len(units):2] = pos[units][:, ls, m].T.imag
                    if neg is not None and m > 0:
                        a[:n, 2 * BT:2 * BT + 2 * len(units):2] = neg[units][:, ls, m - 1].T.real
                        a[:n, 2 * BT + 1:2 * BT + 2 * len(units):2] = neg[units][:, ls, m - 1].T.imag
                    lt = np.zeros((RT, TL))  # the Lambda tile, zeros past lmax and nring
                    lt[:len(rings), :n] = lam[ls][:, m, rings].T
                    for k0 in range(0, (n + 3) & ~3, 4):
                        acc += lt[:, k0:k0 + 4] @ a[k0:k0 + 4]
                    if l0 + n == nl:  # the m's last tile: store
                        c = acc[:len(rings)]
                        tpos[units[:, None], m, rings] = (c[:, 0:2 * len(units):2]
                                                    + 1j * c[:, 1:2 * len(units):2]).T
                        if neg is not None:
                            sgn = -1.0 if m % 2 else 1.0
                            d = c[:, 2 * BT:]
                            tneg[units[:, None], m, rings] = sgn * (d[:, 0:2 * len(units):2]
                                                              + 1j * d[:, 1:2 * len(units):2]).T
    return tpos, (None if neg is None else tneg)


@pytest.mark.parametrize("form", ["real", "complex"])
@pytest.mark.parametrize("B,nm", [(1, 41), (3, 30), (9, 41), (17, 25)])
def test_synth_tile_walk_is_the_transform(form, B, nm):
    """Two ring tiles (255 rings, the second ragged), odd and even nm up to
    lmax + 1, one to three unit blocks: the emulated walk equals the plain
    version (float64, 1e-12 of the largest value)."""
    lmax = 40
    g = healpix.ring_geometry(64)
    rng = np.random.default_rng(B + nm)
    z = rng.standard_normal((2, B, lmax + 1, nm)) + 1j * rng.standard_normal((2, B, lmax + 1, nm))
    pos = torch.as_tensor(z[0])
    neg = torch.as_tensor(z[1][..., 1:]) if form == "complex" else None
    ct = torch.as_tensor(g.cos_theta)
    st = torch.as_tensor(g.sin_theta)
    got = _emulate(pos, neg, ct, st)
    want = sht.legendre_synth_ref(pos, neg, ct, st)
    for x, w in zip(got, want):
        if w is None:
            assert x is None
            continue
        w = w.numpy()
        assert np.isfinite(x).all()
        assert np.abs(x - w).max() <= 1e-12 * np.abs(w).max()


@pytest.mark.parametrize("lmax,nm", [(10, 11), (47, 30), (229, 230)])
def test_step_coefficients_are_the_recurrences(lmax, nm):
    """The kernel's step-coefficient table holds, for every (m, l) up to
    lmax + SYNTH_L_TILE, the bits of legendre_rec.cuh's coef_a and coef_b
    (exact integer operands, one IEEE division and square root each)."""
    c = sht.step_coefficients(lmax, nm)
    assert c.shape == (nm, lmax + 1 + sht.SYNTH_L_TILE, 2) and c.dtype == np.float64
    assert sht.SYNTH_L_TILE >= TL
    for m in sorted({0, 1, nm // 2, nm - 1}):
        for l in range(c.shape[1]):
            a = math.sqrt(max(4.0 * l * l - 1.0, 0.0) / max(l * l - m * m, 1.0))
            b = math.sqrt(max((l - 1.0) * (l - 1.0) - m * m, 0.0)
                          / max(4.0 * (l - 1.0) * (l - 1.0) - 1.0, 1.0))
            assert c[m, l, 0] == a and c[m, l, 1] == b, (m, l)


def test_synth_tables_upload_once():
    """The step coefficients go to the device once per (lmax, nm, device)."""
    dev = torch.device("cpu")
    t = sht._synth_tables(40, 41, dev)
    assert sht._synth_tables(40, 41, dev) is t
    np.testing.assert_array_equal(t.numpy(), sht.step_coefficients(40, 41))


@pytest.mark.parametrize("form,k", [("real", 1), ("complex", 2)])
def test_k14_bound_is_its_slowest_unit(form, k):
    """chip_smoke.py's bound for K14 at the timestream's shape (B 8, lmax
    229, nside 256): the recurrence's 5 flops a lambda on the float64 CUDA
    cores run beside the product on the float64 tensor cores, so the bound
    is the slower unit's time (the product's), not the sum of the two."""
    import chip_smoke

    B, nl, nring = 8, 230, healpix.ring_geometry(256).nring
    nlam = nl * (nl + 1) // 2 * nring
    rec = chip_smoke.RECURRENCE_FLOPS * nlam / chip_smoke.F64_CUDA_CORE_FLOPS * 1e3
    prod = 4.0 * k * B * nlam / chip_smoke.F64_FLOPS * 1e3
    moved = 16 * B * nl * (k * nl + k * nring)  # the coefficients read, the outputs written
    ms, by = chip_smoke.bound(moved, [(chip_smoke.RECURRENCE_FLOPS * nlam,
                                       chip_smoke.F64_CUDA_CORE_FLOPS),
                                      (4.0 * k * B * nlam, chip_smoke.F64_FLOPS)])
    assert rec < prod
    assert (ms, by) == (prod, "operations")
    assert chip_smoke.bound(moved, []) == (moved / chip_smoke.HBM_BYTES_PER_S * 1e3, "bytes")
