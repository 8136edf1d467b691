"""m-windows of the port's resident path against the JAX package.

``sht.analysis(m_window=)`` (the phase stage and K3+K5's plain version at a
window's m), ``btm_resident(m_range=)`` and ``product_all_resident(m_range=)``
on small cylinders, float64 on the CPU:

* the windowed SHT and BTM tables against the JAX package's
  ``analysis_split(m_window=)`` and ``btm_resident(m_range=)`` within 1e-12
  of their largest entry;
* a window's columns equal to the same columns of the full range bit for
  bit (the uniform layout: column j holds m = m0 + j in both planes);
* the product step over two windows against the full-range run (mode
  counts equal, spectra rtol 2e-5 / atol 1e-8 of the top, the summed
  Fisher within 1e-10 of its max) and against the JAX package's windowed
  run (counts equal, spectra rtol 2e-4 / atol 1e-6 of the top, Fisher 1e-4
  of its max).
"""

import numpy as np
import pytest
import torch

import bench
from driftscan_tpu.ops import sht as jsht
from driftscan_tpu.ops import zarray as za
from driftscan_tpu.parallel import mstep as jms
from driftscan_tpu.parallel import resident as jres
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.ops import healpix, sht
from driftscan_tpu_torch.parallel import resident
from driftscan_tpu_torch.telescope import cylinder

# test_resident.py's window telescope (2 channels at 100-110 MHz, 2 x 3
# feeds; lmax 13, 11 m); its KL spectrum tops at 6.5e-13, and the Fisher
# keeps the modes above 1e-13, the top decade
CFG = dict(
    num_freq=2, freq_start=100.0, freq_end=110.0, freq_mode="edge",
    num_cylinders=2, cylinder_width=2.0, num_feeds=3, feed_spacing=1.5,
)
PS_THRESHOLD = 1e-13


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _units(tel):
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    return [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]


def _z(z):
    return np.asarray(z.re) + 1j * np.asarray(z.im)


@pytest.mark.parametrize("m_window", [(0, 9), (5, 23), (30, 48), (40, 41)])
def test_windowed_analysis_matches_jax(m_window):
    """nside 16, lmax 40; the last two windows run past lmax + 1 = 41."""
    nside, lmax = 16, 40
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(11)
    shape = (3, g.nring * g.maxlen)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * g.mask.ravel()
    pos, neg = sht.analysis(torch.as_tensor(x), lmax, nside, m_window=m_window)
    jp, jn = jsht.analysis_split(
        za.Z(np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)), lmax=lmax,
        neg_m=True, m_window=m_window, nside=nside, ring_padded=True,
    )
    jp, jn = _z(jp), _z(jn)
    width = m_window[1] - m_window[0]
    assert pos.shape == neg.shape == jp.shape == (3, lmax + 1, width)
    scale = np.abs(jp).max()
    print(f"analysis {m_window}: vs JAX {np.abs(pos.numpy() - jp).max() / scale:.2e}, "
          f"{np.abs(neg.numpy() - jn).max() / scale:.2e} of max")
    np.testing.assert_allclose(pos.numpy(), jp, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(neg.numpy(), jn, rtol=0, atol=1e-12 * scale)
    # the window's columns are the full range's, bit for bit
    fp, fn = sht.analysis(torch.as_tensor(x), lmax, nside)
    m0 = m_window[0]
    hi = min(m_window[1], lmax + 1)
    assert torch.equal(pos[..., : hi - m0], fp[..., m0:hi])
    lo = max(m0, 1)
    assert torch.equal(neg[..., lo - m0 : hi - m0], fn[..., lo - 1 : hi - 1])
    assert not pos[..., hi - m0 :].any() and not neg[..., hi - m0 :].any()
    if m0 == 0:
        assert not neg[..., 0].any()


def test_legendre_contract_ref_window_columns():
    """K3+K5's plain version at m_lo: each column is the full call's, bit
    for bit, and the columns past lmax are zeros."""
    nside, lmax = 8, 20
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(5)
    shape = (4, lmax + 1, g.nring)
    F = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    G = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    ct, st = torch.as_tensor(g.cos_theta), torch.as_tensor(g.sin_theta)
    area = 4.0 * np.pi / g.npix
    fp, fn = sht.legendre_contract(F, G, ct, st, lmax, area)
    for m0, m1 in ((0, 5), (7, 21), (13, 30)):
        w = min(m1, lmax + 1) - m0
        Fw = torch.zeros((4, m1 - m0, g.nring), dtype=F.dtype)
        Gw = torch.zeros_like(Fw)
        Fw[:, :w], Gw[:, :w] = F[:, m0 : m0 + w], G[:, m0 : m0 + w]
        p, n = sht.legendre_contract(Fw, Gw, ct, st, lmax, area, m_lo=m0)
        assert torch.equal(p[..., :w], fp[..., m0 : m0 + w])
        assert torch.equal(n[..., :w], fn[..., m0 : m0 + w])
        assert not p[..., w:].any() and not n[..., w:].any()
    # the kernel's schedule over a window: physical m, each once, balanced
    sched = sht.m_schedule(9, m_lo=13)
    assert sorted(sched[sched >= 0].tolist()) == list(range(13, 22))
    assert len({int(r.sum()) for r in sched if (r >= 0).all()}) == 1


@pytest.fixture(scope="module")
def tels():
    jt = jcyl.UnpolarisedCylinderTelescope.from_config(CFG)
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG, device="cpu")
    cl_s, cl_n, noisew, _ = bench._covariances(jt)
    ls, lf = jms.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
    blt = jms.band_factor_table(
        iter(bench._fisher_bands(jt)), out_dtype=np.float64, rank_rtol=1e-9
    )
    return jt, tt, (ls, lf, noisew.astype(np.float64), blt)


def test_windowed_tables_match_jax_and_the_full_tables(tels):
    jt, tt, _ = tels
    blg, fig = _units(tt)
    fp, fn = resident.btm_resident(tt, blg, fig)
    nm = tt.mmax + 1
    for m0, m1 in ((0, nm // 2), (nm // 2, nm), (nm - 3, nm + 4)):
        pw, nw = resident.btm_resident(tt, blg, fig, m_range=(m0, m1))
        assert pw.shape[-1] == nw.shape[-1] == m1 - m0
        jp, jn = jres.btm_resident(jt, blg, fig, m_range=(m0, m1))
        jp, jn = za.to_numpy(jp), za.to_numpy(jn)
        scale = np.abs(jp).max()
        print(f"tables m {m0}..{m1 - 1}: vs JAX {np.abs(pw.numpy() - jp).max() / scale:.2e}, "
              f"{np.abs(nw.numpy() - jn).max() / scale:.2e} of max")
        np.testing.assert_allclose(pw.numpy(), jp, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(nw.numpy(), jn, rtol=0, atol=1e-12 * scale)
        # test_window_referee.py's table equivalence, every column
        hi = min(m1, tt.lmax + 1)
        assert torch.equal(pw[..., : hi - m0], fp[..., m0:hi])
        lo = max(m0, 1)
        assert torch.equal(nw[..., lo - m0 : hi - m0], fn[..., lo - 1 : hi - 1])
        if m0 == 0:
            assert not nw[..., 0].any()


def test_window_product_matches_full_and_jax(tels):
    """test_resident.py's m-window streaming case, with the fused Fisher."""
    jt, tt, (ls, lf, noisew, blt) = tels
    blg, fig = _units(tt)
    kw = dict(band_lt=blt, ps_threshold=PS_THRESHOLD, bucket=False, sig_levels=2)
    pos, neg = resident.btm_resident(tt, blg, fig)
    ev_full, nm_full, f_full = resident.product_all_resident(tt, pos, neg, ls, lf, noisew, **kw)
    assert (ev_full > PS_THRESHOLD).any() and np.abs(f_full).max() > 0

    nm = tt.mmax + 1
    cut = nm // 2
    evs, nms, fish = [], [], 0.0
    jevs, jnms, jfish = [], [], 0.0
    for m0, m1 in ((0, cut), (cut, nm)):
        pw, nw = resident.btm_resident(tt, blg, fig, m_range=(m0, m1))
        ev, nmo, f = resident.product_all_resident(
            tt, pw, nw, ls, lf, noisew, m_range=(m0, m1), **kw
        )
        assert ev.shape[0] == nmo.shape[0] == m1 - m0
        evs.append(ev)
        nms.append(nmo)
        fish = fish + f
        jp, jn = jres.btm_resident(jt, blg, fig, m_range=(m0, m1))
        jev, jnmo, jf = jres.product_all_resident(
            jt, jp, jn, ls, lf, noisew, m_range=(m0, m1), **kw
        )
        jevs.append(jev)
        jnms.append(jnmo)
        jfish = jfish + jf
    ev_win, nm_win = np.concatenate(evs), np.concatenate(nms)
    jev_win = np.concatenate(jevs)
    print(f"window product: spectra vs full {np.abs(ev_win - ev_full).max() / ev_full.max():.2e}, "
          f"vs JAX {np.abs(ev_win - jev_win).max() / ev_full.max():.2e} of the top; Fisher vs "
          f"full {np.abs(fish - f_full).max() / np.abs(f_full).max():.2e}, vs JAX "
          f"{np.abs(fish - jfish).max() / np.abs(jfish).max():.2e} of max")
    np.testing.assert_array_equal(nm_win, nm_full)
    scale = ev_full.max()
    np.testing.assert_allclose(ev_win, ev_full, rtol=2e-5, atol=1e-8 * scale)
    np.testing.assert_allclose(fish, f_full, rtol=0, atol=1e-10 * np.abs(f_full).max())

    np.testing.assert_array_equal(nm_win, np.concatenate(jnms))
    np.testing.assert_allclose(ev_win, np.concatenate(jevs), rtol=2e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(fish, jfish, rtol=0, atol=1e-4 * np.abs(jfish).max())

    # max_m counts from the window's first m
    pw, nw = resident.btm_resident(tt, blg, fig, m_range=(cut, nm))
    ev3, nm3 = resident.product_all_resident(
        tt, pw, nw, ls, lf, noisew, m_range=(cut, nm), max_m=3, bucket=False, sig_levels=2
    )
    assert ev3.shape[0] == 3
    np.testing.assert_array_equal(nm3, nm_full[cut : cut + 3])
    with pytest.raises(ValueError, match="width"):
        resident.product_all_resident(tt, pos, neg, ls, lf, noisew, m_range=(0, 4))
