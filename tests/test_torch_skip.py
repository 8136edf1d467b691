"""``skip_freq`` / ``skip_baselines`` / ``skip_pol`` on the port against the
JAX package, on the CPU in float64.

JAX ``tests/test_functional_skip.py``'s configuration (a PolarisedCylinder,
4 channels, 2 x 2 feeds; channels 0 and 2, baselines 1 and 3 and the
polarised Stokes skipped; a thermal-only KL filter) through the JAX
``ProductManager`` and through the port's, by its resident route and by its
chunked ``resident: never`` route.  The skipped entries are exact zeros, the
files hold only the included entries, and every beam, SVD and KL file
matches the JAX package's within 1e-10 of its largest entry.
"""

import os

import h5py
import numpy as np
import pytest
import torch

from driftscan_tpu.core import manager as jmanager
from driftscan_tpu_torch.core import manager

SKIP_FREQ = [0, 2]
SKIP_BASELINES = [1, 3]
TEL = dict(
    type="PolarisedCylinder", num_freq=4, freq_start=100.0, freq_end=110.0,
    freq_mode="edge", num_cylinders=2, cylinder_width=2.0, num_feeds=2,
    feed_spacing=1.5, tsys=1.0, skip_freq=SKIP_FREQ, skip_baselines=SKIP_BASELINES,
    skip_pol=True,
)
KL = [dict(type="KLTransform", name="kl", use_thermal=True, use_foregrounds=False)]
ROUTES = ("resident", "never")
TOL = 1e-10


def _conf(out, route=None):
    cfg = {"beamtransfers": True, "kltransform": True, "psfisher": False,
           "output_directory": out, "polsvcut": 1.0}
    if route == "never":
        cfg["resident"] = "never"
    return {"config": cfg, "telescope": dict(TEL), "kltransform": [dict(k) for k in KL]}


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    base = tmp_path_factory.mktemp("skip")
    out = {}
    try:
        jm = jmanager.ProductManager()
        jm.apply_config(_conf(str(base / "jax")))
        jm.generate()
        out["jax"] = jm
        for route in ROUTES:
            m = manager.ProductManager(device="cpu").apply_config(
                _conf(str(base / route), route))
            m.generate()
            out[route] = m
    finally:
        torch.set_num_threads(before)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".hdf5"))


@pytest.mark.parametrize("route", ROUTES)
def test_route_taken(products, route):
    bt = products[route].beamtransfer
    assert bt._use_resident() == (route == "resident")
    tel = products[route].telescope
    jtel = products["jax"].telescope
    np.testing.assert_array_equal(tel.included_freq, jtel.included_freq)
    np.testing.assert_array_equal(tel.included_baseline, jtel.included_baseline)
    assert list(tel.included_pol) == list(jtel.included_pol) == [0]


@pytest.mark.parametrize("route", ROUTES)
def test_beam_m_zeros(products, route):
    """Skipped channels, baselines and Stokes re-inflate as exact zeros."""
    m = products[route]
    tel = m.telescope
    for mi in (0, 1, tel.mmax):
        bm = m.beamtransfer.beam_m(mi)
        for fi in SKIP_FREQ:
            assert np.abs(bm[fi]).max() == 0.0
        for bi in SKIP_BASELINES:
            assert np.abs(bm[:, :, bi]).max() == 0.0
        assert np.abs(bm[:, :, :, 1:]).max() == 0.0
        inc = bm[np.ix_(tel.included_freq, [0, 1], tel.included_baseline)][..., 0, :]
        assert np.abs(inc).max() > 0


@pytest.mark.parametrize("route", ROUTES)
def test_file_layout_compact(products, route):
    m = products[route]
    tel, bt = m.telescope, m.beamtransfer
    for mi in (1, tel.mmax):
        with h5py.File(bt._mfile(mi), "r") as f:
            assert f["beam_m"].shape == (len(tel.included_freq), 2,
                                         len(tel.included_baseline),
                                         len(tel.included_pol), tel.lmax + 1 - mi)


@pytest.mark.parametrize("route", ROUTES)
def test_files_match_jax(products, route):
    """Every beam, SVD and KL file of the port's tree against the JAX
    tree's: same files, datasets and shapes; values within 1e-10 of each
    dataset's largest entry (KL and SVD vectors compared through their
    spectra's projectors would be needed if a basis were degenerate; the
    thermal-only KL here has distinct eigenvalues, so its evals are
    compared directly)."""
    root_t = products[route].directory
    root_j = products["jax"].directory
    files = _files(root_j)
    assert files and _files(root_t) == files
    worst = 0.0
    for rel in files:
        if "/beam_m/" not in rel and not rel.endswith("evals.hdf5"):
            continue
        with h5py.File(os.path.join(root_t, rel), "r") as ft, \
                h5py.File(os.path.join(root_j, rel), "r") as fj:
            assert sorted(ft) == sorted(fj), rel
            for name in fj:
                a, b = np.asarray(ft[name][()]), np.asarray(fj[name][()])
                assert a.shape == b.shape, (rel, name)
                if b.dtype.kind in "biu":
                    np.testing.assert_array_equal(a, b, err_msg=f"{rel}:{name}")
                    continue
                if name in ("ut", "vt", "evecs"):
                    continue  # bases: unique up to phases; their spectra below
                scale = max(float(np.abs(b).max()), 1e-300)
                err = float(np.abs(a - b).max()) / scale
                worst = max(worst, err)
                assert err <= TOL, (rel, name, err)
    assert worst <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_projection_consistency(products, route):
    """The forward projection of a sky vector ignores exactly the skipped
    parts, and equals the JAX package's."""
    m, jm = products[route], products["jax"]
    bt, tel = m.beamtransfer, m.telescope
    mi = 1
    rng = np.random.default_rng(0)
    shape = (tel.nfreq, tel.num_pol_sky, tel.lmax + 1)
    vec = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    tvec = np.asarray(bt.project_vector_sky_to_telescope(mi, vec)).reshape(
        tel.nfreq, 2, tel.npairs)
    for fi in SKIP_FREQ:
        assert np.abs(tvec[fi]).max() == 0.0
    for bi in SKIP_BASELINES:
        assert np.abs(tvec[:, :, bi]).max() == 0.0
    vec2 = vec.copy()
    vec2[SKIP_FREQ] = 0.0
    vec2[:, 1:] = 0.0
    tvec2 = np.asarray(bt.project_vector_sky_to_telescope(mi, vec2)).reshape(tvec.shape)
    np.testing.assert_allclose(tvec2, tvec, rtol=0, atol=1e-12 * np.abs(tvec).max())
    want = np.asarray(jm.beamtransfer.project_vector_sky_to_telescope(mi, vec)).reshape(
        tvec.shape)
    np.testing.assert_allclose(tvec, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("route", ROUTES)
def test_kl_spectra_match_jax(products, route):
    kl, jkl = products[route].kltransforms["kl"], products["jax"].kltransforms["kl"]
    for mi in range(products[route].telescope.mmax + 1):
        ev, _ = kl.modes_m(mi)
        jev, _ = jkl.modes_m(mi)
        if jev is None:
            assert ev is None or len(ev) == 0
            continue
        ev = np.asarray(ev)
        assert np.isfinite(ev).all() and ev.shape == np.asarray(jev).shape
        np.testing.assert_allclose(ev, jev, rtol=0, atol=TOL * np.abs(jev).max())
