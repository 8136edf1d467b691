"""The chunked streaming BTM generate of driftscan_tpu_torch (``resident:
never``, tables over the resident budget) against the JAX package's, and
against the port's own resident route, on the CPU in float64.

The small cylinders of ``tests/test_torch_products.py`` (unpolarised, 2 x
3 feeds, 4 channels; polarised, 2 x 2 feeds, 3 channels) go once through
each route (module-scoped fixtures); the unpolarised one runs the whole
chain (BTM -> SVD -> KL -> PSExact) in both packages.  Tolerances:
``beam.hdf5`` 1e-10 of its largest entry against the JAX package's
chunked files (the parity test of the resident route holds 1e-7, the bit
truncation); the port's two routes, and one chunk against many, bit for
bit (every route makes its SHT calls in ``TransitTelescope.btm_blocks``,
and the plain maps are the same for a unit in any batch); the rest of
the chain at the parity tiers of ROADMAP.md.
"""

import os

import h5py
import numpy as np
import pytest
import torch

from driftscan_tpu.core import beamtransfer as jbeamtransfer
from driftscan_tpu.core import manager as jmanager
from driftscan_tpu_torch.core import manager
from driftscan_tpu_torch.util import store

KINDS = ["UnpolarisedCylinder", "PolarisedCylinder"]
GEOMETRY = {
    "UnpolarisedCylinder": {"num_freq": 4, "cylinder_width": 3.0, "num_feeds": 3},
    "PolarisedCylinder": {"num_freq": 3, "cylinder_width": 2.0, "num_feeds": 2},
}
BANDS = [{"spacing": "linear", "start": 0.0, "stop": 0.25, "num": 3}]
THRESHOLD = 0.1  # the unpolarised cylinder's KL / PS retention cut


def _config(kind, outdir, chain=False, telescope=None, **cfg):
    conf = {
        "config": {"beamtransfers": True, "skip_svd": not chain, "kltransform": chain,
                   "psfisher": chain, "output_directory": str(outdir), **cfg},
        "telescope": {
            "type": kind, "freq_start": 400.0, "freq_end": 410.0, "freq_mode": "edge",
            "num_cylinders": 2, "feed_spacing": 1.0, "tsys": 10.0, **GEOMETRY[kind],
            **(telescope or {}),
        },
    }
    if chain:
        conf["kltransform"] = [{"type": "KLTransform", "name": "kl", "threshold": THRESHOLD}]
        conf["psfisher"] = [{"type": "Full", "name": "ps", "klname": "kl",
                             "threshold": THRESHOLD, "k_bands": BANDS}]
    return conf


def _port(conf):
    m = manager.ProductManager(device="cpu").apply_config(conf)
    m.generate()
    return m


def _jax(conf):
    m = jmanager.ProductManager()
    m.apply_config(conf)
    m.generate()
    return m


def _units_chunk(m, units):
    """mem_chunk (GiB) that holds ``units`` (frequency, baseline) rows."""
    tel = m.telescope
    nl, nm = tel.lmax + 1, tel.mmax + 1
    return (units + 0.5) * tel.num_pol_sky * nl * 2 * nm * 16.0 / 2**30


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs: the configs are small, and
    the test workers of one host share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=KINDS)
def runs(request, tmp_path_factory):
    """{route: manager} of one telescope: the JAX package's chunked route
    ("jax"), the port's chunked route in one chunk ("one") and in chunks of
    three units ("many"), and the port's resident route ("resident").  The
    unpolarised telescope runs the whole chain in "jax" and "one"."""
    kind = request.param
    base = tmp_path_factory.mktemp(kind)
    chain = kind == "UnpolarisedCylinder"
    out = {
        "jax": _jax(_config(kind, base / "jax", chain, resident="never")),
        "one": _port(_config(kind, base / "one", chain, resident="never")),
        "resident": _port(_config(kind, base / "resident", resident="always")),
    }
    out["many"] = _port(_config(kind, base / "many", resident="never",
                                mem_chunk=_units_chunk(out["one"], 3)))
    return kind, out


def _beam(m, mi):
    with h5py.File(m.beamtransfer._mfile(mi), "r") as f:
        d = f["beam_m"]
        return d[:], d.chunks, d.compression, dict(f.attrs)


def test_routes_taken(runs):
    kind, r = runs
    nfb = len(r["one"].telescope.included_freq) * len(r["one"].telescope.included_baseline)
    assert r["one"].beamtransfer.num_chunks == 1
    assert r["many"].beamtransfer.num_chunks == -(-nfb // 3) > 2
    assert r["resident"].beamtransfer.num_chunks is None
    assert r["resident"].beamtransfer._mem_beam is not None
    for route in ("one", "many"):
        bt = r[route].beamtransfer
        assert bt._mem_beam is None and not bt._use_resident()
        assert os.path.exists(bt.directory + "/beam_m/COMPLETED")
    # the float64 cylinders take host beams (K2-host's plain version here)
    assert not r["one"].telescope._bank_beams_apply()


def test_chunked_files_match_jax(runs):
    """The same datasets, layout and attributes as the JAX package's
    chunked files, and values within 1e-10 of the largest entry."""
    kind, r = runs
    worst = 0.0
    for mi in range(r["one"].telescope.mmax + 1):
        a, ca, za, aa = _beam(r["one"], mi)
        b, cb, zb, ab = _beam(r["jax"], mi)
        assert a.shape == b.shape and a.dtype == b.dtype == np.complex128
        assert ca == cb and za == zb
        assert set(aa) == set(ab) == {"m", "frequencies"} and int(aa["m"]) == mi
        assert np.array_equal(aa["frequencies"], ab["frequencies"])
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    print(f"{kind}: chunked beam.hdf5, port vs JAX, max {worst:.3e} of max (tol 1e-10)")
    assert worst <= 1e-10


@pytest.mark.parametrize("route", ["resident", "many"])
def test_chunked_files_equal_the_ports_other_routes(runs, route):
    """One chunk, many chunks and the resident tables give the same files,
    bit for bit, with the same layout."""
    kind, r = runs
    for mi in range(r["one"].telescope.mmax + 1):
        a, ca, za, _ = _beam(r["one"], mi)
        b, cb, zb, _ = _beam(r[route], mi)
        assert ca == cb and za == zb
        assert np.array_equal(a, b), (route, mi)
    assert np.array_equal(r["one"].beamtransfer.beam_m(2), r[route].beamtransfer.beam_m(2))


@pytest.mark.parametrize("runs", ["UnpolarisedCylinder"], indirect=True)
def test_full_chain_matches_jax(runs):
    """``resident: never`` through SVD, KL and PSExact, file by file at the
    parity tiers: singular values 1e-6, KL spectra 1e-4 of each m's top,
    Fisher 3e-2; and the port's directory opens in the JAX package."""
    kind, r = runs
    mj, mt = r["jax"], r["one"]
    sv_t, sv_j = mt.beamtransfer.svd_all(), mj.beamtransfer.svd_all()
    top = sv_j.max(axis=-1, keepdims=True)
    kept = sv_j > mt.beamtransfer.svcut * top
    assert np.array_equal(sv_t > mt.beamtransfer.svcut * top, kept)
    sv_err = float((np.abs(sv_t - sv_j) / np.maximum(top, 1e-300))[kept].max())
    ev_t, ev_j = mt.kltransforms["kl"].evals_all(), mj.kltransforms["kl"].evals_all()
    ev_err = float((np.abs(ev_t - ev_j) / np.maximum(ev_j.max(axis=1, keepdims=True), 1e-300)).max())
    f_t = mt.psestimators["ps"].fisher_bias()[0]
    f_j = mj.psestimators["ps"].fisher_bias()[0]
    f_err = float(np.abs(f_t - f_j).max() / np.abs(f_j).max())
    print(f"{kind}: chunked chain vs JAX: singular values {sv_err:.3e} (1e-6), KL {ev_err:.3e} "
          f"(1e-4), Fisher {f_err:.3e} (3e-2); modes kept {(ev_t > THRESHOLD).sum()}")
    assert sv_err <= 1e-6 and ev_err <= 1e-4 and f_err <= 3e-2
    assert (ev_t > THRESHOLD).sum() > 0
    # the port's chunked directory in the JAX package
    jbt = jbeamtransfer.BeamTransfer(mt.beamtransfer.directory, telescope=mj.telescope)
    for mi in (0, 3, mj.telescope.mmax):
        assert np.array_equal(jbt.beam_m(mi), mt.beamtransfer.beam_m(mi))
        assert np.array_equal(jbt.beam_svd(mi), mt.beamtransfer.beam_svd(mi))


def test_auto_routes_by_budget(tmp_path):
    """``auto`` takes the resident tables within both budgets and the
    chunked route over either; the files are the same."""
    kind = "UnpolarisedCylinder"
    small = _port(_config(kind, tmp_path / "host", resident_host_gb=1e-4))
    hbm = _port(_config(kind, tmp_path / "hbm", resident_hbm_gb=1e-4))
    fits = _port(_config(kind, tmp_path / "fits"))
    assert small.beamtransfer.num_chunks == hbm.beamtransfer.num_chunks == 1
    assert fits.beamtransfer.num_chunks is None and fits.beamtransfer._mem_beam is not None
    for mi in range(fits.telescope.mmax + 1):
        a = _beam(fits, mi)[0]
        assert np.array_equal(_beam(small, mi)[0], a) and np.array_equal(_beam(hbm, mi)[0], a)


def test_bank_cylinder_chunked_equals_resident(tmp_path):
    """A single-precision cylinder (bank beams: K1+K2's plain version), in
    chunks of two units, against its resident route: the same bits."""
    kind = "UnpolarisedCylinder"
    sp = {"single_precision": True}
    res = _port(_config(kind, tmp_path / "res", telescope=sp, resident="always"))
    assert res.telescope._bank_beams_apply()
    many = _port(_config(kind, tmp_path / "many", telescope=sp, resident="never",
                         mem_chunk=_units_chunk(res, 2)))
    assert many.beamtransfer.num_chunks > 2
    for mi in range(res.telescope.mmax + 1):
        assert np.array_equal(_beam(many, mi)[0], _beam(res, mi)[0]), mi


def test_directory_store_chunked(tmp_path, monkeypatch):
    """The chunked route through the ``.npy`` directory store (a host
    without h5py, as the card's): m-files created empty, then written in
    place chunk by chunk; the same values as through HDF5."""
    kind = "PolarisedCylinder"
    ref = _port(_config(kind, tmp_path / "h5", resident="never"))
    conf = _config(kind, tmp_path / "npy", resident="never", mem_chunk=_units_chunk(ref, 4))
    with monkeypatch.context() as mp:
        mp.setattr(store, "h5py", None)
        mp.setattr(store, "BACKEND", "npy")
        m = _port(conf)
        assert m.beamtransfer.num_chunks > 2
        for mi in range(m.telescope.mmax + 1):
            path = m.beamtransfer._mfile(mi)
            assert os.path.isfile(os.path.join(path, "beam_m.npy"))
            with store.File(path, "r") as f:
                assert int(f.attrs["m"]) == mi
                assert np.array_equal(f["beam_m"][:], _beam(ref, mi)[0])
        with pytest.raises(ValueError, match="mode 'w'"):
            with store.File(m.beamtransfer._mfile(0), "r+") as f:
                f.create_dataset("x", data=np.zeros(1))


def test_mmax_above_lmax(tmp_path):
    """mmax > lmax: the JAX package's chunked route fails (an m-file of nl - m
    <= 0 columns), and the port names the limit before writing anything.
    mmax == lmax runs, and its routes agree."""
    kind = "UnpolarisedCylinder"
    lmax = manager.ProductManager(device="cpu").apply_config(
        _config(kind, tmp_path / "probe")).telescope.lmax
    with pytest.raises(ValueError, match=r"mmax .* > lmax"):
        _port(_config(kind, tmp_path / "over", telescope={"force_mmax": lmax + 2}))
    assert not os.path.exists(tmp_path / "over" / "bt" / "beam_m" / "00" / "beam.hdf5")
    with pytest.raises(ValueError):
        _jax(_config(kind, tmp_path / "jover", telescope={"force_mmax": lmax + 2},
                     resident="never"))
    edge = {"force_mmax": lmax}
    a = _port(_config(kind, tmp_path / "edge", telescope=edge, resident="never"))
    b = _port(_config(kind, tmp_path / "edge_res", telescope=edge))
    assert a.telescope.mmax == lmax and a.beamtransfer.num_chunks == 1
    assert b.beamtransfer.num_chunks is None
    for mi in (0, lmax):
        assert np.array_equal(_beam(a, mi)[0], _beam(b, mi)[0])
