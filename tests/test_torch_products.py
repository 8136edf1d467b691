"""The file pipeline of driftscan_tpu_torch (``run_config`` -> ProductManager
-> BeamTransfer files -> KLTransform / DoubleKL -> PSExact) against the JAX
package's, file by file, on the CPU in float64.

Two small cylinders (unpolarised, 2 x 3 feeds, 4 channels; polarised, 2 x 2
feeds, 3 channels) go
once through each package's manager (module-scoped fixtures); the tests
then read the two product directories.  Tolerances: ``beam.hdf5`` within
the bit truncation (``truncate_rel`` 1e-7 of the largest entry), singular
values rel 1e-6, KL spectra 1e-4 of each m's top eigenvalue (1e-2 for
DoubleKL, its stage-1 spectrum included), Fisher matrix, covariance and
errors 3e-2 of their largest entry (the parity tiers of the port); the
figures achieved are printed.  SVD bases are compared through what is
unique: singular values and the projector onto the modes above svcut.
"""

import logging
import os
import pickle

import h5py
import numpy as np
import pytest
import torch
import yaml

from driftscan_tpu.core import beamtransfer as jbeamtransfer
from driftscan_tpu.core import kltransform as jkltransform
from driftscan_tpu.core import manager as jmanager
from driftscan_tpu.core import psestimation as jpsestimation
from driftscan_tpu_torch.core import beamtransfer, doublekl, kltransform, manager, psestimation
from driftscan_tpu_torch.ops import projections, sht
from driftscan_tpu_torch.scripts import makeproducts
from driftscan_tpu_torch.telescope import cylinder
from driftscan_tpu_torch.util import store

KINDS = ["UnpolarisedCylinder", "PolarisedCylinder"]

# Per telescope: the KL / PS retention cut, DoubleKL's retention cut and its
# foreground cut.  The small polarised cylinder's KL spectrum tops at 4.8e-7
# and its DoubleKL spectrum at 5e-8, so it keeps their top decades.
CUTS = {"UnpolarisedCylinder": (0.1, 0.1, 1.0), "PolarisedCylinder": (2e-8, 2e-8, 0.05)}
GEOMETRY = {
    "UnpolarisedCylinder": {"num_freq": 4, "cylinder_width": 3.0, "num_feeds": 3},
    "PolarisedCylinder": {"num_freq": 3, "cylinder_width": 2.0, "num_feeds": 2},
}
BANDS = [{"spacing": "linear", "start": 0.0, "stop": 0.25, "num": 3}]


def _config(kind, outdir, **kl_extra):
    thr, dthr, fthr = CUTS[kind]
    return {
        "config": {"beamtransfers": True, "kltransform": True, "psfisher": True,
                   "output_directory": str(outdir)},
        "telescope": {
            "type": kind, "freq_start": 400.0, "freq_end": 410.0, "freq_mode": "edge",
            "num_cylinders": 2, "feed_spacing": 1.0, "tsys": 10.0, **GEOMETRY[kind],
        },
        "kltransform": [
            {"type": "KLTransform", "name": "kl", "threshold": thr, **kl_extra},
            {"type": "DoubleKL", "name": "dk", "threshold": dthr,
             "foreground_threshold": fthr},
        ],
        "psfisher": [
            {"type": "Full", "name": "ps", "klname": "kl", "threshold": thr, "k_bands": BANDS},
            {"type": "Full", "name": "psdk", "klname": "dk", "threshold": dthr, "k_bands": BANDS},
        ],
    }


def _write(conf, path):
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return str(path)


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
    """(kind, JAX manager, port manager) after one full run of each."""
    kind = request.param
    base = tmp_path_factory.mktemp(kind)
    mj = jmanager.ProductManager.from_config(_write(_config(kind, base / "jax"), base / "j.yaml"))
    mj.generate()
    mt = makeproducts.run_config(
        _write(_config(kind, base / "torch"), base / "t.yaml"), device="cpu"
    )
    return kind, mj, mt


def _read(path, name):
    with h5py.File(path, "r") as f:
        return f[name][:]


def _rel(a, b):
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale > 0 else float(np.abs(a).max())


def test_manager_graph(runs):
    kind, mj, mt = runs
    assert type(mt.telescope).__name__ == type(mj.telescope).__name__
    assert isinstance(mt.beamtransfer, beamtransfer.BeamTransfer)
    assert isinstance(mt.kltransforms["kl"], kltransform.KLTransform)
    assert isinstance(mt.kltransforms["dk"], doublekl.DoubleKL)
    assert isinstance(mt.psestimators["ps"], psestimation.PSExact)
    assert mt.telescope.device.type == "cpu" and mt.device.type == "cpu"
    assert (mt.telescope.lmax, mt.telescope.mmax) == (mj.telescope.lmax, mj.telescope.mmax)
    assert set(mt.timings) >= {"beams", "beams.svd", "kl.kl", "kl.dk", "ps.ps", "ps.psdk"}


def test_directory_layout(runs):
    """The same relative file set in both product directories."""
    _, mj, mt = runs

    def tree(root):
        return sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files
        )

    assert tree(mt.directory) == tree(mj.directory)
    assert os.path.exists(mt.directory + "/bt/beam_m/COMPLETED")


def test_beam_files(runs):
    kind, mj, mt = runs
    worst = 0.0
    for mi in range(mt.telescope.mmax + 1):
        fj, ft = mj.beamtransfer._mfile(mi), mt.beamtransfer._mfile(mi)
        a, b = _read(ft, "beam_m"), _read(fj, "beam_m")
        assert a.shape == b.shape and a.dtype == b.dtype == np.complex128
        worst = max(worst, _rel(a, b))
        with h5py.File(ft, "r") as f, h5py.File(fj, "r") as g:
            assert int(f.attrs["m"]) == int(g.attrs["m"]) == mi
            assert np.array_equal(f.attrs["frequencies"], g.attrs["frequencies"])
    print(f"{kind}: beam.hdf5 max rel diff {worst:.3e} (truncate_rel 1e-7)")
    assert worst <= 1e-7


def test_svd_files(runs):
    kind, mj, mt = runs
    bt = mt.beamtransfer
    sv_worst = proj_worst = 0.0
    for mi in range(mt.telescope.mmax + 1):
        fj, ft = mj.beamtransfer._svdfile(mi), bt._svdfile(mi)
        sa, sb = _read(ft, "singularvalues"), _read(fj, "singularvalues")
        top = max(sb.max(), 1e-300)
        kept = sb > bt.svcut * top
        assert np.array_equal(sa > bt.svcut * top, kept)
        sv_worst = max(sv_worst, float(np.abs(sa - sb)[kept].max() / top) if kept.any() else 0.0)
        ua, ub = _read(ft, "beam_ut"), _read(fj, "beam_ut")
        ba, bb = _read(ft, "beam_svd"), _read(fj, "beam_svd")
        assert ba.shape == bb.shape and _read(ft, "invbeam_svd").shape == _read(
            fj, "invbeam_svd").shape
        for fi in range(sa.shape[0]):
            k = kept[fi]
            if not k.any():
                continue
            # orthonormal rows in the noise-weighted basis: the projector
            # onto the retained modes, and the beams' Gram through them
            nw = bt._noise_weights(fi)
            qa, qb = ua[fi][k] / nw, ub[fi][k] / nw
            proj_worst = max(proj_worst, float(np.abs(qa.conj().T @ qa - qb.conj().T @ qb).max()))
            ga = ba[fi][k].reshape(k.sum(), -1)
            gb = bb[fi][k].reshape(k.sum(), -1)
            assert _rel(np.abs(ga @ ga.conj().T).diagonal(), np.abs(gb @ gb.conj().T).diagonal()) <= 1e-6
    print(f"{kind}: singular values {sv_worst:.3e} (tol 1e-6), projectors {proj_worst:.3e}")
    assert sv_worst <= 1e-6 and proj_worst <= 1e-6
    assert _rel(bt.svd_all(), mj.beamtransfer.svd_all()) <= 1e-6


def test_kl_files(runs):
    kind, mj, mt = runs
    for name, tol, thr, dsets in (("kl", 1e-4, CUTS[kind][0], ("evals",)),
                                  ("dk", 1e-2, CUTS[kind][1], ("evals", "f_evals"))):
        fj = mj.kltransforms[name].evdir + "/evals.hdf5"
        ft = mt.kltransforms[name].evdir + "/evals.hdf5"
        for ds in dsets:
            a, b = _read(ft, ds), _read(fj, ds)
            assert a.shape == b.shape
            top = np.maximum(b.max(axis=1, keepdims=True), 1e-300)
            err = float((np.abs(a - b) / top).max())
            print(f"{kind}: {name} {ds} max diff / top {err:.3e} (tol {tol:g}); "
                  f"modes above {thr:g}: {(a > thr).sum()} / {(b > thr).sum()}")
            assert err <= tol
        # the retained modes per m: counts, attributes, and the span
        nmodes = 0
        for mi in range(mt.telescope.mmax + 1):
            with h5py.File(mt.kltransforms[name]._evfile % mi, "r") as f, h5py.File(
                mj.kltransforms[name]._evfile % mi, "r"
            ) as g:
                assert int(f.attrs["m"]) == mi and bool(f.attrs["SUBSET"]) == bool(g.attrs["SUBSET"])
                assert int(f.attrs["num_modes"]) == int(g.attrs["num_modes"]) == f["evals"].shape[0]
                assert f["evecs"].shape == g["evecs"].shape
                assert set(f.keys()) == set(g.keys())
                nmodes += int(f.attrs["num_modes"])
        assert nmodes > 0, "the config retains no mode: the comparison would be empty"


def test_fisher_files(runs):
    kind, mj, mt = runs
    for name in ("ps", "psdk"):
        fj = mj.psestimators[name].psdir + "/fisher.hdf5"
        ft = mt.psestimators[name].psdir + "/fisher.hdf5"
        with h5py.File(ft, "r") as f, h5py.File(fj, "r") as g:
            assert set(f.keys()) == set(g.keys())
            assert f.attrs["bandtype"] == g.attrs["bandtype"]
            assert np.abs(g["fisher"][:]).max() > 0
            for ds in ("fisher", "covariance", "errors"):
                err = _rel(f[ds][:], g[ds][:])
                print(f"{kind}: {name} {ds} rel {err:.3e} (tol 3e-2)")
                assert err <= 3e-2
            for ds in ("k_start", "k_end", "k_center", "theta_bands", "band_power"):
                assert np.allclose(f[ds][:], g[ds][:], rtol=1e-12, atol=0)


def test_jax_directory_loads_in_the_port(runs):
    """A product directory written by the JAX package opens in the port's
    classes, and PSExact on it reproduces the JAX per-m Fisher."""
    kind, mj, mt = runs
    tel = type(mt.telescope).from_config(mt.config["telescope"], device="cpu")
    bt = beamtransfer.BeamTransfer(mj.beamtransfer.directory, telescope=tel)
    kl = kltransform.KLTransform.from_config(mt.config["kltransform"][0], bt, subdir="kl")
    ps = psestimation.PSExact.from_config(mt.config["psfisher"][0], kl, subdir="ps")
    mi = int(np.argmax((mj.kltransforms["kl"].evals_all() > CUTS[kind][0]).sum(axis=1)))
    assert np.array_equal(bt.beam_m(mi), mj.beamtransfer.beam_m(mi))
    assert np.array_equal(bt.beam_svd(mi), mj.beamtransfer.beam_svd(mi))
    assert np.array_equal(bt.beam_ut(mi), mj.beamtransfer.beam_ut(mi))
    assert bt.ndof(mi) == mj.beamtransfer.ndof(mi)
    assert np.array_equal(kl.evals_all(), mj.kltransforms["kl"].evals_all())
    ev, vec = kl.modes_m(mi)
    jev, jvec = mj.kltransforms["kl"].modes_m(mi)
    assert np.array_equal(ev, jev) and np.array_equal(vec, jvec)
    assert np.array_equal(ps.fisher_bias()[0], mj.psestimators["ps"].fisher_bias()[0])
    # the same per-m Fisher from the same files
    ps.genbands()
    jps = mj.psestimators["ps"]
    jps.genbands()
    assert _rel(ps.clarray, jps.clarray) <= 1e-12
    f_t, _ = ps.fisher_bias_m(mi)
    f_j, _ = jps.fisher_bias_m(mi)
    assert np.abs(f_j).max() > 0 and _rel(f_t, f_j) <= 1e-9
    # and through the carrier of numpy products
    g = ps._sky_modes_t(mi)
    t = projections.products_from_numpy("cpu", clarray=jps.clarray, evals=jev)
    proj = projections.band_covariance_projection(g, t["clarray"])
    f_c = projections.fisher_trace_block(proj, proj, 1.0 / (1.0 + t["evals"]))
    assert _rel(f_c.numpy(), f_j) <= 1e-9


def test_projection_api_on_the_same_files(runs):
    """BeamTransfer's and KLTransform's projections and PSExact's q
    estimator, both packages reading the JAX-written directory (one SVD
    basis, so vectors compare entry by entry)."""
    kind, mj, mt = runs
    tel = type(mt.telescope).from_config(mt.config["telescope"], device="cpu")
    bt = beamtransfer.BeamTransfer(mj.beamtransfer.directory, telescope=tel)
    kl = kltransform.KLTransform.from_config(mt.config["kltransform"][0], bt, subdir="kl")
    jbt, jkl = mj.beamtransfer, mj.kltransforms["kl"]
    mi = int(np.argmax((jkl.evals_all() > CUTS[kind][0]).sum(axis=1)))
    rng = np.random.default_rng(31)
    npol, nl = tel.num_pol_sky, tel.lmax + 1

    def crandn(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    sky = crandn(bt.nfreq, npol, nl)
    sky[:, :, :mi] = 0
    tvec = crandn(bt.nfreq, bt.ntel)
    svec = crandn(bt.ndof(mi))
    cl = mt.kltransforms["kl"].signal()
    for name, args in (
        ("project_vector_sky_to_telescope", (mi, sky)),
        ("project_vector_telescope_to_sky", (mi, tvec)),
        ("project_vector_backward_dirty", (mi, tvec)),
        ("project_vector_telescope_to_svd", (mi, tvec)),
        ("project_vector_svd_to_telescope", (mi, svec)),
        ("project_vector_sky_to_svd", (mi, sky)),
        ("project_vector_svd_to_sky", (mi, svec)),
        ("project_matrix_sky_to_telescope", (mi, cl)),
        ("project_matrix_sky_to_svd", (mi, cl)),
        ("project_matrix_diagonal_telescope_to_svd", (mi, np.abs(tvec))),
        ("invbeam_m", (mi,)),
    ):
        got, want = getattr(bt, name)(*args), getattr(jbt, name)(*args)
        assert got.shape == want.shape, name
        assert _rel(got, want) <= 1e-8, (name, _rel(got, want))
    assert _rel(bt.project_vector_svd_to_sky(mi, svec, conj=True),
                jbt.project_vector_svd_to_sky(mi, svec, conj=True)) <= 1e-10
    for name, args in (
        ("project_vector_sky_to_kl", (mi, sky)),
        ("project_vector_svd_to_kl", (mi, svec)),
        ("project_matrix_sky_to_kl", (mi, cl)),
    ):
        assert _rel(getattr(kl, name)(*args), getattr(jkl, name)(*args)) <= 1e-8, name
    if bt.ndof(mi) == bt.nfreq * bt.ntel:
        # defined (in both packages) only where the SVD cut drops no mode
        assert _rel(kl.skymodes_m(mi), jkl.skymodes_m(mi)) <= 1e-8
    klvec = kl.project_vector_svd_to_kl(mi, svec)
    assert _rel(kl.project_vector_kl_to_svd(mi, klvec), jkl.project_vector_kl_to_svd(mi, klvec)) <= 1e-8
    alm = np.zeros((bt.nfreq, npol, nl, tel.mmax + 1), dtype=np.complex128)
    alm[..., mi] = sky
    assert _rel(kl.project_sky(alm, mlist=[mi], harmonic=True),
                jkl.project_sky(alm, mlist=[mi], harmonic=True)) <= 1e-8
    # the q estimator and the decorrelation of a Fisher matrix
    ps = psestimation.PSExact.from_config(mt.config["psfisher"][0], kl, subdir="ps")
    jps = mj.psestimators["ps"]
    ps.genbands()
    jps.genbands()
    data = crandn(klvec.shape[0], 3)
    assert _rel(ps.q_estimator(mi, data), jps.q_estimator(mi, data)) <= 1e-8
    assert _rel(ps.q_estimator(mi, data, data[:, ::-1], noise=True),
                jps.q_estimator(mi, data, data[:, ::-1], noise=True)) <= 1e-8
    fisher = jps.fisher_bias()[0] + 1e-3 * np.eye(ps.nbands) * np.abs(jps.fisher_bias()[0]).max()
    for got, want in zip(psestimation.decorrelate_ps(np.ones(ps.nbands), fisher),
                         jpsestimation.decorrelate_ps(np.ones(ps.nbands), fisher)):
        assert _rel(got, want) <= 1e-12


def test_cli_with_the_directory_store(tmp_path, monkeypatch, caplog):
    """The command line, with the product files going to the ``.npy``
    directory store (as on a host without h5py): the run ends, the
    products are directories that open, and a second run skips."""
    from click.testing import CliRunner

    conf = _small(tmp_path / "out")
    cfg = _write(conf, tmp_path / "cfg.yaml")
    root_logger = logging.getLogger()
    handlers, level = list(root_logger.handlers), root_logger.level

    def run_cli():
        caplog.clear()
        with caplog.at_level(logging.INFO):
            res = CliRunner().invoke(makeproducts._cli(), ["run", cfg, "--device", "cpu"])
        assert res.exit_code == 0, repr(res.exception)
        return caplog.text

    try:
        with monkeypatch.context() as mp:
            mp.setattr(store, "h5py", None)
            mp.setattr(store, "BACKEND", "npy")
            assert "DONE GENERATING PRODUCTS" in run_cli()
            bt = str(tmp_path / "out" / "bt")
            assert os.path.isfile(os.path.join(bt, "beam_m", "00", "beam.hdf5", "beam_m.npy"))
            assert os.path.isfile(os.path.join(bt, "kl", "ps", "fisher.hdf5", "fisher.npy"))
            fisher = np.load(os.path.join(bt, "kl", "ps", "fisher.hdf5", "fisher.npy"))
            again = run_cli()
            assert "Complete file exists. Skipping" in again
            assert "fisher.hdf5 exists. Skipping" in again
    finally:
        # the command's logging set-up belongs to its own process
        root_logger.handlers[:] = handlers
        root_logger.setLevel(level)
    # the same run through HDF5
    m = manager.ProductManager(device="cpu").apply_config(_small(tmp_path / "h5"))
    m.generate()
    assert np.abs(fisher).max() > 0 and _rel(fisher, m.psestimators["ps"].fisher_bias()[0]) <= 1e-9


def test_port_directory_loads_in_the_jax_package(runs):
    kind, mj, mt = runs
    bt = jbeamtransfer.BeamTransfer(mt.beamtransfer.directory, telescope=mj.telescope)
    kl = jkltransform.KLTransform.from_config(mj.config["kltransform"][0], bt, subdir="kl")
    ps = jpsestimation.PSExact.from_config(mj.config["psfisher"][0], kl, subdir="ps")
    mi = 3
    assert np.array_equal(bt.beam_m(mi), mt.beamtransfer.beam_m(mi))
    assert np.array_equal(bt.beam_svd(mi), mt.beamtransfer.beam_svd(mi))
    assert np.array_equal(bt.beam_singularvalues(mi), mt.beamtransfer.beam_singularvalues(mi))
    assert np.array_equal(kl.evals_all(), mt.kltransforms["kl"].evals_all())
    assert np.array_equal(ps.fisher_bias()[0], mt.psestimators["ps"].fisher_bias()[0])


def test_pickled_telescope_reopens(runs, tmp_path):
    """The telescope pickle holds the configuration only and the name of
    its device; a BeamTransfer without a telescope reads it, and moves it
    to the CPU only when asked."""
    kind, _, mt = runs
    with open(mt.beamtransfer._picklefile, "rb") as f:
        tel = pickle.load(f)
    assert tel.device.type == "cpu" and type(tel) is type(mt.telescope)
    assert not any(isinstance(v, torch.Tensor) for v in tel.__getstate__().values())
    bt = beamtransfer.BeamTransfer(mt.beamtransfer.directory, device="cpu")
    assert bt.telescope.lmax == mt.telescope.lmax
    assert np.array_equal(bt.beam_m(2), mt.beamtransfer.beam_m(2))
    # a state pickled on the card opens on any host and keeps its device
    state = tel.__getstate__()
    state["device"] = "cuda:0"
    moved = type(tel).__new__(type(tel))
    moved.__setstate__(state)
    assert moved.device == torch.device("cuda:0")
    carddir = str(tmp_path / "card")
    os.makedirs(carddir)
    with open(os.path.join(carddir, "telescopeobject.pickle"), "wb") as f:
        pickle.dump(moved, f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            beamtransfer.BeamTransfer(carddir)
    onhost = beamtransfer.BeamTransfer(carddir, device="cpu")
    assert onhost.device.type == "cpu" and onhost.telescope.lmax == mt.telescope.lmax


def test_rerun_skips_every_stage(runs, caplog):
    kind, _, mt = runs
    files = [
        os.path.join(d, f) for d, _, fs in os.walk(mt.directory) for f in fs
        if f.endswith(".hdf5") and f != "svdspectrum.hdf5"
    ]
    stamp = {f: os.stat(f).st_mtime_ns for f in files}
    with caplog.at_level(logging.INFO):
        again = makeproducts.run_config(os.path.join(mt.directory, "config.yaml"), device="cpu")
    assert {f: os.stat(f).st_mtime_ns for f in files} == stamp
    text = caplog.text
    assert "m-files already generated" in text and "Complete file exists. Skipping" in text
    assert "fisher.hdf5 exists. Skipping" in text
    assert again.timings["beams.svd"] < mt.timings["beams.svd"] + 1.0


def test_dense_transform_matches_jax(runs):
    """The dense per-m path (projected covariances, whitened eigensolve)
    against the JAX package's on the same m.  The dense noise covariance
    has a condition number of ~4e11 here, so its whitened spectrum is
    defined to ~cond * eps = 1e-4 of the top eigenvalue: gate 1e-3."""
    kind, mj, mt = runs
    mi = int(np.argmax([mt.beamtransfer.ndof(m) for m in range(mt.telescope.mmax + 1)]))
    ev, vec, _, extra = mt.kltransforms["kl"]._transform_m(mi)
    jev, jvec, _, jextra = mj.kltransforms["kl"]._transform_m(mi)
    assert ev.shape == jev.shape and vec.shape == jvec.shape
    assert float(np.abs(ev - jev).max()) <= 1e-3 * jev.max()
    assert extra["ac"] == jextra["ac"] == 0.0
    s, n = mt.kltransforms["kl"].sn_covariance(mi)
    js, jn = mj.kltransforms["kl"].sn_covariance(mi)
    # the SVD basis is free within degenerate clusters: compare spectra
    for a, b in ((s, js), (n, jn)):
        assert _rel(np.linalg.eigvalsh(a), np.linalg.eigvalsh(b)) <= 1e-6


# ------------------------------------------------------------------
# one-off runs of the port alone
# ------------------------------------------------------------------


def _small(outdir, **sections):
    conf = _config("UnpolarisedCylinder", outdir)
    conf["telescope"].update(num_freq=2, num_feeds=2)
    conf["kltransform"] = conf["kltransform"][:1]
    conf["psfisher"] = conf["psfisher"][:1]
    # two channels, 2 x 2 feeds (top eigenvalue 4e-6): keep the modes above 1e-7
    conf["kltransform"][0]["threshold"] = conf["psfisher"][0]["threshold"] = 1e-7
    for key, val in sections.items():
        conf[key].update(val) if isinstance(conf[key], dict) else conf[key][0].update(val)
    return conf


def test_inverse_takes_the_dense_path(tmp_path):
    m = manager.ProductManager(device="cpu").apply_config(
        _small(tmp_path / "out", kltransform={"inverse": True})
    )
    m.generate()
    kl = m.kltransforms["kl"]
    seen = 0
    for mi in range(m.telescope.mmax + 1):
        with h5py.File(kl._evfile % mi, "r") as f:
            assert "evinv" in f and f["evinv"].shape == f["evecs"].shape
            if f["evecs"].shape[0]:
                # rows of evinv are the dual basis of the retained modes
                assert np.allclose(f["evecs"][:] @ f["evinv"][:].T, np.eye(f["evecs"].shape[0]),
                                   atol=1e-6)
                seen += 1
    assert seen > 0
    assert np.isfinite(m.psestimators["ps"].fisher_bias()[0]).all()


def test_apply_config_needs_no_yaml_file(tmp_path):
    """A parsed dictionary is enough (no config file is staged)."""
    conf = _small(tmp_path / "out")
    conf["config"].update(kltransform=False, psfisher=False)
    m = manager.ProductManager(device="cpu").apply_config(conf)
    m.generate()
    assert os.path.exists(m.beamtransfer._svdfile(0)) and not os.path.exists(
        m.kltransforms["kl"]._evfile % 0)
    assert not os.path.exists(os.path.join(m.directory, "config.yaml"))


def test_unknown_types_give_the_registry_error(tmp_path):
    conf = _small(tmp_path / "out")
    conf["telescope"]["type"] = "NoSuchTelescope"
    with pytest.raises(Exception, match="Unsupported telescope type.*PolarisedCylinder.*UnpolarisedCylinder"):
        manager.ProductManager(device="cpu").apply_config(conf)
    conf = _small(tmp_path / "out", psfisher={"type": "NoSuchEstimator"})
    with pytest.raises(Exception, match="Unsupported PS estimator type 'NoSuchEstimator'"
                       r".*Cross, Full, MonteCarlo, MonteCarloAlt\)"):
        manager.ProductManager(device="cpu").apply_config(conf)
    conf = _small(tmp_path / "out", kltransform={"type": "KLSomething"})
    with pytest.raises(Exception, match="Unsupported KL filter type.*DoubleKL, KLTransform"):
        manager.ProductManager(device="cpu").apply_config(conf)


def test_plugin_telescope_loads(tmp_path):
    plugin = tmp_path / "myscope.py"
    plugin.write_text(
        "from driftscan_tpu_torch.telescope import cylinder\n"
        "class MyCylinder(cylinder.UnpolarisedCylinderTelescope):\n"
        "    marker = 'plugin'\n"
    )
    conf = _small(tmp_path / "out")
    conf["telescope"]["type"] = {
        "module": "torch_products_plugin_scope", "class": "MyCylinder", "file": str(plugin)
    }
    conf["config"].update(kltransform=False, psfisher=False)
    m = manager.ProductManager(device="cpu").apply_config(conf)
    assert m.telescope.marker == "plugin" and isinstance(
        m.telescope, cylinder.UnpolarisedCylinderTelescope)
    m.generate()
    # the pickled plugin telescope reopens by its module name
    assert beamtransfer.BeamTransfer(m.beamtransfer.directory).telescope.marker == "plugin"


@pytest.mark.parametrize("sections,match", [
    ({"kltransform": {"engine": "topband"}}, r"topband.*ROADMAP\.md.*item 10"),
])
def test_unported_options_name_their_roadmap_line(tmp_path, sections, match):
    """``engine: topband`` was the last unported option of this config; it
    is ported now: it generates and writes the KL files (no top-band
    chunk falls back to the exact engine here), and an unknown engine
    still raises, naming the value."""
    m = manager.ProductManager(device="cpu").apply_config(_small(tmp_path / "out", **sections))
    m.generate()
    kl = m.kltransforms["kl"]
    assert kl.engine == "topband" and kl.topband_fallback_chunks == []
    kept = 0
    for mi in range(m.telescope.mmax + 1):
        with h5py.File(kl._evfile % mi, "r") as f:
            kept += int(f.attrs["num_modes"])
            assert f["evecs"].shape[0] == f.attrs["num_modes"]
    assert kept > 0
    bad = _small(tmp_path / "bad", kltransform={"engine": "nonesuch"})
    with pytest.raises(ValueError, match="nonesuch"):
        manager.ProductManager(device="cpu").apply_config(bad).generate()


@pytest.mark.parametrize("variant", ["nosvd", "fullsvd", "tempsvd"])
def test_svd_variants_generate_their_files(tmp_path, variant):
    """The SVD variants (once NotImplementedError, ROADMAP item 7.2) make
    their products: nosvd and fullsvd from their config keys, TempSVD as a
    class; NoSVD writes no SVD files, the others the four datasets."""
    conf = _small(tmp_path / "out", config={"nosvd": variant == "nosvd",
                                             "fullsvd": variant == "fullsvd"})
    conf["config"]["psfisher"] = False
    m = manager.ProductManager(device="cpu").apply_config(conf)
    if variant == "tempsvd":
        m.beamtransfer = beamtransfer.BeamTransferTempSVD(
            m.beamtransfer.directory, telescope=m.telescope
        )
        m.kltransforms["kl"].beamtransfer = m.beamtransfer
    want = {"nosvd": beamtransfer.BeamTransferNoSVD, "fullsvd": beamtransfer.BeamTransferFullSVD,
            "tempsvd": beamtransfer.BeamTransferTempSVD}[variant]
    assert type(m.beamtransfer) is want
    m.generate()
    bt = m.beamtransfer
    ntel = 2 * m.telescope.npairs
    for mi in range(m.telescope.mmax + 1):
        assert os.path.exists(bt._mfile(mi))
        if variant == "nosvd":
            assert not os.path.exists(bt._svdfile(mi)) and bt.ndof(mi) == ntel * bt.nfreq
        else:
            with h5py.File(bt._svdfile(mi), "r") as f:
                assert set(f) == {"beam_svd", "invbeam_svd", "beam_ut", "singularvalues"}
                assert f["beam_ut"].shape == (bt.nfreq, bt.svd_len, ntel)
    assert os.path.exists(m.kltransforms["kl"].evdir + "/evals.hdf5")


def test_unported_calls_name_their_roadmap_line(tmp_path):
    """The forward SHT's refinement (ROADMAP item 8.1) is ported: one step
    on a projected-sky-sized stack against the JAX package's, 1e-10 of
    max (the full parity is in tests/test_torch_sht_iters.py)."""
    from driftscan_tpu.ops import sht as jsht

    x = np.random.default_rng(8).standard_normal((2, 1, 12 * 4**2))
    got = sht.sphtrans_sky(x, iters=1, device="cpu").numpy()
    want = np.asarray(jsht.analysis(x, 11, iters=1)[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_default_device_is_the_card():
    """No device given: the card, and an error at once on a host without."""
    if torch.cuda.is_available():
        assert manager.ProductManager().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            manager.ProductManager()
        with pytest.raises(RuntimeError, match="CUDA"):
            makeproducts.run_config("does-not-matter.yaml")
