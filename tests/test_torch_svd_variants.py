"""The SVD variants of driftscan_tpu_torch (``nosvd``, ``fullsvd`` and
BeamTransferTempSVD) against the JAX package's, file by file, on the CPU in
float64; then a timestream through a NoSVD product directory.

nosvd and fullsvd go through each package's ``drift-makeproducts run``,
TempSVD (which has no config key) through each manager with its beam
transfer swapped; the tests then read the product directories.
Tolerances, the port's tiers: ``beam.hdf5`` within the bit truncation
(1e-7 of its largest entry), singular values 1e-6 of the top one and the
projectors onto the modes above svcut 1e-6 (the plain SVD's bases are
unique only up to a unitary within degenerate clusters), KL spectra 1e-4
of each m's top eigenvalue, Fisher 3e-2 of its largest entry.

The timestream: the JAX package writes one NoSVD product directory (the
disharray example's KL filter: inverse, no subset), and both packages'
``drift-runpipeline run-config`` run on it, each into its own directory
(a noiseless timestream from a seeded sky; m-modes, SVD modes, which are
the flattened m-modes, KL modes, full / SVD / KL maps): every dataset at
rel 1e-10 of its largest entry.
"""

import logging
import os

import h5py
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from driftscan_tpu.core import beamtransfer as jbeamtransfer
from driftscan_tpu.core import manager as jmanager
from driftscan_tpu.ops import sht as jsht
from driftscan_tpu.scripts import makeproducts as jmakeproducts
from driftscan_tpu.scripts import runpipeline as jrunpipeline
from driftscan_tpu_torch.core import beamtransfer, manager
from driftscan_tpu_torch.scripts import makeproducts, runpipeline

RTOL = 1e-10
THRESHOLD = 1e-9

# a polarised cylinder, so that TempSVD (the Stokes I block) and FullSVD
# (the whole beam) compress differently
TELESCOPE = {
    "type": "PolarisedCylinder", "num_freq": 2, "freq_start": 400.0, "freq_end": 410.0,
    "freq_mode": "edge", "num_cylinders": 2, "cylinder_width": 2.0, "num_feeds": 2,
    "feed_spacing": 1.0, "tsys": 10.0,
}
VARIANTS = {
    "nosvd": beamtransfer.BeamTransferNoSVD,
    "fullsvd": beamtransfer.BeamTransferFullSVD,
    "tempsvd": beamtransfer.BeamTransferTempSVD,
}


def _config(outdir, variant):
    return {
        "config": {"beamtransfers": True, "kltransform": True, "psfisher": True,
                   "output_directory": str(outdir), "nosvd": variant == "nosvd",
                   "fullsvd": variant == "fullsvd"},
        "telescope": TELESCOPE,
        "kltransform": [{"type": "KLTransform", "name": "kl", "threshold": THRESHOLD}],
        "psfisher": [
            {"type": "Full", "name": "ps", "klname": "kl", "threshold": THRESHOLD,
             "k_bands": [{"spacing": "linear", "start": 0.0, "stop": 0.25, "num": 3}]},
        ],
    }


def _write(conf, path):
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cli(cli, args):
    """Invoke a click command in-process, keeping the test's logging."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        res = CliRunner().invoke(cli, args)
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
    assert res.exit_code == 0, repr(res.exception)


def _temp_svd(m, klass):
    """Swap a manager's beam transfer for TempSVD, which no config key selects."""
    m.beamtransfer = klass(m.beamtransfer.directory, telescope=m.telescope)
    m.kltransforms["kl"].beamtransfer = m.beamtransfer
    return m


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def runs(request, tmp_path_factory):
    """(variant, JAX manager, port manager) after one full run of each."""
    variant = request.param
    base = tmp_path_factory.mktemp(variant)
    jconf = _write(_config(base / "jax", variant), base / "j.yaml")
    tconf = _write(_config(base / "torch", variant), base / "t.yaml")
    if variant == "tempsvd":
        _temp_svd(jmanager.ProductManager.from_config(jconf),
                  jbeamtransfer.BeamTransferTempSVD).generate()
        _temp_svd(manager.ProductManager.from_config(tconf, device="cpu"),
                  beamtransfer.BeamTransferTempSVD).generate()
    else:
        _cli(jmakeproducts.cli, ["run", jconf])
        _cli(makeproducts._cli(), ["run", tconf, "--device", "cpu"])
    mj = jmanager.ProductManager.from_config(jconf)
    mt = manager.ProductManager.from_config(tconf, device="cpu")
    if variant == "tempsvd":
        _temp_svd(mj, jbeamtransfer.BeamTransferTempSVD)
        _temp_svd(mt, beamtransfer.BeamTransferTempSVD)
    assert type(mt.beamtransfer) is VARIANTS[variant]
    assert type(mj.beamtransfer).__name__ == VARIANTS[variant].__name__
    return variant, mj, mt


def _read(path, name):
    with h5py.File(path, "r") as f:
        return f[name][:]


def _rel(a, b):
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale > 0 else float(np.abs(a).max())


def _tree(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )


def test_directory_layout(runs):
    variant, mj, mt = runs
    tree = _tree(mt.directory)
    assert tree == _tree(mj.directory)
    assert ("bt/beam_m/00/svd.hdf5" in tree) == (variant != "nosvd")


def test_beam_files(runs):
    _, mj, mt = runs
    for mi in range(mt.telescope.mmax + 1):
        a = _read(mt.beamtransfer._mfile(mi), "beam_m")
        assert _rel(a, _read(mj.beamtransfer._mfile(mi), "beam_m")) <= 1e-7


def test_svd_files(runs):
    variant, mj, mt = runs
    bt, jbt = mt.beamtransfer, mj.beamtransfer
    assert bt.svd_len == jbt.svd_len and bt.ndofmax == jbt.ndofmax
    for mi in range(mt.telescope.mmax + 1):
        assert bt.ndof(mi) == jbt.ndof(mi)
    if variant == "nosvd":
        assert bt.ndof(0) == bt.ntel * bt.nfreq
        return
    sv_worst = proj_worst = 0.0
    for mi in range(mt.telescope.mmax + 1):
        ft, fj = bt._svdfile(mi), jbt._svdfile(mi)
        sa, sb = _read(ft, "singularvalues"), _read(fj, "singularvalues")
        top = max(sb.max(), 1e-300)
        kept = sb > bt.svcut * top
        assert np.array_equal(sa > bt.svcut * top, kept)
        sv_worst = max(sv_worst, float(np.abs(sa - sb).max() / top))
        ua, ub = _read(ft, "beam_ut"), _read(fj, "beam_ut")
        for name in ("beam_svd", "invbeam_svd"):
            assert _read(ft, name).shape == _read(fj, name).shape
        for fi in range(sa.shape[0]):
            k = kept[fi]
            nw = bt._noise_weights(fi)
            qa, qb = ua[fi][k] / nw, ub[fi][k] / nw
            proj_worst = max(proj_worst, float(np.abs(qa.conj().T @ qa - qb.conj().T @ qb).max()))
    print(f"{variant}: singular values {sv_worst:.3e}, projectors {proj_worst:.3e} (tol 1e-6)")
    assert sv_worst <= 1e-6 and proj_worst <= 1e-6
    assert _rel(bt.svd_all(), jbt.svd_all()) <= 1e-6


def test_kl_and_fisher_files(runs):
    variant, mj, mt = runs
    a = _read(mt.kltransforms["kl"].evdir + "/evals.hdf5", "evals")
    b = _read(mj.kltransforms["kl"].evdir + "/evals.hdf5", "evals")
    assert a.shape == b.shape
    err = float((np.abs(a - b) / np.maximum(b.max(axis=1, keepdims=True), 1e-300)).max())
    kept = int((b > THRESHOLD).sum())
    print(f"{variant}: KL spectra {err:.3e} of each m's top (tol 1e-4), {kept} modes kept")
    assert err <= 1e-4 and kept > 0
    for mi in range(mt.telescope.mmax + 1):
        with h5py.File(mt.kltransforms["kl"]._evfile % mi, "r") as f, h5py.File(
            mj.kltransforms["kl"]._evfile % mi, "r"
        ) as g:
            assert int(f.attrs["num_modes"]) == int(g.attrs["num_modes"])
            assert f["evecs"].shape == g["evecs"].shape
    ft = mt.psestimators["ps"].psdir + "/fisher.hdf5"
    fj = mj.psestimators["ps"].psdir + "/fisher.hdf5"
    fish = _read(fj, "fisher")
    assert np.abs(fish).max() > 0
    print(f"{variant}: Fisher {_rel(_read(ft, 'fisher'), fish):.3e} (tol 3e-2)")
    assert _rel(_read(ft, "fisher"), fish) <= 3e-2


# ---- a timestream through a NoSVD product directory ----

NSIDE = 16


@pytest.fixture(scope="module")
def nosvd_pipeline(tmp_path_factory):
    base = tmp_path_factory.mktemp("nosvd_pipeline")
    prod = str(base / "prod")
    conf = {
        "config": {"beamtransfers": True, "kltransform": True, "psfisher": False,
                   "output_directory": prod, "nosvd": True},
        "telescope": {
            "type": "UnpolarisedCylinder", "num_freq": 2, "freq_start": 400.0,
            "freq_end": 410.0, "freq_mode": "edge", "num_cylinders": 2,
            "cylinder_width": 2.0, "num_feeds": 2, "feed_spacing": 1.5, "tsys": 1.0,
        },
        "kltransform": [{"type": "KLTransform", "name": "kl", "inverse": True,
                         "subset": False, "threshold": -1.0e30}],
    }
    _cli(jmakeproducts.cli, ["run", _write(conf, base / "prod.yaml")])

    lmax = 38
    rng = np.random.default_rng(7)
    ls, ms = np.arange(lmax + 1)[:, None], np.arange(lmax + 1)[None, :]
    alm = rng.standard_normal((2, lmax + 1, lmax + 1)) + 1j * rng.standard_normal(
        (2, lmax + 1, lmax + 1)
    )
    alm = np.where(ms <= ls, alm, 0)
    alm[..., 0] = alm[..., 0].real
    skymap = str(base / "sky.hdf5")
    with h5py.File(skymap, "w") as f:
        f.create_dataset("map", data=np.asarray(jsht.synthesis_real(alm, NSIDE))[:, None])

    out = {}
    for kind in ("jax", "torch"):
        pipe = {
            "config": {"product_directory": prod, "klmodes": ["kl"], "klmaps": ["kl"],
                       "nside": NSIDE},
            "timestreams": [{"name": "ts1", "directory": str(base / kind / "ts1"),
                             "simulate": {"product_directory": prod, "maps": [skymap],
                                          "ndays": 0}}],
        }
        out[kind] = (str(base / kind), _write(pipe, base / f"{kind}.yaml"))
    _cli(jrunpipeline.cli, ["run-config", out["jax"][1]])
    _cli(runpipeline._cli(), ["run-config", out["torch"][1], "--device", "cpu"])
    return out


def test_nosvd_timestream_files(nosvd_pipeline):
    """Every file of the two pipelines' output, dataset by dataset."""
    root_t, root_j = nosvd_pipeline["torch"][0], nosvd_pipeline["jax"][0]
    tree = _tree(root_j)
    assert _tree(root_t) == tree
    assert "ts1/mmodes/00/svd.hdf5" in tree and "ts1/map_svd.hdf5" in tree
    checked = 0
    for rel in tree:
        if not rel.endswith(".hdf5"):
            continue
        with h5py.File(os.path.join(root_t, rel), "r") as ft, h5py.File(
            os.path.join(root_j, rel), "r"
        ) as fj:
            assert sorted(ft) == sorted(fj)
            for name in fj:
                a, b = np.asarray(ft[name][()]), np.asarray(fj[name][()])
                assert a.shape == b.shape and a.dtype == b.dtype, (rel, name)
                if b.dtype.kind in "biu":
                    assert np.array_equal(a, b), (rel, name)
                elif b.size and np.abs(b).max() > 0:
                    assert np.abs(a - b).max() <= RTOL * np.abs(b).max(), (rel, name)
                checked += 1
    assert checked > 3 * 36
