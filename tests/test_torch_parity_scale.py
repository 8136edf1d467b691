"""Parity at scale on the CPU (slow tier): the port against the JAX package
through both command lines, and fault 7's triage pinned.

* the file path (``ProductManager.generate``: beams, SVD, KL, DoubleKL,
  PSExact) at ``bench.build_telescope``'s cylinder (2 x 8 feeds, 8 channels
  over 400-450 MHz, lmax 229, 226 m) and at the reference's CI scale (2 x 5
  feeds 5 m wide, 8 channels over 400-450 MHz, lmax 96), float64,
  through ``drift-makeproducts run`` of each package; file by file at
  BASELINE's tiers: ``beam.hdf5`` within its bit truncation (1e-7 of max),
  singular values 1e-3 of each m's top, KL spectra 1e-4 of each m's top
  (DoubleKL 1e-2), Fisher, covariance and errors 3e-2 of max.  Each file
  path is held against the other package's file path, never against a
  resident run (the file path's pencil carries KLTransform's foreground
  regulariser);
* the timestream (``drift-runpipeline run-config``: simulate, m-modes, SVD
  and KL modes, power spectra, maps) at the bench cylinder, both packages'
  pipelines on the JAX product directory (one set of SVD and KL bases),
  every dataset 1e-8 of its largest entry;
* fault 7: ``tests/ns2_triage.py`` on a rehearsal cut of ns2 (its 16 units
  of the longest baselines at the highest channels, m 270 and 313): the two
  packages' float64 BTM columns within 1e-10 of max; every SVD mode the JAX
  route keeps and the port does not lies under 1e-10 of its channel's top
  singular value (the polarisation filter's rounding residue), and in
  float32 the JAX route keeps more such modes still; the port's complex64
  tables give the float64 counts.

The figures achieved are printed (``-s``).  The JAX package's command
line alone takes tens of minutes at these scales on a CPU.
"""

import logging
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from driftscan_tpu.core import manager as jmanager
from driftscan_tpu.ops import sht as jsht
from driftscan_tpu.scripts import runpipeline as jrunpipeline
from driftscan_tpu_torch.scripts import makeproducts, runpipeline

pytestmark = pytest.mark.slow

HERE = os.path.dirname(os.path.abspath(__file__))
BANDS = [{"spacing": "linear", "start": 0.02, "stop": 0.25, "num": 5}]
CONFIGS = {
    "bench": (
        {"type": "UnpolarisedCylinder", "num_freq": 8, "freq_start": 400.0,
         "freq_end": 450.0, "freq_mode": "edge", "num_cylinders": 2, "cylinder_width": 12.0,
         "num_feeds": 8, "feed_spacing": 0.6, "tsys": 50.0, "single_precision": False},
        {}, 0.1),
    "ci": (
        {"type": "UnpolarisedCylinder", "num_freq": 8, "freq_start": 400.0, "freq_end": 450.0,
         "freq_mode": "edge", "num_cylinders": 2, "cylinder_width": 5.0, "num_feeds": 5,
         "feed_spacing": 0.5, "tsys": 50.0, "single_precision": False},
        {}, 0.1),
}
NSIDE = 64


def _config(name, outdir):
    tel, kl_extra, thr = CONFIGS[name]
    return {
        "config": {"beamtransfers": True, "kltransform": True, "psfisher": True,
                   "output_directory": str(outdir)},
        "telescope": dict(tel),
        "kltransform": [
            {"type": "KLTransform", "name": "kl", "threshold": thr, **kl_extra},
            {"type": "DoubleKL", "name": "dk", "threshold": thr, **kl_extra},
        ],
        "psfisher": [
            {"type": "Full", "name": "ps", "klname": "kl", "threshold": thr,
             "bandtype": "polar", "num_theta": 1, "unit_bands": True, "k_bands": BANDS},
        ],
    }


def _write(conf, path):
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return str(path)


def _cli(cli, args):
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        res = CliRunner().invoke(cli, args)
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
    assert res.exit_code == 0, repr(res.exception)


@pytest.fixture(scope="module", autouse=True)
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def products(request, tmp_path_factory):
    """(name, JAX product directory, port product directory)."""
    name = request.param
    base = tmp_path_factory.mktemp(name)
    mj = jmanager.ProductManager.from_config(_write(_config(name, base / "jax"),
                                                    base / "j.yaml"))
    mj.generate()
    mt = makeproducts.run_config(_write(_config(name, base / "torch"), base / "t.yaml"),
                                 device="cpu")
    return name, mj, mt


def _read(path, ds):
    with h5py.File(path, "r") as f:
        return f[ds][:]


def _rel(a, b):
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale > 0 else float(np.abs(a).max())


def test_same_files(products):
    _, mj, mt = products

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(mt.directory) == tree(mj.directory)


def test_beam_files(products):
    name, mj, mt = products
    worst = max(_rel(_read(mt.beamtransfer._mfile(mi), "beam_m"),
                     _read(mj.beamtransfer._mfile(mi), "beam_m"))
                for mi in range(mt.telescope.mmax + 1))
    print(f"{name}: beam.hdf5 max rel diff {worst:.3e} (tol 1e-7, the bit truncation)")
    assert worst <= 1e-7


def test_svd_files(products):
    name, mj, mt = products
    bt = mt.beamtransfer
    worst, ndiff = 0.0, 0
    for mi in range(mt.telescope.mmax + 1):
        sa = _read(bt._svdfile(mi), "singularvalues")
        sb = _read(mj.beamtransfer._svdfile(mi), "singularvalues")
        top = max(sb.max(), 1e-300)
        ka, kb = sa > bt.svcut * top, sb > bt.svcut * top
        ndiff += int((ka != kb).sum())
        both = ka & kb
        if both.any():
            worst = max(worst, float(np.abs(sa - sb)[both].max() / top))
    print(f"{name}: singular values max diff / m's top {worst:.3e} (tol 1e-3); modes kept "
          f"by one package only {ndiff}")
    assert worst <= 1e-3 and ndiff == 0


@pytest.mark.parametrize("kl,tol", [("kl", 1e-4), ("dk", 1e-2)])
def test_kl_files(products, kl, tol):
    name, mj, mt = products
    a = _read(mt.kltransforms[kl].evdir + "/evals.hdf5", "evals")
    b = _read(mj.kltransforms[kl].evdir + "/evals.hdf5", "evals")
    assert a.shape == b.shape
    top = np.maximum(b.max(axis=1, keepdims=True), 1e-300)
    err = float((np.abs(a - b) / top).max())
    thr = CONFIGS[name][2]
    print(f"{name}: {kl} spectra max diff / m's top {err:.3e} (tol {tol:g}); retained "
          f"{int((a > thr).sum())} / {int((b > thr).sum())}")
    assert err <= tol
    assert (b > thr).sum() > 0, "no mode retained: the comparison would be empty"


def test_fisher_files(products):
    name, mj, mt = products
    ft = mt.psestimators["ps"].psdir + "/fisher.hdf5"
    fj = mj.psestimators["ps"].psdir + "/fisher.hdf5"
    with h5py.File(ft, "r") as f, h5py.File(fj, "r") as g:
        assert np.abs(g["fisher"][:]).max() > 0
        for ds in ("fisher", "covariance", "errors"):
            err = _rel(f[ds][:], g[ds][:])
            print(f"{name}: {ds} rel {err:.3e} of max (tol 3e-2)")
            assert err <= 3e-2


def _pipeline_config(prod, skymap, out):
    sim = {"product_directory": prod, "maps": [skymap]}
    return {
        "config": {"product_directory": prod, "klmodes": ["kl"],
                   "powerspectra": [{"psname": "ps", "klname": "kl"}], "nside": NSIDE},
        "timestreams": [
            {"name": "ts1", "directory": f"{out}/ts1", "simulate": dict(sim, ndays=0)},
            {"name": "ts2", "directory": f"{out}/ts2", "simulate": dict(sim, seed=5)},
        ],
    }


def test_timestream_files(products, tmp_path):
    """Both pipelines on the JAX product directory: every dataset of the two
    output trees within 1e-8 of its largest entry."""
    name, mj, _ = products
    if name != "bench":
        pytest.skip("the timestream runs at the bench cylinder")
    tel = mj.telescope
    lmax = tel.lmax
    rng = np.random.default_rng(99)
    ls, ms = np.arange(lmax + 1)[:, None], np.arange(lmax + 1)[None, :]
    alm = rng.standard_normal((tel.nfreq, lmax + 1, lmax + 1)) + 1j * rng.standard_normal(
        (tel.nfreq, lmax + 1, lmax + 1))
    alm = np.where(ms <= ls, alm, 0)
    alm[..., 0] = alm[..., 0].real
    skymap = str(tmp_path / "sky.hdf5")
    with h5py.File(skymap, "w") as f:
        f.create_dataset("map", data=np.asarray(jsht.synthesis_real(alm, NSIDE))[:, None])
    out = {k: str(tmp_path / k) for k in ("jax", "torch")}
    cfg = {k: _write(_pipeline_config(mj.directory, skymap, out[k]), tmp_path / f"{k}.yaml")
           for k in out}
    _cli(jrunpipeline.cli, ["run-config", cfg["jax"]])
    runpipeline.run_config(cfg["torch"], device="cpu")

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs if f.endswith(".hdf5"))

    files = tree(out["jax"])
    assert files and tree(out["torch"]) == files
    worst = {}
    for rel in files:
        with h5py.File(os.path.join(out["torch"], rel), "r") as ft, \
                h5py.File(os.path.join(out["jax"], rel), "r") as fj:
            for ds in fj:
                if not isinstance(fj[ds], h5py.Dataset):
                    continue
                a, b = np.asarray(ft[ds][()]), np.asarray(fj[ds][()])
                assert a.shape == b.shape, (rel, ds)
                if b.dtype.kind in "biu":
                    assert np.array_equal(a, b), (rel, ds)
                    continue
                stage = rel.split("/")[1] if "/" in rel else rel
                worst[stage] = max(worst.get(stage, 0.0), _rel(a, b))
    print(f"{name}: timestream datasets, max diff / max by stage {worst} (tol 1e-8)")
    assert max(worst.values()) <= 1e-8


def test_ns2_triage_rehearsal(tmp_path):
    """Fault 7's outcome on a rehearsal cut of ns2 (``tests/ns2_triage.py
    --units 16``): a route and precision trap of the JAX package, not a
    departure of the port."""
    out = str(tmp_path / "triage")
    subprocess.run([sys.executable, os.path.join(HERE, "ns2_triage.py"), "--out", out,
                    "--units", "16"], check=True, timeout=3600)
    z = {k: np.load(os.path.join(out, k + ".npz")) for k in (
        "btm-jax-f64", "btm-port-f64", "prod-jax-native-f64", "prod-jax-split-f64",
        "prod-jax-split-f32", "prod-port-f64", "prod-port-c64")}
    for key in ("pos", "neg"):
        assert _rel(z["btm-port-f64"][key], z["btm-jax-f64"][key]) <= 1e-10
    for m in (270, 313):
        jf, js, j32 = z["prod-jax-native-f64"], z["prod-jax-split-f64"], z["prod-jax-split-f32"]
        pf, pc = z["prod-port-f64"], z["prod-port-c64"]
        # the JAX package's resident product always takes the split route
        assert np.array_equal(jf[f"ev_{m}"], js[f"ev_{m}"])
        assert np.array_equal(pf[f"nmo_{m}"], pc[f"nmo_{m}"])
        s1 = jf[f"s1_{m}"][:, None]
        extra = (jf[f"sig_{m}"] > 0) & ~(pf[f"sig_{m}"] > 0)
        assert (jf[f"sig_{m}"][extra] < 1e-10 * np.broadcast_to(s1, extra.shape)[extra]).all()
        # where both keep a mode its singular value agrees (BASELINE's 1e-3)
        both = (jf[f"sig_{m}"] > 0) & (pf[f"sig_{m}"] > 0)
        if both.any():
            assert float((np.abs(pf[f"sig_{m}"] - jf[f"sig_{m}"])[both]
                          / jf[f"sig_{m}"][both]).max()) <= 1e-3
        assert int(j32[f"nmo_{m}"].sum()) > int(jf[f"nmo_{m}"].sum()) >= int(pf[f"nmo_{m}"].sum())
