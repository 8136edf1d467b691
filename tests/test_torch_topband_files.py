"""``engine: topband`` through the port's file pipeline, on the CPU: the
KL and the DoubleKL filter.

JAX ``tests/test_kl_topband_writer.py``'s config (an unpolarised cylinder,
3 channels at 100-110 MHz, 2 x 2 feeds; KL cut 1e-10, DoubleKL cuts 1e-12
and 1e-10) with an exact and a top-band filter of each kind, generated
once through each package's ProductManager (a module-scoped fixture; the
JAX package runs only its two top-band filters, on a one-device mesh; its
exact ones are held against the port's in tests/test_torch_products.py):

* the port's top-band eigenfiles against the JAX package's: ``num_modes``
  equal, retained eigenvalues within rel 1e-4 (KL) and rel 1e-2 (DoubleKL,
  with its kept stage-1 band);
* against the port's exact eigenfiles: ``num_modes`` equal, retained
  eigenvalues within rel 1e-6, and the ``evals_full`` tail below the
  retained modes exact zeros;
* a forced certificate failure (a one-column basis and one level, less
  than any m's retained band) ends in the exact engine's files, bit for
  bit, with the fallback logged and recorded.
"""

import functools
import glob
import logging
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from driftscan_tpu.core import manager as jmanager
from driftscan_tpu.parallel import mesh as jmesh
from driftscan_tpu_torch.core import manager
from driftscan_tpu_torch.ops import projections

CONFIG = {
    "config": {"beamtransfers": True, "kltransform": True, "psfisher": False,
               "truncate": False},
    "telescope": {
        "type": "UnpolarisedCylinder", "num_freq": 3, "freq_start": 100.0,
        "freq_end": 110.0, "freq_mode": "edge", "num_cylinders": 2,
        "cylinder_width": 2.0, "num_feeds": 2, "feed_spacing": 1.5, "tsys": 40.0,
    },
    "kltransform": [
        {"type": "KLTransform", "name": "kl_exact", "threshold": 1.0e-10},
        {"type": "KLTransform", "name": "kl_topband", "engine": "topband",
         "threshold": 1.0e-10},
        {"type": "DoubleKL", "name": "dkl_exact", "foreground_threshold": 1.0e-10,
         "threshold": 1.0e-12},
        {"type": "DoubleKL", "name": "dkl_topband", "engine": "topband",
         "foreground_threshold": 1.0e-10, "threshold": 1.0e-12},
    ],
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _conf(outdir, names=None):
    conf = {k: (dict(v) if isinstance(v, dict) else [dict(x) for x in v])
            for k, v in CONFIG.items()}
    conf["config"]["output_directory"] = str(outdir)
    if names is not None:
        conf["kltransform"] = [k for k in conf["kltransform"] if k["name"] in names]
    return conf


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's top-band filters and the port's four under one
    directory: (JAX manager, port manager)."""
    import yaml

    base = tmp_path_factory.mktemp("topband_files")
    cfile = base / "jax.yaml"
    with open(cfile, "w") as f:
        yaml.safe_dump(_conf(base / "jax", names=("kl_topband", "dkl_topband")), f)
    # on one device: the package's default mesh spans the 8 virtual CPU
    # devices of tests/conftest.py, whose sharded compiles cost ~25 s more
    with jmesh.use_mesh(jmesh.make_mesh(jax.local_devices()[:1])):
        jm = jmanager.ProductManager.from_config(str(cfile))
        jm.generate()
    tm = manager.ProductManager(device="cpu").apply_config(_conf(base / "port"))
    tm.generate()
    return jm, tm


def _read(kl, mi):
    with h5py.File(kl._evfile % mi, "r") as f:
        out = {k: f[k][:] for k in ("evals", "evals_full", "evecs")}
        out["num_modes"] = int(f.attrs["num_modes"])
        if "f_evals" in f:
            out["f_evals"] = f["f_evals"][:]
    return out


def _pairs(runs, name_a, pkg_a, name_b, pkg_b):
    jm, tm = runs
    ka = (jm if pkg_a == "jax" else tm).kltransforms[name_a]
    kb = (jm if pkg_b == "jax" else tm).kltransforms[name_b]
    for mi in range(tm.telescope.mmax + 1):
        yield mi, _read(ka, mi), _read(kb, mi)


def match_jax(runs, name, rtol):
    compared = 0
    for mi, t, j in _pairs(runs, name, "port", name, "jax"):
        assert t["num_modes"] == j["num_modes"], mi
        if j["num_modes"]:
            compared += 1
            np.testing.assert_allclose(t["evals"], j["evals"], rtol=rtol)
        if "f_evals" in j:
            kt, kj = t["f_evals"][t["f_evals"] > 1e-10], j["f_evals"][j["f_evals"] > 1e-10]
            assert len(kt) == len(kj)
            np.testing.assert_allclose(np.sort(kt), np.sort(kj), rtol=rtol)
    assert compared > 0


def match_exact(runs, kind):
    compared = 0
    for mi, t, x in _pairs(runs, f"{kind}_topband", "port", f"{kind}_exact", "port"):
        assert t["num_modes"] == x["num_modes"], mi
        if x["num_modes"]:
            compared += 1
            np.testing.assert_allclose(t["evals"], x["evals"], rtol=1e-6)
    assert compared > 0


def tail_is_zero(runs, name):
    checked = 0
    for mi in range(runs[1].telescope.mmax + 1):
        t = _read(runs[1].kltransforms[name], mi)
        full, nret = t["evals_full"], t["num_modes"]
        if full.size > nret:
            assert np.all(full[: full.size - nret] == 0.0), mi
            checked += 1
    assert checked > 0


def test_topband_files_match_jax(runs):
    match_jax(runs, "kl_topband", 1e-4)


def test_topband_files_match_the_exact_engine(runs):
    match_exact(runs, "kl")


def test_evals_full_tail_is_zero(runs):
    tail_is_zero(runs, "kl_topband")


def test_topband_dkl_files_match_jax(runs):
    match_jax(runs, "dkl_topband", 1e-2)


def test_topband_dkl_files_match_the_exact_engine(runs):
    match_exact(runs, "dkl")


def test_dkl_evals_full_tail_is_zero(runs):
    tail_is_zero(runs, "dkl_topband")


def test_failed_certificate_falls_back_to_the_exact_engine(tmp_path, monkeypatch, caplog):
    """A one-column basis over one level holds less than any m's retained
    band: every chunk with retained modes fails its certificate and is
    solved again exactly; the files equal the exact filter's bit for bit."""
    monkeypatch.setattr(projections, "kl_factored_batched_topband",
                        functools.partial(projections.kl_factored_batched_topband, k=1,
                                          levels=1))
    tm = manager.ProductManager(device="cpu").apply_config(
        _conf(tmp_path / "fallback", names=("kl_exact", "kl_topband")))
    with caplog.at_level(logging.INFO):
        tm.generate()
    kl = tm.kltransforms["kl_topband"]
    assert kl.topband_fallback_chunks and "top-band certificate failed" in caplog.text
    for mi in range(tm.telescope.mmax + 1):
        t, x = _read(kl, mi), _read(tm.kltransforms["kl_exact"], mi)
        assert t["num_modes"] == x["num_modes"]
        for key in ("evals", "evals_full", "evecs"):
            np.testing.assert_array_equal(t[key], x[key])
    assert os.path.exists(os.path.join(kl.evdir, "evals.hdf5"))
    assert glob.glob(os.path.join(kl.evdir, "ev_m_*.hdf5"))
