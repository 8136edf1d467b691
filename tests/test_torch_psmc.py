"""The Monte-Carlo PS estimators of driftscan_tpu_torch (``MonteCarlo``,
``MonteCarloAlt``, ``Cross``) against the JAX package's, on the CPU in
float64.

KL eigenvectors are defined only up to a phase per mode, so identical
draws give identical q values only over the same KL modes: the exact
parity runs both packages' estimators over one product directory that the
JAX package wrote (the small unpolarised cylinder of
``tests/test_torch_products.py``), with the same seed, Fisher and bias
within 1e-8 of their largest entry.  The port draws every sample of an m
from one generator; the JAX package makes a new one per draw (its second
sample chunk repeats the first, and Cross's two streams are one), so where
they part the JAX estimator is given the port's stream.  Statistical
parity runs on the port's own products: ``tests/test_psmc_variants.py``'s
configuration and tolerances against the port's ``Full`` Fisher.
"""

import logging
import os
import shutil

import h5py
import numpy as np
import pytest
import torch
import yaml

from driftscan_tpu.core import crosspower as jcrosspower
from driftscan_tpu.core import manager as jmanager
from driftscan_tpu.core import psmc as jpsmc
from driftscan_tpu_torch.core import beamtransfer, crosspower, kltransform, manager, psmc
from driftscan_tpu_torch.scripts import makeproducts
from driftscan_tpu_torch.telescope import cylinder

BANDS = [{"spacing": "linear", "start": 0.0, "stop": 0.25, "num": 3}]
THRESHOLD = 0.1
SEED = 7
TELESCOPE = {"freq_start": 400.0, "freq_end": 410.0, "freq_mode": "edge", "num_cylinders": 2,
             "feed_spacing": 1.0, "tsys": 10.0, "num_freq": 4, "cylinder_width": 3.0,
             "num_feeds": 3}
KINDS = {
    "MonteCarlo": (psmc.PSMonteCarlo, jpsmc.PSMonteCarlo),
    "MonteCarloAlt": (psmc.PSMonteCarloAlt, jpsmc.PSMonteCarloAlt),
    "Cross": (crosspower.CrossPower, jcrosspower.CrossPower),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs: the configs are small, and
    the test workers of one host share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_products(tmp_path_factory):
    """(JAX KL transform, the port's KL transform) over one directory of
    BTM, SVD and KL products written by the JAX package."""
    base = tmp_path_factory.mktemp("psmc_jax")
    conf = {
        "config": {"beamtransfers": True, "kltransform": True, "output_directory": str(base)},
        "telescope": dict(type="UnpolarisedCylinder", **TELESCOPE),
        "kltransform": [{"type": "KLTransform", "name": "kl", "threshold": THRESHOLD}],
    }
    mj = jmanager.ProductManager()
    mj.apply_config(conf)
    mj.generate()
    tel = cylinder.UnpolarisedCylinderTelescope.from_config(TELESCOPE, device="cpu")
    bt = beamtransfer.BeamTransfer(mj.beamtransfer.directory, telescope=tel)
    kl = kltransform.KLTransform.from_config(conf["kltransform"][0], bt, subdir="kl")
    return mj.kltransforms["kl"], kl


def _pair(jax_products, kind, nsamples):
    jkl, kl = jax_products
    entry = {"klname": "kl", "threshold": THRESHOLD, "k_bands": BANDS,
             "nsamples": nsamples, "seed": SEED}
    port_cls, jax_cls = KINDS[kind]
    ps = port_cls.from_config(entry, kl, subdir=f"port_{kind}_{nsamples}")
    jps = jax_cls.from_config(entry, jkl, subdir=f"jax_{kind}_{nsamples}")
    ps.genbands()
    jps.genbands()
    return ps, jps


def _one_stream(jps):
    """Give the JAX estimator the port's draws: one generator per m, seeded
    as both packages seed it, for all of that m's draws."""
    streams = {}
    jps._rng = lambda mi: streams.setdefault(mi, np.random.default_rng(SEED + 31 * mi))
    return streams


def _rel(a, b):
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("kind,nsamples", [("MonteCarlo", 300), ("MonteCarlo", 1500),
                                           ("MonteCarloAlt", 300), ("Cross", 300)])
def test_estimators_match_jax(jax_products, kind, nsamples):
    """Per-m Fisher and bias of every m with retained modes, the port
    against the JAX package on the JAX package's KL modes, same seed."""
    ps, jps = _pair(jax_products, kind, nsamples)
    # one chunk of draws (<= 1000) and Alt's single draw are the same in
    # both packages; later draws follow one stream in the port
    same_draws = kind == "MonteCarloAlt" or (kind == "MonteCarlo" and nsamples <= 1000)
    ms = [mi for mi in range(ps.telescope.mmax + 1) if ps.num_evals(mi) > 0]
    assert len(ms) > 4
    worst = 0.0
    for mi in ms:
        if not same_draws:
            _one_stream(jps)
        f, b = ps.fisher_bias_m(mi)
        jf, jb = jps.fisher_bias_m(mi)
        assert f.shape == (ps.nbands, ps.nbands) and b.shape == (ps.nbands,)
        worst = max(worst, _rel(f, jf), _rel(b, jb) if np.abs(jb).max() > 0 else 0.0)
    print(f"{kind} x {nsamples}: {len(ms)} m, Fisher and bias max {worst:.3e} of max (tol 1e-8)")
    assert worst <= 1e-8


def test_the_ports_streams_are_independent(jax_products):
    """Cross's two streams, and the chunks of a long MonteCarlo run, are
    successive draws of one generator: not repeats (the JAX package's
    seeded draws restart per call)."""
    ps, jps = _pair(jax_products, "Cross", 300)
    mi = next(m for m in range(ps.telescope.mmax + 1) if ps.num_evals(m) > 0)
    assert np.array_equal(jps.gen_sample(mi, 10), jps.gen_sample(mi, 10))
    rng = ps._rng(mi)
    first, second = ps.gen_sample(mi, 10, rng=rng), ps.gen_sample(mi, 10, rng=rng)
    assert not np.allclose(first, second)
    assert np.array_equal(first, jps.gen_sample(mi, 10))


def test_gen_sample_noiseonly(jax_products):
    ps, _ = _pair(jax_products, "MonteCarlo", 300)
    mi = next(m for m in range(ps.telescope.mmax + 1) if ps.num_evals(m) > 0)
    evals, _ = ps.kltrans.modes_m(mi)
    noise = ps.gen_sample(mi, 200, noiseonly=True)
    data = ps.gen_sample(mi, 200)
    assert noise.shape == data.shape == (evals.size, 200) and noise.dtype == np.complex128
    np.testing.assert_allclose(data, noise * np.sqrt(evals + 1.0)[:, None], rtol=1e-15)
    assert np.array_equal(noise, psmc.complex_std_normal((evals.size, 200),
                                                         np.random.default_rng(SEED + 31 * mi)))


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    """``tests/test_psmc_variants.py``'s products (Full, MonteCarlo and
    MonteCarloAlt at 1500 samples, Cross at 600, seed 7) from the port."""
    src = open(os.path.join(os.path.dirname(__file__), "test_psmc_variants.py")).read()
    start = src.index('CONFIG = """') + len('CONFIG = """')
    text = src[start : src.index('"""', start)]
    base = tmp_path_factory.mktemp("psmc_variants")
    conf = yaml.safe_load(text.format(outdir=f"{base}/testdir"))
    m = manager.ProductManager(device="cpu").apply_config(conf)
    m.generate()
    return m


def _fisher(ps):
    f, b = ps.fisher_bias()
    return np.asarray(f).real, np.asarray(b).real


@pytest.mark.parametrize("name", ["psmc", "psalt"])
def test_mc_matches_full(variants, name):
    """The sample-covariance and stochastic-trace Fishers against the exact
    one, at the tolerances of the JAX package's test."""
    f_exact, _ = _fisher(variants.psestimators["psx"])
    f_mc, _ = _fisher(variants.psestimators[name])
    scale = np.abs(f_exact).max()
    assert scale > 0
    np.testing.assert_allclose(f_mc, f_exact, rtol=0.35, atol=0.15 * scale)
    if name == "psalt":
        np.testing.assert_allclose(f_mc, f_mc.T, atol=1e-12 * scale)
        assert np.linalg.eigvalsh(f_mc).min() > -1e-8 * scale


def test_crosspower_fisher(variants):
    ps = variants.psestimators["pscross"]
    assert ps.crosspower is True and isinstance(ps, crosspower.CrossPower)
    fisher, bias = _fisher(ps)
    assert fisher.shape == (ps.nbands, ps.nbands) and bias.shape == (ps.nbands,)
    assert np.isfinite(fisher).all() and np.isfinite(bias).all()
    np.testing.assert_allclose(fisher, fisher.T, atol=1e-12)


@pytest.mark.parametrize("name", ["psmc", "psalt", "pscross"])
def test_seeded_determinism(variants, name):
    """A fixed seed gives the same Fisher and bias again, bit for bit."""
    ps = variants.psestimators[name]
    ps.genbands()
    f1, b1 = ps._work_fisher_bias_m(1)
    f2, b2 = ps._work_fisher_bias_m(1)
    assert np.array_equal(f1, f2) and np.array_equal(b1, b2)


def test_testparams_yaml_through_the_cli(tmp_path):
    """The repository's functional-test configuration (MonteCarlo on a KL
    and a DoubleKL filter), unedited, through ``drift-makeproducts-torch``
    on the CPU."""
    from click.testing import CliRunner

    src = os.path.join(os.path.dirname(__file__), "testparams.yaml")
    shutil.copy(src, tmp_path / "testparams.yaml")
    cwd = os.getcwd()
    root_logger = logging.getLogger()
    handlers, level = list(root_logger.handlers), root_logger.level
    try:
        os.chdir(tmp_path)
        res = CliRunner().invoke(makeproducts._cli(), ["run", "testparams.yaml", "--device", "cpu"])
    finally:
        os.chdir(cwd)
        # the command's logging set-up belongs to its own process
        root_logger.handlers[:] = handlers
        root_logger.setLevel(level)
    assert res.exit_code == 0, repr(res.exception)
    with open(src) as f:
        conf = yaml.safe_load(f)
    out = tmp_path / "testdir" / "bt"
    for entry in conf["psfisher"]:
        assert entry["type"] == "MonteCarlo"
        path = out / entry["klname"] / entry["name"] / "fisher.hdf5"
        with h5py.File(path, "r") as f:
            fisher, bias = f["fisher"][:], f["bias"][:]
        nb = len(np.linspace(0, 1, entry["k_bands"][0]["num"])) - 1
        nb *= entry.get("num_theta", 1)
        assert fisher.shape == (nb, nb) and bias.shape == (nb,)
        assert np.isfinite(fisher).all() and np.isfinite(bias).all()
        assert np.array_equal(fisher, fisher.T)
    with h5py.File(out / "kl" / "ps1" / "fisher.hdf5", "r") as f:
        assert np.abs(f["fisher"][:]).max() > 0
