"""``drift-makeproducts`` and ``drift-runpipeline`` of driftscan_tpu_torch
under two processes (torchrun, ``gloo``, ``--device cpu``) against one
process of the port and one of the JAX package.

The config is the JAX package's two-process products test's
(``tests/test_multiprocess_products.py``: a 2-channel polarised cylinder,
a KL filter, a seeded MonteCarlo estimator) with a ``Full`` estimator
beside the MonteCarlo.  That config keeps no KL mode (its largest KL
eigenvalue is 5e-18, its Fisher matrices are zero), so here the cylinder
observes at 400 MHz with two cylinders and 733 days, as the cylinder of
``tests/test_torch_timestream.py`` does, and the filter and estimators cut
at 1e-7: 13 modes are kept.  The BTM takes the chunked route
(``resident: never``, the route of every multi-process run) with a
``mem_chunk`` of three and a half units a process, so the 32 units go in
six chunks of six units (the last of two) whose round-robin deal and
exchange reorder them; the BTM is bit-truncated, as by default.  The
timestream leg simulates a noiseless timestream from a seeded sky and
makes its m-modes, SVD and KL modes, a power spectrum and the full and SVD
maps.  The two bands of the estimators above have a Fisher matrix of
condition number ~5e7 on this small telescope, which the power spectrum's
inverse would carry the last-bit change of the allreduce's sum order
through; the power spectrum takes a one-band ``Full`` estimator.

Tolerances: against the port's one-process run, ``beam.hdf5`` bit for bit
(every unit goes through the same SHT calls), the rest at 1e-10 of the
largest entry (the allreduce sums per-process partial sums); against the
JAX package's one-process run, the JAX package's own multi-process tiers:
beam rtol 1e-8 / atol 1e-10, singular values 1e-6, KL 1e-5, maps 1e-6,
Fisher, bias and power spectrum 1e-6.
"""

import logging
import os
import re
import signal
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from driftscan_tpu.core import manager as jmanager
from driftscan_tpu.core import psmc as jpsmc
from driftscan_tpu.ops import sht as jsht
from driftscan_tpu.scripts import makeproducts as jmakeproducts
from driftscan_tpu.scripts import runpipeline as jrunpipeline
from driftscan_tpu_torch.scripts import makeproducts, runpipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
NSIDE = 16
LMAX, MMAX = 38, 35  # of the cylinder below
UNIT_GB = 4 * (LMAX + 1) * 2 * (MMAX + 1) * 16 / 2**30  # one (2, npol, nl, nm) c128 unit
BANDS = [{"spacing": "linear", "start": 0.0, "stop": 0.25, "num": 3}]
THRESHOLD = 1e-7

PRODUCTS = {
    "config": {"beamtransfers": True, "kltransform": True, "psfisher": True,
               "resident": "never", "mem_chunk": 3.5 * UNIT_GB},
    "telescope": {
        "type": "PolarisedCylinder", "num_freq": 2, "freq_start": 400.0, "freq_end": 410.0,
        "freq_mode": "edge", "num_cylinders": 2, "cylinder_width": 2.0, "num_feeds": 2,
        "feed_spacing": 1.5, "tsys": 1.0, "ndays": 733,
    },
    "kltransform": [{"type": "KLTransform", "name": "kl", "threshold": THRESHOLD}],
    "psfisher": [
        {"type": "MonteCarlo", "name": "ps1", "klname": "kl", "threshold": THRESHOLD,
         "nsamples": 100, "seed": 42, "k_bands": BANDS},
        {"type": "Full", "name": "full", "klname": "kl", "threshold": THRESHOLD,
         "k_bands": BANDS},
        # one band: the power spectrum's estimator (see the module docstring)
        {"type": "Full", "name": "full1", "klname": "kl", "threshold": THRESHOLD,
         "k_bands": [dict(BANDS[0], num=2)]},
    ],
}


def _write(conf, path):
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return str(path)


def _pipeline(prod, skymap, out):
    return {
        "config": {"product_directory": prod, "klmodes": ["kl"], "nside": NSIDE,
                   "powerspectra": [{"psname": "full1", "klname": "kl"}]},
        "timestreams": [{"name": "ts1", "directory": f"{out}/ts1",
                         "simulate": {"product_directory": prod, "maps": [skymap],
                                      "ndays": 0}}],
    }


def _torchrun(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    # its own session, so that the launcher's workers go with it on a timeout
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(NPROC), *args, "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return err


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs: the configs are small, and
    the test workers of one host share its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"mp" | "sp" | "jax": product directory}: the port under two
    processes, the port in this process, the JAX package in this process;
    each with its timestream under ``<dir>_ts``.  Also the two-process
    run's log and its per-process stats files."""
    base = tmp_path_factory.mktemp("mp_products")
    lmax = LMAX
    rng = np.random.default_rng(99)
    ls, ms = np.arange(lmax + 1)[:, None], np.arange(lmax + 1)[None, :]
    alm = rng.standard_normal((8, lmax + 1, lmax + 1)) + 1j * rng.standard_normal(
        (8, lmax + 1, lmax + 1))
    alm = np.where(ms <= ls, alm, 0)
    alm[..., 0] = alm[..., 0].real
    skymap = str(base / "sky.hdf5")
    with h5py.File(skymap, "w") as f:
        f.create_dataset("map", data=np.asarray(jsht.synthesis_real(alm, NSIDE)).reshape(2, 4, -1))

    dirs, cfgs, pcfgs = {}, {}, {}
    for kind in ("mp", "sp", "jax"):
        dirs[kind] = str(base / kind)
        conf = dict(PRODUCTS, config=dict(PRODUCTS["config"], output_directory=dirs[kind]))
        cfgs[kind] = _write(conf, base / f"{kind}.yaml")
        pcfgs[kind] = _write(_pipeline(dirs[kind], skymap, f"{dirs[kind]}_ts"),
                             base / f"{kind}_pipe.yaml")

    stats = str(base / "stats_{rank}.json")
    log = _torchrun("-m", "driftscan_tpu_torch.scripts.makeproducts", "run", cfgs["mp"],
                    "--stats", stats)
    log += _torchrun("-m", "driftscan_tpu_torch.scripts.runpipeline", "run-config",
                     pcfgs["mp"])

    sp = makeproducts.run_config(cfgs["sp"], device="cpu")
    runpipeline.run_config(pcfgs["sp"], device="cpu")

    root_logger = logging.getLogger()
    handlers, level = list(root_logger.handlers), root_logger.level
    try:
        for cli, args in ((jmakeproducts.cli, ["run", cfgs["jax"]]),
                          (jrunpipeline.cli, ["run-config", pcfgs["jax"]])):
            res = CliRunner().invoke(cli, args)
            assert res.exit_code == 0, repr(res.exception)
    finally:
        # the commands' logging set-up belongs to their own process
        root_logger.handlers[:] = handlers
        root_logger.setLevel(level)

    # the JAX MonteCarlo over the two-process run's KL modes, into ps1_jax
    jkl = jmanager.ProductManager.from_config(dirs["mp"]).kltransforms["kl"]
    entry = next(e for e in PRODUCTS["psfisher"] if e["name"] == "ps1")
    jpsmc.PSMonteCarlo.from_config(entry, jkl, subdir="ps1_jax").generate()
    return dirs, log, stats, sp


def _read(path, dset):
    with h5py.File(path, "r") as f:
        return f[dset][:]


def _rel(a, b):
    """max |a - b| over max |b|; max |a| where b is all zeros (the Full
    estimator's bias)."""
    assert a.shape == b.shape
    top = np.abs(b).max()
    return float(np.abs(a - b).max() / top) if top > 0 else float(np.abs(a).max())


def test_two_processes_ran(runs):
    """Both processes joined, each logged its device and wrote its stats;
    the BTM took the chunked route in six chunks of both processes' units
    (the one-process run cuts the same units into eleven)."""
    dirs, log, stats, sp = runs
    import json

    for r in range(NPROC):
        with open(stats.replace("{rank}", str(r))) as f:
            st = json.load(f)
        assert (st["rank"], st["size"], st["device"]) == (r, NPROC, "cpu")
        assert st["timings"]["beams"] > 0 and set(st["launches"]) >= {"k1k2_beam_vis"}
        assert re.search(rf"\[MPI {r}/{NPROC}\].*process {r} of {NPROC} on cpu", log)
    assert "Splitting into 6 chunks" in log
    assert sp.beamtransfer.num_chunks == 11 and sp.beamtransfer._mem_beam is None
    assert (sp.telescope.lmax, sp.telescope.mmax) == (LMAX, MMAX)


def test_not_vacuous(runs):
    """The config keeps KL modes and gives non-zero Fisher matrices."""
    dirs = runs[0]
    ev = _read(f"{dirs['mp']}/bt/kl/evals.hdf5", "evals")
    assert (ev > THRESHOLD).sum() >= 10
    for ps in ("ps1", "full"):
        assert np.abs(_read(f"{dirs['mp']}/bt/kl/{ps}/fisher.hdf5", "fisher")).max() > 0


def _mdirs(d):
    return sorted(x for x in os.listdir(f"{d}/bt/beam_m") if x.isdigit())


def test_beam_files(runs):
    """beam.hdf5 of every m: two processes bit for bit one; within the JAX
    multi-process tier of the JAX package's one-process files."""
    dirs = runs[0]
    assert _mdirs(dirs["mp"]) == _mdirs(dirs["sp"]) == _mdirs(dirs["jax"])
    for d in _mdirs(dirs["sp"]):
        mp, sp, jx = (_read(f"{dirs[k]}/bt/beam_m/{d}/beam.hdf5", "beam_m")
                      for k in ("mp", "sp", "jax"))
        assert np.array_equal(mp, sp), d
        np.testing.assert_allclose(mp, jx, rtol=1e-8, atol=1e-10)


# (file under the product directory, dataset, tier against the JAX package,
# the JAX package's file: its own run's, or for the MonteCarlo its estimator
# over the two-process run's KL modes)
PRODUCT_FILES = [
    ("bt/svdspectrum.hdf5", "singularvalues", 1e-6, None),
    ("bt/kl/evals.hdf5", "evals", 1e-5, None),
    ("bt/kl/ps1/fisher.hdf5", "fisher", 1e-6, "bt/kl/ps1_jax/fisher.hdf5"),
    ("bt/kl/ps1/fisher.hdf5", "bias", 1e-6, "bt/kl/ps1_jax/fisher.hdf5"),
    ("bt/kl/full/fisher.hdf5", "fisher", 1e-6, None),
    ("bt/kl/full/fisher.hdf5", "bias", 1e-6, None),
]


@pytest.mark.parametrize("path,dset,tier,jpath", PRODUCT_FILES,
                         ids=[f"{p.split('/')[-2]}-{d}" for p, d, _, _ in PRODUCT_FILES])
def test_products(runs, path, dset, tier, jpath):
    """The seeded MonteCarlo included: its draws depend on (seed, m) only,
    so the process that takes an m does not change them.  KL eigenvectors
    are defined up to a phase per mode, so the same draws give the same
    Monte-Carlo Fisher matrix only over the same KL modes: the JAX
    estimator runs over the two-process run's."""
    dirs = runs[0]
    mp, sp = (_read(f"{dirs[k]}/{path}", dset) for k in ("mp", "sp"))
    jx = _read(f"{dirs['mp']}/{jpath}" if jpath else f"{dirs['jax']}/{path}", dset)
    err_sp, err_jax = _rel(mp, sp), _rel(mp, jx)
    print(f"{path}:{dset}: 2 vs 1 process {err_sp:.3e} (tol 1e-10), vs JAX {err_jax:.3e} "
          f"(tol {tier:g})")
    assert err_sp <= 1e-10 and err_jax <= tier


# (file under the timestream directory, dataset, tier against the JAX package)
TIMESTREAM_FILES = [
    ("ts1/map_full.hdf5", "map", 1e-6),
    ("ts1/map_svd.hdf5", "map", 1e-6),
    ("ts1/ps_full1.hdf5", "powerspectrum", 1e-6),
]


@pytest.mark.parametrize("path,dset,tier", TIMESTREAM_FILES,
                         ids=[p.split("/")[-1][:-5] for p, _, _ in TIMESTREAM_FILES])
def test_timestream(runs, path, dset, tier):
    """The noiseless timestream's maps and power spectrum."""
    dirs = runs[0]
    mp, sp, jx = (_read(f"{dirs[k]}_ts/{path}", dset) for k in ("mp", "sp", "jax"))
    err_sp, err_jax = _rel(mp, sp), _rel(mp, jx)
    print(f"{path}: 2 vs 1 process {err_sp:.3e} (tol 1e-10), vs JAX {err_jax:.3e} "
          f"(tol {tier:g})")
    assert err_sp <= 1e-10 and err_jax <= tier


def test_modes_files(runs):
    """Every m's m-mode, SVD-mode and KL-mode file of two processes equals
    one process's at 1e-10 of its largest entry."""
    dirs = runs[0]
    mp_ts, sp_ts = f"{dirs['mp']}_ts/ts1/mmodes", f"{dirs['sp']}_ts/ts1/mmodes"
    ms = sorted(os.listdir(sp_ts))
    assert sorted(os.listdir(mp_ts)) == ms
    checked = 0
    for d in ms:
        if not d.isdigit():
            continue
        for name in sorted(os.listdir(f"{sp_ts}/{d}")):
            with h5py.File(f"{sp_ts}/{d}/{name}", "r") as f:
                (dset,) = list(f)
            a, b = _read(f"{mp_ts}/{d}/{name}", dset), _read(f"{sp_ts}/{d}/{name}", dset)
            assert a.shape == b.shape
            if b.size and np.abs(b).max() > 0:
                assert _rel(a, b) <= 1e-10, (d, name)
            checked += 1
    assert checked >= 3 * (MMAX + 1)
