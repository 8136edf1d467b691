"""The repository's example (``examples/disharray``: a 4 x 4 DishArray with
``nosvd``, its KL filter with an inverse, then a timestream and maps)
through both packages' command lines, file by file, on the CPU.

The two YAML files are copied unedited into one directory per package,
with the input map that the example's walkthrough script writes (a
seeded band-limited sky at nside 32, made here by the JAX package's
synthesis for both); then ``drift-makeproducts run prod_params.yaml``
and ``drift-runpipeline run-config pipe_params.yaml`` of each package run
there.  Tolerances: ``beam.hdf5`` within the bit truncation (1e-7 of its
largest entry); the KL spectra 1e-3 of each m's top eigenvalue, the
dense per-m path's tier (a NoSVD KL filter with an inverse takes that
path; its noise covariance is ill-conditioned, so two correct solvers
differ by ~1e-4 of the top: 1.7e-4 here), compared through their
spectra, since the inverse filter's eigenvectors are unique only up to
phases; the timestream, m-modes, SVD modes and full / SVD maps, which
the two directories compute from their own beams, 1e-6 of their largest
entry (beams truncated at 1e-7).
"""

import contextlib
import logging
import os
import shutil

import h5py
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from driftscan_tpu.ops import sht as jsht
from driftscan_tpu.scripts import makeproducts as jmakeproducts
from driftscan_tpu.scripts import runpipeline as jrunpipeline
from driftscan_tpu_torch.core import beamtransfer
from driftscan_tpu_torch.examples import disharray_driver
from driftscan_tpu_torch.scripts import makeproducts, runpipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "disharray")
NSIDE = 32


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cli(cli, args):
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        res = CliRunner().invoke(cli, args)
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
    assert res.exit_code == 0, repr(res.exception)


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    """{"jax" | "torch": the example directory after both commands}."""
    base = tmp_path_factory.mktemp("example")
    out = {}
    for kind in ("jax", "torch"):
        d = base / kind
        d.mkdir()
        for name in ("prod_params.yaml", "pipe_params.yaml"):
            shutil.copy(os.path.join(EXAMPLE, name), d / name)
        out[kind] = str(d)

    # the example runs from its own directory: its paths are relative
    with contextlib.chdir(out["jax"]):
        _cli(jmakeproducts.cli, ["run", "prod_params.yaml"])
    with contextlib.chdir(out["torch"]):
        _cli(makeproducts._cli(), ["run", "prod_params.yaml", "--device", "cpu"])

    # the walkthrough script's input map: a seeded band-limited sky
    tel = beamtransfer.BeamTransfer(
        os.path.join(out["torch"], "products", "bt"), device="cpu"
    ).telescope
    lmax = tel.lmax
    rng = np.random.default_rng(42)
    ls, ms = np.arange(lmax + 1)[:, None], np.arange(lmax + 1)[None, :]
    alm = rng.standard_normal((tel.nfreq, lmax + 1, lmax + 1)) + 1j * rng.standard_normal(
        (tel.nfreq, lmax + 1, lmax + 1)
    )
    alm = np.where(ms <= ls, alm, 0)
    alm[..., 0] = alm[..., 0].real
    skymap = np.asarray(jsht.synthesis_real(alm, NSIDE))
    for d in out.values():
        with h5py.File(os.path.join(d, "simulated_input_map.hdf5"), "w") as f:
            f.create_dataset("map", data=skymap[:, np.newaxis, :])

    with contextlib.chdir(out["jax"]):
        _cli(jrunpipeline.cli, ["run-config", "pipe_params.yaml"])
    with contextlib.chdir(out["torch"]):
        _cli(runpipeline._cli(), ["run-config", "pipe_params.yaml", "--device", "cpu"])
    return out


def _tree(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )


def _datasets(path_t, path_j):
    with h5py.File(path_t, "r") as ft, h5py.File(path_j, "r") as fj:
        assert sorted(ft) == sorted(fj), path_t
        for name in fj:
            yield name, np.asarray(ft[name][()]), np.asarray(fj[name][()])


def test_same_files(example):
    tree = _tree(example["torch"])
    assert tree == _tree(example["jax"])
    for rel in ("products/bt/beam_m/00/beam.hdf5", "products/bt/kl/evals.hdf5",
                "timestream/timestream_f/0/timestream.hdf5", "timestream/map_full.hdf5",
                "timestream/mmodes/00/svd.hdf5"):
        assert rel in tree
    assert not any(r.endswith("svd.hdf5") and r.startswith("products/") for r in tree)


@pytest.mark.parametrize("stage,tol", [("products", 1e-7), ("timestream", 1e-6)])
def test_files_match(example, stage, tol):
    """Every dataset of a stage: beams, the NoSVD telescope-basis products,
    and the pipeline's timestream, modes and maps."""
    checked = 0
    for rel in _tree(example["jax"]):
        if not (rel.startswith(stage + "/") and rel.endswith(".hdf5")):
            continue
        if rel.startswith("products/bt/kl/"):
            continue  # the KL files: below, through their spectra
        for name, a, b in _datasets(os.path.join(example["torch"], rel),
                                    os.path.join(example["jax"], rel)):
            assert a.shape == b.shape and a.dtype == b.dtype, (rel, name)
            if b.dtype.kind in "biu":
                assert np.array_equal(a, b), (rel, name)
            elif b.size and np.abs(b).max() > 0:
                assert np.abs(a - b).max() <= tol * np.abs(b).max(), (rel, name)
            checked += 1
    assert checked > 30


def test_kl_spectra_match(example):
    rel = "products/bt/kl/evals.hdf5"
    for name, a, b in _datasets(os.path.join(example["torch"], rel),
                                os.path.join(example["jax"], rel)):
        top = np.maximum(np.abs(b).max(axis=1, keepdims=True), 1e-300)
        assert a.shape == b.shape and float((np.abs(a - b) / top).max()) <= 1e-3


def test_maps_are_finite(example):
    for name in ("map_full", "map_svd"):
        with h5py.File(os.path.join(example["torch"], "timestream", f"{name}.hdf5"), "r") as f:
            skymap = f["map"][:]
        assert skymap.shape[-1] == 12 * NSIDE**2
        assert np.isfinite(skymap).all() and np.abs(skymap).max() > 0


def test_driver_input_map_matches_jax(example):
    """The port's copy of the example's driver
    (``driftscan_tpu_torch.examples.disharray_driver``) makes the JAX
    driver's input map: the same seeded alm, the port's synthesis, within
    1e-10 of its largest entry."""
    tel = beamtransfer.BeamTransfer(
        os.path.join(example["torch"], "products", "bt"), device="cpu"
    ).telescope
    got = disharray_driver.input_map(tel, device="cpu")
    with h5py.File(os.path.join(example["jax"], "simulated_input_map.hdf5"), "r") as f:
        want = f["map"][:]
    assert got.shape == want.shape == (tel.nfreq, 1, 12 * NSIDE**2)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_driver_runs_the_example(example, tmp_path):
    """The port's driver end to end on the CPU (products, input map,
    noiseless timestream, m-modes, full map) against the JAX command lines'
    run of the same example: its full map within 1e-6 of max, as the files
    above."""
    with contextlib.chdir(tmp_path):
        ts = disharray_driver.main(str(tmp_path), device="cpu")
    path = os.path.join(ts.output_directory, "map_full.hdf5")
    assert path == str(tmp_path / "timestream" / "map_full.hdf5")
    with h5py.File(path, "r") as f:
        got = f["map"][:]
    with h5py.File(os.path.join(example["jax"], "timestream", "map_full.hdf5"), "r") as f:
        want = f["map"][:]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
