"""The timestream pipeline of driftscan_tpu_torch (``drift-runpipeline``:
simulate -> m-modes -> SVD / KL modes -> power spectra -> maps) against the
JAX package's, file by file, on the CPU in float64.

One product directory is made by the JAX package's ``drift-makeproducts
run`` from a small cylinder (2 channels, 2 x 2 feeds, the SVD
BeamTransfer, a KLTransform with its inverse, a Full estimator); product
directories load in both packages, so both pipelines see the same SVD and
KL bases (which separate runs need not give alike).  The JAX package runs its
``drift-runpipeline run-config`` and the port its ``python -m
driftscan_tpu_torch.scripts.runpipeline run-config cfg.yaml --device cpu``, each
into a directory of its own: ts1 noiseless from a seeded sky map, ts2 with
the telescope's noise from a seed (numpy in both, so the same draw), and a
cross power spectrum of the two.  Every dataset is held at rel 1e-10 of its
largest entry, attributes exactly.

The JAX manager's ``generate`` never reaches its crosspower step (it tests
``stage is self._stage_powerspectra``, and a bound method is a new object
at every access): its cross spectrum is made here by calling that step.
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

from driftscan_tpu.ops import sht as jsht
from driftscan_tpu.pipeline import pipeline as jpipeline
from driftscan_tpu.scripts import makeproducts as jmakeproducts
from driftscan_tpu.scripts import runpipeline as jrunpipeline
from driftscan_tpu_torch.pipeline import pipeline, timestream
from driftscan_tpu_torch.scripts import runpipeline
from driftscan_tpu_torch.util import store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NSIDE = 16
RTOL = 1e-10

# KL and PS cut: the 2-channel cylinder's KL spectrum tops at ~3e-6, so the
# top modes of most m pass 1e-7 (none passes 0.1)
PRODUCTS = {
    "config": {"beamtransfers": True, "kltransform": True, "psfisher": True},
    "telescope": {
        "type": "UnpolarisedCylinder", "num_freq": 2, "freq_start": 400.0,
        "freq_end": 410.0, "freq_mode": "edge", "num_cylinders": 2,
        "cylinder_width": 2.0, "num_feeds": 2, "feed_spacing": 1.5, "tsys": 1.0,
        "ndays": 733,
    },
    "kltransform": [
        {"type": "KLTransform", "name": "kl", "inverse": True, "threshold": 1e-7},
    ],
    "psfisher": [
        {"type": "Full", "name": "ps", "klname": "kl", "threshold": 1e-7,
         "k_bands": [{"spacing": "linear", "start": 0.0, "stop": 0.25, "num": 3}]},
    ],
}


def _write(conf, path):
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return str(path)


def _pipeline_config(prod, skymap, out, xps):
    sim = {"product_directory": prod, "maps": [skymap]}
    return {
        "config": {
            "product_directory": prod, "klmodes": ["kl"],
            "powerspectra": [{"psname": "ps", "klname": "kl"}],
            "klmaps": ["kl"], "nside": NSIDE,
        },
        "timestreams": [
            {"name": "ts1", "directory": f"{out}/ts1", "simulate": dict(sim, ndays=0)},
            {"name": "ts2", "directory": f"{out}/ts2", "simulate": dict(sim, seed=5)},
        ],
        "crosspower": [
            {"psname": "ps", "klname": "kl", "timestreams": ["ts1", "ts2"], "psfile": xps},
        ],
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
def runs(tmp_path_factory):
    """{"jax" | "torch": (output directory, config file, cross spectrum file)}
    after one run of each package's command line on the same products."""
    base = tmp_path_factory.mktemp("timestream")
    prod = str(base / "prod")
    conf = dict(PRODUCTS, config=dict(PRODUCTS["config"], output_directory=prod))
    root_logger = logging.getLogger()
    handlers, level = list(root_logger.handlers), root_logger.level
    try:
        res = CliRunner().invoke(jmakeproducts.cli, ["run", _write(conf, base / "prod.yaml")])
        assert res.exit_code == 0, repr(res.exception)
    finally:
        # the command's logging set-up belongs to its own process
        root_logger.handlers[:] = handlers
        root_logger.setLevel(level)

    # a seeded band-limited sky, (freq, pol, pix)
    lmax = 38
    rng = np.random.default_rng(99)
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
        cfg = _write(
            _pipeline_config(prod, skymap, str(base / kind), str(base / f"xps_{kind}.hdf5")),
            base / f"{kind}.yaml",
        )
        out[kind] = (str(base / kind), cfg, str(base / f"xps_{kind}.hdf5"))

    res = CliRunner().invoke(jrunpipeline.cli, ["run-config", out["jax"][1]])
    assert res.exit_code == 0, repr(res.exception)
    jpipeline.PipelineManager.from_configfile(out["jax"][1])._run_crosspower()

    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    res = subprocess.run(
        [sys.executable, "-m", "driftscan_tpu_torch.scripts.runpipeline", "run-config",
         out["torch"][1], "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    return out


def _tree(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )


def _compare(path_t, path_j):
    """Every dataset of two HDF5 files at rel RTOL of its largest entry, and
    every attribute exactly."""
    with h5py.File(path_t, "r") as ft, h5py.File(path_j, "r") as fj:
        assert sorted(ft) == sorted(fj)
        assert sorted(ft.attrs) == sorted(fj.attrs)
        for key in fj.attrs:
            assert np.array_equal(ft.attrs[key], fj.attrs[key]), key
        for name in fj:
            a, b = np.asarray(ft[name][()]), np.asarray(fj[name][()])
            assert a.shape == b.shape and a.dtype == b.dtype, name
            if b.size == 0:
                continue
            if b.dtype.kind in "biu":
                assert np.array_equal(a, b), name
                continue
            scale = np.abs(b).max()
            err = np.abs(a - b).max() / scale if scale > 0 else np.abs(a).max()
            assert err <= RTOL, (path_t, name, err)


def test_same_files(runs):
    """The port's command leaves the file list of the JAX package's."""
    tree = _tree(runs["torch"][0])
    assert tree == _tree(runs["jax"][0])
    for ts in ("ts1", "ts2"):
        assert f"{ts}/timestream_f/0/timestream.hdf5" in tree
        assert f"{ts}/mmodes/COMPLETED_M" in tree
        assert f"{ts}/timestreamobject.pickle" in tree
        for name in ("map_full", "map_svd", "map_kl", "ps_ps", "klmodes_kl_0.000000"):
            assert f"{ts}/{name}.hdf5" in tree
    assert os.path.exists(runs["torch"][2])


@pytest.mark.parametrize("ts", ["ts1", "ts2"])
def test_timestream_files(runs, ts):
    for fi in range(2):
        rel = f"{ts}/timestream_f/{fi}/timestream.hdf5"
        _compare(os.path.join(runs["torch"][0], rel), os.path.join(runs["jax"][0], rel))


@pytest.mark.parametrize("kind", ["mode", "svd", "klmode_kl_0.000000"])
@pytest.mark.parametrize("ts", ["ts1", "ts2"])
def test_mode_files(runs, ts, kind):
    """m-modes, SVD modes and KL modes of every m."""
    rels = [r for r in _tree(runs["jax"][0]) if r.startswith(f"{ts}/mmodes/")
            and r.endswith(f"/{kind}.hdf5")]
    assert len(rels) == 36
    for rel in rels:
        _compare(os.path.join(runs["torch"][0], rel), os.path.join(runs["jax"][0], rel))


@pytest.mark.parametrize(
    "name", ["klmodes_kl_0.000000", "map_full", "map_svd", "map_kl", "ps_ps"]
)
@pytest.mark.parametrize("ts", ["ts1", "ts2"])
def test_collected_files(runs, ts, name):
    """Collected KL modes, the full, SVD and KL maps, the power spectrum."""
    rel = f"{ts}/{name}.hdf5"
    _compare(os.path.join(runs["torch"][0], rel), os.path.join(runs["jax"][0], rel))
    if name.startswith("map"):
        with h5py.File(os.path.join(runs["torch"][0], rel), "r") as f:
            skymap = f["map"][:]
        assert skymap.shape == (2, 1, 12 * NSIDE**2)
        assert np.isfinite(skymap).all() and np.abs(skymap).max() > 0


def test_cross_power_spectrum(runs):
    _compare(runs["torch"][2], runs["jax"][2])
    with h5py.File(runs["torch"][2], "r") as f:
        ps = f["powerspectrum"][:]
    assert ps.shape == (2, 2, 2) and np.isfinite(ps).all()


def test_wiener_kl_map(runs):
    """The Wiener-weighted KL map (not a stage of the config): each
    package's Timestream of ts2 makes it beside the others."""
    jts = jpipeline.PipelineManager.from_configfile(runs["jax"][1]).timestreams["ts2"]
    tts = pipeline.PipelineManager.from_configfile(
        runs["torch"][1], device="cpu"
    ).timestreams["ts2"]
    for ts in (jts, tts):
        ts.set_kltransform("kl")
        ts.mapmake_kl(NSIDE, "map_kl_wiener.hdf5", wiener=True)
    rel = "ts2/map_kl_wiener.hdf5"
    _compare(os.path.join(runs["torch"][0], rel), os.path.join(runs["jax"][0], rel))
    with h5py.File(os.path.join(runs["torch"][0], rel), "r") as fw, h5py.File(
        os.path.join(runs["torch"][0], "ts2/map_kl.hdf5"), "r"
    ) as f0:
        assert not np.allclose(fw["map"][:], f0["map"][:])


def test_rerun_skips(runs):
    """A second run rewrites neither the timestreams, the mode files nor
    the power spectra; the full and SVD maps are made again, as in the JAX
    package."""
    root = runs["torch"][0]
    stamp = {r: os.path.getmtime(os.path.join(root, r)) for r in _tree(root)}
    pm = runpipeline.run_config(runs["torch"][1], device="cpu")
    again = {r for r in _tree(root) if os.path.getmtime(os.path.join(root, r)) != stamp[r]}
    assert again == {f"{ts}/map_{k}.hdf5" for ts in ("ts1", "ts2") for k in ("full", "svd")}
    assert set(pm.timings) == {"simulate", "modes", "klmodes", "powerspectra", "crosspower", "maps"}


def test_mmodes_with_the_directory_store(runs, tmp_path, monkeypatch):
    """generate_mmodes with the files kept as ``.npy`` directories (as on a
    host without h5py): the same m-modes as the HDF5 run."""
    root = runs["torch"][0]
    tts = pipeline.PipelineManager.from_configfile(
        runs["torch"][1], device="cpu"
    ).timestreams["ts2"]
    streams = []
    for fi in range(2):
        with h5py.File(tts._ffile(fi), "r") as f:
            streams.append((f["timestream"][:], dict(f.attrs)))
    npy = timestream.Timestream(str(tmp_path / "ts2"), tts.manager)
    with monkeypatch.context() as mp:
        mp.setattr(store, "h5py", None)
        mp.setattr(store, "BACKEND", "npy")
        for fi, (data, attrs) in enumerate(streams):
            os.makedirs(npy._fdir(fi))
            with store.File(npy._ffile(fi), "w") as f:
                f.create_dataset("timestream", data=data)
                f.attrs.update(attrs)
        npy.generate_mmodes()
        assert os.path.isfile(os.path.join(npy._mfile(3), "mmode.npy"))
        got = [npy.mmode(mi) for mi in range(36)]
    for mi in range(36):
        with h5py.File(os.path.join(root, "ts2", "mmodes", f"{mi:02d}", "mode.hdf5"), "r") as f:
            assert np.array_equal(got[mi], f["mmode"][:])


def test_timestream_pickle(runs):
    ts = timestream.Timestream.load(os.path.join(runs["torch"][0], "ts1"))
    assert isinstance(ts, timestream.Timestream)
    assert ts.directory == os.path.join(runs["torch"][0], "ts1")
    assert ts.ntime == 2 * ts.telescope.mmax + 1


def test_cli_commands_not_ported(runs, tmp_path):
    """ROADMAP item 8.2 is ported: ``interactive-config`` loads the
    pipeline on the CPU into ``manager``; ``queue-config --nosubmit`` writes
    driftscan's job script, running this CLI's ``run-config``."""
    res = CliRunner().invoke(runpipeline._cli(),
                             ["interactive-config", runs["torch"][1], "--device", "cpu"])
    assert res.exit_code == 0, res.output
    assert runpipeline.manager is not None and runpipeline.manager.device == "cpu"
    with open(runs["torch"][1]) as f:
        conf = yaml.safe_load(f)
    conf["config"]["timestream_directory"] = str(tmp_path)
    cfg = tmp_path / "pipe.yaml"
    cfg.write_text(yaml.safe_dump(conf))
    res = CliRunner().invoke(runpipeline._cli(), ["queue-config", str(cfg), "--nosubmit"])
    assert res.exit_code == 0, res.output
    script = (tmp_path / "queue" / "jobscript.sh").read_text()
    assert f"-m driftscan_tpu_torch.scripts.runpipeline run-config {tmp_path}/queue/config.yaml" in script


def test_runs_on_the_card_by_default(runs):
    """With no device named the pipeline loads its products on the card:
    on a host without one it fails at once."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would use it")
    with pytest.raises(RuntimeError, match="CUDA"):
        runpipeline.run_config(runs["torch"][1])
