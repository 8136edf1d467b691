"""driftscan_tpu_torch stands alone: no JAX anywhere; no h5py/yaml/click on
the resident path; h5py only behind util.store, yaml and click only inside
the functions that read a YAML file or build the command line.

``tests/conftest.py`` imports jax in the test process, so the import check
runs in a subprocess.
"""

import os
import re
import subprocess
import sys

import pytest

from driftscan_tpu_torch.core import telescope
from driftscan_tpu_torch.telescope import cylinder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "driftscan_tpu_torch",
    "driftscan_tpu_torch.backend",
    "driftscan_tpu_torch.config",
    "driftscan_tpu_torch.core.cosmology",
    "driftscan_tpu_torch.core.skymodel",
    "driftscan_tpu_torch.core.telescope",
    "driftscan_tpu_torch.core.visibility",
    "driftscan_tpu_torch.engine_picks",
    "driftscan_tpu_torch.experiments.k14_ablations",
    "driftscan_tpu_torch.experiments.k14_m_ranges",
    "driftscan_tpu_torch.experiments.map_rounding",
    "driftscan_tpu_torch.experiments.ns1b_window",
    "driftscan_tpu_torch.experiments.ns2_btm_breakdown",
    "driftscan_tpu_torch.experiments.ns2_retained",
    "driftscan_tpu_torch.experiments.double_grids",
    "driftscan_tpu_torch.experiments.probe_breakdown",
    "driftscan_tpu_torch.experiments.probe_tiles",
    "driftscan_tpu_torch.experiments.topband_lock",
    "driftscan_tpu_torch.experiments.k17_tiles",
    "driftscan_tpu_torch.experiments.k4_ablations",
    "driftscan_tpu_torch.experiments.k4_turns",
    "driftscan_tpu_torch.ops.cheb",
    "driftscan_tpu_torch.ops.fpencil",
    "driftscan_tpu_torch.ops.healpix",
    "driftscan_tpu_torch.ops.kernels",
    "driftscan_tpu_torch.ops.linalg",
    "driftscan_tpu_torch.ops.probe",
    "driftscan_tpu_torch.ops.projections",
    "driftscan_tpu_torch.ops.sht",
    "driftscan_tpu_torch.parallel.comm",
    "driftscan_tpu_torch.parallel.mesh",
    "driftscan_tpu_torch.parallel.mstep",
    "driftscan_tpu_torch.parallel.resident",
    "driftscan_tpu_torch.telescope.beamlib",
    "driftscan_tpu_torch.telescope.cylbeam",
    "driftscan_tpu_torch.telescope.cylinder",
    "driftscan_tpu_torch.telescope.disharray",
    "driftscan_tpu_torch.telescope.exotic_cylinder",
    "driftscan_tpu_torch.telescope.focalplane",
    "driftscan_tpu_torch.telescope.gmrt",
    "driftscan_tpu_torch.telescope.oldcylinder",
    "driftscan_tpu_torch.telescope.restrictedcylinder",
    "driftscan_tpu_torch.util.plotutil",
    "driftscan_tpu_torch.util.util",
    "chip_smoke",
]

# the file pipelines (products and timestreams): files go through util.store
# (h5py where it imports)
FILE_MODULES = [
    "driftscan_tpu_torch.core.beamtransfer",
    "driftscan_tpu_torch.core.crosspower",
    "driftscan_tpu_torch.core.doublekl",
    "driftscan_tpu_torch.core.kltransform",
    "driftscan_tpu_torch.core.manager",
    "driftscan_tpu_torch.core.psestimation",
    "driftscan_tpu_torch.core.psmc",
    "driftscan_tpu_torch.examples.disharray_driver",
    "driftscan_tpu_torch.ops.bitshuffle",
    "driftscan_tpu_torch.ops.truncate",
    "driftscan_tpu_torch.pipeline",
    "driftscan_tpu_torch.pipeline.pipeline",
    "driftscan_tpu_torch.pipeline.timestream",
    "driftscan_tpu_torch.scripts.makeproducts",
    "driftscan_tpu_torch.scripts.runpipeline",
    "driftscan_tpu_torch.util.store",
]


def _import_check(modules, banned):
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in {banned!r} if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_slice_imports_no_jax():
    _import_check(
        SLICE_MODULES, ("jax", "jaxlib", "driftscan_tpu", "h5py", "yaml", "click")
    )


def test_file_pipeline_imports_no_jax():
    """Every module of the package, the file pipeline included: no JAX,
    nothing of the JAX package, and no yaml or click at import."""
    _import_check(
        SLICE_MODULES + FILE_MODULES, ("jax", "jaxlib", "driftscan_tpu", "yaml", "click")
    )


def test_port_imports_no_triton():
    """The port's kernels are CUDA C++ built by nvcc: no module of the
    package, nor chip_smoke.py, imports triton, at import or inside a
    function."""
    _import_check(SLICE_MODULES + FILE_MODULES, ("triton",))
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(os.path.join(REPO, "driftscan_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not the package
        sources += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not re.search(r"^\s*(import|from)\s+triton\b", text, re.M), path


def test_every_module_is_listed():
    """The two lists above cover every module of the package."""
    import pkgutil

    import driftscan_tpu_torch

    found = {"driftscan_tpu_torch"} | {
        m.name
        for m in pkgutil.walk_packages(driftscan_tpu_torch.__path__, "driftscan_tpu_torch.")
        if not m.ispkg and ".csrc." not in m.name
    }
    assert found <= set(SLICE_MODULES + FILE_MODULES), found - set(SLICE_MODULES + FILE_MODULES)


def test_telescope_defaults_to_the_card():
    """The port's entry points build on the card unless asked for the CPU;
    from_config reads only the config, so this holds on a host without
    CUDA (the first device tensor is made later)."""
    tel = cylinder.UnpolarisedCylinderTelescope.from_config(dict(num_freq=2))
    assert tel.device.type == "cuda"
    ptel = cylinder.PolarisedCylinderTelescope.from_config(dict(num_freq=2))
    assert ptel.device.type == "cuda"
    assert cylinder.UnpolarisedCylinderTelescope.from_config(
        dict(num_freq=2), device="cpu"
    ).device.type == "cpu"


@pytest.mark.parametrize("cap", ["-4", "48", "3", "abc"])
def test_nside_cap_rejects_bad_values(cap, monkeypatch):
    tel = cylinder.UnpolarisedCylinderTelescope.from_config(dict(num_freq=2), device="cpu")
    monkeypatch.setenv("DRIFTSCAN_TPU_NSIDE_CAP", cap)
    with pytest.raises(ValueError):
        tel._nside_for(300)


@pytest.mark.parametrize("cap,lmax,want", [("0", 300, 512), ("256", 300, 256), ("64", 300, 256)])
def test_nside_cap_clamps(cap, lmax, want, monkeypatch):
    tel = cylinder.UnpolarisedCylinderTelescope.from_config(dict(num_freq=2), device="cpu")
    monkeypatch.setenv("DRIFTSCAN_TPU_NSIDE_CAP", cap)
    assert telescope.nside_cap() == int(cap)
    assert tel._nside_for(lmax) == want
