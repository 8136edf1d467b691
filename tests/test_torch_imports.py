"""driftscan_tpu_torch stands alone: no JAX (or h5py/yaml/click) on its slice.

``tests/conftest.py`` imports jax in the test process, so the import check
runs in a subprocess.
"""

import os
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
    "driftscan_tpu_torch.core.psestimation",
    "driftscan_tpu_torch.core.skymodel",
    "driftscan_tpu_torch.core.telescope",
    "driftscan_tpu_torch.ops.fpencil",
    "driftscan_tpu_torch.ops.healpix",
    "driftscan_tpu_torch.ops.kernels",
    "driftscan_tpu_torch.ops.linalg",
    "driftscan_tpu_torch.ops.probe",
    "driftscan_tpu_torch.ops.sht",
    "driftscan_tpu_torch.parallel.mstep",
    "driftscan_tpu_torch.parallel.resident",
    "driftscan_tpu_torch.telescope.cylbeam",
    "driftscan_tpu_torch.telescope.cylinder",
    "chip_smoke",
]


def test_slice_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'jaxlib', 'driftscan_tpu', 'h5py', 'yaml', 'click')"
        " if m in sys.modules]\n"
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


@pytest.mark.parametrize("cap", ["-4", "48", "3", "abc"])
def test_nside_cap_rejects_bad_values(cap, monkeypatch):
    tel = cylinder.UnpolarisedCylinderTelescope.from_config(dict(num_freq=2))
    monkeypatch.setenv("DRIFTSCAN_TPU_NSIDE_CAP", cap)
    with pytest.raises(ValueError):
        tel._nside_for(300)


@pytest.mark.parametrize("cap,lmax,want", [("0", 300, 512), ("256", 300, 256), ("64", 300, 256)])
def test_nside_cap_clamps(cap, lmax, want, monkeypatch):
    tel = cylinder.UnpolarisedCylinderTelescope.from_config(dict(num_freq=2))
    monkeypatch.setenv("DRIFTSCAN_TPU_NSIDE_CAP", cap)
    assert telescope.nside_cap() == int(cap)
    assert tel._nside_for(lmax) == want
