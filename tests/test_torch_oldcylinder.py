"""The legacy sinc-beam cylinders (``telescope/oldcylinder.py``) of the port
against the JAX package's, float64 on the CPU.

Small cylinders (2 x 2 feeds, 2 channels; lmax 26, nside 32) of both
classes: ``beam``, ``beamx`` and ``beamy`` (orthogonal and projected
polarisation axes, unequal illuminations) on the sky grid, rel 1e-12 of
max; then the BTM tables of every unit through ``resident.btm_resident``
in both packages, 1e-10 of max.  The port evaluates these beams on the
host and takes the host-beam map kernels (K2-host, scalar or Stokes): the
bank gate says no.  The class is reached by the manager's plugin form, as
in the JAX package; neither registry names it.
"""

import numpy as np
import pytest
import torch

from driftscan_tpu.ops import zarray as za
from driftscan_tpu.parallel import resident as jres
from driftscan_tpu.telescope import oldcylinder as jold
from driftscan_tpu_torch.core import manager
from driftscan_tpu_torch.parallel import resident
from driftscan_tpu_torch.telescope import oldcylinder

CFG = dict(num_freq=2, freq_start=400.0, freq_end=420.0, freq_mode="edge",
           num_cylinders=2, cylinder_width=1.5, num_feeds=2, feed_spacing=0.5,
           tsys=50.0, single_precision=False)
POL_CFGS = {
    "ortho": dict(CFG, illumination_x=1.0, illumination_y=0.8),
    "projected": dict(CFG, illumination_x=0.9, illumination_y=1.2, ortho_pol=False),
}
CLASSES = {"unpol": "UnpolarisedCylinderTelescope", "pol": "PolarisedCylinderTelescope"}


def _pair(name, cfg):
    jt = getattr(jold, CLASSES[name]).from_config(cfg)
    tt = getattr(oldcylinder, CLASSES[name]).from_config(cfg, device="cpu")
    return jt, tt


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


def test_layout_matches():
    jt, tt = _pair("pol", POL_CFGS["ortho"])
    assert (tt.lmax, tt.mmax, tt.npairs, tt.num_pol_sky) == (jt.lmax, jt.mmax, jt.npairs, 4)
    np.testing.assert_array_equal(tt.feedpositions, jt.feedpositions)
    np.testing.assert_array_equal(tt.uniquepairs, jt.uniquepairs)
    assert tt._nside_for(tt.lmax) == jt._nside_for(jt.lmax) == 32


def test_unpolarised_beam():
    jt, tt = _pair("unpol", CFG)
    for t in (jt, tt):
        t._init_trans(16)
    for fi in range(tt.nfreq):
        _close(tt.beam(0, fi), jt.beam(0, fi), 1e-12)


@pytest.mark.parametrize("which", sorted(POL_CFGS))
def test_polarised_beams(which):
    jt, tt = _pair("pol", POL_CFGS[which])
    for t in (jt, tt):
        t._init_trans(16)
    for fi in range(tt.nfreq):
        bx, by = tt.beamx(0, fi), tt.beamy(0, fi)
        assert bx.shape == by.shape == (12 * 16**2, 2)
        _close(bx, jt.beamx(0, fi), 1e-12)
        _close(by, jt.beamy(0, fi), 1e-12)
        # the dispatch on the feed's polarisation
        _close(tt.beam(tt.nfeed - 1, fi), jt.beam(jt.nfeed - 1, fi), 1e-12)


def test_host_beams_not_the_bank():
    for name in CLASSES:
        tt = getattr(oldcylinder, CLASSES[name]).from_config(
            dict(CFG, single_precision=True), device="cpu")
        assert not tt._bank_beams_apply()


@pytest.mark.parametrize("name,which", [("unpol", "ortho"), ("pol", "ortho"),
                                        ("pol", "projected")])
def test_btm_tables_match(name, which):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        jt, tt = _pair(name, POL_CFGS[which] if name == "pol" else CFG)
        bl, fi = [x.ravel() for x in np.meshgrid(np.arange(tt.npairs), np.arange(tt.nfreq),
                                                 indexing="ij")]
        jp, jn = jres.btm_resident(jt, bl, fi)
        tp, tn = resident.btm_resident(tt, bl, fi)
    finally:
        torch.set_num_threads(before)
    jp, jn = za.to_numpy(jp), za.to_numpy(jn)
    assert tp.dtype == torch.complex128
    assert np.abs(jp).max() > 0
    _close(tp.numpy(), jp, 1e-10)
    _close(tn.numpy(), jn, 1e-10)


def test_plugin_form(tmp_path):
    """``type: {module, class}`` reaches the class; the registry does not."""
    conf = {"config": {"output_directory": str(tmp_path / "out")},
            "telescope": dict(CFG, type={"module": "driftscan_tpu_torch.telescope.oldcylinder",
                                         "class": "PolarisedCylinderTelescope"})}
    m = manager.ProductManager(device="cpu").apply_config(conf)
    assert type(m.telescope) is oldcylinder.PolarisedCylinderTelescope
    assert oldcylinder.PolarisedCylinderTelescope not in manager._telescope_registry().entries.values()
