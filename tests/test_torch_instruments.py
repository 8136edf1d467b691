"""The host-beam telescopes of driftscan_tpu_torch against the JAX package.

Every telescope whose beams are evaluated on the host (dish array, GMRT,
focal plane, the restricted and exotic cylinders, and a cylinder subclass
that overrides its beam) runs in float64 on the CPU in both packages: the
beams of a few (feed, freq) on the compact grid, then the transfer
matrices of every (baseline, frequency) unit.  The port's K2-host kernel
runs its plain version.  Tolerance: 1e-10 of the largest entry (both
packages evaluate the same float64 formulas; rounding differs by ~1e-15).

The cylinder that overrides its beam is fault 1's regression test: the
port used to take every cylinder beam from its bank and so ignored the
override.  In single precision the JAX package sends it to the host,
and so does the port: the BTM matches the JAX package's at 1e-5 of max
(float32) and differs from the base class's.

The plain K2-host forms are also held against the JAX package's
``unpol_visibility_map`` / ``stokes_visibility_map`` on seeded complex
beams at 1e-10 of max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driftscan_tpu.core import manager as jmanager
from driftscan_tpu.ops import kernels as jkernels
from driftscan_tpu.telescope import cylbeam as jcylbeam
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.core import manager
from driftscan_tpu_torch.ops import healpix, kernels
from driftscan_tpu_torch.telescope import cylbeam, cylinder

RTOL = 1e-10

CYL = dict(
    num_freq=2,
    freq_start=400.0,
    freq_end=410.0,
    freq_mode="edge",
    num_cylinders=2,
    cylinder_width=3.0,
    num_feeds=2,
    feed_spacing=1.0,
)

# (registry name, config): small enough for a CPU BTM at nside <= 64
CASES = {
    "DishArray": dict(num_freq=2, freq_lower=100.0, freq_upper=102.0),
    "GMRT": dict(num_freq=2, freq_lower=10.0, freq_upper=12.0, maxlength=110.0),
    "FocalPlane": dict(
        num_freq=2, freq_lower=100.0, freq_upper=102.0, beam_num_u=2, beam_num_v=2,
        beam_spacing_u=6.0, beam_spacing_v=6.0, beam_size=10.0, auto_correlations=True,
    ),
    "FocalPlaneSquare": dict(
        num_freq=2, freq_lower=100.0, freq_upper=102.0, beam_num_u=2, beam_num_v=1,
        beam_spacing_u=8.0, beam_size=10.0, square_beam=True, beam_freq_scale=False,
        auto_correlations=True,
    ),
    "RestrictedCylinder": dict(CYL, beam_type="gaussian", beam_height=40.0),
    "RestrictedPolarisedCylinder": dict(CYL, beam_type="box", beam_height=50.0),
    "RestrictedExtra": dict(CYL, beam_type="box", extra_feeds=[0.4]),
    "GradientCylinder": dict(CYL, num_feeds=3, max_spacing=2.0),
    "PertCylinder": dict(CYL, num_cylinders=1),
}


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(name):
    conf = dict(CASES[name])
    kind = "FocalPlane" if name.startswith("FocalPlane") else name
    jt = jmanager._telescope_registry().resolve(kind).from_config(conf)
    tt = manager._telescope_registry().resolve(kind).from_config(conf, device="cpu")
    return jt, tt


def _units(tel):
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    return [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def test_registry_has_every_jax_telescope():
    names = set(jmanager._telescope_registry().entries)
    assert names == set(manager._telescope_registry().entries)
    assert len(names) == 10


@pytest.mark.parametrize("name", sorted(CASES))
def test_beams_match_jax(name):
    jt, tt = _pair(name)
    assert not tt._bank_beams_apply()
    assert tt.npairs == jt.npairs and tt.lmax == jt.lmax and tt.mmax == jt.mmax
    np.testing.assert_array_equal(tt.feedpositions, jt.feedpositions)
    np.testing.assert_array_equal(tt.beamclass, jt.beamclass)
    ns = jt._nside_for(jt.lmax)
    jt._init_trans(ns)
    tt._init_trans(ns)
    np.testing.assert_array_equal(tt._angpos, jt._angpos)
    np.testing.assert_array_equal(tt._ring_pad_index, jt._ring_pad_index)
    np.testing.assert_array_equal(tt._ring_pad_mask, jt._ring_pad_mask)
    for feed in sorted({0, tt.nfeed - 1}):
        for fi in range(tt.nfreq):
            _close(tt.beam(feed, fi), jt.beam(feed, fi))


@pytest.mark.parametrize("name", sorted(CASES))
def test_transfer_matrices_match_jax(name):
    jt, tt = _pair(name)
    blg, fig = _units(jt)
    _close(tt.transfer_matrices(blg, fig), jt.transfer_matrices(blg, fig))


def test_transfer_for_frequency_and_baseline():
    jt, tt = _pair("RestrictedCylinder")
    _close(tt.transfer_for_frequency(1), jt.transfer_for_frequency(1))
    _close(tt.transfer_for_baseline(0), jt.transfer_for_baseline(0))


def _ripple(beam_fn):
    """A subclass beam: the stock beam times a ripple across the sky."""

    def beam(self, feed, freq):
        base = np.asarray(beam_fn(self, feed, freq))
        return base * (1.0 + 0.5 * np.cos(3.0 * self._angpos[:, 1]))

    return beam


class TorchRipple(cylinder.UnpolarisedCylinderTelescope):
    beam = _ripple(cylinder.UnpolarisedCylinderTelescope.beam)


class JaxRipple(jcyl.UnpolarisedCylinderTelescope):
    beam = _ripple(jcyl.UnpolarisedCylinderTelescope.beam)


@pytest.mark.parametrize("single", [False, True])
def test_beam_override_is_honoured(single):
    """A cylinder subclass that overrides ``beam`` gets its own BTM (the
    JAX package's), in either precision, not the base class's."""
    conf = dict(CYL, single_precision=single)
    jt = JaxRipple.from_config(conf)
    tt = TorchRipple.from_config(conf, device="cpu")
    base = cylinder.UnpolarisedCylinderTelescope.from_config(conf, device="cpu")
    assert not tt._bank_beams_apply()
    assert base._bank_beams_apply() == single
    blg, fig = _units(jt)
    want = jt.transfer_matrices(blg, fig)
    got = tt.transfer_matrices(blg, fig)
    _close(got, want, rtol=1e-5 if single else RTOL)
    stock = base.transfer_matrices(blg, fig)
    assert np.abs(stock - want).max() > 1e-2 * np.abs(want).max()


def test_feed_beam_override_goes_to_the_host():
    class Wider(cylinder.PolarisedCylinderTelescope):
        def _feed_beam(self, pattern, freq, fwhm_ew, fwhm_ns):
            return super()._feed_beam(pattern, freq, 1.2 * fwhm_ew, fwhm_ns)

    conf = dict(CYL, single_precision=True)
    assert cylinder.PolarisedCylinderTelescope.from_config(conf, device="cpu")._bank_beams_apply()
    assert not Wider.from_config(conf, device="cpu")._bank_beams_apply()


def test_host_beam_caches():
    """Host beams are cached by (nside, freq, beamclass) within their
    budget; device beams are padded with zeros and kept in an LRU cache."""
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(dict(CYL), device="cpu")
    ns = tt._nside_for(tt.lmax)
    tt._init_trans(ns)
    b0 = tt._beam(0, 0)
    assert tt._beam(1, 0) is b0 and tt._beam(0, 1) is not b0
    dev = tt._beam_device(0, 0)
    assert dev.shape == tt._horizon.shape and dev.dtype == torch.float64
    pad = ~tt._ring_pad_mask.astype(bool)
    assert pad.any() and float(dev[torch.as_tensor(pad)].abs().max()) == 0.0
    np.testing.assert_array_equal(
        dev.numpy()[~pad], b0[tt._ring_pad_index[~pad]]
    )
    tt._beam_dev_budget = 2 * dev.numel() * 8
    tt._beam_device(0, 1)
    tt._beam_device(0, 0)  # a hit moves it last
    tt._init_trans(ns // 2)
    tt._beam_device(0, 0)  # evicts the least recently used: (ns, freq 1)
    assert list(tt._beam_dev_cache) == [(ns, 0, 0), (ns // 2, 0, 0)]
    tt.beam_cache_size = 0
    tt._beam(0, 1)
    assert len(tt._beam_cache) == 1


def test_single_precision_host_beams_are_float32():
    tt = manager._telescope_registry().resolve("DishArray").from_config(
        dict(CASES["DishArray"], single_precision=True), device="cpu"
    )
    tt._init_trans(16)
    assert tt._beam(0, 0).dtype == np.float32
    assert tt._beam_device(0, 0).dtype == torch.float32


def _grid(nside):
    geom = healpix.ring_geometry(nside)
    pix = np.asarray(geom.pix_index).ravel()
    mask = np.asarray(geom.mask).ravel()
    angpos = healpix.ang_positions(nside)[pix]
    cart = kernels.sph_to_cart(torch.as_tensor(angpos))
    zenith = np.array([np.pi / 4, 0.0])
    hor = kernels.horizon_mask(cart, torch.as_tensor(zenith)) * torch.as_tensor(mask)
    return cart, hor, zenith


@pytest.mark.parametrize("stokes", [False, True])
def test_plain_host_kernels_match_jax_with_complex_beams(stokes):
    """host_visibility_maps_ref / host_stokes_maps_ref against the JAX
    package's visibility maps of the same complex beams."""
    nside, nb, nu = 8, 3, 5
    cart, hor, zenith = _grid(nside)
    npix = cart.shape[0]
    rng = np.random.default_rng(11)
    shape = (nb, npix, 2) if stokes else (nb, npix)
    beams = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    ii = rng.integers(0, nb, nu)
    jj = rng.integers(0, nb, nu)
    uv = rng.uniform(-6.0, 6.0, (nu, 2))
    pxarea = 4.0 * np.pi / (12 * nside**2)
    uv3 = kernels.uv_cart(torch.as_tensor(zenith), torch.as_tensor(uv))
    args = (torch.as_tensor(beams), torch.as_tensor(ii), torch.as_tensor(jj), uv3,
            cart, hor, pxarea)
    jfn = jkernels.stokes_visibility_map if stokes else jkernels.unpol_visibility_map
    want = np.asarray(jfn(
        beams[ii], beams[jj], uv, jnp.asarray(zenith), jnp.asarray(cart.numpy()),
        jnp.asarray(hor.numpy()), pxarea=pxarea,
    ))
    if stokes:
        got = kernels.host_stokes_maps(*args)
        _close(got.numpy(), want)
        _close(kernels.host_stokes_maps(*args, npol=3).numpy(), want[:, :3])
    else:
        _close(kernels.host_visibility_maps(*args).numpy(), want)


def test_host_cylinder_beam_functions_match_jax():
    ang = healpix.ang_positions(8)
    zen = np.array([np.pi / 4, 0.0])
    for fn, jfn in ((cylbeam.beam_amp, jcylbeam.beam_amp), (cylbeam.beam_x, jcylbeam.beam_x),
                    (cylbeam.beam_y, jcylbeam.beam_y)):
        _close(fn(ang, zen, 4.0, 1.5, 2.0), np.asarray(jfn(ang, zen, 4.0, 1.5, 2.0)))
    _close(cylbeam.polpattern(ang, [0.3, 0.2]), np.asarray(jcylbeam.polpattern(ang, [0.3, 0.2])))
    th, ph = ang[:, 0], ang[:, 1]
    _close(cylbeam.beam_dipole(th, ph, 0.1), np.asarray(jcylbeam.beam_dipole(th, ph, 0.1)))


def test_beamlib_matches_jax():
    """jinc (as J1(x)/x here, (J0 + J2)/2 in the JAX package, 1/2 at 0)
    and the dish beams, at 1e-10 of max."""
    from driftscan_tpu.telescope import beamlib as jbeamlib
    from driftscan_tpu_torch.telescope import beamlib

    x = np.concatenate([[0.0, 1e-9, -2.5], np.linspace(0.0, 90.0, 20001)])
    _close(beamlib.jinc(x), np.asarray(jbeamlib.jinc(x)))
    assert beamlib.jinc(0.0) == 0.5
    ang = healpix.ang_positions(16)
    zen = np.array([np.pi / 3, 0.2])
    _close(beamlib.beam_circular(ang, zen, 7.0), np.asarray(jbeamlib.beam_circular(ang, zen, 7.0)))
    _close(beamlib.beam_gaussian(ang, zen, 0.1), np.asarray(jbeamlib.beam_gaussian(ang, zen, 0.1)))
    assert beamlib.fwhm_to_sigma(3.1) == jbeamlib.fwhm_to_sigma(3.1)


def test_restricted_beam_masks_match_jax():
    """The RestrictedBeam mixin's masks (its reference API names too)."""
    jt, tt = _pair("RestrictedCylinder")
    ns = 16
    jt._init_trans(ns)
    tt._init_trans(ns)
    for name in ("bmask_gaussian", "bmask_box"):
        _close(getattr(tt, name)(0, 0), np.asarray(getattr(jt, name)(0, 0)))
    _close(tt._bmask(0, 1), np.asarray(jt._bmask(0, 1)))
    tt.beam_type = "other"
    with pytest.raises(ValueError, match="beam_type"):
        tt._bmask(0, 0)
