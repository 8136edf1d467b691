"""Cylinder telescopes.

Port of ``driftscan_tpu/telescope/cylinder.py`` (the unpolarised and the
polarised cylinder): N-S oriented parabolic cylinders, regularly spaced
feeds along each axis, optional exclusion of intra-cylinder baselines,
and Fraunhofer beams (cylbeam).  The config property names are the JAX
package's.

A cylinder takes its beams from the device beam bank (fused with the
maps, K1+K2) only when its beam physics is the stock one and it runs in
single precision (:meth:`CylinderTelescope._bank_beams_apply`, the JAX
package's gate): a subclass that overrides ``beam``, ``beamx``, ``beamy``
or ``_feed_beam`` (a YAML plugin included), and every double-precision
cylinder, evaluates ``beam(feed, freq)`` on the host and takes the K2-host
kernel, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core import telescope
from . import cylbeam

# FWHM of the fiducial dipole illumination (radians); the e/h width
# properties scale it.
_DIPOLE_FWHM = 2.0 * np.pi / 3.0


class CylinderTelescope(telescope.TransitTelescope):
    """Common functionality for N-S oriented cylinder telescopes."""

    num_cylinders = config.Property(proptype=int, default=2)
    num_feeds = config.Property(proptype=int, default=6)

    cylinder_width = config.Property(proptype=float, default=20.0)
    feed_spacing = config.Property(proptype=float, default=0.5)

    in_cylinder = config.Property(proptype=bool, default=True)

    touching = config.Property(proptype=bool, default=True)
    cylspacing = config.Property(proptype=float, default=0.0)

    non_commensurate = config.Property(proptype=bool, default=False)

    e_width = config.Property(proptype=float, default=0.7)
    h_width = config.Property(proptype=float, default=1.0)

    _fwhm_e = _DIPOLE_FWHM
    _fwhm_h = _DIPOLE_FWHM

    @property
    def fwhm_e(self):
        """Full width half max of the E-plane antenna beam."""
        return self._fwhm_e * self.e_width

    @property
    def fwhm_h(self):
        """Full width half max of the H-plane antenna beam."""
        return self._fwhm_h * self.h_width

    @property
    def u_width(self):
        return self.cylinder_width

    @property
    def v_width(self):
        return 0.0

    def _unique_baselines(self):
        """Optionally exclude intra-cylinder (u == 0) baselines."""
        base_map, base_mask = super()._unique_baselines()
        if self.in_cylinder:
            return base_map, base_mask
        du = (
            self.feedpositions[:, np.newaxis, 0]
            - self.feedpositions[np.newaxis, :, 0]
        )
        base_mask = base_mask & (du != 0.0)
        return telescope._remap_keyarray(base_map, base_mask), base_mask

    @property
    def cylinder_spacing(self):
        if self.touching:
            return self.cylinder_width
        if self.cylspacing is None:
            raise ValueError("Need to set cylinder spacing if not touching.")
        return self.cylspacing

    def _cylinder_layout(self, cylinder_index):
        """(nfeed_cyl, spacing) for one cylinder."""
        if self.non_commensurate:
            nf = self.num_feeds - cylinder_index
            return nf, self.feed_spacing * nf / (nf - 1.0)
        return self.num_feeds, self.feed_spacing

    def feed_positions_cylinder(self, cylinder_index):
        """(num_feeds, 2) feed positions on one cylinder."""
        if not 0 <= cylinder_index < self.num_cylinders:
            raise ValueError("Cylinder index is invalid.")
        nf, sp = self._cylinder_layout(cylinder_index)
        x = np.full(nf, cylinder_index * self.cylinder_spacing)
        y = sp * np.arange(nf)
        return np.column_stack([x, y])

    @property
    def _single_feedpositions(self):
        return np.concatenate(
            [self.feed_positions_cylinder(ci) for ci in range(self.num_cylinders)]
        )

    def _feed_beam(self, pattern, freq, fwhm_ew, fwhm_ns):
        """A cylbeam host pattern on the current sky grid at frequency
        index ``freq`` (the cylinder's width in wavelengths)."""
        return pattern(
            self._angpos,
            self.zenith,
            self.cylinder_width / self.wavelengths[freq],
            fwhm_ew,
            fwhm_ns,
        )

    def _bank_beams_apply(self):
        """The bank gate: single precision, and the beam methods and
        ``_feed_beam`` all this package's own (JAX
        ``telescope/cylinder.py:188-224``, ``:233-260``)."""
        cls = type(self)
        if not self.single_precision or cls._feed_beam is not CylinderTelescope._feed_beam:
            return False
        if self.num_pol_sky == 1:
            return cls.beam is UnpolarisedCylinderTelescope.beam
        return (
            cls.beamx is PolarisedCylinderTelescope.beamx
            and cls.beamy is PolarisedCylinderTelescope.beamy
            and cls.beam is telescope.SimplePolarisedTelescope.beam
        )

    _beam_bank = None

    def beam_bank_numpy(self):
        """Host (params (nfreq, C, 12), tables (nfreq, C, nfx)) of the band."""
        return cylbeam.build_beam_bank(
            self.zenith,
            self.cylinder_width / self.wavelengths,
            self.fwhm_e,
            self.fwhm_h,
            polarised=self.num_pol_sky > 1,
            dtype=np.float32 if self.single_precision else np.float64,
        )

    def set_beam_bank(self, params, tables):
        """Install host bank arrays (e.g. the JAX package's
        ``cylbeam.build_beam_bank`` output) as this telescope's device bank."""
        dt = self.real_dtype
        self._beam_bank = (
            torch.as_tensor(np.asarray(params), dtype=dt, device=self.device),
            torch.as_tensor(np.asarray(tables), dtype=dt, device=self.device),
        )

    def _beam_bank_rows(self, freq):
        if self._beam_bank is None:
            self.set_beam_bank(*self.beam_bank_numpy())
        params, tables = self._beam_bank
        return params[freq], tables[freq], self._bank_row_of_class


class UnpolarisedCylinderTelescope(
    CylinderTelescope, telescope.SimpleUnpolarisedTelescope
):
    """Unpolarised cylinder telescope (amplitude beam, fwhm_h both planes)."""

    # the single beamclass 0 is bank row 0
    _bank_row_of_class = {0: 0}

    def beam(self, feed, freq):
        return self._feed_beam(cylbeam.beam_amp, freq, self.fwhm_h, self.fwhm_h)


class PolarisedCylinderTelescope(CylinderTelescope, telescope.SimplePolarisedTelescope):
    """Polarised cylinder telescope with X/Y dipole feeds."""

    # X feeds (beamclass 0) are bank row 0, Y feeds (1) row 1, whose
    # fwhm order is swapped (H-plane east-west)
    _bank_row_of_class = {0: 0, 1: 1}

    def beamx(self, feed, freq):
        return self._feed_beam(cylbeam.beam_x, freq, self.fwhm_e, self.fwhm_h)

    def beamy(self, feed, freq):
        return self._feed_beam(cylbeam.beam_y, freq, self.fwhm_e, self.fwhm_h)
