"""Cylinders with a restricted declination strip.

Port of ``driftscan_tpu/telescope/restrictedcylinder.py``: a Gaussian or
box mask in zenith distance multiplies the cylinder beams.  The classes
override the beam, so their beams are evaluated on the host and their
maps take the K2-host kernel.
"""

from __future__ import annotations

import numpy as np

from .. import config
from . import cylinder, exotic_cylinder


def gaussian_fwhm(x, fwhm):
    """Unit-peak Gaussian parameterised by its full width at half maximum."""
    sigma2 = fwhm**2 / (8.0 * np.log(2.0))
    return np.exp(-(x**2) / (2.0 * sigma2))


class RestrictedBeam(cylinder.CylinderTelescope):
    """Mixin: a declination-strip envelope multiplying the cylinder beam.

    ``beam_height`` is the strip's angular size in degrees; ``beam_type``
    selects a Gaussian (FWHM = beam_height) or a hard box.
    """

    beam_height = config.Property(proptype=float, default=30.0)
    beam_type = config.Property(proptype=str, default="box")

    def _zenith_distance(self):
        """|theta - theta_zenith| per pixel, with the azimuth branch cut
        resolved as the reference does (phi wrapped past pi)."""
        delta = self._angpos - self.zenith[np.newaxis, :]
        wrap = delta[:, 1] >= np.pi
        return np.abs(np.where(wrap[:, np.newaxis], delta - [0.0, 2 * np.pi], delta))[:, 0]

    def _bmask(self, feed, freq):
        height = np.radians(self.beam_height)
        zd = self._zenith_distance()
        if self.beam_type == "gaussian":
            return gaussian_fwhm(zd, height)
        if self.beam_type == "box":
            return (zd < 0.5 * height).astype(np.float64)
        raise ValueError(f"Unknown beam_type {self.beam_type!r}")

    # Reference API names (bmask_gaussian / bmask_box)
    def bmask_gaussian(self, feed, freq):
        return gaussian_fwhm(self._zenith_distance(), np.radians(self.beam_height))

    def bmask_box(self, feed, freq):
        zd = self._zenith_distance()
        return (zd < 0.5 * np.radians(self.beam_height)).astype(np.float64)


class RestrictedCylinder(RestrictedBeam, cylinder.UnpolarisedCylinderTelescope):
    def beam(self, feed, freq):
        base = cylinder.UnpolarisedCylinderTelescope.beam(self, feed, freq)
        return self._bmask(feed, freq) * np.asarray(base)


class RestrictedPolarisedCylinder(RestrictedBeam, cylinder.PolarisedCylinderTelescope):
    def beamx(self, feed, freq):
        base = cylinder.PolarisedCylinderTelescope.beamx(self, feed, freq)
        return self._bmask(feed, freq)[:, np.newaxis] * np.asarray(base)

    def beamy(self, feed, freq):
        base = cylinder.PolarisedCylinderTelescope.beamy(self, feed, freq)
        return self._bmask(feed, freq)[:, np.newaxis] * np.asarray(base)


class RestrictedExtra(RestrictedCylinder):
    """Restricted cylinder with extra irregularly placed feeds."""

    extra_feeds = config.Property(proptype=np.array, default=np.zeros(0))

    def feed_positions_cylinder(self, cylinder_index):
        regular = super().feed_positions_cylinder(cylinder_index)
        extra = exotic_cylinder._column(
            cylinder_index, self.cylinder_spacing, self.extra_feeds
        )
        return np.concatenate([extra, regular], axis=0)
