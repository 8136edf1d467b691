"""Focal-plane (multi-beam single dish) array.

Port of ``driftscan_tpu/telescope/focalplane.py``: a regular grid of sky
pointings from a single aperture, Gaussian or top-hat ("square") beams,
and uniqueness by beam only (each pointing auto-correlates with itself;
there are no interferometric baselines).  Its beams are evaluated on the
host (K2-host maps).
"""

from __future__ import annotations

import numpy as np

from .. import config
from ..core import telescope
from ..util import util
from . import beamlib

C_LIGHT = telescope.C_LIGHT

# re-exported: historical import location
jinc = beamlib.jinc
beam_circular = beamlib.beam_circular


def gaussian_beam(angpos, pointing, fwhm):
    """Gaussian beam of given FWHM (degrees) about a pointing."""
    return beamlib.beam_gaussian(angpos, pointing, beamlib.fwhm_to_sigma(fwhm))


class FocalPlaneArray(telescope.UnpolarisedTelescope):
    """Grid of Gaussian or square beams on the sky from one dish."""

    beam_num_u = config.Property(proptype=int, default=10)
    beam_num_v = config.Property(proptype=int, default=10)

    beam_spacing_u = config.Property(proptype=float, default=0.1)
    beam_spacing_v = config.Property(proptype=float, default=0.1)

    beam_size = config.Property(proptype=float, default=0.1)
    beam_pivot = config.Property(proptype=float, default=400.0)

    beam_freq_scale = config.Property(proptype=bool, default=True)

    square_beam = config.Property(proptype=bool, default=False)

    @property
    def beam_pointings(self):
        """(nfeed, 2) spherical pointings: a centred (u, v) grid offset
        from the zenith, in degrees of spacing."""

        def centred(n, spacing):
            return np.radians(spacing * (np.arange(n) - (n - 1) / 2.0))

        phi = centred(self.beam_num_u, self.beam_spacing_u) + self.zenith[1]
        theta = centred(self.beam_num_v, self.beam_spacing_v) + self.zenith[0]

        # u-major ordering: all v pointings of the first u column first
        tt, pp = np.meshgrid(theta, phi)
        return np.stack([tt.ravel(), pp.ravel()], axis=-1)

    def _fwhm_at(self, freq):
        if not self.beam_freq_scale:
            return self.beam_size
        return self.beam_size * self.frequencies[freq] / self.beam_pivot

    @util.cache_last
    def beam_gaussian(self, feed, freq):
        return gaussian_beam(self._angpos, self.beam_pointings[feed], self._fwhm_at(freq))

    @util.cache_last
    def beam_square(self, feed, freq):
        offset = self._angpos - self.beam_pointings[feed]
        # wrap phi offsets past pi back into (-pi, pi]
        wrap = offset[:, 1] >= np.pi
        offset[wrap, 1] -= 2 * np.pi
        inside = np.abs(offset) < 0.5 * np.radians(self.beam_size)
        return (inside[:, 0] & inside[:, 1]).astype(np.float64)

    def beam(self, feed, freq):
        return (
            self.beam_square(feed, freq)
            if self.square_beam
            else self.beam_gaussian(feed, freq)
        )

    @property
    def dish_width(self):
        pivot_wavelength = C_LIGHT / self.beam_pivot * 1e-6
        return pivot_wavelength / np.radians(self.beam_size)

    u_width = dish_width
    v_width = dish_width

    @property
    def nfeed(self):
        return self.beam_num_u * self.beam_num_v

    @property
    def beamclass(self):
        """Every pointing is its own beam class."""
        return np.arange(self.nfeed, dtype=np.int64)

    @property
    def feedpositions(self):
        """Feed positions (all zero in an FPA)."""
        return np.zeros([self.nfeed, 2])

    def _unique_beams(self):
        """Beams pair only with themselves (autos of each pointing)."""
        auto_mask = np.identity(self.nfeed, dtype=bool)
        beam_map = telescope._label_classes(auto_mask, np.diag(np.arange(self.nfeed)))
        return beam_map, auto_mask
