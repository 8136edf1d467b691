"""GMRT dish array model.

Port of ``driftscan_tpu/telescope/gmrt.py``: the real 30-dish layout (the
port's own copy of ``gmrtpositions.dat``, package data), a Gaussian
primary beam scaled from 150 MHz, Tsys = 582 K and a 600 m maximum
baseline cut.  Its beams are evaluated on the host (K2-host maps).
"""

from __future__ import annotations

import os.path

import numpy as np

from .. import config
from ..core import telescope
from . import beamlib

# re-exported: historical import location
jinc = beamlib.jinc
beam_circular = beamlib.beam_circular

_POSITIONS_FILE = os.path.join(os.path.dirname(__file__), "gmrtpositions.dat")

# Site and instrument constants (public GMRT parameters).
_GMRT_LATITUDE = 19.09
_GMRT_LONGITUDE = 74.05


class GmrtArray(beamlib.MemoisedBeam, telescope.TransitTelescope):
    """The GMRT 30-dish array with a Gaussian primary beam."""

    fwhm = 3.1  # beam FWHM in degrees at 150 MHz

    freq_lower = 139.33
    freq_upper = 156.00
    num_freq = 64

    pointing = config.Property(proptype=float, default=0.0)

    dish_width = 45.0
    tsys_flat = 582.0
    minlength = 0.0
    maxlength = 600.0

    _positions = None

    def __init__(self, pointing=0.0, device="cuda"):
        super().__init__(latitude=_GMRT_LATITUDE, longitude=_GMRT_LONGITUDE, device=device)
        self._positions = np.loadtxt(_POSITIONS_FILE)
        self.pointing = pointing

    @property
    def u_width(self):
        return self.dish_width

    @property
    def v_width(self):
        return self.dish_width

    @property
    def pointing_direction(self):
        """Spherical direction `pointing` degrees from zenith in declination."""
        return np.array([np.pi / 2.0 - np.radians(self.pointing), self.zenith[1]])

    def beam(self, feed, freq):
        def build():
            sigma = beamlib.fwhm_to_sigma(self.fwhm) / (self.frequencies[freq] / 150.0)
            return beamlib.beam_gaussian(self._angpos, self.pointing_direction, sigma)

        return self._memo_beam(build, freq)

    beamx = beam
    beamy = beam

    @property
    def _single_feedpositions(self):
        if self._positions is None:
            self._positions = np.loadtxt(_POSITIONS_FILE)
        return self._positions


class GmrtUnpolarised(GmrtArray, telescope.SimpleUnpolarisedTelescope):
    """Unpolarised GMRT."""
