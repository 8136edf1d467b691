"""Simple grid-of-dishes interferometer with an Airy (jinc) beam.

Port of ``driftscan_tpu/telescope/disharray.py``: a gridu x gridv square
grid of identical circular dishes at one-dish-width spacing.  Its beams
are evaluated on the host (K2-host maps).
"""

from __future__ import annotations

import numpy as np

from ..core import telescope
from . import beamlib

# re-exported: historical import location
jinc = beamlib.jinc
beam_circular = beamlib.beam_circular


class DishArray(beamlib.MemoisedBeam, telescope.SimpleUnpolarisedTelescope):
    """A rectangular grid of identical circular dishes."""

    dish_width = 3.5

    gridu = 4
    gridv = 4

    freq_lower = 1000.0
    freq_upper = 1200.0
    num_freq = 100

    @property
    def u_width(self):
        return self.dish_width

    @property
    def v_width(self):
        return self.dish_width

    def beam(self, feed, freq):
        return self._memo_beam(
            lambda: beamlib.beam_circular(
                self._angpos,
                self.zenith,
                self.dish_width / self.wavelengths[freq],
            ),
            freq,
        )

    beamx = beam
    beamy = beam

    @property
    def _single_feedpositions(self):
        gu, gv = np.mgrid[: self.gridu, : self.gridv]
        return self.dish_width * np.stack([gu.ravel(), gv.ravel()], axis=-1).astype(
            np.float64
        )
