"""Shared primary-beam building blocks for the dish-style telescopes.

Port of ``driftscan_tpu/telescope/beamlib.py``: Airy (jinc) patterns for
uniform circular apertures and Gaussian beams, evaluated on the host
(numpy, float64) over the compact sky grid, plus a per-(freq, nside)
memoisation mixin.  Used by the dish-array, GMRT and focal-plane models.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import j1

from ..ops import kernels


def jinc(x):
    """Radial profile of a uniform circular aperture.

    The JAX package's (J0(x) + J2(x)) / 2, which the Bessel recurrence
    makes J1(x) / x (1/2 at x = 0): scipy's J1 instead of two general-order
    ``jn`` calls, which dominated the host-beam evaluation of a dish array.
    """
    x = np.asarray(x, dtype=np.float64)
    safe = np.where(x == 0.0, 1.0, x)
    return np.where(x == 0.0, 0.5, j1(safe) / safe)


def _cart(sph):
    return kernels.sph_to_cart(torch.as_tensor(np.asarray(sph, dtype=np.float64))).numpy()


def sin_offset(angpos, centre):
    """sin of the angle between each position and a centre direction."""
    c = _cart(angpos) @ _cart(centre)
    return np.sqrt(np.maximum(1.0 - c * c, 0.0))


def beam_circular(angpos, zenith, uv_diameter):
    """Airy beam of a circular dish of ``uv_diameter`` wavelengths."""
    return 2 * jinc(np.pi * uv_diameter * sin_offset(angpos, zenith))


def beam_gaussian(angpos, pointing, sigma):
    """Gaussian beam of width ``sigma`` (radians) about a pointing."""
    s = sin_offset(angpos, pointing)
    return np.exp(-(s * s) / (4 * sigma**2))


def fwhm_to_sigma(fwhm_deg):
    """Gaussian sigma (radians) from a FWHM in degrees."""
    return np.radians(fwhm_deg) / np.sqrt(8.0 * np.log(2.0))


class MemoisedBeam:
    """Cache the most recent beam map, keyed on (freq index, nside).

    Dish beams depend only on frequency (not feed), so the transfer-matrix code
    re-requests the identical map for every feed; recomputing it per feed
    would dominate the host time.
    """

    _beam_key = None
    _beam_map = None

    def _memo_beam(self, build, freq):
        key = (freq, self._nside)
        if self._beam_key != key:
            self._beam_map = build()
            self._beam_key = key
        return self._beam_map
