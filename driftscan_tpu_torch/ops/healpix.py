"""HEALPix RING-scheme geometry in closed form.

The reference gets pixel geometry from healpy (via ``cora.util.hputil``,
called at driftscan's drift/core/telescope.py:948-952).  Only the
*geometry* is needed — the spherical harmonic transform itself is built in
:mod:`driftscan_tpu_torch.ops.sht` — and the RING scheme is closed form
(Gorski et al. 2005), so we compute it directly in numpy on the host and
cache per nside.

Ring layout (rings indexed i = 1 .. 4*nside-1 from the north pole):

* north cap, ``1 <= i < nside``:  4*i pixels, ``z = 1 - i^2/(3 nside^2)``,
  pixel centres at ``phi = (pi/(2 i)) (j + 1/2)``.
* equatorial belt, ``nside <= i <= 3*nside``: 4*nside pixels,
  ``z = 4/3 - 2 i/(3 nside)``, centres at
  ``phi = (pi/(2 nside)) (j + s/2)`` with ``s = (i - nside + 1) mod 2``.
* south cap mirrors the north cap.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np


def npix_for_nside(nside: int) -> int:
    return 12 * nside * nside


def nside_for_lmax(lmax: int, accuracy_boost: float = 1.0) -> int:
    """An nside adequate for spherical harmonics up to ``lmax``.

    Uses the smallest power of two with ``2*nside >= lmax`` and then doubles
    ``accuracy_boost`` times (the reference exposes the same knob,
    driftscan's drift/core/telescope.py:227).
    """
    base = max(int(math.ceil(max(lmax, 1) / 2)), 1)
    nside = 1 << (base - 1).bit_length()
    return int(nside * 2 ** int(round(accuracy_boost)))


@dataclass(frozen=True)
class RingGeometry:
    """Static per-nside geometry tables (host numpy)."""

    nside: int
    npix: int
    nring: int
    maxlen: int
    # Per ring
    theta: np.ndarray  # (nring,) colatitude of ring
    cos_theta: np.ndarray  # (nring,)
    sin_theta: np.ndarray  # (nring,)
    nphi: np.ndarray  # (nring,) pixels in ring
    phi0: np.ndarray  # (nring,) azimuth of first pixel centre
    start: np.ndarray  # (nring,) RING index of first pixel
    # Padded (nring, maxlen) tables for static-shape gathers
    pix_index: np.ndarray  # int32 gather indices (clipped for padding)
    mask: np.ndarray  # float64 1/0 validity
    phi: np.ndarray  # azimuth per (ring, slot), 0 for padding
    # Integer angle tables: phi[r, j] = 2*pi * twoj_h[r, j] / n2[r], exact.
    # Lets m*phi be range-reduced in integer arithmetic so the phase stage
    # runs entirely in f32 without losing accuracy at large m.
    twoj_h: np.ndarray  # int32 (nring, maxlen): 2*j + h_r (h = 2*phi0*n/2pi)
    n2: np.ndarray  # int32 (nring,): 2 * nphi

    @property
    def pixarea(self) -> float:
        return 4.0 * np.pi / self.npix


@functools.lru_cache(maxsize=32)
def ring_geometry(nside: int) -> RingGeometry:
    if nside < 1 or (nside & (nside - 1)) != 0:
        raise ValueError(f"nside must be a positive power of two, got {nside}")

    nring = 4 * nside - 1
    i = np.arange(1, nring + 1)  # ring index from north pole

    ncap = i < nside
    nbelt = (i >= nside) & (i <= 3 * nside)
    scap = i > 3 * nside
    k = 4 * nside - i  # mirror index for the south cap

    z = np.empty(nring, dtype=np.float64)
    z[ncap] = 1.0 - i[ncap] ** 2 / (3.0 * nside**2)
    z[nbelt] = 4.0 / 3.0 - 2.0 * i[nbelt] / (3.0 * nside)
    z[scap] = -(1.0 - k[scap] ** 2 / (3.0 * nside**2))

    nphi = np.empty(nring, dtype=np.int64)
    nphi[ncap] = 4 * i[ncap]
    nphi[nbelt] = 4 * nside
    nphi[scap] = 4 * k[scap]

    phi0 = np.empty(nring, dtype=np.float64)
    phi0[ncap] = np.pi / (4.0 * i[ncap])
    s = (i[nbelt] - nside + 1) % 2
    phi0[nbelt] = np.pi / (4.0 * nside) * s
    phi0[scap] = np.pi / (4.0 * k[scap])

    start = np.concatenate([[0], np.cumsum(nphi)[:-1]])
    npix = int(np.sum(nphi))
    assert npix == npix_for_nside(nside)

    theta = np.arccos(z)
    maxlen = 4 * nside

    j = np.arange(maxlen)[np.newaxis, :]
    valid = j < nphi[:, np.newaxis]
    pix_index = np.where(valid, start[:, np.newaxis] + j, 0).astype(np.int32)
    mask = valid.astype(np.float64)
    dphi = 2.0 * np.pi / nphi.astype(np.float64)
    phi = np.where(valid, phi0[:, np.newaxis] + j * dphi[:, np.newaxis], 0.0)

    # phi0 is always (2*pi / nphi) * (h/2) with h in {0, 1}: recover h
    # exactly and build the integer numerators of phi / (2*pi / (2*nphi)).
    h = np.rint(phi0 * nphi / np.pi).astype(np.int64)
    assert set(np.unique(h)) <= {0, 1}, "unexpected healpix ring offset"
    twoj_h = np.where(valid, 2 * j + h[:, np.newaxis], 0).astype(np.int32)

    return RingGeometry(
        nside=nside,
        npix=npix,
        nring=nring,
        maxlen=maxlen,
        theta=theta,
        cos_theta=z,
        sin_theta=np.sqrt(np.maximum(1.0 - z * z, 0.0)),
        nphi=nphi,
        phi0=phi0,
        start=start,
        pix_index=pix_index,
        mask=mask,
        twoj_h=twoj_h,
        n2=(2 * nphi).astype(np.int32),
        phi=phi,
    )


def ang_positions(nside: int) -> np.ndarray:
    """(npix, 2) array of (theta, phi) pixel centres in RING order.

    Equivalent of ``cora.util.hputil.ang_positions`` used by
    driftscan's drift/core/telescope.py:949.
    """
    g = ring_geometry(nside)
    ang = np.empty((g.npix, 2), dtype=np.float64)
    for r in range(g.nring):
        n = int(g.nphi[r])
        s = int(g.start[r])
        ang[s : s + n, 0] = g.theta[r]
        ang[s : s + n, 1] = g.phi0[r] + 2.0 * np.pi * np.arange(n) / n
    return ang
