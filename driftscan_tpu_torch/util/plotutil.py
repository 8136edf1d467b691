"""Plotting helpers.

Port of ``driftscan_tpu/util/plotutil.py``: the polar-to-Cartesian
regridder for visualising Fisher forecast errors binned in (k, theta).
"""

from __future__ import annotations

import numpy as np


def regrid_polar(polar_img, r_bins, theta_bins, res: int = 1024):
    """Resample a binned quarter-plane polar image onto a Cartesian grid.

    ``polar_img`` (num_r, num_theta) holds one value per polar bin between
    the monotonic edges ``r_bins`` (num_r + 1) and ``theta_bins``
    (num_theta + 1, radians, 0 = the parallel axis).  Returns (res, res),
    row index the parallel component and column the perpendicular one, by
    nearest-bin lookup, NaN where a pixel falls outside the binned domain.
    A sample exactly on an interior edge goes to the bin above it.
    """
    polar_img = np.asarray(polar_img)
    r_bins = np.asarray(r_bins, dtype=np.float64)
    theta_bins = np.asarray(theta_bins, dtype=np.float64)

    axis = np.linspace(r_bins[0], r_bins[-1], res)
    kpar, kperp = np.meshgrid(axis, axis, indexing="ij")
    radius = np.hypot(kpar, kperp)
    angle = np.arctan2(kperp, kpar)  # 0 at the origin

    ir = np.searchsorted(r_bins, radius, side="right") - 1
    it = np.searchsorted(theta_bins, angle, side="right") - 1
    inside = (ir >= 0) & (ir < len(r_bins) - 1) & (it >= 0) & (it < len(theta_bins) - 1)

    cart_img = np.full((res, res), np.nan, dtype=polar_img.dtype)
    cart_img[inside] = polar_img[ir[inside], it[inside]]
    return cart_img
