"""Full-sky visibility primitives (numpy facing).

Port of ``driftscan_tpu/core/visibility.py``: the UV-plane basis, the
horizon, the fringe, the sinc beam of an N-S cylinder and the I/Q/U
projection onto two feeds, on the host in float64 through the port's
:mod:`driftscan_tpu_torch.ops.kernels` (``sph_to_cart``,
``thetaphi_plane_cart``, ``horizon_mask``, ``uv_cart`` and ``fringe``).
Every function takes and returns numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def uv_plane_cart(zenith):
    """Unit vectors (uhat east, vhat north) spanning the UV plane."""
    that, phat = kernels.thetaphi_plane_cart(_t(zenith))
    return phat.numpy(), -that.numpy()


def horizon(sph_arr, zenith):
    """Horizon function: 1 above the horizon, 0 below."""
    return kernels.horizon_mask(kernels.sph_to_cart(_t(sph_arr)), _t(zenith)).numpy()


def fringe(sph_arr, zenith, uv):
    """Fringe exp(2 pi i n.u) at each angular position.

    ``uv`` (..., 2) baselines in wavelengths; returns (..., npix).  The
    port's :func:`kernels.fringe` takes the zenith inside its baseline
    vectors (:func:`kernels.uv_cart`).
    """
    cart = kernels.sph_to_cart(_t(sph_arr))
    return kernels.fringe(cart, kernels.uv_cart(_t(zenith), _t(uv))).numpy()


def cylinder_beam(sph_arr, zenith, cylwidth):
    """Simple sinc beam of an N-S cylinder of the given width (wavelengths)."""
    uhatc, _ = uv_plane_cart(zenith)
    cart = kernels.sph_to_cart(_t(sph_arr)).numpy()
    return np.sinc(np.inner(cart, cylwidth * uhatc))


def pol_IQU(sph_arr, zenith, feed1, feed2):
    """I/Q/U polarisation tensors projected onto two feed directions."""
    that, phat = (v.numpy() for v in kernels.thetaphi_plane_cart(_t(sph_arr)))
    uhat, vhat = uv_plane_cart(zenith)

    f1c = feed1[0] * uhat + feed1[1] * vhat
    f2c = feed2[0] * uhat + feed2[1] * vhat

    f1_t = np.inner(that, f1c)
    f1_p = np.inner(phat, f1c)
    f2_t = np.inner(that, f2c)
    f2_p = np.inner(phat, f2c)

    pI = 0.5 * (f1_t * f2_t + f1_p * f2_p)
    pQ = 0.5 * (f1_t * f2_t - f1_p * f2_p)
    pU = 0.5 * (f1_t * f2_p + f1_p * f2_t)

    return pI, pQ, pU
