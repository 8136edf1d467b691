"""Cylinder feed beam models: the Fraunhofer tables and the beam bank.

Port of ``driftscan_tpu/telescope/cylbeam.py``.  A feed illuminates a
parabolic cylinder; the E-W beam is the Fraunhofer diffraction pattern of
the feed's aperture distribution (computed once per (fwhm, width) on the
host by FFT, then interpolated on its uniform grid), and the N-S beam is
the ExpTan model.  The bank packs every frequency's table and beam
parameters into two arrays; the per-pixel evaluation of a bank row is
fused with the visibility map in
:func:`driftscan_tpu_torch.ops.kernels.bank_visibility_maps` (K1+K2), or
with the dipole pattern and the Stokes maps in
:func:`driftscan_tpu_torch.ops.kernels.bank_stokes_maps`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import kernels

_PAR_LEN = kernels.PAR_LEN  # kx0, inv_step, fwhm_ns, xhat(3), yhat(3), dipole(3)


@functools.lru_cache(maxsize=1024)
def fraunhofer_cylinder(fwhm_x: float, width: float, res: float = 1.0):
    """1-D Fraunhofer diffraction pattern of an ExpTan feed on a cylinder.

    The aperture (normalised coordinate u in [-1, 1], ``sin(angle) =
    2u / (1 + u^2)``) is sampled on an fft-ordered ``res * 16``-fold
    zero-padded grid, transformed, peak-normalised and trimmed to a
    margin past |sin(theta)| = 1.  Returns (sin_theta, amplitude) numpy
    arrays in ascending sin_theta order (a uniform grid).
    """
    half = 256  # aperture samples per unit of u
    n = int(res * 16) * 2 * half  # padded grid length

    offs = np.fft.fftfreq(n, 1.0 / n)
    u = offs / half
    inside = np.abs(u) <= 1.0

    st = 2.0 * u / (1.0 + u * u)  # sin(feed -> surface angle)
    alpha = np.log(2.0) / (2.0 * np.tan(0.5 * fwhm_x) ** 2)
    tan2 = st * st / np.maximum(1.0 - st * st, 1e-100)
    aperture = np.where(inside, np.exp(-alpha * tan2), 0.0)

    pattern = np.fft.fft(aperture).real
    sin_theta = np.fft.fftfreq(n, 1.0 / (2.0 * half)) / width

    keep = np.abs(sin_theta) < 1.1
    order = np.argsort(sin_theta[keep])
    return (
        sin_theta[keep][order],
        (pattern / pattern.max())[keep][order],
    )


def _basis_np(zenith, rot=(0.0, 0.0, 0.0)):
    """Host (xhat, yhat, zhat) feed basis at the zenith, rotated by ``rot``."""
    z = torch.as_tensor(np.asarray(zenith, dtype=np.float64))
    that, phat = kernels.thetaphi_plane_cart(z)
    zhat = kernels.sph_to_cart(z)
    xh, yh, zh = kernels.rotate_ypr(rot, phat, -that, zhat)
    return xh.numpy(), yh.numpy(), zh.numpy()


def _bank_row(zenith, width, fwhm_ew, fwhm_ns, pol, rot=(0.0, 0.0, 0.0)):
    """Host (params (12,), fx (n,)) for one (freq, class)."""
    kx, fx = fraunhofer_cylinder(float(fwhm_ew), float(width))
    step = kx[1] - kx[0]
    xhat, yhat, _ = _basis_np(zenith, rot)
    dipole = yhat if pol == "y" else xhat
    par = np.concatenate([[kx[0], 1.0 / step, fwhm_ns], xhat, yhat, dipole])
    return par, fx


def build_beam_bank(zenith, widths, fwhm_e, fwhm_h, polarised, dtype=np.float32):
    """(params (nfreq, C, 12), fx (nfreq, C, nfx)) host arrays.

    ``widths`` is the per-frequency cylinder width in wavelengths.
    C = 2 (X then Y dipole) when ``polarised``, else 1 (amplitude beam,
    fwhm_h in both planes).  Rows are edge-padded to the widest table,
    rounded up to a power of two.
    """
    rows = []
    for w in widths:
        if polarised:
            rows.append(
                [
                    _bank_row(zenith, w, fwhm_e, fwhm_h, "x"),
                    # the Y dipole swaps the fwhm order (H-plane east-west)
                    _bank_row(zenith, w, fwhm_h, fwhm_e, "y"),
                ]
            )
        else:
            rows.append([_bank_row(zenith, w, fwhm_h, fwhm_h, None)])
    nfx = max(len(fx) for r in rows for _, fx in r)
    nfx = 1 << (nfx - 1).bit_length()
    C = len(rows[0])
    params = np.zeros((len(rows), C, _PAR_LEN), dtype=dtype)
    tables = np.zeros((len(rows), C, nfx), dtype=dtype)
    for i, r in enumerate(rows):
        for c, (par, fx) in enumerate(r):
            params[i, c] = par
            tables[i, c, : len(fx)] = fx
            tables[i, c, len(fx):] = fx[-1]  # edge padding
    return params, tables
