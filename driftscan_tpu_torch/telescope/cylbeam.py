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

The same beams as host functions of the compact (npix, 2) sky grid
(:func:`beam_amp`, :func:`beam_x`, :func:`beam_y`, numpy float64) serve
the cylinders whose beams are evaluated on the host: a subclass that
overrides the beam physics, and every cylinder in double precision.
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


def polpattern(angpos, dipole):
    """Unit polarisation vectors of a dipole at each position.

    angpos (npix, 2) spherical; dipole (2,) spherical or (3,) cartesian.
    Returns (npix, 2) numpy vectors in the (theta_hat, phi_hat) basis.
    """
    dipole = torch.as_tensor(np.asarray(dipole, dtype=np.float64))
    if dipole.shape[0] == 2:
        dipole = kernels.sph_to_cart(dipole)
    cart = kernels.sph_to_cart(torch.as_tensor(np.asarray(angpos, dtype=np.float64)))
    return kernels.polpattern(cart, dipole).numpy()


def beam_dipole(theta, phi, squint):
    """Beam of a dipole above a ground plane."""
    return (1 - np.sin(theta) ** 2 * np.sin(phi) ** 2) ** (squint / 2) * np.sin(
        0.5 * np.pi * np.cos(theta)
    )


def beam_exptan(sintheta, fwhm):
    """ExpTan feed illumination model (see ops.kernels.beam_exptan)."""
    return kernels.beam_exptan(torch.as_tensor(np.asarray(sintheta)), fwhm).numpy()


def _cart(angpos):
    return kernels.sph_to_cart(torch.as_tensor(np.asarray(angpos, dtype=np.float64))).numpy()


def beam_amp(angpos, zenith, width, fwhm_x, fwhm_y, rot=(0.0, 0.0, 0.0)):
    """Amplitude beam of a cylinder feed over the sky (host, float64).

    E-W the Fraunhofer pattern of an ExpTan feed of ``fwhm_x`` on a
    cylinder ``width`` wavelengths wide (linear interpolation of the
    table); N-S an ExpTan of ``fwhm_y``; zero below the horizon.
    """
    xhat, yhat, _ = _basis(zenith, rot)
    kx, fx = fraunhofer_cylinder(float(fwhm_x), float(width))
    cvec = _cart(angpos)
    horizon = (cvec @ _cart(zenith) > 0.0).astype(np.float64)
    ew_amp = np.interp(cvec @ xhat, kx, fx)
    ns_amp = beam_exptan(cvec @ yhat, fwhm_y)
    return ew_amp * ns_amp * horizon


def beam_x(angpos, zenith, width, fwhm_e, fwhm_h, rot=(0.0, 0.0, 0.0)):
    """(npix, 2) polarised beam of the X (east-pointing) dipole."""
    xhat, _, _ = _basis(zenith, rot)
    amp = beam_amp(angpos, zenith, width, fwhm_e, fwhm_h, rot=rot)
    return amp[:, None] * polpattern(angpos, xhat)


def beam_y(angpos, zenith, width, fwhm_e, fwhm_h, rot=(0.0, 0.0, 0.0)):
    """(npix, 2) polarised beam of the Y (north-pointing) dipole."""
    _, yhat, _ = _basis(zenith, rot)
    # swapped fwhm order: H-plane east-west, E-plane north-south
    amp = beam_amp(angpos, zenith, width, fwhm_h, fwhm_e, rot=rot)
    return amp[:, None] * polpattern(angpos, yhat)


def _basis(zenith, rot=(0.0, 0.0, 0.0)):
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
    xhat, yhat, _ = _basis(zenith, rot)
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
