"""Sky covariance models: foregrounds and the 21 cm signal.

Functional replacement for driftscan's drift/core/skymodel.py plus the
parts of ``cora`` it leans on.  The foregrounds follow the standard
power-law angular/spectral model with log-normal frequency decorrelation
(Santos-Cooray-Knox style, parameters as used in arXiv:1302.0327):

    C_l(nu1, nu2) = A (l/l_0)^-alpha (nu1 nu2 / nu_0^2)^-beta
                    exp( -ln^2(nu1/nu2) / (2 zeta^2) )

The 21 cm signal C_l(nu1, nu2) is the flat-sky integral of the linear
matter power spectrum with Kaiser redshift-space factors:

    C_l = T(z1) T(z2) D(z1) D(z2) / (pi chi1 chi2)
          * Int dk_par cos(k_par dchi) F(mu,z1) F(mu,z2) P(k)

with k = sqrt(k_par^2 + k_perp^2), k_perp = (l + 1/2)/chi_mean and
F = 1 + f(z) mu^2.  The k_par quadrature is evaluated as a pair of
(l, k_par) x (k_par, freq-pair) host matmuls in float64: the covariances
are built once per run, and the factored pencil needs them at float64
resolution.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from . import cosmology as _cosmo

class ForegroundModel:
    """Power-law foreground angular power spectrum."""

    A = 1.0
    alpha = 2.5
    beta = 1.0
    zeta = 1.0
    l_0 = 100.0
    nu_0 = 408.0

    def angular_powerspectrum(self, l, nu1, nu2):
        l = np.asarray(l, dtype=np.float64)
        lsafe = np.where(l > 0, l, 1.0)
        cl = (
            self.A
            * (lsafe / self.l_0) ** (-self.alpha)
            * (nu1 * nu2 / self.nu_0**2) ** (-self.beta)
            * np.exp(-np.log(nu1 / nu2) ** 2 / (2 * self.zeta**2))
        )
        # No monopole power
        return np.where(l > 0, cl, 0.0)

    def angular_powerspectrum_grid(self, ls, f1, f2):
        """Dense (nl, nf1, nf2) grid exploiting the separable form.

        C_l(nu1, nu2) = [A (l/l0)^-alpha] x [(nu1/nu0)^-beta] x
        [(nu2/nu0)^-beta] x [exp(-log^2(nu1/nu2)/2 zeta^2)]: one small
        power-law vector per axis plus an (nf1, nf2) decorrelation
        matrix, assembled by broadcasting — ~6 transcendental ops per
        *axis* element instead of per grid element (the dense evaluation
        took minutes at 256 freqs x lmax 1000 on a single-core host).
        """
        ls = np.asarray(ls, dtype=np.float64)
        f1 = np.asarray(f1, dtype=np.float64)
        f2 = np.asarray(f2, dtype=np.float64)
        lpart = np.where(
            ls > 0, self.A * (np.maximum(ls, 1.0) / self.l_0) ** (-self.alpha), 0.0
        )
        p1 = (f1 / self.nu_0) ** (-self.beta)
        p2 = (f2 / self.nu_0) ** (-self.beta)
        dec = np.exp(
            -np.subtract.outer(np.log(f1), np.log(f2)) ** 2 / (2 * self.zeta**2)
        )
        return lpart[:, None, None] * (np.outer(p1, p2) * dec)[None]


class FullSkySynchrotron(ForegroundModel):
    """Galactic synchrotron (amplitude for the full, unmasked sky)."""

    A = 6.6e-3  # K^2
    alpha = 2.80
    beta = 2.8
    zeta = 4.0


class FullSkyPolarisedSynchrotron(ForegroundModel):
    """Polarised synchrotron with short frequency decorrelation length."""

    A = 1.65e-3  # K^2
    alpha = 2.80
    beta = 2.8
    zeta = 1.3


class PointSources(ForegroundModel):
    """Unresolved point sources below S_cut = 0.1 Jy (driftscan override,
    driftscan's drift/core/skymodel.py:12-17)."""

    A = 3.55e-5  # K^2
    alpha = 2.10
    beta = 1.1
    zeta = 1.0
    nu_0 = 408.0
    l_0 = 100.0


def clarray(aps: Callable, lmax: int, frequencies) -> np.ndarray:
    """Evaluate an angular power spectrum over (l, nu1, nu2)."""
    freq = np.asarray(frequencies, dtype=np.float64)
    grid = getattr(getattr(aps, "__self__", None), "angular_powerspectrum_grid", None)
    if grid is not None and aps.__name__ == "angular_powerspectrum":
        return grid(np.arange(lmax + 1, dtype=np.float64), freq, freq)
    ls = np.arange(lmax + 1, dtype=np.float64)[:, None, None]
    n1 = freq[None, :, None]
    n2 = freq[None, None, :]
    return aps(ls, n1, n2)


def foreground_model(lmax, frequencies, npol, pol_frac=1.0, pol_length=None):
    """Foreground covariance [pol, pol, l, freq, freq].

    Parity with driftscan's drift/core/skymodel.py:20-44.
    """
    fsyn = FullSkySynchrotron()
    fps = PointSources()

    nfreq = len(frequencies)
    cv_fg = np.zeros((npol, npol, lmax + 1, nfreq, nfreq))

    cv_fg[0, 0] = clarray(fsyn.angular_powerspectrum, lmax, frequencies)

    if npol >= 3:
        fpol = FullSkyPolarisedSynchrotron()
        if pol_length is not None:
            fpol.zeta = pol_length
        cv_fg[1, 1] = pol_frac * clarray(fpol.angular_powerspectrum, lmax, frequencies)
        cv_fg[2, 2] = pol_frac * clarray(fpol.angular_powerspectrum, lmax, frequencies)

    cv_fg[0, 0] += clarray(fps.angular_powerspectrum, lmax, frequencies)
    return cv_fg


class Corr21cm:
    """21 cm brightness correlations from the linear matter power spectrum.

    Replaces ``cora.signal.corr21cm.Corr21cm`` for the uses driftscan makes
    of it: ``angular_powerspectrum(l, nu1, nu2)`` and ``ps_vv(k)``.

    Parameters
    ----------
    ps
        Optional replacement power spectrum.  With ``ps_2d = False`` it is
        a function of k only (Kaiser factors are applied internally); with
        ``ps_2d = True`` it is a function (k, mu) used verbatim — this is
        how the PS estimator builds band covariances
        (driftscan's drift/core/psestimation.py:351-378).
    redshift
        Redshift at which `ps` is defined (growth evolves it elsewhere).
    """

    # Quadrature resolution for the k_par integral
    NKPAR = 2048
    KPAR_MAX = 2.0  # Mpc^-1

    def __init__(self, ps: Optional[Callable] = None, redshift: float = 1.5, cosmo=None):
        self.cosmo = cosmo or _cosmo.default_cosmology()
        self._ps = ps
        self.ps_redshift = redshift
        self.ps_2d = False

    # ------------- fiducial real-space spectrum -------------

    def ps_vv(self, k):
        """Fiducial (bias = 1) matter power spectrum at the PS redshift."""
        D = self.cosmo.growth_factor(self.ps_redshift)
        return self.cosmo.matter_powerspectrum(k) * D**2

    def _pk(self, k, mu):
        """Base spectrum before growth factors (z=0 for the internal P(k);
        z=ps_redshift for a user-supplied one)."""
        if self._ps is not None:
            if self.ps_2d:
                return self._ps(k, mu)
            return self._ps(k)
        return self.cosmo.matter_powerspectrum(k)

    # ------------- flat-sky angular power spectrum -------------

    def angular_powerspectrum(self, l, nu1, nu2):
        """C_l(nu1, nu2) on a dense (l, nu1, nu2) grid.

        Accepts broadcastable arrays like ``clarray`` produces; computes on
        the full outer grid and returns the broadcast shape.
        """
        l = np.asarray(l, dtype=np.float64)
        nu1 = np.asarray(nu1, dtype=np.float64)
        nu2 = np.asarray(nu2, dtype=np.float64)

        ls = np.unique(l.ravel())
        f1 = np.unique(nu1.ravel())
        f2 = np.unique(nu2.ravel())

        cl_grid = self._cl_grid(ls, f1, f2)

        # Map requested broadcast indices into the dense grid
        li = np.searchsorted(ls, l)
        i1 = np.searchsorted(f1, nu1)
        i2 = np.searchsorted(f2, nu2)
        li, i1, i2 = np.broadcast_arrays(li, i1, i2)
        return cl_grid[li, i1, i2]

    def _cl_grid(self, ls, freq1, freq2):
        """Dense C_l grid (nl, nf1, nf2) via the matmul quadrature."""
        c = self.cosmo

        z1 = c.redshift_from_freq(freq1)
        z2 = c.redshift_from_freq(freq2)
        x1 = np.atleast_1d(c.comoving_distance(z1))
        x2 = np.atleast_1d(c.comoving_distance(z2))
        T1 = np.atleast_1d(c.T21(z1))
        T2 = np.atleast_1d(c.T21(z2))
        # Growth relative to the redshift the input spectrum is defined at
        Dref = c.growth_factor(self.ps_redshift) if self._ps is not None else 1.0
        D1 = np.atleast_1d(c.growth_factor(z1)) / Dref
        D2 = np.atleast_1d(c.growth_factor(z2)) / Dref
        fg1 = np.atleast_1d(c.growth_rate(z1))
        fg2 = np.atleast_1d(c.growth_rate(z2))

        xc = 0.5 * (x1.mean() + x2.mean())
        kpar = np.linspace(0.0, self.KPAR_MAX, self.NKPAR)
        dk = kpar[1] - kpar[0]

        kperp = (ls + 0.5) / xc  # (nl,)
        kgrid = np.sqrt(kpar[None, :] ** 2 + kperp[:, None] ** 2)  # (nl, nk)
        mu = np.where(kgrid > 0, kpar[None, :] / np.maximum(kgrid, 1e-12), 0.0)

        if self.ps_2d and self._ps is not None:
            # Band-style 2D spectra: no internal Kaiser factors.
            P = self._pk(kgrid, mu)
            A0, A2, A4 = P, np.zeros_like(P), np.zeros_like(P)
            use_kaiser = False
        else:
            P = self._pk(kgrid, mu)
            A0 = P
            A2 = P * mu**2
            A4 = P * mu**4
            use_kaiser = True

        dchi = (x1[:, None] - x2[None, :]).ravel()  # (nf1*nf2,)
        # cos(k_j * dchi) for the *linear* kpar grid via the three-term
        # recurrence cos((j+1)d) = 2 cos(d) cos(jd) - cos((j-1)d): two
        # cos evaluations + fused multiply-adds replace nk * nf^2
        # transcendentals (this single-core host took ~30 s on the
        # direct np.cos at 256 freqs; error ~ nk^2 * eps ~ 1e-9).
        cosmat = np.empty((self.NKPAR, dchi.size))
        cosmat[0] = 1.0
        if self.NKPAR > 1:
            step = np.cos(dk * dchi)
            cosmat[1] = step
            two_step = 2.0 * step
            for j in range(2, self.NKPAR):
                np.multiply(two_step, cosmat[j - 1], out=cosmat[j])
                cosmat[j] -= cosmat[j - 2]
        # Trapezoid end-point correction
        w = np.ones(self.NKPAR)
        w[0] = w[-1] = 0.5
        cosmat *= (w * dk)[:, None]

        I0 = A0 @ cosmat  # (nl, nf1*nf2)
        if use_kaiser:
            I2 = A2 @ cosmat
            I4 = A4 @ cosmat

        nf1, nf2 = x1.size, x2.size
        pref = (T1[:, None] * T2[None, :]) * (D1[:, None] * D2[None, :]) / (
            np.pi * x1[:, None] * x2[None, :]
        )

        I0 = np.asarray(I0).reshape(-1, nf1, nf2)
        if use_kaiser:
            I2 = np.asarray(I2).reshape(-1, nf1, nf2)
            I4 = np.asarray(I4).reshape(-1, nf1, nf2)
            fsum = fg1[:, None] + fg2[None, :]
            fprod = fg1[:, None] * fg2[None, :]
            integral = I0 + fsum[None] * I2 + fprod[None] * I4
        else:
            integral = I0

        return pref[None] * integral


class EoR21cm(Corr21cm):
    """Epoch-of-reionisation variant: boosted amplitude at high z.

    A lightweight stand-in for ``cora.signal.corr21cm.EoR21cm``: the mean
    temperature is scaled by the neutral fraction (taken to be 1 during
    the EoR) with the same correlation structure.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cos = self.cosmo
        # During reionisation Omega_HI ~ Omega_b x_HI: boost the amplitude.
        self.cosmo = _cosmo.Cosmology(
            H0=cos.H0,
            omega_m=cos.omega_m,
            omega_b=cos.omega_b,
            n_s=cos.n_s,
            sigma8=cos.sigma8,
            T_cmb=cos.T_cmb,
            omega_HI=cos.omega_b,
        )


_cr = None

# Set by the product manager (``config: reionisation: Yes``): the default
# signal model is then the EoR one.
_reionisation = False


def im21cm_model(lmax, frequencies, npol, cr=None, temponly=False):
    """21 cm signal covariance [pol, pol, l, freq, freq].

    Parity with driftscan's drift/core/skymodel.py:47-68.
    """
    global _cr
    nfreq = len(frequencies)

    if not cr:
        if not _cr:
            _cr = EoR21cm() if _reionisation else Corr21cm()
        cr = _cr

    cv_t = clarray(cr.angular_powerspectrum, lmax, frequencies)

    if temponly:
        return cv_t
    cv_sg = np.zeros((npol, npol, lmax + 1, nfreq, nfreq))
    cv_sg[0, 0] = cv_t
    return cv_sg
