"""Self-contained flat-LambdaCDM cosmology for the 21 cm sky models.

The reference delegates to the external ``cora`` package for its signal
covariances (driftscan's drift/core/skymodel.py:1-6).  We implement the
required pieces from standard published formulas so the framework has no
external cosmology dependency:

* background: E(z), comoving distance, linear growth factor/rate;
* linear matter power spectrum: Eisenstein & Hu (1998) no-wiggle transfer
  function, normalised to sigma_8;
* mean 21 cm brightness temperature T_b(z).

Distances are in Mpc, wavenumbers in Mpc^-1, temperatures in K.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F21 = 1420.405751  # MHz, 21cm rest frequency


@dataclass(frozen=True)
class Cosmology:
    """Flat LambdaCDM parameters (Planck-like fiducial)."""

    H0: float = 67.8  # km/s/Mpc
    omega_m: float = 0.308
    omega_b: float = 0.0484
    n_s: float = 0.968
    sigma8: float = 0.815
    T_cmb: float = 2.7255
    omega_HI: float = 1e-3

    @property
    def h(self) -> float:
        return self.H0 / 100.0

    @property
    def omega_l(self) -> float:
        return 1.0 - self.omega_m

    # ----------------- background -----------------

    def E(self, z):
        z = np.asarray(z, dtype=np.float64)
        return np.sqrt(self.omega_m * (1 + z) ** 3 + self.omega_l)

    _DH = 299792.458  # c in km/s

    def comoving_distance(self, z):
        """chi(z) in Mpc by fixed-grid quadrature (vectorised)."""
        z = np.atleast_1d(np.asarray(z, dtype=np.float64))
        zmax = max(float(z.max()), 1e-4)
        grid = np.linspace(0.0, zmax, 4096)
        integ = 1.0 / self.E(grid)
        cum = np.concatenate([[0.0], np.cumsum((integ[1:] + integ[:-1]) / 2) * np.diff(grid)])
        chi = np.interp(z, grid, cum) * self._DH / self.H0
        return chi if chi.size > 1 else float(chi[0])

    def growth_factor(self, z):
        """Linear growth factor D(z), normalised to D(0) = 1."""
        z = np.atleast_1d(np.asarray(z, dtype=np.float64))

        def _raw(zv):
            # D(z) propto E(z) * int_0^a da' / (a' E(a'))^3
            a = np.linspace(1e-4, 1.0 / (1.0 + zv), 2048)
            ig = 1.0 / (a * self.E(1.0 / a - 1.0)) ** 3
            return self.E(zv) * np.trapezoid(ig, a)

        raw = np.array([_raw(zv) for zv in z])
        return (raw / _raw(0.0)) if raw.size > 1 else float(raw[0] / _raw(0.0))

    def growth_rate(self, z):
        """f(z) = dlnD/dlna ~= Omega_m(z)^0.55."""
        z = np.asarray(z, dtype=np.float64)
        om_z = self.omega_m * (1 + z) ** 3 / self.E(z) ** 2
        return om_z**0.55

    # ----------------- matter power spectrum -----------------

    def _transfer_nowiggle(self, k):
        """EH98 zero-baryon-wiggle transfer function (eqs 28-31)."""
        k = np.asarray(k, dtype=np.float64)
        h = self.h
        om_h2 = self.omega_m * h * h
        ob_h2 = self.omega_b * h * h
        theta = self.T_cmb / 2.7

        s = 44.5 * np.log(9.83 / om_h2) / np.sqrt(1.0 + 10.0 * ob_h2**0.75)
        fb = self.omega_b / self.omega_m
        alpha = 1.0 - 0.328 * np.log(431.0 * om_h2) * fb + 0.38 * np.log(
            22.3 * om_h2
        ) * fb**2

        gamma_eff = self.omega_m * h * (
            alpha + (1.0 - alpha) / (1.0 + (0.43 * k * s) ** 4)
        )
        q = (k / h) * theta**2 / gamma_eff
        L0 = np.log(2.0 * np.e + 1.8 * q)
        C0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
        return L0 / (L0 + C0 * q * q)

    _norm_cache = None

    def _norm(self) -> float:
        """Amplitude of P(k) = A k^ns T(k)^2 fixed by sigma_8."""
        if self._norm_cache is not None:
            return self._norm_cache
        k = np.logspace(-4, 2, 4096)
        R = 8.0 / self.h
        x = k * R
        W = 3.0 * (np.sin(x) - x * np.cos(x)) / x**3
        pk_un = k**self.n_s * self._transfer_nowiggle(k) ** 2
        integrand = pk_un * W**2 * k**2 / (2 * np.pi**2)
        s8sq_un = np.trapezoid(integrand, k)
        A = self.sigma8**2 / s8sq_un
        object.__setattr__(self, "_norm_cache", A)
        return A

    def matter_powerspectrum(self, k, z=0.0):
        """Linear P(k, z) in Mpc^3 (k in Mpc^-1)."""
        k = np.asarray(k, dtype=np.float64)
        ksafe = np.maximum(k, 1e-8)
        pk0 = self._norm() * ksafe**self.n_s * self._transfer_nowiggle(ksafe) ** 2
        D = self.growth_factor(z) if np.any(np.asarray(z) != 0) else 1.0
        return pk0 * np.asarray(D) ** 2

    # ----------------- 21 cm observables -----------------

    def redshift_from_freq(self, freq_mhz):
        """z of the 21 cm line observed at freq (MHz)."""
        return F21 / np.asarray(freq_mhz, dtype=np.float64) - 1.0

    def T21(self, z):
        """Mean 21 cm brightness temperature in K.

        Standard HI intensity-mapping amplitude:
        T_b = 0.3 mK (Omega_HI / 1e-3) sqrt((1+z)/2.5) / sqrt(E(z)^2/(1+z)^3 ...)
        expressed as 0.3 mK (Omega_HI/1e-3) ((1+z)^2 / E(z)) * (0.7/h-ish);
        we use the common form T_b = 0.3 mK (Omega_HI/1e-3)
        sqrt((1+z)/2.5 * 0.29/(omega_m + omega_l/(1+z)^3)).
        """
        z = np.asarray(z, dtype=np.float64)
        densfac = self.omega_m + self.omega_l / (1 + z) ** 3
        return (
            0.3e-3
            * (self.omega_HI / 1e-3)
            * np.sqrt((1.0 + z) / 2.5)
            * np.sqrt(0.29 / densfac)
        )


_default = None


def default_cosmology() -> Cosmology:
    global _default
    if _default is None:
        _default = Cosmology()
    return _default
