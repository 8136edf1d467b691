"""Monte-Carlo estimation of the Fisher matrix.

Port of ``driftscan_tpu/core/psmc.py``: Cov(q_a, q_b) = F_ab (Padmanabhan &
Pen 2003; Dillon et al. 2012), so Gaussian KL-space draws give the Fisher
matrix and the bias.  The draws are numpy ``Generator`` draws on the host,
seeded from the seed and m alone (``seed + 31 m``, unseeded when ``seed``
is None), so an m draws the same samples on whichever process takes it
and the Fisher matrix of N processes is the one-process one.  The JAX
package adds the process rank to the seed; its one-process stream is this
one.  The draws go to the estimator's device once per m and
sample chunk; everything after them (whitening, KL -> SVD -> sky, the band
contraction, covariance and mean, Alt's Gram) runs there in complex128.

One generator serves all the draws of an m.  The JAX package makes a new
one at each draw, so with a seed its second sample chunk repeats the first
(``nsamples`` > 1000) and CrossPower's two streams are the same stream;
the first chunk's draws are the same in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from . import psestimation


def complex_std_normal(shape, rng=None):
    """Complex standard normal samples (unit total variance per element)."""
    rng = rng or np.random.default_rng()
    return (rng.standard_normal(shape) + 1.0j * rng.standard_normal(shape)) / 2**0.5


def matrix_root_manynull(mat, truncate=False):
    """Square root of a PSD matrix with (many) null directions."""
    evals, evecs = np.linalg.eigh(mat)
    evals = np.where(evals > 0.0, evals, 0.0)
    root = evecs * evals**0.5
    if truncate:
        nz = np.nonzero(evals > 0)[0]
        root = root[:, nz]
    return root


def _chunk_sizes(total, chunk=1000):
    """Sample-count chunks bounding the per-pass working set."""
    full, rem = divmod(total, chunk)
    return [chunk] * full + ([rem] if rem else [])


class MonteCarloMixin:
    """Shared sampling machinery for the Monte-Carlo PS estimators."""

    nsamples = config.Property(proptype=int, default=500)
    seed = config.Property(proptype=int, default=None)

    def _rng(self, mi):
        if self.seed is None:
            return np.random.default_rng()
        return np.random.default_rng(self.seed + 31 * mi)

    def gen_sample(self, mi, nsamples=None, noiseonly=False, rng=None):
        """Draw KL-space data realisations from the eigenvalue spectrum.

        The KL basis diagonalises the data covariance to diag(evals + 1)
        (signal eigenvalue + unit noise), so a draw is white noise scaled
        by sqrt(evals + 1) per mode -- sqrt(1) for noise-only draws.  Host
        numpy (nmodes, nsamples), from ``rng`` (a new generator of m when
        None).
        """
        nsamples = self.nsamples if nsamples is None else nsamples

        evals, _ = self.kltrans.modes_m(mi)
        x = complex_std_normal((evals.shape[0], nsamples), rng=rng or self._rng(mi))
        if noiseonly:
            return x
        return x * np.sqrt(evals + 1.0)[:, np.newaxis]

    def _samples_t(self, mi, nsamples, rng):
        """:meth:`gen_sample` from ``rng``, moved to the device."""
        return torch.as_tensor(
            self.gen_sample(mi, nsamples, rng=rng), dtype=torch.complex128, device=self.device
        )


def _cov_mean(qs):
    """(np.cov, mean over samples) of the stacked q chunks (nq, ns) on the
    device, as host arrays."""
    qa = torch.cat(qs, dim=1)
    nq = qa.shape[0]
    return torch.cov(qa).reshape(nq, nq).cpu().numpy(), qa.mean(dim=1).cpu().numpy()


class PSMonteCarlo(MonteCarloMixin, psestimation.PSEstimation):
    """Fisher via the sample covariance of the q estimator.

    Attributes
    ----------
    nsamples : int
        Number of Gaussian samples to draw per m.
    """

    def _work_fisher_bias_m(self, mi):
        """Fisher = Cov(q); bias = mean(q)."""
        modes = self._modes_t(mi)
        rng = self._rng(mi)
        return _cov_mean([
            self.q_estimator_t(mi, self._samples_t(mi, n, rng), modes=modes)
            for n in _chunk_sizes(self.nsamples)
        ])


class PSMonteCarloAlt(MonteCarloMixin, psestimation.PSEstimation):
    """Stochastic-trace-style estimation with cached per-band vectors."""

    nswitch = config.Property(proptype=int, default=0)

    vec_cache = None

    def gen_vecs(self, mi):
        """Cache Z2 sample vectors pushed through each band covariance.

        One batch of Z2 vectors is whitened by (evals+1)^-1/2, projected
        KL -> SVD -> sky (temperature), multiplied by every band's C_l and
        projected back; ``vec_cache`` (nbands, nmodes, nsamples) then holds
        each band's C^-1/2-weighted vectors, on the device.
        """
        evals, evecs = self._modes_t(mi)
        cf = (evals + 1.0) ** -0.5
        z2 = self._rng(mi).integers(0, 2, (evals.numel(), self.nsamples))
        xv = (2.0 * torch.as_tensor(z2, dtype=torch.float64, device=self.device) - 1.0)
        xv = (xv * cf[:, None]).to(torch.complex128)

        sky = self._svd_to_sky_t(mi, evecs.mH @ xv, temponly=True)
        svd = self._sky_to_svd_t(mi, self._band_apply(sky))  # (nbands, ndof, ns)
        self.vec_cache = cf[:, None] * (evecs @ svd)

    def _work_fisher_bias_m(self, mi):
        """Fisher from pairwise inner products of the cached band vectors."""
        self.gen_vecs(mi)

        # V: (nbands, nmodes * nsamples) -- Fisher is the Gram matrix / ns
        V = self.vec_cache.reshape(self.nbands, -1)
        fisher = (V @ V.mH) / self.nsamples
        bias = np.zeros(self.nbands, dtype=np.complex128)
        return fisher.cpu().numpy(), bias


def sim_skyvec(trans, n):
    """Simulate alm(nu) draws given per-l covariance roots."""
    gaussvars = complex_std_normal(trans.shape[:2] + (n,))
    return np.einsum("lfg,lgn->lfn", trans, gaussvars)


def block_root(clzz):
    """Square roots of each l-block of an angular power spectrum."""
    return np.stack([matrix_root_manynull(b) for b in np.asarray(clzz)])
