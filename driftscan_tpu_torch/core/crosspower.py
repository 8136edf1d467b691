"""Cross-power spectrum estimation (two independent data streams).

Port of ``driftscan_tpu/core/crosspower.py``, on the device like
:mod:`.psmc`.
"""

from __future__ import annotations

from . import psmc


class CrossPower(psmc.PSMonteCarlo):
    """Monte-Carlo Fisher for a cross-power estimator.

    Instrumental noise does not bias a cross-power, so the noise
    projection is excluded (`crosspower = True`) and each q draw uses two
    independent realisations of the data.
    """

    crosspower = True

    def _work_fisher_bias_m(self, mi):
        """Fisher and bias from the covariance of two-stream q estimates.

        The q row block is extended by the noise band (``noise=True``);
        its covariance row against the signal bands is the bias.  Both
        streams of a chunk are successive draws of m's generator.
        """
        modes = self._modes_t(mi)
        rng = self._rng(mi)
        qs = []
        for n in psmc._chunk_sizes(self.nsamples):
            x = self._samples_t(mi, n, rng)
            y = self._samples_t(mi, n, rng)
            qs.append(self.q_estimator_t(mi, x, y, noise=True, modes=modes))
        qcov, _ = psmc._cov_mean(qs)
        return qcov[: self.nbands, : self.nbands], qcov[-1, : self.nbands]
