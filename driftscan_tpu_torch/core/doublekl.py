"""Two-stage KL: foreground rejection, then signal/noise diagonalisation.

Port of ``driftscan_tpu/core/doublekl.py``: stage 1 solves the
signal/foreground pencil with thermal noise suppressed and keeps modes
whose S/F exceeds ``foreground_threshold``; stage 2 re-solves the full
signal/noise pencil restricted to that cleaned subspace.  The eigenfiles
additionally record the stage-1 spectrum (``f_evals``).  The batched path
runs the fully-factored two-stage pencil
(ops.projections.doublekl_factored_batched) on the device, or with
``engine: topband`` its top-band form, with the exact engine for a chunk
whose certificate fails; the dense per-m path whitens dense covariances
(ops.linalg.eigh_gen).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from .. import config
from ..ops import linalg, projections
from ..parallel import comm
from ..parallel import mesh as meshmod
from ..util import store
from . import kltransform

logger = logging.getLogger(__name__)


class DoubleKL(kltransform.KLTransform):
    """KL with an initial S/F (foreground) filtering step.

    Attributes
    ----------
    foreground_threshold : scalar
        S/F power ratio below which modes are discarded as
        foreground-contaminated (stage 1 cut).
    """

    foreground_threshold = config.Property(proptype=float, default=100.0)

    def _pencil(self, mi, thermal):
        """Solve the (signal, noise) pencil at m on the device; returns the
        covariances, evals ascending, mode rows, and the regularisation
        constant."""
        cs, cn = self.sn_covariance_t(mi, thermal=thermal)
        stage = "step 2" if thermal else "step 1"
        evals, evecs, ac = projections.generalised_eigh(
            cs, cn, message=f"m = {mi}; KL {stage}"
        )
        return evals, evecs.mH.resolve_conj(), ac

    def _transform_m(self, mi):
        if self.beamtransfer.ndof(mi) == 0:
            return (
                np.array([]),
                np.array([[]]),
                np.array([[]]),
                {"ac": 0.0, "f_evals": np.array([])},
            )

        # Stage 1: S/F pencil, thermal off; cut at the foreground threshold.
        f_evals, modes, ac = self._pencil(mi, thermal=False)
        keep = f_evals > self.foreground_threshold

        inv = linalg.inv_gen(modes).T if self.inverse else None

        evals = f_evals[keep]
        modes = modes[keep]
        if self.inverse:
            inv = inv[keep]

        extra = {"ac": ac, "f_evals": f_evals.cpu().numpy().copy()}

        if evals.numel():
            # Stage 2: full S/N pencil restricted to the cleaned subspace.
            cs, cn = self.sn_covariance_t(mi, thermal=True)
            evals, evecs2, _ = projections.generalised_eigh(
                modes @ cs @ modes.mH, modes @ cn @ modes.mH,
                message=f"m = {mi}; KL step 2",
            )
            modes = (evecs2.mH @ modes).resolve_conj()
            if self.inverse:
                inv = linalg.inv_gen(evecs2) @ inv

        return (
            evals.cpu().numpy(),
            modes.cpu().numpy(),
            None if inv is None else inv.cpu().numpy(),
            extra,
        )

    def _ev_save_hook(self, f, evextra):
        super()._ev_save_hook(f, evextra)
        f.create_dataset("f_evals", data=evextra["f_evals"])

    def _transform_save_mbatch(self, m_chunk):
        """Two-stage KL for a chunk of m-modes in one device batch.

        Both stages run from covariance *factors* by QR whitening.  svcut
        padding never survives stage 1 (zero signal and foreground rows
        give S/F = 0 against the suppressed-thermal floor), so the stage-1
        spectrum compacts by simply taking the top ndof values.
        """
        tel = self.telescope
        bsvd, idx_list = self._load_bsvd_batch(m_chunk)
        ls, lf = self._cl_factors()

        nc1 = (1e-3 / tel.tsys_flat) ** 2  # suppressed-thermal floor
        kw = dict(nc=1.0, nc1=nc1, fg_threshold=self.foreground_threshold,
                  fg_reg_rel=self._foreground_regulariser,
                  mesh=meshmod.get_mesh(bsvd.device))

        # the top-band engine: both stages compute only the modes they
        # keep, and the sub-threshold tails of `evals_full` / `f_evals` are
        # exact zeros; a failed certificate sends the chunk to the exact
        # engine
        topband_ok = False
        if self._use_topband:
            f_ev_t, ev_t, evecs_t, nkept_t, ok = projections.doublekl_factored_batched_topband(
                bsvd, ls, lf, cut=self.threshold, **kw
            )
            topband_ok = not self._topband_failed(m_chunk, ok)
        if not topband_ok:
            f_ev_t, ev_t, evecs_t, nkept_t = projections.doublekl_factored_batched(
                bsvd, ls, lf, **kw
            )
        f_ev_b = f_ev_t.cpu().numpy()
        ev_b = ev_t.cpu().numpy()
        nkept_b = nkept_t.cpu().numpy()
        n = ev_b.shape[1]
        kmax = max(int(nkept_b.max()), 1)
        tail = evecs_t[:, :, n - kmax :].cpu().numpy()

        for i, mi in enumerate(m_chunk):
            idx = idx_list[i]
            ndof = len(idx)
            nkept = int(nkept_b[i])

            # ascending, padding zeros shed
            f_evals = f_ev_b[i][-ndof:] if ndof else f_ev_b[i][:0]
            if nkept:
                evals = ev_b[i][-nkept:]
                # rows = modes, compact coordinates
                evecs = tail[i][idx, kmax - nkept :].T.conj()
            else:
                evals = np.array([])
                evecs = np.array([[]])

            logger.info(
                "Writing DoubleKL file for m = %i (%i kept): %s",
                mi, nkept, self._evfile % mi,
            )
            with store.File(self._evfile % mi, "w") as f:
                f.attrs["m"] = mi
                f.attrs["SUBSET"] = self.subset

                evalsf = np.zeros(ndof, dtype=np.float64)
                if evals.size:
                    evalsf[-evals.size :] = evals
                f.create_dataset("evals_full", data=evalsf)

                if self.subset and evals.size:
                    i_ev = np.searchsorted(evals, self.threshold)
                    evals = evals[i_ev:]
                    evecs = evecs[i_ev:]

                f.create_dataset("evals", data=evals)
                f.create_dataset("evecs", data=np.ascontiguousarray(evecs))
                f.attrs["num_modes"] = evals.size
                self._ev_save_hook(f, {"ac": 0.0, "f_evals": f_evals})

    def _collect(self):
        """Collect both spectra (S/N and stage-1 S/F) into evals.hdf5."""
        ndofmax = self.beamtransfer.ndofmax

        def spectra(mi):
            out = np.zeros((2, ndofmax), dtype=np.float64)
            with store.File(self._evfile % mi, "r") as f:
                for row, name in enumerate(("evals_full", "f_evals")):
                    v = f[name][:]
                    if v.size:
                        out[row, -v.size :] = v
            return out

        if comm.rank0():
            logger.info("Creating eigenvalues file (process 0 only).")

        mlist = list(range(self.telescope.mmax + 1))
        evarray = kltransform.collect_m_array(mlist, spectra, (2, ndofmax), np.float64)

        if comm.rank0():
            fname = os.path.join(self.evdir, "evals.hdf5")
            if os.path.exists(fname):
                logger.info("File %s exists. Skipping...", fname)
                return
            with store.File(fname, "w") as f:
                f.create_dataset("evals", data=evarray[:, 0])
                f.create_dataset("f_evals", data=evarray[:, 1])
