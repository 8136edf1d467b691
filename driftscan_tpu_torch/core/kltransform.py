"""Karhunen-Loeve signal/foreground filtering.

Port of ``driftscan_tpu/core/kltransform.py``: build signal and noise
covariances in the SVD basis, solve the generalised eigenproblem per m,
threshold-subset the modes, cache per-m eigenfiles and collect the
spectra.  Two paths:

* the batched path solves the *factored* pencil of a whole m-chunk on the
  device (ops.projections.kl_factored_batched), from the sky -> SVD beams
  the SVD stage left there, and brings only the spectrum, the support
  statistics and the retained eigenvector columns to the host;
* the dense per-m path (``inverse: Yes``, ``mbatch: 1``, or an m whose
  padded modes cannot be told from genuine ones) projects the covariances
  with the sandwich kernel and solves the whitened dense eigenproblem
  (ops.linalg.eigh_gen).

The per-m orchestration, files and thresholds stay host-side.  With
``engine: topband`` (and ``subset``) the batched path computes only the
retained eigenpairs (ops.projections.kl_factored_batched_topband); a chunk
whose certificate fails is solved again by the exact engine.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from .. import config
from ..ops import fpencil, linalg, projections, sht
from ..parallel import comm
from ..parallel import mesh as meshmod
from ..util import store, util
from . import skymodel

logger = logging.getLogger(__name__)


def collect_m_arrays(mlist, func, shapes, dtype):
    """Evaluate func(mi) (a list of arrays) for each m and collect them:
    the stacked arrays, on every process."""
    marrays = [np.zeros((len(mlist),) + shape, dtype=dtype) for shape in shapes]

    for mi in comm.partition_list_mpi(mlist):
        result = func(mi)
        for si in range(len(shapes)):
            if result[si] is not None:
                marrays[si][mi] = result[si]

    comm.barrier()
    return [comm.allreduce(m) for m in marrays]


def collect_m_array(mlist, func, shape, dtype):
    res = collect_m_arrays(mlist, lambda mi: [func(mi)], [shape], dtype)
    return res[0]


class KLTransform(config.Reader):
    """Perform the KL transform.

    `subset`/`threshold` control S/N mode cuts, `inverse` caches the
    inverse transform, `use_thermal`/`use_foregrounds` select the noise
    content, and `regulariser` sets the diagonal regulariser.
    """

    subset = config.Property(proptype=bool, default=True, key="subset")
    inverse = config.Property(proptype=bool, default=False, key="inverse")

    threshold = config.Property(proptype=float, default=0.1, key="threshold")

    # Eigensolver of the batched path: "exact" (the whole whitened-Gram
    # eigendecomposition) or "topband" (fpencil.gram_topband: only the
    # retained band).  With "topband" the sub-threshold tail of the
    # `evals_full` dataset is exact zeros (the retained `evals`/`evecs` are
    # unchanged); it needs ``subset`` and falls back to "exact" for any
    # chunk whose completeness certificate fails.
    engine = config.Property(proptype=str, default="exact", key="engine")

    _foreground_regulariser = config.Property(
        proptype=float, default=1e-14, key="regulariser"
    )

    use_thermal = config.Property(proptype=bool, default=True)
    use_foregrounds = config.Property(proptype=bool, default=True)
    use_polarised = config.Property(proptype=bool, default=True)

    pol_length = config.Property(proptype=config.float_or_none, default=None)

    # m-modes KL-transformed per batch (1 takes the dense per-m path).
    mbatch = config.Property(proptype=int, default=8)

    evdir = ""

    _cvfg = None
    _cvsg = None

    @property
    def _evfile(self):
        return self.evdir + "/ev_m_" + util.natpattern(self.telescope.mmax) + ".hdf5"

    def __init__(self, bt, subdir=None):
        self.beamtransfer = bt
        self.telescope = self.beamtransfer.telescope
        # m that the batched path handed to the dense per-m transform
        self.dense_fallback_m = []
        # m-chunks whose top-band certificate failed (solved again exactly)
        self.topband_fallback_chunks = []

        subdir = "ev" if subdir is None else subdir
        self.evdir = self.beamtransfer.directory + "/" + subdir
        if comm.rank0() and not os.path.exists(self.evdir):
            os.makedirs(self.evdir)
        comm.barrier()

    def _finalise_config(self):
        if self.engine not in ("exact", "topband"):
            raise ValueError(
                f"KL engine {self.engine!r}: the engines are 'exact' and 'topband'"
            )

    @property
    def _use_topband(self) -> bool:
        return self.engine == "topband" and self.subset

    def _topband_failed(self, m_chunk, ok) -> bool:
        """Whether a top-band chunk's certificate failed somewhere (then
        logged and recorded: the caller solves the chunk again exactly)."""
        if bool(ok.all()):
            return False
        logger.info(
            "m chunk %s: top-band certificate failed; re-solving with the exact engine.",
            list(m_chunk),
        )
        self.topband_fallback_chunks.append(list(m_chunk))
        return True

    @property
    def device(self) -> torch.device:
        return self.beamtransfer.device

    # ================= covariances =================

    def _check_npol(self):
        npol = self.telescope.num_pol_sky
        if npol not in (1, 3, 4):
            raise Exception(
                "Can only handle unpolarised (num_pol_sky = 1) or "
                "polarised (num_pol_sky = 3 or 4) cases."
            )
        return npol

    def foreground(self):
        """Foreground sky covariance [pol, pol, l, freq, freq]."""
        if self._cvfg is None:
            npol = self._check_npol()
            tel = self.telescope
            if self.use_polarised:
                self._cvfg = skymodel.foreground_model(
                    tel.lmax, tel.frequencies, npol, pol_length=self.pol_length
                )
            else:
                self._cvfg = skymodel.foreground_model(
                    tel.lmax, tel.frequencies, npol, pol_frac=0.0
                )
        return self._cvfg

    def signal(self):
        """21 cm signal sky covariance [pol, pol, l, freq, freq]."""
        if self._cvsg is None:
            npol = self._check_npol()
            self._cvsg = skymodel.im21cm_model(
                self.telescope.lmax, self.telescope.frequencies, npol
            )
        return self._cvsg

    def sn_covariance_t(self, mi, thermal=None):
        """:meth:`sn_covariance` as tensors on the device."""
        use_thermal = self.use_thermal if thermal is None else thermal
        if not (self.use_foregrounds or use_thermal):
            raise Exception(
                "Either `use_thermal` or `use_foregrounds`, or both must be True."
            )

        bt = self.beamtransfer

        cvb_s = bt.matrix_sky_to_svd(mi, self.signal())
        if self.use_foregrounds:
            cvb_n = bt.matrix_sky_to_svd(mi, self.foreground()).clone()
        else:
            cvb_n = torch.zeros_like(cvb_s)

        # Regularise the noise matrix.
        if cvb_n.numel():
            # the largest entry as numpy orders complex numbers (by real
            # part): for a Hermitian PSD block its largest diagonal entry
            diag = torch.diagonal(cvb_n)
            diag += self._foreground_regulariser * cvb_n.real.max()

        cvb_n = cvb_n + bt.matrix_diagonal_telescope_to_svd(
            mi, self._noise_power(thermal=use_thermal)
        )
        return cvb_s, cvb_n

    def sn_covariance(self, mi, thermal=None):
        """Signal and noise covariances in the SVD basis at m.

        Noise = foregrounds + regulariser + (possibly suppressed) thermal.
        ``thermal`` overrides ``self.use_thermal`` for this call (used by
        the two-stage DoubleKL without mutating state).
        """
        cvb_s, cvb_n = self.sn_covariance_t(mi, thermal=thermal)
        return cvb_s.cpu().numpy(), cvb_n.cpu().numpy()

    # ================= the transform =================

    def _transform_m(self, mi):
        """KL transform for one m: returns (evals, evecs rows, inv, extra)."""
        logger.info("Solving for Eigenvalues....")

        st = time.time()
        nside = self.beamtransfer.ndof(mi)
        if nside == 0:
            return np.array([]), np.array([[]]), np.array([[]]), {"ac": 0.0}

        cvb_sr, cvb_nr = self.sn_covariance_t(mi)
        logger.info("Covariance build time = %f", time.time() - st)

        st = time.time()
        evals, evecs, ac = projections.generalised_eigh(
            cvb_sr, cvb_nr, message=f"m = {mi}"
        )
        logger.info("Eigensolve time = %f", time.time() - st)

        evecs = evecs.mH.resolve_conj()

        inv = None
        if self.inverse:
            inv = linalg.inv_gen(evecs).T.cpu().numpy()

        return evals.cpu().numpy(), evecs.cpu().numpy(), inv, {"ac": ac}

    def transform_save(self, mi):
        """Perform the transform for m and save the eigenfile."""
        logger.info("Constructing signal and noise covariances for m = %i ...", mi)
        evals, evecs, inv, evextra = self._transform_m(mi)

        logger.info("Creating file %s ....", self._evfile % mi)
        with store.File(self._evfile % mi, "w") as f:
            f.attrs["m"] = mi
            f.attrs["SUBSET"] = self.subset

            # Zero-padded full spectrum (DoubleKL may have truncated).
            nside = self.beamtransfer.ndof(mi)
            evalsf = np.zeros(nside, dtype=np.float64)
            if evals.size != 0:
                evalsf[-evals.size :] = evals
            f.create_dataset("evals_full", data=evalsf)

            if self.subset:
                i_ev = np.searchsorted(evals, self.threshold)
                evals = evals[i_ev:]
                evecs = evecs[i_ev:]
                logger.info(
                    "Modes with S/N > %f: %i of %i",
                    self.threshold,
                    evals.size,
                    evalsf.size,
                )

            f.create_dataset("evals", data=evals)
            f.create_dataset("evecs", data=evecs)
            f.attrs["num_modes"] = evals.size

            if self.inverse:
                if self.subset:
                    inv = inv[i_ev:]
                f.create_dataset("evinv", data=inv)

            self._ev_save_hook(f, evextra)

        return evals, evecs

    def _ev_save_hook(self, f, evextra):
        ac = evextra["ac"]
        if ac != 0.0:
            f.attrs["add_const"] = ac
            f.attrs["FLAGS"] = "NotPositiveDefinite"
        else:
            f.attrs["FLAGS"] = "Normal"

    # ================= collection =================

    def evals_all(self):
        """Full eigenvalue spectrum for all m from disk."""
        with store.File(self.evdir + "/evals.hdf5", "r") as f:
            return f["evals"][:]

    def _collect(self):
        def evfunc(mi):
            evf = np.zeros(self.beamtransfer.ndofmax)
            with store.File(self._evfile % mi, "r") as f:
                if f["evals_full"].shape[0] > 0:
                    ev = f["evals_full"][:]
                    evf[-ev.size :] = ev
            return evf

        if comm.rank0():
            logger.info("Creating eigenvalues file (process 0 only).")

        mlist = list(range(self.telescope.mmax + 1))
        evarray = collect_m_array(mlist, evfunc, (self.beamtransfer.ndofmax,), np.float64)

        if comm.rank0():
            if os.path.exists(self.evdir + "/evals.hdf5"):
                logger.info("File %s exists. Skipping...", self.evdir + "/evals.hdf5")
                return
            with store.File(self.evdir + "/evals.hdf5", "w") as f:
                f.create_dataset("evals", data=evarray)

    def generate(self, regen=False):
        """KL transform every m and save the results."""
        st = time.time()
        if comm.rank0():
            logger.info("======== Starting KL calculation ========")

        mlist = [
            mi
            for mi in comm.mpirange(self.telescope.mmax + 1)
            if regen or not os.path.exists(self._evfile % mi)
        ]

        # The batched path is only taken when the effective ``_transform_m``
        # is defined at or above (in MRO) the class supplying the batched
        # writer: a subclass that overrides only ``_transform_m`` falls
        # back to the per-m path, so its customisation is never ignored.
        mro = type(self).__mro__
        writer_cls = next(c for c in mro if "_transform_save_mbatch" in c.__dict__)
        tm_cls = next(c for c in mro if "_transform_m" in c.__dict__)
        use_batched = (
            self.mbatch > 1
            and not self.inverse
            and getattr(self.beamtransfer, "kl_mbatch_ok", True)
            and mro.index(tm_cls) >= mro.index(writer_cls)
        )

        if use_batched and mlist:
            # Double-buffered (base writer only; a subclass with its own
            # batched writer keeps the chunk-at-a-time call): chunk i+1's
            # solve is queued on the device before chunk i's results are
            # fetched and written.
            pipelined = (
                writer_cls._transform_save_mbatch
                is KLTransform._transform_save_mbatch
            )
            pending = None
            for s in range(0, len(mlist), self.mbatch):
                chunk = mlist[s : s + self.mbatch]
                if not pipelined:
                    self._transform_save_mbatch(chunk)
                    continue
                dispatched = self._kl_dispatch_mbatch(chunk)
                if pending is not None:
                    self._kl_finish_mbatch(pending)
                pending = dispatched
            if pending is not None:
                self._kl_finish_mbatch(pending)
        else:
            for mi in mlist:
                self.transform_save(mi)

        comm.barrier()
        if comm.rank0():
            logger.info(
                "======== Ending KL calculation (time=%f) ========", time.time() - st
            )

        self._collect()

    def _noise_power(self, thermal=None):
        """Diagonal instrumental noise power [nfreq, ntel].

        With thermal noise disabled a tiny floor remains (Tsys -> 1 mK).
        """
        use_thermal = self.use_thermal if thermal is None else thermal
        bt = self.beamtransfer
        nc = 1.0 if use_thermal else (1e-3 / self.telescope.tsys_flat) ** 2
        bl = np.arange(self.telescope.npairs)
        bl = np.concatenate((bl, bl))
        return nc * self.telescope.noisepower(
            bl[np.newaxis, :], np.arange(self.telescope.nfreq)[:, np.newaxis]
        ).reshape(self.telescope.nfreq, bt.ntel)

    _cl_factor_cache = None

    def _cl_factors(self):
        """Per-l factor tables of the sky covariances, float64 on the
        device (cached).  With foregrounds disabled the foreground factor
        is zero: the pencil then reduces to S v = w nc I v."""
        if self._cl_factor_cache is None:
            ls = fpencil.factor_cl(self.signal(), out_dtype=np.float64)
            if self.use_foregrounds:
                lf = fpencil.factor_cl(self.foreground(), out_dtype=np.float64)
            else:
                lf = np.zeros_like(ls)
            self._cl_factor_cache = (
                torch.as_tensor(ls, device=self.device),
                torch.as_tensor(lf, device=self.device),
            )
        return self._cl_factor_cache

    def _load_bsvd_batch(self, m_chunk):
        """The svcut-masked SVD-beam batch of a chunk of m-modes on the
        device, (len(m_chunk), F, S, npol, nl) complex128, and the per-m
        compact index lists."""
        bt = self.beamtransfer
        nfreq, S = self.telescope.nfreq, bt.svd_len

        mask = np.zeros((len(m_chunk), nfreq, S))
        idx_list = []
        for i, mi in enumerate(m_chunk):
            svnum, _ = bt._svd_num(mi)
            for fi in range(nfreq):
                mask[i, fi, : svnum[fi]] = 1.0
            idx_list.append(bt._compact_indices(mi)[0])
        bsvd = bt.device_beam_svd(list(m_chunk))
        mask = torch.as_tensor(mask, device=bsvd.device).to(bsvd.dtype)
        return bsvd * mask[:, :, :, None, None], idx_list

    def _transform_save_mbatch(self, m_chunk):
        """KL-transform a chunk of m-modes in one device batch (dispatch
        and finish in one step; :meth:`generate` calls the halves apart)."""
        self._kl_finish_mbatch(self._kl_dispatch_mbatch(m_chunk))

    def _kl_dispatch_mbatch(self, m_chunk):
        """Queue one m-chunk's factored KL pencil solve on the device.

        The stored beams are noise-prewhitened, so the projected
        instrumental noise is exactly ``nc I`` on the retained modes (nc
        the thermal scaling of :meth:`_noise_power`); the identity also
        regularises the svcut-padded directions, whose signal rows are
        zero and therefore emerge with eval == 0 and unit padded support.
        Returns the state for :meth:`_kl_finish_mbatch`.
        """
        bsvd, idx_list = self._load_bsvd_batch(m_chunk)
        ls, lf = self._cl_factors()
        nc = 1.0 if self.use_thermal else (1e-3 / self.telescope.tsys_flat) ** 2
        mesh = meshmod.get_mesh(bsvd.device)

        def exact():
            return projections.kl_factored_batched(
                bsvd, ls, lf, nc=nc, with_thermal=True,
                fg_reg_rel=self._foreground_regulariser, mesh=mesh,
            )

        ok = None
        if self._use_topband:
            evals_t, evecs_t, ok = projections.kl_factored_batched_topband(
                bsvd, ls, lf, cut=self.threshold, nc=nc,
                fg_reg_rel=self._foreground_regulariser, mesh=mesh,
            )
        else:
            evals_t, evecs_t = exact()
        return m_chunk, idx_list, evals_t, evecs_t, ok, exact

    def _kl_finish_mbatch(self, state):
        """Fetch a dispatched chunk's results and write its eigenfiles.

        With threshold subsetting only the retained tail columns of the
        eigenbasis reach the files, so only the spectrum, the support
        statistics (reduced on the device) and those columns come to the
        host.
        """
        m_chunk, idx_list, evals_t, evecs_t, ok, exact = state
        topband_ok = ok is not None and not self._topband_failed(m_chunk, ok)
        if ok is not None and not topband_ok:
            evals_t, evecs_t = exact()
        evals_b = evals_t.cpu().numpy()
        M, n = evals_b.shape

        # Genuine modes are supported on the compact directions; padding
        # modes are unit vectors on padded axes.  Compare each column's
        # compact support to its *total* norm: the columns are
        # N-orthonormal, so absolute support scales as 1/lambda_N and an
        # absolute test misclassifies every genuine mode once foregrounds
        # lift the noise floor; the support *fraction* is free of the
        # normalisation.
        row_mask = np.zeros((M, n))
        for i, idx in enumerate(idx_list):
            row_mask[i, idx] = 1.0
        support_t, total_t = projections.kl_support_stats(evecs_t, row_mask)
        support_b = support_t.cpu().numpy()
        total_b = total_t.cpu().numpy() + 1e-300

        # Retained columns are the ascending tail: fetch only that tail;
        # anything else takes the full block.
        tail_only = (
            self.subset and self.threshold > 0
            and bool((np.diff(evals_b, axis=1) >= 0).all())
        )
        if tail_only:
            kmax = min(n, max(int((evals_b >= self.threshold).sum(axis=1).max()), 1))
        else:
            kmax = n
        offset = n - kmax
        tail = evecs_t[:, :, offset:].cpu().numpy()

        def cols(i, sel):
            """Columns ``sel`` of m-slot i, (nrows, len(sel))."""
            return tail[i][:, np.asarray(sel, dtype=int) - offset]

        for i, mi in enumerate(m_chunk):
            idx = idx_list[i]
            ndof = len(idx)
            w = evals_b[i]

            if topband_ok:
                # the columns above the cut are genuine by construction
                # (padded and svcut directions come out at exactly 0), and
                # the sub-threshold spectrum is written as zeros
                sel = np.nonzero(w > self.threshold)[0]
                self._write_ev_file(mi, ndof, w[sel], cols(i, sel)[idx, :].T.conj())
                continue

            keep = support_b[i] > 0.5 * total_b[i]
            if keep.sum() != ndof:
                # The pencil's zero eigenvalue is degenerate between the
                # svcut-padded unit directions and any genuine zero-signal
                # modes, so the eigensolver may return an arbitrary mixed
                # basis for that cluster and the global support count
                # miscounts.  With a positive subset cut only
                # above-threshold modes are ever written: classify those
                # alone, and report the full spectrum from the top-ndof
                # eigenvalues (the dropped n - ndof values are the ~0
                # duplicates of the padding directions).
                strict = w > self.threshold
                if (
                    self.subset
                    and self.threshold > 0
                    and int(strict.sum()) <= ndof
                    and bool(keep[strict].all())
                ):
                    sel = np.nonzero(strict)[0]
                    self._write_ev_file(
                        mi, ndof, w[sel], cols(i, sel)[idx, :].T.conj(),
                        evals_full=np.sort(np.asarray(w))[-ndof:] if ndof else w[:0],
                    )
                    continue
                # A genuinely mixed above-threshold column (or a full
                # eigenbasis request): fall back to the per-m path.
                logger.warning(
                    "m index %i: padded-mode separation ambiguous "
                    "(%i of %i); falling back to per-m transform.",
                    mi, int(keep.sum()), ndof,
                )
                self.dense_fallback_m.append(mi)
                self.transform_save(mi)
                continue

            if tail_only:
                # Only the >= threshold part of the genuine set reaches
                # the file (the sub-threshold genuine evals enter just the
                # evals_full diagnostic); all such columns are in the tail.
                sel = np.nonzero(keep & (w >= self.threshold))[0]
                self._write_ev_file(
                    mi, ndof, w[sel], cols(i, sel)[idx, :].T.conj(),
                    evals_full=w[keep],
                )
            else:
                sel = np.nonzero(keep)[0]
                self._write_ev_file(mi, ndof, w[sel], cols(i, sel)[idx, :].T.conj())

    def _write_ev_file(self, mi, ndof, evals, evecs, evals_full=None):
        """Write one m's eigenfile (evals ascending-sorted here).

        `evals_full`, if given, supplies the full-spectrum diagnostic
        dataset separately from the (possibly already subset) evals.
        """
        order = np.argsort(evals)
        evals = evals[order]
        evecs = evecs[order]

        logger.info("Writing KL file for m = %i: %s", mi, self._evfile % mi)
        with store.File(self._evfile % mi, "w") as f:
            f.attrs["m"] = mi
            f.attrs["SUBSET"] = self.subset

            evalsf = np.zeros(ndof, dtype=np.float64)
            if evals_full is not None:
                src = np.sort(np.asarray(evals_full, dtype=np.float64))
                if src.size:
                    evalsf[-src.size :] = src
            elif evals.size != 0:
                evalsf[-evals.size :] = evals
            f.create_dataset("evals_full", data=evalsf)

            if self.subset:
                i_ev = np.searchsorted(evals, self.threshold)
                evals = evals[i_ev:]
                evecs = evecs[i_ev:]

            f.create_dataset("evals", data=evals)
            f.create_dataset("evecs", data=np.ascontiguousarray(evecs))
            f.attrs["num_modes"] = evals.size
            self._ev_save_hook(f, {"ac": 0.0})

    olddatafile = False

    # ================= mode access =================

    @util.cache_last
    def modes_m(self, mi, threshold=None):
        """(evals, evecs) for m with S/N above `threshold` (None, None if empty)."""
        if not os.path.exists(self._evfile % mi):
            modes = self.transform_save(mi)
        else:
            with store.File(self._evfile % mi, "r") as f:
                if f["evals"].shape[0] == 0:
                    modes = None, None
                else:
                    evals = f["evals"][:]
                    startind = (
                        np.searchsorted(evals, threshold)
                        if threshold is not None
                        else 0
                    )
                    if startind == evals.size:
                        modes = None, None
                    else:
                        modes = (evals[startind:], f["evecs"][startind:])
                        if self.olddatafile:
                            modes = (modes[0], modes[1].conj())
        return modes

    @util.cache_last
    def evals_m(self, mi, threshold=None):
        """Eigenvalues for m above `threshold` (None if empty)."""
        if not os.path.exists(self._evfile % mi):
            modes = self.transform_save(mi)
            return modes[0] if modes[0] is not None and modes[0].size else None

        with store.File(self._evfile % mi, "r") as f:
            if f["evals"].shape[0] == 0:
                return None
            evals = f["evals"][:]
            startind = (
                np.searchsorted(evals, threshold) if threshold is not None else 0
            )
            if startind == evals.size:
                return None
            return evals[startind:]

    @util.cache_last
    def invmodes_m(self, mi, threshold=None):
        """Inverse modes (cached inverse or pseudo-inverse of evecs)."""
        evals = self.evals_m(mi, threshold)

        with store.File(self._evfile % mi, "r") as f:
            if "evinv" in f:
                inv = f["evinv"][:]
                if threshold is not None:
                    nevals = evals.size
                    inv = inv[(-nevals):]
                return inv.T
            logger.info("Inverse not cached, generating pseudo-inverse.")
            return np.linalg.pinv(self.modes_m(mi, threshold)[1])

    @util.cache_last
    def skymodes_m(self, mi, threshold=None):
        """KL modes rotated into the sky (alm) basis."""
        evals, evecs = self.modes_m(mi, threshold=threshold)
        if evals is None:
            raise Exception("Don't seem to be any evals to use.")

        bt = self.beamtransfer
        beam = bt.beam_m(mi).reshape((bt.nfreq, bt.ntel, bt.nsky))
        evecs = evecs.reshape((-1, bt.nfreq, bt.ntel))

        evsky = np.zeros((evecs.shape[0], bt.nfreq, bt.nsky), dtype=np.complex128)
        for fi in range(bt.nfreq):
            evsky[:, fi, :] = np.dot(evecs[:, fi, :], beam[fi])
        return evsky

    # ================= projections =================

    def project_vector_svd_to_kl(self, mi, vec, threshold=None):
        """SVD vector -> KL basis."""
        evals, evecs = self.modes_m(mi, threshold)
        if evals is None:
            return np.zeros((0,), dtype=np.complex128)
        if vec.shape[0] != evecs.shape[1]:
            raise Exception("Vectors are incompatible.")
        return np.dot(evecs, vec)

    def project_vector_kl_to_svd(self, mi, vec, threshold=None):
        """KL vector -> SVD basis (via the cached/pseudo- inverse)."""
        evals, evecs = self.modes_m(mi, threshold)
        if evals is None:
            return np.zeros(self.beamtransfer.ndofmax, dtype=np.complex128)
        if vec.shape[0] != evecs.shape[0]:
            raise Exception("Vectors are incompatible.")
        invmodes = self.invmodes_m(mi, threshold)
        return np.dot(invmodes, vec)

    def project_vector_sky_to_kl(self, mi, vec, threshold=None):
        """Sky alm -> KL basis."""
        tvec = self.beamtransfer.project_vector_sky_to_svd(mi, vec)
        return self.project_vector_svd_to_kl(mi, tvec, threshold)

    def project_matrix_svd_to_kl(self, mi, mat, threshold=None):
        """SVD covariance -> KL basis."""
        evals, evecs = self.modes_m(mi, threshold)
        if (mat.shape[0] != evecs.shape[1]) or (mat.shape[0] != mat.shape[1]):
            raise Exception("Matrix size incompatible.")
        return np.dot(np.dot(evecs, mat), evecs.T.conj())

    def project_matrix_sky_to_kl(self, mi, mat, threshold=None):
        """Sky covariance -> KL basis."""
        mproj = self.beamtransfer.project_matrix_sky_to_svd(mi, mat)
        return self.project_matrix_svd_to_kl(mi, mproj, threshold)

    def project_sky(self, sky, mlist=None, threshold=None, harmonic=False):
        """Project a sky map (nfreq, npol, npix), or with ``harmonic`` its
        alm (nfreq, npol, lmax+1, m), through the KL filter for a set of m;
        a map is transformed on the KL transform's device."""
        if mlist is None:
            mlist = list(range(self.telescope.mmax + 1))
        nmodes = self.beamtransfer.nfreq * self.beamtransfer.ntel
        alm = (
            sky
            if harmonic
            else sht.sphtrans_sky(sky, lmax=self.telescope.lmax, device=self.device)
            .cpu().numpy()
        )

        proj_arr = np.zeros((2 * self.telescope.mmax + 1, nmodes), dtype=np.complex128)
        for mi in comm.partition_list_mpi(mlist):
            p1 = self.project_vector_sky_to_kl(mi, alm[..., mi], threshold)
            if p1.size:
                proj_arr[mi, -p1.size :] = p1
        return proj_arr
