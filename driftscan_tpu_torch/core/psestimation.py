"""Quadratic power-spectrum estimation (Tegmark-style Fisher forecasting).

Port of ``driftscan_tpu/core/psestimation.py``: band definitions
(polar/cartesian), per-band angular power spectra, the q-estimator, and
Fisher/bias accumulation over m-modes.  The per-band C_l arrays are built
on the host with the matmul quadrature in skymodel.Corr21cm and kept on
the device; per m, PSExact projects every band into the KL basis with the
sandwich kernel and contracts the projections with the Fisher-trace
kernel (ops.projections), so only the (nbands, nbands) matrix comes back
to the host.
"""

from __future__ import annotations

import abc
import logging
import os
import time

import numpy as np
import torch

from .. import config
from ..ops import projections
from ..parallel import comm
from ..util import store, util
from . import skymodel

logger = logging.getLogger(__name__)


def uniform_band(k, kstart, kend):
    return ((k > kstart) & (k < kend)).astype(np.float64)


def bandfunc_2d_polar(ks, ke, ts, te):
    """Indicator of the polar annulus ks <= k < ke, ts <= theta <= te."""

    def band(k, mu):
        theta = np.arccos(np.clip(mu, -1.0, 1.0))
        inside = (k >= ks) & (k < ke) & (theta >= ts) & (theta <= te)
        return inside.astype(np.float64)

    return band


def bandfunc_2d_cart(kpar_s, kpar_e, kperp_s, kperp_e):
    """Indicator of the cartesian cell in (k_parallel, k_perp)."""

    def band(k, mu):
        kpar = k * mu
        kperp = k * np.sqrt(1.0 - mu**2)
        inside = (
            (kpar >= kpar_s)
            & (kpar <= kpar_e)
            & (kperp >= kperp_s)
            & (kperp < kperp_e)
        )
        return inside.astype(np.float64)

    return band


_SPACINGS = {
    "log": lambda a, b, n, ep: np.logspace(np.log10(a), np.log10(b), n, endpoint=ep),
    "linear": lambda a, b, n, ep: np.linspace(a, b, n, endpoint=ep),
}


def range_config(lst):
    """Expand a list of {spacing, start, stop, num} dicts into bin edges.

    Only the final segment includes its endpoint, so consecutive segments
    chain into one monotone edge array.
    """
    segments = []
    for i, item in enumerate(lst):
        if not isinstance(item, dict):
            raise Exception("Require a dict.")
        is_last = i == len(lst) - 1
        make = _SPACINGS.get(item["spacing"])
        if make is not None:
            edges = make(item["start"], item["stop"], item["num"], is_last)
        else:
            edges = item
        segments.append(np.atleast_1d(edges))
    return np.concatenate(segments)


def decorrelate_ps(ps, fisher):
    """Decorrelate a power spectrum estimate (Tegmark window trick).

    The mixing matrix M = L^-1 / rowsum(L^T) (L the Fisher Cholesky)
    makes the window functions W = M F have unit row sums and diagonal
    band covariance.  Returns (decorrelated ps, errors, windows).
    """
    L = np.linalg.cholesky(fisher)
    mixing = np.linalg.inv(L) / L.T.sum(axis=1)[:, np.newaxis]

    windows = mixing @ fisher
    errors = np.sqrt((mixing @ fisher @ mixing.T).diagonal())
    return windows @ ps, errors, windows


def decorrelate_ps_file(fname):
    with store.File(fname, "r") as f1:
        return decorrelate_ps(f1["powerspectrum"][:], f1["fisher"][:])


class PSEstimation(config.Reader, metaclass=abc.ABCMeta):
    """Base class for quadratic power spectrum estimation (driftscan's
    config keys)."""

    bandtype = config.Property(proptype=str, default="polar")

    k_bands = config.Property(
        proptype=range_config,
        default=lambda: np.linspace(0.0, 0.4, 20, endpoint=True),
    )
    num_theta = config.Property(proptype=int, default=1)

    kpar_bands = config.Property(
        proptype=range_config,
        default=lambda: np.linspace(0.0, 0.4, 20, endpoint=True),
    )
    kperp_bands = config.Property(
        proptype=range_config,
        default=lambda: np.linspace(0.0, 0.4, 20, endpoint=True),
    )

    threshold = config.Property(proptype=float, default=0.0)

    unit_bands = config.Property(proptype=bool, default=True)

    zero_mean = config.Property(proptype=bool, default=True)

    crosspower = False

    clarray = None

    fisher = None
    bias = None

    def __init__(self, kltrans, subdir="ps"):
        self.kltrans = kltrans
        self.telescope = kltrans.telescope
        self.psdir = self.kltrans.evdir + "/" + subdir + "/"

        if comm.rank0() and not os.path.exists(self.psdir):
            os.makedirs(self.psdir)
        comm.barrier()

    def __getstate__(self):
        # Band window functions are closures (unpicklable) and the band
        # C_l arrays are bulky: drop them; genbands() rebuilds on demand.
        state = self.__dict__.copy()
        for key in ("band_func", "band_pk", "clarray", "_clarray_dev", "_bp_cache"):
            state.pop(key, None)
        return state

    @property
    def nbands(self):
        return self.k_center.size

    def num_evals(self, mi):
        evals = self.kltrans.modes_m(mi, threshold=self.threshold)[0]
        return evals.size if evals is not None else 0

    # ============ band construction ============

    @staticmethod
    def _cell_edges(radial_edges, angular_edges):
        """2D cell bounds from two edge arrays.

        Cells are ordered radial-major within each angular row (matching
        the file layout consumers expect).  Returns (r_lo, r_hi, a_lo,
        a_hi) flattened over the (n_ang, n_rad) grid.
        """
        r_lo, r_hi = radial_edges[:-1], radial_edges[1:]
        a_lo, a_hi = angular_edges[:-1], angular_edges[1:]
        na, nr = a_lo.size, r_lo.size
        return (
            np.tile(r_lo, na),
            np.tile(r_hi, na),
            np.repeat(a_lo, nr),
            np.repeat(a_hi, nr),
        )

    def _make_polar_bands(self):
        self.theta_bands = np.linspace(
            0.0, np.pi / 2.0, self.num_theta + 1, endpoint=True
        )
        self.k_start, self.k_end, self.theta_start, self.theta_end = (
            self._cell_edges(self.k_bands, self.theta_bands)
        )
        self.k_center = 0.5 * (self.k_start + self.k_end)
        self.theta_center = 0.5 * (self.theta_start + self.theta_end)

        self.band_func = [
            bandfunc_2d_polar(*b)
            for b in zip(self.k_start, self.k_end, self.theta_start, self.theta_end)
        ]

    def _make_cartesian_bands(self):
        self.kpar_start, self.kpar_end, self.kperp_start, self.kperp_end = (
            self._cell_edges(self.kpar_bands, self.kperp_bands)
        )
        self.kpar_center = 0.5 * (self.kpar_start + self.kpar_end)
        self.kperp_center = 0.5 * (self.kperp_start + self.kperp_end)
        self.k_center = np.hypot(self.kpar_center, self.kperp_center)

        self.band_func = [
            bandfunc_2d_cart(*b)
            for b in zip(
                self.kpar_start, self.kpar_end, self.kperp_start, self.kperp_end
            )
        ]

    def genbands(self):
        """Precompute the P(k, mu) bands and their angular power spectra."""
        logger.info("Generating bands...")

        makers = {
            "polar": self._make_polar_bands,
            "cartesian": self._make_cartesian_bands,
        }
        if self.bandtype not in makers:
            raise Exception(f"Bandtype {self.bandtype} is not supported.")
        makers[self.bandtype]()

        cr = skymodel.Corr21cm()
        cr.ps_2d = False

        if self.unit_bands:
            # Bands are sections of the fiducial spectrum (each band's
            # fiducial amplitude is 1).
            def section(indicator):
                return lambda k, mu: cr.ps_vv(k) * indicator(k, mu)

            self.band_pk = [section(f) for f in self.band_func]
            self.band_power = np.ones_like(self.k_center)
        else:
            self.band_pk = self.band_func
            self.band_power = cr.ps_vv(self.k_center)

        if self.clarray is None:
            self.make_clzz_array()

        logger.info("Done.")

    def make_clzz(self, pk):
        """Angular power spectrum of one band's P(k, mu)."""
        crt = skymodel.Corr21cm(ps=pk, redshift=1.5)
        crt.ps_2d = True

        clzz = skymodel.im21cm_model(
            self.telescope.lmax,
            self.telescope.frequencies,
            self.telescope.num_pol_sky,
            cr=crt,
            temponly=True,
        )
        logger.info("Rank: %i - Finished making band.", comm.rank())
        return clzz

    def make_clzz_array(self):
        """Build the (nbands, lmax+1, nfreq, nfreq) band C_l array.

        Each process fills its local block of bands; the allreduce stitches
        the full array together everywhere (zeros elsewhere).
        """
        tel = self.telescope
        shape = (self.nbands, tel.lmax + 1, tel.nfreq, tel.nfreq)
        local = np.zeros(shape, dtype=np.float64)

        _, start, end = comm.split_local(self.nbands)
        for bi in range(start, end):
            local[bi] = self.make_clzz(self.band_pk[bi])

        self.clarray = comm.allreduce(local)

    def delbands(self):
        """Drop the cached band C_l arrays to free memory."""
        self.clarray = None

    # ============ Fisher accumulation ============

    def fisher_bias_m(self, mi):
        """Fisher matrix and bias for one m."""
        if self.num_evals(mi) > 0:
            logger.info("Making fisher (for m=%i).", mi)
            fisher, bias = self._work_fisher_bias_m(mi)
        else:
            logger.info("No evals (for m=%i), skipping.", mi)
            fisher = np.zeros((self.nbands, self.nbands), dtype=np.complex128)
            bias = np.zeros((self.nbands,), dtype=np.complex128)
        return fisher, bias

    @abc.abstractmethod
    def _work_fisher_bias_m(self, mi):
        """Per-m Fisher/bias worker (implemented by subclasses)."""

    def generate(self, regen=False):
        """Accumulate the total Fisher matrix and bias, and save."""
        st = time.time()
        if comm.rank0():
            logger.info("======== Starting PS calculation ========")

        ffile = self.psdir + "/fisher.hdf5"
        if os.path.exists(ffile) and not regen:
            logger.info("Fisher matrix file: %s exists. Skipping...", ffile)
            return

        comm.barrier()

        self.genbands()

        zlist = list(enumerate(range(self.telescope.mmax + 1)))
        llist = comm.partition_list_mpi(zlist)
        fisher_bias_list = [self.fisher_bias_m(item) for ind, item in llist]

        if fisher_bias_list:
            fisher_loc, bias_loc = zip(*fisher_bias_list)
            fisher_loc = np.sum(np.array(fisher_loc), axis=0).real
            bias_loc = np.sum(np.array(bias_loc), axis=0).real
        else:
            fisher_loc = np.zeros((self.nbands, self.nbands))
            bias_loc = np.zeros((self.nbands,))

        self.fisher = comm.allreduce(fisher_loc)
        self.bias = comm.allreduce(bias_loc)

        if comm.rank0():
            logger.info(
                "======== Ending PS calculation (time=%f) ========",
                time.time() - st,
            )

            if not (self.fisher == 0).all():
                cv = np.linalg.pinv(self.fisher, rcond=1e-8)
                err = cv.diagonal() ** 0.5
                cr = cv / np.outer(err, err)
            else:
                cv = np.zeros_like(self.fisher)
                err = cv.diagonal()
                cr = np.zeros_like(self.fisher)

            # driftscan's file contract: result datasets plus the band-grid
            # geometry for whichever band parameterisation was used
            datasets = {
                "fisher": self.fisher,
                "bias": self.bias,
                "covariance": cv,
                "errors": err,
                "correlation": cr,
                "band_power": self.band_power,
            }
            grid_keys = {
                "polar": (
                    "k_start", "k_end", "k_center",
                    "theta_start", "theta_end", "theta_center",
                    "k_bands", "theta_bands",
                ),
                "cartesian": (
                    "kpar_start", "kpar_end", "kpar_center",
                    "kperp_start", "kperp_end", "kperp_center",
                    "kpar_bands", "kperp_bands",
                ),
            }
            for key in grid_keys.get(self.bandtype, ()):
                datasets[key] = getattr(self, key)

            with store.File(self.psdir + "/fisher.hdf5", "w") as f:
                f.attrs["bandtype"] = np.bytes_(self.bandtype)
                for name, data in datasets.items():
                    f.create_dataset(name, data=data)
        comm.barrier()

    def fisher_file(self):
        """Open handle of the Fisher file."""
        return store.File(self.psdir + "fisher.hdf5", "r")

    def fisher_bias(self):
        with store.File(self.psdir + "/fisher.hdf5", "r") as f:
            return f["fisher"][:], f["bias"][:]

    # ============ the q estimator ============

    def _whiten_to_sky(self, mi, vec, evals, evecs):
        """Inverse-covariance weight a KL vector and rotate it to the sky.

        Returns (kl_weighted, sky) where kl_weighted = vec / (evals + 1)
        and sky is its image under (KL -> SVD -> sky), conjugate transform.
        """
        weighted = (vec.T / (evals + 1.0)).T
        svd = evecs.T.conj() @ weighted
        sky = self.kltrans.beamtransfer.project_vector_svd_to_sky(
            mi, svd, conj=True
        )
        return weighted, sky

    def q_estimator(self, mi, vec1, vec2=None, noise=False):
        """Estimate per-band q parameters from KL-basis data vectors.

        q_a = y^H C^-1 C_a C^-1 x evaluated in the sky basis (TT only),
        optionally with a trailing noise-band entry.
        """
        evals, evecs = self.kltrans.modes_m(mi)

        nq = self.nbands + 1 if noise else self.nbands
        if evals is None:
            return np.zeros((nq,) + vec1.shape[1:])

        x0, x_sky = self._whiten_to_sky(mi, vec1, evals, evecs)
        if vec2 is None:
            y0, y_sky = x0, x_sky
        else:
            y0, y_sky = self._whiten_to_sky(mi, vec2, evals, evecs)

        # q_a = sum_{l,f,g} y*[f,l] C^a_l[f,g] x[g,l] on the temperature row
        xv = x_sky[:, 0, :]  # (nfreq, lside, ...)
        yv = y_sky[:, 0, :]

        qa = np.zeros((nq,) + vec1.shape[1:])
        for bi, cl in enumerate(self.clarray):
            cx = np.einsum("lfg,gl...->fl...", cl.astype(np.complex128), xv)
            qa[bi] = np.sum((yv.conj() * cx).real, axis=(0, 1))

        if noise:
            noisemodes = 0.0 if self.crosspower else 1.0
            noisemodes = noisemodes + (evals if self.zero_mean else 0.0)
            qa[-1] = np.sum((x0 * y0.conj()).T.real * noisemodes, axis=-1)

        return qa.real if np.iscomplexobj(qa) else qa


class PSExact(PSEstimation):
    """Exact Fisher calculation by forward-projecting band covariances."""

    @property
    def _cfile(self):
        return (
            self.psdir
            + "/ps_c_m_"
            + util.intpattern(self.telescope.mmax)
            + "_b_"
            + util.natpattern(self.nbands - 1)
            + ".hdf5"
        )

    @property
    def device(self) -> torch.device:
        return self.kltrans.beamtransfer.device

    _clarray_dev = None

    def _band_spectra(self) -> torch.Tensor:
        """The band C_l array on the device, float64 (cached)."""
        if self._clarray_dev is None or self._clarray_dev.device != self.device:
            self._clarray_dev = torch.as_tensor(
                np.asarray(self.clarray, dtype=np.float64), device=self.device
            )
        return self._clarray_dev

    def delbands(self):
        super().delbands()
        self._clarray_dev = None

    def makeproj(self, mi, bi):
        """Project one band's angular power spectrum into the KL basis."""
        clarray = self.clarray[bi].reshape((1, 1) + self.clarray[bi].shape)
        svdmat = self.kltrans.beamtransfer.project_matrix_sky_to_svd(
            mi, clarray, temponly=True
        )
        return self.kltrans.project_matrix_svd_to_kl(mi, svdmat, self.threshold)

    # Above this KL dimension the band projections spill to disk instead
    # of being held in memory together.
    _disk_cache_ndof = 500

    def _use_disk(self, mi):
        return self.num_evals(mi) >= self._disk_cache_ndof

    def _sky_modes_t(self, mi):
        """KL modes rotated to the temperature sky basis, (nkl, F, lside) on
        the device: G = evecs @ B_svd restricted to the Stokes-I row; the
        band projections are then G C_b G^H for every band at once."""
        kl = self.kltrans
        bt = kl.beamtransfer
        evals, evecs = kl.modes_m(mi, threshold=self.threshold)
        if evals is None or evecs.shape[0] == 0:
            return None

        idx, _, _ = bt._compact_indices(mi)
        nkl = evecs.shape[0]
        padded = torch.zeros(
            (nkl, bt.nfreq * bt.svd_len), dtype=torch.complex128, device=self.device
        )
        padded[:, torch.as_tensor(idx, device=self.device)] = torch.as_tensor(
            evecs, dtype=torch.complex128, device=self.device
        )
        padded = padded.reshape(nkl, bt.nfreq, bt.svd_len)

        bsvd_t = bt.device_beam_svd([mi])[0][:, :, 0, :]  # (F, S, lside)
        return torch.einsum("kfa,fal->kfl", padded, bsvd_t)

    def _batchable_proj(self):
        """True when the one-shot all-band projection applies: the standard
        SVD layout (a beam transfer with its own projections, as NoSVD,
        goes band by band) and no makeproj override."""
        from . import beamtransfer

        bt = self.kltrans.beamtransfer
        return (
            type(bt).project_matrix_sky_to_svd
            is beamtransfer.BeamTransfer.project_matrix_sky_to_svd
            and type(self).makeproj is PSExact.makeproj
        )

    def cacheproj(self, mi):
        """Cache the band projections (device memory for small, disk for
        large): all bands in one sandwich launch, or band by band where a
        subclass overrides :meth:`makeproj`."""
        self._bp_cache = []

        projs = None
        if self._batchable_proj():
            g = self._sky_modes_t(mi)
            if g is None:
                projs = torch.zeros(
                    (self.nbands, 0, 0), dtype=torch.complex128, device=self.device
                )
            else:
                projs = projections.band_covariance_projection(g, self._band_spectra())

        if projs is not None and not self._use_disk(mi):
            self._bp_cache = projs
            return

        for bi in range(self.nbands):
            if projs is not None:
                projm = projs[bi].cpu().numpy()
            else:
                logger.info("Generating cache for m=%i band=%i", mi, bi)
                projm = self.makeproj(mi, bi)
            if self._use_disk(mi):
                logger.info("Creating cache file: %s", self._cfile % (mi, bi))
                with store.File(self._cfile % (mi, bi), "w") as f:
                    f.create_dataset("proj", data=projm)
            else:
                self._bp_cache.append(projm)

    def delproj(self, mi):
        self._bp_cache = []
        for bi in range(self.nbands):
            store.remove(self._cfile % (mi, bi))

    def getproj(self, mi, bi):
        if not self._use_disk(mi):
            return self._bp_cache[bi]
        with store.File(self._cfile % (mi, bi), "r") as f:
            return f["proj"][:]

    # Device working-set budget for one chunk of band projections in the
    # disk-streamed Fisher contraction (bytes; complex128 entries).
    _fisher_chunk_bytes = 512 * 2**20

    def _getproj_chunk(self, mi, b_lo, b_hi):
        """Load bands [b_lo, b_hi) of the projection cache as one stack on
        the device."""
        return torch.as_tensor(
            np.asarray([self.getproj(mi, bi) for bi in range(b_lo, b_hi)]),
            device=self.device,
        )

    def _work_fisher_bias_m(self, mi):
        """Exact per-m Fisher: F_ab = sum_ij C_a[i,j] C_b[j,i] w_i w_j with
        inverse-covariance weights w = 1/(1 + lambda).

        Both cases run the trace on the device
        (ops.projections.fisher_trace_block); the disk-cached case streams
        band *chunks* (each band is read O(nbands/chunk) times rather than
        O(nbands)).  The bias term vanishes for the zero-mean exact
        estimator.
        """
        evals = self.kltrans.evals_m(mi, self.threshold)
        bias = np.zeros(self.nbands, dtype=np.complex128)

        self.cacheproj(mi)
        w = torch.as_tensor(1.0 / (evals + 1.0), device=self.device)

        if not self._use_disk(mi):
            stack = self._bp_cache
            if not isinstance(stack, torch.Tensor):
                stack = torch.as_tensor(np.asarray(stack), device=self.device)
            fisher = projections.fisher_trace_block(stack, stack, w).cpu().numpy()
        else:
            nkl = evals.size
            chunk = max(1, int(self._fisher_chunk_bytes // max(nkl * nkl * 16, 1)))
            edges = list(range(0, self.nbands, chunk)) + [self.nbands]
            fisher = np.zeros((self.nbands, self.nbands), dtype=np.complex128)
            for ai in range(len(edges) - 1):
                a_lo, a_hi = edges[ai], edges[ai + 1]
                c_a = self._getproj_chunk(mi, a_lo, a_hi)
                fisher[a_lo:a_hi, a_lo:a_hi] = (
                    projections.fisher_trace_block(c_a, c_a, w).cpu().numpy()
                )
                for bi in range(ai):
                    b_lo, b_hi = edges[bi], edges[bi + 1]
                    c_b = self._getproj_chunk(mi, b_lo, b_hi)
                    f_ab = projections.fisher_trace_block(c_a, c_b, w).cpu().numpy()
                    fisher[a_lo:a_hi, b_lo:b_hi] = f_ab
                    # Hermitian in the band indices (C_a, C_b Hermitian)
                    fisher[b_lo:b_hi, a_lo:a_hi] = f_ab.conj().T

        self.delproj(mi)
        return fisher, bias
