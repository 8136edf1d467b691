"""Timestream simulation and m-mode analysis.

Port of ``driftscan_tpu/pipeline/timestream.py``: the same directory layout
(``timestream_f/<f>/timestream.hdf5``, ``mmodes/<m>/mode.hdf5`` with the SVD
and KL mode files beside it, the ``COMPLETED_M`` marker, ``map_*.hdf5``,
``ps_*.hdf5``), datasets and attrs, so a directory written by one package
opens in the other.  The device work runs in torch on the products' device:

* the two time-axis FFTs are ``torch.fft``;
* the forward SHT of the input maps (K3+K5) and the inverse SHT of every
  map (K14) are :mod:`ops.sht`;
* the forward model is :func:`parallel.mstep.btm_forward_step` and the
  telescope -> SVD -> KL projections are ``ops.projections.block_matvec``,
  each batched over a chunk of m; the map makers' per-m projections are
  the BeamTransfer / KLTransform projection API.

Files go through util.store (HDF5 wherever h5py imports).  The noise draw
is numpy ``default_rng(seed + rank)``, as in the JAX package, so the two
packages draw the same noise.  The pickled :class:`Timestream` names this
package's classes.
"""

from __future__ import annotations

import logging
import os
import pickle

import numpy as np
import torch

from ..core import kltransform
from ..ops import projections, sht
from ..parallel import comm, mstep
from ..util import store, util

logger = logging.getLogger(__name__)

# m-modes projected per device batch (beam, SVD and KL matvecs).
MBATCH = 16


def _freq_pattern(base, nfreq):
    return os.path.join(base, "timestream_f", util.natpattern(nfreq))


def _write_map(path, skymap):
    with store.File(path, "w") as f:
        f.create_dataset("map", data=skymap)


def _spectrum_datasets(f, fisher, band_power, powerspectrum):
    """Common contents of every power-spectrum output file."""
    cv = np.linalg.inv(fisher)
    err = np.sqrt(cv.diagonal())
    f.create_dataset("fisher", data=fisher)
    f.create_dataset("covariance", data=cv)
    f.create_dataset("error", data=err)
    f.create_dataset("correlation", data=cv / np.outer(err, err))
    f.create_dataset("bandpower", data=band_power)
    f.create_dataset("powerspectrum", data=powerspectrum)


def _chunks(seq, size=MBATCH):
    return [seq[s : s + size] for s in range(0, len(seq), size)]


class Timestream:
    """A simulated (or real) visibility timestream and its m-mode products."""

    directory = None
    output_directory = None

    no_m_zero = True

    def __init__(self, tsdir, prodmanager):
        """Create a Timestream rooted at `tsdir` using `prodmanager` products."""
        self.directory = os.path.abspath(tsdir)
        self.output_directory = self.directory
        self.manager = prodmanager

    # ===== products access =====

    @property
    def beamtransfer(self):
        return self.manager.beamtransfer

    @property
    def telescope(self):
        return self.beamtransfer.telescope

    @property
    def device(self) -> torch.device:
        return self.beamtransfer.device

    def _mlist(self):
        """The m indices analysis loops run over (optionally skip m=0)."""
        return list(range(1 if self.no_m_zero else 0, self.telescope.mmax + 1))

    # ===== frequency-ordered timestream files =====

    def _fdir(self, fi):
        return _freq_pattern(self.directory, self.telescope.nfreq) % fi

    def _ffile(self, fi):
        return os.path.join(self._fdir(fi), "timestream.hdf5")

    @property
    def ntime(self):
        with store.File(self._ffile(0), "r") as f:
            return int(f.attrs["ntime"])

    def timestream_f(self, fi):
        """(npairs, ntime) visibility timestream at one frequency."""
        with store.File(self._ffile(fi), "r") as f:
            return f["timestream"][:]

    # ===== m-mode files =====

    def _mdir(self, mi):
        pat = os.path.join(
            self.output_directory, "mmodes", util.natpattern(self.telescope.mmax)
        )
        return pat % abs(mi)

    def _mfile(self, mi):
        return os.path.join(self._mdir(mi), "mode.hdf5")

    def mmode(self, mi):
        """(nfreq, 2, npairs) m-mode of the timestream."""
        with store.File(self._mfile(mi), "r") as f:
            return f["mmode"][:]

    def generate_mmodes(self):
        """FFT the timestream into m-modes (on the device) and store them
        m-ordered: mode m holds (F[m], conj(F[-m]))."""
        marker = os.path.join(self.output_directory, "mmodes", "COMPLETED_M")
        if os.path.exists(marker):
            if comm.rank0():
                logger.info("m-files already generated, skipping")
            return

        tel = self.telescope
        mmax = tel.mmax
        ntime = self.ntime
        lfreq, sfreq, efreq = comm.split_local(tel.nfreq)
        _, sm, em = comm.split_local(mmax + 1)

        local = torch.as_tensor(
            np.stack([self.timestream_f(fi) for fi in range(sfreq, efreq)])
            if lfreq else np.zeros((0, tel.npairs, ntime), dtype=np.complex128),
            dtype=torch.complex128, device=self.device,
        )
        fourier = torch.fft.fft(local, dim=-1) / ntime

        paired = torch.zeros(
            (lfreq, 2, tel.npairs, mmax + 1), dtype=torch.complex128, device=self.device
        )
        paired[:, 0] = fourier[..., : mmax + 1]
        if mmax > 0:
            paired[:, 1, :, 1:] = fourier[..., -mmax:].flip(-1).conj()

        m_major = comm.transpose_blocks(
            paired, (tel.nfreq, 2, tel.npairs, mmax + 1)
        ).permute(3, 0, 1, 2).cpu().numpy()

        for lmi, mi in enumerate(range(sm, em)):
            os.makedirs(self._mdir(mi), exist_ok=True)
            with store.File(self._mfile(mi), "w") as f:
                f.create_dataset("mmode", data=m_major[lmi])
                f.attrs["m"] = mi

        if comm.rank0():
            open(marker, "a").close()
        comm.barrier()

    # ===== SVD modes =====

    def _svdfile(self, mi):
        return os.path.join(self._mdir(mi), "svd.hdf5")

    def mmode_svd(self, mi):
        with store.File(self._svdfile(mi), "r") as f:
            if f["mmode_svd"].shape[0] == 0:
                return np.zeros((0,), dtype=np.complex128)
            return f["mmode_svd"][:]

    def generate_mmodes_svd(self):
        """Project the m-modes into the telescope SVD basis: the per-m
        telescope -> SVD matvecs of a chunk of m as one device batch,
        compacted to each m's retained modes at the file boundary.  A beam
        transfer with its own projection (NoSVD) goes m by m through its
        ``project_vector_telescope_to_svd``."""
        from ..core import beamtransfer

        bt = self.beamtransfer
        tel = self.telescope

        todo = [
            mi
            for mi in comm.mpirange(tel.mmax + 1)
            if not os.path.exists(self._svdfile(mi))
        ]
        if len(todo) < tel.mmax + 1 - len(todo):
            logger.info("Some SVD m-mode files exist; generating %i", len(todo))

        if (
            type(bt).project_vector_telescope_to_svd
            is not beamtransfer.BeamTransfer.project_vector_telescope_to_svd
        ):
            for mi in todo:
                tm = self.mmode(mi).reshape(tel.nfreq, bt.ntel)
                with store.File(self._svdfile(mi), "w") as f:
                    f.create_dataset(
                        "mmode_svd", data=bt.project_vector_telescope_to_svd(mi, tm)
                    )
                    f.attrs["m"] = mi
            comm.barrier()
            return

        for chunk in _chunks(todo):
            tm = np.stack([self.mmode(mi).reshape(tel.nfreq, bt.ntel) for mi in chunk])
            ut = torch.as_tensor(np.stack([bt.beam_ut(mi) for mi in chunk]), device=self.device)
            # one m a call: on the card a batched product's bits depend on
            # the batch, and the m of a chunk depend on the process count
            out = torch.stack(
                [projections.block_matvec(ut[i], tm[i]) for i in range(len(chunk))]
            ).reshape(len(chunk), tel.nfreq * bt.svd_len).cpu().numpy()

            for i, mi in enumerate(chunk):
                idx, _, _ = bt._compact_indices(mi)
                with store.File(self._svdfile(mi), "w") as f:
                    f.create_dataset("mmode_svd", data=out[i][idx])
                    f.attrs["m"] = mi

        comm.barrier()

    # ===== map making (one map maker, three projections) =====

    def alm_full_m(self, mi):
        """Sky alm (nfreq, npol, lmax+1) of m from the raw m-mode (the
        beam's pseudo-inverse)."""
        logger.info("Making %i", mi)
        return self.beamtransfer.project_vector_telescope_to_sky(mi, self.mmode(mi))

    def alm_svd_m(self, mi):
        """Sky alm of m from its SVD-projected mode."""
        return self.beamtransfer.project_vector_svd_to_sky(mi, self.mmode_svd(mi))

    def alm_kl_m(self, mi, wiener=False):
        """Sky alm of m from its KL-filtered mode (optionally Wiener
        weighted by S / (S + N))."""
        logger.info("Making %i", mi)
        kl = self.manager.kltransforms[self.klname]
        klmode = self.mmode_kl(mi)
        if wiener:
            evals = kl.evals_m(mi, self.klthreshold)
            if evals is not None:
                klmode *= evals / (1.0 + evals)
        svdmode = kl.project_vector_kl_to_svd(mi, klmode, threshold=self.klthreshold)
        return self.beamtransfer.project_vector_svd_to_sky(mi, svdmode)

    def collect_alm(self, alm_for_m, mlist=None):
        """The (nfreq, npol, lmax+1, lmax+1) alm of a map: ``alm_for_m(m)``
        for every m (all are evaluated, as in the JAX package), kept for the
        m of ``mlist`` (all when None)."""
        tel = self.telescope
        mall = list(range(tel.mmax + 1))
        alm_list = comm.parallel_map(alm_for_m, mall)
        alm = np.zeros(
            (tel.nfreq, tel.num_pol_sky, tel.lmax + 1, tel.lmax + 1), dtype=np.complex128
        )
        for mi in mall if mlist is None else mlist:
            alm[..., mi] = alm_list[mi]
        return alm

    def _mapmake(self, nside, mapname, alm_for_m, mlist=None):
        """Shared map maker: gather per-m alm columns, inverse SHT on the
        device, write."""
        alm = self.collect_alm(alm_for_m, mlist)
        if comm.rank0():
            skymap = sht.sphtrans_inv_sky(alm, nside, device=self.device)
            _write_map(os.path.join(self.output_directory, mapname), skymap.cpu().numpy())
        comm.barrier()

    def mapmake_full(self, nside, mapname):
        """Direct pseudo-inverse map from the raw m-modes."""
        self._mapmake(nside, mapname, self.alm_full_m)

    def mapmake_svd(self, nside, mapname):
        """Map from the SVD-projected modes."""
        self.generate_mmodes_svd()
        self._mapmake(nside, mapname, self.alm_svd_m)

    def mapmake_kl(self, nside, mapname, wiener=False):
        """Map from the KL-filtered modes (optionally Wiener weighted)."""
        mapfile = os.path.join(self.output_directory, mapname)
        if os.path.exists(mapfile):
            if comm.rank0():
                logger.info("File %s exists. Skipping...", mapfile)
            return

        if not self.manager.kltransforms[self.klname].inverse:
            raise Exception("Need the inverse to make a meaningful map.")

        self._mapmake(
            nside, mapname, lambda mi: self.alm_kl_m(mi, wiener), mlist=self._mlist()
        )

    # ===== KL modes =====

    def set_kltransform(self, klname, threshold=None):
        self.klname = klname
        if threshold is None:
            threshold = self.manager.kltransforms[klname].threshold
        self.klthreshold = threshold

    def _klfile(self, mi):
        return os.path.join(
            self._mdir(mi), f"klmode_{self.klname}_{self.klthreshold:f}.hdf5"
        )

    def mmode_kl(self, mi):
        with store.File(self._klfile(mi), "r") as f:
            if f["mmode_kl"].shape[0] == 0:
                return np.zeros((0,), dtype=np.complex128)
            return f["mmode_kl"][:]

    def generate_mmodes_kl(self):
        """Project the SVD modes through the KL filter: the per-m KL matvecs
        of a chunk of m as one device batch, padded to the largest KL
        dimension and compacted at the file boundary."""
        kl = self.manager.kltransforms[self.klname]
        ndofmax = self.beamtransfer.ndofmax

        todo = [
            mi
            for mi in comm.mpirange(self.telescope.mmax + 1)
            if not os.path.exists(self._klfile(mi))
        ]

        for chunk in _chunks(todo):
            evecs_pad = np.zeros((len(chunk), ndofmax, ndofmax), dtype=np.complex128)
            svd_pad = np.zeros((len(chunk), ndofmax), dtype=np.complex128)
            nkl = np.zeros(len(chunk), dtype=int)
            for i, mi in enumerate(chunk):
                evals, evecs = kl.modes_m(mi, threshold=self.klthreshold)
                if evals is None:
                    continue
                svdm = self.mmode_svd(mi)
                nkl[i] = evecs.shape[0]
                evecs_pad[i, : evecs.shape[0], : evecs.shape[1]] = evecs
                svd_pad[i, : svdm.shape[0]] = svdm

            out = projections.block_matvec(evecs_pad, svd_pad, device=self.device).cpu().numpy()

            for i, mi in enumerate(chunk):
                with store.File(self._klfile(mi), "w") as f:
                    f.create_dataset("mmode_kl", data=out[i, : nkl[i]])
                    f.attrs["m"] = mi

        comm.barrier()

    def collect_mmodes_kl(self):
        """Collect every m's KL data vector into one file."""
        ndofmax = self.beamtransfer.ndofmax

        def padded_kl(mi):
            out = np.zeros(ndofmax, dtype=np.complex128)
            v = self.mmode_kl(mi)
            if v.size:
                out[-v.size :] = v
            return out

        if comm.rank0():
            logger.info("Creating eigenvalues file (process 0 only).")

        evarray = kltransform.collect_m_array(
            list(range(self.telescope.mmax + 1)), padded_kl, (ndofmax,), np.complex128
        )

        if comm.rank0():
            fname = os.path.join(
                self.output_directory, f"klmodes_{self.klname}_{self.klthreshold:f}.hdf5"
            )
            if os.path.exists(fname):
                logger.info("File: %s exists. Skipping...", fname)
                return
            with store.File(fname, "w") as f:
                f.create_dataset("evals", data=evarray)

    def fake_kl_data(self):
        """Replace the KL data with a synthetic draw from the KL spectrum."""
        kl = self.manager.kltransforms[self.klname]

        for mi in comm.mpirange(self.telescope.mmax + 1):
            evals = kl.evals_m(mi)

            if evals is None:
                klmode = np.array([], dtype=np.complex128)
            else:
                amp = np.sqrt((evals + 1.0) / 2.0)
                draw = np.random.standard_normal((amp.size, 2))
                klmode = amp * (draw[:, 0] + 1.0j * draw[:, 1])

            os.makedirs(self._mdir(mi), exist_ok=True)
            with store.File(self._klfile(mi), "w") as f:
                f.create_dataset("mmode_kl", data=klmode)
                f.attrs["m"] = mi

        comm.barrier()

    # ===== power spectrum from data =====

    @property
    def _psfile(self):
        return os.path.join(self.output_directory, f"ps_{self.psname}.hdf5")

    def set_psestimator(self, psname):
        self.psname = psname

    def powerspectrum(self):
        """Quadratic PS estimate from the KL data."""
        if os.path.exists(self._psfile):
            logger.info("File %s exists. Skipping...", self._psfile)
            return

        ps = self.manager.psestimators[self.psname]
        ps.genbands()

        qvals = comm.parallel_map(
            lambda mi: ps.q_estimator(mi, self.mmode_kl(mi)), self._mlist()
        )
        qtotal = np.array(qvals).sum(axis=0)

        fisher, bias = ps.fisher_bias()
        powerspectrum = np.linalg.inv(fisher) @ (qtotal - bias)

        if comm.rank0():
            with store.File(self._psfile, "w") as f:
                _spectrum_datasets(f, fisher, ps.band_power, powerspectrum)

        ps.delbands()
        comm.barrier()
        return powerspectrum

    # ===== pickling =====

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    @property
    def _picklefile(self):
        return os.path.join(self.output_directory, "timestreamobject.pickle")

    def save(self):
        """Pickle the Timestream object into its directory."""
        if comm.rank0():
            with open(self._picklefile, "wb") as f:
                logger.info("=== Saving Timestream object. ===")
                pickle.dump(self, f)

    @classmethod
    def load(cls, tsdir):
        """Load a pickled Timestream."""
        tmp_obj = cls(tsdir, tsdir)
        with open(tmp_obj._picklefile, "rb") as f:
            logger.info("=== Loading Timestream object. ===")
            return pickle.load(f)


def cross_powerspectrum(timestreams, psname, psfile):
    """Cross power spectrum of several timestreams."""
    if os.path.exists(psfile):
        logger.info("File %s exists. Skipping...", psfile)
        return

    ps = timestreams[0].manager.psestimators[psname]
    ps.genbands()

    nstream = len(timestreams)

    def q_pairs(mi):
        qp = np.zeros((nstream, nstream, ps.nbands), dtype=np.float64)
        for ti in range(nstream):
            for tj in range(ti + 1, nstream):
                logger.info("Making m=%i (%i, %i)", mi, ti, tj)
                qp[ti, tj] = ps.q_estimator(
                    mi, timestreams[ti].mmode_kl(mi), timestreams[tj].mmode_kl(mi)
                )
                qp[tj, ti] = qp[ti, tj]
        return qp

    qvals = comm.parallel_map(q_pairs, timestreams[0]._mlist())
    qtotal = np.array(qvals).sum(axis=0)

    fisher, bias = ps.fisher_bias()

    flat = (qtotal - bias).reshape(nstream**2, ps.nbands).T
    powerspectrum = (np.linalg.inv(fisher) @ flat).T.reshape(nstream, nstream, ps.nbands)

    if comm.rank0():
        with store.File(psfile, "w") as f:
            _spectrum_datasets(f, fisher, ps.band_power, powerspectrum)

    ps.delbands()
    comm.barrier()
    return powerspectrum


# ===== simulation =====


def _derive_ntime(mmax, resolution):
    if resolution == 0:
        return 2 * mmax + 1
    return int(np.round(24 * 3600.0 / resolution))


def _project_maps_to_vis(bt, maps, lfreq, sfreq, efreq, sm, em, ntime):
    """Sum the input maps, SHT them (K3+K5) locally in frequency, project
    each chunk of m through the BTM (``btm_forward_step``), and reshard back
    to frequency-major visibilities.

    Returns (npairs, lfreq, ntime) complex128 visibilities on the device.
    """
    tel = bt.telescope
    dev = bt.device
    lmax, mmax, nfreq, npol = tel.lmax, tel.mmax, tel.nfreq, tel.num_pol_sky
    c128 = torch.complex128

    with store.File(maps[0], "r") as f:
        mapshape = f["map"].shape

    if lfreq > 0:
        row_map = np.zeros((lfreq,) + tuple(mapshape[1:]), dtype=np.float64)
        for mapfile in maps:
            with store.File(mapfile, "r") as f:
                row_map += f["map"][sfreq:efreq]
        row_alm = sht.sphtrans_sky(row_map, lmax=lmax, device=dev).reshape(
            (lfreq, npol * (lmax + 1), lmax + 1)
        )
    else:
        row_alm = torch.zeros((0, npol * (lmax + 1), lmax + 1), dtype=c128, device=dev)

    # freq-major alm -> m-major (also trims m > mmax)
    col_alm = comm.transpose_blocks(row_alm, (nfreq, npol * (lmax + 1), mmax + 1))
    col_alm = col_alm.permute(2, 0, 1).reshape(em - sm, nfreq, bt.nsky)

    vis_m = torch.zeros((em - sm, nfreq, bt.ntel), dtype=c128, device=dev)
    for chunk in _chunks(list(range(sm, em))):
        beam = np.stack([bt.beam_m(mi).reshape(nfreq, bt.ntel, bt.nsky) for mi in chunk])
        beam = torch.as_tensor(beam, dtype=c128, device=dev)
        # one m a call, so that an m's bits do not depend on its chunk (the
        # chunks depend on the process count)
        for i, mi in enumerate(chunk):
            j = mi - sm
            vis_m[j : j + 1] = mstep.btm_forward_step(col_alm[j : j + 1], beam[i : i + 1])

    # m-major -> freq-major
    freq_major = comm.transpose_blocks(
        vis_m.permute(0, 2, 1), (mmax + 1, bt.ntel, nfreq)
    ).reshape(mmax + 1, 2, tel.npairs, lfreq)

    # Unwrap the (+m, -m) pairs into FFT ordering (negative m conjugated)
    vis = torch.zeros((tel.npairs, lfreq, ntime), dtype=c128, device=dev)
    vis[..., : mmax + 1] = freq_major[:, 0].permute(1, 2, 0)
    vis[..., ntime - torch.arange(1, mmax + 1, device=dev)] = (
        freq_major[1:, 1].permute(1, 2, 0).conj()
    )
    return vis


def _noise_draw(tel, local_freq, shape, ndays, seed):
    """Complex radiometer noise for the local frequency block (numpy)."""
    noise_ps = tel.noisepower(
        np.arange(tel.npairs)[:, np.newaxis],
        np.array(local_freq)[np.newaxis, :],
        ndays=ndays,
    ).reshape(tel.npairs, len(local_freq), 1)

    rng = (
        np.random.default_rng(seed + comm.rank())
        if seed is not None
        else np.random.default_rng()
    )
    draw = rng.standard_normal(shape + (2,))
    return np.sqrt(noise_ps / 2.0) * (draw[..., 0] + 1.0j * draw[..., 1])


def simulate(m, outdir, maps=(), ndays=None, resolution=0, seed=None, **kwargs):
    """Simulate a visibility timestream and save it to disk.

    Sky maps are SHT'd to alm, projected to visibility m-modes through the
    BTM, given a radiometer noise draw, and inverse-FFT'd to a timestream,
    on the products' device.

    Parameters
    ----------
    m : ProductManager
    outdir : str
        Output timestream directory.
    maps : list of str
        Healpix map files whose sum is the simulated sky.
    ndays : int, optional
        Observing days for the noise level (0 = noiseless).
    resolution : float, optional
        Time resolution in seconds (0 = derive from mmax).
    seed : int, optional
        RNG seed (offset by process rank).
    """
    bt = m.beamtransfer
    tel = bt.telescope

    lfreq, sfreq, efreq = comm.split_local(tel.nfreq)
    local_freq = list(range(sfreq, efreq))
    _, sm, em = comm.split_local(tel.mmax + 1)

    if ndays is None:
        ndays = tel.ndays
    ntime = _derive_ntime(tel.mmax, resolution)

    if maps:
        col_vis = _project_maps_to_vis(bt, maps, lfreq, sfreq, efreq, sm, em, ntime)
    else:
        col_vis = torch.zeros(
            (tel.npairs, lfreq, ntime), dtype=torch.complex128, device=bt.device
        )

    if ndays > 0:
        col_vis += torch.as_tensor(
            _noise_draw(tel, local_freq, tuple(col_vis.shape), ndays, seed), device=bt.device
        )

    vis_stream = (torch.fft.ifft(col_vis, dim=-1) * ntime).cpu().numpy()

    tphi = np.linspace(0, 2 * np.pi, ntime, endpoint=False)

    tstream = Timestream(outdir, m)

    for lfi, fi in enumerate(local_freq):
        os.makedirs(tstream._fdir(fi), exist_ok=True)
        with store.File(tstream._ffile(fi), "w") as f:
            f.create_dataset("timestream", data=vis_stream[:, lfi])
            f.create_dataset("phi", data=tphi)

            f.create_dataset("feedmap", data=tel.feedmap)
            f.create_dataset("feedconj", data=tel.feedconj)
            f.create_dataset("feedmask", data=tel.feedmask)
            f.create_dataset("uniquepairs", data=tel.uniquepairs)
            f.create_dataset("baselines", data=tel.baselines)

            f.attrs["beamtransfer_path"] = os.path.abspath(bt.directory)
            f.attrs["ntime"] = ntime

    tstream.save()
    comm.barrier()
    return tstream
