"""Generation, storage and application of Beam Transfer Matrices.

Port of ``driftscan_tpu/core/beamtransfer.py``: the same on-disk layout
(``beam_m/<m>/beam.hdf5`` with the compact l >= m storage,
``beam_m/<m>/svd.hdf5``, ``svdspectrum.hdf5``, completion markers, pickled
telescope) and the same projection API, with the device work in torch on
the telescope's device:

* the BTMs come from the device-resident tables of
  :func:`parallel.resident.btm_resident`, fetched once, bit-truncated and
  written m by m; the tables stay in host memory, so the SVD stage never
  reads ``beam.hdf5`` back;
* the per-(m, freq) triple SVD runs as one batched program per m-chunk
  (ops.linalg.triple_svd_batched) in complex128; the sky -> SVD beams it
  makes stay on the device for the KL stage;
* the projections are the programs of ops.projections, compacted at the
  API boundary to driftscan's variable-size layout.

The variants of the SVD stage: :class:`BeamTransferTempSVD` (a plain SVD
of the Stokes I block), :class:`BeamTransferFullSVD` (a plain SVD of the
whole beam), both batched like the triple SVD through
``projections.simple_svd`` (K18b), and :class:`BeamTransferNoSVD` (no
compression: the telescope basis, identity projections).

Files go through util.store (HDF5 wherever h5py imports).  Not ported yet,
raising ``NotImplementedError`` with its ROADMAP line: the chunked
streaming generate (``resident: never``, or tables over budget).
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from .. import config
from ..ops import projections, truncate
from ..parallel import comm
from ..util import store, util

logger = logging.getLogger(__name__)

_CHUNKED_NOT_PORTED = (
    "the chunked streaming BTM generate is not ported yet: ROADMAP.md, "
    "modules to port, item 7.3"
)


class BeamTransfer(config.Reader):
    """Manage calculation, storage and use of beam transfer matrices.

    Parameters
    ----------
    directory : str
        Directory to read/write the products.
    telescope : TransitTelescope, optional
        If None, the one pickled in the directory.
    device : optional
        Move the telescope (given or unpickled) to this device; by default
        it stays where it is (a pickle names the device it was written
        on).  A telescope on the card raises on a host without one:
        nothing runs on the CPU unless ``device="cpu"`` asks for it.
    """

    mem_chunk = config.Property(proptype=float, default=3.0)

    svcut = config.Property(proptype=float, default=1e-6)
    polsvcut = config.Property(proptype=float, default=1e-4)

    truncate = config.Property(proptype=bool, default=True)

    # Product-file codec: "bitshuffle" (bitshuffle+LZ4 plugin, LZF+shuffle
    # where it cannot be built), or "lzf" / "none" explicitly.
    compression = config.Property(proptype=str, default="bitshuffle")

    # The batched KL path assumes this beamtransfer's stored beams are
    # noise-prewhitened and laid out (F, svd_len, npol, nl).
    kl_mbatch_ok = True
    truncate_rel = config.Property(proptype=float, default=1e-7)
    truncate_maxl = config.Property(proptype=float, default=1e-8)
    chunk_cache_size = config.Property(proptype=int, default=128)

    # Noise-weight the beam matrix before SVD compression.
    noise_weight = True

    # Device-resident BTM generation: "auto" uses it when the (l, m)
    # tables fit the budgets below, "always" / "never" force it.  The
    # alternative (the chunked streaming generate) is not ported yet.
    resident = config.Property(proptype=str, default="auto")
    resident_hbm_gb = config.Property(proptype=float, default=10.0)
    resident_host_gb = config.Property(proptype=float, default=8.0)

    # m-modes SVD-compressed per batch (1 writes m by m).
    svd_mbatch = config.Property(proptype=int, default=8)

    def _comp_kwargs(self, dtype):
        return store.compression_kwargs(dtype, self.compression)

    # ====== internal filenames ======

    @property
    def _picklefile(self):
        return self.directory + "/telescopeobject.pickle"

    def _mdir(self, mi):
        pat = self.directory + "/beam_m/" + util.natpattern(self.telescope.mmax)
        return pat % abs(mi)

    def _mfile(self, mi):
        return self._mdir(mi) + "/beam.hdf5"

    def _svdfile(self, mi):
        return self._mdir(mi) + "/svd.hdf5"

    @property
    def _telescope_pickle(self):
        return pickle.dumps(self.telescope)

    # In-memory m-major BTM tables (set by the resident generate path):
    # (pos_m, neg_m) host complex arrays, truncated exactly like the
    # files, serving `beam_m` without the file read-back.
    _mem_beam = None

    def __init__(self, directory, telescope=None, device=None):
        self.directory = directory
        self.telescope = telescope
        # seconds per generation stage of this process, for reports
        self.timings = {}

        if comm.rank0() and not os.path.exists(directory):
            os.makedirs(directory)
        comm.barrier()
        # products written with the bitshuffle codec must open in every
        # consumer, readers included
        store.register_codecs()

        if self.telescope is None:
            logger.info("Attempting to read telescope from disk...")
            try:
                with open(self._picklefile, "rb") as f:
                    self.telescope = pickle.load(f)
            except (IOError, pickle.UnpicklingError) as e:
                raise RuntimeError("Could not load Telescope object from disk.") from e
        if device is not None:
            self.telescope.to(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"the telescope of {directory} is on {self.device} and no CUDA device "
                'is available; pass device="cpu" to run it on the host'
            )

    @property
    def device(self) -> torch.device:
        return self.telescope.device

    def _dev(self, x, dtype=torch.complex128) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ====== loading m-order beams ======

    @util.cache_last
    def beam_m(self, mi: int, fi: Optional[int] = None) -> np.ndarray:
        """Beam transfer matrix for m.

        Returns (nfreq, 2, nbase, npol_sky, lmax+1) -- or without the
        leading frequency axis when `fi` is given -- re-inflated from the
        compact included/l>=m storage with zeros elsewhere.
        """
        tel = self.telescope
        nfreq, nbase = tel.nfreq, tel.nbase
        npol, lmax = tel.num_pol_sky, tel.lmax

        ind_list = [
            np.arange(2),
            tel.included_baseline,
            tel.included_pol,
            np.arange(mi, lmax + 1),
        ]
        shape = (2, nbase, npol, lmax + 1)

        if fi is None:
            ind_list = [tel.included_freq] + ind_list
            shape = (nfreq,) + shape

        bf = np.zeros(shape, dtype=np.complex128)

        if fi is not None:
            fi_file = _find_index_sorted(tel.included_freq, fi)
            if fi_file is None:
                return bf
        else:
            fi_file = None

        ind = np.ix_(*ind_list)
        if self._mem_beam is not None:
            block = self._mem_mblock(mi)
            bf[ind] = block if fi_file is None else block[fi_file]
        else:
            bf[ind] = _load_beam_f(self._mfile(mi), "beam_m", fi_file)
        return bf

    def _mem_mblock(self, mi):
        """File-layout block (nf_inc, 2, nb_inc, np_inc, nl - mi) for m
        from the in-memory tables (same values as the beam.hdf5 dataset:
        the tables are stored post-truncation)."""
        tel = self.telescope
        nl = tel.lmax + 1
        nf_inc = len(tel.included_freq)
        nb_inc = len(tel.included_baseline)
        np_inc = len(tel.included_pol)
        pos_m, neg_m = self._mem_beam

        def org(x):
            # (nu, np_inc, nl - mi) -> (nf_inc, nb_inc, np_inc, nl - mi)
            return x.reshape(nb_inc, nf_inc, np_inc, nl - mi).transpose(1, 0, 2, 3)

        blk = np.zeros((nf_inc, 2, nb_inc, np_inc, nl - mi), dtype=np.complex128)
        blk[:, 0] = org(pos_m[mi][:, :np_inc, mi:])
        if mi > 0:
            # B(-m) is packed as (-1)^m conj(B(-m)) at read time; the raw
            # negative-m coefficients are stored unpacked.
            blk[:, 1] = org((-1) ** mi * np.conj(neg_m[mi - 1][:, :np_inc, mi:]))
        return blk

    # ====== pseudo-inverse beams ======

    @util.cache_last
    def invbeam_m(self, mi):
        """Moore-Penrose pseudo-inverse of the beam for m,
        (nfreq, npol_sky, lmax+1, ntel)."""
        beam = self.beam_m(mi)
        tel = self.telescope

        if self.noise_weight:
            noisew = tel.noisepower(np.arange(tel.npairs), 0).flatten() ** (-0.5)
            beam = beam * noisew[:, np.newaxis, np.newaxis]

        beam = beam.reshape((self.nfreq, self.ntel, self.nsky))
        ibeam = projections.block_pinv(self._dev(beam), rcond=1e-6).cpu().numpy()

        if self.noise_weight:
            ibeam = ibeam.reshape((-1, tel.npairs))
            ibeam = ibeam * noisew

        return ibeam.reshape((self.nfreq, tel.num_pol_sky, tel.lmax + 1, self.ntel))

    # ====== SVD beam loading ======

    # In-memory SVD products (filled by the batched SVD writer when the
    # resident generate is active): {m: {dset_name: array}} holding the
    # same complex128 values the svd.hdf5 files store, so the KL stage
    # in the same process skips the file read-back.
    _mem_svd = None

    # Device-resident sky->SVD beams (same gate, plus a device budget):
    # {m: (nfreq, svd_len, npol, nl) complex128 tensor}.
    _dev_svd = None

    def _dev_svd_fits(self):
        """True when the full device beam-SVD set fits half the device budget."""
        tel = self.telescope
        nfreq, npol, nl = tel.nfreq, tel.num_pol_sky, tel.lmax + 1
        per_m = nfreq * self.svd_len * npol * nl * 16
        return (tel.mmax + 1) * per_m <= self.resident_hbm_gb * 2**29

    def device_beam_svd(self, ms):
        """The (len(ms), nfreq, svd_len, npol, nl) beam batch on the device.

        From the tensors the SVD stage kept where every requested m has
        one (the very values the files were written from), else uploaded
        from ``beam_svd``.
        """
        if self._dev_svd is not None and all(mi in self._dev_svd for mi in ms):
            return torch.stack([self._dev_svd[mi] for mi in ms])
        return self._dev(np.stack([self.beam_svd(mi) for mi in ms]))

    def _svd_mem(self, mi, name, fi=None):
        if self._mem_svd is not None:
            ent = self._mem_svd.get(mi)
            if ent is not None and name in ent:
                return ent[name] if fi is None else ent[name][fi]
        return _load_beam_f(self._svdfile(mi), name, fi)

    @util.cache_last
    def beam_svd(self, mi: int, fi: Optional[int] = None) -> np.ndarray:
        """SVD beam matrix (sky -> SVD basis), (nfreq, svd_len, npol, lmax+1)."""
        return self._svd_mem(mi, "beam_svd", fi)

    @util.cache_last
    def invbeam_svd(self, mi: int, fi: Optional[int] = None) -> np.ndarray:
        """Pseudo-inverse SVD beam, (nfreq, npol, lmax+1, svd_len)."""
        return self._svd_mem(mi, "invbeam_svd", fi)

    @util.cache_last
    def beam_ut(self, mi: int, fi: Optional[int] = None) -> np.ndarray:
        """Telescope -> SVD projection (U^H), (nfreq, svd_len, ntel)."""
        return self._svd_mem(mi, "beam_ut", fi)

    @util.cache_last
    def beam_singularvalues(self, mi: int) -> np.ndarray:
        """Singular values, (nfreq, svd_len)."""
        return self._svd_mem(mi, "singularvalues")

    # ====== generation ======

    def generate(self, regen=False, skip_svd=False, skip_svd_inv=False):
        """Generate and save all beam transfer matrices."""
        st = time.time()

        self._generate_dirs()

        if comm.rank0():
            with open(self._picklefile, "wb") as f:
                logger.info("Saving Telescope object.")
                pickle.dump(self.telescope, f)

        self._generate_mfiles(regen)

        if not skip_svd:
            t = time.time()
            self._generate_svdfiles(regen, skip_svd_inv)
            self.timings["svd"] = time.time() - t

        comm.barrier()
        if comm.rank0():
            logger.info("Beam generation time: %f", time.time() - st)

    generate_cache = generate  # old-code compatibility

    def _generate_dirs(self):
        if comm.rank0():
            if not os.path.exists(self.directory):
                os.makedirs(self.directory)
            for mi in range(self.telescope.mmax + 1):
                dirname = self._mdir(mi)
                if not os.path.exists(dirname):
                    os.makedirs(dirname)
        comm.barrier()

    def _use_resident(self):
        """True when the device-resident BTM generate should be used:
        single process, m <= lmax, and under "auto" the (l, m) tables
        within the device and host budgets."""
        if self.resident == "never" or comm.size() != 1:
            return False
        tel = self.telescope
        if tel.mmax > tel.lmax:
            # resident tables are indexed by m <= lmax
            return False
        if self.resident == "always":
            return True
        nl = tel.lmax + 1
        nu = len(tel.included_freq) * len(tel.included_baseline)
        npol = tel.num_pol_sky
        elems = nu * npol * nl * (2 * nl + 1)
        esz = 8 if tel.single_precision else 16
        dev_gb = elems * esz / 2**30
        host_gb = elems * 16 * 2 / 2**30  # c128 m-major copy + transient
        return dev_gb <= self.resident_hbm_gb and host_gb <= self.resident_host_gb

    def _generate_mfiles_resident(self, regen=False):
        """Device-resident BTM generate: one fetch, then the files.

        Computes the full (l, m) tables with
        :func:`parallel.resident.btm_resident`, fetches them once, applies
        the bit truncation, writes the per-m beam.hdf5 layout and keeps
        the tables in memory so `beam_m` (and therefore the SVD stage)
        never reads beam.hdf5 back.
        """
        st = time.time()
        tel = self.telescope
        from ..parallel import resident

        freq_inc = tel.included_freq
        bl_inc = tel.included_baseline
        nb_inc = len(bl_inc)
        nl = tel.lmax + 1
        nm = tel.mmax + 1

        # Unit ordering: baseline-major (u = b * nf_inc + f), matching
        # _mem_mblock's reshape.
        blg, fig = [x.ravel() for x in np.meshgrid(bl_inc, freq_inc, indexing="ij")]
        pos, neg = resident.btm_resident(tel, blg, fig)

        # One host fetch, m-major (contiguous full-l rows for truncation).
        def fetch(z):
            return np.ascontiguousarray(
                z.permute(3, 0, 1, 2).to(torch.complex128).cpu().numpy()
            )

        pos_m = fetch(pos)  # (nl + 1, nu, npol, nl): only the first nm used
        neg_m = fetch(neg)  # (nl, nu, npol, nl), column j <-> m = j + 1
        del pos, neg

        if self.truncate:
            # full-l rows per (m, unit, pol); the sign/conj packing keeps
            # magnitudes, so truncating the raw tables equals truncating
            # the packed blocks
            for tab in (pos_m, neg_m):
                truncate.bit_truncate_max_complex(
                    tab.reshape(-1, tab.shape[-1]), self.truncate_rel, self.truncate_maxl
                )

        self._mem_beam = (pos_m, neg_m)
        self.timings["btm_compute"] = time.time() - st
        logger.info(
            "resident BTM tables computed + fetched in %.1f s", time.time() - st
        )

        wt = time.time()
        for mi in range(nm):
            if os.path.exists(self._mfile(mi)) and not regen:
                logger.info("m index %i. File exists. Skipping...", mi)
                continue
            blk = self._mem_mblock(mi)
            tmpfile = self._mfile(mi) + ".tmp"
            with store.File(tmpfile, "w") as f:
                f.create_dataset(
                    "beam_m",
                    data=blk,
                    chunks=(1, 2, min(10, nb_inc), blk.shape[3], nl - mi),
                    dtype=np.complex128,
                    **self._comp_kwargs(np.complex128),
                )
                f.attrs["m"] = mi
                f.attrs["frequencies"] = tel.frequencies
            store.replace(tmpfile, self._mfile(mi))

        open(self.directory + "/beam_m/COMPLETED", "a").close()
        self.timings["btm_write"] = time.time() - wt
        logger.info(
            "=== BTM generation (resident) took %f s (write %.1f s) ===",
            time.time() - st,
            time.time() - wt,
        )

    def _generate_mfiles(self, regen=False):
        """Compute the BTMs and write them m-ordered."""
        if os.path.exists(self.directory + "/beam_m/COMPLETED") and not regen:
            if comm.rank0():
                logger.info("m-files already generated")
            return

        if not self._use_resident():
            raise NotImplementedError(_CHUNKED_NOT_PORTED)
        self._generate_mfiles_resident(regen)

    def _generate_svdfiles(self, regen=False, skip_svd_inv=False):
        """SVD-compress every m-mode."""
        m_list = np.arange(self.telescope.mmax + 1)
        if comm.rank0():
            for mi in list(m_list):
                if os.path.exists(self._svdfile(mi)) and not regen:
                    if store.readable(self._svdfile(mi)):
                        logger.info(
                            "m index %i. Complete file exists. Skipping...", mi
                        )
                        m_list[mi] = -1
                    else:
                        logger.info(
                            "m index %i. Incomplete file exists. Will regenerate.", mi
                        )
            m_list = m_list[m_list != -1]

        m_list = comm.bcast(m_list)
        comm.barrier()

        local_m = comm.partition_list_mpi(list(m_list))

        if len(local_m):
            # One batched triple-SVD program per m-chunk; chunk i+1 is
            # dispatched before chunk i is fetched, and files are written
            # on a background thread.
            mbatch = max(self.svd_mbatch, 1)
            writer = util.BackgroundWriter(maxsize=2)
            pending = None
            try:
                for s in range(0, len(local_m), mbatch):
                    dispatched = self._svd_dispatch_mbatch(
                        local_m[s : s + mbatch], skip_svd_inv=skip_svd_inv
                    )
                    if pending is not None:
                        self._svd_finish_mbatch(*pending, writer=writer)
                    pending = dispatched
                if pending is not None:
                    self._svd_finish_mbatch(*pending, writer=writer)
            finally:
                writer.close()

        comm.barrier()
        self._collect_svd_spectrum()

    def _svd_dispatch_mbatch(self, m_chunk, skip_svd_inv=False):
        """Launch one m-chunk's triple SVD (+ pseudo-inverse) on the device.

        Nothing is fetched here, so the caller can dispatch the next chunk
        before this one is brought to the host.  Returns the state for
        :meth:`_svd_finish_mbatch`.
        """
        tel = self.telescope
        nfreq, npol, nl = tel.nfreq, tel.num_pol_sky, tel.lmax + 1
        nm = len(m_chunk)

        noisew = np.stack([self._noise_weights(fi) for fi in range(nfreq)])
        bfm = np.stack(
            [self.beam_m(mi).reshape(nfreq, self.ntel, npol * nl) for mi in m_chunk]
        )
        bfm_w = self._dev(bfm) * self._dev(noisew)[None, :, :, None]

        ut, beam, sig = self._svd_compress(bfm_w.reshape(nm * nfreq, self.ntel, npol * nl))
        ibeam = None
        if not skip_svd_inv:
            ibeam = projections.block_pinv(beam, rcond=1e-15)

        # keep the sky->SVD beams on the device for the KL stage
        if self._mem_beam is not None and self._svd_cache_fits() and self._dev_svd_fits():
            if self._dev_svd is None:
                self._dev_svd = {}
            b5 = beam.reshape(nm, nfreq, self.svd_len, npol, nl)
            for i, mi in enumerate(m_chunk):
                self._dev_svd[mi] = b5[i]

        return m_chunk, noisew, (ut, beam, sig, ibeam), skip_svd_inv

    def _svd_compress(self, bfm_w):
        """(ut (B, svd_len, ntel), sky->SVD beam (B, svd_len, npol*nl),
        singular values (B, svd_len)) of noise-weighted beams (B, ntel,
        npol*nl): the triple SVD with its polarisation filter."""
        tel = self.telescope
        ut, beam, sig, _ = projections.triple_svd(
            bfm_w, npol=tel.num_pol_sky, nl=tel.lmax + 1, polsvcut=self.polsvcut
        )
        return ut, beam, sig

    def _simple_compress(self, bfm_w, block):
        """The plain-SVD compression of the variants: U^H and the singular
        values of ``block`` (the whole beam, or its Stokes I columns),
        applied to the whole beam."""
        ut, sig = projections.simple_svd(block)
        ut, sig = ut[:, : self.svd_len], sig[:, : self.svd_len]
        return ut, ut @ bfm_w, sig

    def _svd_finish_mbatch(self, m_chunk, noisew, products, skip_svd_inv, writer=None):
        """Fetch a dispatched chunk and write its svd.hdf5 files (through
        ``writer``, a util.BackgroundWriter, when given)."""
        tel = self.telescope
        nfreq, npol, nl = tel.nfreq, tel.num_pol_sky, tel.lmax + 1
        nm = len(m_chunk)
        ut, beam, sig, ibeam = products

        ut = ut.cpu().numpy().reshape(nm, nfreq, self.svd_len, self.ntel)
        beam = beam.cpu().numpy().reshape(nm, nfreq, self.svd_len, npol, nl)
        sig = sig.cpu().numpy().reshape(nm, nfreq, self.svd_len)
        if ibeam is not None:
            ibeam = ibeam.cpu().numpy().reshape(nm, nfreq, npol, nl, self.svd_len)

        # undo the noise weighting on the telescope side of U^H
        ut_out = ut * noisew[np.newaxis, :, np.newaxis, :]

        # Cache the products in memory when the resident generate is
        # active (and the whole set fits the host budget): the KL stage
        # in this process then skips the svd.hdf5 read-back.
        cache = self._mem_beam is not None and self._svd_cache_fits()
        if cache and self._mem_svd is None:
            self._mem_svd = {}

        for i, mi in enumerate(m_chunk):
            bsvd_i = beam[i].astype(np.complex128)
            ibsvd_i = None if ibeam is None else ibeam[i].astype(np.complex128)
            ut_i = ut_out[i].astype(np.complex128)
            sig_i = sig[i].astype(np.float64)

            if cache:
                ent = {"beam_svd": bsvd_i, "beam_ut": ut_i, "singularvalues": sig_i}
                if ibsvd_i is not None:
                    ent["invbeam_svd"] = ibsvd_i
                self._mem_svd[mi] = ent

            job = (mi, bsvd_i, ibsvd_i, ut_i, sig_i, skip_svd_inv)
            if writer is not None:
                writer.submit(self._svd_write_m, *job)
            else:
                self._svd_write_m(*job)

    def _svd_write_m(self, mi, bsvd_i, ibsvd_i, ut_i, sig_i, skip_svd_inv):
        """Write one m's svd.hdf5 (write-to-temp-then-rename)."""
        tel = self.telescope
        logger.info("m index %i. Writing SVD file: %s", mi, self._svdfile(mi))
        tmpfile = self._svdfile(mi) + ".tmp"
        with store.File(tmpfile, "w") as fs:
            dset_bsvd, dset_ibsvd, dset_ut, dset_sig = self._svd_dsets(fs, skip_svd_inv)
            dset_bsvd[:] = bsvd_i
            if dset_ibsvd is not None:
                dset_ibsvd[:] = ibsvd_i
            dset_ut[:] = ut_i
            dset_sig[:] = sig_i

            fs.attrs["baselines"] = tel.baselines
            fs.attrs["m"] = mi
            fs.attrs["frequencies"] = tel.frequencies
        store.replace(tmpfile, self._svdfile(mi))

    def _svd_cache_fits(self):
        """True when the full SVD-product set fits the host budget."""
        tel = self.telescope
        nfreq, npol, nl = tel.nfreq, tel.num_pol_sky, tel.lmax + 1
        per_m = nfreq * self.svd_len * (2 * npol * nl + self.ntel + 1) * 16
        return (tel.mmax + 1) * per_m <= self.resident_host_gb * 2**30

    def _svd_dsets(self, fs, skip_svd_inv):
        """Create the four SVD datasets with driftscan's layout."""
        tel = self.telescope
        nfreq, npol, nl = tel.nfreq, tel.num_pol_sky, tel.lmax + 1

        dset_bsvd = fs.create_dataset(
            "beam_svd",
            (nfreq, self.svd_len, npol, nl),
            chunks=(1, min(10, self.svd_len), npol, nl),
            **self._comp_kwargs(np.complex128),
            dtype=np.complex128,
        )
        dset_ibsvd = None
        if not skip_svd_inv:
            dset_ibsvd = fs.create_dataset(
                "invbeam_svd",
                (nfreq, npol, nl, self.svd_len),
                chunks=(1, npol, nl, min(10, self.svd_len)),
                **self._comp_kwargs(np.complex128),
                dtype=np.complex128,
            )
        dset_ut = fs.create_dataset(
            "beam_ut",
            (nfreq, self.svd_len, self.ntel),
            chunks=(1, min(10, self.svd_len), self.ntel),
            **self._comp_kwargs(np.complex128),
            dtype=np.complex128,
        )
        dset_sig = fs.create_dataset(
            "singularvalues", (nfreq, self.svd_len), dtype=np.float64
        )
        return dset_bsvd, dset_ibsvd, dset_ut, dset_sig

    def _noise_weights(self, fi):
        tel = self.telescope
        noisew = tel.noisepower(np.arange(tel.npairs), fi).flatten() ** (-0.5)
        return np.concatenate([noisew, noisew])

    def _collect_svd_spectrum(self):
        """Gather the full SVD spectrum into svdspectrum.hdf5."""
        from . import kltransform

        svdspectrum = kltransform.collect_m_array(
            list(range(self.telescope.mmax + 1)),
            lambda mi: self.beam_singularvalues(mi),
            (self.nfreq, self.svd_len),
            np.float64,
        )

        if comm.rank0():
            with store.File(self.directory + "/svdspectrum.hdf5", "w") as f:
                f.create_dataset("singularvalues", data=svdspectrum)
        comm.barrier()

    def svd_all(self):
        """Full SVD spectrum (mmax+1, nfreq, svd_len) from disk."""
        with store.File(self.directory + "/svdspectrum.hdf5", "r") as f:
            return f["singularvalues"][:]

    # ====== projections between bases ======

    def project_vector_sky_to_telescope(self, mi, vec):
        """Sky alm [nfreq, npol, lmax+1] -> telescope vector [nfreq, ntel]."""
        tel = self.telescope
        vecf = np.zeros((self.nfreq, 2, tel.nbase), dtype=np.complex128)

        ind = np.ix_(tel.included_freq, tel.included_pol, np.arange(mi, tel.lmax + 1))
        nfreq_trim = len(tel.included_freq)
        nsky_trim = len(tel.included_pol) * (tel.lmax + 1 - mi)
        vtrim = np.asarray(vec)[ind].reshape((nfreq_trim, nsky_trim))

        if vtrim.size and not np.all(vtrim == 0):
            beam = _load_beam_f(self._mfile(mi), "beam_m").reshape(
                nfreq_trim, -1, nsky_trim
            )
            t = self._matvec(beam, vtrim)
            t = t.reshape(nfreq_trim, 2, len(tel.included_baseline))
            fsel = np.ix_(tel.included_freq, np.arange(2), tel.included_baseline)
            vecf[fsel] = t

        return vecf.reshape(self.nfreq, self.ntel)

    project_vector_forward = project_vector_sky_to_telescope

    def _matvec(self, mats, vecs) -> np.ndarray:
        return projections.block_matvec(self._dev(mats), self._dev(vecs)).cpu().numpy()

    def project_vector_telescope_to_sky(self, mi, vec):
        """Map-making pseudo-inverse: [nfreq, ntel] -> [nfreq, npol, lmax+1]."""
        tel = self.telescope
        vec = np.asarray(vec).reshape((self.nfreq, self.ntel))
        if np.all(vec == 0):
            return np.zeros(
                (self.nfreq, tel.num_pol_sky, tel.lmax + 1), dtype=np.complex128
            )
        ibeam = self.invbeam_m(mi).reshape((self.nfreq, self.nsky, self.ntel))
        vecb = self._matvec(ibeam, vec)
        return vecb.reshape((self.nfreq, tel.num_pol_sky, tel.lmax + 1))

    project_vector_backward = project_vector_telescope_to_sky

    def project_vector_backward_dirty(self, mi, vec):
        """Normalised adjoint ("dirty map") projection."""
        tel = self.telescope
        vec = np.asarray(vec).reshape((self.nfreq, self.ntel))
        vecb = np.zeros((self.nfreq, self.nsky), dtype=np.complex128)
        if np.all(vec == 0):
            return vecb.reshape((self.nfreq, tel.num_pol_sky, tel.lmax + 1))

        dbeam = self.beam_m(mi).reshape((self.nfreq, self.ntel, self.nsky))
        dbeam = dbeam.transpose((0, 2, 1)).conj()

        for fi in range(self.nfreq):
            norm = np.dot(dbeam[fi].T.conj(), dbeam[fi]).diagonal()
            norm = np.where(np.abs(norm) < 1e-6, 0.0, 1.0 / norm)
            vecb[fi] = np.dot(dbeam[fi], vec[fi] * norm)

        return vecb.reshape((self.nfreq, tel.num_pol_sky, tel.lmax + 1))

    def matrix_sky_to_telescope(self, mi, mat, temponly=False) -> torch.Tensor:
        """:meth:`project_matrix_sky_to_telescope` as a tensor on the device."""
        npol = 1 if temponly else self.telescope.num_pol_sky
        lside = self.telescope.lmax + 1
        beam = self.beam_m(mi).reshape(
            (self.nfreq, self.ntel, self.telescope.num_pol_sky, lside)
        )
        return projections.sky_covariance_projection(
            self._dev(np.ascontiguousarray(beam[:, :, :npol])),
            np.ascontiguousarray(np.asarray(mat)[:npol, :npol].real),
        )

    def project_matrix_sky_to_telescope(self, mi, mat, temponly=False):
        """Sky covariance [pol,pol,l,f,f] -> telescope [f,ntel,f,ntel]."""
        return self.matrix_sky_to_telescope(mi, mat, temponly).cpu().numpy()

    project_matrix_forward = project_matrix_sky_to_telescope

    def _svd_num(self, mi):
        """Per-frequency counts of SVD modes above svcut, and their bounds."""
        sv = self.beam_singularvalues(mi)
        svnum = (sv > sv.max() * self.svcut).sum(axis=1)
        svbounds = np.cumsum(np.insert(svnum, 0, 0))
        return svnum, svbounds

    def _svd_freq_iter(self, mi):
        num = self._svd_num(mi)[0]
        return [fi for fi in range(self.nfreq) if (num[fi] > 0)]

    def _compact_indices(self, mi):
        """Indices into the padded (nfreq*svd_len) axis for the compact
        (svbounds[-1]) layout: freq-major, modes within each frequency."""
        svnum, svbounds = self._svd_num(mi)
        idx = np.concatenate(
            [fi * self.svd_len + np.arange(svnum[fi]) for fi in range(self.nfreq)]
        ).astype(int) if svbounds[-1] > 0 else np.zeros(0, dtype=int)
        return idx, svnum, svbounds

    def _compact(self, mi, matf: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(self._compact_indices(mi)[0], device=matf.device)
        return matf[idx][:, idx]

    def matrix_sky_to_svd(self, mi, mat, temponly=False) -> torch.Tensor:
        """:meth:`project_matrix_sky_to_svd` as a tensor on the device."""
        npol = 1 if temponly else self.telescope.num_pol_sky
        beam = self.device_beam_svd([mi])[0]  # (nfreq, svd_len, npol, lside)
        matf = projections.sky_covariance_projection(
            beam[:, :, :npol].contiguous(),
            np.ascontiguousarray(np.asarray(mat)[:npol, :npol].real),
        )
        n = self.nfreq * self.svd_len
        return self._compact(mi, matf.reshape(n, n))

    def project_matrix_sky_to_svd(self, mi, mat, temponly=False):
        """Sky covariance [pol,pol,l,f,f] -> compact SVD covariance [nsvd,nsvd]."""
        return self.matrix_sky_to_svd(mi, mat, temponly).cpu().numpy()

    def matrix_diagonal_telescope_to_svd(self, mi, dmat) -> torch.Tensor:
        """:meth:`project_matrix_diagonal_telescope_to_svd` as a tensor on
        the device."""
        blocks = projections.diag_noise_projection(
            self._dev(self.beam_ut(mi)), np.ascontiguousarray(np.asarray(dmat).real)
        )
        return self._compact(mi, torch.block_diag(*blocks))

    def project_matrix_diagonal_telescope_to_svd(self, mi, dmat):
        """Diagonal telescope covariance [f, ntel] -> compact SVD [nsvd,nsvd]."""
        return self.matrix_diagonal_telescope_to_svd(mi, dmat).cpu().numpy()

    def project_vector_telescope_to_svd(self, mi, vec):
        """Telescope vector [f, ntel, ...] -> compact SVD vector [nsvd, ...]."""
        idx, svnum, svbounds = self._compact_indices(mi)
        vecf = np.zeros((svbounds[-1],) + np.asarray(vec).shape[2:], dtype=np.complex128)
        if np.all(np.asarray(vec) == 0):
            return vecf
        out = self._matvec(
            self.beam_ut(mi), np.asarray(vec).reshape(self.nfreq, self.ntel, -1)
        )
        out = out.reshape((self.nfreq * self.svd_len,) + vecf.shape[1:])
        return out[idx]

    def project_vector_svd_to_telescope(self, mi, svec):
        """Compact SVD vector -> telescope [f, 2, npairs] (pseudo-inverse)."""
        idx, svnum, svbounds = self._compact_indices(mi)
        tel = self.telescope
        vecf = np.zeros((self.nfreq, self.ntel), dtype=np.complex128)
        if np.all(np.asarray(svec) == 0):
            return vecf.reshape(self.nfreq, 2, tel.npairs)

        # Scatter back to the padded layout
        spad = np.zeros((self.nfreq * self.svd_len,), dtype=np.complex128)
        spad[idx] = np.asarray(svec)
        spad = spad.reshape(self.nfreq, self.svd_len)

        beam = self.beam_ut(mi)
        for fi in self._svd_freq_iter(mi):
            noise = tel.noisepower(np.arange(tel.npairs), fi).flatten()
            noise = np.concatenate([noise, noise])
            vecf[fi] = noise * np.dot(beam[fi].T.conj(), spad[fi])

        return vecf.reshape(self.nfreq, 2, tel.npairs)

    def project_vector_sky_to_svd(self, mi, vec, temponly=False):
        """Sky alm [f, npol, lmax+1, ...] -> compact SVD vector."""
        npol = 1 if temponly else self.telescope.num_pol_sky
        idx, svnum, svbounds = self._compact_indices(mi)

        vec = np.asarray(vec)
        vecf = np.zeros((svbounds[-1],) + vec.shape[3:], dtype=np.complex128)
        if np.all(vec == 0):
            return vecf

        beam = self.beam_svd(mi)  # (f, svd_len, npol, l)
        lside = self.telescope.lmax + 1
        b2 = beam[:, :, :npol].reshape(self.nfreq, self.svd_len, npol * lside)
        v2 = vec[:, :npol].reshape((self.nfreq, npol * lside) + vec.shape[3:])
        out = self._matvec(b2, v2)
        out = out.reshape((self.nfreq * self.svd_len,) + vec.shape[3:])
        return out[idx]

    def project_vector_svd_to_sky(self, mi, vec, temponly=False, conj=False):
        """Compact SVD vector -> sky alm [f, npol, lmax+1, ...].

        With conj=True apply the Hermitian conjugate of the forward
        projection instead of the pseudo-inverse.
        """
        npol = 1 if temponly else self.telescope.num_pol_sky
        idx, svnum, svbounds = self._compact_indices(mi)
        lside = self.telescope.lmax + 1

        vec = np.asarray(vec)
        vecf = np.zeros(
            (self.nfreq, self.telescope.num_pol_sky, lside) + vec.shape[1:],
            dtype=np.complex128,
        )
        if np.all(vec == 0):
            return vecf

        spad = np.zeros((self.nfreq * self.svd_len,) + vec.shape[1:], dtype=np.complex128)
        spad[idx] = vec
        spad = spad.reshape((self.nfreq, self.svd_len) + vec.shape[1:])

        if conj:
            beam = self.beam_svd(mi)[:, :, :npol]  # (f, svd, npol, l)
            b2 = np.conj(
                beam.reshape(self.nfreq, self.svd_len, npol * lside).transpose(0, 2, 1)
            )
        else:
            beam = self.invbeam_svd(mi)[:, :npol]  # (f, npol, l, svd)
            b2 = beam.reshape(self.nfreq, npol * lside, self.svd_len)

        out = self._matvec(b2, spad)
        vecf[:, :npol] = out.reshape((self.nfreq, npol, lside) + vec.shape[1:])
        return vecf

    # ====== dimensions ======

    @property
    def ntel(self):
        """Telescope degrees of freedom per frequency (2 * npairs)."""
        return 2 * self.telescope.npairs

    @property
    def nsky(self):
        """Sky degrees of freedom per frequency ((lmax+1) * npol)."""
        return (self.telescope.lmax + 1) * self.telescope.num_pol_sky

    @property
    def nfreq(self):
        return self.telescope.nfreq

    @property
    def svd_len(self):
        """Padded SVD mode count per frequency."""
        return min(self.telescope.lmax + 1, self.ntel)

    @property
    def ndofmax(self):
        return self.svd_len * self.nfreq

    def ndof(self, mi):
        """Degrees of freedom at m after the SVD cut."""
        return int(self._svd_num(mi)[1][-1])


class BeamTransferTempSVD(BeamTransfer):
    """SVD of the temperature (Stokes I) block only: U^H from the plain
    SVD of each (m, freq) beam's Stokes I columns, applied to the whole
    beam (JAX ``core/beamtransfer.py:1152``)."""

    def _svd_compress(self, bfm_w):
        tel = self.telescope
        nl = tel.lmax + 1
        block = bfm_w.reshape(bfm_w.shape[0], self.ntel, tel.num_pol_sky, nl)[:, :, 0]
        return self._simple_compress(bfm_w, block)


class BeamTransferFullSVD(BeamTransfer):
    """Plain SVD of the full beam matrix, no polarisation filtering (JAX
    ``core/beamtransfer.py:1191``)."""

    def _svd_compress(self, bfm_w):
        return self._simple_compress(bfm_w, bfm_w)

    @property
    def svd_len(self):
        return min((self.telescope.lmax + 1) * self.telescope.num_pol_sky, self.ntel)


class BeamTransferNoSVD(BeamTransfer):
    """No SVD compression: every projection works in the telescope basis
    (JAX ``core/beamtransfer.py:1234``)."""

    svcut = 0.0
    noise_weight = False
    # telescope-basis beams: not prewhitened, (2, npairs) layout
    kl_mbatch_ok = False

    def _svd_num(self, mi):
        svnum = (np.ones(self.nfreq) * self.ntel).astype(int)
        svbounds = np.cumsum(np.insert(svnum, 0, 0))
        return svnum, svbounds

    def _generate_svdfiles(self, regen=False, skip_svd_inv=False):
        logger.info("======== Skipping telescope SVD step ========")

    def matrix_sky_to_svd(self, mi, mat, temponly=False) -> torch.Tensor:
        n = self.ndof(mi)
        return self.matrix_sky_to_telescope(mi, mat, temponly).reshape(n, n)

    def project_matrix_sky_to_svd(self, mi, mat, temponly=False):
        return self.matrix_sky_to_svd(mi, mat, temponly).cpu().numpy()

    def project_vector_sky_to_svd(self, mi, vec, *args, **kwargs):
        return self.project_vector_sky_to_telescope(mi, vec).flatten()

    def project_matrix_telescope_to_svd(self, mi, mat):
        return np.asarray(mat).reshape(self.ndof(mi), self.ndof(mi))

    def matrix_diagonal_telescope_to_svd(self, mi, dmat) -> torch.Tensor:
        return torch.diag(self._dev(np.asarray(dmat).flatten()))

    def project_matrix_diagonal_telescope_to_svd(self, mi, dmat, *args, **kwargs):
        return np.diag(np.asarray(dmat).flatten())

    def project_vector_telescope_to_svd(self, mi, vec, *args, **kwargs):
        return np.asarray(vec).flatten()

    def project_vector_svd_to_sky(self, mi, vec, temponly=False, conj=False):
        if temponly:
            raise NotImplementedError(
                "temponly not implemented for no-SVD project_vector_svd_to_sky!"
            )
        tel = self.telescope
        vec = np.asarray(vec)
        vr = vec.reshape((self.nfreq, self.ntel, -1))
        if conj:
            beam = self.beam_m(mi).reshape((self.nfreq, self.ntel, self.nsky))
            out = self._matvec(np.swapaxes(beam, 1, 2).conj(), vr)
        else:
            ibeam = self.invbeam_m(mi).reshape((self.nfreq, self.nsky, self.ntel))
            out = self._matvec(ibeam, vr)
        return out.reshape((self.nfreq, tel.num_pol_sky, tel.lmax + 1) + vec.shape[1:])

    def beam_svd(self, mi, *args, **kwargs):
        return self.beam_m(mi)

    def ndof(self, mi, *args, **kwargs):
        return self.ntel * self.nfreq

    @property
    def ndofmax(self):
        return self.ntel * self.nfreq


def _load_beam_f(path, dset_name, ind=None):
    """Load a beam dataset (or an index of it)."""
    ind = ind if ind is not None else slice(None)
    with store.File(path, "r") as fh:
        if dset_name not in fh:
            raise RuntimeError(f"Malformed beam file: {path}")
        return np.asarray(fh[dset_name][ind])


def _find_index_sorted(a: np.ndarray, v: int) -> Optional[int]:
    """Index of the first entry of sorted `a` equal to `v` (None if absent)."""
    ind = int(np.searchsorted(a, v))
    if ind < len(a) and a[ind] == v:
        return ind
    return None
