"""Abstract transit-telescope model and the batched transfer-matrix driver.

Port of ``driftscan_tpu/core/telescope.py`` (unpolarised and polarised
telescopes).  Feed layout, unique-baseline discovery, frequency binning
and the noise model are host numpy, unchanged; the pixel grid, the beams
and the visibility maps live on the telescope's ``device`` as torch
tensors.  A telescope's beams come from one of two places:

* a cylinder whose beam physics is the stock one, in single precision,
  evaluates them from its device beam bank inside the map kernel (K1+K2,
  :meth:`TransitTelescope._gather_beams`);
* every other telescope evaluates ``beam(feed, freq)`` on the host grid
  ``self._angpos`` (numpy, any subclass Python), caches the maps by
  (nside, freq, beamclass) (:meth:`TransitTelescope._beam`), uploads each
  once into the padded device layout (:meth:`TransitTelescope._beam_device`)
  and hands the batch's unique beams to the K2-host kernel
  (:meth:`TransitTelescope._gather_host_beams`).

:meth:`TransitTelescope._bank_beams_apply` chooses between them.

A telescope builds on the card by default
(``UnpolarisedCylinderTelescope.from_config(params)``); the CPU is what a
caller asks for with ``device="cpu"``.  Without CUDA, a default-device
telescope raises at its first device tensor, as torch does.
"""

from __future__ import annotations

import abc
import os
from functools import cached_property

import numpy as np
import torch

from .. import config
from ..ops import healpix, kernels, sht

# Speed of light (m/s) — for wavelength conversion from MHz channels.
C_LIGHT = 299792458.0
# Sidereal day in seconds (used in the radiometer noise model).
T_SIDEREAL = 23.9344696 * 3600.0


def in_range(arr, min, max):
    """True if all entries lie in [min, max)."""
    arr = np.asarray(arr)
    return bool(((arr >= min) & (arr < max)).all())


def out_of_range(arr, min, max):
    return not in_range(arr, min, max)


def map_half_plane(arr):
    """Map 2D separations into the half plane with positive u (E pointing)."""
    arr = np.asarray(arr)
    west = (arr[:, 0] < 0.0) | ((arr[:, 0] == 0.0) & (arr[:, 1] < 0.0))
    return np.where(west[:, np.newaxis], -arr, arr)


def _label_classes(mask, *keys):
    """Dense labels for equal key tuples inside ``mask``; -1 elsewhere.

    Labels are assigned in lexicographic key order (complex keys sort by
    real part, then imaginary).
    """
    mask = np.asarray(mask, dtype=bool)
    sel = np.nonzero(mask.ravel())[0]

    cols = []
    for k in keys:
        k = np.asarray(k).ravel()[sel]
        if np.iscomplexobj(k):
            cols.extend([k.real, k.imag])
        else:
            cols.append(k)

    # np.lexsort keys run last-to-first; we want keys[0] most significant.
    order = np.lexsort(tuple(cols[::-1]))
    boundary = np.zeros(sel.size, dtype=bool)
    for c in cols:
        cs = c[order]
        boundary[1:] |= cs[1:] != cs[:-1]

    labels = np.full(mask.size, -1, dtype=np.int64)
    labels[sel[order]] = np.cumsum(boundary)
    return labels.reshape(mask.shape)


def _class_representatives(labels, mask):
    """First (row-major) (i, j) index inside ``mask`` for every class."""
    flat = labels.ravel()
    sel = np.nonzero(np.asarray(mask, dtype=bool).ravel())[0]
    labs = flat[sel]
    if labs.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    first = np.full(labs.max() + 1, -1, dtype=np.int64)
    first[labs[::-1]] = sel[::-1]  # reversed fill leaves the earliest index
    return np.column_stack(np.unravel_index(first, labels.shape))


def _remap_keyarray(keyarray, mask=None):
    """Assign dense integer labels to the equivalence classes of keys."""
    if mask is None:
        mask = np.ones(keyarray.shape, bool)
    return _label_classes(mask, keyarray)


def sht_unit_chunks(n_units: int, npix: int, npol: int = 1):
    """Split a unit batch into SHT-call chunks bounded by a memory budget.

    The beam-map + SHT stage holds several pixel-grid temporaries per
    unit; the budget is ``DRIFTSCAN_TPU_SHT_BUDGET_GB`` (default 2.0).
    Returns a list of slice lengths (each a power of two, covering
    ``n_units``).
    """
    budget = float(os.environ.get("DRIFTSCAN_TPU_SHT_BUDGET_GB", "2.0")) * 2**30
    per_unit = npix * 4.0 * 8.0 * max(npol, 1)  # ~8 f32 pixel temporaries
    cap = max(1, int(budget / max(per_unit, 1.0)))
    cap = 1 << (cap.bit_length() - 1)  # round down to a power of two

    chunks = []
    left = n_units
    while left > 0:
        take = min(cap, left)
        chunks.append(take)
        left -= take
    return chunks


def max_lm(baselines, wavelengths, uwidth, vwidth=0.0):
    """Maximum (l, m) a baseline is sensitive to.

    ``mmax = ceil(2 pi u_max)``, ``lmax = ceil(hypot(mmax, 2 pi v_max))``.
    """
    umax = (np.abs(baselines[..., 0]) + uwidth) / wavelengths
    vmax = (np.abs(baselines[..., 1]) + vwidth) / wavelengths

    mmax = np.ceil(2 * np.pi * umax).astype(np.int64)
    lmax = np.ceil((mmax**2 + (2 * np.pi * vmax) ** 2) ** 0.5).astype(np.int64)
    return lmax, mmax


def nside_cap():
    """The ``DRIFTSCAN_TPU_NSIDE_CAP`` value (0 = off), validated at read.

    A cap must be a positive power of two: a negative value or any other
    integer is an error, not a silent clamp.
    """
    raw = os.environ.get("DRIFTSCAN_TPU_NSIDE_CAP", "0") or "0"
    try:
        cap = int(raw)
    except ValueError as exc:
        raise ValueError(f"DRIFTSCAN_TPU_NSIDE_CAP={raw!r} is not an integer") from exc
    if cap != 0 and (cap < 0 or cap & (cap - 1)):
        raise ValueError(
            f"DRIFTSCAN_TPU_NSIDE_CAP={cap} must be 0 (off) or a positive "
            "power of two"
        )
    return cap


class Observer(config.Reader):
    """Minimal observer location."""

    latitude = config.Property(proptype=float, default=45.0)
    longitude = config.Property(proptype=float, default=0.0)
    altitude = config.Property(proptype=float, default=0.0)

    def __init__(self, longitude=0.0, latitude=45.0, altitude=0.0, **kwargs):
        self.longitude = longitude
        self.latitude = latitude
        self.altitude = altitude


class TransitTelescope(Observer, metaclass=abc.ABCMeta):
    """Base class for a transit interferometer.

    Subclasses implement ``feedpositions``, ``beamclass``, ``u_width``,
    ``v_width`` and ``beam`` (or a beam bank, :meth:`_bank_beams_apply`);
    everything else lives here.  ``device`` (the card unless given) holds
    the pixel grid and the beams.
    """

    freq_lower = config.Property(proptype=config.float_or_none, default=None)
    freq_upper = config.Property(proptype=config.float_or_none, default=None)

    freq_start = config.Property(proptype=float, default=800.0)
    freq_end = config.Property(proptype=float, default=400.0)
    num_freq = config.Property(proptype=int, default=1024)

    freq_mode = config.enum(["centre", "centre_nyquist", "edge"], default="centre")

    channel_bin = config.Property(proptype=int, default=1)
    channel_range = config.Property(proptype=list)
    channel_list = config.Property(proptype=list)

    tsys_flat = config.Property(proptype=float, default=50.0, key="tsys")
    ndays = config.Property(proptype=int, default=733)

    accuracy_boost = config.Property(proptype=float, default=1.0)
    l_boost = config.Property(proptype=float, default=1.0)
    force_lmax = config.Property(proptype=int, default=None)
    force_mmax = config.Property(proptype=int, default=None)

    minlength = config.Property(proptype=float, default=0.0)
    maxlength = config.Property(proptype=float, default=1.0e7)

    auto_correlations = config.Property(proptype=bool, default=False)

    local_origin = config.Property(proptype=bool, default=True)

    # Run the beam-map + SHT path in complex64 (float32 pixel grid).
    single_precision = config.Property(proptype=bool, default=False)

    # Frequency channels and baselines left out of the product files.
    skip_freq = config.Property(proptype=lambda v: [int(i) for i in v], default=list)
    skip_baselines = config.Property(proptype=lambda v: [int(i) for i in v], default=list)

    # Host beam cache budget (MB) of :meth:`_beam`.
    beam_cache_size = config.Property(proptype=int, default=200)

    # Tolerance (decimal places) when comparing baselines for equivalence.
    _bl_tol = 6

    # private attributes that a pickle keeps: the rest (pixel grid, beam
    # bank, baseline tables) are device tensors or caches rebuilt on demand
    _pickle_keys = ("_frequencies",)

    def __init__(self, latitude=45, longitude=0, device="cuda", **kwargs):
        Observer.__init__(self, longitude, latitude, **kwargs)
        self.device = torch.device(device)

    def __getstate__(self):
        """The configuration alone: device tensors and caches are dropped,
        and the device is kept by name."""
        state = {
            k: v
            for k, v in self.__dict__.items()
            if k in self._pickle_keys or not k.startswith("_")
        }
        state["device"] = str(self.device)
        return state

    def __setstate__(self, state):
        """Restore the configuration and the name of the pickled device.
        The state holds no tensor, so a pickle written on the card opens
        on any host; nothing moves to another device unless the caller
        asks with :meth:`to`."""
        self.__dict__.update(state)
        self.device = torch.device(state.get("device", "cpu"))

    def to(self, device):
        """Move the telescope to ``device``: its device caches are dropped
        and rebuilt there on demand.  Returns self."""
        for key in ("_beam_bank", "_nside", "_angpos_cart", "_horizon",
                    "_beam_dev_cache", "_beam_dev_bytes"):
            self.__dict__.pop(key, None)
        self.device = torch.device(device)
        return self

    # ======================= location =========================

    @property
    def zenith(self):
        """Zenith direction in spherical polars [theta, phi]."""
        theta = np.pi / 2.0 - np.radians(self.latitude)
        phi = np.remainder(np.radians(self.longitude), 2 * np.pi)
        phi = 0.0 if self.local_origin else phi
        return np.array([theta, phi])

    @property
    def real_dtype(self) -> torch.dtype:
        return torch.float32 if self.single_precision else torch.float64

    # ======================= baselines ========================

    _baselines = None
    _redundancy = None
    _uniquepairs = None
    _feedmap = None
    _feedmask = None
    _feedconj = None

    @property
    def baselines(self):
        """The unique baselines (nbase, 2) in metres."""
        if self._baselines is None:
            self.calculate_feedpairs()
        return self._baselines

    @property
    def redundancy(self):
        if self._redundancy is None:
            self.calculate_feedpairs()
        return self._redundancy

    @property
    def npairs(self):
        return self.uniquepairs.shape[0]

    @property
    def nbase(self):
        return self.npairs

    @property
    def included_freq(self) -> np.ndarray:
        return np.array(
            [i for i in range(self.nfreq) if i not in self.skip_freq], dtype=int
        )

    @property
    def included_baseline(self) -> np.ndarray:
        return np.array(
            [i for i in range(self.nbase) if i not in self.skip_baselines], dtype=int
        )

    @property
    def included_pol(self) -> np.ndarray:
        return np.arange(self.num_pol_sky)

    @property
    def uniquepairs(self):
        if self._uniquepairs is None:
            self.calculate_feedpairs()
        return self._uniquepairs

    @property
    def feedmap(self):
        """(nfeed, nfeed) unique-pair label of every ordered feed pair."""
        if self._feedmap is None:
            self.calculate_feedpairs()
        return self._feedmap

    @property
    def feedmask(self):
        """(nfeed, nfeed) True for the feed pairs that are included."""
        if self._feedmask is None:
            self.calculate_feedpairs()
        return self._feedmask

    @property
    def feedconj(self):
        """(nfeed, nfeed) True where a pair is its unique pair conjugated."""
        if self._feedconj is None:
            self.calculate_feedpairs()
        return self._feedconj

    def calculate_feedpairs(self):
        """Unique feed pairs, their redundancy and (east-pointing) baselines.

        Feed pairs are labelled by joint (baseline, beam) equivalence and
        joined with their reversed pairs; each class representative is
        oriented east, and classes are relabelled in (u, v, beamclass_j,
        beamclass_i) order.
        """
        fmap, mask, conj = self._get_unique()

        conj = self._orient_east(fmap, mask, conj)
        fmap = self._rank_pairs(fmap, mask, conj)

        tmask = mask & ~conj
        self._feedmap, self._feedmask, self._feedconj = fmap, mask, conj
        self._uniquepairs = _class_representatives(fmap, tmask)
        if self._uniquepairs.shape[0] == 0:
            raise ValueError(
                "telescope has no included feed pairs — check "
                "auto_correlations and the min/max baseline-length cuts"
            )
        self._redundancy = np.bincount(fmap[tmask])
        self._baselines = (
            self.feedpositions[self._uniquepairs[:, 0]]
            - self.feedpositions[self._uniquepairs[:, 1]]
        )

    def _pair_separations(self, pairs):
        return self.feedpositions[pairs[:, 0]] - self.feedpositions[pairs[:, 1]]

    def _orient_east(self, fmap, mask, conj):
        """Flip the conjugation flag of classes whose representative
        separation points west, so every effective baseline has u >= 0."""
        reps = _class_representatives(fmap, mask & ~conj)
        sep = self._pair_separations(reps)
        west = (sep[:, 0] < 0.0) | ((sep[:, 0] == 0.0) & (sep[:, 1] < 0.0))
        flip = np.zeros_like(conj)
        flip[mask] = west[fmap[mask]]
        return conj ^ flip

    def _rank_pairs(self, fmap, mask, conj):
        """Relabel classes in lexicographic (u, v, bc_j, bc_i) order."""
        reps = _class_representatives(fmap, mask & ~conj)
        sep = self._pair_separations(reps)
        ci = self.beamclass[reps[:, 0]].astype(np.int32)
        cj = self.beamclass[reps[:, 1]].astype(np.int32)

        order = np.lexsort((ci, cj, sep[:, 1], sep[:, 0]))
        rank = np.empty(order.size, dtype=np.int64)
        rank[order] = np.arange(order.size)

        out = np.full_like(fmap, -1)
        out[mask] = rank[fmap[mask]]
        return out

    def _unique_baselines(self):
        """Key map of equivalent baseline separations + inclusion mask."""
        sep = self.feedpositions[:, np.newaxis] - self.feedpositions[np.newaxis, :]
        key = np.around(sep[..., 0] + 1.0j * sep[..., 1], self._bl_tol)

        blen = np.hypot(sep[..., 0], sep[..., 1])
        mask = (blen >= self.minlength) & (blen <= self.maxlength)
        if not self.auto_correlations:
            mask &= blen > 0.0

        return _label_classes(mask, key), mask

    def _unique_beams(self):
        """Key map of equivalent beam pairs + inclusion mask."""
        bc = self.beamclass
        beam_map = _label_classes(
            np.ones((self.nfeed, self.nfeed), dtype=bool),
            np.broadcast_to(bc[:, np.newaxis], (self.nfeed, self.nfeed)),
            np.broadcast_to(bc[np.newaxis, :], (self.nfeed, self.nfeed)),
        )

        if self.auto_correlations:
            beam_mask = np.ones((self.nfeed, self.nfeed), dtype=bool)
        else:
            beam_mask = ~np.identity(self.nfeed, dtype=bool)

        return beam_map, beam_mask

    def _get_unique(self):
        """Label ordered feed pairs by joint (baseline, beam) equivalence
        and join every class with its reversed-pair class."""
        base_map, base_mask = self._unique_baselines()
        beam_map, beam_mask = self._unique_beams()

        mask = base_mask & beam_mask
        pair_lab = _label_classes(mask, base_map, beam_map)

        conj = pair_lab > pair_lab.T
        joined = np.minimum(pair_lab, pair_lab.T)
        return _label_classes(mask, joined), mask, conj

    # ======================= frequencies ======================

    _frequencies = None

    @property
    def frequencies(self):
        """Band-centre frequencies in MHz."""
        if self._frequencies is None:
            self.calculate_frequencies()
        return self._frequencies

    def calculate_frequencies(self):
        if self.freq_lower or self.freq_upper:
            self.freq_start = self.freq_lower
            self.freq_end = self.freq_upper

        if self.freq_mode == "centre":
            frequencies = np.linspace(
                self.freq_start, self.freq_end, self.num_freq, endpoint=False
            )
        elif self.freq_mode == "centre_nyquist":
            frequencies = np.linspace(
                self.freq_start, self.freq_end, self.num_freq, endpoint=True
            )
        else:  # edge
            df = abs(self.freq_end - self.freq_start) / self.num_freq
            frequencies = self.freq_start + df * (np.arange(self.num_freq) + 0.5)

        if self.channel_bin > 1:
            if self.num_freq % self.channel_bin != 0:
                raise ValueError(
                    "Channel binning must exactly divide the total number of channels"
                )
            frequencies = frequencies.reshape(-1, self.channel_bin).mean(axis=1)

        if self.channel_list is not None and len(self.channel_list):
            chans = np.asarray(self.channel_list, dtype=int)
            if chans.min() < 0 or chans.max() >= len(frequencies):
                raise ValueError(
                    f"channel_list entries must be in [0, {len(frequencies)}); "
                    f"got {self.channel_list}"
                )
            frequencies = frequencies[chans]
        elif self.channel_range is not None and len(self.channel_range):
            frequencies = frequencies[slice(*self.channel_range)]

        self._frequencies = frequencies

    @property
    def wavelengths(self):
        """Band-centre wavelengths in metres."""
        return C_LIGHT / (1e6 * self.frequencies)

    @property
    def nfreq(self):
        return self.frequencies.shape[0]

    @property
    def input_index(self):
        """Correlator-input labels (draco compatible)."""
        return np.array(np.arange(self.nfeed), dtype=[("chan_id", "u2")])

    @property
    def nfeed(self):
        return self.feedpositions.shape[0]

    @property
    def num_pol_sky(self):
        """Sky polarisation components handled (1 = T)."""
        return self._npol_sky_

    # ==================== harmonic spread =====================

    @property
    def lmax(self):
        """Maximum l the telescope is sensitive to."""
        if self.force_lmax is not None:
            return self.force_lmax
        lmax, _ = max_lm(
            self.baselines, self.wavelengths.min(), self.u_width, self.v_width
        )
        return int(np.ceil(lmax.max() * self.l_boost))

    @property
    def mmax(self):
        """Maximum m the telescope is sensitive to."""
        if self.force_mmax is not None:
            return self.force_mmax
        _, mmax = max_lm(
            self.baselines, self.wavelengths.min(), self.u_width, self.v_width
        )
        return int(np.ceil(mmax.max() * self.l_boost))

    def unit_lmax(self, bl_indices, f_indices):
        """Per-unit band limits, boosted like :attr:`lmax`."""
        lmax, _ = max_lm(
            self.baselines[bl_indices],
            self.wavelengths[f_indices],
            self.u_width,
            self.v_width,
        )
        return np.ceil(lmax * self.l_boost).astype(np.int64)

    # ================== transfer matrices =====================

    def transfer_for_frequency(self, freq):
        """All transfer matrices at one frequency."""
        bi = np.arange(self.npairs)
        return self.transfer_matrices(bi, freq * np.ones_like(bi))

    def transfer_for_baseline(self, baseline):
        """All transfer matrices of one baseline."""
        fi = np.arange(self.nfreq)
        return self.transfer_matrices(baseline * np.ones_like(fi), fi)

    def transfer_matrices(self, bl_indices, f_indices):
        """Batched transfer matrices for (baseline, frequency) pairs.

        Returns a complex128 numpy array of shape
        ``bl.shape + (npol, lside+1, 2*lside+1)`` in the FFT-like m
        packing (positive m at [l, m], negative at [l, 2*lside+1+m]).
        """
        bl_indices, f_indices = np.broadcast_arrays(bl_indices, f_indices)
        if out_of_range(bl_indices, 0, self.npairs):
            raise ValueError("Baseline indices aren't valid")
        if out_of_range(f_indices, 0, self.nfreq):
            raise ValueError("Frequency indices aren't valid")

        lside = self.lmax
        tshape = bl_indices.shape + (self.num_pol_sky, lside + 1, 2 * lside + 1)
        tarray = np.zeros((bl_indices.size,) + tshape[len(bl_indices.shape):], np.complex128)

        for sel, pos, neg in self.btm_blocks(bl_indices.ravel(), f_indices.ravel()):
            packed = sht.pack_fftlike(pos.cpu().numpy(), neg.cpu().numpy(), lside)
            # Stokes components past the transformed ones stay zero
            tarray[sel, : packed.shape[1]] = packed

        return tarray.reshape(tshape)

    def btm_blocks(self, bl_indices, f_indices, m_window=None):
        """The BTM coefficients of a unit list, one SHT call at a time.

        Units are grouped by the nside their own band limit needs,
        frequency-major within a group (consecutive calls share beams), and
        each group is cut by :func:`sht_unit_chunks`.  Yields (sel, pos,
        neg): ``sel`` indexes the call's units in the lists, pos and neg are
        :meth:`btm_chunk`'s device tensors at the call's largest band limit,
        each unit zeroed above its own.  Every BTM route (the resident
        tables, the chunked files, :meth:`transfer_matrices`) makes its SHT
        calls here, so the same units in the same calls give the same bits.

        ``m_window=(m0, m1)`` gives each call's m in [m0, m1) in the uniform
        layout of :func:`sht.analysis` (pos and neg of width m1 - m0), and
        skips a call whose band limit lies below m0 before its beams are
        evaluated.
        """
        bl_indices = np.asarray(bl_indices)
        f_indices = np.asarray(f_indices)
        lmax_arr = self.unit_lmax(bl_indices, f_indices)
        nsides = np.array([self._nside_for(int(l)) for l in lmax_arr], dtype=np.int64)

        for ns in np.unique(nsides):
            bucket = np.nonzero(nsides == ns)[0]
            bucket = bucket[np.argsort(f_indices[bucket], kind="stable")]
            off = 0
            for take in sht_unit_chunks(len(bucket), 12 * int(ns) ** 2, self.num_pol_sky):
                sel = bucket[off : off + take]
                off += take
                sub_lmax = int(lmax_arr[sel].max())
                if m_window is not None and sub_lmax < m_window[0]:
                    continue  # no m of the window reaches these units
                pos, neg = self.btm_chunk(
                    bl_indices[sel], f_indices[sel], int(ns), sub_lmax, m_window
                )
                lmask = (
                    torch.arange(sub_lmax + 1, device=pos.device)[None, :]
                    <= torch.as_tensor(lmax_arr[sel], device=pos.device)[:, None]
                ).to(pos.real.dtype)[:, None, :, None]
                yield sel, pos * lmask, neg * lmask

    def btm_chunk(self, bl_ind, f_ind, nside, lmax, m_window=None):
        """BTM coefficients of a unit batch at one nside.

        Returns (pos (nu, npol_t, lmax+1, lmax+1), neg (nu, npol_t, lmax+1,
        lmax)) complex tensors on the device, one scalar SHT per
        transformed Stokes component (npol_t = 1 unpolarised): btrans =
        conj(SHT(conj(visibility map))), negative-m column j <-> m = -(j + 1).
        With ``m_window`` both have width m1 - m0, column j holding
        m = +-(m0 + j) (:func:`sht.analysis`).
        """
        self._init_trans(nside)
        cvis = self._beam_map_batch(bl_ind, f_ind)
        if cvis.dim() == 2:  # unpolarised: add the pol axis
            cvis = cvis[:, None]
        pos, neg = sht.analysis(cvis.conj(), lmax=lmax, nside=nside, m_window=m_window)
        return pos.conj().resolve_conj(), neg.conj().resolve_conj()

    def _nside_for(self, lmax: int) -> int:
        """Pixelisation for a unit's band limit (``accuracy_boost`` doublings).

        ``DRIFTSCAN_TPU_NSIDE_CAP`` (a power of two; 0/unset = off) clamps
        the boosted nside from above, but never below the un-boosted
        adequacy criterion ``2*nside >= lmax``.  The cap is validated at
        read (:func:`nside_cap`).
        """
        ns = healpix.nside_for_lmax(int(lmax), accuracy_boost=self.accuracy_boost)
        cap = nside_cap()
        if cap:
            floor = healpix.nside_for_lmax(int(lmax), accuracy_boost=0.0)
            ns = max(min(ns, cap), floor)
        return ns

    @abc.abstractmethod
    def _beam_map_batch(self, bl_ind, f_ind):
        """Visibility maps of a batch of units at the current nside, on the
        ring-padded device grid: (nunit, nring*maxlen) unpolarised, or
        (nunit, npol_transform, nring*maxlen) Stokes maps."""

    # ========================= noise ==========================

    def tsys(self, f_indices=None):
        """System temperature (K) at the given frequency indices."""
        freq = self.frequencies if f_indices is None else self.frequencies[f_indices]
        return np.ones_like(freq) * self.tsys_flat

    def noisepower(self, bl_indices, f_indices, ndays=None):
        """Radiometer noise power spectrum, white in m."""
        ndays = self.ndays if not ndays else ndays
        bl_indices, f_indices = np.broadcast_arrays(bl_indices, f_indices)
        bw = np.abs(self.frequencies[1] - self.frequencies[0]) * 1e6
        delnu = T_SIDEREAL * bw / (2 * np.pi)
        noisepower = self.tsys(f_indices) ** 2 / (2 * np.pi * delnu * ndays)
        return noisepower / self.redundancy[bl_indices]

    def noisepower_feedpairs(self, fi, fj, f_indices, m, ndays=None):
        """Noise power of the feed pairs (fi, fj) at ``f_indices`` and m:
        half the per-channel radiometer power, broadcast over the inputs."""
        ndays = self.ndays if not ndays else ndays
        bw = np.abs(self.frequencies[1] - self.frequencies[0]) * 1e6
        delnu = T_SIDEREAL * bw / (2 * np.pi)
        noisepower = self.tsys(f_indices) ** 2 / (2 * np.pi * delnu * ndays)
        return np.ones_like(fi) * np.ones_like(fj) * np.ones_like(m) * noisepower / 2.0

    # ================== pixel grid and beams ==================

    _nside = None

    def _init_trans(self, nside):
        """(Re)generate the device pixel grid for ``nside``.

        The grid is the ring-padded (ring, slot) layout, flat
        (nring*maxlen,); padding slots have horizon 0, so every pixel op
        is elementwise and the SHT consumes the maps with a reshape.
        Positions and horizon are formed in float64 on the host, then
        cast to the telescope's precision on the device.  Host beams are
        evaluated on the compact grid ``self._angpos`` ((npix, 2) numpy)
        and padded with ``_ring_pad_index`` / ``_ring_pad_mask``, the JAX
        package's names, so subclasses written against it run unchanged.
        """
        if self._nside == nside:
            return
        self._nside = nside
        self._angpos = healpix.ang_positions(nside)
        geom = healpix.ring_geometry(nside)
        pix = np.asarray(geom.pix_index).ravel()
        self._ring_pad_index = pix
        self._ring_pad_mask = np.asarray(geom.mask).ravel()
        padmask = torch.as_tensor(self._ring_pad_mask)
        angpos = torch.as_tensor(self._angpos[pix])
        cart = kernels.sph_to_cart(angpos)
        horizon = kernels.horizon_mask(cart, torch.as_tensor(self.zenith)) * padmask
        dt = self.real_dtype
        self._angpos_cart = cart.to(device=self.device, dtype=dt).contiguous()
        self._horizon = horizon.to(device=self.device, dtype=dt).contiguous()

    def _bank_beams_apply(self):
        """True when the beams are device bank rows (K1+K2); False, as
        here, sends the telescope to the host-beam path (K2-host)."""
        return False

    _beam_cache = None
    _beam_cache_bytes = 0

    def _beam(self, feed, freq):
        """Host beam map of ``feed`` at frequency index ``freq`` on the
        compact grid, cached by (nside, freq, beamclass) within
        ``beam_cache_size`` MB (oldest out first); float32 / complex64
        under ``single_precision``."""
        if self._beam_cache is None:
            self._beam_cache = {}
            self._beam_cache_bytes = 0
        key = (self._nside, int(freq), int(self.beamclass[feed]))
        beam = self._beam_cache.get(key)
        if beam is None:
            beam = np.asarray(self.beam(feed, freq))
            if self.single_precision:
                beam = beam.astype(np.complex64 if np.iscomplexobj(beam) else np.float32)
            limit = self.beam_cache_size << 20
            while self._beam_cache_bytes + beam.nbytes > limit and self._beam_cache:
                old = self._beam_cache.pop(next(iter(self._beam_cache)))
                self._beam_cache_bytes -= old.nbytes
            self._beam_cache[key] = beam
            self._beam_cache_bytes += beam.nbytes
        return beam

    _beam_dev_cache = None
    _beam_dev_bytes = 0
    _beam_dev_budget = 1 << 30  # ~1 GB of device beams

    def _beam_device(self, feed, freq):
        """The beam of ``feed`` at ``freq`` on the device grid: the host map
        padded into the (ring, slot) layout with zeroed padding, in the
        grid's precision (complex beams in its complex counterpart),
        uploaded once per (nside, freq, beamclass) and kept in an LRU cache
        of ``_beam_dev_budget`` bytes."""
        if self._beam_dev_cache is None:
            self._beam_dev_cache = {}
            self._beam_dev_bytes = 0
        key = (self._nside, int(freq), int(self.beamclass[feed]))
        beam = self._beam_dev_cache.pop(key, None)
        if beam is None:
            bh = self._beam(feed, freq)
            pad = self._ring_pad_mask.reshape((-1,) + (1,) * (bh.ndim - 1))
            bh = bh[self._ring_pad_index] * pad.astype(bh.real.dtype)
            dt = self.real_dtype
            if np.iscomplexobj(bh):
                dt = torch.complex64 if dt == torch.float32 else torch.complex128
            beam = torch.as_tensor(bh).to(device=self.device, dtype=dt).contiguous()
            nbytes = beam.numel() * beam.element_size()
            while self._beam_dev_bytes + nbytes > self._beam_dev_budget and self._beam_dev_cache:
                old = self._beam_dev_cache.pop(next(iter(self._beam_dev_cache)))
                self._beam_dev_bytes -= old.numel() * old.element_size()
            self._beam_dev_bytes += nbytes
        # (re)inserted last: the most recently used beams are evicted last
        self._beam_dev_cache[key] = beam
        return beam

    def _unit_pairs(self, bl_ind, f_ind):
        """The batch's unique (freq, beamclass) beams and the pairing.

        Returns (keys [(freq, feed)] of the unique beams in first-use
        order, idx_i, idx_j (nu,) int64 on the device, uv3 (nu, 3) float64
        baselines in wavelengths on the device).
        """
        slot = {}
        keys = []
        idx_i, idx_j, uvs = [], [], []
        for bi, fi in zip(bl_ind, f_ind):
            feedi, feedj = self.uniquepairs[bi]
            for feed, idx in ((feedi, idx_i), (feedj, idx_j)):
                key = (int(fi), int(self.beamclass[feed]))
                if key not in slot:
                    slot[key] = len(keys)
                    keys.append((int(fi), int(feed)))
                idx.append(slot[key])
            uvs.append(self.baselines[bi] / self.wavelengths[fi])

        uv = np.array(uvs)
        if self.single_precision:
            uv = uv.astype(np.float32)
        dev = self.device
        uv3 = kernels.uv_cart(torch.as_tensor(self.zenith), torch.as_tensor(uv))
        return (
            keys,
            torch.as_tensor(idx_i, dtype=torch.int64, device=dev),
            torch.as_tensor(idx_j, dtype=torch.int64, device=dev),
            uv3.to(dev).contiguous(),
        )

    def _gather_beams(self, bl_ind, f_ind):
        """Bank rows of the batch's unique beams and the per-unit pairing.

        Only the unique (freq, beamclass) beams are gathered; returns
        (fx (nb, nfx), par (nb, 12), idx_i (nu,), idx_j (nu,), uv3 (nu, 3)
        float64 baselines in wavelengths).
        """
        keys, idx_i, idx_j, uv3 = self._unit_pairs(bl_ind, f_ind)
        par, fx = [], []
        for f, feed in keys:
            p, t, row_of = self._beam_bank_rows(f)
            row = row_of[int(self.beamclass[feed])]
            par.append(p[row])
            fx.append(t[row])
        return torch.stack(fx).contiguous(), torch.stack(par).contiguous(), idx_i, idx_j, uv3

    def _gather_host_beams(self, bl_ind, f_ind):
        """Host-evaluated unique beams of a batch and the per-unit pairing.

        Returns (beams (nb, npix) or (nb, npix, 2) on the device grid,
        idx_i (nu,), idx_j (nu,), uv3 (nu, 3) float64): each unique
        (freq, beamclass) beam crosses to the device once per nside
        (:meth:`_beam_device`).
        """
        keys, idx_i, idx_j, uv3 = self._unit_pairs(bl_ind, f_ind)
        beams = torch.stack([self._beam_device(feed, f) for f, feed in keys])
        return beams, idx_i, idx_j, uv3

    @property
    def _pxarea(self):
        """Pixel area at the current nside (not one over the padded length)."""
        return 4.0 * np.pi / (12 * self._nside**2)

    # ================= draco-compatible maps ==================

    @cached_property
    def prodstack(self):
        """(input_a, input_b) structured array over unique pairs."""
        upairs = self.uniquepairs
        dtype = [("input_a", upairs.dtype), ("input_b", upairs.dtype)]
        return upairs.ravel().view(dtype)

    @cached_property
    def index_map_prod(self):
        """Full upper-triangle `index_map/prod` structured array."""
        tpairs = np.array(np.triu_indices(self.nfeed))
        dtype = [("input_a", tpairs.dtype), ("input_b", tpairs.dtype)]
        return tpairs.T.flatten().view(dtype)

    @cached_property
    def index_map_stack(self):
        """`index_map/stack` (prod index, conjugate) per unique pair."""

        def ind2tri(i, j, n):
            return (n * (n + 1) // 2) - ((n - i) * (n - i + 1) // 2) + (j - i)

        upairs = self.uniquepairs
        stack_map = np.empty(len(upairs), dtype=[("prod", "<u4"), ("conjugate", "u1")])
        stack_map["conjugate"] = upairs[:, 0] > upairs[:, 1]
        input_a, input_b = np.where(stack_map["conjugate"], upairs[:, ::-1].T, upairs.T)
        stack_map["prod"] = ind2tri(input_a, input_b, self.nfeed)
        return stack_map

    @cached_property
    def reverse_map_stack(self):
        """`reverse_map/stack` (stack index, conjugate) per product."""
        stack_revmap = np.empty(
            self.nfeed * (self.nfeed + 1) // 2,
            dtype=[("stack", "<i4"), ("conjugate", "u1")],
        )
        upper = np.triu_indices(self.nfeed)
        stack_revmap["stack"] = self.feedmap[upper]
        stack_revmap["conjugate"] = self.feedconj[upper]
        return stack_revmap


class UnpolarisedTelescope(TransitTelescope, metaclass=abc.ABCMeta):
    """Telescope with a scalar (total-intensity) beam."""

    _npol_sky_ = 1

    @abc.abstractmethod
    def beam(self, feed, freq):
        """Scalar beam map (npix,) of ``feed`` at frequency index ``freq``
        on the compact host grid ``self._angpos``, real or complex."""

    def _beam_map_batch(self, bl_ind, f_ind):
        """Stacked normalised visibility maps for a batch of units: from
        bank rows (K1+K2) or from host-evaluated beams (K2-host)."""
        cart, hor = self._angpos_cart, self._horizon
        if self._bank_beams_apply():
            fx, par, idx_i, idx_j, uv3 = self._gather_beams(bl_ind, f_ind)
            return kernels.bank_visibility_maps(
                cart, hor, fx, par, idx_i, idx_j, uv3, pxarea=self._pxarea
            )
        beams, idx_i, idx_j, uv3 = self._gather_host_beams(bl_ind, f_ind)
        return kernels.host_visibility_maps(
            beams, idx_i, idx_j, uv3, cart, hor, pxarea=self._pxarea
        )

    def noisepower(self, bl_indices, f_indices, ndays=None):
        """Noise power with the factor-1/2 unpolarised correction."""
        bnoise = TransitTelescope.noisepower(self, bl_indices, f_indices, ndays)
        return bnoise[..., np.newaxis] * 0.5


class PolarisedTelescope(TransitTelescope, metaclass=abc.ABCMeta):
    """Telescope with dipole feed beams -> full Stokes transfer matrices.

    ``skip_V`` / ``skip_pol`` transform only Stokes I, Q, U or only I; the
    omitted components stay in the outputs as zeros.  The noise power has
    no factor 1/2 (that correction is the unpolarised telescope's).
    """

    skip_V = config.Property(proptype=bool, default=False)
    skip_pol = config.Property(proptype=bool, default=False)

    _npol_sky_ = 4

    @property
    def polarisation(self):
        raise NotImplementedError("`polarisation` must be implemented.")

    @property
    def _npol_transform(self):
        if self.skip_pol:
            return 1
        if self.skip_V:
            return 3
        return 4

    @property
    def included_pol(self) -> np.ndarray:
        return np.arange(self._npol_transform)

    @abc.abstractmethod
    def beam(self, feed, freq):
        """(npix, 2) field pattern of ``feed`` in the (theta_hat, phi_hat)
        basis on the compact host grid, real or complex."""

    def _beam_map_batch(self, bl_ind, f_ind):
        """Stokes maps (nunit, npol_transform, npix) of a batch of units:
        from bank rows (K1+K2) or host-evaluated beams (K2-host)."""
        cart, hor, npol = self._angpos_cart, self._horizon, self._npol_transform
        if self._bank_beams_apply():
            fx, par, idx_i, idx_j, uv3 = self._gather_beams(bl_ind, f_ind)
            return kernels.bank_stokes_maps(
                cart, hor, fx, par, idx_i, idx_j, uv3, pxarea=self._pxarea, npol=npol
            )
        beams, idx_i, idx_j, uv3 = self._gather_host_beams(bl_ind, f_ind)
        return kernels.host_stokes_maps(
            beams, idx_i, idx_j, uv3, cart, hor, pxarea=self._pxarea, npol=npol
        )


class SimpleUnpolarisedTelescope(UnpolarisedTelescope, metaclass=abc.ABCMeta):
    """Single-beamclass unpolarised telescope (implement `_single_feedpositions`)."""

    @property
    def beamclass(self):
        return np.zeros(self._single_feedpositions.shape[0], dtype=np.int64)

    @property
    @abc.abstractmethod
    def _single_feedpositions(self):
        """(nfeed, 2) positions of the (single polarisation) feeds."""

    @property
    def feedpositions(self):
        return self._single_feedpositions


class SimplePolarisedTelescope(PolarisedTelescope, metaclass=abc.ABCMeta):
    """Dual-polarisation telescope: X feeds (beamclass 0), then Y feeds
    (beamclass 1) at the same positions."""

    @property
    def polarisation(self):
        return np.asarray(
            ["X" if feed % 2 == 0 else "Y" for feed in self.beamclass], dtype=str
        )

    @property
    def beamclass(self):
        nsfeed = self._single_feedpositions.shape[0]
        return np.concatenate((np.zeros(nsfeed), np.ones(nsfeed))).astype(np.int64)

    @property
    @abc.abstractmethod
    def _single_feedpositions(self):
        """(nfeed, 2) positions of the single-polarisation feeds."""

    @property
    def feedpositions(self):
        return np.concatenate((self._single_feedpositions, self._single_feedpositions))

    def beam(self, feed, freq):
        if self.beamclass[feed] % 2 == 0:
            return self.beamx(feed, freq)
        return self.beamy(feed, freq)

    @abc.abstractmethod
    def beamx(self, feed, freq):
        """(npix, 2) field pattern of the X feed."""

    @abc.abstractmethod
    def beamy(self, feed, freq):
        """(npix, 2) field pattern of the Y feed."""
