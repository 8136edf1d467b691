"""Device-resident product generation: BTM -> SVD -> KL -> Fisher.

Port of ``driftscan_tpu/parallel/resident.py`` (the full-range path on
one device):

* :func:`btm_resident` computes the beam transfer matrices bucket by
  bucket (per nside) and leaves the (l, m) tables on the device, padded to
  the global band limit;
* :func:`product_all_resident` builds each m-batch's beam matrices from
  the tables (a gather along m plus the (-1)^m conjugate negative-m
  block) and runs the product step, and optionally the fused Fisher
  step, so only spectra and the summed Fisher matrix reach the host.

Both take an m-window (``m_range``): the tables then hold only its
columns, the streaming axis for telescopes whose full tables outgrow the
card.  :func:`product_all_resident` can also bucket the m-modes
(``bucket``): a cheap SVD-only pass counts each (m, frequency)'s modes,
and each m-chunk runs with its frequency axis compacted to the active
frequencies and its mode axis capped at the chunk's largest count.  With
``topband`` the KL stage takes the top-band engine (only the eigenpairs
above the retention cut, with an escalation on a failed certificate).
Device meshes are not ported yet; asking for one raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import telescope as teles
from . import mstep


def btm_resident(tel, bl_indices, f_indices, m_range=None):
    """Compute BTMs for the given units, leaving them on the device.

    Returns (pos (nu, npol, lside+1, lside+1), neg (nu, npol, lside+1,
    lside)) complex tensors on ``tel.device``: pos column m holds m >= 0,
    neg column j holds m = -(j + 1); each unit is masked to its own band
    limit.  A polarised telescope fills its transformed Stokes components;
    the skipped ones stay zero.  ``tel.single_precision`` selects
    complex64.

    ``m_range=(m0, m1)`` computes and keeps only that m-window, in the
    uniform layout: both planes have width m1 - m0, column j holding
    m = m0 + j in pos and m = -(m0 + j) in neg (the m = 0 negative column
    is zero).  The full tables grow as units x nl x nm and outgrow the
    card at production band limits; a window costs its share of the SHT,
    and its columns equal the full tables' bit for bit.
    """
    lside = tel.lmax
    npol = tel.num_pol_sky
    nu = len(bl_indices)
    cdt = torch.complex64 if tel.single_precision else torch.complex128
    if m_range is None:
        pw, nw = lside + 1, lside
    else:
        m_range = (int(m_range[0]), int(m_range[1]))
        pw = nw = m_range[1] - m_range[0]
    pos = torch.zeros((nu, npol, lside + 1, pw), dtype=cdt, device=tel.device)
    neg = torch.zeros((nu, npol, lside + 1, nw), dtype=cdt, device=tel.device)

    # (k, npol_t, l, m) blocks, one SHT call each
    for sel, p, n in tel.btm_blocks(bl_indices, f_indices, m_window=m_range):
        npt, nl_s = p.shape[1], p.shape[2]
        idx = torch.as_tensor(sel, device=tel.device)
        pos[idx, :npt, :nl_s, : p.shape[3]] = p.to(cdt)
        neg[idx, :npt, :nl_s, : n.shape[3]] = n.to(cdt)
    return pos, neg


def _build_beam_batch(pos, neg, mv, npairs, nfreq, npol, nl, m_lo=None, f_idx=None,
                      fmask=None):
    """(M, F, 2*npairs, npol*nl) beam matrices from the resident tables.

    Units are baseline-major (u = bl * nfreq + f).  The telescope axis is
    the positive-m pair block, then the conjugate block
    (-1)^m conj(B(-m)), present for m > 0.  Padding slots (m < 0) are zero.
    ``m_lo`` reads tables in the uniform window layout of
    :func:`btm_resident` (column m - m_lo of both planes); None reads the
    full-range layout (neg column m - 1).  ``f_idx`` compacts the frequency
    axis to those frequencies (``fmask`` zeroes its padding slots), after
    the per-m slice, so that no full-band copy of the tables is made.
    """
    m = mv.to(pos.device)
    valid = m >= 0
    mc = torch.clamp(m, min=0)
    if m_lo is None:
        p = pos[..., mc]  # (nu, npol, nl, M)
        n = neg[..., torch.clamp(mc - 1, min=0)]
    else:
        col = torch.clamp(m - m_lo, min=0)
        p = pos[..., col]
        n = neg[..., col]
    sign = torch.where(mc % 2 == 0, 1.0, -1.0).to(p.real.dtype)
    n = (sign * (m > 0)).to(p.dtype) * n.conj()
    p = p * valid.to(p.dtype)
    if f_idx is not None:
        fi = torch.as_tensor(np.asarray(f_idx), device=pos.device)
        fm = torch.as_tensor(np.asarray(fmask), dtype=p.real.dtype, device=pos.device)

    def organise(x):
        # (nu, npol, nl, M) -> (M, F, npairs, npol*nl)
        x = x.permute(3, 0, 1, 2).reshape(-1, npairs, nfreq, npol * nl)
        if f_idx is not None:
            x = x[:, :, fi] * fm[None, None, :, None]
        return x.transpose(1, 2)

    return torch.cat([organise(p), organise(n)], dim=2).contiguous()


def svdcount_batch(tel, pos, neg, noisew, m_values, m_lo=None):
    """Per-(m, frequency) SVD mode counts of an m-batch, the sizing pass of
    the m-bucketing: only the beam build and the SVD stage of the product
    step (:func:`mstep.svd_compress`), so the counts are the ones
    :func:`mstep.kl_product_step` reports (the polarisation residue floor
    and the global svcut included).  m_values (M,) ints, m < 0 marking
    padding (zero counts); noisew a tensor on the tables' device.  Returns
    host (M, F) ints."""
    npol, nl = tel.num_pol_sky, tel.lmax + 1
    mvt = torch.as_tensor(np.asarray(m_values, dtype=np.int64), device=pos.device)
    beam = _build_beam_batch(pos, neg, mvt, tel.npairs, tel.nfreq, npol, nl, m_lo=m_lo)
    nmodes = mstep.svd_compress(beam, noisew, mvt, npol, nl)[3]
    return (nmodes * (mvt >= 0)[:, None]).cpu().numpy()


# One signal Gram level resolves eigenvalues to ~n*eps(f32) of the top;
# with retained modes cut at ~0.1 a single level is accurate whenever the
# batch's top whitened eigenvalue stays below this bound — above it the
# batch is re-solved with the default depth.
_SIG1_TOP_BOUND = 1.0


# Largest m-batch: the JAX package's cap, kept so that the card's m-batches
# match the CPU check's (the adaptive sig1 depth is chosen per batch); a
# compacted m-chunk of the bucketing takes up to _BUCKET_MBATCH_CAP, as in
# the JAX package.
_MBATCH_CAP = 8
_BUCKET_MBATCH_CAP = 16

# Working (basis width, levels) of the top-band engine per pencil
# dimension, remembered across chunks and windows, so that the escalation
# is paid once a shape; its starting width is n / _TB_START_FRAC, the JAX
# package's n / 8.
_TB_STATE: dict = {}
_TB_START_FRAC = 8

# Top-band dispatches of this process: chunk solves, failed certificates
# (each followed by a redispatch at (2k, levels + 1)), and chunks that
# went past k = n/2 to the exact engine.
TB_COUNTS = {"solves": 0, "failed": 0, "exact": 0}


# Least reduction of the pencil dimension F * S for which an m-chunk runs
# compacted; below it the chunk runs at full size.
_BUCKET_MIN_SAVING = 2


def _quant_frac(x: int, full: int) -> int:
    """Smallest power-of-two fraction of ``full`` (full, ~full/2, ~full/4,
    ...) that is >= x: the compacted chunk shapes are quantised, which
    bounds the number of distinct shapes (and cuSOLVER's workspace
    variants) to log2(full) an axis.  The halving stops at 1 (the JAX
    package's loop never ends at x = 1: a chunk with one active frequency
    or one mode a frequency)."""
    x = max(int(x), 1)
    q = full
    while q > 1 and (q + 1) // 2 >= x:
        q = (q + 1) // 2
    return q


def _auto_mbatch_n(n: int, K: int, budget_bytes: float, K_aug=None, cap=_MBATCH_CAP):
    """m-batch size bounding the product step's working set.

    Dominant complex64 per-m buffers: the noise-side CholeskyQR rows
    ((K_aug + n) x n), the whitened signal factor (n x K, K capped at n
    when the compact signal path re-factors it) and a few (n, n) Gram and
    eigh temporaries, with a 3x allowance for temporaries.
    """
    if mstep.uses_compact_signal(n, K):
        K = n
    ka = K if K_aug is None else K_aug
    per_m = ((ka + n) * n + n * K + 6 * n * n) * 8.0 * 3.0
    mb = int(max(1, min(cap, budget_bytes // max(per_m, 1.0))))
    return 1 << (mb.bit_length() - 1)  # power of two


def pencil_size(tel) -> int:
    """The KL pencil dimension n = F * S of the product step, with the
    SVD basis length S = min(nl, 2 * npairs)."""
    return tel.nfreq * min(tel.lmax + 1, 2 * tel.npairs)


def auto_mbatch(tel, ls_width: int, lf_width: int, device) -> int:
    """The m-batch :func:`product_all_resident` picks for ``tel`` on
    ``device``, given the widths of the signal and foreground factors."""
    nl = tel.lmax + 1
    return _auto_mbatch_n(
        pencil_size(tel), nl * ls_width, _device_budget(device), K_aug=nl * lf_width
    )


def _device_budget(device) -> float:
    """A quarter of the card's memory for the product step's batch (the
    JAX package's ratio: 4 GB of a 16 GB chip); 4 GB on the host."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 4.0
    return 4.0 * 2**30


def _analytic_dof_bound(tel, nm, m_lo=0):
    """Host-side upper profile of the per-m pencil dimension, used only to
    decide whether m-bucketing would pay."""
    nl = tel.lmax + 1
    S = min(nl, 2 * tel.npairs)
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    lmax_a, mmax_a = teles.max_lm(
        tel.baselines[blg], tel.wavelengths[fig], tel.u_width, tel.v_width
    )
    lmax_a = np.ceil(np.asarray(lmax_a) * tel.l_boost).reshape(tel.npairs, tel.nfreq)
    mmax_a = np.ceil(np.asarray(mmax_a) * tel.l_boost).reshape(tel.npairs, tel.nfreq)
    ms = (m_lo + np.arange(nm))[:, None, None]
    pair_rows = 2 * (mmax_a[None] >= ms).sum(axis=1)
    lrows = tel.num_pol_sky * np.maximum(lmax_a.max(axis=0)[None] + 1 - ms[:, :, 0], 0)
    return np.minimum(np.minimum(pair_rows, lrows), S).sum(axis=1)


def auto_bucket(tel, nm, m_lo=0) -> bool:
    """The "auto" rule of :func:`product_all_resident`: bucket the m in
    [m_lo, m_lo + nm) when the analytic per-m pencil dimension promises at
    least a halving of the cubic KL cost (e.g. a wide fractional band,
    whose high m hold a fraction of the frequencies)."""
    prof = _analytic_dof_bound(tel, nm, m_lo).astype(np.float64)
    return float((prof**3).sum()) < 0.5 * nm * float(pencil_size(tel)) ** 3


class Chunk(NamedTuple):
    """One dispatch of :func:`product_all_resident`: its m values (padded
    with -1 to the batch size), the frequency slots of a compacted chunk
    (``f_idx``, padded with its last active frequency; None at full size)
    with the number of active ones, and the pencil's frequency and mode
    sizes (fq, sq); fq * sq is its dimension."""

    m_values: np.ndarray
    f_idx: Optional[np.ndarray]
    nact: int
    fq: int
    sq: int

    @property
    def compacted(self) -> bool:
        return self.f_idx is not None

    @property
    def fmask(self):
        if self.f_idx is None:
            return None
        return (np.arange(self.fq) < self.nact).astype(np.float64)


def mode_counts(tel, pos, neg, noisew, m_values, mbatch, m_lo=None):
    """The bucketing's sizing pass: (len(m_values), F) SVD mode counts, in
    batches of max(mbatch, 16) m (:func:`svdcount_batch`); ``m_lo`` reads
    window tables."""
    cb = max(mbatch, 16)
    rows = []
    for s in range(0, len(m_values), cb):
        ms = m_values[s : s + cb]
        mv = np.full(cb, -1, np.int64)
        mv[: len(ms)] = ms
        rows.append(svdcount_batch(tel, pos, neg, noisew, mv, m_lo=m_lo)[: len(ms)])
    return np.concatenate(rows)


def plan_chunks(counts, m_lo, F, S, mbatch, mb_for):
    """The m-chunks of a bucketed run, the JAX package's rule: each chunk's
    batch is sized at its head m's compacted shape, then the chunk takes
    the quantised shape (``_quant_frac``) of its own largest count (sq) and
    active frequencies (fq); it runs at full size (F, S, ``mbatch``) when
    fq * sq * ``_BUCKET_MIN_SAVING`` > F * S.  ``mb_for(n)`` is the
    compacted batch size for a pencil of dimension n.  Returns [Chunk]."""
    nm = counts.shape[0]
    chunks = []
    s = 0
    while s < nm:
        sq = _quant_frac(int(counts[s].max()), S)
        fq = _quant_frac(int((counts[s] > 0).sum()), F)
        mb = mb_for(fq * sq)
        ms = m_lo + np.arange(s, min(s + mb, nm))
        cc = counts[ms - m_lo]
        sq = _quant_frac(int(cc.max()), S)
        act = np.nonzero(cc.max(axis=0) > 0)[0]
        fq = _quant_frac(max(len(act), 1), F)
        if fq * sq * _BUCKET_MIN_SAVING > F * S or (fq >= F and sq >= S):
            mb = mbatch
            ms = m_lo + np.arange(s, min(s + mb, nm))
            f_idx, nact, fq, sq = None, F, F, S
        else:
            # never grow the chunk past the m its caps were measured on
            mb = min(mb, mb_for(fq * sq))
            ms = ms[:mb]
            f_idx = np.full(fq, act[-1] if len(act) else 0, np.int64)
            f_idx[: len(act)] = act
            nact = len(act)
        mv = np.full(mb, -1, np.int64)
        mv[: len(ms)] = ms
        chunks.append(Chunk(mv, f_idx, nact, fq, sq))
        s += mb
    return chunks


def product_all_resident(
    tel, pos, neg, ls, lf, noisew, mbatch=None, max_m=None, mesh=None,
    sig_levels=None, bucket=None, m_range=None, topband=False,
    band_lt=None, ps_threshold=0.1, chunks=None, kl_cut=0.1,
):
    """Run the SVD+KL product step (and the fused Fisher) over every m.

    ls, lf, noisew (and band_lt) are host arrays or tensors; they are
    moved to the tables' device in the tables' real precision.  Returns
    host numpy (evals (nm, F*S), nmodes (nm, F)), plus the (nbands,
    nbands) complex128 Fisher matrix summed over m when ``band_lt`` (from
    :func:`mstep.band_factor_table`) is given.

    ``sig_levels=None`` picks the signal-side depth per batch: one Gram
    level first, and the default depth again for any batch whose top
    eigenvalue exceeds ``_SIG1_TOP_BOUND``.  ``mbatch=None`` sizes the
    batch from the device's memory.

    ``m_range=(m0, m1)`` runs the m in [m0, m1) from tables made by
    ``btm_resident(..., m_range=(m0, m1))``; ``max_m`` then counts from m0.

    ``bucket=True`` first counts every m's SVD modes per frequency
    (:func:`mode_counts`), then runs each m-chunk of :func:`plan_chunks`
    with its frequency axis compacted to the active frequencies and its
    mode axis capped at the chunk's largest count, and pads the results
    back to the full layout (spectra left-padded with zeros to F*S, counts
    at their frequencies).  ``bucket=None`` (auto) buckets when the
    telescope's analytic per-m dimension promises at least a halving of
    the cubic KL cost (:func:`auto_bucket`).  ``chunks``, a list, receives
    one :class:`Chunk` per dispatch.

    ``topband=True`` solves the KL pencil with the top-band engine
    (:func:`_run_topband`): only the eigenvalues >= ``kl_cut`` (the
    retention cut the spectrum will be cut at) are computed, the rest are
    exact zeros; a chunk with a failed certificate is redispatched with a
    doubled basis and one more level, and past a basis of half the pencil
    it takes the exact engine.
    """
    if mesh is not None:
        raise NotImplementedError(
            "device meshes are not ported yet: ROADMAP.md, modules to port, item 11"
        )
    if m_range is not None:
        m_lo, m_hi = int(m_range[0]), int(m_range[1])
        if pos.shape[-1] != m_hi - m_lo or neg.shape[-1] != m_hi - m_lo:
            raise ValueError(
                f"m_range {m_range} needs tables of width {m_hi - m_lo} "
                f"(btm_resident(..., m_range=...)), not {pos.shape[-1]}"
            )
    else:
        m_lo, m_hi = 0, tel.mmax + 1
    # the first m of window tables (None: the full-range layout)
    m_tab = None if m_range is None else m_lo
    if max_m is not None:
        m_hi = min(m_hi, m_lo + max_m)
    nm = m_hi - m_lo
    F = tel.nfreq
    S = pencil_size(tel) // F
    if bucket is None:
        bucket = auto_bucket(tel, nm, m_lo)

    dev = pos.device
    rdt = pos.real.dtype
    ls, lf, band_dev = mstep.factors_from_numpy(ls, lf, band_lt, dev, rdt)
    noisew = torch.as_tensor(np.asarray(noisew), dtype=rdt, device=dev)

    if mbatch is None:
        mbatch = auto_mbatch(tel, ls.shape[-1], lf.shape[-1], dev)

    if bucket:
        nl = tel.lmax + 1
        counts = mode_counts(tel, pos, neg, noisew, np.arange(m_lo, m_hi), mbatch, m_tab)
        budget = _device_budget(dev)

        def mb_for(n):
            return _auto_mbatch_n(n, nl * ls.shape[-1], budget, K_aug=nl * lf.shape[-1],
                                  cap=_BUCKET_MBATCH_CAP)

        plan = plan_chunks(counts, m_lo, F, S, mbatch, mb_for)
    else:
        plan = []
        for s in range(0, nm, mbatch):
            mv = np.full(mbatch, -1, np.int64)
            ms = m_lo + np.arange(s, min(s + mbatch, nm))
            mv[: len(ms)] = ms
            plan.append(Chunk(mv, None, F, F, S))

    fisher = band_dev is not None
    fish_total = (
        np.zeros((band_dev.shape[0],) * 2, np.complex128) if fisher else None
    )

    evals, nmodes = [], []
    for ch in plan:
        if chunks is not None:
            chunks.append(ch)
        take = int((ch.m_values >= 0).sum())
        ev, nmo, fm = product_m_batch(
            tel, pos, neg, ls, lf, noisew, ch.m_values, band_lt=band_dev,
            ps_threshold=ps_threshold, sig_levels=sig_levels,
            m_lo=m_tab, chunk=ch, kl_cut=kl_cut if topband else None,
        )
        if fisher:
            fish_total += fm
        ev, nmo = ev[:take], nmo[:take]
        if ch.compacted:
            # back to the full layout: the full-size pencil has the same
            # eigenvalues plus exact zeros, which sort to the front
            ev = np.pad(ev, ((0, 0), (F * S - ev.shape[1], 0)))
            full = np.zeros((take, F), dtype=nmo.dtype)
            full[:, ch.f_idx[: ch.nact]] = nmo[:, : ch.nact]
            nmo = full
        evals.append(ev)
        nmodes.append(nmo)

    if fisher:
        return np.concatenate(evals), np.concatenate(nmodes), fish_total
    return np.concatenate(evals), np.concatenate(nmodes)


def fisher_k(evals, ps_threshold) -> int:
    """The retained-mode count K13 runs at for one m-batch: the batch's
    largest count of KL eigenvalues above ``ps_threshold`` (evals (M, n)
    host array); 0 means the batch adds nothing to the Fisher."""
    return int((np.asarray(evals) > ps_threshold).sum(axis=1).max())


def _run_topband(run, n_chunk, kl_cut, exact_levels):
    """One chunk through the top-band engine, with the escalation.

    ``run(levels, **kw)`` runs the product step's KL stage on the chunk's
    SVD stage, computed once (:func:`mstep.kl_solve_step`).  Starts from the (k,
    levels) remembered for this pencil dimension (n / _TB_START_FRAC
    columns, quantised, at least 8; 5 levels); while some m fails its
    certificate the chunk is redispatched at (2k, levels + 1); past k =
    n/2 the filtered engine no longer pays and the chunk takes the exact
    engine at ``exact_levels``.  Returns the product step's result."""
    k, lv = _TB_STATE.get(
        n_chunk, (_quant_frac(max(n_chunk // _TB_START_FRAC, 8), n_chunk), 5)
    )
    while k <= n_chunk // 2:
        TB_COUNTS["solves"] += 1
        res = run(2, kl_cut=float(kl_cut), kl_top_k=int(min(k, n_chunk)), kl_levels=int(lv))
        if bool(res.ok.all()):
            _TB_STATE[n_chunk] = (k, lv)
            return res
        TB_COUNTS["failed"] += 1
        k, lv = 2 * k, lv + 1
    TB_COUNTS["exact"] += 1
    return run(exact_levels)


def product_m_batch(tel, pos, neg, ls, lf, noisew, m_values, band_lt=None,
                    ps_threshold=0.1, sig_levels=None, m_lo=None, chunk=None,
                    kl_cut=None):
    """One m-batch of :func:`product_all_resident`, any m's.

    The batch's beams are gathered from the resident tables and go
    through :func:`mstep.kl_product_step` (with the adaptive sig1 depth
    when ``sig_levels`` is None) and, with ``band_lt``, through
    :func:`mstep.fisher_step`.  ls, lf, noisew and band_lt are tensors on
    the tables' device in their real precision
    (:func:`mstep.factors_from_numpy`); m_values (M,) ints, m < 0 marking
    padding; ``m_lo`` reads window tables (:func:`_build_beam_batch`).  A
    compacted ``chunk`` (:class:`Chunk`) gathers the beams, noisew, ls, lf
    and band_lt to its frequency slots and caps the pencil at its sq modes
    a frequency.  Returns host (evals (M, F*S), nmodes (M, F), Fisher
    (nbands, nbands) complex128 summed over the batch, or None without
    band_lt), with the chunk's fq and sq for F and S.  ``kl_cut`` set
    solves the pencil with the top-band engine (:func:`_run_topband`; a
    chunk that falls back to the exact engine takes the default depth
    where ``sig_levels`` is None, as in the JAX package).
    """
    if band_lt is not None and float(ps_threshold) <= 0:
        raise ValueError("ps_threshold must be > 0 for the Fisher pass")
    npol = tel.num_pol_sky
    nl = tel.lmax + 1
    mvt = torch.as_tensor(np.asarray(m_values, dtype=np.int64), device=pos.device)
    f_idx = s_cap = None
    if chunk is not None and chunk.compacted:
        f_idx, s_cap = chunk.f_idx, chunk.sq
        fi = torch.as_tensor(f_idx, device=pos.device)
        noisew, ls, lf = noisew[fi], ls[:, :, fi], lf[:, :, fi]
    beam = _build_beam_batch(
        pos, neg, mvt, tel.npairs, tel.nfreq, npol, nl, m_lo=m_lo, f_idx=f_idx,
        fmask=None if chunk is None else chunk.fmask,
    )

    # the SVD stage once; each solve of the pencil (a deeper exact solve, a
    # top-band redispatch) reuses it
    comp = mstep.compress_step(beam, noisew, ls, lf, mvt, npol=npol, nl=nl, s_cap=s_cap or 0)

    def run(levels, **kw):
        return mstep.kl_solve_step(comp, sig_levels=levels, **kw)

    if kl_cut is not None:
        n_chunk = pencil_size(tel) if chunk is None else chunk.fq * chunk.sq
        res = _run_topband(run, n_chunk, kl_cut, 2 if sig_levels is None else sig_levels)
        ev = res.evals.cpu().numpy()
    else:
        res = run(1 if sig_levels is None else sig_levels)
        ev = res.evals.cpu().numpy()
        if sig_levels is None and ev.max() > _SIG1_TOP_BOUND:
            res = run(2)
            ev = res.evals.cpu().numpy()
    fish = None
    if band_lt is not None:
        fish = np.zeros((band_lt.shape[0],) * 2, np.complex128)
        kf = fisher_k(ev, ps_threshold)
        if kf:
            fm = mstep.fisher_step(
                res.evals, res.evecs, res.beam_svd, band_lt,
                ps_threshold=float(ps_threshold), npol=npol, nl=nl, kf=kf,
                s_cap=s_cap or 0, f_idx=f_idx,
            )
            fish += fm.sum(0).cpu().numpy().astype(np.complex128)
    return ev, res.nmodes.cpu().numpy(), fish
