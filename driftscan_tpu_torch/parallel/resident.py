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

m-bucketing, m-windows, the top-band engine and device meshes are not
ported yet; asking for them raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import telescope as teles
from . import mstep

_NOT_PORTED = "not ported yet: ROADMAP.md, modules to port, item 6"


def btm_resident(tel, bl_indices, f_indices, m_range=None):
    """Compute BTMs for the given units, leaving them on the device.

    Returns (pos (nu, npol, lside+1, lside+1), neg (nu, npol, lside+1,
    lside)) complex tensors on ``tel.device``: pos column m holds m >= 0,
    neg column j holds m = -(j + 1); each unit is masked to its own band
    limit.  A polarised telescope fills its transformed Stokes components;
    the skipped ones stay zero.  ``tel.single_precision`` selects
    complex64.
    """
    if m_range is not None:
        raise NotImplementedError(f"m-windowed BTM tables are {_NOT_PORTED}")
    lside = tel.lmax
    npol = tel.num_pol_sky
    nu = len(bl_indices)
    cdt = torch.complex64 if tel.single_precision else torch.complex128
    pos = torch.zeros((nu, npol, lside + 1, lside + 1), dtype=cdt, device=tel.device)
    neg = torch.zeros((nu, npol, lside + 1, lside), dtype=cdt, device=tel.device)

    # (k, npol_t, l, m) blocks, one SHT call each
    for sel, p, n in tel.btm_blocks(bl_indices, f_indices):
        npt, nl_s = p.shape[1], p.shape[2]
        idx = torch.as_tensor(sel, device=tel.device)
        pos[idx, :npt, :nl_s, :nl_s] = p.to(cdt)
        neg[idx, :npt, :nl_s, : nl_s - 1] = n.to(cdt)
    return pos, neg


def _build_beam_batch(pos, neg, mv, npairs, nfreq, npol, nl):
    """(M, F, 2*npairs, npol*nl) beam matrices from the resident tables.

    Units are baseline-major (u = bl * nfreq + f).  The telescope axis is
    the positive-m pair block, then the conjugate block
    (-1)^m conj(B(-m)), present for m > 0.  Padding slots (m < 0) are zero.
    """
    m = mv.to(pos.device)
    valid = m >= 0
    mc = torch.clamp(m, min=0)
    p = pos[..., mc]  # (nu, npol, nl, M)
    n = neg[..., torch.clamp(mc - 1, min=0)]
    sign = torch.where(mc % 2 == 0, 1.0, -1.0).to(p.real.dtype)
    n = (sign * (m > 0)).to(p.dtype) * n.conj()
    p = p * valid.to(p.dtype)

    def organise(x):
        # (nu, npol, nl, M) -> (M, F, npairs, npol*nl)
        x = x.permute(3, 0, 1, 2).reshape(-1, npairs, nfreq, npol * nl)
        return x.transpose(1, 2)

    return torch.cat([organise(p), organise(n)], dim=2).contiguous()


# One signal Gram level resolves eigenvalues to ~n*eps(f32) of the top;
# with retained modes cut at ~0.1 a single level is accurate whenever the
# batch's top whitened eigenvalue stays below this bound — above it the
# batch is re-solved with the default depth.
_SIG1_TOP_BOUND = 1.0


# Largest m-batch: the JAX package's cap, kept so that the card's m-batches
# match the CPU check's (the adaptive sig1 depth is chosen per batch).
_MBATCH_CAP = 8


def _auto_mbatch_n(n: int, K: int, budget_bytes: float, K_aug=None):
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
    mb = int(max(1, min(_MBATCH_CAP, budget_bytes // max(per_m, 1.0))))
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


def product_all_resident(
    tel, pos, neg, ls, lf, noisew, mbatch=None, max_m=None, mesh=None,
    sig_levels=None, bucket=None, m_range=None, topband=False,
    band_lt=None, ps_threshold=0.1,
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
    """
    if mesh is not None:
        raise NotImplementedError(f"device meshes are {_NOT_PORTED}")
    if m_range is not None:
        raise NotImplementedError(f"m-windows are {_NOT_PORTED}")
    if topband:
        raise NotImplementedError(
            "the top-band KL engine is not ported yet: ROADMAP.md, modules to "
            "port, item 10"
        )
    nm = tel.mmax + 1 if max_m is None else min(max_m, tel.mmax + 1)
    if bucket is None:
        prof = _analytic_dof_bound(tel, nm).astype(np.float64)
        bucket = float((prof**3).sum()) < 0.5 * nm * float(pencil_size(tel)) ** 3
    if bucket:
        raise NotImplementedError(f"m-bucketing is {_NOT_PORTED}")

    dev = pos.device
    rdt = pos.real.dtype
    ls, lf, band_dev = mstep.factors_from_numpy(ls, lf, band_lt, dev, rdt)
    noisew = torch.as_tensor(np.asarray(noisew), dtype=rdt, device=dev)

    if mbatch is None:
        mbatch = auto_mbatch(tel, ls.shape[-1], lf.shape[-1], dev)

    fisher = band_dev is not None
    fish_total = (
        np.zeros((band_dev.shape[0],) * 2, np.complex128) if fisher else None
    )

    evals, nmodes = [], []
    for s in range(0, nm, mbatch):
        ms = np.arange(s, min(s + mbatch, nm))
        mv = np.full(mbatch, -1, np.int64)
        mv[: len(ms)] = ms
        ev, nmo, fm = product_m_batch(
            tel, pos, neg, ls, lf, noisew, mv, band_lt=band_dev,
            ps_threshold=ps_threshold, sig_levels=sig_levels,
        )
        if fisher:
            fish_total += fm
        evals.append(ev[: len(ms)])
        nmodes.append(nmo[: len(ms)])

    if fisher:
        return np.concatenate(evals), np.concatenate(nmodes), fish_total
    return np.concatenate(evals), np.concatenate(nmodes)


def fisher_k(evals, ps_threshold) -> int:
    """The retained-mode count K13 runs at for one m-batch: the batch's
    largest count of KL eigenvalues above ``ps_threshold`` (evals (M, n)
    host array); 0 means the batch adds nothing to the Fisher."""
    return int((np.asarray(evals) > ps_threshold).sum(axis=1).max())


def product_m_batch(tel, pos, neg, ls, lf, noisew, m_values, band_lt=None,
                    ps_threshold=0.1, sig_levels=None):
    """One m-batch of :func:`product_all_resident`, any m's.

    The batch's beams are gathered from the resident tables and go
    through :func:`mstep.kl_product_step` (with the adaptive sig1 depth
    when ``sig_levels`` is None) and, with ``band_lt``, through
    :func:`mstep.fisher_step`.  ls, lf, noisew and band_lt are tensors on
    the tables' device in their real precision
    (:func:`mstep.factors_from_numpy`); m_values (M,) ints, m < 0 marking
    padding.  Returns host (evals (M, F*S), nmodes (M, F), Fisher (nbands,
    nbands) complex128 summed over the batch, or None without band_lt).
    """
    if band_lt is not None and float(ps_threshold) <= 0:
        raise ValueError("ps_threshold must be > 0 for the Fisher pass")
    npol = tel.num_pol_sky
    nl = tel.lmax + 1
    mvt = torch.as_tensor(np.asarray(m_values, dtype=np.int64), device=pos.device)
    beam = _build_beam_batch(pos, neg, mvt, tel.npairs, tel.nfreq, npol, nl)

    def run(levels):
        return mstep.kl_product_step(
            beam, noisew, ls, lf, mvt, npol=npol, nl=nl, sig_levels=levels
        )

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
            )
            fish += fm.sum(0).cpu().numpy().astype(np.complex128)
    return ev, res.nmodes.cpu().numpy(), fish
