"""Factored-covariance KL pencil solver (native complex).

Port of the exact QR path of ``driftscan_tpu/ops/fpencil.py``.  The KL
stage solves the generalised Hermitian problem S v = w N v projected into
the SVD basis, without ever forming the ill-conditioned dense
covariances:

* each per-l sky covariance block is factored once on the host in
  float64, C_l = L_l L_l^H (:func:`factor_cl`);
* per m, the projected signal factor is either the wide product
  A = B_svd L (:func:`beam_factor`) or, when that is wider than 2n, the
  (n, n) Cholesky factor of S = (B L)(B L)^H (:func:`beam_factor_compact`,
  whose Gram is the hand-written kernel K9);
* the noise N = I + A_f A_f^H is given by its factor rows
  [A_f^H; I]; its triangular factor R comes from shifted CholeskyQR
  (:func:`chol_qr_r`), and the pencil eigenvalues are the squared
  singular values of R^-H A_s, resolved by Gram deflation levels
  (:func:`gram_bands`);
* the two-stage DoubleKL pencil (:func:`doublekl_solve_qr`) composes the
  same pieces: a foreground stage with the thermal noise suppressed, then
  the thermal pencil on the modes that stage keeps;
* the top-band engine (:func:`gram_topband` and the ``*_topband``
  solvers) computes only the eigenpairs above the KL cut, by a
  Chebyshev-filtered subspace iteration whose filter step is the
  hand-written kernel K17 (ops.cheb), without a full eigendecomposition;
* the opt-in engines of the JAX package: ``kl_solve(method="gram")``, the
  multi-level Gram deflation of the foreground factor itself
  (:func:`whiten_apply_idpluslr`, :func:`whiten_apply_floor`); the
  rank-capped quick-look (``sig_k_cap`` / ``fg_k_cap``,
  :func:`gram_bands_topk`); and the whitening variants selected by the
  module levers ``_QR_IMPL`` and ``_WHITEN_IMPL`` (:func:`_make_whitener`).

Every function is batched over leading axes: a Python loop or a batch
dimension takes the place of the JAX package's ``vmap``/``scan``.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import backend
from . import cheb

K9 = backend.register(
    "k9_signal_gram",
    "driftscan_tpu_torch/csrc/signal_gram.cu",
    "driftscan_tpu/ops/fpencil.py:225",
)


# ------------------------------------------------------------------
# Host-side: factor the per-l sky covariance blocks (f64, once per run)
# ------------------------------------------------------------------


def factor_cl(cl, out_dtype=np.float32, compact_rank=True, rank_rtol=1e-15):
    """Factor per-l sky covariance blocks: C_l = L_l L_l^H (host, f64).

    Parameters
    ----------
    cl : (npol, npol, nl, F, F) real array
        Angular covariance blocks C_l[p, q, f, g] (as produced by
        skymodel.foreground_model / im21cm_model).
    out_dtype
        dtype of the returned factor (factor entries span only half the
        decades of the covariance, so f32 is adequate for f32 pipelines).
    compact_rank
        Spectrally smooth covariances (foregrounds: the whole premise of
        KL foreground removal) have tiny per-(l, pol) numerical
        frequency rank r even at hundreds of frequencies.  When the
        worst block's rank is below F/2, factor by per-block f64 eigh
        truncated at ``rank_rtol * w_max(l, pol)`` instead of Cholesky:
        the downstream pencil width — and with it the memory and the
        per-round CholeskyQR cost of the noise whitening, both linear in
        the factor width — shrinks by F/r (measured 768 -> 24 columns
        for the standard foreground model at 256 frequencies).
        Full-rank covariances (the 21 cm signal, which decorrelates
        rapidly in frequency) fall back to the Cholesky path
        automatically.
    rank_rtol
        Relative eigenvalue cut (vs the per-block maximum) for
        ``compact_rank``.  The default sits at f64 eigh resolution:
        KL pencil eigenvalues are sensitive to *absolute* covariance
        perturbations at the thermal floor — many decades below the
        foreground maximum — so the cut must discard only what the f64
        input rounding already corrupts (a per-l-max-relative 1e-12 cut
        measurably biases near-floor KL eigenvalues by ~1%).

    Returns
    -------
    L : (nl, npol, F, K) array such that
        C_l[p,q,f,g] = sum_k L[l,p,f,k] L[l,q,g,k].
        For pol-block-diagonal covariances (every standard sky model) the
        zero columns are compacted away: K = n_active_pols * F (or
        n_active_pols * r_max when rank compaction wins), which directly
        shrinks the pencil's factor width downstream.
    """
    in_eps = np.finfo(np.asarray(cl).dtype).eps
    # The rank floor can't sit below the input's own rounding noise: an
    # f32-cast covariance has eigenvalue noise ~sqrt(F)*eps32*w_max, so
    # a 1e-15 cut correctly measures full rank there and compaction
    # falls back to Cholesky (callers wanting compaction must supply
    # f64 covariances — see bench._covariances).
    rank_rtol = max(rank_rtol, 8.0 * float(in_eps))
    cl = np.asarray(cl, dtype=np.float64)
    npol, _, nl, F, _ = cl.shape

    def _block_sqrt(b):
        """(nl, F, F) PSD blocks -> (nl, F, F) factors, Cholesky-first."""
        b = 0.5 * (b + b.transpose(0, 2, 1))
        d = np.einsum("lii->li", b).max(axis=1)
        ok = d > 0
        out = np.zeros_like(b)
        if not ok.any():
            return out
        jit = 1e-12 * d[ok]
        n = b.shape[-1]
        try:
            out[ok] = np.linalg.cholesky(b[ok] + jit[:, None, None] * np.eye(n))
        except np.linalg.LinAlgError:
            # semi-definite numerics: eigh square root (slower, exactly
            # the old behaviour)
            w, q = np.linalg.eigh(b[ok])
            w = np.maximum(w, 0.0)
            out[ok] = q * np.sqrt(w)[:, None, :]
        return out

    # Pol-block-diagonal fast path (standard sky models have no pol
    # cross-covariances): per-pol (nl, F, F) Cholesky on the contiguous
    # diagonal blocks — no 5-axis transpose of the full array, which at
    # 256 freqs x lmax 1000 is a 17 GB strided copy costing ~5 minutes
    # on a single-core host.
    cross = any(
        np.any(cl[p, q])
        for p in range(npol)
        for q in range(npol)
        if p != q
    )
    if not cross:
        active_pols = [p for p in range(npol) if np.any(cl[p, p])]

        if compact_rank and active_pols:
            # Measure the numerical frequency rank per (l, pol) block.
            facs, ranks = [], []
            for p in active_pols:
                b = 0.5 * (cl[p, p] + cl[p, p].transpose(0, 2, 1))
                w, q = np.linalg.eigh(b)  # ascending
                wmax = np.maximum(w[:, -1:], 0.0)
                keep = w > rank_rtol * wmax + 1e-300
                ranks.append(int(keep.sum(axis=1).max()))
                facs.append((w, q, keep))
            r_max = max(ranks)
            if r_max <= F // 2:
                # quantise to a power of two: the factor width is a
                # compiled-shape axis downstream
                r_q = 1 << (max(r_max, 1) - 1).bit_length()
                K = len(active_pols) * r_q
                L = np.zeros((nl, npol, F, K))
                for i, (p, (w, q, keep)) in enumerate(zip(active_pols, facs)):
                    # top-r_q eigenpairs are the last r_q columns (w asc)
                    wt = np.where(keep, np.maximum(w, 0.0), 0.0)[:, -r_q:]
                    qt = q[:, :, -r_q:]
                    L[:, p, :, i * r_q : (i + 1) * r_q] = qt * np.sqrt(wt)[
                        :, None, :
                    ]
                return np.ascontiguousarray(L.astype(out_dtype))

        K = max(len(active_pols), 1) * F
        L = np.zeros((nl, npol, F, K))
        for i, p in enumerate(active_pols):
            L[:, p, :, i * F : (i + 1) * F] = _block_sqrt(cl[p, p])
        return np.ascontiguousarray(L.astype(out_dtype))

    # General (pol-coupled) path: dense (npol F)^2 blocks
    npf = npol * F
    m = cl.transpose(2, 0, 3, 1, 4).reshape(nl, npf, npf)
    L = _block_sqrt(m)
    return np.ascontiguousarray(L.reshape(nl, npol, F, npf).astype(out_dtype))



# ------------------------------------------------------------------
# Device-side: project a factor through the SVD beam
# ------------------------------------------------------------------


def _real_factor(L, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(L, dtype=backend.real_dtype(like.dtype), device=like.device)


def beam_factor(bsvd: torch.Tensor, L) -> torch.Tensor:
    """Projected covariance factor A = B_svd L, in factored (tall) form.

    bsvd : (..., F, S, npol, nl) complex — the sky->SVD projection.
    L : (nl, npol, F, K) real — output of :func:`factor_cl`.
    Returns (..., F*S, nl*K): A[(f a), (l k)] = sum_p bsvd[f,a,p,l] L[l,p,f,k].
    """
    F, S = bsvd.shape[-4], bsvd.shape[-3]
    L = _real_factor(L, bsvd)
    nl, K = L.shape[0], L.shape[-1]
    br = torch.view_as_real(bsvd)  # (..., F, S, npol, nl, 2)
    a = torch.einsum("...faplc,lpfk->...falkc", br, L)
    a = torch.view_as_complex(a.contiguous())
    return a.reshape(bsvd.shape[:-4] + (F * S, nl * K))


def signal_gram_ref(bsvd: torch.Tensor, L) -> torch.Tensor:
    """Plain PyTorch version of :func:`signal_gram`: S = A A^H."""
    a = beam_factor(bsvd, L)
    return a @ a.conj().transpose(-1, -2)


def signal_gram(bsvd: torch.Tensor, L) -> torch.Tensor:
    """S = (B L)(B L)^H without forming the wide factor (K9).

    bsvd : (M, F, S, npol, nl) complex; L : (nl, npol, F, K) real.
    Returns (M, F*S, F*S) complex, accumulated in the input precision.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    L = _real_factor(L, bsvd)
    if not backend.on_cuda(bsvd, L):
        return signal_gram_ref(bsvd, L)
    M, F, S, npol, nl = bsvd.shape
    K = L.shape[-1]
    backend.require(bsvd, "bsvd", dtype=(torch.complex64, torch.complex128), ndim=5)
    L = L.contiguous()
    backend.require(L, "L", shape=(nl, npol, F, K))
    n = F * S
    out = torch.empty((M, n, n), dtype=bsvd.dtype, device=bsvd.device)
    part, (part_ptr, part_bytes, nsplit, cps) = backend.gram_launch(n, nl * K, M, bsvd)
    fn = K9.entry(
        "signal_gram_c64" if bsvd.dtype == torch.complex64 else "signal_gram_c128",
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    )
    backend.launch(
        K9, fn, bsvd.device,
        bsvd.data_ptr(), L.data_ptr(), out.data_ptr(), part_ptr, part_bytes,
        M, F, S, npol, nl, K, nsplit, cps,
    )
    return out


def _herm(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.conj().transpose(-1, -2))


def beam_factor_compact(bsvd: torch.Tensor, L) -> torch.Tensor:
    """(n, n) Cholesky re-factorisation of S = (B L)(B L)^H.

    rank(S) <= n, so an (n, n) factor reproduces the pencil up to
    formation rounding while every downstream stage pays O(n^2 n)
    instead of O(n^2 nl K).  S comes from :func:`signal_gram`; its
    Cholesky is taken in complex128 with the smallest relative diagonal
    shift of the ladder {1e-10, 1e-7, 1e-4, 1e-2} whose factorisation
    succeeds (``cholesky_ex`` info, per batch element): S is PSD and often
    rank-deficient, and the float32 Gram can push small eigenvalues
    slightly negative.  bsvd (M, F, S, npol, nl); returns the (M, n, n)
    factor in complex128, the pencil's precision.
    """
    s = _herm(signal_gram(bsvd, L)).to(torch.complex128)
    n = s.shape[-1]
    eye = torch.eye(n, dtype=s.dtype, device=s.device)
    dmax = torch.diagonal(s, dim1=-2, dim2=-1).real.amax(-1) + 1e-30
    out = None
    for rel in (1e-2, 1e-4, 1e-7, 1e-10):
        cand, info = torch.linalg.cholesky_ex(s + (rel * dmax)[..., None, None] * eye)
        if out is None:
            out = cand  # the 1e-2 rung is the always-finite backstop
        else:
            out = torch.where((info == 0)[..., None, None], cand, out)
    return out


# ------------------------------------------------------------------
# Multi-level Gram deflation
# ------------------------------------------------------------------


class GramBands(NamedTuple):
    """Banded left singular structure of a factor X (..., n, K).

    q : (levels, ..., n, n) per-level eigenvector columns, zeroed outside
        the level's band; s : (levels, ..., n) singular values, zeroed
        outside the band (the last level keeps every column).
    """

    q: torch.Tensor
    s: torch.Tensor


# calls of :func:`_eigh_scaled` that took the SVD (cuSOLVER's eigh failed)
svd_retries = 0


def _eigh_scaled(g: torch.Tensor):
    """torch.linalg.eigh of g scaled by the power of two nearest max|g|.

    cuSOLVER's Hermitian eigensolver fails to converge on finite Grams
    of small scale (measured on an H100: complex64 at max|g| ~ 1e-7, the
    bench telescope's m >= 200), while the same matrices scaled to ~1
    converge.  A power-of-two scale is exact, so the eigenvalues and
    vectors are those of g itself.  A Gram below tiny/eps (a zero-padded
    m slot, or subnormal roundoff) is zero to working precision: it gets
    eigenvalues 0 and the identity basis, without a solver call that
    subnormal entries can break.  Where the eigensolver still fails (on
    an H100, the full-size n = 3200 complex128 Grams of the ns2 telescope,
    whose ~2,900 eigenvalues below 1e-12 of the top break cuSOLVER's
    divide and conquer; MAGMA and LAPACK converge), the batch takes the
    SVD: g is a Gram, Hermitian positive semidefinite, so its singular
    values and left vectors are its eigenvalues and vectors.
    """
    global svd_retries
    fin = torch.finfo(g.real.dtype)
    amax = g.abs().amax(dim=(-2, -1))
    zero = amax <= fin.tiny / fin.eps
    scale = torch.where(
        zero, torch.ones_like(amax), torch.exp2(torch.round(torch.log2(amax)))
    )
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    gs = torch.where(zero[..., None, None], eye, g / scale[..., None, None].to(g.dtype))
    try:
        w, q = torch.linalg.eigh(gs)
    except torch.linalg.LinAlgError:
        svd_retries += 1
        u, sv, _ = torch.linalg.svd(gs)
        w, q = sv.flip(-1), u.flip(-1)  # ascending, as eigh
    return torch.where(zero[..., None], 0.0, w * scale[..., None]), q


def _gram_level_scan(x: torch.Tensor, levels: int, band_rel: float, eig_fn) -> GramBands:
    """The level loop shared by :func:`gram_bands` and :func:`gram_bands_topk`.

    ``eig_fn(g) -> (s, q)``: descending non-negative singular values and
    the matching left-vector columns of the level Gram ``g``.  Each level
    keeps the values above ``band_rel * s_max_level`` (the last level keeps
    every column) and deflates that subspace out of X twice (CGS2: one pass
    leaks ~eps * s_max_level into the remainder, which would floor every
    later level at that leak).
    """
    qs, ss = [], []
    xc = x
    for level in range(levels):
        g = _herm(xc @ xc.conj().transpose(-1, -2))
        s, q = eig_fn(g)
        if level == levels - 1:
            maskf = torch.ones_like(s)
        else:
            maskf = (s > s[..., :1] * band_rel).to(s.dtype)
        qm = q * maskf[..., None, :]
        qs.append(qm)
        ss.append(s * maskf)
        if level < levels - 1:
            for _ in range(2):
                proj = qm.conj().transpose(-1, -2) @ xc
                xc = xc - qm @ proj
    return GramBands(torch.stack(qs), torch.stack(ss))


def _eig_desc(g: torch.Tensor):
    """Full eigendecomposition of a level Gram: (s descending, q)."""
    w, q = _eigh_scaled(g)  # ascending
    return torch.sqrt(torch.clamp(w.flip(-1), min=0.0)), q.flip(-1)


def gram_bands(x: torch.Tensor, levels: int = 3, band_rel: float = 3e-2) -> GramBands:
    """Left singular structure of X over ~levels*|log10(band_rel)| decades.

    Each level forms G = X X^H, takes its eigendecomposition, keeps the
    singular values above ``band_rel * s_max_level``, deflates that
    subspace out of X twice (CGS2) and repeats on the remainder.
    """
    return _gram_level_scan(x, levels, band_rel, _eig_desc)


def _chol_qr_real(v: torch.Tensor) -> torch.Tensor:
    """Orthonormalise a real column block (..., m, k) by two rounds of
    CholeskyQR, each Gram shifted by 1e-5 of its largest diagonal entry
    plus 1e-30 (subspace iteration drives the Gram numerically singular;
    the repeat restores orthogonality)."""
    k = v.shape[-1]
    eye = torch.eye(k, dtype=v.dtype, device=v.device)
    for _ in range(2):
        g = v.transpose(-1, -2) @ v
        g = 0.5 * (g + g.transpose(-1, -2))
        shift = 1e-5 * torch.diagonal(g, dim1=-2, dim2=-1).amax(-1) + 1e-30
        low, _ = torch.linalg.cholesky_ex(g + shift[..., None, None] * eye)
        v = torch.linalg.solve_triangular(low, v.transpose(-1, -2), upper=False).transpose(-1, -2)
    return v


def _embed_herm(h: torch.Tensor) -> torch.Tensor:
    """Real symmetric embedding [[A, -B], [B, A]] of a Hermitian H = A + iB."""
    top = torch.cat([h.real, -h.imag], dim=-1)
    bot = torch.cat([h.imag, h.real], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _unembed_vecs(v2n: torch.Tensor) -> torch.Tensor:
    """Complex vectors from the columns of a 2n real embedding's vectors."""
    n = v2n.shape[-2] // 2
    return torch.complex(v2n[..., :n, :], v2n[..., n:, :])


def _top_band_eigh(g: torch.Tensor, k_c: int, iters: int = 8):
    """Approximate top-k_c eigenpairs of a Hermitian PSD matrix (..., n, n).

    The JAX package's iterate, on the real symmetric embedding
    [[A, -B], [B, A]] (a native complex subspace iteration spans another
    subspace): from the real start block of :func:`_start_block` (2n, 2k),
    ``iters`` steps of the embedding (normalised by max(|A|, |B|)) each
    followed by :func:`_chol_qr_real`; one (2k, 2k) Rayleigh-Ritz eigh;
    the embedding doubles every eigenvalue, so the even-indexed Ritz pairs
    are kept and the reassembled complex vectors get two Newton steps
    V <- V (3I - V^H V) / 2 towards orthonormality.

    Past k_c = n the start block is the Q of the (2n, 2 k_c) draw, 2n
    columns, as in the JAX program, and n pairs are returned: the JAX
    program gathers the even indices past 2n clamped to the last Ritz
    pair, repeating the smallest value.  Returns (w (..., min(k_c, n))
    descending Ritz values, v (..., n, min(k_c, n)) columns).
    """
    n = g.shape[-1]
    e = _embed_herm(g)
    scale = torch.maximum(g.real.abs().amax(dim=(-2, -1)), g.imag.abs().amax(dim=(-2, -1))) + 1e-30
    en = e / scale[..., None, None]
    v = _start_block(2 * n, 2 * k_c, en)
    k_c = int(min(k_c, n))
    v = v.expand(en.shape[:-2] + v.shape)
    for _ in range(iters):
        v = _chol_qr_real(en @ v)
    h = v.transpose(-1, -2) @ (en @ v)
    h = 0.5 * (h + h.transpose(-1, -2))
    w2, u = _eigh_scaled(h)  # ascending
    w2 = w2.flip(-1) * scale[..., None]
    ritz = v @ u.flip(-1)
    w = w2[..., 0::2]
    vc = _unembed_vecs(ritz[..., 0::2])
    eye = torch.eye(k_c, dtype=vc.dtype, device=vc.device)
    for _ in range(2):
        vc = vc @ (1.5 * eye - 0.5 * (vc.conj().transpose(-1, -2) @ vc))
    return w, vc


def gram_bands_topk(
    x: torch.Tensor, levels: int, band_rel: float, k_cap: int, iters: int = 8
) -> GramBands:
    """Rank-capped :func:`gram_bands`: each level extracts at most ``k_cap``
    directions by :func:`_top_band_eigh` instead of a full eigh.

    Directions a level cannot hold stay in the deflated remainder and
    surface at the next level; the last level is not complete.  The JAX
    package's quick-look: approximate by design (band-edge Ritz vectors
    converge slowly on continuous spectra), for spectrum-style passes and
    the identity-plus-low-rank whitening only.  The bands are (levels,
    ..., n, min(k_cap, n)).
    """

    def eig_fn(g):
        w, q = _top_band_eigh(g, k_cap, iters=iters)  # descending
        return torch.sqrt(torch.clamp(w, min=0.0)), q

    return _gram_level_scan(x, levels, band_rel, eig_fn)


def _select_complete_basis(bands: GramBands):
    """Pick n mutually-orthogonal columns across bands, by singular value.

    In-band columns rank by their s; masked-out columns get key -1, so
    the stable top-n selection takes each level's converged columns plus
    the head of the last level.  Rank-capped bands (levels * k < n) are
    completed with zero columns of key -1 (value exactly 0, below anything
    a caller keeps).  Returns (q (..., n, n) columns descending by s,
    s (..., n)).
    """
    levels = bands.q.shape[0]
    n, k = bands.q.shape[-2], bands.q.shape[-1]
    is_last = torch.zeros(levels, dtype=torch.bool, device=bands.s.device)
    is_last[-1] = True
    is_last = is_last.reshape((levels,) + (1,) * (bands.s.dim() - 1))
    keys = torch.where(is_last | (bands.s > 0), bands.s, -1.0)
    # (levels, ..., n, k) -> (..., n, levels*k), level-major columns
    qcat = torch.cat(list(bands.q), dim=-1)
    keys = torch.cat(list(keys), dim=-1)
    if levels * k < n:
        pad = n - levels * k
        qcat = torch.nn.functional.pad(qcat, (0, pad))
        keys = torch.nn.functional.pad(keys, (0, pad), value=-1.0)
    order = torch.argsort(-keys, dim=-1, stable=True)[..., :n]
    q = torch.take_along_dim(qcat, order[..., None, :], dim=-1)
    s = torch.clamp(torch.take_along_dim(keys, order, dim=-1), min=0.0)
    return q, s


# ------------------------------------------------------------------
# Whitening operators of the gram engine
# ------------------------------------------------------------------


def whiten_apply_idpluslr(bands: GramBands, y: torch.Tensor) -> torch.Tensor:
    """Apply W = (I + A A^H)^(-1/2) to y (..., n, c), A given by its Gram
    bands: W = I - sum_i Q_i diag(alpha_i) Q_i^H with alpha = 1 -
    1/sqrt(1 + s^2).  alpha -> 0 as s -> 0, so unconverged or duplicate
    tail columns do no harm; the bands are mutually orthogonal."""
    alpha = 1.0 - 1.0 / torch.sqrt(1.0 + bands.s * bands.s)  # (levels, ..., k)
    proj = bands.q.conj().transpose(-1, -2) @ y  # (levels, ..., k, c)
    proj = proj * alpha[..., None].to(proj.dtype)
    return y - (bands.q @ proj).sum(0)


def whiten_apply_floor(bands: GramBands, y: torch.Tensor, floor_rel: float) -> torch.Tensor:
    """Apply W = (A A^H)^(-1/2) to y with a relative eigenvalue floor: the
    eigenvalues of A A^H below ``floor_rel * lambda_max`` are clamped (not
    shifted) before the inversion, i.e. the singular values below
    f = sqrt(floor_rel) * s_max.  Foreground-only whitening (DoubleKL stage
    1 of the gram engine).

    W = I / f + sum_i q_i (1 / s_i - 1 / f) q_i^H over the band columns
    with s_i > f: only the directions above the floor need a vector, and
    those of the bands are mutually orthogonal.  The JAX package forms
    Q diag(1 / max(s, f)) Q^H from a complete basis (``_select_complete_basis``)
    whose zero-value columns come from the last level's null space, an
    arbitrary basis that holds the earlier levels' directions too where A
    is rank deficient (a cylinder's foreground factor is: 18 of 56 singular
    values above 1e-12 of the top); those columns then add 1/f weight to
    directions already whitened, and the spectrum departs from the dense
    referee (0.77 of the top at a small cylinder's m = 9, its eigh's jitter
    picking the basis).  Where that basis is orthonormal both forms are
    equal.
    """
    f = float(np.sqrt(floor_rel)) * bands.s[0].amax(-1) + 1e-30  # (...,)
    f = f[None, ..., None]
    beta = torch.where(bands.s > f, 1.0 / torch.clamp(bands.s, min=1e-300) - 1.0 / f, 0.0)
    proj = bands.q.conj().transpose(-1, -2) @ y  # (levels, ..., k, c)
    proj = proj * beta[..., None].to(proj.dtype)
    return y / f[0, ..., None].to(y.dtype) + (bands.q @ proj).sum(0)


# ------------------------------------------------------------------
# Tall R factorisation: shifted CholeskyQR
# ------------------------------------------------------------------

# Relative shift per round, in units of the current lambda_max estimate.
_CHOLQR_SHIFT_EPS_MULT = 3000.0


# The module levers of the noise whitening, read once from the JAX
# package's environment variable names; tests and decision records
# (engine_picks) set the attributes.
#
# _CHOLQR_ROUNDS: the shifted CholeskyQR's round count (None: the
# conditioning worst case of :func:`_cholqr_rounds`).
_CHOLQR_ROUNDS = (
    int(os.environ["DRIFTSCAN_TPU_CHOLQR_ROUNDS"])
    if os.environ.get("DRIFTSCAN_TPU_CHOLQR_ROUNDS")
    else None
)

# _QR_IMPL: the factorisation of the noise rows.  "cholqr_split" and
# "cholqr" (the JAX package's split-complex and interleaved CholeskyQR,
# equal in exact arithmetic) both select :func:`chol_qr_r`, the one
# CholeskyQR of native complex; "householder" a Householder QR
# (``torch.linalg.qr``) with each row of R scaled to a positive real
# diagonal, so that R is CholeskyQR's.
_QR_IMPL = os.environ.get("DRIFTSCAN_TPU_QR_IMPL", "cholqr_split")
_QR_IMPLS = ("cholqr_split", "cholqr", "householder")

# _WHITEN_IMPL: how R^-H b and R^-1 b are applied.  "solve": triangular
# solves against the whole R (which carries cond(N)^(1/2) and is never
# inverted as a whole); "factored": the chain of the per-round inverses
# R_1^-1 .. R_K^-1, each shift-capped at cond ~ sqrt(1/shift_rel), one
# (n, n) product a round; "refined": the chain composed into one matrix
# plus _WHITEN_REFINE_STEPS residual corrections against R.  Under
# "householder" there are no rounds, and both fall back to "solve".
_WHITEN_IMPL = os.environ.get("DRIFTSCAN_TPU_WHITEN_IMPL", "solve")
_WHITEN_IMPLS = ("solve", "factored", "refined")
_WHITEN_REFINE_STEPS = int(os.environ.get("DRIFTSCAN_TPU_WHITEN_REFINE", "2"))


def _cholqr_rounds(dtype) -> int:
    """Shifted-round count covering any representable pencil conditioning
    (cond(N) ~ 1e18): 8 for float32, 4 for float64, unless
    ``_CHOLQR_ROUNDS`` sets it."""
    if _CHOLQR_ROUNDS:
        return _CHOLQR_ROUNDS
    return 8 if torch.finfo(backend.real_dtype(dtype)).eps > 1e-10 else 4


def chol_qr_r(rows: torch.Tensor, return_inv: bool = False):
    """Upper-triangular R with N = R^H R for the noise rows G (..., R, n).

    Shifted CholeskyQR: per round one Gram, one shifted Cholesky, one
    explicit small triangular inverse and one tall update; ``rounds - 2``
    fully shifted rounds (each cuts cond^2 by ~1/shift_rel), one
    small-shift round, then one unshifted polish.  The diagonal is
    positive.  ``return_inv`` also returns the per-round inverses
    [R_1^-1 .. R_K^-1] (R = R_K .. R_1), the last one included.
    """
    n = rows.shape[-1]
    eps = float(torch.finfo(backend.real_dtype(rows.dtype)).eps)
    rounds = _cholqr_rounds(rows.dtype)
    shift_rel = _CHOLQR_SHIFT_EPS_MULT * eps
    small_rel = 10.0 * (2 * n) * eps
    eye = torch.eye(n, dtype=rows.dtype, device=rows.device)

    g = rows
    r_tot = None
    invs = []
    for k in range(rounds):
        gram = _herm(g.conj().transpose(-1, -2) @ g)
        if k < rounds - 2:
            rel = shift_rel
        elif k == rounds - 2:
            rel = small_rel
        else:
            rel = 0.0
        if rel:
            # inf-norm upper bound on lambda_max (|z| <= |re| + |im|)
            lam = (gram.real.abs() + gram.imag.abs()).sum(-1).amax(-1)
            gram = gram + (rel * lam + 1e-30)[..., None, None] * eye
        low, _ = torch.linalg.cholesky_ex(gram)
        r_k = low.conj().transpose(-1, -2)
        r_tot = r_k if r_tot is None else r_k @ r_tot
        if k < rounds - 1 or return_inv:
            rinv = torch.linalg.solve_triangular(r_k, eye.expand_as(r_k), upper=True)
            invs.append(rinv)
            if k < rounds - 1:
                g = g @ rinv
    if return_inv:
        return r_tot, invs
    return r_tot


def _check_levers():
    if _QR_IMPL not in _QR_IMPLS:
        raise ValueError(f"unknown _QR_IMPL {_QR_IMPL!r}: one of {_QR_IMPLS}")
    if _WHITEN_IMPL not in _WHITEN_IMPLS:
        raise ValueError(f"unknown _WHITEN_IMPL {_WHITEN_IMPL!r}: one of {_WHITEN_IMPLS}")


def _noise_r_factor(noise_rows: torch.Tensor) -> torch.Tensor:
    """Upper-triangular R with N = R^H R from the noise rows G, by the
    ``_QR_IMPL`` lever."""
    if _QR_IMPL != "householder":
        return chol_qr_r(noise_rows)
    r = torch.linalg.qr(noise_rows, mode="r")[1]
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    mag = d.abs()
    # row i times conj(d_i) / |d_i|: a real positive diagonal, R^H R kept
    phase = torch.where(mag > 0, d.conj() / torch.where(mag > 0, mag, 1.0), 1.0)
    return r * phase[..., :, None]


def _whiten_factored() -> bool:
    return _WHITEN_IMPL in ("factored", "refined") and _QR_IMPL != "householder"


def _whiten_apply_factors(invs, b: torch.Tensor, adjoint: bool) -> torch.Tensor:
    """R^-H b (adjoint) or R^-1 b through the per-round inverses: R = R_K
    .. R_1, so R^-1 = R_1^-1 .. R_K^-1 (applied right to left) and R^-H =
    R_K^-H .. R_1^-H (their adjoints, left to right)."""
    if adjoint:
        for inv in invs:
            b = inv.conj().transpose(-1, -2) @ b
    else:
        for inv in reversed(invs):
            b = inv @ b
    return b


def _compose_factor_inv(invs) -> torch.Tensor:
    """R^-1 = R_1^-1 .. R_K^-1 composed into one (n, n) matrix."""
    m = invs[0]
    for inv in invs[1:]:
        m = m @ inv
    return m


def _whiten_apply_refined(r: torch.Tensor, m_inv: torch.Tensor, b: torch.Tensor,
                          adjoint: bool) -> torch.Tensor:
    """The composed inverse applied to b, then ``_WHITEN_REFINE_STEPS``
    residual corrections against R itself (R^H y = b, resp. R v = b), so
    that the result converges to the same solution as the "solve" path."""
    m = m_inv.conj().transpose(-1, -2) if adjoint else m_inv
    mat = r.conj().transpose(-1, -2) if adjoint else r
    y = m @ b
    for _ in range(_WHITEN_REFINE_STEPS):
        y = y + m @ (b - mat @ y)
    return y


def _make_whitener(noise_rows: torch.Tensor):
    """``whiten(b, adjoint)`` computing R^-H b (adjoint) or R^-1 b for the
    active ``_QR_IMPL`` and ``_WHITEN_IMPL`` levers (see their comments)."""
    _check_levers()
    if _whiten_factored():
        r, invs = chol_qr_r(noise_rows, return_inv=True)
        if _WHITEN_IMPL == "refined":
            m_inv = _compose_factor_inv(invs)
            return lambda b, adj: _whiten_apply_refined(r, m_inv, b, adj)
        return lambda b, adj: _whiten_apply_factors(invs, b, adj)
    r = _noise_r_factor(noise_rows)

    def whiten(b, adj):
        if adj:
            return torch.linalg.solve_triangular(r.conj().transpose(-1, -2), b, upper=False)
        return torch.linalg.solve_triangular(r, b, upper=True)

    return whiten


# ------------------------------------------------------------------
# The pencil
# ------------------------------------------------------------------


class KLResult(NamedTuple):
    evals: torch.Tensor  # (..., n) ascending
    evecs: torch.Tensor  # (..., n, n) columns, N-orthonormal


def pencil_solve_qr(
    a_signal: torch.Tensor,
    noise_rows: torch.Tensor,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    sig_k_cap: int = 0,
) -> KLResult:
    """Solve S v = w N v with S = A_s A_s^H and N = G^H G given by rows G.

    The eigenvalues are the squared singular values of y = R^-H A_s,
    resolved by ``sig_levels`` Gram deflation levels (rank-capped at
    ``sig_k_cap`` directions a level when set: :func:`gram_bands_topk`,
    whose unresolved tail reports eigenvalue 0 with zero vectors); the
    eigenvectors are R^-1 U.  The whitening follows the module levers
    (:func:`_make_whitener`).  Returns evals ascending and N-orthonormal
    columns.
    """
    whiten = _make_whitener(noise_rows)
    y = whiten(a_signal, True)  # R^-H A_s
    if sig_k_cap:
        bands = gram_bands_topk(y, levels=sig_levels, band_rel=band_rel, k_cap=sig_k_cap)
    else:
        bands = gram_bands(y, levels=sig_levels, band_rel=band_rel)
    u, sy = _select_complete_basis(bands)
    evals = sy * sy  # descending
    v = whiten(u, False)  # R^-1 U
    return KLResult(evals.flip(-1), v.flip(-1))


def _thermal_noise_rows(a_fg: torch.Tensor, nc) -> torch.Tensor:
    """Noise factor rows [A_f^H; sqrt(nc) I] for N = nc*I + A_f A_f^H;
    ``nc`` a float or a tensor over the batch axes."""
    n = a_fg.shape[-2]
    eye = torch.eye(n, dtype=a_fg.dtype, device=a_fg.device)
    afh = a_fg.conj().transpose(-1, -2)
    if isinstance(nc, torch.Tensor):
        eye = torch.sqrt(nc)[..., None, None].to(a_fg.dtype) * eye
    else:
        eye = (nc**0.5) * eye
    return torch.cat([afh, eye.expand(afh.shape[:-2] + (n, n))], dim=-2)


_START_BLOCKS: dict = {}


def _start_block(n: int, k: int, like: torch.Tensor) -> torch.Tensor:
    """The fixed real orthonormal start block (n, k) of the power and
    subspace iterations: the Q of numpy's ``default_rng(97531)`` normal
    (n, k) draw, as the JAX package's ``_random_real_basis`` makes it,
    cached per (n, k).  A k-column block is its own draw, not the first k
    columns of a wider one; k = 1 is the power iteration's start vector."""
    if (n, k) not in _START_BLOCKS:
        q, _ = np.linalg.qr(np.random.default_rng(97531).standard_normal((n, k)))
        _START_BLOCKS[n, k] = np.ascontiguousarray(q)
    return torch.as_tensor(_START_BLOCKS[n, k], device=like.device).to(like.dtype)


def _spectral_norm_sq(a: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """lambda_max(A A^H) by power iteration from a fixed start, batched
    over leading axes: (...,) real."""
    v = _start_block(a.shape[-2], 1, a).expand(a.shape[:-2] + (a.shape[-2], 1))
    lam = None
    for _ in range(iters):
        v = a @ (a.conj().transpose(-1, -2) @ v)
        lam = torch.linalg.vector_norm(v, dim=(-2, -1))
        v = v / (lam + 1e-30)[..., None, None].to(v.dtype)
    return lam


def _max_row_norm_sq(a_fg: torch.Tensor) -> torch.Tensor:
    """The largest diagonal entry of F = A_f A_f^H (for PSD F its largest
    entry), per batch item."""
    return (a_fg.real**2 + a_fg.imag**2).sum(-1).amax(-1)


def kl_solve_qr(
    a_signal: torch.Tensor,
    a_fg: torch.Tensor,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    with_thermal: bool = True,
    fg_floor: float = 1e-6,
    fg_reg_rel: float = 0.0,
    sig_k_cap: int = 0,
) -> KLResult:
    """Solve S v = w (nc I + F) v by factor-side QR whitening.

    With thermal noise nc = 1 (the beams are noise-prewhitened); without
    (DoubleKL stage 1), nc = ``fg_floor`` * lambda_max(F).  ``fg_reg_rel``
    adds driftscan's foreground regulariser, fg_reg_rel * max|F_ij|, an
    identity shift that folds into the noise scale.  ``sig_k_cap`` as in
    :func:`pencil_solve_qr`.  The defaults give the plain thermal pencil
    S v = w (I + F) v.
    """
    if with_thermal:
        nc = 1.0
    else:
        nc = fg_floor * _spectral_norm_sq(a_fg) + 1e-30
    if fg_reg_rel:
        nc = nc + fg_reg_rel * _max_row_norm_sq(a_fg)
    return pencil_solve_qr(
        a_signal, _thermal_noise_rows(a_fg, nc), sig_levels=sig_levels,
        band_rel=band_rel, sig_k_cap=sig_k_cap,
    )


def kl_solve(
    a_signal: torch.Tensor,
    a_fg: torch.Tensor,
    sig_levels: int | None = None,
    band_rel: float | None = None,
    method: str = "qr",
    with_thermal: bool = True,
    fg_floor: float = 1e-6,
    fg_reg_rel: float = 0.0,
    fg_levels: int = 8,
    solve_dtype=None,
    fg_k_cap: int = 0,
    sig_k_cap: int = 0,
) -> KLResult:
    """Solve S v = w N v with S = A_s A_s^H and N = [I +] A_f A_f^H.

    ``method="qr"`` (the default) whitens by factor-side QR
    (:func:`kl_solve_qr`).  ``method="gram"`` is the JAX package's
    multi-level Gram-deflation engine, kept for A/B and for covariances
    too wide even for QR: ``fg_levels`` levels of the foreground factor's
    Gram (rank-capped at ``fg_k_cap`` directions a level when set),
    whitening by (I + F)^-1/2 (:func:`whiten_apply_idpluslr`) or, without
    thermal noise, by F^-1/2 with F's eigenvalues clamped at ``fg_floor``
    of its largest (:func:`whiten_apply_floor`), then ``sig_levels`` levels
    of the whitened signal.  Its foreground whitening error grows with
    cond(N).  ``fg_reg_rel`` is driftscan's foreground regulariser
    fg_reg_rel * max|F_ij| on the noise diagonal (for ``gram`` by scaling
    both factors by (1 + r)^-1/2, the same eigenvalues).

    The depth defaults depend on the method, as in the JAX package: 2
    signal levels at band_rel 3e-2 for ``qr``, 5 at 1e-1 for ``gram``.
    ``solve_dtype`` (a real torch dtype) runs the solve in that precision
    (``qr`` returns in it, ``gram`` in the inputs' precision).  Returns evals ascending and
    evecs as columns.
    """
    if sig_levels is None:
        sig_levels = 2 if method == "qr" else 5
    if band_rel is None:
        band_rel = 3e-2 if method == "qr" else 1e-1

    if method == "qr":
        if fg_k_cap:
            raise ValueError(
                "fg_k_cap is a gram-engine knob (method='gram'): QR whitening has no "
                "foreground Gram to rank-cap"
            )
        if solve_dtype is not None:
            cdt = backend.complex_dtype(solve_dtype)
            a_signal, a_fg = a_signal.to(cdt), a_fg.to(cdt)
        return kl_solve_qr(
            a_signal, a_fg, sig_levels=sig_levels, band_rel=band_rel,
            with_thermal=with_thermal, fg_floor=fg_floor, fg_reg_rel=fg_reg_rel,
            sig_k_cap=sig_k_cap,
        )
    if method != "gram":
        raise ValueError(f"Unknown kl_solve method {method!r}")

    if fg_reg_rel:
        # N = (1 + r) I + F = (1 + r) (I + F / (1 + r))
        r = fg_reg_rel * _max_row_norm_sq(a_fg)
        sc = (1.0 / torch.sqrt(1.0 + r))[..., None, None].to(a_signal.dtype)
        a_signal, a_fg = a_signal * sc, a_fg * sc

    in_dtype = a_signal.dtype
    if solve_dtype is not None:
        cdt = backend.complex_dtype(solve_dtype)
        a_signal, a_fg = a_signal.to(cdt), a_fg.to(cdt)

    # the identity-plus-low-rank whitening tolerates missing tail
    # directions (alpha -> 0); the floor whitening needs a complete basis
    if fg_k_cap and not with_thermal:
        raise ValueError(
            "fg_k_cap requires with_thermal=True: foreground-floor whitening needs a "
            "complete basis"
        )
    if fg_k_cap:
        fg = gram_bands_topk(a_fg, levels=fg_levels, band_rel=band_rel, k_cap=fg_k_cap)
    else:
        fg = gram_bands(a_fg, levels=fg_levels, band_rel=band_rel)

    def whiten(b):
        if with_thermal:
            return whiten_apply_idpluslr(fg, b)
        return whiten_apply_floor(fg, b, floor_rel=fg_floor)

    y = whiten(a_signal)
    if sig_k_cap:
        yb = gram_bands_topk(y, levels=sig_levels, band_rel=band_rel, k_cap=sig_k_cap)
    else:
        yb = gram_bands(y, levels=sig_levels, band_rel=band_rel)
    u, sy = _select_complete_basis(yb)
    evals = sy * sy  # descending
    v = whiten(u)
    return KLResult(
        evals.flip(-1).to(backend.real_dtype(in_dtype)), v.flip(-1).to(in_dtype)
    )


# ------------------------------------------------------------------
# The two-stage (DoubleKL) pencil
# ------------------------------------------------------------------


def _doublekl_stage1_floor(a_fg, nc1, fg_floor, fg_reg_rel):
    """Stage-1 identity floor: the suppressed radiometer noise ``nc1``
    where the caller knows it (else a relative foreground floor), plus
    the relative foreground regulariser fg_reg_rel * max|F_ij|."""
    if nc1 is None:
        nc1 = fg_floor * _spectral_norm_sq(a_fg) + 1e-30
    return nc1 + fg_reg_rel * _max_row_norm_sq(a_fg)


def _doublekl_stage2_rows(a_signal, a_fg, p):
    """Stage-2 pencil factors on the kept subspace: (p^H A_s, noise rows
    [A_f^H p; p; delta I]).  The kept-mode diagonal of N' is >= 1 (stage-1
    noise normalisation), so delta = 1e-4 keeps dropped columns
    nonsingular at ~1e-8 relative effect on genuine eigenvalues."""
    n = p.shape[-1]
    ph = p.conj().transpose(-1, -2)
    bs = ph @ a_signal
    fp = a_fg.conj().transpose(-1, -2) @ p  # (K, n)
    delta = 1e-4 * torch.eye(n, dtype=p.dtype, device=p.device)
    return bs, torch.cat([fp, p, delta.expand(p.shape[:-2] + (n, n))], dim=-2)


def doublekl_solve_qr(
    a_signal: torch.Tensor,
    a_fg: torch.Tensor,
    fg_threshold: float = 100.0,
    fg_floor: float = 1e-6,
    nc1: float | None = None,
    fg_reg_rel: float = 1e-14,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
):
    """Two-stage (DoubleKL) pencil on factors, batched over leading axes.

    Stage 1 solves S v = w (F + nc1 I) v (thermal noise suppressed to
    ``nc1``, or a relative floor when nc1 is None); modes with w <=
    ``fg_threshold`` are mask-dropped (columns zeroed, shapes kept).
    Stage 2 solves the thermal pencil on the kept subspace: signal factor
    p^H A_s, noise rows [A_f^H p; p; delta I]; dropped columns emerge
    with eigenvalue 0 and zero vectors, below any genuine mode.

    Returns (f_evals (..., n) ascending stage-1 spectrum, evals (..., n)
    ascending stage-2 spectrum with dropped modes 0, evecs (..., n, n)
    final mode columns in the original basis, nkept (...,) int32).
    """
    floor = _doublekl_stage1_floor(a_fg, nc1, fg_floor, fg_reg_rel)
    kl1 = pencil_solve_qr(
        a_signal, _thermal_noise_rows(a_fg, floor), sig_levels=sig_levels,
        band_rel=band_rel,
    )
    f_evals = kl1.evals
    keep = f_evals > fg_threshold
    p = kl1.evecs * keep[..., None, :].to(kl1.evecs.dtype)

    bs, gr = _doublekl_stage2_rows(a_signal, a_fg, p)
    kl2 = pencil_solve_qr(bs, gr, sig_levels=sig_levels, band_rel=band_rel)

    v = p @ kl2.evecs
    vnorm = (v.real**2 + v.imag**2).sum(-2)
    evals2 = kl2.evals * (vnorm > 1e-12).to(kl2.evals.dtype)
    return f_evals, evals2, v, keep.sum(-1).to(torch.int32)


# ------------------------------------------------------------------
# The top-band engine: Chebyshev-filtered subspace iteration
# ------------------------------------------------------------------
#
# The KL transform keeps only the eigenvalues of H = Y Y^H above an
# absolute cut (the S/N threshold).  This engine computes just those: a
# Chebyshev filter suppressing [0, b] (b below the level's lock bound)
# drives a k-column subspace iteration, a float64 Rayleigh-Ritz against
# the explicit basis metric recovers the eigenpairs, and deflation
# levels (each about two decades) walk down from lambda_max to the cut.
# No full eigendecomposition of H is formed: one (k, k) eigh a level.


def _chol_qr_block(v: torch.Tensor) -> torch.Tensor:
    """Orthonormalise a complex column block (..., n, k) by two rounds of
    shifted CholeskyQR: per round the Hermitised Gram, shifted by 1e-5 of its
    largest diagonal entry plus 1e-30, its Cholesky factor and the
    explicit triangular inverse.  The shifted rounds leave ~1e-5
    non-orthonormality but keep the span (column operations only); the
    Rayleigh-Ritz step uses the explicit metric V^H V."""
    k = v.shape[-1]
    eye = torch.eye(k, dtype=v.dtype, device=v.device)
    for _ in range(2):
        g = _herm(v.conj().transpose(-1, -2) @ v)
        shift = 1e-5 * torch.diagonal(g, dim1=-2, dim2=-1).real.amax(-1) + 1e-30
        low, _ = torch.linalg.cholesky_ex(g + shift[..., None, None].to(g.dtype) * eye)
        rinv = torch.linalg.solve_triangular(
            low.conj().transpose(-1, -2), eye.expand_as(low), upper=True
        )
        v = v @ rinv
    return v


def _cheb_apply(y: torch.Tensor, v: torch.Tensor, b: torch.Tensor, degree: int):
    """Apply the Chebyshev filter T_degree(t(H)) to the block v (..., n, k).

    H = Y Y^H is never formed: t(lam) = 2 lam / b - 1 maps the suppressed
    interval [0, b] onto [-1, 1] (b (...,) a batch element), and each
    application of t(H) is the product W = Y^H V and one launch of K17
    (:func:`cheb.cheb_step`), which forms Y W and the recurrence around it.
    Each recurrence step rescales both iterates by the running max of the
    new one: only the direction of the filtered block matters.
    """
    y = y.resolve_conj().contiguous()
    yh = y.conj().transpose(-1, -2)
    inv_b = 2.0 / b
    v = v.contiguous()
    vp = v
    vk, _ = cheb.cheb_step(y, (yh @ v).contiguous(), v, None, inv_b, -1.0, 0.0)
    for _ in range(degree - 1):
        vn, amax = cheb.cheb_step(y, (yh @ vk).contiguous(), vk, vp, 2.0 * inv_b, -2.0, -1.0)
        s = (1.0 / (amax + 1e-30))[..., None, None].to(vn.dtype)
        vp, vk = vk * s, vn * s
    return vk


def _whiten_eigh(h: torch.Tensor, met: torch.Tensor):
    """Generalised Hermitian h u = w met u through the eigendecomposition
    of the metric (the JAX package's ``whiten_eigh``): met's eigenvalues
    floored at eps of its largest, W = Q d^-1/2, then eigh of W^H h W.
    Returns (w ascending, u = W U)."""
    d, q = _eigh_scaled(met)
    eps = torch.finfo(d.dtype).eps
    dclamp = torch.maximum(d, eps * d[..., -1:] + 1e-30)
    wmat = q * (1.0 / torch.sqrt(dclamp))[..., None, :].to(q.dtype)
    c = _herm(wmat.conj().transpose(-1, -2) @ (h @ wmat))
    w, u = _eigh_scaled(c)
    return w, wmat @ u


def _spectral_norm_sq_block(a: torch.Tensor) -> torch.Tensor:
    """lambda_max(A A^H) by block subspace iteration and a Rayleigh-Ritz,
    batched over leading axes: (...,) real.

    Sharper from below than :func:`_spectral_norm_sq` where a dense shelf
    of slightly smaller eigenvalues dilutes a single power vector's
    Rayleigh quotient: the q-column block (q = ``_CERT_Q``) takes the shelf
    into its lower Ritz directions, and the top Ritz value converges at
    (lambda_{q+1}/lambda_1)^(2 ``_CERT_ITERS``).  The top-band certificate's
    norm.
    """
    n = a.shape[-2]
    q = min(_CERT_Q, n)
    ah = a.conj().transpose(-1, -2)
    v = _start_block(n, q, a).expand(a.shape[:-2] + (n, q))
    for _ in range(_CERT_ITERS):
        v = _chol_qr_block(a @ (ah @ v))
    b = ah @ v
    w, _ = _eigh_scaled(_herm(b.conj().transpose(-1, -2) @ b))
    return w[..., -1]


# The level schedule of :func:`gram_topband`, the JAX package's defaults:
# each level locks down to _LOCK_REL of its top, under a Chebyshev filter
# of degree _DEGREE suppressing [0, lock / _GAP_REL], in _ITERS filter and
# CholeskyQR rounds.  The certificate's block power iteration runs
# _CERT_ITERS rounds on a _CERT_Q-column block.
_LOCK_REL = 1e-2
_GAP_REL = 4.0
_DEGREE = 2
_ITERS = 4
_CERT_Q = 16
_CERT_ITERS = 32


def gram_topband(y: torch.Tensor, k: int, cut: float, levels: int = 5):
    """All eigenpairs of H = Y Y^H with eigenvalue >= ``cut`` (absolute).

    y (..., n, K).  Level ell locks the eigenvalues in [max(_LOCK_REL
    lam_ell, cut), lam_ell] (lam_1 by power iteration, then the previous
    lock bound), found by _ITERS rounds of a degree-_DEGREE Chebyshev
    filter suppressing [0, lock / _GAP_REL] and a shifted CholeskyQR, from
    the fixed start block; the Rayleigh-Ritz runs against the explicit
    metric V^H V; pairs at or above the lock are kept and deflated out of
    Y twice (CGS2), the rest surfaces at the next level.

    The certificate: after the last level, lambda_max of the remainder
    (:func:`_spectral_norm_sq_block`) must lie below the cut.  It
    catches a band overflowing the k-column basis, an unconverged filter
    and too few levels for the spectrum's range.

    One step goes beyond the JAX program, which locks every Ritz pair at
    or above the lock bound: a pair is locked only when its residual is
    within ``_RITZ_RES_REL`` of its value.  Where a level's band and the
    eigenvalues just under it hold more directions than the basis, the
    pairs at the bottom of the block have not converged; locked, they mix
    two eigenvectors, the rest of the pair is locked later, and both
    values are off (4.8e-2 rel in float64 at a basis of n/7, every
    certificate passing).  Left in Y, such a pair is found at a later level
    or fails the certificate.  Where every locked pair has converged the
    two programs agree to rounding.

    Returns (theta (..., levels k) descending within each level, zero
    below the cut; u (..., n, levels k) orthonormal columns, zero below the
    cut; ok (...,) bool, True where every eigenvalue >= cut was captured).
    """
    cut = float(cut)
    if cut <= 0.0:
        # the certificate compares a PSD norm with the cut: with cut <= 0
        # it cannot hold, and a dispatcher would escalate to no end
        raise ValueError(
            f"topband engine requires a positive cut (got {cut}); use the exact engine instead"
        )
    n = y.shape[-2]
    lam = _spectral_norm_sq(y)
    v0 = _start_block(n, k, y).expand(y.shape[:-2] + (n, k))

    thetas, us = [], []
    for _ in range(levels):
        lock = torch.clamp(_LOCK_REL * lam, min=cut)
        b = torch.clamp(lock / _GAP_REL, min=1e-30)
        v = v0
        for _ in range(_ITERS):
            v = _chol_qr_block(_cheb_apply(y, v, b, _DEGREE))
        bd = y.conj().transpose(-1, -2) @ v  # (K, k)
        h = _herm(bd.conj().transpose(-1, -2) @ bd)  # V^H H V
        met = _herm(v.conj().transpose(-1, -2) @ v)  # V^H V
        theta, u = _whiten_eigh(h, met)
        theta, u = theta.flip(-1), u.flip(-1)
        uu = v @ u
        # lock only the converged pairs, at or above the lock bound with a
        # residual |Y (Y^H uu) - theta uu| within _RITZ_RES_REL of theta;
        # the rest stays in Y
        res = torch.linalg.vector_norm(
            y @ (bd @ u) - uu * theta[..., None, :].to(uu.dtype), dim=-2
        )
        keep = ((theta >= lock[..., None]) & (res <= _RITZ_RES_REL * theta)).to(theta.dtype)
        theta = theta * keep
        uu = uu * keep[..., None, :].to(uu.dtype)
        thetas.append(theta)
        us.append(uu)
        for _ in range(2):
            proj = uu.conj().transpose(-1, -2) @ y
            y = y - uu @ proj
        lam = lock

    ok = _spectral_norm_sq_block(y) < cut
    theta = torch.cat(thetas, dim=-1)
    u = torch.cat(us, dim=-1)
    mask = (theta >= cut).to(theta.dtype)
    return theta * mask, u * mask[..., None, :].to(u.dtype), ok


# Largest relative residual |H u - theta u| / theta of a Ritz pair that a
# level locks.  A residual r bounds the value's error by r (and by
# r^2 / gap away from other eigenvalues); a pair above it stays in Y and
# is found at a later level, where it sits at the band's top.  Measured on
# a small cylinder (pencil n 56, cut 1e-3, float64, bases of n/7):
# locking every pair above the lock bound (the JAX program) put values
# 4.8e-2 off the exact engine's, every certificate passing; with this
# test they lie within 3e-10 (1e-4 gave 2e-8, 1e-3 gave 6e-6).
_RITZ_RES_REL = 1e-5


def pencil_solve_qr_topband(
    a_signal: torch.Tensor,
    noise_rows: torch.Tensor,
    cut: float,
    k: int,
    levels: int = 5,
):
    """The retained band of S v = w N v: :func:`pencil_solve_qr`'s noise
    whitening (the module levers, :func:`_make_whitener`), with the whitened Gram's eigendecomposition replaced by
    :func:`gram_topband`.  Eigenvalues below ``cut`` are exact zeros with
    zero eigenvector columns.  Returns (KLResult (evals (..., n)
    ascending, evecs (..., n, n)), ok (...,))."""
    n = a_signal.shape[-2]
    w = min(levels * k, n)
    whiten = _make_whitener(noise_rows)
    y = whiten(a_signal, True)  # R^-H A_s
    theta, u, ok = gram_topband(y, k=k, cut=cut, levels=levels)
    # top w by value (the masked zeros make value order the keep set)
    order = torch.argsort(-theta, dim=-1, stable=True)[..., :w]
    theta = torch.take_along_dim(theta, order, dim=-1)
    u = torch.take_along_dim(u, order[..., None, :], dim=-1)
    v = whiten(u, False)  # R^-1 U
    lead = a_signal.shape[:-2]
    pad = n - w
    evals = torch.cat([theta.new_zeros(lead + (pad,)), theta.flip(-1)], dim=-1)
    vfull = torch.cat([v.new_zeros(lead + (n, pad)), v.flip(-1)], dim=-1)
    return KLResult(evals, vfull), ok


def kl_solve_qr_topband(
    a_signal: torch.Tensor,
    a_fg: torch.Tensor,
    cut: float,
    k: int,
    levels: int = 5,
    fg_reg_rel: float = 0.0,
):
    """The retained band of the thermal pencil S v = w (I + F) v (see
    :func:`kl_solve_qr`; ``fg_reg_rel`` is the same identity shift).
    Returns (KLResult, ok)."""
    nc = 1.0
    if fg_reg_rel:
        nc = nc + fg_reg_rel * _max_row_norm_sq(a_fg)
    return pencil_solve_qr_topband(
        a_signal, _thermal_noise_rows(a_fg, nc), cut=cut, k=k, levels=levels
    )


def doublekl_solve_qr_topband(
    a_signal: torch.Tensor,
    a_fg: torch.Tensor,
    cut: float,
    k: int,
    fg_threshold: float = 100.0,
    fg_floor: float = 1e-6,
    nc1: float | None = None,
    fg_reg_rel: float = 1e-14,
    levels: int = 5,
):
    """The two-stage pencil of :func:`doublekl_solve_qr` through the
    top-band engine: stage 1 computes only the modes it keeps (S/F above
    ``fg_threshold``), stage 2 those above ``cut``; everything below either
    cut is exact zeros.  Returns (f_evals, evals, evecs, nkept, ok), the
    first four as :func:`doublekl_solve_qr`, ``ok`` both stages'
    certificates."""
    floor = _doublekl_stage1_floor(a_fg, nc1, fg_floor, fg_reg_rel)
    kl1, ok1 = pencil_solve_qr_topband(
        a_signal, _thermal_noise_rows(a_fg, floor), cut=fg_threshold, k=k, levels=levels
    )
    f_evals = kl1.evals
    keep = f_evals > fg_threshold
    p = kl1.evecs * keep[..., None, :].to(kl1.evecs.dtype)

    bs, gr = _doublekl_stage2_rows(a_signal, a_fg, p)
    kl2, ok2 = pencil_solve_qr_topband(bs, gr, cut=cut, k=k, levels=levels)

    v = p @ kl2.evecs
    vnorm = (v.real**2 + v.imag**2).sum(-2)
    evals2 = kl2.evals * (vnorm > 1e-12).to(kl2.evals.dtype)
    return f_evals, evals2, v, keep.sum(-1).to(torch.int32), ok1 & ok2
