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
  the thermal pencil on the modes that stage keeps.

Every function is batched over leading axes: a Python loop or a batch
dimension takes the place of the JAX package's ``vmap``/``scan``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import backend

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
    backend.check(
        fn(
            bsvd.data_ptr(), L.data_ptr(), out.data_ptr(), part_ptr, part_bytes,
            M, F, S, npol, nl, K, nsplit, cps, backend.stream_ptr(bsvd.device),
        ),
        K9.name,
    )
    K9.launches += 1
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


def _eigh_scaled(g: torch.Tensor):
    """torch.linalg.eigh of g scaled by the power of two nearest max|g|.

    cuSOLVER's Hermitian eigensolver fails to converge on finite Grams
    of small scale (measured on an H100: complex64 at max|g| ~ 1e-7, the
    bench telescope's m >= 200), while the same matrices scaled to ~1
    converge.  A power-of-two scale is exact, so the eigenvalues and
    vectors are those of g itself.  A Gram below tiny/eps (a zero-padded
    m slot, or subnormal roundoff) is zero to working precision: it gets
    eigenvalues 0 and the identity basis, without a solver call that
    subnormal entries can break.
    """
    fin = torch.finfo(g.real.dtype)
    amax = g.abs().amax(dim=(-2, -1))
    zero = amax <= fin.tiny / fin.eps
    scale = torch.where(
        zero, torch.ones_like(amax), torch.exp2(torch.round(torch.log2(amax)))
    )
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    gs = torch.where(zero[..., None, None], eye, g / scale[..., None, None].to(g.dtype))
    w, q = torch.linalg.eigh(gs)
    return torch.where(zero[..., None], 0.0, w * scale[..., None]), q


def gram_bands(x: torch.Tensor, levels: int = 3, band_rel: float = 3e-2) -> GramBands:
    """Left singular structure of X over ~levels*|log10(band_rel)| decades.

    Each level forms G = X X^H, takes its eigendecomposition, keeps the
    singular values above ``band_rel * s_max_level``, deflates that
    subspace out of X twice (CGS2) and repeats on the remainder.
    """
    qs, ss = [], []
    xc = x
    for level in range(levels):
        g = _herm(xc @ xc.conj().transpose(-1, -2))
        w, q = _eigh_scaled(g)  # ascending
        s = torch.sqrt(torch.clamp(w.flip(-1), min=0.0))
        q = q.flip(-1)
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


def _select_complete_basis(bands: GramBands):
    """Pick n mutually-orthogonal columns across bands, by singular value.

    In-band columns rank by their s; masked-out columns get key -1, so
    the stable top-n selection takes each level's converged columns plus
    the head of the last level.  Returns (q (..., n, n) columns
    descending by s, s (..., n)).
    """
    levels = bands.q.shape[0]
    n = bands.q.shape[-1]
    is_last = torch.zeros(levels, dtype=torch.bool, device=bands.s.device)
    is_last[-1] = True
    is_last = is_last.reshape((levels,) + (1,) * (bands.s.dim() - 1))
    keys = torch.where(is_last | (bands.s > 0), bands.s, -1.0)
    # (levels, ..., n, k) -> (..., n, levels*k), level-major columns
    qcat = torch.cat(list(bands.q), dim=-1)
    keys = torch.cat(list(keys), dim=-1)
    order = torch.argsort(-keys, dim=-1, stable=True)[..., :n]
    q = torch.take_along_dim(qcat, order[..., None, :], dim=-1)
    s = torch.clamp(torch.take_along_dim(keys, order, dim=-1), min=0.0)
    return q, s


# ------------------------------------------------------------------
# Tall R factorisation: shifted CholeskyQR
# ------------------------------------------------------------------

# Relative shift per round, in units of the current lambda_max estimate.
_CHOLQR_SHIFT_EPS_MULT = 3000.0


def _cholqr_rounds(dtype) -> int:
    """Shifted-round count covering any representable pencil conditioning
    (cond(N) ~ 1e18): 8 for float32, 4 for float64."""
    return 8 if torch.finfo(backend.real_dtype(dtype)).eps > 1e-10 else 4


def chol_qr_r(rows: torch.Tensor) -> torch.Tensor:
    """Upper-triangular R with N = R^H R for the noise rows G (..., R, n).

    Shifted CholeskyQR: per round one Gram, one shifted Cholesky, one
    explicit small triangular inverse and one tall update; ``rounds - 2``
    fully shifted rounds (each cuts cond^2 by ~1/shift_rel), one
    small-shift round, then one unshifted polish.  The diagonal is
    positive.
    """
    n = rows.shape[-1]
    eps = float(torch.finfo(backend.real_dtype(rows.dtype)).eps)
    rounds = _cholqr_rounds(rows.dtype)
    shift_rel = _CHOLQR_SHIFT_EPS_MULT * eps
    small_rel = 10.0 * (2 * n) * eps
    eye = torch.eye(n, dtype=rows.dtype, device=rows.device)

    g = rows
    r_tot = None
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
        if k < rounds - 1:
            rinv = torch.linalg.solve_triangular(r_k, eye.expand_as(r_k), upper=True)
            g = g @ rinv
    return r_tot


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
) -> KLResult:
    """Solve S v = w N v with S = A_s A_s^H and N = G^H G given by rows G.

    The eigenvalues are the squared singular values of y = R^-H A_s,
    resolved by ``sig_levels`` Gram deflation levels; the eigenvectors
    are R^-1 U.  Returns evals ascending and N-orthonormal columns.
    """
    r = chol_qr_r(noise_rows)
    y = torch.linalg.solve_triangular(r.conj().transpose(-1, -2), a_signal, upper=False)
    u, sy = _select_complete_basis(gram_bands(y, levels=sig_levels, band_rel=band_rel))
    evals = sy * sy  # descending
    v = torch.linalg.solve_triangular(r, u, upper=True)
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


_START_VECTORS: dict = {}


def _start_vector(n: int, like: torch.Tensor) -> torch.Tensor:
    """The fixed unit start vector (n, 1) of the power iteration (numpy
    seed 97531, as the JAX package draws it)."""
    if n not in _START_VECTORS:
        q, _ = np.linalg.qr(np.random.default_rng(97531).standard_normal((n, 1)))
        _START_VECTORS[n] = np.ascontiguousarray(q)
    return torch.as_tensor(_START_VECTORS[n], device=like.device).to(like.dtype)


def _spectral_norm_sq(a: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """lambda_max(A A^H) by power iteration from a fixed start, batched
    over leading axes: (...,) real."""
    v = _start_vector(a.shape[-2], a).expand(a.shape[:-2] + (a.shape[-2], 1))
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
) -> KLResult:
    """Solve S v = w (nc I + F) v by factor-side QR whitening.

    With thermal noise nc = 1 (the beams are noise-prewhitened); without
    (DoubleKL stage 1), nc = ``fg_floor`` * lambda_max(F).  ``fg_reg_rel``
    adds driftscan's foreground regulariser, fg_reg_rel * max|F_ij|, an
    identity shift that folds into the noise scale.  The defaults give the
    plain thermal pencil S v = w (I + F) v.
    """
    if with_thermal:
        nc = 1.0
    else:
        nc = fg_floor * _spectral_norm_sq(a_fg) + 1e-30
    if fg_reg_rel:
        nc = nc + fg_reg_rel * _max_row_norm_sq(a_fg)
    return pencil_solve_qr(
        a_signal, _thermal_noise_rows(a_fg, nc), sig_levels=sig_levels,
        band_rel=band_rel,
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
) -> KLResult:
    """Solve S v = w ([I +] A_f A_f^H) v; the ``qr`` engine only.

    Defaults follow the JAX package: 2 signal levels at band_rel 3e-2,
    thermal noise on, no regulariser.
    """
    if method != "qr":
        raise NotImplementedError(
            f"kl_solve method {method!r} is not ported: ROADMAP.md, modules "
            "to port, item 10 (opt-in engines)"
        )
    return kl_solve_qr(
        a_signal,
        a_fg,
        sig_levels=2 if sig_levels is None else sig_levels,
        band_rel=3e-2 if band_rel is None else band_rel,
        with_thermal=with_thermal,
        fg_floor=fg_floor,
        fg_reg_rel=fg_reg_rel,
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
