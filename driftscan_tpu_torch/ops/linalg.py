"""Padded, batched triple-SVD compression of the beam transfer matrices.

Port of ``driftscan_tpu/ops/linalg.py`` ``triple_svd_split_batched`` (the
algorithm the JAX product path runs), with native-complex
``torch.linalg.svd`` in place of the Gram-eigendecomposition SVDs.  Per
(m, freq) item of the noise-weighted beam B (ntel, npol*nl):

1. SVD1: the image of the full beam (cut at ``SVD_FLOOR``);
2. SVD2: the resolved polarised directions -- the left singular vectors
   of the image's Q/U/V block with s >= max(s) * polsvcut -- are
   projected out of the image basis by classical Gram-Schmidt, twice
   (CGS2), which leaves the polarisation-filtered basis.  The null space
   is never taken from the tail of an SVD;
3. SVD3: the Stokes-I response of what remains, ordered by sensitivity.

Unpolarised beams (npol = 1) go straight to SVD3.

The dense generalised Hermitian eigensolve of the per-m KL path
(:func:`eigh_gen`, :func:`eigh_gen_batched`) and the (pseudo-)inverses
are library compositions: Cholesky whitening plus ``torch.linalg.eigh``.
"""

from __future__ import annotations

import torch

# Image cut of SVD1 and SVD3, relative to each item's top singular value:
# the resident product path of the JAX package (triple_svd_split_batched)
# floors the cut at 1e-5 -- modes that faint carry 1e-10 of the peak power
# and fall under the global svcut anyway.
SVD_FLOOR = 1e-5

# Absolute floor of the Stokes-I stage, relative to the item's full-beam
# top singular value.  When the polarisation filter removes the whole
# image (every image direction has a polarised response above the cut),
# what SVD3 sees is the CGS2 rounding residue (~1e-15 of the beam), and a
# cut relative to its own top would keep that residue as modes; the
# reference keeps none there (its null space is empty).
POL_RESIDUE_FLOOR = 1e-12


def _herm_t(x: torch.Tensor) -> torch.Tensor:
    return x.conj().transpose(-1, -2).resolve_conj()


# The image cuts of the file pipeline's SVD stage (the JAX package's
# native-complex ``triple_svd_batched``): 1e-10 for SVD1, 1e-13 for SVD3;
# the svcut (1e-6 by default) is applied downstream, when modes are counted.
FILE_SVD1_FLOOR = 1e-10
FILE_SVD3_FLOOR = 1e-13


def triple_svd_batched(bfr: torch.Tensor, npol: int, nl: int, polsvcut: float = 1e-4,
                       floor1: float = SVD_FLOOR, floor3: float = SVD_FLOOR):
    """Per-item SVD compression of noise-weighted beam matrices.

    bfr : (..., ntel, npol*nl) complex, pol-major columns (p * nl + l).
    ``floor1`` and ``floor3`` are the image cuts of SVD1 and SVD3 relative
    to each item's top singular value (the resident path's by default).
    Returns (ut (..., svd_len, ntel), beam (..., svd_len, npol*nl), sig
    (..., svd_len), nmodes (...) int32) with ``svd_len = min(ntel, nl)``;
    rows past an item's mode count are zero.
    """
    if bfr.shape[-1] != npol * nl:
        raise ValueError(f"beam has {bfr.shape[-1]} columns, expected npol*nl = {npol * nl}")
    ntel = bfr.shape[-2]
    svd_len = min(nl, ntel)
    ut2 = None
    bft = bfr
    residue = None
    if npol > 1:
        # SVD1: image of the full beam
        u1, s1, _ = torch.linalg.svd(bfr, full_matrices=False)
        mask1 = s1 > s1[..., :1] * floor1
        ut1 = _herm_t(u1 * mask1[..., None, :].to(u1.dtype))  # (..., K1, ntel)
        # an all-zero item keeps no mode (the JAX package's pol_ok)
        residue = s1[..., :1] * POL_RESIDUE_FLOOR

        # SVD2: project the resolved polarised directions out of the image
        bfp = (ut1 @ bfr)[..., nl:]  # (..., K1, (npol-1)*nl)
        u2, s2, _ = torch.linalg.svd(bfp, full_matrices=False)
        keep2 = s2 >= s2.amax(-1, keepdim=True) * polsvcut
        qp = u2 * keep2[..., None, :].to(u2.dtype)
        qph = _herm_t(qp)
        ut2 = ut1
        for _ in range(2):  # CGS2
            ut2 = ut2 - qp @ (qph @ ut2)
        bft = (ut2 @ bfr)[..., :nl]

    # SVD3: image of the Stokes-I response
    u3, s3, _ = torch.linalg.svd(bft, full_matrices=False)  # u3 (..., K2, k)
    mask3 = s3 > s3[..., :1] * floor3
    if residue is not None:
        mask3 = mask3 & (s3 > residue)
    ut = _herm_t(u3 * mask3[..., None, :].to(u3.dtype))
    if ut2 is not None:
        ut = ut @ ut2
    beam = ut @ bfr
    sig = s3 * mask3.to(s3.dtype)
    nmodes = mask3.sum(-1).to(torch.int32)
    k = ut.shape[-2]
    if k < svd_len:
        pad = svd_len - k
        ut = torch.nn.functional.pad(ut, (0, 0, 0, pad))
        beam = torch.nn.functional.pad(beam, (0, 0, 0, pad))
        sig = torch.nn.functional.pad(sig, (0, pad))
    return ut[..., :svd_len, :], beam[..., :svd_len, :], sig[..., :svd_len], nmodes


# ------------------------------------------------------------------
# Generalised Hermitian eigenproblem (dense per-m KL path)
# ------------------------------------------------------------------


def _whitened_eigh(A: torch.Tensor, B: torch.Tensor):
    """eigh of A v = w B v via Cholesky whitening, batched over leading axes.

    Returns (evals ascending, evecs with columns v, ok): ``ok`` is False
    for an item whose B has no Cholesky factor or whose outputs are not
    finite; the caller regularises those.
    """
    low, info = torch.linalg.cholesky_ex(B)
    li_a = torch.linalg.solve_triangular(low, A, upper=False)
    c = torch.linalg.solve_triangular(low, li_a.mH, upper=False).mH
    c = 0.5 * (c + c.mH)  # Hermitise against roundoff
    finite = torch.isfinite(torch.view_as_real(c) if c.is_complex() else c)
    finite = finite.reshape(c.shape[:-2] + (-1,)).all(-1)
    ok = (info == 0) & finite
    eye = torch.eye(c.shape[-1], dtype=c.dtype, device=c.device)
    w, u = torch.linalg.eigh(torch.where(ok[..., None, None], c, eye))
    v = torch.linalg.solve_triangular(low.mH, u, upper=True)
    vr = torch.view_as_real(v) if v.is_complex() else v
    ok = ok & torch.isfinite(w).all(-1) & torch.isfinite(vr).reshape(
        v.shape[:-2] + (-1,)
    ).all(-1)
    return w, v, ok


def eigh_gen(A: torch.Tensor, B: torch.Tensor, message: str = ""):
    """Solve ``A v = lambda B v`` with regularisation fallback.

    A, B (n, n) Hermitian tensors on one device.  Returns (evals (n,)
    ascending, evecs (n, n) columns, add_const): ``add_const`` is the
    constant added to diag(B) when B was not positive definite
    (1e-15 lambda_max(B) - 2 lambda_min(B) + 1e-60).
    """
    n = A.shape[0]
    if not bool((A != 0).any()):
        rdt = A.real.dtype if A.is_complex() else A.dtype
        return (
            torch.zeros(n, dtype=rdt, device=A.device),
            torch.eye(n, dtype=A.dtype, device=A.device),
            0.0,
        )
    w, v, ok = _whitened_eigh(A, B)
    if bool(ok):
        return w, v, 0.0
    evb = torch.linalg.eigvalsh(B)
    add_const = float(1e-15 * evb[-1] - 2.0 * evb[0] + 1e-60)
    breg = B + add_const * torch.eye(n, dtype=B.dtype, device=B.device)
    w, v, ok = _whitened_eigh(A, breg)
    if not bool(ok):
        raise RuntimeError(
            f"Generalised eigenproblem failed even after regularisation {message}"
        )
    return w, v, add_const


def eigh_gen_batched(A: torch.Tensor, B: torch.Tensor):
    """Batched generalised eigh with per-item regularisation.

    A, B : (batch, n, n).  Items whose B has no Cholesky factor get a
    diagonal shift from Gershgorin bounds (1e-15 hi - 2 min(lo, 0) +
    1e-30) before the whitened solve; an all-zero A gives zero eigenvalues
    and the identity basis.  Returns (evals (batch, n) ascending, evecs
    (batch, n, n) columns, add_const (batch,)).
    """
    n = A.shape[-1]
    _, info = torch.linalg.cholesky_ex(B)
    bad = info != 0
    diag = torch.diagonal(B, dim1=-2, dim2=-1)
    radius = B.abs().sum(-1) - diag.abs()
    lo = (diag.real - radius).amin(-1)
    hi = (diag.real + radius).amax(-1)
    shift = 1e-15 * hi - 2.0 * torch.clamp(lo, max=0.0) + 1e-30
    add_const = torch.where(bad, shift, torch.zeros_like(shift))
    eye = torch.eye(n, dtype=B.dtype, device=B.device)
    w, v, _ = _whitened_eigh(A, B + add_const[..., None, None] * eye)
    zero = ~(A != 0).reshape(A.shape[:-2] + (-1,)).any(-1)
    w = torch.where(zero[..., None], torch.zeros_like(w), w)
    v = torch.where(zero[..., None, None], eye.to(v.dtype), v)
    return w, v, torch.where(zero, torch.zeros_like(add_const), add_const)


def inv_gen(A: torch.Tensor) -> torch.Tensor:
    """Inverse, or the pseudo-inverse where A is singular or the inverse
    is not finite."""
    inv, info = torch.linalg.inv_ex(A)
    fin = torch.isfinite(torch.view_as_real(inv) if inv.is_complex() else inv)
    if int(info) != 0 or not bool(fin.all()):
        return torch.linalg.pinv(A)
    return inv


def pinv(A: torch.Tensor, rcond: float = 1e-15) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse with a relative singular-value cut."""
    return torch.linalg.pinv(A, rtol=rcond)
