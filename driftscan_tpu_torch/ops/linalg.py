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


def triple_svd_batched(bfr: torch.Tensor, npol: int, nl: int, polsvcut: float = 1e-4):
    """Per-item SVD compression of noise-weighted beam matrices.

    bfr : (..., ntel, npol*nl) complex, pol-major columns (p * nl + l).
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
    floor3 = None
    if npol > 1:
        # SVD1: image of the full beam
        u1, s1, _ = torch.linalg.svd(bfr, full_matrices=False)
        mask1 = s1 > s1[..., :1] * SVD_FLOOR
        ut1 = _herm_t(u1 * mask1[..., None, :].to(u1.dtype))  # (..., K1, ntel)
        # an all-zero item keeps no mode (the JAX package's pol_ok)
        floor3 = s1[..., :1] * POL_RESIDUE_FLOOR

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
    mask3 = s3 > s3[..., :1] * SVD_FLOOR
    if floor3 is not None:
        mask3 = mask3 & (s3 > floor3)
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
