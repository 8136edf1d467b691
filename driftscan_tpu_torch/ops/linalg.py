"""Padded, batched SVD compression of the beam transfer matrices.

Port of ``driftscan_tpu/ops/linalg.py`` ``triple_svd_batched`` for the
unpolarised case, where the triple SVD reduces to one masked SVD per
(m, freq) of the noise-weighted beam (``torch.linalg.svd``, native
complex).  The polarised stages (image and polarisation null space) are
not ported yet.
"""

from __future__ import annotations

import torch

# Image cut of the Stokes-I stage, relative to each item's top singular
# value: the resident product path of the JAX package
# (triple_svd_split_batched) floors the cut at 1e-5 — modes that faint
# carry 1e-10 of the peak power and fall under the global svcut anyway.
SVD_FLOOR = 1e-5


def triple_svd_batched(bfr: torch.Tensor, npol: int, nl: int):
    """Per-item SVD compression of noise-weighted beam matrices.

    bfr : (..., ntel, npol*nl) complex.  Returns (ut (..., svd_len, ntel),
    beam (..., svd_len, npol*nl), sig (..., svd_len), nmodes (...) int32)
    with ``svd_len = min(ntel, nl)``; rows past an item's mode count are
    zero.
    """
    if npol != 1:
        raise NotImplementedError(
            "the polarised triple SVD is not ported yet: ROADMAP.md, modules "
            "to port, item 6 (the polarised leg)"
        )
    ntel = bfr.shape[-2]
    svd_len = min(nl, ntel)
    u, s, _ = torch.linalg.svd(bfr, full_matrices=False)  # u (..., ntel, k)
    mask = s > s[..., :1] * SVD_FLOOR
    ut = (u * mask[..., None, :].to(u.dtype)).conj().transpose(-1, -2).resolve_conj()
    beam = ut @ bfr
    sig = s * mask.to(s.dtype)
    nmodes = mask.sum(-1).to(torch.int32)
    k = ut.shape[-2]
    if k < svd_len:
        pad = svd_len - k
        ut = torch.nn.functional.pad(ut, (0, 0, 0, pad))
        beam = torch.nn.functional.pad(beam, (0, 0, 0, pad))
        sig = torch.nn.functional.pad(sig, (0, pad))
    return ut[..., :svd_len, :], beam[..., :svd_len, :], sig[..., :svd_len], nmodes
