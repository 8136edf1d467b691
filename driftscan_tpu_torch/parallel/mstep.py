"""The batched per-m product step: SVD compression, KL pencil, Fisher.

Port of ``driftscan_tpu/parallel/mstep.py``.  One call takes a batch of
m-modes of beam transfer matrices and produces the SVD compression and
the KL filter of every one of them, with a batch dimension in place of
the JAX package's ``vmap`` and one native-complex path.  The KL stage
works on factored covariances (ops.fpencil); the fused Fisher step
contracts each m's retained KL modes against factored band covariances,
whose per-band Gram is the hand-written kernel K13 and whose weighted
trace is the hand-written kernel K15b (ops.projections.fisher_trace).
:func:`btm_forward_step` is the timestream simulation's forward model.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import backend
from ..ops import fpencil, linalg, projections
from . import mesh as meshmod

K13 = backend.register(
    "k13_fisher_cov",
    "driftscan_tpu_torch/csrc/fisher_gram.cu",
    "driftscan_tpu/parallel/mstep.py:387",
)


def prepare_cl_factors(cl_signal, cl_noise, out_dtype=np.float32):
    """Host-side, once per run: factor the per-l sky covariance blocks.

    cl_signal, cl_noise : (npol, npol, nl, F, F) real arrays.  Returns
    host (ls, lf) factor tables of shape (nl, npol, F, K).
    """
    return (
        fpencil.factor_cl(cl_signal, out_dtype=out_dtype),
        fpencil.factor_cl(cl_noise, out_dtype=out_dtype),
    )


def factors_from_numpy(ls, lf, band_lt, device, dtype):
    """The factor tables (e.g. the JAX package's, as numpy) as the port's
    tensors: (ls, lf, band_lt) of real ``dtype`` on ``device``
    (``band_lt`` may be None)."""
    def as_t(a):
        return None if a is None else torch.as_tensor(a, dtype=dtype, device=device)

    return as_t(ls), as_t(lf), as_t(band_lt)


def uses_compact_signal(n: int, width: int) -> bool:
    """Whether :func:`kl_product_step` re-factors the signal side to width
    n (K9 + shifted Cholesky): when the signal factor's width nl*K is more
    than twice the pencil dimension n."""
    return width > 2 * n


class ProductStepResult(NamedTuple):
    """Per-m outputs of the batched product step (all padded)."""

    ut: torch.Tensor  # (M, F, S, T) telescope -> SVD basis
    beam_svd: torch.Tensor  # (M, F, S, P*L) sky -> SVD basis
    sig: torch.Tensor  # (M, F, S) singular values
    nmodes: torch.Tensor  # (M, F) retained mode counts
    evals: torch.Tensor  # (M, F*S) KL eigenvalues (ascending, 0-padded)
    evecs: torch.Tensor  # (M, F*S, F*S) KL modes (rows)
    # per-m certificate of the top-band engine (fpencil.gram_topband):
    # False where kl_top_k was set and the m's band was not wholly captured
    # (redispatch those m); True on padding m and for the exact engine
    ok: torch.Tensor  # (M,) bool


def svd_compress(beam, noisew, m_values, npol: int, nl: int, polsvcut: float = 1e-4,
                 svcut: float = 1e-6):
    """The SVD stage of :func:`kl_product_step`, in complex128: (ut, beam_svd,
    sig, nmodes) of the masked, noise-whitened beams, with the global
    ``svcut`` (relative to each m's top singular value) applied to the
    bases and counted in ``nmodes``."""
    M = beam.shape[0]
    mv = m_values.to(beam.device)
    noisew = noisew.to(torch.float64)
    # The SVD and the pencil run in complex128 (outputs return in the
    # beams' precision; K9's Gram stays in it).  On an H100 a float32 SVD
    # puts the card's retained spectrum 2.9e-2 of the top eigenvalue away
    # from the CPU's at the bench's m = 3 (both float32; 1e-10 in
    # complex128), and cuSOLVER's complex64 Hermitian eigensolver fails
    # to converge on some deflated Grams.
    # beams are sensitive to l >= m only: mask, then noise-prewhiten
    lmask = (torch.arange(nl, device=beam.device)[None, :] >= mv[:, None]).double()
    tile = lmask.repeat(1, npol)[:, None, None, :]
    bw = beam.to(torch.complex128) * tile * noisew[None, :, :, None]

    ut, bsvd, sig, nmodes = linalg.triple_svd_batched(
        bw, npol=npol, nl=nl, polsvcut=polsvcut
    )
    # global svcut relative to each m's top singular value
    smax = sig.reshape(M, -1).amax(-1)
    svmask = (sig > smax[:, None, None] * svcut).double()
    ut = ut * svmask[..., None]
    bsvd = bsvd * svmask[..., None]
    nmodes = torch.minimum(nmodes, svmask.sum(-1).to(nmodes.dtype))
    return ut, bsvd, sig, nmodes


class Compressed(NamedTuple):
    """The SVD stage and the pencil factors of :func:`kl_product_step`, the
    part that does not depend on the KL engine (:func:`compress_step`)."""

    ut: torch.Tensor  # (M, F, S, T)
    beam_svd: torch.Tensor  # (M, F, S, P*L)
    sig: torch.Tensor  # (M, F, S)
    nmodes: torch.Tensor  # (M, F)
    a_s: torch.Tensor  # (M, n, Ks) signal factor
    a_f: torch.Tensor  # (M, n, Kf) foreground factor
    m_values: torch.Tensor  # (M,), m < 0 marking padding
    dtype: torch.dtype  # the beams' complex dtype


def compress_step(beam, noisew, ls, lf, m_values, npol: int, nl: int,
                  polsvcut: float = 1e-4, svcut: float = 1e-6, s_cap: int = 0,
                  method: str = "qr", compact_signal: bool | None = None) -> Compressed:
    """The SVD stage of :func:`kl_product_step` and its pencil's factors;
    arguments as there.  A caller that solves one pencil more than once
    (a deeper exact solve, a top-band redispatch) computes this once and
    passes it to :func:`kl_solve_step` each time."""
    M, F = beam.shape[0], beam.shape[1]
    mv = m_values.to(beam.device)
    ut, bsvd, sig, nmodes = svd_compress(beam, noisew, mv, npol, nl, polsvcut, svcut)
    S = ut.shape[-2]
    # modes are sorted by singular value per frequency, so the top-s_cap
    # slice keeps every non-zero mode
    s_kl = s_cap if 0 < s_cap < S else S

    b5 = bsvd[:, :, :s_kl].reshape(M, F, s_kl, npol, nl)
    compact = compact_signal
    if compact is None:
        # the gram engine deflates the signal factor as it is (K9 does not
        # run there), as in the JAX package
        compact = method == "qr" and uses_compact_signal(F * s_kl, nl * ls.shape[-1])
    if compact:
        # re-factor the signal side to width n (K9 + shifted Cholesky)
        a_s = fpencil.beam_factor_compact(b5.to(beam.dtype), ls)
    else:
        a_s = fpencil.beam_factor(b5, ls)
    a_f = fpencil.beam_factor(b5, lf)
    return Compressed(ut, bsvd, sig, nmodes, a_s, a_f, mv, beam.dtype)


def kl_solve_step(
    comp: Compressed,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    kl_cut: float = 0.0,
    kl_top_k: int = 0,
    kl_levels: int = 5,
    with_thermal: bool = True,
    fg_levels: int = 8,
    fg_k_cap: int = 0,
    sig_k_cap: int = 0,
    method: str = "qr",
) -> ProductStepResult:
    """The KL stage of :func:`kl_product_step` on a :func:`compress_step`
    result; arguments as there."""
    cdt = comp.dtype
    rdt = backend.real_dtype(cdt)
    keep_m = comp.m_values >= 0
    if kl_top_k:
        if method != "qr" or not with_thermal:
            raise ValueError("kl_top_k requires method='qr' with_thermal=True")
        kl, ok = fpencil.kl_solve_qr_topband(comp.a_s, comp.a_f, cut=kl_cut, k=kl_top_k,
                                             levels=kl_levels)
        ok = ok | ~keep_m  # padding m never block a dispatch
    else:
        kl = fpencil.kl_solve(
            comp.a_s, comp.a_f, with_thermal=with_thermal, fg_levels=fg_levels,
            sig_levels=sig_levels, band_rel=band_rel, fg_k_cap=fg_k_cap,
            sig_k_cap=sig_k_cap, method=method,
        )
        ok = torch.ones_like(keep_m)
    evecs = kl.evecs.conj().transpose(-1, -2)  # rows are KL modes

    keep = keep_m.double()
    return ProductStepResult(
        ut=(comp.ut * keep[:, None, None, None]).to(cdt),
        beam_svd=(comp.beam_svd * keep[:, None, None, None]).to(cdt),
        sig=(comp.sig * keep[:, None, None]).to(rdt),
        nmodes=(comp.nmodes * keep_m[:, None]).to(torch.int32),
        evals=(kl.evals * keep[:, None]).to(rdt),
        evecs=(evecs * keep[:, None, None]).to(cdt),
        ok=ok,
    )


def kl_product_step(
    beam: torch.Tensor,
    noisew: torch.Tensor,
    ls: torch.Tensor,
    lf: torch.Tensor,
    m_values: torch.Tensor,
    npol: int,
    nl: int,
    polsvcut: float = 1e-4,
    svcut: float = 1e-6,
    with_thermal: bool = True,
    fg_levels: int = 8,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    fg_k_cap: int = 0,
    sig_k_cap: int = 0,
    method: str = "qr",
    s_cap: int = 0,
    compact_signal: bool | None = None,
    kl_cut: float = 0.0,
    kl_top_k: int = 0,
    kl_levels: int = 5,
    mesh=None,
) -> ProductStepResult:
    """SVD-compress and KL-filter a batch of m-modes: :func:`compress_step`
    then :func:`kl_solve_step`.

    beam : (M, F, T, npol*nl) complex, m-major; noisew (F, T) inverse noise
    weights (noisepower^-1/2), so the projected radiometer noise is the
    identity in the SVD basis; ls, lf (nl, npol, F, K) covariance factors;
    m_values (M,) with m < 0 marking padding (zero outputs).  ``polsvcut``
    is the polarisation filter's cut (npol > 1), relative to each item's
    largest polarised singular value.  ``s_cap`` > 0 keeps the top
    ``s_cap`` SVD modes of each frequency in the KL pencil (its dimension
    is then F * s_cap; the caller keeps every retained mode inside the
    cap): the m-bucketing's compacted mode axis.

    The KL engine's arguments are the JAX package's, with its defaults for
    this entry point (fg_levels 8, sig_levels 2, band_rel 3e-2, passed to
    :func:`fpencil.kl_solve` as they are): ``method`` ("qr" or "gram"),
    ``with_thermal`` (False: the foreground-only pencil), ``fg_levels``,
    ``fg_k_cap`` and ``sig_k_cap`` (the rank-capped quick-look levels).
    ``compact_signal`` forces the signal factor's re-factorisation to
    width n on or off (None: for ``qr`` when its width exceeds 2n, never
    for ``gram``).  ``kl_top_k`` > 0 solves the pencil with the top-band
    engine (:func:`fpencil.kl_solve_qr_topband`; ``qr`` with thermal noise
    only): only the eigenvalues >= ``kl_cut`` are computed, in
    ``kl_levels`` deflation levels of a ``kl_top_k``-column filtered
    basis, the rest are exact zeros, and ``ok`` carries each m's
    certificate.

    With a ``mesh`` of more than one entry (``parallel/mesh.py``) the step
    is sharded along m, the counterpart of the JAX package's
    ``jit_product_step(mesh=)``: the beam batch and the m values are split
    over the entries (M must divide the mesh size), noisew, ls and lf are
    replicated, each entry runs the step on its part in its own worker
    thread, and every output is gathered along m on the beams' device.
    """
    mesh = meshmod.multi(mesh)
    if mesh is not None:
        kw = dict(polsvcut=polsvcut, svcut=svcut, with_thermal=with_thermal,
                  fg_levels=fg_levels, sig_levels=sig_levels, band_rel=band_rel,
                  fg_k_cap=fg_k_cap, sig_k_cap=sig_k_cap, method=method, s_cap=s_cap,
                  compact_signal=compact_signal, kl_cut=kl_cut, kl_top_k=kl_top_k,
                  kl_levels=kl_levels)
        return meshmod.shard_map(
            lambda b, mv, nw, s, f: kl_product_step(b, nw, s, f, mv, npol, nl, **kw),
            mesh, sharded=(beam, m_values), replicated=(noisew, ls, lf),
            gather_to=beam.device,
        )
    comp = compress_step(beam, noisew, ls, lf, m_values, npol, nl, polsvcut, svcut, s_cap,
                         method=method, compact_signal=compact_signal)
    return kl_solve_step(comp, sig_levels=sig_levels, band_rel=band_rel, kl_cut=kl_cut,
                         kl_top_k=kl_top_k, kl_levels=kl_levels, with_thermal=with_thermal,
                         fg_levels=fg_levels, fg_k_cap=fg_k_cap, sig_k_cap=sig_k_cap,
                         method=method)


def band_factor_table(clbands, out_dtype=np.float32, l_chunk=64, rank_rtol=1e-15):
    """Host-side, once per run: factor each band's temperature C_l.

    clbands : iterable of (nl, F, F) real arrays.  Returns band_lt
    (nbands, nlp, F, Kmax): per-band rank-compacted factors
    (``fpencil.factor_cl``), zero-padded to the largest width and to an l
    axis that is a multiple of ``l_chunk``.
    """
    facs = []
    for c in clbands:
        c = np.asarray(c, dtype=np.float64)
        facs.append(
            fpencil.factor_cl(c[None, None], out_dtype=out_dtype, rank_rtol=rank_rtol)[:, 0]
        )
    if not facs:
        raise ValueError("no bands given")
    kmax = max(f.shape[-1] for f in facs)
    nl, F = facs[0].shape[0], facs[0].shape[1]
    nlp = ((nl + l_chunk - 1) // l_chunk) * l_chunk
    out = np.zeros((len(facs), nlp, F, kmax), dtype=out_dtype)
    for bi, f in enumerate(facs):
        out[bi, :nl, :, : f.shape[-1]] = f
    return out


def fisher_factor(v: torch.Tensor, bt: torch.Tensor, band_lt: torch.Tensor):
    """The per-band factors Y_b = G L_b of :func:`fisher_cov`, formed in
    full: (M, nb, k, nlp*Kb)."""
    nlp = band_lt.shape[1]
    nl = bt.shape[-1]
    g = torch.einsum("mkfs,mfsl->mkfl", v, bt)
    g = torch.nn.functional.pad(g, (0, nlp - nl))
    gr = torch.view_as_real(g)  # (M, k, F, nlp, 2)
    y = torch.einsum("mkflc,blfK->mbklKc", gr, band_lt)
    return torch.view_as_complex(y.contiguous()).flatten(-2)


def fisher_cov_ref(v: torch.Tensor, bt: torch.Tensor, band_lt: torch.Tensor):
    """Plain PyTorch version of :func:`fisher_cov`."""
    y = fisher_factor(v, bt, band_lt)
    return y @ y.conj().transpose(-1, -2)


def fisher_cov(v: torch.Tensor, bt: torch.Tensor, band_lt: torch.Tensor):
    """Per-band projected covariances C_b = (G L_b)(G L_b)^H (K13).

    v : (M, k, F, S) retained KL modes (rows) in the SVD basis;
    bt : (M, F, S, nl) temperature rows of the sky->SVD beams;
    band_lt : (nb, nlp, F, Kb) real band factors, nlp >= nl.
    G[k, f, l] = sum_s v[k, f, s] bt[f, s, l];
    C_b[i, j] = sum_{l, K} Y_b[i, l, K] conj(Y_b[j, l, K]) with
    Y_b[i, l, K] = sum_f G[i, f, l] L_b[l, f, K].  Returns (M, nb, k, k).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    band_lt = band_lt.to(backend.real_dtype(v.dtype))
    if not backend.on_cuda(v, bt, band_lt):
        return fisher_cov_ref(v, bt, band_lt)
    M, k, F, S = v.shape
    nl = bt.shape[-1]
    nb, nlp, _, Kb = band_lt.shape
    backend.require(v, "v", dtype=(torch.complex64, torch.complex128), ndim=4)
    backend.require(bt, "bt", dtype=v.dtype, shape=(M, F, S, nl))
    band_lt = band_lt.contiguous()
    backend.require(band_lt, "band_lt", shape=(nb, nlp, F, Kb))
    if nlp < nl:
        raise ValueError(f"band table l axis {nlp} shorter than nl={nl}")
    # scratch: G and the band factors Y, over l < nl
    g = torch.empty((M, k, F, nl), dtype=v.dtype, device=v.device)
    y = torch.empty((M * nb, k, nl * Kb), dtype=v.dtype, device=v.device)
    out = torch.empty((M, nb, k, k), dtype=v.dtype, device=v.device)
    part, (part_ptr, part_bytes, nsplit, cps) = backend.gram_launch(k, nl * Kb, M * nb, v)
    fn = K13.entry(
        "fisher_cov_c64" if v.dtype == torch.complex64 else "fisher_cov_c128",
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    )
    backend.launch(
        K13, fn, v.device,
        v.data_ptr(), bt.data_ptr(), band_lt.data_ptr(), g.data_ptr(), y.data_ptr(),
        out.data_ptr(), part_ptr, part_bytes,
        M, k, F, S, nl, nlp, nb, Kb, nsplit, cps,
    )
    return out


def fisher_step(evals, evecs, beam_svd, band_lt, ps_threshold: float, npol: int,
                nl: int, kf: int, s_cap: int = 0, f_idx=None, mesh=None):
    """Per-m quadratic-estimator Fisher matrices from the KL products.

    F_ab[m] = sum_ij w_i w_j C_a[i, j] C_b[j, i] with w = 1/(1 + lambda)
    over the modes retained above ``ps_threshold`` (> 0, so zero-padded
    slots drop out); the covariances C_b are Hermitian (K13 returns them
    so bit for bit), so C_b[j, i] = conj(C_b[i, j]).  evals (M, n)
    ascending, evecs (M, n, n) rows = modes, beam_svd (M, F, S, npol*nl);
    the retained modes are the trailing ``kf`` rows, where kf is at least
    the batch's largest retained count.  A compacted m-chunk passes the
    product step's ``s_cap`` (the pencil's top-s_cap modes a frequency)
    and ``f_idx`` (the band table's frequencies of the chunk's frequency
    slots; padding slots need no mask: their beams are zero).  Returns
    (M, nb, nb) complex128 (:func:`projections.fisher_trace`, accumulated
    in float64).  A ``mesh`` of more than one entry splits evals, evecs and
    beam_svd along m over its entries and replicates band_lt, as
    :func:`kl_product_step` does; the per-m matrices are gathered on the
    spectra's device.
    """
    if ps_threshold <= 0:
        raise ValueError("ps_threshold must be > 0 (padding-slot contract)")
    mesh = meshmod.multi(mesh)
    if mesh is not None:
        return meshmod.shard_map(
            lambda e, v, b, bl: fisher_step(e, v, b, bl, ps_threshold, npol, nl, kf,
                                            s_cap, f_idx),
            mesh, sharded=(evals, evecs, beam_svd), replicated=(band_lt,),
            gather_to=evals.device,
        )
    M, F, S = beam_svd.shape[0], beam_svd.shape[1], beam_svd.shape[2]
    s_kl = s_cap if 0 < s_cap < S else S
    if f_idx is not None:
        band_lt = band_lt[:, :, torch.as_tensor(f_idx, device=band_lt.device)]
    n = evals.shape[-1]
    ev = evals[:, n - kf :]
    w = torch.where(ev > ps_threshold, 1.0 / (1.0 + ev), torch.zeros_like(ev))
    v = evecs[:, n - kf :].reshape(M, kf, F, s_kl).resolve_conj().contiguous()
    bt = beam_svd[:, :, :s_kl].reshape(M, F, s_kl, npol, nl)[:, :, :, 0].contiguous()
    c = fisher_cov(v, bt, band_lt)  # (M, nb, kf, kf)
    return projections.fisher_trace(c, c, w.contiguous())


def btm_forward_step(alm, beam):
    """The m-mode forward model for a batch of m: sky alm -> visibilities,
    v[m, f, t] = sum_s beam[m, f, t, s] alm[m, f, s] (the inner projection
    of the timestream simulation)."""
    return torch.einsum("mfts,mfs->mft", beam, alm.to(beam.dtype))
