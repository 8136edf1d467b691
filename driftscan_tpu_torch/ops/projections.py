"""Projection programs of the product pipeline.

Port of ``driftscan_tpu/ops/projections.py``: the contractions behind
BeamTransfer's projection API, the KL covariance builds and PSExact's
Fisher matrix.  Every function takes tensors (or arrays, which go to
``device``) and returns tensors that stay on their device until a file
needs them; there is one native-complex path.

Two of the programs are hand-written kernels:

* :func:`sandwich` (K15a, CUDA C++): out = sum_l X_l C_l Y_l^H per batch
  item, behind :func:`band_covariance_projection` and
  :func:`sky_covariance_projection` / :func:`sky_covariance_projection_m`;
* :func:`fisher_trace` (K15b, CUDA C++): F_ab = sum_ij w_i w_j C_a[i,j]
  C_b[j,i], behind :func:`fisher_trace_block` and ``mstep.fisher_step``.

Each has a plain PyTorch version (``*_ref``) that the wrapper takes for
CPU tensors only.  The rest are library compositions (a scaled batched
matmul, ``torch.linalg``) or compositions of the factored-pencil pieces
of ops.fpencil.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import backend
from ..parallel import mesh as meshmod
from . import fpencil, linalg

K15A = backend.register(
    "k15a_sandwich",
    "driftscan_tpu_torch/csrc/sandwich.cu",
    "driftscan_tpu/ops/projections.py:302",
)

K15B = backend.register(
    "k15b_fisher_trace",
    "driftscan_tpu_torch/csrc/fisher_trace.cu",
    "driftscan_tpu/ops/projections.py:352",
)

def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its device unless ``device`` is
    given; an array goes to ``device`` (the card when None)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype) if (device or dtype) else x
    return torch.as_tensor(
        np.asarray(x), dtype=dtype, device="cuda" if device is None else device
    )


def products_from_numpy(device, dtype=torch.complex128, **arrays):
    """Host arrays as the JAX package holds them (``beam_svd`` (F, S, npol,
    nl), ``beam_ut``, KL ``evals`` / ``evecs``, ``clarray``, ...) as the
    port's tensors on ``device``: complex arrays in ``dtype``, real ones in
    its real precision.  Returns a dict with the same keys."""
    rdt = backend.real_dtype(dtype)
    out = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        want = dtype if np.iscomplexobj(arr) else (rdt if arr.dtype.kind == "f" else None)
        out[name] = torch.as_tensor(arr, dtype=want, device=device)
    return out


# ------------------------------------------------------------------
# K15a: the projection sandwich
# ------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _default_index(nb: int, size: int, device: torch.device) -> torch.Tensor:
    """The index of an operand given without one: the identity for a batch
    of nb, all zeros for a batch of one (kept per device: the per-m callers
    ask for the same few again and again)."""
    if size not in (1, nb):
        raise ValueError(f"operand batch of {size} does not broadcast to {nb}")
    i = torch.arange(nb, dtype=torch.int32) if size == nb else torch.zeros(nb, dtype=torch.int32)
    return i.to(device)


@functools.lru_cache(maxsize=64)
def sky_pair_index(nm: int, nf: int, device: torch.device):
    """(ix, iy, ic) int32 on ``device`` for the sky forms: batch item
    (mi, f, g), in that order, takes X = beam[mi * nf + f], Y = beam[mi * nf
    + g] and C = c[f * nf + g].  Built once per (nm, nf, device)."""
    mi, f, g = (a.ravel() for a in np.meshgrid(
        np.arange(nm), np.arange(nf), np.arange(nf), indexing="ij"))
    return tuple(
        torch.as_tensor(a.astype(np.int32), device=device)
        for a in (mi * nf + f, mi * nf + g, f * nf + g)
    )


def _sandwich_indices(x, y, c, ix, iy, ic):
    """The three (B,) int32 operand indices on the operands' device.  An
    index tensor already on that device is used as it is; a host array or
    list is range-checked with numpy and uploaded once."""
    nb = max(x.shape[0], y.shape[0], c.shape[0]) if ix is None else len(ix)

    def idx(name, i, size):
        if i is None:
            return _default_index(nb, size, x.device)
        if isinstance(i, torch.Tensor) and i.device == x.device:
            if tuple(i.shape) != (nb,):
                raise ValueError(f"{name}: shape {tuple(i.shape)}, expected ({nb},)")
            return i.to(torch.int32).contiguous()
        a = np.asarray(i.cpu() if isinstance(i, torch.Tensor) else i)
        if a.shape != (nb,):
            raise ValueError(f"{name}: shape {a.shape}, expected ({nb},)")
        if nb and not (0 <= a.min() and a.max() < size):
            raise ValueError(f"{name} out of range for a batch of {size}")
        return torch.as_tensor(a.astype(np.int32), device=x.device)

    return idx("ix", ix, x.shape[0]), idx("iy", iy, y.shape[0]), idx("ic", ic, c.shape[0])


def sandwich_ref(x, y, c, ix=None, iy=None, ic=None):
    """Plain PyTorch version of :func:`sandwich` (two contractions)."""
    c = c.to(backend.real_dtype(x.dtype))
    ix, iy, ic = _sandwich_indices(x, y, c, ix, iy, ic)
    t = torch.einsum("bicl,blcd->bidl", x[ix.long()], c[ic.long()].to(x.dtype))
    return torch.einsum("bidl,bjdl->bij", t, y[iy.long()].conj())


# csrc/sandwich.cu: contraction slots (d, l) per chunk, the largest cluster
# that shares a tile's chunks, and the blocks an SM holds at once, of
# either tile edge (its MIN_BLOCKS launch bound)
SANDWICH_KC = 16
SANDWICH_MAX_SPLIT = 8
SANDWICH_BLOCKS_PER_SM = 2
_SANDWICH_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


class SandwichPlan(NamedTuple):
    tile: int  # output tile edge, 32 or 64
    dc: int  # d values per chunk (16 // dc values of l)
    nchunks: int
    nsplit: int  # blocks of a cluster sharing one tile's chunks
    cps: int  # chunks per split


@functools.lru_cache(maxsize=256)
def sandwich_plan(nb: int, n: int, m: int, cd: int, nl: int, sms: int) -> SandwichPlan:
    """The launch plan of one sandwich call.

    The output tile edge is 32 where n and m are at most 64 (a 44 x 44 or
    52 x 52 KL block: more blocks, and the sub-tiles past the edge skipped)
    and 64 otherwise.  A chunk holds dc = min(cd, 16) values of d times
    16 // dc values of l.  The chunks of a tile are shared among the nsplit
    blocks of a cluster so as to minimise rounds x (chunks per block + 2),
    the launch's critical path with a block's staging and epilogue counted
    as two chunks (the smallest split on a tie).
    """
    tile = 32 if max(n, m) <= 64 else 64
    dc = min(cd, SANDWICH_KC)
    nchunks = -(-nl // (SANDWICH_KC // dc)) * -(-cd // dc)
    tiles = max(nb * -(-n // tile) * -(-m // tile), 1)
    slots = sms * SANDWICH_BLOCKS_PER_SM

    def cost(s):
        return -(-tiles * s // slots) * (-(-nchunks // s) + 2)

    nsplit = min(range(1, min(SANDWICH_MAX_SPLIT, nchunks) + 1), key=lambda s: (cost(s), s))
    cps = -(-nchunks // nsplit)
    return SandwichPlan(tile, dc, nchunks, -(-nchunks // cps), cps)


def sandwich(x, y, c, ix=None, iy=None, ic=None):
    """out[b] = sum_l X_b[:, :, l] C_b[l] Y_b[:, :, l]^H (K15a).

    x (Nx, n, Cc, nl) and y (Ny, m, Cd, nl) complex64 or complex128,
    c (Nc, nl, Cc, Cd) real; batch item b takes x[ix[b]], y[iy[b]] and
    c[ic[b]] (an index left None is the identity, or all zeros for a batch
    of one; index tensors on the operands' device are used as they are,
    unchecked).  Returns (B, n, m) complex: out[b, i, j] = sum_{l, c, d}
    x[i, c, l] C[l, c, d] conj(y[j, d, l]).  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    rdt = backend.real_dtype(x.dtype)
    if c.dtype != rdt:
        c = c.to(rdt)
    if not backend.on_cuda(x, y, c):
        return sandwich_ref(x, y, c, ix, iy, ic)
    _, n, cc, nl = x.shape
    _, m, cd, _ = y.shape
    backend.require(x, "x", dtype=(torch.complex64, torch.complex128), ndim=4)
    backend.require(y, "y", dtype=x.dtype, shape=(y.shape[0], m, cd, nl))
    if c.dim() != 4 or tuple(c.shape[1:]) != (nl, cc, cd):
        raise ValueError(f"c: shape {tuple(c.shape)}, expected (Nc, {nl}, {cc}, {cd})")
    c = c.contiguous()  # the kernel reads C in this layout
    ix, iy, ic = _sandwich_indices(x, y, c, ix, iy, ic)
    nb = len(ix)
    if nb > 65535:
        raise ValueError(f"sandwich batch {nb} exceeds the launch grid's 65535")
    if not (nb and n and m and nl and cc and cd):
        return torch.zeros((nb, n, m), dtype=x.dtype, device=x.device)
    out = torch.empty((nb, n, m), dtype=x.dtype, device=x.device)
    plan = sandwich_plan(nb, n, m, cd, nl, backend.sm_count(x.device))
    fn = K15A.entry(
        "sandwich_c64" if x.dtype == torch.complex64 else "sandwich_c128", _SANDWICH_ARGS
    )
    backend.launch(
        K15A, fn, x.device,
        x.data_ptr(), y.data_ptr(), c.data_ptr(), out.data_ptr(),
        ix.data_ptr(), iy.data_ptr(), ic.data_ptr(),
        nb, n, m, cc, cd, nl, plan.tile, plan.dc, plan.nsplit, plan.cps,
    )
    return out


def band_covariance_projection(g, clarray, device=None):
    """Project every band's angular power spectrum into the KL basis.

    g (nkl, F, nl) complex: the KL modes rotated to the temperature sky
    basis at one m; clarray (nbands, nl, F, F) real band spectra.  Returns
    (nbands, nkl, nkl): proj[b, k, q] = sum_{l, f, h} g[k, f, l]
    C_b[l, f, h] conj(g[q, h, l]).
    """
    g = as_tensor(g, device)
    clarray = as_tensor(clarray, g.device)
    gb = g.contiguous()[None]
    return sandwich(gb, gb, clarray)


def _sky_cl(cl, like):
    """(P, Q, nl, F, G) -> (F*G, nl, P, Q) real blocks, one per (f, g)."""
    cl = as_tensor(cl, like.device).to(backend.real_dtype(like.dtype))
    p, q, nl, f, g = cl.shape
    return cl.permute(3, 4, 2, 0, 1).reshape(f * g, nl, p, q), f


def sky_covariance_projection(beam4, cl, device=None):
    """matf[f, a, g, b] = sum_{p, q, l} B[f, a, p, l] C[p, q, l, f, g]
    conj(B[g, b, q, l]); beam4 (F, A, P, nl) complex, cl real."""
    beam4 = as_tensor(beam4, device).contiguous()
    c, nf = _sky_cl(cl, beam4)
    out = sandwich(beam4, beam4, c, *sky_pair_index(1, nf, beam4.device))
    na = beam4.shape[1]
    return out.reshape(nf, nf, na, na).permute(0, 2, 1, 3)


def sky_covariance_projection_m(beam5, cl, device=None):
    """m-batched sky covariance projection: (M, F, S, P, nl) -> (M, F, S, F, S)."""
    beam5 = as_tensor(beam5, device).contiguous()
    nm, nf, ns = beam5.shape[:3]
    c, _ = _sky_cl(cl, beam5)
    flat = beam5.reshape((nm * nf,) + tuple(beam5.shape[2:]))
    out = sandwich(flat, flat, c, *sky_pair_index(nm, nf, beam5.device))
    return out.reshape(nm, nf, nf, ns, ns).permute(0, 1, 3, 2, 4)


# ------------------------------------------------------------------
# K15b: the weighted Fisher trace
# ------------------------------------------------------------------


def fisher_trace_ref(ca, cb, w):
    """Plain PyTorch version of :func:`fisher_trace`."""
    w = w.to(torch.float64)
    ww = w[..., :, None] * w[..., None, :]
    d = ca.to(torch.complex128) * ww[..., None, :, :]
    return torch.einsum("...aij,...bji->...ab", d, cb.to(torch.complex128))


# The launch plan of csrc/fisher_trace.cu: (i, j) tiles of TRACE_TILE a side,
# one job a warp at a time, TRACE_WARPS warps a block, band tiles of
# TRACE_BANDS a side per block, and at most TRACE_MAX_SPLIT blocks (a
# portable cluster) sharing one m's tiles.
TRACE_TILE = 8
TRACE_WARPS = 8
TRACE_BANDS = 4
TRACE_MAX_SPLIT = 8
_TRACE_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_TRACE_FNS = {
    (torch.complex64, torch.float32): "fisher_trace_c64_w32",
    (torch.complex64, torch.float64): "fisher_trace_c64_w64",
    (torch.complex128, torch.float32): "fisher_trace_c128_w32",
    (torch.complex128, torch.float64): "fisher_trace_c128_w64",
}


class TracePlan(NamedTuple):
    nt: int  # (i, j) tiles a side
    njobs: int  # tiles of one m: nt^2, or nt (nt + 1) / 2 for one stack
    pairs: int  # band-tile pairs (blocks of one m and one rank)
    split: int  # blocks of a cluster sharing an m's tiles


@functools.lru_cache(maxsize=256)
def fisher_trace_plan(nm: int, na: int, nb: int, k: int, sym: bool, sms: int) -> TracePlan:
    """The launch plan of one Fisher trace call.

    A job is one TRACE_TILE x TRACE_TILE (i, j) tile of one m: all nt^2
    tiles, or the tiles I <= J where C_a and C_b are one stack (``sym``,
    at most TRACE_BANDS bands).  The jobs of an m go round-robin to the
    TRACE_WARPS warps of each of the ``split`` blocks of a cluster, across
    the blocks first, sized so that nm x pairs x split blocks fill the
    card's ``sms`` with no block left without a job: 1 where one tile
    covers k.
    """
    nt = -(-k // TRACE_TILE)
    njobs = nt * (nt + 1) // 2 if sym else nt * nt
    pairs = -(-na // TRACE_BANDS) * -(-nb // TRACE_BANDS)
    split = max(1, min(TRACE_MAX_SPLIT, njobs, -(-sms // max(nm * pairs, 1))))
    return TracePlan(nt, njobs, pairs, split)


def fisher_trace(ca, cb, w):
    """F[a, b] = sum_ij w_i w_j C_a[i, j] C_b[j, i] (K15b).

    ca (na, k, k) and cb (nb, k, k) complex64 or complex128 stacks of
    projected band covariances, w (k,) real weights; or all three with one
    leading batch axis M.  Returns (na, nb) (or (M, na, nb)) complex128,
    accumulated in float64 whatever the input type.

    The second factor enters transposed, C_b[j, i], as in PSExact's trace
    tr(W C_a W C_b).  For Hermitian C_b that equals conj(C_b[i, j]), the
    form of the fused Fisher step, whose covariances K13 returns Hermitian
    bit for bit.  Where ca and cb are one tensor's storage (same pointer,
    shape and strides) of at most TRACE_BANDS bands, F is symmetric: the
    kernel reads the upper triangle of (i, j) tiles and writes F_ab and
    F_ba together.  CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    if not backend.on_cuda(ca, cb, w):
        return fisher_trace_ref(ca, cb, w)
    sym = (
        ca.data_ptr() == cb.data_ptr()
        and ca.shape == cb.shape
        and ca.stride() == cb.stride()
        and ca.shape[-3] <= TRACE_BANDS
    )
    batched = ca.dim() == 4
    if not batched:
        ca, cb, w = ca[None], cb[None], w[None]
    nm, na, k = ca.shape[0], ca.shape[1], ca.shape[-1]
    nb = cb.shape[1]
    backend.require(ca, "ca", dtype=(torch.complex64, torch.complex128), shape=(nm, na, k, k))
    backend.require(cb, "cb", dtype=ca.dtype, shape=(nm, nb, k, k))
    backend.require(w, "w", dtype=(torch.float32, torch.float64), shape=(nm, k))
    if not (k > 0 and na > 0 and nb > 0 and nm > 0):
        out = torch.zeros((nm, na, nb), dtype=torch.complex128, device=ca.device)
        return out if batched else out[0]
    if nm > 65535:
        raise ValueError(f"fisher trace batch {nm} exceeds the launch grid's 65535")
    # the kernel writes every entry
    out = torch.empty((nm, na, nb), dtype=torch.complex128, device=ca.device)
    plan = fisher_trace_plan(nm, na, nb, k, sym, backend.sm_count(ca.device))
    fn = K15B.entry(_TRACE_FNS[ca.dtype, w.dtype], _TRACE_ARGS)
    backend.launch(
        K15B, fn, ca.device,
        ca.data_ptr(), cb.data_ptr(), w.data_ptr(), out.data_ptr(), nm, na, nb, k,
        int(sym), plan.split,
    )
    return out if batched else out[0]


def fisher_trace_block(proj_a, proj_b, w, device=None):
    """F[a, b] = sum_ij C_a[i, j] C_b[j, i] w_i w_j for two band chunks;
    ``w`` the real inverse-covariance weights 1 / (1 + lambda).  Returns
    (chunk_a, chunk_b) complex128."""
    proj_a = as_tensor(proj_a, device)
    proj_b = as_tensor(proj_b, proj_a.device)
    w = as_tensor(w, proj_a.device).to(backend.real_dtype(proj_a.dtype))
    return fisher_trace(proj_a.contiguous(), proj_b.contiguous(), w.contiguous())


# ------------------------------------------------------------------
# Library compositions
# ------------------------------------------------------------------


def diag_noise_projection(beam_ut, dmat, device=None):
    """blocks[f, a, b] = sum_t U[f, a, t] d[f, t] conj(U[f, b, t]) (d real)."""
    beam_ut = as_tensor(beam_ut, device)
    dmat = as_tensor(dmat, beam_ut.device).to(beam_ut.dtype)
    return (beam_ut * dmat[:, None, :]) @ beam_ut.mH


def diag_noise_projection_m(beam_ut, dmat, device=None):
    """m-batched diagonal noise projection: (M, F, S, T), (F, T) -> (M, F, S, S)."""
    beam_ut = as_tensor(beam_ut, device)
    dmat = as_tensor(dmat, beam_ut.device).to(beam_ut.dtype)
    return (beam_ut * dmat[None, :, None, :]) @ beam_ut.mH


def block_matvec(mats, vecs, device=None):
    """Batched (block-diagonal) matrix @ vector: "fij,fj...->fi..."."""
    mats = as_tensor(mats, device)
    vecs = as_tensor(vecs, mats.device).to(mats.dtype)
    flat = vecs.reshape(vecs.shape[0], vecs.shape[1], -1)
    return (mats @ flat).reshape(mats.shape[:2] + tuple(vecs.shape[2:]))


def block_pinv(mats, rcond: float = 1e-6, device=None):
    """Batched pseudo-inverse of (possibly complex) blocks."""
    return torch.linalg.pinv(as_tensor(mats, device), rtol=rcond)


def triple_svd(bfm_w, npol: int, nl: int, polsvcut: float, device=None, mesh=None):
    """Triple-SVD compression of a batch of noise-weighted beams (batch,
    ntel, npol*nl) with the file pipeline's image cuts: (ut, beam, sig,
    nmodes), see :func:`linalg.triple_svd_batched`.  With a ``mesh`` of
    more than one entry the batch axis is split over its entries, each
    SVDing its own slice (:func:`_on_mesh`)."""
    def svd(b):
        return linalg.triple_svd_batched(
            b, npol=npol, nl=nl, polsvcut=polsvcut,
            floor1=linalg.FILE_SVD1_FLOOR, floor3=linalg.FILE_SVD3_FLOOR,
        )

    return _on_mesh(svd, as_tensor(bfm_w, device), mesh)


def simple_svd(bfm_w, device=None):
    """Plain thin SVD compression of a batch of beams (K18b, lib).

    bfm_w (batch, ntel, k).  Returns (ut (batch, kk, ntel) with ut = u^H,
    sig (batch, kk)), kk = min(ntel, k), complex128 / float64 tensors:
    the compression of ``BeamTransferTempSVD`` (Stokes I block) and
    ``BeamTransferFullSVD`` (the whole beam).  JAX ``ops/linalg.py:403``
    ``svd_simple_batched`` (a library SVD there too), through
    ``torch.linalg.svd`` (cuSOLVER on the card).
    """
    u, sig, _ = torch.linalg.svd(
        as_tensor(bfm_w, device, torch.complex128), full_matrices=False
    )
    return u.mH.contiguous().resolve_conj(), sig


def _on_mesh(fn, batch, mesh, *replicated):
    """``fn(batch, *replicated)``; with a ``mesh`` of more than one entry,
    on each entry's slice of the batch axis, padded to a multiple of the
    mesh size by repeating its last row (the JAX package's
    ``_kl_pencil_shard``), the results gathered on ``batch``'s device and
    trimmed (:func:`parallel.mesh.shard_map`)."""
    mesh = meshmod.multi(mesh)
    if mesh is None:
        return fn(batch, *replicated)
    return meshmod.shard_map(fn, mesh, sharded=(batch,), replicated=replicated, pad=True,
                             gather_to=batch.device)


def _projected_factors(bsvd5, ls, lf, nc, compact):
    """Signal and foreground factors of a beam batch, scaled by nc^-1/2."""
    from ..parallel import mstep

    scale = 1.0 / float(np.sqrt(nc))
    n = bsvd5.shape[1] * bsvd5.shape[2]
    ls_t = as_tensor(ls, bsvd5.device)
    if compact and mstep.uses_compact_signal(n, ls_t.shape[0] * ls_t.shape[-1]):
        a_s = fpencil.beam_factor_compact(bsvd5, ls_t)
    else:
        a_s = fpencil.beam_factor(bsvd5, ls_t)
    a_f = fpencil.beam_factor(bsvd5, lf)
    if scale != 1.0:
        a_s, a_f = a_s * scale, a_f * scale
    return a_s, a_f


def kl_factored_batched(
    bsvd5,
    ls,
    lf,
    nc: float = 1.0,
    with_thermal: bool = True,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    fg_floor: float = 1e-6,
    method: str = "qr",
    fg_reg_rel: float = 0.0,
    device=None,
    compact: bool = True,
    fg_levels: int = 8,
    mesh=None,
):
    """m-batched KL pencil solve on *factored* covariances.

    Solves ``S v = w (nc I + F) v`` per m with S and F given by their
    per-l factor tables (ops.fpencil) projected through the SVD beams,
    never forming the ill-conditioned dense covariances.

    bsvd5 (M, F, S, npol, nl) complex svcut-masked sky -> SVD projections;
    ls, lf (nl, npol, F, K) real factor tables; ``nc`` the scale of the
    (identity) projected instrumental noise.  Where the signal factor is
    wider than twice the pencil (``mstep.uses_compact_signal``) and
    ``compact`` is set, the signal side is re-factored to width n through
    the K9 Gram (the same S); the ``gram`` engine (``method``, with
    ``fg_levels`` foreground levels) takes the wide factor.  Returns
    (evals (M, n) ascending, evecs (M, n, n) complex columns) on the beams'
    device.  A ``mesh`` of more than one entry splits the m axis over its
    entries (:func:`_on_mesh`; ls, lf replicated).
    """
    def solve(b, ls, lf):
        a_s, a_f = _projected_factors(b, ls, lf, nc, compact and method == "qr")
        kl = fpencil.kl_solve(
            a_s, a_f, sig_levels=sig_levels, band_rel=band_rel, method=method,
            with_thermal=with_thermal, fg_floor=fg_floor, fg_reg_rel=fg_reg_rel,
            fg_levels=fg_levels,
        )
        return kl.evals, kl.evecs

    return _on_mesh(solve, as_tensor(bsvd5, device), mesh, ls, lf)


def kl_support_stats(evecs, row_mask):
    """Per column of each m's eigenbasis, the squared norm on the rows that
    ``row_mask`` (M, n) marks and the total squared norm: ((M, n), (M, n))."""
    p = evecs.real**2 + evecs.imag**2
    mask = as_tensor(row_mask, evecs.device).to(p.dtype)
    return torch.einsum("mij,mi->mj", p, mask), p.sum(dim=1)


def doublekl_factored_batched(
    bsvd5,
    ls,
    lf,
    nc: float = 1.0,
    nc1: float | None = None,
    fg_threshold: float = 100.0,
    fg_floor: float = 1e-6,
    fg_reg_rel: float = 1e-14,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    device=None,
    mesh=None,
):
    """m-batched two-stage (DoubleKL) factored pencil.

    Stage 1 solves the S/F pencil per m; stage 2 re-solves S/(nc I + F) on
    the modes whose S/F exceeds ``fg_threshold`` (dropped modes emerge
    with eigenvalue 0 and zero columns; the caller compacts with
    ``nkept``), see :func:`fpencil.doublekl_solve_qr`.  Returns (f_evals
    (M, n) ascending, evals (M, n) ascending, evecs (M, n, n) complex
    columns, nkept (M,) int).  A ``mesh`` of more than one entry splits the
    m axis over its entries (:func:`_on_mesh`).
    """
    def solve(b, ls, lf):
        a_s, a_f = _projected_factors(b, ls, lf, nc, compact=False)
        return fpencil.doublekl_solve_qr(
            a_s, a_f,
            fg_threshold=fg_threshold,
            fg_floor=fg_floor,
            nc1=None if nc1 is None else float(nc1 / nc),
            fg_reg_rel=fg_reg_rel,
            sig_levels=sig_levels,
            band_rel=band_rel,
        )

    return _on_mesh(solve, as_tensor(bsvd5, device), mesh, ls, lf)


def _topband_k(k: int, n: int) -> int:
    """The top-band basis width: ``k``, or max(n // 8, 8) for 0, at most n."""
    return int(min(k or max(n // 8, 8), n))


def kl_factored_batched_topband(
    bsvd5,
    ls,
    lf,
    cut: float,
    nc: float = 1.0,
    k: int = 0,
    levels: int = 6,
    fg_reg_rel: float = 0.0,
    device=None,
    mesh=None,
):
    """m-batched retained-band KL solve (fpencil.kl_solve_qr_topband).

    The conventions of :func:`kl_factored_batched`, but only the eigenpairs
    with eigenvalue >= ``cut`` (the caller's KL retention threshold) are
    computed; everything below is exact zeros with zero eigenvector
    columns.  The signal factor is not compacted.  ``k`` 0 sizes the
    filter basis at max(n // 8, 8) columns.  Returns (evals (M, n), evecs
    (M, n, n), ok (M,) bool): a False certificate means that m's band
    overflowed the basis or the levels; re-solve it with the exact engine.
    A ``mesh`` of more than one entry splits the m axis over its entries
    (:func:`_on_mesh`), the certificates gathered per m.
    """
    def solve(b, ls, lf):
        a_s, a_f = _projected_factors(b, ls, lf, nc, compact=False)
        kl, ok = fpencil.kl_solve_qr_topband(
            a_s, a_f, cut=cut, k=_topband_k(k, a_s.shape[-2]), levels=int(levels),
            fg_reg_rel=fg_reg_rel,
        )
        return kl.evals, kl.evecs, ok

    return _on_mesh(solve, as_tensor(bsvd5, device), mesh, ls, lf)


def doublekl_factored_batched_topband(
    bsvd5,
    ls,
    lf,
    cut: float,
    nc: float = 1.0,
    nc1: float | None = None,
    fg_threshold: float = 100.0,
    fg_floor: float = 1e-6,
    fg_reg_rel: float = 1e-14,
    k: int = 0,
    levels: int = 6,
    device=None,
    mesh=None,
):
    """m-batched two-stage DoubleKL through the top-band engine
    (fpencil.doublekl_solve_qr_topband): the outputs of
    :func:`doublekl_factored_batched` and a trailing per-m ``ok`` (both
    stages' certificates).  Stage 1 computes only the modes it keeps (S/F
    above ``fg_threshold``), stage 2 those above ``cut``; everything below
    either cut is exact zeros.  A ``mesh`` of more than one entry splits
    the m axis over its entries (:func:`_on_mesh`)."""
    def solve(b, ls, lf):
        a_s, a_f = _projected_factors(b, ls, lf, nc, compact=False)
        return fpencil.doublekl_solve_qr_topband(
            a_s, a_f,
            cut=cut,
            k=_topband_k(k, a_s.shape[-2]),
            levels=int(levels),
            fg_threshold=fg_threshold,
            fg_floor=fg_floor,
            nc1=None if nc1 is None else float(nc1 / nc),
            fg_reg_rel=fg_reg_rel,
        )

    return _on_mesh(solve, as_tensor(bsvd5, device), mesh, ls, lf)


def generalised_eigh_batched(A, B, device=None):
    """m-batched generalised Hermitian eigensolve: A, B (M, n, n) ->
    (w (M, n) ascending, v (M, n, n) columns)."""
    A = as_tensor(A, device)
    w, v, _ = linalg.eigh_gen_batched(A, as_tensor(B, A.device))
    return w, v


def generalised_eigh(A, B, message: str = "", device=None):
    """Generalised Hermitian eigensolve with the regularisation fallback:
    (evals, evecs columns, add_const), see :func:`linalg.eigh_gen`."""
    A = as_tensor(A, device)
    return linalg.eigh_gen(A, as_tensor(B, A.device), message=message)
