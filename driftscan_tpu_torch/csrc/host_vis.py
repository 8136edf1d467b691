"""K2 on host-evaluated beams: solid angles and visibility / Stokes maps (Triton).

Replaces the JAX programs ``driftscan_tpu/ops/kernels.py``
``unpol_visibility_map`` (:189) and ``stokes_visibility_map`` (:196), with
the ``fringe`` (:41), ``beam_solid_angle`` (:72), ``unpolarised_visibility``
(:84) and ``stokes_visibility`` (:101) they fuse: the maps of every
telescope whose beams are arrays evaluated on the host rather than cylinder
bank rows (dish arrays, GMRT, focal planes, cylinders that override their
beam, and every cylinder in double precision).  Plain versions:
``driftscan_tpu_torch.ops.kernels.host_visibility_maps_ref`` and
``host_stokes_maps_ref``.

The inputs are the batch's unique beams, (nb, npix) scalar or (nb, npix, 2)
(theta_hat, phi_hat) field patterns on the ring-padded pixel grid, real or
complex (complex ones as interleaved (re, im) pairs), on a float32 or a
float64 grid: constexpr flags select the form, one source serves all.
Unlike the bank kernel's, these beams need not be real, so B_j is
conjugated in every product.

Two passes:

1. ``_omega_kernel``, grid (pixel blocks, beams): each program writes its
   block sum of |B|^2 h (both components of a field pattern) to a (beams,
   blocks) scratch; ``beam_vis._row_sum_kernel`` then sums each beam's
   partials in a fixed order into its solid angle, so the maps repeat
   bitwise from run to run;
2. ``_map_kernel`` (scalar) or ``_stokes_kernel`` (field patterns), grid
   (pixel blocks, units): each program reads B_i and B_j of its unit over
   a pixel block, forms the fringe (``beam_vis._fringe``: turns in float64
   reduced to [-1/2, 1/2)) and writes h B_i conj(B_j) e^{2 pi i u.n} /
   sqrt(Omega_i Omega_j), or its Stokes I, Q, U, V, as interleaved (re,
   im) pairs.

What bounds it on an H100: memory bandwidth.  The maps are the large
array (8 or 16 bytes a pixel a unit a Stokes component); the grid and the
unique beams are read once a unit and mostly hit L2, since consecutive
units of a batch share their beams.  The arithmetic (a few products and a
sincos a pixel) is far below the card's rate in either precision.  The
pixel area is read from a one-element tensor of the grid's type, since a
Python float reaches a Triton kernel as float32.

This module imports ``triton`` at the top: import it only from the
launching function.
"""

import torch
import triton
import triton.language as tl

from .beam_vis import _fringe, omega_sums

BLOCK = 1024


@triton.jit
def _cmulc(ar, ai, br, bi):
    """a conj(b) as (re, im)."""
    return ar * br + ai * bi, ai * br - ar * bi


@triton.jit
def _component(ptr, m, OFF: tl.constexpr, COMPLEX: tl.constexpr):
    """(re, im) of a beam component at the pixel addresses ``ptr`` (+ OFF)."""
    re = tl.load(ptr + OFF, mask=m, other=0.0)
    if COMPLEX:
        im = tl.load(ptr + OFF + 1, mask=m, other=0.0)
    else:
        im = tl.zeros_like(re)
    return re, im


@triton.jit
def _omega_kernel(beam_ptr, hor_ptr, part_ptr, npix, NCOMP: tl.constexpr,
                  CSTRIDE: tl.constexpr, COMPLEX: tl.constexpr,
                  BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    b = tl.program_id(1).to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    m = offs < npix
    h = tl.load(hor_ptr + offs, mask=m, other=0.0)
    ptr = beam_ptr + (b * npix + offs) * (NCOMP * CSTRIDE)
    re, im = _component(ptr, m, 0, COMPLEX)
    w = re * re + im * im
    if NCOMP == 2:
        re, im = _component(ptr, m, CSTRIDE, COMPLEX)
        w += re * re + im * im
    tl.store(part_ptr + b * tl.num_programs(0) + pid, tl.sum(w * h, axis=0))


@triton.jit
def _pixels(cart_ptr, hor_ptr, offs, m):
    cx = tl.load(cart_ptr + offs * 3 + 0, mask=m, other=0.0)
    cy = tl.load(cart_ptr + offs * 3 + 1, mask=m, other=0.0)
    cz = tl.load(cart_ptr + offs * 3 + 2, mask=m, other=0.0)
    h = tl.load(hor_ptr + offs, mask=m, other=0.0)
    return cx, cy, cz, h


@triton.jit
def _map_kernel(cart_ptr, hor_ptr, beam_ptr, om_ptr, px_ptr, ii_ptr, jj_ptr,
                uv_ptr, out_ptr, npix, CSTRIDE: tl.constexpr,
                COMPLEX: tl.constexpr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    u = tl.program_id(1)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    m = offs < npix
    cx, cy, cz, h = _pixels(cart_ptr, hor_ptr, offs, m)

    bi = tl.load(ii_ptr + u)
    bj = tl.load(jj_ptr + u)
    ir, ii = _component(beam_ptr + (bi * npix + offs) * CSTRIDE, m, 0, COMPLEX)
    jr, ji = _component(beam_ptr + (bj * npix + offs) * CSTRIDE, m, 0, COMPLEX)
    px = tl.load(px_ptr)
    om_i = tl.load(om_ptr + bi) * px
    om_j = tl.load(om_ptr + bj) * px
    amp = h * (1.0 / tl.sqrt(om_i * om_j))
    pr, pi = _cmulc(ir, ii, jr, ji)

    c, s = _fringe(cx, cy, cz, uv_ptr + u * 3)
    base = out_ptr + (u.to(tl.int64) * npix + offs) * 2
    tl.store(base, amp * (pr * c - pi * s), mask=m)
    tl.store(base + 1, amp * (pr * s + pi * c), mask=m)


@triton.jit
def _store_stokes(ptr, ar, ai, c, s, m):
    """Store (ar + i ai) (c + i s) at ptr as (re, im)."""
    tl.store(ptr, ar * c - ai * s, mask=m)
    tl.store(ptr + 1, ar * s + ai * c, mask=m)


@triton.jit
def _stokes_kernel(cart_ptr, hor_ptr, beam_ptr, om_ptr, px_ptr, ii_ptr, jj_ptr,
                   uv_ptr, out_ptr, npix, NPOL: tl.constexpr,
                   CSTRIDE: tl.constexpr, COMPLEX: tl.constexpr,
                   BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    u = tl.program_id(1)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    m = offs < npix
    cx, cy, cz, h = _pixels(cart_ptr, hor_ptr, offs, m)

    bi = tl.load(ii_ptr + u)
    bj = tl.load(jj_ptr + u)
    pi_ = beam_ptr + (bi * npix + offs) * (2 * CSTRIDE)
    pj_ = beam_ptr + (bj * npix + offs) * (2 * CSTRIDE)
    itr, iti = _component(pi_, m, 0, COMPLEX)
    ipr, ipi = _component(pi_, m, CSTRIDE, COMPLEX)
    jtr, jti = _component(pj_, m, 0, COMPLEX)
    jpr, jpi = _component(pj_, m, CSTRIDE, COMPLEX)
    px = tl.load(px_ptr)
    om_i = tl.load(om_ptr + bi) * px
    om_j = tl.load(om_ptr + bj) * px
    amp = h * (1.0 / tl.sqrt(om_i * om_j))

    # conj on beam j: tt = B_it conj(B_jt), ...
    ttr, tti = _cmulc(itr, iti, jtr, jti)
    ppr, ppi = _cmulc(ipr, ipi, jpr, jpi)
    tpr, tpi = _cmulc(itr, iti, jpr, jpi)
    ptr_, pti = _cmulc(ipr, ipi, jtr, jti)

    c, s = _fringe(cx, cy, cz, uv_ptr + u * 3)
    c = amp * c
    s = amp * s
    base = out_ptr + (u.to(tl.int64) * NPOL * npix + offs) * 2
    _store_stokes(base, ttr + ppr, tti + ppi, c, s, m)  # I = tc (tt + pp)
    if NPOL > 1:  # Q = tc (tt - pp)
        _store_stokes(base + 2 * npix, ttr - ppr, tti - ppi, c, s, m)
    if NPOL > 2:  # U = tc (tp + pt)
        _store_stokes(base + 4 * npix, tpr + ptr_, tpi + pti, c, s, m)
    if NPOL > 3:  # V = i tc (tp - pt)
        _store_stokes(base + 6 * npix, pti - tpi, tpr - ptr_, c, s, m)


def _solid_angles(beams_r, horizon, ncomp, is_complex):
    """Both steps of pass 1; returns the (nb,) raw solid angles (no pxarea)."""
    nb, npix = beams_r.shape[0], horizon.shape[0]
    nblk = triton.cdiv(npix, BLOCK)
    part = torch.empty((nb, nblk), dtype=horizon.dtype, device=horizon.device)
    omega = torch.empty(nb, dtype=horizon.dtype, device=horizon.device)
    _omega_kernel[(nblk, nb)](
        beams_r, horizon, part, npix, NCOMP=ncomp, CSTRIDE=2 if is_complex else 1,
        COMPLEX=is_complex, BLOCK=BLOCK, num_warps=8,
    )
    omega_sums(part, omega)
    return omega


def launch(cart, horizon, beams_r, is_complex, idx_i, idx_j, uv3, pxarea, out_ri):
    """Scalar maps, both passes, on the current stream.  ``beams_r`` is the
    (nb, npix) real beams or the (nb, npix, 2) real view of complex ones;
    ``out_ri`` the (nu, npix, 2) real view of the maps.  Arguments
    validated by the wrapper (``ops.kernels.host_visibility_maps``)."""
    npix, nu = horizon.shape[0], idx_i.shape[0]
    omega = _solid_angles(beams_r, horizon, 1, is_complex)
    px = torch.full((1,), pxarea, dtype=horizon.dtype, device=horizon.device)
    _map_kernel[(triton.cdiv(npix, BLOCK), nu)](
        cart, horizon, beams_r, omega, px, idx_i, idx_j, uv3, out_ri, npix,
        CSTRIDE=2 if is_complex else 1, COMPLEX=is_complex, BLOCK=BLOCK,
        num_warps=8,
    )


def launch_stokes(cart, horizon, beams_r, is_complex, idx_i, idx_j, uv3, pxarea,
                  out_ri):
    """Stokes maps, both passes, on the current stream.  ``beams_r`` is the
    (nb, npix, 2) real field patterns or the (nb, npix, 2, 2) real view of
    complex ones; ``out_ri`` the (nu, npol, npix, 2) real view of the maps.
    Arguments validated by the wrapper (``ops.kernels.host_stokes_maps``)."""
    npix, nu, npol = horizon.shape[0], idx_i.shape[0], out_ri.shape[1]
    omega = _solid_angles(beams_r, horizon, 2, is_complex)
    px = torch.full((1,), pxarea, dtype=horizon.dtype, device=horizon.device)
    _stokes_kernel[(triton.cdiv(npix, BLOCK), nu)](
        cart, horizon, beams_r, omega, px, idx_i, idx_j, uv3, out_ri, npix,
        NPOL=npol, CSTRIDE=2 if is_complex else 1, COMPLEX=is_complex,
        BLOCK=BLOCK, num_warps=8,
    )
