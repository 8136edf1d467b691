"""K1+K2: cylinder beams from bank rows fused with the visibility maps (Triton).

Replaces the JAX programs ``driftscan_tpu/telescope/cylbeam.py``
``_beam_device_kernel`` / ``_beam_bank_kernel`` (the per-pixel beam, with
the dipole ``polpattern`` of ``driftscan_tpu/ops/kernels.py`` for
polarised feeds) and ``driftscan_tpu/ops/kernels.py``
``unpol_visibility_map_split`` / ``stokes_visibility_map_split`` (solid
angles, fringe and the normalised maps).  Plain versions:
``driftscan_tpu_torch.ops.kernels.bank_visibility_maps_ref`` and
``bank_stokes_maps_ref``.

Two passes over the ring-padded pixel grid:

1. ``_omega_kernel``, grid (pixel blocks, bank rows): each program
   evaluates one beam row over a pixel block and adds its block sum of
   |B|^2 h to that row's solid angle (one float atomic per program);
2. ``_map_kernel`` (scalar beams) or ``_stokes_kernel`` (dipole beams),
   grid (pixel blocks, units): each program re-evaluates B_i and B_j for
   its unit over a pixel block, forms the fringe and writes
   h B_i conj(B_j) e^{2 pi i u.n} / sqrt(Omega_i Omega_j) -- or its
   Stokes I, Q, U, V -- as interleaved (re, im) pairs.

A dipole beam is its amplitude times the unit projection p of the
dipole axis on the local (theta_hat, phi_hat) plane.  The frame is formed
from the cartesian n (rho = |(n_x, n_y)|, cos phi = n_x / rho, sin phi =
n_y / rho), not through arccos/arctan2, which lose float32 precision
near the pole; at rho = 0 it is phi = 0, and a dipole along n gets p = 0,
never 0/0.  Ring-padding slots have h = 0, so nothing formed there may
be NaN: every division is guarded before it is taken.

What bounds it on an H100: memory bandwidth.  The map is the only large
array (8 bytes a pixel a unit a Stokes component in complex64); the
pixel grid (16 bytes a pixel) and the table rows (a few KB, L1/L2
resident) are re-read per unit.  Re-evaluating the beams in pass 2 costs
arithmetic the card has in excess, and saves writing and reading a
per-unit beam array, which the JAX program materialises.  The fringe's
turns u.n are formed in float64 and reduced to [-1/2, 1/2) before the
float32 angle, so the cos/sin argument is always within [-pi, pi).

This module imports ``triton`` at the top: import it only from the
launching function.
"""

import triton
import triton.language as tl
import triton.language.extra.libdevice as tld

BLOCK = 1024


@triton.jit
def _beam(cx, cy, cz, h, fx_row, par_row, alpha, nfx):
    """Bank-row beam amplitude at a block of pixels (port of _beam_device_kernel)."""
    kx0 = tl.load(par_row + 0)
    inv_step = tl.load(par_row + 1)
    x = cx * tl.load(par_row + 3) + cy * tl.load(par_row + 4) + cz * tl.load(par_row + 5)
    y = cx * tl.load(par_row + 6) + cy * tl.load(par_row + 7) + cz * tl.load(par_row + 8)
    t = (x - kx0) * inv_step
    # clip(floor(t), 0, nfx - 2): truncation equals floor for t >= 0
    i0 = tl.minimum(tl.maximum(t, 0.0).to(tl.int32), nfx - 2)
    frac = t - i0.to(t.dtype)
    f0 = tl.load(fx_row + i0)
    f1 = tl.load(fx_row + i0 + 1)
    ew = f0 * (1.0 - frac) + f1 * frac
    st2 = y * y
    # the plain version's 1e-100 guard is 0.0 in float32
    tan2 = st2 / (1.0 - st2)
    ns = tl.exp(-alpha * tan2)
    return ew * ns * h


@triton.jit
def _frame(cx, cy):
    """(rho, cos phi, sin phi) of the pixels; phi = 0 at a pole."""
    rho = tl.sqrt(cx * cx + cy * cy)
    pole = rho == 0.0
    safe = tl.where(pole, 1.0, rho)
    cp = tl.where(pole, 1.0, cx / safe)
    sp = tl.where(pole, 0.0, cy / safe)
    return rho, cp, sp


@triton.jit
def _polvec(cz, rho, cp, sp, par_row):
    """Unit (theta_hat, phi_hat) components of the row's dipole (par[9:12])."""
    dx = tl.load(par_row + 9)
    dy = tl.load(par_row + 10)
    dz = tl.load(par_row + 11)
    vt = cz * cp * dx + cz * sp * dy - rho * dz
    vp = cp * dy - sp * dx
    norm = tl.sqrt(vt * vt + vp * vp)
    ok = norm > 0.0
    inv = tl.where(ok, 1.0 / tl.where(ok, norm, 1.0), 0.0)
    return vt * inv, vp * inv


@triton.jit
def _fringe(cx, cy, cz, uv_row):
    """(cos, sin) of 2 pi u.n; turns in float64, reduced to [-1/2, 1/2)."""
    turns = (
        cx.to(tl.float64) * tl.load(uv_row + 0)
        + cy.to(tl.float64) * tl.load(uv_row + 1)
        + cz.to(tl.float64) * tl.load(uv_row + 2)
    )
    shifted = turns + 0.5
    fl = shifted.to(tl.int64).to(tl.float64)
    fl = tl.where(fl > shifted, fl - 1.0, fl)
    phase = (turns - fl).to(cx.dtype) * 6.283185307179586
    return tld.cos(phase), tld.sin(phase)


@triton.jit
def _omega_kernel(cart_ptr, hor_ptr, fx_ptr, par_ptr, alpha_ptr, om_ptr,
                  npix, nfx, POLARISED: tl.constexpr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    row = tl.program_id(1)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    m = offs < npix
    cx = tl.load(cart_ptr + offs * 3 + 0, mask=m, other=0.0)
    cy = tl.load(cart_ptr + offs * 3 + 1, mask=m, other=0.0)
    cz = tl.load(cart_ptr + offs * 3 + 2, mask=m, other=0.0)
    h = tl.load(hor_ptr + offs, mask=m, other=0.0)
    alpha = tl.load(alpha_ptr + row)
    b = _beam(cx, cy, cz, h, fx_ptr + row * nfx, par_ptr + row * 12, alpha, nfx)
    w = b * b * h
    if POLARISED:
        rho, cp, sp = _frame(cx, cy)
        pt, pp = _polvec(cz, rho, cp, sp, par_ptr + row * 12)
        w = w * (pt * pt + pp * pp)
    tl.atomic_add(om_ptr + row, tl.sum(w, axis=0))


@triton.jit
def _map_kernel(cart_ptr, hor_ptr, fx_ptr, par_ptr, alpha_ptr, om_ptr,
                ii_ptr, jj_ptr, uv_ptr, out_ptr, npix, nfx, pxarea,
                BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    u = tl.program_id(1)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    m = offs < npix
    cx = tl.load(cart_ptr + offs * 3 + 0, mask=m, other=0.0)
    cy = tl.load(cart_ptr + offs * 3 + 1, mask=m, other=0.0)
    cz = tl.load(cart_ptr + offs * 3 + 2, mask=m, other=0.0)
    h = tl.load(hor_ptr + offs, mask=m, other=0.0)

    ri = tl.load(ii_ptr + u)
    rj = tl.load(jj_ptr + u)
    bi = _beam(cx, cy, cz, h, fx_ptr + ri * nfx, par_ptr + ri * 12,
               tl.load(alpha_ptr + ri), nfx)
    bj = _beam(cx, cy, cz, h, fx_ptr + rj * nfx, par_ptr + rj * 12,
               tl.load(alpha_ptr + rj), nfx)
    om_i = tl.load(om_ptr + ri) * pxarea
    om_j = tl.load(om_ptr + rj) * pxarea
    amp = bi * bj * h * (1.0 / tl.sqrt(om_i * om_j))

    c, s = _fringe(cx, cy, cz, uv_ptr + u * 3)
    base = out_ptr + (u.to(tl.int64) * npix + offs) * 2
    tl.store(base, amp * c, mask=m)
    tl.store(base + 1, amp * s, mask=m)


@triton.jit
def _stokes_kernel(cart_ptr, hor_ptr, fx_ptr, par_ptr, alpha_ptr, om_ptr,
                   ii_ptr, jj_ptr, uv_ptr, out_ptr, npix, nfx, pxarea,
                   NPOL: tl.constexpr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    u = tl.program_id(1)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    m = offs < npix
    cx = tl.load(cart_ptr + offs * 3 + 0, mask=m, other=0.0)
    cy = tl.load(cart_ptr + offs * 3 + 1, mask=m, other=0.0)
    cz = tl.load(cart_ptr + offs * 3 + 2, mask=m, other=0.0)
    h = tl.load(hor_ptr + offs, mask=m, other=0.0)

    ri = tl.load(ii_ptr + u)
    rj = tl.load(jj_ptr + u)
    bi = _beam(cx, cy, cz, h, fx_ptr + ri * nfx, par_ptr + ri * 12,
               tl.load(alpha_ptr + ri), nfx)
    bj = _beam(cx, cy, cz, h, fx_ptr + rj * nfx, par_ptr + rj * 12,
               tl.load(alpha_ptr + rj), nfx)
    rho, cp, sp = _frame(cx, cy)
    pti, ppi = _polvec(cz, rho, cp, sp, par_ptr + ri * 12)
    ptj, ppj = _polvec(cz, rho, cp, sp, par_ptr + rj * 12)
    om_i = tl.load(om_ptr + ri) * pxarea
    om_j = tl.load(om_ptr + rj) * pxarea
    amp = bi * bj * h * (1.0 / tl.sqrt(om_i * om_j))

    c, s = _fringe(cx, cy, cz, uv_ptr + u * 3)
    # beams are real, so conj(B_j) = B_j
    tt = pti * ptj
    pp = ppi * ppj
    base = out_ptr + (u.to(tl.int64) * NPOL * npix + offs) * 2
    a = amp * (tt + pp)  # I
    tl.store(base, a * c, mask=m)
    tl.store(base + 1, a * s, mask=m)
    if NPOL > 1:  # Q
        a = amp * (tt - pp)
        tl.store(base + 2 * npix, a * c, mask=m)
        tl.store(base + 2 * npix + 1, a * s, mask=m)
    if NPOL > 2:  # U
        a = amp * (pti * ppj + ppi * ptj)
        tl.store(base + 4 * npix, a * c, mask=m)
        tl.store(base + 4 * npix + 1, a * s, mask=m)
    if NPOL > 3:  # V = i tc (tp - pt)
        a = amp * (pti * ppj - ppi * ptj)
        tl.store(base + 6 * npix, -a * s, mask=m)
        tl.store(base + 6 * npix + 1, a * c, mask=m)


def launch(cart, horizon, fx, par, alpha, idx_i, idx_j, uv3, omega, out_ri, pxarea):
    """Run both passes of the scalar maps on the current stream; arguments
    validated by the wrapper (``ops.kernels.bank_visibility_maps``)."""
    npix = cart.shape[0]
    nb, nfx = fx.shape
    nu = idx_i.shape[0]
    nblk = triton.cdiv(npix, BLOCK)
    _omega_kernel[(nblk, nb)](
        cart, horizon, fx, par, alpha, omega, npix, nfx, POLARISED=False,
        BLOCK=BLOCK, num_warps=8,
    )
    _map_kernel[(nblk, nu)](
        cart, horizon, fx, par, alpha, omega, idx_i, idx_j, uv3, out_ri,
        npix, nfx, pxarea, BLOCK=BLOCK, num_warps=8,
    )


def launch_stokes(cart, horizon, fx, par, alpha, idx_i, idx_j, uv3, omega, out_ri,
                  pxarea):
    """Run both passes of the Stokes maps on the current stream; ``out_ri``
    is (nu, npol, npix, 2).  Arguments validated by the wrapper
    (``ops.kernels.bank_stokes_maps``)."""
    npix = cart.shape[0]
    nb, nfx = fx.shape
    nu, npol = out_ri.shape[0], out_ri.shape[1]
    nblk = triton.cdiv(npix, BLOCK)
    _omega_kernel[(nblk, nb)](
        cart, horizon, fx, par, alpha, omega, npix, nfx, POLARISED=True,
        BLOCK=BLOCK, num_warps=8,
    )
    _stokes_kernel[(nblk, nu)](
        cart, horizon, fx, par, alpha, omega, idx_i, idx_j, uv3, out_ri,
        npix, nfx, pxarea, NPOL=npol, BLOCK=BLOCK, num_warps=8,
    )
