"""K1+K2: cylinder beams from bank rows fused with the visibility maps (Triton).

Replaces the JAX programs ``driftscan_tpu/telescope/cylbeam.py``
``_beam_device_kernel`` / ``_beam_bank_kernel`` (the per-pixel beam) and
``driftscan_tpu/ops/kernels.py`` ``unpol_visibility_map_split`` (solid
angles, fringe and the normalised map).  Plain version:
``driftscan_tpu_torch.ops.kernels.bank_visibility_maps_ref``.

Two passes over the ring-padded pixel grid:

1. ``_omega_kernel``, grid (pixel blocks, bank rows): each program
   evaluates one beam row over a pixel block and adds its block sum of
   |B|^2 h to that row's solid angle (one float atomic per program);
2. ``_map_kernel``, grid (pixel blocks, units): each program re-evaluates
   B_i and B_j for its unit over a pixel block, forms the fringe and
   writes h B_i B_j e^{2 pi i u.n} / sqrt(Omega_i Omega_j) as interleaved
   (re, im) pairs.

What bounds it on an H100: memory bandwidth.  The map is the only large
array (8 bytes a pixel a unit in complex64); the pixel grid (16 bytes a
pixel) and the table rows (a few KB, L1/L2 resident) are re-read per
unit.  Re-evaluating the beams in pass 2 costs arithmetic the card has
in excess, and saves writing and reading a per-unit beam array, which the
JAX program materialises.  The fringe's turns u.n are formed in float64
and reduced to [-1/2, 1/2) before the float32 angle, so the cos/sin
argument is always within [-pi, pi).

This module imports ``triton`` at the top: import it only from the
launching function.
"""

import triton
import triton.language as tl
import triton.language.extra.libdevice as tld

BLOCK = 1024


@triton.jit
def _beam(cx, cy, cz, h, fx_row, par_row, alpha, nfx):
    """Bank-row beam at a block of pixels (port of _beam_device_kernel)."""
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
def _omega_kernel(cart_ptr, hor_ptr, fx_ptr, par_ptr, alpha_ptr, om_ptr,
                  npix, nfx, BLOCK: tl.constexpr):
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
    tl.atomic_add(om_ptr + row, tl.sum(b * b * h, axis=0))


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

    # fringe: turns u.n in float64, reduced to [-1/2, 1/2)
    turns = (
        cx.to(tl.float64) * tl.load(uv_ptr + u * 3 + 0)
        + cy.to(tl.float64) * tl.load(uv_ptr + u * 3 + 1)
        + cz.to(tl.float64) * tl.load(uv_ptr + u * 3 + 2)
    )
    shifted = turns + 0.5
    fl = shifted.to(tl.int64).to(tl.float64)
    fl = tl.where(fl > shifted, fl - 1.0, fl)
    phase = (turns - fl).to(cx.dtype) * 6.283185307179586
    re = amp * tld.cos(phase)
    im = amp * tld.sin(phase)
    base = out_ptr + (u.to(tl.int64) * npix + offs) * 2
    tl.store(base, re, mask=m)
    tl.store(base + 1, im, mask=m)


def launch(cart, horizon, fx, par, alpha, idx_i, idx_j, uv3, omega, out_ri, pxarea):
    """Run both passes on the current stream; arguments validated by the
    wrapper (``ops.kernels.bank_visibility_maps``)."""
    npix = cart.shape[0]
    nb, nfx = fx.shape
    nu = idx_i.shape[0]
    nblk = triton.cdiv(npix, BLOCK)
    _omega_kernel[(nblk, nb)](
        cart, horizon, fx, par, alpha, omega, npix, nfx, BLOCK=BLOCK, num_warps=8
    )
    _map_kernel[(nblk, nu)](
        cart, horizon, fx, par, alpha, omega, idx_i, idx_j, uv3, out_ri,
        npix, nfx, pxarea, BLOCK=BLOCK, num_warps=8,
    )
