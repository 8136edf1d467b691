"""Beam and fringe pixel kernels, and the fused beam/visibility-map kernels.

Port of ``driftscan_tpu/ops/kernels.py`` plus the per-pixel cylinder
beam of ``driftscan_tpu/telescope/cylbeam.py``.  The hot program of the
BTM phase evaluates, for every (baseline, frequency) unit, the
visibility transfer map

    V(n) = h(n) B_i(n) conj(B_j(n)) exp(2 pi i u.n) / sqrt(Omega_i Omega_j)

over the ring-padded pixel grid, with the beams B given by bank rows (a
uniform-grid Fraunhofer table in the E-W direction times an ExpTan
profile N-S, times the horizon h).  :func:`bank_visibility_maps` runs it
as one hand-written CUDA C++ kernel (solid angles, then the maps, with the
beams formed in the block); :func:`bank_visibility_maps_ref` is its plain
PyTorch version.

Polarised telescopes give each beam a dipole polarisation pattern (a unit
vector in the (theta_hat, phi_hat) basis) and form the Stokes I/Q/U/V
maps of each feed pair instead: :func:`bank_stokes_maps` (CUDA C++) and
:func:`bank_stokes_maps_ref` (plain).

Telescopes whose beams are evaluated on the host (any beam that is not a
cylinder bank row) hand the batch's unique beam arrays to
:func:`host_visibility_maps` / :func:`host_stokes_maps` (K2 alone, CUDA C++;
plain versions :func:`host_visibility_maps_ref` / :func:`host_stokes_maps_ref`).
Both kernels share one map pass, ``csrc/vis_map.cuh``, and differ in where
the beams come from.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import backend

# Fused K1 (beam from bank rows) + K2 (normalised visibility map).
K1K2 = backend.register(
    "k1k2_beam_vis",
    "driftscan_tpu_torch/csrc/bank_vis.cu",
    "driftscan_tpu/telescope/cylbeam.py:133 + driftscan_tpu/ops/kernels.py:203",
)

# The polarised variant: dipole pattern (K19) + Stokes maps (K2).
K1K2_STOKES = backend.register(
    "k1k2_stokes_vis",
    "driftscan_tpu_torch/csrc/bank_vis.cu",
    "driftscan_tpu/telescope/cylbeam.py:133 + driftscan_tpu/ops/kernels.py:214"
    " + driftscan_tpu/ops/kernels.py:297",
)

# K2 on host-evaluated beams: solid angles + normalised visibility maps.
K2_HOST = backend.register(
    "k2_host_vis",
    "driftscan_tpu_torch/csrc/host_vis.cu",
    "driftscan_tpu/ops/kernels.py:189 (+ :41, :72, :84)",
)

# Its Stokes form: solid angles + Stokes I/Q/U/V maps of field patterns.
K2_HOST_STOKES = backend.register(
    "k2_host_stokes",
    "driftscan_tpu_torch/csrc/host_vis.cu",
    "driftscan_tpu/ops/kernels.py:196 (+ :41, :72, :101)",
)

# The map pass of csrc/vis_map.cuh (K2-host and K1+K2): pixels a block, and
# the pixels a block of its solid-angle pass sums (the partials' scratch is
# sized from it).  A block stages its pixels of as many unique beams as
# HOST_VIS_STAGE_BYTES of shared memory hold (two blocks an SM), and more in
# groups of that many.
HOST_VIS_TILE = 512
HOST_VIS_OMEGA_TILE = 1024
HOST_VIS_STAGE_BYTES = 96 * 1024

# Bank parameter row layout (see telescope.cylbeam.build_beam_bank).
PAR_LEN = 12  # kx0, inv_step, fwhm_ns, xhat(3), yhat(3), dipole(3)


def sph_to_cart(sph: torch.Tensor) -> torch.Tensor:
    """(..., 2) spherical polar (theta, phi) -> (..., 3) cartesian units."""
    theta, phi = sph[..., 0], sph[..., 1]
    st = torch.sin(theta)
    return torch.stack(
        [st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1
    )


def thetaphi_plane_cart(sph: torch.Tensor):
    """Unit vectors (theta_hat, phi_hat) at spherical positions (..., 2)."""
    theta, phi = sph[..., 0], sph[..., 1]
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    that = torch.stack([ct * cp, ct * sp, -st], dim=-1)
    phat = torch.stack([-sp, cp, torch.zeros_like(sp)], dim=-1)
    return that, phat


def horizon_mask(cart: torch.Tensor, zenith: torch.Tensor) -> torch.Tensor:
    """1.0 above the horizon, 0.0 below."""
    zc = sph_to_cart(zenith.to(cart.dtype))
    return ((cart @ zc) > 0.0).to(cart.dtype)


def beam_exptan(sintheta: torch.Tensor, fwhm) -> torch.Tensor:
    """ExpTan beam amplitude model (with the reference's factor of two)."""
    return torch.exp(-exptan_alpha(fwhm) * exptan_tan2(sintheta))


def exptan_alpha(fwhm):
    """ExpTan exponent scale; a tensor fwhm keeps its dtype."""
    if isinstance(fwhm, torch.Tensor):
        return math.log(2.0) / (2 * torch.tan(fwhm / 2.0) ** 2)
    return math.log(2.0) / (2 * math.tan(fwhm / 2.0) ** 2)


def exptan_tan2(sintheta: torch.Tensor) -> torch.Tensor:
    st2 = sintheta**2
    return st2 / (1.0 - st2 + 1e-100)


def rotate_ypr(rot, xhat, yhat, zhat):
    """Rotate an orthonormal basis by yaw (z), pitch (new x), roll (new y)."""
    yaw, pitch, roll = (float(a) for a in rot)

    def _rot(axis, vec, ang):
        # Rodrigues rotation of `vec` about unit `axis`
        axis = axis / torch.linalg.norm(axis)
        c, s = math.cos(ang), math.sin(ang)
        return (
            vec * c
            + torch.linalg.cross(axis, vec) * s
            + axis * torch.dot(axis, vec) * (1 - c)
        )

    xh = _rot(zhat, xhat, yaw)
    yh = _rot(zhat, yhat, yaw)
    zh = zhat
    yh2 = _rot(xh, yh, pitch)
    zh2 = _rot(xh, zh, pitch)
    xh3 = _rot(yh2, xh, roll)
    zh3 = _rot(yh2, zh2, roll)
    return xh3, yh2, zh3


def uv_cart(zenith: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) baselines in wavelengths -> (..., 3) float64 vectors u.

    u = u_E phi_hat - u_N theta_hat at the zenith, so that the fringe
    phase is 2 pi u.n for the sky direction n.
    """
    that, phat = thetaphi_plane_cart(zenith.to(torch.float64))
    uv = uv.to(torch.float64)
    return uv[..., 0:1] * phat - uv[..., 1:2] * that


def fringe(cart: torch.Tensor, uv3: torch.Tensor) -> torch.Tensor:
    """Fringe exp(2 pi i u.n) at each pixel, (..., npix) complex.

    ``uv3`` (..., 3) float64 from :func:`uv_cart`.  The turns u.n are
    formed in float64 and reduced to [-1/2, 1/2) before the angle takes
    the pixel grid's precision, so a float32 fringe is accurate at any
    baseline length (the integer range reduction of the SHT's phases,
    applied to the fringe).
    """
    turns = torch.einsum("...k,pk->...p", uv3, cart.to(torch.float64))
    turns = turns - torch.floor(turns + 0.5)
    phase = turns.to(cart.dtype) * (2.0 * math.pi)
    return torch.complex(torch.cos(phase), torch.sin(phase))


def unpol_visibility_map(beam_i, beam_j, uv3, cart, horizon, pxarea: float):
    """Normalised unpolarised visibility maps for stacked beam pairs (K2).

    beam_i, beam_j : (nu, npix) real or complex beams on the padded grid;
    uv3 : (nu, 3) float64 baselines; returns (nu, npix) complex.
    """
    om_i = torch.sum(beam_i.abs() ** 2 * horizon, dim=-1) * pxarea
    om_j = torch.sum(beam_j.abs() ** 2 * horizon, dim=-1) * pxarea
    inv_om = (1.0 / torch.sqrt(om_i * om_j))[..., None]
    bb = beam_i * beam_j.conj()
    return bb * fringe(cart, uv3) * horizon * inv_om


def thetaphi_from_cart(cart: torch.Tensor):
    """Unit vectors (theta_hat, phi_hat) at cartesian unit vectors (..., 3).

    Formed from n directly, without arccos/arctan2: with rho = sin(theta)
    = |(n_x, n_y)|, phi_hat = (-n_y, n_x, 0)/rho and theta_hat = (n_z n_x,
    n_z n_y, -rho^2)/rho.  At a pole (rho = 0) phi is 0, as arctan2(0, 0)
    gives in the JAX package.
    """
    x, y, z = cart[..., 0], cart[..., 1], cart[..., 2]
    rho = torch.sqrt(x * x + y * y)
    pole = rho == 0
    safe = torch.where(pole, torch.ones_like(rho), rho)
    cp = torch.where(pole, torch.ones_like(rho), x / safe)
    sp = torch.where(pole, torch.zeros_like(rho), y / safe)
    that = torch.stack([z * cp, z * sp, -rho], dim=-1)
    phat = torch.stack([-sp, cp, torch.zeros_like(sp)], dim=-1)
    return that, phat


def polpattern(cart: torch.Tensor, dipole: torch.Tensor) -> torch.Tensor:
    """Unit polarisation vectors of dipoles at each sky position (K19).

    cart (npix, 3) sky directions; dipole (..., 3) cartesian dipole axes.
    The dipole is projected onto the local (theta_hat, phi_hat) plane and
    normalised; where the projection vanishes (a dipole along n) the
    vector is zero.  Returns (..., npix, 2).
    """
    that, phat = thetaphi_from_cart(cart)
    vt = torch.einsum("...k,pk->...p", dipole.to(cart.dtype), that)
    vp = torch.einsum("...k,pk->...p", dipole.to(cart.dtype), phat)
    norm = torch.sqrt(vt * vt + vp * vp)
    ok = norm > 0
    inv = torch.where(ok, 1.0 / torch.where(ok, norm, torch.ones_like(norm)), 0.0)
    return torch.stack([vt * inv, vp * inv], dim=-1)


def stokes_visibility_map(beam_i, beam_j, uv3, cart, horizon, pxarea: float):
    """Normalised Stokes I/Q/U/V visibility maps of stacked beam pairs (K2).

    beam_i, beam_j : (nu, npix, 2) field patterns in the (theta_hat,
    phi_hat) basis on the padded grid; uv3 : (nu, 3) float64 baselines.
    With tc = h e^{2 pi i u.n} / sqrt(Omega_i Omega_j) and conj on beam j:
    I = tc (tt + pp), Q = tc (tt - pp), U = tc (tp + pt), V = i tc (tp - pt).
    Returns (nu, 4, npix) complex.
    """
    om_i = torch.sum((beam_i.abs() ** 2).sum(-1) * horizon, dim=-1) * pxarea
    om_j = torch.sum((beam_j.abs() ** 2).sum(-1) * horizon, dim=-1) * pxarea
    inv_om = (1.0 / torch.sqrt(om_i * om_j))[..., None]
    tc = fringe(cart, uv3) * horizon * inv_om
    bit, bip = beam_i[..., 0], beam_i[..., 1]
    bjt, bjp = beam_j[..., 0].conj(), beam_j[..., 1].conj()
    tt, pp, tp, pt = bit * bjt, bip * bjp, bit * bjp, bip * bjt
    return torch.stack(
        [tc * (tt + pp), tc * (tt - pp), tc * (tp + pt), 1j * tc * (tp - pt)], dim=-2
    )


def bank_beam(cart, horizon, fx, par, polarised: bool = False):
    """Beams of bank rows over the pixel grid (K1), (nb, npix) real.

    Per pixel: a linear interpolation of the row's Fraunhofer table on
    its uniform grid at x = n.xhat, times the ExpTan N-S profile at
    n.yhat, times the horizon.  fx (nb, nfx), par (nb, 12).  With
    ``polarised`` each row's amplitude takes its dipole's
    :func:`polpattern` (dipole ``par[:, 9:12]``): (nb, npix, 2).
    """
    nfx = fx.shape[-1]
    x = cart @ par[:, 3:6].T  # (npix, nb)
    y = cart @ par[:, 6:9].T
    t = (x - par[:, 0]) * par[:, 1]
    i0 = torch.clamp(torch.floor(t).to(torch.int64), 0, nfx - 2)
    frac = t - i0.to(t.dtype)
    rows = torch.arange(fx.shape[0], device=fx.device)
    ew0 = fx[rows, i0]
    ew1 = fx[rows, i0 + 1]
    ew = ew0 * (1.0 - frac) + ew1 * frac
    ns = torch.exp(-exptan_alpha(par[:, 2]) * exptan_tan2(y))
    amp = (ew * ns * horizon[:, None]).T.contiguous()
    if not polarised:
        return amp
    return amp[..., None] * polpattern(cart, par[:, 9:12])


def bank_visibility_maps_ref(cart, horizon, fx, par, idx_i, idx_j, uv3, pxarea):
    """Plain PyTorch version of :func:`bank_visibility_maps`."""
    beams = bank_beam(cart, horizon, fx, par)
    return unpol_visibility_map(
        beams[idx_i], beams[idx_j], uv3, cart, horizon, pxarea
    )


def bank_visibility_maps(cart, horizon, fx, par, idx_i, idx_j, uv3, pxarea: float):
    """Visibility maps of a unit batch whose beams are bank rows (K1+K2).

    cart (npix, 3) and horizon (npix,) are the ring-padded pixel grid;
    fx (nb, nfx) and par (nb, 12) the bank rows of the batch's unique
    beams; unit u pairs rows idx_i[u], idx_j[u] at baseline uv3[u]
    ((nu, 3) float64).  Returns (nu, npix) complex.  CPU tensors take the
    plain version; CUDA tensors launch the kernel, which takes the float32
    grid of single-precision telescopes.
    """
    if not backend.on_cuda(cart, horizon, fx, par, idx_i, idx_j, uv3):
        return bank_visibility_maps_ref(
            cart, horizon, fx, par, idx_i, idx_j, uv3, pxarea
        )
    _require_bank_args(cart, horizon, fx, par, idx_i, idx_j, uv3)
    out = torch.empty(
        (idx_i.shape[0], cart.shape[0]), dtype=torch.complex64, device=cart.device
    )
    _map_launch(K1K2, "bank_maps_f32", (fx.data_ptr(), par.data_ptr()), fx.shape[1],
                fx.shape[0], 1, fx.element_size(), 1, idx_i, idx_j, uv3, cart, horizon,
                pxarea, out)
    return out


def _require_bank_args(cart, horizon, fx, par, idx_i, idx_j, uv3):
    """Validate the arguments of the bank map kernels (float32 grid)."""
    dt = cart.dtype
    npix = cart.shape[0]
    nb, nfx = fx.shape
    nu = idx_i.shape[0]
    backend.require(cart, "cart", dtype=torch.float32, shape=(npix, 3))
    backend.require(horizon, "horizon", dtype=dt, shape=(npix,))
    backend.require(fx, "fx", dtype=dt, ndim=2)
    backend.require(par, "par", dtype=dt, shape=(nb, PAR_LEN))
    backend.require(idx_i, "idx_i", dtype=torch.int64, shape=(nu,))
    backend.require(idx_j, "idx_j", dtype=torch.int64, shape=(nu,))
    backend.require(uv3, "uv3", dtype=torch.float64, shape=(nu, 3))
    if nfx < 2:
        raise ValueError("bank tables need at least two samples")


def bank_stokes_maps_ref(cart, horizon, fx, par, idx_i, idx_j, uv3, pxarea,
                         npol: int = 4):
    """Plain PyTorch version of :func:`bank_stokes_maps`."""
    beams = bank_beam(cart, horizon, fx, par, polarised=True)
    maps = stokes_visibility_map(
        beams[idx_i], beams[idx_j], uv3, cart, horizon, pxarea
    )
    return maps[:, :npol]


def bank_stokes_maps(cart, horizon, fx, par, idx_i, idx_j, uv3, pxarea: float,
                     npol: int = 4):
    """Stokes visibility maps of a unit batch of dipole bank beams (K1+K2, K19).

    Arguments as :func:`bank_visibility_maps`; each bank row's beam is its
    amplitude times its dipole's polarisation pattern.  Returns (nu,
    npol, npix) complex: the first ``npol`` of Stokes I, Q, U, V (a
    telescope that skips V or all polarisation transforms fewer).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (float32
    grid).
    """
    if not 1 <= npol <= 4:
        raise ValueError(f"npol={npol}: Stokes maps have 1 to 4 components")
    if not backend.on_cuda(cart, horizon, fx, par, idx_i, idx_j, uv3):
        return bank_stokes_maps_ref(
            cart, horizon, fx, par, idx_i, idx_j, uv3, pxarea, npol
        )
    _require_bank_args(cart, horizon, fx, par, idx_i, idx_j, uv3)
    out = torch.empty(
        (idx_i.shape[0], npol, cart.shape[0]), dtype=torch.complex64, device=cart.device
    )
    _map_launch(K1K2_STOKES, "bank_maps_f32", (fx.data_ptr(), par.data_ptr()), fx.shape[1],
                fx.shape[0], 2, fx.element_size(), npol, idx_i, idx_j, uv3, cart, horizon,
                pxarea, out)
    return out


def host_visibility_maps_ref(beams, idx_i, idx_j, uv3, cart, horizon, pxarea):
    """Plain PyTorch version of :func:`host_visibility_maps`."""
    return unpol_visibility_map(beams[idx_i], beams[idx_j], uv3, cart, horizon, pxarea)


def host_visibility_maps(beams, idx_i, idx_j, uv3, cart, horizon, pxarea: float):
    """Visibility maps of a unit batch from host-evaluated beams (K2).

    beams (nb, npix) real or complex: the batch's unique beams on the
    ring-padded grid cart (npix, 3) / horizon (npix,); unit u pairs beams
    idx_i[u], idx_j[u] at baseline uv3[u] ((nu, 3) float64).  ``pxarea``
    is the pixel area 4 pi / (12 nside^2), not one over the padded length.
    Returns (nu, npix) complex.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (float32 or float64 grid).
    """
    if not backend.on_cuda(beams, idx_i, idx_j, uv3, cart, horizon):
        return host_visibility_maps_ref(beams, idx_i, idx_j, uv3, cart, horizon, pxarea)
    _require_host_args(beams, 2, idx_i, idx_j, uv3, cart, horizon)
    out = torch.empty(
        (idx_i.shape[0], cart.shape[0]), dtype=backend.complex_dtype(cart.dtype),
        device=cart.device,
    )
    _host_launch(K2_HOST, beams, 1, 1, idx_i, idx_j, uv3, cart, horizon, pxarea, out)
    return out


def host_stokes_maps_ref(beams, idx_i, idx_j, uv3, cart, horizon, pxarea, npol: int = 4):
    """Plain PyTorch version of :func:`host_stokes_maps`."""
    maps = stokes_visibility_map(beams[idx_i], beams[idx_j], uv3, cart, horizon, pxarea)
    return maps[:, :npol]


def host_stokes_maps(beams, idx_i, idx_j, uv3, cart, horizon, pxarea: float,
                     npol: int = 4):
    """Stokes visibility maps of a unit batch from host-evaluated field
    patterns (K2).

    Arguments as :func:`host_visibility_maps`, with beams (nb, npix, 2) in
    the (theta_hat, phi_hat) basis.  Returns (nu, npol, npix) complex: the
    first ``npol`` of Stokes I, Q, U, V.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if not 1 <= npol <= 4:
        raise ValueError(f"npol={npol}: Stokes maps have 1 to 4 components")
    if not backend.on_cuda(beams, idx_i, idx_j, uv3, cart, horizon):
        return host_stokes_maps_ref(beams, idx_i, idx_j, uv3, cart, horizon, pxarea, npol)
    _require_host_args(beams, 3, idx_i, idx_j, uv3, cart, horizon)
    out = torch.empty(
        (idx_i.shape[0], npol, cart.shape[0]), dtype=backend.complex_dtype(cart.dtype),
        device=cart.device,
    )
    _host_launch(K2_HOST_STOKES, beams, 2, npol, idx_i, idx_j, uv3, cart, horizon, pxarea, out)
    return out


def host_vis_stage(nb: int, ncomp: int, elem_bytes: int) -> int:
    """Unique beams a block of the map pass (K2-host, K1+K2) stages at once:
    as many of the batch's ``nb`` beams (``ncomp`` components of
    ``elem_bytes`` a pixel) as HOST_VIS_STAGE_BYTES hold over a pixel tile,
    at least one."""
    per_beam = HOST_VIS_TILE * ncomp * elem_bytes
    return max(1, min(nb, HOST_VIS_STAGE_BYTES // per_beam))


def _host_launch(kernel, beams, ncomp, npol, idx_i, idx_j, uv3, cart, horizon, pxarea, out):
    """One call of csrc/host_vis.cu on the current stream; arguments
    validated by the caller."""
    _map_launch(
        kernel, "host_maps_f32" if cart.dtype == torch.float32 else "host_maps_f64",
        (beams.data_ptr(),), int(beams.is_complex()), beams.shape[0], ncomp,
        beams.element_size(),  # one (re, im) pair for a complex beam
        npol, idx_i, idx_j, uv3, cart, horizon, pxarea, out,
    )


def _map_launch(kernel, symbol, beam_ptrs, flag, nb, ncomp, elem, npol, idx_i, idx_j, uv3,
                cart, horizon, pxarea, out):
    """One call of a csrc/vis_map.cuh map pass (solid angles, then the maps)
    on the current stream.  ``beam_ptrs`` are the beam source's arrays (the
    host beams; or the bank tables and parameters), ``flag`` its int (complex
    beams; or the table length), ``nb`` its unique beams of ``ncomp``
    components of ``elem`` bytes a pixel.  Arguments validated by the
    caller."""
    npix, nu = cart.shape[0], idx_i.shape[0]
    if npix == 0 or nu == 0:
        return
    scratch = torch.empty(
        nb * (-(-npix // HOST_VIS_OMEGA_TILE) + 1), dtype=cart.dtype, device=cart.device
    )
    fn = kernel.entry(
        symbol,
        (ctypes.c_void_p,) * (7 + len(beam_ptrs))
        + (ctypes.c_longlong, ctypes.c_double, ctypes.c_longlong)
        + (ctypes.c_int,) * 6 + (ctypes.c_void_p,),
    )
    backend.check(
        fn(
            cart.data_ptr(), horizon.data_ptr(), *beam_ptrs, idx_i.data_ptr(),
            idx_j.data_ptr(), uv3.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), float(pxarea), npix, nu, nb, ncomp, flag, npol,
            host_vis_stage(nb, ncomp, elem), backend.stream_ptr(cart.device),
        ),
        kernel.name,
    )
    kernel.launches += 1


def _require_host_args(beams, ndim, idx_i, idx_j, uv3, cart, horizon):
    """Validate the arguments of the host-beam map kernels: beams of the
    grid's real type or its complex counterpart."""
    dt = cart.dtype
    npix = cart.shape[0]
    nu = idx_i.shape[0]
    backend.require(cart, "cart", dtype=(torch.float32, torch.float64), shape=(npix, 3))
    backend.require(horizon, "horizon", dtype=dt, shape=(npix,))
    backend.require(beams, "beams", dtype=(dt, backend.complex_dtype(dt)), ndim=ndim)
    if beams.shape[1] != npix or (ndim == 3 and beams.shape[2] != 2):
        raise ValueError(
            f"beams: shape {tuple(beams.shape)}, expected (nb, {npix})"
            + (", 2)" if ndim == 3 else ")")
        )
    backend.require(idx_i, "idx_i", dtype=torch.int64, shape=(nu,))
    backend.require(idx_j, "idx_j", dtype=torch.int64, shape=(nu,))
    backend.require(uv3, "uv3", dtype=torch.float64, shape=(nu, 3))
