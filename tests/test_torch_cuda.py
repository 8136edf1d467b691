"""The hand-written kernels of driftscan_tpu_torch against their plain
versions, on a CUDA card (small shapes; skipped without a card).

This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which pins JAX to the CPU.)
"""

import numpy as np
import pytest
import torch

from driftscan_tpu_torch import backend
from driftscan_tpu_torch.ops import cheb, fpencil, healpix, kernels, probe, projections, sht
from driftscan_tpu_torch.parallel import mstep
from driftscan_tpu_torch.telescope import cylbeam, cylinder

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _crandn(rng, shape, device):
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor(z.astype(np.complex64), device=device)


def _check(kernel, fn, ref, rtol):
    before = kernel.launches
    got = fn()
    want = ref()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert float((g - w).abs().max()) <= rtol * scale


def test_k1k2_beam_vis(cuda):
    tel = cylinder.UnpolarisedCylinderTelescope.from_config(
        dict(num_freq=2, freq_start=400.0, freq_end=410.0, num_cylinders=2,
             cylinder_width=3.0, num_feeds=3, feed_spacing=1.0,
             single_precision=True),
        device=cuda,
    )
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    ns = tel._nside_for(tel.lmax)
    tel._init_trans(ns)
    args = (tel._angpos_cart, tel._horizon, *tel._gather_beams(blg, fig),
            4 * np.pi / (12 * ns**2))
    _check(kernels.K1K2, lambda: kernels.bank_visibility_maps(*args),
           lambda: kernels.bank_visibility_maps_ref(*args), 1e-5)


@pytest.mark.parametrize("skip,npol", [({}, 4), ({"skip_V": True}, 3), ({"skip_pol": True}, 1)])
def test_k1k2_stokes_vis(cuda, skip, npol):
    tel = cylinder.PolarisedCylinderTelescope.from_config(
        dict(num_freq=2, freq_start=400.0, freq_end=410.0, num_cylinders=2,
             cylinder_width=3.0, num_feeds=2, feed_spacing=1.0,
             single_precision=True, **skip),
        device=cuda,
    )
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    ns = tel._nside_for(tel.lmax)
    tel._init_trans(ns)
    args = (tel._angpos_cart, tel._horizon, *tel._gather_beams(blg, fig),
            4 * np.pi / (12 * ns**2))
    assert tel._npol_transform == npol
    _check(kernels.K1K2_STOKES, lambda: kernels.bank_stokes_maps(*args, npol=npol),
           lambda: kernels.bank_stokes_maps_ref(*args, npol=npol), 1e-5)


def test_k1k2_repeats_bitwise(cuda):
    """The solid angles are summed in a fixed order (no atomics): two
    launches on the same inputs give the same bits."""
    for pol in (False, True):
        klass = cylinder.PolarisedCylinderTelescope if pol else cylinder.UnpolarisedCylinderTelescope
        tel = klass.from_config(
            dict(num_freq=2, freq_start=400.0, freq_end=410.0, num_cylinders=2,
                 cylinder_width=3.0, num_feeds=3, feed_spacing=1.0, single_precision=True),
            device=cuda,
        )
        bl = np.arange(tel.npairs)
        fi = np.arange(tel.nfreq)
        blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
        tel._init_trans(tel._nside_for(tel.lmax))
        a = tel._beam_map_batch(blg, fig)
        b = tel._beam_map_batch(blg, fig)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def _bank_inputs(device, npix, nb, nu, pol, seed, poles=False):
    """Seeded unit vectors (a ragged pixel count), a horizon, ``nb`` bank
    rows of a cylinder (``pol``: X and Y dipole rows) and ``nu`` unit pairs
    over them for the K1+K2 kernels.  ``poles``: the first pixels lie at
    the pole n = z and row 0's dipole lies along it."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((npix, 3))
    if poles:
        v[:5] = [0.0, 0.0, 1.0]
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    zenith = np.array([np.pi / 4, 0.0])
    zc = np.array([np.sin(zenith[0]), 0.0, np.cos(zenith[0])])
    cart = torch.as_tensor(v, dtype=torch.float32, device=device)
    hor = torch.as_tensor((v @ zc > 0.0).astype(np.float32), device=device)
    widths = np.linspace(3.0, 8.0, -(-nb // (2 if pol else 1)))
    par, fx = cylbeam.build_beam_bank(zenith, widths, 2.0, 1.5, pol)
    par = par.reshape(-1, kernels.PAR_LEN)[:nb]
    fx = fx.reshape(-1, fx.shape[-1])[:nb]
    if poles:
        par[0, 9:12] = [0.0, 0.0, 1.0]
    ii = torch.as_tensor(rng.integers(0, nb, nu), device=device)
    jj = torch.as_tensor(rng.integers(0, nb, nu), device=device)
    uv3 = torch.as_tensor(rng.uniform(-40.0, 40.0, (nu, 3)), device=device)
    return (cart, hor, torch.as_tensor(fx, device=device), torch.as_tensor(par, device=device),
            ii, jj, uv3, 4.0 * np.pi / npix)


def _bank_case(args, pol, npol):
    if pol:
        return (kernels.K1K2_STOKES, lambda: kernels.bank_stokes_maps(*args, npol=npol),
                lambda: kernels.bank_stokes_maps_ref(*args, npol=npol))
    return (kernels.K1K2, lambda: kernels.bank_visibility_maps(*args),
            lambda: kernels.bank_visibility_maps_ref(*args))


# (npix, nb, nu, npol): many units over one and two rows (more than one
# 256-unit round), a pixel count that is no multiple of the 512-pixel tile,
# rows beyond one shared-memory stage (48 scalar rows, 24 dipole rows: the
# map pass stages them in groups and evaluates a unit's row j in another
# group in place), Stokes npol 1, 3 and 4
K1K2_EDGES = [
    (5000, 1, 300, 4), (4093, 2, 300, 3), (2049, 64, 150, 4), (3001, 5, 40, 1),
    (1000, 40, 90, 3),
]


@pytest.mark.parametrize("pol", [False, True], ids=["scalar", "stokes"])
@pytest.mark.parametrize("shape", K1K2_EDGES, ids=lambda s: "x".join(map(str, s)))
def test_k1k2_edges(cuda, pol, shape):
    """The bank kernels against their plain versions (rel 1e-5), and two
    launches bitwise equal."""
    npix, nb, nu, npol = shape
    args = _bank_inputs(cuda, npix, nb, nu, pol, seed=npix + nb)
    if nb == 64:
        assert kernels.host_vis_stage(nb, 2 if pol else 1, 4) < nb
    kernel, fn, ref = _bank_case(args, pol, npol)
    _check(kernel, fn, ref, 1e-5)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("npol", [1, 3, 4])
def test_k1k2_stokes_dipole_along_the_pole(cuda, npol):
    """Pixels at the pole n = z with a dipole along n: the dipole's
    projection on (theta_hat, phi_hat) vanishes, so every map of a unit on
    that row is zero there, never NaN; the kernel stays within 1e-5 of its
    plain version."""
    args = _bank_inputs(cuda, 3000, 4, 20, True, seed=9, poles=True)
    kernel, fn, ref = _bank_case(args, True, npol)
    _check(kernel, fn, ref, 1e-5)
    got = fn()
    assert bool(torch.isfinite(got).all())
    on_row0 = (args[4] == 0) | (args[5] == 0)
    assert bool(on_row0.any())
    assert float(got[on_row0][..., :5].abs().max()) == 0.0
    assert float(got[~on_row0][..., 5:].abs().max()) > 0.0


def _host_inputs(device, dtype, cplx, stokes, npix, nb=3, nu=7, seed=5):
    """Seeded unit vectors (a ragged pixel count), a horizon, beams and
    unit pairs for the K2-host kernels."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((npix, 3))
    cart = torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True), dtype=dtype,
                           device=device)
    hor = (cart[:, 2] > -0.2).to(dtype)
    shape = (nb, npix, 2) if stokes else (nb, npix)
    beams = rng.standard_normal(shape) + (1j * rng.standard_normal(shape) if cplx else 0)
    cdt = backend.complex_dtype(dtype) if cplx else dtype
    beams = torch.as_tensor(beams, device=device).to(cdt)
    ii = torch.as_tensor(rng.integers(0, nb, nu), device=device)
    jj = torch.as_tensor(rng.integers(0, nb, nu), device=device)
    uv3 = torch.as_tensor(rng.uniform(-40.0, 40.0, (nu, 3)), device=device)
    return beams, ii, jj, uv3, cart, hor, 4.0 * np.pi / npix


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("npix", [1000, 4093])
def test_k2_host_vis(cuda, dtype, rtol, cplx, npix):
    args = _host_inputs(cuda, dtype, cplx, False, npix)
    _check(kernels.K2_HOST, lambda: kernels.host_visibility_maps(*args),
           lambda: kernels.host_visibility_maps_ref(*args), rtol)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("npol", [1, 3, 4])
def test_k2_host_stokes(cuda, dtype, rtol, cplx, npol):
    args = _host_inputs(cuda, dtype, cplx, True, 3001)
    _check(kernels.K2_HOST_STOKES, lambda: kernels.host_stokes_maps(*args, npol=npol),
           lambda: kernels.host_stokes_maps_ref(*args, npol=npol), rtol)


def test_k2_host_repeats_bitwise(cuda):
    for stokes in (False, True):
        args = _host_inputs(cuda, torch.float32, True, stokes, 5000)
        fn = kernels.host_stokes_maps if stokes else kernels.host_visibility_maps
        a, b = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def _host_case(args, stokes, npol):
    fn = kernels.host_stokes_maps if stokes else kernels.host_visibility_maps
    ref = kernels.host_stokes_maps_ref if stokes else kernels.host_visibility_maps_ref
    kw = dict(npol=npol) if stokes else {}
    return (kernels.K2_HOST_STOKES if stokes else kernels.K2_HOST,
            lambda: fn(*args, **kw), lambda: ref(*args, **kw))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("stokes", [False, True], ids=["scalar", "stokes"])
def test_k2_host_many_units_few_beams(cuda, dtype, rtol, cplx, stokes):
    """nu >> nb over a pixel count that is no multiple of the 512-pixel
    tile: each block walks 300 units (more than one 256-unit round) over
    its staged beams."""
    args = _host_inputs(cuda, dtype, cplx, stokes, 5000, nb=3, nu=300, seed=11)
    kernel, fn, ref = _host_case(args, stokes, 4)
    _check(kernel, fn, ref, rtol)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("stokes", [False, True], ids=["scalar", "stokes"])
def test_k2_host_beams_in_groups(cuda, dtype, rtol, cplx, stokes):
    """More unique beams than one shared-memory stage holds: the map pass
    stages them in groups, and a unit whose beam j lies in another group
    reads it in place."""
    nb = 64
    args = _host_inputs(cuda, dtype, cplx, stokes, 2049, nb=nb, nu=150, seed=12)
    elem = args[0].element_size()
    assert kernels.host_vis_stage(nb, 2 if stokes else 1, elem) < nb
    kernel, fn, ref = _host_case(args, stokes, 3)
    _check(kernel, fn, ref, rtol)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_k2_host_rejects_mixed_types(cuda):
    beams, ii, jj, uv3, cart, hor, px = _host_inputs(cuda, torch.float32, False, False, 999)
    with pytest.raises(TypeError):
        kernels.host_visibility_maps(beams.double(), ii, jj, uv3, cart, hor, px)
    with pytest.raises(ValueError):
        kernels.host_stokes_maps(beams, ii, jj, uv3, cart, hor, px)


def test_double_precision_cylinder_runs_on_the_card(cuda):
    """A cylinder at the default precision takes host beams and the
    float64 K2-host kernel (once a dtype error at the bank kernel), and
    its transfer matrices equal the CPU's."""
    cfg = dict(num_freq=2, freq_start=400.0, freq_end=410.0, num_cylinders=2,
               cylinder_width=3.0, num_feeds=2, feed_spacing=1.0)
    for klass in (cylinder.UnpolarisedCylinderTelescope, cylinder.PolarisedCylinderTelescope):
        tel = klass.from_config(cfg, device=cuda)
        cpu = klass.from_config(cfg, device="cpu")
        bl = np.arange(tel.npairs)
        fi = np.arange(tel.nfreq)
        blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
        backend.reset_launch_counts()
        got = tel.transfer_matrices(blg, fig)
        host = kernels.K2_HOST_STOKES if klass is cylinder.PolarisedCylinderTelescope else kernels.K2_HOST
        assert host.launches >= 1 and kernels.K1K2.launches == kernels.K1K2_STOKES.launches == 0
        want = cpu.transfer_matrices(blg, fig)
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_k3k5_legendre_sht(cuda, dtype):
    g = healpix.ring_geometry(16)
    lmax, B = 30, 20
    rng = np.random.default_rng(7)
    F = _crandn(rng, (B, lmax + 1, g.nring), cuda).to(dtype)
    G = _crandn(rng, (B, lmax + 1, g.nring), cuda).to(dtype)
    ct = torch.as_tensor(g.cos_theta, device=cuda)
    st = torch.as_tensor(g.sin_theta, device=cuda)
    _check(sht.K3K5, lambda: sht.legendre_contract(F, G, ct, st, lmax, 0.01),
           lambda: sht.legendre_contract_ref(F, G, ct, st, lmax, 0.01), 1e-4)


# (nside, lmax, nm, B, dtype): lmax below the multipole tile (64 complex64,
# 32 complex128), nm < lmax + 1 (odd and even: the (m, nm - 1 - m) pairs),
# ring counts that are not a multiple of the 512-ring or 32-ring tiles (31,
# 63, 1023), B = 1, 8, 64 (one block of units in complex64) and 256 (four),
# 33 (three blocks in complex128), the [dish] shape (nside 512, lmax 494,
# complex128) and nside 1024, whose 4095 rings exceed the ring states one
# block holds (ring ranges)
K3K5_EDGES = [
    (8, 10, 11, 1, torch.complex64), (16, 20, 7, 8, torch.complex64),
    (16, 20, 8, 3, torch.complex128), (64, 120, 121, 64, torch.complex64),
    (32, 47, 48, 256, torch.complex64), (32, 47, 30, 33, torch.complex128),
    (256, 229, 230, 8, torch.complex128), (512, 494, 495, 2, torch.complex128),
    (1024, 40, 41, 2, torch.complex64), (1024, 40, 41, 1, torch.complex128),
]


@pytest.mark.parametrize("shape", K3K5_EDGES, ids=lambda s: "x".join(map(str, s[:4])) + str(s[4])[-3:])
def test_k3k5_legendre_sht_edges(cuda, shape):
    """The kernel against its plain version (rel 1e-4 in complex64, 1e-10 in
    complex128), and two launches bitwise equal."""
    nside, lmax, nm, B, dtype = shape
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(nside + lmax + B)
    F = _crandn(rng, (B, nm, g.nring), cuda).to(dtype)
    G = _crandn(rng, (B, nm, g.nring), cuda).to(dtype)
    ct = torch.as_tensor(g.cos_theta, device=cuda)
    st = torch.as_tensor(g.sin_theta, device=cuda)
    area = 4 * np.pi / g.npix
    rtol = 1e-4 if dtype == torch.complex64 else 1e-10
    _check(sht.K3K5, lambda: sht.legendre_contract(F, G, ct, st, lmax, area),
           lambda: sht.legendre_contract_ref(F, G, ct, st, lmax, area), rtol)
    a = sht.legendre_contract(F, G, ct, st, lmax, area)
    b = sht.legendre_contract(F, G, ct, st, lmax, area)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# (nside, lmax, m0, m1, B, dtype): windows of odd and even width, one m,
# windows that run past lmax + 1, m0 = 0, and ns2's window at its lmax
K3K5_WINDOWS = [
    (16, 30, 0, 9, 8, torch.complex64), (16, 30, 5, 23, 3, torch.complex128),
    (16, 30, 29, 40, 8, torch.complex64), (32, 47, 47, 48, 2, torch.complex128),
    (64, 120, 60, 121, 64, torch.complex64), (256, 324, 270, 315, 16, torch.complex64),
    # ns1b's window (chip_smoke [ns1b window]): lmax 1035 on nside 1024's
    # rings, 8 units x 4 Stokes a call
    (1024, 1035, 0, 33, 32, torch.complex64),
]


@pytest.mark.parametrize("shape", K3K5_WINDOWS, ids=lambda s: "x".join(map(str, s[:5])) + str(s[5])[-3:])
def test_k3k5_window(cuda, shape):
    """K3+K5 over an m-window (m_lo): against its plain version, two
    launches bitwise equal, the window's columns bitwise equal to a
    full-range call's on the same inputs, and the columns past lmax zero."""
    nside, lmax, m0, m1, B, dtype = shape
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(nside + m0 + B)
    Ff = _crandn(rng, (B, lmax + 1, g.nring), cuda).to(dtype)
    Gf = _crandn(rng, (B, lmax + 1, g.nring), cuda).to(dtype)
    w = min(m1, lmax + 1) - m0
    F = torch.zeros((B, m1 - m0, g.nring), dtype=dtype, device=cuda)
    G = torch.zeros_like(F)
    F[:, :w], G[:, :w] = Ff[:, m0 : m0 + w], Gf[:, m0 : m0 + w]
    ct = torch.as_tensor(g.cos_theta, device=cuda)
    st = torch.as_tensor(g.sin_theta, device=cuda)
    area = 4 * np.pi / g.npix
    rtol = 1e-5 if dtype == torch.complex64 else 1e-10
    _check(sht.K3K5, lambda: sht.legendre_contract(F, G, ct, st, lmax, area, m0),
           lambda: sht.legendre_contract_ref(F, G, ct, st, lmax, area, m0), rtol)
    a = sht.legendre_contract(F, G, ct, st, lmax, area, m0)
    b = sht.legendre_contract(F, G, ct, st, lmax, area, m0)
    full = sht.legendre_contract(Ff, Gf, ct, st, lmax, area)
    torch.cuda.synchronize()
    for x, y, f in zip(a, b, full):
        assert torch.equal(x, y)
        assert torch.equal(x[..., :w], f[..., m0 : m0 + w])
        assert not x[..., w:].any()


def test_windowed_btm_on_the_card(cuda):
    """btm_resident(m_range=) on the card: every column bitwise equal to
    the full tables' (the uniform layout)."""
    from driftscan_tpu_torch.parallel import resident

    tel = cylinder.PolarisedCylinderTelescope.from_config(
        dict(num_freq=2, freq_start=400.0, freq_end=410.0, num_cylinders=2,
             cylinder_width=3.0, num_feeds=2, feed_spacing=1.0, single_precision=True),
        device=cuda,
    )
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    fp, fn = resident.btm_resident(tel, blg, fig)
    m0, m1 = 5, tel.lmax + 4
    pw, nw = resident.btm_resident(tel, blg, fig, m_range=(m0, m1))
    hi = tel.lmax + 1
    assert torch.equal(pw[..., : hi - m0], fp[..., m0:hi])
    assert torch.equal(nw[..., : hi - m0], fn[..., m0 - 1 : hi - 1])
    assert not pw[..., hi - m0 :].any() and not nw[..., hi - m0 :].any()


@pytest.mark.parametrize("nside,lmax,B", [(64, 120, 64), (128, 229, 16)])
def test_k3k5_complex64_no_farther_from_float64_than_plain(cuda, nside, lmax, B):
    """In complex64 the 3xTF32 products (tf32 parts rounded to nearest,
    summed outside the tensor cores every 8 rings) land no farther from the
    float64 truth than the plain version's float32 lambda and sums."""
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(lmax + B)
    F = _crandn(rng, (B, lmax + 1, g.nring), cuda)
    G = _crandn(rng, (B, lmax + 1, g.nring), cuda)
    ct = torch.as_tensor(g.cos_theta, device=cuda)
    st = torch.as_tensor(g.sin_theta, device=cuda)
    area = 4 * np.pi / g.npix
    truth = sht.legendre_contract_ref(F.to(torch.complex128), G.to(torch.complex128), ct, st,
                                      lmax, area)

    def err(out):
        return max(float((o.to(torch.complex128) - t).abs().max()) for o, t in zip(out, truth))

    kernel = err(sht.legendre_contract(F, G, ct, st, lmax, area))
    assert kernel <= err(sht.legendre_contract_ref(F, G, ct, st, lmax, area))


# (nside, lmax, B): an odd unit count over one and two unit tiles, ring counts
# (63, 255) that are not a multiple of the 128-ring tile, m above the polar
# rings' length, and the path's lmax at an nside of the same ring tiling
K14_SHAPES = [(16, 30, 3), (16, 47, 11), (64, 150, 9), (32, 229, 8)]


@pytest.mark.parametrize("dtype,rtol", [(torch.complex128, 1e-10), (torch.complex64, 1e-5)])
@pytest.mark.parametrize("neg", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("shape", K14_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k14_legendre_synth(cuda, shape, neg, dtype, rtol):
    nside, lmax, B = shape
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(14)
    pos = _crandn(rng, (B, lmax + 1, lmax + 1), cuda).to(dtype)
    nalm = _crandn(rng, (B, lmax + 1, lmax), cuda).to(dtype) if neg else None
    ct = torch.as_tensor(g.cos_theta, device=cuda)
    st = torch.as_tensor(g.sin_theta, device=cuda)
    _check(sht.K14, lambda: sht.legendre_synth(pos, nalm, ct, st)[: 1 + neg],
           lambda: sht.legendre_synth_ref(pos, nalm, ct, st)[: 1 + neg], rtol)


# (nside, lmax, nm, B): odd and even nm below lmax + 1 (the (m, nm - 1 - m)
# pairs, one m alone), ring counts (31, 63, 127, 255, 1023) that are no
# multiple of the 128-ring tile, lmax + 1 at and just past the 32-multipole
# tile, B 1, 3, 9 and 17 (one to three blocks of 8 units), and the
# timestream's shape (lmax 229, nside 256), whole and with its first 58 m
K14_EDGES = [
    (8, 20, 21, 1), (16, 30, 17, 3), (16, 47, 30, 9), (64, 100, 101, 17),
    (32, 31, 32, 2), (32, 32, 33, 5), (256, 229, 230, 8), (256, 229, 58, 8),
]


@pytest.mark.parametrize("dtype,rtol", [(torch.complex128, 1e-10), (torch.complex64, 1e-5)])
@pytest.mark.parametrize("neg", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("shape", K14_EDGES, ids=lambda s: "x".join(map(str, s)))
def test_k14_legendre_synth_edges(cuda, shape, neg, dtype, rtol):
    """The kernel against its plain version, and two launches bitwise
    equal (its sums run in a fixed order)."""
    nside, lmax, nm, B = shape
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(nside + lmax + nm + B)
    pos = _crandn(rng, (B, lmax + 1, nm), cuda).to(dtype)
    nalm = _crandn(rng, (B, lmax + 1, nm - 1), cuda).to(dtype) if neg else None
    ct = torch.as_tensor(g.cos_theta, device=cuda)
    st = torch.as_tensor(g.sin_theta, device=cuda)
    fn = lambda: sht.legendre_synth(pos, nalm, ct, st)[: 1 + neg]
    _check(sht.K14, fn, lambda: sht.legendre_synth_ref(pos, nalm, ct, st)[: 1 + neg], rtol)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# (nside, B, m0, nm): one unit, units that fill a row tile (64) or spill
# past it, the full range at 3 nside (the cap rings' m past N_r), windows
# past the caps' N_r, one m, nside 1024's 4,096-pixel belt (and 2,047-pixel
# pairs) at ns1b's window; the plan's edges (ops/sht.py phase_plan): nm 33,
# 45, 48, 49 (one m past a 48-column tile) and 495 (nine 56-column tiles),
# each warp-row count (B 1, whose cap groups hold 2 rows; B 12; B 40), and
# nside 512 in both types
K4_SHAPES = [
    (4, 1, 0, 12), (16, 3, 0, 48), (16, 64, 5, 23), (32, 5, 100, 7), (8, 70, 29, 1),
    (64, 2, 0, 192), (1024, 2, 0, 33),
    (64, 3, 0, 33), (64, 12, 270, 45), (32, 40, 7, 48), (128, 1, 0, 49), (256, 2, 0, 495),
    (512, 3, 300, 49),
]


@pytest.mark.parametrize("dtype,rtol", [(torch.complex64, 1e-5), (torch.complex128, 1e-12)])
@pytest.mark.parametrize("shape", K4_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k4_phase(cuda, shape, dtype, rtol):
    """K4 against its plain version (the FFT route), two launches bitwise
    equal."""
    nside, B, m0, nm = shape
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(nside + B + m0)
    mask = torch.as_tensor(g.mask, device=cuda)
    maps = (_crandn(rng, (B, g.nring, g.maxlen), cuda) * mask).to(dtype)
    fn = lambda: sht.phase_stage(maps, nside, nm, m0)
    _check(sht.K4, fn, lambda: sht.phase_stage_ref(maps, nside, nm, m0), rtol)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# m-windows whose own plans take every m-tile width (8, 16, ..., 64
# columns), and whose full ranges take one to three tiles
K4_WINDOWS = [(16, 3, (40, 49)), (64, 16, (60, 121)), (512, 2, (270, 315)),
              (64, 3, (5, 6)), (64, 3, (60, 81)), (64, 3, (3, 33)), (64, 3, (100, 137)),
              (64, 3, (0, 45)), (64, 3, (7, 56)), (64, 3, (130, 190))]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nside,B,window", K4_WINDOWS)
def test_k4_phase_window(cuda, nside, B, window, dtype):
    """K4 over an m-window: every column bitwise the full-range call's on
    the same maps (ns2's window at nside 512 among them), at every m-tile
    width of the plan."""
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(nside + B)
    maps = _crandn(rng, (B, g.nring, g.maxlen), cuda).to(dtype)
    m0, m1 = window
    full = sht.phase_stage(maps, nside, m1)
    win = sht.phase_stage(maps, nside, m1 - m0, m0)
    torch.cuda.synchronize()
    for w, f in zip(win, full):
        assert torch.equal(w, f[:, m0:m1])


# (nside, B, nm): one unit, a row tile and past it, nm up to 3 nside and
# past it (caps' bins fold), the timestream's shape (nside 256, B 8, lmax
# 229); each warp-row count of the plan (B 12, B 40), nm inside one stage,
# 32-pixel tiles (nside 8)
K4_INV_SHAPES = [(4, 1, 12), (16, 3, 48), (16, 33, 70), (32, 2, 20), (256, 8, 230),
                 (64, 12, 192), (32, 40, 20), (8, 2, 5)]


@pytest.mark.parametrize("dtype,rtol", [(torch.complex64, 1e-5), (torch.complex128, 1e-12)])
@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("shape", K4_INV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k4_phase_inv(cuda, shape, real, dtype, rtol):
    """K4's inverse against its plain version, real and complex forms, the
    padding slots zero, two launches bitwise equal."""
    nside, B, nm = shape
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(nside + B + nm)
    tp = _crandn(rng, (B, nm, g.nring), cuda).to(dtype)
    tn = None if real else _crandn(rng, (B, nm, g.nring), cuda).to(dtype)
    fn = lambda: sht.phase_stage_inv(tp, tn, nside, real)
    _check(sht.K4_INV, fn, lambda: sht.phase_stage_inv_ref(tp, tn, nside, real), rtol)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert not a[:, torch.as_tensor(g.mask, device=cuda) == 0].any()


@pytest.mark.parametrize("neg", [False, True], ids=["real", "complex"])
def test_synthesis_on_the_card(cuda, neg):
    """The whole inverse SHT (K14 and K4's inverse) against the CPU."""
    lmax, nside = 47, 16
    rng = np.random.default_rng(3)
    pos = _crandn(rng, (2, 3, lmax + 1, lmax + 1), torch.device("cpu")).to(torch.complex128)
    nalm = _crandn(rng, (2, 3, lmax + 1, lmax), torch.device("cpu")).to(torch.complex128)
    if neg:
        fn = lambda p, n: sht.synthesis_complex(p, n, nside)
    else:
        fn = lambda p, n: sht.synthesis_real(p, nside)
    before = sht.K14.launches, sht.K4_INV.launches
    got = fn(pos.to(cuda), nalm.to(cuda)).cpu()
    assert (sht.K14.launches, sht.K4_INV.launches) == (before[0] + 1, before[1] + 1)
    want = fn(pos, nalm)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())


def _check_gram(kernel, fn, ref, rtol):
    """A Gram kernel against its plain version, and its contract: the lower
    triangle bitwise the conjugate of the upper (real diagonal), and a
    second run bitwise equal to the first (the split-l sum has a fixed
    order)."""
    _check(kernel, fn, ref, rtol)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, a.transpose(-1, -2).conj().resolve_conj())


# (M, F, S, npol, nl, K): ragged n and width, the bench's path shape (n 352,
# width 1840) and the polarised leg's npol 4 factor
K9_SHAPES = [(3, 7, 10, 1, 70, 5), (2, 8, 44, 1, 230, 8), (2, 4, 80, 4, 121, 4)]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", K9_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k9_signal_gram(cuda, shape, dtype):
    M, F, S, npol, nl, K = shape
    rng = np.random.default_rng(9)
    b = _crandn(rng, (M, F, S, npol, nl), cuda).to(dtype)
    L = torch.as_tensor(rng.standard_normal((nl, npol, F, K)), device=cuda).to(
        torch.float32 if dtype == torch.complex64 else torch.float64
    )
    _check_gram(fpencil.K9, lambda: fpencil.signal_gram(b, L),
                lambda: fpencil.signal_gram_ref(b, L), 1e-5)


# (k, F, S, nl, nlp, nb, Kb): ragged k around the tile edge (the path's k is
# the batch's largest retained count), and k = n at the bench's band table
K13_SHAPES = [(k, 4, 10, 50, 64, 3, 5) for k in (1, 17, 64, 65, 130)] + [
    (352, 8, 44, 230, 256, 4, 8)
]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", K13_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k13_fisher_cov(cuda, shape, dtype):
    k, F, S, nl, nlp, nb, Kb = shape
    rng = np.random.default_rng(13)
    v = _crandn(rng, (2, k, F, S), cuda).to(dtype)
    bt = _crandn(rng, (2, F, S, nl), cuda).to(dtype)
    lb = torch.as_tensor(rng.standard_normal((nb, nlp, F, Kb)), device=cuda).to(
        torch.float32 if dtype == torch.complex64 else torch.float64
    )
    _check_gram(mstep.K13, lambda: mstep.fisher_cov(v, bt, lb),
                lambda: mstep.fisher_cov_ref(v, bt, lb), 1e-4)


def test_gram_refuses_a_short_split_scratch(cuda, monkeypatch):
    """The engine holds the split scratch it is given against its own tile
    size, so a plan that disagrees with the header fails at launch."""
    rng = np.random.default_rng(5)
    b = _crandn(rng, (8, 8, 44, 1, 230), cuda)
    L = torch.as_tensor(rng.standard_normal((230, 1, 8, 8)), dtype=torch.float32, device=cuda)
    launch = backend.gram_launch

    def short(*args):
        part, (ptr, nbytes, nsplit, cps) = launch(*args)
        assert nsplit > 1
        return part, (ptr, nbytes - 8, nsplit, cps)

    monkeypatch.setattr(backend, "gram_launch", short)
    with pytest.raises(RuntimeError):
        fpencil.signal_gram(b, L)


def test_wrappers_reject_lazy_conjugates(cuda):
    rng = np.random.default_rng(1)
    v = _crandn(rng, (1, 4, 2, 3), cuda)
    bt = _crandn(rng, (1, 2, 3, 5), cuda)
    lb = torch.ones((1, 8, 2, 1), device=cuda)
    with pytest.raises(ValueError):
        mstep.fisher_cov(v.conj(), bt, lb)


# (nkl, F, nl, nb): ragged nkl around the 64-wide tile, one band, and the
# bench cylinder's band form at a product run's size (nkl 52: one tile per
# band, its chunks split across blocks) and at nkl = n = 352
K15A_BAND = [(1, 3, 11, 1), (17, 3, 11, 3), (64, 2, 40, 2), (65, 5, 33, 1), (52, 8, 230, 4),
             (352, 8, 230, 4)]
K15_DTYPES = [(torch.complex128, 1e-12), (torch.complex64, 1e-5)]


@pytest.mark.parametrize("dtype,rtol", K15_DTYPES)
@pytest.mark.parametrize("shape", K15A_BAND, ids=lambda s: "x".join(map(str, s)))
def test_k15a_sandwich_band_form(cuda, shape, dtype, rtol):
    nkl, F, nl, nb = shape
    rng = np.random.default_rng(15)
    g = _crandn(rng, (nkl, F, nl), cuda).to(dtype)
    cl = torch.as_tensor(rng.standard_normal((nb, nl, F, F)), device=cuda).to(
        backend.real_dtype(dtype)
    )
    _check(projections.K15A, lambda: projections.band_covariance_projection(g, cl),
           lambda: projections.sandwich_ref(g[None], g[None], cl), rtol)


@pytest.mark.parametrize("dtype,rtol", K15_DTYPES)
@pytest.mark.parametrize("shape", [(3, 5, 1, 9), (3, 5, 4, 9), (8, 44, 1, 230), (4, 80, 4, 121)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k15a_sandwich_sky_form(cuda, shape, dtype, rtol):
    """Two different outer operands per batch item (a frequency pair), a
    result that is not Hermitian item by item, npol 1 and 4."""
    F, S, npol, nl = shape
    rng = np.random.default_rng(16)
    beam = _crandn(rng, (F, S, npol, nl), cuda).to(dtype)
    cl = torch.as_tensor(rng.standard_normal((npol, npol, nl, F, F)), device=cuda).to(
        backend.real_dtype(dtype)
    )
    want = torch.einsum("fapl,pqlfg,gbql->fagb", beam, cl.to(dtype), beam.conj())
    _check(projections.K15A, lambda: projections.sky_covariance_projection(beam, cl),
           lambda: want, rtol)
    beam5 = torch.stack([beam, 2 * beam])
    got = projections.sky_covariance_projection_m(beam5, cl)
    assert float((got[1] - 4 * want).abs().max()) <= 4 * rtol * float(want.abs().max())


def test_k15a_sandwich_index_arrays(cuda):
    rng = np.random.default_rng(17)
    x = _crandn(rng, (2, 70, 3, 7), cuda).to(torch.complex128)
    y = _crandn(rng, (3, 66, 2, 7), cuda).to(torch.complex128)
    c = torch.as_tensor(rng.standard_normal((4, 7, 3, 2)), device=cuda)
    ix, iy, ic = [1, 0, 1, 1, 0], [2, 2, 0, 1, 1], [3, 0, 1, 2, 3]
    _check(projections.K15A, lambda: projections.sandwich(x, y, c, ix, iy, ic),
           lambda: projections.sandwich_ref(x, y, c, ix, iy, ic), 1e-12)
    with pytest.raises(ValueError):
        projections.sandwich(x, y.conj(), c, ix, iy, ic)
    with pytest.raises(TypeError):
        projections.sandwich(x, y.to(torch.complex64), c, ix, iy, ic)


def test_k15a_sandwich_split_plan(cuda, monkeypatch):
    """Split and unsplit launches agree; a plan that leaves chunks
    uncovered, or a cluster wider than 8, is refused at launch."""
    rng = np.random.default_rng(19)
    g = _crandn(rng, (52, 8, 230), cuda).to(torch.complex128)
    cl = torch.as_tensor(rng.standard_normal((4, 230, 8, 8)), device=cuda)
    plan = projections.sandwich_plan(4, 52, 52, 8, 230, backend.sm_count(cuda))
    assert plan.nsplit > 1
    split = projections.band_covariance_projection(g, cl)
    for tile in (32, 64):
        whole = projections.SandwichPlan(tile, 8, 115, 1, 115)
        monkeypatch.setattr(projections, "sandwich_plan", lambda *a: whole)
        got = projections.band_covariance_projection(g, cl)
        assert float((split - got).abs().max()) <= 1e-12 * float(got.abs().max())
    for bad in (projections.SandwichPlan(32, 8, 115, 2, 115 // 2 - 1),
                projections.SandwichPlan(32, 8, 115, 9, 13)):
        monkeypatch.setattr(projections, "sandwich_plan", lambda *a: bad)
        with pytest.raises(RuntimeError):
            projections.band_covariance_projection(g, cl)


# (B, n, m, Cc, Cd, nl, Nx, Ny, Nc): n = m = 1; n and m off the tile edges;
# Cc != Cd, Cd above 16 (two d groups a chunk row) and Cd = 3 (a chunk of
# 15 slots); a batch of 4096 one-element outputs; a 130 x 129 output (64
# tiles, split)
K15A_EDGES = [
    (1, 1, 1, 1, 1, 1, 1, 1, 1), (3, 33, 70, 3, 5, 19, 2, 4, 3),
    (2, 65, 31, 2, 17, 7, 2, 2, 1), (4096, 5, 3, 2, 1, 4, 7, 5, 3),
    (2, 130, 129, 1, 3, 40, 3, 1, 2),
]


@pytest.mark.parametrize("where", ["host", "device"])
@pytest.mark.parametrize("dtype,rtol", K15_DTYPES)
@pytest.mark.parametrize("shape", K15A_EDGES, ids=lambda s: "x".join(map(str, s[:6])))
def test_k15a_sandwich_edges(cuda, shape, dtype, rtol, where):
    """The kernel against its plain version with index arrays given on the
    host (range-checked, uploaded) or on the card (used as they are), and
    two launches bitwise equal."""
    B, n, m, cc, cd, nl, nx, ny, nc = shape
    rng = np.random.default_rng(sum(shape))
    x = _crandn(rng, (nx, n, cc, nl), cuda).to(dtype)
    y = _crandn(rng, (ny, m, cd, nl), cuda).to(dtype)
    c = torch.as_tensor(rng.standard_normal((nc, nl, cc, cd)), device=cuda).to(
        backend.real_dtype(dtype)
    )
    idx = [rng.integers(0, k, B) for k in (nx, ny, nc)]
    if where == "device":
        idx = [torch.as_tensor(i.astype(np.int32), device=cuda) for i in idx]
    _check(projections.K15A, lambda: projections.sandwich(x, y, c, *idx),
           lambda: projections.sandwich_ref(x, y, c, *idx), rtol)
    a = projections.sandwich(x, y, c, *idx)
    b = projections.sandwich(x, y, c, *idx)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_k15a_sandwich_empty_basis(cuda):
    """nkl = 0 (an m with no KL modes): an empty result and no launch."""
    g = torch.zeros((0, 8, 230), dtype=torch.complex128, device=cuda)
    cl = torch.ones((4, 230, 8, 8), dtype=torch.float64, device=cuda)
    before = projections.K15A.launches
    out = projections.band_covariance_projection(g, cl)
    assert out.shape == (4, 0, 0) and projections.K15A.launches == before


@pytest.mark.parametrize("dtype,rtol", [(torch.complex128, 1e-12), (torch.complex64, 1e-12)])
@pytest.mark.parametrize("k,na,nb", [(1, 1, 1), (17, 3, 2), (64, 2, 2), (65, 1, 3), (352, 4, 4)])
def test_k15b_fisher_trace(cuda, k, na, nb, dtype, rtol):
    """Non-Hermitian C_b: the kernel takes C_b[j, i], not conj(C_b[i, j])."""
    rng = np.random.default_rng(18)
    ca = _crandn(rng, (na, k, k), cuda).to(dtype)
    cb = _crandn(rng, (nb, k, k), cuda).to(dtype)
    w = torch.as_tensor(rng.random(k), device=cuda).to(backend.real_dtype(dtype))
    _check(projections.K15B, lambda: projections.fisher_trace(ca, cb, w),
           lambda: projections.fisher_trace_ref(ca, cb, w), rtol)
    # the batched form of the fused Fisher step
    cam, cbm, wm = torch.stack([ca, 2 * ca]), torch.stack([cb, cb]), torch.stack([w, w])
    _check(projections.K15B, lambda: projections.fisher_trace(cam, cbm, wm),
           lambda: projections.fisher_trace_ref(cam, cbm, wm), rtol)


@pytest.mark.parametrize("dtype,rtol", [(torch.complex128, 1e-12), (torch.complex64, 1e-12)])
@pytest.mark.parametrize("k", [1, 17, 65, 352])
@pytest.mark.parametrize("M", [1, 8])
def test_k15b_one_stack_symmetric_path(cuda, dtype, rtol, k, M):
    """One stack as C_a and C_b (every path's call) takes the symmetric
    form: it agrees with the general form on a copy (``clone``: other
    storage) and the plain version, is exactly symmetric, and repeats
    bitwise."""
    rng = np.random.default_rng(19)
    c = _crandn(rng, (M, 4, k, k), cuda).to(dtype)
    w = torch.as_tensor(rng.random((M, k)), device=cuda).to(backend.real_dtype(dtype))
    _check(projections.K15B, lambda: projections.fisher_trace(c, c, w),
           lambda: projections.fisher_trace_ref(c, c, w), rtol)
    general = projections.fisher_trace(c, c.clone(), w)
    a, b = projections.fisher_trace(c, c, w), projections.fisher_trace(c, c, w)
    torch.cuda.synchronize()
    assert float((a - general).abs().max()) <= rtol * float(general.abs().max())
    assert torch.equal(a, b) and torch.equal(a, a.transpose(-1, -2))


def test_k15b_one_stack_of_many_bands(cuda):
    """One stack of more than TRACE_BANDS bands takes the general form, band
    tile by band tile (9 bands: 3 x 3 band-tile pairs)."""
    rng = np.random.default_rng(21)
    c = _crandn(rng, (2, 9, 40, 40), cuda).to(torch.complex128)
    w = torch.as_tensor(rng.random((2, 40)), device=cuda)
    _check(projections.K15B, lambda: projections.fisher_trace(c, c, w),
           lambda: projections.fisher_trace_ref(c, c, w), 1e-12)


@pytest.mark.parametrize("dtype,rtol", [(torch.complex128, 1e-12), (torch.complex64, 1e-12)])
def test_k15b_hermitian_stack(cuda, dtype, rtol):
    """A Hermitian stack as the fused Fisher step gives it (M 8, 4 bands,
    k 52, float32 weights with zeroed padding slots): F is real up to
    rounding, and held against the plain version."""
    rng = np.random.default_rng(20)
    x = _crandn(rng, (8, 4, 52, 52), cuda).to(dtype)
    c = (x + x.mH).contiguous()
    w = torch.as_tensor(rng.random((8, 52)), device=cuda).to(torch.float32)
    w[:, :7] = 0.0
    _check(projections.K15B, lambda: projections.fisher_trace(c, c, w),
           lambda: projections.fisher_trace_ref(c, c, w), rtol)
    f = projections.fisher_trace(c, c, w)
    assert float(f.imag.abs().max()) <= rtol * float(f.real.abs().max())


def test_k15b_fisher_trace_empty_and_strict(cuda):
    z = torch.zeros((3, 0, 0), dtype=torch.complex128, device=cuda)
    out = projections.fisher_trace(z, z, torch.zeros(0, dtype=torch.float64, device=cuda))
    assert out.shape == (3, 3) and not out.any()
    c = torch.ones((2, 4, 4), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):
        projections.fisher_trace(c, c.cpu(), torch.ones(4, device=cuda))
    with pytest.raises(ValueError):
        projections.fisher_trace(c, c.transpose(-1, -2), torch.ones(4, device=cuda))


def test_probe_double(cuda):
    x = torch.arange(1000 * 1001, dtype=torch.float32, device=cuda).reshape(1000, 1001)
    _check(probe.PROBE_DOUBLE, lambda: probe.double(x), lambda: probe.double_ref(x), 0.0)


def _check_repeats(kernel, fn, ref, rtol):
    """_check, then a second launch bitwise equal to the first."""
    _check(kernel, fn, ref, rtol)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,shift", [(999 * 1001, 0), (1000 * 1001, 1), (999 * 1001, 3),
                                     (3, 1), (8192 * 33, 2)])
def test_probe_double_head_tail(cuda, n, shift):
    """An odd count (scalar tail) and views whose data pointer is not
    16-byte aligned (scalar head; the output shares the offset)."""
    base = torch.arange(n + shift, dtype=torch.float32, device=cuda) - 7.5
    x = base[shift:]
    assert x.data_ptr() % 16 == 4 * shift
    _check_repeats(probe.PROBE_DOUBLE, lambda: probe.double(x), lambda: probe.double_ref(x), 0.0)
    assert probe.double(x).data_ptr() % 16 == 4 * shift


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
def test_probe_mm(cuda, dtype, rtol):
    rng = np.random.default_rng(2)
    # ragged shapes exercise the kernel's edge masks
    a = torch.as_tensor(rng.standard_normal((130, 70)), dtype=dtype, device=cuda)
    b = torch.as_tensor(rng.standard_normal((70, 97)), dtype=dtype, device=cuda)
    _check(probe.PROBE_MM, lambda: probe.mm(a, b), lambda: probe.mm_ref(a, b), rtol)


_MM_CASES = {
    "probe 1024^3 (TMA)": (1024, 1024, 1024, 0),
    "one tile": (64, 128, 16, 0),
    "K 1000": (256, 192, 1000, 0),
    "aligned, ragged tiles": (200, 136, 256, 0),
    "unaligned pointer": (150, 96, 128, 1),
}


@pytest.mark.parametrize("case", sorted(_MM_CASES))
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
def test_probe_mm_cases(cuda, dtype, rtol, case):
    """mm against mm_ref by the wrapper's own plan, two launches bitwise
    equal; ``shift`` elements of offset put A's and B's data pointers off
    16-byte alignment (the staged route)."""
    M, N, K, shift = _MM_CASES[case]
    rng = np.random.default_rng(3)

    def operand(rows, cols):
        flat = torch.as_tensor(rng.standard_normal(rows * cols + shift), dtype=dtype,
                               device=cuda)
        return flat[shift:].view(rows, cols)

    a, b = operand(M, K), operand(K, N)
    plan = probe.mm_plan(M, N, K, dtype, (K, N), probe._align(a.data_ptr(), b.data_ptr()),
                         backend.sm_count(cuda))
    assert plan.route == ("staged" if shift else "tma")
    _check_repeats(probe.PROBE_MM, lambda: probe.mm(a, b), lambda: probe.mm_ref(a, b), rtol)


@pytest.mark.parametrize("route", ["tma", "staged"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
def test_probe_mm_every_width(cuda, dtype, rtol, route):
    """Every tile width of either route, forced, on a shape ragged in all
    three dimensions (rows 16-byte aligned, so either route applies)."""
    rng = np.random.default_rng(4)
    M, N, K = 200, 456, 264
    a = torch.as_tensor(rng.standard_normal((M, K)), dtype=dtype, device=cuda)
    b = torch.as_tensor(rng.standard_normal((K, N)), dtype=dtype, device=cuda)
    for nw in probe.MM_WIDTHS[dtype]:
        plan = probe.MMPlan(route, nw, (0, 0))
        _check_repeats(probe.PROBE_MM, lambda: probe.mm_launch(a, b, plan),
                       lambda: probe.mm_ref(a, b), rtol)


def _small_products(outdir, kl=True, **cfg):
    conf = {
        "config": {"beamtransfers": True, "kltransform": kl, "skip_svd": not kl,
                   "output_directory": str(outdir), **cfg},
        "telescope": dict(type="UnpolarisedCylinder", num_freq=4, freq_start=400.0,
                          freq_end=410.0, freq_mode="edge", num_cylinders=2,
                          cylinder_width=3.0, num_feeds=3, feed_spacing=1.0, tsys=10.0,
                          single_precision=True),
    }
    if kl:
        conf["kltransform"] = [{"type": "KLTransform", "name": "kl", "threshold": 0.1}]
    return conf


def test_chunked_generate_matches_resident_on_the_card(cuda, tmp_path):
    """The chunked route in two chunks (K1+K2 and K3+K5 on the card) writes
    the resident route's files, bit for bit."""
    from driftscan_tpu_torch.core import manager
    from driftscan_tpu_torch.util import store

    res = manager.ProductManager(device=cuda).apply_config(
        _small_products(tmp_path / "res", kl=False, resident="always"))
    res.generate()
    tel = res.telescope
    unit = tel.num_pol_sky * (tel.lmax + 1) * 2 * (tel.mmax + 1) * 16.0
    half = (tel.nfreq * tel.npairs) // 2 + 1
    backend.reset_launch_counts()
    m = manager.ProductManager(device=cuda).apply_config(_small_products(
        tmp_path / "chunked", kl=False, resident="never", mem_chunk=half * unit / 2**30))
    m.generate()
    torch.cuda.synchronize()
    assert m.beamtransfer.num_chunks == 2 and m.beamtransfer._mem_beam is None
    assert kernels.K1K2.launches > 0 and sht.K3K5.launches > 0
    for mi in range(tel.mmax + 1):
        with store.File(m.beamtransfer._mfile(mi), "r") as f, \
                store.File(res.beamtransfer._mfile(mi), "r") as g:
            assert np.array_equal(f["beam_m"][:], g["beam_m"][:]), mi


def test_q_estimator_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The device q estimator (whitening, KL -> SVD -> sky, all bands in
    one contraction) on the card against the same estimator on the CPU,
    over one product directory."""
    from driftscan_tpu_torch.core import manager, psmc

    conf = _small_products(tmp_path / "out")
    manager.ProductManager(device=cuda).apply_config(conf).generate()
    entry = {"klname": "kl", "threshold": 0.1, "nsamples": 200, "seed": 3,
             "k_bands": [{"spacing": "linear", "start": 0.0, "stop": 0.25, "num": 3}]}
    ests = []
    for dev in (cuda, "cpu"):
        kl = manager.ProductManager(device=dev).apply_config(conf).kltransforms["kl"]
        ps = psmc.PSMonteCarlo.from_config(entry, kl, subdir=f"mc_{torch.device(dev).type}")
        ps.genbands()
        ests.append(ps)
    card, cpu = ests
    rng = np.random.default_rng(5)
    ms = [mi for mi in range(card.telescope.mmax + 1) if card.num_evals(mi) > 0][:4]
    assert ms
    for mi in ms:
        n = cpu.kltrans.modes_m(mi)[0].size
        x = rng.standard_normal((n, 7)) + 1j * rng.standard_normal((n, 7))
        y = rng.standard_normal((n, 7)) + 1j * rng.standard_normal((n, 7))
        for args in ((x,), (x, y, True)):
            got, want = card.q_estimator(mi, *args), cpu.q_estimator(mi, *args)
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
        f_card, b_card = card.fisher_bias_m(mi)
        f_cpu, b_cpu = cpu.fisher_bias_m(mi)
        assert np.abs(f_card - f_cpu).max() <= 1e-8 * np.abs(f_cpu).max()
        assert np.abs(b_card - b_cpu).max() <= 1e-8 * np.abs(b_cpu).max()


def test_two_ranks_on_the_card_match_one(cuda, tmp_path):
    """``drift-makeproducts-torch run`` under torchrun with two ranks on the
    card (both on the one card of a one-card host): the chunked route's
    beam files bit for bit those of one rank, the KL spectra and Fisher
    matrix within 1e-10, and every kernel of the file path launched in
    each rank."""
    import json
    import os
    import signal
    import subprocess
    import sys

    import yaml

    from driftscan_tpu_torch.core import manager
    from driftscan_tpu_torch.util import store

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    confs = {}
    for kind in ("two", "one"):
        conf = _small_products(tmp_path / kind, resident="never", psfisher=True)
        conf["psfisher"] = [{"type": "Full", "name": "ps", "klname": "kl", "threshold": 0.1,
                             "k_bands": [{"spacing": "linear", "start": 0.0, "stop": 0.25,
                                          "num": 3}]}]
        confs[kind] = conf
    tel = manager.ProductManager(device=cuda).apply_config(confs["one"]).telescope
    unit = tel.num_pol_sky * (tel.lmax + 1) * 2 * (tel.mmax + 1) * 16.0
    for conf in confs.values():
        conf["config"]["mem_chunk"] = 3.5 * unit / 2**30  # three units a rank
    one = manager.ProductManager(device=cuda).apply_config(confs["one"])
    one.generate()

    cfg = tmp_path / "two.yaml"
    cfg.write_text(yaml.safe_dump(confs["two"]))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
    # its own session, so that the launcher's workers go with it on a timeout
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "driftscan_tpu_torch.scripts.makeproducts", "run", str(cfg),
         "--stats", str(tmp_path / "stats_{rank}.json")],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    for r in range(2):
        with open(tmp_path / f"stats_{r}.json") as f:
            st = json.load(f)
        assert st["size"] == 2 and st["device"].startswith("cuda")
        for name in ("k1k2_beam_vis", "k3k5_legendre_sht", "k9_signal_gram", "k15a_sandwich",
                     "k15b_fisher_trace"):
            assert st["launches"][name] > 0, (r, name)

    two = manager.ProductManager(device=cuda).apply_config(confs["two"])
    for mi in range(tel.mmax + 1):
        with store.File(two.beamtransfer._mfile(mi), "r") as f, \
                store.File(one.beamtransfer._mfile(mi), "r") as g:
            assert np.array_equal(f["beam_m"][:], g["beam_m"][:]), mi
    for a, b in ((two.kltransforms["kl"].evals_all(), one.kltransforms["kl"].evals_all()),
                 (two.psestimators["ps"].fisher_bias()[0], one.psestimators["ps"].fisher_bias()[0])):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()


# small and ragged shapes; the bench cylinder's slice (M 8, n 352, K 352,
# k 44), its escalated width (k 88) and the ns2 telescope's full size
# (M 1, n 3200, K 3200, k 400), each on the tile ops/cheb.py plans for it;
# n, K and k all off the tiles (and the 8-deep slices) at full size
K17_SHAPES = [(1, 5, 3, 2), (2, 70, 33, 17), (3, 130, 200, 45), (1, 64, 16, 32),
              (8, 352, 352, 44), (8, 352, 352, 88), (1, 3200, 3200, 400), (2, 1000, 1001, 131),
              (1, 3203, 3205, 403), (2, 333, 517, 83)]


def _k17_inputs(rng, shape, first, device):
    M, n, K, k = shape

    def c(*s):
        z = rng.standard_normal(s) + 1j * rng.standard_normal(s)
        return torch.as_tensor(z, device=device)

    y, w, vk, vp = c(M, n, K), c(M, K, k), c(M, n, k), None if first else c(M, n, k)
    alpha = torch.as_tensor(rng.random(M) + 0.5, device=device)
    beta, gamma = (-1.0, 0.0) if first else (-2.0, -1.0)
    return y, w, vk, vp, alpha, beta, gamma


def _scale_err(got, want):
    """Largest relative difference of the running scale 1 / (amax + 1e-30)."""
    return float(((1.0 / (got + 1e-30)) / (1.0 / (want + 1e-30)) - 1.0).abs().max())


@pytest.mark.parametrize("first", [False, True], ids=["step", "first"])
@pytest.mark.parametrize("shape", K17_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k17_cheb_step(cuda, shape, first):
    """V_out within 1e-12 of its max, the running scale within 1e-13 rel,
    two launches bit for bit."""
    args = _k17_inputs(np.random.default_rng(17), shape, first, cuda)
    _check(cheb.K17, lambda: cheb.cheb_step(*args), lambda: cheb.cheb_step_ref(*args), 1e-12)
    a = cheb.cheb_step(*args)
    b = cheb.cheb_step(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert _scale_err(a[1], cheb.cheb_step_ref(*args)[1]) <= 1e-13


@pytest.mark.parametrize("tile", cheb.TILES, ids=lambda t: "x".join(map(str, t)))
def test_k17_every_tile(cuda, tile):
    """Each tile the library is built with, forced at a ragged shape."""
    M, n, K, k = 2, 333, 517, 83
    args = _k17_inputs(np.random.default_rng(18), (M, n, K, k), False, cuda)
    mt, nt, wr, wc = tile[:4]
    p = cheb.ChebPlan(*tile, (-(-k // (wc * 8 * nt)), -(-n // (wr * 16 * mt)), M))
    _check(cheb.K17, lambda: cheb.cheb_step_launch(*args, p),
           lambda: cheb.cheb_step_ref(*args), 1e-12)
    a = cheb.cheb_step_launch(*args, p)
    b = cheb.cheb_step_launch(*args, p)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("shape", [(2, 70, 33, 17), (8, 352, 352, 44)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k17_nan_reaches_amax(cuda, shape):
    """A NaN in V_k reaches its batch element's amax (and V_out there); the
    other elements keep their finite amax."""
    y, w, vk, vp, alpha, beta, gamma = _k17_inputs(np.random.default_rng(19), shape, False,
                                                   cuda)
    vk[1, 5, 3] = complex(float("nan"), 0.0)
    out, amax = cheb.cheb_step(y, w, vk, vp, alpha, beta, gamma)
    ref, ref_amax = cheb.cheb_step_ref(y, w, vk, vp, alpha, beta, gamma)
    torch.cuda.synchronize()
    assert bool(torch.isnan(amax[1])) and bool(torch.isnan(ref_amax[1]))
    assert bool(torch.isnan(out[1, 5, 3].real))
    assert bool(torch.isfinite(amax[0])) and bool(torch.isfinite(amax[2:]).all())
    assert _scale_err(amax[0], ref_amax[0]) <= 1e-13


def test_k17_rejects_complex64(cuda):
    from driftscan_tpu_torch.ops import cheb

    y = torch.zeros((1, 4, 3), dtype=torch.complex64, device=cuda)
    w = torch.zeros((1, 3, 2), dtype=torch.complex64, device=cuda)
    v = torch.zeros((1, 4, 2), dtype=torch.complex64, device=cuda)
    with pytest.raises(TypeError):
        cheb.cheb_step(y, w, v, None, torch.ones(1, device=cuda), -1.0, 0.0)


def test_topband_engine_on_the_card(cuda):
    """kl_solve_qr_topband on CUDA tensors (K17 in the filter) against the
    same solve on the CPU (its plain version): the certificate equal,
    retained eigenvalues within rel 1e-9."""
    from driftscan_tpu_torch.ops import cheb

    rng = np.random.default_rng(11)
    n = 96
    a_s = rng.standard_normal((2, n, 60)) + 1j * rng.standard_normal((2, n, 60))
    a_s *= np.logspace(2.5, -4.5, 60)[None, None, :]
    a_f = rng.standard_normal((2, n, 40)) + 1j * rng.standard_normal((2, n, 40))
    a_f *= np.logspace(4, 0, 40)[None, None, :]
    before = cheb.K17.launches
    g, gok = fpencil.kl_solve_qr_topband(torch.as_tensor(a_s, device=cuda),
                                         torch.as_tensor(a_f, device=cuda), cut=0.1, k=24)
    assert cheb.K17.launches > before
    c, cok = fpencil.kl_solve_qr_topband(torch.as_tensor(a_s), torch.as_tensor(a_f), cut=0.1,
                                         k=24)
    assert torch.equal(gok.cpu(), cok) and bool(cok.all())
    ge, ce = g.evals.cpu().numpy(), c.evals.numpy()
    kept = ce > 0
    assert np.array_equal(ge > 0, kept) and kept.sum() > 10
    np.testing.assert_allclose(ge[kept], ce[kept], rtol=1e-9)


def test_oldcylinder_btm_on_the_card(cuda):
    """The legacy sinc-beam polarised cylinder's BTM on the card (host
    beams, K2-host Stokes, K3+K5) against the same tables on the CPU."""
    from driftscan_tpu_torch.parallel import resident
    from driftscan_tpu_torch.telescope import oldcylinder

    cfg = dict(num_freq=2, freq_start=400.0, freq_end=420.0, num_cylinders=2,
               cylinder_width=3.0, num_feeds=2, feed_spacing=0.75, single_precision=True,
               illumination_y=0.8, ortho_pol=False)
    tels = {d: oldcylinder.PolarisedCylinderTelescope.from_config(cfg, device=d)
            for d in (cuda, "cpu")}
    assert not tels["cpu"]._bank_beams_apply()
    bl, fi = [x.ravel() for x in np.meshgrid(np.arange(tels["cpu"].npairs),
                                             np.arange(tels["cpu"].nfreq), indexing="ij")]
    k2 = backend.KERNELS["k2_host_stokes"]
    before = k2.launches
    pg, ng = resident.btm_resident(tels[cuda], bl, fi)
    torch.cuda.synchronize()
    assert k2.launches > before
    pc, nc = resident.btm_resident(tels["cpu"], bl, fi)
    for g, c in ((pg, pc), (ng, nc)):
        assert float((g.cpu() - c).abs().max()) <= 1e-5 * float(c.abs().max())


def test_example_driver_on_the_card(cuda, tmp_path):
    """The port's copy of examples/disharray's driver on the card against
    the same driver on the CPU: its full map within 1e-6 of max."""
    from driftscan_tpu_torch.examples import disharray_driver
    from driftscan_tpu_torch.util import store

    maps = {}
    for dev in ("cuda", "cpu"):
        ts = disharray_driver.main(str(tmp_path / dev), device=None if dev == "cuda" else "cpu")
        with store.File(f"{ts.output_directory}/map_full.hdf5", "r") as f:
            maps[dev] = f["map"][:]
    assert maps["cuda"].shape == maps["cpu"].shape
    assert np.isfinite(maps["cuda"]).all()
    assert np.abs(maps["cuda"] - maps["cpu"]).max() <= 1e-6 * np.abs(maps["cpu"]).max()


def _pencil_pair(seed, n, device):
    """(a_s, a_f) complex128 on ``device``: a five-decade foreground and a
    three-decade signal."""
    rng = np.random.default_rng(seed)

    def u(p, q):
        return np.linalg.qr(rng.standard_normal((p, q)) + 1j * rng.standard_normal((p, q)))[0]

    a_f = (u(n, n) * 3e3 * np.logspace(0, -5, n)) @ u(2 * n, n).conj().T
    a_s = (u(n, n) * 3.0 * np.logspace(0, -3, n)) @ u(2 * n, n).conj().T
    return (torch.as_tensor(np.stack([a_s, 0.5 * a_s]), device=device),
            torch.as_tensor(np.stack([a_f, 2.0 * a_f]), device=device))


@pytest.mark.parametrize("kw", [
    dict(method="gram"), dict(method="gram", with_thermal=False),
    dict(method="gram", fg_k_cap=16, sig_k_cap=8), dict(method="qr", sig_k_cap=8),
])
def test_opt_in_engines_on_the_card(cuda, kw):
    """The gram engine and the quick-look caps (library linear algebra
    only) on the card against the same solve on the host, 1e-8 of each
    m's top."""
    a_s, a_f = _pencil_pair(3, 64, cuda)
    got = fpencil.kl_solve(a_s, a_f, **kw).evals.cpu()
    want = fpencil.kl_solve(a_s.cpu(), a_f.cpu(), **kw).evals
    assert torch.isfinite(got).all()
    assert float(((got - want).abs().amax(-1) / want.amax(-1)).max()) < 1e-8


@pytest.mark.parametrize("qr_impl,whiten", [("cholqr_split", "factored"),
                                            ("cholqr_split", "refined"),
                                            ("householder", "solve")])
def test_whitening_levers_on_the_card(cuda, monkeypatch, qr_impl, whiten):
    a_s, a_f = _pencil_pair(4, 64, cuda)
    want = fpencil.kl_solve(a_s.cpu(), a_f.cpu()).evals
    monkeypatch.setattr(fpencil, "_QR_IMPL", qr_impl)
    monkeypatch.setattr(fpencil, "_WHITEN_IMPL", whiten)
    got = fpencil.kl_solve(a_s, a_f).evals.cpu()
    assert float(((got - want).abs().amax(-1) / want.amax(-1)).max()) < 1e-8


@pytest.mark.parametrize("neg_m", [False, True], ids=["real", "complex"])
def test_sht_refinement_on_the_card(cuda, neg_m):
    """Two refinement steps: K14 and K3+K5 launch at each, and the alm sit
    within 1e-10 of max of the host's."""
    nside, lmax = 32, 63
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12 * nside**2))
    if neg_m:
        x = x + 1j * rng.standard_normal(x.shape)
    before = (sht.K3K5.launches, sht.K14.launches)
    got = sht.analysis_maps(torch.as_tensor(x, device=cuda), lmax, neg_m=neg_m, iters=2)
    torch.cuda.synchronize()
    assert sht.K3K5.launches == before[0] + 3 and sht.K14.launches == before[1] + 2
    want = sht.analysis_maps(torch.as_tensor(x), lmax, neg_m=neg_m, iters=2)
    for g, w in zip(got, want):
        if w is not None:
            assert float((g.cpu() - w).abs().max()) <= 1e-10 * float(w.abs().max())


def test_mesh_of_two_entries_matches_unsharded_batches(cuda):
    """``product_all_resident(mesh=)`` on a mesh of two entries of the card
    (two shards, two worker threads) at mbatch 4 against ``mesh=None`` at
    mbatch 2, sig_levels pinned: each shard runs the batch of one unsharded
    dispatch, so spectra and SVD mode counts bit for bit, the Fisher within
    1e-12 of max (summed in another order), every launch count equal
    (chip_smoke.py's ``[mesh]`` gate (a) at a small cylinder)."""
    import chip_smoke
    from driftscan_tpu_torch.parallel import mesh as meshmod
    from driftscan_tpu_torch.parallel import resident

    tel = cylinder.UnpolarisedCylinderTelescope.from_config(
        dict(num_freq=4, freq_start=400.0, freq_end=410.0, freq_mode="edge", num_cylinders=2,
             cylinder_width=3.0, num_feeds=3, feed_spacing=1.0, single_precision=True),
        device=cuda,
    )
    bl, fi = np.arange(tel.npairs), np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    cl_s, cl_n, noisew = chip_smoke.covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    blt = mstep.band_factor_table(iter(chip_smoke.fisher_bands(tel)), out_dtype=np.float32,
                                  rank_rtol=1e-9)
    pos, neg = resident.btm_resident(tel, blg, fig)
    kw = dict(band_lt=blt, ps_threshold=1e-3, sig_levels=2, bucket=False, max_m=16)
    runs = []
    for mesh, mb in ((meshmod.make_mesh([cuda, cuda]), 4), (None, 2)):
        backend.reset_launch_counts()
        out = resident.product_all_resident(tel, pos, neg, ls, lf, noisew, mesh=mesh,
                                            mbatch=mb, **kw)
        torch.cuda.synchronize()
        runs.append((out, {k.name: k.launches for k in backend.KERNELS.values()}))
    ((ev2, nm2, f2), l2), ((ev1, nm1, f1), l1) = runs
    assert np.array_equal(ev2, ev1) and np.array_equal(nm2, nm1)
    assert np.abs(f1).max() > 0 and np.abs(f2 - f1).max() <= 1e-12 * np.abs(f1).max()
    assert l2 == l1 and l1["k13_fisher_cov"] > 0 and l1["k15b_fisher_trace"] > 0


# each kernel's wrapper through one of the tests above, on tensors of a
# second card
_ON_SECOND_CARD = {
    "k1k2_beam_vis": lambda d: test_k1k2_beam_vis(d),
    "k1k2_stokes_vis": lambda d: test_k1k2_stokes_vis(d, {}, 4),
    "k2_host_vis": lambda d: test_k2_host_vis(d, torch.float32, 1e-5, True, 1000),
    "k2_host_stokes": lambda d: test_k2_host_stokes(d, torch.float64, 1e-10, False, 4),
    "k3k5_legendre_sht": lambda d: test_k3k5_legendre_sht(d, torch.complex64),
    "k14_legendre_synth": lambda d: test_k14_legendre_synth(
        d, K14_SHAPES[0], True, torch.complex128, 1e-10),
    "k4_phase": lambda d: test_k4_phase(d, K4_SHAPES[1], torch.complex64, 1e-5),
    "k4_phase_inv": lambda d: test_k4_phase_inv(d, K4_INV_SHAPES[1], False, torch.complex128,
                                                1e-12),
    "k9_signal_gram": lambda d: test_k9_signal_gram(d, K9_SHAPES[1], torch.complex64),
    "k13_fisher_cov": lambda d: test_k13_fisher_cov(d, K13_SHAPES[-1], torch.complex64),
    "k15a_sandwich": lambda d: test_k15a_sandwich_band_form(
        d, K15A_BAND[4], torch.complex128, 1e-12),
    "k15b_fisher_trace": lambda d: test_k15b_fisher_trace(d, 65, 1, 3, torch.complex64, 1e-12),
    "k17_cheb_step": lambda d: test_k17_cheb_step(d, K17_SHAPES[1], False),
    "probe_double": lambda d: test_probe_double(d),
    "probe_mm": lambda d: test_probe_mm(d, torch.float32, 1e-5),
}


@pytest.mark.parametrize("name", sorted(_ON_SECOND_CARD))
def test_wrappers_launch_on_their_tensors_card(cuda, name):
    """Every wrapper launches on its tensors' card (``backend.launch``
    enters it around the C call): the kernel's test on tensors of cuda:1
    while cuda:0 is the current device, against its plain version there.
    Skips below two cards."""
    assert set(_ON_SECOND_CARD) == set(backend.KERNELS)
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: tensors of cuda:1 while cuda:0 is current")
    with torch.cuda.device(0):
        _ON_SECOND_CARD[name](torch.device("cuda", 1))
        assert torch.cuda.current_device() == 0
