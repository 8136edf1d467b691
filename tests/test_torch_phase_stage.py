"""The SHT's phase stage (K4) and its inverse in driftscan_tpu_torch against
the JAX package on the CPU.

On the CPU ``phase_stage`` and ``phase_stage_inv`` take their plain
versions (one FFT a ring length); the card's kernels (``csrc/
phase_stage.cu``) are held against those in tests/test_torch_cuda.py.
Here the plain versions meet the JAX package's own phase stage -- the
einsum of its analysis and synthesis bodies against ``e^{-+i m phi}`` built
from ``_phase_angle`` (the integer-reduced angle tables) -- in complex64
and complex128, over the full m range and over windows whose m pass the
polar rings' N_r (there the FFT's bin wraps while the phase keeps the true
m), and a numpy float64 direct sum, the truth for both.  The inverse also
runs through the port's ``_synthesis`` against JAX ``synthesis_real`` and
``synthesis_complex``.

Tolerances: 1e-5 of the largest entry in complex64 (float32 sums of up to
4 nside terms in two orders, and float32 angles), 1e-12 in complex128;
``_synthesis``, whose Legendre stage sums its recurrence's lambda in
another order than the JAX table, 1e-10 and 1e-4 as
tests/test_torch_synthesis.py.  Few torch threads, nside 4 to 32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driftscan_tpu.ops import sht as jsht
from driftscan_tpu_torch import backend
from driftscan_tpu_torch.ops import healpix, sht

TIERS = {np.complex64: 1e-5, np.complex128: 1e-12}
# (nside, m0, nm): the full range at 3 nside (m up to 3 nside - 1 > the
# first rings' 4, 8, ... pixels), windows from m0 = 0, windows wholly past
# the cap rings' N_r (m0 40 at nside 16: rings of 4..36 pixels wrap), one m
CASES = [(4, 0, 12), (16, 0, 48), (16, 5, 23), (16, 40, 9), (32, 100, 7), (8, 29, 1)]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _maps(nside, B, seed, dtype):
    """Seeded padded maps (B, nring, maxlen), padding slots zero."""
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(seed)
    shape = (B, g.nring, g.maxlen)
    m = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * g.mask
    return m.astype(dtype)


def _coeffs(nside, B, nm, seed, dtype):
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(seed)
    shape = (B, nm, g.nring)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _jax_phase(nside, m0, nm, dtype):
    """The JAX package's e^{i m phi} (nm, nring, maxlen), masked: the
    integer-reduced angle of ``_phase_angle`` in the dtype's real type."""
    rdt = jnp.float64 if dtype == np.complex128 else jnp.float32
    g = jsht.geom_arrays(nside)
    phase = jsht._phase_angle(jnp.arange(m0, m0 + nm), g, nside, rdt)
    mr = g.mask[None].astype(rdt)
    return jnp.cos(phase) * mr + 1j * (jnp.sin(phase) * mr)


def _exact_phase(nside, m0, nm):
    """numpy float64 e^{i m phi} (nm, nring, maxlen), masked."""
    g = healpix.ring_geometry(nside)
    m = np.arange(m0, m0 + nm, dtype=np.float64)[:, None, None]
    return np.exp(1j * m * g.phi[None]) * g.mask[None]


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("nside", [1, 2, 4, 32, 512])
def test_phase_groups_cover_every_ring(nside):
    """Each ring in exactly one group; a group's rings share N and h, are
    evenly spaced from the first, longest N first; the belt's two parities
    hold 2 nside + 1 rings and the caps pair ring i with 4 nside - i."""
    g = healpix.ring_geometry(nside)
    grp = sht.phase_groups(nside)
    assert grp.dtype == np.int32 and grp.shape[1] == 5
    h = np.rint(g.phi0 * g.nphi / np.pi).astype(np.int64)
    seen = np.zeros(g.nring, int)
    for n, hh, nr, first, stride in grp.tolist():
        rings = first + stride * np.arange(nr)
        seen[rings] += 1
        assert (g.nphi[rings] == n).all() and (h[rings] == hh).all()
        if n < 4 * nside:  # a polar cap's pair
            i = n // 4
            assert nr == 2 and hh == 1 and rings.tolist() == [i - 1, 4 * nside - i - 1]
    assert (seen == 1).all()
    assert (np.diff(grp[:, 0]) <= 0).all()
    belt = grp[grp[:, 0] == 4 * nside]
    assert sorted(belt[:, 2].tolist()) == sorted([nside + 1, nside])


@pytest.mark.parametrize("nside,B,rows", [(1, 3, 64), (4, 1, 32), (16, 5, 64), (32, 16, 32)])
def test_phase_tiles_cover_every_row(nside, B, rows):
    """The launch's tiles take every (unit, ring) row of every group once."""
    grp = sht.phase_groups(nside)
    tiles = sht.phase_tiles(nside, B, rows)
    assert tiles.dtype == np.int32 and tiles.shape[1] == 2
    got = set()
    for gi, r0 in tiles.tolist():
        nrows = B * int(grp[gi, 2])
        assert 0 <= r0 < nrows and r0 % rows == 0
        got.update((gi, q) for q in range(r0, min(r0 + rows, nrows)))
    assert len(got) == B * healpix.ring_geometry(nside).nring
    assert tiles[:, 0].tolist() == sorted(tiles[:, 0].tolist())


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_phase_stage_matches_jax(case, dtype):
    """F and G of the plain version against the JAX package's einsum of
    the padded maps with e^{-+i m phi} from ``_phase_angle``."""
    nside, m0, nm = case
    maps = _maps(nside, 3, seed=nside + m0 + nm, dtype=dtype)
    e = _jax_phase(nside, m0, nm, dtype)
    want_f = np.asarray(jnp.einsum("brj,mrj->bmr", maps, jnp.conj(e)))
    want_g = np.asarray(jnp.einsum("brj,mrj->bmr", maps, e))
    F, G = sht.phase_stage(torch.as_tensor(maps), nside, nm, m0)
    assert F.dtype == G.dtype == torch.as_tensor(maps).dtype
    _close(F, want_f, TIERS[dtype])
    _close(G, want_g, TIERS[dtype])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_phase_stage_matches_direct_sum(case, dtype):
    """The plain version against the float64 direct sum over each ring's
    pixels (the truth)."""
    nside, m0, nm = case
    maps = _maps(nside, 2, seed=7 * nside + m0, dtype=dtype)
    e = _exact_phase(nside, m0, nm)
    wide = maps.astype(np.complex128)
    F, G = sht.phase_stage(torch.as_tensor(maps), nside, nm, m0)
    _close(F, np.einsum("brj,mrj->bmr", wide, e.conj()), TIERS[dtype])
    _close(G, np.einsum("brj,mrj->bmr", wide, e), TIERS[dtype])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
def test_phase_stage_window_columns_equal_full_range(dtype):
    """A window's columns are the full range's, bit for bit, wherever the
    window starts (the rule the card's kernel keeps too)."""
    nside, nmax = 16, 48
    maps = torch.as_tensor(_maps(nside, 2, seed=3, dtype=dtype))
    full = sht.phase_stage(maps, nside, nmax)
    for m0, m1 in ((0, 9), (5, 23), (40, 48)):
        win = sht.phase_stage(maps, nside, m1 - m0, m0)
        for w, f in zip(win, full):
            assert torch.equal(w, f[:, m0:m1])


# (nside, nm): m up to 3 nside - 1 and past it (the caps' bins fold)
INV_CASES = [(4, 12), (16, 48), (16, 70), (32, 20)]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("case", INV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_phase_stage_inv_matches_jax(case, real, dtype):
    """The inverse's plain version against the JAX package's synthesis
    bodies: ``einsum("bmr,mrj->brj", T w, e^{+i m phi})`` (real part, w_0
    = 1, w_{m>0} = 2) for a real field, ``T+ e^{+i m phi} + T- e^{-i m
    phi}`` for a complex one."""
    nside, nm = case
    tp = _coeffs(nside, 3, nm, seed=nside + nm, dtype=dtype)
    tn = None if real else _coeffs(nside, 3, nm, seed=nside + nm + 1, dtype=dtype)
    e = _jax_phase(nside, 0, nm, dtype)
    if real:
        w = jnp.where(jnp.arange(nm) == 0, 1.0, 2.0).astype(e.real.dtype)
        want = jnp.einsum("bmr,mrj->brj", tp * w[None, :, None], e).real
    else:
        want = jnp.einsum("bmr,mrj->brj", tp, e) + jnp.einsum("bmr,mrj->brj", tn, jnp.conj(e))
    got = sht.phase_stage_inv(torch.as_tensor(tp), None if tn is None else torch.as_tensor(tn),
                              nside, real)
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    _close(got, want, TIERS[dtype])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("case", INV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_phase_stage_inv_matches_direct_sum(case, real, dtype):
    """The inverse's plain version against the float64 direct sum over m
    (the truth); padding slots zero."""
    nside, nm = case
    g = healpix.ring_geometry(nside)
    tp = _coeffs(nside, 2, nm, seed=5 * nside + nm, dtype=dtype)
    tn = None if real else _coeffs(nside, 2, nm, seed=5 * nside + nm + 1, dtype=dtype)
    e = _exact_phase(nside, 0, nm)
    if real:
        w = np.where(np.arange(nm) == 0, 1.0, 2.0)
        want = np.einsum("bmr,mrj->brj", tp.astype(np.complex128) * w[None, :, None], e).real
    else:
        want = (np.einsum("bmr,mrj->brj", tp.astype(np.complex128), e)
                + np.einsum("bmr,mrj->brj", tn.astype(np.complex128), e.conj()))
    got = sht.phase_stage_inv(torch.as_tensor(tp), None if tn is None else torch.as_tensor(tn),
                              nside, real)
    _close(got, want, TIERS[dtype])
    assert not got.numpy()[:, g.mask == 0].any()


@pytest.mark.parametrize("dtype,rtol", [(np.complex128, 1e-10), (np.complex64, 1e-4)],
                         ids=["c128", "c64"])
@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("lmax", [20, 47])
def test_synthesis_through_the_inverse_matches_jax(lmax, real, dtype, rtol):
    """The port's ``_synthesis`` (K14's and the inverse phase stage's plain
    versions) against JAX ``synthesis_real`` / ``synthesis_complex`` at
    nside 16; lmax 47 folds several m into one bin of the first rings."""
    nside = 16
    rng = np.random.default_rng(lmax + real)
    mask = np.arange(lmax + 1)[None, :] <= np.arange(lmax + 1)[:, None]
    pos = ((rng.standard_normal((2, lmax + 1, lmax + 1))
            + 1j * rng.standard_normal((2, lmax + 1, lmax + 1))) * mask).astype(dtype)
    neg = ((rng.standard_normal((2, lmax + 1, lmax))
            + 1j * rng.standard_normal((2, lmax + 1, lmax))) * mask[:, 1:]).astype(dtype)
    if real:
        pos[..., 0] = pos[..., 0].real
        got = sht._synthesis(torch.as_tensor(pos), None, nside)
        want = jsht.synthesis_real(pos, nside)
    else:
        got = sht._synthesis(torch.as_tensor(pos), torch.as_tensor(neg), nside)
        want = jsht.synthesis_complex(pos, neg, nside)
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    _close(got, want, rtol)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    nside, nm = 8, 20
    maps = torch.as_tensor(_maps(nside, 2, seed=1, dtype=np.complex64))
    tp = torch.as_tensor(_coeffs(nside, 2, nm, seed=2, dtype=np.complex128))
    tn = torch.as_tensor(_coeffs(nside, 2, nm, seed=3, dtype=np.complex128))
    before = (sht.K4.launches, sht.K4_INV.launches)
    for got, want in ((sht.phase_stage(maps, nside, nm, 3), sht.phase_stage_ref(maps, nside, nm, 3)),
                      ((sht.phase_stage_inv(tp, tn, nside, False),),
                       (sht.phase_stage_inv_ref(tp, tn, nside, False),)),
                      ((sht.phase_stage_inv(tp, None, nside, True),),
                       (sht.phase_stage_inv_ref(tp, None, nside, True),))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (sht.K4.launches, sht.K4_INV.launches) == before
    assert sht.K4.source == sht.K4_INV.source == "driftscan_tpu_torch/csrc/phase_stage.cu"
    assert backend.KERNELS["k4_phase"] is sht.K4 and backend.KERNELS["k4_phase_inv"] is sht.K4_INV


class PlainTaken(Exception):
    """Raised by a stand-in for a plain version that must not run."""


@pytest.mark.parametrize("which", ["forward", "inverse real", "inverse complex"])
def test_the_cuda_path_raises_rather_than_falls_back(monkeypatch, which):
    """Taken for a card's tensors (``backend.on_cuda`` forced true on CPU
    tensors), a wrapper goes to its kernel -- built with nvcc, launched on
    the card -- and raises where it cannot, never returning the plain
    version's result; tensors on neither the CPU nor a card raise too."""
    nside, nm = 4, 6
    maps = torch.as_tensor(_maps(nside, 1, seed=4, dtype=np.complex64))
    tp = torch.as_tensor(_coeffs(nside, 1, nm, seed=5, dtype=np.complex64))
    calls = {
        "forward": lambda x: sht.phase_stage(x, nside, nm),
        "inverse real": lambda x: sht.phase_stage_inv(x, None, nside, True),
        "inverse complex": lambda x: sht.phase_stage_inv(x, x, nside, False),
    }
    arg = maps if which == "forward" else tp
    with pytest.raises(ValueError, match="unsupported devices"):
        calls[which](arg.to("meta"))

    def plain(*a, **k):
        raise PlainTaken

    monkeypatch.setattr(sht, "phase_stage_ref", plain)
    monkeypatch.setattr(sht, "phase_stage_inv_ref", plain)
    monkeypatch.setattr(backend, "on_cuda", lambda *t: True)
    kernel = sht.K4 if which == "forward" else sht.K4_INV
    before = kernel.launches
    with pytest.raises(Exception) as info:
        calls[which](arg)
    assert not isinstance(info.value, PlainTaken), "the plain version was taken for a card's tensors"
    assert kernel.launches == before


def test_the_real_form_takes_no_negative_block():
    tp = torch.as_tensor(_coeffs(4, 1, 5, seed=6, dtype=np.complex128))
    with pytest.raises(ValueError, match="no negative-m block"):
        sht.phase_stage_inv(tp, tp, 4, True)


def test_the_complex_form_needs_its_negative_block():
    """The complex form without a negative-m block is refused on the CPU as
    the kernel refuses it on the card."""
    tp = torch.as_tensor(_coeffs(4, 1, 5, seed=7, dtype=np.complex128))
    with pytest.raises(ValueError, match="needs its negative-m block"):
        sht.phase_stage_inv(tp, None, 4, False)
