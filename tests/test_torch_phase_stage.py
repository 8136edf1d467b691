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


# (nside, B, nm) of the paths (the [slice] and [pol] chunks, the [ns2
# window], [dish], ns1b, the timestream's inverse) and the plan's edges
PLAN_CASES = [(256, 64, 230), (128, 256, 121), (512, 16, 45), (512, 16, 495), (1024, 64, 33),
              (256, 8, 230), (4, 1, 12), (16, 3, 48), (64, 12, 49), (32, 40, 7), (8, 70, 1),
              (64, 3, 57), (2048, 64, 300)]
TORCH_TYPES = {"c64": torch.complex64, "c128": torch.complex128}


@pytest.mark.parametrize("dtype", ["c64", "c128"])
@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_phase_plan_covers_every_row_and_m_once(case, dtype):
    """The forward's tiles (row tiles of phase_tiles x m tiles of the plan)
    take every (group row, m) exactly once; each tile starts inside its
    group's rows and the call's m; the m tiles are multiples of 8, nm up to
    64 in one tile with at most 7 padding columns; the shared memory fits
    the card and the stages are 2-4."""
    nside, B, nm = case
    plan = sht.phase_plan(nside, B, nm, TORCH_TYPES[dtype])
    grp = sht.phase_groups(nside)
    tiles = sht.phase_tiles(nside, B, plan.rows)
    assert plan.cols % 8 == 0 and 8 <= plan.cols <= sht.PHASE_MAX_COLS
    assert plan.cols * plan.tiles >= nm > plan.cols * (plan.tiles - 1)
    if nm <= sht.PHASE_MAX_COLS:
        assert plan.tiles == 1 and plan.cols - nm <= 7
    else:
        assert plan.cols * plan.tiles - nm < 8 * plan.tiles
    assert plan.rows in (16, 32, 64) and 2 <= plan.stages <= 4
    assert plan.smem <= sht.PHASE_SMEM
    seen = {}
    for gi, r0 in tiles.tolist():
        nrows = B * int(grp[gi, 2])
        assert 0 <= r0 < nrows
        for k in range(plan.tiles):
            c0 = k * plan.cols
            assert c0 < nm
            for q in range(r0, min(r0 + plan.rows, nrows)):
                key = (gi, q)
                seen[key] = seen.get(key, 0) + min(c0 + plan.cols, nm) - c0
    assert len(seen) == B * healpix.ring_geometry(nside).nring
    assert set(seen.values()) == {nm}


@pytest.mark.parametrize("dtype", ["c64", "c128"])
@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_inverse_plan_covers_every_row_and_pixel_once(case, real, dtype):
    """The inverse's tiles (row tiles x pixel tiles) take every (group row,
    slot) of the padded maps exactly once, each tile starting inside its
    group's rows and the ring's slots."""
    nside, B, nm = case
    plan = sht.phase_plan(nside, B, nm, TORCH_TYPES[dtype], inverse=True, real=real)
    g = healpix.ring_geometry(nside)
    per = 32 if real else 16
    assert plan.rows in (per, 2 * per, 4 * per) and plan.cols in (32, 64)
    assert plan.cols * plan.tiles >= g.maxlen > plan.cols * (plan.tiles - 1)
    assert 2 <= plan.stages <= 4 and plan.smem <= sht.PHASE_SMEM
    grp = sht.phase_groups(nside)
    rows = 0
    for gi, r0 in sht.phase_tiles(nside, B, plan.rows).tolist():
        nrows = B * int(grp[gi, 2])
        assert 0 <= r0 < nrows
        rows += min(r0 + plan.rows, nrows) - r0
    assert rows == B * g.nring


def test_the_windows_of_the_card_tests_take_every_tile_width():
    """tests/test_torch_cuda.py's K4_WINDOWS (m0, m1) at nside 64, B 3 take
    every m-tile width of the plan, 8 to 64 columns."""
    windows = [(5, 6), (40, 49), (60, 81), (3, 33), (100, 137), (0, 45), (7, 56), (130, 190)]
    widths = {sht.phase_plan(64, 3, m1 - m0, torch.complex64).cols for m0, m1 in windows}
    assert widths == set(range(8, 65, 8))


def test_the_plan_refuses_what_the_shared_memory_cannot_hold():
    """nside 8192's half-wave tables (32,769 entries) pass the shared
    memory in float64 (the complex128 forward) and as table entries (the
    inverse): the plan raises rather than launch; the complex64 forward
    keeps its table in float32 and fits, and nside 4096 fits in every
    form."""
    for dtype, inverse in ((torch.complex128, False), (torch.complex64, True),
                           (torch.complex128, True)):
        with pytest.raises(ValueError, match="shared memory"):
            sht.phase_plan(8192, 1, 12, dtype, inverse=inverse)
    assert sht.phase_plan(8192, 1, 12, torch.complex64).smem <= sht.PHASE_SMEM
    for dtype in (torch.complex64, torch.complex128):
        for inverse, real in ((False, False), (True, False), (True, True)):
            plan = sht.phase_plan(4096, 64, 500, dtype, inverse=inverse, real=real)
            assert plan.smem <= sht.PHASE_SMEM and plan.stages >= 2


def _fold(t, N):
    return np.where(t <= N, t, 2 * N - t)


def _add_mod(a, b, n):
    s = a + b
    return np.where(s >= n, s - n, s)


def _half_wave(N):
    """The kernels' half-wave table cos(pi u / N), u = 0 .. N, and its index
    maps for cos and sin (pi t / N), 0 <= t < 2N."""
    half = np.cos(np.pi * np.arange(N + 1) / N)

    def cos_sin(t):
        t = np.asarray(t)
        sin_idx = _fold(np.where(t >= N // 2, t - N // 2, t + 3 * (N // 2)), N)
        return half[_fold(t, N)], half[sin_idx]

    return cos_sin


@pytest.mark.parametrize("nside", [1, 2, 4, 8, 16, 64])
def test_the_forward_kernels_angles_are_exact(nside):
    """A numpy mirror of csrc/phase_stage.cu's forward angle arithmetic: the
    block's table tile t = (m mod 2N) (2 jl + h) mod 2N and the turn of
    stage s, s dt with dt = (m mod 2N) 2 JC mod 2N (complex64 steps it by
    exact modular adds, complex128 raises the one step to the s-th power
    by its Horner walk), add up to m (2 j + h) mod 2N for every (N, h, m, j)
    of the rings of ``nside`` at j = jl + JC s (m up to past 4N, any first
    m), in 32-bit products; the half-wave lookups are cos and sin (pi t / N)
    to 4e-15 (numpy's own rounding of pi t / N up to 2 pi)."""
    for N, h, _, _, _ in sht.phase_groups(nside).tolist():
        n2 = 2 * N
        cos_sin = _half_wave(N)
        t = np.arange(n2)
        c, s = cos_sin(t)
        assert np.abs(c - np.cos(np.pi * t / N)).max() < 4e-15
        assert np.abs(s - np.sin(np.pi * t / N)).max() < 4e-15
        for JC in (32, 16):
            assert (n2 - 1) * (2 * JC + 1) < 2**32
            for m0, cols in ((0, 8), (3 * N + 5, 48), (7, 64)):
                m = (m0 + np.arange(cols)) % n2
                jl = np.arange(JC)
                loc = (m[None, :] * (2 * jl[:, None] + h)) % n2
                dt = (m * 2 * JC) % n2
                tc = np.zeros_like(dt)
                for st in range(-(-N // JC)):
                    j = jl[:, None] + JC * st
                    want = ((m0 + np.arange(cols))[None, :] * (2 * j + h)) % n2
                    assert ((loc + tc[None, :]) % n2 == want).all()
                    assert (tc == (dt * st) % n2).all()
                    tc = _add_mod(tc, dt, n2)


@pytest.mark.parametrize("nside", [2, 8, 32])
def test_the_forward_kernels_turned_stage_sums_are_the_projection(nside):
    """The forward kernel's factored sum in float64: each JC-pixel stage
    projected with the block's one table tile and turned by the stage's
    angle (complex64's order: stage sums from zero, each turned and added
    in order) or walked from the last stage, the running total turned by
    the one step before each (complex128's Horner order), equals the
    direct projection sum_j f_j e^{-i m phi_j} (F) and e^{+i m phi_j} (G)
    to 1e-13 of its largest entry, for the rings' own N and h at m past
    4N."""
    rng = np.random.default_rng(nside)
    for N, h, _, _, _ in sht.phase_groups(nside).tolist():
        cos_sin = _half_wave(N)
        n2 = 2 * N
        m = np.arange(0, 4 * N + 9)
        f = rng.standard_normal(N) + 1j * rng.standard_normal(N)
        # m phi_j reduced exactly: pi t / N, t = m (2 j + h) mod 2N
        ang = np.pi * ((m[:, None] * (2 * np.arange(N)[None, :] + h)) % n2) / N
        want_F = (f[None, :] * np.exp(-1j * ang)).sum(1)
        want_G = (f[None, :] * np.exp(1j * ang)).sum(1)
        scale = max(np.abs(want_F).max(), 1.0)
        for JC in (32, 16):
            nst = -(-N // JC)
            x = np.zeros(nst * JC, complex)
            x[:N] = f
            jl = np.arange(JC)
            tc, ts = cos_sin((m[None, :] % n2) * (2 * jl[:, None] + h) % n2)
            zc, zs = cos_sin((m % n2) * 2 * JC % n2)

            def stage(st):
                xs = x[st * JC:(st + 1) * JC, None]
                return (xs * tc).sum(0), (xs * ts).sum(0)  # P, Q (complex rows)

            def turn(p, q, c, s):
                return c * p - s * q, s * p + c * q

            P = Q = 0
            for st in range(nst):
                c, s = cos_sin((m % n2) * 2 * JC * st % n2)
                p, q = turn(*stage(st), c, s)
                P, Q = P + p, Q + q
            P2, Q2 = stage(nst - 1)
            for st in range(nst - 2, -1, -1):
                P2, Q2 = turn(P2, Q2, zc, zs)
                p, q = stage(st)
                P2, Q2 = P2 + p, Q2 + q
            for p, q in ((P, Q), (P2, Q2)):
                assert np.abs((p - 1j * q) - want_F).max() < 1e-13 * scale
                assert np.abs((p + 1j * q) - want_G).max() < 1e-13 * scale


@pytest.mark.parametrize("nside", [1, 2, 4, 8, 16, 64])
def test_the_inverse_kernels_angle_steps_are_exact(nside):
    """A numpy mirror of csrc/phase_stage.cu's inverse table gather, thread
    by thread: pixel jl of the tile, m mfirst + mstep k of each m stage (32
    in complex64, 16 in complex128), t stepped by exact modular adds across
    m and stages, reaches t = m (2 j + h) mod 2N for every (N, h, m, j) of
    the rings of ``nside``."""
    for N, h, _, _, _ in sht.phase_groups(nside).tolist():
        n2 = 2 * N
        for MC in (32, 16):
            for nthr in (64, 128, 256):
                tid = np.arange(nthr)
                pix = 32
                for j0 in range(0, N, pix):
                    jl, mfirst, mstep = tid % pix, tid // pix, nthr // pix
                    kj = (2 * (j0 + jl) + h) % n2
                    tstart, tstep = (mfirst * kj) % n2, (mstep * kj) % n2
                    dstart = (MC * kj) % n2
                    for s in range(3):
                        tc = tstart
                        for k in range(-(-MC // mstep)):
                            m, j = s * MC + mfirst + mstep * k, j0 + jl
                            ok = mfirst + mstep * k < MC
                            assert (tc == m * (2 * j + h) % n2)[ok].all()
                            tc = _add_mod(tc, tstep, n2)
                        tstart = _add_mod(tstart, dstart, n2)


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
