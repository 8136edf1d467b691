"""The whitening levers of the port's QR engine (``fpencil._QR_IMPL``,
``_WHITEN_IMPL``, ``_WHITEN_REFINE_STEPS``, ``_CHOLQR_ROUNDS``) against the
same levers of the JAX package, on the CPU in float64.

The levers are module state: each case sets them on both packages with
``monkeypatch`` (restored after it) and traces a fresh ``jax.jit`` of the
JAX solve, which reads them at trace time.  The pencil is JAX
``tests/test_fpencil.py``'s hard one (n 96, a continuous six-decade
foreground, cond(N) ~ 3e11, the bench telescope's conditioning), from a
numpy seed.  Every (_QR_IMPL, _WHITEN_IMPL) pair is held against the same
pair in the JAX package at the KL tier, 1e-4 of the top eigenvalue, and
its top 32 eigenvalues against the dense complex128 referee at rel 5e-3
(the JAX test's bound); each case prints what it reached.  With the levers
at their defaults the solve is the one the port computed before them, bit
for bit.
"""

import jax
import numpy as np
import pytest
import torch

from driftscan_tpu.ops import fpencil as jfp
from driftscan_tpu.ops import zarray as za
from driftscan_tpu_torch.ops import fpencil

TIER = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rand_u(rng, p, q):
    a = rng.standard_normal((p, q)) + 1j * rng.standard_normal((p, q))
    return np.linalg.qr(a)[0]


def _hard_pencil(seed=3, n=96, kf=288, ks=288):
    rng = np.random.default_rng(seed)
    a_f = (_rand_u(rng, n, n) * np.logspace(np.log10(5.6e5), -3, n)) @ _rand_u(rng, kf, n).conj().T
    a_s = (_rand_u(rng, n, n) * 0.3 * np.logspace(0, -3, n)) @ _rand_u(rng, ks, n).conj().T
    return a_s, a_f


@pytest.fixture(scope="module")
def pencil():
    a_s, a_f = _hard_pencil()
    return a_s, a_f, jfp.kl_solve_dense_ref(a_s, a_f)[0]


def _z(a):
    return za.Z(np.ascontiguousarray(a.real), np.ascontiguousarray(a.imag))


def _levers(monkeypatch, **kw):
    for name, value in kw.items():
        monkeypatch.setattr(jfp, name, value)
        monkeypatch.setattr(fpencil, name, value)


@pytest.mark.parametrize("qr_impl", ["cholqr_split", "cholqr", "householder"])
@pytest.mark.parametrize("whiten", ["solve", "factored", "refined"])
def test_whitening_pair_matches_jax(pencil, monkeypatch, qr_impl, whiten):
    a_s, a_f, ref = pencil
    _levers(monkeypatch, _QR_IMPL=qr_impl, _WHITEN_IMPL=whiten)
    want = jax.jit(lambda s, f: jfp.kl_solve(s, f, method="qr"))(_z(a_s), _z(a_f))
    got = fpencil.kl_solve(torch.as_tensor(a_s), torch.as_tensor(a_f))
    wev, ev = np.asarray(want.evals), got.evals.numpy()
    gap = float(np.abs(ev - wev).max() / wev.max())
    rel = float(np.abs(ev[-32:] / ref[-32:] - 1).max())
    # the retained block stays N-orthonormal
    v = got.evecs.numpy()[:, -32:]
    noise = a_f @ a_f.conj().T + np.eye(a_s.shape[0])
    ortho = float(np.abs(v.conj().T @ noise @ v - np.eye(32)).max())
    print(f"{qr_impl}/{whiten}: {gap:.2e} of the top from JAX, top 32 rel {rel:.2e} from "
          f"the dense referee, N-orthonormality {ortho:.2e}")
    assert gap < TIER and rel < 5e-3 and ortho < 5e-3


@pytest.mark.parametrize("rounds", [3, 6])
@pytest.mark.parametrize("whiten", ["solve", "refined"])
def test_cholqr_rounds_match_jax(pencil, monkeypatch, rounds, whiten):
    """``_CHOLQR_ROUNDS`` overrides the round count in both packages; three
    rounds still sit on the referee in float64."""
    a_s, a_f, ref = pencil
    _levers(monkeypatch, _CHOLQR_ROUNDS=rounds, _WHITEN_IMPL=whiten)
    assert fpencil._cholqr_rounds(torch.complex128) == rounds
    r, invs = fpencil.chol_qr_r(torch.as_tensor(np.vstack([a_f.conj().T, np.eye(96)])),
                                return_inv=True)
    assert len(invs) == rounds
    want = jax.jit(lambda s, f: jfp.kl_solve(s, f, method="qr"))(_z(a_s), _z(a_f))
    got = fpencil.kl_solve(torch.as_tensor(a_s), torch.as_tensor(a_f))
    wev, ev = np.asarray(want.evals), got.evals.numpy()
    gap = float(np.abs(ev - wev).max() / wev.max())
    rel = float(np.abs(ev[-32:] / ref[-32:] - 1).max())
    print(f"rounds {rounds}/{whiten}: {gap:.2e} of the top from JAX, top 32 rel {rel:.2e}")
    assert gap < TIER and rel < 5e-3


def test_factors_compose_to_r():
    """R = R_K .. R_1 with the per-round inverses returned; their chain and
    their composition invert R; the Householder R (each row scaled to a
    positive real diagonal) is CholeskyQR's R."""
    rng = np.random.default_rng(4)
    rows = torch.as_tensor((rng.standard_normal((40, 12)) + 1j * rng.standard_normal((40, 12)))
                           * np.logspace(0, -4, 12))
    r, invs = fpencil.chol_qr_r(rows, return_inv=True)
    assert len(invs) == fpencil._cholqr_rounds(rows.dtype)
    eye = torch.eye(12, dtype=rows.dtype)
    m = fpencil._compose_factor_inv(invs)
    scale = float(torch.linalg.matrix_norm(r, 2) * torch.linalg.matrix_norm(m, 2))
    assert float((m @ r - eye).abs().max()) < 1e-10 * scale
    b = torch.as_tensor(rng.standard_normal((12, 3)) + 0j)
    for adj in (False, True):
        chain = fpencil._whiten_apply_factors(invs, b, adj)
        mat = r.conj().T if adj else r
        assert float((mat @ chain - b).abs().max()) < 1e-8 * float(b.abs().max()) * scale
    try:
        before = fpencil._QR_IMPL
        fpencil._QR_IMPL = "householder"
        rh = fpencil._noise_r_factor(rows)
    finally:
        fpencil._QR_IMPL = before
    d = torch.diagonal(rh)
    assert float(d.imag.abs().max()) == 0.0 and bool((d.real > 0).all())
    assert float((rh - r).abs().max()) < 1e-8 * float(r.abs().max())
    gram = rows.conj().T @ rows
    assert float((rh.conj().T @ rh - gram).abs().max()) < 1e-12 * float(gram.abs().max())


def test_defaults_compute_what_they_did(pencil):
    """The default levers (cholqr_split, solve) give the pencil solve the
    port had before the levers, bit for bit: one CholeskyQR and two
    triangular solves against the whole R."""
    a_s, a_f, _ = pencil
    assert (fpencil._QR_IMPL, fpencil._WHITEN_IMPL) == ("cholqr_split", "solve")
    s, f = torch.as_tensor(a_s), torch.as_tensor(a_f)
    rows = fpencil._thermal_noise_rows(f, 1.0)
    r = fpencil.chol_qr_r(rows)
    y = torch.linalg.solve_triangular(r.conj().transpose(-1, -2), s, upper=False)
    u, sy = fpencil._select_complete_basis(fpencil.gram_bands(y, levels=2, band_rel=3e-2))
    v = torch.linalg.solve_triangular(r, u, upper=True)
    got = fpencil.pencil_solve_qr(s, rows)
    assert torch.equal(got.evals, (sy * sy).flip(-1)) and torch.equal(got.evecs, v.flip(-1))


@pytest.mark.parametrize("qr_impl,whiten", [("cholqr_split", "factored"),
                                            ("householder", "refined")])
def test_doublekl_and_topband_stages_take_the_levers(monkeypatch, qr_impl, whiten):
    """The DoubleKL stages whiten through the levers as the JAX package's
    do (both stages against JAX at the DoubleKL tier, 1e-2 of the top), and
    the top-band engine's retained band under a lever sits on the default
    whitening's (rel 1e-8)."""
    rng = np.random.default_rng(9)
    n = 48
    a_f = (_rand_u(rng, n, n) * 30.0 * np.logspace(0, -5, n)) @ _rand_u(rng, 96, n).conj().T
    a_s = (_rand_u(rng, n, n) * 3.0 * np.logspace(0, -3, n)) @ _rand_u(rng, 96, n).conj().T
    s, f = torch.as_tensor(a_s), torch.as_tensor(a_f)
    base = fpencil.kl_solve_qr_topband(s, f, cut=1e-3, k=12)[0].evals.numpy()
    _levers(monkeypatch, _QR_IMPL=qr_impl, _WHITEN_IMPL=whiten)
    kw = dict(fg_threshold=10.0)
    want = jax.jit(lambda x, y: jfp.doublekl_solve_qr(x, y, **kw))(_z(a_s), _z(a_f))
    got = fpencil.doublekl_solve_qr(s, f, **kw)
    for g, w, name in ((got[0], want[0], "stage 1"), (got[1], want[1], "stage 2")):
        w = np.asarray(w)
        gap = float(np.abs(g.numpy() - w).max() / w.max())
        print(f"DoubleKL {qr_impl}/{whiten} {name}: {gap:.2e} of the top from JAX")
        assert gap < 1e-2
    assert 0 < int(got[3]) == int(want[3]) < n
    tb, ok = fpencil.kl_solve_qr_topband(s, f, cut=1e-3, k=12)
    kept = base > 0
    assert bool(ok) and kept.any()
    rel = float(np.abs(tb.evals.numpy()[kept] / base[kept] - 1).max())
    print(f"top band {qr_impl}/{whiten}: rel {rel:.2e} from the default whitening")
    assert rel < 1e-8


def test_unknown_lever_raises(monkeypatch):
    a = torch.eye(4, dtype=torch.complex128)
    monkeypatch.setattr(fpencil, "_WHITEN_IMPL", "cholesky")
    with pytest.raises(ValueError, match="_WHITEN_IMPL"):
        fpencil.kl_solve(a, a)
    monkeypatch.setattr(fpencil, "_WHITEN_IMPL", "solve")
    monkeypatch.setattr(fpencil, "_QR_IMPL", "givens")
    with pytest.raises(ValueError, match="_QR_IMPL"):
        fpencil.kl_solve(a, a)
