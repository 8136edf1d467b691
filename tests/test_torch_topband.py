"""The port's top-band KL engine against the JAX package's, on the CPU.

The synthetic factored pencils of JAX ``tests/test_topband.py`` (n 128:
seed 11 retains 50 modes above the cut 0.1 with 5 levels; seed 13's
lambda_max ~1.5e9 needs 6) go through both packages in float64 from the
same numpy arrays, with the same fixed start block (numpy seed 97531):

* ``kl_solve_qr_topband`` and ``gram_topband``: the certificate and the
  retained count equal, retained eigenvalues within rel 1e-6 (the noise
  whitening's conditioning sets the floor: the two packages' exact engines
  differ by 6.4e-7 on seed 11, their top-band engines by the same), the
  retained projectors within 1e-6 of their max (the bases are not unique),
  the sub-cut entries exact zeros in both;
* the port's engine against its own exact engine (rel 1e-9 on retained
  eigenvalues: the same whitening, so only the engine differs);
* K17's plain version (``cheb.cheb_step_ref``) through the port's
  ``_cheb_apply`` against the JAX ``_cheb_apply``, iterate by iterate
  (degrees 1 to 4), within 1e-12 of the iterate's max.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from driftscan_tpu.ops import fpencil as JF
from driftscan_tpu.ops import zarray as za
from driftscan_tpu_torch.ops import cheb, fpencil

CUT = 0.1


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def pencil(seed, n, Ks, Kf, sig_top, fg_top):
    """JAX tests/test_topband.py's synthetic pencil, complex128."""
    rng = np.random.default_rng(seed)
    As = rng.standard_normal((n, Ks)) + 1j * rng.standard_normal((n, Ks))
    As *= np.logspace(sig_top, sig_top - 7, Ks)[None, :]
    Af = rng.standard_normal((n, Kf)) + 1j * rng.standard_normal((n, Kf))
    Af *= np.logspace(fg_top, 0, Kf)[None, :]
    return As, Af


def zj(a):
    return za.Z(jnp.asarray(a.real), jnp.asarray(a.imag))


def zn(z):
    return np.asarray(z.re) + 1j * np.asarray(z.im)


CASES = {
    "seed11": (dict(seed=11, n=128, Ks=90, Kf=50, sig_top=2.5, fg_top=5), dict(k=32)),
    "seed13": (dict(seed=13, n=128, Ks=90, Kf=50, sig_top=3.5, fg_top=5), dict(k=48, levels=6)),
}


@pytest.fixture(scope="module")
def solved():
    out = {}
    for name, (pk, kw) in CASES.items():
        As, Af = pencil(**pk)
        jr, jok = JF.kl_solve_qr_topband(zj(As), zj(Af), cut=CUT, **kw)
        tr, tok = fpencil.kl_solve_qr_topband(torch.as_tensor(As), torch.as_tensor(Af), cut=CUT,
                                              **kw)
        ex = fpencil.kl_solve_qr(torch.as_tensor(As), torch.as_tensor(Af))
        out[name] = dict(
            jev=np.asarray(jr.evals), jv=zn(jr.evecs), jok=bool(jok),
            tev=tr.evals.numpy(), tv=tr.evecs.numpy(), tok=bool(tok),
            xev=ex.evals.numpy(), As=As, Af=Af, kw=kw,
        )
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_certificate_and_count_match(solved, case):
    r = solved[case]
    assert r["tok"] and r["jok"]
    assert int((r["tev"] > 0).sum()) == int((r["jev"] > 0).sum()) > 10


@pytest.mark.parametrize("case", sorted(CASES))
def test_retained_eigenvalues_match(solved, case):
    r = solved[case]
    kept = r["jev"] > 0
    rel = np.abs(r["tev"][kept] - r["jev"][kept]) / r["jev"][kept]
    assert rel.max() <= 1e-6, rel.max()
    # the sub-cut entries, values and vectors, are exact zeros in both
    assert np.all(r["tev"][~kept] == 0.0) and np.all(r["jev"][~kept] == 0.0)
    assert np.all(r["tv"][:, ~kept] == 0.0) and np.all(r["jv"][:, ~kept] == 0.0)
    assert np.all(r["tev"][kept] >= CUT)


@pytest.mark.parametrize("case", sorted(CASES))
def test_retained_projectors_match(solved, case):
    r = solved[case]
    kept = r["jev"] > 0
    pt = r["tv"][:, kept] @ r["tv"][:, kept].conj().T
    pj = r["jv"][:, kept] @ r["jv"][:, kept].conj().T
    assert np.abs(pt - pj).max() <= 1e-6 * np.abs(pj).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_topband_equals_the_exact_engine(solved, case):
    """The same whitening, so only the engine differs: rel 1e-9."""
    r = solved[case]
    kept = r["tev"] > 0
    want = np.sort(r["xev"])[-int(kept.sum()):]
    assert np.sort(r["xev"])[-int(kept.sum()) - 1] < CUT  # the band is the whole set
    np.testing.assert_allclose(r["tev"][kept], want, rtol=1e-9)


def test_gram_topband_matches(solved):
    """gram_topband on the whitened seed-11 factor, both packages: theta
    (levels * k, descending a level) within rel 1e-6 where nonzero and
    zero at the same entries; projectors within 1e-6."""
    r = solved["seed11"]
    rows = fpencil._thermal_noise_rows(torch.as_tensor(r["Af"]), 1.0)
    rr = fpencil.chol_qr_r(rows)
    y = torch.linalg.solve_triangular(rr.mH, torch.as_tensor(r["As"]), upper=False)
    th, u, ok = fpencil.gram_topband(y, k=16, cut=CUT, levels=5)
    jth, ju, jok = JF.gram_topband(zj(y.numpy()), k=16, cut=CUT, levels=5)
    jth, ju = np.asarray(jth), zn(ju)
    assert bool(ok) and bool(jok)
    nz = jth > 0
    assert np.array_equal(th.numpy() > 0, nz) and nz.sum() > 10
    np.testing.assert_allclose(th.numpy()[nz], jth[nz], rtol=1e-6)
    pt = u.numpy() @ u.numpy().conj().T
    pj = ju @ ju.conj().T
    assert np.abs(pt - pj).max() <= 1e-6 * np.abs(pj).max()


def test_start_block_is_the_jax_draw():
    """(n, k) blocks are their own draws (not slices of a wider one), and
    the k = 1 column is the power iteration's start vector."""
    like = torch.zeros(1, dtype=torch.float64)
    for n, k in ((128, 1), (128, 32), (96, 16)):
        np.testing.assert_array_equal(
            fpencil._start_block(n, k, like).numpy(),
            np.asarray(JF._random_real_basis(n, k, np.float64)),
        )
    assert not np.array_equal(fpencil._start_block(128, 32, like).numpy()[:, :16],
                              fpencil._start_block(128, 16, like).numpy())


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_cheb_step_ref_follows_the_jax_recurrence(degree):
    """The port's filter (K17's plain version on CPU tensors) against the
    JAX _cheb_apply: the degree-d result is the recurrence's d-th iterate,
    each within 1e-12 of its max."""
    rng = np.random.default_rng(5)
    y = (rng.standard_normal((40, 30)) + 1j * rng.standard_normal((40, 30))) * 0.3
    v = rng.standard_normal((40, 6)) + 1j * rng.standard_normal((40, 6))
    b = 0.7
    got = fpencil._cheb_apply(torch.as_tensor(y), torch.as_tensor(v),
                              torch.tensor(b, dtype=torch.float64), degree).numpy()
    want = zn(JF._cheb_apply(zj(y), zj(v), b, degree))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_cheb_step_on_the_cpu_is_its_plain_version():
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    launches nothing; a batch of two m with its own coefficients."""
    rng = np.random.default_rng(6)

    def c(*shape):
        return torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))

    y, w, vk, vp = c(2, 20, 12), c(2, 12, 5), c(2, 20, 5), c(2, 20, 5)
    alpha = torch.tensor([0.5, 3.0], dtype=torch.float64)
    before = cheb.K17.launches
    out, amax = cheb.cheb_step(y, w, vk, vp, alpha, -2.0, -1.0)
    ref, ramax = cheb.cheb_step_ref(y, w, vk, vp, alpha, -2.0, -1.0)
    assert cheb.K17.launches == before
    assert torch.equal(out, ref) and torch.equal(amax, ramax)
    want = alpha[:, None, None] * (y @ w) - 2.0 * vk - vp
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_array_equal(
        amax.numpy(), np.maximum(np.abs(out.real.numpy()).max(axis=(1, 2)),
                                 np.abs(out.imag.numpy()).max(axis=(1, 2))))
    first, _ = cheb.cheb_step(y, w, vk, None, alpha, -1.0, 0.0)
    np.testing.assert_allclose(first.numpy(), (alpha[:, None, None] * (y @ w) - vk).numpy(),
                               rtol=0, atol=1e-13)


def test_nonpositive_cut_raises():
    y = torch.zeros((1, 8, 4), dtype=torch.complex128)
    with pytest.raises(ValueError, match="positive cut"):
        fpencil.gram_topband(y, k=2, cut=0.0)
