"""The top-band engine's certificate and its two-stage (DoubleKL) form,
the port against the JAX package on the CPU, float64, same numpy inputs.

* The certificate is False in the port exactly where it is in the JAX
  package, on JAX ``tests/test_topband.py``'s cases: total capacity below
  the band (basis overflow), too few levels for the spectrum's range, an
  empty band (True, nothing retained), and the shelf that hides an
  above-cut outlier from a single power vector but not from the block
  estimator (its value within rel 1e-10 of the JAX one).
* ``doublekl_solve_qr_topband`` on the JAX two-stage case (n 128, seed 11,
  7 levels): ``ok`` and ``nkept`` equal, the kept stage-1 and the retained
  stage-2 eigenvalues within rel 1e-6, their projectors within 1e-6 of the
  max, exact zeros below either cut.
"""

import numpy as np
import pytest
import torch

from driftscan_tpu.ops import fpencil as JF
from driftscan_tpu_torch.ops import fpencil
from test_torch_topband import CUT, pencil, zj, zn


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def both(pk, **kw):
    """(port ok, port evals, JAX ok, JAX evals) of kl_solve_qr_topband."""
    As, Af = pencil(**pk)
    tr, tok = fpencil.kl_solve_qr_topband(torch.as_tensor(As), torch.as_tensor(Af), cut=CUT,
                                          **kw)
    jr, jok = JF.kl_solve_qr_topband(zj(As), zj(Af), cut=CUT, **kw)
    return bool(tok), tr.evals.numpy(), bool(jok), np.asarray(jr.evals)


SEED11 = dict(seed=11, n=128, Ks=90, Kf=50, sig_top=2.5, fg_top=5)
SEED13 = dict(seed=13, n=128, Ks=90, Kf=50, sig_top=3.5, fg_top=5)


@pytest.mark.parametrize("pk,kw", [
    (SEED11, dict(k=5)),  # capacity 5 levels x 5 columns below the 50 retained
    (SEED13, dict(k=48, levels=2)),  # 10 decades above the cut in 2 levels
], ids=["basis_overflow", "too_few_levels"])
def test_certificate_fails_where_jax_fails(pk, kw):
    tok, _, jok, _ = both(pk, **kw)
    assert tok is False and jok is False


def test_empty_band_certifies():
    tok, tev, jok, jev = both(
        dict(seed=9, n=96, Ks=50, Kf=30, sig_top=-4, fg_top=5), k=16
    )
    assert tok and jok
    assert float(tev.max()) == 0.0 and float(jev.max()) == 0.0


def test_block_estimator_sees_through_the_shelf():
    """A dense shelf just below an above-cut outlier pulls a single power
    vector's estimate below the cut; the block estimator of the
    certificate resolves the outlier, in both packages alike."""
    rng = np.random.default_rng(7)
    n = 512
    lam = np.full(n, 1e-6)
    lam[0] = 1.05
    lam[1:501] = 0.90
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    y = q * np.sqrt(lam)[None, :]
    yt = torch.as_tensor(y.astype(np.complex128))
    single = float(fpencil._spectral_norm_sq(yt, iters=12))
    block = float(fpencil._spectral_norm_sq_block(yt))
    jblock = float(JF._spectral_norm_sq_block(zj(y.astype(np.complex128)), q=16, iters=32))
    assert single < 1.0 < block
    np.testing.assert_allclose(block, 1.05, rtol=1e-2)
    np.testing.assert_allclose(block, jblock, rtol=1e-10)


@pytest.fixture(scope="module")
def doublekl():
    As, Af = pencil(seed=11, n=128, Ks=90, Kf=50, sig_top=5.0, fg_top=3)
    t = fpencil.doublekl_solve_qr_topband(torch.as_tensor(As), torch.as_tensor(Af), cut=CUT,
                                          k=48, levels=7)
    j = JF.doublekl_solve_qr_topband(zj(As), zj(Af), cut=CUT, k=48, levels=7)
    port = dict(f=t[0].numpy(), e=t[1].numpy(), v=t[2].numpy(), nk=int(t[3]), ok=bool(t[4]))
    jax = dict(f=np.asarray(j[0]), e=np.asarray(j[1]), v=zn(j[2]), nk=int(j[3]), ok=bool(j[4]))
    return port, jax


def test_doublekl_topband_counts_and_certificate(doublekl):
    t, j = doublekl
    assert t["ok"] and j["ok"]
    assert t["nk"] == j["nk"] > 10
    assert int((t["e"] > CUT).sum()) == int((j["e"] > CUT).sum()) > 10


@pytest.mark.parametrize("stage,cut", [("f", 100.0), ("e", CUT)])
def test_doublekl_topband_spectra_match(doublekl, stage, cut):
    t, j = doublekl
    kept = j[stage] > cut
    assert np.array_equal(t[stage] > cut, kept)
    rel = np.abs(t[stage][kept] - j[stage][kept]) / j[stage][kept]
    assert rel.max() <= 1e-6, rel.max()
    assert np.all(t[stage][~kept] == 0.0) and np.all(j[stage][~kept] == 0.0)


def test_doublekl_topband_modes_match(doublekl):
    t, j = doublekl
    kept = j["e"] > CUT
    pt = t["v"][:, kept] @ t["v"][:, kept].conj().T
    pj = j["v"][:, kept] @ j["v"][:, kept].conj().T
    assert np.abs(pt - pj).max() <= 1e-6 * np.abs(pj).max()
    # the columns below either cut are exact zeros, the same ones in both
    zero = np.all(j["v"] == 0.0, axis=0)
    assert zero.sum() > 0 and np.array_equal(np.all(t["v"] == 0.0, axis=0), zero)
