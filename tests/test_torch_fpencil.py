"""driftscan_tpu_torch factored KL pencil (K9 and the QR engine) against the
JAX package.

Inputs come from a numpy seed and both packages run in float64 on the CPU,
the port's signal Gram through its plain version (``signal_gram_ref``):
the same algorithm, so rel 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driftscan_tpu.ops import fpencil as jfp
from driftscan_tpu.ops import zarray as za
from driftscan_tpu_torch.ops import fpencil, linalg


def _crandn(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("npol,K", [(1, 8), (1, 3), (2, 4), (4, 4)])
def test_beam_factor_compact_matches_jax(npol, K):
    rng = np.random.default_rng(11 + K)
    F, S, nl = 3, 5, 37
    b = _crandn(rng, (F, S, npol, nl))
    L = rng.standard_normal((nl, npol, F, K))
    want = za.to_numpy(jfp.beam_factor_compact(za.Z(b.real, b.imag), L))
    got = fpencil.beam_factor_compact(torch.as_tensor(b)[None], torch.as_tensor(L))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())

    # the compact factor reproduces the Gram of the wide one
    wide = fpencil.beam_factor(torch.as_tensor(b)[None], torch.as_tensor(L))[0]
    s = (wide @ wide.conj().T).numpy()
    c = got.numpy()
    np.testing.assert_allclose(c @ c.conj().T, s, rtol=0, atol=1e-8 * np.abs(s).max())


def test_beam_factor_matches_jax():
    rng = np.random.default_rng(5)
    b = _crandn(rng, (2, 4, 1, 9))
    L = rng.standard_normal((9, 1, 2, 3))
    want = za.to_numpy(jfp.beam_factor(za.Z(b.real, b.imag), L))
    got = fpencil.beam_factor(torch.as_tensor(b), torch.as_tensor(L))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_signal_gram_plain_is_the_gram():
    rng = np.random.default_rng(3)
    b = torch.as_tensor(_crandn(rng, (2, 3, 4, 1, 11)))
    L = torch.as_tensor(rng.standard_normal((11, 1, 3, 5)))
    a = fpencil.beam_factor(b, L)
    torch.testing.assert_close(fpencil.signal_gram(b, L), a @ a.conj().transpose(-1, -2))


def test_chol_qr_r_matches_jax():
    rng = np.random.default_rng(9)
    rows = _crandn(rng, (40, 12)) * np.logspace(0, -6, 12)[None, :]
    want = za.to_numpy(za.deinterleave(jfp._chol_qr_r_split(za.Z(rows.real, rows.imag))))
    got = fpencil.chol_qr_r(torch.as_tensor(rows)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    # N = R^H R
    np.testing.assert_allclose(
        got.conj().T @ got, rows.conj().T @ rows, rtol=0, atol=1e-10 * np.abs(want).max() ** 2
    )


@pytest.mark.parametrize("levels", [1, 2])
def test_kl_solve_matches_jax(levels):
    rng = np.random.default_rng(21 + levels)
    n = 24
    # signal factor spanning a few decades, a strong low-rank foreground
    a_s = _crandn(rng, (n, 30)) * np.logspace(0, -3, 30)[None, :]
    a_f = 1e3 * _crandn(rng, (n, 6))
    jr = jfp.kl_solve(
        za.Z(jnp.asarray(a_s.real), jnp.asarray(a_s.imag)),
        za.Z(jnp.asarray(a_f.real), jnp.asarray(a_f.imag)),
        sig_levels=levels, method="qr",
    )
    tr = fpencil.kl_solve(torch.as_tensor(a_s), torch.as_tensor(a_f), sig_levels=levels)
    want = np.asarray(jr.evals)
    got = tr.evals.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10 * want.max())
    # the eigenvectors are N-orthonormal and solve the pencil (top modes)
    v = tr.evecs.numpy()
    N = np.eye(n) + a_f @ a_f.conj().T
    S = a_s @ a_s.conj().T
    top = slice(n - 5, n)
    np.testing.assert_allclose(
        v[:, top].conj().T @ N @ v[:, top], np.eye(5), rtol=0, atol=1e-8
    )
    np.testing.assert_allclose(
        S @ v[:, top], N @ v[:, top] * got[top], rtol=0, atol=1e-8 * want.max()
    )


def test_triple_svd_masks_and_pads():
    rng = np.random.default_rng(4)
    bfr = _crandn(rng, (3, 6, 9))
    bfr[1, 4:] = 0.0  # rank 4
    bfr[2] = 0.0  # padding item
    ut, beam, sig, nmodes = linalg.triple_svd_batched(torch.as_tensor(bfr), npol=1, nl=9)
    assert ut.shape == (3, 6, 6) and beam.shape == (3, 6, 9) and sig.shape == (3, 6)
    assert nmodes.tolist() == [6, 4, 0]
    np.testing.assert_allclose(
        beam[0].numpy(), ut[0].numpy() @ bfr[0], rtol=0, atol=1e-12
    )
    s_ref = np.linalg.svd(bfr[0], compute_uv=False)
    np.testing.assert_allclose(sig[0].numpy(), s_ref, rtol=1e-12)
    assert float(sig[2].abs().max()) == 0.0
    # npol * nl must match the beam's columns (the polarised stages are in
    # tests/test_torch_pol.py)
    with pytest.raises(ValueError):
        linalg.triple_svd_batched(torch.as_tensor(bfr), npol=2, nl=9)


def test_kl_solve_rejects_unported_engines():
    """Both engines of the JAX package run (the ``gram`` engine's parity is
    in tests/test_torch_gram_engine.py); any other name raises ValueError,
    as in the JAX package."""
    rng = np.random.default_rng(12)
    a_s, a_f = _crandn(rng, (10, 14)) * 0.5, _crandn(rng, (10, 20)) * 3.0
    for method in ("qr", "gram"):
        kl = fpencil.kl_solve(torch.as_tensor(a_s), torch.as_tensor(a_f), method=method)
        want = jfp.kl_solve(za.Z(a_s.real, a_s.imag), za.Z(a_f.real, a_f.imag), method=method)
        np.testing.assert_allclose(kl.evals.numpy(), np.asarray(want.evals), rtol=0,
                                   atol=1e-10 * float(np.max(want.evals)))
    a = torch.zeros((4, 4), dtype=torch.complex128)
    for kl_solve in (fpencil.kl_solve, jfp.kl_solve):
        with pytest.raises(ValueError, match="Unknown kl_solve method"):
            kl_solve(a, a, method="lanczos")


def test_gram_bands_take_the_svd_where_eigh_fails(monkeypatch):
    """Where the Hermitian eigensolver raises (cuSOLVER's divide and
    conquer on Grams with a large near-zero cluster), the Gram's SVD gives
    the same levels: singular values and projectors within 1e-12."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(_crandn(rng, (2, 12, 5)) @ _crandn(rng, (2, 5, 30)))  # rank 5
    want = fpencil.gram_bands(x, levels=2)

    def fail(_):
        raise torch.linalg.LinAlgError("failed to converge")

    before = fpencil.svd_retries
    monkeypatch.setattr(torch.linalg, "eigh", fail)
    got = fpencil.gram_bands(x, levels=2)
    assert fpencil.svd_retries == before + 2
    np.testing.assert_allclose(got.s.numpy(), want.s.numpy(), rtol=0,
                               atol=1e-12 * float(want.s.max()))
    for a, b in ((got.q, want.q),):
        pa = (a @ a.conj().transpose(-1, -2)).numpy()
        pb = (b @ b.conj().transpose(-1, -2)).numpy()
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-10)
