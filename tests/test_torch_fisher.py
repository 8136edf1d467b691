"""driftscan_tpu_torch fused Fisher step (K13) against the JAX package.

Seeded random KL spectra, eigenvectors and beams (non-zero, so the Fisher
matrix is not trivially zero) go through ``mstep.fisher_step_split`` and
the port's ``fisher_step`` (plain ``fisher_cov_ref`` on the CPU), both in
float64: rel 1e-10.
"""

import numpy as np
import pytest
import torch

from driftscan_tpu.parallel import mstep as jms
from driftscan_tpu_torch.parallel import mstep


def _inputs(seed, M=3, F=3, S=5, nl=20, nb=3, Kb=2):
    rng = np.random.default_rng(seed)
    n = F * S
    ev = np.sort(np.abs(rng.standard_normal((M, n))) * 3.0, axis=1)
    ev[:, : n // 3] = 0.0  # zero-padded front, as the product step emits
    ev[-1] = 0.0  # a padding m slot
    evec = rng.standard_normal((M, n, n)) + 1j * rng.standard_normal((M, n, n))
    beam = rng.standard_normal((M, F, S, nl)) + 1j * rng.standard_normal((M, F, S, nl))
    clb = []
    for _ in range(nb):
        a = rng.standard_normal((nl, F, F))
        clb.append(a @ a.transpose(0, 2, 1) + 0.1 * np.eye(F))
    blt = jms.band_factor_table(iter(clb), out_dtype=np.float64, l_chunk=8)
    return ev, evec, beam, blt, Kb


@pytest.mark.parametrize("thr", [0.5, 2.0])
def test_fisher_step_matches_jax(thr):
    ev, evec, beam, blt, _ = _inputs(seed=int(thr * 10))
    M, n = ev.shape
    F, S, nl = beam.shape[1:]
    f_re, f_im = jms.fisher_step_split(
        ev, evec.real, evec.imag, beam.real, beam.imag, blt,
        ps_threshold=thr, fisher_k=n, npol=1, nl=nl, l_chunk=8,
    )
    want = np.asarray(f_re) + 1j * np.asarray(f_im)
    assert np.abs(want[:-1]).max() > 0

    kf = int((ev > thr).sum(axis=1).max())
    got = mstep.fisher_step(
        torch.as_tensor(ev), torch.as_tensor(evec), torch.as_tensor(beam),
        torch.as_tensor(blt), ps_threshold=thr, npol=1, nl=nl, kf=kf,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    assert np.abs(got[-1]).max() == 0.0  # the padding slot contributes nothing


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("thr", [0.5, 2.0])
def test_fisher_step_trace_is_the_old_contraction(thr, dtype):
    """The step's tail now goes through ``projections.fisher_trace`` (its
    plain version on the CPU): the same numbers as the contraction it
    replaced, sum_ij w_i w_j C_a[i, j] conj(C_b[i, j]), to 1e-12 (K13's
    covariances are Hermitian, so C_b[j, i] = conj(C_b[i, j]))."""
    ev, evec, beam, blt, _ = _inputs(seed=int(thr * 10) + 1)
    M, n = ev.shape
    F, S, nl = beam.shape[1:]
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    ev_t = torch.as_tensor(ev).to(rdt)
    evec_t, beam_t = torch.as_tensor(evec).to(dtype), torch.as_tensor(beam).to(dtype)
    blt_t = torch.as_tensor(blt).to(rdt)
    kf = int((ev > thr).sum(axis=1).max())
    got = mstep.fisher_step(ev_t, evec_t, beam_t, blt_t, ps_threshold=thr, npol=1, nl=nl, kf=kf)
    assert got.dtype == torch.complex128

    evk = ev_t[:, n - kf:]
    w = torch.where(evk > thr, 1.0 / (1.0 + evk), torch.zeros_like(evk))
    v = evec_t[:, n - kf:].reshape(M, kf, F, S).contiguous()
    c = mstep.fisher_cov(v, beam_t.reshape(M, F, S, 1, nl)[:, :, :, 0].contiguous(), blt_t)
    # Hermitian to rounding here (matmul); bit for bit from the kernel
    assert float((c - c.mH).abs().max()) <= 1e-6 * float(c.abs().max())
    c, w = c.to(torch.complex128), w.to(torch.float64)
    d = c * (w[:, :, None] * w[:, None, :]).to(c.dtype)[:, None]
    want = torch.einsum("maij,mbij->mab", d, c.conj())
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_band_factor_table_matches_jax():
    rng = np.random.default_rng(2)
    clb = []
    for _ in range(2):
        a = rng.standard_normal((30, 4, 2))
        clb.append(a @ a.transpose(0, 2, 1))  # rank 2 per l
    want = jms.band_factor_table(iter(clb), out_dtype=np.float32, rank_rtol=1e-9)
    got = mstep.band_factor_table(iter(clb), out_dtype=np.float32, rank_rtol=1e-9)
    np.testing.assert_array_equal(got, want)


def test_fisher_cov_plain_matches_direct():
    """C_b = Y_b Y_b^H with Y_b = (V B_T) L_b, spelled out with numpy."""
    rng = np.random.default_rng(8)
    M, k, F, S, nl, nb, nlp, Kb = 2, 4, 3, 2, 5, 2, 8, 3
    v = rng.standard_normal((M, k, F, S)) + 1j * rng.standard_normal((M, k, F, S))
    bt = rng.standard_normal((M, F, S, nl)) + 1j * rng.standard_normal((M, F, S, nl))
    lb = rng.standard_normal((nb, nlp, F, Kb))
    got = mstep.fisher_cov(torch.as_tensor(v), torch.as_tensor(bt), torch.as_tensor(lb))
    g = np.einsum("mkfs,mfsl->mkfl", v, bt)
    y = np.einsum("mkfl,blfK->mbklK", g, lb[:, :nl]).reshape(M, nb, k, -1)
    want = y @ y.conj().transpose(0, 1, 3, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_factors_from_numpy():
    ls = np.ones((3, 1, 2, 2), np.float32)
    a, b, c = mstep.factors_from_numpy(ls, 2 * ls, None, "cpu", torch.float64)
    assert a.dtype == torch.float64 and float(b.sum()) == 24.0 and c is None
