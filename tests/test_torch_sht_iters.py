"""The forward SHT's Jacobi refinement (``sht.analysis_maps(..., iters)``,
``sphtrans_sky(iters=)``) and ``sphtrans_complex`` / ``sphtrans_complex_pol``
of the port against the JAX package's ``analysis`` and wrappers, on the CPU
in float64 (complex128), at nside 8 and 16: coefficients within 1e-10 of
their largest, each case printing what it reached.  Each refinement step
lowers the map residual, and the JAX package's errors carry over.
"""

import numpy as np
import pytest
import torch

from driftscan_tpu.ops import sht as jsht
from driftscan_tpu_torch.ops import sht


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _gap(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("nside,lmax,mmax", [(8, 20, None), (16, 47, None), (16, 40, 17)])
@pytest.mark.parametrize("iters", [1, 3])
def test_real_refinement_matches_jax(nside, lmax, mmax, iters):
    x = np.random.default_rng(nside + iters).standard_normal((2, 1, 12 * nside**2))
    want = jsht.analysis(x, lmax, mmax=mmax, iters=iters)
    got = sht.analysis_maps(torch.as_tensor(x), lmax, mmax=mmax, iters=iters)
    assert got[1] is None and want[1] is None
    gap = _gap(got[0], want[0])
    print(f"real nside {nside} lmax {lmax} mmax {mmax} iters {iters}: {gap:.2e} of max")
    assert gap < 1e-10
    if mmax is None:
        gap = _gap(sht.sphtrans_sky(torch.as_tensor(x), lmax=lmax, iters=iters), want[0])
        assert gap < 1e-10


@pytest.mark.parametrize("nside,lmax", [(8, 20), (16, 47)])
@pytest.mark.parametrize("iters", [0, 2])
def test_complex_refinement_matches_jax(nside, lmax, iters):
    rng = np.random.default_rng(3 * nside + iters)
    z = rng.standard_normal((3, 12 * nside**2)) + 1j * rng.standard_normal((3, 12 * nside**2))
    jp, jn = jsht.analysis(z, lmax, neg_m=True, iters=iters)
    pp, pn = sht.analysis_maps(torch.as_tensor(z), lmax, neg_m=True, iters=iters)
    gp, gn = _gap(pp, jp), _gap(pn, jn)
    print(f"complex nside {nside} lmax {lmax} iters {iters}: pos {gp:.2e}, neg {gn:.2e} of max")
    assert gp < 1e-10 and gn < 1e-10


def test_residual_falls_at_every_step():
    """A band-limited map: each step shrinks the resynthesis residual
    (healpy's ``iter``); the coefficients converge on the input's."""
    nside, lmax = 16, 30
    rng = np.random.default_rng(7)
    alm = rng.standard_normal((1, lmax + 1, lmax + 1)) + 1j * rng.standard_normal(
        (1, lmax + 1, lmax + 1))
    alm[:, :, 0] = alm[:, :, 0].real
    alm = np.triu(alm.transpose(0, 2, 1)).transpose(0, 2, 1)  # l >= m
    x = sht.synthesis_real(torch.as_tensor(alm), nside)
    resid, err = [], []
    for it in range(4):
        a = sht.analysis_maps(x, lmax, iters=it)[0]
        resid.append(float((x - sht.synthesis_real(a, nside)).abs().max()))
        err.append(float((a - torch.as_tensor(alm)).abs().max()))
    print("residuals", resid, "coefficient errors", err)
    assert all(b < a for a, b in zip(resid, resid[1:]))
    assert all(b < a for a, b in zip(err, err[1:]))


@pytest.mark.parametrize("lside", [None, 30])
def test_sphtrans_complex_matches_jax(lside):
    nside, lmax = 8, 20
    rng = np.random.default_rng(11)
    z = rng.standard_normal((2, 12 * nside**2)) + 1j * rng.standard_normal((2, 12 * nside**2))
    want = jsht.sphtrans_complex(z, lmax=lmax, lside=lside)
    got = sht.sphtrans_complex(z, lmax=lmax, lside=lside, device="cpu")
    gap = _gap(got, want)
    print(f"sphtrans_complex lside {lside}: {gap:.2e} of max")
    assert got.dtype == np.complex128 and gap < 1e-10
    stack = np.stack([z, 2 * z])
    gap = _gap(sht.sphtrans_complex_pol(stack, lmax=lmax, device="cpu"),
               jsht.sphtrans_complex_pol(stack, lmax=lmax))
    print(f"sphtrans_complex_pol: {gap:.2e} of max")
    assert gap < 1e-10
    # the default band limit, 3 nside - 1
    assert _gap(sht.sphtrans_complex(torch.as_tensor(z)), jsht.sphtrans_complex(z)) < 1e-10


def test_errors_carry_over():
    nside = 4
    z = torch.ones((12 * nside**2,), dtype=torch.complex128)
    for fn, arg in ((jsht.analysis, z.numpy()), (sht.analysis_maps, z)):
        with pytest.raises(ValueError, match="neg_m"):
            fn(arg, 8, iters=1)
    padded = torch.zeros(sht.pad_map(torch.zeros(12 * nside**2), nside).shape[-1])
    with pytest.raises(ValueError, match="cannot be refined"):
        sht.analysis_maps(padded, 8, nside=nside, iters=1)
    with pytest.raises(ValueError):
        jsht.analysis(padded.numpy(), 8, nside=nside, iters=1, ring_padded=True)
    for fn, arg in ((jsht.sphtrans_complex, z.numpy()), (sht.sphtrans_complex, z)):
        with pytest.raises(NotImplementedError, match="centered"):
            fn(arg, centered=True)
