"""The hand-written kernels of driftscan_tpu_torch against their plain
versions, on a CUDA card (small shapes; skipped without a card).

This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which pins JAX to the CPU.)
"""

import numpy as np
import pytest
import torch

from driftscan_tpu_torch.ops import fpencil, healpix, kernels, probe, sht
from driftscan_tpu_torch.parallel import mstep
from driftscan_tpu_torch.telescope import cylinder

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


def test_k9_signal_gram(cuda):
    rng = np.random.default_rng(9)
    b = _crandn(rng, (3, 4, 10, 1, 70), cuda)
    L = torch.as_tensor(rng.standard_normal((70, 1, 4, 5)).astype(np.float32), device=cuda)
    _check(fpencil.K9, lambda: fpencil.signal_gram(b, L),
           lambda: fpencil.signal_gram_ref(b, L), 1e-5)


def test_k13_fisher_cov(cuda):
    rng = np.random.default_rng(13)
    v = _crandn(rng, (2, 70, 4, 10), cuda)
    bt = _crandn(rng, (2, 4, 10, 50), cuda)
    lb = torch.as_tensor(rng.standard_normal((3, 64, 4, 5)).astype(np.float32), device=cuda)
    _check(mstep.K13, lambda: mstep.fisher_cov(v, bt, lb),
           lambda: mstep.fisher_cov_ref(v, bt, lb), 1e-4)


def test_wrappers_reject_lazy_conjugates(cuda):
    rng = np.random.default_rng(1)
    v = _crandn(rng, (1, 4, 2, 3), cuda)
    bt = _crandn(rng, (1, 2, 3, 5), cuda)
    lb = torch.ones((1, 8, 2, 1), device=cuda)
    with pytest.raises(ValueError):
        mstep.fisher_cov(v.conj(), bt, lb)


def test_probe_double(cuda):
    x = torch.arange(1000 * 1001, dtype=torch.float32, device=cuda).reshape(1000, 1001)
    _check(probe.PROBE_DOUBLE, lambda: probe.double(x), lambda: probe.double_ref(x), 0.0)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
def test_probe_mm(cuda, dtype, rtol):
    rng = np.random.default_rng(2)
    # ragged shapes exercise the kernel's edge masks
    a = torch.as_tensor(rng.standard_normal((130, 70)), dtype=dtype, device=cuda)
    b = torch.as_tensor(rng.standard_normal((70, 97)), dtype=dtype, device=cuda)
    _check(probe.PROBE_MM, lambda: probe.mm(a, b), lambda: probe.mm_ref(a, b), rtol)
