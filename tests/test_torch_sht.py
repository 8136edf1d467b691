"""driftscan_tpu_torch SHT analysis (K4 phase stage, K3+K5 Legendre stage)
against the JAX package.

Both run in float64 on the CPU, the port's Legendre stage through its
plain version (``legendre_contract_ref``): rel 1e-10 of the largest
coefficient.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driftscan_tpu.ops import sht as jsht
from driftscan_tpu.ops import zarray as za
from driftscan_tpu_torch.ops import healpix, sht


def _maps(nside, nmaps, seed):
    g = healpix.ring_geometry(nside)
    rng = np.random.default_rng(seed)
    shape = (nmaps, g.nring * g.maxlen)
    m = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return m * g.mask.ravel()


# lmax 40 at nside 16: cap rings of 4..60 pixels alias m up to 40 (the
# FFT bin wraps mod N_r while the phi0 phase uses the true m)
@pytest.mark.parametrize("nside,lmax", [(8, 15), (16, 23), (16, 40)])
def test_analysis_matches_jax(nside, lmax):
    maps = _maps(nside, 3, seed=nside + lmax)
    jp, jn = jsht.analysis_split(
        za.Z(maps.real, maps.imag), lmax=lmax, neg_m=True, nside=nside,
        ring_padded=True,
    )
    jp, jn = za.to_numpy(jp), za.to_numpy(jn)
    tp, tn = sht.analysis(torch.as_tensor(maps), lmax=lmax, nside=nside)
    assert tp.shape == jp.shape and tn.shape == jn.shape
    scale = np.abs(jp).max()
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=0, atol=1e-10 * scale)


# lmax 90: m up to lmax reaches the polar rings' underflow range; lmax 229
# (the bench cylinder's): mantissas pass 1e30, so the rescale factors must be
# float64 (in float32 they put lambda 4e-9 off after the first rescale)
@pytest.mark.parametrize("nside,lmax", [(32, 90), (64, 229)])
def test_legendre_table_matches_jax(nside, lmax):
    g = healpix.ring_geometry(nside)
    mvals = np.arange(lmax + 1)
    logpref = sht._log_lambda_mm_prefactor(lmax)
    want = np.asarray(
        jsht._legendre_chunk(
            jnp.asarray(mvals), jnp.asarray(g.cos_theta), jnp.asarray(g.sin_theta),
            lmax, jnp.asarray(logpref),
        )
    )
    got = sht.legendre_table(
        torch.as_tensor(mvals), torch.as_tensor(g.cos_theta),
        torch.as_tensor(g.sin_theta), lmax, torch.as_tensor(logpref),
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("nm", [1, 2, 7, 8, 121, 230])
def test_m_schedule_covers_each_m_once(nm):
    """The Legendre kernel's block schedule: rows (m, nm - 1 - m) take every
    m exactly once, for odd and even nm, and every row walks the same
    number of multipoles (lmax + 1 - m summed over its m's) but for the
    lone middle m of an odd nm."""
    sched = sht.m_schedule(nm)
    assert sched.dtype == np.int32 and sched.shape == ((nm + 1) // 2, 2)
    taken = sched[sched >= 0]
    assert sorted(taken.tolist()) == list(range(nm))
    lmax = nm + 5
    walks = [sum(lmax + 1 - m for m in row if m >= 0) for row in sched]
    full = [w for row, w in zip(sched, walks) if (row >= 0).all()]
    assert len(set(full)) <= 1
    assert max(walks) <= 2 * (lmax + 1)


def test_legendre_tables_upload_once():
    """The prefactor of lambda_mm and the schedule go to the device once
    per (lmax, nm, device)."""
    dev = torch.device("cpu")
    a = sht._legendre_tables(40, 41, dev)
    assert sht._legendre_tables(40, 41, dev)[0] is a[0]
    np.testing.assert_array_equal(a[0].numpy(), sht._log_lambda_mm_prefactor(40))
    np.testing.assert_array_equal(a[1].numpy(), sht.m_schedule(41))
