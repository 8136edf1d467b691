"""driftscan_tpu_torch K1+K2 (beam bank + visibility maps) against the JAX package.

Both packages run in float64 on the CPU, the port through its plain
PyTorch path (``bank_visibility_maps_ref``), so they agree to rounding:
rel 1e-10 of the largest map value.
"""

import numpy as np
import pytest
import torch

from driftscan_tpu.ops import zarray as za
from driftscan_tpu.telescope import cylbeam as jcylbeam
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.ops import kernels
from driftscan_tpu_torch.telescope import cylbeam, cylinder

CFG = dict(
    num_freq=2,
    freq_start=100.0,
    freq_end=110.0,
    freq_mode="edge",
    num_cylinders=2,
    cylinder_width=2.0,
    num_feeds=2,
    feed_spacing=1.5,
)


def _units(tel):
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    return [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]


def test_visibility_maps_match_jax():
    jt = jcyl.UnpolarisedCylinderTelescope.from_config(CFG)
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG)
    assert tt.npairs == jt.npairs and tt.lmax == jt.lmax
    blg, fig = _units(jt)
    ns = jt._nside_for(jt.lmax)
    jt._init_trans(ns)
    tt._init_trans(ns)
    want = za.to_numpy(jt._beam_map_batch_split(blg, fig))
    got = tt._beam_map_batch(blg, fig)
    assert got.dtype == torch.complex128 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_beam_bank_matches_jax_and_carries_across():
    jt = jcyl.UnpolarisedCylinderTelescope.from_config(dict(CFG, single_precision=True))
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(dict(CFG, single_precision=True))
    widths = jt.cylinder_width / jt.wavelengths
    jpar, jtab = jcylbeam.build_beam_bank(
        jt.zenith, widths, jt.fwhm_e, jt.fwhm_h, False, dtype=np.float32
    )
    tpar, ttab = tt.beam_bank_numpy()
    np.testing.assert_array_equal(tpar, jpar)
    np.testing.assert_array_equal(ttab, jtab)

    # the JAX bank installed in the port drives its beams (K1, plain)
    tt.set_beam_bank(jpar, jtab)
    ns = jt._nside_for(jt.lmax)
    jt._init_trans(ns)
    tt._init_trans(ns)
    want = np.asarray(
        jcylbeam._beam_bank_kernel(
            jt._angpos_cart, jt._horizon, jtab[0], jpar[0], polarised=False
        )
    )
    got = kernels.bank_beam(
        tt._angpos_cart, tt._horizon, torch.as_tensor(ttab[0]), torch.as_tensor(tpar[0])
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("turns", [0.25, 10.4, -37.7])
def test_fringe_range_reduction(turns):
    """The fringe's turns are reduced in float64 before the float32 angle."""
    cart = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float32)
    uv3 = torch.tensor([[turns, 0.0, 0.0]], dtype=torch.float64)
    got = kernels.fringe(cart, uv3)[0, 0]
    want = np.exp(2j * np.pi * turns)
    assert abs(complex(got) - want) < 1e-6


def test_transfer_matrices_match_jax():
    jt = jcyl.UnpolarisedCylinderTelescope.from_config(CFG)
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG)
    blg, fig = _units(jt)
    want = np.asarray(jt.transfer_matrices(blg, fig))
    got = tt.transfer_matrices(blg, fig)
    assert got.shape == want.shape == (len(blg), 1, jt.lmax + 1, 2 * jt.lmax + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
