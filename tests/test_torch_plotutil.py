"""The port's ``util/plotutil.regrid_polar`` against the JAX package's and
against JAX ``tests/test_plotutil.py``'s per-pixel loop over the same
semantics (nearest polar bin, NaN outside the binned domain, a sample on
an interior edge in the bin above): equal to the bit, NaNs in the same
places."""

import numpy as np
import pytest

from driftscan_tpu.util import plotutil as jplotutil
from driftscan_tpu_torch.util import plotutil
from test_plotutil import _slow_reference

CASES = {
    "bruteforce": (5, 4, 40, np.linspace(0.01, 1.0, 6), np.linspace(0.0, np.pi / 2, 5)),
    "domain": (3, 3, 64, np.linspace(0.0, 1.0, 4), np.linspace(0.0, np.pi / 2, 4)),
    "uneven": (4, 6, 33, np.array([0.05, 0.1, 0.2, 0.4, 0.9]),
               np.array([0.0, 0.1, 0.3, 0.7, 1.0, 1.3, np.pi / 2])),
}


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep], want[keep])


@pytest.mark.parametrize("case", sorted(CASES))
def test_regrid_polar_matches(case):
    nr, nt, res, r_bins, theta_bins = CASES[case]
    img = np.random.default_rng(7).standard_normal((nr, nt))
    got = plotutil.regrid_polar(img, r_bins, theta_bins, res=res)
    _same(got, jplotutil.regrid_polar(img, r_bins, theta_bins, res=res))
    _same(got, _slow_reference(img, r_bins, theta_bins, res))


def test_regrid_polar_domain_mask():
    out = plotutil.regrid_polar(np.ones((3, 3)), np.linspace(0.0, 1.0, 4),
                                np.linspace(0.0, np.pi / 2, 4), res=64)
    assert np.isnan(out[-1, -1])
    assert out[0, 0] == 1.0
    axis = np.linspace(0.0, 1.0, 64)
    rr = np.hypot(axis[:, None], axis[None, :])
    assert not np.isnan(out[(rr < 0.999) & (axis[:, None] > 0)]).any()
