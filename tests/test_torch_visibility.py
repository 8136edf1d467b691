"""The port's ``core/visibility.py`` against the JAX package's, float64 on
the CPU: the UV-plane basis, the horizon, the fringe, the cylinder's sinc
beam and the I/Q/U feed projections at seeded sky positions and zeniths.
Tolerance: 1e-12 of each output's largest entry (the fringe's phase is
reduced to whole turns in the port, the JAX one is not: both are the same
exp(2 pi i n.u) to rounding).
"""

import numpy as np
import pytest

from driftscan_tpu.core import visibility as jvis
from driftscan_tpu_torch.core import visibility

TOL = 1e-12
ZENITHS = [np.array([np.pi / 4, 0.0]), np.array([np.pi / 2 - np.radians(49.3), 2.1])]


def _sky(n=400, seed=5):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    return np.stack([theta, phi], axis=-1)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= TOL * scale


@pytest.mark.parametrize("zi", range(len(ZENITHS)))
def test_uv_plane_cart(zi):
    for got, want in zip(visibility.uv_plane_cart(ZENITHS[zi]),
                         jvis.uv_plane_cart(ZENITHS[zi])):
        _close(got, want)


@pytest.mark.parametrize("zi", range(len(ZENITHS)))
def test_horizon(zi):
    got = visibility.horizon(_sky(), ZENITHS[zi])
    want = jvis.horizon(_sky(), ZENITHS[zi])
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("zi", range(len(ZENITHS)))
def test_fringe(zi):
    uv = np.array([[3.0, 0.0], [-1.5, 7.25], [40.0, -12.0]])
    got = visibility.fringe(_sky(), ZENITHS[zi], uv)
    want = jvis.fringe(_sky(), ZENITHS[zi], uv)
    assert got.shape == (3, len(_sky()))
    _close(got, want)


@pytest.mark.parametrize("zi", range(len(ZENITHS)))
@pytest.mark.parametrize("width", [2.5, 30.0])
def test_cylinder_beam(zi, width):
    _close(visibility.cylinder_beam(_sky(), ZENITHS[zi], width),
           jvis.cylinder_beam(_sky(), ZENITHS[zi], width))


@pytest.mark.parametrize("feeds", [((1.0, 0.0), (1.0, 0.0)), ((1.0, 0.0), (0.0, 1.0)),
                                   ((0.6, 0.8), (-0.8, 0.6))])
def test_pol_IQU(feeds):
    got = visibility.pol_IQU(_sky(), ZENITHS[1], *feeds)
    want = jvis.pol_IQU(_sky(), ZENITHS[1], *feeds)
    for g, w in zip(got, want):
        _close(g, w)
