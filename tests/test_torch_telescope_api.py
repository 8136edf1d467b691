"""The index-map and noise API of the port's ``core/telescope.py`` against
the JAX package's: ``map_half_plane``, ``input_index``,
``noisepower_feedpairs``, ``prodstack``, ``index_map_prod``,
``index_map_stack`` and ``reverse_map_stack``, on JAX
``tests/test_simplepolarizedtelescope.py``'s dummy polarised telescope
(and that test's reference values) and on small cylinders of both kinds.
Structured arrays must be equal field by field, dtypes included; the noise
power rel 1e-14.
"""

import numpy as np
import pytest

from driftscan_tpu.core import telescope as jtelescope
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.core import telescope
from driftscan_tpu_torch.telescope import cylinder

INDEX_MAPS = ("input_index", "prodstack", "index_map_prod", "index_map_stack",
              "reverse_map_stack")
CYL = dict(num_freq=3, freq_start=400.0, freq_end=420.0, freq_mode="edge",
           num_cylinders=2, cylinder_width=3.0, num_feeds=3, feed_spacing=0.75)


def _dummy(base):
    class DummyPolarisedTelescope(base):
        """The JAX test's instrument: fixed feeds, delta-ish beams."""

        num_freq = 2
        freq_start = 100.0
        freq_end = 110.0
        freq_mode = "edge"

        @property
        def _single_feedpositions(self):
            return np.array([[0.0, 0.0], [3.0, 0.0], [0.0, 4.0]])

        @property
        def u_width(self):
            return 1.0

        @property
        def v_width(self):
            return 1.0

        def beamx(self, feed, freq):
            b = np.zeros((self._angpos.shape[0], 2))
            b[:, 1] = 1.0
            return b

        def beamy(self, feed, freq):
            b = np.zeros((self._angpos.shape[0], 2))
            b[:, 0] = 1.0
            return b

    return DummyPolarisedTelescope


PAIRS = {
    "dummy": lambda: (_dummy(telescope.SimplePolarisedTelescope)(device="cpu"),
                      _dummy(jtelescope.SimplePolarisedTelescope)()),
    "unpol cylinder": lambda: (
        cylinder.UnpolarisedCylinderTelescope.from_config(CYL, device="cpu"),
        jcyl.UnpolarisedCylinderTelescope.from_config(CYL)),
    "pol cylinder": lambda: (
        cylinder.PolarisedCylinderTelescope.from_config(dict(CYL, in_cylinder=False),
                                                        device="cpu"),
        jcyl.PolarisedCylinderTelescope.from_config(dict(CYL, in_cylinder=False))),
}


def _equal_structured(got, want):
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    for name in want.dtype.names or ():
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if want.dtype.names is None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("what", INDEX_MAPS)
@pytest.mark.parametrize("which", sorted(PAIRS))
def test_index_maps_match(which, what):
    tt, jt = PAIRS[which]()
    _equal_structured(getattr(tt, what), getattr(jt, what))


@pytest.mark.parametrize("which", sorted(PAIRS))
def test_noisepower_feedpairs_matches(which):
    tt, jt = PAIRS[which]()
    rng = np.random.default_rng(3)
    n = tt.nfeed
    fi, fj = rng.integers(0, n, 7), rng.integers(0, n, 7)
    f_ind = rng.integers(0, tt.nfreq, 7)
    m = rng.integers(0, 20, 7)
    for ndays in (None, 3):
        got = tt.noisepower_feedpairs(fi, fj, f_ind, m, ndays=ndays)
        want = jt.noisepower_feedpairs(fi, fj, f_ind, m, ndays=ndays)
        assert got.shape == want.shape == (7,)
        np.testing.assert_allclose(got, want, rtol=1e-14)
    # broadcast over a scalar channel and an m axis
    got = tt.noisepower_feedpairs(fi[:, None], fj[:, None], 0, np.arange(4)[None, :])
    want = jt.noisepower_feedpairs(fi[:, None], fj[:, None], 0, np.arange(4)[None, :])
    assert got.shape == want.shape == (7, 4)
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_reference_values():
    """JAX ``tests/test_simplepolarizedtelescope.py``'s assertions, on the port."""
    tt = _dummy(telescope.SimplePolarisedTelescope)(device="cpu")
    tt.calculate_feedpairs()
    npw = tt.noisepower_feedpairs(np.arange(3), np.arange(3), np.zeros(3, int), np.arange(3))
    assert npw.shape == (3,)
    assert (npw > 0).all()
    # the reference value: Tsys^2 / (2 pi delnu ndays) / 2
    bw = np.abs(tt.frequencies[1] - tt.frequencies[0]) * 1e6
    delnu = telescope.T_SIDEREAL * bw / (2 * np.pi)
    np.testing.assert_allclose(npw, tt.tsys_flat**2 / (2 * np.pi * delnu * tt.ndays) / 2,
                               rtol=1e-15)
    assert tt.nfeed == 6
    np.testing.assert_array_equal(tt.input_index["chan_id"], np.arange(6))
    # every unique pair appears in the stack map; the reverse map inverts it
    nprod = tt.nfeed * (tt.nfeed + 1) // 2
    assert len(tt.index_map_prod) == nprod == len(tt.reverse_map_stack)
    assert len(tt.index_map_stack) == len(tt.prodstack) == tt.npairs
    prod = tt.index_map_prod[tt.index_map_stack["prod"]]
    a, b = tt.prodstack["input_a"], tt.prodstack["input_b"]
    conj = tt.index_map_stack["conjugate"].astype(bool)
    np.testing.assert_array_equal(np.where(conj, b, a), prod["input_a"])
    np.testing.assert_array_equal(np.where(conj, a, b), prod["input_b"])


def test_map_half_plane():
    rng = np.random.default_rng(11)
    arr = rng.integers(-3, 4, (64, 2)).astype(np.float64)
    got = telescope.map_half_plane(arr)
    np.testing.assert_array_equal(got, jtelescope.map_half_plane(arr))
    assert ((got[:, 0] > 0) | ((got[:, 0] == 0) & (got[:, 1] >= 0))).all()
    np.testing.assert_array_equal(np.abs(got), np.abs(arr))
