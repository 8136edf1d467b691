"""The inverse SHT of driftscan_tpu_torch (K14 plain version + the inverse
phase stage), its forward SHT of compact real maps, and the single-process
verbs and forward model of the timestream pipeline, against the JAX
package on the CPU.

Seeded inputs at nside 16 and two band limits: lmax 20, and lmax 47, where
m reaches above the polar rings' N_r (4, 8, ... pixels) so several m fold
into one bin of a ring's spectrum.  Tolerances: rel 1e-10 of the largest
entry in float64, 1e-4 in float32 (the same recurrence in float64, the
contraction summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from driftscan_tpu.core import manager as jmanager
from driftscan_tpu.ops import sht as jsht
from driftscan_tpu.parallel import comm as jcomm
from driftscan_tpu.parallel import mstep as jmstep
from driftscan_tpu_torch.core import manager
from driftscan_tpu_torch.ops import healpix, sht
from driftscan_tpu_torch.parallel import comm, mstep

NSIDE = 16
LMAX = [20, 47]
DTYPES = {"float64": (np.complex128, 1e-10), "float32": (np.complex64, 1e-4)}


def _alm(lmax, lead, seed, neg=False, dtype=np.complex128):
    """Seeded band-limited coefficients (l >= |m|): the m >= 0 block, or the
    negative block (column j holding m = -(j + 1))."""
    rng = np.random.default_rng(seed)
    nm = lmax if neg else lmax + 1
    shape = lead + (lmax + 1, nm)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    m = np.arange(1, lmax + 1) if neg else np.arange(lmax + 1)
    a = np.where(m[None, :] <= np.arange(lmax + 1)[:, None], a, 0)
    if not neg:
        a[..., 0] = a[..., 0].real
    return a.astype(dtype)


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("lmax", LMAX)
def test_synthesis_real(lmax, dt):
    cdt, rtol = DTYPES[dt]
    alm = _alm(lmax, (3,), seed=lmax, dtype=cdt)
    _close(sht.synthesis_real(torch.as_tensor(alm), NSIDE), jsht.synthesis_real(alm, NSIDE), rtol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("lmax", LMAX)
def test_synthesis_complex(lmax, dt):
    cdt, rtol = DTYPES[dt]
    pos = _alm(lmax, (2,), seed=lmax, dtype=cdt)
    neg = _alm(lmax, (2,), seed=lmax + 1, neg=True, dtype=cdt)
    got = sht.synthesis_complex(torch.as_tensor(pos), torch.as_tensor(neg), NSIDE)
    _close(got, jsht.synthesis_complex(pos, neg, NSIDE), rtol)


@pytest.mark.parametrize("lmax", LMAX)
def test_sphtrans_inv_sky(lmax):
    """[freq, pol, l, m] -> [freq, pol, pix], an array in (the CPU named)."""
    alm = _alm(lmax, (2, 1), seed=3 * lmax)
    got = sht.sphtrans_inv_sky(alm, NSIDE, device="cpu")
    assert got.device.type == "cpu"
    _close(got, jsht.sphtrans_inv_sky(alm, NSIDE), 1e-10)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("lmax", LMAX)
def test_sphtrans_sky(lmax, dt):
    cdt, rtol = DTYPES[dt]
    rdt = np.float64 if cdt == np.complex128 else np.float32
    skymap = np.random.default_rng(lmax).standard_normal((2, 1, 12 * NSIDE**2)).astype(rdt)
    got = sht.sphtrans_sky(torch.as_tensor(skymap), lmax=lmax)
    _close(got, jsht.analysis(skymap, lmax)[0], rtol)


def test_sphtrans_sky_refinement_not_ported():
    """The refinement is ported: two steps against the JAX package's."""
    skymap = np.random.default_rng(2).standard_normal((2, 12 * NSIDE**2))
    got = sht.sphtrans_sky(torch.as_tensor(skymap), lmax=LMAX[0], iters=2)
    _close(got, jsht.analysis(skymap, LMAX[0], iters=2)[0], 1e-10)


@pytest.mark.parametrize("lmax", LMAX)
def test_pad_unpad(lmax):
    skymap = np.random.default_rng(lmax).standard_normal((3, 12 * NSIDE**2))
    padded = sht.pad_map(torch.as_tensor(skymap), NSIDE)
    _close(padded, jsht.pad_map(skymap, NSIDE), 0.0)
    _close(sht.unpad_map(padded, NSIDE), skymap, 0.0)


@pytest.mark.parametrize("neg", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("lmax", LMAX)
def test_legendre_synth_ref_matches_a_table_einsum(lmax, neg):
    """The plain K14 against the JAX recurrence's lambda table and one
    numpy einsum per block, with the (-1)^m of the negative block."""
    g = healpix.ring_geometry(NSIDE)
    pos = _alm(lmax, (3,), seed=lmax)
    nalm = _alm(lmax, (3,), seed=lmax + 7, neg=True) if neg else None
    lam = np.asarray(
        jsht._legendre_chunk(
            jnp.arange(lmax + 1), jnp.asarray(g.cos_theta), jnp.asarray(g.sin_theta),
            lmax, jnp.asarray(jsht._log_lambda_mm_prefactor(lmax)),
        )
    )
    tpos, tneg = sht.legendre_synth_ref(
        torch.as_tensor(pos), None if nalm is None else torch.as_tensor(nalm),
        torch.as_tensor(g.cos_theta), torch.as_tensor(g.sin_theta),
    )
    _close(tpos, np.einsum("lmr,blm->bmr", lam, pos), 1e-12)
    if neg:
        shifted = np.concatenate([np.zeros_like(pos[..., :1]), nalm], axis=-1)
        sign = (-1.0) ** np.arange(lmax + 1)
        _close(tneg, np.einsum("lmr,blm->bmr", lam, shifted) * sign[:, None], 1e-12)
    else:
        assert tneg is None


def test_btm_forward_step():
    rng = np.random.default_rng(5)
    beam = rng.standard_normal((4, 2, 6, 9)) + 1j * rng.standard_normal((4, 2, 6, 9))
    alm = rng.standard_normal((4, 2, 9)) + 1j * rng.standard_normal((4, 2, 9))
    got = mstep.btm_forward_step(torch.as_tensor(alm), torch.as_tensor(beam))
    _close(got, jmstep.btm_forward_step(alm, beam), 1e-12)


def test_transpose_blocks_and_parallel_map():
    a = np.arange(4 * 3 * 7).reshape(4, 3, 7)
    for shape in ((4, 3, 7), (4, 3, 5)):
        want = jcomm.transpose_blocks(a, shape)
        _close(comm.transpose_blocks(a, shape), want, 0.0)
        _close(comm.transpose_blocks(torch.as_tensor(a), shape), want, 0.0)
    with pytest.raises(ValueError):
        comm.transpose_blocks(a, (5, 3, 7))
    assert comm.parallel_map(lambda x: x * x, [3, 1, 2]) == jcomm.parallel_map(
        lambda x: x * x, [3, 1, 2]
    )


def test_project_sky_of_a_map(tmp_path):
    """KLTransform.project_sky of a sky map (harmonic=False): the port's,
    on a product directory the JAX package made, against the JAX one."""
    out = str(tmp_path / "prod")
    conf = {
        "config": {"beamtransfers": True, "kltransform": True, "output_directory": out},
        "telescope": {
            "type": "UnpolarisedCylinder", "num_freq": 2, "freq_start": 400.0,
            "freq_end": 410.0, "freq_mode": "edge", "num_cylinders": 2,
            "cylinder_width": 2.0, "num_feeds": 2, "feed_spacing": 1.5, "tsys": 1.0,
        },
        "kltransform": [{"type": "KLTransform", "name": "kl", "threshold": 1e-7}],
    }
    with open(tmp_path / "prod.yaml", "w") as f:
        yaml.safe_dump(conf, f)
    mj = jmanager.ProductManager.from_config(str(tmp_path / "prod.yaml"))
    mj.generate()
    mt = manager.ProductManager.from_config(out, device="cpu")
    skymap = np.random.default_rng(11).standard_normal((2, 1, 12 * NSIDE**2))
    # the m with retained modes: the JAX projection fails on an m without
    # (it writes an empty vector into p2[-0:])
    kl = mt.kltransforms["kl"]
    ms = [mi for mi in range(mt.telescope.mmax + 1) if kl.evals_m(mi) is not None]
    assert len(ms) >= mt.telescope.mmax
    want = mj.kltransforms["kl"].project_sky(skymap, mlist=ms)
    got = kl.project_sky(skymap, mlist=ms)
    assert np.abs(want).max() > 0
    _close(got, want, 1e-10)
    alm = sht.sphtrans_sky(skymap, lmax=mt.telescope.lmax, device="cpu").numpy()
    _close(kl.project_sky(alm, mlist=ms, harmonic=True), want, 1e-10)
    # every m, the empty ones included
    assert np.array_equal(kl.project_sky(skymap)[ms], got[ms])
