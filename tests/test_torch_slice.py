"""The port's product slice (BTM -> SVD -> KL -> Fisher) against the JAX package.

A small cylinder that retains KL modes (281 above 1e-3) goes through
``resident.btm_resident`` and ``resident.product_all_resident`` with the
fused Fisher in both packages, float64 on the CPU, each package building
its own covariances and factor tables from its own sky models.
"""

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from driftscan_tpu.ops import zarray as za
from driftscan_tpu.parallel import mstep as jms
from driftscan_tpu.parallel import resident as jres
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.parallel import mstep, resident
from driftscan_tpu_torch.telescope import cylinder

CFG = dict(
    num_freq=4,
    freq_start=400.0,
    freq_end=410.0,
    freq_mode="edge",
    num_cylinders=2,
    cylinder_width=3.0,
    num_feeds=3,
    feed_spacing=1.0,
    tsys=50.0,
)
PS_THRESHOLD = 1e-3


def _units(tel):
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    return [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]


@pytest.fixture(scope="module")
def runs():
    jt = jcyl.UnpolarisedCylinderTelescope.from_config(CFG)
    blg, fig = _units(jt)
    cl_s, cl_n, noisew, _ = bench._covariances(jt)
    ls, lf = jms.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
    blt = jms.band_factor_table(
        iter(bench._fisher_bands(jt)), out_dtype=np.float64, rank_rtol=1e-9
    )
    jp, jn = jres.btm_resident(jt, blg, fig)
    jev, jnm, jf = jres.product_all_resident(
        jt, jp, jn, ls, lf, noisew.astype(np.float64), band_lt=blt,
        ps_threshold=PS_THRESHOLD,
    )

    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG, device="cpu")
    t_cl_s, t_cl_n, t_noisew = chip_smoke.covariances(tt)
    t_ls, t_lf = mstep.prepare_cl_factors(t_cl_s, t_cl_n, out_dtype=np.float64)
    t_blt = mstep.band_factor_table(
        iter(chip_smoke.fisher_bands(tt)), out_dtype=np.float64, rank_rtol=1e-9
    )
    tp, tn = resident.btm_resident(tt, blg, fig)
    tev, tnm, tf = resident.product_all_resident(
        tt, tp, tn, t_ls, t_lf, t_noisew.astype(np.float64), band_lt=t_blt,
        ps_threshold=PS_THRESHOLD,
    )
    return dict(
        jax=dict(pos=za.to_numpy(jp), neg=za.to_numpy(jn), ev=jev, nm=jnm, f=jf,
                 cov=(cl_s, cl_n, noisew, blt)),
        port=dict(pos=tp.numpy(), neg=tn.numpy(), ev=tev, nm=tnm, f=tf,
                  cov=(t_cl_s, t_cl_n, t_noisew, t_blt)),
    )


def test_covariances_match(runs):
    for want, got in zip(runs["jax"]["cov"], runs["port"]["cov"]):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


def test_btm_tables_match(runs):
    j, t = runs["jax"], runs["port"]
    assert t["pos"].shape == j["pos"].shape and t["neg"].shape == j["neg"].shape
    scale = np.abs(j["pos"]).max()
    np.testing.assert_allclose(t["pos"], j["pos"], rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(t["neg"], j["neg"], rtol=0, atol=1e-10 * scale)


def test_kl_spectra_match(runs):
    j, t = runs["jax"], runs["port"]
    assert t["ev"].shape == j["ev"].shape
    assert (j["ev"] > PS_THRESHOLD).sum() == 281
    scale = np.abs(j["ev"]).max()
    # spectra, not eigenvectors: the pencil's zero cluster is degenerate; the
    # atol floor covers tail modes whose band assignment shifts with roundoff
    np.testing.assert_allclose(t["ev"], j["ev"], rtol=1e-6, atol=1e-4 * scale)
    np.testing.assert_array_equal(t["nm"], j["nm"])


def test_fisher_matches(runs):
    j, t = runs["jax"], runs["port"]
    assert np.abs(j["f"]).max() > 0  # a Fisher that is not vacuously zero
    np.testing.assert_allclose(t["f"], j["f"], rtol=0, atol=1e-4 * np.abs(j["f"]).max())


def test_unported_options_raise():
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG, device="cpu")
    z = torch.zeros((1, 1, 2, 2), dtype=torch.complex128)
    # the top-band engine and device meshes are ported
    # (tests/test_torch_topband_resident.py, tests/test_torch_mesh_pipeline.py);
    # a mesh that is not a Mesh raises
    with pytest.raises(TypeError, match="Mesh"):
        resident.product_all_resident(tt, z, z, None, None, None, mesh=object())
