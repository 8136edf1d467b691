"""The port's polarised path (Stokes maps -> npol=4 BTM -> polarisation-filtering
triple SVD -> KL -> Fisher) against the JAX package.

A small polarised cylinder (2 cylinders x 4 dual-polarisation feeds, 3
channels) that retains KL modes (50 above 1e-3) goes through
``resident.btm_resident`` and ``resident.product_all_resident`` with the
fused Fisher in both packages, float64 on the CPU; the port's kernels run
their plain versions.  Tiers: maps rel 1e-10, BTM 1e-10 of max, SVD rel
1e-3, KL 1e-4 of max, Fisher 3e-2 of max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from driftscan_tpu.ops import linalg as jlinalg
from driftscan_tpu.ops import fpencil as jfp
from driftscan_tpu.ops import kernels as jkernels
from driftscan_tpu.ops import zarray as za
from driftscan_tpu.parallel import mstep as jms
from driftscan_tpu.parallel import resident as jres
from driftscan_tpu.telescope import cylbeam as jcylbeam
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.ops import fpencil, kernels, linalg
from driftscan_tpu_torch.parallel import mstep, resident
from driftscan_tpu_torch.telescope import cylinder

CFG = dict(
    num_freq=3,
    freq_start=400.0,
    freq_end=410.0,
    freq_mode="edge",
    num_cylinders=2,
    cylinder_width=3.0,
    num_feeds=4,
    feed_spacing=0.75,
    tsys=10.0,
)
PS_THRESHOLD = 1e-3
POLSVCUT = 1e-4


def _units(tel):
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    return [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]


def _weighted_beams(tel, pos, neg, noisew, ms):
    """(M, F, ntel, 4*nl) noise-weighted, l >= m masked beams, as the
    product step forms them."""
    nl = tel.lmax + 1
    mv = torch.as_tensor(np.asarray(ms))
    beam = resident._build_beam_batch(pos, neg, mv, tel.npairs, tel.nfreq, 4, nl)
    lmask = (torch.arange(nl)[None, :] >= mv[:, None]).double().repeat(1, 4)
    nw = torch.as_tensor(noisew, dtype=torch.float64)
    return (beam * lmask[:, None, None, :] * nw[None, :, :, None]).numpy()


def _filter_census(bw, nl):
    """Per item: (image rank K1, polarised directions above the cut, s1, s2)."""
    items = bw.reshape(-1, *bw.shape[-2:])
    out = []
    for x in items:
        u1, s1, _ = np.linalg.svd(x, full_matrices=False)
        k1 = int((s1 > s1[0] * linalg.SVD_FLOOR).sum()) if s1[0] > 0 else 0
        bfp = (u1[:, :k1].conj().T @ x)[:, nl:]
        s2 = np.linalg.svd(bfp, compute_uv=False) if k1 else np.zeros(0)
        npol = int((s2 >= s2.max() * POLSVCUT).sum()) if s2.size and s2.max() > 0 else 0
        out.append((k1, npol, s1, s2))
    return out


@pytest.fixture(scope="module")
def runs():
    jt = jcyl.PolarisedCylinderTelescope.from_config(CFG)
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

    tt = cylinder.PolarisedCylinderTelescope.from_config(CFG, device="cpu")
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
        tel=tt, jtel=jt, tables=(tp, tn), noisew=t_noisew.astype(np.float64),
        jax=dict(pos=za.to_numpy(jp), neg=za.to_numpy(jn), ev=jev, nm=jnm, f=jf,
                 cov=(cl_s, cl_n, noisew, blt)),
        port=dict(pos=tp.numpy(), neg=tn.numpy(), ev=tev, nm=tnm, f=tf,
                  cov=(t_cl_s, t_cl_n, t_noisew, t_blt)),
    )


def test_pol_telescope_matches_jax(runs):
    tt, jt = runs["tel"], runs["jtel"]
    assert tt.num_pol_sky == jt.num_pol_sky == 4
    np.testing.assert_array_equal(tt.beamclass, jt.beamclass)
    np.testing.assert_array_equal(tt.feedpositions, jt.feedpositions)
    np.testing.assert_array_equal(tt.polarisation, jt.polarisation)
    np.testing.assert_array_equal(tt.uniquepairs, jt.uniquepairs)
    np.testing.assert_array_equal(tt.included_pol, jt.included_pol)
    assert (tt.lmax, tt.mmax, tt.npairs) == (jt.lmax, jt.mmax, jt.npairs)
    bl = np.arange(tt.npairs)
    # no factor 1/2: that correction is the unpolarised telescope's
    np.testing.assert_allclose(tt.noisepower(bl, 1), jt.noisepower(bl, 1), rtol=1e-14)
    assert tt.noisepower(bl, 1).shape == (tt.npairs,)
    # the product path runs unbucketed here, as at the bench's polarised config
    prof = resident._analytic_dof_bound(tt, tt.mmax + 1).astype(np.float64)
    S = min(tt.lmax + 1, 2 * tt.npairs)
    assert float((prof**3).sum()) >= 0.5 * (tt.mmax + 1) * float(tt.nfreq * S) ** 3


def test_pol_covariances_match(runs):
    for want, got in zip(runs["jax"]["cov"], runs["port"]["cov"]):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())
    cl_n = runs["port"]["cov"][1]
    assert cl_n.shape[:2] == (4, 4) and np.abs(cl_n[1, 1]).max() > 0  # polarised foregrounds


def test_pol_btm_tables_match(runs):
    j, t = runs["jax"], runs["port"]
    assert t["pos"].shape == j["pos"].shape and t["pos"].shape[1] == 4
    scale = np.abs(j["pos"]).max()
    for p in range(4):  # every Stokes component carries response
        assert np.abs(t["pos"][:, p]).max() > 1e-6 * scale
    np.testing.assert_allclose(t["pos"], j["pos"], rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(t["neg"], j["neg"], rtol=0, atol=1e-10 * scale)


def test_stokes_maps_match_jax(runs):
    """bank_stokes_maps_ref against JAX stokes_visibility_map on JAX bank beams."""
    jt, tt = runs["jtel"], runs["tel"]
    widths = jt.cylinder_width / jt.wavelengths
    jpar, jtab = jcylbeam.build_beam_bank(
        jt.zenith, widths, jt.fwhm_e, jt.fwhm_h, True, dtype=np.float64
    )
    tt = cylinder.PolarisedCylinderTelescope.from_config(CFG, device="cpu")
    tt.set_beam_bank(jpar, jtab)
    blg, fig = _units(jt)
    ns = jt._nside_for(jt.lmax)
    jt._init_trans(ns)
    tt._init_trans(ns)
    beams = {
        f: np.asarray(jcylbeam._beam_bank_kernel(
            jt._angpos_cart, jt._horizon, jtab[f], jpar[f], polarised=True
        ))
        for f in range(jt.nfreq)
    }  # (C, npix, 2)
    got_beams = kernels.bank_beam(
        tt._angpos_cart, tt._horizon, torch.as_tensor(jtab[0]),
        torch.as_tensor(jpar[0]), polarised=True,
    )
    np.testing.assert_allclose(
        got_beams.numpy(), beams[0], rtol=0, atol=1e-10 * np.abs(beams[0]).max()
    )
    ci = [jt.beamclass[jt.uniquepairs[b, 0]] for b in blg]
    cj = [jt.beamclass[jt.uniquepairs[b, 1]] for b in blg]
    bi = np.stack([beams[f][c] for f, c in zip(fig, ci)])
    bj = np.stack([beams[f][c] for f, c in zip(fig, cj)])
    uv = np.stack([jt.baselines[b] / jt.wavelengths[f] for b, f in zip(blg, fig)])
    want = np.asarray(jkernels.stokes_visibility_map(
        bi, bj, uv, jnp.asarray(jt.zenith), jt._angpos_cart, jt._horizon,
        pxarea=4.0 * np.pi / (12 * ns**2),
    ))
    got = tt._beam_map_batch(blg, fig)
    assert got.shape == want.shape == (len(blg), 4, tt._horizon.shape[0])
    scale = np.abs(want).max()
    for p in range(4):
        assert np.abs(want[:, p]).max() > 1e-3 * scale
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * scale)


def test_polpattern_guards():
    """A dipole along n gets a zero vector and a pole gets phi = 0, never NaN.

    (Points where the JAX package's arccos/arctan2 leave rounding, as
    sin(arccos(-1)) = 1.2e-16, are not compared.)
    """
    cart = torch.tensor(
        [[0.0, 0.0, 1.0], [0.0, 0.6, -0.8], [0.48, 0.6, 0.64], [0.6, 0.0, 0.8]],
        dtype=torch.float64,
    )
    dip = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64)
    got = kernels.polpattern(cart, dip).numpy()  # (2, 4, 2)
    want = np.stack([
        np.asarray(jkernels.polpattern(jnp.asarray(cart.numpy()), jnp.asarray(d)))
        for d in dip.numpy()
    ])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[1, 0], 0.0)  # z dipole seen from the pole


def test_pol_triple_svd_matches_jax(runs):
    tel, (tp, tn) = runs["tel"], runs["tables"]
    nl = tel.lmax + 1
    ms = [2, 18, 33, 46, 50]
    bw = _weighted_beams(tel, tp, tn, runs["noisew"], ms)
    items = bw.reshape(-1, *bw.shape[-2:])
    census = _filter_census(bw, nl)
    for k1, npol, s1, s2 in census:
        # the polarisation filter leaves modes, and no singular value sits
        # within 1% of a cut: polsvcut for SVD2, the 1e-5 image floor for SVD1
        assert npol < k1
        r2 = s2 / s2.max()
        assert not ((r2 > 0.99 * POLSVCUT) & (r2 < 1.01 * POLSVCUT)).any()
        r1 = s1 / s1[0]
        assert not ((r1 > 0.99 * linalg.SVD_FLOOR) & (r1 < 1.01 * linalg.SVD_FLOOR)).any()

    ut, beam, sig, nmodes = linalg.triple_svd_batched(
        torch.as_tensor(items), npol=4, nl=nl, polsvcut=POLSVCUT
    )
    j = jlinalg.triple_svd_split_batched(
        jnp.asarray(items.real), jnp.asarray(items.imag), npol=4, nl=nl,
        polsvcut=POLSVCUT,
    )
    jsig, jnm = np.asarray(j[4]), np.asarray(j[5])
    np.testing.assert_array_equal(nmodes.numpy(), jnm)
    assert (jnm > 0).all()
    got = sig.numpy()
    np.testing.assert_allclose(got, jsig, rtol=1e-3, atol=0)
    # the Stokes-I projection: rows of ut are orthonormal over the kept modes
    jbeam = np.asarray(j[2]) + 1j * np.asarray(j[3])
    for i, k in enumerate(jnm):
        u = ut[i, :k].numpy()
        np.testing.assert_allclose(u @ u.conj().T, np.eye(k), rtol=0, atol=1e-8)
        np.testing.assert_allclose(
            np.abs(beam[i, :k, :nl].numpy()), np.abs(jbeam[i, :k, :nl]), rtol=0,
            atol=1e-3 * np.abs(jbeam[i, :k, :nl]).max(),
        )


def test_pol_filter_residue_keeps_no_modes(runs):
    """Where the filter removes the whole image (m = 0 here), the port keeps
    no mode, as the reference's empty null space does; the JAX package keeps
    the residue of its CGS2 projection as modes."""
    tel, (tp, tn) = runs["tel"], runs["tables"]
    nl = tel.lmax + 1
    bw = _weighted_beams(tel, tp, tn, runs["noisew"], [0])
    items = bw.reshape(-1, *bw.shape[-2:])
    for k1, npol, s1, _ in _filter_census(bw, nl):
        assert npol >= k1 > 0
    _, _, sig, nmodes = linalg.triple_svd_batched(torch.as_tensor(items), npol=4, nl=nl)
    assert (nmodes.numpy() == 0).all() and float(sig.abs().max()) == 0.0
    j = jlinalg.triple_svd_split_batched(
        jnp.asarray(items.real), jnp.asarray(items.imag), npol=4, nl=nl
    )
    # the JAX modes are the residue of its Gram-method CGS2 (~1e-10 of the beam)
    jsig = np.asarray(j[4])
    s1max = np.abs(np.linalg.svd(items, compute_uv=False)).max(-1)
    assert (np.asarray(j[5]) > 0).all() and (jsig.max(-1) < 1e-8 * s1max).all()


def test_pol_kl_spectra_match(runs):
    j, t = runs["jax"], runs["port"]
    assert t["ev"].shape == j["ev"].shape
    assert (j["ev"] > PS_THRESHOLD).sum() == 50
    scale = np.abs(j["ev"]).max()
    np.testing.assert_allclose(t["ev"], j["ev"], rtol=0, atol=1e-4 * scale)
    # nmodes agree wherever the filter leaves modes; where it removes the
    # whole image the port keeps none (test_pol_filter_residue_keeps_no_modes)
    tel, (tp, tn) = runs["tel"], runs["tables"]
    bad = np.argwhere(t["nm"] != j["nm"])
    for m in np.unique(bad[:, 0]):
        bw = _weighted_beams(tel, tp, tn, runs["noisew"], [m])
        census = _filter_census(bw, tel.lmax + 1)
        for f in bad[bad[:, 0] == m, 1]:
            k1, npol, _, _ = census[f]
            assert npol >= k1 and t["nm"][m, f] == 0, (m, f)
    assert len(bad) <= tel.nfreq


def test_pol_fisher_matches(runs):
    j, t = runs["jax"], runs["port"]
    assert np.abs(j["f"]).max() > 0
    np.testing.assert_allclose(t["f"], j["f"], rtol=0, atol=3e-2 * np.abs(j["f"]).max())
    np.testing.assert_allclose(t["f"], t["f"].conj().T, rtol=0, atol=1e-10 * np.abs(t["f"]).max())


@pytest.mark.parametrize("skip,kept", [("skip_V", 3), ("skip_pol", 1)])
def test_skipped_stokes_components_are_zero(runs, skip, kept):
    cfg = dict(CFG, num_freq=1, num_feeds=2)
    full = cylinder.PolarisedCylinderTelescope.from_config(cfg, device="cpu")
    part = cylinder.PolarisedCylinderTelescope.from_config(
        dict(cfg, **{skip: True}), device="cpu"
    )
    assert part._npol_transform == kept and part.num_pol_sky == 4
    np.testing.assert_array_equal(part.included_pol, np.arange(kept))
    bl = np.arange(full.npairs)
    fi = np.zeros_like(bl)
    fp, fn = resident.btm_resident(full, bl, fi)
    pp, pn = resident.btm_resident(part, bl, fi)
    assert float(pp[:, kept:].abs().max()) == 0.0 and float(pn[:, kept:].abs().max()) == 0.0
    torch.testing.assert_close(pp[:, :kept], fp[:, :kept], rtol=0, atol=1e-14)
    torch.testing.assert_close(pn[:, :kept], fn[:, :kept], rtol=0, atol=1e-14)
    tarr = part.transfer_matrices(bl, fi)
    assert tarr.shape[1] == 4 and np.abs(tarr[:, kept:]).max() == 0.0
    np.testing.assert_allclose(
        tarr[:, :kept, :, : part.lmax + 1], pp[:, :kept].numpy(), rtol=0, atol=1e-14
    )


def test_pol_unported_options_raise():
    tt = cylinder.PolarisedCylinderTelescope.from_config(dict(CFG, num_freq=1), device="cpu")
    z = torch.zeros((1, 4, 2, 2), dtype=torch.complex128)
    # the top-band engine and device meshes are ported
    # (tests/test_torch_topband_resident.py, tests/test_torch_mesh_pipeline.py);
    # a mesh that is not a Mesh raises
    with pytest.raises(TypeError, match="Mesh"):
        resident.product_all_resident(tt, z, z, None, None, None, mesh=object())
    with pytest.raises(ValueError):
        kernels.bank_stokes_maps(*(torch.zeros(1),) * 7, pxarea=1.0, npol=5)


@pytest.mark.parametrize(
    "build,cls,params,k9",
    [
        (bench.build_telescope, cylinder.UnpolarisedCylinderTelescope, "BENCH_PARAMS", True),
        (bench.build_pol_telescope, cylinder.PolarisedCylinderTelescope, "POL_PARAMS", False),
    ],
    ids=["unpolarised", "polarised"],
)
def test_path_kernel_list_follows_product_rule(build, cls, params, k9):
    """chip_smoke.py's kernel list of each bench leg takes K9 exactly where
    the JAX product step re-factors the signal side (``mstep.py``'s
    ``nl * K > 2 * n``), at the pencil size the JAX package uses."""
    jt = build()
    ls, _ = jms.prepare_cl_factors(*bench._covariances(jt)[:2])
    nl = jt.lmax + 1
    n_jax = jt.nfreq * min(nl, 2 * jt.npairs)
    assert (nl * ls.shape[-1] > 2 * n_jax) is k9

    tt = cls.from_config(getattr(chip_smoke, params), device="cpu")
    t_ls, _ = mstep.prepare_cl_factors(*chip_smoke.covariances(tt)[:2])
    assert t_ls.shape == ls.shape
    names, n, width = chip_smoke.path_kernels(tt, t_ls.shape[-1])
    assert (n, width) == (n_jax, nl * ls.shape[-1])
    assert ("k9_signal_gram" in names) is k9
    assert mstep.uses_compact_signal(n, width) is k9


def test_factor_cl_pol_coupled_matches_jax():
    """factor_cl's dense (npol F)^2 path, taken when pols are cross-coupled."""
    rng = np.random.default_rng(17)
    npol, nl, F = 4, 6, 3
    a = rng.standard_normal((nl, npol * F, npol * F))
    c = a @ a.transpose(0, 2, 1) + 1e-3 * np.eye(npol * F)
    cl = c.reshape(nl, npol, F, npol, F).transpose(1, 3, 0, 2, 4)
    want = jfp.factor_cl(cl, out_dtype=np.float64)
    got = fpencil.factor_cl(cl, out_dtype=np.float64)
    assert got.shape == want.shape == (nl, npol, F, npol * F)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    lf = got.reshape(nl, npol * F, npol * F)
    np.testing.assert_allclose(lf @ lf.transpose(0, 2, 1), c, rtol=0, atol=1e-9 * np.abs(c).max())
