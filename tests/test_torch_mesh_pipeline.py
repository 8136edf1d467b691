"""The port's batched solves, product step and resident product on a device
mesh, against its own unsharded runs and against the JAX package's on a mesh.

The counterpart of ``tests/test_mesh_pipeline.py`` and
``tests/test_split_path.py::test_product_step_split_sharded``: the JAX
functions run sharded over the virtual CPU devices of ``tests/conftest.py``
(``mesh8``, or 2 devices for the resident product), the port's over entries
of ``cpu`` (one worker thread each).  Against its own ``mesh=None`` the port
is held to 1e-10 (the JAX mesh tests' tolerance), and bit for bit where each
shard gets exactly the batch of an unsharded dispatch; against the JAX
package each function is held to the tolerance of its unsharded parity test,
named beside each comparison.
"""

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from driftscan_tpu.ops import fpencil as jfp
from driftscan_tpu.ops import projections as JP
from driftscan_tpu.ops import zarray as za
from driftscan_tpu.parallel import mesh as jmesh
from driftscan_tpu.parallel import mstep as jms
from driftscan_tpu.parallel import resident as jres
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.ops import projections as TP
from driftscan_tpu_torch.parallel import mesh as tmesh
from driftscan_tpu_torch.parallel import mstep, resident
from driftscan_tpu_torch.telescope import cylinder


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def mesh8():
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(devices[:8]), tmesh.make_mesh(["cpu"] * 8)


def _random_bsvd(rng, M, F, S, npol, nl):
    b = rng.standard_normal((M, F, S, npol, nl)) + 1j * rng.standard_normal((M, F, S, npol, nl))
    return b * 0.1


def _psd_cl(rng, npol, nl, F, scale):
    a = rng.standard_normal((nl, npol * F, npol * F))
    m = np.einsum("lij,lkj->lik", a, a) * scale
    return m.reshape(nl, npol, F, npol, F).transpose(1, 3, 0, 2, 4)


def _inputs(seed, M, fg=1e6):
    rng = np.random.default_rng(seed)
    F, S, npol, nl = 2, 3, 1, 6
    bsvd = _random_bsvd(rng, M, F, S, npol, nl)
    ls = jfp.factor_cl(_psd_cl(rng, npol, nl, F, 1.0))
    lf = jfp.factor_cl(_psd_cl(rng, npol, nl, F, fg))
    return bsvd, ls, lf


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("M,fg", [(8, 1e6), (5, 1e4)])
def test_kl_factored_batched_sharded(mesh8, M, fg):
    """M 8 over 8 entries, and the ragged M 5 (padded by repeating the last
    m, then trimmed).  Against JAX: 1e-8 of the top eigenvalue, the
    tolerance of tests/test_torch_projections.py::test_kl_factored_batched."""
    jm, tm = mesh8
    bsvd, ls, lf = _inputs(M, M, fg)
    w, v = TP.kl_factored_batched(bsvd, ls, lf, device="cpu", mesh=tm)
    assert w.shape == (M, 6) and v.shape == (M, 6, 6)
    w1, v1 = TP.kl_factored_batched(bsvd, ls, lf, device="cpu", mesh=None)
    assert _rel(w, w1) <= 1e-10 and _rel(v.abs(), v1.abs()) <= 1e-10
    jw, _ = JP.kl_factored_batched(bsvd, ls, lf, mesh=jm)
    assert np.asarray(jw).shape == (M, 6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(jw)).max())


def test_triple_svd_sharded(mesh8):
    """11 units over 8 entries.  Against JAX: singular values 1e-10 of the
    top and equal mode counts, as
    tests/test_torch_projections.py::test_triple_svd_file_cuts_keep_faint_modes."""
    jm, tm = mesh8
    rng = np.random.default_rng(2)
    n, ntel, npol, nl = 11, 8, 1, 6
    bfm = rng.standard_normal((n, ntel, npol * nl)) + 1j * rng.standard_normal((n, ntel, npol * nl))
    ut1, beam1, sig1, nm1 = TP.triple_svd(bfm, npol=npol, nl=nl, polsvcut=1e-4, device="cpu",
                                          mesh=tm)
    ut0, beam0, sig0, nm0 = TP.triple_svd(bfm, npol=npol, nl=nl, polsvcut=1e-4, device="cpu")
    assert sig1.shape == sig0.shape == (n, min(ntel, npol * nl))
    assert _rel(sig1, sig0) <= 1e-10 and torch.equal(nm1, nm0)
    assert _rel(ut1.abs(), ut0.abs()) <= 1e-10
    jut, jbeam, jsig, jnm = JP.triple_svd(bfm, npol=npol, nl=nl, polsvcut=1e-4, mesh=jm)
    assert _rel(sig1, jsig) <= 1e-10
    np.testing.assert_array_equal(nm1.numpy(), np.asarray(jnm))


def test_doublekl_factored_batched_sharded(mesh8):
    """Against JAX: both stages' spectra 1e-7 of their top and equal kept
    counts, as tests/test_torch_projections.py::test_doublekl_factored_batched."""
    jm, tm = mesh8
    bsvd, ls, lf = _inputs(4, 6, fg=1e-2)
    kw = dict(nc1=1e-3, fg_threshold=5.0)
    f_ev, ev, vec, nk = TP.doublekl_factored_batched(bsvd, ls, lf, device="cpu", mesh=tm, **kw)
    f0, e0, v0, k0 = TP.doublekl_factored_batched(bsvd, ls, lf, device="cpu", **kw)
    assert _rel(f_ev, f0) <= 1e-10 and _rel(ev, e0) <= 1e-10 and torch.equal(nk, k0)
    assert vec.shape == v0.shape == (6, 6, 6)
    jf, je, jv, jn = JP.doublekl_factored_batched(bsvd, ls, lf, mesh=jm, **kw)
    assert nk.tolist() == np.asarray(jn).tolist() and 0 < int(nk.min())
    assert _rel(f_ev, jf) <= 1e-7 and _rel(ev, je) <= 1e-7


def test_kl_factored_topband_sharded(mesh8):
    """The certificates come back per m, equal to the unsharded ones, and
    the retained spectra within 1e-10 of them (as JAX
    tests/test_mesh_pipeline.py::test_kl_factored_topband_sharded_over_mesh)."""
    _, tm = mesh8
    bsvd, ls, lf = _inputs(3, 8)
    bsvd = bsvd * 10.0
    for fn, kw in ((TP.kl_factored_batched_topband, {}),
                   (TP.doublekl_factored_batched_topband, dict(fg_threshold=1e-12))):
        out = fn(bsvd, ls, lf, cut=1e-9, device="cpu", mesh=tm, **kw)
        ref = fn(bsvd, ls, lf, cut=1e-9, device="cpu", **kw)
        assert out[-1].shape == (8,) and torch.equal(out[-1], ref[-1])
        assert _rel(out[0], ref[0]) <= 1e-10


def test_product_step_sharded_matches_jax(mesh8):
    """The sharded product step and fused Fisher (the JAX dry run's inputs,
    __graft_entry__._example_args, in float64) against JAX
    ``jit_product_step(mesh=)`` on 8 devices: spectra 1e-8 of the top and
    equal mode counts, the tolerance of
    tests/test_torch_bucket.py's product-step parity; against the port's
    unsharded step 1e-10."""
    jm, tm = mesh8
    npol, nl, nm = 1, 8, 8
    beam, noisew, ls, lf, mv = tmesh._example_args(nm=nm, npol=npol, nl=nl)
    beam, noisew = beam.astype(np.complex128), noisew.astype(np.float64)
    ls, lf = ls.astype(np.float64), lf.astype(np.float64)
    args = [torch.as_tensor(a) for a in (beam, noisew, ls, lf)]
    mvt = torch.as_tensor(mv, dtype=torch.int64)
    res = mstep.kl_product_step(args[0], *args[1:], mvt, npol=npol, nl=nl, mesh=tm)
    ref = mstep.kl_product_step(args[0], *args[1:], mvt, npol=npol, nl=nl)
    assert res.evals.shape == (nm, 16) and torch.equal(res.nmodes, ref.nmodes)
    assert _rel(res.evals, ref.evals) <= 1e-10
    assert bool(res.ok.all())

    step = jms.jit_product_step(npol=npol, nl=nl, mesh=jm)
    jr = step(beam, noisew, ls, lf, mv)
    assert len(jr.evals.sharding.device_set) == 8
    np.testing.assert_allclose(res.evals.numpy(), np.asarray(jr.evals), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(jr.evals)).max())
    np.testing.assert_array_equal(res.nmodes.numpy(), np.asarray(jr.nmodes))

    rng = np.random.default_rng(7)
    clb = [np.einsum("lfk,lgk->lfg", *(rng.standard_normal((nl, 2, 2)),) * 2) for _ in range(2)]
    band = torch.as_tensor(mstep.band_factor_table(clb, out_dtype=np.float64, l_chunk=4))
    kw = dict(ps_threshold=0.1, npol=npol, nl=nl, kf=16)
    f1 = mstep.fisher_step(res.evals, res.evecs, res.beam_svd, band, mesh=tm, **kw)
    f0 = mstep.fisher_step(res.evals, res.evecs, res.beam_svd, band, **kw)
    assert f1.shape == (nm, 2, 2) and _rel(f1, f0) <= 1e-10
    with pytest.raises(ValueError):
        mstep.kl_product_step(args[0][:5], *args[1:], mvt[:5], npol=npol, nl=nl, mesh=tm)


CFG = dict(num_freq=2, freq_start=400.0, freq_end=410.0, freq_mode="edge", num_cylinders=2,
           cylinder_width=3.0, num_feeds=2, feed_spacing=1.0, tsys=50.0)
PS_THRESHOLD = 1e-7  # the cylinder's spectrum tops at ~3e-6


@pytest.fixture(scope="module")
def cyl():
    torch.set_num_threads(1)
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG, device="cpu")
    bl, fi = np.arange(tt.npairs), np.arange(tt.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    cl_s, cl_n, noisew = chip_smoke.covariances(tt)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
    blt = mstep.band_factor_table(iter(chip_smoke.fisher_bands(tt)), out_dtype=np.float64,
                                  rank_rtol=1e-9)
    pos, neg = resident.btm_resident(tt, blg, fig)
    return dict(tel=tt, tabs=(pos, neg), fac=(ls, lf, noisew.astype(np.float64)), blt=blt)


def _product(cyl, **kw):
    return resident.product_all_resident(
        cyl["tel"], *cyl["tabs"], *cyl["fac"], band_lt=cyl["blt"], ps_threshold=PS_THRESHOLD,
        **kw)


@pytest.mark.parametrize("n", [2, 4])
def test_product_all_resident_bitwise_at_pinned_depth(cyl, n):
    """Each shard of a dispatch of n x 2 m is the batch of one unsharded
    dispatch of 2: spectra and counts bit for bit, the Fisher (the same
    per-shard terms, summed in another order) within 1e-12 of max."""
    pin = dict(sig_levels=2, bucket=False)
    chunks = []
    ev, nmo, f = _product(cyl, mbatch=2 * n, mesh=tmesh.make_mesh(["cpu"] * n), chunks=chunks,
                          **pin)
    ev0, nmo0, f0 = _product(cyl, mbatch=2, **pin)
    assert ev.shape == ev0.shape == (cyl["tel"].mmax + 1, 16)
    assert np.array_equal(ev, ev0) and np.array_equal(nmo, nmo0)
    assert (ev > PS_THRESHOLD).sum() > 0 and np.abs(f0).max() > 0
    assert np.abs(f - f0).max() <= 1e-12 * np.abs(f0).max()
    assert all(len(c.m_values) == 2 * n and not c.compacted for c in chunks)


def test_product_all_resident_adaptive_and_jax(cyl):
    """The default (adaptive) depth on 2 entries, decided over the whole
    dispatch: equal to an unsharded run of the same batch (1e-10), and
    against JAX ``product_all_resident(mesh=)`` on 2 virtual devices, on
    the same tables and factors, at the tolerances of
    tests/test_torch_slice.py (spectra rtol 1e-6 with an atol of 1e-4 of
    the top; mode counts equal; Fisher 1e-4 of max)."""
    two = tmesh.make_mesh(["cpu"] * 2)
    chunks = []
    ev, nmo, f = _product(cyl, mesh=two, mbatch=3, chunks=chunks)
    assert all(len(c.m_values) == 4 for c in chunks)  # rounded up to the mesh
    ev0, nmo0, f0 = _product(cyl, mbatch=4, bucket=False)
    assert _rel(ev, ev0) <= 1e-10 and np.array_equal(nmo, nmo0) and _rel(f, f0) <= 1e-10

    devices = jax.devices()
    if len(devices) < 2:
        pytest.skip("needs 2 virtual devices")
    pos, neg = (za.Z(jax.numpy.asarray(t.real.numpy()), jax.numpy.asarray(t.imag.numpy()))
                for t in cyl["tabs"])
    jev, jnmo, jf = jres.product_all_resident(
        jcyl.UnpolarisedCylinderTelescope.from_config(CFG), pos, neg, *cyl["fac"],
        band_lt=cyl["blt"], ps_threshold=PS_THRESHOLD, mesh=jmesh.make_mesh(devices[:2]),
    )
    np.testing.assert_allclose(ev, jev, rtol=1e-6, atol=1e-4 * np.abs(jev).max())
    np.testing.assert_array_equal(nmo, jnmo)
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-4 * np.abs(jf).max())


def test_product_all_resident_mesh_buckets_never(cyl):
    two = tmesh.make_mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="bucket=True is unsupported"):
        _product(cyl, mesh=two, bucket=True, max_m=4)
    with pytest.raises(TypeError, match="Mesh"):
        _product(cyl, mesh=jmesh.make_mesh(jax.devices()[:2]), max_m=4)
    # a one-entry mesh is the unsharded path, auto bucketing included
    a = _product(cyl, mesh=tmesh.make_mesh(["cpu"]), max_m=6)
    b = _product(cyl, max_m=6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_kltransform_generate_uses_mesh(tmp_path, monkeypatch):
    """End to end: ``KLTransform.generate`` under ``use_mesh`` hands the
    active mesh to ``kl_factored_batched`` (as JAX
    test_kltransform_generate_uses_mesh), the triple SVD of the beam stage
    too, and the run's spectra equal a run without a mesh (1e-10)."""
    from driftscan_tpu_torch.core import manager

    seen = {}
    for name in ("kl_factored_batched", "triple_svd"):
        orig = getattr(TP, name)

        def spy(*args, _orig=orig, _name=name, **kwargs):
            seen.setdefault(_name, []).append(kwargs.get("mesh"))
            return _orig(*args, **kwargs)

        monkeypatch.setattr(TP, name, spy)

    def run(sub):
        conf = {
            "config": {"beamtransfers": True, "kltransform": True, "psfisher": False,
                       "output_directory": str(tmp_path / sub)},
            "telescope": dict(type="UnpolarisedCylinder", num_freq=2, freq_start=100.0,
                              freq_end=110.0, freq_mode="edge", num_cylinders=2,
                              cylinder_width=2.0, num_feeds=2, feed_spacing=1.5),
            "kltransform": [{"type": "KLTransform", "name": "kl"}],
        }
        m = manager.ProductManager(device="cpu").apply_config(conf)
        m.generate()
        kl = m.kltransforms["kl"]
        return [kl.modes_m(mi)[0] for mi in range(m.telescope.mmax + 1)]

    two = tmesh.make_mesh(["cpu"] * 2)
    with tmesh.use_mesh(two):
        sharded = run("mesh")
    assert seen["kl_factored_batched"] and all(m is two for m in seen["kl_factored_batched"])
    assert seen["triple_svd"] and all(m is two for m in seen["triple_svd"])
    seen.clear()
    plain = run("plain")
    assert all(m.size == 1 for m in seen["kl_factored_batched"])
    for a, b in zip(sharded, plain):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * max(np.abs(b).max(), 1e-300))
