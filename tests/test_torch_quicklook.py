"""The rank-capped quick-look of the port (``gram_bands_topk``,
``sig_k_cap`` / ``fg_k_cap``, ``product_all_resident(sig_k_cap=)``)
against the JAX package, on the CPU in float64.

The quick-look is approximate by design (shifted CholeskyQR rounds, eight
subspace steps), so the port is held against the JAX package on the same
iterate, never against the exact engine: ``_top_band_eigh`` runs on the
real 2n x 2k embedding from the JAX package's real start block.  Ritz
values and level spectra agree to rounding (1e-10 of the top), projectors
of the top directions to 1e-8 (1e-6 over a whole level, whose last pairs
have not converged); the KL spectra through ``kl_solve``
and the resident dispatcher within the KL tier, 1e-4 of each m's top, and
the Fisher within 1e-4 of its max.  Each case prints what it reached.
"""

import numpy as np
import pytest
import torch

import bench
from driftscan_tpu.ops import fpencil as jfp
from driftscan_tpu.ops import zarray as za
from driftscan_tpu.parallel import mstep as jms
from driftscan_tpu.parallel import resident as jres
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.ops import fpencil
from driftscan_tpu_torch.parallel import resident
from driftscan_tpu_torch.telescope import cylinder

TIER = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rand_u(rng, p, q):
    a = rng.standard_normal((p, q)) + 1j * rng.standard_normal((p, q))
    return np.linalg.qr(a)[0]


def _z(a):
    return za.Z(np.ascontiguousarray(a.real), np.ascontiguousarray(a.imag))


def _proj(v):
    return v @ v.conj().T


@pytest.mark.parametrize("k", [8, 20, 48, 60])
def test_top_band_eigh_matches_jax(k):
    """Ritz values and the projectors of the top pairs; k = n and past it
    (the port returns n pairs, the JAX program n plus repeats of the
    last)."""
    rng = np.random.default_rng(5)
    n = 48
    u = _rand_u(rng, n, n)
    g = (u * np.logspace(0, -8, n)) @ u.conj().T
    g = 0.5 * (g + g.conj().T)
    jw, jv = jfp._top_band_eigh(_z(g), k)
    jw, jv = np.asarray(jw), za.to_numpy(jv)
    w, v = fpencil._top_band_eigh(torch.as_tensor(g)[None], k)
    w, v = w[0].numpy(), v[0].numpy()
    kk = min(k, n)
    assert w.shape == (kk,) and v.shape == (n, kk)
    gap_w = float(np.abs(w - jw[:kk]).max())
    gap_p = max(float(np.abs(_proj(v[:, :t]) - _proj(jv[:, :t])).max()) for t in (2, 4))
    print(f"_top_band_eigh k={k}: values {gap_w:.2e}, top-4 projectors {gap_p:.2e}")
    assert gap_w < 1e-10 and gap_p < 1e-8


@pytest.mark.parametrize("levels,band_rel,k_cap", [(3, 0.1, 6), (2, 3e-2, 20), (2, 0.1, 60)])
def test_gram_bands_topk_matches_jax(levels, band_rel, k_cap):
    """Level spectra and the completed basis of ``_select_complete_basis``,
    including levels * k_cap < n (zero columns pad the basis to n)."""
    rng = np.random.default_rng(6)
    n = 48
    x = (_rand_u(rng, n, n) * np.logspace(0, -5, n)) @ _rand_u(rng, 80, n).conj().T
    jb = jfp.gram_bands_topk(_z(x), levels, band_rel, k_cap)
    pb = fpencil.gram_bands_topk(torch.as_tensor(x)[None], levels, band_rel, k_cap)
    kk = min(k_cap, n)
    js = np.asarray(jb.s)[:, :kk]
    gap = float(np.abs(pb.s[:, 0].numpy() - js).max() / js.max())
    jq, jss = jfp._select_complete_basis(jb)
    q, ss = fpencil._select_complete_basis(pb)
    q, ss = q[0].numpy(), ss[0].numpy()
    assert q.shape == (n, n)
    gap_sel = float(np.abs(ss - np.asarray(jss)).max() / js.max())
    live = int((ss > 0).sum())
    jqn = za.to_numpy(jq)
    gap_p = float(np.abs(_proj(q[:, :live]) - _proj(jqn[:, :live])).max())
    print(f"gram_bands_topk {levels}x{k_cap}: levels {gap:.2e}, selected {gap_sel:.2e} of "
          f"the top, projector of {live} columns {gap_p:.2e}")
    assert gap < 1e-10 and gap_sel < 1e-10 and gap_p < 1e-6
    if levels * k_cap < n:
        assert live <= levels * k_cap
        assert np.all(q[:, levels * k_cap:] == 0) and np.all(ss[levels * k_cap:] == 0)


def _pencil(seed, n=48, k=96):
    rng = np.random.default_rng(seed)
    a_f = (_rand_u(rng, n, n) * 3e3 * np.logspace(0, -5, n)) @ _rand_u(rng, k, n).conj().T
    a_s = (_rand_u(rng, n, n) * 3.0 * np.logspace(0, -3, n)) @ _rand_u(rng, k, n).conj().T
    return a_s, a_f


@pytest.mark.parametrize("kw", [
    dict(method="qr", sig_k_cap=8),
    dict(method="qr", sig_k_cap=8, with_thermal=False),
    dict(method="gram", fg_k_cap=16),
    dict(method="gram", sig_k_cap=8),
    dict(method="gram", fg_k_cap=16, sig_k_cap=8),
    dict(method="gram", sig_k_cap=4, with_thermal=False),
])
def test_caps_through_kl_solve_match_jax(kw):
    a_s, a_f = _pencil(7)
    want = np.asarray(jfp.kl_solve(_z(a_s), _z(a_f), **kw).evals)
    got = fpencil.kl_solve(torch.as_tensor(a_s), torch.as_tensor(a_f), **kw).evals.numpy()
    gap = float(np.abs(got - want).max() / want.max())
    print(f"kl_solve {kw}: {gap:.2e} of the top")
    assert gap < TIER


def test_cap_errors():
    """fg_k_cap is the gram engine's, and needs thermal noise (JAX
    fpencil.py:1645-1649, :1686-1690); the top-band engine takes neither."""
    a_s, a_f = (torch.as_tensor(a) for a in _pencil(8, n=12, k=16))
    for fn, z in ((fpencil.kl_solve, lambda t: t), (jfp.kl_solve, lambda t: _z(t.numpy()))):
        with pytest.raises(ValueError, match="gram-engine knob"):
            fn(z(a_s), z(a_f), fg_k_cap=4, method="qr")
        with pytest.raises(ValueError, match="complete basis"):
            fn(z(a_s), z(a_f), fg_k_cap=4, method="gram", with_thermal=False)


# a small cylinder (tests/test_torch_bucket.py's): a wide band, so that the
# high m thin out and the bucketing compacts
CFG = dict(
    num_freq=4, freq_start=100.0, freq_end=200.0, freq_mode="edge",
    num_cylinders=2, cylinder_width=2.0, num_feeds=3, feed_spacing=1.5,
)


@pytest.fixture(scope="module")
def tables():
    jt = jcyl.UnpolarisedCylinderTelescope.from_config(CFG)
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG, device="cpu")
    cl_s, cl_n, noisew, _ = bench._covariances(jt)
    ls, lf = jms.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
    blt = jms.band_factor_table(iter(bench._fisher_bands(jt)), out_dtype=np.float64,
                                rank_rtol=1e-9)
    bl = np.arange(tt.npairs)
    fi = np.arange(tt.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    return dict(jt=jt, tt=tt, jtab=jres.btm_resident(jt, blg, fig),
                tab=resident.btm_resident(tt, blg, fig), ls=ls, lf=lf,
                noisew=noisew.astype(np.float64), blt=blt)


@pytest.mark.parametrize("bucket", [False, True])
def test_product_all_resident_sig_k_cap_matches_jax(tables, bucket, monkeypatch):
    """bench's ``BENCH_SIG_K_CAP`` leg at this size: the adaptive depth,
    the signal levels capped at 8 directions, the fused Fisher; bucketed
    with ``_quant_frac`` exact and ``_BUCKET_MIN_SAVING`` 1 in both
    packages (as JAX tests/test_resident.py does), so that compacted
    chunks run here.

    The cap keeps the block's last Ritz value converged: at 4 directions
    m 8's fourth value is 0.6% off the exact engine's, and an unconverged
    Ritz value carries the whitened factor's rounding, which already
    differs between the packages by ~1e-5 of the top in the exact engine
    (tests/test_torch_bucket.py): 3.3e-3 of the top there, 2.7e-5 at 8."""
    t = tables
    if bucket:
        for mod in (jres, resident):
            monkeypatch.setattr(mod, "_quant_frac", lambda x, full: min(max(int(x), 1), full))
            monkeypatch.setattr(mod, "_BUCKET_MIN_SAVING", 1)
    args = (t["ls"], t["lf"], t["noisew"])
    kw = dict(sig_k_cap=8, bucket=bucket, band_lt=t["blt"], ps_threshold=1e-14)
    chunks = []
    ev, nm, fish = resident.product_all_resident(t["tt"], *t["tab"], *args, chunks=chunks, **kw)
    jev, jnm, jfish = jres.product_all_resident(t["jt"], *t["jtab"], *args, **kw)
    if bucket:
        assert any(c.compacted for c in chunks)
    np.testing.assert_array_equal(nm, jnm)
    top = np.maximum(jev.max(axis=1), 1e-300)
    gap = float((np.abs(ev - jev).max(axis=1) / top).max())
    gap_f = float(np.abs(fish - jfish).max() / np.abs(jfish).max())
    exact = resident.product_all_resident(t["tt"], *t["tab"], *args, bucket=bucket)[0]
    bias = float(np.abs(ev[:, -1] / exact[:, -1] - 1).max())
    print(f"product_all_resident(sig_k_cap=8, bucket={bucket}): spectra {gap:.2e} of each "
          f"m's top, Fisher {gap_f:.2e} of max; top value {bias:.2e} off the exact engine")
    assert gap < TIER and gap_f < TIER
    assert np.isfinite(ev).all() and ev.shape == exact.shape and bias < 1e-3
