"""The ``gram`` KL engine of the port (``kl_solve(method="gram")``) against
the JAX package, on the CPU in float64.

Inputs come from a numpy seed: pencils with seeded spectra (n 48) whose
singular values lie away from the band edges, so that both packages put
every direction in the same deflation level (the JAX package's eigh adds a
1e-12 Hermitian jitter, the port's does not), and a small cylinder's beams
(bench's covariances) through ``kl_product_step(method="gram")``.  The
tolerance is the KL tier, 1e-4 of each m's top eigenvalue; both packages
run the same algorithm, so they agree far inside it, and each case prints
the difference it reached.  Where the engine is accurate (a moderately
conditioned foreground) it also holds against the dense referee
``kl_solve_dense_ref``: additive with thermal noise, clamped without.
"""

import numpy as np
import pytest
import torch

import bench
from driftscan_tpu.ops import fpencil as jfp
from driftscan_tpu.ops import zarray as za
from driftscan_tpu.parallel import mstep as jms
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.ops import fpencil
from driftscan_tpu_torch.parallel import mstep, resident
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


def _pencil(seed, n=48, k=96, fg_top=3e3, fg_decades=5.0, sig_top=3.0):
    """(a_s, a_f): a foreground of ``fg_decades`` decades of singular value
    under ``fg_top`` and a signal of three decades under ``sig_top``."""
    rng = np.random.default_rng(seed)
    sf = fg_top * np.logspace(0, -fg_decades, n)
    a_f = (_rand_u(rng, n, n) * sf) @ _rand_u(rng, k, n).conj().T
    ss = sig_top * np.logspace(0, -3, n)
    a_s = (_rand_u(rng, n, n) * ss) @ _rand_u(rng, k, n).conj().T
    return a_s, a_f


def _z(a):
    return za.Z(np.ascontiguousarray(a.real), np.ascontiguousarray(a.imag))


def _gap(got, want):
    """max |got - want| over the top of want, per row."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    return float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())


@pytest.mark.parametrize("with_thermal", [True, False])
@pytest.mark.parametrize("kw", [
    {},
    dict(fg_reg_rel=1e-3),
    dict(solve_dtype=np.float32),
    dict(fg_levels=3, sig_levels=2, band_rel=1e-3),
])
def test_gram_engine_matches_jax(with_thermal, kw):
    a_s, a_f = _pencil(1)
    want = jfp.kl_solve(_z(a_s), _z(a_f), method="gram", with_thermal=with_thermal, **kw)
    tkw = dict(kw, solve_dtype=torch.float32) if "solve_dtype" in kw else kw
    got = fpencil.kl_solve(torch.as_tensor(a_s), torch.as_tensor(a_f), method="gram",
                           with_thermal=with_thermal, **tkw)
    assert got.evals.dtype == torch.float64 and got.evecs.dtype == torch.complex128
    wev = np.asarray(want.evals)
    gap = _gap(got.evals.numpy(), wev)
    print(f"gram thermal={with_thermal} {kw}: {gap:.2e} of the top")
    assert gap < TIER
    if "solve_dtype" not in kw:
        assert gap < 1e-8
        # the retained modes' projectors: v v^H over the top 8
        vj = za.to_numpy(want.evecs)[:, -8:]
        vt = got.evecs.numpy()[:, -8:]
        pj, pt = vj @ vj.conj().T, vt @ vt.conj().T
        assert np.abs(pt - pj).max() <= 1e-7 * np.abs(pj).max()


@pytest.mark.parametrize("with_thermal,fg_reg", [(True, "additive"), (False, "clamp")])
def test_gram_engine_matches_dense_referee(with_thermal, fg_reg):
    """The gram engine's top eigenvalues sit on the JAX package's dense
    referee where the foreground is moderate:
    the thermal pencil S v = w (I + F) v, and the foreground-only pencil
    whose F is clamped at fg_floor of its top (whiten_apply_floor)."""
    a_s, a_f = _pencil(2, fg_top=3e2, fg_decades=4.0)
    ref = jfp.kl_solve_dense_ref(a_s, a_f, with_thermal=with_thermal, fg_reg=fg_reg)[0]
    got = fpencil.kl_solve(torch.as_tensor(a_s), torch.as_tensor(a_f), method="gram",
                           with_thermal=with_thermal).evals.numpy()
    top = 16
    rel = float(np.abs(got[-top:] / ref[-top:] - 1).max())
    print(f"gram vs dense referee ({fg_reg}): top {top} rel {rel:.2e}")
    assert rel < 1e-6


def test_gram_engine_knobs_and_errors():
    a_s, a_f = (torch.as_tensor(a) for a in _pencil(3, n=16, k=24))
    # the method-dependent depth defaults (JAX fpencil.py:1639-1642)
    a = fpencil.kl_solve(a_s, a_f, method="gram")
    b = fpencil.kl_solve(a_s, a_f, method="gram", sig_levels=5, band_rel=1e-1)
    torch.testing.assert_close(a.evals, b.evals, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Unknown kl_solve method"):
        fpencil.kl_solve(a_s, a_f, method="eig")
    for fn, z in ((fpencil.kl_solve, lambda x: x), (jfp.kl_solve, lambda x: _z(x.numpy()))):
        with pytest.raises(ValueError, match="gram-engine knob"):
            fn(z(a_s), z(a_f), fg_k_cap=4, method="qr")
        with pytest.raises(ValueError, match="with_thermal=True"):
            fn(z(a_s), z(a_f), fg_k_cap=4, method="gram", with_thermal=False)


# a small cylinder (tests/test_torch_bucket.py's): 4 channels, 2 x 3 feeds
CFG = dict(
    num_freq=4, freq_start=100.0, freq_end=200.0, freq_mode="edge",
    num_cylinders=2, cylinder_width=2.0, num_feeds=3, feed_spacing=1.5,
)


@pytest.fixture(scope="module")
def beams():
    """A batch of the cylinder's beams (m 1, 4, 9 and a padding slot), the
    noise weights and bench's factor tables (ls wide enough that the qr
    engine compacts the signal factor)."""
    jt = jcyl.UnpolarisedCylinderTelescope.from_config(CFG)
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG, device="cpu")
    cl_s, cl_n, noisew, _ = bench._covariances(jt)
    ls, lf = jms.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
    bl = np.arange(tt.npairs)
    fi = np.arange(tt.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    pos, neg = resident.btm_resident(tt, blg, fig)
    mv = np.array([1, 4, 9, -1])
    beam = resident._build_beam_batch(pos, neg, torch.as_tensor(mv), tt.npairs, tt.nfreq,
                                      1, tt.lmax + 1)
    return dict(beam=beam, noisew=noisew.astype(np.float64), ls=ls, lf=lf, mv=mv,
                nl=tt.lmax + 1)


@pytest.mark.parametrize("with_thermal", [True, False])
def test_kl_product_step_gram_matches_jax(beams, with_thermal):
    """``kl_product_step(method="gram")`` against JAX ``kl_product_step_split``
    at the entry point's defaults (fg_levels 8, sig_levels 2, band_rel
    3e-2): the SVD counts equal, padding zero, and each m's KL spectrum
    within the tier of its top of the dense referee on the step's own
    factors (clamped without thermal noise), and with thermal noise of the
    JAX package's.  Without thermal noise the cylinder's foreground factor
    is rank deficient and the JAX package's floor whitening takes arbitrary
    null-space columns (``fpencil.whiten_apply_floor``): its distance from
    the referee is printed, and the two packages' floor forms are held
    against each other on full-rank pencils (test_gram_engine_matches_jax)."""
    b = beams
    beam = b["beam"].numpy()
    kw = dict(npol=1, nl=b["nl"], method="gram", with_thermal=with_thermal)
    jr = jms.kl_product_step_split(
        np.ascontiguousarray(beam.real), np.ascontiguousarray(beam.imag), b["noisew"],
        b["ls"], b["lf"], b["mv"].astype(np.int32), **kw,
    )
    args = (b["beam"], torch.as_tensor(b["noisew"]), torch.as_tensor(b["ls"]),
            torch.as_tensor(b["lf"]), torch.as_tensor(b["mv"]))
    res = mstep.kl_product_step(*args, **kw)
    np.testing.assert_array_equal(res.nmodes.numpy(), np.asarray(jr.nmodes))
    assert float(res.evals[3].abs().max()) == 0.0 and bool(res.ok.all())
    comp = mstep.compress_step(*args, 1, b["nl"], method="gram")
    fg_reg = "additive" if with_thermal else "clamp"
    ev, wev = res.evals.numpy(), np.asarray(jr.evals)
    for i, m in enumerate(b["mv"][:3]):
        ref = jfp.kl_solve_dense_ref(comp.a_s[i].numpy(), comp.a_f[i].numpy(),
                                     with_thermal=with_thermal, fg_reg=fg_reg)[0]
        g_ref, j_ref, g_jax = _gap(ev[i], ref), _gap(wev[i], ref), _gap(ev[i], wev[i])
        print(f"kl_product_step gram thermal={with_thermal} m={m}: port {g_ref:.2e}, "
              f"JAX {j_ref:.2e} of the referee's top; port-JAX {g_jax:.2e}")
        assert g_ref < TIER
        if with_thermal:
            assert g_jax < TIER


def test_gram_never_compacts_the_signal_factor(beams, monkeypatch):
    """Under ``gram`` the signal factor keeps its width nl * K and K9 does
    not run (JAX mstep.py:194); under ``qr`` the same tables compact."""
    b = beams
    # the same signal covariance as a factor three times as wide
    ls3 = np.concatenate([b["ls"]] * 3, axis=-1) / np.sqrt(3.0)
    args = (b["beam"], torch.as_tensor(b["noisew"]), torch.as_tensor(ls3),
            torch.as_tensor(b["lf"]), torch.as_tensor(b["mv"]), 1, b["nl"])
    calls = []
    real = fpencil.beam_factor_compact
    monkeypatch.setattr(fpencil, "beam_factor_compact",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    qr = mstep.compress_step(*args)
    n = qr.a_s.shape[-2]
    assert qr.a_s.shape[-1] == n and calls == [1]
    gram = mstep.compress_step(*args, method="gram")
    assert gram.a_s.shape[-1] == b["nl"] * ls3.shape[-1] > 2 * n
    assert calls == [1]
    with pytest.raises(ValueError, match="kl_top_k requires"):
        mstep.kl_solve_step(gram, method="gram", kl_cut=0.1, kl_top_k=4)
