"""m-bucketing of the port's resident path against the JAX package.

The sizing pass (``resident.mode_counts`` / ``svdcount_batch``), the
compacted dispatch of ``product_all_resident(bucket=True)`` and the Fisher
step on compacted frequencies, on small cylinders in float64 on the CPU:

* the sizing pass's counts equal the product step's SVD mode counts, and
  the JAX package's ``_svdcount_batch`` counts;
* bucketed against unbucketed, with ``_quant_frac`` (exact) and
  ``_BUCKET_MIN_SAVING`` (1) forced in both packages as JAX
  ``tests/test_resident.py`` does, so that compacted chunks really run at
  this size: mode counts equal, retained spectra rtol 2e-4 and the whole
  spectrum within 1e-5 of the top, Fisher 1e-4 of its max; the same against
  the JAX package's bucketed run, alone and with an m-window (at the
  packages' own chunk cap; a second case caps chunks at 4 m in the port,
  so that the frequency axis compacts, against the unbucketed run);
* the Fisher step on a compacted chunk (``f_idx``, a zeroed padding slot)
  against the same with the band table gathered on the host (rel 1e-12),
  and against the JAX package's ``fisher_step_split`` (1e-8 of its max),
  after JAX ``tests/test_fisher_resident.py``'s case.
"""

import numpy as np
import pytest
import torch

import bench
from driftscan_tpu.ops import zarray as za
from driftscan_tpu.parallel import mstep as jms
from driftscan_tpu.parallel import resident as jres
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.parallel import mstep, resident
from driftscan_tpu_torch.telescope import cylinder

# test_resident.py's bucketing telescope: a wide fractional band, so the
# per-frequency band limit thins with m (4 channels at 100-200 MHz, 2 x 3
# feeds); its spectrum tops at ~1e-12, the Fisher keeps the top two decades
CFG = dict(
    num_freq=4, freq_start=100.0, freq_end=200.0, freq_mode="edge",
    num_cylinders=2, cylinder_width=2.0, num_feeds=3, feed_spacing=1.5,
)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(params=[16, 4])
def forced(request, monkeypatch):
    """Quantise exactly and take any saving, in both packages; the second
    case caps a compacted chunk of the port at 4 m (the first chunks hold
    m where every channel is active), so that the frequency axis compacts
    too.  Returns the m-batch to pass (None: the default)."""
    for mod in (jres, resident):
        monkeypatch.setattr(mod, "_quant_frac", lambda x, full: min(max(int(x), 1), full))
        monkeypatch.setattr(mod, "_BUCKET_MIN_SAVING", 1)
    if request.param == 16:
        return None
    monkeypatch.setattr(resident, "_BUCKET_MBATCH_CAP", request.param)
    return request.param


def _units(tel):
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    return [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]


@pytest.fixture(scope="module")
def run():
    jt = jcyl.UnpolarisedCylinderTelescope.from_config(CFG)
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG, device="cpu")
    cl_s, cl_n, noisew, _ = bench._covariances(jt)
    ls, lf = jms.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
    blt = jms.band_factor_table(
        iter(bench._fisher_bands(jt)), out_dtype=np.float64, rank_rtol=1e-9
    )
    blg, fig = _units(tt)
    jtab = jres.btm_resident(jt, blg, fig)
    tab = resident.btm_resident(tt, blg, fig)
    noisew = noisew.astype(np.float64)
    ev, nm, f = resident.product_all_resident(
        tt, *tab, ls, lf, noisew, bucket=False, sig_levels=2, band_lt=blt,
        ps_threshold=1e-14,
    )
    thr = 10.0 ** (np.floor(np.log10(ev.max())) - 1)
    full = resident.product_all_resident(
        tt, *tab, ls, lf, noisew, bucket=False, sig_levels=2, band_lt=blt, ps_threshold=thr,
    )
    return dict(jt=jt, tt=tt, jtab=jtab, tab=tab, ls=ls, lf=lf, noisew=noisew, blt=blt,
                thr=thr, full=full)


def _check(got, want, what, thr):
    """Mode counts equal, the retained band (> thr) within rtol 2e-4, the
    whole spectrum within 1e-5 of the top (the sub-cut eigenvalues of
    pencils of different dimension differ by their rounding, ~1.5e-6 of
    the top here), the Fisher within 1e-4 of its max."""
    ev, nm, f = got
    wev, wnm, wf = want
    np.testing.assert_array_equal(nm, wnm, err_msg=what)
    scale = wev.max()
    kept = wev > thr
    print(f"{what}: retained rel {(np.abs(ev - wev)[kept] / wev[kept]).max():.2e}, whole "
          f"{np.abs(ev - wev).max() / scale:.2e} of the top, Fisher "
          f"{np.abs(f - wf).max() / np.abs(wf).max():.2e} of max")
    assert kept.any()
    np.testing.assert_allclose(ev[kept], wev[kept], rtol=2e-4, err_msg=what)
    np.testing.assert_allclose(ev, wev, rtol=0, atol=1e-5 * scale, err_msg=what)
    assert np.abs(wf).max() > 0
    np.testing.assert_allclose(f, wf, rtol=0, atol=1e-4 * np.abs(wf).max(), err_msg=what)


def test_sizing_pass_counts(run):
    tt, jt = run["tt"], run["jt"]
    pos, neg = run["tab"]
    nm = tt.mmax + 1
    nw = torch.as_tensor(run["noisew"])
    counts = resident.mode_counts(tt, pos, neg, nw, np.arange(nm), 8)
    assert counts.shape == (nm, tt.nfreq)
    # the product step's own counts
    np.testing.assert_array_equal(counts, run["full"][1])
    # and the JAX package's sizing pass
    jp, jn = run["jtab"]
    nl = tt.lmax + 1
    rows = []
    for s in range(0, nm, 16):
        mv = np.full(16, -1, np.int32)
        ms = np.arange(s, min(s + 16, nm))
        mv[: len(ms)] = ms
        c = jres._svdcount_batch(
            jp.re, jp.im, jn.re, jn.im, run["noisew"], mv,
            npairs=tt.npairs, nfreq=tt.nfreq, nl=nl,
        )
        rows.append(np.asarray(c)[: len(ms)])
    np.testing.assert_array_equal(counts, np.concatenate(rows))
    # the band thins with m: the high m have inactive channels
    assert (counts[-1] == 0).any()


def test_bucketed_matches_unbucketed_and_jax(run, forced):
    tt, jt = run["tt"], run["jt"]
    kw = dict(sig_levels=2, band_lt=run["blt"], ps_threshold=run["thr"])
    args = (run["ls"], run["lf"], run["noisew"])
    kw["mbatch"] = forced
    chunks = []
    got = resident.product_all_resident(tt, *run["tab"], *args, bucket=True, chunks=chunks, **kw)
    S = resident.pencil_size(tt) // tt.nfreq
    assert any(c.compacted and c.sq < S for c in chunks)
    if forced:
        assert any(c.compacted and c.fq < tt.nfreq for c in chunks)
    _check(got, run["full"], "bucketed vs unbucketed", run["thr"])
    if forced is None:  # the JAX package's run at its own chunk cap
        want = jres.product_all_resident(jt, *run["jtab"], *args, bucket=True, **kw)
        _check(got, want, "bucketed vs the JAX package's", run["thr"])
    # auto picks bucketing where the JAX rule does (this wide band: yes)
    prof = resident._analytic_dof_bound(tt, tt.mmax + 1).astype(np.float64)
    assert float((prof**3).sum()) < 0.5 * (tt.mmax + 1) * float(tt.nfreq * S) ** 3
    auto = []
    resident.product_all_resident(tt, *run["tab"], *args, chunks=auto, **kw)
    assert [c.m_values.tolist() for c in auto] == [c.m_values.tolist() for c in chunks]


def test_bucketed_window_matches_jax(run, forced):
    tt, jt = run["tt"], run["jt"]
    blg, fig = _units(tt)
    nm = tt.mmax + 1
    m0, m1 = nm // 3, nm
    kw = dict(sig_levels=2, band_lt=run["blt"], ps_threshold=run["thr"], bucket=True,
              m_range=(m0, m1), mbatch=forced)
    args = (run["ls"], run["lf"], run["noisew"])
    chunks = []
    got = resident.product_all_resident(
        tt, *resident.btm_resident(tt, blg, fig, m_range=(m0, m1)), *args, chunks=chunks, **kw
    )
    assert any(c.compacted for c in chunks)
    assert chunks[0].m_values[0] == m0
    if forced is None:  # the JAX package's run at its own chunk cap
        jwin = jres.btm_resident(jt, blg, fig, m_range=(m0, m1))
        want = jres.product_all_resident(jt, *jwin, *args, **kw)
        _check(got, want, "bucketed window vs the JAX package's", run["thr"])
    # and the full run's rows of the window
    ev, nmo, _ = run["full"]
    np.testing.assert_array_equal(got[1], nmo[m0:m1])
    np.testing.assert_allclose(got[0], ev[m0:m1], rtol=0, atol=1e-5 * ev.max())


def test_fisher_step_compacted_frequencies():
    """JAX test_fisher_resident.py's case: 3 frequencies, active {0, 2},
    one zeroed padding slot (a duplicate of 2)."""
    rng = np.random.default_rng(3)
    M, Ff, T, npol, nl = 2, 3, 5, 1, 6
    beam_c = rng.standard_normal((M, 3, T, nl)) + 1j * rng.standard_normal((M, 3, T, nl))
    beam_c[:, 1] = 0.0
    noisew = np.ones((3, T))
    a = rng.standard_normal((nl, 3, 2))
    cl_s = np.einsum("lfk,lgk->lfg", a, a)[None, None] * 5.0
    cl_f = np.eye(3)[None, None, None] * np.ones((nl, 1, 1)) * 1e-3
    f_idx = np.array([0, 2, 2])
    ls, lf = mstep.prepare_cl_factors(
        cl_s[:, :, :, f_idx][:, :, :, :, f_idx], cl_f[:, :, :, f_idx][:, :, :, :, f_idx],
        out_dtype=np.float64,
    )
    mv = np.array([1, 2])
    res = mstep.kl_product_step(
        torch.as_tensor(beam_c), torch.as_tensor(noisew), torch.as_tensor(ls),
        torch.as_tensor(lf), torch.as_tensor(mv), npol=npol, nl=nl,
    )
    clb = [np.einsum("lfk,lgk->lfg", rng.standard_normal((nl, Ff, 2)),
                     rng.standard_normal((nl, Ff, 2))) for _ in range(2)]
    clb = [0.5 * (c + c.transpose(0, 2, 1)) + 3 * np.eye(Ff)[None] for c in clb]
    band_full = mstep.band_factor_table(clb, out_dtype=np.float64)
    thr = 0.05
    kf = resident.fisher_k(res.evals.numpy(), thr)
    assert kf >= 1
    step = dict(ps_threshold=thr, npol=npol, nl=nl, kf=kf)
    got = mstep.fisher_step(res.evals, res.evecs, res.beam_svd, torch.as_tensor(band_full),
                            f_idx=f_idx, **step).numpy()
    want = mstep.fisher_step(res.evals, res.evecs, res.beam_svd,
                             torch.as_tensor(band_full[:, :, f_idx]), **step).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14 * np.abs(want).max())

    jls, jlf = jms.prepare_cl_factors(
        cl_s[:, :, :, f_idx][:, :, :, :, f_idx], cl_f[:, :, :, f_idx][:, :, :, :, f_idx],
        out_dtype=np.float64,
    )
    jr = jms.kl_product_step_split(
        np.ascontiguousarray(beam_c.real), np.ascontiguousarray(beam_c.imag), noisew,
        jls, jlf, mv.astype(np.int32), npol=npol, nl=nl,
    )
    j = jms.fisher_step_split(
        jr.evals, jr.evecs_re, jr.evecs_im, jr.beam_re, jr.beam_im, band_full,
        ps_threshold=thr, fisher_k=3 * T, npol=npol, nl=nl, f_idx=f_idx.astype(np.int32),
    )
    jf = np.asarray(j[0]) + 1j * np.asarray(j[1])
    np.testing.assert_allclose(got, jf, rtol=0, atol=1e-8 * np.abs(jf).max())


def test_s_cap_keeps_the_spectrum():
    """The compacted mode axis: with s_cap at the batch's largest SVD mode
    count the KL spectrum is the full pencil's, zero-padded in front."""
    rng = np.random.default_rng(8)
    M, F, T, nl = 2, 2, 6, 7
    beam = rng.standard_normal((M, F, T, nl)) + 1j * rng.standard_normal((M, F, T, nl))
    a = rng.standard_normal((nl, F, 2))
    cl_s = np.einsum("lfk,lgk->lfg", a, a)[None, None]
    cl_f = np.eye(F)[None, None, None] * np.ones((nl, 1, 1)) * 1e-2
    ls, lf = (torch.as_tensor(x) for x in mstep.prepare_cl_factors(cl_s, cl_f, np.float64))
    args = (torch.as_tensor(beam), torch.ones((F, T), dtype=torch.float64), ls, lf,
            torch.as_tensor(np.array([3, 5])))
    full = mstep.kl_product_step(*args, npol=1, nl=nl, sig_levels=2)
    cap = int(full.nmodes.max())
    assert cap < min(T, nl)
    part = mstep.kl_product_step(*args, npol=1, nl=nl, sig_levels=2, s_cap=cap)
    assert part.evals.shape[-1] == F * cap
    ev = full.evals.numpy()
    pad = np.pad(part.evals.numpy(), ((0, 0), (ev.shape[1] - F * cap, 0)))
    np.testing.assert_allclose(pad, ev, rtol=1e-8, atol=1e-10 * ev.max())
    np.testing.assert_array_equal(part.nmodes.numpy(), full.nmodes.numpy())


def _returns_within(fn, seconds=20.0):
    """fn() run in a daemon thread: (finished, result)."""
    import threading

    out = []
    th = threading.Thread(target=lambda: out.append(fn()), daemon=True)
    th.start()
    th.join(seconds)
    return bool(out), (out[0] if out else None)


@pytest.mark.parametrize("full", [1, 2, 3, 16, 200])
def test_quant_frac_reaches_one(full):
    """A count of 1 (or 0) quantises to 1: the JAX package's loop never ends
    there, which an m-chunk with one active frequency or one mode a
    frequency meets (an ns2 window cut to the highest channels did)."""
    for x in (0, 1):
        done, q = _returns_within(lambda: resident._quant_frac(x, full))
        assert done and q == 1
    assert resident._quant_frac(full, full) == full
    if full > 2:
        assert resident._quant_frac(2, full) == 2


def test_plan_chunks_one_active_frequency():
    """A bucketed plan where one channel holds one mode a m: it ends, and
    compacts to that channel."""
    F, S, nm = 16, 200, 3
    counts = np.zeros((nm, F), np.int64)
    counts[:, 5] = 1
    done, chunks = _returns_within(
        lambda: resident.plan_chunks(counts, 270, F, S, 8, lambda n: 8))
    assert done
    assert [(c.fq, c.sq, list(c.f_idx)) for c in chunks] == [(1, 1, [5])]
    assert list(chunks[0].m_values[:nm]) == [270, 271, 272]
