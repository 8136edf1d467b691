"""``product_all_resident(topband=True)``: the port's resident path with
the top-band KL engine against the JAX package's, on the CPU in float64.

test_torch_slice.py's cylinder (4 channels, 2 x 3 feeds; pencil n 56)
through both packages from their own tables and factors, at the Fisher's
retention cut (kl_cut = ps_threshold = 1e-3, 281 modes), each package's
escalation state seeded with (k, levels) = START (``_TB_STATE``, as a
remembered state would be): one level of 7 columns holds less than some
m's band, so both packages fail a certificate once, redispatch at
(2k, levels + 1) = (14, 2), pass there and remember it:

* retained spectra within rel 1e-4 (the KL tier), sub-cut entries exact
  zeros, mode counts equal, the Fisher within 3e-2 of its max; the port's
  top-band run against its exact run (rel 1e-9, Fisher 1e-9);
* ``_TB_STATE`` equal after that one escalation, {56: (14, 2)};
* on the port alone, past the levels' reach (kl_cut 1e-11 on the first
  m-batch, 9.7 decades under the top eigenvalue 4.7e-2): the escalation
  fails at (14, 5) and (28, 6) and ends in the exact engine, whose whole
  spectrum it returns;
* on the port alone, m-bucketing and two m-windows against the unbucketed
  full-range top-band run: the same retained set, spectra within rel 1e-8,
  the Fisher within 1e-8 of its max.  The bucketing quantises exactly and
  takes any saving (``_quant_frac``, ``_BUCKET_MIN_SAVING`` 1), so that
  chunks compact to n 40 and 32 and every basis is 8 columns (n/7 at
  n 56): there the JAX program, which locks every Ritz pair above a
  level's lock bound, reports values up to 4.8e-2 off while every
  certificate passes; the port locks only pairs whose residual is within
  1e-5 of their value (``fpencil._RITZ_RES_REL``), and its values stay
  within 3e-10 of the exact engine's.
"""

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from driftscan_tpu.parallel import mstep as jms
from driftscan_tpu.parallel import resident as jres
from driftscan_tpu.telescope import cylinder as jcyl
from driftscan_tpu_torch.parallel import mstep, resident
from driftscan_tpu_torch.telescope import cylinder
from test_torch_slice import CFG, PS_THRESHOLD, _units

LOW_CUT = 1e-11  # 9.7 decades under the top eigenvalue (4.7e-2)
START = (7, 1)  # the seeded (k, levels): fails once, passes at (14, 2)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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
    jres._TB_STATE.clear()
    jres._TB_STATE[56] = START
    jev, jnm, jf = jres.product_all_resident(
        jt, jp, jn, ls, lf, noisew.astype(np.float64), band_lt=blt,
        ps_threshold=PS_THRESHOLD, topband=True, kl_cut=PS_THRESHOLD,
    )
    jstate = dict(jres._TB_STATE)
    jres._TB_STATE.clear()

    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG, device="cpu")
    t_cl_s, t_cl_n, t_noisew = chip_smoke.covariances(tt)
    t_ls, t_lf = mstep.prepare_cl_factors(t_cl_s, t_cl_n, out_dtype=np.float64)
    t_blt = mstep.band_factor_table(
        iter(chip_smoke.fisher_bands(tt)), out_dtype=np.float64, rank_rtol=1e-9
    )
    tp, tn = resident.btm_resident(tt, blg, fig)
    args = (tt, tp, tn, t_ls, t_lf, t_noisew.astype(np.float64))
    kw = dict(band_lt=t_blt, ps_threshold=PS_THRESHOLD)
    resident._TB_STATE.clear()
    resident._TB_STATE[56] = START
    before = dict(resident.TB_COUNTS)
    chunks = []
    tev, tnm, tf = resident.product_all_resident(*args, topband=True, kl_cut=PS_THRESHOLD,
                                                 chunks=chunks, **kw)
    counts = {k: resident.TB_COUNTS[k] - before[k] for k in before}
    counts["chunks"] = len(chunks)
    tstate = dict(resident._TB_STATE)
    xev, xnm, xf = resident.product_all_resident(*args, **kw)
    resident._TB_STATE.clear()
    before = dict(resident.TB_COUNTS)
    tlow, _ = resident.product_all_resident(*args, topband=True, kl_cut=LOW_CUT, max_m=8)
    low_counts = {k: resident.TB_COUNTS[k] - before[k] for k in before}
    xlow, _ = resident.product_all_resident(*args, max_m=8, sig_levels=2)
    resident._TB_STATE.clear()
    return dict(
        jax=dict(ev=jev, nm=jnm, f=jf, state=jstate),
        port=dict(ev=tev, nm=tnm, f=tf, state=tstate, counts=counts, low=tlow,
                  low_counts=low_counts),
        exact=dict(ev=xev, nm=xnm, f=xf, low=xlow),
        args=args, kw=kw,
    )


def test_topband_spectra_match_jax(runs):
    j, t = runs["jax"], runs["port"]
    assert t["ev"].shape == j["ev"].shape
    kept = j["ev"] > PS_THRESHOLD
    assert kept.sum() == 281 and np.array_equal(t["ev"] > PS_THRESHOLD, kept)
    rel = np.abs(t["ev"][kept] - j["ev"][kept]) / j["ev"][kept]
    assert rel.max() <= 1e-4, rel.max()
    # everything below the cut is an exact zero, in both
    assert np.all(t["ev"][~kept] == 0.0) and np.all(j["ev"][~kept] == 0.0)
    np.testing.assert_array_equal(t["nm"], j["nm"])


def test_topband_fisher_matches_jax(runs):
    j, t = runs["jax"], runs["port"]
    assert np.abs(j["f"]).max() > 0
    np.testing.assert_allclose(t["f"], j["f"], rtol=0, atol=3e-2 * np.abs(j["f"]).max())


def test_topband_equals_the_exact_engine(runs):
    t, x = runs["port"], runs["exact"]
    kept = x["ev"] > PS_THRESHOLD
    assert np.array_equal(t["ev"] > PS_THRESHOLD, kept)
    np.testing.assert_allclose(t["ev"][kept], x["ev"][kept], rtol=1e-9)
    np.testing.assert_allclose(t["f"], x["f"], rtol=0, atol=1e-9 * np.abs(x["f"]).max())


def test_escalation_state_matches_jax(runs):
    """From (7, 1) both packages fail a certificate once and pass at
    (14, 2), the state they remember; past the levels' reach the port's
    escalation ends in the exact engine, at its default depth."""
    j, t, x = runs["jax"], runs["port"], runs["exact"]
    assert j["state"] == t["state"] == {56: (14, 2)}
    c = t["counts"]
    assert (c["failed"], c["exact"]) == (1, 0) and c["solves"] == c["chunks"] + 1
    assert t["low_counts"] == {"solves": 2, "failed": 2, "exact": 1}
    assert (x["low"] > LOW_CUT).sum() > 300
    np.testing.assert_array_equal(t["low"], x["low"])


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setattr(resident, "_quant_frac", lambda x, full: min(max(int(x), 1), full))
    monkeypatch.setattr(resident, "_BUCKET_MIN_SAVING", 1)
    monkeypatch.setattr(resident, "_TB_STATE", {})


def _same(got, want):
    (ev, nm, f), (wev, wnm, wf) = got, want
    np.testing.assert_array_equal(nm, wnm)
    kept = wev > PS_THRESHOLD
    assert np.array_equal(ev > PS_THRESHOLD, kept)
    np.testing.assert_allclose(ev[kept], wev[kept], rtol=1e-8)
    np.testing.assert_allclose(f, wf, rtol=0, atol=1e-8 * np.abs(wf).max())


def test_bucketed_topband_matches_unbucketed(runs, forced):
    chunks = []
    got = resident.product_all_resident(*runs["args"], topband=True, kl_cut=PS_THRESHOLD,
                                        bucket=True, chunks=chunks, **runs["kw"])
    assert {c.fq * c.sq for c in chunks} >= {40, 32}
    t = runs["port"]
    _same(got, (t["ev"], t["nm"], t["f"]))


def test_windowed_topband_matches_full(runs, monkeypatch):
    monkeypatch.setattr(resident, "_TB_STATE", {})
    tel, _, _, ls, lf, nw = runs["args"]
    blg, fig = _units(tel)
    parts = []
    for m_range in ((0, 26), (26, tel.mmax + 1)):
        wp, wn = resident.btm_resident(tel, blg, fig, m_range=m_range)
        parts.append(resident.product_all_resident(
            tel, wp, wn, ls, lf, nw, m_range=m_range, topband=True, kl_cut=PS_THRESHOLD,
            bucket=False, **runs["kw"]))
    got = (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
           parts[0][2] + parts[1][2])
    t = runs["port"]
    _same(got, (t["ev"], t["nm"], t["f"]))
