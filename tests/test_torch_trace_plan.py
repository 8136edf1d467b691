"""The launch plans of the map-pass (K2-host, K1+K2) and K15b kernels on the
CPU, and the arithmetic of K15b's symmetric form.

The kernels (csrc/host_vis.cu, csrc/bank_vis.cu, csrc/fisher_trace.cu) run
only on the card.
What surrounds them is Python and is checked here: the Fisher trace's split
of an m's (i, j) tiles over the blocks of a cluster, the number of unique
beams the map pass stages at once, and the registry entries.  The
symmetric form (one stack passed as C_a and C_b: tile pairs I <= J only,
half weight on i = j, F_ab = P_ab + P_ba) is emulated tile by tile in
float64 and held against the plain version.
Test-only code: no path runs the emulation.
"""

import os

import numpy as np
import pytest
import torch

from driftscan_tpu_torch import backend
from driftscan_tpu_torch.ops import kernels, projections, sht  # noqa: F401 (sht registers K14)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _job_tile(plan, t, sym):
    """(I, J) of job t, as fisher_trace.cu's job_tile decodes it."""
    if not sym:
        return t // plan.nt, t % plan.nt
    i = 0
    while t >= plan.nt - i:
        t -= plan.nt - i
        i += 1
    return i, i + t


def _rank_jobs(plan, rank):
    """The jobs of one block: its warps' streams g = warp x split + rank,
    each taking jobs g, g + streams, ... (fisher_trace.cu)."""
    streams = plan.split * projections.TRACE_WARPS
    for warp in range(projections.TRACE_WARPS):
        yield from range(warp * plan.split + rank, plan.njobs, streams)


@pytest.mark.parametrize("k", [1, 16, 17, 52, 65, 352])
@pytest.mark.parametrize("sym", [False, True], ids=["general", "sym"])
@pytest.mark.parametrize("nm,na", [(1, 4), (8, 4), (1, 9)])
def test_fisher_trace_split_covers_k2_exactly(k, sym, nm, na):
    """Every (i, j) of [0, k)^2 (every i <= j for one stack) falls in
    exactly one job of exactly one warp of one rank, every rank has a job,
    and the split fits a cluster."""
    te = projections.TRACE_TILE
    plan = projections.fisher_trace_plan(nm, na, na, k, sym, 132)
    assert 1 <= plan.split <= projections.TRACE_MAX_SPLIT
    assert plan.split <= plan.njobs
    count = np.zeros((k, k), dtype=np.int64)
    for rank in range(plan.split):
        jobs = list(_rank_jobs(plan, rank))
        assert jobs, "a rank with no job"
        for t in jobs:
            I, J = _job_tile(plan, t, sym)
            assert 0 <= I < plan.nt and 0 <= J < plan.nt and (not sym or I <= J)
            count[I * te:(I + 1) * te, J * te:(J + 1) * te] += 1
    if sym:
        upper = np.triu(np.ones((k, k), dtype=bool))
        assert (count[upper] == 1).all()
        # a diagonal tile's lower triangle is staged but weighs nothing
        assert count[~upper].max(initial=0) <= 1
    else:
        assert (count == 1).all()


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("nm", [1, 8, 200])
def test_fisher_trace_split_is_one_where_one_tile_covers_k(k, nm):
    for sym in (False, True):
        assert projections.fisher_trace_plan(nm, 4, 4, k, sym, 132).split == 1


@pytest.mark.parametrize("nm,k,want", [(1, 352, 8), (8, 52, 8), (8, 51, 8), (8, 9, 3),
                                       (64, 352, 3), (200, 352, 1)])
def test_fisher_trace_split_fills_the_card(nm, k, want):
    """nm x split blocks reach the card's 132 SMs where the jobs allow."""
    plan = projections.fisher_trace_plan(nm, 4, 4, k, True, 132)
    assert plan.split == want
    assert nm * plan.split >= min(132, nm * min(projections.TRACE_MAX_SPLIT, plan.njobs))


def test_fisher_trace_band_tiles():
    """Band tiles of TRACE_BANDS a side: one band-tile pair up to 4 bands
    (the symmetric form's only case), every pair beyond."""
    plan = projections.fisher_trace_plan
    assert plan(1, 4, 4, 52, True, 132).pairs == 1
    assert plan(1, 4, 3, 52, False, 132).pairs == 1
    assert plan(1, 9, 9, 52, False, 132).pairs == 9
    assert plan(1, 9, 5, 52, False, 132).pairs == 6


def _emulate(ca, cb, w, sym):
    """F as fisher_trace.cu forms it, job by job and rank by rank, in float64."""
    te = projections.TRACE_TILE
    nm, na, k = ca.shape[0], ca.shape[1], ca.shape[-1]
    nb = cb.shape[1]
    plan = projections.fisher_trace_plan(nm, na, nb, k, sym, 132)
    ca = ca.to(torch.complex128)
    cb = cb.to(torch.complex128)
    w = w.to(torch.float64)
    out = torch.zeros((nm, na, nb), dtype=torch.complex128)
    idx = torch.arange(k)
    for m in range(nm):
        for rank in range(plan.split):
            for t in _rank_jobs(plan, rank):
                I, J = _job_tile(plan, t, sym)
                ii = idx[I * te:(I + 1) * te]
                jj = idx[J * te:(J + 1) * te]
                ww = w[m, ii, None] * w[m, None, jj]
                if sym:
                    f = (ii[:, None] < jj[None, :]).double() + 0.5 * (ii[:, None] == jj[None, :])
                    ww = ww * f
                    u = ca[m][:, ii][:, :, jj]  # C[i, j]
                    v = ca[m][:, jj][:, :, ii].transpose(-1, -2)  # C[j, i]
                    out[m] += torch.einsum("aij,bij->ab", ww * u, v)
                else:
                    x = ww * ca[m][:, ii][:, :, jj]
                    y = cb[m][:, jj][:, :, ii].transpose(-1, -2)
                    out[m] += torch.einsum("aij,bij->ab", x, y)
    # one stack: F_ab = P_ab + P_ba over the upper-triangle sums P
    return out + out.transpose(-1, -2) if sym else out


@pytest.mark.parametrize("k", [1, 17, 52, 70])
@pytest.mark.parametrize("dtype,rtol", [(torch.complex128, 1e-12), (torch.complex64, 1e-12)])
def test_fisher_trace_symmetric_form_is_the_trace(k, dtype, rtol):
    """The symmetric decomposition equals the plain trace on one stack (a
    non-Hermitian one: the pairing needs only C_a and C_b to be one
    stack), and is symmetric (the kernel forms a <= b and mirrors); the
    general form on two stacks too."""
    rng = np.random.default_rng(31)
    nm, na = 2, 4
    z = rng.standard_normal((nm, na, k, k)) + 1j * rng.standard_normal((nm, na, k, k))
    c = torch.as_tensor(z).to(dtype)
    w = torch.as_tensor(rng.random((nm, k)))
    want = projections.fisher_trace_ref(c, c, w)
    got = _emulate(c, c, w, True)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * scale
    assert float((got - got.transpose(-1, -2)).abs().max()) <= rtol * scale
    cb = torch.as_tensor(rng.standard_normal((nm, 3, k, k)) + 0j).to(dtype)
    want = projections.fisher_trace_ref(c, cb, w)
    got = _emulate(c, cb, w, False)
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


@pytest.mark.parametrize("nb", [1, 3, 24, 25, 64, 500])
@pytest.mark.parametrize("ncomp,elem", [(1, 4), (1, 8), (1, 16), (2, 4), (2, 8), (2, 16), (2, 32)])
def test_host_vis_stage_fits_its_budget(nb, ncomp, elem):
    """All the batch's beams in one stage where they fit the budget, else
    the most that do (at least one): groups of that many."""
    s = kernels.host_vis_stage(nb, ncomp, elem)
    per_beam = kernels.HOST_VIS_TILE * ncomp * elem
    assert 1 <= s <= nb
    assert s * per_beam <= max(kernels.HOST_VIS_STAGE_BYTES, per_beam)
    if nb * per_beam <= kernels.HOST_VIS_STAGE_BYTES:
        assert s == nb
    else:
        assert (s + 1) * per_beam > kernels.HOST_VIS_STAGE_BYTES


@pytest.mark.parametrize("name", ["k2_host_vis", "k2_host_stokes", "k15b_fisher_trace",
                                  "k1k2_beam_vis", "k1k2_stokes_vis", "k14_legendre_synth"])
def test_redesigned_kernels_are_cuda(name):
    """K2-host and K1+K2 (both forms), K15b and K14 are CUDA C++ sources of
    csrc/."""
    k = backend.KERNELS[name]
    assert k.route == "cuda"
    assert k.source.startswith("driftscan_tpu_torch/csrc/") and k.source.endswith(".cu")
    assert os.path.isfile(os.path.join(REPO, k.source))
