#!/usr/bin/env python
"""The top-band engine with and without its residual test, on one GPU.

    python3 driftscan_tpu_torch/experiments/topband_lock.py

The port's engine locks a Ritz pair only when its residual is within
``fpencil._RITZ_RES_REL`` of its value; the JAX program locks every pair
above a level's lock bound.  On ``chip_smoke.py``'s bench cylinder this
runs each route twice, with the test (``_RITZ_RES_REL`` 1e-5) and
without it (infinity: the JAX program's lock), each from a cleared
escalation state:

* the resident route, ``product_all_resident(topband=True, kl_cut=0.1)``
  with the fused Fisher, twice (the first pays the escalation), against
  the exact engine on the same tables;
* the file route, ``chip_smoke.py``'s ``[products]`` config (without its
  power spectrum) with its KL and DoubleKL filters again under ``engine:
  topband``, against the exact filters.

For each it prints the escalations (solves, failed certificates, exact
fallbacks, the final (k, levels)), the file route's chunks that fell back
to the exact engine, the times, and the retained eigenvalues against the
exact engine's (max rel, modes retained by one engine only).  Needs a CUDA
card; imports no JAX.
"""

import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
SETTINGS = (("residual test on", 1e-5), ("residual test off", float("inf")))


def log(msg):
    print(f"[topband lock] {msg}", flush=True)


def resident_route(smoke, tel):
    import torch

    from driftscan_tpu_torch.ops import fpencil
    from driftscan_tpu_torch.parallel import mstep, resident

    pos, neg = resident.btm_resident(tel, *smoke.units(tel))
    cl_s, cl_n, noisew = smoke.covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    band_lt = mstep.band_factor_table(
        iter(smoke.fisher_bands(tel)), out_dtype=np.float32, rank_rtol=1e-9
    )
    kw = dict(band_lt=band_lt, ps_threshold=smoke.PS_THRESHOLD)
    nm = tel.mmax + 1
    t = time.time()
    ev_x, _, f_x = resident.product_all_resident(tel, pos, neg, ls, lf, noisew, **kw)
    torch.cuda.synchronize()
    t_x = time.time() - t
    log(f"resident, exact engine: {t_x:.4f} s, {nm / t_x:.4f} m-modes/s")
    for name, res_rel in SETTINGS:
        fpencil._RITZ_RES_REL = res_rel
        resident._TB_STATE.clear()
        before = dict(resident.TB_COUNTS)
        times = []
        for _ in range(2):
            chunks = []
            t = time.time()
            ev, _, f = resident.product_all_resident(
                tel, pos, neg, ls, lf, noisew, topband=True, kl_cut=smoke.PS_THRESHOLD,
                chunks=chunks, **kw)
            torch.cuda.synchronize()
            times.append(time.time() - t)
        c = smoke.topband_counts(before)
        rel, ndiff, _ = smoke.retained_diff(ev, ev_x, smoke.PS_THRESHOLD)
        ferr = float(np.abs(f - f_x).max() / np.abs(f_x).max())
        log(f"resident, {name}: {len(chunks)} chunks a run; over both runs solves "
            f"{c['solves']}, failed certificates {c['failed']}, exact fallbacks "
            f"{c['exact']}; (k, levels) {dict(resident._TB_STATE)}; s {times} "
            f"(m-modes/s {nm / times[0]:.4f}, then {nm / times[1]:.4f}); vs exact: max rel "
            f"on retained {rel:.3e}, retained by one engine only {ndiff}, Fisher "
            f"|diff| / max|F| {ferr:.3e}")
    fpencil._RITZ_RES_REL = SETTINGS[0][1]
    del pos, neg


def compare_files(m, tb_name, ex_name):
    """(max rel of retained eigenvalues, m whose num_modes differ, modes)."""
    from driftscan_tpu_torch.util import store

    tb, ex = m.kltransforms[tb_name], m.kltransforms[ex_name]
    worst, differ, modes = 0.0, [], 0
    for mi in range(m.telescope.mmax + 1):
        with store.File(tb._evfile % mi, "r") as f:
            ev_t, n_t = f["evals"][:], int(f.attrs["num_modes"])
        with store.File(ex._evfile % mi, "r") as f:
            ev_x, n_x = f["evals"][:], int(f.attrs["num_modes"])
        modes += n_x
        if n_t != n_x:
            differ.append(mi)
        elif n_x:
            worst = max(worst, float((np.abs(ev_t - ev_x) / ev_x).max()))
    return worst, differ, modes


def file_route(smoke, outdir):
    import torch

    from driftscan_tpu_torch.core import manager
    from driftscan_tpu_torch.ops import fpencil

    conf = smoke.products_config(outdir)
    conf["config"]["psfisher"] = False
    del conf["psfisher"]
    conf["kltransform"] += [
        {"type": "KLTransform", "name": "kl_tb", "threshold": smoke.PS_THRESHOLD,
         "engine": "topband"},
        {"type": "DoubleKL", "name": "dk_tb", "engine": "topband"},
    ]
    for name, res_rel in SETTINGS:
        fpencil._RITZ_RES_REL = res_rel
        # the top-band filters' files of the previous setting go; a new
        # manager makes their directories again
        for tb_name in ("kl_tb", "dk_tb"):
            shutil.rmtree(os.path.join(outdir, "bt", tb_name), ignore_errors=True)
        m = manager.ProductManager().apply_config(conf)
        t = time.time()
        m.generate()
        torch.cuda.synchronize()
        wall = time.time() - t
        tm = m.timings
        for tb_name, ex_name in (("kl_tb", "kl"), ("dk_tb", "dk")):
            fell = m.kltransforms[tb_name].topband_fallback_chunks
            worst, differ, modes = compare_files(m, tb_name, ex_name)
            log(f"files, {name}: {tb_name} {tm[f'kl.{tb_name}']:.4f} s ({ex_name}, exact: "
                f"{tm.get(f'kl.{ex_name}', float('nan')):.4f} s when generated in this "
                f"call); chunks that fell back to the exact engine {len(fell)} "
                f"({sum(map(len, fell))} m: {[c[0] for c in fell]}...); vs {ex_name}: "
                f"num_modes differ at {len(differ)} m {differ[:8]}, max rel on retained "
                f"{worst:.3e} ({modes} modes)")
        log(f"files, {name}: generate() {wall:.4f} s")
    fpencil._RITZ_RES_REL = SETTINGS[0][1]


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.telescope import cylinder

    log(f"{ROOT} on {smoke.card_line()}")
    backend.build_all()
    tel = cylinder.UnpolarisedCylinderTelescope.from_config(smoke.BENCH_PARAMS, device="cuda")
    resident_route(smoke, tel)
    outdir = tempfile.mkdtemp(prefix="driftscan_topband_lock_")
    try:
        file_route(smoke, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


if __name__ == "__main__":
    main()
