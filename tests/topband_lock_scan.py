"""The top-band engine's escalation from seeded (k, levels) states, both
packages on the CPU in float64 (a script, not collected by pytest).

    python tests/topband_lock_scan.py [KxL ...]    # default: 7x1 7x2 4x3

On tests/test_torch_topband_resident.py's cylinder (pencil n 56) at
kl_cut = ps_threshold = 1e-3 with the fused Fisher, each package's
``_TB_STATE`` is seeded with (k, levels) and ``product_all_resident(
topband=True)`` runs over every m.  Printed for each seed: the state each
package ends in, the port's solves / failed certificates / exact
fallbacks, and the retained eigenvalues' max rel against the port's exact
engine for both packages (and the modes retained by one side only).  The
JAX program locks every Ritz pair above a level's lock bound; where a
seed's basis is narrow for the band its certificate passes with values
off the exact ones, where the port's residual test (``fpencil.
_RITZ_RES_REL``) escalates instead.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import conftest  # noqa: E402,F401  (the CPU backend, before JAX starts)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from driftscan_tpu.parallel import mstep as jms  # noqa: E402
from driftscan_tpu.parallel import resident as jres  # noqa: E402
from driftscan_tpu.telescope import cylinder as jcyl  # noqa: E402
from driftscan_tpu_torch.parallel import mstep, resident  # noqa: E402
from driftscan_tpu_torch.telescope import cylinder  # noqa: E402
from test_torch_slice import CFG, PS_THRESHOLD, _units  # noqa: E402


def rel(ev, ref):
    """(max rel on the modes both retain, modes retained by one only)."""
    a, b = ev > PS_THRESHOLD, ref > PS_THRESHOLD
    both = a & b
    return float((np.abs(ev - ref)[both] / ref[both]).max()), int((a ^ b).sum())


def main(seeds):
    torch.set_num_threads(2)
    jt = jcyl.UnpolarisedCylinderTelescope.from_config(CFG)
    blg, fig = _units(jt)
    cl_s, cl_n, noisew, _ = bench._covariances(jt)
    ls, lf = jms.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
    blt = jms.band_factor_table(
        iter(bench._fisher_bands(jt)), out_dtype=np.float64, rank_rtol=1e-9
    )
    jp, jn = jres.btm_resident(jt, blg, fig)
    tt = cylinder.UnpolarisedCylinderTelescope.from_config(CFG, device="cpu")
    t_cl_s, t_cl_n, t_noisew = chip_smoke.covariances(tt)
    t_ls, t_lf = mstep.prepare_cl_factors(t_cl_s, t_cl_n, out_dtype=np.float64)
    t_blt = mstep.band_factor_table(
        iter(chip_smoke.fisher_bands(tt)), out_dtype=np.float64, rank_rtol=1e-9
    )
    tp, tn = resident.btm_resident(tt, blg, fig)
    args = (tt, tp, tn, t_ls, t_lf, t_noisew.astype(np.float64))
    kw = dict(band_lt=t_blt, ps_threshold=PS_THRESHOLD)
    n = resident.pencil_size(tt)
    xev, _, _ = resident.product_all_resident(*args, **kw)
    for seed in seeds:
        t = time.time()
        jres._TB_STATE.clear()
        jres._TB_STATE[n] = seed
        jev, _, _ = jres.product_all_resident(
            jt, jp, jn, ls, lf, noisew.astype(np.float64), band_lt=blt,
            ps_threshold=PS_THRESHOLD, topband=True, kl_cut=PS_THRESHOLD)
        resident._TB_STATE.clear()
        resident._TB_STATE[n] = seed
        before = dict(resident.TB_COUNTS)
        tev, _, _ = resident.product_all_resident(*args, topband=True, kl_cut=PS_THRESHOLD,
                                                  **kw)
        c = {k: resident.TB_COUNTS[k] - before[k] for k in before}
        print(f"seed {seed}: JAX ends at {dict(jres._TB_STATE)}, port at "
              f"{dict(resident._TB_STATE)} (solves {c['solves']}, failed {c['failed']}, "
              f"exact {c['exact']}); retained eigenvalues vs the port's exact engine "
              f"(max rel, modes retained by one side only): JAX {rel(jev, xev)}, port "
              f"{rel(tev, xev)}; {time.time() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main([tuple(int(v) for v in a.split("x")) for a in (sys.argv[1:] or ["7x1", "7x2", "4x3"])])
