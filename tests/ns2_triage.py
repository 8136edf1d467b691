"""ns2 at single m in both packages on the CPU: the BTM, the SVD stage and
the KL spectrum, by each precision and route (a script, not collected by
pytest).

    python tests/ns2_triage.py [--out DIR] [--units N] [STAGE ...]
    python tests/ns2_triage.py --out DIR report

The JAX package's north-star telescope ``ns2`` (``chip_smoke.NS2_PARAMS``,
``scratch/northstar2.py``'s values: a PolarisedCylinder, 2 x 9 feeds, 16
channels over 400-500 MHz; lmax 324, 1,600 units, npol 4, pencil n up to
3,200) at full width, at m 270 and 313 (fault 7's window, where no mode
passes 0.1) and at m 60 (the JAX run's second window, where modes do:
stages ``btm60-*`` and ``prod60-*``, the same settings on the m-window
(60, 61)).  Each stage runs in a subprocess
of its own and leaves ``DIR/<stage>.npz``; a stage whose file exists is
skipped, so an interrupted run resumes.  With no STAGE every stage runs in
order, then ``report``.

BTM stages (``btm_resident(m_range=(270, 314))``, columns 0 and 43 kept):
  btm-jax-f64   JAX package, ``single_precision`` off
  btm-jax-f32   JAX package, ``single_precision`` on, under the TPU's
                environment (``DRIFTSCAN_TPU_SPLIT_COMPLEX=1``,
                ``DRIFTSCAN_TPU_DEVICE_F64=0``)
  btm-port-f64  the port, complex128
  btm-port-c64  the port, complex64 (the card's BTM)
Product stages, on a stage's tables, m by m (``m_range=(m, m + 1)``):
the SVD stage alone (per-(m, f) singular values and counts after the
global svcut 1e-6), then ``product_all_resident`` with ns2's 10 Fisher
bands (k 0-0.4) and ``ps_threshold`` 0.1:
  prod-jax-native-f64   JAX on btm-jax-f64, no environment
  prod-jax-split-f64    JAX on btm-jax-f64, DRIFTSCAN_TPU_SPLIT_COMPLEX=1
  prod-jax-split-f32    JAX on btm-jax-f32 under the TPU's environment
                        (the TPU run's route and precision)
  prod-port-f64         the port on btm-port-f64
  prod-port-c64         the port on btm-port-c64: complex64 tables, the
                        SVD and pencil in complex128 (what the card runs)
``report`` prints, for each setting and m, the SVD count and the top 20
KL eigenvalues, beside the TPU run's record
(``ckpt/ns2_windows/w06_270_315_*.npz``, ``w01_45_90_*.npz``), and the
differences between the settings at BASELINE's tiers.

``--units N`` keeps only the N units of the longest baselines at the
highest channels (a quick rehearsal; the counts are then not ns2's).
The full run takes hours on the CPU; the JAX BTM stages hold ~8 GB.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# window key -> (the BTM's m-window, the m run from it); "" is fault 7's
# window (no mode passes 0.1 there), "60" an m of the JAX run's second
# window, where modes do
WINDOWS = {"": ((270, 314), (270, 313)), "60": ((60, 61), (60,))}
SVCUT = 1e-6
POLSVCUT = 1e-4
PS_THRESHOLD = 0.1
TOP = 20
# the port's linalg.POL_RESIDUE_FLOOR: a Stokes-I mode under this fraction of
# its channel's full-beam top singular value is the polarisation filter's
# rounding residue
RESIDUE = 1e-12
RECORDS = {"": ("ckpt/ns2_windows/w06_270_315_exact_highest_solve_bcast_f1.npz", 270),
           "60": ("ckpt/ns2_windows/w01_45_90_exact_highest_solve_bcast_f1.npz", 45)}
TPU_ENV = {"DRIFTSCAN_TPU_SPLIT_COMPLEX": "1", "DRIFTSCAN_TPU_DEVICE_F64": "0"}

# stage -> (package, precision, environment, tables), for each window key
_BTM = {
    "jax-f64": ("jax", "f64", {}),
    "jax-f32": ("jax", "f32", TPU_ENV),
    "port-f64": ("port", "f64", {}),
    "port-c64": ("port", "f32", {}),
}
_PROD = {
    "jax-native-f64": ("jax", "f64", {}, "jax-f64"),
    "jax-split-f64": ("jax", "f64", {"DRIFTSCAN_TPU_SPLIT_COMPLEX": "1"}, "jax-f64"),
    "jax-split-f32": ("jax", "f32", TPU_ENV, "jax-f32"),
    "port-f64": ("port", "f64", {}, "port-f64"),
    "port-c64": ("port", "f32", {}, "port-c64"),
}
STAGES = {}
for _key in WINDOWS:
    STAGES.update({f"btm{_key}-{k}": (p, q, e, None, _key) for k, (p, q, e) in _BTM.items()})
    STAGES.update({f"prod{_key}-{k}": (p, q, e, f"btm{_key}-{t}", _key)
                   for k, (p, q, e, t) in _PROD.items()})
LABELS = {
    "jax-native-f64": "JAX native f64",
    "jax-split-f64": "JAX split f64",
    "jax-split-f32": "JAX split f32 (the TPU's route)",
    "port-f64": "port f64",
    "port-c64": "port c64 BTM + c128 SVD (the card's)",
}


def log(msg):
    print(msg, flush=True)


def _params(prec):
    sys.path.insert(0, REPO)
    import chip_smoke

    return dict(chip_smoke.NS2_PARAMS, single_precision=prec == "f32")


def _units(tel, n):
    import numpy as np

    bl, fi = [x.ravel() for x in np.meshgrid(np.arange(tel.npairs), np.arange(tel.nfreq),
                                             indexing="ij")]
    if n:
        blen = np.hypot(tel.baselines[:, 0], tel.baselines[:, 1])
        keep = np.lexsort((fi, blen[bl]))[-n:]
        bl, fi = bl[np.sort(keep)], fi[np.sort(keep)]
    return bl, fi


def _jax_telescope(prec):
    sys.path.insert(0, HERE)
    import conftest  # noqa: F401  (the CPU backend, before JAX starts)
    from driftscan_tpu.telescope import cylinder as jcyl

    return jcyl.PolarisedCylinderTelescope.from_config(_params(prec))


def _port_telescope(prec):
    import torch

    from driftscan_tpu_torch.telescope import cylinder

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    return cylinder.PolarisedCylinderTelescope.from_config(_params(prec), device="cpu")


def run_btm(pkg, prec, out, nunits, key):
    import numpy as np

    WINDOW, MS = WINDOWS[key]
    cols = [m - WINDOW[0] for m in MS]
    t = time.time()
    if pkg == "jax":
        from driftscan_tpu.ops import zarray as za
        from driftscan_tpu.parallel import resident as jres

        tel = _jax_telescope(prec)
        bl, fi = _units(tel, nunits)
        p, n = jres.btm_resident(tel, bl, fi, m_range=WINDOW)
        pos, neg = za.to_numpy(p), za.to_numpy(n)
    else:
        from driftscan_tpu_torch.parallel import resident

        tel = _port_telescope(prec)
        bl, fi = _units(tel, nunits)
        p, n = resident.btm_resident(tel, bl, fi, m_range=WINDOW)
        pos, neg = p.numpy(), n.numpy()
    log(f"btm {pkg} {prec}: {len(bl)} units, window {WINDOW}, {time.time() - t:.1f} s, "
        f"dtype {pos.dtype}, max |pos| {np.abs(pos).max():.6e}")
    # every unit's rows (baseline-major, u = bl * nfreq + f), zero where a
    # rehearsal left a unit out
    u = bl * tel.nfreq + fi
    full = (tel.npairs * tel.nfreq,) + pos.shape[1:-1] + (len(cols),)
    tabs = {}
    for key, x in (("pos", pos), ("neg", neg)):
        tabs[key] = np.zeros(full, x.dtype)
        tabs[key][u] = x[..., cols]
    np.savez(out, bl=bl, fi=fi, seconds=time.time() - t, **tabs)


def _ns2_edges():
    import numpy as np

    return np.linspace(0.0, 0.4, 11)


def _jax_product(tel, prec, pos, neg, m):
    import jax.numpy as jnp
    import numpy as np

    import bench
    from driftscan_tpu.core import psestimation, skymodel
    from driftscan_tpu.ops import linalg as jlinalg
    from driftscan_tpu.ops import zarray as za
    from driftscan_tpu.parallel import mstep as jms
    from driftscan_tpu.parallel import resident as jres

    f64 = prec == "f64"
    rdt = np.float64 if f64 else np.float32
    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    ls, lf = jms.prepare_cl_factors(cl_s, cl_n, out_dtype=rdt)
    cr = skymodel.Corr21cm()
    cr.ps_2d = False

    def bands():
        edges = _ns2_edges()
        for ks, ke in zip(edges[:-1], edges[1:]):
            bf = psestimation.bandfunc_2d_polar(ks, ke, 0.0, np.pi / 2)
            crt = skymodel.Corr21cm(ps=(lambda k, mu, f=bf: cr.ps_vv(k) * f(k, mu)),
                                    redshift=1.5)
            crt.ps_2d = True
            yield skymodel.im21cm_model(tel.lmax, tel.frequencies, tel.num_pol_sky, cr=crt,
                                        temponly=True)

    band_lt = jms.band_factor_table(bands(), out_dtype=rdt, rank_rtol=1e-9)
    noisew = np.asarray(noisew, dtype=rdt)
    zp = za.Z(jnp.asarray(pos.real.astype(rdt)), jnp.asarray(pos.imag.astype(rdt)))
    zn = za.Z(jnp.asarray(neg.real.astype(rdt)), jnp.asarray(neg.imag.astype(rdt)))
    nl, npol = tel.lmax + 1, tel.num_pol_sky

    # the SVD stage of mstep's product step, as it runs there
    mv = jnp.asarray([m])
    b_re, b_im = jres._build_beam_batch(zp.re, zp.im, zn.re, zn.im, mv, tel.npairs, tel.nfreq,
                                        npol, nl, m_lo=m)
    lmask = (jnp.arange(nl) >= m).astype(b_re.dtype)
    tile = jnp.tile(lmask, npol)[None, None, :]
    w = jnp.asarray(noisew)[:, :, None]
    bw_re, bw_im = b_re[0] * tile * w, b_im[0] * tile * w
    out = jlinalg.triple_svd_split_batched(bw_re, bw_im, npol=npol, nl=nl, polsvcut=POLSVCUT)
    sig, nmo = np.asarray(out[4]), np.asarray(out[5])
    s1 = _top_singular(np.asarray(bw_re, np.float64) + 1j * np.asarray(bw_im, np.float64))
    svmask = sig > sig.max() * SVCUT
    nmo = np.minimum(nmo, svmask.sum(-1))

    ev, nm_p, fish = jres.product_all_resident(
        tel, zp, zn, ls, lf, noisew, bucket=True, m_range=(m, m + 1), band_lt=band_lt,
        ps_threshold=PS_THRESHOLD)
    return sig * svmask, nmo, np.asarray(ev)[0], np.asarray(nm_p)[0], np.asarray(fish), s1


def _top_singular(bw):
    """(F,) top singular value of each channel's weighted beam, float64."""
    import numpy as np

    return np.array([np.linalg.norm(b, 2) if np.abs(b).max() > 0 else 0.0 for b in bw])


def _port_product(tel, prec, pos, neg, m):
    import numpy as np
    import torch

    import chip_smoke
    from driftscan_tpu_torch.parallel import mstep, resident

    f64 = prec == "f64"
    cdt = torch.complex128 if f64 else torch.complex64
    cl_s, cl_n, noisew = chip_smoke.covariances(tel)
    if f64:
        ls, lf = mstep.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
        band_lt = mstep.band_factor_table(
            iter(chip_smoke.fisher_bands(tel, edges=_ns2_edges())), out_dtype=np.float64,
            rank_rtol=1e-9)
        noisew = noisew.astype(np.float64)
    else:
        ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
        band_lt = mstep.band_factor_table(
            iter(chip_smoke.fisher_bands(tel, edges=_ns2_edges())), out_dtype=np.float32,
            rank_rtol=1e-9)
    tp = torch.as_tensor(pos).to(cdt)
    tn = torch.as_tensor(neg).to(cdt)
    nl, npol = tel.lmax + 1, tel.num_pol_sky
    mv = torch.as_tensor([m])
    beam = resident._build_beam_batch(tp, tn, mv, tel.npairs, tel.nfreq, npol, nl, m_lo=m)
    _, _, sig, nmo = mstep.svd_compress(beam, torch.as_tensor(noisew), mv, npol, nl,
                                        POLSVCUT, SVCUT)
    lmask = (torch.arange(nl) >= m).double().repeat(npol)
    bw = (beam[0].to(torch.complex128) * lmask
          * torch.as_tensor(noisew, dtype=torch.float64)[:, :, None])
    s1 = _top_singular(bw.numpy())
    sig = sig[0].numpy()
    svmask = sig > sig.max() * SVCUT
    ev, nm_p, fish = resident.product_all_resident(
        tel, tp, tn, ls, lf, noisew, bucket=True, m_range=(m, m + 1), band_lt=band_lt,
        ps_threshold=PS_THRESHOLD)
    return (sig * svmask, nmo[0].numpy(), np.asarray(ev)[0], np.asarray(nm_p)[0],
            np.asarray(fish), s1)


def run_product(pkg, prec, tables, out, key):
    import numpy as np

    MS = WINDOWS[key][1]
    z = np.load(tables)
    res = {}
    tel = _jax_telescope(prec) if pkg == "jax" else _port_telescope(prec)
    for i, m in enumerate(MS):
        t = time.time()
        pos, neg = z["pos"][..., i:i + 1], z["neg"][..., i:i + 1]
        fn = _jax_product if pkg == "jax" else _port_product
        sig, nmo, ev, nmo_p, fish, s1 = fn(tel, prec, pos, neg, m)
        res.update({f"sig_{m}": sig, f"nmo_{m}": nmo, f"ev_{m}": ev, f"nmop_{m}": nmo_p,
                    f"fish_{m}": fish, f"s1_{m}": s1, f"seconds_{m}": time.time() - t})
        log(f"product {pkg} {prec} m {m}: svd modes {int(nmo.sum())} (product's count "
            f"{int(np.sum(nmo_p))}), top ev {float(ev.max()):.6e}, {time.time() - t:.1f} s")
    np.savez(out, **res)


def report(outdir):
    import numpy as np

    def load(name):
        path = os.path.join(outdir, name + ".npz")
        return np.load(path) if os.path.exists(path) else None

    for key, (window, MS) in WINDOWS.items():
        rpath, r0 = RECORDS[key]
        rec = np.load(os.path.join(REPO, rpath))
        jev, jnmo = rec["ev"], rec["nmo"]
        rows = []
        for name, label in LABELS.items():
            z = load(f"prod{key}-{name}")
            if z is not None:
                rows.append((label, {m: (z[f"nmo_{m}"], np.sort(z[f"ev_{m}"])[::-1][:TOP],
                                         (z[f"sig_{m}"], z[f"s1_{m}"])) for m in MS}))
        if not rows:
            continue
        rows.append(("TPU record (float32)",
                     {m: (jnmo[m - r0], np.sort(jev[m - r0])[::-1][:TOP], None) for m in MS}))
        for m in MS:
            log(f"m {m}: SVD modes (sum over 16 channels; per channel) and the top {TOP} KL "
                f"eigenvalues (retained above {PS_THRESHOLD:g}: the count after 'ret')")
            for label, r in rows:
                nmo, top, extra = r[m]
                above = ""
                if extra is not None:
                    sig, s1 = extra
                    real = int((sig > RESIDUE * s1[:, None]).sum())
                    above = f" ({real} above {RESIDUE:g} of their channel's top singular value)"
                log(f"  {label:38s} {int(np.sum(nmo)):6d}  {list(map(int, nmo))}{above}")
                log(f"  {'':38s} ret {int((top > PS_THRESHOLD).sum())}, top {TOP}: "
                    + " ".join(f"{v:.4e}" for v in top))

        # the differences between the settings at BASELINE's tiers
        bj, bp = load(f"btm{key}-jax-f64"), load(f"btm{key}-port-f64")
        if bj is not None and bp is not None:
            for part in ("pos", "neg"):
                err = np.abs(bp[part] - bj[part]).max() / np.abs(bj[part]).max()
                log(f"BTM columns (m {list(MS)}) port f64 vs JAX f64, {part}: {err:.3e} of max")
        pairs = [("port-f64", "jax-native-f64"), ("jax-split-f64", "jax-native-f64"),
                 ("port-c64", "port-f64"), ("jax-split-f32", "jax-native-f64"),
                 ("jax-split-f32", "port-f64")]
        for a, b in pairs:
            za_, zb = load(f"prod{key}-{a}"), load(f"prod{key}-{b}")
            if za_ is None or zb is None:
                continue
            for m in MS:
                na, nb = za_[f"nmo_{m}"], zb[f"nmo_{m}"]
                sa, sb = za_[f"sig_{m}"], zb[f"sig_{m}"]
                both = (sa > 0) & (sb > 0)
                srel = float((np.abs(sa - sb)[both] / sb[both]).max()) if both.any() else 0.0
                ea = np.sort(za_[f"ev_{m}"])[::-1]
                eb = np.sort(zb[f"ev_{m}"])[::-1]
                k = min(len(ea), len(eb))
                ea, eb = ea[:k], eb[:k]
                etop = max(float(eb.max()), 1e-300)
                erel = float(np.abs(ea - eb).max() / etop)
                e20 = float(np.abs(ea[:TOP] - eb[:TOP]).max() / etop)
                kept = (ea > PS_THRESHOLD) & (eb > PS_THRESHOLD)
                krel = (float((np.abs(ea - eb)[kept] / eb[kept]).max()) if kept.any()
                        else float("nan"))
                log(f"{LABELS[a]} vs {LABELS[b]}, m {m}: SVD counts differ in "
                    f"{int((na != nb).sum())} of 16 channels (total "
                    f"{int(na.sum()) - int(nb.sum()):+d}); singular values rel {srel:.3e} where "
                    f"both keep a mode (tier 1e-3); KL spectrum {erel:.3e} of the top, top {TOP} "
                    f"{e20:.3e} (tier 1e-4); retained above {PS_THRESHOLD:g} "
                    f"{int((ea > PS_THRESHOLD).sum())} / {int((eb > PS_THRESHOLD).sum())}, rel "
                    f"{krel:.3e} rank by rank; Fisher max |F| "
                    f"{float(np.abs(za_[f'fish_{m}']).max()):.3e} / "
                    f"{float(np.abs(zb[f'fish_{m}']).max()):.3e}")
        for name, label in LABELS.items():
            z = load(f"prod{key}-{name}")
            if z is None:
                continue
            for m in MS:
                top20 = np.sort(z[f"ev_{m}"])[::-1][:TOP]
                j20 = np.sort(jev[m - r0])[::-1][:TOP]
                log(f"{label} vs the TPU record, m {m}: SVD modes "
                    f"{int(z[f'nmo_{m}'].sum()) - int(jnmo[m - r0].sum()):+d}; top {TOP} "
                    f"|ev - record| / record top {float(np.abs(top20 - j20).max() / j20[0]):.3e}"
                    f"; the top {float(abs(top20[0] - j20[0]) / j20[0]):.3e} rel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(os.environ.get("TMPDIR", "/tmp"),
                                                  "ns2_triage"))
    ap.add_argument("--units", type=int, default=0)
    ap.add_argument("stages", nargs="*")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    if len(args.stages) == 1 and args.stages[0] in STAGES:
        stage = args.stages[0]
        pkg, prec, _, tables, key = STAGES[stage]
        out = os.path.join(args.out, stage + ".npz")
        if tables is None:
            run_btm(pkg, prec, out, args.units, key)
        else:
            run_product(pkg, prec, os.path.join(args.out, tables + ".npz"), out, key)
        return
    stages = args.stages or list(STAGES) + ["report"]
    for stage in stages:
        if stage == "report":
            report(args.out)
            continue
        if os.path.exists(os.path.join(args.out, stage + ".npz")):
            log(f"{stage}: done already")
            continue
        env = dict(os.environ, **STAGES[stage][2])
        cmd = [sys.executable, os.path.abspath(__file__), "--out", args.out,
               "--units", str(args.units), stage]
        log(f"{stage}: {' '.join(f'{k}={v}' for k, v in STAGES[stage][2].items())}")
        subprocess.run(cmd, env=env, check=True)


if __name__ == "__main__":
    main()
