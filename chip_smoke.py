#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (driftscan_tpu_torch) on one GPU.

    python3 chip_smoke.py             # the phases below
    python3 chip_smoke.py --profile   # then torch.profiler over each path

Needs one CUDA card and the CUDA toolkit (nvcc) and Triton; imports no
JAX.  Phases, each printed on its own line(s); any failure raises, so the
script exits non-zero:

1. device -- ``torch.cuda.is_available()`` or an error; the card's name
   and power limit as ``nvidia-smi`` reports them;
2. build -- compiles every CUDA source of ``driftscan_tpu_torch/csrc``
   into ``driftscan_tpu_torch/_build/``, one ``nvcc`` per source, all at
   once (the Triton kernels compile at their first launch);
3. kernels -- each hand-written kernel of the product paths against its
   plain PyTorch version on the same CUDA inputs (at the shapes each of
   paths 4 and 5 gives it, numpy seed), with the tolerance asserted and
   the median time of both (CUDA events);
4. slice -- the bench telescope (``bench.build_telescope``'s full config)
   through ``btm_resident`` and ``product_all_resident`` with the fused
   Fisher over all m;
5. pol -- the polarised telescope (``bench.build_pol_telescope``'s full
   config, npol 4) through the same entry points;
6. probe -- the ports of the two Pallas probes of
   ``scratch/pallas_probe.py`` (o = 2 x; a 1024^3 matmul, float32 and
   bfloat16 inputs) against their plain versions, with Tflop/s.

Each path (4-6) runs with every launch count set to 0 just before it and
read just after, and fails unless every kernel of that path launched.
Paths 4 and 5 then re-run their first and last 8 m on CPU tensors from
the same BTM tables (the plain paths) and compare with the card.

The line before the last holds the nvidia-smi name and power limit; the
line before that one the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# bench.py build_telescope(), full scale
BENCH_PARAMS = dict(
    num_freq=8,
    freq_start=400.0,
    freq_end=450.0,
    freq_mode="edge",
    num_cylinders=2,
    cylinder_width=12.0,
    num_feeds=8,
    feed_spacing=0.6,
    tsys=50.0,
    single_precision=True,
)
# bench.py build_pol_telescope(), full scale
POL_PARAMS = dict(
    num_freq=4,
    freq_start=400.0,
    freq_end=450.0,
    freq_mode="edge",
    num_cylinders=2,
    cylinder_width=6.0,
    num_feeds=4,
    feed_spacing=1.5,
    tsys=50.0,
    single_precision=True,
)
PS_THRESHOLD = 0.1  # bench's KL retention cut for the Fisher
# The polarised telescope's KL spectrum tops at 6.42e-5 (m = 6), in the JAX
# package as in the port: its product step on the same BTM tables gives the
# same top eigenvalue per m (PERF.md section 2).  No mode passes 0.1, so
# its Fisher at PS_THRESHOLD would be identically zero; it keeps the modes
# above 1e-5, the top decade of its spectrum.
POL_PS_THRESHOLD = 1e-5
CPU_CHECK_M = 8
PROBE_N = 1024  # scratch/pallas_probe.py's shapes

PROBE_KERNELS = ("probe_double", "probe_mm")


def log(msg):
    print(msg, flush=True)


def covariances(tel):
    """(cl_s, cl_n, noisew) of the port's sky models (bench._covariances).

    Covariances stay float64 (the rank compaction of factor_cl measures
    the numerical rank at float64 resolution); noisew is float32.
    """
    from driftscan_tpu_torch.core import skymodel

    npol = tel.num_pol_sky
    cl_s = skymodel.im21cm_model(tel.lmax, tel.frequencies, npol)
    cl_n = skymodel.foreground_model(tel.lmax, tel.frequencies, npol)
    noisew = np.stack(
        [
            np.concatenate([w, w])
            for w in (
                tel.noisepower(np.arange(tel.npairs), fi).flatten() ** -0.5
                for fi in range(tel.nfreq)
            )
        ]
    )
    return cl_s, cl_n, noisew.astype(np.float32)


def fisher_bands(tel, nbands=4):
    """(nbands, nl, F, F) polar-annulus band spectra (bench._fisher_bands)."""
    from driftscan_tpu_torch.core import psestimation, skymodel

    edges = np.linspace(0.02, 0.25, nbands + 1)
    cr = skymodel.Corr21cm()
    cl = []
    for ks, ke in zip(edges[:-1], edges[1:]):
        ind = psestimation.bandfunc_2d_polar(ks, ke, 0.0, np.pi / 2.0)
        crt = skymodel.Corr21cm(
            ps=(lambda f: (lambda k, mu: cr.ps_vv(k) * f(k, mu)))(ind),
            redshift=1.5,
        )
        crt.ps_2d = True
        cl.append(
            skymodel.im21cm_model(tel.lmax, tel.frequencies, 1, cr=crt, temponly=True)
        )
    return np.asarray(cl, dtype=np.float32)


def units(tel):
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    return [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=10):
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(name, kernel_fn, plain_fn, rtol, reps=10, tag="kernels"):
    """Kernel vs plain on the same inputs: max error, tolerance, times."""
    import torch

    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"{name}: kernel output not finite")
    if not err <= rtol * scale:
        raise AssertionError(
            f"{name}: max |kernel - plain| = {err:.3e} > {rtol:g} * {scale:.3e}"
        )
    ms = median_ms(kernel_fn, reps)
    plain_ms = median_ms(plain_fn, reps)
    log(
        f"[{tag}] {name}: max_abs_err {err:.6e} (max|plain| {scale:.6e}, "
        f"rel tol {rtol:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def first_chunk(tel):
    """The units of one SHT chunk of ``btm_resident`` for ``tel``: the first
    (and largest) chunk at its largest nside, frequency-major as
    btm_resident orders a bucket, and the largest band limit of that
    nside's chunks.  Returns (nside, bl, f, lmax)."""
    from driftscan_tpu_torch.core import telescope as teles

    blg, fig = units(tel)
    lmax_u = tel.unit_lmax(blg, fig)
    nsides = np.array([tel._nside_for(int(l)) for l in lmax_u])
    ns = int(nsides.max())
    bucket = np.nonzero(nsides == ns)[0]
    bucket = bucket[np.argsort(fig[bucket], kind="stable")]
    take = teles.sht_unit_chunks(len(bucket), 12 * ns**2, tel.num_pol_sky)[0]
    sel = bucket[:take]
    return ns, blg[sel], fig[sel], int(lmax_u[bucket].max())


def kernel_phases(tel, ptel):
    """Each product-path kernel against its plain version at the shapes each
    path (unpolarised ``tel``, polarised ``ptel``) gives it.  Returns the
    unpolarised path's records (the polarised-only kernel's from ptel)."""
    import torch

    from driftscan_tpu_torch.ops import fpencil, healpix, kernels, sht
    from driftscan_tpu_torch.parallel import mstep, resident

    dev = tel.device
    rng = np.random.default_rng(SEED)
    res = {}

    def crandn(shape, dtype=np.complex64):
        return torch.as_tensor(
            (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype),
            device=dev,
        )

    def keep(name, rec):
        res.setdefault(name, rec)

    for t in (tel, ptel):
        pol = t.num_pol_sky > 1
        npol_t = t._npol_transform if pol else 1

        # K1+K2 (scalar or Stokes): one BTM chunk's beams and maps
        ns, blc, fic, sub_lmax = first_chunk(t)
        nu = len(blc)
        t._init_trans(ns)
        fx, par, ii, jj, uv3 = t._gather_beams(blc, fic)
        args = (t._angpos_cart, t._horizon, fx, par, ii, jj, uv3, 4.0 * np.pi / (12 * ns**2))
        npx = t._horizon.shape[0]
        if pol:
            keep("k1k2_stokes_vis", compare(
                f"k1k2_stokes_vis ({nu} units x {npol_t} Stokes x {npx} px, nside {ns})",
                lambda: kernels.bank_stokes_maps(*args, npol=npol_t),
                lambda: kernels.bank_stokes_maps_ref(*args, npol=npol_t),
                rtol=1e-5,
            ))
        else:
            keep("k1k2_beam_vis", compare(
                f"k1k2_beam_vis ({nu} units x {npx} px, nside {ns})",
                lambda: kernels.bank_visibility_maps(*args),
                lambda: kernels.bank_visibility_maps_ref(*args),
                rtol=1e-5,
            ))
        del args

        # K3+K5: phase-stage outputs (units x Stokes, nm, nring) of that
        # chunk's size at the nside's largest band limit
        g = healpix.ring_geometry(ns)
        B = nu * npol_t
        F = crandn((B, sub_lmax + 1, g.nring))
        G = crandn((B, sub_lmax + 1, g.nring))
        cos_t = torch.as_tensor(g.cos_theta, device=dev)
        sin_t = torch.as_tensor(g.sin_theta, device=dev)
        area = 4.0 * np.pi / g.npix
        keep("k3k5_legendre_sht", compare(
            f"k3k5_legendre_sht (B {B}, lmax {sub_lmax}, nring {g.nring})",
            lambda: sht.legendre_contract(F, G, cos_t, sin_t, sub_lmax, area),
            lambda: sht.legendre_contract_ref(F, G, cos_t, sin_t, sub_lmax, area),
            rtol=1e-4,
            reps=5,
        ))
        del F, G

        # K9: an m-batch of sky->SVD beams (8, F, S, npol, nl) and a signal
        # factor as wide as the path's (npol 4 is off the polarised path,
        # whose factor is narrower than 2n; held here all the same)
        nl = t.lmax + 1
        n = resident.pencil_size(t)
        S = n // t.nfreq
        npol = t.num_pol_sky
        bsvd = crandn((8, t.nfreq, S, npol, nl))
        ls = torch.as_tensor(
            rng.standard_normal((nl, npol, t.nfreq, t.nfreq)).astype(np.float32), device=dev
        )
        keep("k9_signal_gram", compare(
            f"k9_signal_gram (M 8, n {n}, npol {npol}, width {nl * t.nfreq})",
            lambda: fpencil.signal_gram(bsvd, ls),
            lambda: fpencil.signal_gram_ref(bsvd, ls),
            rtol=1e-5,
            reps=10 if not pol else 3,
        ))
        del bsvd

        # K13: k = n retained modes (the upper bound), the path's band table
        # shape (4 bands of rank <= F, l axis padded to 64)
        v = crandn((8, n, t.nfreq, S))
        bt = crandn((8, t.nfreq, S, nl))
        nlp = -(-nl // 64) * 64
        blt = torch.as_tensor(
            rng.standard_normal((4, nlp, t.nfreq, t.nfreq)).astype(np.float32), device=dev
        )
        keep("k13_fisher_cov", compare(
            f"k13_fisher_cov (M 8, k {n}, nb 4, nlp {nlp}, Kb {t.nfreq})",
            lambda: mstep.fisher_cov(v, bt, blt),
            lambda: mstep.fisher_cov_ref(v, bt, blt),
            rtol=1e-4,
        ))
        del v, bt
    return res


def launch_counts():
    """{kernel name: launches since the last reset}."""
    from driftscan_tpu_torch import backend

    return {k.name: k.launches for k in backend.KERNELS.values()}


def require_launched(tag, launches, names):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the {tag} path")


def path_kernels(tel, ls_width):
    """The hand kernels a product path launches: beams + maps, the SHT,
    the compact signal Gram where the product step takes it
    (``mstep.uses_compact_signal``), and the Fisher covariances."""
    from driftscan_tpu_torch.parallel import mstep, resident

    n = resident.pencil_size(tel)
    width = (tel.lmax + 1) * ls_width
    names = ["k1k2_stokes_vis" if tel.num_pol_sky > 1 else "k1k2_beam_vis",
             "k3k5_legendre_sht", "k13_fisher_cov"]
    if mstep.uses_compact_signal(n, width):
        names.append("k9_signal_gram")
    return names, n, width


def path_phase(tag, tel, ps_threshold):
    """One product path on the card, its launch counts, and the CPU check."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.parallel import mstep, resident

    nm = tel.mmax + 1
    blg, fig = units(tel)
    cl_s, cl_n, noisew = covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    band_lt = mstep.band_factor_table(
        iter(fisher_bands(tel)), out_dtype=np.float32, rank_rtol=1e-9
    )
    required, n, width = path_kernels(tel, ls.shape[-1])
    log(
        f"[{tag}] lmax {tel.lmax} nm {nm} npairs {tel.npairs} nfreq {tel.nfreq} "
        f"npol {tel.num_pol_sky} units {len(blg)} pencil n {n} signal width {width} "
        f"ls {ls.shape} lf {lf.shape} band_lt {band_lt.shape} kernels {required}"
    )
    kw = dict(band_lt=band_lt, ps_threshold=ps_threshold)

    # warm-up: builds, Triton compile, cuFFT plans, first-call costs
    t = time.time()
    pos, neg = resident.btm_resident(tel, blg, fig)
    resident.product_all_resident(tel, pos, neg, ls, lf, noisew, max_m=8, **kw)
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up {time.time() - t:.2f} s")
    del pos, neg

    backend.reset_launch_counts()
    t0 = time.time()
    pos, neg = resident.btm_resident(tel, blg, fig)
    torch.cuda.synchronize()
    t1 = time.time()
    evals, nmodes, fisher = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, **kw
    )
    torch.cuda.synchronize()
    t2 = time.time()
    launches = launch_counts()

    t_btm, t_prod = t1 - t0, t2 - t1
    retained = int((evals > ps_threshold).sum())
    log(
        f"[{tag}] t_btm {t_btm:.4f} s  t_product_fisher {t_prod:.4f} s  "
        f"m-modes/s {nm / (t_btm + t_prod):.4f}  retained modes "
        f"(ev > {ps_threshold:g}) {retained}  top ev {float(evals.max()):.6e}  "
        f"svd modes {int(nmodes.sum())}  launches {launches}"
    )
    if not np.isfinite(evals).all():
        raise AssertionError(f"{tag}: non-finite KL eigenvalues")
    if not np.isfinite(fisher).all():
        raise AssertionError(f"{tag}: non-finite Fisher matrix")
    fscale = np.abs(fisher).max()
    if not fscale > 0:
        raise AssertionError(f"{tag}: Fisher matrix is zero (no retained modes)")
    if not np.abs(fisher - fisher.conj().T).max() <= 1e-4 * fscale:
        raise AssertionError(f"{tag}: Fisher matrix not Hermitian")
    diag = np.diagonal(fisher)
    if not ((diag.real >= 0).all() and np.abs(diag.imag).max() <= 1e-4 * fscale):
        raise AssertionError(f"{tag}: Fisher diagonal not real non-negative: {diag}")
    require_launched(tag, launches, required)
    log(f"[{tag}] fisher diag {np.round(diag.real, 12).tolist()}")

    cpu_check(tag, tel, pos, neg, ls, lf, noisew, band_lt, ps_threshold)
    return launches, required


def cpu_check(tag, tel, pos, neg, ls, lf, noisew, band_lt, ps_threshold):
    """The first and last CPU_CHECK_M m-modes again, on the card and on CPU
    tensors from the same tables, in the same m-batches (the adaptive sig1
    depth is chosen per batch): retained spectra, and the whole spectrum,
    within 1e-4 of each m's top eigenvalue (the whole spectrum keeps the
    check meaningful where no mode is retained, as at high m), partial
    Fisher within 3e-2 of its max."""
    import torch

    from driftscan_tpu_torch.parallel import mstep, resident

    nm = tel.mmax + 1
    mb = resident.auto_mbatch(tel, ls.shape[-1], lf.shape[-1], tel.device)
    windows = (("first", 0, min(CPU_CHECK_M, nm)), ("last", max(nm - CPU_CHECK_M, 0), nm))

    def run(p, n, lo, hi):
        rdt = p.real.dtype
        ls_t, lf_t, band_t = mstep.factors_from_numpy(ls, lf, band_lt, p.device, rdt)
        nw = torch.as_tensor(noisew, dtype=rdt, device=p.device)
        evs, fish = [], 0.0
        for s in range(lo, hi, mb):
            take = min(mb, hi - s)
            mv = np.full(mb, -1, np.int64)
            mv[:take] = np.arange(s, s + take)
            ev, _, f = resident.product_m_batch(
                tel, p, n, ls_t, lf_t, nw, mv, band_lt=band_t, ps_threshold=ps_threshold
            )
            evs.append(ev[:take])
            fish = fish + f
        return np.concatenate(evs), fish

    pos_c, neg_c = pos.cpu(), neg.cpu()
    for name, lo, hi in windows:
        ev_g, f_g = run(pos, neg, lo, hi)
        t = time.time()
        ev_c, f_c = run(pos_c, neg_c, lo, hi)
        t_cpu = time.time() - t
        kept = (ev_c > ps_threshold) | (ev_g > ps_threshold)
        top = np.maximum(ev_c.max(axis=1, keepdims=True), 1e-30)
        rel = np.abs(ev_g - ev_c) / top
        ev_err = float(rel[kept].max()) if kept.any() else 0.0
        all_err = float(rel.max())
        f_err = float(np.abs(f_g - f_c).max() / max(np.abs(f_c).max(), 1e-300))
        log(
            f"[{tag}] cpu check {name} m {lo}..{hi - 1} (mbatch {mb}, cpu {t_cpu:.2f} s): "
            f"retained {int(kept.sum())} modes, max |ev_card - ev_cpu| / ev_top "
            f"{ev_err:.3e} (whole spectrum {all_err:.3e}; tol 1e-4; top ev "
            f"{float(ev_c.max()):.6e}), partial Fisher rel {f_err:.3e} (tol 3e-2, "
            f"max|F| {float(np.abs(f_c).max()):.6e})"
        )
        if not ev_err <= 1e-4:
            raise AssertionError(f"{tag} {name}: retained spectra card vs cpu {ev_err:.3e} > 1e-4")
        if not all_err <= 1e-4:
            raise AssertionError(f"{tag} {name}: spectrum card vs cpu {all_err:.3e} > 1e-4")
        if not f_err <= 3e-2:
            raise AssertionError(f"{tag} {name}: partial Fisher card vs cpu {f_err:.3e} > 3e-2")


def probe_phase():
    """The two Pallas probes' ports: one run of each (counted), then each
    against its plain version, with Tflop/s for the matmul."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import probe

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n = PROBE_N
    x = torch.arange(n * n, dtype=torch.float32, device=dev).reshape(n, n)
    a = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=dev)
    b = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=dev)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)

    backend.reset_launch_counts()
    outs = (probe.double(x), probe.mm(a, b), probe.mm(a16, b16))
    torch.cuda.synchronize()
    launches = launch_counts()
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError("probe outputs not finite")
    require_launched("probe", launches, PROBE_KERNELS)
    log(f"[probe] launches {launches}")

    res = {
        "probe_double": compare(
            f"probe_double ({n}x{n} f32, exact)", lambda: probe.double(x),
            lambda: probe.double_ref(x), rtol=0.0, tag="probe",
        )
    }
    flops = 2.0 * n**3
    for label, (p, q), rtol in (("f32", (a, b), 1e-5), ("bf16", (a16, b16), 1e-3)):
        rec = compare(
            f"probe_mm ({n}^3 {label} in, f32 out)", lambda: probe.mm(p, q),
            lambda: probe.mm_ref(p, q), rtol=rtol, tag="probe",
        )
        log(
            f"[probe] probe_mm {label}: kernel {flops / rec['ms'] / 1e9:.4f} Tflop/s, "
            f"plain {flops / rec['plain_ms'] / 1e9:.4f} Tflop/s"
        )
        if label == "f32":
            res["probe_mm"] = rec
    return launches, res


def profile_paths(tels):
    """torch.profiler over one pass of each product path's two phases: the
    device busy time (union of kernel and copy intervals), the idle share
    of the wall, and the largest kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from driftscan_tpu_torch.parallel import mstep, resident

    for tag, tel, ps_threshold in tels:
        blg, fig = units(tel)
        cl_s, cl_n, noisew = covariances(tel)
        ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
        band_lt = mstep.band_factor_table(
            iter(fisher_bands(tel)), out_dtype=np.float32, rank_rtol=1e-9
        )
        state = {}

        def btm():
            state["tables"] = resident.btm_resident(tel, blg, fig)

        def product():
            resident.product_all_resident(
                tel, *state["tables"], ls, lf, noisew, band_lt=band_lt,
                ps_threshold=ps_threshold,
            )

        for phase, fn in (("btm_resident", btm), ("product+fisher", product)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.time()
                fn()
                torch.cuda.synchronize()
                wall = time.time() - t
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            spans = sorted(
                (e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
            )
            busy, end = 0.0, -1.0
            for s, e in spans:
                if e > end:
                    busy += e - max(s, end)
                    end = e
            busy_s = busy * 1e-6
            log(
                f"[profile] {tag} {phase}: wall {wall:.4f} s, device busy {busy_s:.4f} s, "
                f"idle share {1.0 - busy_s / wall:.4f}, {len(spans)} device ops"
            )
            table = prof.key_averages().table(sort_by="device_time_total", row_limit=12)
            for line in table.splitlines():
                log(f"[profile]   {line}")


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, HERE)
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.telescope import cylinder

    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t = time.time()
    reports = backend.build_all()
    log(f"[build] CUDA kernels built in {time.time() - t:.2f} s")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {os.path.basename(src)}: {line.strip()}")

    tel = cylinder.UnpolarisedCylinderTelescope.from_config(BENCH_PARAMS, device="cuda")
    ptel = cylinder.PolarisedCylinderTelescope.from_config(POL_PARAMS, device="cuda")
    perf = kernel_phases(tel, ptel)
    counted = {}
    for tag, t_, ps in (("slice", tel, PS_THRESHOLD), ("pol", ptel, POL_PS_THRESHOLD)):
        launches, required = path_phase(tag, t_, ps)
        for name in required:
            counted[name] = counted.get(name, 0) + launches[name]
    launches, probe_perf = probe_phase()
    perf.update(probe_perf)
    for name in PROBE_KERNELS:
        counted[name] = launches[name]
    if "--profile" in sys.argv[1:]:
        profile_paths((("slice", tel, PS_THRESHOLD), ("pol", ptel, POL_PS_THRESHOLD)))

    missing = [k.name for k in backend.KERNELS.values() if k.name not in counted]
    if missing:
        raise AssertionError(f"kernels on no path of this run: {missing}")
    record = {
        "kernels": [
            {
                "name": k.name,
                "route": k.route,
                "source": k.source,
                "replaces": k.replaces,
                "launches": counted[k.name],
                **perf[k.name],
            }
            for k in backend.KERNELS.values()
        ]
    }
    print(json.dumps(record), flush=True)
    print(card_line(), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
