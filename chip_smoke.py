#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (driftscan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc) and Triton; imports no
JAX.  Phases, each printed on its own line(s); any failure raises, so the
script exits non-zero:

1. device — ``torch.cuda.is_available()`` or an error; the card's name
   and power limit as ``nvidia-smi`` reports them;
2. build — compiles every CUDA kernel of ``driftscan_tpu_torch/csrc``
   into ``driftscan_tpu_torch/_build/`` (the Triton kernel compiles at its
   first launch), prints the seconds;
3. kernels — each hand-written kernel against its plain PyTorch version
   on the same CUDA inputs (bench-scale shapes, numpy seed), with the
   tolerance asserted and the median time of both (CUDA events);
4. slice — the bench telescope (``bench.build_telescope``'s full config)
   through ``btm_resident`` and ``product_all_resident`` with the fused
   Fisher over all m, with every kernel's launch count > 0; then the
   first 8 m re-run on CPU tensors from the same BTM tables (the plain
   paths) and compared with the card's run.

The line before the last holds the nvidia-smi name and power limit; the
line before that one the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
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
PS_THRESHOLD = 0.1  # bench's KL retention cut for the Fisher
CPU_CHECK_M = 8


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


def compare(name, kernel_fn, plain_fn, rtol, reps=10):
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
        f"[kernels] {name}: max_abs_err {err:.6e} (max|plain| {scale:.6e}, "
        f"rel tol {rtol:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def kernel_phases(tel):
    """Each kernel against its plain version at the bench's shapes."""
    import torch

    from driftscan_tpu_torch.ops import fpencil, healpix, kernels, sht
    from driftscan_tpu_torch.parallel import mstep

    dev = tel.device
    rng = np.random.default_rng(SEED)
    res = {}

    def crandn(shape, dtype=np.complex64):
        return torch.as_tensor(
            (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype),
            device=dev,
        )

    # K1+K2: the bench telescope's nside-256 grid and its first 64 units there
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    lmax_u = tel.unit_lmax(blg, fig)
    ns = max(tel._nside_for(int(l)) for l in lmax_u)
    sel = np.nonzero([tel._nside_for(int(l)) == ns for l in lmax_u])[0][:64]
    tel._init_trans(ns)
    fx, par, ii, jj, uv3 = tel._gather_beams(blg[sel], fig[sel])
    pxarea = 4.0 * np.pi / (12 * ns**2)
    args = (tel._angpos_cart, tel._horizon, fx, par, ii, jj, uv3, pxarea)
    res["k1k2_beam_vis"] = compare(
        f"k1k2_beam_vis ({len(sel)} units x {tel._horizon.shape[0]} px, nside {ns})",
        lambda: kernels.bank_visibility_maps(*args),
        lambda: kernels.bank_visibility_maps_ref(*args),
        rtol=1e-5,
    )

    # K3+K5: phase-stage outputs (64, nm, nring) at the bench band limit
    g = healpix.ring_geometry(ns)
    lmax = tel.lmax
    F = crandn((64, lmax + 1, g.nring))
    G = crandn((64, lmax + 1, g.nring))
    cos_t = torch.as_tensor(g.cos_theta, device=dev)
    sin_t = torch.as_tensor(g.sin_theta, device=dev)
    res["k3k5_legendre_sht"] = compare(
        f"k3k5_legendre_sht (B 64, lmax {lmax}, nring {g.nring})",
        lambda: sht.legendre_contract(F, G, cos_t, sin_t, lmax, pxarea),
        lambda: sht.legendre_contract_ref(F, G, cos_t, sin_t, lmax, pxarea),
        rtol=1e-4,
        reps=5,
    )
    del F, G

    # K9: an m-batch of sky->SVD beams (8, F, S, 1, nl) and the signal factor
    nl = lmax + 1
    S = min(nl, 2 * tel.npairs)
    bsvd = crandn((8, tel.nfreq, S, 1, nl))
    ls = torch.as_tensor(
        rng.standard_normal((nl, 1, tel.nfreq, tel.nfreq)).astype(np.float32), device=dev
    )
    res["k9_signal_gram"] = compare(
        f"k9_signal_gram (M 8, n {tel.nfreq * S}, width {nl * tel.nfreq})",
        lambda: fpencil.signal_gram(bsvd, ls),
        lambda: fpencil.signal_gram_ref(bsvd, ls),
        rtol=1e-5,
    )

    # K13: k = n retained modes (the upper bound), 4 bands of width 8
    k = tel.nfreq * S
    v = crandn((8, k, tel.nfreq, S))
    bt = crandn((8, tel.nfreq, S, nl))
    nlp = -(-nl // 64) * 64
    blt = torch.as_tensor(
        rng.standard_normal((4, nlp, tel.nfreq, 8)).astype(np.float32), device=dev
    )
    res["k13_fisher_cov"] = compare(
        f"k13_fisher_cov (M 8, k {k}, nb 4, nlp {nlp}, Kb 8)",
        lambda: mstep.fisher_cov(v, bt, blt),
        lambda: mstep.fisher_cov_ref(v, bt, blt),
        rtol=1e-4,
    )
    return res


def slice_phase(tel):
    """The bench path on the card, its launch counts, and the CPU check."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.parallel import mstep, resident

    nm = tel.mmax + 1
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    cl_s, cl_n, noisew = covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    band_lt = mstep.band_factor_table(
        iter(fisher_bands(tel)), out_dtype=np.float32, rank_rtol=1e-9
    )
    log(
        f"[slice] lmax {tel.lmax} nm {nm} npairs {tel.npairs} nfreq {tel.nfreq} "
        f"units {len(blg)} ls {ls.shape} lf {lf.shape} band_lt {band_lt.shape}"
    )
    kw = dict(band_lt=band_lt, ps_threshold=PS_THRESHOLD)

    # warm-up: builds, Triton compile, cuFFT plans, first-call costs
    t = time.time()
    pos, neg = resident.btm_resident(tel, blg, fig)
    resident.product_all_resident(tel, pos, neg, ls, lf, noisew, max_m=8, **kw)
    torch.cuda.synchronize()
    log(f"[slice] warm-up {time.time() - t:.2f} s")
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
    launches = {k.name: k.launches for k in backend.KERNELS.values()}

    t_btm, t_prod = t1 - t0, t2 - t1
    retained = int((evals > PS_THRESHOLD).sum())
    log(
        f"[slice] t_btm {t_btm:.4f} s  t_product_fisher {t_prod:.4f} s  "
        f"m-modes/s {nm / (t_btm + t_prod):.4f}  retained modes "
        f"(ev > {PS_THRESHOLD}) {retained}  launches {launches}"
    )
    if not np.isfinite(evals).all():
        raise AssertionError("non-finite KL eigenvalues")
    if not np.isfinite(fisher).all():
        raise AssertionError("non-finite Fisher matrix")
    fscale = np.abs(fisher).max()
    if not np.abs(fisher - fisher.conj().T).max() <= 1e-4 * fscale:
        raise AssertionError("Fisher matrix not Hermitian")
    diag = np.diagonal(fisher)
    if not ((diag.real >= 0).all() and np.abs(diag.imag).max() <= 1e-4 * fscale):
        raise AssertionError(f"Fisher diagonal not real non-negative: {diag}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the slice")
    log(f"[slice] fisher diag {np.round(diag.real, 12).tolist()}")

    # the first CPU_CHECK_M m-modes again: on the card, then on CPU tensors
    mb = resident._auto_mbatch_n(
        tel.nfreq * min(tel.lmax + 1, 2 * tel.npairs),
        (tel.lmax + 1) * ls.shape[-1],
        resident._device_budget(tel.device),
        K_aug=(tel.lmax + 1) * lf.shape[-1],
    )
    ev_g, _, f_g = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, mbatch=mb, max_m=CPU_CHECK_M, **kw
    )
    t3 = time.time()
    ev_c, _, f_c = resident.product_all_resident(
        tel, pos.cpu(), neg.cpu(), ls, lf, noisew, mbatch=mb, max_m=CPU_CHECK_M, **kw
    )
    t_cpu = time.time() - t3
    kept = (ev_c > PS_THRESHOLD) | (ev_g > PS_THRESHOLD)
    top = np.maximum(ev_c.max(axis=1, keepdims=True), 1e-30)
    ev_err = float((np.abs(ev_g - ev_c) / top)[kept].max()) if kept.any() else 0.0
    f_err = float(np.abs(f_g - f_c).max() / max(np.abs(f_c).max(), 1e-300))
    log(
        f"[slice] cpu check m<{CPU_CHECK_M} (mbatch {mb}, cpu {t_cpu:.2f} s): "
        f"retained {int(kept.sum())} modes, max |ev_card - ev_cpu| / ev_top "
        f"{ev_err:.3e} (tol 1e-4), partial Fisher rel {f_err:.3e} (tol 3e-2)"
    )
    if not ev_err <= 1e-4:
        raise AssertionError(f"retained spectra card vs cpu: {ev_err:.3e} > 1e-4")
    if not f_err <= 3e-2:
        raise AssertionError(f"partial Fisher card vs cpu: {f_err:.3e} > 3e-2")
    return launches, t_btm, t_prod


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
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    tel = cylinder.UnpolarisedCylinderTelescope.from_config(BENCH_PARAMS, device="cuda")
    perf = kernel_phases(tel)
    launches, _, _ = slice_phase(tel)

    record = {
        "kernels": [
            {
                "name": k.name,
                "route": k.route,
                "source": k.source,
                "replaces": k.replaces,
                "launches": launches[k.name],
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
