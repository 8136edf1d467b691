#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (driftscan_tpu_torch) on one GPU.

    python3 chip_smoke.py             # the phases below
    python3 chip_smoke.py --profile   # then torch.profiler over each path,
                                      # the file pipeline and the timestream
                                      # pipeline

Needs one CUDA card and the CUDA toolkit (nvcc); imports no JAX.  Phases, each printed on its own line(s); any failure raises, so the
script exits non-zero:

1. device -- ``torch.cuda.is_available()`` or an error; the card's name
   and power limit as ``nvidia-smi`` reports them;
2. build -- compiles every CUDA source of ``driftscan_tpu_torch/csrc``
   into ``driftscan_tpu_torch/_build/``, one ``nvcc`` per source, all at
   once;
3. kernels -- each hand-written kernel of the product and timestream
   paths against its plain PyTorch version on the same CUDA inputs (at the
   shapes each of paths 4, 5, 5a, 7 and 8 gives it, numpy seed; K14 at B 8,
   lmax 229, 1023 rings, real and complex forms; K1+K2, K2-host and K14
   also launched twice, bitwise equal), with the tolerance asserted and
   the median time (CUDA events) of the kernel, the plain version and,
   where one PyTorch call computes the same function, that call
   (``library_ms``: ``torch.matmul(a, a.mH)`` of the pre-formed factor for
   K9 and K13; the JAX line's einsum for K15a; for K3+K5 and K14 one
   einsum a plane over the JAX package's lambda table, which is built once
   and timed apart); ``bound_ms`` is the larger of the bytes moved over
   3.35 TB/s and the operations over the peak of the units that run them
   (67 TFLOP/s float32 on the CUDA cores; 67 TFLOP/s float64, the card's
   float64 peak, on its tensor cores; 3xTF32 products -- the Grams', and
   K3+K5's in complex64 -- three tf32 products each, at 495 TFLOP/s; a
   Legendre recurrence, 5 float64 flops a lambda, on the 34 TFLOP/s
   float64 CUDA cores; work on different units may overlap, so the
   slowest unit's time is the bound), from the shapes; K15a and K3+K5 (also at the
   ``[dish]`` path's complex128 chunk) are launched twice and must repeat
   bit for bit, and K3+K5 in complex64 must lie no farther than its
   float32 plain version from the float64 truth on the same inputs;
4. slice -- the bench telescope (``bench.build_telescope``'s full config)
   through ``btm_resident`` and ``product_all_resident`` with the fused
   Fisher over all m;
5. pol -- the polarised telescope (``bench.build_pol_telescope``'s full
   config, npol 4) through the same entry points;
5a. dish, restricted, restricted pol -- the host-beam telescopes through
   the same entry points: DishArray as its JAX class defines it (4 x 4
   dishes, 1000-1200 MHz, double precision; ``num_freq`` 100 -> 8), the
   RestrictedCylinder (Gaussian mask) at bench's unpolarised parameters
   and the RestrictedPolarisedCylinder (box) at its polarised ones, single
   precision; each launches K2-host (scalar or Stokes) and no bank kernel,
   with the CPU check of paths 4 and 5 and a retention cut at the top
   decade of its spectrum; then the host-beam evaluation's share of a
   cold ``[dish]`` BTM, and ``[float64 gate]``: the restricted and the
   bench cylinder at ``single_precision: False``, one ``btm_resident``
   each, K2-host in float64 against the CPU;
6. products -- the file pipeline behind ``drift-makeproducts``: the bench
   unpolarised cylinder as a config dictionary through
   ``ProductManager.apply_config(...).generate()`` into a fresh temporary
   directory (beam and SVD files for all m, the KL and DoubleKL
   eigenfiles, PSExact's Fisher file), then the checks of
   :func:`products_phase`: every file opens, the Fisher from the files
   against path 4's fused Fisher, KL spectra against the port's CPU run on
   the same SVD beams, one m through the dense per-m transform, a second
   ``generate()`` that skips every stage; then the sandwich (K15a) and the
   Fisher trace (K15b) again at the sizes that run gave them
   (``[products kernels]``);
7. klinv -- an inverse KL filter ``klinv`` added to that product
   directory's config and generated (:func:`klinv_phase`: the dense per-m
   path, K15a's sky form);
8. timestream -- the pipeline behind ``drift-runpipeline`` on that product
   directory (:func:`timestream_phase`): an input sky made by
   ``synthesis_real`` (K14) at the nside of the BTM, then
   ``runpipeline.run_config``: two timestreams (noiseless; the telescope's
   noise from a seed) -> m-modes -> SVD and KL modes -> power spectra and
   cross power -> full, SVD and ``klinv`` maps; its checks (every file
   opens, m-modes against the direct projection, maps against the CPU
   synthesis of their alm, SVD/KL modes and power spectra against the CPU,
   a second run that rewrites only the full and SVD maps);
8a. example -- the repository's ``examples/disharray`` (DishArray,
   ``nosvd``, a KL filter with an inverse), its two YAML files copied
   unedited into a temporary directory and run there by
   ``makeproducts.run_config`` and ``runpipeline.run_config`` after the
   input map of the example's walkthrough script (K14, the port's store); every file
   opens, the NoSVD telescope basis, maps against the CPU synthesis of
   their alm; then ``[svd variants]``: TempSVD and FullSVD beam transfers
   of the same telescope, their singular values against the CPU's
   ``simple_svd`` (K18b, a library SVD) on the same beams;
9. probe -- the ports of the two Pallas probes of
   ``scratch/pallas_probe.py`` (o = 2 x; a 1024^3 matmul, float32 and
   bfloat16 inputs) against their plain versions, with Tflop/s;
10. svd cut -- the bench cylinder's SVD mode count from its BTM made by
   the kernels, with K3+K5's plain version in its place, and in float64
   (:func:`svd_cut_phase`; printed, not gated).

K1+K2, K2-host (each form), K14 and K15b (every shape) also give their
per-launch time: CUDA events around 50 back-to-back calls over the count
(``launch_ms``); K1+K2, K14 and K15b also the same over one CUDA graph of
50 calls (``graph_ms``: no host time between launches), K15b for its
one-stack form and its general form on a copy of the stack, which must
agree.

Each path (4-9) runs with every launch count set to 0 just before it and
read just after, and fails unless every kernel of that path launched; in
8 that window holds ``run_config`` alone, not the making of its input.
Paths 4 and 5 then re-run their first and last 8 m on CPU tensors from
the same BTM tables (the plain paths) and compare with the card, and time
K13 again at the k the path launched it with (``[slice kernels]``,
``[pol kernels]``: the largest and the median over the m-batches of the
batch's largest retained count); the kernels' record holds K13 at the
unpolarised path's largest k.

The line before the last holds the nvidia-smi name and power limit; the
line before that one the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import functools
import json
import os
import shutil
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
# The host-beam telescopes.  DishArray as its JAX class defines it (a 4 x 4
# grid of 3.5 m dishes, 1000-1200 MHz, double precision: npairs 24, lmax
# 494, mmax 349, nside 512) with one cut, num_freq 100 -> 8 edge channels
# (n <= 384 per m, the bench cylinder's product size); the restricted
# cylinders (a Gaussian and a box declination mask) at bench's parameters.
DISH_PARAMS = dict(num_freq=8, freq_mode="edge")
RESTRICTED_PARAMS = dict(BENCH_PARAMS, beam_type="gaussian")
RESTRICTED_POL_PARAMS = dict(POL_PARAMS, beam_type="box")
# the beam and visibility-map kernels: one of them serves each path
MAP_KERNELS = ("k1k2_beam_vis", "k1k2_stokes_vis", "k2_host_vis", "k2_host_stokes")
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
NBANDS = 4  # Fisher bands of every path: edges linspace(0.02, 0.25, 5)

# Published H100 SXM peaks (NVIDIA's H100 datasheet, dense): device
# memory, float32 outside the tensor cores, float64, tf32 and bfloat16 on
# the tensor cores, at the 700 W power limit.  The Gram kernels (K9, K13)
# take each float32 product as three tf32 products (3xTF32), as K3+K5 does
# in complex64.  Float64 work is bounded at the card's float64 peak, which
# its tensor cores give; the Legendre recurrences run on the float64 CUDA
# cores.  A recurrence step is 5 of their flops a lambda (legendre_rec.cuh:
# b u0, one fma, the product by a, the scale; its coefficients are tabled).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 67e12
F64_CUDA_CORE_FLOPS = 34e12
GRAM_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12
RECURRENCE_FLOPS = 5.0


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


def launch_ms(fn, n=50):
    """Per-launch time of fn() in ms: CUDA events around n back-to-back
    calls, over n, after one warm-up call (host time shows where a call's
    host path outlasts its kernel)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def graph_ms(fn, n=50):
    """Per-launch device time of fn() in ms: n calls captured into one CUDA
    graph, events around a replay, over n (no host time between launches)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / n


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_moved, ops):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (each input read once, each output written once) over the card's
    memory rate and its operations, ``ops`` = [(flops, peak rate of the
    units that run them), ...], one entry a kind of unit, each over its
    rate.  Different units can work at once, so the operations take the
    slowest unit's time."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max((flops / rate for flops, rate in ops), default=0.0) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, kernel_fn, plain_fn, rtol, work, library_fn=None, reps=10,
            tag="kernels", bitwise=False, per_launch=False, graph=False):
    """Kernel vs plain on the same inputs: max error, tolerance, times; the
    bound of ``work`` = (bytes, [(flops, rate), ...]) and the time of one
    PyTorch call computing the same function (``library_fn``), if any.
    With ``bitwise`` a second kernel call must repeat the first bit for
    bit.  ``per_launch`` adds launch_ms (and graph_ms with ``graph``) to
    the log."""
    import torch

    got = kernel_fn()
    if bitwise:
        again = kernel_fn()
        torch.cuda.synchronize()
        pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        log(f"[{tag}] {name}: two launches repeat bitwise")
        del again
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
    library_ms = None if library_fn is None else median_ms(library_fn, reps)
    bound_ms, bound_by = bound(*work)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    extra = ""
    if per_launch:
        per = launch_ms(kernel_fn)
        extra = f"; per launch {per:.4f} ms ({bound_ms / per:.4f} of bound)"
        if graph:
            extra += f", in a graph {graph_ms(kernel_fn):.4f} ms"
    log(
        f"[{tag}] {name}: max_abs_err {err:.6e} (max|plain| {scale:.6e}, "
        f"rel tol {rtol:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"library {lib} bound {bound_ms:.4f} ms ({bound_by}; "
        f"{bound_ms / ms:.4f} of bound){extra}"
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
        # bytes: the grid (cart, horizon) read once, the bank rows, unit
        # indices and baselines read once, the maps written once; the beams'
        # per-pixel arithmetic is not counted.  No single PyTorch call
        # computes the function (library none).
        if pol:
            maps = kernels.bank_stokes_maps(*args, npol=npol_t)
            keep("k1k2_stokes_vis", compare(
                f"k1k2_stokes_vis ({nu} units x {npol_t} Stokes x {npx} px, nside {ns}, "
                f"{fx.shape[0]} bank rows)",
                lambda: kernels.bank_stokes_maps(*args, npol=npol_t),
                lambda: kernels.bank_stokes_maps_ref(*args, npol=npol_t),
                rtol=1e-5, work=(nbytes(maps, *args[:7]), []), bitwise=True,
                per_launch=True, graph=True,
            ))
        else:
            maps = kernels.bank_visibility_maps(*args)
            keep("k1k2_beam_vis", compare(
                f"k1k2_beam_vis ({nu} units x {npx} px, nside {ns}, {fx.shape[0]} bank rows)",
                lambda: kernels.bank_visibility_maps(*args),
                lambda: kernels.bank_visibility_maps_ref(*args),
                rtol=1e-5, work=(nbytes(maps, *args[:7]), []), bitwise=True,
                per_launch=True, graph=True,
            ))
        del args, maps

        # K3+K5: phase-stage outputs (units x Stokes, nm, nring) of that
        # chunk's size at the nside's largest band limit
        g = healpix.ring_geometry(ns)
        B = nu * npol_t
        nm = sub_lmax + 1
        F = crandn((B, nm, g.nring))
        G = crandn((B, nm, g.nring))
        keep("k3k5_legendre_sht", k3k5_compare(F, G, g, sub_lmax, 1e-4, f"B {B}"))
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
        a = fpencil.beam_factor(bsvd, ls)
        width = a.shape[-1]
        keep("k9_signal_gram", compare(
            f"k9_signal_gram (M 8, n {n}, npol {npol}, width {width})",
            lambda: fpencil.signal_gram(bsvd, ls),
            lambda: fpencil.signal_gram_ref(bsvd, ls),
            rtol=1e-5, reps=10 if not pol else 3,
            work=(nbytes(bsvd, ls) + 8 * n * n * 8,
                  [(8.0 * 8 * n * (n + 1) / 2 * width, GRAM_FLOPS)]),
            library_fn=lambda: torch.matmul(a, a.mH),
        ))
        del bsvd, a

        # K13: k = n retained modes (the upper bound)
        keep("k13_fisher_cov", k13_compare(t, 8, n, rng))

        if not pol:
            # K15a and K15b at nkl = k = n, the file path's upper bound (the
            # products phase times them again at the sizes its run gave)
            keep("k15a_sandwich", sandwich_band_compare(t, n, rng))
            sandwich_band_compare(t, n, rng, dtype=torch.complex64)
            sandwich_sky_compare(t, rng)
            keep("k15b_fisher_trace", trace_compare(n, rng))
            trace_compare(n, rng, dtype=torch.complex64, M=8)
    keep("k14_legendre_synth", k14_compare(tel, rng))
    return res


def k14_compare(tel, rng, tag="kernels"):
    """K14 against its plain version at the timestream path's shape: B =
    nfreq x npol coefficients at the telescope's band limit, on the rings
    of the nside of its own BTM, complex128 in the real form (recorded) and
    the complex form, and the complex64 instantiation; then K3+K5 at the
    input map's shape (complex128, B 8).  Each form is launched twice and
    must repeat bit for bit.  Bound: the recurrence
    (``RECURRENCE_FLOPS`` a lambda) on the float64 CUDA cores beside 4
    flops a real x complex multiply-add per unit and block on the float64
    tensor cores, which take the product in both types; the coefficients
    read and the (B, nm, nring) outputs written once."""
    import torch

    from driftscan_tpu_torch.ops import healpix, sht

    dev = tel.device
    g = healpix.ring_geometry(tel._nside_for(tel.lmax))
    B, lmax = tel.nfreq * tel.num_pol_sky, tel.lmax
    nl = lmax + 1
    ct = torch.as_tensor(g.cos_theta, device=dev)
    st = torch.as_tensor(g.sin_theta, device=dev)
    nlam = nl * (nl + 1) // 2 * g.nring
    log(f"[{tag}] k14_legendre_synth: {nlam:.4e} lambda (B {B}, lmax {lmax}, nside {g.nside})")
    rec = None
    # complex128 last: the input map's K3+K5 below reuses its lambda table
    for dtype, rtol in ((torch.complex64, 1e-5), (torch.complex128, 1e-10)):
        pos = _crandn(rng, (B, nl, nl), dtype, dev)
        neg = _crandn(rng, (B, nl, lmax), dtype, dev)
        for form, nb in (("real", None), ("complex", neg)):
            k = 1 if nb is None else 2
            ops = [(RECURRENCE_FLOPS * nlam, F64_CUDA_CORE_FLOPS),
                   (4.0 * k * B * nlam, F64_FLOPS)]
            moved = nbytes(pos, ct, st, *(() if nb is None else (nb,)))
            moved += k * B * nl * g.nring * pos.element_size()
            r = compare(
                f"k14_legendre_synth ({form} form, B {B}, lmax {lmax}, nring {g.nring}, {dtype})",
                lambda: sht.legendre_synth(pos, nb, ct, st)[:k],
                lambda: sht.legendre_synth_ref(pos, nb, ct, st)[:k],
                rtol=rtol, reps=5, tag=tag, work=(moved, ops), bitwise=True,
                per_launch=True, graph=True,
                library_fn=synth_library(pos, nb, legendre_table_lib(nl, g.nside, lmax, dtype)),
            )
            if dtype == torch.complex128 and nb is None:
                rec = r
    F = _crandn(rng, (B, nl, g.nring), torch.complex128, dev)
    G = _crandn(rng, (B, nl, g.nring), torch.complex128, dev)
    k3k5_compare(F, G, g, lmax, 1e-10, f"input map: B {B}", tag=tag)
    return rec


@functools.lru_cache(maxsize=1)
def legendre_table_lib(nm, nside, lmax, dtype):
    """The JAX package's lambda table (ops/sht.py's ``legendre_table``, the
    plain versions' recurrence), (lmax + 1, nm, nring) on the card in the
    real type of ``dtype``: the operand of the library form of K3+K5 and
    K14.  Built once per key (the last one kept) and timed apart (host
    clock around a synchronised build), never inside ``library_ms``."""
    import torch

    from driftscan_tpu_torch.ops import healpix, sht

    g = healpix.ring_geometry(nside)
    ct = torch.as_tensor(g.cos_theta, device="cuda")
    st = torch.as_tensor(g.sin_theta, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    mvals = torch.arange(nm, device="cuda")
    logpref = torch.as_tensor(sht._log_lambda_mm_prefactor(lmax), device="cuda")
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    lam = sht.legendre_table(mvals, ct, st, lmax, logpref).to(rdt)
    torch.cuda.synchronize()
    log(f"[lambda table] {tuple(lam.shape)} {rdt} for the library calls: built in "
        f"{(time.time() - t0) * 1e3:.1f} ms (not in library_ms)")
    return lam


def _sign_m(nm, rdt, scale=1.0):
    """scale * (-1)^m for m < nm, on the card."""
    import torch

    m = torch.arange(nm, device="cuda")
    return (scale * torch.where(m % 2 == 0, 1.0, -1.0)).to(rdt)


def synth_library(pos, neg, lam):
    """K14 as one einsum a plane over the cached lambda table."""
    import torch

    pr = torch.view_as_real(pos)
    if neg is None:
        return lambda: torch.einsum("lmr,blmc->bmrc", lam, pr)
    shifted = torch.view_as_real(torch.cat([torch.zeros_like(pos[..., :1]), neg], dim=-1))
    sgn = _sign_m(lam.shape[1], lam.dtype)
    return lambda: (torch.einsum("lmr,blmc->bmrc", lam, pr),
                    torch.einsum("lmr,blmc,m->bmrc", lam, shifted, sgn))


def k3k5_compare(F, G, g, lmax, rtol, what, tag="kernels", reps=5):
    """K3+K5 against its plain version on phase-stage outputs F, G (B, nm,
    nring) at the rings of ``g``, with a bitwise repeat; library: one
    einsum a plane over the cached lambda table (the JAX package's form).
    Bound: the recurrence (``RECURRENCE_FLOPS`` a lambda) on the float64
    CUDA cores beside 8 B flops a lambda for the two planes' products, on
    the tensor cores
    (float64; complex64 as 3xTF32 at 495 / 3 TFLOP/s, as the Grams are
    counted); the CUDA-core bound (the products alone at 67 TFLOP/s
    float32, no recurrence) is printed beside it.  In complex64 the kernel
    and the plain version are also held against the float64 truth, and
    the kernel must be no farther from it."""
    import torch

    from driftscan_tpu_torch.ops import sht

    B, nm, nring = F.shape
    ct = torch.as_tensor(g.cos_theta, device=F.device)
    st = torch.as_tensor(g.sin_theta, device=F.device)
    area = 4.0 * np.pi / g.npix
    nlam = sum(lmax + 1 - m for m in range(nm)) * nring
    c128 = F.dtype == torch.complex128
    ops = [(RECURRENCE_FLOPS * nlam, F64_CUDA_CORE_FLOPS),
           (8.0 * B * nlam, F64_FLOPS if c128 else GRAM_FLOPS)]
    moved = nbytes(F, G, ct, st) + 2 * B * (lmax + 1) * nm * F.element_size()
    if not c128:
        cuda_core_ms = bound(moved, [(8.0 * B * nlam, F32_FLOPS)])[0]
        log(f"[{tag}] k3k5_legendre_sht ({what}): the CUDA-core bound (the products alone "
            f"at 67 TFLOP/s float32, no recurrence) {cuda_core_ms:.4f} ms")
    lam = legendre_table_lib(nm, g.nside, lmax, F.dtype)
    fr, gr = torch.view_as_real(F), torch.view_as_real(G)
    w_pos = torch.full((nm,), area, dtype=lam.dtype, device="cuda")
    w_neg = _sign_m(nm, lam.dtype, area)

    def library():
        return (torch.einsum("lmr,bmrc,m->blmc", lam, fr, w_pos),
                torch.einsum("lmr,bmrc,m->blmc", lam, gr, w_neg))

    rec = compare(
        f"k3k5_legendre_sht ({what}, lmax {lmax}, nring {nring}, {F.dtype})",
        lambda: sht.legendre_contract(F, G, ct, st, lmax, area),
        lambda: sht.legendre_contract_ref(F, G, ct, st, lmax, area),
        rtol=rtol, reps=reps, tag=tag, work=(moved, ops), library_fn=library, bitwise=True,
    )
    del lam
    if not c128:
        # the plain version rounds lambda and its sums to float32 too: the
        # kernel and it against the float64 truth on the same inputs, and
        # the kernel no farther from it
        wide = [x.to(torch.complex128) for x in (F, G)]
        truth = sht.legendre_contract_ref(*wide, ct, st, lmax, area)
        del wide
        errs = []
        for fn in (sht.legendre_contract, sht.legendre_contract_ref):
            out = fn(F, G, ct, st, lmax, area)
            errs.append(max(float((o.to(torch.complex128) - t).abs().max())
                            for o, t in zip(out, truth)))
            del out
        log(f"[{tag}] k3k5_legendre_sht ({what}): max error against the float64 truth: kernel "
            f"{errs[0]:.6e}, plain {errs[1]:.6e}")
        if not errs[0] <= errs[1]:
            raise AssertionError(f"k3k5_legendre_sht ({what}): the kernel is farther from the "
                                 f"float64 truth ({errs[0]:.3e}) than the plain version "
                                 f"({errs[1]:.3e})")
        del truth
    return rec


def k3k5_dish_compare(dtel, rng):
    """K3+K5 at the ``[dish]`` path's first BTM chunk: complex128, its
    largest band limit (494) on the rings of nside 512."""
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import healpix

    ns, blc, _, sub_lmax = first_chunk(dtel)
    g = healpix.ring_geometry(ns)
    B = len(blc) * (dtel._npol_transform if dtel.num_pol_sky > 1 else 1)
    nm = sub_lmax + 1
    dtype = backend.complex_dtype(dtel.real_dtype)
    F = _crandn(rng, (B, nm, g.nring), dtype, dtel.device)
    G = _crandn(rng, (B, nm, g.nring), dtype, dtel.device)
    k3k5_compare(F, G, g, sub_lmax, 1e-10, f"[dish] chunk: B {B}", tag="host kernels", reps=3)
    legendre_table_lib.cache_clear()  # its float64 table is ~4 GB


def k13_compare(t, M, k, rng, tag="kernels"):
    """K13 against its plain version for an m-batch of M items with k
    retained modes, at ``t``'s path shapes (4 bands of rank <= F, the l
    axis padded to 64), with its library call and bound."""
    import torch

    from driftscan_tpu_torch.parallel import mstep, resident

    dev = t.device
    nl = t.lmax + 1
    n = resident.pencil_size(t)
    F = t.nfreq
    S = n // F

    def crandn(shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.as_tensor(z.astype(np.complex64), device=dev)

    v = crandn((M, k, F, S))
    bt = crandn((M, F, S, nl))
    nlp = -(-nl // 64) * 64
    nb, Kb = 4, F
    blt = torch.as_tensor(rng.standard_normal((nb, nlp, F, Kb)).astype(np.float32), device=dev)
    y = mstep.fisher_factor(v, bt, blt)
    # G = V B_T (8 flops a complex multiply-add) and Y_b = G L_b (4 a
    # complex x real one) on the CUDA cores, the Hermitian half of
    # C_b = Y_b Y_b^H over l < nl as 3xTF32
    ops = [(8.0 * M * k * F * nl * S + 4.0 * M * nb * k * nl * Kb * F, F32_FLOPS),
           (8.0 * M * nb * k * (k + 1) / 2 * nl * Kb, GRAM_FLOPS)]
    return compare(
        f"k13_fisher_cov (M {M}, k {k}, nb {nb}, nlp {nlp}, Kb {Kb})",
        lambda: mstep.fisher_cov(v, bt, blt),
        lambda: mstep.fisher_cov_ref(v, bt, blt),
        rtol=1e-4, tag=tag,
        work=(nbytes(v, bt, blt) + M * nb * k * k * 8, ops),
        library_fn=lambda: torch.matmul(y, y.mH),
    )


def _crandn(rng, shape, dtype, dev):
    import torch

    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor(z, device=dev).to(dtype)


def _rate(dtype):
    import torch

    return F64_FLOPS if dtype == torch.complex128 else F32_FLOPS


def sandwich_band_compare(t, nkl, rng, dtype=None, tag="kernels"):
    """K15a in its band form (PSExact's per-m projection of every band into
    the KL basis): g (nkl, F, nl), NBANDS spectra (nl, F, F); against the
    plain version, with the JAX line's one einsum as the library call."""
    import torch

    from driftscan_tpu_torch.ops import projections

    dtype = dtype or torch.complex128
    F, nl = t.nfreq, t.lmax + 1
    g = _crandn(rng, (nkl, F, nl), dtype, t.device)
    cl = torch.as_tensor(rng.standard_normal((NBANDS, nl, F, F)), device=t.device).to(
        g.real.dtype
    )
    clc = cl.to(dtype)
    flops = NBANDS * nl * (4.0 * nkl * F * F + 8.0 * nkl * nkl * F)
    return compare(
        f"k15a_sandwich band form (nkl {nkl}, F {F}, nl {nl}, nb {NBANDS}, {dtype})",
        lambda: projections.band_covariance_projection(g, cl),
        lambda: projections.sandwich_ref(g[None], g[None], cl),
        rtol=1e-12 if dtype == torch.complex128 else 1e-5, tag=tag, bitwise=True,
        work=(nbytes(g, cl) + NBANDS * nkl * nkl * g.element_size(), [(flops, _rate(dtype))]),
        library_fn=lambda: torch.einsum("kfl,blfh,qhl->bkq", g, clc, g.conj()),
    )


def sandwich_sky_compare(t, rng, tag="kernels"):
    """K15a in its sky form (a sky covariance into the SVD basis, the dense
    per-m KL path): one batch item per frequency pair, X = B[f], Y = B[g]
    (S, npol 1, nl) complex128."""
    import torch

    from driftscan_tpu_torch.ops import projections
    from driftscan_tpu_torch.parallel import resident

    F, nl = t.nfreq, t.lmax + 1
    S = resident.pencil_size(t) // F
    beam = _crandn(rng, (F, S, 1, nl), torch.complex128, t.device)
    cl = torch.as_tensor(rng.standard_normal((1, 1, nl, F, F)), device=t.device)
    c = cl.permute(3, 4, 2, 0, 1).reshape(F * F, nl, 1, 1).contiguous()
    # the sky form's own operand indices, on the card (sky_covariance_projection's)
    fi, gi, ci = projections.sky_pair_index(1, F, t.device)
    clc = cl.to(beam.dtype)
    lib = lambda: torch.einsum("fapl,pqlfg,gbql->fagb", beam, clc, beam.conj())
    got = projections.sky_covariance_projection(beam, cl)
    if not float((got - lib()).abs().max()) <= 1e-12 * float(got.abs().max()):
        raise AssertionError("sky_covariance_projection disagrees with its einsum")
    flops = F * F * nl * (4.0 * S + 8.0 * S * S)
    return compare(
        f"k15a_sandwich sky form ({F * F} pairs, S {S}, npol 1, nl {nl}, complex128)",
        lambda: projections.sandwich(beam, beam, c, fi, gi, ci),
        lambda: projections.sandwich_ref(beam, beam, c, fi, gi, ci),
        rtol=1e-12, tag=tag, bitwise=True,
        work=(nbytes(beam, c) + F * F * S * S * 16, [(flops, F64_FLOPS)]),
        library_fn=lib,
    )


def trace_compare(k, rng, dtype=None, M=None, tag="kernels"):
    """K15b at NBANDS bands of k modes (an m-batch of M where the fused
    Fisher step calls it): against the plain version; the library call is
    the JAX program's, a scale and one matmul of the flattened stacks."""
    import torch

    from driftscan_tpu_torch.ops import projections

    dtype = dtype or torch.complex128
    dev = torch.device("cuda")
    lead = () if M is None else (M,)
    c = _crandn(rng, lead + (NBANDS, k, k), dtype, dev)
    w = torch.as_tensor(rng.random(lead + (k,)), device=dev).to(c.real.dtype)

    def library():
        d = c * (w[..., None, :, None] * w[..., None, None, :])
        flat = lead + (NBANDS, k * k)
        return d.reshape(flat) @ c.transpose(-1, -2).reshape(flat).transpose(-1, -2)

    # one pass over the stack (C_a and C_b are the same tensor on every
    # path); per term a complex product, the weight and the sum, in float64
    nitem = M or 1
    name = f"k15b_fisher_trace (M {M}, nb {NBANDS}, k {k}, {dtype})"
    # float64 sums whatever the input type: 1e-12 for complex64 too
    rtol = 1e-12
    rec = compare(
        name,
        lambda: projections.fisher_trace(c, c, w),
        lambda: projections.fisher_trace_ref(c, c, w),
        rtol=rtol, tag=tag,
        work=(nbytes(c, w) + nitem * NBANDS * NBANDS * 16,
              [(10.0 * nitem * NBANDS * NBANDS * k * k, F64_FLOPS)]),
        library_fn=library, bitwise=True, per_launch=True, graph=True,
    )
    # the general form (C_b another tensor, as PSExact's cross-chunk trace
    # passes it) on the same values, against the plain version, and both
    # forms' per-launch times in a graph, one stack, general, general, one
    # stack
    cb = c.clone()
    ref = projections.fisher_trace_ref(c, c, w)
    err = float((projections.fisher_trace(c, cb, w) - ref).abs().max())
    if not err <= rtol * float(ref.abs().max()):
        raise AssertionError(f"{name}: general form off by {err:.3e}")
    forms = (lambda: projections.fisher_trace(c, c, w),
             lambda: projections.fisher_trace(c, cb, w))
    times = [graph_ms(forms[f]) for f in (0, 1, 1, 0)]
    log(f"[{tag}] {name} general form (C_b a copy): max_abs_err {err:.6e}; in a graph "
        f"one stack {times[0]:.4f}, {times[3]:.4f} ms, general {times[1]:.4f}, "
        f"{times[2]:.4f} ms ({card_line()})")
    return rec


def path_k13(tag, tel, evals, ps_threshold, mb, launches):
    """K13 at the k the product path launched it with: per m-batch, the
    batch's largest retained count (``resident.fisher_k``, the path's own
    rule), one k per launch the path counted; timed at the largest and the
    median of the launched k."""
    from driftscan_tpu_torch.parallel import resident

    ks = [resident.fisher_k(evals[s : s + mb], ps_threshold) for s in range(0, len(evals), mb)]
    ks = sorted(k for k in ks if k)
    log(f"[{tag}] K13 launches at k {ks}")
    if len(ks) != launches:
        raise AssertionError(f"{tag}: {len(ks)} K13 shapes for {launches} launches")
    rng = np.random.default_rng(SEED + 1)
    import torch

    big = k13_compare(tel, mb, ks[-1], rng, tag=f"{tag} kernels")
    k13_compare(tel, mb, ks[len(ks) // 2], rng, tag=f"{tag} kernels")
    # the Fisher step's trace over K13's covariances, at the same k
    trace_compare(ks[-1], rng, dtype=torch.complex64, M=mb, tag=f"{tag} kernels")
    return big


def launch_counts():
    """{kernel name: launches since the last reset}."""
    from driftscan_tpu_torch import backend

    return {k.name: k.launches for k in backend.KERNELS.values()}


def require_launched(tag, launches, names):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the {tag} path")


def map_kernel(tel):
    """The beam and map kernel of ``tel``'s BTM: bank rows (K1+K2) or
    host-evaluated beams (K2-host), scalar or Stokes."""
    pol = tel.num_pol_sky > 1
    if tel._bank_beams_apply():
        return "k1k2_stokes_vis" if pol else "k1k2_beam_vis"
    return "k2_host_stokes" if pol else "k2_host_vis"


def require_map_kernel(tag, tel, launches):
    """The path launched its own map kernel and none of the other three."""
    mine = map_kernel(tel)
    require_launched(tag, launches, [mine])
    others = {k: launches[k] for k in MAP_KERNELS if k != mine and launches[k]}
    if others:
        raise AssertionError(f"{tag}: {mine} path also launched {others}")


def top_decade(top):
    """The retention cut of a new path: PS_THRESHOLD, or the top decade of
    its spectrum where that tops below ten times the cut (as
    POL_PS_THRESHOLD keeps the polarised cylinder's)."""
    return min(PS_THRESHOLD, 10.0 ** np.floor(np.log10(top)))


def path_kernels(tel, ls_width):
    """The hand kernels a product path launches: beams + maps, the SHT,
    the compact signal Gram where the product step takes it
    (``mstep.uses_compact_signal``), the Fisher covariances and their
    weighted trace."""
    from driftscan_tpu_torch.parallel import mstep, resident

    n = resident.pencil_size(tel)
    width = (tel.lmax + 1) * ls_width
    names = [map_kernel(tel), "k3k5_legendre_sht", "k13_fisher_cov", "k15b_fisher_trace"]
    if mstep.uses_compact_signal(n, width):
        names.append("k9_signal_gram")
    return names, n, width


def path_phase(tag, tel, ps_threshold=None):
    """One product path on the card, its launch counts, and the CPU check.
    Without ``ps_threshold`` the cut is the top decade of the warm-up's
    spectrum (:func:`top_decade`)."""
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
    # m-bucketing (ROADMAP item 6.1) is not ported: every path runs the
    # full-range m-batches (what "auto" picks at bench's two cylinders)
    kw = dict(band_lt=band_lt, ps_threshold=ps_threshold or PS_THRESHOLD, bucket=False)

    # warm-up: builds, cuFFT plans, first-call costs
    t = time.time()
    pos, neg = resident.btm_resident(tel, blg, fig)
    ev_w, nmo_w, _ = resident.product_all_resident(tel, pos, neg, ls, lf, noisew, max_m=8, **kw)
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up {time.time() - t:.2f} s")
    tables_w = (pos, neg)
    del pos, neg
    if ps_threshold is None:
        ps_threshold = top_decade(float(np.max(ev_w)))
        kw["ps_threshold"] = ps_threshold
        log(f"[{tag}] retention cut {ps_threshold:g} (warm-up top ev {float(np.max(ev_w)):.6e})")

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
    # the warm-up's tables and first m repeat: the BTM bit for bit (the
    # solid angles are summed in a fixed order), and the product step's
    # spectra and SVD mode counts reported as they came
    if not all(torch.equal(a, b) for a, b in zip((pos, neg), tables_w)):
        raise AssertionError(f"{tag}: two btm_resident runs on the same telescope differ")
    del tables_w
    nw = len(ev_w)
    log(
        f"[{tag}] repeat: btm_resident tables bitwise equal; first {nw} m warm-up vs timed: "
        f"spectra {'bitwise equal' if np.array_equal(ev_w, evals[:nw]) else 'differ'} "
        f"(max {float(np.abs(ev_w - evals[:nw]).max()):.3e}), svd modes "
        f"{int(nmo_w.sum())} vs {int(nmodes[:nw].sum())}"
    )
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
    require_map_kernel(tag, tel, launches)
    log(f"[{tag}] fisher diag {np.round(diag.real, 12).tolist()}")

    cpu_check(tag, tel, pos, neg, ls, lf, noisew, band_lt, ps_threshold)
    mb = resident.auto_mbatch(tel, ls.shape[-1], lf.shape[-1], tel.device)
    k13_rec = path_k13(tag, tel, evals, ps_threshold, mb, launches["k13_fisher_cov"])
    run = {"evals": evals, "fisher": fisher, "rate": nm / (t_btm + t_prod),
           "t_btm": t_btm, "ps_threshold": ps_threshold}
    return launches, required, k13_rec, run


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


def products_config(outdir):
    """The bench unpolarised cylinder as a ``drift-makeproducts`` config:
    the KL filter and the two-stage DoubleKL, and PSExact on the KL filter
    with the four polar bands of :func:`fisher_bands`."""
    return {
        "config": {"beamtransfers": True, "kltransform": True, "psfisher": True,
                   "output_directory": outdir},
        "telescope": dict(type="UnpolarisedCylinder", **BENCH_PARAMS),
        "kltransform": [
            {"type": "KLTransform", "name": "kl", "threshold": PS_THRESHOLD},
            {"type": "DoubleKL", "name": "dk"},
        ],
        "psfisher": [
            {"type": "Full", "name": "ps", "klname": "kl", "threshold": PS_THRESHOLD,
             "bandtype": "polar", "num_theta": 1, "unit_bands": True,
             "k_bands": [{"spacing": "linear", "start": 0.02, "stop": 0.25,
                          "num": NBANDS + 1}]},
        ],
    }


def products_files(m):
    """Every product file of a finished run of :func:`products_config`."""
    bt, kl, dk = m.beamtransfer, m.kltransforms["kl"], m.kltransforms["dk"]
    files = [bt.directory + "/svdspectrum.hdf5", kl.evdir + "/evals.hdf5",
             dk.evdir + "/evals.hdf5", m.psestimators["ps"].psdir + "/fisher.hdf5"]
    for mi in range(m.telescope.mmax + 1):
        files += [bt._mfile(mi), bt._svdfile(mi), kl._evfile % mi, dk._evfile % mi]
    return files


def products_phase(slice_run, outdir):
    """The file pipeline on the card, into ``outdir``, and its checks;
    ``slice_run`` holds the resident path's spectra, Fisher matrix and rate
    for the same telescope, bands and threshold.  Returns (launches, [nkl
    per m])."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.core import manager
    from driftscan_tpu_torch.ops import projections, truncate
    from driftscan_tpu_torch.util import store

    tag = "products"
    conf = products_config(outdir)
    backend.reset_launch_counts()
    t = time.time()
    m = manager.ProductManager().apply_config(conf)
    m.generate()
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = launch_counts()

    tel, bt = m.telescope, m.beamtransfer
    kl, dk, ps = m.kltransforms["kl"], m.kltransforms["dk"], m.psestimators["ps"]
    nm, n = tel.mmax + 1, bt.ndofmax
    tm = m.timings
    t_file = tm["beams"] + tm["kl.kl"] + tm["ps.ps"]
    log(
        f"[{tag}] store {store.BACKEND} (truncation codec {truncate.codec()}, "
        f"file codec {store.codec(bt.compression)})  device {m.device}  wall {wall:.4f} s  "
        f"t_beams {tm['beams']:.4f} s (compute {tm['beams.btm_compute']:.4f}, "
        f"write {tm['beams.btm_write']:.4f})  t_svd {tm['beams.svd']:.4f} s  "
        f"t_kl {tm['kl.kl']:.4f} s  t_doublekl {tm['kl.dk']:.4f} s  "
        f"t_ps {tm['ps.ps']:.4f} s"
    )
    log(
        f"[{tag}] m-modes/s of the file path (beams + SVD + KL + PSExact, "
        f"{nm} m) {nm / t_file:.4f}; with DoubleKL {nm / (t_file + tm['kl.dk']):.4f}; "
        f"the resident path's {slice_run['rate']:.4f}; m that took the dense "
        f"fallback: {len(kl.dense_fallback_m)} {kl.dense_fallback_m}; launches {launches}"
    )

    # every product file exists and opens
    files = products_files(m)
    bad = [f for f in files if not store.readable(f)]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} product files missing or unreadable: {bad[:4]}")
    size = sum(
        os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(outdir) for f in fs
    )
    log(f"[{tag}] {len(files)} product files open ({size / 2**20:.1f} MiB on disk)")
    require_launched(tag, launches, ["k1k2_beam_vis", "k3k5_legendre_sht",
                                     "k9_signal_gram", "k15a_sandwich",
                                     "k15b_fisher_trace"])

    # spectra and Fisher: finite, symmetric, positive diagonal
    ev_file = kl.evals_all()
    with store.File(dk.evdir + "/evals.hdf5", "r") as f:
        dk_ev, dk_fev = f["evals"][:], f["f_evals"][:]
    with store.File(ps.psdir + "/fisher.hdf5", "r") as f:
        fisher = f["fisher"][:]
        errors = f["errors"][:]
        bandtype = f.attrs["bandtype"]
    for name, arr in (("KL evals", ev_file), ("DoubleKL evals", dk_ev),
                      ("DoubleKL f_evals", dk_fev), ("svd spectrum", bt.svd_all()),
                      ("Fisher", fisher), ("errors", errors)):
        if not np.isfinite(arr).all():
            raise AssertionError(f"{tag}: {name} not finite")
    if ev_file.shape != (nm, n) or fisher.shape != (NBANDS, NBANDS):
        raise AssertionError(f"{tag}: shapes {ev_file.shape} {fisher.shape}")
    fscale = np.abs(fisher).max()
    if not (np.abs(fisher - fisher.T).max() <= 1e-10 * fscale and (np.diag(fisher) > 0).all()):
        raise AssertionError(f"{tag}: Fisher not symmetric with a positive diagonal: {fisher}")
    nkl = []
    for mi in range(nm):
        with store.File(kl._evfile % mi, "r") as f:
            nkl.append(int(f.attrs["num_modes"]))
            if int(f.attrs["m"]) != mi:
                raise AssertionError(f"{tag}: ev file of m {mi} holds m {f.attrs['m']}")
    log(
        f"[{tag}] bandtype {bandtype!r}  KL modes >= {PS_THRESHOLD:g}: {sum(nkl)} "
        f"(largest per m {max(nkl)})  top ev {ev_file.max():.6e}  DoubleKL kept "
        f"{int((dk_ev > 0).sum())} modes (top S/F {dk_fev.max():.6e})  fisher diag "
        f"{np.diag(fisher).tolist()}  errors {errors.tolist()}"
    )

    # PSExact's Fisher from the files against the fused resident Fisher
    f_res = np.asarray(slice_run["fisher"]).real
    f_err = float(np.abs(fisher - f_res).max() / np.abs(f_res).max())
    log(f"[{tag}] Fisher, files vs resident path: rel {f_err:.3e} of max|F| (tol 3e-2)")
    if not f_err <= 3e-2:
        raise AssertionError(f"{tag}: file Fisher vs resident Fisher {f_err:.3e} > 3e-2")

    # the file spectra against the resident path's (which solves the
    # pencil without the foreground regulariser): printed, not gated
    ev_res = np.sort(np.asarray(slice_run["evals"]), axis=1)
    kept = ev_file > PS_THRESHOLD
    top = np.maximum(ev_file.max(axis=1, keepdims=True), 1e-30)
    rel = np.abs(ev_file - ev_res[:, -n:]) / top
    log(
        f"[{tag}] retained KL spectra, files vs resident path: max "
        f"{float(rel[kept].max()) if kept.any() else 0.0:.3e} of each m's top"
    )

    # KL spectra of the first and last m against the CPU run of the
    # same pencil on the same SVD beams
    ls, lf = kl._cl_factors()
    for name, lo, hi in (("first", 0, min(CPU_CHECK_M, nm)),
                         ("last", max(nm - CPU_CHECK_M, 0), nm)):
        bsvd, idx_list = kl._load_bsvd_batch(list(range(lo, hi)))
        t = time.time()
        ev_c, _ = projections.kl_factored_batched(
            bsvd.cpu(), ls.cpu(), lf.cpu(), nc=1.0,
            fg_reg_rel=kl._foreground_regulariser,
        )
        t_cpu = time.time() - t
        ev_c = ev_c.numpy()
        err = 0.0
        for i, idx in enumerate(idx_list):
            ndof = len(idx)
            if ndof:
                a, b = ev_file[lo + i][n - ndof:], ev_c[i][n - ndof:]
                err = max(err, float(np.abs(a - b).max() / max(b.max(), 1e-30)))
        log(
            f"[{tag}] cpu check {name} m {lo}..{hi - 1} (cpu {t_cpu:.2f} s): max "
            f"|ev_file - ev_cpu| / ev_top {err:.3e} (tol 1e-4)"
        )
        if not err <= 1e-4:
            raise AssertionError(f"{tag} {name}: KL spectra card vs cpu {err:.3e} > 1e-4")

    # a second generate() on the same directory skips every stage
    stamp = {f: os.path.getmtime(f) for f in files if "svdspectrum" not in f}
    backend.reset_launch_counts()
    t = time.time()
    m2 = manager.ProductManager().apply_config(conf)
    m2.generate()
    torch.cuda.synchronize()
    t_again = time.time() - t
    again = launch_counts()
    touched = [f for f, at in stamp.items() if os.path.getmtime(f) != at]
    log(f"[{tag}] second generate(): {t_again:.2f} s, launches {sum(again.values())}, "
        f"files rewritten {len(touched)}")
    if any(again.values()) or touched:
        raise AssertionError(f"{tag}: the second generate() did not skip: {again} {touched[:4]}")

    # one m through the dense per-m transform (the sandwich's sky form,
    # then the whitened dense eigensolve): the card against the same
    # transform on the CPU from the same files, and against the m's
    # factored spectrum, on the retained band.  The dense noise
    # covariance has a condition number of ~3e11 at this telescope, so
    # its whitened spectrum is defined to ~cond * eps = 7e-5 of the top
    # eigenvalue whatever computes it: both gates are 1e-3, and the
    # figures are printed beside the KL tier's 1e-4.
    mi = int(np.argmax(nkl))
    with store.File(kl._evfile % mi, "r") as f:
        ev_fact = f["evals_full"][:]
    backend.reset_launch_counts()
    t = time.time()
    kl.transform_save(mi)
    t_dense = time.time() - t
    dense_launches = launch_counts()["k15a_sandwich"]
    with store.File(kl._evfile % mi, "r") as f:
        ev_dense = f["evals_full"][:]
        n_dense = int(f.attrs["num_modes"])
    kl_cpu = manager.ProductManager(device="cpu").apply_config(conf).kltransforms["kl"]
    ev_dense_cpu = kl_cpu._transform_m(mi)[0]
    band = (ev_fact > PS_THRESHOLD) | (ev_dense > PS_THRESHOLD)
    c_err = float(np.abs(ev_dense - ev_dense_cpu)[band].max() / ev_dense_cpu.max())
    d_err = float(np.abs(ev_fact - ev_dense)[band].max() / ev_dense.max())
    log(
        f"[{tag}] dense path, m {mi} ({t_dense:.2f} s, {dense_launches} sandwich "
        f"launches): {n_dense} modes retained (factored {nkl[mi]}), retained band "
        f"|ev_card - ev_cpu| / ev_top {c_err:.3e}, |ev_dense - ev_factored| / "
        f"ev_top {d_err:.3e} (tol 1e-3 each; KL tier 1e-4)"
    )
    if not (c_err <= 1e-3 and dense_launches > 0):
        raise AssertionError(f"{tag}: dense path m {mi}, card vs cpu {c_err:.3e} > 1e-3")
    if not (d_err <= 1e-3 and abs(n_dense - nkl[mi]) <= 1):
        raise AssertionError(
            f"{tag}: dense path m {mi} vs factored: {d_err:.3e}, {n_dense} vs {nkl[mi]} modes"
        )
    return launches, nkl


def products_kernels(tel, nkl):
    """K15a (band form) and K15b again at the sizes the products run gave
    them: its largest and its median count of retained KL modes per m."""
    sizes = sorted(k for k in nkl if k)
    log(f"[products] {len(sizes)} m with retained modes; nkl {sizes}")
    rng = np.random.default_rng(SEED + 2)
    recs = {}
    for k in (sizes[-1], sizes[len(sizes) // 2]):
        a = sandwich_band_compare(tel, k, rng, tag="products kernels")
        b = trace_compare(k, rng, tag="products kernels")
        recs.setdefault("k15a_sandwich", a)
        recs.setdefault("k15b_fisher_trace", b)
    return recs


def write_yaml(conf, path):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return path


def timestream_config(outdir, tsdir, mapfile, nside):
    """The ``drift-runpipeline`` config of ``[timestream]`` on the products
    in ``outdir``: ts1 noiseless from ``mapfile``, ts2 with the telescope's
    noise from a seed; every stage, the KL modes of both filters, PSExact on
    ``kl``, maps of the inverse filter ``klinv`` at ``nside``, and the
    cross power of the two timestreams."""
    sim = {"product_directory": outdir, "maps": [mapfile]}
    return {
        "config": {
            "product_directory": outdir, "klmodes": ["kl", "klinv"],
            "powerspectra": [{"psname": "ps", "klname": "kl"}], "klmaps": ["klinv"],
            "nside": nside,
        },
        "timestreams": [
            {"name": "ts1", "directory": f"{tsdir}/ts1", "simulate": dict(sim, ndays=0)},
            {"name": "ts2", "directory": f"{tsdir}/ts2", "simulate": dict(sim, seed=SEED)},
        ],
        "crosspower": [{"psname": "ps", "klname": "kl", "timestreams": ["ts1", "ts2"],
                        "psfile": f"{tsdir}/xps.hdf5"}],
    }


def timestream_files(pm, tsdir):
    """Every file the pipeline of :func:`timestream_config` leaves."""
    files = [os.path.join(tsdir, "xps.hdf5")]
    for ts in pm.timestreams.values():
        nm, out = ts.telescope.mmax + 1, ts.output_directory
        files += [ts._ffile(fi) for fi in range(ts.telescope.nfreq)]
        files += [ts._mfile(mi) for mi in range(nm)] + [ts._svdfile(mi) for mi in range(nm)]
        for klname in ("kl", "klinv"):
            ts.set_kltransform(klname)
            files += [ts._klfile(mi) for mi in range(nm)]
            files.append(os.path.join(out, f"klmodes_{klname}_{ts.klthreshold:f}.hdf5"))
        files += [os.path.join(out, f"{n}.hdf5")
                  for n in ("ps_ps", "map_full", "map_svd", "map_klinv")]
    return files


def _rel(a, b):
    """max |a - b| over max |b| (0 for two empty arrays)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise AssertionError(f"shapes {a.shape} and {b.shape}")
    return float(np.abs(a - b).max() / np.abs(b).max()) if b.size else 0.0


def _gate(tag, what, err, tol):
    log(f"[{tag}] {what}: {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{tag}: {what} {err:.3e} > {tol:g}")


def klinv_phase(outdir):
    """An inverse KL filter ``klinv`` added to the products in ``outdir``:
    their config, with ``klinv`` appended, goes into the directory as
    ``config.yaml``, and a second ``generate()`` of a manager loaded from it
    writes only ``klinv`` (the rest is skipped), through the dense per-m
    path (K15a's sky form).  Returns (launches, manager)."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.core import manager

    tag = "klinv"
    conf = products_config(outdir)
    conf["kltransform"].append(
        {"type": "KLTransform", "name": "klinv", "threshold": PS_THRESHOLD, "inverse": True}
    )
    write_yaml(conf, os.path.join(outdir, "config.yaml"))

    backend.reset_launch_counts()
    t = time.time()
    m = manager.ProductManager.from_config(outdir)
    m.generate()
    torch.cuda.synchronize()
    t_klinv = time.time() - t
    launches = launch_counts()
    log(f"[{tag}] generate() {t_klinv:.4f} s  launches {launches}")
    require_launched(tag, launches, ["k15a_sandwich"])
    return launches, m


def timestream_phase(outdir, m):
    """The timestream pipeline behind ``drift-runpipeline`` on the card, on
    the product directory ``[products]`` left in ``outdir`` with ``klinv``
    added (manager ``m``), and its checks.

    The input sky is made on the card by ``synthesis_real`` (K14) from
    seeded band-limited alm at the nside of the telescope's BTM; the launch
    counts are set to 0 after that, just before ``run_config``.  Returns
    (launches, mapfile, nside)."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.core import manager
    from driftscan_tpu_torch.ops import sht
    from driftscan_tpu_torch.scripts import runpipeline
    from driftscan_tpu_torch.util import store

    tag = "timestream"
    tel, bt = m.telescope, m.beamtransfer
    nside = tel._nside_for(tel.lmax)
    nl, nm = tel.lmax + 1, tel.mmax + 1
    rng = np.random.default_rng(SEED + 3)
    alm = rng.standard_normal((tel.nfreq, nl, nl)) + 1j * rng.standard_normal((tel.nfreq, nl, nl))
    alm = np.where(np.arange(nl)[None, :] <= np.arange(nl)[:, None], alm, 0)
    alm[..., 0] = alm[..., 0].real
    skymap = sht.synthesis_real(torch.as_tensor(alm, device=tel.device), nside)[:, None]
    skymap = skymap.cpu().numpy()
    mapfile = os.path.join(outdir, "sky.hdf5")
    with store.File(mapfile, "w") as f:
        f.create_dataset("map", data=skymap)

    tsdir = os.path.join(outdir, "timestreams")
    cfg = write_yaml(timestream_config(outdir, tsdir, mapfile, nside),
                     os.path.join(outdir, "timestream.yaml"))
    backend.reset_launch_counts()
    t = time.time()
    pm = runpipeline.run_config(cfg)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = launch_counts()
    ts1, ts2 = pm.timestreams["ts1"], pm.timestreams["ts2"]
    stages = "  ".join(f"t_{k} {v:.4f} s" for k, v in pm.timings.items())
    log(
        f"[{tag}] store {store.BACKEND}  nside {nside}  map {skymap.shape}  ntime {ts1.ntime}  "
        f"pipeline wall {wall:.4f} s  {stages}"
    )
    log(f"[{tag}] launches {launches}")
    require_launched(tag, launches, ["k14_legendre_synth", "k3k5_legendre_sht"])

    # every file exists and opens
    files = timestream_files(pm, tsdir)
    bad = [f for f in files if not store.readable(f)]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} files missing or unreadable: {bad[:4]}")
    log(f"[{tag}] {len(files)} pipeline files open")

    # the noiseless m-modes are the direct projection of the sky's alm
    alm_in = sht.sphtrans_sky(skymap, lmax=tel.lmax, device=tel.device).cpu().numpy()
    direct, got = [], []
    for mi in (0, 1, 8, tel.mmax):
        direct.append(bt.project_vector_sky_to_telescope(mi, alm_in[..., mi]))
        got.append(ts1.mmode(mi).reshape(tel.nfreq, bt.ntel))
    _gate(tag, "ts1 m-modes (m 0, 1, 8, mmax) vs the direct projection, of max", _rel(got, direct), 1e-8)

    # maps: finite, non-zero; ts1's against the CPU synthesis of the same alm
    ts1.set_kltransform("klinv")
    alm_of = {"full": ts1.alm_full_m, "svd": ts1.alm_svd_m,
              "klinv": lambda mi: ts1.alm_kl_m(mi, pm.wiener)}
    for ts in (ts1, ts2):
        for name in alm_of:
            with store.File(os.path.join(ts.output_directory, f"map_{name}.hdf5"), "r") as f:
                skm = f["map"][:]
            if skm.shape != (tel.nfreq, tel.num_pol_sky, 12 * nside**2):
                raise AssertionError(f"{tag}: map_{name} shape {skm.shape}")
            if not (np.isfinite(skm).all() and np.abs(skm).max() > 0):
                raise AssertionError(f"{tag}: map_{name} of {ts.directory} not finite and non-zero")
            if ts is ts1:
                a = ts1.collect_alm(alm_of[name], ts1._mlist() if name == "klinv" else None)
                cpu = sht.sphtrans_inv_sky(a, nside, device="cpu").numpy()
                _gate(tag, f"ts1 map_{name} vs the CPU synthesis of its alm, of max "
                      f"(max|map| {np.abs(cpu).max():.6e})", _rel(skm, cpu), 1e-10)

    # SVD and KL modes of the first and last m against the CPU projections
    mc = manager.ProductManager.from_config(outdir, device="cpu")
    btc, klc = mc.beamtransfer, mc.kltransforms["kl"]
    ts1.set_kltransform("kl")
    e_svd = e_kl = 0.0
    for mi in list(range(CPU_CHECK_M)) + list(range(nm - CPU_CHECK_M, nm)):
        svd = ts1.mmode_svd(mi)
        e_svd = max(e_svd, _rel(svd, btc.project_vector_telescope_to_svd(
            mi, ts1.mmode(mi).reshape(tel.nfreq, bt.ntel))))
        e_kl = max(e_kl, _rel(ts1.mmode_kl(mi),
                              klc.project_vector_svd_to_kl(mi, svd, threshold=ts1.klthreshold)))
    _gate(tag, f"ts1 SVD modes of the first and last {CPU_CHECK_M} m vs the CPU", e_svd, 1e-8)
    _gate(tag, f"ts1 KL modes of the first and last {CPU_CHECK_M} m vs the CPU", e_kl, 1e-8)

    # power spectra: finite, and the CPU's q estimator summed over m
    psc = mc.psestimators["ps"]
    psc.genbands()
    fisher, bias = psc.fisher_bias()
    finv = np.linalg.inv(fisher)
    qs = []
    for ts in (ts1, ts2):
        ts.set_kltransform("kl")
        ts.set_psestimator("ps")
        q = sum(psc.q_estimator(mi, ts.mmode_kl(mi)) for mi in ts._mlist())
        qs.append(q)
        with store.File(ts._psfile, "r") as f:
            ps = f["powerspectrum"][:]
        if not np.isfinite(ps).all():
            raise AssertionError(f"{tag}: power spectrum of {ts.directory} not finite")
        _gate(tag, f"{os.path.basename(ts.directory)} power spectrum vs the CPU q estimator "
              f"({np.round(ps, 9).tolist()})", _rel(ps, finv @ (q - bias)), 1e-8)
    qx = np.zeros((2, 2, psc.nbands))
    qx[0, 1] = qx[1, 0] = sum(psc.q_estimator(mi, ts1.mmode_kl(mi), ts2.mmode_kl(mi))
                              for mi in ts1._mlist())
    want = (finv @ (qx - bias).reshape(4, psc.nbands).T).T.reshape(2, 2, psc.nbands)
    with store.File(os.path.join(tsdir, "xps.hdf5"), "r") as f:
        xps = f["powerspectrum"][:]
    if not np.isfinite(xps).all():
        raise AssertionError(f"{tag}: cross power spectrum not finite")
    _gate(tag, "cross power spectrum vs the CPU q estimator", _rel(xps, want), 1e-8)
    psc.delbands()

    # a second run rewrites only the full and SVD maps (as the JAX package)
    def snapshot():
        return {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
                for d, _, fs in os.walk(tsdir) for f in fs}

    def product(path):
        parts = os.path.relpath(path, tsdir).split(os.sep)
        return os.sep.join(parts[: next(i for i, p in enumerate(parts) if p.endswith(
            (".hdf5", ".pickle", "COMPLETED_M"))) + 1])

    stamp = snapshot()
    t = time.time()
    pm2 = runpipeline.run_config(cfg)
    torch.cuda.synchronize()
    t_again = time.time() - t
    touched = {product(p) for p, at in snapshot().items() if stamp.get(p) != at}
    want = {os.path.join(ts, f"map_{k}.hdf5") for ts in ("ts1", "ts2") for k in ("full", "svd")}
    log(f"[{tag}] second run_config(): {t_again:.2f} s "
        f"({'  '.join(f't_{k} {v:.3f}' for k, v in pm2.timings.items())}), rewrote {sorted(touched)}")
    if touched != want:
        raise AssertionError(f"{tag}: the second run rewrote {sorted(touched)}, expected {sorted(want)}")
    return launches, mapfile, nside


def profile_timestream(outdir, mapfile, nside):
    """torch.profiler over one fresh ``run_config`` of the ``[timestream]``
    pipeline (new timestream directories, the same products): wall, device
    busy time, idle share, largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from driftscan_tpu_torch.scripts import runpipeline

    tsdir = os.path.join(outdir, "timestreams_profiled")
    cfg = write_yaml(timestream_config(outdir, tsdir, mapfile, nside),
                     os.path.join(outdir, "timestream_profiled.yaml"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        with record_function(PROFILED):
            pm = runpipeline.run_config(cfg)
            torch.cuda.synchronize()
        wall = time.time() - t
    busy_s, nops = device_busy(prof, wall)
    stages = "  ".join(f"{k} {v:.3f} s" for k, v in pm.timings.items())
    log(
        f"[profile] timestream run_config(): wall {wall:.4f} s (profiled), device busy "
        f"{busy_s:.4f} s, idle share {1.0 - busy_s / wall:.4f}, {nops} device ops; {stages}"
    )
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=14)
    for line in table.splitlines():
        log(f"[profile]   {line}")


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
            work=(2 * nbytes(x), [(float(x.numel()), F32_FLOPS)]),
            library_fn=lambda: torch.mul(x, 2.0),
        )
    }
    flops = 2.0 * n**3
    for label, (p, q), rtol in (("f32", (a, b), 1e-5), ("bf16", (a16, b16), 1e-3)):
        # float32 inputs run at the float32 CUDA-core peak; bfloat16 inputs
        # could run on the tensor cores
        rec = compare(
            f"probe_mm ({n}^3 {label} in, f32 out)", lambda: probe.mm(p, q),
            lambda: probe.mm_ref(p, q), rtol=rtol, tag="probe",
            work=(nbytes(p, q) + n * n * 4,
                  [(flops, F32_FLOPS if label == "f32" else BF16_FLOPS)]),
            library_fn=lambda: torch.matmul(p, q),
        )
        log(
            f"[probe] probe_mm {label}: kernel {flops / rec['ms'] / 1e9:.4f} Tflop/s, "
            f"plain {flops / rec['plain_ms'] / 1e9:.4f} Tflop/s"
        )
        if label == "f32":
            res["probe_mm"] = rec
    return launches, res


PROFILED = "chip_smoke profiled window"


def device_busy(prof, wall):
    """(seconds the device was busy, device operations) inside the
    ``record_function(PROFILED)`` span of a finished torch.profiler run:
    the union of its kernel and copy intervals, clipped to that span.
    ``wall`` is the host's time for the same span; a busy time above it
    means the trace is not to be trusted, and raises."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    marks = [
        e for e in events
        if e.get("name") == PROFILED and "dur" in e and "gpu" not in str(e.get("cat", ""))
    ]
    if not marks:
        raise AssertionError("profile: the profiled window is not in the trace")
    mark = max(marks, key=lambda e: e["dur"])
    lo, hi = mark["ts"], mark["ts"] + mark["dur"]
    spans = sorted(
        (max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
        and e["ts"] < hi and e["ts"] + e["dur"] > lo
    )
    busy, end = 0.0, lo
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    busy *= 1e-6
    if not busy <= wall:
        raise AssertionError(f"profile: device busy {busy:.4f} s exceeds the wall {wall:.4f} s")
    return busy, len(spans)


def profile_paths(tels):
    """torch.profiler over one pass of each product path's two phases: the
    device busy time (union of kernel and copy intervals), the idle share
    of the wall, and the largest kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

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
                with record_function(PROFILED):
                    fn()
                    torch.cuda.synchronize()
                wall = time.time() - t
            busy_s, nops = device_busy(prof, wall)
            log(
                f"[profile] {tag} {phase}: wall {wall:.4f} s, device busy {busy_s:.4f} s, "
                f"idle share {1.0 - busy_s / wall:.4f}, {nops} device ops"
            )
            table = prof.key_averages().table(sort_by="device_time_total", row_limit=12)
            for line in table.splitlines():
                log(f"[profile]   {line}")


def profile_products():
    """torch.profiler over one whole ``generate()`` of the file pipeline in
    a fresh directory: wall, device busy time, idle share, largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from driftscan_tpu_torch.core import manager

    outdir = tempfile.mkdtemp(prefix="driftscan_products_")
    try:
        m = manager.ProductManager().apply_config(products_config(outdir))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.time()
            with record_function(PROFILED):
                m.generate()
                torch.cuda.synchronize()
            wall = time.time() - t
        busy_s, nops = device_busy(prof, wall)
        stages = "  ".join(f"{k} {v:.3f} s" for k, v in m.timings.items())
        log(
            f"[profile] products generate(): wall {wall:.4f} s (profiled), device busy "
            f"{busy_s:.4f} s, idle share {1.0 - busy_s / wall:.4f}, {nops} device ops; {stages}"
        )
        table = prof.key_averages().table(sort_by="device_time_total", row_limit=14)
        for line in table.splitlines():
            log(f"[profile]   {line}")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def host_kernel_phases(tels):
    """K2-host (scalar and Stokes) against its plain version at the first
    BTM chunk of each host-beam path (``tels``: tag -> telescope), with a
    bitwise repeat.  Bytes: the maps written, the grid (cart, horizon) and
    the chunk's unique beams read once; the per-pixel arithmetic is not
    counted.  No single PyTorch call computes the function.  Returns the
    records of the double-precision scalar form (the ``[dish]`` path's)
    and of the Stokes form."""
    from driftscan_tpu_torch.ops import kernels

    res = {}
    for tag, t in tels.items():
        pol = t.num_pol_sky > 1
        ns, blc, fic, _ = first_chunk(t)
        t._init_trans(ns)
        beams, ii, jj, uv3 = t._gather_host_beams(blc, fic)
        args = (beams, ii, jj, uv3, t._angpos_cart, t._horizon, t._pxarea)
        npx = t._horizon.shape[0]
        rtol = 1e-5 if t.single_precision else 1e-10
        what = (f"({len(blc)} units x {t._npol_transform if pol else 1} x {npx} px, nside {ns}, "
                f"{len(beams)} unique beams {beams.dtype}; {tag})")
        if pol:
            npol = t._npol_transform
            maps = kernels.host_stokes_maps(*args, npol=npol)
            rec = compare(
                f"k2_host_stokes {what}",
                lambda: kernels.host_stokes_maps(*args, npol=npol),
                lambda: kernels.host_stokes_maps_ref(*args, npol=npol),
                rtol=rtol, work=(nbytes(maps, *args[:6]), []), bitwise=True, per_launch=True,
            )
            res.setdefault("k2_host_stokes", rec)
        else:
            maps = kernels.host_visibility_maps(*args)
            rec = compare(
                f"k2_host_vis {what}",
                lambda: kernels.host_visibility_maps(*args),
                lambda: kernels.host_visibility_maps_ref(*args),
                rtol=rtol, work=(nbytes(maps, *args[:6]), []), bitwise=True, per_launch=True,
            )
            if not t.single_precision:
                res["k2_host_vis"] = rec
        del maps, args, beams
    return res


def host_beam_share(tag, tel):
    """The host-beam evaluation's share of a cold ``btm_resident`` (empty
    beam caches): the seconds spent in ``beam(feed, freq)`` (numpy) and in
    padding and uploading each beam, over t_btm."""
    import torch

    from driftscan_tpu_torch.parallel import resident

    spent = {"_beam": 0.0, "_beam_device": 0.0}

    def timed(name):
        fn = getattr(tel, name)

        def wrapper(*a):
            t = time.time()
            out = fn(*a)
            spent[name] += time.time() - t
            return out
        return wrapper

    blg, fig = units(tel)
    tel._beam_cache = tel._beam_dev_cache = tel._beam_key = None
    for name in spent:
        setattr(tel, name, timed(name))
    try:
        torch.cuda.synchronize()
        t = time.time()
        pos, neg = resident.btm_resident(tel, blg, fig)
        torch.cuda.synchronize()
        t_btm = time.time() - t
    finally:
        for name in spent:
            delattr(tel, name)
    del pos, neg
    log(
        f"[{tag}] cold btm_resident {t_btm:.4f} s: host beams {spent['_beam']:.4f} s "
        f"({spent['_beam'] / t_btm:.4f} of t_btm), with padding and upload "
        f"{spent['_beam_device']:.4f} s ({spent['_beam_device'] / t_btm:.4f}); "
        f"{len(tel._beam_cache)} beams"
    )


def precision_gate_phase(tag, klass, params, nunits=4):
    """A cylinder at ``single_precision: False`` on the card: one
    ``btm_resident`` pass of all its units launches K2-host in float64 and
    no bank kernel, and the tables of a few units equal the CPU's."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.parallel import resident

    tel = klass.from_config(dict(params, single_precision=False), device="cuda")
    cpu = klass.from_config(dict(params, single_precision=False), device="cpu")
    blg, fig = units(tel)
    backend.reset_launch_counts()
    t = time.time()
    pos, neg = resident.btm_resident(tel, blg, fig)
    torch.cuda.synchronize()
    t_btm = time.time() - t
    launches = launch_counts()
    log(f"[{tag}] {klass.__name__} single_precision False: btm_resident {t_btm:.4f} s "
        f"({len(blg)} units, {pos.dtype}) launches {launches}")
    require_map_kernel(tag, tel, launches)
    pick = np.linspace(0, len(blg) - 1, nunits).astype(int)
    pc, nc = resident.btm_resident(cpu, blg[pick], fig[pick])
    err = max(_rel(pos[pick].cpu().numpy(), pc.numpy()), _rel(neg[pick].cpu().numpy(), nc.numpy()))
    _gate(tag, f"BTM tables of units {pick.tolist()} card vs CPU, of max", err, 1e-10)
    return launches


def svd_cut_phase(tag, tel, params, svcut=1e-6):
    """Where ``[slice]``'s SVD mode count sits against its cut: the bench
    cylinder's BTM from the path's kernels, with K3+K5's plain version in
    the kernel's place, and in float64, each through the product step's
    SVD cut (``mstep.kl_product_step`` at npol 1: the singular values of
    the l >= m masked, noise-weighted beams of each (m, f) above
    ``SVD_FLOOR`` of their top and ``svcut`` of their m's top).  Prints
    each count, and how far the singular values within a factor 2 of the
    cut lie from the float64 ones."""
    from unittest import mock

    import torch

    from driftscan_tpu_torch.ops import linalg, sht
    from driftscan_tpu_torch.parallel import resident

    def spectra(t):
        nm, nl = t.mmax + 1, t.lmax + 1
        pos, neg = resident.btm_resident(t, *units(t))
        noisew = torch.as_tensor(covariances(t)[2], device="cuda").double()
        svs, cuts = [], []
        for s in range(0, nm, 8):
            mv = torch.arange(s, min(s + 8, nm), device="cuda")
            beam = resident._build_beam_batch(pos, neg, mv, t.npairs, t.nfreq, 1, nl)
            lmask = (torch.arange(nl, device="cuda")[None, :] >= mv[:, None]).double()
            bw = beam.to(torch.complex128) * lmask[:, None, None, :] * noisew[None, :, :, None]
            sv = torch.linalg.svd(bw, full_matrices=False)[1]  # (M, F, k)
            top_m = sv[..., 0].amax(-1)
            cut = torch.maximum(sv[..., :1] * linalg.SVD_FLOOR, top_m[:, None, None] * svcut)
            svs.append(sv)
            cuts.append(cut.expand_as(sv))
        return torch.cat(svs), torch.cat(cuts)

    res = {"kernel": spectra(tel)}
    with mock.patch.object(sht, "legendre_contract", sht.legendre_contract_ref):
        res["plain K3+K5"] = spectra(tel)
    tel64 = type(tel).from_config(dict(params, single_precision=False), device="cuda")
    res["float64"] = spectra(tel64)
    sv64, cut64 = res["float64"]
    near = (sv64 > cut64 / 2) & (sv64 < cut64 * 2)
    kept64 = (sv64 > cut64).sum(-1)
    for name, (sv, cut) in res.items():
        kept = (sv > cut).sum(-1)
        dev = float((sv / sv64 - 1).abs()[near].max()) if bool(near.any()) else 0.0
        log(f"[{tag}] {name} BTM: svd modes {int(kept.sum())}; (m, f) whose count differs "
            f"from float64's {int((kept != kept64).sum())}; of the {int(near.sum())} float64 "
            f"singular values within a factor 2 of the cut, largest |sv / sv_float64 - 1| "
            f"{dev:.3e}")


def example_phase(workdir):
    """The repository's example (``examples/disharray``: DishArray with
    ``nosvd``, a KL filter with an inverse; then a timestream and maps),
    its two YAML files copied unedited into ``workdir`` and run there as
    the example's README runs them, through the port: ``makeproducts``
    then ``runpipeline.run_config``, after the input map the example's
    walkthrough script writes (made here by K14 through the port's store).  Checks:
    every file opens, the NoSVD telescope basis (ndof = ntel x nfreq), maps
    finite and equal to the CPU synthesis of their alm.  Returns the
    launches of the two runs and the telescope."""
    import contextlib

    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.core import beamtransfer
    from driftscan_tpu_torch.ops import sht
    from driftscan_tpu_torch.scripts import makeproducts, runpipeline
    from driftscan_tpu_torch.util import store

    tag = "example"
    example = os.path.join(HERE, "examples", "disharray")
    for name in ("prod_params.yaml", "pipe_params.yaml"):
        shutil.copy(os.path.join(example, name), os.path.join(workdir, name))
    counted = {}
    with contextlib.chdir(workdir):
        backend.reset_launch_counts()
        t = time.time()
        m = makeproducts.run_config("prod_params.yaml")
        torch.cuda.synchronize()
        t_prod = time.time() - t
        launches = launch_counts()
        tel, bt = m.telescope, m.beamtransfer
        log(f"[{tag}] makeproducts {t_prod:.4f} s: {type(tel).__name__} lmax {tel.lmax} "
            f"mmax {tel.mmax} nfreq {tel.nfreq} npairs {tel.npairs} "
            f"{type(bt).__name__} ntel {bt.ntel} svd_len {bt.svd_len} ndof {bt.ndof(0)} "
            f"launches {launches}")
        if not isinstance(bt, beamtransfer.BeamTransferNoSVD):
            raise AssertionError(f"{tag}: nosvd gave {type(bt).__name__}")
        if not (bt.ndof(0) == bt.ndofmax == bt.ntel * bt.nfreq):
            raise AssertionError(f"{tag}: NoSVD ndof {bt.ndof(0)} != ntel x nfreq")
        require_map_kernel(tag, tel, launches)
        counted.update({k: v for k, v in launches.items() if v})

        # the walkthrough script's input map: seeded band-limited alm (K14)
        nside = 32
        nl = tel.lmax + 1
        rng = np.random.default_rng(42)
        alm = rng.standard_normal((tel.nfreq, nl, nl)) + 1j * rng.standard_normal(
            (tel.nfreq, nl, nl))
        alm = np.where(np.arange(nl)[None, :] <= np.arange(nl)[:, None], alm, 0)
        alm[..., 0] = alm[..., 0].real
        skymap = sht.synthesis_real(torch.as_tensor(alm, device="cuda"), nside)
        with store.File("simulated_input_map.hdf5", "w") as f:
            f.create_dataset("map", data=skymap[:, None].cpu().numpy())

        backend.reset_launch_counts()
        t = time.time()
        pm = runpipeline.run_config("pipe_params.yaml")
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = launch_counts()
        log(f"[{tag}] runpipeline run_config {wall:.4f} s  "
            f"{'  '.join(f't_{k} {v:.4f} s' for k, v in pm.timings.items())}  launches {launches}")
        require_launched(tag, launches, ["k3k5_legendre_sht", "k14_legendre_synth"])
        for k, v in launches.items():
            if v:
                counted[k] = counted.get(k, 0) + v

        files = [os.path.join(r, f) for r, ds, fs in os.walk(workdir) for f in fs
                 if f.endswith(".hdf5")]
        files += [os.path.join(r, d) for r, ds, fs in os.walk(workdir) for d in ds
                  if d.endswith(".hdf5")]
        bad = [f for f in files if not store.readable(f)]
        if bad or not files:
            raise AssertionError(f"{tag}: {len(bad)} of {len(files)} files unreadable: {bad[:4]}")
        log(f"[{tag}] {len(files)} files open (store {store.BACKEND})")
        ts = pm.timestreams["ts1"]
        for name, alm_m in (("full", ts.alm_full_m), ("svd", ts.alm_svd_m)):
            with store.File(os.path.join(ts.output_directory, f"map_{name}.hdf5"), "r") as f:
                skm = f["map"][:]
            if not (np.isfinite(skm).all() and np.abs(skm).max() > 0):
                raise AssertionError(f"{tag}: map_{name} not finite and non-zero")
            cpu = sht.sphtrans_inv_sky(ts.collect_alm(alm_m), nside, device="cpu").numpy()
            _gate(tag, f"map_{name} {skm.shape} vs the CPU synthesis of its alm, of max",
                  _rel(skm, cpu), 1e-10)
    return counted, tel


def svd_variants_phase(workdir):
    """TempSVD and FullSVD beam transfers of the example's telescope on the
    card (``[products]``-style: BTM and SVD files through the manager), and
    ``simple_svd`` (K18b, the library SVD) against the CPU on the same
    noise-weighted beams: singular values within 1e-8 of each m's top.
    Times one batched call at an m-batch of the run's shape."""
    import torch
    import yaml

    from driftscan_tpu_torch.core import beamtransfer, manager
    from driftscan_tpu_torch.ops import projections

    tag = "svd variants"
    with open(os.path.join(HERE, "examples", "disharray", "prod_params.yaml")) as f:
        base = yaml.safe_load(f)
    for variant in ("fullsvd", "tempsvd"):
        conf = {"config": {"beamtransfers": True, "fullsvd": variant == "fullsvd",
                           "output_directory": os.path.join(workdir, variant)},
                "telescope": base["telescope"]}
        m = manager.ProductManager().apply_config(conf)
        if variant == "tempsvd":
            m.beamtransfer = beamtransfer.BeamTransferTempSVD(
                m.beamtransfer.directory, telescope=m.telescope)
        t = time.time()
        m.generate()
        torch.cuda.synchronize()
        t_gen = time.time() - t
        bt, tel = m.beamtransfer, m.telescope
        nfreq, nl, npol = tel.nfreq, tel.lmax + 1, tel.num_pol_sky
        noisew = np.stack([bt._noise_weights(fi) for fi in range(nfreq)])
        err = 0.0
        ms = list(range(0, tel.mmax + 1, max(1, tel.mmax // 8)))
        for mi in ms:
            bw = bt.beam_m(mi).reshape(nfreq, bt.ntel, npol * nl) * noisew[:, :, None]
            block = bw if variant == "fullsvd" else bw.reshape(nfreq, bt.ntel, npol, nl)[:, :, 0]
            _, sig_c = projections.simple_svd(block, device="cpu")
            sig_g = bt.beam_singularvalues(mi)
            top = max(float(sig_c.max()), 1e-300)
            err = max(err, float(np.abs(sig_g - sig_c[:, : bt.svd_len].numpy()).max()) / top)
        log(f"[{tag}] {type(bt).__name__}: generate {t_gen:.4f} s, svd_len {bt.svd_len}")
        _gate(tag, f"{type(bt).__name__} singular values of m {ms} card vs CPU simple_svd, "
              "of each m's top", err, 1e-8)
    batch = torch.as_tensor(np.stack([
        bt.beam_m(mi).reshape(nfreq, bt.ntel, npol * nl) * noisew[:, :, None]
        for mi in range(min(bt.svd_mbatch, tel.mmax + 1))
    ]).reshape(-1, bt.ntel, npol * nl), device="cuda")
    ms_svd = median_ms(lambda: projections.simple_svd(batch), reps=5)
    # bound: U1, sigma and V of each (m, n) matrix, the smaller of Golub and
    # Van Loan's Golub-Reinsch (14 m n^2 + 8 n^3) and R-SVD (6 m n^2 +
    # 20 n^3) counts, four real flops a complex one, at the float64 peak;
    # bytes: the batch read, U1, sigma and V written
    nb_, m_, n_ = batch.shape
    m_, n_ = max(m_, n_), min(m_, n_)
    flops = 4.0 * nb_ * min(14 * m_ * n_**2 + 8 * n_**3, 6 * m_ * n_**2 + 20 * n_**3)
    moved = nbytes(batch) * 2 + nb_ * n_ * (8 + 16 * n_)
    bound_ms, bound_by = bound(moved, [(flops, F64_FLOPS)])
    log(f"[{tag}] simple_svd (lib, complex128) of {tuple(batch.shape)}: {ms_svd:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, HERE)
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.telescope import cylinder, disharray, restrictedcylinder

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
    dtel = disharray.DishArray.from_config(DISH_PARAMS, device="cuda")
    rtel = restrictedcylinder.RestrictedCylinder.from_config(RESTRICTED_PARAMS, device="cuda")
    rptel = restrictedcylinder.RestrictedPolarisedCylinder.from_config(
        RESTRICTED_POL_PARAMS, device="cuda")
    perf = kernel_phases(tel, ptel)
    perf.update(host_kernel_phases(
        {"restricted": rtel, "restricted pol": rptel, "dish": dtel}))
    k3k5_dish_compare(dtel, np.random.default_rng(SEED + 3))
    counted = {}
    for tag, t_, ps in (("slice", tel, PS_THRESHOLD), ("pol", ptel, POL_PS_THRESHOLD),
                        ("dish", dtel, None), ("restricted", rtel, None),
                        ("restricted pol", rptel, None)):
        launches, required, k13_rec, run = path_phase(tag, t_, ps)
        for name in required:
            counted[name] = counted.get(name, 0) + launches[name]
        if tag == "slice":
            # the unpolarised leg's K13 at the largest k its path launched
            perf["k13_fisher_cov"] = k13_rec
            slice_run = run
        if tag == "dish":
            host_beam_share(tag, dtel)
        del run
    del dtel
    for klass, params in ((restrictedcylinder.RestrictedCylinder, RESTRICTED_PARAMS),
                          (cylinder.UnpolarisedCylinderTelescope, BENCH_PARAMS)):
        launches = precision_gate_phase("float64 gate", klass, params)
        counted["k2_host_vis"] += launches["k2_host_vis"]
    # the product directory of [products] serves [timestream]
    outdir = tempfile.mkdtemp(prefix="driftscan_products_")
    profiling = "--profile" in sys.argv[1:]
    try:
        launches, nkl = products_phase(slice_run, outdir)
        for name, count in launches.items():
            if count:
                counted[name] = counted.get(name, 0) + count
        # the sandwich and the trace at the largest nkl of the products run
        perf.update(products_kernels(tel, nkl))
        launches, m = klinv_phase(outdir)
        for name, count in launches.items():
            if count:
                counted[name] = counted.get(name, 0) + count
        launches, mapfile, nside = timestream_phase(outdir, m)
        for name, count in launches.items():
            if count:
                counted[name] = counted.get(name, 0) + count
        if profiling:
            profile_timestream(outdir, mapfile, nside)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="driftscan_example_")
    try:
        launches, _ = example_phase(workdir)
        for name, count in launches.items():
            counted[name] = counted.get(name, 0) + count
        svd_variants_phase(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches, probe_perf = probe_phase()
    perf.update(probe_perf)
    for name in PROBE_KERNELS:
        counted[name] = launches[name]
    # last, so that its float64 telescope and BTMs precede no timed phase
    svd_cut_phase("svd cut", tel, BENCH_PARAMS)
    if profiling:
        profile_paths((("slice", tel, PS_THRESHOLD), ("pol", ptel, POL_PS_THRESHOLD)))
        profile_products()

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
