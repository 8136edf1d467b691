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
   K3+K5 over an m-window at the ``[ns2 window]`` shape (m 270..314,
   complex64, rel 1e-5), whose columns must equal a full-range call's
   bit for bit; K17 (the top-band engine's Chebyshev filter step,
   complex128) at the slice's shape (M 8, n 352, K 352, k 44) and at
   ns2's full size (M 1, n 3200, K 3200, k 400): V_out within 1e-12 of
   its max, the running scale within 1e-13 rel, bitwise repeats, the
   library being ``torch.baddbmm`` and an inf-norm (two calls);
4. slice -- the bench telescope (``bench.build_telescope``'s full config)
   through ``btm_resident`` and ``product_all_resident`` with the fused
   Fisher over all m; every path leaves ``bucket`` to its auto rule and
   logs what it picked and the m-chunks it ran (full size or compacted);
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
   each, K2-host in float64 against the CPU; ``[dish]`` buckets under
   its auto rule;
5b. slice windows, ns2 window -- m-windows and m-bucketing: the bench
   telescope in two m-windows against path 4 (:func:`slice_windows_phase`),
   and the JAX package's north-star telescope ``ns2`` at full width in its
   run's last m-window, bucketed (:func:`ns2_window_phase`), then
   ``[topband ns2]``: four of its m at full size (n 3200) by the exact
   and the top-band engine (:func:`topband_ns2_phase`), with K17's
   launches by distinct (M, n, K, k) and the tile each got; then
   ``[ns2 retained]``: ns2 in its run's second m-window [45, 90), where
   modes pass 0.1, cut to its first 8 m (one m-chunk), by the exact and
   the top-band engine on the same tables, m 45 and 52 against the CPU,
   K13 and K15b timed at the shapes it launched them with, and those m
   held against the JAX run's record (:func:`ns2_retained_phase`,
   :func:`record_compare`; ``experiments/ns2_retained.py`` runs the whole
   window, its Fisher against the record's);
5d. oldcylinder -- the legacy sinc-beam polarised cylinder
   (``telescope/oldcylinder.py``, reached by the manager's plugin form) at
   bench's polarised layout and 4 channels through the entry points of 4,
   its host beams on K2-host Stokes, with path 5's CPU check
   (:func:`oldcylinder_phase`);
5e. ns1b window -- the JAX package's scale-axis telescope ``ns1b`` (lmax
   1035, nside 1024 under its run's cap) in its run's first m-window
   [0, 33): K3+K5 at the path's shape (B 64 Stokes maps, 4,095 rings)
   against its plain version, with its library call and bound
   (:func:`ns1b_window_phase`; ``experiments/ns1b_window.py`` runs the
   window itself against the JAX run's record);
5c. topband -- path 4's tables through ``product_all_resident(topband=True,
   kl_cut=0.1)`` with the fused Fisher (:func:`topband_phase`): K17
   launched, every failed certificate solved again, the card against the
   port's CPU engine on the CPU check's m (retained eigenvalues rel 1e-6),
   the exact engine's spectra and Fisher beside it, both engines'
   m-modes/s, K17's launches by distinct (M, n, K, k) and the tile each
   got;
6. products -- the file pipeline behind ``drift-makeproducts``: the bench
   unpolarised cylinder as a config dictionary through
   ``ProductManager.apply_config(...).generate()`` into a fresh temporary
   directory (beam and SVD files for all m, the KL and DoubleKL
   eigenfiles, PSExact's Fisher file), then the checks of
   :func:`products_phase`: every file opens, the Fisher from the files
   against path 4's fused Fisher, KL spectra against the port's CPU run on
   the same SVD beams, one m through the dense per-m transform, a second
   ``generate()`` that skips every stage; ``[convert]``: the directory's
   conversion to HDF5 where h5py imports (:func:`convert_phase`); then the
   sandwich (K15a) and the Fisher trace (K15b) again at the sizes that
   run gave them (``[products kernels]``);
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
   a second run that rewrites only the full and SVD maps); then
   ``[topband products]``: the KL and DoubleKL filters again with
   ``engine: topband`` added to that directory's config and generated
   (:func:`topband_products_phase`; eigenvalues rel 1e-6 and
   ``num_modes`` equal to the exact filters', fallbacks and K17's launches
   by distinct (M, n, K, k) printed);
8a. example -- the repository's ``examples/disharray`` (DishArray,
   ``nosvd``, a KL filter with an inverse), its two YAML files copied
   unedited into a temporary directory and run there by
   ``makeproducts.run_config`` and ``runpipeline.run_config`` after the
   input map of the example's walkthrough script, made by the port's copy
   of its driver (``driftscan_tpu_torch/examples/disharray_driver.py``:
   K14, the port's store); every file
   opens, the NoSVD telescope basis, maps against the CPU synthesis of
   their alm; then ``[svd variants]``: TempSVD and FullSVD beam transfers
   of the same telescope, their singular values against the CPU's
   ``simple_svd`` (K18b, a library SVD) on the same beams;
8b. chunked, chunked 128, psmc (run after 8, on the products of 6) -- the
   chunked streaming BTM generate and the Monte-Carlo estimators:
   ``[products]``' config with ``resident: never`` and ``mem_chunk: 0.1``
   (3 unit chunks) through the whole chain,
   every file against the resident run's, and the polarised cylinder's
   BTM by both routes (:func:`chunked_phase`); the bench cylinder at 128
   channels, whose tables are over the resident host budget, through the
   chunked route in 2 chunks (the BTM of 226 m; units against the plain CPU
   versions; its peak host RSS; :func:`chunked_128_phase`), then its product
   chain (SVD, KL, PSExact) cut to its first 8 m, two m against the CPU
   (:func:`chunked_128_products`); MonteCarlo,
   MonteCarloAlt and Cross on ``[products]``' KL filter against its
   ``Full`` Fisher and the CPU (:func:`psmc_phase`); between ``[chunked]``
   and ``[chunked 128]``, ``[mp products]``: ``[chunked]``'s config with a
   seeded MonteCarlo through ``drift-makeproducts-torch run`` under
   torchrun with two ranks on the card, then ``run-config`` with
   ``[timestream]``'s noiseless ts1 under two ranks; each rank's kernels,
   the files against ``[chunked]``'s and the maps against
   ``[timestream]``'s (:func:`mp_products_phase`);
9. probe -- the ports of the two Pallas probes of
   ``scratch/pallas_probe.py`` against their plain versions: o = 2 x at
   the probe's 1024^2 and at 8192^2 (512 MiB moved, past the L2), the
   matmul at the probe's 1024^3 and at 4096^3, float32 and bfloat16
   inputs, each with kernel and library per-launch and CUDA-graph times,
   its bound by the units it uses and Tflop/s (:func:`probe_phase`);
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
import signal
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
# The JAX package's north-star telescope "ns2" (scratch/northstar2.py's
# preset: a PolarisedCylinder, 2 x 9 feeds 15 m wide, 16 channels over
# 400-500 MHz; lmax 324, mmax 313, 100 baseline pairs, npol 4, pencil up to
# 3,200), at its full width, in its run's last m-window of width 45
# (m = 314 is the window's padding past mmax and is trimmed), with its 10
# Fisher bands over k 0-0.4; the JAX run's spectra of that window (a TPU,
# float32) for a printed comparison
NS2_PARAMS = dict(
    num_freq=16,
    freq_start=400.0,
    freq_end=500.0,
    freq_mode="edge",
    num_cylinders=2,
    cylinder_width=15.0,
    num_feeds=9,
    feed_spacing=1.0,
    tsys=50.0,
    single_precision=True,
)
NS2_WINDOW = (270, 315)
NS2_CPU_M = (270, 313)
NS2_FULL_M = 4  # m of the one bucket=False batch held against the bucketed run
NS2_BAND_EDGES = np.linspace(0.0, 0.4, 11)
NS2_RECORD = "ckpt/ns2_windows/w06_270_315_exact_highest_solve_bcast_f1.npz"
# [ns2 retained]: the same telescope in the JAX run's second m-window, where
# modes pass 0.1 (the record: 1,026 retained, top 0.245, a 10-band Fisher of
# max 0.453), cut in depth to its first NS2_RETAINED_M m; m
# NS2_RETAINED_CPU_M against the CPU
NS2_RETAINED_WINDOW = (45, 90)
NS2_RETAINED_M = 8  # the window's m that chip_smoke.py runs (one m-chunk)
NS2_RETAINED_CPU_M = (45, 52)
NS2_RETAINED_RECORD = "ckpt/ns2_windows/w01_45_90_exact_highest_solve_bcast_f1.npz"
# [ns1b window]: the JAX package's scale-axis telescope "ns1b"
# (scratch/northstar2.py's preset: a PolarisedCylinder, 2 x 4 feeds 31 m
# wide, 32 channels over 400-800 MHz, ndays 733; lmax 1035, mmax 1032, 40
# baseline pairs, 1,280 units, pencil up to 2,560) at full width in the JAX
# run's first m-window, under the run's nside cap of 1024 (the boost would
# take the longest units to nside 2048); the SHT budget lets 16 units of
# nside 1024 share one call (the default 2 GB lets one)
NS1B_PARAMS = dict(
    num_freq=32,
    freq_start=400.0,
    freq_end=800.0,
    freq_mode="edge",
    num_cylinders=2,
    cylinder_width=31.0,
    num_feeds=4,
    feed_spacing=1.5,
    tsys=50.0,
    single_precision=True,
    ndays=733,
)
NS1B_WINDOW = (0, 33)
NS1B_NSIDE_CAP = 1024
NS1B_SHT_BUDGET_GB = 32.0
NS1B_RECORD = "ckpt/ns1b_windows/w00_0_33_exact_highest_solve_bcast_f1.npz"
# Tolerances of the comparisons with the JAX run's records (a TPU: float32
# tables, a float32 Gram-eigendecomposition SVD that keeps the polarisation
# filter's rounding residue as modes, a float32 KL engine; PERF.md section
# 6): where the record retains modes, its retained count within
# REC_COUNT_RTOL, its retained eigenvalues rank by rank within
# REC_RETAINED_TOP of each m's top eigenvalue (a float32 SVD and pencil's
# error on this card, ROADMAP's precision rule: its rounding is a fraction of
# the top, not of each eigenvalue) and its Fisher within REC_FISHER_RTOL of
# max|F|; where it retains none, none retained.  SVD mode counts and sub-cut
# spectra are printed.
REC_COUNT_RTOL = 5e-2
REC_RETAINED_TOP = 4.3e-2
REC_FISHER_RTOL = 1e-1
# [oldcylinder]: the legacy sinc-beam polarised cylinder
# (telescope/oldcylinder.py, the manager's plugin form) at bench's polarised
# layout and 4 channels
OLDCYL_PARAMS = POL_PARAMS
# [chunked 128] past the BTM: the product chain on a subset of its 228 m,
# the first four (pencils up to 128 x 44 = 5,632) and four high m (the
# l >= m rows thin out: up to 128 x 18)
CHUNKED_128_M = (0, 1, 2, 3, 214, 217, 220, 223)
# [slice windows]: the bench cylinder's 226 m in two m-windows
SLICE_WINDOWS = ((0, 113), (113, 226))
PROBE_N = 1024  # scratch/pallas_probe.py's shapes
PROBE_DOUBLE_LARGE = 8192  # 512 MiB moved: past the 50 MB L2
PROBE_MM_LARGE = 4096  # a matmul that fills the card

PROBE_KERNELS = ("probe_double", "probe_mm")
# [chunked]: mem_chunk 0.1 GiB holds 64 of the bench cylinder's 176 units
# (each (2, npol, nl, nm) complex128, 1.66 MB), so 3 chunks; [chunked 128]:
# its 2,816 units at the default 3 GiB (1,936 a chunk) take 2
CHUNKED_MEM_GB = 0.1
CHUNKED_CHUNKS = 3
# the polarised cylinder's units (npol 4, nl 121, nm 113: 1.75 MB each) in
# chunks of 18
CHUNKED_POL_MEM_GB = 0.03
CHUNKED_128_CHUNKS = 2
# [mp products]: [chunked]'s config under torchrun, two ranks on the one
# card: mem_chunk CHUNKED_MEM_GB a rank, so 2 chunks of 128 units
MP_NPROC = 2
MP_CHUNKS = 2
MP_MC_SAMPLES = 500
MP_TIMEOUT_S = 600
FILE_PATH_KERNELS = ["k1k2_beam_vis", "k3k5_legendre_sht", "k9_signal_gram", "k15a_sandwich",
                     "k15b_fisher_trace"]
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


T_START = time.time()


def log(msg):
    print(msg, flush=True)


def mark(what):
    """A line with the seconds since the script started, after a phase."""
    log(f"[time] {what}: {time.time() - T_START:.1f} s since the start")


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


def fisher_bands(tel, nbands=4, edges=None):
    """(nbands, nl, F, F) polar-annulus band spectra (bench._fisher_bands),
    or the bands between ``edges``."""
    from driftscan_tpu_torch.core import psestimation, skymodel

    edges = np.linspace(0.02, 0.25, nbands + 1) if edges is None else edges
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
            tag="kernels", bitwise=False, per_launch=False, graph=False,
            library_per_launch=False):
    """Kernel vs plain on the same inputs: max error, tolerance, times; the
    bound of ``work`` = (bytes, [(flops, rate), ...]) and the time of one
    PyTorch call computing the same function (``library_fn``), if any.
    With ``bitwise`` a second kernel call must repeat the first bit for
    bit.  ``per_launch`` adds launch_ms (and graph_ms with ``graph``) to
    the log; ``library_per_launch`` the same for the library call, and
    returns all four under ``"device"``."""
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
    device = {}
    if per_launch:
        per = device["launch_ms"] = launch_ms(kernel_fn)
        extra = f"; per launch {per:.4f} ms ({bound_ms / per:.4f} of bound)"
        if graph:
            device["graph_ms"] = graph_ms(kernel_fn)
            extra += f", in a graph {device['graph_ms']:.4f} ms"
        if library_per_launch and library_fn is not None:
            device["library_launch_ms"] = launch_ms(library_fn)
            extra += f"; library per launch {device['library_launch_ms']:.4f} ms"
            if graph:
                device["library_graph_ms"] = graph_ms(library_fn)
                extra += f", in a graph {device['library_graph_ms']:.4f} ms"
    log(
        f"[{tag}] {name}: max_abs_err {err:.6e} (max|plain| {scale:.6e}, "
        f"rel tol {rtol:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"library {lib} bound {bound_ms:.4f} ms ({bound_by}; "
        f"{bound_ms / ms:.4f} of bound){extra}"
    )
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    if library_per_launch:
        rec["device"] = device
    return rec


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
    n = resident.pencil_size(tel)
    k, K = k17_shape(n)
    keep("k17_cheb_step", k17_compare(8, n, K, k, rng, "slice"))
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
def legendre_table_lib(nm, nside, lmax, dtype, m_lo=0):
    """The JAX package's lambda table (ops/sht.py's ``legendre_table``, the
    plain versions' recurrence), (lmax + 1, nm, nring) for m = m_lo ..
    m_lo + nm - 1 on the card in the real type of ``dtype``: the operand
    of the library form of K3+K5 and K14.  Built once per key (the last
    one kept) and timed apart (host clock around a synchronised build),
    never inside ``library_ms``."""
    import torch

    from driftscan_tpu_torch.ops import healpix, sht

    g = healpix.ring_geometry(nside)
    ct = torch.as_tensor(g.cos_theta, device="cuda")
    st = torch.as_tensor(g.sin_theta, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    mvals = m_lo + torch.arange(nm, device="cuda")
    logpref = torch.as_tensor(sht._log_lambda_mm_prefactor(lmax), device="cuda")
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    lam = sht.legendre_table(mvals, ct, st, lmax, logpref).to(rdt)
    torch.cuda.synchronize()
    log(f"[lambda table] {tuple(lam.shape)} {rdt} for the library calls: built in "
        f"{(time.time() - t0) * 1e3:.1f} ms (not in library_ms)")
    return lam


def _sign_m(nm, rdt, scale=1.0, m_lo=0):
    """scale * (-1)^m for m = m_lo .. m_lo + nm - 1, on the card."""
    import torch

    m = m_lo + torch.arange(nm, device="cuda")
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


def k3k5_compare(F, G, g, lmax, rtol, what, tag="kernels", reps=5, m_lo=0):
    """K3+K5 against its plain version on phase-stage outputs F, G (B, nm,
    nring) for m = m_lo .. m_lo + nm - 1 (all <= lmax) at the rings of
    ``g``, with a bitwise repeat; library: one einsum a plane over the
    cached lambda table of those m (the JAX package's form).
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
    nlam = sum(lmax + 1 - m for m in range(m_lo, m_lo + nm)) * nring
    c128 = F.dtype == torch.complex128
    ops = [(RECURRENCE_FLOPS * nlam, F64_CUDA_CORE_FLOPS),
           (8.0 * B * nlam, F64_FLOPS if c128 else GRAM_FLOPS)]
    moved = nbytes(F, G, ct, st) + 2 * B * (lmax + 1) * nm * F.element_size()
    if not c128:
        cuda_core_ms = bound(moved, [(8.0 * B * nlam, F32_FLOPS)])[0]
        log(f"[{tag}] k3k5_legendre_sht ({what}): the CUDA-core bound (the products alone "
            f"at 67 TFLOP/s float32, no recurrence) {cuda_core_ms:.4f} ms")
    lam = legendre_table_lib(nm, g.nside, lmax, F.dtype, m_lo)
    fr, gr = torch.view_as_real(F), torch.view_as_real(G)
    w_pos = torch.full((nm,), area, dtype=lam.dtype, device="cuda")
    w_neg = _sign_m(nm, lam.dtype, area, m_lo)

    def library():
        return (torch.einsum("lmr,bmrc,m->blmc", lam, fr, w_pos),
                torch.einsum("lmr,bmrc,m->blmc", lam, gr, w_neg))

    rec = compare(
        f"k3k5_legendre_sht ({what}, lmax {lmax}, nring {nring}, {F.dtype})",
        lambda: sht.legendre_contract(F, G, ct, st, lmax, area, m_lo),
        lambda: sht.legendre_contract_ref(F, G, ct, st, lmax, area, m_lo),
        rtol=rtol, reps=reps, tag=tag, work=(moved, ops), library_fn=library, bitwise=True,
    )
    del lam
    if not c128:
        # the plain version rounds lambda and its sums to float32 too: the
        # kernel and it against the float64 truth on the same inputs, and
        # the kernel no farther from it
        wide = [x.to(torch.complex128) for x in (F, G)]
        truth = sht.legendre_contract_ref(*wide, ct, st, lmax, area, m_lo)
        del wide
        errs = []
        for fn in (sht.legendre_contract, sht.legendre_contract_ref):
            out = fn(F, G, ct, st, lmax, area, m_lo)
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


def k3k5_window_compare(ntel, rng):
    """K3+K5 over an m-window at the ``[ns2 window]`` path's shape: one SHT
    call of its largest nside's first chunk (B = units x 4 Stokes) at m
    ``NS2_WINDOW``, complex64, against its plain version (rel 1e-5), with
    its library call and bound (:func:`k3k5_compare`); then the same call's
    columns against a full-range call's columns of the same inputs, which
    must be bitwise equal."""
    import torch

    from driftscan_tpu_torch.ops import healpix, sht

    ns, blc, _, sub_lmax = first_chunk(ntel)
    g = healpix.ring_geometry(ns)
    B = len(blc) * ntel._npol_transform
    m0, m1 = NS2_WINDOW
    Ff = _crandn(rng, (B, sub_lmax + 1, g.nring), torch.complex64, ntel.device)
    Gf = _crandn(rng, (B, sub_lmax + 1, g.nring), torch.complex64, ntel.device)
    F, G = Ff[:, m0:m1].contiguous(), Gf[:, m0:m1].contiguous()
    rec = k3k5_compare(F, G, g, sub_lmax, 1e-5, f"[ns2 window] m {m0}..{m1 - 1}: B {B}",
                       reps=5, m_lo=m0)
    legendre_table_lib.cache_clear()
    ct = torch.as_tensor(g.cos_theta, device=F.device)
    st = torch.as_tensor(g.sin_theta, device=F.device)
    area = 4.0 * np.pi / g.npix
    win = sht.legendre_contract(F, G, ct, st, sub_lmax, area, m0)
    full = sht.legendre_contract(Ff, Gf, ct, st, sub_lmax, area)
    same = all(torch.equal(w, f[..., m0:m1]) for w, f in zip(win, full))
    log(f"[kernels] k3k5_legendre_sht window m {m0}..{m1 - 1}: columns "
        f"{'bitwise equal' if same else 'differ from'} the full-range call's")
    if not same:
        raise AssertionError("k3k5_legendre_sht: a window's columns differ from the full range's")
    return rec


def k13_compare(t, M, k, rng, tag="kernels", F=None, S=None, nb=NBANDS):
    """K13 against its plain version for an m-batch of M items with k
    retained modes, at ``t``'s path shapes (``nb`` bands of rank <= F, the
    l axis padded to 64), or a compacted chunk's F and S, with its library
    call and bound."""
    import torch

    from driftscan_tpu_torch.parallel import mstep, resident

    dev = t.device
    nl = t.lmax + 1
    F = t.nfreq if F is None else F
    S = resident.pencil_size(t) // t.nfreq if S is None else S

    def crandn(shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.as_tensor(z.astype(np.complex64), device=dev)

    v = crandn((M, k, F, S))
    bt = crandn((M, F, S, nl))
    nlp = -(-nl // 64) * 64
    Kb = F
    blt = torch.as_tensor(rng.standard_normal((nb, nlp, F, Kb)).astype(np.float32), device=dev)
    y = mstep.fisher_factor(v, bt, blt)
    # G = V B_T (8 flops a complex multiply-add) and Y_b = G L_b (4 a
    # complex x real one) on the CUDA cores, the Hermitian half of
    # C_b = Y_b Y_b^H over l < nl as 3xTF32
    ops = [(8.0 * M * k * F * nl * S + 4.0 * M * nb * k * nl * Kb * F, F32_FLOPS),
           (8.0 * M * nb * k * (k + 1) / 2 * nl * Kb, GRAM_FLOPS)]
    return compare(
        f"k13_fisher_cov (M {M}, k {k}, F {F}, S {S}, nb {nb}, nlp {nlp}, Kb {Kb})",
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


def trace_compare(k, rng, dtype=None, M=None, tag="kernels", nb=NBANDS):
    """K15b at ``nb`` bands of k modes (an m-batch of M where the fused
    Fisher step calls it): against the plain version; the library call is
    the JAX program's, a scale and one matmul of the flattened stacks."""
    import torch

    from driftscan_tpu_torch.ops import projections

    dtype = dtype or torch.complex128
    dev = torch.device("cuda")
    lead = () if M is None else (M,)
    c = _crandn(rng, lead + (nb, k, k), dtype, dev)
    w = torch.as_tensor(rng.random(lead + (k,)), device=dev).to(c.real.dtype)

    def library():
        d = c * (w[..., None, :, None] * w[..., None, None, :])
        flat = lead + (nb, k * k)
        return d.reshape(flat) @ c.transpose(-1, -2).reshape(flat).transpose(-1, -2)

    # one pass over the stack (C_a and C_b are the same tensor on every
    # path); per term a complex product, the weight and the sum, in float64
    nitem = M or 1
    name = f"k15b_fisher_trace (M {M}, nb {nb}, k {k}, {dtype})"
    # float64 sums whatever the input type: 1e-12 for complex64 too
    rtol = 1e-12
    rec = compare(
        name,
        lambda: projections.fisher_trace(c, c, w),
        lambda: projections.fisher_trace_ref(c, c, w),
        rtol=rtol, tag=tag,
        work=(nbytes(c, w) + nitem * nb * nb * 16,
              [(10.0 * nitem * nb * nb * k * k, F64_FLOPS)]),
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


def k17_shape(n):
    """(k, K) of K17 on a pencil of dimension n: the top-band engine's
    starting basis width (resident._run_topband) and the whitened signal
    factor's width (n: the compact signal path)."""
    from driftscan_tpu_torch.parallel import resident

    return resident._quant_frac(max(n // resident._TB_START_FRAC, 8), n), n


def k17_compare(M, n, K, k, rng, what, tag="kernels"):
    """K17 (one Chebyshev filter step, complex128) at (M, n, K, k) against
    its plain version: V_out within 1e-12 of max|V_out|, and the running
    scale s = 1 / (amax + 1e-30) within 1e-13 rel (below that the plain
    version's own summation order shows: a K-term complex sum rounds at
    ~eps sqrt(K) of its size); two launches repeat bit for bit.  The
    library time is two PyTorch calls computing the same function:
    ``torch.baddbmm`` (one alpha for all m) and an inf-norm for amax.
    bytes: Y, W, V_k, V_p read once, V_out written once; operations:
    8 M n K k float64 flops (the product Y W) at the float64 peak.  Prints
    the tile ``cheb.plan`` chose for the shape."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import cheb

    dev = torch.device("cuda")
    y = _crandn(rng, (M, n, K), torch.complex128, dev)
    vk = _crandn(rng, (M, n, k), torch.complex128, dev)
    vp = _crandn(rng, (M, n, k), torch.complex128, dev)
    w = (y.mH @ vk).contiguous()
    a0, beta, gamma = 2.0 * 2.0 / 7.5, -2.0, -1.0
    alpha = torch.full((M,), a0, dtype=torch.float64, device=dev)
    c = beta * vk + gamma * vp

    def library():
        out = torch.baddbmm(c, y, w, alpha=a0)
        return out, torch.linalg.vector_norm(torch.view_as_real(out), ord=float("inf"),
                                             dim=(-3, -2, -1))

    rec = compare(
        f"k17_cheb_step ({what}: M {M}, n {n}, K {K}, k {k}, complex128)",
        lambda: cheb.cheb_step(y, w, vk, vp, alpha, beta, gamma),
        lambda: cheb.cheb_step_ref(y, w, vk, vp, alpha, beta, gamma),
        rtol=1e-12, tag=tag,
        work=(nbytes(y, w, vk, vp, alpha) + 16 * M * n * k + 8 * M,
              [(8.0 * M * n * K * k, F64_FLOPS)]),
        library_fn=library, bitwise=True, per_launch=True, graph=True,
        library_per_launch=True,
    )
    got = cheb.cheb_step(y, w, vk, vp, alpha, beta, gamma)[1]
    ref = cheb.cheb_step_ref(y, w, vk, vp, alpha, beta, gamma)[1]
    s_err = float(((1.0 / (got + 1e-30)) / (1.0 / (ref + 1e-30)) - 1.0).abs().max())
    p = cheb.plan(M, n, K, k, backend.sm_count(dev))
    log(f"[{tag}] k17_cheb_step ({what}): plan {p.bm} x {p.bn} tiles (mt {p.mt}, nt {p.nt}, "
        f"warps {p.wr} x {p.wc}, depth split {p.wks}), grid {p.grid}, {p.blocks} blocks, "
        f"{p.threads} threads, {p.smem} B shared memory")
    t_mm = median_ms(lambda: torch.baddbmm(c, y, w, alpha=a0))
    out = torch.baddbmm(c, y, w, alpha=a0)
    t_norm = median_ms(lambda: torch.linalg.vector_norm(
        torch.view_as_real(out), ord=float("inf"), dim=(-3, -2, -1)))
    log(f"[{tag}] k17_cheb_step ({what}): scale s rel err {s_err:.3e} (tol 1e-13); library "
        f"calls apart: baddbmm {t_mm:.4f} ms, inf-norm {t_norm:.4f} ms ({card_line()})")
    if not s_err <= 1e-13:
        raise AssertionError(f"k17_cheb_step ({what}): scale off by {s_err:.3e}")
    return rec


def path_k13(tag, tel, evals, ps_threshold, chunks, launches, m_lo=0, nb=NBANDS):
    """K13 at the k the product path launched it with: per m-chunk of the
    run (``chunks``, :class:`resident.Chunk`), the chunk's largest retained
    count (``resident.fisher_k``, the path's own rule), one k per launch
    the path counted; timed at the largest and the median of the launched
    k, each at its chunk's batch and (compacted) F and S."""
    from driftscan_tpu_torch.parallel import resident

    shapes = []
    for ch in chunks:
        rows = ch.m_values[ch.m_values >= 0] - m_lo
        k = resident.fisher_k(evals[rows], ps_threshold)
        if k:
            shapes.append((k, len(ch.m_values), ch.fq, ch.sq))
    shapes.sort()
    log(f"[{tag}] K13 launches at (k, M, F, S) {shapes}")
    if len(shapes) != launches:
        raise AssertionError(f"{tag}: {len(shapes)} K13 shapes for {launches} launches")
    rng = np.random.default_rng(SEED + 1)
    import torch

    k, M, F, S = shapes[-1]
    big = k13_compare(tel, M, k, rng, tag=f"{tag} kernels", F=F, S=S, nb=nb)
    k2, M2, F2, S2 = shapes[len(shapes) // 2]
    k13_compare(tel, M2, k2, rng, tag=f"{tag} kernels", F=F2, S=S2, nb=nb)
    # the Fisher step's trace over K13's covariances, at the same k
    trace_compare(k, rng, dtype=torch.complex64, M=M, tag=f"{tag} kernels", nb=nb)
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
    # bucket=None: the m-bucketing's auto rule decides, as for a user
    kw = dict(band_lt=band_lt, ps_threshold=ps_threshold or PS_THRESHOLD)
    log(f"[{tag}] bucket auto: {'bucketed' if resident.auto_bucket(tel, nm) else 'full size'}")

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
    chunks = []
    t0 = time.time()
    pos, neg = resident.btm_resident(tel, blg, fig)
    torch.cuda.synchronize()
    t1 = time.time()
    evals, nmodes, fisher = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, chunks=chunks, **kw
    )
    torch.cuda.synchronize()
    t2 = time.time()
    launches = launch_counts()
    log(f"[{tag}] m-chunks: {describe_chunks(chunks)}")

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

    cpu_check(tag, tel, pos, neg, ls, lf, noisew, band_lt, ps_threshold, chunks)
    k13_rec = path_k13(tag, tel, evals, ps_threshold, chunks, launches["k13_fisher_cov"])
    run = {"evals": evals, "nmodes": nmodes, "fisher": fisher, "rate": nm / (t_btm + t_prod),
           "t_btm": t_btm, "t_product": t_prod, "ps_threshold": ps_threshold,
           "tables": (pos, neg)}
    return launches, required, k13_rec, run


def describe_chunks(chunks):
    """How many m-chunks of a run went at full size and compacted, with
    the compacted (fq, sq) shapes and their counts."""
    from collections import Counter

    full = sum(not c.compacted for c in chunks)
    shapes = Counter((c.fq, c.sq) for c in chunks if c.compacted)
    return (f"{len(chunks)} dispatched, {full} full size, {len(chunks) - full} compacted "
            f"(fq, sq): {dict(sorted(shapes.items()))}")


def cpu_check(tag, tel, pos, neg, ls, lf, noisew, band_lt, ps_threshold, chunks,
              m_lo=None, checks=None):
    """m-modes of a run again, on the card and on CPU tensors from the same
    tables, through the run's own m-chunks (``chunks``: the same batches,
    whose adaptive sig1 depth is chosen per batch, and the same compacted
    frequency and mode axes): retained spectra, and the whole spectrum,
    within 1e-4 of each m's top eigenvalue (the whole spectrum keeps the
    check meaningful where no mode is retained, as at high m), partial
    Fisher within 3e-2 of its max.  ``checks`` [(name, [m, ...])] defaults
    to the first and last CPU_CHECK_M m; ``m_lo`` reads window tables."""
    import torch

    from driftscan_tpu_torch.parallel import mstep, resident

    if checks is None:
        ms = np.concatenate([c.m_values[c.m_values >= 0] for c in chunks])
        k = min(CPU_CHECK_M, len(ms))
        checks = (("first", ms[:k]), ("last", ms[-k:]))

    def run(p, n, mine):
        rdt = p.real.dtype
        ls_t, lf_t, band_t = mstep.factors_from_numpy(ls, lf, band_lt, p.device, rdt)
        nw = torch.as_tensor(noisew, dtype=rdt, device=p.device)
        evs, fish = {}, 0.0
        for ch in mine:
            ev, _, f = resident.product_m_batch(
                tel, p, n, ls_t, lf_t, nw, ch.m_values, band_lt=band_t,
                ps_threshold=ps_threshold, m_lo=m_lo, chunk=ch,
            )
            evs.update({int(m): ev[i] for i, m in enumerate(ch.m_values) if m >= 0})
            fish = fish + f
        return evs, fish

    pos_c, neg_c = pos.cpu(), neg.cpu()
    for name, want in checks:
        want = [int(m) for m in want]
        mine = [c for c in chunks if np.isin(c.m_values, want).any()]
        ev_g, f_g = run(pos, neg, mine)
        t = time.time()
        ev_c, f_c = run(pos_c, neg_c, mine)
        t_cpu = time.time() - t
        ev_g = np.stack([ev_g[m] for m in want])
        ev_c = np.stack([ev_c[m] for m in want])
        kept = (ev_c > ps_threshold) | (ev_g > ps_threshold)
        top = np.maximum(ev_c.max(axis=1, keepdims=True), 1e-30)
        rel = np.abs(ev_g - ev_c) / top
        ev_err = float(rel[kept].max()) if kept.any() else 0.0
        all_err = float(rel.max())
        f_err = float(np.abs(f_g - f_c).max() / max(np.abs(f_c).max(), 1e-300))
        shapes = sorted({(len(c.m_values), c.fq, c.sq) for c in mine})
        log(
            f"[{tag}] cpu check {name} m {want[0]}..{want[-1]} (chunks (M, fq, sq) {shapes}, "
            f"cpu {t_cpu:.2f} s): "
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


def slice_windows_phase(tel, slice_run, tag="slice windows"):
    """The bench cylinder in the m-windows ``SLICE_WINDOWS`` through
    ``btm_resident(m_range=)`` and ``product_all_resident(m_range=)`` with
    the fused Fisher and the auto bucketing, against ``[slice]`` (its run
    dict): each window's tables bitwise equal to the ``[slice]`` tables'
    columns, the SVD mode counts equal, spectra within rtol 2e-4 / atol
    1e-6 of the top, the summed Fisher within 1e-3 of max |F|.  Returns
    the launch counts of the windows' run."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.parallel import mstep, resident

    blg, fig = units(tel)
    cl_s, cl_n, noisew = covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    band_lt = mstep.band_factor_table(
        iter(fisher_bands(tel)), out_dtype=np.float32, rank_rtol=1e-9
    )
    pos_f, neg_f = slice_run["tables"]
    thr = slice_run["ps_threshold"]
    evs, nmos, fish, t_all = [], [], 0.0, 0.0
    backend.reset_launch_counts()
    for m0, m1 in SLICE_WINDOWS:
        chunks = []
        t0 = time.time()
        pos, neg = resident.btm_resident(tel, blg, fig, m_range=(m0, m1))
        torch.cuda.synchronize()
        t1 = time.time()
        ev, nmo, f = resident.product_all_resident(
            tel, pos, neg, ls, lf, noisew, m_range=(m0, m1), band_lt=band_lt,
            ps_threshold=thr, chunks=chunks,
        )
        torch.cuda.synchronize()
        t2 = time.time()
        t_all += t2 - t0
        lo = max(m0, 1)
        same = (torch.equal(pos, pos_f[..., m0:m1])
                and torch.equal(neg[..., lo - m0 :], neg_f[..., lo - 1 : m1 - 1])
                and (m0 > 0 or not bool(neg[..., 0].any())))
        log(f"[{tag}] m {m0}..{m1 - 1}: bucket auto "
            f"{'bucketed' if resident.auto_bucket(tel, m1 - m0, m0) else 'full size'}, "
            f"{describe_chunks(chunks)}; t_btm {t1 - t0:.4f} s t_product_fisher "
            f"{t2 - t1:.4f} s; tables {'bitwise equal to' if same else 'differ from'} "
            f"[slice]'s columns")
        if not same:
            raise AssertionError(f"{tag} m {m0}..{m1 - 1}: tables differ from [slice]'s columns")
        evs.append(ev)
        nmos.append(nmo)
        fish = fish + f
        del pos, neg
    launches = launch_counts()
    ev, nmo = np.concatenate(evs), np.concatenate(nmos)
    want_ev, want_f = slice_run["evals"], slice_run["fisher"]
    scale = float(want_ev.max())
    ev_err = float((np.abs(ev - want_ev) / (2e-4 * np.abs(want_ev) + 1e-6 * scale)).max())
    f_err = float(np.abs(fish - want_f).max() / np.abs(want_f).max())
    counts_equal = bool(np.array_equal(nmo, slice_run["nmodes"]))
    log(f"[{tag}] {ev.shape[0]} m in {len(SLICE_WINDOWS)} windows: {t_all:.4f} s, m-modes/s "
        f"{ev.shape[0] / t_all:.4f}; svd mode counts {'equal' if counts_equal else 'differ'}; "
        f"spectra vs [slice] {ev_err:.3e} of the tolerance (rtol 2e-4, atol 1e-6 of the top); "
        f"summed Fisher vs [slice] {f_err:.3e} of max |F| (tol 1e-3); launches {launches}")
    if not counts_equal:
        raise AssertionError(f"{tag}: svd mode counts differ from [slice]'s")
    if not ev_err <= 1.0:
        raise AssertionError(f"{tag}: spectra differ from [slice]'s beyond rtol 2e-4 / atol 1e-6")
    if not (np.isfinite(fish).all() and f_err <= 1e-3):
        raise AssertionError(f"{tag}: summed Fisher {f_err:.3e} of max |F| from [slice]'s > 1e-3")
    required, _, _ = path_kernels(tel, ls.shape[-1])
    require_launched(tag, launches, required)
    require_map_kernel(tag, tel, launches)
    return launches


def ns2_window_phase(ntel, tag="ns2 window"):
    """The north-star telescope ``ns2`` at full width in the m-window
    ``NS2_WINDOW`` through ``btm_resident(m_range=)`` and
    ``product_all_resident(bucket=True, m_range=, band_lt=, ps_threshold=0.1)``
    (the JAX run's last window).  Gates: at least one compacted chunk;
    spectra and Fisher finite, the Fisher Hermitian; m ``NS2_CPU_M`` again
    alone in their chunks' compacted shapes on the card and on the CPU
    (:func:`cpu_check`, 1e-4 of each m's top); the first ``NS2_FULL_M``
    m in one ``bucket=False`` batch against the bucketed spectra (rtol 2e-4
    above 1e-3 of each m's top; the whole spectrum 1e-4 of the top).
    Printed only: mode counts and the top 20 eigenvalues of each m against
    the JAX run's record (a TPU in float32).  Returns the launch counts of
    the bucketed run and of :func:`topband_ns2_phase` on the same tables."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.parallel import mstep, resident

    m0, m1 = NS2_WINDOW
    nreal = min(m1, ntel.mmax + 1) - m0
    blg, fig = units(ntel)
    t = time.time()
    cl_s, cl_n, noisew = covariances(ntel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    band_lt = mstep.band_factor_table(
        iter(fisher_bands(ntel, edges=NS2_BAND_EDGES)), out_dtype=np.float32, rank_rtol=1e-9
    )
    log(f"[{tag}] lmax {ntel.lmax} mmax {ntel.mmax} npairs {ntel.npairs} nfreq {ntel.nfreq} "
        f"npol {ntel.num_pol_sky} units {len(blg)} pencil n {resident.pencil_size(ntel)} "
        f"window m {m0}..{m1 - 1} ({nreal} real) ls {ls.shape} lf {lf.shape} band_lt "
        f"{band_lt.shape}; covariances and tables {time.time() - t:.2f} s; bucket auto "
        f"{'bucketed' if resident.auto_bucket(ntel, m1 - m0, m0) else 'full size'}")
    kw = dict(band_lt=band_lt, ps_threshold=PS_THRESHOLD)

    from driftscan_tpu_torch.ops import fpencil

    backend.reset_launch_counts()
    chunks = []
    retries = fpencil.svd_retries
    t0 = time.time()
    pos, neg = resident.btm_resident(ntel, blg, fig, m_range=(m0, m1))
    torch.cuda.synchronize()
    t1 = time.time()
    evals, nmodes, fisher = resident.product_all_resident(
        ntel, pos, neg, ls, lf, noisew, bucket=True, m_range=(m0, m1), chunks=chunks, **kw
    )
    torch.cuda.synchronize()
    t2 = time.time()
    launches = launch_counts()
    evals, nmodes = evals[:nreal], nmodes[:nreal]
    t_btm, t_prod = t1 - t0, t2 - t1
    # the run's first ns2 BTM: cold (cuFFT plans for nside 512's ring lengths
    # included); experiments/ns2_btm_breakdown.py times a warm one
    log(f"[{tag}] t_btm {t_btm:.4f} s (cold)  t_product_fisher {t_prod:.4f} s  m-modes/s "
        f"{nreal / (t_btm + t_prod):.4f}  tables {nbytes(pos, neg) / 2**30:.4f} GiB  top ev "
        f"{float(evals.max()):.6e}  retained (ev > {PS_THRESHOLD:g}) "
        f"{int((evals > PS_THRESHOLD).sum())}  svd modes {int(nmodes.sum())}  launches {launches}")
    log(f"[{tag}] m-chunks: {describe_chunks(chunks)}; per chunk (first m, M, fq, sq): "
        f"{[(int(c.m_values[0]), len(c.m_values), c.fq, c.sq) for c in chunks]}; Gram "
        f"eigensolves that failed in cuSOLVER and took the SVD: {fpencil.svd_retries - retries}")
    if not any(c.compacted for c in chunks):
        raise AssertionError(f"{tag}: no m-chunk ran compacted")
    if not (np.isfinite(evals).all() and np.isfinite(fisher).all()):
        raise AssertionError(f"{tag}: non-finite spectra or Fisher")
    fscale = float(np.abs(fisher).max())
    if not np.abs(fisher - fisher.conj().T).max() <= 1e-4 * fscale:
        raise AssertionError(f"{tag}: Fisher matrix not Hermitian")
    log(f"[{tag}] Fisher max |F| {fscale:.6e} (zero when no mode passes {PS_THRESHOLD:g})")
    names = [map_kernel(ntel), "k3k5_legendre_sht"]
    nl = ntel.lmax + 1
    if any(mstep.uses_compact_signal(c.fq * c.sq, nl * ls.shape[-1]) for c in chunks):
        names.append("k9_signal_gram")
    if fscale > 0:
        names += ["k13_fisher_cov", "k15b_fisher_trace"]
    require_launched(tag, launches, names)
    require_map_kernel(tag, ntel, launches)

    # m NS2_CPU_M alone, each in its chunk's compacted shape (no mode
    # passes the sig1 bound here, so the depth is the batch's)
    alone = []
    for m in NS2_CPU_M:
        ch = next(c for c in chunks if m in c.m_values)
        alone.append(ch._replace(m_values=np.array([m])))
    cpu_check(tag, ntel, pos, neg, ls, lf, noisew, band_lt, PS_THRESHOLD, alone, m_lo=m0,
              checks=[(f"m {m}", [m]) for m in NS2_CPU_M])

    # the first NS2_FULL_M m in one full-size batch
    retries = fpencil.svd_retries
    t3 = time.time()
    ev_f, nmo_f, _ = resident.product_all_resident(
        ntel, pos, neg, ls, lf, noisew, bucket=False, m_range=(m0, m1), max_m=NS2_FULL_M,
        mbatch=NS2_FULL_M, **kw
    )
    torch.cuda.synchronize()
    t_full = time.time() - t3
    ev_b = evals[:NS2_FULL_M]
    top = ev_b.max(axis=1, keepdims=True)
    band = ev_b > 1e-3 * top
    band_err = float((np.abs(ev_f - ev_b)[band] / np.abs(ev_b[band])).max())
    all_err = float((np.abs(ev_f - ev_b) / top).max())
    log(f"[{tag}] bucket=False, one batch of {NS2_FULL_M} m: {t_full:.4f} s "
        f"({t_full / NS2_FULL_M:.4f} s a m at pencil n {ev_f.shape[1]}; bucketed "
        f"{t_prod / nreal:.4f} s a m, its sizing pass included); spectra vs bucketed: rel "
        f"{band_err:.3e} above 1e-3 of each m's top (tol 2e-4), whole {all_err:.3e} of the "
        f"top (tol 1e-4); svd modes {'equal' if np.array_equal(nmo_f, nmodes[:NS2_FULL_M]) else 'differ'}; "
        f"Gram eigensolves that took the SVD: {fpencil.svd_retries - retries}")
    if not (band_err <= 2e-4 and all_err <= 1e-4):
        raise AssertionError(f"{tag}: bucketed spectra differ from the full-size batch's")

    rec_path = os.path.join(HERE, NS2_RECORD)
    if os.path.exists(rec_path):
        with np.load(rec_path) as z:
            jev, jnmo = z["ev"], z["nmo"]
        k = min(len(jev), nreal)
        dn = nmodes[:k].sum(axis=1) - jnmo[:k].sum(axis=1)
        top20 = np.abs(evals[:k, -20:] - jev[:k, -20:]) / np.maximum(jev[:k, -1:], 1e-300)
        log(f"[{tag}] against the JAX run's record ({NS2_RECORD}; a TPU, float32; not "
            f"gated): svd modes a m, card minus record: min {int(dn.min())} max "
            f"{int(dn.max())} total {int(dn.sum())} of {int(jnmo[:k].sum())}; top 20 "
            f"eigenvalues, |card - record| / record top: max {float(top20.max()):.3e} "
            f"median {float(np.median(top20)):.3e}")
    tb_launches = topband_ns2_phase(ntel, pos, neg, ls, lf, noisew, kw, m0, m1)
    del pos, neg
    return launches, tb_launches


def record_compare(tag, evals, nmodes, fisher, path, cut=PS_THRESHOLD):
    """The card's run of an m-window against the JAX run's record of the
    same window (``path``: ``ev`` (nm, n) ascending, ``nmo`` (nm, F),
    ``fish``; a TPU in float32).  Where the record retains modes above
    ``cut``: the retained count within REC_COUNT_RTOL, the retained
    eigenvalues rank by rank within each m (the modes both retain) within
    REC_RETAINED_TOP of that m's top, the Fisher (``fisher``; None for a run of part of
    the window) within REC_FISHER_RTOL of the record's max|F|; where it
    retains none: none retained on the card.  SVD mode counts and each m's
    top 20 eigenvalues are printed."""
    with np.load(os.path.join(HERE, path)) as z:
        jev, jnmo, jfish = z["ev"], z["nmo"], z["fish"]
    z_ev = jev
    k = min(len(jev), len(evals))
    ev, jev = np.sort(evals[:k], axis=1)[:, ::-1], np.sort(jev[:k], axis=1)[:, ::-1]
    dn = nmodes[:k].sum(axis=1) - jnmo[:k].sum(axis=1)
    log(f"[{tag}] against the JAX run's record ({path}; a TPU, float32): svd modes a m, card "
        f"{nmodes[:k].sum(axis=1).min()}..{nmodes[:k].sum(axis=1).max()} (total "
        f"{int(nmodes[:k].sum())}), record {jnmo[:k].sum(axis=1).min()}.."
        f"{jnmo[:k].sum(axis=1).max()} (total {int(jnmo[:k].sum())}); card minus record by m: "
        f"min {int(dn.min())} max {int(dn.max())}")
    n = min(ev.shape[1], jev.shape[1])
    ev, jev = ev[:, :n], jev[:, :n]
    top20 = np.abs(ev[:, :20] - jev[:, :20]) / np.maximum(jev[:, :1], 1e-300)
    tops = np.abs(ev[:, 0] - jev[:, 0]) / np.maximum(jev[:, 0], 1e-300)
    kept, jkept = int((ev > cut).sum()), int((jev > cut).sum())
    log(f"[{tag}] record: top eigenvalue {float(jev.max()):.6e} (card {float(ev.max()):.6e}); "
        f"each m's top, |card - record| / record: max {float(tops.max()):.3e} median "
        f"{float(np.median(tops)):.3e}; top 20 of each m, of its top: max "
        f"{float(top20.max()):.3e} median {float(np.median(top20)):.3e}; retained (ev > "
        f"{cut:g}) card {kept}, record {jkept}")
    if jkept == 0:
        # the sub-cut spectrum: not gated (the JAX engine's adaptive depth
        # leaves it inaccurate in absolute terms; ROADMAP's traps)
        if kept:
            raise AssertionError(f"{tag}: the card retains {kept} modes, the record none")
        log(f"[{tag}] record: none retained on either side (gated); the sub-cut spectra above "
            f"are printed, not gated")
        return
    both = (ev > cut) & (jev > cut)
    rels = np.where(both, np.abs(ev - jev) / np.where(both, jev, 1.0), 0.0)
    of_top = np.where(both, np.abs(ev - jev) / jev[:, :1], 0.0)
    rel = float(rels.max())
    wm, wr = np.unravel_index(int(np.argmax(rels)), rels.shape)
    cm, jm = (ev > cut).sum(axis=1), (jev > cut).sum(axis=1)
    odd = [(int(i), int(cm[i]), int(jm[i])) for i in np.nonzero(cm != jm)[0]]
    log(f"[{tag}] record: retained eigenvalues rank by rank, rel: max {rel:.3e} (row {wm}, rank "
        f"{wr}: card {float(ev[wm, wr]):.6e}, record {float(jev[wm, wr]):.6e}; that row's "
        f"ranks {max(wr - 2, 0)}..{wr + 2}: card {ev[wm, max(wr - 2, 0):wr + 3].tolist()}, record "
        f"{jev[wm, max(wr - 2, 0):wr + 3].tolist()}) median "
        f"{float(np.median(rels[both])):.3e} over {int(both.sum())} modes both retain; of each "
        f"m's top: max {float(of_top.max()):.3e}; rows whose retained counts differ (row, card, "
        f"record) {odd}")
    fscale = float(np.abs(jfish).max())
    gates = [(f"retained count {kept} vs the record's {jkept}, rel", abs(kept - jkept) / jkept,
              REC_COUNT_RTOL),
             ("retained eigenvalues vs the record's, rank by rank, of each m's top",
              float(of_top.max()), REC_RETAINED_TOP)]
    if fisher is None:
        log(f"[{tag}] record: its Fisher sums the whole window; a run of {k} of its "
            f"{len(z_ev)} m is not held against it")
    else:
        gates.append((f"Fisher {fisher.shape} vs the record's (max|F| {fscale:.6e}, card "
                      f"{float(np.abs(fisher).max()):.6e}), of max",
                      float(np.abs(fisher - jfish).max()) / fscale, REC_FISHER_RTOL))
    for what, err, tol in gates:  # every figure printed before any gate fails
        log(f"[{tag}] {what}: {err:.3e} (tol {tol:g})")
    bad = [f"{what} {err:.3e} > {tol:g}" for what, err, tol in gates if not err <= tol]
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))


def window_tables(tag, tel, window, band_edges):
    """Covariance factors, the band table of ``band_edges`` and the window's
    BTM tables of ``tel``, with the log line of its shapes; returns (pos,
    neg, ls, lf, noisew, band_lt, t_btm)."""
    import torch

    from driftscan_tpu_torch.parallel import mstep, resident

    m0, m1 = window
    blg, fig = units(tel)
    cl_s, cl_n, noisew = covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    band_lt = mstep.band_factor_table(
        iter(fisher_bands(tel, edges=band_edges)), out_dtype=np.float32, rank_rtol=1e-9
    )
    log(f"[{tag}] lmax {tel.lmax} mmax {tel.mmax} npairs {tel.npairs} nfreq {tel.nfreq} "
        f"npol {tel.num_pol_sky} units {len(blg)} pencil n {resident.pencil_size(tel)} "
        f"window m {m0}..{m1 - 1} ls {ls.shape} lf {lf.shape} band_lt {band_lt.shape}; "
        f"bucket auto {'bucketed' if resident.auto_bucket(tel, m1 - m0, m0) else 'full size'}")
    t = time.time()
    pos, neg = resident.btm_resident(tel, blg, fig, m_range=window)
    torch.cuda.synchronize()
    return pos, neg, ls, lf, noisew, band_lt, time.time() - t


def ns2_retained_phase(ntel, tag="ns2 retained", nm=NS2_RETAINED_M, ntb=NS2_RETAINED_M,
                       cpu_m=NS2_RETAINED_CPU_M):
    """ns2 at full width in the m-window ``NS2_RETAINED_WINDOW``, where
    modes pass 0.1: ``btm_resident(m_range=)`` and ``product_all_resident``
    over its first ``nm`` m (all with None; bucketed, as the JAX run that
    made the record and ``[ns2 window]``: the auto rule's analytic bound
    would run these m at full size, n 3,200, where the SVD keeps ~550 modes
    a m; the 10 bands of k 0-0.4, ps_threshold 0.1), the counts zeroed just
    before and read just after, then its first ``ntb`` m (one m-chunk) on
    the same tables with ``topband=True, kl_cut=0.1``.  Gates: spectra and
    Fisher finite, the Fisher Hermitian and non-zero; K13 and K15b launched
    (and the map kernel, K3+K5, K9 where the path takes it); m ``cpu_m``
    against the CPU (:func:`cpu_check`); the top-band engine's retained set
    equal to the exact engine's and its retained eigenvalues within
    TB_CHECK_RTOL, K17 launched; the record (:func:`record_compare`; its
    Fisher sums the whole window, so only a run of the whole window holds
    the Fisher against it).  Printed: SVD modes a m, the times beside the
    TPU run's, K13 and K15b against their plain versions at the shapes the
    path launched (:func:`path_k13`).  ``chip_smoke.py`` runs the first
    NS2_RETAINED_M m (the whole window's exact product takes ~145 s of its
    time budget); ``driftscan_tpu_torch/experiments/ns2_retained.py`` runs
    the whole window.  Returns the launch counts of both runs."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import cheb
    from driftscan_tpu_torch.parallel import mstep, resident

    m0, m1 = NS2_RETAINED_WINDOW
    nreal = min(m1, ntel.mmax + 1) - m0
    if nm is not None:
        nreal = min(nreal, nm)
    backend.reset_launch_counts()
    pos, neg, ls, lf, noisew, band_lt, t_btm = window_tables(tag, ntel, NS2_RETAINED_WINDOW,
                                                             NS2_BAND_EDGES)
    kw = dict(band_lt=band_lt, ps_threshold=PS_THRESHOLD)
    chunks = []
    t = time.time()
    evals, nmodes, fisher = resident.product_all_resident(
        ntel, pos, neg, ls, lf, noisew, bucket=True, m_range=NS2_RETAINED_WINDOW,
        max_m=nm, chunks=chunks, **kw)
    torch.cuda.synchronize()
    t_prod = time.time() - t
    launches = launch_counts()
    evals, nmodes = evals[:nreal], nmodes[:nreal]
    with np.load(os.path.join(HERE, NS2_RETAINED_RECORD)) as z:
        tb_rec, tp_rec = float(z["tb"]), float(z["tp"])
    retained = int((evals > PS_THRESHOLD).sum())
    log(f"[{tag}] t_btm {t_btm:.4f} s  t_product_fisher {t_prod:.4f} s  m-modes/s "
        f"{nreal / (t_btm + t_prod):.4f} (the TPU run's record: btm {tb_rec:.1f} s, product "
        f"{tp_rec:.1f} s, on a TPU)  top ev {float(evals.max()):.6e}  retained (ev > "
        f"{PS_THRESHOLD:g}) {retained}  svd modes a m {nmodes.sum(axis=1).min()}.."
        f"{nmodes.sum(axis=1).max()} (mean {float(nmodes.sum(axis=1).mean()):.1f})  launches "
        f"{launches}")
    log(f"[{tag}] m-chunks: {describe_chunks(chunks)} ({card_line()})")
    if not (np.isfinite(evals).all() and np.isfinite(fisher).all()):
        raise AssertionError(f"{tag}: non-finite spectra or Fisher")
    fscale = float(np.abs(fisher).max())
    if not (fscale > 0 and np.abs(fisher - fisher.conj().T).max() <= 1e-4 * fscale):
        raise AssertionError(f"{tag}: Fisher zero or not Hermitian (max|F| {fscale:.3e})")
    log(f"[{tag}] Fisher max |F| {fscale:.6e}, diag {np.round(np.diagonal(fisher).real, 9).tolist()}")
    names = [map_kernel(ntel), "k3k5_legendre_sht", "k13_fisher_cov", "k15b_fisher_trace"]
    if any(mstep.uses_compact_signal(c.fq * c.sq, (ntel.lmax + 1) * ls.shape[-1])
           for c in chunks):
        names.append("k9_signal_gram")
    require_launched(tag, launches, names)
    require_map_kernel(tag, ntel, launches)

    alone = []
    for m in cpu_m:
        ch = next(c for c in chunks if m in c.m_values)
        alone.append(ch._replace(m_values=np.array([m])))
    cpu_check(tag, ntel, pos, neg, ls, lf, noisew, band_lt, PS_THRESHOLD, alone, m_lo=m0,
              checks=[(f"m {m}", [m]) for m in cpu_m])
    whole = nreal == min(m1, ntel.mmax + 1) - m0
    record_compare(tag, evals, nmodes, fisher if whole else None, NS2_RETAINED_RECORD)
    path_k13(tag, ntel, evals, PS_THRESHOLD, chunks, launches["k13_fisher_cov"], m_lo=m0,
             nb=band_lt.shape[0])

    # the top-band engine on the same tables
    before = dict(resident.TB_COUNTS)
    backend.reset_launch_counts()
    cheb.SHAPES.clear()
    t = time.time()
    ev_t, _, f_t = resident.product_all_resident(
        ntel, pos, neg, ls, lf, noisew, bucket=True, m_range=NS2_RETAINED_WINDOW,
        max_m=ntb, topband=True, kl_cut=PS_THRESHOLD, **kw)
    torch.cuda.synchronize()
    t_tb = time.time() - t
    tb_launches = launch_counts()
    tb = topband_counts(before)
    ev_t = ev_t[:ntb]
    rel, ndiff, near = retained_diff(ev_t, evals[:ntb], PS_THRESHOLD)
    log(f"[{tag}] topband (kl_cut {PS_THRESHOLD:g}) on m {m0}..{m0 + ntb - 1}: {t_tb:.4f} s "
        f"(exact {t_prod * ntb / nreal:.4f} s pro rata): "
        f"solves {tb['solves']}, failed certificates {tb['failed']}, exact fallbacks "
        f"{tb['exact']}; retained {int((ev_t > PS_THRESHOLD).sum())} vs exact "
        f"{int((evals[:ntb] > PS_THRESHOLD).sum())}, by one only {ndiff}, max rel {rel:.3e} (tol "
        f"{TB_CHECK_RTOL:g}), exact modes within 1e-6 rel of the cut {near}; K17 by (M, n, K, k): "
        f"{k17_shapes()}; launches {tb_launches}")
    if not (np.isfinite(ev_t).all() and np.isfinite(f_t).all()):
        raise AssertionError(f"{tag}: top-band spectra or Fisher not finite")
    if ndiff or not rel <= TB_CHECK_RTOL:
        raise AssertionError(f"{tag}: topband vs exact: {ndiff} modes retained by one engine "
                             f"only, max rel {rel:.3e}")
    require_launched(tag, tb_launches, ["k17_cheb_step", "k13_fisher_cov", "k15b_fisher_trace"])
    del pos, neg
    return launches, tb_launches


def k3k5_ns1b_compare(tel, rng):
    """K3+K5 at the ``[ns1b window]`` path's shape: one SHT call of its
    largest nside's first chunk (B = units x 4 Stokes, under the phase's
    SHT budget and nside cap) at lmax 1035 over m ``NS1B_WINDOW``,
    complex64, against its plain version (rel 1e-5), with its library
    call and bound (:func:`k3k5_compare`): the recurrence
    (``csrc/legendre_rec.cuh``), the schedule and the launch limits past
    lmax 1000."""
    import torch

    from driftscan_tpu_torch.ops import healpix

    ns, blc, _, sub_lmax = first_chunk(tel)
    g = healpix.ring_geometry(ns)
    B = len(blc) * tel._npol_transform
    m0, m1 = NS1B_WINDOW
    F = _crandn(rng, (B, m1 - m0, g.nring), torch.complex64, tel.device)
    G = _crandn(rng, (B, m1 - m0, g.nring), torch.complex64, tel.device)
    rec = k3k5_compare(F, G, g, sub_lmax, 1e-5,
                       f"[ns1b window] nside {ns}, m {m0}..{m1 - 1}: B {B}", reps=3, m_lo=m0)
    legendre_table_lib.cache_clear()
    return rec


def ns1b_env():
    """The environment of ``[ns1b window]``: its nside cap and SHT budget
    (restored by the caller)."""
    return {"DRIFTSCAN_TPU_NSIDE_CAP": str(NS1B_NSIDE_CAP),
            "DRIFTSCAN_TPU_SHT_BUDGET_GB": f"{NS1B_SHT_BUDGET_GB:g}"}


def ns1b_window_phase(tag="ns1b window", run_window=True):
    """ns1b at full width in the m-window ``NS1B_WINDOW`` (lmax 1035, nside
    1024 under the cap and the phase's SHT budget, set here and restored):
    first K3+K5 at the path's shape (:func:`k3k5_ns1b_compare`), with the
    unit batch's map bytes and the lambda table's printed before it; then,
    with ``run_window``, ``btm_resident(m_range=)`` and
    ``product_all_resident`` (bucket auto, 10 bands of k 0-0.4,
    ps_threshold 0.1), the counts zeroed just before and read just after.
    Gates: spectra and Fisher finite; the map kernel and K3+K5 launched; the
    record (:func:`record_compare`: none retained; the sub-cut spectra
    printed).  ``chip_smoke.py`` runs K3+K5 alone (the window's BTM and
    product take ~90 s: ``driftscan_tpu_torch/experiments/ns1b_window.py``
    runs them).  Returns (launches or None, K3+K5's record at this
    shape)."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import healpix
    from driftscan_tpu_torch.parallel import resident
    from driftscan_tpu_torch.telescope import cylinder

    saved = {k: os.environ.get(k) for k in ns1b_env()}
    os.environ.update(ns1b_env())
    try:
        tel = cylinder.PolarisedCylinderTelescope.from_config(NS1B_PARAMS, device="cuda")
        m0, m1 = NS1B_WINDOW
        ns, blc, _, sub_lmax = first_chunk(tel)
        g = healpix.ring_geometry(ns)
        B = len(blc) * tel._npol_transform
        maps_gb = B * g.nring * g.maxlen * 8 / 2**30
        lam_gb = (sub_lmax + 1) * (m1 - m0) * g.nring * 8 / 2**30
        log(f"[{tag}] {', '.join(f'{k}={v}' for k, v in ns1b_env().items())}: the largest "
            f"nside {ns} ({g.nring} rings), {len(blc)} units a call, B {B} Stokes maps of "
            f"{g.nring} x {g.maxlen} padded complex64 pixels: {maps_gb:.2f} GiB "
            f"a call; the library's float64 lambda table ({sub_lmax + 1}, {m1 - m0}, "
            f"{g.nring}): {lam_gb:.2f} GiB")
        rec = k3k5_ns1b_compare(tel, np.random.default_rng(SEED + 8))
        if not run_window:
            return None, rec
        nreal = min(m1, tel.mmax + 1) - m0
        backend.reset_launch_counts()
        pos, neg, ls, lf, noisew, band_lt, t_btm = window_tables(tag, tel, NS1B_WINDOW,
                                                                 NS2_BAND_EDGES)
        chunks = []
        t = time.time()
        evals, nmodes, fisher = resident.product_all_resident(
            tel, pos, neg, ls, lf, noisew, m_range=NS1B_WINDOW, chunks=chunks,
            band_lt=band_lt, ps_threshold=PS_THRESHOLD)
        torch.cuda.synchronize()
        t_prod = time.time() - t
        launches = launch_counts()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    evals, nmodes = evals[:nreal], nmodes[:nreal]
    with np.load(os.path.join(HERE, NS1B_RECORD)) as z:
        tb_rec, tp_rec = float(z["tb"]), float(z["tp"])
    log(f"[{tag}] t_btm {t_btm:.4f} s  t_product_fisher {t_prod:.4f} s  m-modes/s "
        f"{nreal / (t_btm + t_prod):.4f} (the TPU run's record: btm {tb_rec:.1f} s, product "
        f"{tp_rec:.1f} s, on a TPU)  tables {nbytes(pos, neg) / 2**30:.4f} GiB  top ev "
        f"{float(evals.max()):.6e}  retained {int((evals > PS_THRESHOLD).sum())}  svd modes "
        f"{int(nmodes.sum())}  m-chunks: {describe_chunks(chunks)}  launches {launches} "
        f"({card_line()})")
    if not (np.isfinite(evals).all() and np.isfinite(fisher).all()):
        raise AssertionError(f"{tag}: non-finite spectra or Fisher")
    require_launched(tag, launches, [map_kernel(tel), "k3k5_legendre_sht"])
    require_map_kernel(tag, tel, launches)
    record_compare(tag, evals, nmodes, fisher, NS1B_RECORD)
    del pos, neg
    return launches, rec


def oldcylinder_phase(tag="oldcylinder"):
    """The legacy polarised cylinder (``telescope/oldcylinder.py``, reached
    by the manager's plugin form, as a YAML file names it) at bench's
    polarised layout and 4 channels through :func:`path_phase`: its sinc
    beams are evaluated on the host, so the path takes K2-host Stokes and
    K3+K5 (no bank kernel), with path 5's CPU check.  Returns the launch
    counts and the kernels the path requires."""
    from driftscan_tpu_torch.core import manager

    spec = {"module": "driftscan_tpu_torch.telescope.oldcylinder",
            "class": "PolarisedCylinderTelescope"}
    tel = manager._telescope_registry().resolve(spec).from_config(
        OLDCYL_PARAMS, device="cuda")
    log(f"[{tag}] {type(tel).__module__}.{type(tel).__name__}: bank beams "
        f"{tel._bank_beams_apply()}, map kernel {map_kernel(tel)}")
    launches, required, _, run = path_phase(tag, tel)
    require_launched(tag, launches, ["k2_host_stokes", "k3k5_legendre_sht"])
    del run
    return launches, required


TB_CHECK_RTOL = 1e-6  # card vs the port's CPU engine, retained eigenvalues
TB_AB_TIER = 1e-4  # the JAX package's TPU A/B tier, topband vs exact
NS2_TB_M = 4  # m of [topband ns2]
NS2_TB_BAND = 100  # modes a m that [topband ns2]'s band cut keeps at least


def topband_counts(before):
    """The top-band dispatches since ``before`` (a copy of
    resident.TB_COUNTS): solves, failed certificates, exact fallbacks."""
    from driftscan_tpu_torch.parallel import resident

    return {k: resident.TB_COUNTS[k] - before[k] for k in before}


def k17_shapes():
    """K17's launches since ``cheb.SHAPES`` was last cleared, by distinct
    (M, n, K, k), each with the tile ``cheb.plan`` gave it, as a log line."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import cheb

    sms = backend.sm_count(torch.device("cuda"))
    parts = []
    for (M, n, K, k), count in sorted(cheb.SHAPES.items()):
        p = cheb.plan(M, n, K, k, sms)
        parts.append(f"(M {M}, n {n}, K {K}, k {k}) x {count} [{p.bm} x {p.bn}, depth split "
                     f"{p.wks}, {p.blocks} blocks]")
    return "; ".join(parts) or "none"


def path_k17(tag, shapes, rng):
    """K17 against its plain version, timed as in ``[kernels]``, at the
    shape a path launched it most (``shapes``: a copy of ``cheb.SHAPES``
    taken just after the path's counted run)."""
    (M, n, K, k), count = max(shapes.items(), key=lambda kv: (kv[1], kv[0]))
    return k17_compare(M, n, K, k, rng, f"{tag}'s most launched shape, {count} launches",
                       tag=f"{tag} kernels")


def retained_diff(ev, ref, cut):
    """(max rel of ev against ref on the modes either retains above cut,
    modes retained by one only, ref's modes within 1e-6 rel of the cut)."""
    ka, kb = ev > cut, ref > cut
    both = ka & kb
    rel = float((np.abs(ev - ref)[both] / ref[both]).max()) if both.any() else 0.0
    near = int((np.abs(ref / cut - 1.0) <= 1e-6).sum())
    return rel, int((ka ^ kb).sum()), near


def topband_phase(tel, slice_run, tag="topband"):
    """The resident slice with the top-band engine: ``[slice]``'s tables
    through ``product_all_resident(topband=True, kl_cut=0.1)`` with the
    fused Fisher, the launch counts zeroed just before and read just after.
    Gates: K17 launched (and the Fisher's kernels), finite spectra and
    Fisher, every chunk whose certificate failed solved again (solves minus
    failures = chunks minus exact fallbacks), and the card against the
    port's CPU engine on ``cpu_check``'s m (first and last CPU_CHECK_M,
    through the same chunks): retained eigenvalues within rel 1e-6.
    Printed: against the exact engine on the same tables (``[slice]``'s
    run), beside the TPU A/B's 1e-4 tier, and both engines' m-modes/s of
    the product step (``[slice]``'s exact run and the gated run), then K17 against its plain version at the shape the run launched
    it most (:func:`path_k17`).  Returns the launch counts."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import cheb
    from driftscan_tpu_torch.parallel import mstep, resident

    pos, neg = slice_run["tables"]
    nm = tel.mmax + 1
    cl_s, cl_n, noisew = covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    band_lt = mstep.band_factor_table(
        iter(fisher_bands(tel)), out_dtype=np.float32, rank_rtol=1e-9
    )
    kw = dict(band_lt=band_lt, ps_threshold=PS_THRESHOLD, kl_cut=PS_THRESHOLD)
    before = dict(resident.TB_COUNTS)
    backend.reset_launch_counts()
    cheb.SHAPES.clear()
    chunks = []
    t = time.time()
    evals, nmodes, fisher = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, topband=True, chunks=chunks, **kw
    )
    torch.cuda.synchronize()
    t_tb = time.time() - t
    launches = launch_counts()
    shapes = dict(cheb.SHAPES)
    log(f"[{tag}] K17 launches by (M, n, K, k): {k17_shapes()}")
    tb = topband_counts(before)
    n = resident.pencil_size(tel)
    log(f"[{tag}] product_all_resident(topband=True, kl_cut {PS_THRESHOLD:g}) {t_tb:.4f} s; "
        f"m-chunks: {describe_chunks(chunks)}; top-band solves {tb['solves']}, failed "
        f"certificates (each solved again) {tb['failed']}, exact fallbacks {tb['exact']}; "
        f"final (k, levels) by pencil n {dict(resident._TB_STATE)}; launches {launches}")
    if not (np.isfinite(evals).all() and np.isfinite(fisher).all()):
        raise AssertionError(f"{tag}: non-finite spectra or Fisher")
    if tb["solves"] - tb["failed"] != len(chunks) - tb["exact"]:
        raise AssertionError(f"{tag}: a chunk with a failed certificate was not solved again")
    names = ["k17_cheb_step", "k13_fisher_cov", "k15b_fisher_trace"]
    if mstep.uses_compact_signal(n, (tel.lmax + 1) * ls.shape[-1]):
        names.append("k9_signal_gram")
    require_launched(tag, launches, names)

    # against the exact engine on the same tables ([slice]'s run)
    rel, ndiff, near = retained_diff(evals, slice_run["evals"], PS_THRESHOLD)
    fx = slice_run["fisher"]
    f_err = float(np.abs(fisher - fx).max() / np.abs(fx).max())
    log(f"[{tag}] vs the exact engine ([slice]'s run, same tables; not gated): retained "
        f"{int((evals > PS_THRESHOLD).sum())} vs {int((slice_run['evals'] > PS_THRESHOLD).sum())}"
        f" modes, retained by one engine only {ndiff}, max rel on retained {rel:.3e} (TPU A/B "
        f"tier {TB_AB_TIER:g}), exact modes within 1e-6 rel of the cut {near}, Fisher "
        f"|diff| / max|F| {f_err:.3e}")

    # the card against the port's CPU engine, through the same chunks
    ls_c, lf_c, _ = mstep.factors_from_numpy(ls, lf, None, "cpu", pos.real.dtype)
    nw_c = torch.as_tensor(noisew, dtype=pos.real.dtype)
    pos_c, neg_c = pos.cpu(), neg.cpu()
    row = {}
    for i, ch in enumerate(chunks):
        for j, m in enumerate(ch.m_values):
            if m >= 0:
                row[int(m)] = (i, j)
    ms = sorted(row)
    k_chk = min(CPU_CHECK_M, len(ms))
    for name, want in (("first", ms[:k_chk]), ("last", ms[-k_chk:])):
        t = time.time()
        got = {}
        for i in sorted({row[m][0] for m in want}):
            ch = chunks[i]
            ev_c, _, _ = resident.product_m_batch(
                tel, pos_c, neg_c, ls_c, lf_c, nw_c, ch.m_values, chunk=ch,
                kl_cut=PS_THRESHOLD,
            )
            if ch.compacted:
                ev_c = np.pad(ev_c, ((0, 0), (evals.shape[1] - ev_c.shape[1], 0)))
            got.update({int(m): ev_c[j] for j, m in enumerate(ch.m_values) if m >= 0})
        ev_c = np.stack([got[m] for m in want])
        ev_g = evals[np.asarray(want)]
        rel_c, ndiff_c, _ = retained_diff(ev_g, ev_c, PS_THRESHOLD)
        log(f"[{tag}] cpu check {name} m {want[0]}..{want[-1]} ({time.time() - t:.2f} s): "
            f"retained {int((ev_c > PS_THRESHOLD).sum())} modes, retained by one side only "
            f"{ndiff_c}, max rel card vs cpu {rel_c:.3e} (tol {TB_CHECK_RTOL:g})")
        if ndiff_c or not rel_c <= TB_CHECK_RTOL:
            raise AssertionError(f"{tag} {name}: card vs cpu {rel_c:.3e}, {ndiff_c} modes differ")

    # both engines' product step on the same tables: [slice]'s exact run and
    # the gated run above (its escalation included)
    t_x = slice_run["t_product"]
    log(f"[{tag}] product step with the fused Fisher, s: exact {t_x:.4f} ([slice]), topband "
        f"{t_tb:.4f}; m-modes/s exact {nm / t_x:.4f}, topband {nm / t_tb:.4f} ({card_line()})")
    path_k17(tag, shapes, np.random.default_rng(SEED + 6))
    return launches


def band_cut(ev, nmin, depth=1e-6):
    """A cut from the spectra ``ev`` (rows ascending) under which each row
    holds its ``nmin`` largest eigenvalues, or those within ``depth`` of its
    top where fewer (deeper, an eigenvalue's relative accuracy in float64
    falls towards the tolerance): the lowest of the rows' candidates,
    moved to the geometric midpoint of the gap under it, so that no
    eigenvalue of that row lies at the cut."""
    top = ev[:, -1]
    cand = np.maximum(ev[:, -nmin], depth * top)
    i = int(np.argmin(cand))
    j = int(np.searchsorted(ev[i], cand[i]))  # the smallest eigenvalue >= cand
    hi, lo = float(ev[i, j]), float(ev[i, j - 1])
    return float(np.sqrt(hi * lo)) if lo > 0 else 0.5 * hi


def topband_ns2_phase(ntel, pos, neg, ls, lf, noisew, kw, m0, m1, tag="topband ns2"):
    """``[ns2 window]``'s tables at full size (n 3200, not bucketed), its
    first NS2_TB_M m in one batch, by the exact engine and by the top-band
    engine (counts zeroed just before the top-band runs, read just after;
    K17 must launch).  The top-band engine runs twice: at the product cut
    kl_cut = PS_THRESHOLD, where these m's band is empty (their top
    eigenvalue is ~1e-9), and at a cut taken from the exact run's own
    spectra (:func:`band_cut`) under which every m holds its
    NS2_TB_BAND largest modes or those within 1e-6 of its top.  Gates on the second: the same retained set as the
    exact engine and retained eigenvalues within rel TB_CHECK_RTOL.
    Printed: seconds a m of each run (the whole product step, then the KL
    stage alone on one SVD stage), how many Gram eigensolves of the
    exact route failed in cuSOLVER and took the SVD, and K17 against its
    plain version at the shape the runs launched it most
    (:func:`path_k17`).  Returns the launch
    counts of the top-band runs."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import cheb, fpencil
    from driftscan_tpu_torch.parallel import mstep, resident

    common = dict(bucket=False, m_range=(m0, m1), max_m=NS2_TB_M, mbatch=NS2_TB_M, **kw)
    retries = fpencil.svd_retries
    t = time.time()
    ev_x, _, f_x = resident.product_all_resident(ntel, pos, neg, ls, lf, noisew, **common)
    torch.cuda.synchronize()
    t_x = time.time() - t
    svd_x = fpencil.svd_retries - retries
    n = ev_x.shape[1]
    cut_b = band_cut(ev_x, NS2_TB_BAND)
    log(f"[{tag}] m {m0}..{m0 + NS2_TB_M - 1} at pencil n {n}, one batch, exact engine: "
        f"{t_x / NS2_TB_M:.4f} s a m (Gram eigensolves that failed in cuSOLVER and took the "
        f"SVD: {svd_x}); top ev by m {ev_x[:, -1].tolist()}; retained above kl_cut "
        f"{PS_THRESHOLD:g}: {int((ev_x > PS_THRESHOLD).sum())}; the band cut {cut_b:.6e} "
        f"(each m's top {NS2_TB_BAND} or its modes within 1e-6 of its top) retains by m "
        f"{(ev_x > cut_b).sum(axis=1).tolist()}")
    before = dict(resident.TB_COUNTS)
    backend.reset_launch_counts()
    cheb.SHAPES.clear()
    runs = []
    for cut in (PS_THRESHOLD, cut_b):
        b4, retries = dict(resident.TB_COUNTS), fpencil.svd_retries
        t = time.time()
        ev_t, _, f_t = resident.product_all_resident(
            ntel, pos, neg, ls, lf, noisew, topband=True, kl_cut=cut, **common
        )
        torch.cuda.synchronize()
        runs.append((cut, time.time() - t, ev_t, f_t, topband_counts(b4),
                     fpencil.svd_retries - retries, resident._TB_STATE.get(n)))
    launches = launch_counts()
    shapes = dict(cheb.SHAPES)
    log(f"[{tag}] K17 launches by (M, n, K, k): {k17_shapes()}")
    tb = topband_counts(before)
    for i, (cut, dt, ev_t, f_t, c, svd_t, state) in enumerate(runs):
        rel, ndiff, near = retained_diff(ev_t, ev_x, cut)
        what = "the product cut" if cut == PS_THRESHOLD else "the band cut"
        log(f"[{tag}] topband at kl_cut {cut:.6e} ({what}; run {i + 1} of {len(runs)}): "
            f"{dt / NS2_TB_M:.4f} s a m (exact {t_x / NS2_TB_M:.4f}); solves {c['solves']}, "
            f"failed certificates {c['failed']}, exact fallbacks {c['exact']}, (k, levels) "
            f"after {state}, Gram eigensolves that took the SVD {svd_t}; retained "
            f"{int((ev_t > cut).sum())} vs exact {int((ev_x > cut).sum())}, by one only "
            f"{ndiff}, max rel {rel:.3e} (tol {TB_CHECK_RTOL:g} at the band cut), exact modes "
            f"within 1e-6 rel of the cut {near} ({card_line()})")
        if not (np.isfinite(ev_t).all() and np.isfinite(f_t).all()):
            raise AssertionError(f"{tag}: non-finite spectra or Fisher")
        if cut != PS_THRESHOLD and (ndiff or not rel <= TB_CHECK_RTOL):
            raise AssertionError(f"{tag}: band cut {cut:.3e}: {ndiff} modes retained by one "
                                 f"engine only, max rel {rel:.3e}")
    log(f"[{tag}] top-band runs: solves {tb['solves']}, failed certificates {tb['failed']}, "
        f"exact fallbacks {tb['exact']}; launches {launches}")
    require_launched(tag, launches, ["k17_cheb_step"])

    # the KL stage alone, on one SVD stage of the same m: the engines' own cost
    dev, rdt = pos.device, pos.real.dtype
    ls_t, lf_t, _ = mstep.factors_from_numpy(ls, lf, None, dev, rdt)
    nw_t = torch.as_tensor(np.asarray(noisew), dtype=rdt, device=dev)
    nl, npol = ntel.lmax + 1, ntel.num_pol_sky
    mvt = torch.arange(m0, m0 + NS2_TB_M, device=dev)
    beam = resident._build_beam_batch(pos, neg, mvt, ntel.npairs, ntel.nfreq, npol, nl,
                                      m_lo=m0)
    comp = mstep.compress_step(beam, nw_t, ls_t, lf_t, mvt, npol=npol, nl=nl)
    k, lv = resident._TB_STATE.get(n, (n // resident._TB_START_FRAC, 5))
    stage = {}
    for name, kwargs in (
        ("exact (1 Gram level, as the resident route's first solve)", dict(sig_levels=1)),
        (f"topband at the product cut ({k}, {lv})",
         dict(kl_cut=PS_THRESHOLD, kl_top_k=k, kl_levels=lv)),
        (f"topband at the band cut ({k}, {lv})", dict(kl_cut=cut_b, kl_top_k=k, kl_levels=lv)),
    ):
        retries = fpencil.svd_retries
        torch.cuda.synchronize()
        t = time.time()
        res = mstep.kl_solve_step(comp, **kwargs)
        torch.cuda.synchronize()
        stage[name] = (time.time() - t, fpencil.svd_retries - retries, bool(res.ok.all()))
    del comp, beam
    log(f"[{tag}] the KL stage alone (one SVD stage, {NS2_TB_M} m), s a m, Gram eigensolves "
        f"that took the SVD, certificates passed: "
        + "; ".join(f"{k_}: {v[0] / NS2_TB_M:.4f}, {v[1]}, {v[2]}" for k_, v in stage.items())
        + f" ({card_line()})")
    path_k17(tag, shapes, np.random.default_rng(SEED + 7))
    return launches


def convert_phase(outdir):
    """``drift-makeproducts-torch convert`` on a copy of ``[products]``'
    directory, in a subprocess, where h5py imports; on a host without
    h5py (the card host) it is logged as not exercised."""
    try:
        import h5py
    except ImportError:
        log("[convert] not exercised: this host has no h5py, so its product files are "
            "the .npy directory store; the converter runs on the CPU in "
            "tests/test_torch_store_convert.py")
        return
    copy = tempfile.mkdtemp(prefix="driftscan_convert_")
    try:
        target = os.path.join(copy, "products")
        shutil.copytree(outdir, target)
        t = time.time()
        out = subprocess.run(
            [sys.executable, "-m", "driftscan_tpu_torch.scripts.makeproducts", "convert", target],
            cwd=HERE, capture_output=True, text=True, timeout=600,
        )
        if out.returncode != 0:
            raise AssertionError(f"[convert] failed: {out.stderr[-2000:]}")
        for d, _, files in os.walk(target):
            for f in files:
                if f.endswith(".hdf5"):
                    with h5py.File(os.path.join(d, f), "r"):
                        pass
        log(f"[convert] {out.stdout.strip().splitlines()[-1] if out.stdout.strip() else 'done'} "
            f"({time.time() - t:.2f} s); every .hdf5 opens in h5py")
    finally:
        shutil.rmtree(copy, ignore_errors=True)


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
        f"t_beams {tm['beams']:.4f} s (BTM {tm['beams'] - tm['beams.svd']:.4f}: compute "
        f"{tm['beams.btm_compute']:.4f}, write {tm['beams.btm_write']:.4f})  "
        f"t_svd {tm['beams.svd']:.4f} s  "
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
    return launches, nkl, (mi, ev_fact)


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


def topband_products_phase(outdir, factored, tag="topband products"):
    """``[products]``' config with two more filters, ``kl_tb`` and ``dk_tb``:
    its KL and DoubleKL sections with ``engine: topband``, added to the
    directory's ``config.yaml`` (after ``klinv``) and generated by a second
    ``generate()``, which writes only them; counts zeroed just before and
    read just after (K17 must launch).  Gates, per m against ``kl`` and
    ``dk``: ``num_modes`` equal, retained eigenvalues within rel 1e-6.
    ``[products]`` rewrote one m of ``kl`` through the dense per-m path
    (``factored`` = (that m, its factored ``evals_full`` from before)); that
    m is held against its factored spectrum.  Printed: the chunks that fell
    back to the exact engine, and K17 against its plain version at the
    shape the run launched it most (:func:`path_k17`).  Returns the launch
    counts."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.core import manager
    from driftscan_tpu_torch.ops import cheb
    from driftscan_tpu_torch.util import store

    conf = products_config(outdir)
    conf["kltransform"] += [
        {"type": "KLTransform", "name": "klinv", "threshold": PS_THRESHOLD, "inverse": True},
        {"type": "KLTransform", "name": "kl_tb", "threshold": PS_THRESHOLD,
         "engine": "topband"},
        {"type": "DoubleKL", "name": "dk_tb", "engine": "topband"},
    ]
    write_yaml(conf, os.path.join(outdir, "config.yaml"))
    backend.reset_launch_counts()
    cheb.SHAPES.clear()
    t = time.time()
    m = manager.ProductManager.from_config(outdir)
    m.generate()
    torch.cuda.synchronize()
    t_gen = time.time() - t
    launches = launch_counts()
    shapes = dict(cheb.SHAPES)
    log(f"[{tag}] K17 launches by (M, n, K, k): {k17_shapes()}")
    nm = m.telescope.mmax + 1
    fallback = {}
    for tb_name, ex_name in (("kl_tb", "kl"), ("dk_tb", "dk")):
        tb_kl, ex_kl = m.kltransforms[tb_name], m.kltransforms[ex_name]
        worst, at, modes, fell = 0.0, None, 0, tb_kl.topband_fallback_chunks
        for mi in range(nm):
            with store.File(tb_kl._evfile % mi, "r") as f:
                ev_t, n_t = f["evals"][:], int(f.attrs["num_modes"])
            with store.File(ex_kl._evfile % mi, "r") as f:
                ev_x, n_x = f["evals"][:], int(f.attrs["num_modes"])
            if ex_name == "kl" and mi == factored[0]:
                ev_x = np.sort(factored[1][factored[1] >= PS_THRESHOLD])
                n_x = ev_x.size
            if n_t != n_x:
                raise AssertionError(f"{tag}: {tb_name} m {mi} keeps {n_t} modes, {ex_name} {n_x}")
            if n_x:
                rel = np.abs(ev_t - ev_x) / ev_x
                if rel.max() > worst:
                    j = int(rel.argmax())
                    worst, at = float(rel[j]), (mi, j, ev_t[max(j - 1, 0):j + 2],
                                                ev_x[max(j - 1, 0):j + 2])
            modes += n_x
        fallback[tb_name] = sum(map(len, fell))
        where = "" if at is None else (f" at m {at[0]} mode {at[1]} (topband {at[2].tolist()}, "
                                       f"exact {at[3].tolist()})")
        log(f"[{tag}] {tb_name} vs {ex_name}: num_modes equal for all {nm} m ({modes} modes), "
            f"retained eigenvalues max rel {worst:.3e}{where} (tol 1e-6); chunks that fell "
            f"back to the exact engine {len(fell)} ({fallback[tb_name]} m)")
        if not worst <= 1e-6:
            raise AssertionError(f"{tag}: {tb_name} eigenvalues off {ex_name}'s by {worst:.3e}")
    log(f"[{tag}] generate() of kl_tb and dk_tb {t_gen:.4f} s ({nm / t_gen:.4f} m-modes/s "
        f"for both filters); launches {launches}")
    require_launched(tag, launches, ["k17_cheb_step"])
    path_k17(tag, shapes, np.random.default_rng(SEED + 8))
    return launches


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


class PeakRSS:
    """Peak resident set of this process over a window, in GiB: /proc's
    ``statm`` sampled every 20 ms by a thread (the card host's kernel
    keeps no resettable peak), beside ``ru_maxrss``, the peak since the
    process started."""

    def __enter__(self):
        import threading

        self.peak = self.rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self.rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())
        return False

    @staticmethod
    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30

    @staticmethod
    def since_start():
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def beam_files_equal(tag, ma, mb):
    """Every m's ``beam_m`` of two product runs: (bitwise equal, max |a - b|
    over max |b|)."""
    from driftscan_tpu_torch.util import store

    same, err, top = True, 0.0, 0.0
    for mi in range(ma.telescope.mmax + 1):
        with store.File(ma.beamtransfer._mfile(mi), "r") as f, \
                store.File(mb.beamtransfer._mfile(mi), "r") as g:
            a, b = f["beam_m"][:], g["beam_m"][:]
        if a.shape != b.shape:
            raise AssertionError(f"{tag}: beam_m of m {mi}: shapes {a.shape} and {b.shape}")
        same = same and np.array_equal(a, b)
        err = max(err, float(np.abs(a - b).max()))
        top = max(top, float(np.abs(b).max()))
    return same, err / top


def chunked_phase(outdir, workdir):
    """The chunked streaming BTM generate on the card: ``[products]``' config
    with ``resident: never`` and ``mem_chunk: 0.1`` (64 units a chunk, so 3
    chunks) into ``workdir``, its whole chain against the resident run in
    ``outdir``; then the polarised cylinder's BTM by both routes.  Returns
    the launches of both runs, and the manager of the first."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.core import manager
    from driftscan_tpu_torch.util import store

    tag = "chunked"
    conf = products_config(os.path.join(workdir, "chunked"))
    conf["config"].update(resident="never", mem_chunk=CHUNKED_MEM_GB)
    backend.reset_launch_counts()
    t = time.time()
    m = manager.ProductManager().apply_config(conf)
    m.generate()
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = launch_counts()
    bt, tm = m.beamtransfer, m.timings
    log(
        f"[{tag}] store {store.BACKEND}  chunks {bt.num_chunks}  wall {wall:.4f} s  "
        f"t_beams {tm['beams']:.4f} s (BTM {tm['beams'] - tm['beams.svd']:.4f}: compute "
        f"{tm['beams.btm_compute']:.4f}, write {tm['beams.btm_write']:.4f})  "
        f"t_svd {tm['beams.svd']:.4f} s  t_kl "
        f"{tm['kl.kl']:.4f} s  t_doublekl {tm['kl.dk']:.4f} s  t_ps {tm['ps.ps']:.4f} s  "
        f"launches {launches}"
    )
    if bt.num_chunks != CHUNKED_CHUNKS or bt._mem_beam is not None:
        raise AssertionError(f"{tag}: took {bt.num_chunks} chunks (resident tables "
                             f"{bt._mem_beam is not None}), expected the chunked route in "
                             f"{CHUNKED_CHUNKS}")
    log(f"[{tag}] m-modes/s of the file path (beams + SVD + KL + PSExact, "
        f"{bt.telescope.mmax + 1} m) {file_path_rate(bt.telescope.mmax + 1, tm):.4f}")
    require_launched(tag, launches, FILE_PATH_KERNELS)
    bad = [f for f in products_files(m) if not store.readable(f)]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} product files missing or unreadable: {bad[:4]}")

    # against [products]' resident run of the same config
    ref = manager.ProductManager().apply_config(products_config(outdir))
    same, err = beam_files_equal(tag, m, ref)
    log(f"[{tag}] beam.hdf5 of {bt.telescope.mmax + 1} m, chunked vs resident: "
        f"{'bitwise equal' if same else 'differ'} (max {err:.3e} of max |BTM|; tol 1e-6)")
    if not err <= 1e-6:
        raise AssertionError(f"{tag}: chunked BTM vs resident {err:.3e} > 1e-6")
    sv, sv_r = bt.svd_all(), ref.beamtransfer.svd_all()
    top = np.maximum(sv_r.max(axis=-1, keepdims=True), 1e-300)
    ev, ev_r = m.kltransforms["kl"].evals_all(), ref.kltransforms["kl"].evals_all()
    f_c, f_r = m.psestimators["ps"].fisher_bias()[0], ref.psestimators["ps"].fisher_bias()[0]
    _gate(tag, f"singular values vs [products] ({'bitwise equal' if np.array_equal(sv, sv_r) else 'differ'}; "
          f"svd modes {int((sv > bt.svcut * top).sum())} vs {int((sv_r > bt.svcut * top).sum())}), "
          "of each (m, f)'s top", float((np.abs(sv - sv_r) / top).max()), 1e-3)
    _gate(tag, f"KL spectra vs [products] ({'bitwise equal' if np.array_equal(ev, ev_r) else 'differ'}; "
          f"modes >= {PS_THRESHOLD:g}: {int((ev > PS_THRESHOLD).sum())} vs "
          f"{int((ev_r > PS_THRESHOLD).sum())}), of each m's top",
          float((np.abs(ev - ev_r) / np.maximum(ev_r.max(axis=1, keepdims=True), 1e-30)).max()), 1e-4)
    _gate(tag, f"Fisher vs [products] ({'bitwise equal' if np.array_equal(f_c, f_r) else 'differ'}), "
          "of max|F|", _rel(f_c, f_r), 3e-2)

    # the polarised cylinder's BTM by both routes
    pol = {}
    pol_launches = {}
    for route in ("never", "always"):
        pconf = {"config": {"beamtransfers": True, "skip_svd": True, "resident": route,
                            "mem_chunk": CHUNKED_POL_MEM_GB,
                            "output_directory": os.path.join(workdir, f"pol_{route}")},
                 "telescope": dict(type="PolarisedCylinder", **POL_PARAMS)}
        backend.reset_launch_counts()
        t = time.time()
        pm = manager.ProductManager().apply_config(pconf)
        pm.generate()
        torch.cuda.synchronize()
        pol[route] = pm
        pol_launches[route] = launch_counts()
        log(f"[{tag}] polarised BTM, resident: {route}: {time.time() - t:.4f} s  chunks "
            f"{pm.beamtransfer.num_chunks}  launches {pol_launches[route]}")
    if not (pol["never"].beamtransfer.num_chunks or 0) > 1:
        raise AssertionError(f"{tag}: the polarised BTM took {pol['never'].beamtransfer.num_chunks} "
                             "chunks, expected several")
    require_launched(f"{tag} pol", pol_launches["never"], ["k1k2_stokes_vis", "k3k5_legendre_sht"])
    same, err = beam_files_equal(f"{tag} pol", pol["never"], pol["always"])
    log(f"[{tag}] polarised beam.hdf5, chunked vs resident: "
        f"{'bitwise equal' if same else 'differ'} (max {err:.3e} of max |BTM|; tol 1e-6)")
    if not err <= 1e-6:
        raise AssertionError(f"{tag}: polarised chunked BTM vs resident {err:.3e} > 1e-6")
    return (launches, pol_launches["never"]), m


def file_path_rate(nm, tm):
    """m-modes/s of the file path (beams + SVD + KL + PSExact) from a
    manager's ``timings``."""
    return nm / (tm["beams"] + tm["kl.kl"] + tm["ps.ps"])


def torchrun(module, *args, timeout=MP_TIMEOUT_S):
    """``python -m torch.distributed.run --standalone`` with ``MP_NPROC``
    processes of ``module`` (a script of the port) from this checkout;
    returns (wall seconds, its output).  A failed rendezvous, a rank's
    exception or the time limit fails the phase."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (HERE, env.get("PYTHONPATH")) if p)
    env.setdefault("OMP_NUM_THREADS", "4")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(MP_NPROC), "-m", module, *args]
    t = time.time()
    # its own session, so that the launcher's workers go with it on a timeout
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"torchrun {module}: over {timeout} s:\n" + out[-6000:])
    wall = time.time() - t
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {module} {' '.join(args)}: exit {proc.returncode}:\n"
                             + out[-6000:])
    return wall, out


def rank_stats(tag, path, out):
    """Every rank's ``--stats`` JSON, each checked to be its rank of
    ``MP_NPROC`` and to have logged its device."""
    ranks = []
    for r in range(MP_NPROC):
        with open(path.replace("{rank}", str(r))) as f:
            st = json.load(f)
        if (st["rank"], st["size"]) != (r, MP_NPROC):
            raise AssertionError(f"{tag}: stats of rank {r}: rank {st['rank']} of {st['size']}")
        line = next((ln for ln in out.splitlines()
                     if f"process {r} of {MP_NPROC} on " in ln), None)
        if line is None or "cuda" not in line:
            raise AssertionError(f"{tag}: rank {r} logged no card")
        log(f"[{tag}] rank {r}: {line.split(' - ')[-1].split(': ', 1)[-1]}")
        ranks.append(st)
    return ranks


def mp_products_phase(workdir, chunked, nside, mapfile, ts_ref):
    """``drift-makeproducts-torch run`` and ``drift-runpipeline-torch
    run-config`` under torchrun, two ranks sharing the one card, on
    ``[chunked]``'s config (``resident: never``, ``mem_chunk``
    ``CHUNKED_MEM_GB`` a rank: 2 chunks) with a seeded MonteCarlo beside
    its Full estimator.  Gates: both processes exit 0 and log their card;
    every kernel of the file path launched in each rank; the files against
    ``[chunked]``'s one-process run (manager ``chunked``): beam files bit
    for bit (else within 1e-12 of max), singular values and KL spectra
    within 1e-10 of each row's top, Full Fisher and bias within 1e-10 of
    max, the MonteCarlo's against one process's over the same KL modes
    within 1e-10; then the noiseless ts1 of ``[timestream]`` from
    ``mapfile`` under two ranks, its maps against ``[timestream]``'s ts1
    (directory ``ts_ref``) within 1e-10 (its power spectrum printed).  Prints
    the two-rank walls and m-modes/s beside ``[chunked]``'s.  Returns each
    rank's launches of both runs."""
    import torch

    from driftscan_tpu_torch.core import manager, psmc
    from driftscan_tpu_torch.util import store

    tag = "mp products"
    torch.cuda.empty_cache()  # the ranks share the card with this process
    log(f"[{tag}] {card_line()} | {MP_NPROC} ranks on {torch.cuda.device_count()} card(s); "
        f"this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    mpdir = os.path.join(workdir, "mp")
    conf = products_config(mpdir)
    conf["config"].update(resident="never", mem_chunk=CHUNKED_MEM_GB)
    mc = dict(conf["psfisher"][0], type="MonteCarlo", name="mc", nsamples=MP_MC_SAMPLES,
              seed=SEED)
    conf["psfisher"].append(mc)
    stats = os.path.join(workdir, "mp_stats_{rank}.json")
    wall, out = torchrun("driftscan_tpu_torch.scripts.makeproducts", "run",
                         write_yaml(conf, os.path.join(workdir, "mp.yaml")), "--stats", stats)
    ranks = rank_stats(tag, stats, out)
    if f"Splitting into {MP_CHUNKS} chunks" not in out:
        raise AssertionError(f"{tag}: the BTM did not take the chunked route in {MP_CHUNKS} chunks")
    nm = chunked.telescope.mmax + 1
    rates = []
    for r, st in enumerate(ranks):
        tm = st["timings"]
        rates.append(file_path_rate(nm, tm))
        log(f"[{tag}] rank {r}: t_beams {tm['beams']:.4f} s (BTM compute "
            f"{tm['beams.btm_compute']:.4f}, write {tm['beams.btm_write']:.4f})  t_svd "
            f"{tm['beams.svd']:.4f} s  t_kl {tm['kl.kl']:.4f} s  t_doublekl {tm['kl.dk']:.4f} s"
            f"  t_ps {tm['ps.ps']:.4f} s  t_mc {tm['ps.mc']:.4f} s  launches {st['launches']}")
        require_launched(f"{tag} rank {r}", st["launches"], FILE_PATH_KERNELS)
    log(f"[{tag}] {card_line()}: {MP_NPROC} ranks, torchrun wall {wall:.4f} s; m-modes/s of the "
        f"file path (beams + SVD + KL + PSExact, {nm} m, the slower rank) {min(rates):.4f}; "
        f"[chunked] (one process) {file_path_rate(nm, chunked.timings):.4f}")

    m = manager.ProductManager().apply_config(conf)
    bad = [f for f in products_files(m) if not store.readable(f)]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} product files missing or unreadable: {bad[:4]}")
    same, err = beam_files_equal(tag, m, chunked)
    log(f"[{tag}] beam.hdf5 of {nm} m, 2 ranks vs [chunked]: "
        f"{'bitwise equal' if same else 'differ'} (max {err:.3e} of max |BTM|)")
    if not same:
        _gate(tag, "beam.hdf5, 2 ranks vs [chunked], of max |BTM|", err, 1e-12)

    def rows(a, b):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            raise AssertionError(f"{tag}: shapes {a.shape} and {b.shape}")
        top = np.maximum(np.abs(b).max(axis=-1, keepdims=True), 1e-300)
        return float((np.abs(a - b) / top).max()), np.array_equal(a, b)

    for what, a, b in (
        ("singular values", m.beamtransfer.svd_all(), chunked.beamtransfer.svd_all()),
        ("KL spectra (kl)", m.kltransforms["kl"].evals_all(), chunked.kltransforms["kl"].evals_all()),
        ("KL spectra (dk)", m.kltransforms["dk"].evals_all(), chunked.kltransforms["dk"].evals_all()),
    ):
        err, eq = rows(a, b)
        _gate(tag, f"{what}, 2 ranks vs [chunked] ({'bitwise equal' if eq else 'differ'}), "
              "of each row's top", err, 1e-10)
    def rel0(a, b):
        """:func:`_rel`, or max |a| where b is all zeros (Full's bias)."""
        return _rel(a, b) if np.abs(b).max() > 0 else float(np.abs(a).max())

    for i, what in enumerate(("Fisher", "bias")):
        a = m.psestimators["ps"].fisher_bias()[i]
        b = chunked.psestimators["ps"].fisher_bias()[i]
        _gate(tag, f"Full {what}, 2 ranks vs [chunked] "
              f"({'bitwise equal' if np.array_equal(a, b) else 'differ'}), of max", rel0(a, b), 1e-10)
    # the seeded MonteCarlo of one process over the same KL modes
    t = time.time()
    one = psmc.PSMonteCarlo.from_config(mc, m.kltransforms["kl"], subdir="mc_one")
    one.generate()
    torch.cuda.synchronize()
    log(f"[{tag}] MonteCarlo ({MP_MC_SAMPLES} samples, seed {SEED}) in this process: "
        f"{time.time() - t:.4f} s")
    for i, what in enumerate(("Fisher", "bias")):
        a, b = m.psestimators["mc"].fisher_bias()[i], one.fisher_bias()[i]
        _gate(tag, f"MonteCarlo {what}, 2 ranks vs 1 over the same KL modes "
              f"({'bitwise equal' if np.array_equal(a, b) else 'differ'}), of max", rel0(a, b), 1e-10)

    # the noiseless timestream of [timestream] on these products, 2 ranks
    tsdir = os.path.join(workdir, "mp_ts")
    pconf = {
        "config": {"product_directory": mpdir, "klmodes": ["kl"], "nside": nside,
                   "powerspectra": [{"psname": "ps", "klname": "kl"}]},
        "timestreams": [{"name": "ts1", "directory": f"{tsdir}/ts1",
                         "simulate": {"product_directory": mpdir, "maps": [mapfile],
                                      "ndays": 0}}],
    }
    pstats = os.path.join(workdir, "mp_ts_stats_{rank}.json")
    wall_ts, out = torchrun("driftscan_tpu_torch.scripts.runpipeline", "run-config",
                            write_yaml(pconf, os.path.join(workdir, "mp_ts.yaml")),
                            "--stats", pstats)
    ts_ranks = rank_stats(tag, pstats, out)
    for r, st in enumerate(ts_ranks):
        stages = "  ".join(f"t_{k} {v:.4f} s" for k, v in st["timings"].items())
        log(f"[{tag}] timestream rank {r}: {stages}  launches {st['launches']}")
    log(f"[{tag}] timestream: torchrun wall {wall_ts:.4f} s")
    for name, dset in (("map_full", "map"), ("map_svd", "map"), ("ps_ps", "powerspectrum")):
        with store.File(os.path.join(tsdir, "ts1", f"{name}.hdf5"), "r") as f, \
                store.File(os.path.join(ts_ref, f"{name}.hdf5"), "r") as g:
            a, b = f[dset][:], g[dset][:]
        if not np.isfinite(a).all():
            raise AssertionError(f"{tag}: ts1 {name} not finite")
        what = (f"ts1 {name}, 2 ranks vs [timestream] "
                f"({'bitwise equal' if np.array_equal(a, b) else 'differ'}), of max")
        if name != "ps_ps":
            _gate(tag, what, _rel(a, b), 1e-10)
        else:
            # F^-1 (q - b) carries the last-bit change of the Fisher
            # allreduce's sum order times F's condition number: printed
            cond = np.linalg.cond(np.asarray(m.psestimators["ps"].fisher_bias()[0]).real)
            log(f"[{tag}] {what}: {_rel(a, b):.3e} (Fisher condition number {cond:.3e}; "
                "not gated)")
    return [st["launches"] for st in ranks + ts_ranks]


def chunked_128_phase(workdir):
    """The bench cylinder at 128 channels over its own band, default knobs:
    its tables are over the resident host budget, so ``generate()`` takes
    the chunked route (in 2 chunks); the SVD stage is skipped.  The units
    at the first and last channel x the shortest and longest baseline, at
    m 0, mmax / 2 and mmax, against the port's plain CPU versions.  The
    directory is deleted afterwards.  Returns the launches."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.core import manager
    from driftscan_tpu_torch.telescope import cylinder
    from driftscan_tpu_torch.util import store

    tag = "chunked 128"
    params = dict(BENCH_PARAMS, num_freq=128)
    out = os.path.join(workdir, "chunked128")
    conf = {"config": {"beamtransfers": True, "skip_svd": True, "output_directory": out},
            "telescope": dict(type="UnpolarisedCylinder", **params)}
    m = manager.ProductManager().apply_config(conf)
    tel, bt = m.telescope, m.beamtransfer
    nl, nm = tel.lmax + 1, tel.mmax + 1
    nu = len(tel.included_freq) * len(tel.included_baseline)
    host_gb = nu * tel.num_pol_sky * nl * (2 * nl + 1) * 16 * 2 / 2**30
    log(f"[{tag}] lmax {tel.lmax} nm {nm} units {nu}: resident host estimate {host_gb:.4f} GB "
        f"(budget {bt.resident_host_gb:g}), mem_chunk {bt.mem_chunk:g} GiB")
    backend.reset_launch_counts()
    t = time.time()
    with PeakRSS() as rss:
        base_rss = rss.peak
        m.generate()
        torch.cuda.synchronize()
    t_beams = time.time() - t
    launches = launch_counts()
    written = dir_bytes(os.path.join(out, "bt", "beam_m"))
    tm = m.timings
    log(
        f"[{tag}] store {store.BACKEND}  chunks {bt.num_chunks}  t_beams {t_beams:.4f} s "
        f"(compute {tm['beams.btm_compute']:.4f}, write {tm['beams.btm_write']:.4f})  "
        f"written {written / 2**30:.4f} GiB  host RSS {base_rss:.4f} GiB before, peak "
        f"{rss.peak:.4f} GiB during (peak since start {PeakRSS.since_start():.4f})  "
        f"launches {launches}"
    )
    if bt.num_chunks != CHUNKED_128_CHUNKS or bt._mem_beam is not None or bt._use_resident():
        raise AssertionError(f"{tag}: route {bt.num_chunks} chunks, resident tables "
                             f"{bt._mem_beam is not None}; expected chunked in {CHUNKED_128_CHUNKS}")
    require_launched(tag, launches, ["k1k2_beam_vis", "k3k5_legendre_sht"])

    cpu = cylinder.UnpolarisedCylinderTelescope.from_config(params, device="cpu")
    blen = np.hypot(tel.baselines[:, 0], tel.baselines[:, 1])
    bls = [int(np.argmin(blen)), int(np.argmax(blen))]
    fis = [0, tel.nfreq - 1]
    bl, fi = [x.ravel() for x in np.meshgrid(bls, fis, indexing="ij")]
    t = time.time()
    want = cpu.transfer_matrices(bl, fi)[:, : len(tel.included_pol)]
    t_cpu = time.time() - t
    err = top = 0.0
    ms = (0, tel.mmax // 2, tel.mmax)
    for mi in ms:
        with store.File(bt._mfile(mi), "r") as f:
            d = f["beam_m"]
            got = np.stack([d[f_, :, b_] for b_, f_ in zip(bl, fi)])
        pos = want[..., mi]
        neg = (-1) ** mi * np.conj(want[..., -mi]) if mi else np.zeros_like(pos)
        ref = np.stack([pos, neg], axis=1)[..., mi:]
        err = max(err, float(np.abs(got - ref).max()))
        top = max(top, float(np.abs(ref).max()))
    _gate(tag, f"units (baselines {bls} x channels {fis}) at m {list(ms)} vs the plain CPU "
          f"versions ({t_cpu:.2f} s), of max |BTM| {top:.6e}", err / top, 1e-4)
    for name, count in chunked_128_products(out, params).items():
        launches[name] = launches.get(name, 0) + count
    shutil.rmtree(out)
    return launches


def chunked_128_products(out, params, tag="chunked 128"):
    """The product chain of the 128-channel design past the BTM, on the
    beam files of :func:`chunked_128_phase` in ``out``, cut in depth to the
    m of CHUNKED_128_M (the first four, pencil n up to 128 x 44 = 5,632, and
    four high m): the file path's own SVD stage, KL filter (threshold 0.1)
    and PSExact with the four polar bands, called m-chunk by m-chunk on that
    subset of the files, the counts zeroed just before and read just after.
    Gates: the files of the subset open; the KL spectra of two m (the
    subset's two smallest pencils) against the CPU run of
    the same pencil on the same SVD beams, compacted to its active channels
    and modes (1e-4 of each m's top); the Fisher terms
    (``fisher_bias_m``) of the two m that retain most against the CPU on
    the same KL files (3e-2 of max); the Fisher kernels launched.  Returns
    the launches."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.core import manager
    from driftscan_tpu_torch.ops import projections
    from driftscan_tpu_torch.util import store, util

    conf = products_config(out)
    conf["telescope"] = dict(type="UnpolarisedCylinder", **params)
    conf["kltransform"] = conf["kltransform"][:1]
    m = manager.ProductManager().apply_config(conf)
    tel, bt, kl, ps = m.telescope, m.beamtransfer, m.kltransforms["kl"], m.psestimators["ps"]
    chunks = [list(CHUNKED_128_M[:4]), list(CHUNKED_128_M[4:])]
    os.makedirs(kl.evdir, exist_ok=True)
    backend.reset_launch_counts()
    t0 = time.time()
    writer = util.BackgroundWriter(maxsize=2)
    try:
        for ch in chunks:
            bt._svd_finish_mbatch(*bt._svd_dispatch_mbatch(ch), writer=writer)
    finally:
        writer.close()
    t1 = time.time()
    for ch in chunks:
        kl._transform_save_mbatch(ch)
    torch.cuda.synchronize()
    t2 = time.time()
    ps.genbands()
    fisher = {mi: np.asarray(ps.fisher_bias_m(mi)[0]) for mi in CHUNKED_128_M}
    torch.cuda.synchronize()
    t3 = time.time()
    launches = launch_counts()
    ev = {}
    for mi in CHUNKED_128_M:
        with store.File(kl._evfile % mi, "r") as f:
            ev[mi] = f["evals_full"][:]
    n = {mi: len(v) for mi, v in ev.items()}
    kept = sum(int((v > PS_THRESHOLD).sum()) for v in ev.values())
    log(f"[{tag}] products on m {list(CHUNKED_128_M)} of {tel.mmax + 1} (pencil n {n}): SVD "
        f"{t1 - t0:.4f} s, KL {t2 - t1:.4f} s, PSExact's Fisher terms {t3 - t2:.4f} s; s a m "
        f"{(t3 - t0) / len(CHUNKED_128_M):.4f}; retained (ev > {PS_THRESHOLD:g}) {kept}; top ev "
        f"{max(float(v.max()) for v in ev.values() if len(v)):.6e}; launches {launches} "
        f"({card_line()})")
    files = [bt._svdfile(mi) for mi in CHUNKED_128_M] + [kl._evfile % mi for mi in CHUNKED_128_M]
    bad = [f for f in files if not store.readable(f)]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} of {len(files)} files unreadable: {bad[:4]}")
    require_launched(tag, launches, ["k15a_sandwich", "k15b_fisher_trace"])

    # the KL spectra of the subset's two smallest pencils on the CPU, each
    # compacted to its active channels and its largest count a channel (the
    # file path pads every m to F x S = 5,632; the zero rows decouple with
    # eigenvalue 0): a pencil of 3,000 takes ~30 s of the card host's CPU
    def compact_n(mi):
        svnum = bt._svd_num(mi)[0]
        return int((svnum > 0).sum()) * int(svnum.max())

    want = sorted(sorted(CHUNKED_128_M, key=compact_n)[:2])
    ls, lf = kl._cl_factors()
    bsvd, idx_list = kl._load_bsvd_batch(want)
    err, t, shapes = 0.0, time.time(), []
    for i, mi in enumerate(want):
        svnum, _ = bt._svd_num(mi)
        act = np.nonzero(svnum)[0]
        sq = int(svnum.max())
        fi = torch.as_tensor(act, device=bsvd.device)
        shapes.append((len(act), sq))
        ev_c, _ = projections.kl_factored_batched(
            bsvd[i:i + 1, fi, :sq].cpu(), ls[:, :, fi].cpu(), lf[:, :, fi].cpu(), nc=1.0,
            fg_reg_rel=kl._foreground_regulariser)
        ndof = len(idx_list[i])
        a, b = np.sort(ev[mi])[-ndof:], np.sort(ev_c.numpy()[0])[-ndof:]
        err = max(err, float(np.abs(a - b).max() / max(b.max(), 1e-30)))
    _gate(tag, f"KL spectra m {want} (ndof {[len(i) for i in idx_list]}; compacted (F, S) "
          f"{shapes}) vs the CPU ({time.time() - t:.2f} s), of each m's top", err, 1e-4)
    # the Fisher terms of the two m that retain most, on the CPU from the
    # same KL files
    fwant = sorted(sorted(CHUNKED_128_M, key=lambda mi: -int((ev[mi] > PS_THRESHOLD).sum()))[:2])
    ps_c = manager.ProductManager(device="cpu").apply_config(conf).psestimators["ps"]
    ps_c.genbands()
    t = time.time()
    f_g = sum(fisher[mi] for mi in fwant)
    f_c = sum(np.asarray(ps_c.fisher_bias_m(mi)[0]) for mi in fwant)
    fscale = float(np.abs(f_c).max())
    _gate(tag, f"Fisher terms of m {fwant} vs the CPU on the same KL files "
          f"({time.time() - t:.2f} s; max|F| {fscale:.6e}), of max",
          float(np.abs(f_g - f_c).max()) / max(fscale, 1e-300), 3e-2)
    return launches


def psmc_phase(outdir):
    """The Monte-Carlo estimators on ``[products]``' KL filter ``kl`` in
    ``outdir``: MonteCarlo and MonteCarloAlt at 1500 samples, Cross at 600,
    seed 7 (``tests/test_psmc_variants.py``'s settings), over the bands of
    its ``Full`` estimator; gates against that Fisher, the card against the
    CPU for m < 8.  Returns the launches (no hand kernel: the q estimator
    is contractions and projections)."""
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.core import manager

    tag = "psmc"
    base = products_config(outdir)["psfisher"][0]
    entries = [dict(base, type="MonteCarlo", name="psmc", nsamples=1500, seed=7),
               dict(base, type="MonteCarloAlt", name="psalt", nsamples=1500, seed=7),
               dict(base, type="Cross", name="pscross", nsamples=600, seed=7)]
    conf = products_config(outdir)
    conf["psfisher"] = [base] + entries
    m = manager.ProductManager().apply_config(conf)
    m_cpu = manager.ProductManager(device="cpu").apply_config(dict(conf, psfisher=[
        dict(e, name=e["name"] + "_cpu") for e in entries]))
    full_fisher = np.asarray(m.psestimators["ps"].fisher_bias()[0]).real
    scale = np.abs(full_fisher).max()
    backend.reset_launch_counts()
    for e in entries:
        ps = m.psestimators[e["name"]]
        t = time.time()
        ps.generate(regen=True)
        torch.cuda.synchronize()
        t_ps = time.time() - t
        fisher, bias = (np.asarray(x).real for x in ps.fisher_bias())
        if not (np.isfinite(fisher).all() and np.isfinite(bias).all()):
            raise AssertionError(f"{tag}: {e['type']} Fisher or bias not finite")
        if fisher.shape != (NBANDS, NBANDS) or bias.shape != (NBANDS,):
            raise AssertionError(f"{tag}: {e['type']} shapes {fisher.shape} {bias.shape}")
        log(f"[{tag}] {e['type']} ({e['nsamples']} samples): {t_ps:.4f} s  fisher diag "
            f"{np.diag(fisher).tolist()}  bias {bias.tolist()}")
        if e["type"] == "Cross":
            _gate(tag, "Cross Fisher symmetry, of max", _rel(fisher, fisher.T), 1e-12)
        else:
            dev = np.abs(fisher - full_fisher) - 0.35 * np.abs(full_fisher)
            _gate(tag, f"{e['type']} Fisher vs Full: max (|F - F_full| - 0.35 |F_full|) over "
                  "max |F_full| (tol 0.15)", float(dev.max() / scale), 0.15)
        if e["type"] == "MonteCarloAlt":
            _gate(tag, "MonteCarloAlt Fisher symmetry, of max", _rel(fisher, fisher.T), 1e-12)
            _gate(tag, "MonteCarloAlt smallest eigenvalue below 0, of max|F_full|",
                  max(0.0, -float(np.linalg.eigvalsh(fisher).min()) / scale), 1e-8)
        # a second m again, bit for bit
        mi = next(mi for mi in range(1, m.telescope.mmax + 1) if ps.num_evals(mi) > 0)
        ps.genbands()
        f1, b1 = ps._work_fisher_bias_m(mi)
        f2, b2 = ps._work_fisher_bias_m(mi)
        if not (np.array_equal(f1, f2) and np.array_equal(b1, b2)):
            raise AssertionError(f"{tag}: {e['type']} m {mi} twice: not bitwise equal")
        # the card against the CPU, same seed, m < 8
        pc = m_cpu.psestimators[e["name"] + "_cpu"]
        pc.genbands()
        err = 0.0
        for mj in range(CPU_CHECK_M):
            fa, ba = ps.fisher_bias_m(mj)
            fb, bb = pc.fisher_bias_m(mj)
            err = max(err, _rel(fa, fb) if np.abs(fb).max() > 0 else float(np.abs(fa).max()),
                      _rel(ba, bb) if np.abs(bb).max() > 0 else float(np.abs(ba).max()))
        _gate(tag, f"{e['type']} m {mi} repeats bitwise; Fisher and bias of m < {CPU_CHECK_M}, "
              "card vs CPU, of max", err, 1e-8)
        ps.delbands()
        pc.delbands()
    launches = launch_counts()
    log(f"[{tag}] launches {launches}")
    return launches


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
    """The two Pallas probes' ports: one run of each at the probe's shapes
    (counted), then each against its plain version at the probe's shapes
    (the records of the kernels line; bfloat16 ``mm`` kept beside them)
    and at the larger ones, with kernel and library times per call, per
    launch and in a CUDA graph, and the bound by the units the kernel
    uses: bytes for ``double``; bfloat16 ``mm`` on the tensor cores,
    float32 ``mm`` as 3xTF32 (the float32 CUDA cores' bound logged
    beside it)."""
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
    del outs

    def timed(name, kernel_fn, plain_fn, rtol, work, library_fn, flops=None):
        rec = compare(name, kernel_fn, plain_fn, rtol=rtol, tag="probe", work=work,
                      library_fn=library_fn, bitwise=True, per_launch=True, graph=True,
                      library_per_launch=True)
        d = rec.pop("device")
        rate = "" if flops is None else (
            f"; Tflop/s in a graph: kernel {flops / d['graph_ms'] / 1e9:.4f}, "
            f"library {flops / d['library_graph_ms'] / 1e9:.4f}")
        log(f"[probe] {name}: device times (kernel / library ms): per launch "
            f"{d['launch_ms']:.4f} / {d['library_launch_ms']:.4f}, in a graph "
            f"{d['graph_ms']:.4f} / {d['library_graph_ms']:.4f}; bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), in a graph "
            f"{rec['bound_ms'] / d['graph_ms']:.4f} of it{rate}")
        return rec, d

    res, summary = {}, {}
    for size in (n, PROBE_DOUBLE_LARGE):
        xs = x if size == n else torch.arange(size * size, dtype=torch.float32,
                                              device=dev).reshape(size, size)
        rec, d = timed(
            f"probe_double ({size}x{size} f32, exact)", lambda: probe.double(xs),
            lambda: probe.double_ref(xs), 0.0,
            (2 * nbytes(xs), [(float(xs.numel()), F32_FLOPS)]), lambda: torch.mul(xs, 2.0))
        summary[f"probe_double {size}^2"] = {**rec, **d}
        if size == n:
            res["probe_double"] = rec
        del xs
    for size in (n, PROBE_MM_LARGE):
        p32, q32 = (a, b) if size == n else (
            torch.as_tensor(rng.standard_normal((size, size)), dtype=torch.float32, device=dev)
            for _ in range(2))
        flops = 2.0 * size**3
        for label, (p, q), rtol, rate in (
                ("f32", (p32, q32), 1e-5, GRAM_FLOPS),
                ("bf16", (p32.to(torch.bfloat16), q32.to(torch.bfloat16)), 1e-3, BF16_FLOPS)):
            plan = probe.mm_plan(size, size, size, p.dtype, (size, size), 16,
                                 backend.sm_count(dev))
            log(f"[probe] probe_mm {size}^3 {label}: route {plan.route}, tile "
                f"{probe.MM_ROWS} x {plan.nw}, {plan.blocks} blocks on "
                f"{backend.sm_count(dev)} SMs")
            if label == "f32":
                # float32 inputs run as 3xTF32 on the tensor cores; the
                # float32 CUDA cores would take flops / 67 TFLOP/s
                log(f"[probe] probe_mm {size}^3 f32: CUDA-core bound "
                    f"{flops / F32_FLOPS * 1e3:.4f} ms")
            rec, d = timed(
                f"probe_mm ({size}^3 {label} in, f32 out)", lambda: probe.mm(p, q),
                lambda: probe.mm_ref(p, q), rtol,
                (nbytes(p, q) + size * size * 4, [(flops, rate)]),
                lambda: torch.matmul(p, q), flops=flops)
            summary[f"probe_mm {size}^3 {label}"] = {**rec, **d}
            if size == n:
                res["probe_mm" if label == "f32" else "probe_mm_bf16"] = rec
        del p32, q32, p, q
    log(f"[probe] records {json.dumps(summary)}")
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
    walkthrough script writes (made by the port's copy of its driver,
    ``driftscan_tpu_torch/examples/disharray_driver.py``: K14, the port's
    store).  Checks:
    every file opens, the NoSVD telescope basis (ndof = ntel x nfreq), maps
    finite and equal to the CPU synthesis of their alm.  Returns the
    launches of the two runs and the telescope."""
    import contextlib

    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.core import beamtransfer
    from driftscan_tpu_torch.examples import disharray_driver
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

        # the walkthrough script's input map, made by the port's copy of its
        # driver: seeded band-limited alm, synthesised by K14
        nside = disharray_driver.NSIDE
        disharray_driver.write_map(disharray_driver.MAPFILE,
                                   disharray_driver.input_map(tel, device="cuda"))

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
    from driftscan_tpu_torch.parallel import resident
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
    ntel = cylinder.PolarisedCylinderTelescope.from_config(NS2_PARAMS, device="cuda")
    perf = kernel_phases(tel, ptel)
    perf.update(host_kernel_phases(
        {"restricted": rtel, "restricted pol": rptel, "dish": dtel}))
    k3k5_dish_compare(dtel, np.random.default_rng(SEED + 3))
    k3k5_window_compare(ntel, np.random.default_rng(SEED + 4))
    n2 = resident.pencil_size(ntel)
    k17_compare(1, n2, k17_shape(n2)[1], k17_shape(n2)[0], np.random.default_rng(SEED + 5),
                "ns2 full size")
    mark("kernels")
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
        mark(tag)
    del dtel
    launches, required = oldcylinder_phase()
    for name in required:
        counted[name] = counted.get(name, 0) + launches[name]
    mark("oldcylinder")
    for launches in (slice_windows_phase(tel, slice_run), *ns2_window_phase(ntel),
                     *ns2_retained_phase(ntel), topband_phase(tel, slice_run)):
        for name, count in launches.items():
            if count:
                counted[name] = counted.get(name, 0) + count
    mark("slice windows, ns2 window, ns2 retained, topband")
    del slice_run["tables"], ntel
    ns1b_window_phase(run_window=False)
    mark("ns1b window's K3+K5")
    for klass, params in ((restrictedcylinder.RestrictedCylinder, RESTRICTED_PARAMS),
                          (cylinder.UnpolarisedCylinderTelescope, BENCH_PARAMS)):
        launches = precision_gate_phase("float64 gate", klass, params)
        counted["k2_host_vis"] += launches["k2_host_vis"]
    mark("float64 gate")
    # the product directory of [products] serves [timestream]
    outdir = tempfile.mkdtemp(prefix="driftscan_products_")
    profiling = "--profile" in sys.argv[1:]
    try:
        launches, nkl, factored = products_phase(slice_run, outdir)
        for name, count in launches.items():
            if count:
                counted[name] = counted.get(name, 0) + count
        convert_phase(outdir)
        # the sandwich and the trace at the largest nkl of the products run
        perf.update(products_kernels(tel, nkl))
        mark("products")
        launches, m = klinv_phase(outdir)
        for name, count in launches.items():
            if count:
                counted[name] = counted.get(name, 0) + count
        mark("klinv")
        launches, mapfile, nside = timestream_phase(outdir, m)
        mark("timestream")
        for name, count in launches.items():
            if count:
                counted[name] = counted.get(name, 0) + count
        for name, count in topband_products_phase(outdir, factored).items():
            if count:
                counted[name] = counted.get(name, 0) + count
        if profiling:
            profile_timestream(outdir, mapfile, nside)
        chunkdir = tempfile.mkdtemp(prefix="driftscan_chunked_")
        try:
            mark("topband products")
            launches, chunked = chunked_phase(outdir, chunkdir)
            mark("chunked")
            launches += tuple(mp_products_phase(chunkdir, chunked, nside, mapfile,
                                                os.path.join(outdir, "timestreams", "ts1")))
            del chunked
            mark("mp products")
            launches += (chunked_128_phase(chunkdir),)
            mark("chunked 128")
            launches += (psmc_phase(outdir),)
            mark("psmc")
        finally:
            shutil.rmtree(chunkdir, ignore_errors=True)
        for run in launches:
            for name, count in run.items():
                if count:
                    counted[name] = counted.get(name, 0) + count
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="driftscan_example_")
    try:
        launches, _ = example_phase(workdir)
        for name, count in launches.items():
            counted[name] = counted.get(name, 0) + count
        svd_variants_phase(workdir)
        mark("example, svd variants")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches, probe_perf = probe_phase()
    mark("probe")
    perf.update(probe_perf)
    for name in PROBE_KERNELS:
        counted[name] = launches[name]
    # last, so that its float64 telescope and BTMs precede no timed phase
    svd_cut_phase("svd cut", tel, BENCH_PARAMS)
    mark("svd cut")
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
