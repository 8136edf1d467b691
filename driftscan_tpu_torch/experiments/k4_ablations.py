#!/usr/bin/env python
"""Where K4's (and its inverse's) device time goes, on one GPU.

    python3 driftscan_tpu_torch/experiments/k4_ablations.py [--no-cuts] [--no-plans]

Part 1 builds copies of ``csrc/phase_stage.cu`` with one part of the
kernels cut out or changed (their results are then wrong where a part is
cut, and only timed) and prints each one's time (median of 5 CUDA-event
timings of one call, ``chip_smoke.median_ms``) beside the whole kernel's,
at the ``[slice]`` chunk (B 64, nside 256, m 0..229), the ``[pol]`` chunk
(B 256, nside 128, m 0..120), the ``[ns2 window]`` (B 16, nside 512, m
270..314), all complex64, the ``[dish]`` chunk (complex128, m 0..494), and
the inverse at the timestream's shape (B 8, nside 256, m 0..229; real and
complex forms in both types):

* ``notable``: the inverse's table tile not made after the first stage's
  (the forward makes its one tile once);
* ``nohalf``: no half-wave table (its cospi) made;
* ``noturn``: the forward's stage sums (complex64) or running totals
  (complex128) not turned;
* ``nomma``: no tensor-core product (a cheap stand-in keeps the operands);
* ``onemma``: one tf32 product a step (big.big) in place of three (in
  complex128 unchanged);
* ``nostore``: the forward's F and G not written;
* ``nosplit``: the complex64 forward's map values not split (big only);
* ``nocopy``: the forward's maps not read (the ring filled with zeros);
* ``skeleton``: ``notable`` + ``nohalf`` + ``noturn`` + ``nomma``.

Part 2 times the unchanged kernel under other plans than
``sht.phase_plan``'s (rows, columns or pixels a tile, stages), at the same
shapes.  Prints the card's name and power limit first.  Needs a CUDA card
and nvcc; imports no JAX.  Builds go to
``driftscan_tpu_torch/_build/k4_ablations``.
"""

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, ROOT)

WG3 = """    for (int k = 0; k < JC / 8; ++k) {
      ring::wgmma_tf32<N>(acc, as[k], dbig + 2 * k, k > 0);
      ring::wgmma_tf32<N>(acc, ab[k], dsmall + 2 * k, 1);
    }
#pragma unroll
    for (int k = 0; k < JC / 8; ++k) ring::wgmma_tf32<N>(acc, ab[k], dbig + 2 * k, 1);"""
MMA3_INV = """            mma::mma_tf32_16x8x8_zero(d, as[a], b.x, b.z);
            mma::mma_tf32_16x8x8(d, ab[a], b.y, b.w);
            mma::mma_tf32_16x8x8(d, ab[a], b.x, b.z);"""
DMMA_FWD = "mma::dmma_16x8x4(sum[a][c], av[a].x, av[a].y, b);"
DMMA_INV = "mma::dmma_16x8x4(sum[a][c], a0[a], a1[a], b);"
BUILD = "    if (s + 1 < nst) build((s + 1) & 1);\n"
HALF = [("  for (int u = tid; u <= Nr; u += nthr) hw[u] = (float)cospi((double)u / (double)Nr);\n",
         ""),
        ("  for (int u = tid; u <= N; u += nthr) hw[u] = cospi((double)u / (double)N);\n", ""),
        ("  fill_half_wave<T>(hw, N);\n", "")]
NOMMA = [
    (WG3, "    for (int k = 0; k < JC / 8; ++k) acc[k] += __uint_as_float(ab[k][0] ^ as[k][1]);"),
    (MMA3_INV, "            for (int r = 0; r < 4; ++r) d[r] = __uint_as_float(ab[a][r] ^ as[a][r] ^ b.x ^ b.w);"),
    (DMMA_FWD, "sum[a][c][0] += av[a].x * b;"),
    (DMMA_INV, "sum[a][c][0] += a0[a] * b;"),
]
NOTURN = [("      turn(acc[4 * q], acc[4 * q + 1], zc, zs);\n"
           "      turn(acc[4 * q + 2], acc[4 * q + 3], zc, zs);\n", ""),
          ("          turn(sum[a][c][0], sum[a][c][1], zc, zs);\n"
           "          turn(sum[a][c][2], sum[a][c][3], zc, zs);\n", "")]
NOSTORE = [("    F[o] = make_float2(pr + qi, pi - qr);\n    G[o] = make_float2(pr - qi, pi + qr);\n",
            "    if (__float_as_uint(pr) == 0x7fc00001u) F[o] = make_float2(qi, qr);\n"),
           ("      F[o] = make_double2(pr + qi, pi - qr);\n      G[o] = make_double2(pr - qi, pi + qr);\n",
            "      if (pr == -1.2345e300) F[o] = make_double2(qi, qr);\n")]
NOSPLIT = [(f"      mma::tf32_split(v{i}.{p}, ab[k][{r}], as[k][{r}]);",
            f"      ab[k][{r}] = __float_as_uint(v{i}.{p}); as[k][{r}] = 0u;")
           for i, p, r in ((0, "x", 0), (0, "y", 1), (1, "x", 2), (1, "y", 3))]
NOCOPY = [("        const bool ok = o >= 0 && j0 + j < N;\n", "        const bool ok = o < -1;\n")]
VARIANTS = {
    "base": [],
    "notable": [(BUILD, "")],
    "nohalf": HALF,
    "noturn": NOTURN,
    "nomma": NOMMA,
    "onemma": [(WG3, "    for (int k = 0; k < JC / 8; ++k) ring::wgmma_tf32<N>(acc, ab[k], dbig + 2 * k, k > 0);"),
               (MMA3_INV, "            mma::mma_tf32_16x8x8_zero(d, ab[a], b.x, b.z);")],
    "nostore": NOSTORE,
    "nosplit": NOSPLIT,
    "nocopy": NOCOPY,
    "skeleton": [(BUILD, "")] + HALF + NOTURN + NOMMA,
}
# name: (forward?, nside, B, m0, nm, complex128, real)
SHAPES = {
    "slice": (True, 256, 64, 0, 230, False, False),
    "pol": (True, 128, 256, 0, 121, False, False),
    "ns2": (True, 512, 16, 270, 45, False, False),
    "dish": (True, 512, 16, 0, 495, True, False),
    "inv c64 real": (False, 256, 8, 0, 230, False, True),
    "inv c64 complex": (False, 256, 8, 0, 230, False, False),
    "inv c128 real": (False, 256, 8, 0, 230, True, True),
    "inv c128 complex": (False, 256, 8, 0, 230, True, False),
}


def build(name, edits):
    from driftscan_tpu_torch import backend

    src = os.path.join(ROOT, "driftscan_tpu_torch", "csrc", "phase_stage.cu")
    with open(src) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: text not found: {old[:60]!r}")
        text = text.replace(old, new)
    out = os.path.join(ROOT, "driftscan_tpu_torch", "_build", "k4_ablations")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, f"phase_{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = cu[:-3] + ".so"
    cmd = [backend._nvcc(), *backend.NVCC_FLAGS, "-I", os.path.dirname(src), "-o", so, cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"variant {name}: nvcc failed\n{res.stderr[-3000:]}")
    return ctypes.CDLL(so)


def caller(lib, shape, plan):
    """A closure launching ``lib``'s kernel at ``shape`` under ``plan``
    (rows, cols, stages), on seeded inputs made once."""
    import torch

    import chip_smoke as cs
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import healpix, sht

    fwd, nside, B, m0, nm, c128, real = shape
    dtype = torch.complex128 if c128 else torch.complex64
    g = healpix.ring_geometry(nside)
    dev = torch.device("cuda")
    rows, cols, stages = plan
    groups, tiles = sht._phase_launch_tables(nside, B, rows, dev)
    stream = backend.stream_ptr(dev)
    if fwd:
        maps = cs.phase_maps(B, nside, dtype, cs.SEED + 60)
        F = torch.empty((B, nm, g.nring), dtype=dtype, device=dev)
        G = torch.empty_like(F)
        fn = getattr(lib, "phase_fwd_c128" if c128 else "phase_fwd_c64")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        args = (maps.data_ptr(), groups.data_ptr(), tiles.data_ptr(), tiles.shape[0],
                F.data_ptr(), G.data_ptr(), B, g.nring, g.maxlen, m0, nm, rows, cols, stages,
                stream)
        keep = (maps, F, G)
    else:
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 61)
        rdt = torch.float64 if c128 else torch.float32
        tp, tn = (torch.view_as_complex(torch.randn((B, nm, g.nring, 2), generator=gen,
                                                    dtype=rdt, device=dev)) for _ in range(2))
        out = torch.empty((B, g.nring, g.maxlen), dtype=rdt if real else dtype, device=dev)
        fn = getattr(lib, "phase_inv_c128" if c128 else "phase_inv_c64")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        args = (tp.data_ptr(), None if real else tn.data_ptr(), groups.data_ptr(),
                tiles.data_ptr(), tiles.shape[0], out.data_ptr(), B, g.nring, g.maxlen, nm, rows,
                cols, stages, int(real), stream)
        keep = (tp, tn, out)

    def call():
        backend.check(fn(*args), "k4 ablation")
        return keep

    return call


def default_plan(shape):
    import torch

    from driftscan_tpu_torch.ops import sht

    fwd, nside, B, m0, nm, c128, real = shape
    p = sht.phase_plan(nside, B, nm, torch.complex128 if c128 else torch.complex64,
                       inverse=not fwd, real=real)
    return p.rows, p.cols, p.stages


def main():
    import torch

    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    cuts = "--no-cuts" not in sys.argv
    names = list(VARIANTS) if cuts else ["base"]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(n, VARIANTS[n]), names)))
    if cuts:
        print("== part 1: ms a call by variant (median of 5)", flush=True)
        for sname, shape in SHAPES.items():
            plan = default_plan(shape)
            times = {n: cs.median_ms(caller(lib, shape, plan), 5) for n, lib in libs.items()}
            print(f"{sname} (plan rows {plan[0]}, cols {plan[1]}, stages {plan[2]}): "
                  + ", ".join(f"{n} {t:.4f}" for n, t in times.items()), flush=True)
            torch.cuda.empty_cache()
    if "--no-plans" not in sys.argv:
        print("== part 2: the whole kernel by plan (rows, cols, stages), ms a call", flush=True)
        for sname, shape in SHAPES.items():
            fwd, nside, B, m0, nm, c128, real = shape
            base = default_plan(shape)
            if fwd:
                plans = [(r, c, s) for r in ((16, 32, 64) if c128 else (32, 64))
                         for c in (base[1], 32) for s in (2, 3, 4)]
            else:
                per = 32 if real else 16
                plans = [(r, p, s) for r in (per, 2 * per, 4 * per) for p in (32, 64)
                         for s in (2, 3)]
            res = []
            for plan in dict.fromkeys([base] + plans):
                try:
                    res.append((plan, cs.median_ms(caller(libs["base"], shape, plan), 5)))
                except RuntimeError as e:  # a plan past the shared memory
                    res.append((plan, str(e)))
            print(f"{sname}: " + "; ".join(
                f"{p}{' (plan)' if p == base else ''} "
                f"{t:.4f}" if isinstance(t, float) else f"{p} refused" for p, t in res),
                flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
