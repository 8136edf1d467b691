#!/usr/bin/env python
"""Where K14's device time goes, on one GPU.

    python3 driftscan_tpu_torch/experiments/k14_ablations.py

Part 1 times the recurrence step alone (``legendre_rec.cuh`` ``advance``
and ``lambda``, a group of 8 steps between warp votes, as K14 runs it) by
recurrence warps a SM and independent chains (rings) a thread, with and
without a shared-memory store of each lambda: cycles at 1.755 GHz (the
clock is not read) a step of one chain, as its warp sees it, and a
partition's (a quarter SM's) cycles a warp's chain step, its throughput.

Part 2 builds copies of ``csrc/legendre_synth.cu`` with one part of the
kernel cut out (their results are then wrong, and only timed) and prints
each one's time in a CUDA graph of 50 launches (``chip_smoke.graph_ms``)
beside the whole kernel's, at the timestream's shape (B 8, lmax 229, nside
256: 1023 rings), complex128 and complex64, real and complex form, and in
complex128 with the first 58 m alone (one wave of blocks):

* ``norec``: no recurrence (the product warps multiply stale Lambda tiles);
* ``nomma``: no product (the recurrence warps alone, with the tile
  barriers and the alm copies);
* ``noreplay``: no group taken again after a flagged rescale window;
* ``nostore``: the recurrence without its Lambda stores;
* ``skeleton``: neither recurrence nor product (the alm copies, barriers
  and output stores).

Needs a CUDA card and nvcc; imports no JAX.  Builds go to
``driftscan_tpu_torch/_build/k14_ablations``.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
CLOCK_HZ = 1.755e9

VARIANTS = {
    "base": [],
    "norec": [("  if (rec) produce(0, 0);", "  if (false) produce(0, 0);"),
              ("      if (k + 1 < ntile) produce(k + 1, (k + 1) & 1);", "")],
    "nomma": [("      consume(k, k & 1);", "")],
    "noreplay": [("      if (__any_sync(0xffffffffu, moved)) {", "      if (false) {")],
    "nostore": [("        put(li + g, legendre::lambda(st));",
                 "        if (li + g < 0) put(li + g, legendre::lambda(st));")],
    "skeleton": [("  if (rec) produce(0, 0);", "  if (false) produce(0, 0);"),
                 ("      if (k + 1 < ntile) produce(k + 1, (k + 1) & 1);", ""),
                 ("      consume(k, k & 1);", "")],
}

REC_BENCH = r"""
#include <cuda_runtime.h>
#include "legendre_rec.cuh"

template <int CH, bool STORE>
__global__ void rec_bench(const double* __restrict__ xs, const double2* __restrict__ coef,
                          double* __restrict__ out, int nsteps) {
  __shared__ double2 cf[256];
  __shared__ double sink[4][8 * 32];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cf[i] = coef[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  legendre::State st[CH];
  double x[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    x[c] = xs[((blockIdx.x * blockDim.x + threadIdx.x) * CH + c) & 1023];
    st[c].u0 = 0.0;
    st[c].u1 = 1.0;
    st[c].sc = 1e-3;
  }
  double acc = 0.0;
  bool moved = false;
  for (int l = 0; l < nsteps; l += 8) {
    double2 c8[8];
#pragma unroll
    for (int g = 0; g < 8; ++g) c8[g] = cf[(l + g) & 255];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        legendre::advance(st[c], moved, x[c], c8[g].x, c8[g].y);
        const double lam = legendre::lambda(st[c]);
        if (STORE) sink[warp & 3][(g * CH + c) % 8 * 32 + lane] = lam;
        else acc += lam;
      }
    }
    if (__any_sync(0xffffffffu, moved)) acc += 1.0;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc + sink[warp & 3][lane];
}

#define LAUNCH(C, S) \
  rec_bench<C, S><<<blocks, threads, 0, (cudaStream_t)stream>>>(xs, (const double2*)coef, out, nsteps)
extern "C" int rec_bench_launch(int ch, int store, int blocks, int threads, const double* xs,
                                const void* coef, double* out, int nsteps, void* stream) {
  if (ch == 1) { if (store) LAUNCH(1, true); else LAUNCH(1, false); }
  if (ch == 2) { if (store) LAUNCH(2, true); else LAUNCH(2, false); }
  if (ch == 4) { if (store) LAUNCH(4, true); else LAUNCH(4, false); }
  return (int)cudaGetLastError();
}
"""


def build_all(outdir, sources):
    """{name: ctypes library}: one nvcc per source, all at once."""
    from driftscan_tpu_torch import backend

    csrc = os.path.join(ROOT, "driftscan_tpu_torch", "csrc")
    procs = {}
    for name, text in sources.items():
        src = os.path.join(outdir, name + ".cu")
        with open(src, "w") as f:
            f.write(text)
        out = os.path.join(outdir, name + ".so")
        cmd = [backend._nvcc(), *backend.NVCC_FLAGS, "-I", csrc, "-o", out, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (p, out) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs


def _copies(outdir, smoke):
    import torch

    from driftscan_tpu_torch.ops import healpix, sht

    with open(os.path.join(ROOT, "driftscan_tpu_torch", "csrc", "legendre_synth.cu")) as f:
        text = f.read()
    sources = {}
    for name, patches in VARIANTS.items():
        s = text
        for a, b in patches:
            if a not in s:
                raise RuntimeError(f"{name}: the kernel no longer holds {a!r}")
            s = s.replace(a, b)
        sources[name] = s
    libs = build_all(outdir, sources)
    dev = torch.device("cuda")
    g = healpix.ring_geometry(256)
    lmax, nl = 229, 230
    ct = torch.as_tensor(g.cos_theta, device=dev)
    st = torch.as_tensor(g.sin_theta, device=dev)
    rng = np.random.default_rng(14)
    argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])

    def launcher(lib, pos, neg):
        B, _, nm = pos.shape
        tpos = torch.empty((B, nm, g.nring), dtype=pos.dtype, device=dev)
        tneg = None if neg is None else torch.empty_like(tpos)
        logpref, sched = sht._legendre_tables(lmax, nm, dev)
        coef = sht._synth_tables(lmax, nm, dev)
        fn = getattr(lib, "legendre_synth_c64" if pos.dtype == torch.complex64
                     else "legendre_synth_c128")
        fn.argtypes = argtypes
        args = (pos.data_ptr(), None if neg is None else neg.data_ptr(), ct.data_ptr(),
                st.data_ptr(), logpref.data_ptr(), coef.data_ptr(), sched.data_ptr(),
                sched.shape[0], tpos.data_ptr(), None if tneg is None else tneg.data_ptr(),
                B, nm, g.nring, lmax)

        # the call holds every tensor it writes or reads: a CUDA graph's
        # capture empties the allocator's cache, and a freed output would
        # then be unmapped under the graph's launches
        def call(keep=(pos, neg, tpos, tneg, logpref, sched, coef)):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
        return call, tpos

    for dtype in (torch.complex128, torch.complex64):
        z = rng.standard_normal((8, nl, nl)) + 1j * rng.standard_normal((8, nl, nl))
        pos = torch.as_tensor(z, device=dev).to(dtype)
        neg = pos[:, :, 1:].contiguous()
        cases = [("real form", pos, None), ("complex form", pos, neg)]
        if dtype == torch.complex128:
            cases.append(("real form, m < 58", pos[:, :, :58].contiguous(), None))
        for what, p, n in cases:
            want = sht.legendre_synth(p, n, ct, st)[0]
            line = []
            for name, lib in libs.items():
                call, out = launcher(lib, p, n)
                call()
                torch.cuda.synchronize()
                if name == "base" and not torch.equal(out, want):
                    raise AssertionError("the unpatched copy differs from the kernel")
                line.append(f"{name} {smoke.graph_ms(call):.4f}")
            print(f"[k14 ablations] {dtype} {what}: ms in a graph: " + ", ".join(line),
                  flush=True)


def _step(outdir, smoke):
    import torch

    lib = build_all(outdir, {"rec_bench": REC_BENCH})["rec_bench"]
    lib.rec_bench_launch.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                                     + [ctypes.c_void_p])
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    xs = torch.linspace(-0.999, 0.999, 1024, dtype=torch.float64, device="cuda")
    l, m = np.arange(300, 556, dtype=np.float64), 100.0
    a = np.sqrt((4 * l * l - 1) / (l * l - m * m))
    b = np.sqrt(((l - 1) ** 2 - m * m) / (4 * (l - 1) ** 2 - 1))
    coef = torch.as_tensor(np.stack([a, b], -1), device="cuda")
    nsteps, threads = 2048, 128
    for store in (1, 0):
        for ch in (1, 2, 4):
            for wps in (4, 8, 16, 32):
                blocks = nsm * wps * 32 // threads
                out = torch.empty(blocks * threads, dtype=torch.float64, device="cuda")

                def call(keep=(xs, coef, out)):
                    rc = lib.rec_bench_launch(ch, store, blocks, threads, xs.data_ptr(),
                                              coef.data_ptr(), out.data_ptr(), nsteps,
                                              torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"launch failed: {rc}")
                ms = smoke.graph_ms(call, n=5)
                cycles = ms * 1e-3 * CLOCK_HZ
                print(f"[k14 ablations] recurrence step, {'stored' if store else 'summed'}, "
                      f"{ch} chain(s) a thread, {wps} warps a SM: {ms:.4f} ms, "
                      f"{blocks * threads * ch * nsteps / ms / 1e9:.1f} Tlambda/s, "
                      f"{cycles / (nsteps * ch):.1f} cycles a step of one chain, "
                      f"{cycles * 4 / (wps * nsteps * ch):.1f} SM-partition cycles a chain "
                      f"step of a warp", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    print(f"[k14 ablations] {ROOT} on {smoke.card_line()}", flush=True)
    outdir = os.path.join(ROOT, "driftscan_tpu_torch", "_build", "k14_ablations")
    os.makedirs(outdir, exist_ok=True)
    _step(outdir, smoke)
    _copies(outdir, smoke)


if __name__ == "__main__":
    main()
