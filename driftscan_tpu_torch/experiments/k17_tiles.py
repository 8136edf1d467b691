#!/usr/bin/env python
"""K17 (the top-band engine's Chebyshev filter step) by tile, and against
an earlier tree's K17, on one GPU.

    python3 driftscan_tpu_torch/experiments/k17_tiles.py [MxNxKxk ...] [--parent ROOT]
        [--no-sweep] [--host]

1. For each shape (given as MxNxKxk, or by default: the bench cylinder's
   slice M 8, n 352, K 352, k 44 and its escalated width k 88; the ns2
   telescope's full size M 1, n 3200, K 3200, k 400; the shapes the
   top-band paths of ``chip_smoke.py`` launch most, (4, 3200, 5200, 400)
   at ``[topband ns2]`` and (8, 352, 1840, 44) at ``[topband products]``;
   two ragged shapes), every tile of ``ops/cheb.py``'s
   ``TILES``, launched through
   ``cheb.cheb_step_launch`` with that tile forced: held against the plain
   version (V_out within 1e-12 of max |V_out|, amax within 1e-13 rel) and
   against a second launch (bitwise), then timed as a launch's device time
   in one CUDA graph of 50 (``chip_smoke.graph_ms``) and as 50
   back-to-back calls (``chip_smoke.launch_ms``), beside the library
   (``torch.baddbmm`` and an inf-norm) timed the same ways; the tile that
   ``cheb.plan`` picks is marked.  ``--no-sweep`` skips this part.
2. With ``--parent ROOT`` (a checkout of an earlier commit, e.g. unpacked
   by ``git archive`` into a gitignored directory): ROOT's and this
   checkout's own ``chip_smoke.k17_compare`` at the slice and ns2 shapes,
   each tree in a process of its own, in turns (parent, this, this,
   parent); each prints its kernel, plain and library times, a call, a
   launch and in a graph.
3. With ``--host``: the host time a call of the wrapper and of its pieces
   at the slice shape (the whole ``cheb_step``, the launch with its plan
   given, the plan's lookup, the argument checks, the allocations, the
   stream lookup (``backend.stream_ptr``, and through a
   ``torch.cuda.Stream`` beside it), the C entry point alone), each the
   median of 5 runs of
   300 back-to-back calls on the host clock, beside the library's two
   calls timed the same way.

Prints the card's name and power limit first.  Needs a CUDA card and
nvcc; imports no JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
SHAPES = ((8, 352, 352, 44), (8, 352, 352, 88), (1, 3200, 3200, 400), (4, 3200, 5200, 400),
          (8, 352, 1840, 44), (2, 1000, 1001, 131), (1, 3203, 3205, 403))
COMPARE = ((8, 352, 352, 44, "slice"), (1, 3200, 3200, 400, "ns2 full size"))
SEED = 17


def sweep(smoke, shapes):
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import cheb

    dev = torch.device("cuda")
    sms = backend.sm_count(dev)
    with open(backend.build(cheb.K17.source) + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("[ptxas]", line.strip(), flush=True)
    rng = np.random.default_rng(SEED)
    for M, n, K, k in shapes:
        y = smoke._crandn(rng, (M, n, K), torch.complex128, dev)
        vk = smoke._crandn(rng, (M, n, k), torch.complex128, dev)
        vp = smoke._crandn(rng, (M, n, k), torch.complex128, dev)
        w = (y.mH @ vk).contiguous()
        a0, beta, gamma = 4.0 / 7.5, -2.0, -1.0
        alpha = torch.full((M,), a0, dtype=torch.float64, device=dev)
        c = beta * vk + gamma * vp
        ref, ref_amax = cheb.cheb_step_ref(y, w, vk, vp, alpha, beta, gamma)
        scale = float(ref.abs().max())

        def library():
            out = torch.baddbmm(c, y, w, alpha=a0)
            return torch.linalg.vector_norm(torch.view_as_real(out), ord=float("inf"),
                                            dim=(-3, -2, -1))

        lib_g, lib_l = smoke.graph_ms(library), smoke.launch_ms(library)
        bound_ms, by = smoke.bound(smoke.nbytes(y, w, vk, vp, alpha) + 16 * M * n * k + 8 * M,
                                   [(8.0 * M * n * K * k, smoke.F64_FLOPS)])
        chosen = cheb.plan(M, n, K, k, sms)
        print(f"(M {M}, n {n}, K {K}, k {k}): library {lib_g:.4f} ms in a graph, {lib_l:.4f} "
              f"a launch; bound {bound_ms:.4f} ms ({by}); plan {tuple(chosen[:5])}, "
              f"{chosen.bm} x {chosen.bn}, {chosen.blocks} blocks", flush=True)
        for tile in cheb.TILES:
            mt, nt, wr, wc = tile[:4]
            bm, bn = wr * 16 * mt, wc * 8 * nt
            p = cheb.ChebPlan(*tile, (-(-k // bn), -(-n // bm), M))

            def run():
                return cheb.cheb_step_launch(y, w, vk, vp, alpha, beta, gamma, p)

            got, amax = run()
            again = run()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            s_err = float(((1.0 / (amax + 1e-30)) / (1.0 / (ref_amax + 1e-30)) - 1.0)
                          .abs().max())
            same = torch.equal(got, again[0]) and torch.equal(amax, again[1])
            ok = err <= 1e-12 * scale and s_err <= 1e-13 and same
            g_ms, l_ms = smoke.graph_ms(run), smoke.launch_ms(run)
            mark = " <- plan" if p == chosen else ""
            print(f"  tile {tile} {bm} x {bn} ({p.blocks} blocks): graph {g_ms:.4f} ms "
                  f"({bound_ms / g_ms:.3f} of bound, "
                  f"{8.0 * M * n * K * k / g_ms / 1e9:.2f} TFLOP/s), launch {l_ms:.4f}; "
                  f"err {err / scale:.3e} of max, scale {s_err:.1e}, repeat "
                  f"{'bitwise' if same else 'DIFFERS'}{'' if ok else '  FAILED'}{mark}",
                  flush=True)
            if not ok:
                raise AssertionError(f"tile {tile} at {(M, n, K, k)} failed")
        del y, w, vk, vp, c, ref


def host_breakdown(smoke):
    import torch

    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import cheb

    dev = torch.device("cuda")
    M, n, K, k = COMPARE[0][:4]
    rng = np.random.default_rng(SEED)
    y = smoke._crandn(rng, (M, n, K), torch.complex128, dev)
    vk = smoke._crandn(rng, (M, n, k), torch.complex128, dev)
    vp = smoke._crandn(rng, (M, n, k), torch.complex128, dev)
    w = (y.mH @ vk).contiguous()
    alpha = torch.full((M,), 4.0 / 7.5, dtype=torch.float64, device=dev)
    c = -2.0 * vk - vp
    p = cheb.plan(M, n, K, k, backend.sm_count(dev))
    out = torch.empty((M, n, k), dtype=torch.complex128, device=dev)
    amax = torch.empty((M,), dtype=torch.float64, device=dev)
    fn = cheb.K17.entry("cheb_step_c128", cheb._ARGTYPES)
    args = (y.data_ptr(), w.data_ptr(), vk.data_ptr(), vp.data_ptr(), alpha.data_ptr(), -2.0,
            -1.0, out.data_ptr(), amax.data_ptr(), M, n, K, k, *p[:5], backend.stream_ptr(dev))

    def checks():
        backend.require(y, "y", dtype=torch.complex128)
        backend.require(w, "w", dtype=torch.complex128, shape=(M, K, k))
        backend.require(vk, "vk", dtype=torch.complex128, shape=(M, n, k))
        backend.require(vp, "vp", dtype=torch.complex128, shape=(M, n, k))
        backend.require(alpha, "alpha", shape=(M,))

    pieces = {
        "cheb_step (the whole wrapper)": lambda: cheb.cheb_step(y, w, vk, vp, alpha, -2.0, -1.0),
        "cheb_step_launch (plan given)":
            lambda: cheb.cheb_step_launch(y, w, vk, vp, alpha, -2.0, -1.0, p),
        "plan lookup (with sm_count)": lambda: cheb.plan(M, n, K, k, backend.sm_count(y.device)),
        "argument checks (5 require)": checks,
        "torch.empty x 2": lambda: (torch.empty((M, n, k), dtype=torch.complex128, device=dev),
                                    torch.empty((M,), dtype=torch.float64, device=dev)),
        "backend.stream_ptr": lambda: backend.stream_ptr(y.device),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "C entry point alone (ctypes)": lambda: fn(*args),
        "library: baddbmm + inf-norm": lambda: torch.linalg.vector_norm(
            torch.view_as_real(torch.baddbmm(c, y, w, alpha=4.0 / 7.5)), ord=float("inf"),
            dim=(-3, -2, -1)),
    }
    print(f"host us a call at (M {M}, n {n}, K {K}, k {k}), median of 5 x 300 calls:",
          flush=True)
    for name, f in pieces.items():
        f()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t = time.perf_counter()
            for _ in range(300):
                f()
            runs.append((time.perf_counter() - t) / 300 * 1e6)
            torch.cuda.synchronize()
        print(f"  {name}: {float(np.median(runs)):.2f} us (runs {[round(r, 2) for r in runs]})",
              flush=True)


def compare_trees(parent):
    code = ("import sys, numpy as np; sys.path.insert(0, '.'); import chip_smoke as s; "
            "M, n, K, k, what = {!r}; "
            "s.k17_compare(M, n, K, k, np.random.default_rng(%d), what, tag=sys.argv[1])" % SEED)
    for root, name in ((parent, "parent"), (ROOT, "this"), (ROOT, "this"), (parent, "parent")):
        for shape in COMPARE:
            res = subprocess.run([sys.executable, "-c", code.format(shape), f"k17 {name}"],
                                 cwd=root, capture_output=True, text=True, timeout=900)
            sys.stdout.write(res.stdout)
            if res.returncode:
                sys.stdout.write(res.stderr[-3000:])
                raise RuntimeError(f"k17_compare in {root} failed")
            sys.stdout.flush()


def main():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    if not torch.cuda.is_available():
        raise RuntimeError("k17_tiles.py needs a CUDA device")
    print(smoke.card_line(), flush=True)
    args = sys.argv[1:]
    shapes = [tuple(map(int, a.split("x"))) for a in args if a[0].isdigit() and "x" in a]
    if "--no-sweep" not in args:
        sweep(smoke, shapes or SHAPES)
    if "--host" in args:
        host_breakdown(smoke)
    if "--parent" in args:
        compare_trees(os.path.abspath(args[args.index("--parent") + 1]))


if __name__ == "__main__":
    main()
