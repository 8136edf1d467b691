#!/usr/bin/env python
"""Where the probe ``mm``'s time goes, on one GPU.

    python3 driftscan_tpu_torch/experiments/probe_breakdown.py

Part 1, fixed cost against K: ``probe.mm`` and ``torch.matmul`` on (M, K)
x (K, M) inputs for M = 1024 and 4096 and K = 64, 256, 1024 and 4096,
bfloat16 and float32, device time a launch over one CUDA graph of 50
launches (``chip_smoke.graph_ms``), beside a kernel that only writes the
(M, M) float32 output (``torch.empty(...).zero_()``).  The time at K = 64
is the launch's fixed cost (set-up, the first loads, the epilogue); the
slope over K is the main loop's.

Part 2, host time a call (enqueue only, no synchronisation; mean of 500
calls after a warm-up) of ``probe.mm`` at 1024^3 in bfloat16 and of the
parts of its path: ``probe.mm_launch`` with the plan given, the C entry
point alone by either route (the TMA route encodes two tensor maps a
call), ``backend.stream_ptr``, the output's ``torch.empty``, the
argument checks and the plan; ``probe.double`` and the two library calls
beside them.

Prints one line a case and the card's name and power limit.  Needs a
CUDA card and nvcc; imports no JAX.
"""

import ctypes
import os
import sys
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import probe

    if not torch.cuda.is_available():
        raise RuntimeError("probe_breakdown.py needs a CUDA device")
    dev = torch.device("cuda")
    print(smoke.card_line(), f"| {backend.sm_count(dev)} SMs", flush=True)
    rng = np.random.default_rng(0)

    print("part 1: device ms a launch in a graph (kernel / torch.matmul / output write)")
    for dtype in (torch.bfloat16, torch.float32):
        for M in (1024, 4096):
            out_ms = smoke.graph_ms(
                lambda: torch.empty((M, M), dtype=torch.float32, device=dev).zero_())
            for K in (64, 256, 1024, 4096):
                a = torch.as_tensor(rng.standard_normal((M, K)), device=dev).to(dtype)
                b = torch.as_tensor(rng.standard_normal((K, M)), device=dev).to(dtype)
                kern = smoke.graph_ms(lambda: probe.mm(a, b))
                lib = smoke.graph_ms(lambda: torch.matmul(a, b))
                print(f"  {str(dtype)[6:]:8s} M {M} K {K:4d}: {kern:.4f} / {lib:.4f} / "
                      f"{out_ms:.4f}", flush=True)
                del a, b

    print("part 2: host us a call (enqueue only)")
    n = 1024
    a = torch.as_tensor(rng.standard_normal((n, n)), device=dev).to(torch.bfloat16)
    b = torch.as_tensor(rng.standard_normal((n, n)), device=dev).to(torch.bfloat16)
    x = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=dev)
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    plan = probe.mm_plan(n, n, n, a.dtype, (n, n), 16, backend.sm_count(dev))
    fn = probe.PROBE_MM.entry("probe_mm_bf16",
                              [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = backend.stream_ptr(dev)

    def entry(tma):
        return lambda: backend.check(
            fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, n, n, tma, plan.nw, stream),
            "probe_mm")

    cases = (
        ("probe.mm", lambda: probe.mm(a, b)),
        ("probe.mm_launch", lambda: probe.mm_launch(a, b, plan)),
        ("C entry, TMA route", entry(1)),
        ("C entry, staged route", entry(0)),
        ("backend.stream_ptr", lambda: backend.stream_ptr(dev)),
        ("torch.empty of the output", lambda: torch.empty((n, n), dtype=torch.float32,
                                                         device=dev)),
        ("argument checks", lambda: (
            backend.require(a, "a", dtype=(torch.float32, torch.bfloat16), ndim=2),
            backend.require(b, "b", dtype=a.dtype, shape=(n, n)))),
        ("plan", lambda: probe.mm_plan(n, n, n, a.dtype, (n, n),
                                       probe._align(a.data_ptr(), b.data_ptr()),
                                       backend.sm_count(dev))),
        ("probe.double", lambda: probe.double(x)),
        ("torch.matmul", lambda: torch.matmul(a, b)),
        ("torch.mul", lambda: torch.mul(x, 2.0)),
    )
    for name, f in cases:
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            f()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        print(f"  {name}: {dt / 500 * 1e6:.2f} us", flush=True)


if __name__ == "__main__":
    main()
