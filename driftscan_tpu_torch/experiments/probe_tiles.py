#!/usr/bin/env python
"""The probe ``mm`` by tile width and route, on one GPU.

    python3 driftscan_tpu_torch/experiments/probe_tiles.py [SIZE ...]

For each square size (default 1024 and 4096), each input dtype (float32,
bfloat16), each route (TMA, staged) and each tile width of
``ops/probe.py``'s ``MM_WIDTHS``, times ``probe.mm_launch`` with that plan
forced: device time a launch over one CUDA graph of 50 launches
(``chip_smoke.graph_ms``), beside ``torch.matmul`` of the same inputs in
the same way, and marks the plan ``mm_plan`` chooses on this card.  Each
forced launch is held against the first width's result (float32 rel 1e-5,
bfloat16 1e-3).  Prints one line a case and the card's name and power
limit.  Needs a CUDA card and nvcc; imports no JAX.
"""

import os
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import probe

    if not torch.cuda.is_available():
        raise RuntimeError("probe_tiles.py needs a CUDA device")
    sizes = [int(s) for s in sys.argv[1:]] or [1024, 4096]
    dev = torch.device("cuda")
    sms = backend.sm_count(dev)
    print(smoke.card_line(), f"| {sms} SMs", flush=True)
    rng = np.random.default_rng(0)
    for size in sizes:
        a = torch.as_tensor(rng.standard_normal((size, size)), dtype=torch.float32, device=dev)
        b = torch.as_tensor(rng.standard_normal((size, size)), dtype=torch.float32, device=dev)
        flops = 2.0 * size**3
        for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-3)):
            p, q = a.to(dtype), b.to(dtype)
            lib = smoke.graph_ms(lambda: torch.matmul(p, q))
            chosen = probe.mm_plan(size, size, size, dtype, (size, size), 16, sms)
            print(f"{size}^3 {str(dtype)[6:]}: torch.matmul {lib:.4f} ms in a graph "
                  f"({flops / lib / 1e9:.1f} TFLOP/s)", flush=True)
            first = None
            for route, nw in [(r, w) for r in ("tma", "staged") for w in probe.MM_WIDTHS[dtype]]:
                plan = probe.MMPlan(route, nw, (-(-size // nw), -(-size // probe.MM_ROWS)))
                got = probe.mm_launch(p, q, plan)
                if first is None:
                    first = got
                err = float((got - first).abs().max()) / float(first.abs().max())
                if not err <= rtol:
                    raise AssertionError(f"{plan}: rel {err:.3e} off the first")
                ms = smoke.graph_ms(lambda: probe.mm_launch(p, q, plan))
                mark = " <- mm_plan" if plan == chosen else ""
                print(f"  {route:6s} nw {nw:3d}: {ms:.4f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s, {lib / ms:.3f} of the library's "
                      f"rate){mark}", flush=True)
            del p, q, first, got
        del a, b


if __name__ == "__main__":
    main()
