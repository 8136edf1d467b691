#!/usr/bin/env python
"""The probe ``double`` by grid, on one GPU.

    python3 driftscan_tpu_torch/experiments/double_grids.py

At the probe's 1024^2 and at 8192^2 (512 MiB moved, past the 50 MB L2),
times ``probe.double_launch`` with a grid that covers the array (a float4
a thread, the wrapper's choice) and with grids of 2, 4, 8 and 16 blocks
an SM striding over it, beside ``torch.mul(x, 2.0)``: device time a
launch over one CUDA graph of 50 launches (``chip_smoke.graph_ms``) and
its share of the bound (bytes: 8 an element over 3.35 TB/s).  Each launch
is held bitwise against ``x * 2``.  Prints one line a case and the card's
name and power limit.  Needs a CUDA card and nvcc; imports no JAX.
"""

import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import probe

    if not torch.cuda.is_available():
        raise RuntimeError("double_grids.py needs a CUDA device")
    dev = torch.device("cuda")
    sms = backend.sm_count(dev)
    print(smoke.card_line(), f"| {sms} SMs", flush=True)
    for size in (1024, 8192):
        x = torch.arange(size * size, dtype=torch.float32, device=dev).reshape(size, size)
        bound = 2 * x.numel() * 4 / smoke.HBM_BYTES_PER_S * 1e3
        lib = smoke.graph_ms(lambda: torch.mul(x, 2.0))
        print(f"{size}^2: bound {bound:.4f} ms; torch.mul {lib:.4f} ms "
              f"({bound / lib:.4f} of bound)", flush=True)
        for per_sm in (0, 2, 4, 8, 16):
            cap = per_sm * sms

            def run():
                return probe.double_launch(x, cap)

            if not torch.equal(run(), x * 2):
                raise AssertionError(f"max_blocks {cap}: not 2 x")
            ms = smoke.graph_ms(run)
            grid = "covers the array" if not per_sm else f"{per_sm} blocks an SM"
            print(f"  grid {grid:16s}: {ms:.4f} ms ({bound / ms:.4f} of bound, "
                  f"{lib / ms:.4f} of torch.mul's rate)", flush=True)
        del x


if __name__ == "__main__":
    main()
