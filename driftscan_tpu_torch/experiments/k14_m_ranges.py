#!/usr/bin/env python
"""K14 (the inverse SHT's Legendre stage) timed by m range and form on one GPU.

    python3 driftscan_tpu_torch/experiments/k14_m_ranges.py [ROOT]

ROOT is a checkout whose ``driftscan_tpu_torch`` is timed (default: the
checkout that holds this script), so that two versions of the kernel can
be timed in one call.  At the timestream path's shape (B 8, lmax 229,
nside 256: 1023 rings) it prints, for complex128 and complex64 in the
real and the complex form, the median CUDA-event time of
``sht.legendre_synth`` over all m and over the first nm' m alone (nm' 1:
the m = 0 blocks, whose 230 multipoles are the longest walk; then growing
shares of the lambda count), and the same over 20 back-to-back calls (the
host's share hidden where the kernel outlasts it), each beside its share
of the lambda; the real form again at B 1; and the registers and spills
ptxas reported for the kernel's source.  Needs a CUDA card; imports no
JAX.

The first nm' m alone cover the same (m, l) work in every version, not
the same blocks: a kernel that pairs m with nm - 1 - m (``m_schedule``)
pairs them by nm' there, (0, nm' - 1) and so on, where the whole run
pairs (0, lmax); so only a kernel with one m a block times a subset of
its whole run's blocks.
"""

import os
import subprocess
import sys

import numpy as np


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import healpix, sht

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[k14 m ranges] {root} on {card}", flush=True)
    path = backend.build(sht.K14.source)
    with open(path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"[k14 m ranges] ptxas: {line.strip()}", flush=True)

    g = healpix.ring_geometry(256)
    lmax, nl = 229, 230
    ct = torch.as_tensor(g.cos_theta, device="cuda")
    st = torch.as_tensor(g.sin_theta, device="cuda")
    rng = np.random.default_rng(14)

    def crandn(shape, dtype):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.as_tensor(z, device="cuda").to(dtype)

    def launch_ms(fn, n=20):
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

    def median_ms(fn, reps=20):
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

    nlam = np.cumsum(nl - np.arange(nl)) * g.nring  # lambda of m < nm'
    for dtype in (torch.complex128, torch.complex64):
        for B in (8, 1):
            pos = crandn((B, nl, nl), dtype)
            neg = crandn((B, nl, lmax), dtype)
            for form in ("real", "complex"):
                if B == 1 and form == "complex":
                    continue
                for nmp in (nl, 1, 58, 115, 173):
                    if form == "complex" and nmp == 1:
                        continue  # no negative-m column: the call is the real form
                    p = pos[:, :, :nmp].contiguous()
                    n = neg[:, :, :nmp - 1].contiguous() if form == "complex" else None
                    fn = lambda: sht.legendre_synth(p, n, ct, st)
                    ms, per = median_ms(fn), launch_ms(fn)
                    print(f"[k14 m ranges] {dtype} {form} B {B} m < {nmp}: {ms:.4f} ms a call, "
                          f"{per:.4f} a launch back to back, "
                          f"{nlam[nmp - 1] / nlam[-1]:.4f} of the lambda", flush=True)


if __name__ == "__main__":
    main()
