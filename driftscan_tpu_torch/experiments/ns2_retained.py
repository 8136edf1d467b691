"""ns2 in the JAX run's second m-window, where modes pass 0.1, on the card,
the whole window against the JAX run's record.

    python3 driftscan_tpu_torch/experiments/ns2_retained.py

``chip_smoke.ns2_retained_phase`` over all 45 m of [45, 90) (``chip_smoke.py``
runs its first ``NS2_RETAINED_M``): the BTM of the window, the bucketed
product with the 10-band Fisher, m 45 and 89 against the CPU, the
top-band engine on the first 16 m against the exact engine, K13 and K15b at
the shapes the path launched them with, and the record
``ckpt/ns2_windows/w01_45_90_*.npz`` at ``chip_smoke``'s tolerances, its
10 x 10 Fisher included (the record sums the whole window).  The window's
BTM comes cold (cuFFT's plans for nside 512 included).  Prints the card's
name and power limit first; ~4 minutes.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def main():
    import chip_smoke as cs
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.telescope import cylinder

    print(cs.card_line(), flush=True)
    backend.build_all()
    ntel = cylinder.PolarisedCylinderTelescope.from_config(cs.NS2_PARAMS, device="cuda")
    cs.ns2_retained_phase(ntel, nm=None, ntb=16, cpu_m=(45, 89))


if __name__ == "__main__":
    main()
