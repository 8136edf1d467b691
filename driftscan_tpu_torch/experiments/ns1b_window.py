"""The JAX package's scale-axis telescope ns1b in its run's first m-window,
on the card, against the JAX run's record.

    python3 driftscan_tpu_torch/experiments/ns1b_window.py

``ns1b`` (``chip_smoke.NS1B_PARAMS``, ``scratch/northstar2.py``'s preset:
lmax 1035, 1,280 units, pencil up to 2,560) at full width, m [0, 33), under
the run's nside cap of 1024 and a 32 GB SHT budget: K3+K5 at the path's
shape against its plain version, then ``btm_resident(m_range=)`` and
``product_all_resident`` (bucket auto, 10 bands of k 0-0.4, ps_threshold
0.1), gated as ``chip_smoke.ns1b_window_phase`` gates them: finite spectra
and Fisher, the kernels launched, none retained (as the record
``ckpt/ns1b_windows/w00_0_33_*.npz``), the SVD counts and the sub-cut
spectra printed beside the record's.  ``chip_smoke.py`` runs the K3+K5
part alone: the window's BTM and product take ~90 s of its time budget.
Prints the card's name and power limit first; ~2 minutes.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def main():
    import chip_smoke as cs
    from driftscan_tpu_torch import backend

    print(cs.card_line(), flush=True)
    backend.build_all()
    cs.ns1b_window_phase()


if __name__ == "__main__":
    main()
