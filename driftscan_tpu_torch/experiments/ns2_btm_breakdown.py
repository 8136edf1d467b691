"""Where the BTM time of an m-window goes, on the card.

    python3 driftscan_tpu_torch/experiments/ns2_btm_breakdown.py [M0 M1]

The JAX package's north-star telescope ``ns2`` (``chip_smoke.NS2_PARAMS``)
through ``btm_resident(m_range=(M0, M1))`` (default ``chip_smoke.NS2_WINDOW``):
one pass to warm up, one timed pass (host clock, synchronised), then a
pass with the card synchronised around each stage of every SHT call: the
beams and visibility maps (``_beam_map_batch``: the beam gather and
K1+K2), the phase stage (``sht.phase_stage``: K4, one launch a call; a
cuFFT a group of rings of equal length and the window's gather before
it was ported) and the Legendre stage
(``sht.legendre_contract``, K3+K5), printing each stage's seconds, its
share of the pass and the number of calls; for the phase stage (K4 of the
port's kernel table) also the bytes it must move (each call's map pixels
read once, not the padding slots, which K4 never reads; its F and G
written once) and their time at 3.35 TB/s, its
bound.  Prints the card's name and power limit first.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def main():
    import torch

    import chip_smoke as cs
    from driftscan_tpu_torch import backend
    from driftscan_tpu_torch.ops import healpix, sht
    from driftscan_tpu_torch.parallel import resident
    from driftscan_tpu_torch.telescope import cylinder

    m_range = tuple(int(a) for a in sys.argv[1:3]) or cs.NS2_WINDOW
    print(cs.card_line(), flush=True)
    backend.build_all()
    tel = cylinder.PolarisedCylinderTelescope.from_config(cs.NS2_PARAMS, device="cuda")
    blg, fig = cs.units(tel)

    def btm():
        torch.cuda.synchronize()
        t = time.time()
        tables = resident.btm_resident(tel, blg, fig, m_range=m_range)
        torch.cuda.synchronize()
        return time.time() - t, tables

    t_warm, _ = btm()
    t_btm, _ = btm()
    spent, calls, moved = {}, {}, {}

    def timed(owner, name, label):
        fn = getattr(owner, name)

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[label] = spent.get(label, 0.0) + time.time() - t
            calls[label] = calls.get(label, 0) + 1
            if name == "phase_stage":
                pixels = a[0].shape[0] * healpix.ring_geometry(a[1]).npix
                moved[label] = (moved.get(label, 0) + pixels * a[0].element_size()
                                + cs.nbytes(*out))
            return out
        return wrapper, fn

    patches = [(tel, "_beam_map_batch", "beams + maps"), (sht, "phase_stage", "phase stage"),
               (sht, "legendre_contract", "Legendre stage (K3+K5)")]
    saved = []
    for owner, name, label in patches:
        wrapper, fn = timed(owner, name, label)
        saved.append((owner, name, fn))
        setattr(owner, name, wrapper)
    try:
        t_sync, _ = btm()
    finally:
        for owner, name, fn in saved:
            if owner is tel:
                delattr(tel, name)
            else:
                setattr(owner, name, fn)
    print(f"[ns2 btm] window m {m_range[0]}..{m_range[1] - 1}, {len(blg)} units: warm-up "
          f"{t_warm:.4f} s, timed {t_btm:.4f} s, synchronised pass {t_sync:.4f} s", flush=True)
    for label, sec in spent.items():
        print(f"[ns2 btm] {label}: {sec:.4f} s ({sec / t_sync:.4f} of the pass) in "
              f"{calls[label]} calls", flush=True)
        if label in moved:
            b = moved[label] / cs.HBM_BYTES_PER_S
            print(f"[ns2 btm] {label}: {moved[label] / 1e9:.4f} GB moved, bound {b:.4f} s "
                  f"(bytes at 3.35 TB/s; {b / sec:.4f} of it)", flush=True)
    rest = t_sync - sum(spent.values())
    print(f"[ns2 btm] the rest (unit bookkeeping, table writes): {rest:.4f} s "
          f"({rest / t_sync:.4f})", flush=True)


if __name__ == "__main__":
    main()
