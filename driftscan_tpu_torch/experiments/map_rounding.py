#!/usr/bin/env python
"""Whether the polarised product step's time follows its BTM's rounding.

    python3 driftscan_tpu_torch/experiments/map_rounding.py [PARENT]

On one GPU, for ``chip_smoke.py``'s polarised bench cylinder (its
``[pol]`` leg): the BTM made by ``btm_resident`` with this checkout's
kernels, and one made the same way whose Stokes maps come from the map
kernel's plain version; with PARENT (a checkout of an earlier commit,
e.g. unpacked by ``git archive`` into a gitignored directory) also the BTM
that PARENT's package makes, in a process of its own.  It prints how far
the BTMs lie apart, then times this checkout's product step
(``product_all_resident`` with the leg's settings) on each, in turns
(this, PARENT, plain, plain, PARENT, this), with each run's SVD and
retained mode counts; and, with PARENT, whether PARENT's K3+K5
(``sht.legendre_contract``) gives the same bits as this checkout's on the
same seeded inputs at the leg's first chunk, so that a BTM difference can
be put on the maps or on K3+K5.  Needs a CUDA card; imports no JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
SEED = 20261017
TURNS = ("this", "parent", "plain", "plain", "parent", "this")


def log(msg):
    print(f"[map rounding] {msg}", flush=True)


def tables(root, plain_maps=False):
    """(smoke, telescope, BTM, K3+K5 outputs) from ``root``'s package and
    its ``chip_smoke.py`` settings; with ``plain_maps`` the BTM's maps come
    from the map kernels' plain versions (K3+K5 is then not run)."""
    from unittest import mock

    import torch

    if sys.path[0] != root:
        sys.path.insert(0, root)
    import chip_smoke as smoke
    from driftscan_tpu_torch.ops import healpix, kernels, sht
    from driftscan_tpu_torch.parallel import resident
    from driftscan_tpu_torch.telescope import cylinder

    tel = cylinder.PolarisedCylinderTelescope.from_config(smoke.POL_PARAMS, device="cuda")
    blg, fig = smoke.units(tel)
    if plain_maps:
        plain = {name: getattr(kernels, name + "_ref") for name in (
            "bank_visibility_maps", "bank_stokes_maps", "host_visibility_maps",
            "host_stokes_maps")}
        with mock.patch.multiple(kernels, **plain):
            btm = resident.btm_resident(tel, blg, fig)
        return smoke, tel, btm, None
    btm = resident.btm_resident(tel, blg, fig)
    # K3+K5 at the leg's first chunk, on inputs drawn from SEED
    ns, blc, _, sub_lmax = smoke.first_chunk(tel)
    g = healpix.ring_geometry(ns)
    shape = (len(blc) * tel._npol_transform, sub_lmax + 1, g.nring)
    rng = np.random.default_rng(SEED)
    F, G = (torch.as_tensor((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                            .astype(np.complex64), device="cuda") for _ in range(2))
    ct = torch.as_tensor(g.cos_theta, device="cuda")
    st = torch.as_tensor(g.sin_theta, device="cuda")
    k3k5 = sht.legendre_contract(F, G, ct, st, sub_lmax, 4.0 * np.pi / g.npix)
    torch.cuda.synchronize()
    return smoke, tel, btm, k3k5


def export(root, path):
    """``root``'s BTM and K3+K5 outputs, saved on the host to ``path``."""
    import torch

    _, _, btm, k3k5 = tables(root)
    torch.save({"btm": [t.cpu() for t in btm], "k3k5": [t.cpu() for t in k3k5]}, path)


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    if sys.argv[1:2] == ["--export"]:
        export(os.path.abspath(sys.argv[3]), sys.argv[2])
        return
    parent = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else None
    smoke, tel, btm, k3k5 = tables(HERE)
    log(f"{HERE} (parent {parent}) on {smoke.card_line()}")
    from driftscan_tpu_torch.parallel import mstep, resident

    btms = {"this": btm, "plain": tables(HERE, plain_maps=True)[2]}
    if parent is not None:
        path = os.path.join(HERE, "driftscan_tpu_torch", "_build", "map_rounding_parent.pt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--export", path, parent],
                       check=True, timeout=900)
        saved = torch.load(path)
        os.remove(path)
        btms["parent"] = tuple(t.cuda() for t in saved["btm"])
        same = all(torch.equal(a.cpu(), b) for a, b in zip(k3k5, saved["k3k5"]))
        diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(k3k5, saved["k3k5"]))
        log(f"K3+K5 at the first chunk ({tuple(k3k5[0].shape)}): this vs parent "
            f"{'bitwise equal' if same else 'differ'}, max |diff| {diff:.3e}")
    names = list(btms)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            d = max(float((x - y).abs().max()) / float(y.abs().max())
                    for x, y in zip(btms[a], btms[b]))
            log(f"BTM {a} vs {b}: max |diff| {d:.3e} of max |BTM|")

    blg, fig = smoke.units(tel)
    cl_s, cl_n, noisew = smoke.covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    band_lt = mstep.band_factor_table(
        iter(smoke.fisher_bands(tel)), out_dtype=np.float32, rank_rtol=1e-9)
    kw = dict(band_lt=band_lt, ps_threshold=smoke.POL_PS_THRESHOLD, bucket=False)
    resident.product_all_resident(tel, *btm, ls, lf, noisew, max_m=8, **kw)  # warm-up
    times = {name: [] for name in btms}
    for name in TURNS:
        if name not in btms:
            continue
        t = time.time()
        evals, nmodes, _ = resident.product_all_resident(tel, *btms[name], ls, lf, noisew, **kw)
        torch.cuda.synchronize()
        times[name].append(time.time() - t)
        log(f"{name} BTM: t_product_fisher {times[name][-1]:.4f} s, svd modes "
            f"{int(nmodes.sum())}, retained modes {int((evals > kw['ps_threshold']).sum())}")
    ref = np.mean(times["this"])
    for name, ts in times.items():
        log(f"t_product_fisher mean on the {name} BTM {np.mean(ts):.4f} s "
            f"({(np.mean(ts) / ref - 1) * 100:+.2f}% against this checkout's)")


if __name__ == "__main__":
    main()
