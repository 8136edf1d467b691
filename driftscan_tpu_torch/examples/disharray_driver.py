#!/usr/bin/env python
"""The ``examples/disharray`` walkthrough on the port: products ->
simulation -> m-modes -> map.

    python -m driftscan_tpu_torch.examples.disharray_driver [DIR] [--device cpu]

Does what ``examples/disharray/driver.py`` does with the JAX package:
generates the beam transfers of the example's ``prod_params.yaml`` (a
DishArray, ``nosvd``, a KL filter with an inverse), makes a random
band-limited sky at nside 32 from numpy seed 42, writes it as
``simulated_input_map.hdf5``, simulates a noiseless timestream from it,
decomposes it into m-modes and makes ``timestream/map_full.hdf5``.  Every
path is relative to ``DIR`` (default: the working directory; made if
absent), which the run enters; ``prod_params.yaml`` is read there, copied
from the repository's ``examples/disharray`` if absent.  It runs on the
CUDA card unless ``--device cpu`` is given.  Files go through :mod:`driftscan_tpu_torch.
util.store` (HDF5 where h5py imports, else its ``.npy`` directory store).
"""

import argparse
import contextlib
import os
import shutil

import numpy as np

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "examples", "disharray")
NSIDE = 32
SEED = 42
MAPFILE = "simulated_input_map.hdf5"


def input_alm(tel, seed=SEED):
    """The walkthrough's seeded band-limited alm (nfreq, lmax+1, lmax+1):
    complex normal entries at m <= l, real at m = 0."""
    lmax = tel.lmax
    rng = np.random.default_rng(seed)
    ls = np.arange(lmax + 1)[:, None]
    ms = np.arange(lmax + 1)[None, :]
    alm = rng.standard_normal((tel.nfreq, lmax + 1, lmax + 1)) + 1j * rng.standard_normal(
        (tel.nfreq, lmax + 1, lmax + 1))
    alm = np.where(ms <= ls, alm, 0)
    alm[..., 0] = alm[..., 0].real
    return alm


def input_map(tel, nside=NSIDE, seed=SEED, device=None):
    """The walkthrough's input sky (nfreq, 1, npix) float64 numpy: the
    synthesis of :func:`input_alm` at ``nside`` (K14 on the card)."""
    from ..ops import sht

    skymap = sht.sphtrans_inv_sky(input_alm(tel, seed), nside, device=device)
    return skymap.cpu().numpy()[:, np.newaxis, :]


def write_map(path, skymap):
    from ..util import store

    with store.File(path, "w") as f:
        f.create_dataset("map", data=skymap)


def main(workdir=".", device=None):
    """Run the walkthrough in ``workdir`` on ``device`` (the card when
    None); returns the :class:`~driftscan_tpu_torch.pipeline.timestream.
    Timestream`."""
    from ..core import manager
    from ..pipeline import timestream

    workdir = os.path.abspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    config = os.path.join(workdir, "prod_params.yaml")
    if not os.path.exists(config):
        # its relative output directory lands beside it: a copy, so that
        # the products go to the working directory, not into the repository
        shutil.copy(os.path.join(EXAMPLE, "prod_params.yaml"), config)
    with contextlib.chdir(workdir):
        # 1. the analysis products
        m = manager.ProductManager.from_config(config, device=device)
        m.generate()

        # 2. a random band-limited sky
        mapfile = os.path.join(workdir, MAPFILE)
        write_map(mapfile, input_map(m.telescope, device=m.device))

        # 3. the observation (noiseless)
        ts = timestream.simulate(m, os.path.join(workdir, "timestream"), [mapfile], ndays=0)

        # 4. m-modes and the map
        ts.generate_mmodes()
        ts.mapmake_full(NSIDE, "map_full.hdf5")
    print("Wrote", os.path.join(ts.output_directory, "map_full.hdf5"))
    return ts


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default=".")
    ap.add_argument("--device", default=None,
                    help="Device to run on (default: the CUDA card; 'cpu' for the host).")
    args = ap.parse_args()
    main(args.workdir, args.device)
