"""Config-driven orchestration of timestream analysis.

Port of ``driftscan_tpu/pipeline/pipeline.py``: the same YAML schema
(``config:`` stage switches + ``timestreams:`` list + optional
``crosspower:``), the same stage order (m-modes -> KL modes -> power
spectra and cross power -> maps) and resumable simulation.  The products
load on ``device`` (the card when None); ``timings`` holds the seconds of
each stage of this manager's runs.
"""

from __future__ import annotations

import logging
import os.path
import time

import torch

from .. import config
from ..core import manager
from ..parallel import comm
from . import timestream

logger = logging.getLogger(__name__)


def fixpath(path):
    """Expand user/vars and normalise a path."""
    return os.path.normpath(os.path.expandvars(os.path.expanduser(path)))


class PipelineManager(config.Reader):
    """Manage and run the timestream pipeline.

    Config keys as in driftscan: which stages to run (`generate_modes`,
    `generate_klmodes`, `generate_powerspectra`, `generate_maps`), the named
    KL filters / PS estimators to apply, and map-making options.
    """

    product_directory = config.Property(proptype=str, default="")

    generate_modes = config.Property(proptype=bool, default=True)
    generate_klmodes = config.Property(proptype=bool, default=True)
    generate_powerspectra = config.Property(proptype=bool, default=True)
    generate_maps = config.Property(proptype=bool, default=True)

    no_m_zero = config.Property(proptype=bool, default=True)

    klmodes = config.Property(proptype=list, default=list)
    powerspectra = config.Property(proptype=list, default=list)
    klmaps = config.Property(proptype=list, default=list)
    crosspower = []

    nside = config.Property(proptype=int, default=128)
    wiener = config.Property(proptype=bool, default=False)

    collect_klmodes = config.Property(proptype=bool, default=True)

    def __init__(self, device=None):
        self.device = device
        self.timestreams = {}
        self.simulations = {}
        self.timings = {}

    # -------------------- loading --------------------

    @classmethod
    def from_configfile(cls, configfile, device=None):
        c = cls(device=device)
        c.load_configfile(configfile)
        return c

    def load_configfile(self, configfile):
        import yaml

        with open(configfile) as f:
            yconf = yaml.safe_load(f)

        for required in ("config", "timestreams"):
            if required not in yconf:
                raise Exception(f"Configuration file must have an '{required}' section.")

        self.read_config(yconf["config"])

        for tsconf in yconf["timestreams"]:
            self._add_timestream(tsconf)

        self.crosspower = list(yconf.get("crosspower", ()))

    def _products(self, directory):
        return manager.ProductManager.from_config(fixpath(directory), device=self.device)

    def _add_timestream(self, tsconf):
        ts = timestream.Timestream(fixpath(tsconf["directory"]), self._products(self.product_directory))
        ts.no_m_zero = self.no_m_zero
        if "output_directory" in tsconf:
            ts.output_directory = fixpath(tsconf["output_directory"])

        name = tsconf["name"]
        self.timestreams[name] = ts
        if "simulate" in tsconf:
            self.simulations[name] = tsconf["simulate"]

    def _timed(self, name, fn):
        t = time.time()
        fn()
        dev = comm.device(self.device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timings[name] = self.timings.get(name, 0.0) + time.time() - t

    # -------------------- simulation --------------------

    def _simulate(self):
        for tsname, simconf in self.simulations.items():
            ts = self.timestreams[tsname]
            # one answer for every process: process 0's, before any writes
            if comm.bcast(os.path.exists(ts._ffile(0))):
                logger.info("Timestream %s already exists; skipping simulation", tsname)
                continue
            kwargs = {k: v for k, v in simconf.items() if k != "product_directory"}
            timestream.simulate(self._products(simconf["product_directory"]), ts.directory, **kwargs)

    def simulate(self):
        """Run configured timestream simulations (skip existing ones)."""
        self._timed("simulate", self._simulate)

    # -------------------- generation stages --------------------

    def _stage_modes(self, name, ts):
        logger.info("Generating modes (%s)", name)
        ts.generate_mmodes()
        ts.generate_mmodes_svd()

    def _stage_klmodes(self, name, ts):
        for klname in self.klmodes:
            logger.info("Generating KL filter (%s:%s)", name, klname)
            ts.set_kltransform(klname)
            ts.generate_mmodes_kl()
            if self.collect_klmodes:
                ts.collect_mmodes_kl()

    def _stage_powerspectra(self, name, ts):
        for ps in self.powerspectra:
            logger.info("Estimating powerspectra (%s:%s)", name, ps["psname"])
            ts.set_kltransform(ps["klname"])
            ts.set_psestimator(ps["psname"])
            ts.powerspectrum()

    def _stage_maps(self, name, ts):
        for klname in self.klmaps:
            logger.info("Generating KL map (%s:%s)", name, klname)
            ts.set_kltransform(klname)
            ts.mapmake_kl(self.nside, f"map_{klname}.hdf5", wiener=self.wiener)

        logger.info("Generating SVD map (%s)", name)
        ts.mapmake_svd(self.nside, "map_svd.hdf5")

        logger.info("Generating full map (%s)", name)
        ts.mapmake_full(self.nside, "map_full.hdf5")

    def _run_crosspower(self):
        for xp in self.crosspower:
            tslist = []
            for tsname in xp["timestreams"]:
                ts = self.timestreams[tsname]
                ts.set_kltransform(xp["klname"])
                ts.set_psestimator(xp["psname"])
                tslist.append(ts)
            timestream.cross_powerspectrum(tslist, xp["psname"], fixpath(xp["psfile"]))

    def generate(self):
        """Generate all configured pipeline outputs, in stage order."""
        stages = (
            ("modes", self.generate_modes, self._stage_modes),
            ("klmodes", self.generate_klmodes, self._stage_klmodes),
            ("powerspectra", self.generate_powerspectra, self._stage_powerspectra),
            ("maps", self.generate_maps, self._stage_maps),
        )
        for name, enabled, stage in stages:
            if not enabled:
                continue
            self._timed(name, lambda: [stage(n, ts) for n, ts in self.timestreams.items()])
            if stage == self._stage_powerspectra:
                self._timed("crosspower", self._run_crosspower)

    run = generate
