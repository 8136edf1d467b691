"""Product manager: config -> object graph -> generated products.

Port of ``driftscan_tpu/core/manager.py``: consumes driftscan's YAML
schema (``config:`` / ``telescope:`` / ``kltransform:`` / ``psfisher:``
sections), supports registry names or ``{module, class[, file]}`` plugin
specs for every component type, stages the output directory with a
path-rewritten copy of the config, and sequences generation as
beam-transfers -> KL filters -> PS estimators.

Everything runs on ``device``: the card unless the caller names another
(``device="cpu"``), so a host without CUDA fails at once unless asked for
the CPU.  Under several processes (``parallel.comm``) each takes the card
of its local rank; process 0 creates the directory and writes the config
copies, and ``timings`` are each process's own.  ``apply_config`` takes a
parsed dictionary and needs no YAML package; ``from_config`` and the
config dump import ``yaml`` themselves.
The registries list what the port has; an unknown name gives the
registry's error with the known ones.
"""

from __future__ import annotations

import logging
import os
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..parallel import comm

logger = logging.getLogger(__name__)


# ------------------------------------------------------------------
# Component registries
# ------------------------------------------------------------------


@dataclass
class Registry:
    """Name -> class lookup with plugin loading.

    A component ``type`` in the config is either a registered name or a
    mapping ``{module: ..., class: ..., file: ...}``; with ``file`` the
    module is loaded from that path, otherwise imported normally.
    """

    kind: str
    entries: Dict[str, Callable]

    def resolve(self, spec):
        if isinstance(spec, dict):
            return self._load_plugin(spec)
        try:
            return self.entries[spec]
        except KeyError:
            known = ", ".join(sorted(self.entries))
            raise Exception(
                f"Unsupported {self.kind} type {spec!r} (known: {known})"
            ) from None

    @staticmethod
    def _load_plugin(spec):
        import importlib
        import importlib.util
        import sys

        modname, clsname = spec["module"], spec["class"]
        if "file" in spec:
            existing = sys.modules.get(modname)
            if existing is not None and getattr(existing, "__file__", None) != str(
                spec["file"]
            ):
                raise ValueError(
                    f"Plugin module name {modname!r} collides with an already "
                    f"imported module ({getattr(existing, '__file__', existing)}); "
                    "choose a unique 'module' name in the plugin spec"
                )
            loader_spec = importlib.util.spec_from_file_location(modname, spec["file"])
            module = importlib.util.module_from_spec(loader_spec)
            # Register before exec so the module is importable by name:
            # required for pickling plugin telescopes into the product
            # directory (beamtransfer stores the telescope object).
            sys.modules[modname] = module
            try:
                loader_spec.loader.exec_module(module)
            except BaseException:
                # Don't leave a half-initialised module importable by name.
                sys.modules.pop(modname, None)
                raise
        else:
            module = importlib.import_module(modname)
        return getattr(module, clsname)


def _telescope_registry() -> Registry:
    from ..telescope import (
        cylinder,
        disharray,
        exotic_cylinder,
        focalplane,
        gmrt,
        restrictedcylinder,
    )

    return Registry(
        "telescope",
        {
            "UnpolarisedCylinder": cylinder.UnpolarisedCylinderTelescope,
            "PolarisedCylinder": cylinder.PolarisedCylinderTelescope,
            "GMRT": gmrt.GmrtUnpolarised,
            "FocalPlane": focalplane.FocalPlaneArray,
            "RestrictedCylinder": restrictedcylinder.RestrictedCylinder,
            "RestrictedPolarisedCylinder": restrictedcylinder.RestrictedPolarisedCylinder,
            "RestrictedExtra": restrictedcylinder.RestrictedExtra,
            "GradientCylinder": exotic_cylinder.GradientCylinder,
            "PertCylinder": exotic_cylinder.CylinderPerturbed,
            "DishArray": disharray.DishArray,
        },
    )


def _kl_registry() -> Registry:
    from . import doublekl, kltransform

    return Registry(
        "KL filter",
        {
            "KLTransform": kltransform.KLTransform,
            "DoubleKL": doublekl.DoubleKL,
        },
    )


def _ps_registry() -> Registry:
    from . import crosspower, psestimation, psmc

    return Registry(
        "PS estimator",
        {
            "Full": psestimation.PSExact,
            "MonteCarlo": psmc.PSMonteCarlo,
            "MonteCarloAlt": psmc.PSMonteCarloAlt,
            "Cross": crosspower.CrossPower,
        },
    )


# ------------------------------------------------------------------
# Config-file staging
# ------------------------------------------------------------------


def _expand(path: str) -> str:
    return os.path.normpath(os.path.expandvars(os.path.expanduser(path)))


def _stage_config(configfile: str) -> str:
    """Copy the config into its own output directory, rewriting a relative
    ``output_directory`` to an absolute path, and return the staged path.

    Only process 0 writes; everyone synchronises after.
    """
    import yaml

    with open(configfile) as f:
        raw = f.read()
    outdir = yaml.safe_load(raw)["config"]["output_directory"]
    staged = os.path.join(outdir, "config.yaml")

    if comm.rank0():
        os.makedirs(outdir, exist_ok=True)
        same = os.path.exists(staged) and os.path.samefile(configfile, staged)
        if not same:
            if not os.path.isabs(outdir):
                absdir = os.path.abspath(
                    os.path.join(os.path.dirname(configfile), outdir)
                )
                raw = raw.replace(outdir, absdir)
            with open(staged, "w") as f:
                f.write(raw)
    comm.barrier()
    return staged


# ------------------------------------------------------------------
# The manager
# ------------------------------------------------------------------


class ProductManager:
    """Builds and owns the telescope / BTM / KL / PS object graph.

    Attributes after :meth:`apply_config`: ``telescope``,
    ``beamtransfer``, ``kltransforms`` (name -> object), ``psestimators``
    (name -> object), ``directory``; after :meth:`generate`, ``timings``
    (seconds per stage).
    """

    directory: Optional[str] = None

    gen_beams = False
    gen_kl = False
    gen_ps = False
    gen_proj = False

    skip_svd = False
    skip_svd_inv = False

    def __init__(self, device=None):
        self.device = comm.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the product pipeline runs on a CUDA device and none is "
                'available; pass device="cpu" to run it on the host'
            )
        self.timings = {}

    @classmethod
    def from_config(cls, configfile, device=None):
        """Create a ProductManager from a YAML config file or directory."""
        import yaml

        m = cls(device=device)
        configfile = _expand(configfile)
        if not os.path.exists(configfile):
            raise Exception(f"Configuration file does not exist {configfile}.")
        if os.path.isdir(configfile):
            configfile = os.path.join(configfile, "config.yaml")

        staged = _stage_config(configfile)
        with open(staged) as f:
            yconf = yaml.safe_load(f)

        # product runs ride the port's recorded engine picks (environment
        # variables win; no record keeps the defaults)
        from .. import engine_picks

        adopted = engine_picks.adopt_decision_records(device=m.device)
        if adopted:
            logger.info("Adopted recorded engine picks: %s", adopted)

        m.apply_config(yconf)
        return m

    # -------------------- construction --------------------

    def apply_config(self, yconf):
        """Instantiate the object graph from a parsed config dictionary;
        returns self."""
        for required in ("config", "telescope"):
            if required not in yconf:
                raise ValueError(
                    f"Configuration file must have an '{required}' section."
                )

        self.config = yconf
        cfg = yconf["config"]

        self.directory = _expand(cfg["output_directory"])
        if comm.rank0():
            logger.info("Product directory: %s (device %s)", self.directory, self.device)

        self._build_telescope(yconf["telescope"], cfg)
        self._build_beamtransfer(cfg)
        self._build_kltransforms(yconf.get("kltransform", ()), cfg)
        self._build_psestimators(yconf.get("psfisher", ()), cfg)
        return self

    def _build_telescope(self, telconf, cfg):
        telclass = _telescope_registry().resolve(telconf["type"])
        self.telescope = telclass.from_config(telconf, device=self.device)

        if cfg.get("reionisation"):
            from . import skymodel

            skymodel._reionisation = True

    def _build_beamtransfer(self, cfg):
        from . import beamtransfer

        variants = {
            "nosvd": beamtransfer.BeamTransferNoSVD,
            "fullsvd": beamtransfer.BeamTransferFullSVD,
        }
        btclass = beamtransfer.BeamTransfer
        for key, klass in variants.items():
            if cfg.get(key):
                btclass = klass

        self.beamtransfer = btclass(
            os.path.join(self.directory, "bt") + "/", telescope=self.telescope
        )
        self.beamtransfer.read_config(cfg)

        self.gen_beams = bool(cfg.get("beamtransfers"))
        self.skip_svd = bool(cfg.get("skip_svd"))

    def _build_kltransforms(self, entries, cfg):
        registry = _kl_registry()
        self.kltransforms = {}
        for entry in entries:
            name = entry["name"]
            klclass = registry.resolve(entry["type"])
            self.kltransforms[name] = klclass.from_config(
                entry, self.beamtransfer, subdir=name
            )
        self.gen_kl = bool(cfg.get("kltransform"))

    def _build_psestimators(self, entries, cfg):
        registry = _ps_registry()
        self.psestimators = {}

        self.gen_ps = bool(cfg.get("psfisher"))
        if self.gen_ps and not entries:
            raise Exception("Require a psfisher section if config: psfisher is Yes.")

        for entry in entries:
            psname = entry.get("name", "ps")
            klname = entry["klname"]
            psclass = registry.resolve(entry["type"])

            kl = self.kltransforms.get(klname)
            if kl is None:
                warnings.warn(f"Desired KL object (name: {klname}) does not exist.")
                self.psestimators[psname] = None
            else:
                self.psestimators[psname] = psclass.from_config(
                    entry, kl, subdir=psname
                )

    # -------------------- generation --------------------

    def _dump_config(self):
        """Write the parsed config beside the products (YAML where the
        package is installed, else its ``repr``)."""
        path = os.path.join(self.directory, "configdump.yaml")
        try:
            import yaml
        except ImportError:
            with open(path, "w") as fh:
                fh.write(repr(self.config) + "\n")
            return
        with open(path, "w") as fh:
            yaml.dump(self.config, fh)

    def generate(self):
        """Run every enabled generation stage, in dependency order."""
        if comm.rank0():
            os.makedirs(self.directory, exist_ok=True)
            self._dump_config()
        comm.barrier()

        for enabled, stage in (
            (self.gen_beams, self._generate_beams),
            (self.gen_kl, self._generate_kl),
            (self.gen_ps, self._generate_ps),
        ):
            if enabled:
                stage()

        if comm.rank0():
            logger.info("DONE GENERATING PRODUCTS")

    def _timed(self, name, fn):
        t = time.time()
        fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[name] = time.time() - t

    def _generate_beams(self):
        self._timed(
            "beams", lambda: self.beamtransfer.generate(skip_svd=self.skip_svd)
        )
        self.timings.update(
            {f"beams.{k}": v for k, v in self.beamtransfer.timings.items()}
        )

    def _generate_kl(self):
        for name, klobj in self.kltransforms.items():
            self._timed(f"kl.{name}", klobj.generate)

    def _generate_ps(self):
        for name, psobj in self.psestimators.items():
            if psobj is None:
                continue

            def run(ps=psobj):
                ps.generate()
                ps.delbands()

            self._timed(f"ps.{name}", run)
