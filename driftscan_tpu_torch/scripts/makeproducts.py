#!/usr/bin/env python
"""drift-makeproducts of the port: generate analysis products from a config.

    python -m driftscan_tpu_torch.scripts.makeproducts run cfg.yaml [--device cpu]
    python -m driftscan_tpu_torch.scripts.makeproducts convert DIR

The ``run`` command is a thin ``click`` wrapper over :func:`run_config`,
which programs call directly.  Products are generated on the card unless
another device is named.  Under torchrun it runs as one process of a
group, each on the card of its local rank (two processes may share one):

    torchrun --standalone --nproc-per-node N -m driftscan_tpu_torch.scripts.makeproducts run cfg.yaml

``--profile`` writes a ``cProfile`` dump, or with ``--profiler torch`` a
device trace (``torch.profiler``), one file per process; ``--stats`` a
JSON file per process of its device, stage timings and kernel launches.
``convert`` rewrites the ``.npy`` directory stores of a finished product
directory (what a host without h5py writes) as HDF5 files
(``util.store.convert``; needs h5py).  The ``interactive`` and ``queue``
commands of driftscan are registered but not ported yet (ROADMAP.md,
modules to port, item 7.4).
"""

import logging

_NOT_PORTED = (
    "the {} command of drift-makeproducts is not ported yet: ROADMAP.md, "
    "modules to port, item 7.4"
)


def run_config(configfile, device=None, profile=False, profiler="cProfile"):
    """Generate the products of the YAML ``configfile`` on ``device`` (the
    card when None) and return the :class:`ProductManager`.  Under several
    processes every process calls it (after ``comm.init``)."""
    from ..core import manager
    from ..parallel import comm

    rank = comm.rank()

    prof = None
    if profile and profiler.lower() == "torch":
        from torch.profiler import ProfilerActivity, profile as torch_profile

        prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    elif profile:
        import cProfile

        prof = cProfile.Profile()
        prof.enable()

    m = manager.ProductManager.from_config(configfile, device=device)
    logging.info("process %i of %i on %s", rank, comm.size(), device_name(m.device))
    m.generate()

    if prof is not None and profiler.lower() == "torch":
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(f"torch_trace_{rank}.json")
        logging.info("torch trace written to torch_trace_%i.json", rank)
    elif prof is not None:
        prof.disable()
        prof.dump_stats(f"profile_{rank}.prof")
    return m


def start():
    """Join the process group of torchrun's environment (rank 0 of 1
    without one) and log with each record's rank; the run commands of the
    port's scripts start here."""
    from ..parallel import comm

    comm.init()
    _setup_logging()


def device_name(device) -> str:
    """``device`` and, for a card, its name."""
    import torch

    dev = torch.device(device)
    return f"{dev} ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else str(dev)


def write_stats(path, device, timings):
    """Write this process's rank, device, stage timings (seconds) and kernel
    launch counts as JSON to ``path``, with ``{rank}`` replaced by the
    rank."""
    import json

    from .. import backend
    from ..parallel import comm

    stats = {
        "rank": comm.rank(),
        "size": comm.size(),
        "device": device_name(device),
        "timings": timings,
        "launches": {k.name: k.launches for k in backend.KERNELS.values()},
    }
    with open(path.replace("{rank}", str(comm.rank())), "w") as f:
        json.dump(stats, f)


def _setup_logging():
    import math

    from ..parallel import comm

    size = comm.size()
    width = int(math.log10(size)) + 1
    filt = comm.MPILogFilter(level_all=logging.INFO, level_rank0=logging.INFO)
    formatter = logging.Formatter(
        f"%(asctime)s [MPI %(mpi_rank){width}d/%(mpi_size){width}d] - %(levelname)-8s "
        "%(name)s: %(message)s"
    )
    root_logger = logging.getLogger()
    root_logger.setLevel(level=logging.DEBUG)
    ch = logging.StreamHandler()
    ch.addFilter(filt)
    ch.setFormatter(formatter)
    root_logger.addHandler(ch)


def _cli():
    import click

    @click.group()
    def cli():
        """Generate products for modelling and analysing driftscan telescopes."""

    @cli.command()
    @click.argument(
        "configfile",
        type=click.Path(exists=True, dir_okay=False, readable=True, resolve_path=True),
    )
    @click.option("--device", default=None,
                  help="Device to run on (default: the CUDA card; 'cpu' for the host).")
    @click.option("--profile", is_flag=True, default=False,
                  help="Profile the run; writes profile_<rank>.prof or torch_trace_<rank>.json.")
    @click.option(
        "--profiler",
        type=click.Choice(["cProfile", "torch"], case_sensitive=False),
        default="cProfile",
        help="Which profiler to use ('torch' writes a device trace).",
    )
    @click.option("--stats", default=None, metavar="PATH",
                  help="Write this process's device, timings and kernel launches as JSON "
                       "to PATH ('{rank}' becomes the rank).")
    def run(configfile, device, profile, profiler, stats):
        """Immediately run the CONFIGFILE to generate products."""
        start()
        m = run_config(configfile, device=device, profile=profile, profiler=profiler)
        if stats:
            write_stats(stats, m.device, m.timings)

    @cli.command()
    @click.argument(
        "directory", type=click.Path(exists=True, file_okay=False, resolve_path=True)
    )
    def convert(directory):
        """Rewrite the .npy directory stores under DIRECTORY as HDF5 files."""
        from ..util import store

        if store.h5py is None:
            raise click.ClickException("convert needs h5py, which this Python cannot import")
        try:
            done = store.convert(directory)
        except ValueError as exc:
            raise click.ClickException(str(exc))
        click.echo(f"converted {len(done)} product files under {directory} to HDF5")

    config = click.Path(exists=True, dir_okay=False, readable=True, resolve_path=True)

    @cli.command()
    @click.argument("configfile", type=config)
    def interactive(configfile):
        """Load the config without generating (not ported yet)."""
        raise NotImplementedError(_NOT_PORTED.format("interactive"))

    @cli.command()
    @click.argument("configfile", type=config)
    def queue(configfile):
        """Write and submit a batch job script (not ported yet)."""
        raise NotImplementedError(_NOT_PORTED.format("queue"))

    return cli


def main():
    _cli()()


if __name__ == "__main__":
    main()
