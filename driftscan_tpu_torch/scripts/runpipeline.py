#!/usr/bin/env python
"""drift-runpipeline of the port: run the timestream pipeline from a config.

    python -m driftscan_tpu_torch.scripts.runpipeline run-config cfg.yaml [--device cpu]

The ``run-config`` command (also ``run``) is a thin ``click`` wrapper over
:func:`run_config`, which programs call directly: simulate the configured
timestreams, then m-modes -> SVD / KL modes -> power spectra and cross
power -> maps.  The products load on the card unless another device is
named.  Under torchrun it runs as one process of a group, as
``drift-makeproducts-torch run`` does (``--stats`` as there):

    torchrun --standalone --nproc-per-node N -m driftscan_tpu_torch.scripts.runpipeline run-config cfg.yaml

The ``interactive-config`` and ``queue-config`` commands of
driftscan are not ported yet (ROADMAP.md, modules to port, item 8.2).
"""

_NOT_PORTED = (
    "the {} command of drift-runpipeline is not ported yet: ROADMAP.md, "
    "modules to port, item 8.2"
)


def run_config(configfile, device=None):
    """Run the pipeline of the YAML ``configfile`` with its products on
    ``device`` (the card when None); returns the :class:`PipelineManager`
    (its ``timings`` hold the seconds of each stage)."""
    import logging

    from ..parallel import comm
    from ..pipeline import pipeline
    from .makeproducts import device_name

    pm = pipeline.PipelineManager.from_configfile(configfile, device=device)
    logging.info("process %i of %i on %s", comm.rank(), comm.size(),
                 device_name(comm.device(device)))
    pm.simulate()
    pm.generate()
    return pm


def _cli():
    import click

    from ..parallel import comm
    from .makeproducts import start, write_stats

    path = click.Path(exists=True, dir_okay=False, readable=True, resolve_path=True)

    @click.group()
    def cli():
        """Run a data-analysis pipeline on simulated or real timestreams."""

    @cli.command("run-config")
    @click.argument("configfile", type=path)
    @click.option("--device", default=None,
                  help="Device to run on (default: the CUDA card; 'cpu' for the host).")
    @click.option("--stats", default=None, metavar="PATH",
                  help="Write this process's device, timings and kernel launches as JSON "
                       "to PATH ('{rank}' becomes the rank).")
    def run(configfile, device, stats):
        """Run the pipeline from CONFIGFILE."""
        start()
        pm = run_config(configfile, device=device)
        if stats:
            write_stats(stats, comm.device(device), pm.timings)

    cli.add_command(run, "run")

    @cli.command("interactive-config")
    @click.argument("configfile", type=path)
    def interactive(configfile):
        """Load the pipeline config without running it (not ported yet)."""
        raise NotImplementedError(_NOT_PORTED.format("interactive-config"))

    @cli.command("queue-config")
    @click.argument("configfile", type=path)
    def queue(configfile):
        """Queue a pipeline run as a batch job (not ported yet)."""
        raise NotImplementedError(_NOT_PORTED.format("queue-config"))

    return cli


def main():
    _cli()()


if __name__ == "__main__":
    main()
