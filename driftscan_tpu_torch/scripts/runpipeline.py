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

``interactive-config`` loads the pipeline without running it into the
global ``manager`` (run it under ``python -i``).  ``queue-config`` writes
``<timestream_directory>/queue/config.yaml`` and a ``jobscript.sh`` that
runs ``run-config`` on it (one process), and runs the script with
``bash`` unless ``--nosubmit``, as driftscan does.
"""

import os

manager = None

_SCRIPT = "#!/bin/bash\ncd %s\npython -m driftscan_tpu_torch.scripts.runpipeline run-config %s &> %s\n"


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


def queue_config(configfile, submit=True):
    """Write (and with ``submit`` run) a job running ``configfile``'s
    pipeline; returns the script's path (see the module docstring)."""
    import shutil
    import subprocess

    import yaml

    with open(configfile) as f:
        conf = yaml.safe_load(f)["config"]
    outdir = os.path.normpath(os.path.expandvars(os.path.expanduser(conf["timestream_directory"])))
    if not os.path.isabs(outdir):
        raise ValueError("Output directory path must be absolute.")
    submitdir = os.path.join(outdir, "queue")
    os.makedirs(submitdir, exist_ok=True)
    dfile = os.path.join(submitdir, "config.yaml")
    if os.path.realpath(configfile) != os.path.realpath(dfile):
        shutil.copy(configfile, dfile)
    scriptname = os.path.join(submitdir, "jobscript.sh")
    with open(scriptname, "w") as f:
        f.write(_SCRIPT % (outdir, dfile, os.path.join(submitdir, "jobout.log")))
    if submit:
        subprocess.run("bash jobscript.sh", shell=True, cwd=submitdir, check=True)
    return scriptname


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
    @click.option("--device", default=None,
                  help="Device to load on (default: the CUDA card; 'cpu' for the host).")
    def interactive(configfile, device):
        """Load the pipeline config without running it (exposes `manager`)."""
        from ..pipeline import pipeline

        global manager
        manager = pipeline.PipelineManager.from_configfile(configfile, device=device)
        click.echo("*** Access the pipeline through the global variable `manager` ***")

    @cli.command("queue-config")
    @click.argument("configfile", type=path)
    @click.option("--submit/--nosubmit", default=True)
    def queue(configfile, submit):
        """Queue a pipeline run as a batch job."""
        try:
            scriptname = queue_config(configfile, submit=submit)
        except ValueError as exc:
            raise click.ClickException(str(exc))
        click.echo(f"wrote {scriptname}")

    return cli


def main():
    _cli()()


if __name__ == "__main__":
    main()
