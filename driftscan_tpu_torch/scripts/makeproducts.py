#!/usr/bin/env python
"""drift-makeproducts of the port: generate analysis products from a config.

    python -m driftscan_tpu_torch.scripts.makeproducts run cfg.yaml [--device cpu]
    python -m driftscan_tpu_torch.scripts.makeproducts interactive cfg.yaml [--device cpu]
    python -m driftscan_tpu_torch.scripts.makeproducts queue cfg.yaml [--nosubmit]
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
(``util.store.convert``; needs h5py).  ``interactive`` loads the
products without generating them into the global ``products`` (run it
under ``python -i``).  ``queue`` writes ``<output_directory>/<queue_sys>/``
``config.yaml`` and ``jobscript.sh`` from the config's ``queue_sys``
(``pbs`` or ``slurm``) or its own ``script_template``, and submits it
(``qsub``, ``sbatch`` or ``submit_command``) unless ``--nosubmit``: the
job runs this CLI, one process per card, each given ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` (by ``torchrun`` under PBS, from
Slurm's variables under Slurm).
"""

import logging
import os

products = None

# Job scripts of ``queue``: driftscan's PBS and Slurm headers; the job
# starts ``pernode`` processes a node (one a card).  The processes join
# their group from the environment (parallel.comm.init): under PBS one
# torchrun a node (pbsdsh -u) meets at the first node; under Slurm each
# task exports its rank from Slurm's variables.
pbs_script = """#!/bin/bash
#PBS -l nodes=%(nodes)i:ppn=%(ppn)i
#PBS -q %(queue)s
#PBS -r n
#PBS -m abe
#PBS -V
#PBS -l walltime=%(time)s
#PBS -N %(name)s
source %(venv)s
cd %(workdir)s
export OMP_NUM_THREADS=%(ompnum)i
export MASTER_ADDR=$(head -n 1 $PBS_NODEFILE)
pbsdsh -u bash -c "cd %(workdir)s && source %(venv)s && OMP_NUM_THREADS=%(ompnum)i \\
  torchrun --nnodes %(nodes)i --nproc-per-node %(pernode)i --rdzv-backend c10d \\
  --rdzv-endpoint $MASTER_ADDR:%(port)i --rdzv-id $PBS_JOBID \\
  -m driftscan_tpu_torch.scripts.makeproducts run %(configpath)s" &> %(logpath)s
"""

slurm_script = """#!/bin/bash
#SBATCH --account=%(account)s
#SBATCH --nodes=%(nodes)i
#SBATCH --ntasks-per-node=%(pernode)i
#SBATCH --cpus-per-task=%(ompnum)i
#SBATCH --mem=%(mem)s
#SBATCH --time=%(time)s
#SBATCH --job-name=%(name)s

source %(venv)s
cd %(workdir)s

export OMP_NUM_THREADS=$SLURM_CPUS_PER_TASK
export MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
export MASTER_PORT=%(port)i

srun bash -c 'RANK=$SLURM_PROCID WORLD_SIZE=$SLURM_NTASKS LOCAL_RANK=$SLURM_LOCALID \\
  exec python -m driftscan_tpu_torch.scripts.makeproducts run %(configpath)s' &> %(logpath)s
"""

script_templates = {"pbs": pbs_script, "slurm": slurm_script}
submit_commands = {"pbs": "qsub", "slurm": "sbatch"}


def queue_job(configfile, submit=True):
    """Write (and with ``submit`` submit) a batch job running ``configfile``.

    The config's ``config`` section names the scheduler (``queue_sys``:
    ``pbs`` or ``slurm``, or any name with its own ``script_template``, a
    %-format string over the keys below) and the job's resources
    (``nodes``, ``time``, ``ppn``, ``mem``, ``account``, ``ompnum``,
    ``queue``, ``pernode``, ``name``, ``venv``, ``port``, the defaults of
    driftscan's ``queue``).  The config is copied to
    ``<directory>/<queue_sys>/config.yaml`` beside ``jobscript.sh``, where
    ``directory`` is ``output_directory`` (else ``timestream_directory``),
    an absolute path.  The job runs this CLI's ``run`` on the copy.
    Returns the script's path."""
    import shutil
    import subprocess

    import yaml

    with open(configfile) as f:
        yconf = yaml.safe_load(f)
    if not isinstance(yconf, dict) or "config" not in yconf:
        raise ValueError("Configuration file must have an 'config' section.")
    conf = yconf["config"]
    outdir = conf.get("output_directory", conf.get("timestream_directory"))
    if outdir is None:
        raise ValueError("the config section needs 'output_directory'")
    outdir = os.path.normpath(os.path.expandvars(os.path.expanduser(outdir)))
    if not os.path.isabs(outdir):
        raise ValueError("Output directory path must be absolute.")

    queue_sys = conf.get("queue_sys")
    if queue_sys in (None, "tpu"):
        raise ValueError(
            f"queue_sys {queue_sys!r} has no counterpart on a GPU host: set queue_sys to "
            "'pbs' or 'slurm', or give a script_template (with a queue_sys name of its own)"
        )
    if queue_sys not in script_templates and "script_template" not in conf:
        raise ValueError(
            f"unknown queue_sys {queue_sys!r}: use 'pbs' or 'slurm', or give a script_template"
        )

    submitdir = os.path.join(outdir, queue_sys)
    os.makedirs(submitdir, exist_ok=True)
    dfile = os.path.join(submitdir, "config.yaml")
    if os.path.realpath(configfile) != os.path.realpath(dfile):
        shutil.copy(configfile, dfile)

    cluster = {
        "queue_sys": queue_sys,
        "nodes": conf.get("nodes", 1),
        "time": conf.get("time", "1:00:00"),
        "ppn": conf.get("ppn", 8),
        "mem": conf.get("mem", "0"),
        "account": conf.get("account", ""),
        "ompnum": conf.get("ompnum", 8),
        "queue": conf.get("queue", "batch"),
        "pernode": conf.get("pernode", 1),
        "name": conf.get("name", "job"),
        "workdir": outdir,
        "logpath": os.path.join(submitdir, "jobout.log"),
        "configpath": dfile,
        "venv": conf.get("venv", "/dev/null"),
        "port": conf.get("port", 29500),
    }
    cluster["mpiproc"] = cluster["nodes"] * cluster["pernode"]
    script = conf.get("script_template", script_templates.get(queue_sys)) % cluster

    scriptname = os.path.join(submitdir, "jobscript.sh")
    with open(scriptname, "w") as f:
        f.write(script)
    if submit:
        cmd = conf.get("submit_command", submit_commands.get(queue_sys, "bash"))
        subprocess.run(f"{cmd} jobscript.sh", shell=True, cwd=submitdir, check=True)
    return scriptname


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
    @click.option("--device", default=None,
                  help="Device to load on (default: the CUDA card; 'cpu' for the host).")
    def interactive(configfile, device):
        """Load the config but do not generate; exposes `products` globally.

        Use: python -i -m driftscan_tpu_torch.scripts.makeproducts interactive config.yaml
        """
        from ..core import manager

        global products
        products = manager.ProductManager.from_config(configfile, device=device)
        click.echo("*** Access analysis products through the global variable `products` ***")

    @cli.command()
    @click.argument("configfile", type=config)
    @click.option("--submit/--nosubmit", default=True,
                  help="Submit the job to the queue (or not)")
    def queue(configfile, submit):
        """Write (and optionally submit) a batch job running CONFIGFILE."""
        try:
            path = queue_job(configfile, submit=submit)
        except ValueError as exc:
            raise click.ClickException(str(exc))
        click.echo(f"wrote {path}")

    return cli


def main():
    _cli()()


if __name__ == "__main__":
    main()
