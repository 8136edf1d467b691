"""The ``interactive`` and ``queue`` commands of the port's CLIs
(``drift-makeproducts-torch``, ``drift-runpipeline-torch``) against the JAX
package's, with ``--nosubmit`` (and one submission through ``bash``).

Both packages' ``queue`` write ``<output_directory>/<queue_sys>/`` with the
config's copy and ``jobscript.sh``: the copies are equal, the scheduler's
header lines (``#PBS``, ``#SBATCH``) are the JAX package's line for line,
and the job runs the port's CLI on the copy, with each process's ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` set (torchrun under PBS, Slurm's
variables under Slurm).  A ``script_template`` of the user's gives both
packages the same script.  ``queue_sys: tpu`` (the JAX default) and a
missing ``queue_sys`` raise a ValueError naming pbs, slurm and
script_template.  ``interactive`` loads the products on the CPU without
generating any.
"""

import os

import pytest
import yaml
from click.testing import CliRunner

from driftscan_tpu.scripts import makeproducts as jmakeproducts
from driftscan_tpu.scripts import runpipeline as jrunpipeline
from driftscan_tpu_torch.scripts import makeproducts, runpipeline

TEL = {"type": "UnpolarisedCylinder", "num_freq": 2, "num_feeds": 2, "num_cylinders": 2,
       "freq_start": 400.0, "freq_end": 410.0}


def _config(path, outdir, **conf):
    c = {"config": {"output_directory": str(outdir), "beamtransfers": True, **conf},
         "telescope": TEL}
    path.write_text(yaml.safe_dump(c))
    return str(path)


def _run(cli, *args):
    res = CliRunner().invoke(cli, [str(a) for a in args])
    assert res.exit_code == 0, (res.output, res.exception)
    return res


def _header(script, mark):
    return [ln for ln in script.splitlines() if ln.startswith(mark)]


@pytest.mark.parametrize("queue_sys,mark", [("pbs", "#PBS"), ("slurm", "#SBATCH")])
def test_queue_scripts_against_jax(tmp_path, queue_sys, mark):
    conf = dict(queue_sys=queue_sys, nodes=2, pernode=4, time="2:00:00", name="drift",
                account="acc", mem="64G", ppn=16, queue="gpu", ompnum=4)
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    _run(makeproducts._cli(), "queue", _config(tmp_path / "t.yaml", tdir, **conf), "--nosubmit")
    _run(jmakeproducts.cli, "queue", _config(tmp_path / "j.yaml", jdir, **conf), "--nosubmit")
    sub_t, sub_j = tdir / queue_sys, jdir / queue_sys
    assert sorted(os.listdir(sub_t)) == sorted(os.listdir(sub_j)) == ["config.yaml", "jobscript.sh"]
    ct = yaml.safe_load((sub_t / "config.yaml").read_text())
    cj = yaml.safe_load((sub_j / "config.yaml").read_text())
    assert ct["telescope"] == cj["telescope"] and ct["config"]["queue_sys"] == queue_sys
    st, sj = (sub_t / "jobscript.sh").read_text(), (sub_j / "jobscript.sh").read_text()
    print(st)
    assert _header(st, mark) and _header(st, mark) == _header(sj, mark)
    job = f"-m driftscan_tpu_torch.scripts.makeproducts run {sub_t}/config.yaml"
    assert job in st and f"&> {sub_t}/jobout.log" in st and "driftscan_tpu." not in st
    assert f"cd {tdir}" in st
    if queue_sys == "slurm":
        for var in ("RANK=$SLURM_PROCID", "WORLD_SIZE=$SLURM_NTASKS",
                    "LOCAL_RANK=$SLURM_LOCALID", "MASTER_ADDR=", "MASTER_PORT=29500"):
            assert var in st, var
    else:
        assert "torchrun --nnodes 2 --nproc-per-node 4" in st and "pbsdsh -u" in st


def test_script_template_and_submit(tmp_path):
    """A template of the user's is filled from the same keys in both
    packages; with --submit the port runs it with ``submit_command``."""
    tmpl = "#!/bin/bash\necho %(name)s %(nodes)i %(workdir)s > %(workdir)s/ran\n"
    conf = dict(queue_sys="mine", script_template=tmpl, submit_command="bash", name="x")
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    _run(makeproducts._cli(), "queue", _config(tmp_path / "t.yaml", tdir, **conf), "--nosubmit")
    _run(jmakeproducts.cli, "queue", _config(tmp_path / "j.yaml", jdir, **conf), "--nosubmit")
    st = (tdir / "mine" / "jobscript.sh").read_text()
    assert st == (jdir / "mine" / "jobscript.sh").read_text().replace(str(jdir), str(tdir))
    assert not (tdir / "ran").exists()
    _run(makeproducts._cli(), "queue", _config(tmp_path / "t.yaml", tdir, **conf))
    assert (tdir / "ran").read_text().split() == ["x", "1", str(tdir)]


@pytest.mark.parametrize("conf", [{}, {"queue_sys": "tpu"}, {"queue_sys": "lsf"}])
def test_queue_needs_a_gpu_scheduler(tmp_path, conf):
    cfg = _config(tmp_path / "c.yaml", tmp_path / "out", **conf)
    with pytest.raises(ValueError, match="'pbs' or 'slurm'.*script_template"):
        makeproducts.queue_job(cfg, submit=False)
    res = CliRunner().invoke(makeproducts._cli(), ["queue", cfg, "--nosubmit"])
    assert res.exit_code != 0 and "script_template" in res.output
    assert not (tmp_path / "out").exists()
    rel = tmp_path / "rel.yaml"
    rel.write_text(yaml.safe_dump({"config": {"output_directory": "out", "queue_sys": "pbs"}}))
    with pytest.raises(ValueError, match="absolute"):
        makeproducts.queue_job(str(rel), submit=False)


def test_runpipeline_queue_config_against_jax(tmp_path):
    """driftscan's plain job: ``<timestream_directory>/queue/`` with the
    config's copy and a script that runs ``run-config`` on it."""
    def cfg(path, out):
        path.write_text(yaml.safe_dump({"config": {"timestream_directory": str(out),
                                                   "product_directory": "p"}}))
        return str(path)

    tdir, jdir = tmp_path / "t", tmp_path / "j"
    _run(runpipeline._cli(), "queue-config", cfg(tmp_path / "t.yaml", tdir), "--nosubmit")
    _run(jrunpipeline.cli, "queue-config", cfg(tmp_path / "j.yaml", jdir), "--nosubmit")
    st = (tdir / "queue" / "jobscript.sh").read_text()
    sj = (jdir / "queue" / "jobscript.sh").read_text()
    print(st)
    assert st.splitlines()[:2] == [ln.replace(str(jdir), str(tdir)) for ln in sj.splitlines()[:2]]
    assert (f"python -m driftscan_tpu_torch.scripts.runpipeline run-config "
            f"{tdir}/queue/config.yaml &> {tdir}/queue/jobout.log") in st
    assert sorted(os.listdir(tdir / "queue")) == sorted(os.listdir(jdir / "queue"))


def test_interactive_loads_on_the_cpu(tmp_path):
    cfg = _config(tmp_path / "c.yaml", tmp_path / "out")
    res = _run(makeproducts._cli(), "interactive", cfg, "--device", "cpu")
    assert "products" in res.output
    p = makeproducts.products
    assert p.device.type == "cpu" and p.telescope.nfreq == 2
    # nothing was generated
    assert not os.path.exists(tmp_path / "out" / "bt" / "beam_m")
