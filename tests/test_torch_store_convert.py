"""The ``.npy`` directory store -> HDF5 converter (``util.store.convert``,
``drift-makeproducts-torch convert DIR``) on the CPU.

A small cylinder's products are made twice by the port: once with the
store patched to the ``.npy`` directories a host without h5py writes, once
through h5py.  The first directory is converted; then every file of the
h5py run has its converted counterpart with the same datasets (dtype,
shape, values bit for bit, chunk shape, codec) and attributes, no
directory store is left, and the JAX package's ``ProductManager`` (BTM,
SVD, KL) and ``PSExact.fisher_bias()`` read the converted directory and
agree with the port's reading of it.  The converter refuses a tree that
is still being written, and says that it needs h5py.  The ``interactive``
and ``queue`` commands run (their parity is in
tests/test_torch_cli_queue.py).
"""

import os
import shutil

import h5py
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from driftscan_tpu.core import manager as jmanager
from driftscan_tpu_torch.core import manager
from driftscan_tpu_torch.scripts import makeproducts
from driftscan_tpu_torch.util import store


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config(outdir):
    """Two channels, 2 x 2 feeds, KL and a Fisher (the products test's
    small config)."""
    return {
        "config": {"beamtransfers": True, "kltransform": True, "psfisher": True,
                   "output_directory": str(outdir)},
        "telescope": {
            "type": "UnpolarisedCylinder", "freq_start": 400.0, "freq_end": 410.0,
            "freq_mode": "edge", "num_cylinders": 2, "feed_spacing": 1.0, "tsys": 10.0,
            "num_freq": 2, "cylinder_width": 3.0, "num_feeds": 2,
        },
        "kltransform": [{"type": "KLTransform", "name": "kl", "threshold": 1e-7}],
        "psfisher": [{"type": "Full", "name": "ps", "klname": "kl", "threshold": 1e-7,
                      "k_bands": [{"spacing": "linear", "start": 0.0, "stop": 0.25,
                                   "num": 3}]}],
    }


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(npy directory before conversion, h5py directory)."""
    base = tmp_path_factory.mktemp("convert")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(store, "h5py", None)
        mp.setattr(store, "BACKEND", "npy")
        manager.ProductManager(device="cpu").apply_config(_config(base / "npy")).generate()
    finally:
        mp.undo()
    manager.ProductManager(device="cpu").apply_config(_config(base / "h5")).generate()
    for d in (base / "npy", base / "h5"):
        with open(d / "config.yaml", "w") as f:
            yaml.safe_dump(_config(d), f)
    return base / "npy", base / "h5"


def _stores(root):
    return [d for d, _, _ in os.walk(root) if store.is_directory_store(d)]


def _files(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, fs in os.walk(root) for f in fs if f.endswith(".hdf5")
    )


def _filters(dset):
    """The dataset's filter pipeline: (filter id, client values) each."""
    plist = dset.id.get_create_plist()
    return [plist.get_filter(i)[::2] for i in range(plist.get_nfilters())]


def _convert(path):
    return CliRunner().invoke(makeproducts._cli(), ["convert", str(path)])


@pytest.fixture(scope="module")
def converted(dirs, tmp_path_factory):
    npy, _ = dirs
    out = tmp_path_factory.mktemp("converted") / "products"
    shutil.copytree(npy, out)
    res = _convert(out)
    assert res.exit_code == 0, res.output
    assert "converted" in res.output
    return out


def test_every_file_converts_as_the_h5py_writer_writes_it(dirs, converted):
    npy, h5 = dirs
    assert len(_stores(npy)) > 0
    assert _stores(converted) == []
    names = _files(h5)
    assert names and names == _files(converted)
    compressed = 0
    for rel in names:
        with h5py.File(h5 / rel, "r") as want, h5py.File(converted / rel, "r") as got:
            assert sorted(got.keys()) == sorted(want.keys()), rel
            for key in want:
                a, b = want[key], got[key]
                assert (a.dtype, a.shape) == (b.dtype, b.shape), (rel, key)
                assert (a.chunks, _filters(a)) == (b.chunks, _filters(b)), (rel, key)
                compressed += bool(_filters(a))
                np.testing.assert_array_equal(b[()], a[()], err_msg=f"{rel}/{key}")
            assert sorted(got.attrs.keys()) == sorted(want.attrs.keys()), rel
            for key in want.attrs:
                np.testing.assert_array_equal(got.attrs[key], want.attrs[key],
                                              err_msg=f"{rel} attr {key}")
                assert type(got.attrs[key]) is type(want.attrs[key]), (rel, key)
    assert compressed > 0  # the beam and SVD files carry the codec


def test_the_jax_package_reads_the_converted_directory(dirs, converted):
    _, h5 = dirs
    with open(converted / "config.yaml", "w") as f:
        yaml.safe_dump(_config(converted), f)
    mj = jmanager.ProductManager.from_config(str(converted))
    mt = manager.ProductManager(device="cpu").apply_config(_config(h5))
    for mi in (0, mj.telescope.mmax):
        np.testing.assert_array_equal(mj.beamtransfer.beam_m(mi), mt.beamtransfer.beam_m(mi))
        np.testing.assert_array_equal(mj.beamtransfer.beam_svd(mi), mt.beamtransfer.beam_svd(mi))
    np.testing.assert_array_equal(mj.kltransforms["kl"].evals_all(),
                                  mt.kltransforms["kl"].evals_all())
    fisher, bias = mj.psestimators["ps"].fisher_bias()
    want_f, want_b = mt.psestimators["ps"].fisher_bias()
    assert np.abs(want_f).max() > 0
    np.testing.assert_array_equal(fisher, want_f)
    np.testing.assert_array_equal(bias, want_b)


def test_an_unfinished_tree_is_refused(dirs, tmp_path):
    npy, _ = dirs
    out = tmp_path / "products"
    shutil.copytree(npy, out)
    os.remove(out / "bt" / "beam_m" / "COMPLETED")
    res = _convert(out)
    assert res.exit_code != 0 and "still being written" in res.output
    assert "COMPLETED" in res.output
    open(out / "bt" / "beam_m" / "COMPLETED", "a").close()
    part = out / "bt" / "kl" / "ev_m_0.hdf5.123.part"
    part.mkdir()
    res = _convert(out)
    assert res.exit_code != 0 and ".part" in res.output
    assert len(_stores(out)) == len(_stores(npy))  # nothing converted
    part.rmdir()
    assert _convert(out).exit_code == 0 and _stores(out) == []


def test_convert_needs_h5py(dirs, tmp_path, monkeypatch):
    npy, _ = dirs
    monkeypatch.setattr(store, "h5py", None)
    res = _convert(npy)
    assert res.exit_code != 0 and "h5py" in res.output
    with pytest.raises(RuntimeError, match="h5py"):
        store.convert(str(npy))


@pytest.mark.parametrize("command", ["interactive", "queue"])
def test_unported_commands_cite_their_roadmap_item(dirs, tmp_path, command):
    """ROADMAP item 7.4 is ported: ``interactive`` loads the converted
    directory's products on the CPU into ``products``; ``queue --nosubmit``
    writes the Slurm job that runs this CLI on its config."""
    _, h5 = dirs
    conf = _config(h5)
    if command == "interactive":
        cfg = h5 / "config.yaml"
        res = CliRunner().invoke(makeproducts._cli(), [command, str(cfg), "--device", "cpu"])
        assert res.exit_code == 0, res.output
        assert makeproducts.products.beamtransfer.telescope.nfreq == 2
        assert "products" in res.output
        return
    conf["config"].update(queue_sys="slurm", output_directory=str(tmp_path))
    cfg = tmp_path / "q.yaml"
    cfg.write_text(yaml.safe_dump(conf))
    res = CliRunner().invoke(makeproducts._cli(), [command, str(cfg), "--nosubmit"])
    assert res.exit_code == 0, res.output
    script = (tmp_path / "slurm" / "jobscript.sh").read_text()
    assert "-m driftscan_tpu_torch.scripts.makeproducts run " in script
    assert yaml.safe_load((tmp_path / "slurm" / "config.yaml").read_text()) == conf
