"""The port's device mesh (``driftscan_tpu_torch.parallel.mesh``) against the
JAX package's (``driftscan_tpu.parallel.mesh``) on the same numpy inputs.

The JAX meshes run on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's on 2-8 entries of ``cpu`` (virtual devices, one worker thread
each).  The counterparts of ``tests/test_comm.py::test_mesh_virtual_devices``
and ``tests/test_transpose.py``; the batched solves and the resident
product on a mesh are in ``tests/test_torch_mesh_pipeline.py``.
"""

import os
import sys
import threading
from contextlib import nullcontext

import jax
import numpy as np
import pytest
import torch

from driftscan_tpu.parallel import mesh as jmesh
from driftscan_tpu_torch import backend
from driftscan_tpu_torch.parallel import comm
from driftscan_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _meshes(n):
    devices = jax.devices()
    if len(devices) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jmesh.make_mesh(devices[:n]), tmesh.make_mesh(["cpu"] * n)


def _jax_shards(arr, mesh):
    """The per-device blocks of a JAX array, in the mesh's device order."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in mesh.devices.flat]


@pytest.mark.parametrize("n", [2, 8])
def test_pad_batch_matches_jax(n):
    jm, tm = _meshes(n)
    for k in (0, 1, n - 1, n, n + 1, 9, 37):
        assert tmesh.pad_batch(k, tm) == jmesh.pad_batch(k, jm)
    with tmesh.use_mesh(tm):
        assert tmesh.n_devices() == n and tmesh.pad_batch(9) == jmesh.pad_batch(9, jm)


@pytest.mark.parametrize("n,shape", [(8, (16, 4)), (4, (8, 3, 5)), (2, (6,))])
def test_shard_batch_matches_jax(n, shape):
    jm, tm = _meshes(n)
    x = np.random.default_rng(len(shape)).standard_normal(shape)
    want = _jax_shards(jmesh.shard_batch(x, jm), jm)
    got = tmesh.shard_batch(x, tm)
    assert isinstance(got, tmesh.Shards) and len(got) == n
    for g, w in zip(got, want):
        assert g.device == torch.device("cpu")
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(tmesh.gather(got).numpy(), x)
    with pytest.raises(ValueError):
        tmesh.shard_batch(np.zeros((n + 1, 2)), tm)


@pytest.mark.parametrize("n,shape", [(8, (16, 3, 24)), (4, (8, 12)), (2, (2, 2, 2, 6))])
def test_transpose_sharded_matches_jax(n, shape):
    """The all-to-all: column blocks equal to the JAX exchange's per-device
    blocks and, gathered, to the input (a plain transpose of the layout)."""
    jm, tm = _meshes(n)
    x = np.random.default_rng(n).standard_normal(shape).astype(np.float32)
    jout = jmesh.transpose_sharded(jax.numpy.asarray(x), jm)
    got = tmesh.transpose_sharded(x, tm)
    assert len(got) == n
    for g, w in zip(got, _jax_shards(jout, jm)):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(tmesh.gather(got, axis=-1).numpy(), x)
    np.testing.assert_array_equal(tmesh.gather(got, axis=-1).numpy(), np.asarray(jout))
    # from row shards as well
    again = tmesh.transpose_sharded(tmesh.shard_batch(x, tm), tm)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("shape", [(10, 24), (16, 3, 10)])
def test_transpose_sharded_rejects_indivisible(shape):
    jm, tm = _meshes(8)
    with pytest.raises(ValueError):
        jmesh.transpose_sharded(jax.numpy.zeros(shape), jm)
    with pytest.raises(ValueError):
        tmesh.transpose_sharded(np.zeros(shape), tm)


def test_default_mesh(monkeypatch):
    """device='cpu': one CPU entry; under more than one process the
    process's own card; with no card and no CPU asked for: an error, never
    a CPU mesh."""
    m = tmesh.make_mesh(device="cpu")
    assert m.devices == (torch.device("cpu"),) and m.axis_names == ("m",)
    assert tmesh.get_mesh("cpu").size == 1 and tmesh.n_devices("cpu") == 1
    assert tmesh.multi(m) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
    monkeypatch.setattr(comm, "size", lambda: 2)
    monkeypatch.setattr(comm, "device", lambda name=None: torch.device("cuda", 1))
    m = tmesh.make_mesh()
    assert m.devices == (torch.device("cuda", 1),)
    assert tmesh.make_mesh(device="cpu").devices == (torch.device("cpu"),)
    monkeypatch.setattr(comm, "device", lambda name=None: torch.device("cuda"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()


def test_active_mesh():
    tm = tmesh.make_mesh(["cpu"] * 3)
    with tmesh.use_mesh(tm):
        assert tmesh.get_mesh() is tm and tmesh.get_mesh("cuda") is tm
    assert tmesh.get_mesh("cpu").size == 1
    tmesh.set_mesh(tm)
    try:
        assert tmesh.n_devices() == 3
    finally:
        tmesh.set_mesh(None)


def test_mesh_checks():
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        tmesh.Mesh([torch.device("cpu"), torch.device("cuda", 0)])
    with pytest.raises(ValueError):
        tmesh.Mesh([])
    with pytest.raises(TypeError, match="Mesh"):
        tmesh.multi(object())
    with pytest.raises(TypeError, match="Mesh"):
        tmesh.multi(jmesh.make_mesh(jax.devices()[:2]))
    two = tmesh.Mesh(["cpu", "cpu"])
    assert tmesh.multi(two) is two and two.distinct == (torch.device("cpu"),)


def test_replicate_one_copy_a_device():
    tm = tmesh.make_mesh(["cpu"] * 4)
    x = torch.arange(6.0)
    r = tmesh.replicate(x, tm)
    assert len(r) == 4 and all(t is r[0] for t in r) and r[0] is x
    a = np.ones(3)
    ra = tmesh.replicate(a, tm)
    assert all(t is ra[0] for t in ra) and isinstance(ra[0], torch.Tensor)
    assert tmesh.replicate(2.5, tm) == (2.5,) * 4
    assert tmesh.replicate(r, tm) is r


def test_shard_map_runs_each_entry_in_its_worker():
    tm = tmesh.make_mesh(["cpu"] * 4)
    names = []

    def fn(x, s):
        names.append(threading.current_thread().name)
        return x * s, x.sum(1)

    x = torch.arange(10.0).reshape(5, 2)
    y, sums = tmesh.shard_map(fn, tm, sharded=(x,), replicated=(3.0,), pad=True)
    assert torch.equal(y, 3.0 * x) and torch.equal(sums, x.sum(1))
    assert len(names) == 4 and all(n.startswith("mesh") for n in names)
    parts = tmesh.shard_map(lambda x: x.shape[0], tm, sharded=(np.zeros(8),), stack=False)
    assert parts == (2, 2, 2, 2)
    with pytest.raises(ValueError):
        tmesh.shard_map(lambda x: x, tm, sharded=(np.zeros(6),))

    def boom(x):
        if int(x[0]) == 4:
            raise RuntimeError("entry 2 failed")
        return x

    with pytest.raises(RuntimeError, match="entry 2 failed"):
        tmesh.shard_map(boom, tm, sharded=(torch.arange(8),))


def test_worker_threads_take_the_callers_thread_count():
    tm = tmesh.make_mesh(["cpu"] * 2)
    torch.set_num_threads(2)
    assert tmesh.shard_map(lambda x: torch.get_num_threads(), tm,
                           sharded=(np.zeros(2),), stack=False) == (2, 2)
    torch.set_num_threads(1)
    assert tmesh.shard_map(lambda x: torch.get_num_threads(), tm,
                           sharded=(np.zeros(2),), stack=False) == (1, 1)


def test_launch_counts_under_worker_threads(monkeypatch):
    """``backend.launch`` counts every launch of threads launching at once
    (the C call and the device guard stubbed: no card here): more worker
    threads than cores and a short switch interval, so that a lost update
    of the count would show."""
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(backend, "stream_ptr", lambda d: 0)
    k = backend.Kernel("test_kernel", "none.cu", "none:0")
    seen = []

    def fn(*args):
        seen.append(args)
        return 0

    n = 2 * (os.cpu_count() or 8)
    tm = tmesh.make_mesh(["cpu"] * n)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tmesh.shard_map(
            lambda x: [backend.launch(k, fn, "cuda:0", 1, 2) for _ in range(2000)],
            tm, sharded=(np.zeros(n),), stack=False,
        )
    finally:
        sys.setswitchinterval(interval)
    assert k.launches == n * 2000 and seen[0] == (1, 2, 0)

    def bad(*args):
        return 700

    with pytest.raises(RuntimeError, match="test_kernel: CUDA error 700"):
        backend.launch(k, bad, "cuda:0")
    assert k.launches == n * 2000


def test_dryrun_multichip_on_cpu(capsys):
    out = tmesh.dryrun_multichip(4, device="cpu")
    assert out["devices"] == ["cpu"] * 4 and out["m"] == 8
    assert out["vs_unsharded"] <= 1e-10
    assert np.isfinite(out["fisher_diag"]).all()
    assert "dryrun_multichip OK: 4 entries" in capsys.readouterr().out
