"""The coordination verbs of driftscan_tpu_torch (``parallel/comm.py``)
under 2 and 3 real ``gloo`` processes on the CPU.

The analogue of the JAX package's ``tests/test_multiprocess.py``: this file
runs itself as the worker (``python test_torch_comm_mp.py worker RANK SIZE
RDZV OUT``); each worker joins the group through a ``file://`` rendezvous
(no TCP port to race for between test workers), calls every verb, and
saves what it got; the tests hold the results against plain numpy and
the JAX package's partitions (imported by the tests only: a worker imports
no JAX).
``transpose_blocks`` runs on uneven splits (7 rows and 5 columns, and 2
rows and 4 columns, so that with 3 ranks one holds no rows), in
complex128 and float64, from numpy arrays and from tensors.  The workers
also create and write ``.npy`` directory stores as the chunked BTM route
does where h5py is missing (one process creates a file, another writes it
in place after a barrier).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NFILES = 5  # directory stores of the store test

# (global shape, dtype, extra last-axis entries to trim)
CASES = {
    "c128": ((7, 2, 5), np.complex128, 0),
    "c128_trim": ((7, 3, 5), np.complex128, 2),
    "f64_2d": ((7, 5), np.float64, 0),
    "few_rows": ((2, 4), np.complex128, 0),
}


def _global(name):
    shape, dtype, extra = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    full = shape[:-1] + (shape[-1] + extra,)
    a = rng.standard_normal(full)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(full)
    return a.astype(dtype)


def _worker(rank, size, rdzv, out):
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from driftscan_tpu_torch.parallel import comm

    assert comm.init(rank, size, f"file://{rdzv}") == (rank, size)
    res = {"rank": comm.rank(), "size": comm.size(), "rank0": comm.rank0(),
           "out": os.path.join(out, f"rank_{rank}.npz")}

    for name, (shape, _, _) in CASES.items():
        a = _global(name)
        _, s, e = comm.split_local(shape[0])
        got = comm.transpose_blocks(a[s:e], shape)
        res[f"tb_{name}"] = np.ascontiguousarray(got)
        got_t = comm.transpose_blocks(torch.as_tensor(a[s:e]), shape)
        assert torch.is_tensor(got_t)
        res[f"tbt_{name}"] = got_t.contiguous().numpy()

    base = np.arange(6, dtype=np.float64).reshape(2, 3)
    res["allreduce_c"] = comm.allreduce((rank + 1) * (base + 1j * base[::-1]))
    t = comm.allreduce(torch.full((3,), float(rank + 1), dtype=torch.float64))
    assert torch.is_tensor(t)
    res["allreduce_t"] = t.numpy()
    res["allreduce_i"] = comm.allreduce(np.array([rank, 1], dtype=np.int64))

    obj = {"a": [3, 1, 4], "b": "driftscan", "c": np.arange(3)} if rank == 0 else None
    got = comm.bcast(obj)
    res["bcast_a"], res["bcast_b"], res["bcast_c"] = got["a"], got["b"], got["c"]

    res["pmap"] = np.array(comm.parallel_map(lambda x: np.array([x * 2.0, x + 0.5]), range(5)))
    few = list(range(size - 1))  # fewer items than processes
    res["pmap_few"] = np.array(
        comm.parallel_map(lambda x: np.full((2, 2), x + 1j), few)
    )
    res["pmap_empty"] = np.array(comm.parallel_map(lambda x: x, []))
    # the .npy directory store as the chunked BTM route uses it: m-files
    # created round-robin, then written in place by their m-block's owner
    from driftscan_tpu_torch.util import store

    for i in comm.mpirange(NFILES):
        with store._NpyFile(os.path.join(out, f"m{i}"), "w") as f:
            f.create_dataset("beam_m", (4, 3), dtype=np.complex128)
            f.attrs["m"] = i
    comm.barrier()
    _, s0, e0 = comm.split_local(NFILES)
    for i in range(s0, e0):
        with store._NpyFile(os.path.join(out, f"m{i}"), "r+") as f:
            f["beam_m"][1:3] = 10 * i + rank + 1j
    comm.barrier()

    res["split_local"] = np.array(comm.split_local(7))
    res["mpirange"] = np.array(comm.mpirange(7))
    res["partition"] = np.array(comm.partition_list_mpi(list("abcdefg")))
    comm.barrier()
    np.savez(os.path.join(out, f"rank_{rank}.npz"), **res)
    comm.barrier()


@pytest.fixture(scope="module", params=[2, 3], ids=lambda n: f"{n}proc")
def results(request, tmp_path_factory):
    size = request.param
    out = tmp_path_factory.mktemp(f"comm{size}")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", str(r), str(size),
             str(out / "rdzv"), str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(size)
    ]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    return size, [dict(np.load(out / f"rank_{r}.npz", allow_pickle=True)) for r in range(size)]


def test_identity(results):
    size, res = results
    for r, got in enumerate(res):
        assert int(got["rank"]) == r and int(got["size"]) == size
        assert bool(got["rank0"]) == (r == 0)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_transpose_blocks(results, name, kind):
    """Each rank's block is the plain transpose's columns (JAX ``split_m``
    blocks), bit for bit, and no larger than that block."""
    from driftscan_tpu.parallel import comm as jcomm

    size, res = results
    shape = CASES[name][0]
    a = _global(name)[..., : shape[-1]]
    blocks = jcomm.split_m(shape[-1], size)
    for r, got in enumerate(res):
        block = got[("tb_" if kind == "numpy" else "tbt_") + name]
        n, s, e = blocks[:, r]
        assert block.shape == shape[:-1] + (n,)
        assert block.dtype == a.dtype
        assert np.array_equal(block, a[..., s:e])
        assert block.size < a.size or size == 1


def test_allreduce(results):
    size, res = results
    base = np.arange(6, dtype=np.float64).reshape(2, 3)
    tot = sum(r + 1 for r in range(size))
    for got in res:
        assert got["allreduce_c"].dtype == np.complex128
        np.testing.assert_allclose(got["allreduce_c"], tot * (base + 1j * base[::-1]))
        np.testing.assert_array_equal(got["allreduce_t"], np.full(3, float(tot)))
        assert got["allreduce_i"].dtype == np.int64
        np.testing.assert_array_equal(got["allreduce_i"], [size * (size - 1) // 2, size])


def test_bcast(results):
    _, res = results
    for got in res:
        assert list(got["bcast_a"]) == [3, 1, 4] and str(got["bcast_b"]) == "driftscan"
        np.testing.assert_array_equal(got["bcast_c"], np.arange(3))


def test_parallel_map(results):
    """The full ordered list everywhere; spare ranks (more ranks than items)
    take part idle; an empty list gives an empty list."""
    size, res = results
    want = np.array([[x * 2.0, x + 0.5] for x in range(5)])
    few = np.array([np.full((2, 2), x + 1j) for x in range(size - 1)])
    for got in res:
        np.testing.assert_array_equal(got["pmap"], want)
        np.testing.assert_array_equal(got["pmap_few"], few)
        assert got["pmap_empty"].size == 0


def test_partitions(results):
    """split_local, mpirange and partition_list_mpi: the JAX package's
    blocks and round-robin subsets, covering every item once."""
    from driftscan_tpu.parallel import comm as jcomm

    size, res = results
    blocks = jcomm.split_m(7, size)
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["split_local"], blocks[:, r])
        np.testing.assert_array_equal(got["mpirange"], list(range(7))[r::size])
        assert list(got["partition"]) == jcomm.partition_list(list("abcdefg"), r, size)
    assert sorted(sum((list(g["mpirange"]) for g in res), [])) == list(range(7))


def test_npy_store_creator_then_writer(results):
    """The ``.npy`` directory store under several writers: each file
    created by one process (round-robin) and written in place, after a
    barrier, by the owner of its block (``split_local``), as the chunked
    BTM route does on a host without h5py."""
    from driftscan_tpu.parallel import comm as jcomm
    from driftscan_tpu_torch.util import store

    size, res = results
    out = os.path.dirname(res[0]["out"].item())
    blocks = jcomm.split_m(NFILES, size)
    for i in range(NFILES):
        owner = next(r for r in range(size) if blocks[1, r] <= i < blocks[2, r])
        with store._NpyFile(os.path.join(out, f"m{i}"), "r") as f:
            got = f["beam_m"][:]
            assert int(f.attrs["m"]) == i
        want = np.zeros((4, 3), dtype=np.complex128)
        want[1:3] = 10 * i + owner + 1j
        np.testing.assert_array_equal(got, want)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
