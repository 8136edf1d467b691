"""Process-level coordination verbs over ``torch.distributed``.

Port of ``driftscan_tpu/parallel/comm.py``, the verbs of driftscan's MPI
layer (``caput.mpiutil``) that the product and timestream pipelines call,
with the same semantics:

==================  =========================================================
verb                 implementation
==================  =========================================================
rank / size          the process group's, else rank 0 of 1
rank0                rank() == 0
barrier()            ``dist.barrier``
bcast(obj)           ``dist.broadcast_object_list``
allreduce(x)         ``dist.all_reduce`` (sum) of a host copy; complex as
                     ``view_as_real``
split_local/all/m    block partitions of ``range(n)``
mpirange             round-robin subset of ``range(n)``
partition_list       round-robin sublist
parallel_map         map over a list, the full ordered result everywhere
transpose_blocks     the per-peer exchange, one ``dist.all_to_all_single``
==================  =========================================================

The group is joined on first use from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or by an
explicit :func:`init`.  Without either the process is rank 0 of 1, has no
group, and every collective is the identity.

The backend is ``gloo`` on host memory: the verbs take numpy arrays and
tensors (on any device; a card's tensor goes through the host) and give
back the type and device they were given.  Collectives time out after
``TIMEOUT``, so a rank that dies does not hang its peers forever (and no
stage may keep one rank from the next collective for longer: process 0's
map synthesis is the longest such wait of the pipelines).  :func:`device`
binds a process to its card, ``LOCAL_RANK`` modulo the cards of the host.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)

# (rank, size) once known; set by init() or on first use
_world = None


def init(rank=None, size=None, init_method=None):
    """Join the ``gloo`` process group as ``rank`` of ``size``, meeting the
    others at ``init_method`` (``"env://"``, ``"tcp://host:port"`` or
    ``"file://path"``).  Unset arguments come from torchrun's environment;
    without it (or with a size of 1) the process stays rank 0 of 1.
    Returns (rank, size).  Once joined, a call that asks for no other rank
    or size returns the group it is in."""
    global _world
    if _world is not None:
        if (rank, size) != (None, None) and (rank, size) != _world:
            raise RuntimeError(f"comm already initialised as rank {_world[0]} of {_world[1]}")
        return _world
    if size is None:
        size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a group of {size}")
    if size > 1:
        dist.init_process_group(
            "gloo", init_method=init_method or "env://", rank=rank, world_size=size,
            timeout=TIMEOUT,
        )
    _world = (rank, size)
    return _world


def _get():
    return _world if _world is not None else init()


def rank() -> int:
    return _get()[0]


def size() -> int:
    return _get()[1]


def rank0() -> bool:
    return rank() == 0


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``; the rank when unset)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def device(name=None) -> torch.device:
    """The device this process runs on: ``name`` (a card when None); a card
    without an index becomes card ``local_rank() % device_count()``, which
    is made the current device (the kernels launch on the current one)."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and torch.cuda.is_available():
        if dev.index is None:
            dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def barrier():
    """Synchronise all processes."""
    if size() > 1:
        dist.barrier()


def bcast(obj, root: int = 0):
    """Broadcast a picklable object from ``root`` to all processes."""
    if size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def _host(x) -> torch.Tensor:
    """A host tensor over numpy array ``x`` (shared memory where numpy's
    strides allow it), or ``x`` itself brought to the host."""
    if torch.is_tensor(x):
        return x.cpu()
    x = np.asarray(x)
    if any(s < 0 for s in x.strides):
        x = np.ascontiguousarray(x)
    return torch.from_numpy(x)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """What gloo carries of a contiguous host tensor: complex as real pairs."""
    return torch.view_as_real(t) if t.is_complex() else t


def _like(t: torch.Tensor, x):
    """Host tensor ``t`` as the type (numpy, or a tensor on its device) of ``x``."""
    return t.to(x.device) if torch.is_tensor(x) else t.numpy()


def allreduce(x, op="sum"):
    """Sum an array contribution across all processes; the type, dtype and
    device of ``x`` come back."""
    if op not in ("sum", "SUM"):
        raise ValueError(f"Unsupported allreduce op: {op}")
    if size() == 1:
        return x
    t = _host(x).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(_wire(t))
    return _like(t, x)


def split_m(n: int, m: int) -> np.ndarray:
    """Split ``range(n)`` into ``m`` near-equal consecutive blocks:
    (3, m) rows (num, start, end)."""
    num = (n // m) * np.ones(m, dtype=int)
    num[: n % m] += 1
    end = np.cumsum(num)
    return np.array([num, end - num, end])


def split_all(n: int) -> np.ndarray:
    """Block partition of ``range(n)`` over all processes -> (3, size)."""
    return split_m(n, size())


def split_local(n: int) -> Tuple[int, int, int]:
    """This process's block of ``range(n)`` as (num, start, end)."""
    return tuple(int(v) for v in split_all(n)[:, rank()])


def mpirange(n, *args) -> Sequence[int]:
    """Round-robin subset of ``range(n)`` (or range(start, stop)) for us."""
    return list(range(n, *args))[rank() :: size()]


def partition_list(full_list: Sequence, i: int, n: int) -> List:
    """Round-robin sublist ``i`` of ``n`` partitions."""
    return list(full_list)[i::n]


def partition_list_mpi(full_list: Sequence) -> List:
    """The sublist of items this process should handle."""
    return partition_list(full_list, rank(), size())


_MAXD = 5  # parallel_map's largest result rank


def parallel_map(func: Callable, lst: Sequence) -> List:
    """``func`` over ``lst``, split round-robin across processes: the full,
    ordered result list on every process.

    Across processes the results are arrays of one shape and dtype (every
    pipeline caller returns per-m arrays): item 0's shape and dtype reach
    every process through a fixed-size metadata allreduce (so processes
    with no item, when there are more processes than items, take part
    idle), each fills its items of a zero array, and one allreduce
    assembles the whole.
    """
    local = [(i, func(x)) for i, x in enumerate(lst) if i % size() == rank()]
    if size() == 1:
        return [v for _, v in local]
    if not lst:
        return []

    meta = np.zeros(3 + _MAXD, dtype=np.int64)
    if rank() == 0:
        p0 = np.asarray(local[0][1])
        if p0.ndim > _MAXD:
            raise ValueError(f"parallel_map results limited to {_MAXD} dims, got {p0.ndim}")
        meta[:3] = p0.ndim, ord(p0.dtype.kind), p0.dtype.itemsize
        meta[3 : 3 + p0.ndim] = p0.shape
    meta = allreduce(meta)
    ndim = int(meta[0])
    shape = tuple(int(v) for v in meta[3 : 3 + ndim])
    dtype = np.dtype(f"{chr(int(meta[1]))}{int(meta[2])}")
    full = np.zeros((len(lst),) + shape, dtype=dtype)
    for i, v in local:
        full[i] = v
    return list(allreduce(full))


def transpose_blocks(row_array, shape: Tuple[int, ...]):
    """Redistribute an axis-0-split array to be split along the last axis.

    ``row_array`` is this process's block of rows (``split_local(shape[0])``)
    of the global array of ``shape``; its last axis may be longer than
    ``shape[-1]`` (the extra entries are trimmed, as the pipeline trims
    m-modes).  Returns this process's block of columns
    (``split_local(shape[-1])``) over all rows, of the type and device of
    ``row_array`` (numpy array or tensor).

    Each process sends each peer only that peer's columns of its own rows,
    in one ``all_to_all_single``, and never holds the global array.  The
    pieces travel column axis first, and the block that comes back lies in
    memory column axis first (the returned array is a view with the column
    axis last): a caller that keeps its rows column-major (as a view of a
    column-major array) packs by plain copies and gets its columns
    contiguous by moving that axis back to the front.
    """
    if size() == 1:
        if row_array.shape[0] != shape[0]:
            raise ValueError(
                f"Local rows {row_array.shape[0]} != global rows {shape[0]} "
                "in single-process transpose_blocks"
            )
        return row_array[..., : shape[-1]]

    rows, cols = split_all(shape[0]), split_all(shape[-1])
    me, nproc = rank(), size()
    nrow = int(rows[0, me])
    if row_array.shape[0] != nrow:
        raise ValueError(
            f"rank {me}: local rows {row_array.shape[0]} != its block {nrow} of {shape[0]}"
        )
    src = row_array[..., : shape[-1]]
    mid = tuple(src.shape[1:-1])
    per_row = int(np.prod(mid, dtype=np.int64))
    src_t = src if torch.is_tensor(src) else _host(src)

    # pack: peer r's columns of our rows, column axis first, one after another
    send_sizes = [int(cols[0, r]) * nrow * per_row for r in range(nproc)]
    send = torch.empty(sum(send_sizes), dtype=src_t.dtype)
    off = 0
    for r in range(nproc):
        n_r, s_r, e_r = (int(v) for v in cols[:, r])
        send[off : off + send_sizes[r]].view((n_r, nrow) + mid).copy_(
            src_t[..., s_r:e_r].movedim(-1, 0)
        )
        off += send_sizes[r]

    ncol = int(cols[0, me])
    recv_sizes = [ncol * int(rows[0, s]) * per_row for s in range(nproc)]
    recv = torch.empty(sum(recv_sizes), dtype=src_t.dtype)
    dist.all_to_all_single(_wire(recv), _wire(send), recv_sizes, send_sizes)
    del send

    # unpack: source s's rows of our columns into their place
    out = torch.empty((ncol, shape[0]) + mid, dtype=src_t.dtype)
    off = 0
    for s in range(nproc):
        n_s, s_s, e_s = (int(v) for v in rows[:, s])
        out[:, s_s:e_s] = recv[off : off + recv_sizes[s]].view((ncol, n_s) + mid)
        off += recv_sizes[s]
    res = _like(out, row_array)
    return res.movedim(0, -1) if torch.is_tensor(res) else np.moveaxis(res, 0, -1)


class MPILogFilter(logging.Filter):
    """Add process rank/size fields to log records and gate by level."""

    def __init__(self, add_mpi_info=True, level_rank0=logging.INFO,
                 level_all=logging.WARNING):
        super().__init__()
        self.add_mpi_info = add_mpi_info
        self.level_rank0 = level_rank0
        self.level_all = level_all

    def filter(self, record):
        if self.add_mpi_info:
            record.mpi_rank = rank()
            record.mpi_size = size()
        level = self.level_rank0 if rank() == 0 else self.level_all
        return record.levelno >= level
