"""Process-level coordination verbs, single process.

Port of the verbs of ``driftscan_tpu/parallel/comm.py`` that the product
and timestream pipelines call, for one process: rank 0 of size 1, and every collective
is the identity.  The partition helpers keep their arithmetic so the
calling code reads as in the JAX package; a multi-process backend
(``torch.distributed``) is ROADMAP.md, modules to port, item 11.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Sequence, Tuple

import numpy as np


def rank() -> int:
    return 0


def size() -> int:
    return 1


def rank0() -> bool:
    return True


def barrier():
    """Synchronise all processes (nothing to do for one)."""


def bcast(obj, root: int = 0):
    return obj


def allreduce(x, op="sum"):
    """Sum an array contribution across all processes."""
    if op not in ("sum", "SUM"):
        raise ValueError(f"Unsupported allreduce op: {op}")
    return x


def split_m(n: int, m: int) -> np.ndarray:
    """Split ``range(n)`` into ``m`` near-equal consecutive blocks:
    (3, m) rows (num, start, end)."""
    num = (n // m) * np.ones(m, dtype=int)
    num[: n % m] += 1
    end = np.cumsum(num)
    return np.array([num, end - num, end])


def split_local(n: int) -> Tuple[int, int, int]:
    """This process's block of ``range(n)`` as (num, start, end)."""
    return tuple(int(v) for v in split_m(n, size())[:, rank()])


def mpirange(n, *args) -> Sequence[int]:
    """Round-robin subset of ``range(n)`` (or range(start, stop)) for us."""
    return list(range(n, *args))[rank() :: size()]


def partition_list_mpi(full_list: Sequence) -> List:
    """The sublist of items this process should handle."""
    return list(full_list)[rank() :: size()]


def parallel_map(func: Callable, lst: Sequence) -> List:
    """``func`` over ``lst``: the full, ordered result list (every item is
    this process's)."""
    return [func(x) for x in lst]


def transpose_blocks(row_array, shape: Tuple[int, ...]):
    """Redistribute an axis-0-split array to be split along the last axis.

    For one process the local block is the whole array: rows must match
    ``shape[0]``, and the last axis is trimmed to ``shape[-1]`` (the JAX
    package trims m-modes this way).  Takes arrays or tensors.
    """
    if row_array.shape[0] != shape[0]:
        raise ValueError(
            f"Local rows {row_array.shape[0]} != global rows {shape[0]} "
            "in single-process transpose_blocks"
        )
    return row_array[..., : shape[-1]]


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
