"""The two runtime probes of ``scratch/pallas_probe.py`` as Hopper kernels.

The JAX repository's only ``pl.pallas_call``s are two probes of the TPU
runtime, outside the package and on none of its paths: ``double``
(o = 2 x of a (1024, 1024) float32 array) and ``mm`` (a tiled 1024^3
matmul of float32 or bfloat16 inputs with a float32 result).  They are
ported as the CUDA kernels of ``csrc/probe.cu``: ``double`` a 16-byte
bandwidth pass, ``mm`` a TMA ring feeding ``wgmma`` (bfloat16 on the
tensor cores, float32 as 3xTF32).  ``chip_smoke.py`` runs them in its
``[probe]`` phase.  CPU tensors take the plain versions
(:func:`double_ref`, :func:`mm_ref`); CUDA tensors launch the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import backend

PROBE_DOUBLE = backend.register(
    "probe_double", "driftscan_tpu_torch/csrc/probe.cu",
    "scratch/pallas_probe.py:56",
)
PROBE_MM = backend.register(
    "probe_mm", "driftscan_tpu_torch/csrc/probe.cu",
    "scratch/pallas_probe.py:83",
)

# csrc/probe.cu's mm: a block owns MM_ROWS rows of the tile's row operand
# (C's rows for bfloat16; C's columns for float32, which computes C^T) and
# one of these widths of the other
MM_ROWS = 128
MM_WIDTHS = {torch.bfloat16: (64, 128, 256), torch.float32: (64, 128)}
# Per-SM tensor-core rate of the H100 (989 TFLOP/s bfloat16, 495 tf32 over
# its 132 SMs; float32 takes three tf32 products) and a tile's fixed cost
# (pipeline fill and epilogue): the plan's model of a block's time.
_SM_FLOPS = {torch.bfloat16: 989e12 / 132, torch.float32: 495e12 / 3 / 132}
_TILE_FIXED_S = 1.5e-6


class MMPlan(NamedTuple):
    """How :func:`mm` launches: ``route`` "tma" or "staged", the tile
    width ``nw`` and the grid (column tiles, row tiles)."""

    route: str
    nw: int
    grid: tuple[int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


@functools.lru_cache(maxsize=256)
def mm_plan(M: int, N: int, K: int, dtype: torch.dtype, strides: tuple[int, int],
            ptr_align: int, sms: int) -> MMPlan:
    """Route and tile of C = A B for (M, K) and (K, N) inputs of ``dtype``
    whose rows lie ``strides`` = (A's, B's) elements apart, at pointers
    aligned to ``ptr_align`` bytes, on a card of ``sms`` SMs.

    TMA needs 16-byte aligned pointers and row strides; otherwise the
    kernel stages its tiles with plain loads.  The tile width is the one
    whose blocks finish first, one block an SM at a time: waves x (the
    tile's flops at an SM's share of the tensor-core rate + a fixed cost).
    At 1024^3 on 132 SMs that is 64 wide (128 blocks in one wave); 128-wide
    tiles would leave 68 SMs idle.
    """
    esize = 4 if dtype == torch.float32 else 2
    aligned = ptr_align % 16 == 0 and all(s * esize % 16 == 0 for s in strides)
    # float32 computes C^T: its tile rows run along N, its width along M
    rows, cols = (N, M) if dtype == torch.float32 else (M, N)
    row_tiles = -(-rows // MM_ROWS)

    def cost(nw):
        waves = -(-row_tiles * -(-cols // nw) // sms)
        return waves * (2.0 * MM_ROWS * nw * K / _SM_FLOPS[dtype] + _TILE_FIXED_S)

    nw = min(MM_WIDTHS[dtype], key=lambda w: (cost(w), w))
    return MMPlan("tma" if aligned else "staged", nw, (-(-cols // nw), row_tiles))


def _align(*ptrs: int) -> int:
    """Bytes every pointer is aligned to, at most 16."""
    low = 16
    for p in ptrs:
        low = min(low, (p & -p) if p else 16)
    return low


def double_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`double`."""
    return x * 2.0


def double(x: torch.Tensor) -> torch.Tensor:
    """o = 2 x of a float32 tensor.

    On the card the output shares the input's address modulo 16 bytes (a
    view into a slightly larger buffer where the input is not 16-byte
    aligned), so the kernel's 16-byte loads and stores line up.
    """
    if not backend.on_cuda(x):
        return double_ref(x)
    backend.require(x, "x", dtype=torch.float32)
    return double_launch(x)


def double_launch(x: torch.Tensor, max_blocks: int = 0) -> torch.Tensor:
    """Launch the kernel of :func:`double` on a contiguous float32 CUDA
    tensor: a grid that covers the array, or at most ``max_blocks``
    blocks striding over it."""
    n = x.numel()
    shift = x.data_ptr() % 16 // 4
    if shift:
        buf = torch.empty(n + 3, dtype=x.dtype, device=x.device)
        off = (shift - buf.data_ptr() % 16 // 4) % 4
        out = buf[off:off + n].view(x.shape)
    else:
        out = torch.empty_like(x)
    fn = PROBE_DOUBLE.entry(
        "probe_double_f32",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p],
    )
    backend.launch(PROBE_DOUBLE, fn, x.device, x.data_ptr(), out.data_ptr(), n, max_blocks)
    return out


def mm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`mm`: a float32 matmul with TF32 off."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A B of float32 or bfloat16 (M, K) and (K, N); float32 (M, N)."""
    if not backend.on_cuda(a, b):
        return mm_ref(a, b)
    backend.require(a, "a", dtype=(torch.float32, torch.bfloat16), ndim=2)
    M, K = a.shape
    N = b.shape[-1]
    backend.require(b, "b", dtype=a.dtype, shape=(K, N))
    if min(M, N, K) < 1:
        raise ValueError(f"empty matmul {M}x{K} @ {K}x{N}")
    plan = mm_plan(M, N, K, a.dtype, (K, N), _align(a.data_ptr(), b.data_ptr()),
                   backend.sm_count(a.device))
    return mm_launch(a, b, plan)


def mm_launch(a: torch.Tensor, b: torch.Tensor, plan: MMPlan) -> torch.Tensor:
    """Launch the kernel of :func:`mm` on CUDA tensors by ``plan`` (its
    route and width; the kernel derives the grid from the width)."""
    M, K = a.shape
    N = b.shape[-1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    fn = PROBE_MM.entry(
        "probe_mm_f32" if a.dtype == torch.float32 else "probe_mm_bf16",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    backend.launch(
        PROBE_MM, fn, a.device,
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, int(plan.route == "tma"), plan.nw,
    )
    return out
