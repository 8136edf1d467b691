"""The Chebyshev filter step of the top-band KL engine (K17).

Each application of the engine's filter t(H) = (2/b) H - I to a column
block, with H = Y Y^H never formed, is one library product W = Y^H V and
one launch of K17 (``csrc/cheb_step.cu``), which forms Y W in its own body
on the float64 tensor cores and fuses the recurrence around it:

    V_out = alpha (Y W) + beta V_k + gamma V_p,
    amax  = max(max |Re V_out|, max |Im V_out|)

per batch element.  :func:`plan` picks the launch's tile from the shape;
:func:`cheb_step_ref` is the plain PyTorch version; the wrapper takes it for
CPU tensors only, and on CUDA tensors launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from .. import backend

K17 = backend.register(
    "k17_cheb_step",
    "driftscan_tpu_torch/csrc/cheb_step.cu",
    "driftscan_tpu/ops/fpencil.py:976",
)

# (M, n, K, k) -> launches of K17 at that shape (read by chip_smoke.py)
SHAPES: collections.Counter = collections.Counter()

# csrc/cheb_step.cu's tiles (mt, nt, wr, wc, wks), in its order: a warp owns
# mt x nt mma tiles of 16 x 8 outputs, a block wr x wc warps of them and
# wks such groups splitting the depth, each DK of every staged slab
TILES = ((2, 5, 4, 2, 1), (2, 4, 2, 2, 2), (1, 6, 2, 1, 4), (1, 4, 2, 1, 4))
DK = 8
NSTAGE = 4
# What a launch may ask of an H100 (and any sm_90 card): shared memory a
# block, threads a block, blocks along the grid's y and z.
SMEM_MAX = 232448
THREADS_MAX = 1024
GRID_YZ_MAX = 65535
# The plan's model of a block's time on one SM: the float64 tensor cores'
# share (67 TFLOP/s over 132 SMs), an assumed L2 -> SM rate for the staged
# slabs (5.5 TB/s over 132), a fixed cost (pipeline fill, epilogue) and a
# cost a slab (its barrier).
_SM_FLOPS = 67e12 / 132
_SM_BYTES = 5.5e12 / 132
_BLOCK_FIXED_S = 2e-6
_SLAB_S = 5e-8


class ChebPlan(NamedTuple):
    """How :func:`cheb_step` launches: the tile of ``TILES`` and the grid
    (column tiles, row tiles, batch)."""

    mt: int
    nt: int
    wr: int
    wc: int
    wks: int
    grid: tuple[int, int, int]

    @property
    def bm(self) -> int:
        return self.wr * 16 * self.mt

    @property
    def bn(self) -> int:
        return self.wc * 8 * self.nt

    @property
    def depth(self) -> int:
        """Depth of one staged slab: DK for each of the wks groups."""
        return DK * self.wks

    @property
    def threads(self) -> int:
        return 32 * self.wr * self.wc * self.wks

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def smem(self) -> int:
        """Dynamic shared memory of a block in bytes (the ring, or the
        split's partial tiles where larger) and the warps' 8-byte maxima."""
        ring = NSTAGE * (self.bm + self.bn) * self.depth
        part = (self.wks - 1) * self.bm * self.bn
        return 16 * max(ring, part) + 8 * self.threads // 32

    def tiles(self, n: int, k: int):
        """The output tiles, one a block: (z, rows, columns) as ranges
        clipped to (n, k)."""
        for z in range(self.grid[2]):
            for by in range(self.grid[1]):
                for bx in range(self.grid[0]):
                    yield (z, range(by * self.bm, min((by + 1) * self.bm, n)),
                           range(bx * self.bn, min((bx + 1) * self.bn, k)))

    def k_parts(self, K: int) -> list[list[range]]:
        """The depth each group sums, in the order the kernel adds it: group
        g takes [q depth + g DK, + DK) of every slab q, in q order, and the
        groups' partial tiles are added in group order."""
        d = self.depth
        return [[range(q * d + g * DK, min(q * d + (g + 1) * DK, K))
                 for q in range(-(-K // d)) if q * d + g * DK < K]
                for g in range(self.wks)]


@functools.lru_cache(maxsize=256)
def plan(M: int, n: int, K: int, k: int, sms: int) -> ChebPlan:
    """The tile of a K17 launch at (M, n, K, k) on a card of ``sms`` SMs.

    Each tile of ``TILES`` runs one block an SM at a time (its registers);
    the one taken finishes first by the model waves x (the larger of the
    block's padded flops at an SM's share of the tensor cores and its
    staged bytes at an SM's share of L2, + a fixed cost + a cost a slab),
    the earlier tile on a tie.  At ns2's (1, 3200, 3200, 400) on 132 SMs
    that is 128 x 80 (125 blocks, one wave); at the bench cylinder's
    (8, 352, 352, 44) 32 x 48 with the depth split four ways (88 blocks).
    """
    if M > GRID_YZ_MAX:
        raise ValueError(f"K17: batch {M} over the grid's {GRID_YZ_MAX}")

    def make(tile):
        mt, nt, wr, wc = tile[:4]
        bm, bn = wr * 16 * mt, wc * 8 * nt
        return ChebPlan(*tile, (-(-k // bn), -(-n // bm), M))

    def cost(p):
        kp = -(-K // p.depth) * p.depth
        block = max(8.0 * p.bm * p.bn * kp / _SM_FLOPS, 16.0 * (p.bm + p.bn) * kp / _SM_BYTES)
        return -(-p.blocks // sms) * (block + _BLOCK_FIXED_S + kp // p.depth * _SLAB_S)

    plans = [make(t) for t in TILES]
    plans = [p for p in plans if p.grid[1] <= GRID_YZ_MAX]
    return min(plans, key=lambda p: (cost(p), TILES.index(p[:5])))


def cheb_step_ref(y, w, vk, vp, alpha, beta: float, gamma: float):
    """Plain PyTorch version of :func:`cheb_step`, in the JAX program's
    order of operations (alpha (Y W), then + beta V_k, then + gamma V_p)."""
    out = alpha[..., None, None] * (y @ w) + beta * vk
    if vp is not None:
        out = out + gamma * vp
    amax = torch.maximum(out.real.abs().amax(dim=(-2, -1)), out.imag.abs().amax(dim=(-2, -1)))
    return out, amax


def cheb_step(y, w, vk, vp, alpha, beta: float, gamma: float):
    """One filter application: (V_out (..., n, k), amax (...,)).

    y (..., n, K), w = Y^H V (..., K, k), vk and vp (..., n, k) complex;
    ``vp`` None drops its term (the first application); alpha (...,) real,
    a coefficient a batch element; beta and gamma floats.  CPU tensors take
    the plain version; CUDA tensors launch K17, which takes complex128.
    """
    alpha = alpha.to(backend.real_dtype(y.dtype))
    tensors = (y, w, vk, alpha) if vp is None else (y, w, vk, alpha, vp)
    if not backend.on_cuda(*tensors):
        return cheb_step_ref(y, w, vk, vp, alpha, beta, gamma)
    return cheb_step_launch(y, w, vk, vp, alpha, beta, gamma)


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def cheb_step_launch(y, w, vk, vp, alpha, beta: float, gamma: float, p: ChebPlan | None = None):
    """Launch K17 on CUDA tensors with the tile of ``p`` (by default
    :func:`plan`'s; any plan of ``TILES`` for this shape)."""
    lead = y.shape[:-2]
    n, K = y.shape[-2:]
    k = vk.shape[-1]
    M = 1
    for d in lead:
        M *= d
    backend.require(y, "y", dtype=torch.complex128)
    backend.require(w, "w", dtype=torch.complex128, shape=lead + (K, k))
    backend.require(vk, "vk", dtype=torch.complex128, shape=lead + (n, k))
    if vp is not None:
        backend.require(vp, "vp", dtype=torch.complex128, shape=lead + (n, k))
    alpha = alpha.contiguous()
    backend.require(alpha, "alpha", dtype=torch.float64, shape=lead)
    if p is None:
        p = plan(M, n, K, k, backend.sm_count(y.device))
    out = torch.empty(lead + (n, k), dtype=y.dtype, device=y.device)
    # zeroed by the entry point, on the stream, before the launch
    amax = torch.empty(lead, dtype=torch.float64, device=y.device)
    backend.launch(
        K17, K17.entry("cheb_step_c128", _ARGTYPES), y.device,
        y.data_ptr(), w.data_ptr(), vk.data_ptr(),
        None if vp is None else vp.data_ptr(), alpha.data_ptr(),
        beta, gamma, out.data_ptr(), amax.data_ptr(),
        M, n, K, k, *p[:5],
    )
    with backend.COUNT_LOCK:
        SHAPES[(M, n, K, k)] += 1
    return out, amax
