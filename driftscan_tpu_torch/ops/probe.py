"""The two runtime probes of ``scratch/pallas_probe.py`` as Hopper kernels.

The JAX repository's only ``pl.pallas_call``s are two probes of the TPU
runtime, outside the package and on none of its paths: ``double``
(o = 2 x of a (1024, 1024) float32 array) and ``mm`` (a tiled 1024^3
matmul of float32 or bfloat16 inputs with a float32 result).  They are
ported as the CUDA kernels of ``csrc/probe.cu``; ``chip_smoke.py`` runs
them in its ``[probe]`` phase.  CPU tensors take the plain versions
(:func:`double_ref`, :func:`mm_ref`); CUDA tensors launch the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from .. import backend

PROBE_DOUBLE = backend.register(
    "probe_double", "cuda", "driftscan_tpu_torch/csrc/probe.cu",
    "scratch/pallas_probe.py:56",
)
PROBE_MM = backend.register(
    "probe_mm", "cuda", "driftscan_tpu_torch/csrc/probe.cu",
    "scratch/pallas_probe.py:83",
)


def double_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`double`."""
    return x * 2.0


def double(x: torch.Tensor) -> torch.Tensor:
    """o = 2 x of a float32 tensor."""
    if not backend.on_cuda(x):
        return double_ref(x)
    backend.require(x, "x", dtype=torch.float32)
    out = torch.empty_like(x)
    fn = PROBE_DOUBLE.lib().probe_double_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    backend.check(
        fn(x.data_ptr(), out.data_ptr(), x.numel(), backend.stream_ptr(x.device)),
        PROBE_DOUBLE.name,
    )
    PROBE_DOUBLE.launches += 1
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
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    lib = PROBE_MM.lib()
    fn = lib.probe_mm_f32 if a.dtype == torch.float32 else lib.probe_mm_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    backend.check(
        fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
           backend.stream_ptr(a.device)),
        PROBE_MM.name,
    )
    PROBE_MM.launches += 1
    return out
