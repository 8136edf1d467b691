"""The Chebyshev filter step of the top-band KL engine (K17).

Each application of the engine's filter t(H) = (2/b) H - I to a column
block, with H = Y Y^H never formed, is one library product W = Y^H V and
one launch of K17 (``csrc/cheb_step.cu``), which forms Y W in its own body
and fuses the recurrence around it:

    V_out = alpha (Y W) + beta V_k + gamma V_p,
    amax  = max(max |Re V_out|, max |Im V_out|)

per batch element.  :func:`cheb_step_ref` is the plain PyTorch version; the
wrapper takes it for CPU tensors only, and on CUDA tensors launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import backend

K17 = backend.register(
    "k17_cheb_step",
    "driftscan_tpu_torch/csrc/cheb_step.cu",
    "driftscan_tpu/ops/fpencil.py:976",
)


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
    tensors = (y, w, vk, alpha) + (() if vp is None else (vp,))
    if not backend.on_cuda(*tensors):
        return cheb_step_ref(y, w, vk, vp, alpha, beta, gamma)
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
    backend.require(alpha, "alpha", shape=lead)
    out = torch.empty(lead + (n, k), dtype=y.dtype, device=y.device)
    amax = torch.zeros(lead, dtype=torch.int64, device=y.device)
    fn = K17.entry(
        "cheb_step_c128",
        [ctypes.c_void_p] * 5 + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    backend.check(
        fn(
            y.data_ptr(), w.data_ptr(), vk.data_ptr(),
            None if vp is None else vp.data_ptr(), alpha.data_ptr(),
            float(beta), float(gamma), out.data_ptr(), amax.data_ptr(),
            M, n, K, k, backend.stream_ptr(y.device),
        ),
        K17.name,
    )
    K17.launches += 1
    return out, amax.view(torch.float64)
