"""Precision truncation of transfer matrices for compressibility.

Port of ``driftscan_tpu/ops/truncate.py``: zero out mantissa bits below a
tolerance so the chunked-compressed HDF5 datasets shrink.  A host codec,
not a device kernel: ``csrc/truncate.cpp`` is compiled with the host C++
compiler at first use; without a compiler the numpy version rounds onto
the same power-of-two grid.  Which one ran is logged once.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from .. import backend

logger = logging.getLogger(__name__)

_lib = None


def _load_native():
    global _lib
    if _lib is None:
        path = backend.build_host("truncate.cpp", ("-fopenmp",))
        _lib = False
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
                lib.bit_truncate_max_complex.argtypes = [
                    ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                    ctypes.c_double, ctypes.c_double,
                ]
                lib.bit_truncate_max_complex.restype = None
                _lib = lib
            except OSError:
                pass
        logger.info("bit truncation codec: %s", "native" if _lib else "numpy")
    return _lib


def codec() -> str:
    """The truncation codec of this process: ``native`` or ``numpy``."""
    return "native" if _load_native() else "numpy"


def _round_to_grid(x: np.ndarray, tol: np.ndarray) -> np.ndarray:
    """Round x onto the power-of-two grid just below tol (elementwise)."""
    tol = np.maximum(tol, 1e-300)
    g = np.exp2(np.floor(np.log2(tol)))
    return np.round(x / g) * g


def bit_truncate_max_complex(arr: np.ndarray, rel: float, maxl: float) -> np.ndarray:
    """Truncate a complex array in place.

    arr : (n, k) complex128, modified in place.  Elements are rounded to
    the larger of ``rel * |x|`` (per element) and ``maxl * max_k |x|``
    (per row).
    """
    if arr.size == 0:
        return arr
    if arr.ndim != 2 or arr.dtype != np.complex128:
        raise ValueError("bit truncation takes an (n, k) complex128 array")

    lib = _load_native()
    if lib:
        carr = np.ascontiguousarray(arr)
        lib.bit_truncate_max_complex(
            carr.ctypes.data, carr.shape[0], carr.shape[1], rel, maxl
        )
        if carr is not arr:
            arr[:] = carr
        return arr

    mag = np.abs(arr)
    rowmax = mag.max(axis=-1, keepdims=True)
    tol = np.maximum(rel * mag, maxl * rowmax)
    arr.real = _round_to_grid(arr.real, tol)
    arr.imag = _round_to_grid(arr.imag, tol)
    return arr
