"""Bitshuffle+LZ4 HDF5 compression (own plugin, LZF otherwise).

Port of ``driftscan_tpu/ops/bitshuffle.py``.  After mantissa truncation,
bit-transposing the floats lines up the zeroed mantissa bits into long
runs that LZ4 collapses.  The filter (standard id 32008) is a host codec,
not a device kernel: ``csrc/bshuf_lz4.cpp`` is compiled with the host C++
compiler at first use into the package's build directory and registered
with HDF5 as a dynamic plugin, for readers as well as writers.
:func:`compression_kwargs` gives LZF+shuffle where the plugin cannot be
built or does not round-trip; which codec is in use is logged once.
"""

from __future__ import annotations

import logging
import os
import tempfile

import numpy as np

from .. import backend

logger = logging.getLogger(__name__)

BSHUF_FILTER = 32008
_BLOCK_ELEMS = 4096

_available = None
_registered = None


def register() -> bool:
    """Build the plugin if need be and add its directory to HDF5's plugin
    search path (idempotent).  Any process that *reads*
    bitshuffle-compressed products needs it, not only writers."""
    global _registered
    if _registered is None:
        _registered = False
        if os.environ.get("DRIFTSCAN_TPU_BITSHUFFLE", "1") in ("0", "false"):
            return False
        path = backend.build_host("bshuf_lz4.cpp", ("-l:liblz4.so.1",))
        if path is not None:
            import h5py

            # HDF5 loads every library of a plugin directory: give it one
            # that holds the filter alone
            plugdir = os.path.join(backend.BUILD_DIR, "h5plugin")
            os.makedirs(plugdir, exist_ok=True)
            link = os.path.join(plugdir, "libdriftbshuf.so")
            if not (os.path.exists(link) and os.path.samefile(link, path)):
                tmp = f"{link}.{os.getpid()}.tmp"
                os.symlink(path, tmp)
                os.replace(tmp, link)
            h5py.h5pl.append(plugdir.encode())
            _registered = True
    return _registered


def available() -> bool:
    """True if the bitshuffle filter plugin loads and round-trips."""
    global _available
    if _available is None:
        _available = False
        try:
            if register():
                import h5py

                data = (np.arange(4096, dtype=np.float64) * np.pi).reshape(64, 64)
                with tempfile.TemporaryDirectory() as d:
                    fn = os.path.join(d, "probe.h5")
                    with h5py.File(fn, "w") as f:
                        f.create_dataset("x", data=data, **dataset_kwargs(data.dtype))
                    with h5py.File(fn, "r") as f:
                        _available = bool(np.array_equal(f["x"][:], data))
        except (OSError, ValueError, RuntimeError):
            _available = False
        logger.info(
            "product codec: %s", "bitshuffle+LZ4" if _available else "LZF+shuffle"
        )
    return _available


def dataset_kwargs(dtype, block: int = _BLOCK_ELEMS) -> dict:
    """``create_dataset`` kwargs for bitshuffle+LZ4 on ``dtype`` data:
    cd_values (major, minor, elem_size, block_size_elems, 2 = LZ4)."""
    elem = np.dtype(dtype).itemsize
    return {
        "compression": BSHUF_FILTER,
        "compression_opts": (0, 4, elem, block, 2),
    }


def compression_kwargs(dtype, codec: str = "bitshuffle") -> dict:
    """Dataset compression kwargs for the requested codec; ``bitshuffle``
    gives LZF+shuffle when the plugin is unavailable."""
    if codec == "bitshuffle" and available():
        return dataset_kwargs(dtype)
    if codec in ("bitshuffle", "lzf"):
        return {"compression": "lzf", "shuffle": True}
    if codec in (None, "none"):
        return {}
    raise ValueError(f"Unknown compression codec {codec!r}")
