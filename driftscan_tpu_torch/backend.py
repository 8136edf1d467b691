"""Device and dtype helpers, and the registry of the hand-written kernels.

Every hand-written kernel of the port is described by a :class:`Kernel`
record: its name, its route (CUDA C++ built with ``nvcc``), its source
file, the JAX program it replaces, and a plain-integer count of its
launches.  The count rises only where a wrapper launches the kernel on a
CUDA tensor, so a run can show that its main path went through the
kernel.

The kernels expose a plain C interface and are compiled at first use
into ``driftscan_tpu_torch/_build/``, keyed on a hash of the source, the
shared headers and the compiler flags, then loaded with :mod:`ctypes`.

Every wrapper takes the kernel's plain PyTorch version only for tensors
that lie on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import ClassVar

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def complex_dtype(real_dtype: torch.dtype) -> torch.dtype:
    """The complex dtype whose parts are ``real_dtype``."""
    if real_dtype == torch.float32:
        return torch.complex64
    if real_dtype == torch.float64:
        return torch.complex128
    raise TypeError(f"no complex counterpart for {real_dtype}")


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real part dtype of a real or complex dtype."""
    if dtype in (torch.complex64, torch.float32):
        return torch.float32
    if dtype in (torch.complex128, torch.float64):
        return torch.float64
    raise TypeError(f"unsupported dtype {dtype}")


def on_cuda(*tensors) -> bool:
    """True if every tensor lies on a CUDA device, False if every one
    lies on the CPU; raises on a mix or any other device."""
    if all(t.is_cuda for t in tensors):
        return True
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")


def require(t: torch.Tensor, name: str, dtype=None, shape=None, ndim=None):
    """Validate a kernel argument before its pointer is passed on."""
    if dtype is not None and t.dtype not in (
        dtype if isinstance(dtype, tuple) else (dtype,)
    ):
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.is_conj() or t.is_neg():
        raise ValueError(f"{name}: lazy conjugate/negative view; resolve it first")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@dataclass
class Kernel:
    """One hand-written kernel: identity, provenance and launch count."""

    route: ClassVar[str] = "cuda"  # every kernel is CUDA C++ built with nvcc
    name: str
    source: str  # path relative to the repository root
    replaces: str  # file:line of the JAX program it replaces
    launches: int = 0
    _lib: object = field(default=None, repr=False)
    _fns: dict = field(default_factory=dict, repr=False)

    def lib(self) -> ctypes.CDLL:
        """The built shared library of the kernel (built at first use)."""
        if self._lib is None:
            self._lib = ctypes.CDLL(build(self.source))
        return self._lib

    def entry(self, symbol: str, argtypes) -> ctypes._CFuncPtr:
        """The C entry point ``symbol`` of the library, returning an int
        CUDA error code, with its argument types set once."""
        fn = self._fns.get(symbol)
        if fn is None:
            fn = getattr(self.lib(), symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
            self._fns[symbol] = fn
        return fn


KERNELS: dict[str, Kernel] = {}


def register(name, source, replaces) -> Kernel:
    k = Kernel(name, source, replaces)
    KERNELS[name] = k
    return k


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


# The complex64 Gram engine of csrc/gram_tile.cuh (K9, K13): its output
# tile edge and factor columns per chunk, as the header defines them, and
# the blocks an SM holds at once (512 threads and ~130 KB or more of shared
# memory a block: one).  The split plan is made here; the launch refuses a
# partial-tile scratch smaller than its own tiles need and a plan that does
# not cover its chunks.
GRAM_TILE = 64
GRAM_KC = 32
GRAM_BLOCKS_PER_SM = 1


@functools.lru_cache(maxsize=256)
def gram_split(n: int, ncols: int, nbatch: int, sms: int) -> tuple[int, int]:
    """(nsplit, chunks per split) of one complex64 Gram launch.

    The engine launches one block per upper-triangle tile and batch item,
    and each block walks its share of the factor's column chunks.  Splitting
    the chunks across nsplit blocks (a second kernel then sums the partial
    tiles in a fixed order) trades rounds of blocks for chunks per block:
    the split taken minimises rounds x (chunks per block + 2), the launch's
    critical path with a block's staging and epilogue counted as two
    chunks, with at least 4 chunks per block and the smallest split on a
    tie.
    """
    nt = -(-n // GRAM_TILE)
    blocks = max(nbatch * nt * (nt + 1) // 2, 1)
    nchunks = max(-(-ncols // GRAM_KC), 1)
    slots = sms * GRAM_BLOCKS_PER_SM

    def cost(s):
        cps = -(-nchunks // s)
        return -(-blocks * s // slots) * (cps + 2)

    nsplit = min(range(1, max(nchunks // 4, 1) + 1), key=lambda s: (cost(s), s))
    cps = -(-nchunks // nsplit)
    return -(-nchunks // cps), cps


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` names."""
    return _sm_count(torch.device(device).index)


def gram_launch(n: int, ncols: int, nbatch: int, like: torch.Tensor):
    """(part, (part pointer, part bytes, nsplit, cps)) for a Gram kernel's
    C entry point: the split of :func:`gram_split` on ``like``'s card and
    its partial-tile scratch (None when unsplit; the caller keeps it alive
    across the launch).  complex128 runs unsplit."""
    if like.dtype != torch.complex64:
        return None, (None, 0, 1, 0)
    nsplit, cps = gram_split(n, ncols, nbatch, _sm_count(like.device.index))
    if nsplit == 1:
        return None, (None, 0, 1, cps)
    nt = -(-n // GRAM_TILE)
    part = torch.empty(
        (nsplit, nbatch, nt * (nt + 1) // 2, GRAM_TILE, GRAM_TILE, 2),
        dtype=torch.float32, device=like.device,
    )
    return part, (part.data_ptr(), part.numel() * part.element_size(), nsplit, cps)


def check(status: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(source: str) -> str:
    """Compile one ``csrc/*.cu`` file into a shared library; return its path.

    The output name carries a hash of the source, the shared ``csrc/*.cuh``
    headers and the flags, so an edited source rebuilds and an unchanged
    one is reused.
    """
    repo_root = os.path.dirname(_PKG_DIR)
    src = os.path.join(repo_root, source)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(_CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {source} ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    with open(out + ".log", "w") as f:
        f.write(res.stderr)
    os.replace(tmp, out)
    return out


def build_host(source: str, extra_flags=()) -> str | None:
    """Compile one host ``csrc/*.cpp`` codec into a shared library with the
    host C++ compiler; return its path, or None when no compiler is found
    or the compile fails (the callers then use their numpy / LZF codecs).
    Same content-hashed naming as :func:`build`."""
    src = os.path.join(_CSRC_DIR, source)
    flags = ["-O3", "-fPIC", "-shared", "-std=c++17", *extra_flags]
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *flags[:4], "-o", tmp, src, *flags[4:]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        return None
    os.replace(tmp, out)
    return out


def build_all() -> dict:
    """Build every registered CUDA kernel, one ``nvcc`` per source, all
    started together; returns {source: ptxas report}."""
    # importing the kernel modules registers every kernel
    from .ops import fpencil, kernels, probe, projections, sht  # noqa: F401
    from .parallel import mstep  # noqa: F401

    sources = sorted({k.source for k in KERNELS.values()})
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        paths = dict(zip(sources, pool.map(build, sources)))
    for k in KERNELS.values():
        k.lib()
    reports = {}
    for src, path in paths.items():
        with open(path + ".log") as f:
            reports[src] = f.read()
    return reports
