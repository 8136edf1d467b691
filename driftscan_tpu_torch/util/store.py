"""Product files: one group-and-dataset tree, two ways to keep it.

The product pipeline writes HDF5 (``beam.hdf5``, ``svd.hdf5``,
``ev_m_<m>.hdf5``, ``fisher.hdf5``) through :mod:`h5py` wherever it
imports, in the layout the JAX package and driftscan itself use, so
product directories are interchangeable.  On a host without h5py the
same tree is kept as a directory of that name holding one ``.npy`` file
per dataset, the attributes in ``__attrs__.npz`` and each dataset's HDF5
layout (chunk shape, codec) in ``__layout__.json``: the pipeline runs
unchanged, and :func:`convert` (``drift-makeproducts-torch convert DIR``)
later rewrites the directories of a finished product tree as the HDF5
files the h5py writer would have made, on any host with h5py.

:func:`File` opens either; ``BACKEND`` says which one this process uses.
A file opened for writing appears under its name only when it is closed
without error.  A file opened for update (``"r+"``) is written in place:
the directory store maps each ``.npy`` file, so a slice assignment writes
only its own bytes.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

try:
    import h5py

    BACKEND = "h5py"
except ImportError:
    h5py = None
    BACKEND = "npy"

_ATTRS = "__attrs__.npz"
_LAYOUT = "__layout__.json"
# the pipeline's completion markers: a directory of this name is finished
# only once it holds its marker
_MARKERS = {"beam_m": "COMPLETED", "mmodes": "COMPLETED_M"}


class _NpyDataset:
    """An array of a directory store, written back when the file closes
    (in place, through its memory map, under ``"r+"``)."""

    def __init__(self, array, written=True):
        self._a = array
        # a dataset created empty and never assigned is saved as a sparse
        # file of zeros
        self._written = written

    @property
    def shape(self):
        return self._a.shape

    @property
    def dtype(self):
        return self._a.dtype

    def __getitem__(self, ind):
        return np.array(self._a[ind])

    def __setitem__(self, ind, value):
        self._a[ind] = value
        self._written = True


class _NpyFile:
    """Directory-of-``.npy`` stand-in for the parts of ``h5py.File`` the
    pipeline uses: ``create_dataset``, ``f[name]``, ``name in f``,
    ``attrs`` and the context manager."""

    def __init__(self, path, mode="r"):
        if mode not in ("r", "r+", "w"):
            raise ValueError(f"directory store: mode {mode!r} not supported")
        self.path = path
        self.mode = mode
        self.attrs = {}
        self._new = {}
        self._layout = {}
        self._mapped = []
        if mode != "w":
            if not os.path.isdir(path):
                raise OSError(f"no product store at {path}")
            with np.load(os.path.join(path, _ATTRS)) as z:
                self.attrs = {k: (v[()] if v.ndim == 0 else v) for k, v in z.items()}

    def create_dataset(self, name, shape=None, dtype=None, data=None, chunks=None, codec=None,
                       **_layout):
        if self.mode != "w":
            raise ValueError(f"directory store: create_dataset needs mode 'w', not {self.mode!r}")
        # what the h5py writer would have been given, for the converter
        self._layout[name] = {"chunks": None if chunks is None else list(chunks),
                              "codec": codec}
        if data is not None:
            ds = _NpyDataset(np.array(data, dtype=dtype))
        else:
            ds = _NpyDataset(np.zeros(shape, dtype=dtype), written=False)
        self._new[name] = ds
        return ds

    def __contains__(self, name):
        if self.mode == "w":
            return name in self._new
        return os.path.exists(os.path.join(self.path, name + ".npy"))

    def __getitem__(self, name):
        if self.mode == "w":
            return self._new[name]
        fn = os.path.join(self.path, name + ".npy")
        if not os.path.exists(fn):
            raise KeyError(name)
        ds = _NpyDataset(np.load(fn, mmap_mode=self.mode))
        if self.mode == "r+":
            self._mapped.append(ds)
        return ds

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        for ds in self._mapped:
            ds._a.flush()
        self._mapped = []
        if self.mode == "w" and exc_type is None:
            tmp = f"{self.path}.{os.getpid()}.part"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for name, ds in self._new.items():
                fn = os.path.join(tmp, name + ".npy")
                if ds._written or ds._a.size == 0:
                    np.save(fn, ds._a)
                else:
                    np.lib.format.open_memmap(fn, "w+", ds.dtype, ds.shape).flush()
            np.savez(os.path.join(tmp, _ATTRS),
                     **{k: np.asarray(v) for k, v in self.attrs.items()})
            with open(os.path.join(tmp, _LAYOUT), "w") as f:
                json.dump(self._layout, f)
            remove(self.path)
            os.replace(tmp, self.path)
        return False


def File(path, mode="r", **kwargs):
    """Open a product file for reading (``"r"``), update in place
    (``"r+"``) or writing (``"w"``)."""
    if h5py is not None:
        return h5py.File(path, mode, **kwargs)
    return _NpyFile(path, mode)


def remove(path):
    """Delete a product file of either form, if it is there."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def replace(tmp, path):
    """Move a finished product file over ``path`` (either form)."""
    if os.path.isdir(tmp):
        remove(path)
    os.replace(tmp, path)


def readable(path) -> bool:
    """True if ``path`` holds a complete product file that opens."""
    if not os.path.exists(path):
        return False
    try:
        with File(path, "r"):
            return True
    except (OSError, KeyError, ValueError):
        return False


def compression_kwargs(dtype, codec):
    """``create_dataset`` compression arguments for ``codec``.  The
    directory store keeps plain arrays and records the codec's name, which
    :func:`to_hdf5` turns into these arguments under h5py."""
    if h5py is None:
        return {"codec": codec}
    from ..ops import bitshuffle

    return bitshuffle.compression_kwargs(dtype, codec)


def codec(name) -> str:
    """What a dataset written with codec ``name`` is compressed with here:
    ``bitshuffle+LZ4``, ``LZF+shuffle`` or ``none``."""
    if h5py is None:
        return "none"
    kwargs = compression_kwargs(np.complex128, name)
    if not kwargs:
        return "none"
    return "LZF+shuffle" if kwargs["compression"] == "lzf" else "bitshuffle+LZ4"


def register_codecs():
    """Make the bitshuffle filter known to HDF5 for readers (HDF5 only)."""
    if h5py is not None:
        from ..ops import bitshuffle

        bitshuffle.register()


def is_directory_store(path) -> bool:
    """True if ``path`` is a product file kept as a directory store."""
    return os.path.isfile(os.path.join(path, _ATTRS))


def to_hdf5(path):
    """Rewrite the directory store at ``path`` as the HDF5 file of the same
    name: the same datasets (dtype, shape, values) and attributes, each
    dataset with the chunk shape it was created with and the codec that
    :func:`compression_kwargs` gives the h5py writer (a store made before
    layouts were recorded gets plain datasets).  Needs h5py."""
    if h5py is None:
        raise RuntimeError("converting a directory store to HDF5 needs h5py")
    register_codecs()
    lay_file = os.path.join(path, _LAYOUT)
    layout = {}
    if os.path.exists(lay_file):
        with open(lay_file) as f:
            layout = json.load(f)
    src = _NpyFile(path, "r")
    names = sorted(fn[: -len(".npy")] for fn in os.listdir(path) if fn.endswith(".npy"))
    tmp = f"{path}.{os.getpid()}.part"
    remove(tmp)
    try:
        with h5py.File(tmp, "w") as f:
            for name in names:
                data = np.load(os.path.join(path, name + ".npy"), mmap_mode="r")
                lay = layout.get(name, {})
                kw = {}
                if lay.get("chunks") is not None:
                    kw["chunks"] = tuple(lay["chunks"])
                if lay.get("codec") is not None:
                    kw.update(compression_kwargs(data.dtype, lay["codec"]))
                f.create_dataset(name, data=data, **kw)
            for key, val in src.attrs.items():
                if isinstance(val, np.ndarray) and val.dtype.kind == "U":
                    val = val.astype(h5py.string_dtype())
                elif isinstance(val, str):
                    val = str(val)  # a text attribute, as h5py keeps a str
                f.attrs[key] = val
    except BaseException:
        remove(tmp)
        raise
    remove(path)
    os.replace(tmp, path)


def unfinished(root) -> list:
    """Paths under ``root`` that show a product tree still being written: a
    file or store being written (``*.part``, ``*.tmp``), or a directory
    the pipeline marks on completion (``beam_m``, ``mmodes``) without its
    marker."""
    found = []
    for d, dirs, files in os.walk(root):
        for name in dirs + files:
            if name.endswith((".part", ".tmp")):
                found.append(os.path.join(d, name))
        marker = _MARKERS.get(os.path.basename(d))
        if marker and marker not in files:
            found.append(os.path.join(d, marker) + " (missing)")
        # a store is a leaf: nothing of the tree lies inside it
        dirs[:] = [x for x in dirs if not is_directory_store(os.path.join(d, x))]
    return found


def convert(root) -> list:
    """Convert every directory store under the product directory ``root``
    to HDF5 (:func:`to_hdf5`), after checking that the tree is finished
    (:func:`unfinished`; a ``ValueError`` names what is not).  Returns the
    converted paths."""
    if h5py is None:
        raise RuntimeError("converting product directories to HDF5 needs h5py")
    if not os.path.isdir(root):
        raise ValueError(f"{root} is not a directory")
    busy = unfinished(root)
    if busy:
        raise ValueError(
            f"{root} is still being written (or was left unfinished): " + ", ".join(busy[:5])
        )
    stores = []
    for d, dirs, _ in os.walk(root):
        for x in list(dirs):
            if is_directory_store(os.path.join(d, x)):
                stores.append(os.path.join(d, x))
                dirs.remove(x)
    for path in sorted(stores):
        to_hdf5(path)
    return sorted(stores)
