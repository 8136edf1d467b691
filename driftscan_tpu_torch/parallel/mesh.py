"""Device meshes in one process, and the sharding helpers over them.

Port of ``driftscan_tpu/parallel/mesh.py``.  The m-mode pipeline scales
along its m (and frequency x baseline) axis, each unit independent of the
others, so a mesh is one axis, ``"m"``, over an ordered tuple of devices,
and batched arrays are split along their leading axis.  Where JAX places
a global array with a ``NamedSharding`` and lets XLA run each device's
part, the port holds the parts itself (:class:`Shards`) and runs a
function on each with :func:`shard_map`: one worker thread a mesh entry,
each under its entry's card (``torch.cuda.device``), so that the host
synchronisations of one part (cuSOLVER's info checks, a spectrum's
``.cpu()``) do not hold up the others.

A mesh may repeat a device.  Its entries are then virtual devices, as
XLA's host device count makes them: the CPU tests run meshes of several
entries of ``cpu``, and one card runs a mesh of two entries of
``cuda:0`` (two shards, each with its own dispatch and its own kernel
launches).  Every caller takes its unsharded path for a mesh of one
entry (and for ``mesh=None``), as the JAX package does.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, wait
from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np
import torch

from . import comm

M_AXIS = "m"


class Mesh:
    """A 1-D device mesh: an ordered tuple of ``torch.device``s along the
    axis ``axis_name``.  Entries may repeat (virtual devices); a mesh of
    the CPU and cards together raises."""

    def __init__(self, devices: Sequence, axis_name: str = M_AXIS):
        devs = tuple(_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = sorted({d.type for d in devs})
        if len(kinds) > 1 or kinds[0] not in ("cpu", "cuda"):
            raise ValueError(f"a mesh is all CPU or all CUDA devices, not {kinds}")
        self.devices = devs
        self.axis_name = axis_name
        self._pool = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> tuple:
        return (self.axis_name,)

    @property
    def distinct(self) -> tuple:
        """The distinct devices, in the order of their first entry."""
        return tuple(dict.fromkeys(self.devices))

    def pool(self) -> ThreadPoolExecutor:
        """The mesh's worker threads, one an entry (made at first use)."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.size, thread_name_prefix="mesh")
        return self._pool

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, axis_name={self.axis_name!r})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return d


class Shards(tuple):
    """Per-entry values of a mesh, entry i's on the mesh's device i: the
    port's counterpart of an array placed with a ``NamedSharding``
    (:func:`shard_batch`: slices of the leading axis; :func:`replicate`:
    one copy a distinct device, shared by the entries of that device)."""


_active_mesh: Optional[Mesh] = None


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = M_AXIS,
              device=None) -> Mesh:
    """A 1-D mesh over ``devices``; by default, this process's own devices.

    The default follows the JAX package's (the process's local devices):
    ``device`` of type ``cpu`` gives a mesh of the CPU; under more than
    one process (``comm.size() > 1``) the process's own card
    (:func:`comm.device`), so that ranks never share cards; in one
    process every visible card.  Without a card it raises: a mesh never
    falls back to the CPU unless asked.
    """
    if devices is None:
        devices = _default_devices(device)
    return Mesh(devices, axis_name)


def _default_devices(device):
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    if comm.size() > 1:
        dev = comm.device(device)
        if dev.type != "cuda" or dev.index is None:
            raise RuntimeError(f"no CUDA device for this process's mesh (got {dev})")
        return [dev]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for the default mesh: pass devices=[...] or device='cpu'"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def get_mesh(device=None) -> Mesh:
    """The active mesh (:func:`set_mesh`, :func:`use_mesh`); else the
    default mesh of :func:`make_mesh` for ``device``, made anew each call
    (unlike the JAX package, which stores its default: a process may run
    on the CPU and on a card in turn)."""
    if _active_mesh is not None:
        return _active_mesh
    return make_mesh(device=device)


def set_mesh(mesh: Optional[Mesh]):
    global _active_mesh
    _active_mesh = mesh


@contextmanager
def use_mesh(mesh: Mesh):
    global _active_mesh
    prev = _active_mesh
    _active_mesh = mesh
    try:
        yield mesh
    finally:
        _active_mesh = prev


def n_devices(device=None) -> int:
    return get_mesh(device).size


def multi(mesh) -> Optional[Mesh]:
    """``mesh`` where it has more than one entry, else None (the unsharded
    path); raises TypeError for anything but None or a :class:`Mesh`."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh or None, not {type(mesh).__name__}")
    return mesh if mesh.size > 1 else None


def pad_batch(n: int, mesh: Optional[Mesh] = None) -> int:
    """Smallest multiple of the mesh size that is >= n."""
    d = (mesh or get_mesh()).size
    return ((n + d - 1) // d) * d


def _on(x, device):
    return torch.as_tensor(x, device=device)


def shard_batch(x, mesh: Optional[Mesh] = None) -> Shards:
    """The slices of ``x``'s leading axis, one an entry, each on its
    entry's device (a numpy array becomes tensors).  The leading axis must
    divide the mesh size; use :func:`pad_batch` (or :func:`shard_map`'s
    ``pad``) to arrange that."""
    if isinstance(x, Shards):
        return x
    mesh = mesh or get_mesh()
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} does not divide the mesh size {mesh.size}")
    b = n // mesh.size
    return Shards(_on(x[i * b:(i + 1) * b], d) for i, d in enumerate(mesh.devices))


def replicate(x, mesh: Optional[Mesh] = None) -> Shards:
    """``x`` on every entry: one copy a distinct device (a tensor already
    there is not copied), shared by that device's entries; values that
    are not arrays pass as they are."""
    if isinstance(x, Shards):
        return x
    mesh = mesh or get_mesh()
    if isinstance(x, (torch.Tensor, np.ndarray)):
        copies = {d: _on(x, d) for d in mesh.distinct}
        return Shards(copies[d] for d in mesh.devices)
    return Shards(x for _ in mesh.devices)


def gather(parts, device=None, axis: int = 0, n: Optional[int] = None):
    """One value from per-entry results: tensors concatenated along
    ``axis`` on ``device`` (the first part's device by default), numpy
    arrays concatenated, tuples (named ones too) element by element, None
    kept; ``n`` trims the concatenated axis (a padded batch)."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        dev = first.device if device is None else torch.device(device)
        out = torch.cat([p.to(dev) for p in parts], dim=axis)
        return out if n is None else out.narrow(axis, 0, n)
    if isinstance(first, np.ndarray):
        out = np.concatenate(parts, axis=axis)
        return out if n is None else out.take(np.arange(n), axis=axis)
    if isinstance(first, tuple):
        items = [gather([p[i] for p in parts], device, axis, n) for i in range(len(first))]
        return type(first)(*items) if hasattr(first, "_fields") else type(first)(items)
    raise TypeError(f"cannot gather {type(first).__name__} results")


def _run_on(device, nthreads, fn, args):
    """``fn(*args)`` in a worker thread, with the caller's intra-op thread
    count (a worker keeps the count it first ran with otherwise, and a
    CPU library's bits may depend on it) and ``device`` current."""
    if torch.get_num_threads() != nthreads:
        torch.set_num_threads(nthreads)
    if device.type == "cuda":
        with torch.cuda.device(device):
            return fn(*args)
    return fn(*args)


def shard_map(fn, mesh: Mesh, sharded=(), replicated=(), *, pad: bool = False,
              gather_to=None, stack: bool = True):
    """``fn(*sharded_i, *replicated_i)`` on every entry i of ``mesh``, each
    in its own worker thread under the entry's device, and the results.

    ``sharded`` values are split along their leading axis
    (:func:`shard_batch`; :class:`Shards` pass as they are); with ``pad``
    the axis is first padded to a multiple of the mesh size by repeating
    its last row (as the JAX package's batched solves do) and the
    gathered results are trimmed back.  ``replicated`` values go to every
    entry (:func:`replicate`).  The results are gathered (:func:`gather`,
    on ``gather_to`` or the first entry's device); ``stack=False``
    returns them as :class:`Shards`.  A failure on any entry raises once
    every entry has finished.
    """
    n = None
    parts = []
    for x in sharded:
        if pad and not isinstance(x, Shards):
            n = x.shape[0]
            extra = pad_batch(n, mesh) - n
            if extra:
                last = x[-1:]
                if isinstance(x, torch.Tensor):
                    x = torch.cat([x, last.expand((extra,) + tuple(x.shape[1:]))])
                else:
                    x = np.concatenate([x, np.repeat(last, extra, axis=0)])
        parts.append(shard_batch(x, mesh))
    parts += [replicate(x, mesh) for x in replicated]
    pool, nthreads = mesh.pool(), torch.get_num_threads()
    futures = [
        pool.submit(_run_on, d, nthreads, fn, [p[i] for p in parts])
        for i, d in enumerate(mesh.devices)
    ]
    wait(futures)
    results = Shards(f.result() for f in futures)
    if not stack:
        return results
    return gather(results, gather_to, n=n)


def transpose_sharded(x, mesh: Optional[Mesh] = None) -> Shards:
    """Reshard a row-sharded array to column sharding: the all-to-all.

    ``x`` is (R, ..., C), as :class:`Shards` of its row blocks or a whole
    array (split by :func:`shard_batch`); the result is the same array as
    :class:`Shards` of its column blocks, each on its entry's device.
    Entry j receives from every entry i only the (R/P, ..., C/P) tile of
    its own columns, one device copy a tile (peer to peer between cards):
    the exchange of the reference's MPI transpose
    (``caput.mpiutil.transpose_blocks``).  R and C must both divide the
    mesh size.
    """
    mesh = mesh or get_mesh()
    P = mesh.size
    rows = x if isinstance(x, Shards) else None
    R = sum(r.shape[0] for r in rows) if rows is not None else x.shape[0]
    C = (rows[0] if rows is not None else x).shape[-1]
    if R % P or C % P:
        raise ValueError(f"both ends of ({R}, ..., {C}) must divide the mesh size {P}")
    if rows is None:
        rows = shard_batch(x, mesh)
    c = C // P
    return Shards(
        torch.cat([r[..., j * c:(j + 1) * c].to(d) for r in rows], dim=0)
        for j, d in enumerate(mesh.devices)
    )


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the sharded product step, the top-band engine and the fused
    Fisher on an ``n_devices``-entry mesh and check them; the counterpart
    of the JAX package's ``dryrun_multichip``.

    ``device`` None takes the first ``n_devices`` cards, or, on a host
    with fewer, ``n_devices`` entries of card 0 (virtual devices, which
    take turns on the card); ``device="cpu"`` (or any one device) makes
    every entry that device.  Two m-modes an entry, the JAX dry run's
    example inputs (``_example_args``).  Asserts finite spectra of the
    expected shape, equal to the unsharded step's within 1e-10 of each
    m's top, finite certificates and a finite (2, 2) Fisher; returns the
    figures it printed.
    """
    from ..ops import projections
    from . import mstep

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip needs a card, or device='cpu'")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i if count >= n_devices else 0)
                   for i in range(n_devices)]
    else:
        devices = [torch.device(device)] * n_devices
    mesh = make_mesh(devices)
    dev = mesh.devices[0]

    npol, nl = 1, 8
    nm = 2 * n_devices
    beam, noisew, ls, lf, m_values = _example_args(nm=nm, npol=npol, nl=nl)
    beam_t = torch.as_tensor(beam, device=dev)
    mv_t = torch.as_tensor(m_values, dtype=torch.int64, device=dev)
    nw_t, ls_t, lf_t = (torch.as_tensor(a, device=dev) for a in (noisew, ls, lf))

    res = mstep.kl_product_step(beam_t, nw_t, ls_t, lf_t, mv_t, npol=npol, nl=nl, mesh=mesh)
    ref = mstep.kl_product_step(beam_t, nw_t, ls_t, lf_t, mv_t, npol=npol, nl=nl)
    evals = res.evals.cpu().numpy()
    assert evals.shape == (nm, beam.shape[1] * min(nl, beam.shape[2]))
    assert np.isfinite(evals).all(), "dryrun produced non-finite KL eigenvalues"
    ev_ref = ref.evals.cpu().numpy()
    err = float((np.abs(evals - ev_ref) / np.maximum(ev_ref.max(1, keepdims=True), 1e-30)).max())
    assert err <= 1e-10, f"sharded step {err:.3e} of each m's top from the unsharded one"

    # the retained-band engine shards the same way (its pencil in
    # complex128, as the port's product step and file path give it)
    bsvd5 = beam.reshape(nm, beam.shape[1], beam.shape[2], npol, nl).astype(np.complex128)
    w_tb, _, ok_tb = projections.kl_factored_batched_topband(
        bsvd5, ls, lf, cut=0.1, device=dev, mesh=mesh
    )
    assert np.isfinite(w_tb.cpu().numpy()).all(), "topband dryrun produced non-finite evals"

    # the fused Fisher: band table replicated, per-m blocks sharded, summed
    rngb = np.random.default_rng(7)
    nfreq = beam.shape[1]
    clb = []
    for _ in range(2):
        a = rngb.standard_normal((nl, nfreq, 2))
        clb.append(np.einsum("lfk,lgk->lfg", a, a).astype(np.float64))
    band_lt = mstep.band_factor_table(clb, out_dtype=np.float32, l_chunk=4)
    band_t = torch.as_tensor(band_lt, device=dev)
    n_kl = evals.shape[1]
    fm = mstep.fisher_step(res.evals, res.evecs, res.beam_svd, band_t, ps_threshold=0.1,
                           npol=npol, nl=nl, kf=n_kl, mesh=mesh)
    fish = fm.sum(0).cpu().numpy()
    assert fish.shape == (2, 2) and np.isfinite(fish).all(), "fisher dryrun produced a bad total"

    out = {
        "devices": [str(d) for d in mesh.devices], "m": nm,
        "evals": (float(evals.min()), float(evals.max())), "vs_unsharded": err,
        "topband_ok": bool(ok_tb.all()),
        "fisher_diag": (float(fish[0, 0].real), float(fish[1, 1].real)),
    }
    print(
        f"dryrun_multichip OK: {n_devices} entries {out['devices']}, {nm} m-modes, "
        f"evals range [{evals.min():.3g}, {evals.max():.3g}], {err:.3e} of each m's top "
        f"from the unsharded step; topband certificates ok={out['topband_ok']}; "
        f"fisher diag [{fish[0, 0].real:.3g}, {fish[1, 1].real:.3g}]"
    )
    return out


def _example_args(nm=4, nfreq=2, ntel=8, npol=1, nl=8, dtype=np.complex64):
    """The JAX dry run's example inputs (``__graft_entry__._example_args``),
    the same numbers from the same seeds: (beam (nm, nfreq, ntel, npol*nl),
    noisew (nfreq, ntel), ls, lf (nl, npol, nfreq, K), m_values (nm,))."""
    from . import mstep

    rng = np.random.default_rng(0)

    def crandn(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)

    def psd_cl(seed):
        r = np.random.default_rng(seed)
        a = r.standard_normal((npol, npol, nl, nfreq, nfreq))
        c = (a + a.transpose(0, 1, 2, 4, 3)) * 0.1
        c += 2.0 * np.eye(nfreq)[None, None, None]
        npf = npol * nfreq
        m = c.transpose(2, 0, 3, 1, 4).reshape(nl, npf, npf)
        m = np.einsum("lij,lkj->lik", m, m)
        return (m.reshape(nl, npol, nfreq, npol, nfreq).transpose(1, 3, 0, 2, 4)
                .astype(np.float32))

    beam = crandn(nm, nfreq, ntel, npol * nl)
    noisew = np.abs(rng.standard_normal((nfreq, ntel))).astype(np.float32) + 0.5
    ls, lf = mstep.prepare_cl_factors(psd_cl(1), psd_cl(2))
    m_values = np.arange(nm, dtype=np.int32)
    return beam, noisew, ls, lf, m_values
