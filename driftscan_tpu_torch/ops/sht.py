"""Spherical harmonic transforms of HEALPix RING maps.

Port of ``driftscan_tpu/ops/sht.py``, the forward transform (analysis):

* phase stage (K4) -- ``F_m(r) = sum_j f(r, j) e^{-i m phi_rj}`` and its
  ``+m`` partner ``G_m(r)`` for the requested m only.
  :func:`phase_stage` runs it as one hand-written CUDA kernel, a projection
  onto those m (the JAX package's algorithm): the rings that share a length
  and an azimuth offset (a polar cap's pair, one parity of the belt) share
  one table of cos / sin(m phi), generated on the card, and each group is
  one product on the CUDA cores.  :func:`phase_stage_ref` is the plain
  version: one ``torch.fft`` per group of rings of equal length, ring r
  holding N_r pixels at ``phi_rj = phi0_r + 2 pi j / N_r``, so
  ``F_m(r) = e^{-i m phi0_r} X_r[m mod N_r]`` and
  ``G_m(r) = e^{+i m phi0_r} X_r[-m mod N_r]`` with X_r the ring's DFT.
  In the polar caps N_r < m: the bin wraps, the phi0 phase uses the true m;
* Legendre stage (K3+K5) — ``a[b, l, m] = Omega_pix sum_r lambda_lm(theta_r)
  F_m(r)`` (and the negative-m block from G with the (-1)^m sign), with
  lambda generated by the three-term recurrence in l in float64 with
  log-domain rescaling.  :func:`legendre_contract` runs it as one
  hand-written CUDA kernel that generates lambda on the fly;
  :func:`legendre_contract_ref` is the plain version (a lambda table and
  a batched contraction), the JAX algorithm step for step.

and the inverse transform (synthesis):

* Legendre stage (K14) -- ``T+[b, m, r] = sum_l lambda_lm(theta_r) a[b, l,
  m]`` and, for a complex field, ``T-[b, m, r] = (-1)^m sum_l
  lambda_lm(theta_r) a[b, l, -m]``.  :func:`legendre_synth` runs it as one
  hand-written CUDA kernel that generates lambda on the fly;
  :func:`legendre_synth_ref` is the plain version (a lambda table and one
  contraction);
* phase stage (K4's inverse) -- ``f(r, j) = sum_m w_m T+_m(r) e^{+i m
  phi_rj}`` (plus ``T-_m(r) e^{-i m phi_rj}``); the real form has
  ``w_0 = 1``, ``w_{m>0} = 2`` and keeps the real part.
  :func:`phase_stage_inv` runs it as one hand-written CUDA kernel on the
  same ring groups; :func:`phase_stage_inv_ref` is the plain version: ring
  r's spectrum ``S_r[k] = sum_{m = k mod N_r} w_m T+_m(r) e^{+i m phi0_r}``
  (plus ``T-_m(r) e^{-i m phi0_r}`` at ``k = -m mod N_r``) folded with
  ``index_add_`` (in the polar caps several m share a bin), then
  ``f(r, j) = N_r ifft(S_r)[j]`` per group of rings of equal length.

Compact RING maps enter and leave through :func:`pad_map` and
:func:`unpad_map`; :func:`analysis_maps` is the JAX package's ``analysis``
on them, with its Jacobi refinement (each step one synthesis, K14 and the
inverse phase stage, and one analysis of the residual, the phase stage and
K3+K5).  Conventions: Condon-Shortley phase, orthonormal
harmonics, so ``Y_{l,-m} = (-1)^m conj(Y_lm)``.  Quadrature is equal-area
pixel weighting.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import backend
from .healpix import ring_geometry
from .projections import as_tensor

K3K5 = backend.register(
    "k3k5_legendre_sht",
    "driftscan_tpu_torch/csrc/legendre_sht.cu",
    "driftscan_tpu/ops/sht.py:80 + driftscan_tpu/ops/sht.py:729",
)

K14 = backend.register(
    "k14_legendre_synth",
    "driftscan_tpu_torch/csrc/legendre_synth.cu",
    "driftscan_tpu/ops/sht.py:474 + driftscan_tpu/ops/sht.py:535 (+ :80)",
)

K4 = backend.register(
    "k4_phase",
    "driftscan_tpu_torch/csrc/phase_stage.cu",
    "driftscan_tpu/ops/sht.py:433-446 + :664-727",
)

K4_INV = backend.register(
    "k4_phase_inv",
    "driftscan_tpu_torch/csrc/phase_stage.cu",
    "driftscan_tpu/ops/sht.py:506-519 + :563-577 + :809",
)

# Rescaling bounds of the Legendre recurrence (the JAX package's constants).
_BIG = 1e30
_SMALL = 1e-30
_LOG_BIG = float(np.log(_BIG))
# exp() underflow guard: values below e^-87 are emitted as exact zeros
_LOG_TINY = -87.0


@functools.lru_cache(maxsize=64)
def _log_lambda_mm_prefactor(mmax: int) -> np.ndarray:
    """log lambda_mm(theta) = pref[m] + m*log(sin theta); sign is (-1)^m."""
    m = np.arange(mmax + 1, dtype=np.float64)
    ratio = np.zeros(mmax + 1)
    if mmax > 0:
        k = np.arange(1, mmax + 1, dtype=np.float64)
        ratio[1:] = np.cumsum(np.log((2 * k - 1) / (2 * k)))
    return 0.5 * (np.log((2 * m + 1) / (4 * np.pi)) + ratio)


def legendre_table(mvals, cos_t, sin_t, lmax: int, logpref):
    """Normalised associated Legendre table, (lmax+1, nm, nring) float64.

    ``lam[l, i, r] = lambda_{l, mvals[i]}(theta_r)`` (0 for l < m), by the
    recurrence of ``driftscan_tpu.ops.sht._legendre_chunk``: mantissas
    (u0, u1) and a log scale s per (m, ring), rescaled by 1e+-30 whenever
    a mantissa leaves [1e-30, 1e30].
    """
    f64 = torch.float64
    m_f = mvals.to(f64)[:, None]
    x = cos_t.to(f64)[None, :]
    log_sin = torch.log(torch.clamp(sin_t.to(f64), min=1e-30))[None, :]
    safe_m = torch.clamp(mvals, 0, logpref.shape[0] - 1)
    log_lmm = logpref[safe_m][:, None] + m_f * log_sin
    sign = torch.where(mvals[:, None] % 2 == 0, 1.0, -1.0).to(f64)

    shape = (mvals.shape[0], cos_t.shape[0])
    u0 = torch.zeros(shape, dtype=f64, device=cos_t.device)
    u1 = torch.zeros_like(u0)
    s = torch.full(shape, -1e6, dtype=f64, device=cos_t.device)
    out = []
    for l in range(lmax + 1):
        l_f = float(l)
        denom = torch.clamp(l_f * l_f - m_f * m_f, min=1.0)
        a = torch.sqrt(max(4.0 * l_f * l_f - 1.0, 0.0) / denom)
        b = torch.sqrt(
            torch.clamp((l_f - 1.0) ** 2 - m_f * m_f, min=0.0)
            / max(4.0 * (l_f - 1.0) ** 2 - 1.0, 1.0)
        )
        u_rec = a * (x * u1 - b * u0)
        is_seed = l == mvals[:, None]
        is_next = l == mvals[:, None] + 1
        below = l < mvals[:, None]
        u_new = torch.where(
            is_seed,
            sign.expand(shape),
            torch.where(is_next, x * torch.sqrt(2.0 * m_f + 3.0) * u1, u_rec),
        )
        u_new = torch.where(below, 0.0, u_new)
        s_new = torch.where(is_seed, log_lmm, s)

        mx = torch.maximum(u_new.abs(), u1.abs())
        up = mx > _BIG
        down = (mx > 0.0) & (mx < _SMALL)
        # float64 factors: where() of two Python scalars gives float32
        one = torch.ones_like(mx)
        factor = torch.where(up, _SMALL * one, torch.where(down, _BIG * one, one))
        dlog = torch.where(up, _LOG_BIG * one, torch.where(down, -_LOG_BIG * one, 0.0 * one))
        u0 = u1 * factor
        u1 = u_new * factor
        s = s_new + dlog

        loglam = s + torch.log(torch.clamp(u1.abs(), min=_SMALL * _SMALL))
        lam = torch.where(
            loglam > _LOG_TINY,
            torch.sign(u1) * torch.exp(torch.clamp(loglam, min=_LOG_TINY)),
            0.0,
        )
        out.append(lam)
    return torch.stack(out)


def _contract_plane(lam, x):
    """sum_r lam[l, m, r] x[b, m, r] for complex x, lam real."""
    xr = torch.view_as_real(x)  # (B, nm, nring, 2)
    out = torch.einsum("lmr,bmrc->blmc", lam, xr)
    return torch.view_as_complex(out.contiguous())


def legendre_contract_ref(F, G, cos_t, sin_t, lmax: int, pixarea: float, m_lo: int = 0):
    """Plain PyTorch version of :func:`legendre_contract`.

    On the card one batched contraction a plane.  On the host one product
    per m, each on its own copies of the operands, so that an m's result
    does not depend on which other m are in the call and a window's
    columns repeat the full range's bit for bit (the host library's
    batched product rounds by the operands' alignment)."""
    nm = F.shape[1]
    rdtype = backend.real_dtype(F.dtype)
    mvals = m_lo + torch.arange(nm, device=F.device)
    logpref = torch.as_tensor(_log_lambda_mm_prefactor(lmax), device=F.device)
    lam = legendre_table(mvals, cos_t, sin_t, lmax, logpref).to(rdtype)
    if F.is_cuda:
        signm = torch.where(mvals % 2 == 0, 1.0, -1.0).to(rdtype)
        return (pixarea * _contract_plane(lam, F),
                pixarea * _contract_plane(lam, G * signm[None, :, None]))
    sign = [1.0 if int(m) % 2 == 0 else -1.0 for m in mvals]
    pos = torch.zeros((F.shape[0], lmax + 1, nm), dtype=F.dtype, device=F.device)
    neg = torch.zeros_like(pos)
    for j in range(min(nm, lmax + 1 - m_lo)):
        lam_m = lam[:, j].contiguous()  # (l, ring)
        for out, x, scale in ((pos, F, pixarea), (neg, G, pixarea * sign[j])):
            xr = torch.view_as_real(x[:, j].contiguous())  # (B, ring, 2)
            prod = torch.matmul(lam_m, xr.permute(1, 0, 2).reshape(xr.shape[1], -1))
            col = torch.view_as_complex(prod.reshape(lmax + 1, -1, 2).contiguous())
            out[:, :, j] = scale * col.transpose(0, 1)
    return pos, neg


def m_schedule(nm: int, m_lo: int = 0) -> np.ndarray:
    """The m values each block of the Legendre kernels (K3+K5, K14) takes:
    (ceil(nm / 2), 2) int32 rows (m_lo + j, m_lo + nm - 1 - j), the second
    -1 where the middle m of an odd nm stands alone.  A block then walks
    2 (lmax + 1) - (2 m_lo + nm - 1) multipoles whatever its row, so no block
    runs twice the mean (m = 0 alone would)."""
    first = np.arange((nm + 1) // 2)
    second = nm - 1 - first
    second[second == first] = -1
    sched = np.stack([first, second], axis=1) + m_lo
    sched[sched < m_lo] = -1
    return sched.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _legendre_tables(lmax: int, nm: int, device: torch.device, m_lo: int = 0):
    """(logpref, schedule) on ``device``, uploaded once per (lmax, nm,
    m_lo)."""
    return (
        torch.as_tensor(_log_lambda_mm_prefactor(lmax), device=device),
        torch.as_tensor(m_schedule(nm, m_lo), device=device),
    )


def legendre_contract(F, G, cos_t, sin_t, lmax: int, pixarea: float, m_lo: int = 0):
    """Legendre stage of the analysis (K3+K5).

    F, G : (B, nm, nring) complex phase-stage outputs for m = m_lo ..
    m_lo + nm - 1 (column j holds m = m_lo + j); cos_t, sin_t : (nring,)
    float64 ring colatitudes.  Returns (pos, neg), each (B, lmax+1, nm)
    complex:
    ``pos[b, l, j] = Omega sum_r lambda_lm(theta_r) F[b, j, r]`` and
    ``neg[b, l, j] = Omega (-1)^m sum_r lambda_lm(theta_r) G[b, j, r]``,
    m = m_lo + j; columns with m > lmax are zeros.  Each m is computed by
    itself, so a window's columns equal the full range's bit for bit.
    CPU tensors take the plain version; CUDA tensors launch the kernel and
    get transposed views of (B, nm, lmax+1) tensors.
    """
    if not backend.on_cuda(F, G, cos_t, sin_t):
        return legendre_contract_ref(F, G, cos_t, sin_t, lmax, pixarea, m_lo)
    B, nm, nring = F.shape
    backend.require(F, "F", dtype=(torch.complex64, torch.complex128), ndim=3)
    backend.require(G, "G", dtype=F.dtype, shape=F.shape)
    backend.require(cos_t, "cos_t", dtype=torch.float64, shape=(nring,))
    backend.require(sin_t, "sin_t", dtype=torch.float64, shape=(nring,))
    if m_lo < 0:
        raise ValueError(f"m_lo={m_lo} is negative")
    dev = F.device
    # the kernel writes (B, nm, lmax + 1), contiguous along l, so that a
    # block's stores for its m run along l; the results are its transposes
    pos = torch.empty((B, nm, lmax + 1), dtype=F.dtype, device=dev)
    neg = torch.empty_like(pos)
    # the columns past lmax are zeros and get no block
    nvalid = max(0, min(nm, lmax + 1 - m_lo))
    pos[:, nvalid:].zero_()
    neg[:, nvalid:].zero_()
    if B == 0 or nvalid == 0 or nring == 0:
        return pos.zero_().transpose(1, 2), neg.zero_().transpose(1, 2)
    logpref, sched = _legendre_tables(lmax, nvalid, dev, m_lo)
    fn = K3K5.entry(
        "legendre_sht_c64" if F.dtype == torch.complex64 else "legendre_sht_c128",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_double, ctypes.c_void_p],
    )
    backend.launch(
        K3K5, fn, dev,
        F.data_ptr(), G.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
        logpref.data_ptr(), sched.data_ptr(), sched.shape[0], pos.data_ptr(),
        neg.data_ptr(), B, nm, m_lo, nring, lmax, float(pixarea),
    )
    return pos.transpose(1, 2), neg.transpose(1, 2)


_PHASE_CACHE = {}


def _phase_tables(nside: int, m1: int, dtype, device, m0: int = 0):
    """Device tables of the phase stage for m = m0 .. m1 - 1, cached per
    (nside, m0, m1, dtype, device).

    Returns (groups [(N, ring indices)], kpos, kneg flat gather indices
    ((m1 - m0)*nring,) into the (ring, slot) spectrum, shift (m1 - m0,
    nring) = e^{+i m phi0_r}), row j holding m = m0 + j.
    """
    key = (nside, m0, m1, dtype, str(device))
    if key not in _PHASE_CACHE:
        g = ring_geometry(nside)
        groups = [
            (int(n), torch.as_tensor(np.nonzero(g.nphi == n)[0], device=device))
            for n in np.unique(g.nphi)
        ]
        nphi = g.nphi.astype(np.int64)
        # phi0_r = pi h_r / N_r exactly, h in {0, 1}:
        # m phi0 = 2 pi (m h mod 2N) / 2N
        h = np.rint(g.phi0 * nphi / np.pi).astype(np.int64)
        m = np.arange(m0, m1, dtype=np.int64)[:, None]
        base = (np.arange(g.nring, dtype=np.int64) * g.maxlen)[None, :]
        kpos = torch.as_tensor((base + m % nphi[None, :]).ravel(), device=device)
        kneg = torch.as_tensor((base + (-m) % nphi[None, :]).ravel(), device=device)
        turns = ((m * h[None, :]) % (2 * nphi[None, :])) / (2.0 * nphi[None, :])
        ang = torch.as_tensor(2.0 * np.pi * turns, device=device).to(
            backend.real_dtype(dtype)
        )
        shift = torch.complex(torch.cos(ang), torch.sin(ang))
        _PHASE_CACHE[key] = (groups, kpos, kneg, shift)
    return _PHASE_CACHE[key]


def _cmul(a, b):
    """a * b for complex tensors, each part by separate real operations:
    the same bits for an element wherever it lies in the tensor (the CPU's
    vectorised complex product rounds differently from its scalar tail)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)


# The plan of csrc/phase_stage.cu: its largest m tile (8 NT columns, NT up
# to 8), its shared memory a block, the pixels of a forward stage and the m
# of an inverse stage of each type (they fix the order of every sum and do
# not depend on the plan)
PHASE_MAX_COLS = 64
PHASE_SMEM = 232448
_PHASE_JC = 32
_PHASE_MC = {torch.complex64: 32, torch.complex128: 16}


class PhasePlan(NamedTuple):
    """The tile of one phase-stage launch (:func:`phase_plan`)."""

    rows: int  # rows (unit, ring) a block: a row tile of phase_tiles
    cols: int  # forward: m a tile (a multiple of 8); inverse: pixels a tile
    tiles: int  # forward: m tiles (cols x tiles >= nm); inverse: pixel tiles
    stages: int  # shared-memory stages of the cp.async ring
    smem: int  # bytes of dynamic shared memory a block


def _m_tiles(nm: int) -> tuple[int, int]:
    """(cols, tiles) covering nm m: one tile of nm rounded up to a multiple
    of 8 up to PHASE_MAX_COLS; past it the fewest columns over an even split
    into 1-3 more tiles than the least (ties: fewer tiles)."""
    least = -(-nm // PHASE_MAX_COLS)
    best = None
    for k in range(least, least + 3):
        cols = -(-(-(-nm // k)) // 8) * 8
        if cols > PHASE_MAX_COLS:
            continue
        if best is None or k * cols < best[0] * best[1]:
            best = (k, cols)
    return best[1], best[0]


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.lru_cache(maxsize=256)
def phase_plan(nside: int, B: int, nm: int, dtype: torch.dtype, inverse: bool = False,
               real: bool = False) -> PhasePlan:
    """The tile of a K4 (``inverse``: K4's inverse, ``real`` its real form)
    launch for B units at ``nside`` over nm m, as csrc/phase_stage.cu takes
    it.  Forward: m tiles of :func:`_m_tiles`; complex64 32 rows (one
    warpgroup) and 4 ring stages, complex128 16, 32 or 64 rows as the polar
    caps' 2B-row groups fill them and 3 stages; inverse: 32 (real form) or
    16 (complex) rows a warp row, 2 or 4 warp rows likewise, pixel tiles
    of 64 (32 where rings hold at most 32 pixels), 2 ring stages.  Where
    the shared memory would pass the card's 227 KB the stages drop to 2,
    then the rows, then the forward's m tile to 32 columns; past that it
    raises ValueError."""
    if dtype not in _PHASE_MC:
        raise TypeError(f"phase stage of {dtype}")
    c64 = dtype == torch.complex64
    maxlen = 4 * nside
    csize = 8 if c64 else 16
    if not inverse:
        # complex64: one warpgroup a block, so that several blocks share an
        # SM; complex128: the warp rows the caps' groups fill
        per, least, most = (32, 1, 1) if c64 else (16, 1, 4)
        cols, tiles = _m_tiles(max(nm, 1))
        stages = 4 if c64 else 3
    else:
        per, least, most = (32 if real else 16), 2, 4
        cols = 64 if maxlen > 32 else 32
        tiles = -(-maxlen // cols)
        stages = 2
    wr = least
    while wr < most and 2 * B > per * wr:
        wr *= 2

    def smem(wr, cols, stages):
        rows = per * wr
        if not inverse and c64:
            # alignment slack, the table's big and small planes (2 cols rows
            # of 128 bytes), two stages' turns, the half-wave table, the
            # ring, the rows' offsets
            return (1024 + 2 * 2 * cols * 128 + 16 * cols + _align16((maxlen + 1) * 4)
                    + stages * rows * (_PHASE_JC + 4) * csize + 8 * rows)
        if not inverse:
            # the half-wave table, the ring, the table tile, the turns, the
            # rows' offsets
            return (_align16((maxlen + 1) * 8) + stages * rows * (_PHASE_JC + 4) * csize
                    + _PHASE_JC * (2 * cols + 4) * 8 + 16 * cols + 8 * rows)
        mc = _PHASE_MC[dtype]
        pad = 2 if c64 else 4
        # the half-wave table as entries, the ring, two table tiles
        return (_align16((maxlen + 1) * 8) + 2 * mc * (cols + pad) * 16
                + stages * (1 if real else 2) * rows * (mc + 4) * csize)

    while smem(wr, cols, stages) > PHASE_SMEM:
        if stages > 2:
            stages -= 1
        elif wr > 1:
            wr //= 2
        elif not inverse and cols > 32:
            cols, tiles = 32, -(-max(nm, 1) // 32)
        else:
            raise ValueError(f"nside {nside}: the phase stage's tables pass the shared memory")
    return PhasePlan(per * wr, cols, tiles, stages, smem(wr, cols, stages))


@functools.lru_cache(maxsize=32)
def phase_groups(nside: int) -> np.ndarray:
    """The rings of ``nside`` that share one phase table, (ngroups, 5)
    int32 rows (N, h, rings, first ring, ring stride), largest N first:
    the rings of N pixels at phi_j = pi (2 j + h) / N (a polar cap's pair
    i and 4 nside - i; each parity of the equatorial belt), evenly spaced
    from the first.  Every ring lies in one group."""
    g = ring_geometry(nside)
    h = np.rint(g.phi0 * g.nphi / np.pi).astype(np.int64)
    rows = []
    for n, hh in sorted(set(zip(g.nphi.tolist(), h.tolist())), reverse=True):
        rings = np.nonzero((g.nphi == n) & (h == hh))[0]
        stride = int(rings[1] - rings[0]) if len(rings) > 1 else 1
        if np.any(np.diff(rings) != stride):
            raise AssertionError(f"nside {nside}: the rings of N {n}, h {hh} are not evenly spaced")
        rows.append((n, hh, len(rings), int(rings[0]), stride))
    return np.asarray(rows, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def phase_tiles(nside: int, B: int, rows: int) -> np.ndarray:
    """The row tiles of one phase-stage launch, (ntiles, 2) int32 (group of
    :func:`phase_groups`, first row): each group's B x rings rows (row q is
    unit q // rings on the group's (q % rings)-th ring) in tiles of
    ``rows``, the groups in their order (the longest rings first)."""
    nr = phase_groups(nside)[:, 2]
    tiles = [(gi, r0) for gi, n in enumerate(nr.tolist()) for r0 in range(0, B * n, rows)]
    return np.asarray(tiles, dtype=np.int32).reshape(-1, 2)


@functools.lru_cache(maxsize=64)
def _phase_launch_tables(nside: int, B: int, rows: int, device: torch.device):
    """(groups, tiles) of :func:`phase_groups` and :func:`phase_tiles` on
    ``device``, uploaded once per (nside, B, rows)."""
    return (torch.as_tensor(phase_groups(nside), device=device),
            torch.as_tensor(phase_tiles(nside, B, rows), device=device))


def phase_stage(padded, nside: int, nm: int, m0: int = 0):
    """Phase stage of the analysis (K4).

    (F, G), each (B, nm, nring) complex, from (B, nring, maxlen) maps (the
    padding slots are not read); row j holds m = m0 + j:
    ``F[b, j, r] = sum_{i < N_r} padded[b, r, i] e^{-i m phi_ri}`` and G
    with ``e^{+i m phi_ri}``.  Each column is computed by itself, so a
    window's columns equal the full range's bit for bit.  CPU tensors take
    the plain version; CUDA tensors launch the kernel.
    """
    if not backend.on_cuda(padded):
        return phase_stage_ref(padded, nside, nm, m0)
    g = ring_geometry(nside)
    B = padded.shape[0]
    backend.require(padded, "padded", dtype=(torch.complex64, torch.complex128),
                    shape=(B, g.nring, g.maxlen))
    if m0 < 0 or nm < 0:
        raise ValueError(f"invalid m range: m0={m0}, nm={nm}")
    dev = padded.device
    # the kernel writes every entry
    F = torch.empty((B, nm, g.nring), dtype=padded.dtype, device=dev)
    G = torch.empty_like(F)
    if F.numel() == 0:
        return F, G
    plan = phase_plan(nside, B, nm, padded.dtype)
    groups, tiles = _phase_launch_tables(nside, B, plan.rows, dev)
    fn = K4.entry(
        "phase_fwd_c64" if padded.dtype == torch.complex64 else "phase_fwd_c128",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
        + [ctypes.c_void_p],
    )
    backend.launch(
        K4, fn, dev,
        padded.data_ptr(), groups.data_ptr(), tiles.data_ptr(), tiles.shape[0], F.data_ptr(),
        G.data_ptr(), B, g.nring, g.maxlen, m0, nm, plan.rows, plan.cols, plan.stages,
    )
    return F, G


def phase_stage_ref(padded, nside: int, nm: int, m0: int = 0):
    """Plain PyTorch version of :func:`phase_stage`: one FFT per group of
    rings of equal length, then the m's bins and their phi0 phases."""
    g = ring_geometry(nside)
    B = padded.shape[0]
    groups, kpos, kneg, shift = _phase_tables(nside, m0 + nm, padded.dtype, padded.device, m0)
    spec = torch.zeros_like(padded)
    for n, r in groups:
        spec[:, r, :n] = torch.fft.fft(padded[:, r, :n], dim=-1)
    flat = spec.reshape(B, -1)
    F = _cmul(flat[:, kpos].reshape(B, nm, g.nring), shift.conj())
    G = _cmul(flat[:, kneg].reshape(B, nm, g.nring), shift)
    return F.contiguous(), G.contiguous()


_GEOM_CACHE = {}


class _Geom(NamedTuple):
    """Device tables of the ring geometry of one nside."""

    cos_t: torch.Tensor  # (nring,) float64
    sin_t: torch.Tensor  # (nring,) float64
    mask: torch.Tensor  # (nring, maxlen) validity of each (ring, slot)
    pix_index: torch.Tensor  # (nring*maxlen,) RING pixel of each slot
    valid: torch.Tensor  # flat slots that hold a pixel, in RING order


def _geom_tensors(nside: int, device) -> _Geom:
    key = (nside, str(device))
    if key not in _GEOM_CACHE:
        g = ring_geometry(nside)
        _GEOM_CACHE[key] = _Geom(
            torch.as_tensor(g.cos_theta, dtype=torch.float64, device=device),
            torch.as_tensor(g.sin_theta, dtype=torch.float64, device=device),
            torch.as_tensor(g.mask, device=device),
            torch.as_tensor(g.pix_index.ravel().astype(np.int64), device=device),
            torch.as_tensor(np.nonzero(g.mask.ravel())[0], device=device),
        )
    return _GEOM_CACHE[key]


def analysis(maps, lmax: int, nside: int, m_window=None):
    """Forward SHT of ring-padded complex maps, both m signs.

    The JAX package's ``analysis_split(..., neg_m=True, ring_padded=True)``
    with mmax = lmax.  maps : (..., nring*maxlen) complex in the padded
    (ring, slot) layout of ``nside``.  Returns (pos (..., lmax+1, lmax+1),
    neg (..., lmax+1, lmax)), the negative block's column j holding
    m = -(j + 1).

    ``m_window=(m0, m1)`` computes only m in [m0, m1), in the uniform
    layout: pos and neg both (..., lmax+1, m1 - m0), column j holding
    m = m0 + j in pos and -(m0 + j) in neg (the m = 0 negative column is
    zero).  m1 may exceed lmax + 1; the columns past lmax are zeros.  A
    window's columns equal the same columns of the full range bit for bit.
    """
    if m_window is not None:
        m0, m1 = int(m_window[0]), int(m_window[1])
        if not 0 <= m0 < m1:
            raise ValueError(f"invalid m_window {m_window}")
    else:
        m0, m1 = 0, lmax + 1
    g = ring_geometry(nside)
    npix = maps.shape[-1]
    if npix != g.nring * g.maxlen:
        raise ValueError(f"padded npix {npix} != nring*maxlen for nside {nside}")
    if not maps.is_complex():
        raise TypeError("analysis takes complex maps")
    lead = maps.shape[:-1]
    cos_t, sin_t, mask = _geom_tensors(nside, maps.device)[:3]
    flat = maps.reshape(-1, g.nring, g.maxlen) * mask.to(maps.real.dtype)
    F, G = phase_stage(flat, nside, m1 - m0, m0)
    pos, neg = legendre_contract(F, G, cos_t, sin_t, lmax, 4.0 * math.pi / g.npix, m0)
    if m_window is None:
        return pos.reshape(lead + (lmax + 1, lmax + 1)), neg[..., 1:].reshape(lead + (lmax + 1, lmax))
    if m0 == 0:
        neg[..., 0] = 0  # the m = 0 column of the negative block is pos's
    shape = lead + (lmax + 1, m1 - m0)
    return pos.reshape(shape), neg.reshape(shape)


# ------------------------------------------------------------------
# Compact RING maps
# ------------------------------------------------------------------


def pad_map(maps, nside: int):
    """Gather (..., npix) RING maps into the flat padded (ring, slot) layout
    (..., nring*maxlen) the transforms take; padding slots are zero."""
    g = _geom_tensors(nside, maps.device)
    return maps[..., g.pix_index] * g.mask.ravel().to(maps.real.dtype)


def unpad_map(padded, nside: int):
    """Inverse of :func:`pad_map`: flat padded layout -> (..., npix)."""
    return padded[..., _geom_tensors(nside, padded.device).valid]


def _nside_of(npix: int) -> int:
    nside = int(round(math.sqrt(npix / 12)))
    if 12 * nside * nside != npix:
        raise ValueError(f"npix {npix} is not a valid healpix size")
    return nside


def analysis_maps(maps, lmax: int, mmax: Optional[int] = None, nside: Optional[int] = None,
                  neg_m: bool = False, iters: int = 0):
    """Forward SHT of compact RING maps (..., npix), real or complex: the
    JAX package's ``analysis(maps, lmax, mmax, nside, neg_m, iters)``.

    Real maps are taken as complex (float64 gives complex128).  Returns
    (pos (..., lmax+1, mmax+1), neg (..., lmax+1, mmax) with column j
    holding m = -(j+1), or None without ``neg_m``).  ``iters`` Jacobi
    refinement steps (healpy's ``iter``) each add the analysis of the
    residual of the current coefficients' synthesis, sharpening the
    equal-area quadrature towards the least-squares coefficients; a real
    field is resynthesised from its m >= 0 block, a complex one needs
    ``neg_m``.
    """
    mmax = lmax if mmax is None else mmax
    npix = maps.shape[-1]
    if nside is None:
        nside = _nside_of(npix)
    elif 12 * nside * nside != npix:
        raise ValueError(
            f"npix {npix} is not a compact RING map of nside {nside} (ring-padded maps "
            "take analysis(); they cannot be refined)"
        )
    real_field = not maps.is_complex()
    if iters and not real_field and not neg_m:
        raise ValueError("refinement of a complex field requires neg_m=True")
    lead = maps.shape[:-1]
    flat = maps.reshape(-1, npix)
    cflat = flat if not real_field else flat.to(backend.complex_dtype(flat.dtype))

    def fwd(x):
        pos, neg = analysis(pad_map(x, nside), lmax, nside, m_window=(0, mmax + 1))
        return pos, neg[..., 1:]

    pos, neg = fwd(cflat)
    for _ in range(iters):
        if real_field:
            resid = flat - synthesis_real(pos, nside).to(flat.dtype)
            pos = pos + fwd(resid.to(cflat.dtype))[0]
        else:
            resid = flat - synthesis_complex(pos, neg, nside)
            dpos, dneg = fwd(resid)
            pos, neg = pos + dpos, neg + dneg
    pos = pos.reshape(lead + (lmax + 1, mmax + 1))
    if not neg_m:
        return pos, None
    return pos, neg.reshape(lead + (lmax + 1, mmax))


def sphtrans_sky(skymap, lmax: Optional[int] = None, iters: int = 0, device=None):
    """Forward SHT of real RING sky maps [..., pix] -> alm [..., l, m >= 0].

    The JAX package's ``analysis(maps, lmax, iters=iters)`` on real maps
    (``neg_m=False``, mmax = lmax, default lmax 3 nside - 1): the map is
    padded, made complex (float64 maps give complex128) and taken through
    the phase stage and K3+K5, whose negative-m block is computed and
    dropped; ``iters`` Jacobi refinement steps as in
    :func:`analysis_maps`.  ``skymap`` is a tensor, or an array that goes
    to ``device`` (the card when None).
    """
    maps = as_tensor(skymap, device)
    if maps.is_complex():
        raise TypeError("sphtrans_sky takes real maps")
    nside = _nside_of(maps.shape[-1])
    lmax = 3 * nside - 1 if lmax is None else lmax
    return analysis_maps(maps, lmax, nside=nside, iters=iters)[0]


def sphtrans_complex(hpmap, lmax: Optional[int] = None, lside: Optional[int] = None,
                     centered: bool = False, device=None) -> np.ndarray:
    """Forward SHT of complex RING maps [..., pix], both m signs, packed in
    driftscan's FFT-like layout (:func:`pack_fftlike`, (lside+1,
    2 lside+1), complex128 numpy): the JAX package's ``sphtrans_complex``
    (default lmax 3 nside - 1, lside lmax; only ``centered=False``).
    ``hpmap`` is a tensor, or an array that goes to ``device`` (the card
    when None)."""
    if centered:
        raise NotImplementedError("centered alm layout not supported")
    maps = as_tensor(hpmap, device)
    if not maps.is_complex():
        maps = maps.to(backend.complex_dtype(maps.dtype))
    nside = _nside_of(maps.shape[-1])
    lmax = 3 * nside - 1 if lmax is None else lmax
    lside = lmax if lside is None else lside
    pos, neg = analysis_maps(maps, lmax, nside=nside, neg_m=True)
    return pack_fftlike(pos.cpu().numpy(), neg.cpu().numpy(), lside)


def sphtrans_complex_pol(hpmaps, lmax: Optional[int] = None, lside: Optional[int] = None,
                         centered: bool = False, device=None) -> np.ndarray:
    """Per-Stokes :func:`sphtrans_complex` of a stack of complex maps."""
    return sphtrans_complex(hpmaps, lmax=lmax, lside=lside, centered=centered, device=device)


# ------------------------------------------------------------------
# Synthesis: K14 and the inverse phase stage
# ------------------------------------------------------------------


def _synth_plane(lam, a):
    """sum_l lam[l, m, r] a[b, l, m] for complex a, lam real: (B, nm, nring)."""
    out = torch.einsum("lmr,blmc->bmrc", lam, torch.view_as_real(a.resolve_conj()))
    return torch.view_as_complex(out.contiguous())


def legendre_synth_ref(pos, neg, cos_t, sin_t):
    """Plain PyTorch version of :func:`legendre_synth`: the lambda table of
    the JAX recurrence and one contraction per block."""
    nl, nm = pos.shape[1:]
    rdtype = backend.real_dtype(pos.dtype)
    mvals = torch.arange(nm, device=pos.device)
    logpref = torch.as_tensor(_log_lambda_mm_prefactor(nl - 1), device=pos.device)
    lam = legendre_table(mvals, cos_t, sin_t, nl - 1, logpref).to(rdtype)
    tpos = _synth_plane(lam, pos)
    if neg is None:
        return tpos, None
    shifted = torch.cat([torch.zeros_like(pos[..., :1]), neg], dim=-1)
    signm = torch.where(mvals % 2 == 0, 1.0, -1.0).to(rdtype)
    return tpos, _synth_plane(lam, shifted) * signm[:, None]


# The step-coefficient table of csrc/legendre_synth.cu runs this far past
# lmax (its CPAD, at least a multipole tile), so that a tile's rows need no
# bound check.
SYNTH_L_TILE = 32


def step_coefficients(lmax: int, nm: int) -> np.ndarray:
    """(nm, lmax + 1 + SYNTH_L_TILE, 2) float64: the recurrence's step
    coefficients (a, b) of each (m, l), as ``legendre_rec.cuh`` coef_a and
    coef_b form them (every operand an exact integer, then an IEEE division
    and square root: the same bits on the host and the card)."""
    l = np.arange(lmax + 1 + SYNTH_L_TILE, dtype=np.float64)[None, :]
    m = np.arange(nm, dtype=np.float64)[:, None]
    a = np.sqrt(np.maximum(4.0 * l * l - 1.0, 0.0) / np.maximum(l * l - m * m, 1.0))
    b = np.sqrt(np.maximum((l - 1.0) * (l - 1.0) - m * m, 0.0)
                / np.maximum(4.0 * (l - 1.0) * (l - 1.0) - 1.0, 1.0))
    return np.ascontiguousarray(np.stack([a, b], axis=-1))


@functools.lru_cache(maxsize=64)
def _synth_tables(lmax: int, nm: int, device: torch.device):
    """The step coefficients of :func:`step_coefficients` on ``device``,
    uploaded once per (lmax, nm)."""
    return torch.as_tensor(step_coefficients(lmax, nm), device=device)


def legendre_synth(pos, neg, cos_t, sin_t):
    """Legendre stage of the synthesis (K14).

    pos (B, lmax+1, nm) complex coefficients for m = 0..nm-1; neg (B,
    lmax+1, nm-1) the negative-m block (column j holding m = -(j+1)) or
    None for a real field; cos_t, sin_t (nring,) float64 ring colatitudes.
    Returns (tpos, tneg), each (B, nm, nring) complex (tneg None without
    ``neg``): ``tpos[b, m, r] = sum_l lambda_lm(theta_r) pos[b, l, m]`` and
    ``tneg[b, m, r] = (-1)^m sum_l lambda_lm(theta_r) a[b, l, -m]``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    args = (pos, cos_t, sin_t) + (() if neg is None else (neg,))
    if not backend.on_cuda(*args):
        return legendre_synth_ref(pos, neg, cos_t, sin_t)
    B, nl, nm = pos.shape
    nring = cos_t.shape[0]
    backend.require(pos, "pos", dtype=(torch.complex64, torch.complex128), ndim=3)
    if neg is not None:
        backend.require(neg, "neg", dtype=pos.dtype, shape=(B, nl, nm - 1))
    backend.require(cos_t, "cos_t", dtype=torch.float64, shape=(nring,))
    backend.require(sin_t, "sin_t", dtype=torch.float64, shape=(nring,))
    if nm > nl:
        raise ValueError(f"nm={nm} exceeds lmax+1={nl}")
    dev = pos.device
    # the kernel writes every entry
    tpos = torch.empty((B, nm, nring), dtype=pos.dtype, device=dev)
    tneg = None if neg is None else torch.empty_like(tpos)
    if tpos.numel() == 0:
        return tpos, tneg
    logpref, sched = _legendre_tables(nl - 1, nm, dev)
    coef = _synth_tables(nl - 1, nm, dev)
    fn = K14.entry(
        "legendre_synth_c64" if pos.dtype == torch.complex64 else "legendre_synth_c128",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
        + [ctypes.c_void_p],
    )
    backend.launch(
        K14, fn, dev,
        pos.data_ptr(), None if neg is None else neg.data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(), logpref.data_ptr(), coef.data_ptr(),
        sched.data_ptr(), sched.shape[0], tpos.data_ptr(),
        None if tneg is None else tneg.data_ptr(), B, nm, nring, nl - 1,
    )
    return tpos, tneg


def phase_stage_inv(tpos, tneg, nside: int, real: bool):
    """Phase stage of the synthesis (K4's inverse).

    Padded maps (B, nring, maxlen) from the Legendre stage's outputs tpos,
    tneg (B, nm, nring) complex for m = 0 .. nm - 1: ``f[b, r, j] = sum_m
    w_m tpos[b, m, r] e^{+i m phi_rj} (+ tneg[b, m, r] e^{-i m phi_rj})``,
    padding slots zero.  ``real``: w_0 = 1, w_{m>0} = 2 and the real part,
    for a real field, which has no negative block (tneg None); else w = 1,
    complex maps and a negative block (tneg given).  Any other pairing
    raises ValueError on either device.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if real and tneg is not None:
        raise ValueError("the real form takes no negative-m block")
    if not real and tneg is None:
        raise ValueError("the complex form needs its negative-m block")
    args = (tpos,) if tneg is None else (tpos, tneg)
    if not backend.on_cuda(*args):
        return phase_stage_inv_ref(tpos, tneg, nside, real)
    g = ring_geometry(nside)
    B, nm, _ = tpos.shape
    backend.require(tpos, "tpos", dtype=(torch.complex64, torch.complex128),
                    shape=(B, nm, g.nring))
    if tneg is not None:
        backend.require(tneg, "tneg", dtype=tpos.dtype, shape=tpos.shape)
    dev = tpos.device
    dtype = backend.real_dtype(tpos.dtype) if real else tpos.dtype
    # the kernel writes every entry, the padding slots as zeros
    out = torch.empty((B, g.nring, g.maxlen), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    plan = phase_plan(nside, B, nm, tpos.dtype, inverse=True, real=real)
    groups, tiles = _phase_launch_tables(nside, B, plan.rows, dev)
    fn = K4_INV.entry(
        "phase_inv_c64" if tpos.dtype == torch.complex64 else "phase_inv_c128",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 8
        + [ctypes.c_void_p],
    )
    backend.launch(
        K4_INV, fn, dev,
        tpos.data_ptr(), None if tneg is None else tneg.data_ptr(), groups.data_ptr(),
        tiles.data_ptr(), tiles.shape[0], out.data_ptr(), B, g.nring, g.maxlen, nm,
        plan.rows, plan.cols, plan.stages, int(real),
    )
    return out


def phase_stage_inv_ref(tpos, tneg, nside: int, real: bool):
    """Plain PyTorch version of :func:`phase_stage_inv`.

    Ring r's spectrum S_r[k] = sum_{m = k mod N_r} w_m T+_m(r) e^{+i m
    phi0_r} (+ T-_m(r) e^{-i m phi0_r} at k = -m mod N_r) is folded with
    ``index_add_``, which sums the m that share a bin in the polar caps
    (the phase uses the true m); then f(r, j) = N_r ifft(S_r)[j] per group
    of rings of equal length.  ``real``: w_0 = 1, w_{m>0} = 2 and the real
    part (padding slots stay zero).
    """
    g = ring_geometry(nside)
    B, nm, _ = tpos.shape
    groups, kpos, kneg, shift = _phase_tables(nside, nm, tpos.dtype, tpos.device)
    vals = tpos * shift
    if real:
        w = torch.full((nm, 1), 2.0, dtype=shift.real.dtype, device=tpos.device)
        w[0] = 1.0
        vals = vals * w
    spec = torch.zeros((B, g.nring * g.maxlen, 2), dtype=shift.real.dtype, device=tpos.device)
    spec.index_add_(1, kpos, torch.view_as_real(vals.reshape(B, -1)))
    if tneg is not None:
        spec.index_add_(1, kneg, torch.view_as_real((tneg * shift.conj()).reshape(B, -1)))
    spec = torch.view_as_complex(spec).reshape(B, g.nring, g.maxlen)
    out = torch.zeros_like(spec)
    for n, r in groups:
        out[:, r, :n] = torch.fft.ifft(spec[:, r, :n], dim=-1) * n
    return out.real.contiguous() if real else out


def _synthesis(pos, neg, nside: int):
    lead = pos.shape[:-2]
    nl, nm = pos.shape[-2:]
    flat = pos.reshape((-1, nl, nm)).resolve_conj().contiguous()
    if neg is not None:
        neg = neg.reshape((-1, nl, nm - 1)).resolve_conj().contiguous()
    g = _geom_tensors(nside, flat.device)
    tpos, tneg = legendre_synth(flat, neg, g.cos_t, g.sin_t)
    maps = phase_stage_inv(tpos, tneg, nside, real=neg is None)
    out = unpad_map(maps.reshape(flat.shape[0], -1), nside)
    return out.reshape(lead + (out.shape[-1],))


def synthesis_real(alm, nside: int):
    """Inverse SHT of the m >= 0 coefficients (..., lmax+1, mmax+1) of a
    real field onto RING maps (..., npix), real (float64 for complex128)."""
    return _synthesis(alm, None, nside)


def synthesis_complex(alm_pos, alm_neg, nside: int):
    """Inverse SHT of a complex field: alm_pos (..., lmax+1, mmax+1) for
    m >= 0, alm_neg (..., lmax+1, mmax) with column j holding m = -(j+1).
    Returns complex RING maps (..., npix)."""
    return _synthesis(alm_pos, alm_neg, nside)


def sphtrans_inv_sky(alm, nside: int, device=None):
    """Inverse SHT onto real sky maps: alm [..., l, m >= 0] -> [..., pix]
    (the JAX package's ``sphtrans_inv_sky``).  ``alm`` is a tensor, or an
    array that goes to ``device`` (the card when None)."""
    return synthesis_real(as_tensor(alm, device), nside)


def pack_fftlike(pos: np.ndarray, neg: Optional[np.ndarray], lside: int) -> np.ndarray:
    """Pack (l, m>=0) and (l, m<0) blocks into the (lside+1, 2*lside+1)
    FFT-like layout (positive m at [l, m], negative at [l, 2*lside+1+m])."""
    lead = pos.shape[:-2]
    lmax_in = pos.shape[-2] - 1
    mmax_in = pos.shape[-1] - 1
    out = np.zeros(lead + (lside + 1, 2 * lside + 1), dtype=np.complex128)
    lmax_o = min(lmax_in, lside)
    mmax_o = min(mmax_in, lside)
    out[..., : lmax_o + 1, : mmax_o + 1] = pos[..., : lmax_o + 1, : mmax_o + 1]
    if neg is not None:
        for m in range(1, mmax_o + 1):
            out[..., : lmax_o + 1, -m] = neg[..., : lmax_o + 1, m - 1]
    return out
