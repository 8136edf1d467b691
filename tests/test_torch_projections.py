"""driftscan_tpu_torch.ops.projections (and its pencil / linalg pieces)
against the JAX package.

Seeded numpy inputs go through the JAX function (CPU backend, native
complex) and through the port's function on CPU tensors, where the two
hand-written kernels (the sandwich K15a, the Fisher trace K15b) take their
plain versions: rel 1e-10 of max|want| in complex128, 1e-5 in complex64
(float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from driftscan_tpu.ops import fpencil as jfp
from driftscan_tpu.ops import linalg as jla
from driftscan_tpu.ops import projections as JP
from driftscan_tpu.ops import truncate as jtr
from driftscan_tpu.ops import zarray as za
from driftscan_tpu_torch.ops import fpencil, linalg, truncate
from driftscan_tpu_torch.ops import projections as TP
from driftscan_tpu_torch.util import store

DTYPES = [(np.complex128, 1e-10), (np.complex64, 1e-5)]


def _crandn(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _rdt(dtype):
    return np.float64 if dtype == np.complex128 else np.float32


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("nkl,nb", [(1, 1), (17, 3), (64, 2), (65, 1)])
def test_band_covariance_projection(dtype, rtol, nkl, nb):
    rng = np.random.default_rng(nkl + nb)
    g = _crandn(rng, (nkl, 3, 11), dtype)
    cl = rng.standard_normal((nb, 11, 3, 3)).astype(_rdt(dtype))
    got = TP.band_covariance_projection(g, cl, device="cpu")
    assert got.dtype == (torch.complex128 if dtype == np.complex128 else torch.complex64)
    _close(got, JP.band_covariance_projection(g, cl), rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("npol", [1, 4])
def test_sky_covariance_projection(dtype, rtol, npol):
    rng = np.random.default_rng(npol)
    beam = _crandn(rng, (3, 5, npol, 9), dtype)
    cl = rng.standard_normal((npol, npol, 9, 3, 3)).astype(_rdt(dtype))
    _close(TP.sky_covariance_projection(beam, cl, device="cpu"),
           JP.sky_covariance_projection(beam, cl), rtol)
    beam5 = _crandn(rng, (2, 3, 5, npol, 9), dtype)
    _close(TP.sky_covariance_projection_m(beam5, cl, device="cpu"),
           JP.sky_covariance_projection_m(beam5, cl), rtol)


def test_sandwich_takes_distinct_operands_and_indices():
    """X and Y differ and the result is not Hermitian; the index arrays
    pick each batch item's operands."""
    rng = np.random.default_rng(5)
    x = _crandn(rng, (2, 4, 3, 7))
    y = _crandn(rng, (3, 6, 2, 7))
    c = rng.standard_normal((4, 7, 3, 2))
    ix, iy, ic = [1, 0, 1, 1, 0], [2, 2, 0, 1, 1], [3, 0, 1, 2, 3]
    got = TP.sandwich(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(c), ix, iy, ic)
    want = np.stack([
        np.einsum("icl,lcd,jdl->ij", x[a], c[k], y[b].conj()) for a, b, k in zip(ix, iy, ic)
    ])
    _close(got, want, 1e-12)
    with pytest.raises(ValueError):
        TP.sandwich(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(c), [2], [0], [0])
    with pytest.raises(ValueError):
        TP.sandwich(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(c))


@pytest.mark.parametrize("shape", [
    (4, 52, 52, 8, 230), (4, 352, 352, 8, 230), (64, 44, 44, 1, 230), (1, 1, 1, 1, 3),
    (40000, 5, 5, 2, 100), (2, 65, 31, 17, 7), (3, 33, 70, 3, 19),
])
def test_sandwich_split_covers_every_chunk(shape):
    """The launch plan of the sandwich kernel: chunks of at most 16 (d, l)
    slots tile the contraction, nsplit blocks of cps chunks cover them with
    no empty block, the cluster is at most 8 wide, and the tile edge is 32
    for outputs of at most 64 x 64 (so 44 x 44 and 52 x 52 do not pay for
    64 x 64 tiles) and 64 above."""
    nb, n, m, cd, nl = shape
    plan = TP.sandwich_plan(nb, n, m, cd, nl, 132)
    assert plan.tile == (32 if max(n, m) <= 64 else 64)
    lc = TP.SANDWICH_KC // plan.dc
    assert plan.dc == min(cd, 16) and plan.dc * lc <= 16
    assert plan.nchunks == -(-nl // lc) * -(-cd // plan.dc)
    assert 1 <= plan.nsplit <= TP.SANDWICH_MAX_SPLIT
    assert plan.nsplit * plan.cps >= plan.nchunks > (plan.nsplit - 1) * plan.cps
    if shape == (4, 52, 52, 8, 230):
        assert plan.nsplit > 1  # few tiles: the chunks are shared out
    if shape == (40000, 5, 5, 2, 100):
        assert plan.nsplit == 1  # the batch alone fills the card


@pytest.mark.parametrize("sms", [1, 66, 132])
def test_sandwich_plan_never_lengthens_the_critical_path(sms):
    """The split taken is no slower, by the planner's own cost (rounds of
    blocks x (chunks a block + 2)), than the unsplit launch."""
    for nb, n, m, cd, nl in [(4, 352, 352, 8, 230), (4, 52, 52, 8, 230), (64, 44, 44, 1, 230)]:
        plan = TP.sandwich_plan(nb, n, m, cd, nl, sms)
        tiles = nb * -(-n // plan.tile) * -(-m // plan.tile)
        slots = sms * TP.SANDWICH_BLOCKS_PER_SM

        def cost(s, cps):
            return -(-tiles * s // slots) * (cps + 2)

        assert cost(plan.nsplit, plan.cps) <= cost(1, plan.nchunks)


@pytest.mark.parametrize("nm,nf", [(1, 1), (1, 8), (3, 5)])
def test_sky_pair_index_is_cached_and_ordered(nm, nf):
    """The sky forms' operand indices: item (mi, f, g) in that order takes
    beam[mi * nf + f], beam[mi * nf + g] and c[f * nf + g]; one build per
    (nm, nf, device)."""
    ix, iy, ic = TP.sky_pair_index(nm, nf, torch.device("cpu"))
    items = [(mi, f, g) for mi in range(nm) for f in range(nf) for g in range(nf)]
    assert ix.tolist() == [mi * nf + f for mi, f, g in items]
    assert iy.tolist() == [mi * nf + g for mi, f, g in items]
    assert ic.tolist() == [f * nf + g for mi, f, g in items]
    assert ix.dtype == torch.int32
    assert TP.sky_pair_index(nm, nf, torch.device("cpu"))[0] is ix


def test_sandwich_indices_checks():
    """Host index arrays are shape- and range-checked before their upload;
    index tensors on the operands' device are taken as they are (int32,
    no copy when already int32); a missing index broadcasts or raises."""
    x = torch.zeros((2, 3, 1, 4), dtype=torch.complex128)
    y = torch.zeros((3, 3, 1, 4), dtype=torch.complex128)
    c = torch.zeros((4, 4, 1, 1), dtype=torch.float64)
    ix, iy, ic = TP._sandwich_indices(x, y, c, [1, 0], np.array([2, 2]), (3, 0))
    assert [t.tolist() for t in (ix, iy, ic)] == [[1, 0], [2, 2], [3, 0]]
    assert all(t.dtype == torch.int32 for t in (ix, iy, ic))
    dev = torch.tensor([1, 1], dtype=torch.int32)
    assert TP._sandwich_indices(x, y, c, dev, dev, dev)[0] is dev
    assert TP._sandwich_indices(x, y, c, dev.long(), dev, dev)[0].dtype == torch.int32
    with pytest.raises(ValueError, match="out of range"):
        TP._sandwich_indices(x, y, c, [2, 0], [0, 0], [0, 0])
    with pytest.raises(ValueError, match="out of range"):
        TP._sandwich_indices(x, y, c, [0, 0], [0, -1], [0, 0])
    with pytest.raises(ValueError, match="shape"):
        TP._sandwich_indices(x, y, c, [0, 0], [0], [0, 0])
    with pytest.raises(ValueError, match="shape"):
        TP._sandwich_indices(x, y, c, dev, torch.tensor([0]), dev)
    with pytest.raises(ValueError, match="broadcast"):
        TP._sandwich_indices(x, y, c, None, None, None)
    one = torch.zeros((1, 3, 1, 4), dtype=torch.complex128)
    bx, by, bc = TP._sandwich_indices(x, one, c[:1], None, None, None)
    assert bx.tolist() == [0, 1] and by.tolist() == [0, 0] and bc.tolist() == [0, 0]


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_diag_noise_projection(dtype, rtol):
    rng = np.random.default_rng(7)
    ut = _crandn(rng, (3, 5, 8), dtype)
    d = rng.random((3, 8)).astype(_rdt(dtype))
    _close(TP.diag_noise_projection(ut, d, device="cpu"), JP.diag_noise_projection(ut, d), rtol)
    utm = _crandn(rng, (2, 3, 5, 8), dtype)
    _close(TP.diag_noise_projection_m(utm, d, device="cpu"),
           JP.diag_noise_projection_m(utm, d), rtol)


@pytest.mark.parametrize("trail", [(), (4,), (2, 3)])
def test_block_matvec(trail):
    rng = np.random.default_rng(8)
    mats = _crandn(rng, (3, 5, 6))
    vecs = _crandn(rng, (3, 6) + trail)
    _close(TP.block_matvec(mats, vecs, device="cpu"), JP.block_matvec(mats, vecs), 1e-12)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("k,na,nb", [(1, 1, 1), (17, 3, 2), (64, 2, 2), (65, 1, 3)])
def test_fisher_trace_block(dtype, rtol, k, na, nb):
    rng = np.random.default_rng(k)
    ca = _crandn(rng, (na, k, k), dtype)
    cb = _crandn(rng, (nb, k, k), dtype)  # not Hermitian
    w = rng.random(k).astype(_rdt(dtype))
    got = TP.fisher_trace_block(ca, cb, w, device="cpu")
    assert got.dtype == torch.complex128
    _close(got, JP.fisher_trace_block(ca, cb, w), rtol)


def test_fisher_trace_is_the_transposed_form():
    """F_ab = sum_ij w_i w_j C_a[i, j] C_b[j, i]: with a non-Hermitian C_b
    the conj(C_b[i, j]) form gives another number."""
    rng = np.random.default_rng(9)
    ca, cb = _crandn(rng, (2, 6, 6)), _crandn(rng, (2, 6, 6))
    w = rng.random(6)
    got = TP.fisher_trace(torch.as_tensor(ca), torch.as_tensor(cb), torch.as_tensor(w)).numpy()
    want = np.einsum("aij,bji,i,j->ab", ca, cb, w, w)
    other = np.einsum("aij,bij,i,j->ab", ca, cb.conj(), w, w)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.abs(got - other).max() > 1e-3 * np.abs(want).max()
    # and a batch axis
    gotm = TP.fisher_trace(
        torch.as_tensor(np.stack([ca, 2 * ca])), torch.as_tensor(np.stack([cb, cb])),
        torch.as_tensor(np.stack([w, w])),
    ).numpy()
    np.testing.assert_allclose(gotm, np.stack([want, 2 * want]), rtol=1e-12)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_block_pinv(dtype, rtol):
    rng = np.random.default_rng(10)
    mats = _crandn(rng, (3, 5, 8), dtype)
    mats[1, 3:] = 0  # a rank-deficient block
    _close(TP.block_pinv(mats, rcond=1e-6, device="cpu"), JP.block_pinv(mats, rcond=1e-6),
           max(rtol, 1e-9))


def _pencil(rng, n, posdef=True):
    a = _crandn(rng, (n, n))
    s = a @ a.conj().T
    b = _crandn(rng, (n, n + (3 if posdef else -2)))
    return s, b @ b.conj().T


def _mode_check(s, n_, w, v):
    """The pencil's residual and the N-orthonormality of the columns."""
    assert np.abs(s @ v - (n_ @ v) * w[None, :]).max() <= 1e-8 * np.abs(s).max()
    assert np.abs(v.conj().T @ n_ @ v - np.eye(len(w))).max() <= 1e-8


def test_generalised_eigh():
    rng = np.random.default_rng(11)
    s, n_ = _pencil(rng, 7)
    w, v, ac = TP.generalised_eigh(s, n_, device="cpu")
    jw, jv, jac = JP.generalised_eigh(s, n_)
    assert ac == jac == 0.0
    _close(w, jw, 1e-10)
    _mode_check(s, n_, w.numpy(), v.numpy())
    # an all-zero signal gives zeros and the identity
    w0, v0, _ = TP.generalised_eigh(np.zeros_like(s), n_, device="cpu")
    assert not w0.any() and np.array_equal(v0.numpy(), np.eye(7))


def test_generalised_eigh_regularises_an_indefinite_noise():
    rng = np.random.default_rng(12)
    s, n_ = _pencil(rng, 6, posdef=False)  # rank 4 of 6
    n_ = n_ - 0.5 * np.eye(6)  # two eigenvalues at -0.5
    w, v, ac = TP.generalised_eigh(s, n_, device="cpu")
    jw, jv, jac = JP.generalised_eigh(s, n_)
    # 1e-15 lambda_max - 2 lambda_min: the same shift in both packages
    assert ac > 1.0 and abs(ac - jac) <= 1e-10 * jac
    _close(w, jw, 1e-8)


def test_generalised_eigh_batched():
    rng = np.random.default_rng(13)
    pairs = [_pencil(rng, 5) for _ in range(3)]
    A = np.stack([p[0] for p in pairs])
    B = np.stack([p[1] for p in pairs])
    A[2] = 0
    w, v = TP.generalised_eigh_batched(A, B, device="cpu")
    jw, jv = JP.generalised_eigh_batched(A, B)
    _close(w, jw, 1e-10)
    _mode_check(A[0], B[0], w[0].numpy(), v[0].numpy())
    assert np.array_equal(v[2].numpy(), np.eye(5))


def test_inv_gen_and_pinv():
    rng = np.random.default_rng(14)
    a = _crandn(rng, (5, 5))
    _close(linalg.inv_gen(torch.as_tensor(a)), jla.inv_gen(a), 1e-10)
    sing = a.copy()
    sing[4] = sing[0]
    _close(linalg.inv_gen(torch.as_tensor(sing)), np.linalg.pinv(sing), 1e-6)
    r = rng.standard_normal((4, 4))
    r = r @ r.T
    _close(linalg.pinv(torch.as_tensor(r), rcond=1e-8), jla.pinv(r, rcond=1e-8), 1e-10)


def _factor_inputs(seed, M=2, F=2, S=4, npol=1, nl=9, K=2):
    rng = np.random.default_rng(seed)
    bsvd = _crandn(rng, (M, F, S, npol, nl))
    bsvd[:, :, -1] = 0  # an svcut-masked row
    ls = rng.standard_normal((nl, npol, F, K)) * 0.7
    lf = rng.standard_normal((nl, npol, F, K)) * 30.0
    return bsvd, ls, lf


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(fg_reg_rel=1e-6),
    dict(nc=2.5e-3, fg_reg_rel=1e-14),
    dict(with_thermal=False, fg_floor=1e-4),
])
def test_kl_factored_batched(kw, compact):
    """The file path's pencil settings (noise scale, regulariser, the
    thermal-free floor) against the JAX program.  With the full signal
    factor every eigenvalue agrees.  With the compact one (the K9 Gram
    re-factored through a Cholesky ladder whose first shift is 1e-10 of
    the mean diagonal of S) the genuine modes agree the same, and the
    zero cluster of the svcut-masked rows, exactly 0 in the JAX program,
    comes out at that shift over the noise scale."""
    bsvd, ls, lf = _factor_inputs(21)
    nzero = bsvd.shape[1]  # one masked row per frequency
    ev, vec = TP.kl_factored_batched(bsvd, ls, lf, device="cpu", compact=compact, **kw)
    jev, jvec = JP.kl_factored_batched(bsvd, ls, lf, **kw)
    jev = np.asarray(jev)
    lo = nzero if compact else 0
    np.testing.assert_allclose(ev.numpy()[:, lo:], jev[:, lo:], rtol=0, atol=1e-8 * jev.max())
    assert (np.abs(jev[:, :nzero]) <= 1e-12 * jev.max()).all()
    if compact:
        a_s = fpencil.beam_factor(torch.as_tensor(bsvd), ls)
        shift = 1e-10 * float((a_s.abs() ** 2).sum((-2, -1)).max()) / a_s.shape[-2]
        assert (ev.numpy()[:, :nzero] >= 0).all()
        assert ev.numpy()[:, :nzero].max() <= 4 * shift / kw.get("nc", 1.0)
    # the retained eigenvectors span the same modes: compare projectors
    # of the top half, which is free of the zero cluster
    k = ev.shape[1] // 2
    for m in range(ev.shape[0]):
        p = vec[m].numpy()[:, -k:]
        q = np.asarray(jvec)[m][:, -k:]
        _close(p @ np.linalg.pinv(p), q @ np.linalg.pinv(q), 1e-6)


def test_kl_solve_defaults_are_the_resident_pencil():
    """with_thermal, no regulariser: bit for bit what the resident path
    solved before the file path's options came."""
    bsvd, ls, lf = _factor_inputs(22)
    b = torch.as_tensor(bsvd)
    a_s, a_f = fpencil.beam_factor(b, ls), fpencil.beam_factor(b, lf)
    want = fpencil.pencil_solve_qr(a_s, fpencil._thermal_noise_rows(a_f, 1.0))
    got = fpencil.kl_solve(a_s, a_f)
    assert torch.equal(got.evals, want.evals) and torch.equal(got.evecs, want.evecs)


def test_spectral_norm_matches_jax():
    rng = np.random.default_rng(23)
    a = _crandn(rng, (6, 15))
    want = float(jfp._spectral_norm_sq(za.Z(a.real, a.imag)))
    got = float(fpencil._spectral_norm_sq(torch.as_tensor(a)))
    assert abs(got - want) <= 1e-10 * want
    assert 0.5 * np.linalg.norm(a, 2) ** 2 <= got <= 1.0001 * np.linalg.norm(a, 2) ** 2


@pytest.mark.parametrize("nc1", [None, 4e-4])
def test_doublekl_factored_batched(nc1):
    bsvd, ls, lf = _factor_inputs(24)
    lf = lf * 1e-3  # so that some S/F ratios pass the stage-1 cut
    kw = dict(nc1=nc1, fg_threshold=5.0)
    f_ev, ev, vec, nk = TP.doublekl_factored_batched(bsvd, ls, lf, device="cpu", **kw)
    jf, je, jv, jn = JP.doublekl_factored_batched(bsvd, ls, lf, **kw)
    assert nk.tolist() == np.asarray(jn).tolist() and 0 < nk.min() < ev.shape[1]
    np.testing.assert_allclose(f_ev.numpy(), np.asarray(jf), rtol=0,
                               atol=1e-7 * np.asarray(jf).max())
    np.testing.assert_allclose(ev.numpy(), np.asarray(je), rtol=0,
                               atol=1e-7 * np.asarray(je).max())
    assert vec.shape == np.asarray(jv).shape


def test_topband_dispatchers_name_their_roadmap_line():
    """The top-band dispatchers are ported: each returns its per-m
    certificate (their parity is in tests/test_torch_topband*.py).  Device
    meshes are ported (tests/test_torch_mesh_pipeline.py): a ``mesh`` that
    is not a ``Mesh`` raises TypeError, and a one-entry mesh takes the
    unsharded path, bit for bit.  The ``gram`` engine runs through
    ``kl_factored_batched`` as in the JAX package."""
    from driftscan_tpu_torch.parallel import mesh as meshmod

    bsvd, ls, lf = _factor_inputs(24)
    lf = lf * 1e-3
    one = meshmod.make_mesh(["cpu"])
    for fn, kw in ((TP.kl_factored_batched_topband, {}),
                   (TP.doublekl_factored_batched_topband, dict(fg_threshold=5.0))):
        out = fn(bsvd, ls, lf, cut=1e-3, device="cpu", **kw)
        ok = out[-1]
        assert ok.dtype == torch.bool and ok.shape == (bsvd.shape[0],)
        assert out[0].shape == (bsvd.shape[0], bsvd.shape[1] * bsvd.shape[2])
        with pytest.raises(TypeError, match="Mesh"):
            fn(bsvd, ls, lf, cut=1e-3, device="cpu", mesh=object())
        for a, b in zip(out, fn(bsvd, ls, lf, cut=1e-3, device="cpu", mesh=one, **kw)):
            assert torch.equal(a, b)
    ev, _ = TP.kl_factored_batched(bsvd, ls, lf, method="gram", device="cpu")
    jev, _ = JP.kl_factored_batched(bsvd, ls, lf, method="gram")
    _close(ev, np.asarray(jev), 1e-10)


def test_triple_svd_file_cuts_keep_faint_modes():
    """The file pipeline's SVD keeps modes down to 1e-13 of the top (the
    svcut is applied when modes are counted); the resident path's default
    cuts at 1e-5."""
    rng = np.random.default_rng(25)
    u, _ = np.linalg.qr(_crandn(rng, (6, 6)))
    v, _ = np.linalg.qr(_crandn(rng, (9, 6)))
    s = np.array([1.0, 0.5, 1e-3, 3e-6, 1e-9, 0.0])
    b = torch.as_tensor((u * s) @ v.conj().T)[None]
    *_, sig, nm = TP.triple_svd(b, npol=1, nl=9, polsvcut=1e-4, device="cpu")
    jout = JP.triple_svd(b.numpy(), npol=1, nl=9, polsvcut=1e-4)
    assert int(nm) == int(jout[3][0]) == 5
    _close(sig, jout[2], 1e-10)
    assert int(linalg.triple_svd_batched(b, npol=1, nl=9)[3]) == 3


def test_bit_truncation_matches_jax():
    rng = np.random.default_rng(26)
    a = _crandn(rng, (5, 40)) * np.logspace(-8, 2, 40)
    want = jtr.bit_truncate_max_complex(a.copy(), 1e-7, 1e-8)
    got = truncate.bit_truncate_max_complex(a.copy(), 1e-7, 1e-8)
    assert np.array_equal(got, want)
    assert 0 < np.abs(got - a).max() <= 1e-7 * np.abs(a).max()
    # the numpy version rounds onto the same grid as the compiled one
    mag = np.abs(a)
    tol = np.maximum(1e-7 * mag, 1e-8 * mag.max(axis=-1, keepdims=True))
    plain = truncate._round_to_grid(a.real, tol) + 1j * truncate._round_to_grid(a.imag, tol)
    assert np.array_equal(plain, got)


def test_products_from_numpy():
    rng = np.random.default_rng(27)
    t = TP.products_from_numpy(
        "cpu", torch.complex64, beam_svd=_crandn(rng, (2, 3, 1, 4)),
        evals=rng.random(5), idx=np.arange(3),
    )
    assert t["beam_svd"].dtype == torch.complex64 and t["evals"].dtype == torch.float32
    assert t["idx"].dtype == torch.int64 and all(v.device.type == "cpu" for v in t.values())


def test_directory_store_round_trip(tmp_path):
    """The ``.npy`` tree that stands in for HDF5 where h5py is missing."""
    path = str(tmp_path / "x.hdf5")
    data = _crandn(np.random.default_rng(28), (3, 4))
    with store._NpyFile(path, "w") as f:
        f.create_dataset("a", data=data, compression="lzf")
        d = f.create_dataset("b", (2, 2), dtype=np.float64, chunks=(1, 2))
        d[:] = 3.0
        f.attrs["m"] = 4
        f.attrs["frequencies"] = np.arange(3.0)
        f.attrs["bandtype"] = np.bytes_("polar")
    with store._NpyFile(path, "r") as f:
        assert "a" in f and "c" not in f
        assert np.array_equal(f["a"][:], data) and np.array_equal(f["a"][1], data[1])
        assert f["b"].shape == (2, 2) and (f["b"][:] == 3.0).all()
        assert f.attrs["m"] == 4 and f.attrs["bandtype"] == b"polar"
        assert np.array_equal(f.attrs["frequencies"], np.arange(3.0))
    with pytest.raises(RuntimeError):
        with store._NpyFile(path, "w") as f:
            raise RuntimeError("a failed write leaves the old file")
    with store._NpyFile(path, "r") as f:
        assert "a" in f
    assert store.readable(path) is (store.BACKEND == "npy")
    store.remove(path)
    assert not store.readable(path)
