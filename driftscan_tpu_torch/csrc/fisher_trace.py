"""K15b: the weighted Fisher trace F_ab = sum_ij w_i w_j C_a[i,j] C_b[j,i] (Triton).

Replaces the JAX program ``driftscan_tpu/ops/projections.py``
``_fisher_trace_native`` (with the host-side weighting of
``fisher_trace_block``) and the tail of ``driftscan_tpu/parallel/mstep.py``
``fisher_step_split``.  Plain version:
``driftscan_tpu_torch.ops.projections.fisher_trace_ref``.

The JAX program scales C_a by w_i w_j into a new array, transposes C_b
into another and multiplies the two flattened (bands, k^2) matrices: a
matmul is how XLA spells a reduction over k^2 for each band pair.  With
single-digit band counts no tile of it fills a tensor-core instruction,
so this is a fused elementwise pass and a reduction.  Grid (band pairs,
batch items): one program owns one F[m, a, b], walks C_a in (32, 32)
tiles, reads the matching tile of C_b at the transposed position,
multiplies by the weights and accumulates in float64 whatever the input
type.  Neither the weighted C_a nor a transposed C_b is ever written, and
each output has one writer, so the sums have a fixed order.

What bounds it on an H100: memory bandwidth (each C read once per pair it
enters; 8 flops per 2 complex numbers read).

This module imports ``triton`` at the top: import it only from the
launching function.
"""

import triton
import triton.language as tl

BLOCK = 32


@triton.jit
def _fisher_trace_kernel(ca_ptr, cb_ptr, w_ptr, out_ptr, na, nb, k,
                         BLOCK: tl.constexpr):
    pair = tl.program_id(0)
    m = tl.program_id(1).to(tl.int64)
    a = (pair // nb).to(tl.int64)
    b = (pair % nb).to(tl.int64)
    # k may arrive specialised to a constant: widen it through a tensor
    kk = (m * 0 + k) * k
    # interleaved (re, im) planes
    ca = ca_ptr + (m * na + a) * kk * 2
    cb = cb_ptr + (m * nb + b) * kk * 2
    wp = w_ptr + m * k

    acc_re = tl.zeros((BLOCK, BLOCK), dtype=tl.float64)
    acc_im = tl.zeros((BLOCK, BLOCK), dtype=tl.float64)
    for i0 in range(0, k, BLOCK):
        ii = i0 + tl.arange(0, BLOCK)
        mi = ii < k
        wi = tl.load(wp + ii, mask=mi, other=0.0).to(tl.float64)
        for j0 in range(0, k, BLOCK):
            jj = j0 + tl.arange(0, BLOCK)
            mj = jj < k
            wj = tl.load(wp + jj, mask=mj, other=0.0).to(tl.float64)
            msk = mi[:, None] & mj[None, :]
            off_a = (ii[:, None].to(tl.int64) * k + jj[None, :]) * 2
            off_b = (jj[None, :].to(tl.int64) * k + ii[:, None]) * 2  # C_b[j, i]
            ar = tl.load(ca + off_a, mask=msk, other=0.0).to(tl.float64)
            ai = tl.load(ca + off_a + 1, mask=msk, other=0.0).to(tl.float64)
            br = tl.load(cb + off_b, mask=msk, other=0.0).to(tl.float64)
            bi = tl.load(cb + off_b + 1, mask=msk, other=0.0).to(tl.float64)
            ww = wi[:, None] * wj[None, :]
            acc_re += ww * (ar * br - ai * bi)
            acc_im += ww * (ar * bi + ai * br)
    re = tl.sum(tl.sum(acc_re, axis=1), axis=0)
    im = tl.sum(tl.sum(acc_im, axis=1), axis=0)
    op = out_ptr + ((m * na + a) * nb + b) * 2
    tl.store(op, re)
    tl.store(op + 1, im)


def launch(ca, cb, w, out, M, na, nb, k):
    """ca (M, na, k, k, 2), cb (M, nb, k, k, 2) real views of the complex
    stacks, w (M, k) real, out (M, na, nb, 2) float64."""
    _fisher_trace_kernel[(na * nb, M)](
        ca, cb, w, out, na, nb, k, BLOCK=BLOCK, num_warps=4,
    )
