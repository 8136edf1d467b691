"""The port of the two ``pl.pallas_call`` probes against their JAX operations.

``scratch/pallas_probe.py`` defines its Pallas kernels ``double`` (o = 2 x)
and ``mm`` (a tiled matmul with float32 accumulation) inside ``main()``,
so they cannot be imported without editing that file; these tests hold
the port's plain versions (``ops.probe.double_ref`` / ``mm_ref``, which
the wrappers take for CPU tensors) against the operations those kernels
compute: ``x * 2`` and ``jnp.dot(a, b, preferred_element_type=float32)``,
at the probe's shapes.  The CUDA kernels are held against the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driftscan_tpu_torch.ops import probe

N = 1024


def test_double_matches_x_times_two():
    x = np.arange(N * N, dtype=np.float32).reshape(N, N)
    got = probe.double(torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (N, N)
    np.testing.assert_array_equal(got.numpy(), x * 2.0)
    assert probe.PROBE_DOUBLE.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 1e-5)])
def test_mm_matches_jnp_dot(dtype, rtol):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    ja = jnp.asarray(a, dtype=getattr(jnp, dtype))
    jb = jnp.asarray(b, dtype=getattr(jnp, dtype))
    want = np.asarray(jnp.dot(ja, jb, preferred_element_type=jnp.float32))
    ta = torch.as_tensor(np.array(ja.astype(jnp.float32))).to(getattr(torch, dtype))
    tb = torch.as_tensor(np.array(jb.astype(jnp.float32))).to(getattr(torch, dtype))
    got = probe.mm(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (N, N)
    # both accumulate exact products in float32; only the order differs
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * np.abs(want).max())
    assert probe.PROBE_MM.launches == 0


def test_mm_ref_keeps_tf32_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    probe.mm_ref(torch.ones((2, 3)), torch.ones((3, 4)))
    assert torch.backends.cuda.matmul.allow_tf32 == before


# mm_plan: the host's choice of route and tile width for csrc/probe.cu


@pytest.mark.parametrize(
    "M,N,K,dtype,strides,ptr_align,route",
    [
        (1024, 1024, 1024, torch.bfloat16, (1024, 1024), 16, "tma"),
        (1024, 1024, 1024, torch.float32, (1024, 1024), 16, "tma"),
        (256, 192, 1000, torch.bfloat16, (1000, 192), 16, "tma"),  # 2000-byte rows
        # rows of 140 / 194 bytes (bfloat16) and 280 / 388 (float32)
        (130, 97, 70, torch.bfloat16, (70, 97), 16, "staged"),
        (130, 97, 70, torch.float32, (70, 97), 16, "staged"),
        (256, 256, 1002, torch.float32, (1002, 256), 16, "staged"),  # A's rows only
        # aligned strides, a pointer off 16-byte alignment
        (1024, 1024, 1024, torch.bfloat16, (1024, 1024), 2, "staged"),
        (1024, 1024, 1024, torch.float32, (1024, 1024), 4, "staged"),
        (1024, 1024, 1024, torch.float32, (1024, 1024), 8, "staged"),
    ],
)
def test_mm_plan_route(M, N, K, dtype, strides, ptr_align, route):
    assert probe.mm_plan(M, N, K, dtype, strides, ptr_align, 132).route == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sms,nw,blocks", [(132, 64, 128), (114, 128, 64)])
def test_mm_plan_tile_follows_sm_count(dtype, sms, nw, blocks):
    """At the probe's 1024^3, 132 SMs take 64-wide tiles (128 blocks, one
    wave; 128-wide tiles would leave 68 SMs idle) and 114 SMs 128-wide
    ones (64 blocks in one wave rather than 128 blocks in two)."""
    plan = probe.mm_plan(N, N, N, dtype, (N, N), 16, sms)
    assert (plan.route, plan.nw, plan.blocks) == ("tma", nw, blocks)
    assert plan.grid == (N // nw, N // probe.MM_ROWS)


@pytest.mark.parametrize("M,N,K", [(1024, 1024, 1024), (130, 97, 70), (200, 456, 264),
                                   (64, 128, 16), (4096, 4096, 4096)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mm_plan_grid_covers_output(M, N, K, dtype):
    """The grid's tiles cover C exactly once over (float32: C^T's) rows and
    columns, with a width the kernel has."""
    plan = probe.mm_plan(M, N, K, dtype, (K, N), 16, 132)
    rows, cols = (N, M) if dtype == torch.float32 else (M, N)
    assert plan.nw in probe.MM_WIDTHS[dtype]
    assert plan.grid == (-(-cols // plan.nw), -(-rows // probe.MM_ROWS))


def test_mm_plan_large_shapes():
    """At 4096^3 the tiles widen to the kernel's widest (bfloat16 256,
    float32 128)."""
    bf = probe.mm_plan(4096, 4096, 4096, torch.bfloat16, (4096, 4096), 16, 132)
    assert (bf.nw, bf.blocks) == (256, 512)
    f32 = probe.mm_plan(4096, 4096, 4096, torch.float32, (4096, 4096), 16, 132)
    assert (f32.nw, f32.blocks) == (128, 1024)


@pytest.mark.parametrize("ptrs,align", [((0x1000, 0x2000), 16), ((0x1000, 0x1004), 4),
                                        ((0x1002, 0x1000), 2), ((0x1008,), 8)])
def test_align(ptrs, align):
    assert probe._align(*ptrs) == align


def test_double_odd_count_and_view_on_cpu():
    """The plain version takes CPU tensors of any count and offset."""
    base = torch.arange(1001 * 999 + 1, dtype=torch.float32)
    x = base[1:]
    np.testing.assert_array_equal(probe.double(x).numpy(), x.numpy() * 2.0)
