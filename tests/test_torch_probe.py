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
