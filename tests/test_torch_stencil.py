"""Port parity: the stencil operator and the Hopper kernel's plain
version against the JAX package (f64 XLA operator, Pallas kernel in
interpret mode), on CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.ops import stencil as jst
from iemic_tpu.ops.stencil_pallas import apply_stencil_pallas

from iemic_tpu_torch.ops import stencil as tst
from iemic_tpu_torch.ops import stencil_hopper


def _inputs(seed, l=4, m=8, n=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((27, 6, 6, l, m, n)),
            rng.standard_normal((6, l, m, n)))


@pytest.mark.parametrize("periodic", [False, True])
def test_apply_stencil_f64_matches_jax(periodic):
    An, x = _inputs(0)
    y_ref = np.asarray(jst.apply_stencil(jnp.asarray(An), jnp.asarray(x),
                                         periodic=periodic))
    y = tst.apply_stencil(torch.as_tensor(An), torch.as_tensor(x),
                          periodic=periodic).numpy()
    # f64, another summation order: round-off of 162-term sums
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y, y_ref, rtol=1e-13, atol=1e-13 * scale)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_plain_matches_pallas(periodic, dtype):
    """prepare + the kernel's plain version (what a CPU tensor takes)
    against the Pallas kernel in interpret mode: f32 accumulation in
    another order, so rtol/atol 2e-5."""
    An, x = _inputs(3)
    y_ref = np.asarray(apply_stencil_pallas(
        jnp.asarray(An), jnp.asarray(x), periodic=periodic,
        interpret=True, dtype=getattr(jnp, dtype)))
    AnK = stencil_hopper.prepare(torch.as_tensor(An),
                                 getattr(torch, dtype))
    assert AnK.dtype == getattr(torch, dtype) and AnK.is_contiguous()
    before = stencil_hopper.LAUNCHES
    y = stencil_hopper.apply_stencil_prepared(
        AnK, torch.as_tensor(x), periodic=periodic)
    assert y.dtype == torch.float32
    assert stencil_hopper.LAUNCHES == before      # CPU: no kernel launch
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-5, atol=2e-5)


def test_flat_roundtrip():
    rng = np.random.default_rng(5)
    l, m, n = 3, 4, 5
    x = rng.standard_normal((6, l, m, n))
    xt = torch.as_tensor(x)
    flat = tst.to_flat(xt)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jst.to_flat(jnp.asarray(x))))
    np.testing.assert_array_equal(tst.from_flat(flat, l, m, n).numpy(), x)


def test_stencil_to_csr_matches_jax():
    An, _ = _inputs(7, l=2, m=3, n=3)
    An[np.abs(An) < 0.5] = 0.0
    for periodic in (False, True):
        ref = jst.stencil_to_csr(An, periodic=periodic)
        got = tst.stencil_to_csr(torch.as_tensor(An), periodic=periodic)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
