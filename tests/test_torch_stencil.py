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


# (l, m, n): 8 is a whole number of coefficient vectors in f32 and bf16,
# 12 (the width of a 2DMOC-like grid row times four) in f32 only, 3 (the
# 2DMOC fixture's n) and 5 in neither
VARIANTS = [
    ("float32", (4, 8, 8), "stencil_matvec_f32_wide"),
    ("float32", (12, 38, 96), "stencil_matvec_f32_wide"),
    ("float32", (2, 3, 12), "stencil_matvec_f32_wide"),
    ("float32", (1, 1, 4), "stencil_matvec_f32_wide"),
    ("float32", (6, 6, 3), "stencil_matvec_f32"),
    ("float32", (12, 38, 97), "stencil_matvec_f32"),
    ("float32", (4, 8, 5), "stencil_matvec_f32"),
    ("float32", (1, 1, 1), "stencil_matvec_f32"),
    ("bfloat16", (4, 8, 8), "stencil_matvec_bf16_wide"),
    ("bfloat16", (12, 38, 96), "stencil_matvec_bf16_wide"),
    ("bfloat16", (2, 3, 12), "stencil_matvec_bf16"),
    ("bfloat16", (4, 8, 4), "stencil_matvec_bf16"),
    ("bfloat16", (6, 6, 3), "stencil_matvec_bf16"),
    ("bfloat16", (12, 38, 97), "stencil_matvec_bf16"),
]


@pytest.mark.parametrize("dtype,shape,entry", VARIANTS)
def test_kernel_variant(dtype, shape, entry):
    """Which library entry point a call takes is a pure function of the
    coefficient type and the grid: the wide kernel where a grid row is a
    whole number of 16-byte coefficient vectors."""
    got = stencil_hopper.kernel_variant(getattr(torch, dtype), *shape)
    assert got == entry and got in stencil_hopper.ENTRIES


def test_kernel_variant_refuses_other_types():
    with pytest.raises(TypeError):
        stencil_hopper.kernel_variant(torch.float64, 4, 8, 8)
    with pytest.raises(ValueError):
        stencil_hopper.kernel_variant(torch.float32, 4, 0, 8)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 16), (3, 5, 7)])
def test_kernel_plain_matches_pallas_shapes(shape, dtype, periodic):
    """The plain version against the Pallas kernel in interpret mode at
    a shape the wide kernel takes (n = 16) and one it refuses (n = 7):
    f32 accumulation in another order, so rtol/atol 2e-5."""
    An, x = _inputs(9, *shape)
    y_ref = np.asarray(apply_stencil_pallas(
        jnp.asarray(An), jnp.asarray(x), periodic=periodic,
        interpret=True, dtype=getattr(jnp, dtype)))
    AnK = stencil_hopper.prepare(torch.as_tensor(An), getattr(torch, dtype))
    y = stencil_hopper.apply_stencil_prepared(
        AnK, torch.as_tensor(x), periodic=periodic)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-5, atol=2e-5)


def edge_columns(x):
    """x kept on the i = 0 and i = n-1 columns only, zero elsewhere: a
    wrong wrap or a wrong zero boundary in i then changes every nonzero
    term of the product."""
    out = np.zeros_like(x)
    out[..., 0] = x[..., 0]
    out[..., -1] = x[..., -1]
    return out


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", [(4, 8, 8), (3, 5, 7)])
def test_kernel_plain_edge_columns_match_jax(shape, periodic):
    """Edge-column input through the plain version against the JAX
    package's f64 operator; the periodic and the closed result differ,
    and only in the columns next to the edges."""
    An, x = _inputs(13, *shape)
    x = edge_columns(x)
    y_ref = np.asarray(jst.apply_stencil(jnp.asarray(An), jnp.asarray(x),
                                         periodic=periodic))
    AnK = stencil_hopper.prepare(torch.as_tensor(An), torch.float32)
    y = stencil_hopper.apply_stencil_prepared(
        AnK, torch.as_tensor(x), periodic=periodic).numpy()
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=2e-5 * scale)
    other = stencil_hopper.apply_plain(
        AnK, torch.as_tensor(x), periodic=not periodic).numpy()
    assert np.abs(other - y).max() > 1e-2 * scale
    assert np.array_equal(other[..., 2:-2], y[..., 2:-2])


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
