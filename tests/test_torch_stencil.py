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


# the sub-block kernel's dispatch: type, (a, b), grid -> entry point and
# layout.  The row layout wants a grid row of n a whole number of 16-byte
# vectors (4 points in f32, 2 in f64).
BLOCK_VARIANTS = [
    ("float32", (2, 2), (12, 38, 96), "stencil_block_f32", True),
    ("float32", (2, 1), (12, 38, 97), "stencil_block_f32", False),
    ("float32", (1, 2), (3, 5, 7), "stencil_block_f32", False),
    ("float32", (3, 3), (1, 2, 2), "stencil_block_f32", False),
    ("float64", (2, 2), (12, 32, 64), "stencil_block_f64", True),
    ("float64", (1, 1), (3, 5, 7), "stencil_block_f64", False),
    ("float64", (4, 2), (2, 3, 2), "stencil_block_f64", True),
    ("float64", (2, 4), (1, 1, 1), "stencil_block_f64", False),
]


@pytest.mark.parametrize("dtype,ab,shape,entry,row", BLOCK_VARIANTS)
def test_block_variant(dtype, ab, shape, entry, row):
    """The entry point and layout of a sub-block product are a pure
    function of type, shape and A's alignment: A one element off its
    16-byte boundary takes the general layout, and a block whose (p, a,
    b) strides are permuted (the rho/mu transform's einsum) but whose
    planes are contiguous keeps the row layout."""
    t = getattr(torch, dtype)
    A = torch.zeros((27, *ab, *shape), dtype=t)
    x = torch.zeros((ab[1], *shape), dtype=t)
    assert stencil_hopper.block_variant(A, x) == (entry, row)
    assert entry in stencil_hopper.BLOCK_ENTRIES
    off = torch.zeros(A.numel() + 1, dtype=t)[1:].view_as(A)
    assert stencil_hopper.block_variant(off, x) == (entry, False)
    perm = torch.zeros((ab[0], 27, ab[1], *shape), dtype=t).movedim(1, 0)
    assert stencil_hopper.block_variant(perm, x) == (entry, row)


def test_block_variant_refuses():
    """What the kernel does not take raises, on the CPU as on the card:
    another type (no fall-back to the plain version), two types, a shape
    it is not built for, an x that does not match, planes that are not
    contiguous; and apply_block refuses a tensor on neither the CPU nor
    a CUDA device."""
    f32 = torch.zeros((27, 2, 2, 3, 4, 8))
    x = torch.zeros((2, 3, 4, 8))
    for t in (torch.bfloat16, torch.float16, torch.int64):
        with pytest.raises(TypeError):
            stencil_hopper.block_variant(f32.to(t), x.to(t))
    with pytest.raises(TypeError):
        stencil_hopper.block_variant(f32, x.double())
    for ab in ((6, 6), (5, 1), (1, 3)):
        with pytest.raises(ValueError):
            stencil_hopper.block_variant(torch.zeros((27, *ab, 3, 4, 8)),
                                         torch.zeros((ab[1], 3, 4, 8)))
    with pytest.raises(ValueError):
        stencil_hopper.block_variant(f32, x[:1])
    with pytest.raises(ValueError):
        stencil_hopper.block_variant(f32.transpose(-1, -2),
                                     x.transpose(-1, -2))
    with pytest.raises(ValueError):
        stencil_hopper.apply_block(f32.to("meta"), x.to("meta"),
                                   periodic=False)


def test_launch_counters_cover_both_kernels():
    """``launches_by_entry`` reads every entry point of both kernels, the
    ranks' job returns it, and ``reset_launches`` zeroes both counters."""
    from iemic_tpu_torch.main import multichip
    stencil_hopper.LAUNCHES_BY_ENTRY["stencil_matvec_f32_wide"] += 2
    stencil_hopper.BLOCK_LAUNCHES["stencil_block_f64"] += 3
    counts = multichip.job_launches("cpu")
    assert set(counts) == set(stencil_hopper.ENTRIES) | set(
        stencil_hopper.BLOCK_ENTRIES)
    assert counts["stencil_block_f64"] >= 3
    assert counts["stencil_matvec_f32_wide"] >= 2
    stencil_hopper.reset_launches()
    assert not any(stencil_hopper.launches_by_entry().values())


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("ab", stencil_hopper.BLOCK_SHAPES)
def test_whole_st_on_cpu_is_the_plain_expression(ab, periodic):
    """On CPU tensors ``mg.Whole.st`` is the plain expression, bit for
    bit, with its own windows and with windows shared from
    ``Whole.windows``, and launches nothing; the f64 product agrees with
    the JAX package's sub-block product (``_block_apply``'s
    apply_stencil) to f64 round-off of 27 b-term sums."""
    from iemic_tpu_torch.solvers.mg import Whole
    rng = np.random.default_rng(5)
    a, b = ab
    A = rng.standard_normal((27, a, b, 3, 5, 7))
    x = rng.standard_normal((b, 3, 5, 7))
    g = Whole(periodic)
    before = dict(stencil_hopper.BLOCK_LAUNCHES)
    for t in (torch.float64, torch.float32):
        At, xt = torch.as_tensor(A, dtype=t), torch.as_tensor(x, dtype=t)
        ref = (At * tst.windows(xt, periodic).unsqueeze(1)).sum(dim=(0, 2))
        w = g.windows(xt)
        assert torch.equal(w, tst.windows(xt, periodic))
        assert torch.equal(g.st(At, xt), ref)
        assert torch.equal(g.st(At, xt, w), ref)
    assert stencil_hopper.BLOCK_LAUNCHES == before
    y_ref = np.asarray(jst.apply_stencil(jnp.asarray(A), jnp.asarray(x),
                                         periodic=periodic))
    y = g.st(torch.as_tensor(A), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-13,
                               atol=1e-13 * np.abs(y_ref).max())
