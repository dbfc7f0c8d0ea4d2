"""The general-shape stencil kernels' CPU side: the plain version they are
held to on the card, against the JAX package at shapes only the general
kernels take (rows of 1, 2, 3, 97 and 100 points), and the launch
geometry the wrapper hands them.  The kernels themselves run only on the
card (chip_smoke.py, tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.ops import stencil as jst
from iemic_tpu.ops.stencil_pallas import apply_stencil_pallas

from iemic_tpu_torch.ops import stencil_hopper

# (l, m, n): n = 1 and n = 2 fold the three di onto one or two columns
# when periodic; 97 is odd, and 100 is a whole number of f32 vectors but
# not of bf16 ones
SHAPES = [(2, 3, 1), (2, 3, 2), (2, 3, 3), (3, 5, 97), (2, 3, 100)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch and the BLAS and OpenMP pools on one thread in this module,
    as tests/test_torch_topo.py does: small problems, shared cores."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _inputs(shape, seed=21):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((27, 6, 6, *shape)),
            rng.standard_normal((6, *shape)))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas(shape, dtype, periodic):
    """prepare + the plain version against the Pallas kernel in interpret
    mode: f32 accumulation in another order, so rtol/atol 2e-5."""
    An, x = _inputs(shape)
    y_ref = np.asarray(apply_stencil_pallas(
        jnp.asarray(An), jnp.asarray(x), periodic=periodic,
        interpret=True, dtype=getattr(jnp, dtype)))
    AnK = stencil_hopper.prepare(torch.as_tensor(An), getattr(torch, dtype))
    y = stencil_hopper.apply_stencil_prepared(
        AnK, torch.as_tensor(x), periodic=periodic)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_f64(shape, periodic):
    """The f32 plain version against the JAX package's f64 operator, to
    2e-5 of the largest output (f32 coefficients and sums)."""
    An, x = _inputs(shape)
    y_ref = np.asarray(jst.apply_stencil(jnp.asarray(An), jnp.asarray(x),
                                         periodic=periodic))
    y = stencil_hopper.apply_stencil_prepared(
        stencil_hopper.prepare(torch.as_tensor(An)), torch.as_tensor(x),
        periodic=periodic).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=2e-5 * np.abs(y_ref).max())


@pytest.mark.parametrize("dtype,entry", [
    (torch.float32, "stencil_matvec_f32_wide"),
    (torch.bfloat16, "stencil_matvec_bf16")])
def test_row_of_100_takes_general_kernel_in_bf16_only(dtype, entry):
    """A row of 100 points is 25 f32 vectors of 16 bytes but 12.5 bf16
    ones."""
    assert stencil_hopper.kernel_variant(dtype, 12, 38, 100) == entry


def _plan(l, m, n, periodic):
    """What the launch of general_launch(l, m, n) does, point by point:
    how often each (A, point) is owned, and the coefficients its loads
    read (the kernel's predicates: those whose neighbour lies in the
    grid)."""
    blocks, threads, points = stencil_hopper.general_launch(l, m, n)
    N = l * m * n
    warps = threads // stencil_hopper.WARP
    rows = 6 // warps
    b, t, h, r = np.meshgrid(np.arange(blocks), np.arange(threads),
                             np.arange(points), np.arange(rows),
                             indexing="ij")
    lane, warp = t % stencil_hopper.WARP, t // stencil_hopper.WARP
    e = (b * stencil_hopper.WARP + lane) * points + h
    A = warp * rows + r
    inside = e < N
    owned = np.zeros((6, N), np.int64)
    np.add.at(owned, (A[inside], e[inside]), 1)

    pt = np.arange(N)
    i, j, k = pt % n, pt // n % m, pt // n // m
    di_read = 1 + ((i > 0) | periodic) + ((i < n - 1) | periodic)
    reads = np.zeros(N, np.int64)
    for dk in (0, -1, 1):
        for dj in (-1, 0, 1):
            ok = (k + dk >= 0) & (k + dk < l) & (j + dj >= 0) & (j + dj < m)
            reads += np.where(ok, 6 * di_read, 0)
    return owned, int((owned * reads).sum())


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(12, 38, 97)])
def test_general_launch_owns_each_output_once(shape, periodic):
    """Every (A, point) pair is owned by exactly one (block, thread,
    point) of the launch, and the coefficient reads its predicates allow
    are the ones the kernels' bound counts."""
    owned, reads = _plan(*shape, periodic)
    assert (owned == 1).all()
    assert reads == stencil_hopper.needed_coefficients(*shape, periodic)
