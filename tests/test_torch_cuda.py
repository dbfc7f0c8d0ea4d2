"""The port on the card: the Hopper stencil kernel and the CUDA-graphed
BGS sweep against their eager PyTorch versions.  This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py imports JAX).  Without a CUDA device every test
skips."""

import os

import numpy as np
import pytest
import torch

from iemic_tpu_torch import interop
from iemic_tpu_torch.models.ocean import Ocean
from iemic_tpu_torch.ops import stencil_hopper
from iemic_tpu_torch.solvers import bgs, mg

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")

needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device (run on the card)")


@pytest.mark.cuda
@needs_card
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card: f32
    accumulation in another order, so rtol/atol 2e-5."""
    rng = np.random.default_rng(11)
    An = rng.standard_normal((27, 6, 6, 4, 8, 8))
    x = torch.as_tensor(rng.standard_normal((6, 4, 8, 8))).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        AnK = stencil_hopper.prepare(torch.as_tensor(An).cuda(), dtype)
        for periodic in (False, True):
            y = stencil_hopper.apply_stencil_prepared(AnK, x,
                                                      periodic=periodic)
            ref = stencil_hopper.apply_plain(AnK, x, periodic=periodic)
            torch.testing.assert_close(y, ref, rtol=2e-5, atol=2e-5)


# every entry point of the library: (l, m, n) and the coefficient type
# that reach it (8x8x4 grids as (l, m, n) = (4, 8, 8); n = 12 and n = 100
# are wide in f32 only; n = 3 is the 2DMOC fixture's row, n = 7 an odd
# one; at n = 1 and n = 2 the periodic wrap folds the three di onto one or
# two columns)
ENTRY_CASES = [
    ((4, 8, 8), "float32", "stencil_matvec_f32_wide"),
    ((4, 8, 8), "bfloat16", "stencil_matvec_bf16_wide"),
    ((2, 3, 12), "float32", "stencil_matvec_f32_wide"),
    ((2, 3, 12), "bfloat16", "stencil_matvec_bf16"),
    ((6, 6, 3), "float32", "stencil_matvec_f32"),
    ((6, 6, 3), "bfloat16", "stencil_matvec_bf16"),
    ((3, 5, 7), "float32", "stencil_matvec_f32"),
    ((3, 5, 7), "bfloat16", "stencil_matvec_bf16"),
    ((2, 3, 100), "bfloat16", "stencil_matvec_bf16"),
    ((2, 3, 1), "float32", "stencil_matvec_f32"),
    ((2, 3, 1), "bfloat16", "stencil_matvec_bf16"),
    ((2, 3, 2), "float32", "stencil_matvec_f32"),
    ((2, 3, 2), "bfloat16", "stencil_matvec_bf16"),
]


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape,dtype,entry", ENTRY_CASES)
def test_kernel_entry_matches_plain_on_card(shape, dtype, entry, periodic):
    """Each entry point against the plain version, at a random x and at
    an x kept on the two edge columns in i (a wrong wrap shows in full
    there); the launch is counted under the entry kernel_variant names."""
    dtype = getattr(torch, dtype)
    l, m, n = shape
    assert stencil_hopper.kernel_variant(dtype, l, m, n) == entry
    rng = np.random.default_rng(12)
    An = torch.as_tensor(rng.standard_normal((27, 6, 6, l, m, n))).cuda()
    AnK = stencil_hopper.prepare(An, dtype)
    x = rng.standard_normal((6, l, m, n))
    edge = np.zeros_like(x)
    edge[..., 0], edge[..., -1] = x[..., 0], x[..., -1]
    for v in (x, edge):
        v = torch.as_tensor(v).cuda()
        before = stencil_hopper.LAUNCHES_BY_ENTRY[entry]
        y = stencil_hopper.apply_stencil_prepared(AnK, v, periodic=periodic)
        torch.cuda.synchronize()
        assert stencil_hopper.LAUNCHES_BY_ENTRY[entry] == before + 1
        ref = stencil_hopper.apply_plain(AnK, v, periodic=periodic)
        torch.testing.assert_close(y, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@needs_card
def test_unaligned_tensor_takes_general_kernel_on_card():
    """A coefficient tensor that does not start on a 16-byte boundary
    goes through the general-shape kernel, never the plain version."""
    rng = np.random.default_rng(13)
    l, m, n = 4, 8, 8
    buf = torch.as_tensor(rng.standard_normal(27 * 36 * l * m * n + 1),
                          dtype=torch.float32).cuda()
    AnK = buf[1:].view(27, 6, 6, l, m, n)
    assert AnK.data_ptr() % 16 != 0 and AnK.is_contiguous()
    x = torch.as_tensor(rng.standard_normal((6, l, m, n))).cuda()
    before = dict(stencil_hopper.LAUNCHES_BY_ENTRY)
    y = stencil_hopper.apply_stencil_prepared(AnK, x, periodic=True)
    assert stencil_hopper.LAUNCHES_BY_ENTRY["stencil_matvec_f32"] \
        == before["stencil_matvec_f32"] + 1
    assert stencil_hopper.LAUNCHES_BY_ENTRY["stencil_matvec_f32_wide"] \
        == before["stencil_matvec_f32_wide"]
    torch.testing.assert_close(
        y, stencil_hopper.apply_plain(AnK, x, periodic=True),
        rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 7), (3, 5, 6)])
def test_general_kernel_at_any_alignment_on_card(shape, dtype, periodic):
    """Coefficients at their usual start and one element off it, at an
    odd and an even l*m*n (rows the wide kernel refuses): the four
    alignments of the general kernel's coefficient pairs, against the
    plain version."""
    rng = np.random.default_rng(14)
    l, m, n = shape
    An = torch.as_tensor(rng.standard_normal((27, 6, 6, l, m, n))).cuda()
    x = torch.as_tensor(rng.standard_normal((6, l, m, n))).cuda().float()
    entry = stencil_hopper.kernel_variant(dtype, l, m, n)
    assert not entry.endswith("_wide")
    for shift in (0, 1):
        buf = torch.empty(An.numel() + shift, device="cuda", dtype=dtype)
        AnK = buf[shift:].view(An.shape).copy_(An)
        before = stencil_hopper.LAUNCHES_BY_ENTRY[entry]
        y = stencil_hopper.apply_stencil_prepared(AnK, x, periodic=periodic)
        torch.cuda.synchronize()
        assert stencil_hopper.LAUNCHES_BY_ENTRY[entry] == before + 1
        torch.testing.assert_close(
            y, stencil_hopper.apply_plain(AnK, x, periodic=periodic),
            rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_general_kernel_equals_wide_on_card(dtype, periodic):
    """Where both kernels run, the general one (forced by an x 4 bytes off
    a 16-byte boundary) sums each output in the wide one's order: equal
    value for value, random and edge-column x."""
    rng = np.random.default_rng(15)
    l, m, n = 4, 8, 16
    An = torch.as_tensor(rng.standard_normal((27, 6, 6, l, m, n))).cuda()
    AnK = stencil_hopper.prepare(An, dtype)
    x = rng.standard_normal((6, l, m, n))
    edge = np.zeros_like(x)
    edge[..., 0], edge[..., -1] = x[..., 0], x[..., -1]
    for v in (x, edge):
        v = torch.as_tensor(v, dtype=torch.float32).cuda()
        off = torch.empty(v.numel() + 1, device="cuda")[1:].view_as(v)
        off.copy_(v)
        before = dict(stencil_hopper.LAUNCHES_BY_ENTRY)
        wide = stencil_hopper.apply_stencil_prepared(AnK, v,
                                                     periodic=periodic)
        general = stencil_hopper.apply_stencil_prepared(AnK, off,
                                                        periodic=periodic)
        torch.cuda.synchronize()
        after = stencil_hopper.LAUNCHES_BY_ENTRY
        assert {k for k in after if after[k] != before[k]} == {
            stencil_hopper.kernel_variant(dtype, l, m, n),
            stencil_hopper.kernel_variant(dtype, l, m, n).removesuffix(
                "_wide")}
        assert torch.equal(wide, general)


# the sub-block kernel at the ocean cell's grid in f32, the coupled
# cell's in f64, and a row of 97 in both
BLOCK_GRIDS = [((12, 38, 96), "float32"), ((12, 32, 64), "float64"),
               ((12, 38, 97), "float32"), ((12, 38, 97), "float64")]
BLOCK_TOL = {"float32": 1e-5, "float64": 1e-13}


def _block_matches_plain(A, x, periodic):
    """One launch of the sub-block kernel against its plain version: each
    value within BLOCK_TOL of |A| |x| at its point.  Both sum at most
    27 b = 108 products in the working type, each rounded once, in other
    orders: together at most 216 units of rounding (6e-8 in f32, 1.1e-16
    in f64) of that sum of magnitudes, 1.3e-5 and 2.4e-14 at the worst,
    and rounding errors that add in random signs come to about the
    square root of that count, under 1e-6 and 2e-15."""
    entry, _ = stencil_hopper.block_variant(A, x)
    before = stencil_hopper.BLOCK_LAUNCHES[entry]
    y = stencil_hopper.apply_block(A, x, periodic=periodic)
    assert stencil_hopper.BLOCK_LAUNCHES[entry] == before + 1
    ref = stencil_hopper.apply_block_plain(A, x, periodic=periodic)
    scale = stencil_hopper.apply_block_plain(A.abs(), x.abs(),
                                             periodic=periodic)
    assert y.dtype == A.dtype and y.shape == ref.shape
    tol = BLOCK_TOL[str(A.dtype).removeprefix("torch.")]
    assert bool(((y - ref).abs() <= tol * scale).all())


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("ab", [(1, 1), (1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("shape,dtype", BLOCK_GRIDS)
def test_block_kernel_matches_plain_on_card(shape, dtype, ab, periodic):
    """Every sub-block shape of the sweep against the plain version, in
    both layouts (A on and off its 16-byte boundary; a row of 97 takes
    the general one either way), with x a tensor and a stride-0 expand
    of one (m, n) field (the saddle's lifted pressure)."""
    t = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    a, b = ab
    A = torch.randn((27, a, b, *shape), generator=g, device="cuda", dtype=t)
    off = torch.empty(A.numel() + 1, device="cuda",
                      dtype=t)[1:].view_as(A).copy_(A)
    x = torch.randn((b, *shape), generator=g, device="cuda", dtype=t)
    lifted = torch.randn(shape[1:], generator=g, device="cuda",
                         dtype=t).expand(b, *shape)
    row = shape[2] % stencil_hopper.BLOCK_VEC[t] == 0
    assert stencil_hopper.block_variant(A, x)[1] == row
    assert not stencil_hopper.block_variant(off, x)[1]
    for coeffs in (A, off):
        for v in (x, lifted):
            _block_matches_plain(coeffs, v, periodic)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("ab", [(3, 3), (2, 4), (4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_block_kernel_other_shapes_on_card(dtype, ab, periodic):
    """The 2D saddle multigrid's and the Teko couplings' sub-blocks on
    the 2DMOC fixture's 6x6x3 grid."""
    t = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(4)
    A = torch.randn((27, *ab, 6, 6, 3), generator=g, device="cuda", dtype=t)
    x = torch.randn((ab[1], 6, 6, 3), generator=g, device="cuda", dtype=t)
    _block_matches_plain(A, x, periodic)


@pytest.mark.cuda
@needs_card
def test_ocean_default_device_is_the_card():
    o = Ocean({"THCM": {"Global Grid-Size n": 8, "Global Grid-Size m": 8,
                        "Global Grid-Size l": 4}}, data_dir=DATA)
    assert o.device.type == "cuda" and o.state.is_cuda


@pytest.mark.cuda
@needs_card
def test_graphed_sweep_matches_eager_on_card():
    """The model's f32 BGS sweep on the card (its saddle iteration
    recorded as CUDA graphs on the first call, replayed on the second)
    against the same sweep launched op by op.  Five saddle iterations
    keep the sweep short of the f32 noise floor, where round-off would
    be amplified; the graphs replay the same kernels, so the default
    f32 tolerances of assert_close hold."""
    o = Ocean({"THCM": {
        "Global Grid-Size n": 8, "Global Grid-Size m": 8,
        "Global Grid-Size l": 4, "Read Land Mask": True,
        "Land Mask": "test8x8x4_3",
        "Starting Parameters": {"Combined Forcing": 0.5,
                                "Temperature Forcing": 10.0,
                                "Salinity Forcing": 0.1,
                                "Wind Forcing": 1.0}}},
        solver_params={"Preconditioning": "BGS", "Precision": "Mixed",
                       "Preconditioner": {"Saddlepoint iterations": 5}},
        data_dir=DATA, device="cuda")
    rng = np.random.default_rng(0)
    interop.install_state(o, 0.05 * rng.standard_normal(
        tuple(o.state.shape)))
    o.compute_jacobian()
    _, f32 = o._get_prec_factors()
    r = torch.as_tensor(rng.standard_normal(tuple(o.state.shape)),
                        dtype=torch.float32, device="cuda")
    eager = bgs.apply(f32, r, periodic=o.cfg.periodic, nit_spp=5)
    for _ in range(2):
        torch.testing.assert_close(o._prec_apply(f32, r), eager)


ISLAND = {"THCM": {
    "Global Grid-Size n": 8, "Global Grid-Size m": 8,
    "Global Grid-Size l": 4, "Read Land Mask": True,
    "Land Mask": "test8x8x4_3",
    "Starting Parameters": {"Combined Forcing": 0.5,
                            "Temperature Forcing": 10.0,
                            "Salinity Forcing": 0.1,
                            "Wind Forcing": 1.0}}}


def _island(device, solver_params):
    """The masked 8x8x4 grid at a random state, F and Jacobian computed;
    the same on every device."""
    o = Ocean(ISLAND, solver_params=solver_params, data_dir=DATA,
              device=device)
    rng = np.random.default_rng(0)
    interop.install_state(o, 0.05 * rng.standard_normal(
        tuple(o.state.shape)))
    o.compute_rhs()
    o.compute_jacobian()
    return o


# sub-block products of one 3D saddle iteration: the operator's three
# (A_uvuv, A_uvp, A_puv) and its preconditioner's, by scheme
SADDLE_PRODUCTS = {"SI": 3 + 4, "SL": 3 + 2, "SR": 3 + 7}


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("scheme", ["SL", "SR"])
def test_graphed_sweep_schemes_match_eager_on_card(scheme, monkeypatch):
    """The graphed saddle iteration depends on the scheme: the model's f32
    sweep with SL and with SR, recorded on the first call and replayed on
    the second, against the same sweep launched op by op; and the graphs
    of one factor set are kept per scheme.  Every sub-block product runs
    the Hopper kernel: the recording launches it for each product of the
    saddle iteration twice (warm-up and capture), a replayed sweep only
    for the products outside the saddle, the replayed operator's graph
    holds the kernel, and no product on the card gathers windows or takes
    the plain expression."""
    on_card = []

    def counted(fn):
        def call(*args, **kwargs):
            on_card.extend(a.is_cuda for a in args
                           if isinstance(a, torch.Tensor))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(mg, "windows", counted(mg.windows))
    monkeypatch.setattr(stencil_hopper, "apply_block_plain",
                        counted(stencil_hopper.apply_block_plain))
    o = _island("cuda", {"Preconditioning": "BGS", "Precision": "Mixed",
                         "Preconditioner": {"Saddlepoint iterations": 5,
                                            "Saddlepoint scheme": scheme}})
    _, f32 = o._get_prec_factors()
    r = torch.as_tensor(np.random.default_rng(1).standard_normal(
        tuple(o.state.shape)), dtype=torch.float32, device="cuda")
    eager = bgs.apply(f32, r, periodic=False, nit_spp=5, spp_scheme=scheme)
    for _ in range(2):
        torch.testing.assert_close(o._prec_apply(f32, r), eager)
    graphs = bgs.SweepGraphs(f32)

    def launches():
        return stencil_hopper.BLOCK_LAUNCHES["stencil_block_f32"]

    for sch in ("SI", scheme):
        n0 = launches()
        recorded = bgs.apply(f32, r, periodic=False, nit_spp=5,
                             spp_scheme=sch, graphs=graphs)
        n1 = launches()
        replayed = bgs.apply(f32, r, periodic=False, nit_spp=5,
                             spp_scheme=sch, graphs=graphs)
        n2 = launches()
        for got in (recorded, replayed):
            torch.testing.assert_close(
                got, bgs.apply(f32, r, periodic=False, nit_spp=5,
                               spp_scheme=sch))
        assert n2 - n1 > 0
        assert (n1 - n0) - (n2 - n1) == 2 * SADDLE_PRODUCTS[sch]
    assert set(graphs.recorded) == {"SI", scheme}
    mv_graph = graphs.recorded["SI"][0]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        mv_graph(torch.zeros_like(mv_graph.inp))
        torch.cuda.synchronize()
    assert any("stencil_block_kernel" in e.key
               for e in prof.key_averages())
    assert not any(on_card)
    mg.Whole(False).windows(r.cpu()[:2])     # the counter sees the CPU's
    assert on_card == [False]


@pytest.mark.cuda
@needs_card
def test_graph_recordings_keep_card_memory_flat():
    """Every factor set records its sweep graphs anew; once the first
    recording has made what lasts (the side stream's cuBLAS workspace, the
    index tables), further recordings, each freed with its factor set,
    leave the card's allocated memory where it was."""
    o = _island("cuda", {"Preconditioning": "BGS", "Precision": "Mixed",
                         "Preconditioner": {"Saddlepoint iterations": 5}})
    _, f32 = o._get_prec_factors()
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(
        tuple(o.state.shape)), dtype=torch.float32, device="cuda")
    allocated = []
    for _ in range(4):
        fac = f32._replace()
        graphs = bgs.SweepGraphs(fac)
        bgs.apply(fac, r, periodic=False, nit_spp=5, graphs=graphs)
        del fac, graphs
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    assert allocated[1:] == allocated[1:2] * 3, allocated


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("method,tol", [("MILU", 1e-4), ("Amesos", 1e-8)])
def test_host_preconditioner_with_cuda_tensors_on_card(method, tol):
    """MILU and Amesos factor and solve on the host: a solve on the card
    carries CUDA tensors across in every application and agrees with the
    same solve on the CPU (the Krylov vectors' sums differ in order: 1e-6
    relative for the one-iteration Amesos solve, 10 tol for MILU)."""
    sp = {"Preconditioning": method, "FGMRES tolerance": tol,
          "FGMRES iterations": 400}
    xs = []
    for device in ("cuda", "cpu"):
        o = _island(device, dict(sp))
        x = o.solve(-o.rhs)
        assert x.device.type == device and o.solve_relres <= tol
        xs.append(x.cpu())
    far = float((xs[0] - xs[1]).abs().max() / xs[1].abs().max())
    assert far <= (1e-6 if method == "Amesos" else 10 * tol), far


@pytest.mark.cuda
@needs_card
def test_jdqz_on_card_matches_cpu():
    """JDQZ on the 4x4x3 ocean (BGS, Mixed: every Arnoldi step is a solve
    through the kernel) on the card against the CPU: eigenvalues to 1e-5
    relative (both are held to 1e-7 Ritz residuals, with f32 inner solves
    whose iterates differ between the devices), search space on the
    card."""
    from iemic_tpu_torch.solvers.eigen import JDQZ
    lams = []
    for device in ("cuda", "cpu"):
        o = Ocean({"THCM": {
            "Global Grid-Size n": 4, "Global Grid-Size m": 4,
            "Global Grid-Size l": 3,
            "Starting Parameters": {"Combined Forcing": 0.2,
                                    "Temperature Forcing": 10.0,
                                    "Wind Forcing": 1.0}}},
            solver_params={"FGMRES tolerance": 1e-12,
                           "FGMRES iterations": 300}, device=device)
        before = stencil_hopper.LAUNCHES
        solver = JDQZ(o, {"Number of eigenvalues": 3, "Tolerance": 1e-7})
        solver.solve()
        assert solver.kmax_converged == 3
        assert solver.eigenvectors[0].device.type == device
        if device == "cuda":
            assert stencil_hopper.LAUNCHES > before
        lams.append(solver.eigenvalues)
    for lam in lams[1][:2]:
        assert np.abs(lams[0] - lam).min() <= 1e-5 * abs(lam)


def _theta_steps(device, stochastic):
    """One theta step (dt 0.01) of the masked 8x8x4 grid from a random
    state, BGS + Mixed at 1e-6, Newton to 1e-6; with stochastic, through
    the stochastic theta model (sigma 1, seed 2)."""
    from iemic_tpu_torch.transient.factory import get_time_step
    from iemic_tpu_torch.transient.theta import (StochasticThetaModel,
                                                 ThetaModel)
    o = _island(device, {"Preconditioning": "BGS", "Precision": "Mixed",
                         "FGMRES tolerance": 1e-6})
    pars = {"theta": 1.0, "Newton tolerance": 1e-6, "sigma": 1.0, "seed": 2}
    model = (StochasticThetaModel if stochastic else ThetaModel)(o, pars)
    step = get_time_step(model, pars)
    x = step(o.get_state(), 0.01)
    assert step.newton.converged and x.device.type == device
    return x.cpu(), model


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["theta", "stochastic"])
def test_theta_step_on_card_matches_cpu(stochastic):
    """A theta step and a stochastic theta step on the card against the
    same step on the CPU: the state to 1e-6 relative (Newton to 1e-6 with
    f32 inner solves summed in another order on each device); the noise,
    drawn on the host, the same to the bit; the solves through the
    kernel."""
    before = stencil_hopper.LAUNCHES
    x_card, m_card = _theta_steps("cuda", stochastic)
    assert stencil_hopper.LAUNCHES > before
    x_cpu, m_cpu = _theta_steps("cpu", stochastic)
    far = float((x_card - x_cpu).abs().max() / x_cpu.abs().max())
    assert far <= 1e-6, far
    if stochastic:
        assert torch.equal(m_card.G.cpu() != 0, m_cpu.G != 0)
        torch.testing.assert_close(m_card.G.cpu(), m_cpu.G, rtol=1e-12,
                                   atol=0)


@pytest.mark.cuda
@needs_card
def test_kernel_on_shifted_operator_on_card():
    """The kernel on J - B/(theta dt) as ThetaModel builds it (a new
    tensor, prepared again) against the plain version."""
    from iemic_tpu_torch.transient.theta import ThetaModel
    o = _island("cuda", {"Preconditioning": "BGS", "Precision": "Mixed"})
    model = ThetaModel(o, {"theta": 1.0})
    model.init_step(0.01)
    model.compute_jacobian()
    An = o.jac
    assert float((An[4, 4, 4] - o._jacobian(o.state, o.par)[4, 4, 4])
                 .abs().max()) == pytest.approx(100.0)
    AnK = stencil_hopper.prepare(An)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        tuple(o.state.shape)), dtype=torch.float32, device="cuda")
    before = stencil_hopper.LAUNCHES
    y = stencil_hopper.apply_stencil_prepared(AnK, x, periodic=False)
    assert stencil_hopper.LAUNCHES == before + 1
    torch.testing.assert_close(
        y, stencil_hopper.apply_plain(AnK, x, periodic=False),
        rtol=2e-5, atol=2e-5)


def _blended_solve(device):
    """The leg test8x8x4_3 -> test8x8x4_1 of the masked 8x8x4 grid at
    Delta 0.4 from a random state and x_A, BGS + Mixed at 1e-2 (from such
    a state one f32 inner solve of J_B or J_h reaches 2e-3 to 6e-4, and
    the next stalls): the blended tensor's solve of -F_h, with the
    launches of the kernel."""
    from iemic_tpu_torch.models.ocean import landmask as lm
    from iemic_tpu_torch.topo import Topo
    o = _island(device, {"Preconditioning": "BGS", "Precision": "Mixed",
                         "FGMRES tolerance": 1e-2})
    masks = [lm.read_mask_file(os.path.join(DATA, "mkmask", name), o.grid)
             for name in ("test8x8x4_3", "test8x8x4_1")]
    topo = Topo(o, {"Number of mask files": 0})
    topo.set_masks(masks)
    topo.initialize()
    rng = np.random.default_rng(1)
    interop.install_state(o, 0.05 * rng.standard_normal(
        tuple(o.state.shape)))
    topo.set_par("Delta", 0.4)
    topo.compute_rhs()
    topo.compute_jacobian()
    J_B = o.jac
    before = stencil_hopper.LAUNCHES
    x = topo.solve(-topo.rhs)
    assert o.jac is J_B and o.solve_relres <= 1e-2
    return x.cpu(), stencil_hopper.LAUNCHES - before, topo


@pytest.mark.cuda
@needs_card
def test_blended_solve_on_card_matches_cpu():
    """Topo.solve on the card runs the ocean's Mixed stack on the
    row-scaled blended tensor through the kernel (the launch count
    rises) and meets its tolerance, and the CPU's f64 operator finds the
    card's solution within that tolerance too (two solves to 1e-2 whose
    f32 inner solves sum in another order may differ by more than that
    in the solution itself)."""
    x_card, launched, _ = _blended_solve("cuda")
    _, none, topo = _blended_solve("cpu")
    assert launched > 0 and none == 0
    o = topo.model
    nullq = o._get_deflator()
    b = (-topo.rhs * o._rowscale).reshape(-1)
    b = b - nullq @ (nullq.T @ b)
    r = b - o._mv64(x_card.reshape(-1), nullq)
    assert float(r.norm() / b.norm()) <= 1e-2


@pytest.mark.cuda
@needs_card
def test_solve_covariance_on_card_matches_cpu():
    """solve_covariance of the 4x4x4 ocean on the card against the CPU
    over five rails iterations (an unconverged rails iteration amplifies
    rounding differences, tests/test_torch_lyapunov.py): trace and
    spectrum to 1e-8 relative, the factor on the card."""
    from iemic_tpu_torch.lyapunov import LyapunovModel
    out = []
    for device in ("cuda", "cpu"):
        o = Ocean({"THCM": {"Global Grid-Size n": 4, "Global Grid-Size m": 4,
                            "Global Grid-Size l": 4, "Periodic": False,
                            "Starting Parameters": {"Combined Forcing": 0.0}}},
                  device=device)
        out.append(LyapunovModel(o, {"Tolerance": 1e-4,
                                     "Maximum Iterations": 5,
                                     "Noise Amplitude": 1e-2})
                   .solve_covariance())
    card, cpu = out
    assert card["iterations"] == cpu["iterations"]
    assert abs(card["trace"] - cpu["trace"]) <= 1e-8 * abs(cpu["trace"])
    top = abs(cpu["spectrum"][0])
    assert np.abs(card["spectrum"] - cpu["spectrum"]).max() <= 1e-8 * top


@pytest.mark.cuda
@needs_card
def test_min_norm_solve_on_card_matches_numpy():
    """The SVD minimal-norm solve on CUDA equals np.linalg.lstsq on a
    rank-deficient block, where torch.linalg.lstsq on CUDA (gels, full
    rank only) does not."""
    from iemic_tpu_torch.lyapunov import min_norm_solve
    rng = np.random.default_rng(2)
    A = rng.standard_normal((60, 45)) @ rng.standard_normal((45, 60))
    B = rng.standard_normal((60, 5))
    want = np.linalg.lstsq(A, B, rcond=None)[0]
    At, Bt = torch.as_tensor(A).cuda(), torch.as_tensor(B).cuda()
    got = min_norm_solve(At, Bt).cpu().numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    gels = torch.linalg.lstsq(At, Bt).solution.cpu().numpy()
    assert not np.abs(gels - want).max() <= 1e-6 * np.abs(want).max()


def _aquaplanet(path, device, n=16, m=8, l=4):
    """run/aquaplanet cut to n x m x l (ocean, atmosphere and sea ice) in
    path, no state file, as a CoupledModel on device: the bundle's BGS
    ocean, coupled scheme C/F, FGMRES 1e-3."""
    import shutil
    from iemic_tpu_torch.config import read_xml, write_xml
    from iemic_tpu_torch.models.coupled import build_coupled_from_files
    repo = os.path.dirname(DATA)
    path = str(path)
    if not os.path.exists(path):
        shutil.copytree(os.path.join(repo, "run", "aquaplanet"), path)
        for name in ("ocean_params.xml", "atmosphere_params.xml",
                     "seaice_params.xml"):
            p = read_xml(os.path.join(path, name))
            t = p.sublist("THCM") if name.startswith("ocean") else p
            t.set("Global Grid-Size n", n)
            t.set("Global Grid-Size m", m)
            if name.startswith("ocean"):
                t.set("Global Grid-Size l", l)
                p.set("Save state", False)
            write_xml(p, os.path.join(path, name))
    return build_coupled_from_files(path, device=device)


def _coupled_pieces(c, seed=0):
    """F, J v and the six coupling blocks at a seeded small state of a
    coupled model, and the first Newton solve from rest (J x = -F), as
    numpy."""
    rng = np.random.default_rng(seed)
    x = 0.05 * rng.standard_normal(c.dim)
    c.set_state(interop.tensor(x, c.device))
    c.compute_rhs()
    c.compute_jacobian()
    out = {"F": c.get_rhs()}
    v = interop.tensor(rng.standard_normal(c.dim), c.device)
    out["Jv"] = c.apply_matrix(v)
    parts = c.split(v)
    for i in range(3):
        for j in range(3):
            if i != j:
                out[f"C{i}{j}"] = c.coupling_apply(i, j, parts[j])
    c.set_state(torch.zeros_like(c.get_state()))
    c.compute_rhs()
    c.compute_jacobian()
    # the pressure modes the coupled solve deflates from the ocean block
    q = c.ocean._get_deflator()
    out["null modes"] = q if q is not None else c.get_state()[:0]
    out["x"] = c.solve(-c.get_rhs())
    return {k: t.cpu().numpy() for k, t in out.items()}, \
        (c.solve_iters, c.solve_relres, c.solve_tol)


@pytest.mark.cuda
@needs_card
def test_coupled_on_card_matches_cpu(tmp_path):
    """The shrunk aquaplanet (16x8x4, BGS ocean): F, the coupled matvec
    and the six coupling blocks on the card against the CPU to 1e-10; the
    first Newton solve from rest reaches its tolerance on both, in
    iterations within 2, and the two solutions agree to that tolerance:
    the BGS sweep's inner Krylov solves stop on tolerances, and rounding
    parts the card's and the CPU's sweeps there (measured on an H100: the
    solutions part by 2.0e-5 of their largest entry)."""
    got, (its_card, rel_card, tol) = _coupled_pieces(
        _aquaplanet(tmp_path / "a", "cuda"))
    ref, (its_cpu, rel_cpu, _) = _coupled_pieces(
        _aquaplanet(tmp_path / "a", "cpu"))
    assert got["null modes"].shape == ref["null modes"].shape
    for k in ref:
        err = np.abs(got[k] - ref[k]).max(initial=0.0) / max(
            np.abs(ref[k]).max(initial=0.0), 1e-300)
        assert err <= (tol if k == "x" else 1e-10), (k, err)
    assert max(rel_card, rel_cpu) <= tol
    assert abs(its_card - its_cpu) <= 2, (its_card, its_cpu)


def _masked_8x8x4(device, solver=None, thcm=None):
    """tests/test_parallel.py's masked 8x8x4 fixture on device, at its
    state of the shallow solve (F and J computed)."""
    from iemic_tpu_torch.models.ocean import landmask
    base = {"Global Grid-Size n": 8, "Global Grid-Size m": 8,
            "Global Grid-Size l": 4, "Periodic": True,
            "Starting Parameters": {"Combined Forcing": 0.3,
                                    "Temperature Forcing": 10.0,
                                    "Wind Forcing": 1.0}}
    o = Ocean({"THCM": dict(base, **(thcm or {}))}, solver_params=solver,
              device=device)
    landm = o.landm.copy()
    landm[1:, 3:5, 3:6] = 1
    o.set_land_mask(landmask.finalize_mask(landm, o.grid, True),
                    finalized=True)
    rng = np.random.default_rng(11)
    o.set_state(o._tensor(0.01 * rng.standard_normal((6, 4, 8, 8))))
    o.compute_rhs()
    o.compute_jacobian()
    return o


@pytest.mark.cuda
@needs_card
def test_one_nccl_rank_matches_serial_on_card(tmp_path):
    """A one-rank NCCL Domain on the card: its sharded matvec equals the
    serial port's Ocean.apply_matrix to 1e-12, and its shallow Double
    solve (tol 1e-2, 120 iterations) is the serial Ocean.solve with the
    same preconditioner (BGS, ATS multigrid, 30 saddle iterations to 1e-6,
    no row scaling): the same MV, relres and iterate."""
    import torch.distributed as dist
    from iemic_tpu_torch.parallel import Domain, make_sharded_ops
    from iemic_tpu_torch.parallel.multihost import initialize_environment

    solver = {"Preconditioning": "BGS", "Precision": "Double",
              "FGMRES tolerance": 1e-2, "FGMRES iterations": 120,
              "Preconditioner": {"Saddlepoint iterations": 30,
                                 "Saddlepoint tolerance": 1e-6,
                                 "ATS Precond": "MG"}}
    serial = _masked_8x8x4("cuda", solver, {"Scaling": "None"})
    z = serial.solve(-serial.rhs)
    initialize_environment("nccl", init_method=f"file://{tmp_path}/store",
                           world_size=1, rank=0, timeout_s=120.0)
    try:
        dom = Domain(8, 8, 4, periodic=True, device="cuda")
        o = _masked_8x8x4(dom.device)
        ops = make_sharded_ops(o, dom)
        v = -o.rhs
        y = ops["matvec"](dom.shard_stencil(o.jac), dom.shard_state(v))
        ref = o.apply_matrix(v)
        assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-12
        from iemic_tpu_torch.parallel.halo import make_sharded_solve
        res = make_sharded_solve(o, dom)(
            dom.shard_stencil(o.jac), dom.shard_state(-o.rhs), 1e-2, 120)
    finally:
        dist.destroy_process_group()
    assert res.mv == serial.solve_iters
    assert res.relres == pytest.approx(serial.solve_relres, rel=1e-10)
    torch.testing.assert_close(res.x, z, rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("method,precision,tol", [("Teko", "Mixed", 1e-3),
                                                  ("Amesos", "Double",
                                                   1e-8)])
def test_sharded_methods_are_ocean_solve_on_card(method, precision, tol):
    """A partitioned method (Teko, Mixed: its f32 factors and coupling
    products on the card) and a host one (Amesos: a CUDA residual through
    the host LU) as one-rank ShardedOcean.solve on CUDA tensors, against
    Ocean.solve on the same solver parameters: the same MV, the iterate
    to 1e-10.  "Matvec kernel" "xla": the sharded f32 product is plain
    PyTorch, and the kernel's summation order would part the iterates."""
    from iemic_tpu_torch.parallel import Domain, ShardedOcean
    solver = {"Preconditioning": method, "Precision": precision,
              "FGMRES tolerance": tol, "FGMRES iterations": 200,
              "Matvec kernel": "xla"}
    serial = _masked_8x8x4("cuda", dict(solver))
    z = serial.solve(-serial.rhs)
    o = _masked_8x8x4("cuda", dict(solver))
    so = ShardedOcean(o, Domain(8, 8, 4, periodic=True, device="cuda"))
    so.compute_rhs()
    so.compute_jacobian()
    zs = so.solve(-so.rhs)
    assert zs.is_cuda and so.solve_iters == serial.solve_iters
    assert so.solve_relres <= tol
    assert float((zs - z).abs().max() / z.abs().max()) <= 1e-10
    assert so._solve.preconditioner().stats()["method"] == method
