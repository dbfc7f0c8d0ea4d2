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
from iemic_tpu_torch.solvers import bgs

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
# that reach it (8x8x4 grids as (l, m, n) = (4, 8, 8); n = 12 is wide in
# f32 only; n = 3 is the 2DMOC fixture's row, n = 7 an odd one)
ENTRY_CASES = [
    ((4, 8, 8), "float32", "stencil_matvec_f32_wide"),
    ((4, 8, 8), "bfloat16", "stencil_matvec_bf16_wide"),
    ((2, 3, 12), "float32", "stencil_matvec_f32_wide"),
    ((2, 3, 12), "bfloat16", "stencil_matvec_bf16"),
    ((6, 6, 3), "float32", "stencil_matvec_f32"),
    ((6, 6, 3), "bfloat16", "stencil_matvec_bf16"),
    ((3, 5, 7), "float32", "stencil_matvec_f32"),
    ((3, 5, 7), "bfloat16", "stencil_matvec_bf16"),
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


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("scheme", ["SL", "SR"])
def test_graphed_sweep_schemes_match_eager_on_card(scheme):
    """The graphed saddle iteration depends on the scheme: the model's f32
    sweep with SL and with SR, recorded on the first call and replayed on
    the second, against the same sweep launched op by op; and the graphs
    of one factor set are kept per scheme."""
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
    for sch in ("SI", scheme):
        torch.testing.assert_close(
            bgs.apply(f32, r, periodic=False, nit_spp=5, spp_scheme=sch,
                      graphs=graphs),
            bgs.apply(f32, r, periodic=False, nit_spp=5, spp_scheme=sch))
    assert set(graphs.recorded) == {"SI", scheme}


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
