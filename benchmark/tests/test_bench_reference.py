"""The reference against the port, on small fixtures: the masked 8x8x4
ocean (F and the stencil tensor J) and run/aquaplanet cut to 16x8x4 (the
coupled F, and J v against the port's coupling blocks)."""

import os

import torch

from conftest import aquaplanet_fixture_config, ocean_fixture_config


def _state(shape, seed, landm=None):
    gen = torch.Generator().manual_seed(seed)
    return 0.1 * torch.randn(shape, generator=gen, dtype=torch.float64)


def test_the_ocean_reference_is_the_port(tmp_path):
    from harness import bundle
    from iemic_tpu_torch.main import run_ocean
    from reference.ocean import ReferenceOcean
    work = bundle.write(ocean_fixture_config(), str(tmp_path / "b"))
    ref = ReferenceOcean(work)
    with run_ocean.bundle(work, "cpu") as (ocean, _):
        x = _state(ocean.state.shape, 1)
        ocean.set_par("Combined Forcing", 0.3)
        ocean.set_state(x)
        ocean.compute_rhs()
        ocean.compute_jacobian()
        par = ref.with_par(ref.par0, "Combined Forcing", 0.3)
        assert torch.equal(par, ocean.par)
        F, J = ref.rhs(x, par), ref.jacobian(x, par)
        assert torch.allclose(F, ocean.rhs, rtol=0, atol=1e-13 * float(
            F.abs().max()))
        assert torch.allclose(J, ocean.jac, rtol=0, atol=1e-13 * float(
            J.abs().max()))
        v = _state(ocean.state.shape, 2)
        assert torch.allclose(ref.apply(J, v), ocean.apply_matrix(v),
                              rtol=0, atol=1e-12)


def test_the_coupled_reference_is_the_port(tmp_path):
    from harness import bundle
    from iemic_tpu_torch.main.run_coupled import coupled_environment
    from reference.coupled import ReferenceCoupled
    work = bundle.write(aquaplanet_fixture_config(), str(tmp_path / "b"))
    ref = ReferenceCoupled(work)
    with coupled_environment(work, "cpu", "test") as c:
        x = 0.01 * _state((c.dim,), 3)
        c.set_state(x)
        c.compute_rhs()
        F = c.get_rhs()
        Fr = ref.F(x)
        assert float((F - Fr).abs().max()) <= 1e-13 * float(Fr.abs().max())
        c.compute_jacobian()
        v = _state((c.dim,), 4)
        Jv = c.apply_matrix(v)
        gap = float(torch.linalg.norm(Jv - ref.jv(x, v))
                    / torch.linalg.norm(Jv))
        assert gap < 1e-6, gap
        assert os.path.exists(work)
