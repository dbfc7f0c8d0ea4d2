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
