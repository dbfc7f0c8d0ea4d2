"""Two branches of the BGS sweep whose output is not bounded on a masked
global grid, in the JAX package as in the port (CPU, f64, 32x16x8; about
40 and 90 s, most of it the JAX side's compilation, so both cases are
marked slow: python -m pytest tests/test_torch_bgs_unbounded.py -m slow)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.solvers import bgs as jbgs

from iemic_tpu_torch.solvers import bgs as tbgs

from test_torch_ocean import _close
from test_torch_bgs_variants import _pair

# Saddle scheme SR and the 2D saddle's multigrid on a masked global grid
# (32x16x8): one f64 preconditioner application (no inner iteration) gives
# max |z| of 8.3e23 and 3.5e17 in the JAX package, and the same in the
# port.  An f32 inner FGMRES cannot square such numbers, so neither package
# can run these two branches in Mixed precision on such a grid.  name ->
# (BGS settings, scheme, least max |z|, limit on the relative max error of
# the port against JAX, the error measured).
HUGE = {"SR": ({"Saddlepoint scheme": "SR"}, "SR", 1e20, 1e-4, 1.8e-7),
        "KRYLOV+MG": ({"Saddlepoint scheme": "KRYLOV",
                       "Saddlepoint Precond": "MG"}, "KRYLOV", 1e15, 1e-6,
                      1.2e-8)}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(HUGE))
def test_unbounded_sweep_is_jax_own(name):
    prec, scheme, least, limit, _ = HUGE[name]
    jo, to = _pair("global32x16x8", prec)
    fj, _ = jo._get_prec_factors()
    ft, _ = to._get_prec_factors()
    r = np.random.default_rng(0).standard_normal(np.shape(jo.state))
    zj = np.asarray(jbgs.apply(fj, jnp.asarray(r), periodic=True,
                               spp_scheme=scheme, nit_spp=0))
    zt = tbgs.apply(ft, torch.as_tensor(r), periodic=True,
                    spp_scheme=scheme, nit_spp=0).numpy()
    assert np.abs(zj).max() > least
    _close(zt, zj, limit)
