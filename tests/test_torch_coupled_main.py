"""Port parity of the coupled entry points: run_coupled and time_coupled
end to end on copies of run/coupled cut to the coupled fixture's 6x6x4, in
the JAX package and in the port, on the CPU; one coupled Newton iteration
of run/aquaplanet cut to 16x8x4 in the port; the entry points' default
device; and two differences from the JAX package (ROADMAP queue 3)."""

import inspect
import os
import re
import shutil

import numpy as np
import pytest
import torch

from test_torch_cuda import _aquaplanet
from test_torch_transient_main import _jax_main, _table
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch.config import ParameterList, read_xml, write_xml
from iemic_tpu_torch.main import run_coupled, time_coupled
from iemic_tpu_torch.utils import logging as tlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch and the BLAS and OpenMP pools on one thread in this module,
    as tests/test_torch_topo.py does."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _quiet():
    jlog.set_verbose(False)
    tlog.set_verbose(False)
    yield
    jlog.set_verbose(True)
    tlog.set_verbose(True)


def _edit(path, name, fn):
    p = read_xml(os.path.join(path, name))
    fn(p)
    write_xml(p, os.path.join(path, name))


def _coupled_bundle(path, *, forcing=None, timestepper=None):
    """run/coupled cut to 6x6x4 (ocean, atmosphere, sea ice), no state
    file and no eigenvalue analysis, one continuation step, without the
    sea ice.  From rest the sea ice's background fluxes put |F| at 195,
    and the bundle's first continuation step fails in both packages (20
    resets to "norm too big", status 1, the same log line by line); at
    Combined Forcing 0 without the sea ice rest is the equilibrium the
    step starts from.  forcing: Combined Forcing of the ocean and the
    atmosphere (a time step from rest needs some)."""
    shutil.copytree(os.path.join(REPO, "run", "coupled"), path)
    os.remove(os.path.join(path, "jdqz_params.xml"))

    def ocean(p):
        p.set("Save state", False)
        t = p.sublist("THCM")
        for k, v in (("n", 6), ("m", 6), ("l", 4)):
            t.set(f"Global Grid-Size {k}", v)
        if forcing is not None:
            t.sublist("Starting Parameters").set("Combined Forcing", forcing)

    def surface(p):
        p.set("Global Grid-Size n", 6)
        p.set("Global Grid-Size m", 6)
        if forcing is not None and p.name.startswith("Atmosphere"):
            p.set("Combined Forcing", forcing)

    _edit(path, "ocean_params.xml", ocean)
    _edit(path, "atmosphere_params.xml", surface)
    _edit(path, "seaice_params.xml", surface)
    _edit(path, "coupledmodel_params.xml",
          lambda p: p.set("Use sea ice", False))
    _edit(path, "continuation_params.xml",
          lambda p: p.set("maximum number of steps", 1))
    if timestepper is not None:
        write_xml(ParameterList("Time stepper parameters", timestepper),
                  os.path.join(path, "timestepper_params.xml"))
    return str(path)


def _fgmres_iters(workdir):
    with open(os.path.join(workdir, "info_0.txt")) as f:
        return [int(v) for v in re.findall(r"CoupledModel: FGMRES (\d+) iters",
                                           f.read())]


def test_run_coupled_matches_jax(tmp_path):
    """run_coupled end to end on the cut bundle: status 0 in the port,
    cdata's par and |x| to 1e-8 of the JAX run's, NR equal, the ocean's MV
    column and every coupled solve's iterations within 2.  The JAX
    run_coupled.main returns its ContinuationResult where an exit status
    belongs, so its process exits 1 after a good run (ROADMAP queue 3);
    the port's returns the status."""
    from iemic_tpu.main import run_coupled as jrun_coupled
    jdir, tdir = (_coupled_bundle(tmp_path / p) for p in ("jax", "port"))
    jres = _jax_main(jrun_coupled.main, jdir)
    assert not isinstance(jres, int) and jres.status == 0
    assert run_coupled.main([tdir, "--device", "cpu"]) == 0
    jc, tc = (_table(os.path.join(d, "cdata.txt")) for d in (jdir, tdir))
    assert jc.shape == tc.shape and len(jc) == 1
    np.testing.assert_allclose(tc[:, 0], jc[:, 0], rtol=1e-8)       # par
    np.testing.assert_allclose(tc[:, 2], jc[:, 2], rtol=1e-8)       # |x|
    np.testing.assert_array_equal(tc[:, 4], jc[:, 4])              # NR
    assert np.abs(tc[:, 5] - jc[:, 5]).max() <= 2                   # MV
    ji, ti = _fgmres_iters(jdir), _fgmres_iters(tdir)
    assert len(ji) == len(ti) > 0
    assert max(abs(a - b) for a, b in zip(ji, ti)) <= 2, (ji, ti)
    assert os.path.exists(os.path.join(tdir, "profile_output"))


def test_time_coupled_matches_jax(tmp_path):
    """time_coupled end to end on the cut bundle at Combined Forcing 0.1:
    two theta steps (theta 1, dt 0.01, not adaptive), status 0 and
    tdata.txt to 1e-8 of the JAX run's."""
    from iemic_tpu.main import time_coupled as jtime_coupled
    steps = {"theta": 1.0, "time step": 0.01, "number of time steps": 2,
             "adaptive time steps": False, "Newton tolerance": 1e-8,
             "HDF5 output frequency": 0}
    jdir, tdir = (_coupled_bundle(tmp_path / p, forcing=0.1,
                                  timestepper=steps)
                  for p in ("jax", "port"))
    assert _jax_main(jtime_coupled.main, jdir) == 0
    assert time_coupled.main([tdir, "--device", "cpu"]) == 0
    tj, tt = (_table(os.path.join(d, "tdata.txt")) for d in (jdir, tdir))
    assert tj.shape == tt.shape and len(tj) == 2
    np.testing.assert_allclose(tt, tj, rtol=1e-8, atol=1e-14)


def test_port_reads_the_ocean_preconditioner_file_jax_does_not(tmp_path):
    """The JAX build_coupled_from_files, which the JAX time_coupled
    builds its model with, gives the ocean solver_params.xml alone and
    leaves out the bundle's ocean_preconditioner_params.xml, which its
    run_coupled merges in (ROADMAP queue 3).  Both of the port's entry
    points merge it: here an Auv block of 3 iterations."""
    from iemic_tpu.models.coupled import (build_coupled_from_files as
                                          jbuild)
    from iemic_tpu_torch.models.coupled import build_coupled_from_files
    path = _coupled_bundle(tmp_path / "b")
    _edit(path, "ocean_preconditioner_params.xml",
          lambda p: p.sublist("Auv Solver").set("Iterations", 3))

    def auv_iterations(ocean):
        return ocean.solver_params.sublist("Preconditioner") \
            .sublist("Auv Solver").get("Iterations")

    cwd = os.getcwd()
    os.chdir(path)
    try:
        assert auv_iterations(jbuild().ocean) == -1     # the default
    finally:
        os.chdir(cwd)
    assert auv_iterations(build_coupled_from_files(path, device="cpu")
                          .ocean) == 3


def test_aquaplanet_newton_iteration(tmp_path):
    """One coupled Newton iteration of run/aquaplanet cut to 16x8x4 (the
    bundle's BGS ocean, scheme C/F, FGMRES 1e-3) from rest: the solve's
    relative residual is recorded and finite, the new state and |F|
    finite."""
    c = _aquaplanet(tmp_path / "a", "cpu")
    c.compute_rhs()
    f0 = float(torch.linalg.norm(c.get_rhs()))
    c.compute_jacobian()
    c.set_state(c.get_state() + c.solve(-c.get_rhs()))
    c.compute_rhs()
    f1 = float(torch.linalg.norm(c.get_rhs()))
    assert np.isfinite(f0) and f0 > 0 and np.isfinite(f1)
    assert c.solve_log and np.isfinite(c.solve_relres)
    assert c.solve_iters >= 1 and c.solve_tol == 1e-3
    assert torch.isfinite(c.get_state()).all()


@pytest.mark.parametrize("entry", [run_coupled, time_coupled])
def test_coupled_entry_points_default_to_the_card(tmp_path, entry):
    """run_coupled and time_coupled run on the card unless asked for the
    CPU, and raise where there is none."""
    assert inspect.signature(entry.run).parameters["device"].default \
        == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.main([str(tmp_path)])
        assert os.listdir(tmp_path) == []
