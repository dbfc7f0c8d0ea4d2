"""The port's JDQZ eigensolver: the toy pencils and the 4x4x3 ocean of
tests/test_eigen.py with torch models, against known eigenvalues, the
dense generalized spectrum (scipy.linalg.eig) and the JAX package's JDQZ
on the same model; the three things its Jacobi-Davidson path does
otherwise than the JAX package's; the shifted Jacobian of
``add_mass_to_jacobian``; and ``run_ocean`` with eigenvalue analysis in
both packages.  CPU, f64."""

import os
import sys

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

from iemic_tpu.config import read_xml as jread_xml
from iemic_tpu.continuation import Continuation as JContinuation
from iemic_tpu.models.ocean import Ocean as JOcean
from iemic_tpu.solvers.eigen import JDQZ as JJDQZ
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch.config import ParameterList, write_xml
from iemic_tpu_torch.main import run_ocean as trun_ocean
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.ops.stencil import stencil_to_csr, to_flat
from iemic_tpu_torch.solvers.eigen import JDQZ

from test_eigen import (LinearToyModel as JLinearToyModel,
                        DenseToyModel as JDenseToyModel, _rotation_block)


class LinearToyModel:
    """dx/dt B = J x with diagonal J, B on torch tensors: a model with
    only what the shift-invert path needs."""

    def __init__(self, Jdiag, Bdiag):
        self.Jd = torch.as_tensor(np.asarray(Jdiag, float))
        self.Bd = torch.as_tensor(np.asarray(Bdiag, float))
        self.state = torch.zeros_like(self.Jd)
        self.shift = 0.0

    def get_state(self, mode='C'):
        return self.state

    def compute_jacobian(self):
        self.shift = 0.0

    def compute_mass_matrix(self):
        pass

    def add_mass_to_jacobian(self, scale):
        self.shift += scale

    def apply_mass_matrix(self, v):
        return self.Bd * v

    def solve(self, b):
        return b / (self.Jd + self.shift * self.Bd)


class DenseToyModel(LinearToyModel):
    """Dense real pencil with complex eigenvalue pairs."""

    def __init__(self, J, B):
        super().__init__(np.zeros(len(B)), B)
        self.J = torch.as_tensor(np.asarray(J, float))

    def _mat(self):
        return self.J + self.shift * torch.diag(self.Bd)

    def apply_matrix(self, v):
        return self._mat() @ v

    def solve(self, b):
        return torch.linalg.solve(self._mat(), b)


def _nearest(found, wanted):
    return np.array([np.abs(found - w).min() for w in wanted])


def test_toy_generalized_eigenvalues():
    """Diagonal pencil with an infinite eigenvalue (B has a zero): the
    eigenvalues nearest zero to 1e-8 (measured 4e-16), and the JAX
    package's, from the same rng(42) start, to 1e-12."""
    J = np.array([-2.0, -1.0, -0.5, 3.0, 1.0])
    B = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
    pars = {"Number of eigenvalues": 3, "Shift (real part)": 0.0,
            "Tolerance": 1e-10}
    solver = JDQZ(LinearToyModel(J, B), dict(pars))
    solver.solve()
    lams = sorted(solver.eigenvalues.real, key=abs)
    assert abs(lams[0] - (-0.5)) < 1e-8
    assert abs(lams[1] - (-1.0)) < 1e-8
    assert solver.kmax_converged == 3
    assert all(torch.is_tensor(v) and v.shape == (5,)
               for v in solver.eigenvectors)
    ref = JJDQZ(JLinearToyModel(J, B), dict(pars))
    ref.solve()
    assert _nearest(solver.eigenvalues, ref.eigenvalues).max() < 1e-12


def test_real_shift_is_added_and_removed():
    """A real shift next to one eigenvalue finds it first, and the model's
    Jacobian is computed again afterwards."""
    J = np.array([-2.0, -1.0, -0.5, 3.0, 1.0])
    m = LinearToyModel(J, np.ones(5))
    solver = JDQZ(m, {"Number of eigenvalues": 1, "Tolerance": 1e-10,
                      "Shift (real part)": 2.9})
    solver.solve()
    assert abs(solver.eigenvalues[0] - 3.0) < 1e-8
    assert m.shift == 0.0


@pytest.mark.parametrize("method", ["auto", "SI"])
def test_complex_shift_finds_oscillatory_pair(method):
    """A complex shift targets the oscillatory mode nearest to it, on the
    Jacobi-Davidson path (auto) and on the real 2N embedding of the
    shift-invert path (SI).  Pencil eigenvalues: -0.1 +/- 2i, -1 +/- 0.5i,
    -3, -4; limit 1e-7 (measured 3e-16 and 2e-15), and the JAX package's
    nearest value to 1e-8."""
    J = scipy.linalg.block_diag(_rotation_block(-0.1, 2.0),
                                _rotation_block(-1.0, 0.5),
                                np.diag([-3.0, -4.0]))
    pars = {"Number of eigenvalues": 2, "Shift (real part)": 0.0,
            "Shift (imaginary part)": 2.0, "Tolerance": 1e-9,
            "Method": method}
    solver = JDQZ(DenseToyModel(J, np.ones(6)), dict(pars))
    solver.solve()
    lams = solver.eigenvalues
    best = lams[np.argmin(np.abs(lams - (-0.1 + 2j)))]
    assert abs(best - (-0.1 + 2j)) < 1e-7
    assert all(torch.is_complex(v) and v.shape == (6,)
               for v in solver.eigenvectors)
    ref = JJDQZ(JDenseToyModel(J, np.ones(6)), dict(pars))
    ref.solve()
    jbest = ref.eigenvalues[np.argmin(np.abs(ref.eigenvalues - (-0.1 + 2j)))]
    assert abs(best - jbest) < 1e-8


def _nonnormal_pencil(n=80, seed=0):
    """A nonnormal dense pencil with one weakly damped oscillatory pair
    and five infinite eigenvalues."""
    rng = np.random.default_rng(seed)
    J = -np.diag(np.linspace(0.5, 40, n)) + 0.3 * rng.standard_normal((n, n))
    J[:2, :2] = [[-0.1, 2.0], [-2.0, -0.1]]
    B = np.ones(n)
    B[-5:] = 0.0
    w = scipy.linalg.eig(J, np.diag(B), right=False)
    return J, B, w[np.isfinite(w)]


def test_jd_restart_keeps_the_new_correction():
    """The JAX package's restart rebuilds the space from the vectors it
    had before the expansion and loses the correction just solved for
    (iemic_tpu/solvers/eigen.py:407-418).  The port keeps it: after a
    restart the space holds the jmin Ritz vectors and that correction, and
    the pair still converges to an eigenvalue of the pencil."""
    J, B, w = _nonnormal_pencil()
    solver = JDQZ(DenseToyModel(J, B), {
        "Number of eigenvalues": 1, "Shift (imaginary part)": 3.0,
        "Tolerance": 1e-9, "Method": "JD", "Min size search space": 3,
        "Max size search space": 12, "GMRES search space": 2,
        "Max JD iterations": 200})
    solver.solve()
    assert solver.kmax_converged == 1
    assert len(solver._jd_restart_sizes) >= 1
    assert all(size == 3 + 1 for size in solver._jd_restart_sizes)
    assert _nearest(w, solver.eigenvalues).max() < 1e-7


def test_jd_accepted_residual_is_that_of_the_stored_vector():
    """The JAX package accepts a pair on the residual of the Ritz vector
    before its deflation (iemic_tpu/solvers/eigen.py:330-345), which is not
    the vector it stores.  In the port every stored vector is orthogonal
    to those accepted before it, and its own residual A u - lambda B u,
    computed here from the stored vector alone and deflated by
    orth(B u_i) of the earlier ones (the left space of the partial
    generalized Schur form), is under the tolerance; and no eigenvalue is
    found twice."""
    J, B, w = _nonnormal_pencil(seed=1)
    tol = 1e-9
    solver = JDQZ(DenseToyModel(J, B), {
        "Number of eigenvalues": 3, "Tolerance": tol,
        "Shift (imaginary part)": 1.0, "Method": "JD"})
    solver.solve()
    assert solver.kmax_converged == 3
    # the three eigenvalues nearest the target i, each once (on this
    # pencil the JAX package returns -1.8175 twice and misses the third)
    wanted = w[np.argsort(np.abs(w - 1j))][:3]
    assert _nearest(solver.eigenvalues, wanted).max() < 1e-8
    assert _nearest(w, solver.eigenvalues).max() < 1e-8
    Jc = torch.as_tensor(J, dtype=torch.complex128)
    Bc = torch.as_tensor(np.diag(B), dtype=torch.complex128)
    done, left = [], []
    for lam, u in zip(solver.eigenvalues, solver.eigenvectors):
        assert abs(float(torch.linalg.norm(u)) - 1.0) < 1e-12
        Au, Bu = Jc @ u, Bc @ u
        r = Au - complex(lam) * Bu
        for q in done:
            assert abs(complex(torch.vdot(q, u))) < 1e-10
        for z in left:
            r = r - torch.vdot(z, r) * z
        rel = float(torch.linalg.norm(r)) / (
            float(torch.linalg.norm(Au))
            + abs(lam) * float(torch.linalg.norm(Bu)))
        print(f"stored pair {lam}: residual {rel:.3e}")
        assert rel < tol, f"stored pair {lam}: residual {rel:.3e}"
        done.append(u)
        z = Bu.clone()
        for y in left:
            z = z - torch.vdot(y, z) * y
        left.append(z / torch.linalg.norm(z))


def test_jd_search_space_is_not_halved():
    """"Max size search space" bounds the Jacobi-Davidson search space as
    it bounds the Arnoldi one; the JAX package halves it on that path
    (iemic_tpu/solvers/eigen.py:225)."""
    J, B, _ = _nonnormal_pencil()
    solver = JDQZ(DenseToyModel(J, B), {
        "Number of eigenvalues": 1, "Shift (imaginary part)": 3.0,
        "Method": "JD", "Max size search space": 40})
    solver.solve()
    assert solver.jmax == 40 and solver._jd_jmax == 40


OCEAN443 = {"THCM": {
    "Global Grid-Size n": 4, "Global Grid-Size m": 4, "Global Grid-Size l": 3,
    "Starting Parameters": {"Combined Forcing": 0.2,
                            "Temperature Forcing": 10.0,
                            "Wind Forcing": 1.0}}}


def _dense_spectrum(ocean):
    """Finite generalized eigenvalues of the port ocean's pencil, by
    magnitude."""
    ocean.compute_jacobian()
    ocean.compute_mass_matrix()
    data, indices, indptr = stencil_to_csr(ocean.jac, periodic=False)
    A = sp.csr_matrix((data, indices, indptr)).toarray()
    w = scipy.linalg.eig(A, np.diag(to_flat(ocean.diagB).numpy()),
                         right=False)
    w = w[np.isfinite(w)]
    w = w[np.abs(w) < 1e8]
    return w[np.argsort(np.abs(w))]


def test_ocean_eigenvalues_match_dense():
    """The 4x4x3 ocean with the model's default solver stack (BGS, Mixed),
    as tests/test_eigen.py runs it: the two leading eigenvalues within
    1e-4 relative of the dense spectrum (measured 2e-9)."""
    ocean = TOcean(OCEAN443, solver_params={"FGMRES tolerance": 1e-12,
                                            "FGMRES iterations": 300},
                   device="cpu")
    ocean.compute_rhs()
    dense = _dense_spectrum(ocean)
    An = ocean.jac.clone()
    solver = JDQZ(ocean, {"Number of eigenvalues": 3, "Tolerance": 1e-7})
    solver.solve()
    mine = solver.eigenvalues[np.argsort(np.abs(solver.eigenvalues))]
    for k in range(2):
        d = np.min(np.abs(dense - mine[k]))
        print(f"eigenvalue {mine[k]}: {d:.3e} from the dense set")
        assert d < 1e-4 * max(1.0, abs(mine[k]))
    assert torch.equal(ocean.jac, An)
    assert solver.eigenvectors[0].shape == (ocean.state.numel(),)


@pytest.mark.parametrize("sigma", [0.0, -0.002])
def test_ocean_eigenvalues_match_jax(sigma):
    """The same ocean in both packages with exact shift-invert solves
    (Amesos), from the same rng(42) start vector, at shift 0 and at a real
    shift: eigenvalues to 1e-6 relative (measured 1e-12), and those of the
    dense spectrum nearest the shift."""
    sp_ = {"Preconditioning": "Amesos", "FGMRES tolerance": 1e-12,
           "FGMRES iterations": 50}
    pars = {"Number of eigenvalues": 3, "Tolerance": 1e-8,
            "Shift (real part)": sigma}
    to = TOcean(OCEAN443, solver_params=dict(sp_), device="cpu")
    jo = JOcean(OCEAN443, solver_params=dict(sp_))
    dense = _dense_spectrum(to)
    An = to.jac.clone()
    ts, js = JDQZ(to, dict(pars)), JJDQZ(jo, dict(pars))
    ts.solve()
    js.solve()
    assert ts.kmax_converged == js.kmax_converged == 3
    far = _nearest(ts.eigenvalues, js.eigenvalues)
    print(f"port against JAX: {far}")
    assert (far <= 1e-6 * np.abs(js.eigenvalues)).all()
    wanted = dense[np.argsort(np.abs(dense - sigma))][:2]
    assert (_nearest(ts.eigenvalues, wanted) <= 1e-6 * np.abs(wanted)).all()
    # the shifted Jacobian is gone again, to the bit
    assert torch.equal(to.jac, An)


def test_shifted_jacobian_gets_its_own_factors():
    """add_mass_to_jacobian makes a new tensor, so the next solve factors
    the shifted matrix (an in-place update would keep the factors and the
    row-scaled copy of the unshifted one), and compute_jacobian brings the
    unshifted tensor back to the bit."""
    ocean = TOcean(OCEAN443, solver_params={
        "Preconditioning": "BGS", "Precision": "Double",
        "FGMRES tolerance": 1e-10, "FGMRES iterations": 300}, device="cpu")
    ocean.compute_rhs()
    ocean.compute_jacobian()
    ocean.compute_mass_matrix()
    An = ocean.jac.clone()
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(
        tuple(ocean.state.shape)))
    b = ocean.apply_mass_matrix(b)
    ocean.solve(b)                      # factors of the unshifted matrix
    before = ocean.jac
    ocean.add_mass_to_jacobian(0.5)
    assert ocean.jac is not before and torch.equal(before, An)
    shifted = An.clone()
    for a in range(6):
        shifted[4, a, a] += 0.5 * ocean.diagB[a]
    assert torch.equal(ocean.jac, shifted)
    x = ocean.solve(b)
    r = ocean._apply(shifted, x) - b
    assert float(r.norm() / b.norm()) < 1e-8
    r0 = ocean._apply(An, x) - b        # not a solution of the unshifted
    assert float(r0.norm() / b.norm()) > 1e-3
    ocean.compute_jacobian()
    assert torch.equal(ocean.jac, An)
    x0 = ocean.solve(b)
    assert float((ocean._apply(An, x0) - b).norm() / b.norm()) < 1e-8


def _write_bundle(path):
    """A bundle of the 4x4x3 basin: one continuation step from the trivial
    solution with eigenvalue analysis at the converged point, exact solves
    (Amesos)."""
    thcm = dict(OCEAN443["THCM"], **{"Starting Parameters": dict(
        OCEAN443["THCM"]["Starting Parameters"],
        **{"Combined Forcing": 0.0})})
    write_xml(ParameterList("Ocean", {"THCM": thcm}),
              os.path.join(path, "ocean_params.xml"))
    write_xml(ParameterList("Continuation parameters", {
        "continuation parameter": "Combined Forcing",
        "initial step size": 0.05, "destination 0": 1.0,
        "maximum number of steps": 1, "Newton tolerance": 1e-10,
        "eigenvalue analysis": "P"}),
        os.path.join(path, "continuation_params.xml"))
    write_xml(ParameterList("Solver parameters", {
        "Preconditioning": "Amesos", "FGMRES tolerance": 1e-12,
        "FGMRES iterations": 50}), os.path.join(path, "solver_params.xml"))
    write_xml(ParameterList("JDQZ parameters", {
        "Number of eigenvalues": 3, "Tolerance": 1e-8}),
        os.path.join(path, "jdqz_params.xml"))


def _jax_run(workdir):
    """What iemic_tpu.main.run_ocean does in workdir, with the log and the
    working directory put back afterwards."""
    from iemic_tpu.main.run_ocean import read_solver_params
    cwd = os.getcwd()
    os.chdir(workdir)
    stream = open("info_0.txt", "w")
    jlog.set_log_stream(stream)
    jlog.set_cdata_file("cdata.txt")
    try:
        ocean = JOcean(jread_xml("ocean_params.xml"),
                       solver_params=read_solver_params())
        continuation = JContinuation(ocean,
                                     jread_xml("continuation_params.xml"))
        continuation.set_eigen_solver(
            JJDQZ(ocean, jread_xml("jdqz_params.xml")))
        result = continuation.run()
    finally:
        jlog.set_log_stream(sys.stdout)
        jlog.set_cdata_file(None)
        stream.close()
        os.chdir(cwd)
    return result, continuation


def _eigenvalue_file(path):
    import h5py
    with h5py.File(path, "r") as f:
        n = int(np.asarray(f["MetaData/NumEigs"]))
        lam = np.asarray(f["EigenValues/AlphaRe"]) \
            + 1j * np.asarray(f["EigenValues/AlphaIm"])
        vec = np.asarray(f["EV_Real_0/Values"])
    return n, lam, vec


def test_run_ocean_with_eigenvalue_analysis_matches_jax(tmp_path):
    """run_ocean with a jdqz_params.xml and eigenvalue analysis "P": the
    port writes ev_step_1.h5 with the eigenvalues the JAX run writes, to
    1e-6 relative (measured 1e-11), at the same continuation point."""
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    for d in (tdir, jdir):
        d.mkdir()
        _write_bundle(str(d))
    status, ocean, continuation = trun_ocean.run(str(tdir), "cpu")
    assert status == 0 and continuation.eigen_solver.kmax_converged == 3
    jres, jcont = _jax_run(str(jdir))
    assert jres.status == 0
    assert abs(continuation.par - jcont.par) <= 1e-10 * abs(jcont.par)
    nt, lt, vt = _eigenvalue_file(tdir / "ev_step_1.h5")
    nj, lj, _ = _eigenvalue_file(jdir / "ev_step_1.h5")
    assert nt == nj == 3
    print(f"port {lt}\njax  {lj}")
    assert (_nearest(lt, lj) <= 1e-6 * np.abs(lj)).all()
    assert vt.shape == (ocean.state.numel(),) and np.isfinite(vt).all()
