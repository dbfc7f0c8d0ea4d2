"""Port parity of the Lyapunov covariance solve: ``rails``,
``LyapunovModel`` and ``run_lyapunov`` against the JAX package, on the
CPU in f64, from the same inputs and seeds; and the minimal-norm Schur
step that stands in for numpy's ``lstsq`` (on CUDA ``torch.linalg.lstsq``
has only the full-rank ``gels`` driver).

Where rails has not converged, the two packages stay together only for
its first iterations: each iteration expands the search space by the
dominant eigenvectors of a 20-step Lanczos estimate of the residual,
and that choice turns rounding differences of 1e-16 into 1e-10 after
about ten iterations and into 0.17 of the residual estimate after
twenty (measured on the 4x4x4 ocean below; on the 4x8x4 2DMOC grid
the trace parts by 1e-9 after five iterations and 1e-4 after six).  The
ocean's covariance solves are therefore held over their first
iterations.
"""

import inspect
import os
import shutil

import numpy as np
import pytest
import torch

from test_lyapunov import _laplacian_1d
from test_torch_transient_main import _jax_main
from iemic_tpu.lyapunov import LyapunovModel as JLyapunovModel
from iemic_tpu.lyapunov import rails as jrails
from iemic_tpu.models.ocean import Ocean as JOcean
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch.lyapunov import LyapunovModel as TLyapunovModel
from iemic_tpu_torch.lyapunov import min_norm_solve, svd_min_norm, rails as trails
from iemic_tpu_torch.main import run_lyapunov
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.utils import logging as tlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRECT = {"Preconditioning": "Amesos", "FGMRES tolerance": 1e-10,
          "FGMRES iterations": 400}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch and the BLAS and OpenMP pools on one thread in this module:
    its problems are small, and where several test workers share the
    cores the threads of each small product spin against the other
    workers (measured: a test of this module 7 times slower with the
    default threads)."""
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


def _dense_problems():
    """The two problems of tests/test_lyapunov.py: (A, B, tol, maxiter)."""
    A1 = _laplacian_1d(60)
    B1 = np.random.default_rng(3).standard_normal((60, 2))
    rng = np.random.default_rng(11)
    A2 = _laplacian_1d(40) + 0.3 * np.triu(rng.standard_normal((40, 40)), 1)
    B2 = rng.standard_normal((40, 1))
    return {"symmetric": (A1, B1, 1e-8, 60),
            "nonsymmetric": (A2, B2, 1e-7, 80)}


@pytest.mark.parametrize("case", ["symmetric", "nonsymmetric"])
def test_rails_matches_jax(case):
    """X = V T V^T to 1e-9 of |X| (measured 2.6e-10 on the symmetric
    problem) in the same iterations, both converged, on the dense
    problems of tests/test_lyapunov.py."""
    A, B, tol, maxiter = _dense_problems()[case]
    rj = jrails(lambda W: A @ np.asarray(W), B, tol=tol, maxiter=maxiter)
    At = torch.as_tensor(A)
    rt = trails(lambda W: At @ W, torch.as_tensor(B), tol=tol,
                maxiter=maxiter)
    assert rt.converged and rj.converged
    assert rt.iterations == rj.iterations
    Xj = rj.V @ rj.T @ rj.V.T
    Vt = rt.V.numpy()
    Xt = Vt @ rt.T @ Vt.T
    assert np.abs(Xt - Xj).max() <= 1e-9 * np.abs(Xj).max()
    R = A @ Xt + Xt @ A.T + B @ B.T
    assert np.linalg.norm(R) <= 1e-5 * np.linalg.norm(B @ B.T)


def _box4():
    """The 4x4x4 ocean of tests/test_lyapunov.py's slow test."""
    return {"THCM": {"Global Grid-Size n": 4, "Global Grid-Size m": 4,
                     "Global Grid-Size l": 4, "Periodic": False,
                     "Starting Parameters": {"Combined Forcing": 0.0}}}


LYAP = {"Tolerance": 1e-4, "Maximum Iterations": 8,
        "Noise Amplitude": 1e-2}


def test_solve_covariance_matches_jax():
    """solve_covariance on the 4x4x4 ocean (eight rails iterations, see
    the module's docstring): trace, spectrum, residual estimate and
    iterations to 1e-8 relative, the covariance factor to 1e-8, and the
    spectrum non-negative as tests/test_lyapunov.py asks."""
    rj = JLyapunovModel(JOcean(_box4()), LYAP).solve_covariance()
    rt = TLyapunovModel(TOcean(_box4(), device="cpu"),
                        LYAP).solve_covariance()
    assert rt["iterations"] == rj["iterations"]
    assert rt["converged"] == rj["converged"]
    for key in ("trace", "resnorm"):
        assert abs(rt[key] - rj[key]) <= 1e-8 * abs(rj[key]), key
    top = abs(rj["spectrum"][0])
    assert np.abs(rt["spectrum"] - rj["spectrum"]).max() <= 1e-8 * top
    assert np.all(rt["spectrum"] >= -1e-8 * max(1.0, top))
    np.testing.assert_array_equal(rt["mass"], rj["mass"])
    Xj = rj["V"] @ rj["T"] @ rj["V"].T
    Xt = rt["V"] @ rt["T"] @ rt["V"].T
    assert np.abs(Xt - Xj).max() <= 1e-8 * np.abs(Xj).max()
    assert set(rt["seconds"]) == {"dense Jacobian", "Schur complement",
                                  "rails"}


def test_min_norm_solve_is_lstsq():
    """The Schur step's minimal-norm solve equals np.linalg.lstsq with
    rcond=None on a rank-deficient block, on the host (lstsq itself) and
    by the SVD that the card takes: a random block of rank 30 of 40, and
    the ocean's own (w, p) block A22, whose pressure checkerboard leaves
    it rank-deficient."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((40, 30)) @ rng.standard_normal((30, 40))
    B = rng.standard_normal((40, 7))
    o = TOcean(_box4(), device="cpu")
    model = TLyapunovModel(o, LYAP)
    o.compute_jacobian()
    mdiag, mass, dummy = model._mass_partition()
    J = model._dense_jacobian(mdiag.numel()).numpy()
    m_, d_ = mass.numpy(), dummy.numpy()
    A22, A21 = J[np.ix_(d_, d_)], J[np.ix_(d_, m_)]
    for M, R in ((A, B), (A22, A21)):
        want, _, rank, _ = np.linalg.lstsq(M, R, rcond=None)
        assert rank < M.shape[1]
        for solve in (min_norm_solve, svd_min_norm):
            got = solve(torch.as_tensor(M), torch.as_tensor(R)).numpy()
            assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def _lyapunov_bundle(path):
    """run/lyapunov (4x32x16 2DMOC) cut to 4x8x4 and two continuation
    steps, with direct solves (Amesos), at most four rails iterations
    (the module's docstring: at this size the two packages part after
    five) and no state file."""
    from iemic_tpu_torch.config import ParameterList, read_xml, write_xml
    shutil.copytree(os.path.join(REPO, "run", "lyapunov"), path)
    op = read_xml(os.path.join(path, "ocean_params.xml"))
    op.set("Save state", False)
    t = op.sublist("THCM")
    t.set("Global Grid-Size m", 8)
    t.set("Global Grid-Size l", 4)
    write_xml(op, os.path.join(path, "ocean_params.xml"))
    cp = read_xml(os.path.join(path, "continuation_params.xml"))
    cp.set("maximum number of steps", 2)
    write_xml(cp, os.path.join(path, "continuation_params.xml"))
    lp = read_xml(os.path.join(path, "lyapunov_params.xml"))
    lp.set("Maximum Iterations", 4)
    write_xml(lp, os.path.join(path, "lyapunov_params.xml"))
    write_xml(ParameterList("Solver parameters", dict(DIRECT)),
              os.path.join(path, "solver_params.xml"))
    return str(path)


def _rows(path):
    return [ln.split() for ln in open(path) if not ln.startswith("#")]


def test_run_lyapunov_matches_jax(tmp_path):
    """run_lyapunov end to end in both packages on the cut bundle: status
    0 (the JAX main returns the continuation's result object, not its
    status, ROADMAP queue 3) and the rows of lyapunov_data.txt to 1e-6."""
    from iemic_tpu.main import run_lyapunov as jrun_lyapunov
    jdir, tdir = (_lyapunov_bundle(tmp_path / p) for p in ("jax", "port"))
    assert _jax_main(jrun_lyapunov.main, jdir).status == 0
    assert run_lyapunov.main([tdir, "--device", "cpu"]) == 0
    rj, rt = (_rows(os.path.join(d, "lyapunov_data.txt"))
              for d in (jdir, tdir))
    assert len(rt) == len(rj) == 2
    for a, b in zip(rt, rj):
        assert a[3:] == b[3:]                          # its, conv
        np.testing.assert_allclose([float(v) for v in a[:3]],
                                   [float(v) for v in b[:3]], rtol=1e-6)
    assert os.path.exists(os.path.join(tdir, "profile_output"))


def test_run_lyapunov_defaults_to_the_card(tmp_path):
    """run_lyapunov runs on the card unless asked for the CPU, and raises
    where there is none."""
    assert inspect.signature(run_lyapunov.run).parameters["device"] \
        .default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_lyapunov.main([str(tmp_path)])
        assert os.listdir(tmp_path) == []
