"""Pseudo-arclength continuation of steady states F(x, lambda) = 0.

Port of ``iemic_tpu/continuation.py`` (the reference's continuation
loop, src/continuation/Continuation.H): Euler/secant predictor,
bordered-system Newton corrector with two linear solves per iteration
and 'O'ld / 'N'ew normalization strategies, backtracking, secant
destination detection, Seydel step-size control, and failure-reset with
state00 double buffering.  The loop is host Python; norms and dots run
on the model's tensors.  A model whose state is split over ranks (the
sharded ocean, ``parallel.model``) gives its sums and maxima over the
ranks as ``reduce`` and ``reduce_max``; a model without them (or with
None, one rank) gets the serial arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .config import ParameterList
from .utils import logging as log


def _norm(v, model=None) -> float:
    reduce = getattr(model, "reduce", None)
    v = v.reshape(-1)
    if reduce is None:
        return float(log.host(torch.linalg.norm(v)))
    return float(log.host(torch.sqrt(reduce(torch.dot(v, v)[None])[0])))


def _dot(a, b, model=None) -> float:
    reduce = getattr(model, "reduce", None)
    if reduce is None:
        return float(log.host(torch.sum(a * b)))
    return float(log.host(reduce(torch.sum(a * b)[None])[0]))


def _norm_inf(v, model=None) -> float:
    reduce_max = getattr(model, "reduce_max", None)
    if reduce_max is None:
        return float(log.host(torch.amax(torch.abs(v))))
    return reduce_max(torch.abs(v))


def _size(v, model=None) -> float:
    """The number of entries of v, over the ranks."""
    reduce = getattr(model, "reduce", None)
    if reduce is None:
        return float(np.prod(tuple(v.shape)))
    return float(reduce(torch.tensor([v.numel()], dtype=torch.float64,
                                     device=v.device))[0])


def _missed_tolerance(model) -> tuple[float, float] | None:
    """(true relres, requested tolerance) of the model's last solve where
    that solve stopped short of its request, else None.  Models that
    record no relres (no ``solve_relres``/``solve_tol``) never miss."""
    relres = getattr(model, "solve_relres", None)
    tol = getattr(model, "solve_tol", None)
    if relres is None or tol is None or relres <= tol:
        return None
    return relres, tol


def _sgn(x: float) -> int:
    return 1 if x >= 0 else -1


def default_continuation_params() -> ParameterList:
    """Defaults of Continuation.H:1321-1370 getDefaultInitParameters."""
    p = ParameterList("Continuation parameters")
    p.set("continuation parameter", "Combined Forcing")
    p.set("initial step size", 1.0e-2)
    p.set("minimum step size", 1.0e-8)
    p.set("maximum step size", 1.0e3)
    p.set("increase step size", 1.25)
    p.set("decrease step size", 2.0)
    p.set("epsilon increment", 1.0e-5)
    p.set("enable backtracking", False)
    p.set("backtracking steps", 0)
    p.set("backtracking increase", 0.0)
    p.set("maximum number of steps", -1)
    p.set("maximum Newton iterations", 7)
    p.set("minimum Newton iterations", 1)
    p.set("optimal Newton iterations", 3.5)
    p.set("Newton tolerance", 1.0e-4)
    p.set("destination tolerance", 1.0e-7)
    p.set("enable custom monitor", False)
    p.set("detection of special points", "D")
    p.set("state tangent scaling", 1.0)
    p.set("normalize strategy", "N")
    p.set("eigenvalue analysis", "N")
    p.set("reject failed iteration", True)
    p.set("give up at minimum step size", True)
    p.set("enable Newton Chord hybrid solve", False)
    p.set("tangent type", "S")
    p.set("corrector residual test", "D")
    p.set("initial tangent type", "E")
    p.set("print important vectors", False)
    p.set("post processing", "at every point")
    p.set("predictor bound", 1e3)
    for i in range(32):
        p.set(f"destination {i}", -999.0)
    return p


@dataclass
class _Storage:
    """Previous-step storage (ContinuationDecl.H Storage struct)."""
    state0: object = None
    state00: object = None
    stateDot0: object = None
    par0: float = 0.0
    par00: float = 0.0
    ds0: float = 0.0
    ds00: float = 0.0
    parDot0: float = 0.0


@dataclass
class ContinuationResult:
    status: int = 0
    steps: int = 0
    resets: int = 0
    sum_newton_iters: int = 0
    par: float = 0.0
    history: list = field(default_factory=list)


class Continuation:
    def __init__(self, model, pars: ParameterList | dict | None = None):
        if pars is None:
            pars = ParameterList("Continuation parameters")
        if isinstance(pars, dict):
            pars = ParameterList("Continuation parameters", pars)
        pars.validate_and_set_defaults(default_continuation_params())
        self.pars = pars
        self.model = model

        g = pars.get
        self.par_name = g("continuation parameter")
        self.ds_init = g("initial step size")
        self.ds_min = g("minimum step size")
        self.ds_max = g("maximum step size")
        self.scale1 = g("increase step size")
        self.scale2 = g("decrease step size")
        self.epsilon = g("epsilon increment")
        self.back_tracking = g("enable backtracking")
        self.num_backtracking_steps = g("backtracking steps")
        self.backtrack_increase = g("backtracking increase")
        self.max_steps = g("maximum number of steps")
        self.max_newton_iters = g("maximum Newton iterations")
        self.min_newton_iters = g("minimum Newton iterations")
        self.opt_newton_iters = g("optimal Newton iterations")
        self.newton_tol = g("Newton tolerance")
        self.destination_tol = g("destination tolerance")
        self.user_detect_flag = g("enable custom monitor")
        self.detect_mode = g("detection of special points")
        self.tan_scaling = g("state tangent scaling")
        self.normalize_strategy = g("normalize strategy")
        self.eigenvalue_analysis = g("eigenvalue analysis")
        self.reject_failed_newton = g("reject failed iteration")
        self.give_up_at_ds_min = g("give up at minimum step size")
        self.newt_chord_hybr = g("enable Newton Chord hybrid solve")
        self.tangent_type = g("tangent type")
        self.residual_test = g("corrector residual test")
        self.initial_tangent = g("initial tangent type")
        self.post_processing = g("post processing")
        self.predictor_bound = g("predictor bound")

        self.destinations_backup = []
        for i in range(32):
            d = g(f"destination {i}")
            if abs(d + 999.0) < 1e-7:
                break
            self.destinations_backup.append(d)
        if not self.destinations_backup:
            raise ValueError("No destinations given for continuation")

        self.eigen_solver = None   # set via set_eigen_solver

    def set_eigen_solver(self, solver) -> None:
        self.eigen_solver = solver

    # reductions over the model's state, over its ranks where it has them
    def _norm(self, v) -> float:
        return _norm(v, self.model)

    def _dot(self, a, b) -> float:
        return _dot(a, b, self.model)

    def _norm_inf(self, v) -> float:
        return _norm_inf(v, self.model)

    # ------------------------------------------------------------------
    def initialize(self):
        m = self.model
        self.ds = self.ds_init
        self.ds_start = self.ds_init
        m.compute_rhs()
        self.par = m.get_par(self.par_name)
        self.starting_par = self.par

        self.storage = _Storage(
            ds0=self.ds, ds00=self.ds, par0=self.par, par00=self.par,
            parDot0=0.0, state0=m.get_state())

        self.destinations = list(self.destinations_backup)
        self.sign_monitor = [0] * len(self.destinations)
        self.secant = False

        N = _size(m.get_state(), m)
        if self.normalize_strategy == "O":
            self.zeta = 1.0 / N
        else:
            self.zeta = self.tan_scaling / N

        self.newton_iter = 0
        self.sum_newton_iter = 0
        self.par_dot_sign = 1
        self.par_dot = 0.0
        self.state_dot = None

        self.step_ = 0
        self.reset_counter = 0
        self.reached_last_dest = False
        self.abort_flag = False
        self.fix_step_size = False
        self.par_hist: list[float] = []
        self.state_norm_hist: list[float] = []
        self.norm_rhs = 0.0
        self.norm_rhs_test = 0.0

    # ------------------------------------------------------------------
    def run(self) -> ContinuationResult:
        log.INFO("Continuation: run initialize...")
        self.initialize()
        with log.timer("Continuation: run"):
            self.create_initial_tangent()
            result = ContinuationResult()
            while (not self.reached_last_dest
                   and self.step_ != self.max_steps
                   and not self.abort_flag):
                self.step_ += 1
                self.info()
                self.store()
                status = self.step()
                if status:
                    self.reset()
                    continue
                self.detect()
                self.user_detect()
                self.adjust_step()

        if self.abort_flag:
            log.WARNING("Continuation aborted!")
            result.status = 1
        result.steps = self.step_
        result.resets = self.reset_counter
        result.sum_newton_iters = self.sum_newton_iter
        result.par = self.par
        result.history = self.par_hist
        log.INFO("---------Finished continuation run--------------")
        return result

    # ------------------------------------------------------------------
    def step(self) -> int:
        with log.timer("Continuation: step"):
            self.model.pre_process()
            if self.euler_predictor():
                return 1
            with log.timer("Continuation: Newton"):
                status = self.newton_corrector()
            if status:
                return 1

            self.par_hist.append(self.par)
            self.state_norm_hist.append(self._norm(self.model.get_state()))
            self.analyze_hist()
            self.create_tangent(self.tangent_type)

            if self.eigenvalue_analysis == "P":
                self.run_eigen_solver()
            if self.post_processing == "at every point":
                self.model.post_process()
            self.write_data(self.step_ == 1)
        return 0

    # ------------------------------------------------------------------
    def compute_dfdpar(self, mode: str):
        """FD derivative of the RHS w.r.t. the continuation parameter
        (Continuation.H:387-418); keeps a copy of F(par) in rhs_copy."""
        m = self.model
        if mode == "F":
            m.compute_rhs()
        self.rhs_copy = m.get_rhs()
        m.set_par(self.par_name, self.par + self.epsilon)
        m.compute_rhs()
        m.set_par(self.par_name, self.par)
        self.dfdpar = (m.get_rhs() - self.rhs_copy) / self.epsilon

    def create_initial_tangent(self):
        log.INFO("Continuation: create initial tangent...")
        m = self.model
        self.compute_dfdpar("F")
        if self.initial_tangent in ("E", "S"):
            m.pre_process()
            m.compute_jacobian()
            m.solve(-self.dfdpar)
            self.state_dot = m.get_solution()
        elif self.initial_tangent == "A":
            self.state_dot = -self.dfdpar
        else:
            log.WARNING("initialTangent invalid!")
        self.normalize()
        # restore consistent rhs in the model (dfdpar left F(par+eps))
        m.compute_rhs()
        log.INFO(f"   ||state||  = {self._norm(m.get_state()):.8e}")
        log.INFO(f"   ||stateDot|| = {self._norm(self.state_dot):.8e}")
        log.INFO(f"   parDot     = {self.par_dot:.8e}")

    def create_tangent(self, mode: str):
        """Secant or Euler tangent (Continuation.H:421-493)."""
        m = self.model
        if mode == "S":
            par0 = self.storage.par0
            ds0 = self.storage.ds0
            self.state_dot = (m.get_state() - self.storage.state0) / ds0
            self.par = m.get_par(self.par_name)
            self.par_dot = (self.par - par0) / ds0
        elif mode == "E":
            if self.newt_chord_hybr:
                self.compute_dfdpar("F")
                m.compute_jacobian()
                m.solve(-self.dfdpar)
                self.state_dot = m.get_solution()
            elif self.newton_iter != 0:
                # corrector left y with J*y = dFdPar; flip sign
                self.state_dot = -self.state_dot
            else:
                log.WARNING("undefined behaviour in create_tangent!")
            self.normalize()
        else:
            log.WARNING("invalid tangent mode!")

    def normalize(self):
        """Tangent normalization (Continuation.H:496-543)."""
        nrm = self._norm(self.state_dot)
        if self.normalize_strategy == "O":
            self.zeta = self.tan_scaling / nrm
            self.state_dot = self.state_dot * self.zeta
            nrm2 = self._norm(self.state_dot)
            norm_comb = np.sqrt(nrm2 * nrm2 + 1.0)
            self.state_dot = self.state_dot / norm_comb
            self.par_dot = 1.0 / norm_comb
        elif self.normalize_strategy == "N":
            norm_comb = np.sqrt(self.zeta * nrm * nrm + 1.0)
            self.par_dot = 1.0 / norm_comb
            self.state_dot = self.state_dot * self.par_dot
        else:
            log.WARNING("undefined normalization strategy!")

    # ------------------------------------------------------------------
    def euler_predictor(self) -> int:
        m = self.model
        m.set_state(m.get_state() + self.ds * self.state_dot)
        self.par = self.par + self.ds * self.par_dot
        m.set_par(self.par_name, self.par)
        m.compute_rhs()
        rhs_nrm = self._norm(m.get_rhs())
        log.INFO(f"   predictor: par={self.par:.8e}  |rhs|={rhs_nrm:.3e}")
        if rhs_nrm > self.predictor_bound:
            log.INFO("   predictor: rhs too big!")
            return 1
        return 0

    def newton_corrector(self) -> int:
        """Bordered-system Newton corrector (Continuation.H:585-813)."""
        m = self.model
        dot = self._dot
        res0 = 100.0
        res = 100.0
        y = None
        self.newton_iter = 0
        stalled = False
        while self.newton_iter < self.max_newton_iters:
            with log.timer("Continuation: Newton iteration"):
                res0 = res
                mode = "F" if self.newton_iter == 0 else "A"
                self.compute_dfdpar(mode)

                R = -self.rhs_copy
                self.norm_rhs = self._norm(self.rhs_copy)

                state_diff = m.get_state() - self.storage.state0
                par_diff = self.par - self.storage.par0

                if self.normalize_strategy == "O":
                    rbp = (self.ds
                           - dot(self.state_dot, state_diff) * self.zeta
                           - self.par_dot * par_diff)
                elif self.normalize_strategy == "N":
                    rbp = (self.ds * self.ds
                           - dot(state_diff, state_diff) * self.zeta
                           - par_diff * par_diff)
                else:
                    log.WARNING("undefined normalization strategy!")
                    rbp = 0.0

                m.compute_jacobian()

                missed = []
                if not self.newt_chord_hybr:
                    m.solve(self.dfdpar)
                    y = m.get_solution()
                    missed.append(_missed_tolerance(m))
                m.solve(R)
                z = m.get_solution()
                missed.append(_missed_tolerance(m))
                missed = [mt for mt in missed if mt is not None]

                if self.normalize_strategy == "O":
                    if self.newt_chord_hybr:
                        par_dir = ((rbp - self.zeta * dot(self.state_dot, z))
                                   / (self.par_dot + self.zeta
                                      * dot(self.state_dot, self.state_dot)))
                    else:
                        par_dir = ((rbp - self.zeta * dot(self.state_dot, z))
                                   / (self.par_dot - self.zeta
                                      * dot(self.state_dot, y)))
                else:
                    if self.newt_chord_hybr:
                        par_dir = ((rbp - 2 * self.zeta * dot(state_diff, z))
                                   / (2 * par_diff + 2 * (self.zeta / par_diff)
                                      * dot(state_diff, state_diff)))
                    else:
                        par_dir = ((rbp - 2 * self.zeta * dot(state_diff, z))
                                   / (2 * par_diff - 2 * self.zeta
                                      * dot(state_diff, y)))

                if self.newt_chord_hybr:
                    state_dir = z + par_dir * self.state_dot
                else:
                    state_dir = z - par_dir * y

                m.set_state(m.get_state() + state_dir)
                self.par = self.par + par_dir
                m.set_par(self.par_name, self.par)

                self.newton_iter += 1
                self.sum_newton_iter += 1

                m.compute_rhs()
                self.norm_rhs_test = self._norm(m.get_rhs())

                if self.norm_rhs_test > self.predictor_bound:
                    log.INFO(f" norm too big! {self.norm_rhs_test:.3e}")
                    return 1

                if self.back_tracking and self.norm_rhs < self.norm_rhs_test:
                    if self.run_backtracking(state_dir, par_dir):
                        return 1

                nrm_state0 = self._norm(self.storage.state0)
                if self._norm(state_dir) > 1e3 * nrm_state0 and nrm_state0 > 0:
                    log.WARNING(f"  |dx| = {self._norm(state_dir):.3e} >> "
                                f"old |x| = {nrm_state0:.3e}")
                    return 1

                if self.residual_test == "R":
                    res = self.norm_rhs_test
                elif self.residual_test == "D":
                    res = max(abs(par_dir), self._norm_inf(state_dir))
                    # a small update from a solve that made no progress is no
                    # sign of convergence: under "D" the iterate counts only
                    # where every solve of this iteration reached its request
                    # (the JAX corrector, iemic_tpu/continuation.py:433-446,
                    # accepts such updates; ROADMAP queue 3)
                    for relres, tol in missed:
                        log.INFO(f"   Newton iter {self.newton_iter}: a "
                                 f"solve stopped at relres {relres:.3e}, "
                                 f"short of its tolerance {tol:.3e}; the "
                                 f"update does not count as converged")
                    stalled = bool(missed)
                else:
                    log.WARNING("undefined residual test!")
                    res = 999.0

                log.INFO(f"   Newton iter {self.newton_iter}: "
                         f"|R|={self.norm_rhs_test:.3e} res={res:.3e} "
                         f"dl={par_dir:.3e} l={self.par:.8e} "
                         f"ratio={res0 / res if res else np.inf:.2f}")

                if res < self.newton_tol and not stalled \
                        and self.newton_iter >= self.min_newton_iters:
                    break

        if not self.newt_chord_hybr:
            self.state_dot = y

        log.track_iterations("Continuation: Newton iterations...",
                             self.newton_iter)

        if res > self.newton_tol or stalled:
            log.INFO(f"Continuation: Newton failed after "
                     f"{self.newton_iter} steps")
            if self.reject_failed_newton:
                return 1
            log.INFO("Continuation: proceeding with unconverged result")
        else:
            log.INFO(f"Continuation: corrector converged in "
                     f"{self.newton_iter} steps")
        return 0

    def run_backtracking(self, state_dir, par_dir) -> int:
        """Backtracking line search (Continuation.H:816-854)."""
        m = self.model
        reduction = -0.5
        increase = self.backtrack_increase
        back_track = 0
        for back_track in range(self.num_backtracking_steps):
            if self.norm_rhs_test < self.norm_rhs * increase:
                break
            m.set_state(m.get_state() + reduction * state_dir)
            self.par = self.par + reduction * par_dir
            m.set_par(self.par_name, self.par)
            m.compute_rhs()
            self.norm_rhs_test = self._norm(m.get_rhs())
            log.INFO(f"    backtracking step {back_track}, "
                     f"norm {self.norm_rhs_test:.3e}")
            reduction /= 2.0
        log.track_iterations("Continuation: backtracking steps...",
                             back_track)
        if (self.norm_rhs_test > self.norm_rhs * increase
                and self.num_backtracking_steps > 0):
            log.WARNING("Continuation: backtracking failed")
            return 1
        return 0

    # ------------------------------------------------------------------
    def detect(self):
        """Destination / fold detection with secant iteration
        (Continuation.H:856-932)."""
        dest = self.destinations[0]
        self.par = self.model.get_par(self.par_name)

        if self.detect_mode == "D":
            f0 = self.storage.par0 - dest
            f1 = self.par - dest
        elif self.detect_mode == "P":
            f0 = self.storage.parDot0
            f1 = self.par_dot
        else:
            raise ValueError(f"Invalid detectMode {self.detect_mode}")

        if f1 == f0:
            log.WARNING(f"This should not happen: f1 == f0 == {f1}")

        if self.sign_monitor[0] == 0:
            self.sign_monitor[0] = _sgn(f1)

        if self.sign_monitor[0] != _sgn(f1) and not self.secant:
            log.INFO(f"detect(): sign switch, activated dest {dest}")
            self.secant = True
            self.ds_start = self.ds
        else:
            self.sign_monitor[0] = _sgn(f1)

        if self.secant:
            self.ds = -f1 * self.ds / (f1 - f0)
            log.INFO(f"    secant: f1={f1:.3e} f0={f0:.3e} "
                     f"new ds={self.ds:.3e}")
            self.create_tangent("S")

        if self.secant and abs(f1) < self.destination_tol:
            log.INFO(f"detect(): destination {dest} reached.")
            if self.eigenvalue_analysis == "E":
                self.run_eigen_solver()
            self.secant = False
            self.ds = self.ds_start
            self.fix_step_size = True
            self.destinations.pop(0)
            self.sign_monitor.pop(0)
            if not self.destinations:
                self.reached_last_dest = True
            else:
                self.sign_monitor[0] = _sgn(self.par
                                            - self.destinations[0])

    def user_detect(self):
        if self.user_detect_flag and self.model.monitor():
            log.INFO("userDetect(): stopping criterion met")
            self.reached_last_dest = True

    def adjust_step(self):
        """Seydel step-size control (Continuation.H:951-981)."""
        if self.secant or self.fix_step_size:
            self.fix_step_size = False
            return
        factor = self.opt_newton_iters / max(self.newton_iter, 1)
        factor = min(max(factor, 0.5), 2.0)
        self.ds *= factor
        if abs(self.ds) > abs(self.ds_max):
            self.ds = _sgn(self.ds) * abs(self.ds_max)
        if abs(self.ds) < abs(self.ds_min):
            self.ds = _sgn(self.ds) * abs(self.ds_min)

    def analyze_hist(self):
        if len(self.par_hist) > 5:
            if abs(self.par_hist[-1] - self.par_hist[-3]) < 1e-8:
                log.INFO("Parameter appears to stagnate... "
                         "(adjust zeta or ds)")

    # ------------------------------------------------------------------
    def store(self):
        s = self.storage
        s.state00 = s.state0
        s.state0 = self.model.get_state()
        s.stateDot0 = self.state_dot
        s.par00 = s.par0
        s.par0 = self.model.get_par(self.par_name)
        s.ds00 = s.ds0
        s.ds0 = self.ds
        s.parDot0 = self.par_dot

    def restore(self):
        s = self.storage
        self.model.set_state(s.state0)
        self.model.set_par(self.par_name, s.par0)
        self.par = s.par0
        self.ds = s.ds0
        self.state_dot = s.stateDot0
        s.state0 = s.state00
        s.state00 = self.model.get_state()
        s.par0 = s.par00
        s.ds0 = s.ds00

    def reset(self):
        """Failed-step reset (Continuation.H:1004-1049)."""
        log.INFO("Continuation: reset...")
        self.step_ -= 1
        self.restore()
        s = _sgn(self.ds)
        self.ds = s * max(abs(self.ds) / self.scale2, abs(self.ds_min))
        self.reset_counter += 1
        self.fix_step_size = True
        if (abs(self.ds) <= abs(self.ds_min)
                and (self.reset_counter >= 100 or self.give_up_at_ds_min)):
            self.abort_flag = True
            log.WARNING("Reached dsMin, continuation failed")

    # ------------------------------------------------------------------
    def run_eigen_solver(self):
        """(Continuation.H:1105-1131: solve + save ev_step_<n>)"""
        if self.eigenvalue_analysis != "N" and self.eigen_solver:
            self.eigen_solver.solve()
            try:
                from .utils import hdf5 as h5
                h5.save_eigenvectors(
                    f"ev_step_{self.step_}.h5",
                    self.eigen_solver.alpha, self.eigen_solver.beta,
                    [v.cpu().numpy() if torch.is_tensor(v) else v
                     for v in self.eigen_solver.eigenvectors])
            except Exception as e:   # saving must not kill the run
                log.WARNING(f"could not save eigenvectors: {e}")

    def info(self):
        log.INFO("-----------------------------------------")
        log.INFO(f" step {self.step_}  ds={self.ds:.6e}  "
                 f"par={self.par:.8e}  dest={self.destinations[-1]}")
        log.INFO(f" ||x||={self._norm(self.model.get_state()):.6e}  "
                 f"parDot={self.par_dot:.4e}  "
                 f"resets={self.reset_counter}")

    def write_data(self, describe: bool):
        """cdata.txt output (Continuation.H:1278-1319)."""
        if describe:
            header = (f"#{'par':>15}{'ds':>12}{'||x||':>12}{'||F||':>12}"
                      f"{'NR':>5}" + self.model.write_data(True))
            log.write_cdata(header)
        line = (f"{self.par:>16.8e}{self.ds:>12.4e}"
                f"{self._norm(self.model.get_state()):>12.4e}"
                f"{self._norm(self.model.get_rhs()):>12.4e}"
                f"{self.newton_iter:>5d}" + self.model.write_data(False))
        log.write_cdata(line)
