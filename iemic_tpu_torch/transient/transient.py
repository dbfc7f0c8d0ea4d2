"""Transient runs and rare-event algorithms: AMS, TAMS, GPA, naive
(PyTorch).

Port of ``iemic_tpu/transient/transient.py`` (the reference's Transient
class, src/transient/Transient.hpp:13-852, TransientDecl.hpp:13-142):
trajectory data structures (AMSExperiment/GPAExperiment), the shared
elimination loop with multi-trajectory elimination, branching from a
random higher-scoring trajectory, periodic cleanup, MFPT/probability
estimators, restartable experiment files and a seedable random engine.

Trajectory states are tensors on the model's device; the outer algorithm
is host control flow, as in the reference.  The random engine is the JAX
package's ``np.random.default_rng``, and the restart file keeps its pickle
layout of numpy arrays, so that a file written by either package resumes
in the other.
"""

from __future__ import annotations

import math
import os
import pickle
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import logging as log


@dataclass(eq=False)
class AMSExperiment:
    """One AMS/TAMS trajectory (Transient.hpp:13-47)."""
    x0: object = None
    xlist: list = field(default_factory=list)
    dlist: list = field(default_factory=list)
    tlist: list = field(default_factory=list)
    max_distance: float = 0.0
    time: float = 0.0
    initial_time: float = 0.0
    return_time: float = 0.0
    initialized: bool = False
    converged: bool = False


@dataclass(eq=False)
class GPAExperiment:
    """One GPA particle (Transient.hpp:49-56)."""
    x: object = None
    weight: float = 1.0
    probability: float = 1.0
    distance: float = 0.0
    converged: bool = False


class Transient:
    def __init__(self, time_step=None, dist_fun=None, x0=None,
                 vector_length: int = 0):
        self.time_step_fn = time_step
        self.dist_fun = dist_fun
        self.method = "TAMS" if dist_fun is not None else "Transient"
        self.x0 = x0
        self.vector_length = vector_length
        self.mfpt = -1.0
        self.probability = -1.0
        self.rng = None
        self.its = 0
        self.time_steps = 0
        self.time_steps_previous_write = 0
        self.ell: list[int] = []

        # defaults (Transient.hpp:134-172 set_parameters)
        self.dt = 0.01
        self.tmax = 1000.0
        self.tstep = 1.0
        self.beta = 1.0
        self.bdist = 0.05
        self.dist_tol = 0.0005
        self.num_exp = 1000
        self.adist = 0.05
        self.cdist = 2 * self.adist
        self.num_init_exp = self.num_exp
        self.maxit = self.num_exp * 10
        self.read_file = ""
        self.write_file = ""
        self.write_final = True
        self.write_steps = -1
        self.write_time_steps = -1
        self.in_days = 737.2685
        self.in_years = self.in_days / 365.0

    def set_parameters(self, params: dict) -> None:
        g = params.get
        self.method = g("method", self.method)
        self.dt = g("time step", 0.01)
        self.tmax = g("maximum time", 1000.0)
        self.in_days = g("timescale in days", 737.2685)
        self.in_years = g("timescale in years", self.in_days / 365.0)
        self.dt = g("time step (in y)", self.dt * self.in_years) \
            / self.in_years
        self.tmax = g("maximum time (in y)", self.tmax * self.in_years) \
            / self.in_years
        self.tstep = g("GPA time step", 1.0)
        self.beta = g("beta", 1.0)
        self.bdist = g("B distance", 0.05)
        self.dist_tol = g("distance tolerance", 0.0005)
        self.num_exp = g("number of experiments", 1000)
        self.adist = g("A distance", 0.05)
        self.cdist = g("C distance", 2 * self.adist)
        self.num_init_exp = max(
            g("number of initial experiments", self.num_exp), self.num_exp)
        self.maxit = g("maximum iterations", self.num_exp * 10)
        self.read_file = g("read file", "")
        self.write_file = g("write file", "")
        self.write_final = g("write final state", True)
        self.write_steps = g("write steps", -1)
        self.write_time_steps = g("write time steps", -1)

    # -- RNG -----------------------------------------------------------
    def set_random_engine(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def _randint(self, a: int, b: int) -> int:
        if self.rng is None:
            self.rng = np.random.default_rng()
            log.WARNING("Random engine not initialized.")
        return int(self.rng.integers(a, b + 1))

    def _randreal(self, a: float, b: float) -> float:
        if self.rng is None:
            self.rng = np.random.default_rng()
            log.WARNING("Random engine not initialized.")
        return float(self.rng.uniform(a, b))

    def _step(self, x, dt):
        self.time_steps += 1
        return self.time_step_fn(x, dt)

    # -- plain transients (Transient.hpp:174-221) ----------------------
    def transient(self, x, dt, tmax):
        t = dt
        while t <= tmax:
            x = self._step(x, dt)
            t += dt
        return x

    def transient_max_distance(self, x, dt, tmax, max_distance):
        lim = max_distance - self.bdist
        t = dt
        while t <= tmax:
            x = self._step(x, dt)
            if self.dist_fun(x) > lim:
                return t
            t += dt
        return -1.0

    def transient_start(self, x0, dt, tmax, exp: AMSExperiment):
        x = x0
        exp.initial_time = 0.0
        t = dt
        while t <= tmax:
            x = self._step(x, dt)
            dist = self.dist_fun(x)
            if dist > self.cdist:
                exp.xlist.append(x)
                exp.dlist.append(dist)
                exp.tlist.append(0.0)
                exp.max_distance = dist
                exp.initial_time = t
                exp.initialized = True
                break
            t += dt

    def transient_ams(self, dt, tmax, exp: AMSExperiment):
        """(Transient.hpp:223-266)"""
        x = exp.xlist[-1]
        t = exp.tlist[-1] + dt
        tend = t + tmax
        max_distance = exp.max_distance
        while t <= tend:
            x = self._step(x, dt)
            dist = self.dist_fun(x)
            if dist < self.adist:
                if exp.return_time < dt / 2.0:
                    exp.return_time = t
                break
            elif dist > 1.0 - self.bdist:
                exp.converged = True
                exp.xlist.append(x)
                exp.tlist.append(t)
                exp.dlist.append(1.0)
                max_distance = 1.0
                break
            if dist > max_distance + self.dist_tol:
                exp.xlist.append(x)
                exp.tlist.append(t)
                exp.dlist.append(dist)
                max_distance = dist
            t += dt
        exp.max_distance = max_distance
        exp.time = t

    def transient_tams(self, dt, tmax, exp: AMSExperiment):
        """(Transient.hpp:268-303)"""
        x = exp.xlist[-1]
        t = exp.tlist[-1] + dt
        max_distance = exp.max_distance
        while t <= tmax:
            x = self._step(x, dt)
            dist = self.dist_fun(x)
            if dist > 1.0 - self.bdist:
                exp.converged = True
                exp.xlist.append(x)
                exp.tlist.append(t)
                exp.dlist.append(1.0)
                max_distance = 1.0
                break
            if dist > max_distance + self.dist_tol:
                exp.xlist.append(x)
                exp.tlist.append(t)
                exp.dlist.append(dist)
                max_distance = dist
            t += dt
        exp.time = exp.tlist[-1]
        exp.max_distance = max_distance

    def transient_gpa(self, dt, tmax, exp: GPAExperiment):
        """(Transient.hpp:305-324)"""
        x = exp.x
        dist = -1.0
        t = dt
        while t <= tmax:
            x = self._step(x, dt)
            dist = self.dist_fun(x)
            if dist > 1.0 - self.bdist:
                exp.converged = True
            t += dt
        exp.distance = dist
        exp.x = x

    # -- naive Monte Carlo (Transient.hpp:326-345) ---------------------
    def naive(self, x0):
        experiments = [GPAExperiment(x=x0) for _ in range(self.num_exp)]
        converged = 0
        for e in experiments:
            e.converged = False
            self.transient_gpa(self.dt, self.tmax, e)
            converged += e.converged
        self.probability = converged / self.num_exp
        log.INFO(f"Transition probability T={self.tmax}: "
                 f"{self.probability}")

    # -- AMS elimination loop (Transient.hpp:348-516) ------------------
    def ams_elimination(self, method, experiments, dt, tmax) -> float:
        converged = 0
        reactive = [experiments[i] for i in range(self.num_exp)]
        unconverged = []
        unused = []
        for e in reactive:
            if not e.converged:
                unconverged.append(e)
            else:
                converged += 1
            unused.append(e)
        unconverged.sort(key=lambda e: e.max_distance, reverse=True)

        i = self.its
        while i < self.maxit:
            i += 1
            minimal = []
            if unconverged and unused:
                min_dist = unconverged[-1].max_distance
                while unconverged \
                        and unconverged[-1].max_distance == min_dist:
                    e = unconverged.pop()
                    minimal.append(e)
                    unused.remove(e)
            if not minimal or not unused:
                continue

            self.ell.append(len(minimal))
            log.INFO(f"Eliminating {len(minimal)} trajector"
                     f"{'y' if len(minimal) == 1 else 'ies'}.")
            self.its += 1

            for e in minimal:
                old_max = e.max_distance
                rnd_idx = self._randint(0, len(unused) - 1)
                while unused[rnd_idx].max_distance <= e.max_distance:
                    rnd_idx = self._randint(0, len(unused) - 1)
                rnd = unused[rnd_idx]
                if not rnd.dlist:
                    log.ERROR(f"Experiment {rnd_idx} has size 0.")
                idx = 0
                while idx < len(rnd.dlist) \
                        and rnd.dlist[idx] < e.max_distance:
                    idx += 1
                if idx == len(rnd.dlist):
                    log.ERROR("Distance not found in branch experiment")
                e.xlist = list(rnd.xlist[:idx + 1])
                e.dlist = list(rnd.dlist[:idx + 1])
                e.tlist = list(rnd.tlist[:idx + 1])

                if method == "AMS":
                    self.transient_ams(dt, tmax, e)
                elif method == "TAMS":
                    self.transient_tams(dt, tmax, e)
                else:
                    log.ERROR(f"Method {method} does not exist.")

                if e.converged:
                    converged += 1
                else:
                    unconverged.append(e)
                log.INFO(f"{method}: {self.its} / {self.maxit}, "
                         f"{converged} / {self.num_exp} converged, "
                         f"max dist {old_max:.4f} -> "
                         f"{e.max_distance:.4f}")

            unused.extend(minimal)
            unconverged.sort(key=lambda e: e.max_distance, reverse=True)

            # cleanup (Transient.hpp:474-502)
            min_max = min(e.max_distance for e in reactive)
            if self.its % 10 == 0:
                for e in unused:
                    idx = 0
                    while idx < len(e.dlist) and e.dlist[idx] < min_max:
                        idx += 1
                    if idx > 0:
                        e.xlist = e.xlist[idx:]
                        e.dlist = e.dlist[idx:]
                        e.tlist = e.tlist[idx:]

            self._write_helper(experiments, self.its)

        if self.write_final and self.write_file:
            self.write(self.write_file, experiments)

        alpha = converged / self.num_exp
        for ln in self.ell:
            alpha *= 1.0 - ln / self.num_exp
        return alpha

    # -- AMS (Transient.hpp:518-605) -----------------------------------
    def ams(self, x0):
        experiments = [AMSExperiment(x0=x0)
                       for _ in range(self.num_init_exp)]
        self.its = 0
        self.time_steps = 0
        self.ell = []
        if self.read_file:
            self.read(self.read_file, experiments)
        converged = 0
        tmax = 100 * self.tmax
        self.time_steps_previous_write = 0

        for i, e in enumerate(experiments):
            if e.initialized:
                continue
            self.transient_start(x0, self.dt, tmax, e)
            if not e.xlist:
                log.ERROR("Initialization failed")
            self.transient_ams(self.dt, tmax, e)
            if i >= self.num_exp:
                e.xlist, e.dlist, e.tlist = [], [], []
            converged += e.converged
            log.INFO(f"Initialization: {i + 1} / {self.num_init_exp}, "
                     f"{converged} converged, "
                     f"t={e.initial_time + e.time:.3f}")
            self._write_helper(experiments, i + 1)

        alpha = self.ams_elimination("AMS", experiments, self.dt, tmax)

        total_tr = total_t1 = total_t2 = 0.0
        num_t1 = self.num_init_exp
        num_t2 = 0
        converged = 0
        for e in experiments[:self.num_exp]:
            total_tr += e.time
            converged += e.converged
        for e in experiments:
            total_t1 += e.initial_time
            total_t2 += e.return_time
            if e.return_time > self.dt / 2.0:
                num_t2 += 1

        # with no trajectory converged alpha is 0 and the MFPT infinite, as
        # the reference's floating-point division gives it (the JAX package
        # raises ZeroDivisionError here); the probability is then 0
        meann = 1.0 / alpha - 1.0 if alpha > 0.0 else math.inf
        self.mfpt = (meann * (total_t1 / num_t1
                              + total_t2 / max(num_t2, 1))
                     + total_t1 / num_t1 + total_tr / max(converged, 1))
        log.INFO(f"Alpha: {alpha}")
        log.INFO(f"Mean first passage time: {self.mfpt}")
        self.probability = 1.0 - np.exp(-1.0 / self.mfpt * self.tmax)
        log.INFO(f"Transition probability T={self.tmax}: "
                 f"{self.probability}")

    # -- TAMS (Transient.hpp:607-656) ----------------------------------
    def tams(self, x0):
        experiments = [AMSExperiment(x0=x0) for _ in range(self.num_exp)]
        self.its = 0
        self.time_steps = 0
        self.ell = []
        if self.read_file:
            self.read(self.read_file, experiments)
        converged = 0
        self.time_steps_previous_write = 0
        for i, e in enumerate(experiments):
            if e.initialized:
                continue
            e.xlist.append(x0)
            e.dlist.append(0.0)
            e.tlist.append(0.0)
            self.transient_tams(self.dt, self.tmax, e)
            e.initialized = True
            converged += e.converged
            log.INFO(f"Initialization: {i + 1} / {self.num_exp}, "
                     f"{converged} converged, t={e.time:.3f}")
            self._write_helper(experiments, i + 1)

        self.probability = self.ams_elimination(
            "TAMS", experiments, self.dt, self.tmax)
        log.INFO(f"Transition probability T={self.tmax}: "
                 f"{self.probability}")

    # -- GPA (Transient.hpp:658-734) -----------------------------------
    def gpa(self, x0):
        experiments = [GPAExperiment(x=x0) for _ in range(self.num_exp)]
        self.time_steps = 0

        def W(x):
            return np.exp(self.beta * x)

        t = self.tstep
        while t <= self.tmax:
            total = sum(e.weight for e in experiments)
            eta = total / self.num_exp
            old = [GPAExperiment(x=e.x, weight=e.weight,
                                 probability=e.probability,
                                 distance=e.distance,
                                 converged=e.converged)
                   for e in experiments]
            # resample by weight
            for i in range(self.num_exp):
                val = self._randreal(0.0, total)
                cumsum = 0.0
                for j, oe in enumerate(old):
                    cumsum += oe.weight
                    if cumsum >= val:
                        experiments[i] = GPAExperiment(
                            x=oe.x, weight=oe.weight,
                            probability=oe.probability,
                            distance=oe.distance,
                            converged=oe.converged)
                        break
                else:
                    log.ERROR("Particle not found in GPA resampling")
            converged = 0
            for e in experiments:
                self.transient_gpa(self.dt, self.tstep, e)
                e.weight = W(e.distance)
                e.probability *= eta / e.weight
                converged += e.converged
            log.INFO(f"GPA: {converged} / {self.num_exp} converged "
                     f"with t={t} and eta={eta}")
            t += self.tstep

        self.probability = sum(e.probability for e in experiments
                               if e.converged) / self.num_exp
        log.INFO(f"Transition probability T={self.tmax}: "
                 f"{self.probability}")

    # -- dispatch ------------------------------------------------------
    def run(self, x0=None) -> int:
        if x0 is None:
            x0 = self.x0
        if self.method == "AMS":
            self.ams(x0)
        elif self.method == "TAMS":
            self.tams(x0)
        elif self.method == "GPA":
            self.gpa(x0)
        elif self.method == "Naive":
            self.naive(x0)
        elif self.method == "Transient":
            self.transient(x0, self.dt, self.tmax)
        else:
            log.ERROR(f"Method {self.method} does not exist.")
            return -1
        return 0

    # -- experiment checkpoint / restart -------------------------------
    def write(self, name: str, experiments) -> None:
        """Restartable ensemble checkpoint (the reference's HDF5
        specialization of Transient::write, Transient.cpp)."""
        data = {
            "its": self.its,
            "time_steps": self.time_steps,
            "ell": list(self.ell),
            "experiments": [
                dict(xlist=[x.detach().cpu().numpy() for x in e.xlist],
                     dlist=list(e.dlist), tlist=list(e.tlist),
                     max_distance=e.max_distance, time=e.time,
                     initial_time=e.initial_time,
                     return_time=e.return_time,
                     initialized=e.initialized, converged=e.converged)
                for e in experiments],
        }
        tmp = name + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(data, f)
        if os.path.exists(name):   # double-buffer like Model saves
            os.replace(name, name + ".bak")
        os.replace(tmp, name)

    def read(self, name: str, experiments) -> None:
        if not os.path.exists(name):
            log.WARNING(f"Restart file {name} not found")
            return
        with open(name, "rb") as f:
            data = pickle.load(f)
        self.its = data["its"]
        self.time_steps = data["time_steps"]
        self.ell = list(data["ell"])
        for e, d in zip(experiments, data["experiments"]):
            e.xlist = [torch.as_tensor(x, device=e.x0.device)
                       for x in d["xlist"]]
            e.dlist = list(d["dlist"])
            e.tlist = list(d["tlist"])
            e.max_distance = d["max_distance"]
            e.time = d["time"]
            e.initial_time = d["initial_time"]
            e.return_time = d["return_time"]
            e.initialized = d["initialized"]
            e.converged = d["converged"]

    def _write_helper(self, experiments, its: int) -> None:
        if not self.write_file:
            return
        if self.write_steps > 0 and its % self.write_steps == 0:
            self.time_steps_previous_write = self.time_steps
            self.write(self.write_file, experiments)
            return
        if self.write_time_steps > 0 and \
                self.time_steps - self.time_steps_previous_write \
                >= self.write_time_steps:
            self.time_steps_previous_write = self.time_steps
            self.write(self.write_file, experiments)

    def get_probability(self) -> float:
        return self.probability

    def get_mfpt(self) -> float:
        return self.mfpt
