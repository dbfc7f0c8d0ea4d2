"""One implicit theta step of the coupled model, replayed from the same
state.

Set-up builds the bundle's ``CoupledModel`` (``main/run_coupled.
coupled_environment``) and the bundle's stepper (``transient_factory``
on ``timestepper_params.xml``); the seed draws the step ``dt`` as the
configuration's "time step" times a factor from the traffic's range.
Set-up takes the step once, to warm up.  Every unit puts the model back
at the start state and runs the stepper's Newton for one step: the
theta residual and the coupled Jacobian at every iterate, and a coupled
FGMRES solve per iteration.  Every unit is the same work.

What a unit produced is read through the theta model's public calls:
each residual (``compute_rhs``, with the state it was computed at) and
each solve's answer (``solve``).  After the window the check applies
the program's own Jacobian at each kept iterate to that iterate's
answer, through the same public calls.
"""

from __future__ import annotations

import numpy as np
import torch


class Cell:
    def __init__(self, workdir: str, traffic: dict, seed: int, device,
                 spans=None):
        import os
        from iemic_tpu_torch.config import read_xml
        from iemic_tpu_torch.main.run_coupled import coupled_environment
        from iemic_tpu_torch.transient import transient_factory

        pars = dict(read_xml(os.path.join(workdir,
                                          "timestepper_params.xml")).items())
        lo, hi = traffic["dt_factor"]
        r = np.random.default_rng(seed).random()
        self.dt = float(pars["time step"] * (lo + (hi - lo) * r))
        self.workdir, self.spans, self.device = workdir, spans, device
        self._ctx = coupled_environment(workdir, str(device), "time_coupled")
        self.coupled = self._ctx.__enter__()
        self.stepper = transient_factory(self.coupled, pars)
        self.theta, self.newton = self.stepper.model, self.stepper.newton
        self.x0 = self.coupled.get_state()
        # the first step takes some 10 s more than the next ones (lazy
        # library and CUDA start-up inside the program): set-up takes it
        self._step()
        self._record = None
        self._hook()
        if spans is not None:
            spans.wrap(self.theta, "compute_rhs", "assembly")
            spans.wrap(self.theta, "compute_jacobian", "assembly")
            spans.wrap(self.coupled, "solve", "solve")

    def _hook(self):
        """Keep, while a unit runs, the state and theta residual of each
        residual the step computes, and each solve's answer."""
        th = self.theta
        rhs, solve = th.compute_rhs, th.solve

        def compute_rhs():
            rhs()
            if self._record is not None:
                self._record.append(dict(x=th.get_state(), F=th.get_rhs()))

        def solve_(b):
            dx = solve(b)
            if self._record is not None:
                self._record[-1]["dx"] = dx
            return dx

        th.compute_rhs, th.solve = compute_rhs, solve_

    def _step(self):
        th = self.theta
        th.set_par("Time", self.dt)
        th.set_state(self.x0)
        th.init_step(self.dt)
        self.newton_result = self.newton.run(self.x0)

    def describe(self) -> str:
        return f"dt {self.dt!r}"

    def unit(self) -> dict:
        c = self.coupled
        first = len(c.solve_log)
        self._record = []
        self._step()
        solves = c.solve_log[first:]
        record = dict(iterates=self._record, final=self.newton_result)
        self._record = None
        if self.spans is not None:
            self.spans.count("newton", self.newton.steps)
            self.spans.count("mv", sum(its for its, _ in solves))
        return record

    def after_trace(self, spans) -> None:
        pass

    def _jacobian_products(self, records: list[dict]) -> None:
        """J2 dx at each kept iterate that a solve followed, from the
        program's Jacobian there (``compute_jacobian``, ``apply_matrix``
        of the theta model, the step's dt in place)."""
        th = self.theta
        for s in records:
            for it in s["iterates"]:
                if "dx" in it:
                    th.set_state(it["x"])
                    th.compute_jacobian()
                    it["Jdx"] = th.apply_matrix(it["dx"])

    def check(self, records: list[dict], dtype=torch.float64) -> list[dict]:
        """Move what the program produced to the host, free the program,
        and judge the steps kept against the reference."""
        from reference import coupled as ref

        def host(v):
            return v.detach().to("cpu") if torch.is_tensor(v) else v

        self._jacobian_products(records)
        x0 = host(self.x0)
        steps = [dict(dt=self.dt, theta=self.theta.theta, x0=x0,
                      final=host(s["final"]),
                      iterates=[{k: host(v) for k, v in it.items()}
                                for it in s["iterates"]])
                 for s in records]
        self.close()
        return [ref.judge_theta(self.workdir, s, dtype) for s in steps]

    def close(self) -> None:
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None
            self.coupled = self.stepper = self.theta = self.newton = None
            if torch.device(self.device).type == "cuda":
                torch.cuda.empty_cache()
