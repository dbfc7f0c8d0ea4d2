"""One Newton iteration of the continuation's bordered corrector,
replayed from the predicted point of the first continuation step.

Set-up builds the bundle's ``Ocean`` and ``Continuation``
(``main/run_ocean.bundle``), takes the initial tangent at the start
(one solve) and the Euler predictor with the step ``ds`` that the seed
draws from the traffic's range.  Every unit puts the model back at the
predicted point and runs ``Continuation.newton_corrector`` for one
iteration: dF/dlambda, the Jacobian, the preconditioner, the solves
J y = dF/dlambda and J z = -F, and the bordered update.  Every unit is
the same work.
"""

from __future__ import annotations

import numpy as np
import torch


class Cell:
    def __init__(self, workdir: str, traffic: dict, seed: int, device,
                 spans=None):
        from iemic_tpu_torch.main import run_ocean

        lo, hi = traffic["ds"]
        self.ds = float(lo + (hi - lo) * np.random.default_rng(seed).random())
        self.workdir, self.spans, self.device = workdir, spans, device
        self._ctx = run_ocean.bundle(workdir, str(device))
        self.ocean, self.cont = self._ctx.__enter__()
        o, c = self.ocean, self.cont
        c.initialize()
        c.create_initial_tangent()
        c.ds = self.ds
        c.step_ = 1
        c.store()
        o.pre_process()
        if c.euler_predictor():
            raise RuntimeError("the predictor refused the step")
        self.x0, self.par0 = c.storage.state0, c.storage.par0
        self.x, self.par, self.tangent = o.get_state(), c.par, c.state_dot
        c.max_newton_iters = 1
        if spans is not None:
            spans.wrap(o, "compute_rhs", "assembly")
            spans.wrap(o, "compute_jacobian", "assembly")
            spans.wrap(o, "_get_prec_factors", "prec_build")
            spans.wrap(o, "solve", "solve")

    def describe(self) -> str:
        return f"ds {self.ds!r}, predicted lambda {float(self.par)!r}"

    def unit(self) -> dict:
        o, c = self.ocean, self.cont
        o.set_state(self.x)
        c.par = self.par
        o.set_par(c.par_name, self.par)
        c.state_dot = self.tangent
        first = len(o.solve_log)
        c.newton_corrector()
        solves = o.solve_log[first:]
        if self.spans is not None:
            self.spans.count("mv", sum(its for its, _ in solves))
        return dict(F=c.rhs_copy, dF=c.dfdpar, y=c.state_dot,
                    z=o.get_solution(), x=o.get_state(), par=float(c.par))

    def after_trace(self, spans) -> None:
        """Counts read outside the traced window: the bytes the stencil
        product needs on the last unit's Jacobian."""
        from harness import roofline
        spans.count("stencil_bytes", roofline.stencil_bytes(
            self.ocean.jac, self.ocean.cfg.periodic))

    def check(self, records: list[dict], dtype=torch.float64) -> list[dict]:
        """Move what the program produced to the host, free the program,
        and judge it against the reference: the compared numbers of each
        unit kept, the Jacobian the last unit left with the last of
        them (every unit assembles it at the same point)."""
        from reference import corrector

        def host(v):
            return v.detach().to("cpu") if torch.is_tensor(v) else v

        setup = dict(x=host(self.x), par=float(self.par), x0=host(self.x0),
                     par0=float(self.par0), ds=self.ds)
        units = [{k: host(v) for k, v in r.items()} for r in records]
        J = host(self.ocean.jac)
        self.close()
        return corrector.judge(self.workdir, setup, units, J, dtype)

    def close(self) -> None:
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None
            self.ocean = self.cont = None
            if torch.device(self.device).type == "cuda":
                torch.cuda.empty_cache()


def build() -> None:
    """The program's kernel library, compiled where the checkout holds
    none yet (the Mixed solve's f32 products run it)."""
    from iemic_tpu_torch.ops import stencil_hopper
    stencil_hopper.build()
