"""The check of the continuation corrector's Newton iterations.

What the program produced in each iteration at the predicted point
(x, lambda): F, dF/dlambda, the Jacobian's stencil tensor, the solutions
y of J y = dF/dlambda and z of J z = -F, and the bordered update to the
new (x, lambda).  The reference recomputes, in f64 on the host:

- F, dF/dlambda (the same forward difference) and J at (x, lambda), and
  compares the program's with them: the largest gap as a share of the
  largest entry;
- the relative residual of y and z in its own J, in the norm the solve's
  tolerance is stated in (THCM's row scale, the pressure null modes
  projected out), which the configuration's tolerance bounds;
- the bordered update from the program's y and z, and its gap to the
  program's new (x, lambda) as a share of the update.
"""

from __future__ import annotations

import os

import torch

from .frozen.config import read_xml
from .ocean import ReferenceOcean

F64 = torch.float64


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    scale = float(torch.amax(torch.abs(b)))
    return float(torch.amax(torch.abs(a.to(b.dtype) - b))) / max(scale,
                                                                 1e-300)


def continuation_settings(workdir: str) -> dict:
    p = read_xml(os.path.join(workdir, "continuation_params.xml"))
    s = dict(name=p.get("continuation parameter", "Combined Forcing"),
             eps=p.get("epsilon increment", 1.0e-5),
             strategy=p.get("normalize strategy", "N"),
             tan_scaling=p.get("state tangent scaling", 1.0))
    if s["strategy"] != "N":
        raise ValueError("reference: only the 'N' normalization is covered")
    return s


class Point:
    """The reference's F, dF/dlambda and J at the predicted point, and
    what its solves are judged in."""

    def __init__(self, workdir: str, x: torch.Tensor, par: float,
                 dtype=F64):
        s = continuation_settings(workdir)
        self.ref = ref = ReferenceOcean(workdir, dtype=dtype)
        self.x = ref.tensor(x)
        p = ref.with_par(ref.par0, s["name"], par)
        pe = ref.with_par(ref.par0, s["name"], par + s["eps"])
        self.F = ref.rhs(self.x, p)
        self.dF = (ref.rhs(self.x, pe) - self.F) / s["eps"]
        self.J = ref.jacobian(self.x, p)
        self.R = ref.row_scale(self.J)
        self.Q = ref.null_basis(self.J)
        self.zeta = s["tan_scaling"] / self.x.numel()

    def _proj(self, v: torch.Tensor) -> torch.Tensor:
        v = v.reshape(-1)
        return v if self.Q is None else v - self.Q @ (self.Q.T @ v)

    def relres(self, b: torch.Tensor, sol: torch.Tensor) -> float:
        """||P R (b - J sol)|| / ||P R b||, P the null-mode projection."""
        sol = self.ref.tensor(sol)
        rb = self._proj(self.R * b)
        r = rb - self._proj(self.R * self.ref.apply(self.J, sol))
        return float(torch.linalg.norm(r) / torch.linalg.norm(rb))

    def update(self, x0: torch.Tensor, par0: float, par: float, ds: float,
               y: torch.Tensor, z: torch.Tensor):
        """The bordered update (Continuation.H:585-813, 'N' strategy) of
        (x, par) from y and z: returns (new x, new par, |update|)."""
        y, z, x0 = (self.ref.tensor(v) for v in (y, z, x0))
        d = self.x - x0
        pd = par - par0
        rbp = ds * ds - float(torch.sum(d * d)) * self.zeta - pd * pd
        par_dir = ((rbp - 2 * self.zeta * float(torch.sum(d * z)))
                   / (2 * pd - 2 * self.zeta * float(torch.sum(d * y))))
        state_dir = z - par_dir * y
        size = max(float(torch.linalg.norm(state_dir)), abs(par_dir))
        return self.x + state_dir, par + par_dir, size


def judge(workdir: str, setup: dict, units: list[dict], J: torch.Tensor,
          dtype=F64) -> list[dict]:
    """The compared numbers of each unit.

    setup: the program's predicted point ``x``, ``par``, the step's
    start ``x0``, ``par0`` and its ``ds``; units: per Newton iteration
    the program's ``F``, ``dF``, ``y``, ``z``, new ``x`` and ``par``; J:
    the program's stencil tensor of the last iteration, judged with the
    last unit given."""
    pt = Point(workdir, setup["x"], setup["par"], dtype)
    out = []
    for u in units:
        x1, p1, size = pt.update(setup["x0"], setup["par0"], setup["par"],
                                 setup["ds"], u["y"], u["z"])
        gap = max(float(torch.linalg.norm(pt.ref.tensor(u["x"]) - x1)),
                  abs(u["par"] - p1)) / max(size, 1e-300)
        out.append(dict(F_gap=_rel_gap(u["F"], pt.F),
                        dFdpar_gap=_rel_gap(u["dF"], pt.dF),
                        relres_y=pt.relres(pt.dF, u["y"]),
                        relres_z=pt.relres(-pt.F, u["z"]),
                        update_gap=gap))
    out[-1]["J_gap"] = _rel_gap(J, pt.J)
    return out


def control(workdir: str, x: torch.Tensor, par: float,
            dtype=torch.float32) -> dict:
    """The assembly's numbers when the reference in dtype stands in the
    program's place: F, dF/dlambda and J computed in dtype, judged by
    the f64 reference."""
    pt = Point(workdir, x, par)
    low = Point(workdir, x, par, dtype)
    return dict(F_gap=_rel_gap(low.F, pt.F), dFdpar_gap=_rel_gap(low.dF, pt.dF),
                J_gap=_rel_gap(low.J, pt.J))
