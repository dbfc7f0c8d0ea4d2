"""Transient factory: wires (Stochastic)ThetaModel + Newton + Transient
(PyTorch).

Port of ``iemic_tpu/transient/factory.py`` (reference
src/transient/TransientFactory.H:19-200).
"""

from __future__ import annotations

from ..utils import logging as log
from .theta import ThetaModel, StochasticThetaModel
from .newton import Newton
from .adaptive import AdaptiveTransient
from .transient import Transient
from .score import default_score_function, ocean_score_function


def get_time_step(model, pars: dict):
    """One implicit theta time step via Newton
    (TransientFactory.H:55-68); ``time_step.newton`` is the Newton solver,
    whose ``converged`` and ``steps`` describe the last step."""
    newton = Newton(model, pars)

    def time_step(x, dt):
        model.set_state(x)
        model.init_step(dt)
        return newton.run(x)

    time_step.newton = newton
    return time_step


def transient_factory(model, pars: dict, sol1=None, sol2=None, sol3=None,
                      x0=None):
    """Build a time stepper / rare-event method.

    * no sol1/sol2: AdaptiveTransient theta stepper (optionally from x0)
    * sol1 & sol2 given: stochastic rare-event method (AMS/TAMS/GPA)
      between states A=sol1 and B=sol2 with optional unstable state
      sol3 (TransientFactory.H:70-200).
    """
    if sol1 is None:
        theta = ThetaModel(model, pars)
        stepper = AdaptiveTransient(theta, pars, x0=x0)
        return stepper

    theta = StochasticThetaModel(model, pars)
    score = pars.get("score function", "default")
    if score == "default":
        score_fun = default_score_function(sol1, sol2, sol3)
    elif score == "ocean":
        score_fun = ocean_score_function(sol1, sol2, sol3)
    else:
        log.ERROR(f"Unknown score function {score}")

    vector_length = sol1.numel()
    tr = Transient(time_step=get_time_step(theta, pars),
                   dist_fun=score_fun, x0=sol1,
                   vector_length=vector_length)
    tr.set_parameters(pars)
    tr.set_random_engine(pars.get("random seed", 0))
    return tr
