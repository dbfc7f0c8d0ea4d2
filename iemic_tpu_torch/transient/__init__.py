"""Implicit time stepping and rare-event methods (port of
``iemic_tpu/transient``)."""

from .theta import ThetaModel, StochasticThetaModel  # noqa: F401
from .newton import Newton  # noqa: F401
from .transient import Transient, AMSExperiment, GPAExperiment  # noqa: F401
from .adaptive import AdaptiveTransient  # noqa: F401
from .score import (  # noqa: F401
    default_score_function,
    ocean_score_function,
)
from .factory import transient_factory  # noqa: F401
