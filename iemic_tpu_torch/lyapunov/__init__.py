"""Lyapunov (covariance) solves — RAILS-equivalent low-rank solver
(port of ``iemic_tpu/lyapunov``; reference
src/lyapunov/LyapunovModel.H:22-110)."""

from .rails import rails, RailsResult
from .model import LyapunovModel, min_norm_solve, svd_min_norm

__all__ = ["rails", "RailsResult", "LyapunovModel", "min_norm_solve",
           "svd_min_norm"]
