"""Topography homotopy continuation (port of ``iemic_tpu/topo``;
reference src/topo/)."""

from .topo import Topo, default_topo_params

__all__ = ["Topo", "default_topo_params"]
