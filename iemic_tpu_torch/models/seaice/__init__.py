from .seaice import SeaIce  # noqa: F401
