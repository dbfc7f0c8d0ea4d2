from .atmosphere import Atmosphere  # noqa: F401
