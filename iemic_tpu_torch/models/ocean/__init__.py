from .ocean import Ocean, OceanConfig  # noqa: F401
