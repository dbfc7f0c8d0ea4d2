"""Shared set-up of the benchmark's own tests: the harness and the
program on the path, the card fixture, and the small fixtures that the
cells' drivers run at on the CPU."""

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def ocean_fixture_config() -> dict:
    """The global ocean's configuration on the masked 8x8x4 fixture
    (test8x8x4_3), solved by the direct method (Amesos: the host LU, one
    iteration a solve), so that a CPU run takes seconds.  At this size
    the BGS + Mixed solve of the corrector stalls near the cell's 5e-2
    and hands over to its GMRES-IR tail, which takes minutes."""
    from harness import registry
    cfg = copy.deepcopy(registry.config("ocean-global-96x38x12"))
    files = cfg["files"]
    t = files["ocean_params.xml"]["params"]["THCM"]
    t["Global Grid-Size n"], t["Global Grid-Size m"] = 8, 8
    t["Global Grid-Size l"] = 4
    t["Land Mask"] = "test8x8x4_3"
    cfg["data"] = {"data/mkmask/test8x8x4_3": "tests/data/test8x8x4_3"}
    files["solver_params.xml"]["params"]["Preconditioning"] = "Amesos"
    files["ocean_preconditioner_params.xml"]["params"]["Method"] = "Amesos"
    return cfg


def aquaplanet_fixture_config() -> dict:
    """The coupled aquaplanet's configuration cut to 16x8x4 (the ocean's
    l = 4, the atmosphere and the sea ice at 16x8)."""
    from harness import registry
    cfg = copy.deepcopy(registry.config("aquaplanet-coupled-64x32x12"))
    files = cfg["files"]
    for name in ("ocean_params.xml", "atmosphere_params.xml",
                 "seaice_params.xml"):
        p = files[name]["params"]
        p = p["THCM"] if name == "ocean_params.xml" else p
        p["Global Grid-Size n"], p["Global Grid-Size m"] = 16, 8
        if name == "ocean_params.xml":
            p["Global Grid-Size l"] = 4
    return cfg
