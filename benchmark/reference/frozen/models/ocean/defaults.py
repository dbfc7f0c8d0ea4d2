"""THCM's default parameters (reference THCM.C:2749-2814), as the port's
``Ocean`` fills them in."""

from __future__ import annotations

from ...config import ParameterList
from . import constants as c


def default_thcm_params() -> ParameterList:
    """THCM defaults (reference THCM.C:2749-2814)."""
    p = ParameterList("THCM")
    p.set("Problem Description", "Unnamed")
    p.set("Global Grid-Size n", 16)
    p.set("Global Grid-Size m", 16)
    p.set("Global Grid-Size l", 16)
    p.set("Global Bound xmin", 286.0)
    p.set("Global Bound xmax", 350.0)
    p.set("Global Bound ymin", 10.0)
    p.set("Global Bound ymax", 74.0)
    p.set("Periodic", False)
    p.set("Depth hdim", 4000.0)
    p.set("Grid Stretching qz", 1.0)
    p.set("Topography", 1)
    p.set("Topography Data", "")
    p.set("Flat Bottom", False)
    p.set("Compute salinity integral", True)
    p.set("Read Land Mask", False)
    p.set("Land Mask", "no_mask_specified")
    p.set("Inhomogeneous Mixing", 0)
    p.set("Mixing", 1)
    p.set("Rho Mixing", True)
    p.set("Taper", 1)
    p.set("Linear EOS: alpha T", 1.0e-4)
    p.set("Linear EOS: alpha S", 7.6e-4)
    p.set("Restoring Temperature Profile", 1)
    p.set("Restoring Salinity Profile", 1)
    p.set("Local SRES Only", False)
    p.set("Salinity Integral Sign", -1)
    p.set("Levitus T", 1)
    p.set("Levitus S", 1)
    p.set("Levitus Internal T/S", False)
    p.set("Coupled Temperature", 0)
    p.set("Coupled Salinity", 0)
    p.set("Coupled Sea Ice Mask", 1)
    p.set("Fix Pressure Points", False)
    p.set("Coriolis Force", 1)
    p.set("Forcing Type", 0)
    p.set("Read Salinity Perturbation Mask", False)
    p.set("Salinity Perturbation Mask", "no_mask_specified")
    p.set("Wind Forcing Type", 2)
    p.set("Wind Forcing Data", "wind/trtau.dat")
    p.set("Temperature Forcing Data", "levitus/new/t00an1")
    p.set("Salinity Forcing Data", "levitus/new/s00an1")
    p.set("Time Dependent Forcing", False)
    p.set("Seasonal Forcing", 1.0)
    p.set("Seasonal Forcing (Wind)", 1.0)
    p.set("Seasonal Forcing (Temperature)", 1.0)
    p.set("Seasonal Forcing (Salinity)", 1.0)
    p.set("Integral row coordinate i", -1)
    p.set("Integral row coordinate j", -1)
    p.set("Scaling", "THCM")
    sp = ParameterList("Starting Parameters")
    for name in c.PAR_NAMES:
        sp.set(name, float("nan"))
    p.set("Starting Parameters", sp)
    return p
