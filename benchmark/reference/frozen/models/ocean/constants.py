# Copied from iemic_tpu/models/ocean/constants.py (numpy-only; importing iemic_tpu would import jax).
"""Physical constants, continuation-parameter registry and starting point.

Mirrors the reference's fixed parameters (src/ocean/usr.F90:129-169),
the 30-parameter registry (src/ocean/par.F90:31-68) and the
name <-> index mapping of THCM::par2int (src/ocean/THCM.C:1754+,
0-based here), plus the starting-point values of ``stpnt``
(src/ocean/usrc.F90:1136-1180).
"""

from __future__ import annotations

import numpy as np

# ---- parameter indices (0-based; Fortran index - 1) ------------------
NPAR = 30
(AL_T, RAYL, EK_V, EK_H, ROSB, MIXP, RESC, SPL1, HMTP, SUNP,
 PE_H, PE_V, P_VC, LAMB, SALT, WIND, TEMP, BIOT, COMB, ARCL,
 NLES, IFRICB, CONT, ENER, ALPC, CMPR, FPER, SPER, MKAP, SPL2) = range(NPAR)

# name mapping used in XML configs (reference THCM::par2int)
PAR_NAMES: dict[str, int] = {
    "AL_T": AL_T,
    "Rayleigh-Number": RAYL,
    "Vertical Ekman-Number": EK_V,
    "Horizontal Ekman-Number": EK_H,
    "Rossby-Number": ROSB,
    "MIXP": MIXP,
    "RESC": RESC,
    "SPL1": SPL1,
    "Salinity Homotopy": HMTP,
    "Solar Forcing": SUNP,
    "Horizontal Peclet-Number": PE_H,
    "Vertical Peclet-Number": PE_V,
    "P_VC": P_VC,
    "LAMB": LAMB,
    "Salinity Forcing": SALT,
    "Wind Forcing": WIND,
    "Temperature Forcing": TEMP,
    "Nonlinear Factor": BIOT,
    "Combined Forcing": COMB,
    "ARCL": ARCL,
    "NLES": NLES,
    "IFRICB": IFRICB,
    "CONT": CONT,
    "Energy": ENER,
    "ALPC": ALPC,
    "CMPR": CMPR,
    "Flux Perturbation": FPER,
    "Salinity Perturbation": SPER,
    "MKAP": MKAP,
    "SPL2": SPL2,
}

INT2PAR = {v: k for k, v in PAR_NAMES.items()}

# ---- fixed physical constants (reference usr.F90:129-169) ------------
PI = np.pi
OMEGADIM = 7.292e-05     # earth rotation rate [1/s]
R0DIM = 6.37e+06         # earth radius [m]
UDIM = 0.1               # velocity scale [m/s]
GDIM = 9.8               # gravity [m/s^2]
RHODIM = 1.024e+03       # density scale [kg/m^3]
T0 = 15.0                # reference temperature [degC]
DELTAT = 1.0
DELTAS = 1.0
S0 = 35.0                # reference salinity [psu]
CP0 = 4.2e+03            # heat capacity [J/kg/K]
ALPT1 = 2.93             # nonlinear EOS coefficients
ALPT2 = 8.3e-02
ALPT3 = 6.6e-04
AH = 2.5e+05             # horizontal friction  (2 deg resolution value)
AV = 1.0e-03             # vertical friction
KAPPAH = 1.0e+03         # horizontal diffusivity
KAPPAV = 1.0e-04         # vertical diffusivity

# latent heat etc. used in coupled mode (reference atm.F90)
LV = 2.5e+06             # latent heat of vaporization [J/kg]

# land mask values (par.F90:77-81)
OCEAN, LAND, WATER, PERIO = 0, 1, 2, 3


def stpnt(hdim: float, dz: float, dfzT_l: float,
          alphaT: float = 1.0e-4, alphaS: float = 7.6e-4) -> np.ndarray:
    """Default starting values of the 30 continuation parameters
    (reference usrc.F90:1136-1180 ``stpnt``)."""
    par = np.zeros(NPAR)
    par[AL_T] = 0.1 / (2 * OMEGADIM * RHODIM * hdim * UDIM * dz * dfzT_l)
    par[RAYL] = alphaT * GDIM * hdim / (2 * OMEGADIM * UDIM * R0DIM)
    par[EK_V] = AV / (2 * OMEGADIM * hdim * hdim)
    par[EK_H] = AH / (2 * OMEGADIM * R0DIM * R0DIM)
    par[ROSB] = UDIM / (2 * OMEGADIM * R0DIM)
    par[HMTP] = 0.0
    par[SUNP] = 0.0
    par[PE_H] = KAPPAH / (UDIM * R0DIM)
    par[PE_V] = KAPPAV * R0DIM / (UDIM * hdim * hdim)
    par[P_VC] = 2.5e+04 * par[PE_V]
    par[LAMB] = alphaS / alphaT
    par[SALT] = 0.0
    par[WIND] = 0.0
    par[TEMP] = 0.0
    par[BIOT] = R0DIM / (75. * 3600. * 24. * UDIM)
    par[COMB] = 0.0
    par[NLES] = 0.0
    par[CMPR] = 0.0
    par[ALPC] = 1.0
    par[ENER] = 1.0e+02
    par[MIXP] = 0.0
    par[MKAP] = 0.0
    par[SPL1] = 2.0e+03
    par[SPL2] = 0.01
    return par
