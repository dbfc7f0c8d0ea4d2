from .coupled import CoupledModel  # noqa: F401


def build_coupled_from_files(workdir: str | None = None, *, device="cuda",
                             ocean=None):
    """A CoupledModel from the XML bundle in ``workdir`` (the working
    directory by default), its models on ``device``: the file-layout
    contract of the reference's coupled CLIs (run_coupled.C:64-108,
    per-model XML files).  The ocean takes solver_params.xml with
    ocean_preconditioner_params.xml merged in, as run_ocean's does; the
    coupled FGMRES takes its flat entries.  An ocean already built from
    the bundle may be passed in."""
    import os
    from ..ocean import Ocean
    from ..atmosphere import Atmosphere
    from ..seaice import SeaIce
    from ...config import read_xml
    from ...main.run_ocean import read_solver_params

    def path(name):
        return os.path.join(workdir, name) if workdir else name

    def load(name):
        return read_xml(path(name)) if os.path.exists(path(name)) else None

    cwd = os.getcwd()
    if workdir:
        os.chdir(workdir)
    try:
        solver_params = read_solver_params()
    finally:
        os.chdir(cwd)
    if ocean is None:
        ocean = Ocean(load("ocean_params.xml"), solver_params=solver_params,
                      device=device)
    atmos_params = load("atmosphere_params.xml")
    seaice_params = load("seaice_params.xml")
    atmos = Atmosphere(atmos_params, device=device) if atmos_params else None
    seaice = SeaIce(seaice_params, device=device) if seaice_params else None
    sp = {}
    if solver_params:
        sp = {k: v for k, v in solver_params.items()
              if not hasattr(v, "items")}
    return CoupledModel(ocean, atmos, seaice,
                        params=load("coupledmodel_params.xml"),
                        solver_params=sp)
