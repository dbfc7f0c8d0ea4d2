"""Post-processing toolbox (port of ``iemic_tpu/post``): the land-mask
tools, the HDF5 and table readers, the transport diagnostics and the
plots of the ocean, atmosphere and sea ice (reference matlab/ toolbox and
scripts/plotbif.sh).  h5py and matplotlib are imported inside the
functions that need them."""

from .plotting import (plot_ocean, plot_overturning, plot_barotropic,
                       plot_atmosphere, plot_seaice, plot_bif)
from .transports import compute_transports
from .masks import (create_mask, flood_fill, smooth_mask, mask_from_etopo,
                    merge_masks, write_mask_file, edit_mask, MaskEditor)
from .readers import (read_state, read_eigen, read_cdata, read_tdata,
                      read_profile, state_to_grid)

__all__ = [
    "plot_ocean", "plot_overturning", "plot_barotropic",
    "plot_atmosphere", "plot_seaice", "plot_bif",
    "compute_transports",
    "create_mask", "flood_fill", "smooth_mask", "mask_from_etopo",
    "merge_masks", "write_mask_file", "edit_mask", "MaskEditor",
    "read_state", "read_eigen", "read_cdata", "read_tdata",
    "read_profile", "state_to_grid",
]
