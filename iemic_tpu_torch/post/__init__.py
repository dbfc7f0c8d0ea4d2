"""Post-processing toolbox (port of ``iemic_tpu/post``): so far the
land-mask tools of ``post/masks.py``, which the mask homotopy and its
tests write mask files with."""

from .masks import (create_mask, flood_fill, smooth_mask, mask_from_etopo,
                    merge_masks, write_mask_file, edit_mask, MaskEditor)

__all__ = ["create_mask", "flood_fill", "smooth_mask", "mask_from_etopo",
           "merge_masks", "write_mask_file", "edit_mask", "MaskEditor"]
