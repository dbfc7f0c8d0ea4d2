"""Subpackage of iemic_tpu_torch; see the module docstrings."""
