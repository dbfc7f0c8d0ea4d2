"""Frozen copy of the port's ocean assembly and what it imports, with
the package layout of ``iemic_tpu_torch`` kept so that its relative
imports stand unchanged."""
