"""iemic_tpu_torch — the PyTorch/CUDA port of iemic_tpu.

The same implicit ocean model (pseudo-arclength continuation of steady
states, Newton-Krylov correctors, the De Niet-Wubs block preconditioner)
on PyTorch tensors, with the stencil matvec of the mixed-precision
Krylov loop as a hand-written CUDA kernel for Hopper (sm_90a).

The package mirrors the layout of ``iemic_tpu`` module by module and
imports ``torch`` only, never ``jax``.  Every function takes its device
and dtype from its tensor arguments (float64 unless stated).
"""

__version__ = "0.1.0"
