"""Hand-written Hopper kernel for the 27-point x 6-variable stencil matvec.

Port of the Pallas TPU kernel ``iemic_tpu/ops/stencil_pallas.py``
(``_kernel`` launched by ``apply_stencil_prepared``): the f32 operator of
every inner Krylov iteration of the mixed-precision solve.  The CUDA
source is ``iemic_tpu_torch/csrc/stencil_matvec.cu``; it is compiled with
nvcc for ``sm_90a`` into a plain-C shared library at first use and bound
with ctypes.  The source note there says what bounds the kernel and what
its design does about it.

``prepare`` is a cast to the coefficient type (f32 or bf16) plus
``.contiguous()``: the natural layout is already coalesced on the card,
so none of the TPU kernel's permutation / lane retiling is carried over.

``apply_stencil_prepared`` launches the kernel for a CUDA tensor (or
raises) and uses the plain PyTorch version, :func:`apply_plain`, for a
tensor on the CPU.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

from .stencil import apply_stencil

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "stencil_matvec.cu")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches made by apply_stencil_prepared (one per call on CUDA)
LAUNCHES = 0

_LIB = None
_ENTRY = {torch.float32: "stencil_matvec_f32",
          torch.bfloat16: "stencil_matvec_bf16"}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("stencil_hopper: no CUDA toolkit (nvcc) found")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(verbose: bool = False) -> str:
    """Compile the kernel library from the repository's source (once per
    content hash of source + flags) and return its path."""
    with open(_SRC, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"libstencil_matvec-{key[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    if verbose:
        print(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def prepare(An: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Cast the (27, 6, 6, l, m, n) stencil tensor to the kernel's
    coefficient type (f32 or bf16), contiguous.  Once per Jacobian."""
    if dtype not in _ENTRY:
        raise ValueError(f"stencil_hopper: unsupported dtype {dtype}")
    return An.to(dtype).contiguous()


def apply_plain(AnK: torch.Tensor, x: torch.Tensor, *,
                periodic: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 coefficients times the
    27 f32 windows of x, f32 output."""
    return apply_stencil(AnK.float(), x.float(), periodic=periodic)


def apply_stencil_prepared(AnK: torch.Tensor, x: torch.Tensor, *,
                           periodic: bool) -> torch.Tensor:
    """y[A] = sum_{p,B} AnK[p,A,B] * shift_p(x[B]) with AnK from
    :func:`prepare`; f32 output of shape x.shape.

    CPU tensors take :func:`apply_plain`; CUDA tensors launch the Hopper
    kernel or raise."""
    if AnK.device.type == "cpu" and x.device.type == "cpu":
        return apply_plain(AnK, x, periodic=periodic)
    if AnK.device.type != "cuda" or x.device != AnK.device:
        raise ValueError("stencil_hopper: AnK and x must be on one CUDA "
                         f"device (got {AnK.device}, {x.device})")
    if AnK.dtype not in _ENTRY:
        raise TypeError(f"stencil_hopper: coefficient dtype {AnK.dtype}")
    nun, l, m, n = x.shape
    if nun != 6 or AnK.shape != (27, 6, 6, l, m, n):
        raise ValueError(f"stencil_hopper: shapes {tuple(AnK.shape)} and "
                         f"{tuple(x.shape)} do not match")
    if not AnK.is_contiguous():
        raise ValueError("stencil_hopper: AnK must be contiguous "
                         "(use prepare)")
    x = x.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    global LAUNCHES
    err = getattr(_lib(), _ENTRY[AnK.dtype])(
        AnK.data_ptr(), x.data_ptr(), y.data_ptr(), l, m, n,
        int(periodic), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil_hopper: kernel launch failed "
                           f"(cudaError {err})")
    LAUNCHES += 1
    return y
