"""Hand-written Hopper kernels for the 27-point x 6-variable stencil matvec.

Port of the Pallas TPU kernel ``iemic_tpu/ops/stencil_pallas.py``
(``_kernel`` launched by ``apply_stencil_prepared``): the f32 operator of
every inner Krylov iteration of the mixed-precision solve.  The CUDA
source is ``iemic_tpu_torch/csrc/stencil_matvec.cu``; it is compiled with
nvcc for ``sm_90a`` into a plain-C shared library at first use and bound
with ctypes.  The source note there says what bounds the kernels and what
their design does about it.

The library holds two kernels for each coefficient type (f32, bf16): the
wide kernel (16-byte coefficient loads, the 972 terms of a point split
over the threads of a block), for a row length ``n`` divisible by its
vector width, and the general-shape kernel (one thread per grid point)
for every other shape.  :func:`kernel_variant` names the entry point a
call takes.

``prepare`` is a cast to the coefficient type plus ``.contiguous()``:
the natural layout is already contiguous in ``i``, which is what both
kernels want, so none of the TPU kernel's permutation / lane retiling is
carried over.

``apply_stencil_prepared`` launches a kernel for a CUDA tensor (or
raises) and uses the plain PyTorch version, :func:`apply_plain`, for a
tensor on the CPU.  ``LAUNCHES`` counts kernel launches, and
``LAUNCHES_BY_ENTRY`` counts them by entry point.
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

_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
# points per 16-byte coefficient load of the wide kernel
WIDE_VEC = {torch.float32: 4, torch.bfloat16: 8}
ENTRIES = tuple(f"stencil_matvec_{tag}{wide}" for tag in _TAG.values()
                for wide in ("_wide", ""))

# kernel launches made by apply_stencil_prepared (one per call on CUDA),
# in all and by entry point
LAUNCHES = 0
LAUNCHES_BY_ENTRY = dict.fromkeys(ENTRIES, 0)

_LIB = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY_ENTRY:
        LAUNCHES_BY_ENTRY[name] = 0


def kernel_variant(dtype, l: int, m: int, n: int) -> str:
    """The library entry point that a call with coefficients of dtype on
    an (l, m, n) grid takes, given 16-byte aligned tensors: the wide
    kernel where a grid row is a whole number of 16-byte coefficient
    vectors, else the general-shape kernel."""
    if dtype not in _TAG:
        raise TypeError(f"stencil_hopper: coefficient dtype {dtype}")
    if min(l, m, n) < 1:
        raise ValueError(f"stencil_hopper: grid {(l, m, n)}")
    wide = "_wide" if n % WIDE_VEC[dtype] == 0 else ""
    return f"stencil_matvec_{_TAG[dtype]}{wide}"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("stencil_hopper: no CUDA toolkit (nvcc) found")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(verbose: bool = False) -> str:
    """Compile the kernel library from the repository's source (once per
    content hash of source + flags) and return its path; what nvcc and
    ptxas said is kept beside it as ``<path>.log``."""
    with open(_SRC, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"libstencil_matvec-{key[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, _SRC]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
        with open(out + ".log", "w") as fh:
            fh.write(res.stdout + res.stderr)
        os.replace(tmp, out)
    if verbose and os.path.exists(out + ".log"):
        with open(out + ".log") as fh:
            print(fh.read())
    return out


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name in ENTRIES:
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
    if dtype not in _TAG:
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

    CPU tensors take :func:`apply_plain`; CUDA tensors launch the kernel
    that :func:`kernel_variant` names (the general-shape kernel instead
    of the wide one if a tensor is not 16-byte aligned) or raise."""
    if AnK.device.type == "cpu" and x.device.type == "cpu":
        return apply_plain(AnK, x, periodic=periodic)
    if AnK.device.type != "cuda" or x.device != AnK.device:
        raise ValueError("stencil_hopper: AnK and x must be on one CUDA "
                         f"device (got {AnK.device}, {x.device})")
    nun, l, m, n = x.shape
    if nun != 6 or AnK.shape != (27, 6, 6, l, m, n):
        raise ValueError(f"stencil_hopper: shapes {tuple(AnK.shape)} and "
                         f"{tuple(x.shape)} do not match")
    entry = kernel_variant(AnK.dtype, l, m, n)
    if not AnK.is_contiguous():
        raise ValueError("stencil_hopper: AnK must be contiguous "
                         "(use prepare)")
    x = x.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    if entry.endswith("_wide") and any(
            t.data_ptr() % 16 for t in (AnK, x, y)):
        entry = entry[:-len("_wide")]
    global LAUNCHES
    err = getattr(_lib(), entry)(
        AnK.data_ptr(), x.data_ptr(), y.data_ptr(), l, m, n,
        int(periodic), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil_hopper: {entry} launch failed "
                           f"(cudaError {err})")
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[entry] += 1
    return y
