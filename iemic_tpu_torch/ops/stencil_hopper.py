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
vector width and 16-byte aligned tensors, and the general-shape kernel
(a lane owns a pair of neighbouring points and three output rows A of
them, a warp 32 neighbouring pairs, so that every warp load reads 64
consecutive coefficients of a plane whatever its alignment) for every
other call.  Where both can run they compute the same value, bit for
bit.  :func:`kernel_variant` names the entry point a call takes, and
:func:`general_launch` the general kernel's launch geometry.

``prepare`` is a cast to the coefficient type plus ``.contiguous()``:
the natural layout is already contiguous in ``i``, which is what both
kernels want, so none of the TPU kernel's permutation / lane retiling is
carried over.

``apply_stencil_prepared`` launches a kernel for a CUDA tensor (or
raises) and uses the plain PyTorch version, :func:`apply_plain`, for a
tensor on the CPU.  ``LAUNCHES`` counts kernel launches, and
``LAUNCHES_BY_ENTRY`` counts them by entry point.

The same library holds the BGS sweep's sub-block product
(``csrc/stencil_block.cu``, which replaces no TPU kernel): a stencil
sub-block A (27, a, b, l, m, n) of :data:`BLOCK_SHAPES` times x
(b, l, m, n), in f32 or f64, with x's strides as they are.
:func:`apply_block` launches it for a CUDA tensor (or raises) and
takes the plain expression, :func:`apply_block_plain`, on the CPU;
:func:`block_variant` names the entry point and layout a call takes.
``BLOCK_LAUNCHES`` counts its launches by entry point, apart from
``LAUNCHES``, and each launch adds to the program counter
``stencil block launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

from ..utils import logging as log
from .stencil import apply_stencil, windows

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SRCS = [os.path.join(_CSRC, name)
         for name in ("stencil_matvec.cu", "stencil_block.cu")]
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
# points per 16-byte coefficient load of the wide kernel
WIDE_VEC = {torch.float32: 4, torch.bfloat16: 8}
# the general kernel: a lane owns a pair of neighbouring points and
# GENERAL_ROWS output rows A of them, a block the 6 / GENERAL_ROWS warps
# of 32 pairs (GEN_ROWS in the source, which refuses any other geometry)
WARP = 32
GENERAL_ROWS = 3
ENTRIES = tuple(f"stencil_matvec_{tag}{wide}" for tag in _TAG.values()
                for wide in ("_wide", ""))

# kernel launches made by apply_stencil_prepared (one per call on CUDA),
# in all and by entry point
LAUNCHES = 0
LAUNCHES_BY_ENTRY = dict.fromkeys(ENTRIES, 0)

# the sub-block kernel: the (a, b) shapes it is built for (the sweep's
# 2x2, 2x1 and 1x2 blocks, 1x1, the 2D saddle multigrid's 3x3 and the Teko
# couplings' 4x2 and 2x4), its types, and the points a lane owns, one
# 16-byte vector of coefficients in the row layout (the source's Vec)
BLOCK_SHAPES = ((1, 1), (1, 2), (2, 1), (2, 2), (3, 3), (2, 4), (4, 2))
_BLOCK_TAG = {torch.float32: "f32", torch.float64: "f64"}
BLOCK_VEC = {torch.float32: 4, torch.float64: 2}
BLOCK_ENTRIES = tuple(f"stencil_block_{tag}" for tag in _BLOCK_TAG.values())
# launches made by apply_block, by entry point
BLOCK_LAUNCHES = dict.fromkeys(BLOCK_ENTRIES, 0)

_LIB = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for counts in (LAUNCHES_BY_ENTRY, BLOCK_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launches_by_entry() -> dict:
    """Launches of every entry point of the library since the last
    :func:`reset_launches`: the stencil matvec's and the sub-block
    kernel's."""
    return {**LAUNCHES_BY_ENTRY, **BLOCK_LAUNCHES}


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


def general_launch(l: int, m: int, n: int) -> tuple[int, int, int]:
    """(blocks, threads, points per thread) of the general kernel on an
    (l, m, n) grid, for either coefficient type.  Thread t of block b
    computes the output rows A = (t // 32) * GENERAL_ROWS + r,
    r < GENERAL_ROWS, at the flat points (k*m + j)*n + i
    = 64*b + 2*(t % 32) + h, h < 2, that lie in the grid."""
    return -(-(l * m * n) // (2 * WARP)), 6 // GENERAL_ROWS * WARP, 2


def needed_coefficients(l: int, m: int, n: int, periodic: bool,
                        a: int = 6, b: int = 6) -> int:
    """Coefficients of the 27 * a*b * l*m*n of an (a, b) block whose
    neighbour lies in the grid: the others multiply a zero, and no kernel
    reads them."""
    return a * b * (3 * l - 2) * (3 * m - 2) * (3 * n if periodic
                                                else 3 * n - 2)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("stencil_hopper: no CUDA toolkit (nvcc) found")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(verbose: bool = False) -> str:
    """Compile the kernel library from the repository's sources (once per
    content hash of sources + flags) and return its path; what nvcc and
    ptxas said is kept beside it as ``<path>.log``."""
    src = b""
    for path in _SRCS:
        with open(path, "rb") as fh:
            src += fh.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"libstencil_matvec-{key[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *_SRCS]
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
            # An, x, y; l, m, n, periodic; the general kernel's blocks,
            # threads and points per lane; the stream
            geometry = [] if name.endswith("_wide") else [ctypes.c_int] * 3
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
                + geometry + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in BLOCK_ENTRIES:
            fn = getattr(lib, name)
            # A and its strides of p, a, b; x and its four strides; y;
            # a, b, l, m, n, periodic, the row layout; the stream
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 \
                + [ctypes.c_void_p] + [ctypes.c_longlong] * 4 \
                + [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    geometry = () if entry.endswith("_wide") else \
        general_launch(l, m, n)
    global LAUNCHES
    err = getattr(_lib(), entry)(
        AnK.data_ptr(), x.data_ptr(), y.data_ptr(), l, m, n,
        int(periodic), *geometry,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil_hopper: {entry} launch failed "
                           f"(cudaError {err})")
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[entry] += 1
    return y


def block_variant(A: torch.Tensor, x: torch.Tensor) -> tuple[str, bool]:
    """The entry point that the sub-block product of A (27, a, b, l, m, n)
    and x (b, l, m, n) takes, and whether it takes the row layout (a grid
    row is a whole number of :data:`BLOCK_VEC` points and A's planes
    start on 16-byte boundaries).  Raises for what the kernel does not take:
    a type other than f32 or f64, A and x of two types, a shape outside
    :data:`BLOCK_SHAPES`, or planes of A that are not contiguous."""
    if A.dtype not in _BLOCK_TAG or x.dtype != A.dtype:
        raise TypeError(f"stencil_hopper: sub-block product of {A.dtype} "
                        f"and {x.dtype} (f32 or f64, one type)")
    if A.dim() != 6 or A.shape[0] != 27 \
            or tuple(A.shape[1:3]) not in BLOCK_SHAPES:
        raise ValueError(f"stencil_hopper: sub-block shape "
                         f"{tuple(A.shape)} (27, a, b, l, m, n) with "
                         f"(a, b) in {BLOCK_SHAPES}")
    _, a, b, l, m, n = A.shape
    if tuple(x.shape) != (b, l, m, n):
        raise ValueError(f"stencil_hopper: x {tuple(x.shape)} does not "
                         f"match the sub-block {tuple(A.shape)}")
    if min(l, m, n) < 1 or l * m * n >= 2 ** 31 - 64:
        raise ValueError(f"stencil_hopper: grid {(l, m, n)}")
    if any(size > 1 and st != want for size, st, want in zip(
            A.shape[3:], A.stride()[3:], (m * n, n, 1))):
        raise ValueError(f"stencil_hopper: the (l, m, n) planes of A "
                         f"must be contiguous (strides {A.stride()})")
    vec = BLOCK_VEC[A.dtype]
    row = A.data_ptr() % 16 == 0 and n % vec == 0 and all(
        size == 1 or st % vec == 0
        for size, st in zip(A.shape[:3], A.stride()[:3]))
    return f"stencil_block_{_BLOCK_TAG[A.dtype]}", row


def apply_block_plain(A: torch.Tensor, x: torch.Tensor, *, periodic: bool,
                      w=None) -> torch.Tensor:
    """Plain PyTorch version of the sub-block kernel: A times the 27
    windows of x (w, where a product of the same x took them already),
    summed over p and b."""
    w = windows(x, periodic) if w is None else w
    return (A * w.unsqueeze(1)).sum(dim=(0, 2))


def apply_block(A: torch.Tensor, x: torch.Tensor, *, periodic: bool,
                w=None) -> torch.Tensor:
    """y[a] = sum_{p,b} A[p,a,b] * shift_p(x[b]) for a stencil sub-block A
    (27, a, b, l, m, n) and x (b, l, m, n); output (a, l, m, n).

    CPU tensors take :func:`apply_block_plain` (on the windows w, where
    given); CUDA tensors launch the entry point that
    :func:`block_variant` names, with x's strides as they are, or
    raise."""
    if A.device.type == "cpu" and x.device.type == "cpu":
        return apply_block_plain(A, x, periodic=periodic, w=w)
    if A.device.type != "cuda" or x.device != A.device:
        raise ValueError("stencil_hopper: A and x must be on one CUDA "
                         f"device (got {A.device}, {x.device})")
    entry, row = block_variant(A, x)
    _, a, b, l, m, n = A.shape
    y = torch.empty((a, l, m, n), dtype=A.dtype, device=A.device)
    err = getattr(_lib(), entry)(
        A.data_ptr(), *A.stride()[:3], x.data_ptr(), *x.stride(),
        y.data_ptr(), a, b, l, m, n, int(periodic), int(row),
        torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil_hopper: {entry} launch failed "
                           f"(cudaError {err})")
    BLOCK_LAUNCHES[entry] += 1
    log.count("stencil block launches")
    return y
