# Copied from iemic_tpu/native/milu.py (numpy-only; importing iemic_tpu would import jax), with its own build.
"""ctypes bridge to the native MILU preconditioner.

Copy of ``iemic_tpu/native/milu.py`` (numpy only) with its own build: the
analog of the reference's mrilucpp handle-based bridge (reference
src/mrilucpp/mrilucpp.F90:120-265: create/set_params/factor/apply/destroy
on integer handles, wrapped by Ifpack_MRILU.h:37-60).  The shared library
is compiled from the repository's ``native/milu.cpp`` with g++ at first
use into ``build/native/``, keyed by a content hash of source and flags,
so it never shares a file with the JAX package's ``native/libmilu.so``.
A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "milu.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXX = os.environ.get("CXX", "g++")
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def build() -> str:
    """Compile the library (once per content hash of source + flags) and
    return its path."""
    with open(_SRC, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(CXXFLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"libmilu-{key[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        res = subprocess.run([CXX, *CXXFLAGS, "-o", tmp, _SRC],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{CXX} failed on native/milu.cpp:\n"
                               + res.stdout + res.stderr)
        os.replace(tmp, out)
    return out


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = build()
        lib = ctypes.CDLL(so)
        lib.milu_factor.restype = ctypes.c_int64
        lib.milu_factor.argtypes = [
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.milu_solve.restype = ctypes.c_int32
        lib.milu_solve.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int32]
        lib.milu_levels.restype = ctypes.c_int32
        lib.milu_levels.argtypes = [ctypes.c_int64]
        lib.milu_destroy.restype = None
        lib.milu_destroy.argtypes = [ctypes.c_int64]
        lib.milu_gmres.restype = ctypes.c_int32
        lib.milu_gmres.argtypes = [
            ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double)]
        _LIB = lib
        return lib


class MILU:
    """Factored multilevel ILU preconditioner (RAII over the handle)."""

    def __init__(self, data, indices, indptr, *, droptol: float = 1e-3,
                 dominance: float = 0.1, max_levels: int = 12,
                 min_coarse: int = 64, use_cmk: bool = True):
        lib = _load()
        data = np.ascontiguousarray(data, np.float64)
        indices = np.ascontiguousarray(indices, np.int32)
        indptr = np.ascontiguousarray(indptr, np.int64)
        self.n = len(indptr) - 1
        self._csr = (data, indices, indptr)   # kept for gmres()
        self._handle = lib.milu_factor(
            self.n, indptr, indices, data,
            float(droptol), float(dominance),
            int(max_levels), int(min_coarse), int(bool(use_cmk)))
        if self._handle == 0:
            raise RuntimeError("milu_factor failed")
        self.levels = int(lib.milu_levels(self._handle))

    def gmres(self, b: np.ndarray, *, tol: float = 1e-8,
              maxiter: int = 500, restart: int = 30,
              x0: np.ndarray | None = None):
        """Native right-preconditioned restarted GMRES on the factored
        matrix, the analog of the MRILU solver loop (mrilu/precon/
        gmres.F90).  Returns (x, iters, relres)."""
        lib = _load()
        data, indices, indptr = self._csr
        b = np.ascontiguousarray(b, np.float64).reshape(-1)
        if b.shape[0] != self.n:
            raise ValueError(f"size mismatch: {b.shape[0]} != {self.n}")
        x = (np.zeros_like(b) if x0 is None
             else np.ascontiguousarray(x0, np.float64).copy())
        relres = ctypes.c_double(0.0)
        it = lib.milu_gmres(self._handle, self.n, indptr, indices, data,
                            b, x, float(tol), int(maxiter), int(restart),
                            ctypes.byref(relres))
        if it < 0:
            raise RuntimeError("milu_gmres: bad handle")
        return x, int(it), float(relres.value)

    def solve(self, b: np.ndarray) -> np.ndarray:
        lib = _load()
        b = np.ascontiguousarray(b, np.float64).reshape(-1)
        if b.shape[0] != self.n:
            raise ValueError(f"size mismatch: {b.shape[0]} != {self.n}")
        x = np.empty_like(b)
        rc = lib.milu_solve(self._handle, b, x, self.n)
        if rc:
            raise RuntimeError("milu_solve: bad handle")
        return x

    def __del__(self):
        try:
            if getattr(self, "_handle", 0):
                _load().milu_destroy(self._handle)
        except Exception:
            pass


def factor(data, indices, indptr, *, droptol: float = 1e-3,
           max_levels: int = 12, fill_factor: float = 10.0,
           dominance: float = 0.1) -> MILU:
    """Functional entry used by the SolverFactory (fill_factor accepted
    for interface parity; dropping is tolerance-based)."""
    return MILU(data, indices, indptr, droptol=droptol,
                dominance=dominance, max_levels=max_levels)


def solve(fac: MILU, b: np.ndarray) -> np.ndarray:
    return fac.solve(b)
