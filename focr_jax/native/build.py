"""Build + load the native host kernels.

The reference builds src/ncc.cpp with the cc crate at `-march=native`
(build.rs:1-12); here g++ compiles focr_jax/native/*.cpp into a shared
library on first use, cached by source hash. No pybind11 in this
environment — the C ABI is consumed via ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ncc_kernel.cpp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LOAD_ERROR: Exception | None = None


class FMatch(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_uint16),
        ("y", ctypes.c_uint16),
        ("similarity", ctypes.c_float),
    ]


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_DIR, f"_libfocrncc-{h}.so")


def _compile(so: str) -> None:
    # unique temp per process: concurrent first-use compiles (pytest-xdist,
    # parallel CLIs) must not interleave writes before the atomic rename
    tmp = f"{so}.{os.getpid()}.tmp"
    # -ffp-contract=off: gcc's default fast contraction fuses the replay's
    # f64 multiply-subtract into FMA, changing the last ulp vs NumPy for
    # ~28% of candidates — bit parity of similarities is the product
    cmd = [
        "g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
        "-shared", "-fPIC", "-fopenmp", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        # retry without OpenMP (still correct, just single-threaded batches)
        cmd = [c for c in cmd if c != "-fopenmp"]
        subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)


def load() -> ctypes.CDLL:
    """Compile (if needed) and load the native library. Raises on failure —
    callers degrade to the NumPy oracle path."""
    global _LIB, _LOAD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LOAD_ERROR is not None:
            raise _LOAD_ERROR
        try:
            so = _so_path()
            if not os.path.exists(so):
                _compile(so)
            lib = ctypes.CDLL(so)
            lib.focr_ncc_search_u8.restype = ctypes.c_int64
            lib.focr_ncc_search_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_float, ctypes.POINTER(FMatch), ctypes.c_int64,
            ]
            lib.focr_ncc_search_many_u8.restype = None
            lib.focr_ncc_search_many_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_float, ctypes.POINTER(FMatch), ctypes.c_int64,
                ctypes.c_void_p,
            ]
            lib.focr_post_winners.restype = ctypes.c_int64
            lib.focr_post_winners.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,  # key, sim
                ctypes.c_int64, ctypes.c_int64,  # n, overlap
                ctypes.c_void_p,  # win_out
            ]
            lib.focr_post_sort_winners.restype = ctypes.c_int64
            lib.focr_post_sort_winners.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,  # key, sim
                ctypes.c_int64, ctypes.c_int64,  # n, overlap
                ctypes.c_void_p,  # win_out
            ]
            _LIB = lib
            return lib
        except Exception as e:  # noqa: BLE001 - cache and re-raise
            _LOAD_ERROR = e
            raise


def available() -> bool:
    try:
        load()
        return True
    except Exception:  # noqa: BLE001
        return False
