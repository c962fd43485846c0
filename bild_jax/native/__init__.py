"""
Native (C++) runtime components, loaded via ctypes.

Dispatch pattern mirrors the reference's compiled/fallback split
(``bild/cython_imports.py``): if the shared library is missing it is built
on demand with g++; if that fails, callers fall back to the pure-Python
implementations in `bild_jax.io` (identical semantics, tested for parity).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "loader.cpp")
_SO = os.path.join(_DIR, "_loader.so")

_lib = None


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", "-o", _SO, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as exc:  # pragma: no cover - toolchain-dependent
        warnings.warn(f"building native loader failed ({exc}); "
                      "falling back to pure-python IO")
        return False


def get_lib():
    """The loaded native library, building it on first use; None if
    unavailable (callers must fall back)."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    lib = ctypes.CDLL(_SO)
    lib.bild_csv_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.bild_csv_load.restype = ctypes.c_int
    lib.bild_csv_dims.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.bild_csv_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.bild_csv_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib
