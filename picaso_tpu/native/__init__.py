"""Native (C++) runtime tier: build-on-demand fast loaders.

The reference's "native" tier is numba JIT; its opacity-DB ingest is
Python sqlite3 + per-row ``np.load`` (optics.py:1985-1996).  Here the
ingest is a small C++ library (``fastload.cpp``) compiled on first use
with the system g++ against the system libsqlite3, bound through ctypes
(pybind11 is not in the image).  Everything degrades gracefully: if the
toolchain or library is unavailable, callers fall back to the pure-Python
loader.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading

import numpy as np

__all__ = ['available', 'load_molecular', 'load_continuum', 'build']

_SRC = os.path.join(os.path.dirname(__file__), 'fastload.cpp')
_SO = os.path.join(os.path.dirname(__file__), '_fastload.so')
_lock = threading.Lock()
_lib = None
_failed = False


def _find_sqlite():
    for pat in ('/lib/x86_64-linux-gnu/libsqlite3.so*',
                '/usr/lib/x86_64-linux-gnu/libsqlite3.so*',
                '/usr/lib/libsqlite3.so*'):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def build(force=False):
    """Compile fastload.cpp -> _fastload.so; returns the .so path."""
    if (not force and os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    sqlite = _find_sqlite()
    if sqlite is None:
        raise RuntimeError('libsqlite3 shared library not found')
    # no -ffast-math: test_native.py asserts BIT parity of log10 output
    # with the numpy loader, and fast-math log10 results are not
    # reproducible across hosts/compilers
    cmd = ['g++', '-O3', '-std=c++17', '-march=native',
           '-fopenmp-simd', '-shared', '-fPIC', _SRC,
           sqlite, '-lpthread', '-o', _SO + '.tmp']
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(_SO + '.tmp', _SO)
    return _SO


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(build())
        except Exception:
            _failed = True
            return None
        lib.fastload_molecular.restype = ctypes.c_int
        lib.fastload_molecular.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        lib.fastload_continuum.restype = ctypes.c_int
        lib.fastload_continuum.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available():
    """True when the native loader can be built/loaded on this host."""
    return _load() is not None


def _cstrs(names):
    arr = (ctypes.c_char_p * len(names))()
    keep = [n.encode() for n in names]
    arr[:] = keep
    return arr, keep


def load_molecular(db_path, molecules, npt, loc, resample=1):
    """log10-opacity cube [nmol, npt, nloc] (fill -50) via the C++ path.

    Returns None when the native library is unavailable, so callers can
    fall back to the Python loader. Raises on a decode error (schema or
    blob-format mismatch) — the caller should also fall back then.
    """
    lib = _load()
    if lib is None:
        return None
    loc = np.ascontiguousarray(loc, dtype=np.int64)
    out = np.full((len(molecules), npt, len(loc)), -50.0, dtype=np.float32)
    names, keep = _cstrs(molecules)
    rc = lib.fastload_molecular(
        db_path.encode(), names, len(molecules), npt,
        loc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(loc),
        int(resample), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f'fastload_molecular failed (code {rc})')
    return out


def load_continuum(db_path, molecules, cia_temps, loc, resample=1):
    """Continuum cube [nmol, ntemp, nloc] float32; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    loc = np.ascontiguousarray(loc, dtype=np.int64)
    temps = np.ascontiguousarray(cia_temps, dtype=np.float64)
    out = np.zeros((len(molecules), len(temps), len(loc)), dtype=np.float32)
    names, keep = _cstrs(molecules)
    rc = lib.fastload_continuum(
        db_path.encode(), names, len(molecules),
        temps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(temps),
        loc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(loc),
        int(resample), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f'fastload_continuum failed (code {rc})')
    return out
