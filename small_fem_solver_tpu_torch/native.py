"""ctypes binding of the native rainflow counter (the port's own copy of
the part of ``small_fem_solver_tpu/native.py`` it needs).

``native/mesh_kit.cpp`` holds ``rainflow_damage_sums``, a batched ASTM
E1049 rainflow Miner sum over [S, M] float64 histories, identical in its
results to the Python stack of ``ops/spectrum.py::_rainflow_ranges``.  At
first use it is compiled with the host C++ compiler into
``small_fem_solver_tpu_torch/_build/`` (named by a hash of the source and
flags; ``native/`` is never written) and loaded with ``ctypes``.  Without
a compiler, or when the build fails, :func:`rainflow_damage_sums_native`
returns ``None`` and the caller counts with the Python stack.  This is a
host-side counter, not a device path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _ROOT / "native" / "mesh_kit.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_tried = False


def _build() -> pathlib.Path | None:
    """The compiled library (built if needed), or None."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not _SOURCE.exists():
        return None
    tag = hashlib.sha256(_SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libmesh_kit_{tag}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(_SOURCE)], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, so)
    return so


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.rainflow_damage_sums.restype = ctypes.c_int
    lib.rainflow_damage_sums.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_double, f64p, f64p]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native counter is built and loaded."""
    return _load() is not None


def rainflow_damage_sums_native(y, m_slope: float):
    """Batched rainflow Miner sums ``(sum w * range^m, sum w)`` per member
    of ``y`` [S, M] (float64 on the host), or None when the library is
    absent."""
    lib = _load()
    if lib is None:
        return None
    y = np.ascontiguousarray(y, dtype=np.float64)
    S, M = y.shape
    out_sum = np.empty(M, np.float64)
    out_n = np.empty(M, np.float64)
    if lib.rainflow_damage_sums(y, S, M, float(m_slope), out_sum, out_n):
        raise RuntimeError("rainflow_damage_sums failed")
    return out_sum, out_n
