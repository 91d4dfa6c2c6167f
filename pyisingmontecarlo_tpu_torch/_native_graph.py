"""Build and load the native graph passes of ``native/graphc.cpp``.

``g++ -O3 -march=native -shared -fPIC`` compiles the source at first use into
``_build/`` under a name keyed by the hash of the source and the flags, and
``ctypes`` loads it. The library is written under a temporary name and moved
into place, so processes that build it at once each find a whole file.

The python passes of ``graph.py`` (the plain version, array for array the
same) run only where no ``g++`` is on ``PATH`` (``available()`` is False). A
failed compile, load or symbol lookup raises: the order of the color classes
is the classical engine's random stream, so a quiet fallback would hide a
broken build. Each of the four passes adds one to its ``calls`` when it runs.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "load", "build_ell", "color_sites", "color_edges", "strong_color_edges"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "native" / "graphc.cpp"
BUILD = _PKG / "_build"
COMPILER = "g++"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_i64, _i32 = ctypes.c_int64, ctypes.c_int32
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
# C entry -> (argtypes, restype)
_SIGNATURES = {
    "graphc_degrees": ([_i64, _i64, _I32P, _I32P, _I32P], _i32),
    "graphc_build_ell": ([_i64, _i64, _i32, _I32P, _I32P, _F64P, _I32P, _F64P, _I32P, _I32P], None),
    "graphc_color_sites": ([_i64, _i64, _I32P, _I32P, _I32P], _i32),
    "graphc_color_edges": ([_i64, _i64, _I32P, _I32P, _I32P], _i32),
    "graphc_strong_color_edges": ([_i64, _i64, _I32P, _I32P, _I32P], _i32),
}

_lock = threading.Lock()
_lib = None


def available() -> bool:
    """Whether a C++ compiler (``g++``) is on ``PATH``."""
    return shutil.which(COMPILER) is not None


def build(source=SOURCE, build_dir=BUILD) -> Path:
    """Compile ``source`` unless a library for it and these flags is in
    ``build_dir``; returns the library's path. Raises ``RuntimeError``,
    naming the command and what it printed, if the compiler fails."""
    cxx = shutil.which(COMPILER)
    if cxx is None:
        raise RuntimeError(f"{COMPILER} not found on PATH; the native graph library cannot be built")
    source, build_dir = Path(source), Path(build_dir)
    digest = hashlib.sha256(source.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    lib = build_dir / f"libgraphc-{digest}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{COMPILER} failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """Build if needed, then load the library with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _edges(ea, eb):
    return np.ascontiguousarray(ea, np.int32), np.ascontiguousarray(eb, np.int32)


def build_ell(nvars: int, ea: np.ndarray, eb: np.ndarray, ej: np.ndarray):
    """``(neighbors, jmat, degree, max_deg, slot_a, slot_b)``: graph.py's ``_build_ell_numpy``."""
    lib = load()
    ea, eb = _edges(ea, eb)
    ej = np.ascontiguousarray(ej, np.float64)
    E = len(ea)
    degree = np.zeros(nvars, np.int32)
    max_deg = int(lib.graphc_degrees(nvars, E, ea, eb, degree))
    neighbors = np.zeros((nvars, max_deg), np.int32)
    jmat = np.zeros((nvars, max_deg), np.float64)
    slot_a = np.zeros(E, np.int32)
    slot_b = np.zeros(E, np.int32)
    lib.graphc_build_ell(nvars, E, max_deg, ea, eb, ej, neighbors.reshape(-1), jmat.reshape(-1), slot_a, slot_b)
    build_ell.calls += 1
    return neighbors, jmat, degree, max_deg, slot_a, slot_b


def color_sites(nvars: int, ea: np.ndarray, eb: np.ndarray) -> np.ndarray:
    """int32 ``[nvars]`` site colors: graph.py's ``_color_sites_python``."""
    lib = load()
    ea, eb = _edges(ea, eb)
    colors = np.empty(nvars, np.int32)
    lib.graphc_color_sites(nvars, len(ea), ea, eb, colors)
    color_sites.calls += 1
    return colors


def color_edges(nvars: int, ea: np.ndarray, eb: np.ndarray) -> np.ndarray:
    """int32 ``[nedges]`` edge colors: graph.py's ``_color_edges_python``."""
    lib = load()
    ea, eb = _edges(ea, eb)
    ecolors = np.empty(len(ea), np.int32)
    lib.graphc_color_edges(nvars, len(ea), ea, eb, ecolors)
    color_edges.calls += 1
    return ecolors


def strong_color_edges(nvars: int, ea: np.ndarray, eb: np.ndarray) -> np.ndarray:
    """int32 ``[nedges]`` strong edge colors: graph.py's ``_strong_color_edges_python``."""
    lib = load()
    ea, eb = _edges(ea, eb)
    ecolors = np.empty(len(ea), np.int32)
    lib.graphc_strong_color_edges(nvars, len(ea), ea, eb, ecolors)
    strong_color_edges.calls += 1
    return ecolors


build_ell.calls = color_sites.calls = color_edges.calls = strong_color_edges.calls = 0
