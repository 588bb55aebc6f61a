"""ctypes loader for the native bundle-adjustment solver, built at first use.

``native/ba_solver.cpp`` (a byte-for-byte copy of the JAX package's) is
compiled with g++ (``-O3 -march=native -fopenmp``) into
``_build/libgasfm_ba.<host>-<digest>.so`` beside the CUDA kernels' libraries
(``ops/kernels/build.py``). The host tag keys the ``-march=native`` build to
the machine's CPU flags, as the JAX package keys its own (a tree shared
between hosts must not load another CPU's vector ISA); the digest covers the
source and the flags, so an edited source rebuilds. The library is written
under a temporary name and renamed into place, so concurrent processes
never load a half-written file. A failed build raises with the compiler's
output: there is no build without OpenMP.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().parent / "native" / "ba_solver.cpp"
BUILD_DIR = PKG / "_build"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-fopenmp")

_lock = threading.Lock()
_lib = None


def host_tag() -> str:
    """The machine's architecture and a hash of its CPU flags line (the ISA
    surface ``-march=native`` keys on); the architecture alone where
    /proc/cpuinfo is unavailable."""
    tag = platform.machine() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return f"{tag}-{hashlib.sha1(line.encode()).hexdigest()[:8]}"
    except OSError:
        pass
    return tag


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libgasfm_ba.{host_tag()}-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the solver into :func:`library_path` (if it is not there) and
    return the path. Raises ``RuntimeError`` with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("cannot build the bundle-adjustment solver: g++ is not on PATH") from e
    if proc.returncode != 0:
        log = proc.stdout + proc.stderr
        hint = ""
        if "omp" in log.lower():
            hint = ("\nThe compiler reports no OpenMP support (-fopenmp / omp.h / libgomp): "
                    "the solver is built with OpenMP only.")
        raise RuntimeError(f"g++ failed to build the bundle-adjustment solver "
                           f"({' '.join(cmd)}):\n{log[-4000:]}{hint}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded solver, built first where needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            c_double_p = ctypes.POINTER(ctypes.c_double)
            c_int_p = ctypes.POINTER(ctypes.c_int)
            for name in ("gasfm_ba_euclidean", "gasfm_ba_projective"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    c_double_p, c_double_p, c_double_p,
                    c_int_p, c_int_p,
                    c_double_p, c_double_p,
                    ctypes.c_double, ctypes.c_int, ctypes.c_double,
                    ctypes.c_int, ctypes.c_int, c_double_p,
                ]
            _lib = lib
        return _lib
