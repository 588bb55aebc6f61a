"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``_build/<name>-<digest>.so``; the digest covers the source, the
headers of ``csrc/`` and the flags, so an edited source rebuilds and an
unchanged one is reused. The first request for any library builds every
missing one, one nvcc process per source, all started together.

A C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; the Python
wrappers raise on a non-zero code (:func:`check`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("fused_dual_attn", "fused_layer_step", "fused_loss")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, in
    parallel. Returns the seconds each compile took (empty when all were
    built). Raises with nvcc's output if one fails; ptxas's register and
    shared-memory report is kept in ``_build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    seconds = {}
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        logs = "\n".join(
            f"--- {n} ---\n" + (BUILD_DIR / f"{n}.log").read_text()[-4000:] for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building the missing ones first."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def bind(lib: ctypes.CDLL, symbol: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def cuda_f32(name: str, t: torch.Tensor, shape=None) -> torch.Tensor:
    """Validate a kernel operand: a float32 tensor on a CUDA device, of the
    given shape (None entries free); returns it contiguous."""
    if t.dtype != torch.float32 or t.device.type != "cuda":
        raise TypeError(f"{name}: expected a float32 CUDA tensor, got {t.dtype} on {t.device}")
    if shape is not None and (
        t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    return t.contiguous()


def cuda_i32(name: str, t: torch.Tensor) -> torch.Tensor:
    """Validate an index operand: an int32 CUDA tensor; returns it contiguous."""
    if t.dtype != torch.int32 or t.device.type != "cuda":
        raise TypeError(f"{name}: expected an int32 CUDA tensor, got {t.dtype} on {t.device}")
    return t.contiguous()


def grid_for(device: torch.device, items: int, warps_per_block: int) -> int:
    """Blocks for a grid-stride kernel with one warp per item: enough to
    cover the items, at most 16 per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-items // warps_per_block), 16 * sms))
