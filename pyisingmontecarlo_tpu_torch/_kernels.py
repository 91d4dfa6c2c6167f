"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per source,
all started together) and links them into one shared library with a plain C
interface, at first use, into ``_build/`` under a name keyed by the hash of
the sources; ``ctypes`` loads it. Each C entry returns
``cudaGetLastError()`` after its launches, and the Python wrapper raises if it
is not 0 (``call``). Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["build", "load", "error_string", "smem_optin", "call", "stream", "device_limits", "resolve_device"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry -> argtypes (pointers and the stream as c_void_p, ints as c_int)
_SIGNATURES = {
    "sq2d_tiled_sweeps": ([_P] * 7 + [_I] * 8 + [_P], ctypes.c_int),
    "wl_sweeps": ([_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "ladder_sweeps": ([_P] * 11 + [_I] * 7 + [_P], ctypes.c_int),
    "wl_resident_sweeps": ([_P, _P, _P, _P, _I, _P, _P] + [_I] * 10 + [_P], ctypes.c_int),
    "ladder_resident_sweeps": ([_P] * 10 + [_I] * 9 + [_P], ctypes.c_int),
    "wl_tiled_sweeps": ([_P] * 6 + [_I] + [_P] * 2 + [_I] * 10 + [_P], ctypes.c_int),
    "threefry_chain": ([_P] * 3 + [_I] * 5 + [_P] * 3, ctypes.c_int),
    "threefry_bits": ([_P, _I, ctypes.c_longlong, _I, _P, _P], ctypes.c_int),
    "pmc_smem_optin": ([_I], ctypes.c_int),
    "pmc_cluster_group": ([_I], ctypes.c_int),
    "pmc_site_lanes": ([_I], ctypes.c_int),
    "pmc_long_scratch_bytes": ([_I, _I, _I], ctypes.c_longlong),
    "pmc_error_string": ([_I], ctypes.c_char_p),
}


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (on PATH, or under $CUDA_HOME/bin or /usr/local/cuda/bin); "
                       "the CUDA kernels cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists; returns
    its path. ``verbose`` compiles in any case, with ``-Xptxas -v``, and prints
    what nvcc says (registers, shared memory and spills of each kernel)."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = _BUILD / f"libpmc_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists() and not verbose:
        return lib
    nvcc = _nvcc()
    _BUILD.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    jobs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = tmp.with_suffix(f".{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    cmd = [nvcc, "-shared", "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
    try:
        for job_cmd, _, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(job_cmd)}\n{out}")
            if verbose:
                print(out, end="")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    finally:
        for _, obj, proc in jobs:
            proc.wait()
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the kernel library with its C signatures set."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def error_string(code: int) -> str:
    """``cudaGetErrorString`` of a code returned by a C entry."""
    return load().pmc_error_string(code).decode()


@functools.lru_cache(maxsize=None)
def smem_optin(device: int) -> int:
    """The opt-in shared memory per block of CUDA device ``device``, in bytes."""
    v = load().pmc_smem_optin(int(device))
    if v < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: {error_string(-v)} ({-v})")
    return v


def call(name: str, fn) -> None:
    """Run ``fn(lib)``, a C entry of the kernel library that launches on the
    current stream, and raise if it returns an error."""
    err = fn(load())
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(err)} ({err})")


def stream(x: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``x``'s device, as the C entries take it."""
    return torch.cuda.current_stream(x.device).cuda_stream


def device_limits(device) -> tuple:
    """``(limit, sms)`` of a CUDA device: its opt-in shared memory per block
    in bytes and its SM count, as the launchers' plans take them."""
    index = torch.device(device).index or 0
    return smem_optin(index), _sm_count(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``, cuda or cpu; raises for another type,
    or for cuda where torch has no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass device='cpu' "
            "to run the kernels' plain versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev
