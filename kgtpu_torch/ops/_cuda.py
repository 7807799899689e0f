"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

`build(src)` compiles one source under `kgtpu_torch/csrc/` for Hopper
(`sm_90a`) into `kgtpu_torch/_build/`, named by a hash of the source and the
flags, so a changed source or flag set builds anew and an unchanged one is
reused; `build(src, host=True)` compiles a host C++ source (the host ops of
`kgtpu_torch/native.py`) with g++ the same way.  `load(src, fn, argtypes)`
builds, opens the library once per source and returns its C function with
`argtypes` set (ctypes would otherwise pass every Python int as a 32-bit int
and cut the pointers).  `call_on(device,
fn, *args)` calls a loaded function with its arguments' device current and
the handle of that device's current stream as the last argument.  Nothing
is built when a module is imported: the CPU tests import every module, and
nvcc exists only beside the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# No --use_fast_math: the Gaussian kernel needs expf's exact exp(-0) = 1.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _gxx() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise RuntimeError("g++ not found: the host ops cannot be built")
    return cand


def build(src: str, host: bool = False) -> str:
    """Compile csrc/`src` into a shared library (once per source and flag
    hash) with nvcc, or with g++ when `host`, and return its path."""
    path = os.path.join(CSRC, src)
    flags = GXX_FLAGS if host else NVCC_FLAGS
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    stem = os.path.splitext(src)[0]
    out = os.path.join(BUILD_DIR, f"libkgtpu_{stem}_{digest[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_gxx() if host else _nvcc(), *flags, "-o", tmp, path], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"{'g++' if host else 'nvcc'} failed on {src}:\n{e.stdout}\n"
                           f"{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(src: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function `fn` of csrc/`src`, built and loaded at first use,
    returning an int (a cudaError_t value)."""
    f = _fns.get((src, fn))
    if f is not None:
        return f
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = _libs[src] = ctypes.CDLL(build(src))
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[(src, fn)] = f
        return f


def call_on(device: torch.device, fn: ctypes._CFuncPtr, *args) -> int:
    """fn(*args, stream) on `device`, with the handle of its current stream
    (what torch.cuda.current_stream(device).cuda_stream gives, read without
    building a Stream object, as torch's own generated kernels read it); the
    device is made current only where it is not already."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
