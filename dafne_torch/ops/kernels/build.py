"""Build the port's native sources and load them with ctypes.

Each ``dafne_torch/csrc/<name>.cu`` compiles with nvcc, and each host-only
``dafne_torch/csrc/<name>.cpp`` with g++, into its own shared library with
a plain C interface, under ``dafne_torch/csrc/build/`` (listed in
``.gitignore``).  A library's file name carries a hash of its source and
flags, so an edited source rebuilds and an unchanged one loads as it is.
Nothing is built at import: the first call that needs a library builds it.
``check_cuda`` is the wrappers' check of a tensor before its pointer goes
to a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no multiply-add contraction: the kernels keep the plain versions'
    # rounding, op for op, so their outputs are bit-equal
    "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]
# no multiply-add contraction on the host either: the host libraries write
# each fused multiply-add they mean as std::fma
CXX_FLAGS = ["-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()  # the loader's threads may ask for a library at once


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels cannot be built")
    return found


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found; host libraries cannot be built")
    return found


def _source(name: str):
    """(source path, compiler, flags) of csrc/<name>: a .cu through nvcc,
    else a .cpp through the host compiler."""
    cu = os.path.join(CSRC, f"{name}.cu")
    if os.path.exists(cu):
        return cu, _nvcc, NVCC_FLAGS
    return os.path.join(CSRC, f"{name}.cpp"), _cxx, CXX_FLAGS


def lib_path(name: str) -> str:
    src, _, flags = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu (nvcc) or csrc/<name>.cpp (g++) unless it is
    built already.  Returns the compiler's output (with ptxas's register
    report for CUDA), or "" when nothing was built."""
    out = lib_path(name)
    if os.path.exists(out):
        return ""
    src, compiler, flags = _source(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler(), *flags, "-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler())} failed for "
                           f"{os.path.basename(src)}:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>, built first if needed.  Only a
    first load takes the lock."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        if name not in _LIBS:
            build(name)
            _LIBS[name] = ctypes.CDLL(lib_path(name))
        return _LIBS[name]


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Raise ValueError unless `t` is a contiguous CUDA tensor of `dtype`
    and `shape`."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
