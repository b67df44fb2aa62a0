"""Build the package's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for sm_90a into `kernels/build/lib<name>-<hash>.so`, where the hash covers
the source with the headers of csrc/ it includes, and the flags, so an
edited source or header builds anew and an unchanged one is built once per
checkout. Nothing is built when a module is
imported: the CPU tests import every module on machines without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "build")

# --fmad=false: no multiply-add contraction, so the kernels round like the
# plain torch versions they are checked against.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}   # name -> {"seconds", "cached", "ptxas"}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH): the CUDA "
                           "kernels cannot be built on this machine")
    return path


_LOCAL_INCLUDE = re.compile(r'^#include "(\w+\.cuh)"\n', re.M)


def source(name: str) -> str:
    """The text of csrc/<name>.cu with the headers of csrc/ that it includes
    (`#include "<header>.cuh"`) written in place: what nvcc compiles."""
    def text(path: str) -> str:
        with open(os.path.join(SRC_DIR, path)) as f:
            return f.read()
    return _LOCAL_INCLUDE.sub(lambda m: text(m.group(1)), text(f"{name}.cu"))


def build(name: str) -> str:
    """Compile csrc/<name>.cu if no build of this source exists; returns the
    shared library's path."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    digest = hashlib.sha256(
        (source(name) + " ".join(NVCC_FLAGS)).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        BUILD_LOG[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    os.replace(tmp, so)   # atomic: no process ever loads a partial file
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                       "ptxas": res.stderr}
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(build(name))
        return _LIBS[name]
