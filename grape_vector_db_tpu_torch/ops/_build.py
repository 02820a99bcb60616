"""Build and load the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, ``_build/libgvdb_<name>_<key>.so``
(``key``: the hash of the source and the flags, so an edited source builds
anew), and loaded with ``ctypes``. Builds happen at first use and never when a
module is imported. Sources build independently, so two threads may build two
libraries at once; each name has its own lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Optional

__all__ = ["BUILD_INFO", "find_nvcc", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()
#: Per source name, what its build did: library path, seconds, compiler log
#: (ptxas -v). Each entry is updated in place, so a module may hold it.
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from csrc/*.cu at first use and need the "
        "CUDA toolkit")


def load(name: str, bind: Callable[[ctypes.CDLL], None],
         src_path: Optional[str] = None) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (or ``src_path``) once per source hash and
    load it as library ``name``. ``bind`` sets the argument and result types
    of the library's functions; every library also exports
    ``gvdb_cuda_error_string(int)``."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src_path = src_path or os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
        with open(src_path, "rb") as f:
            src = f.read()
        key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        so = os.path.join(_BUILD_DIR, f"libgvdb_{name}_{key}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.tmp.{os.getpid()}"
            proc = subprocess.run([find_nvcc(), *_NVCC_FLAGS, "-o", tmp, src_path],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src_path}:\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.gvdb_cuda_error_string.restype = ctypes.c_char_p
        lib.gvdb_cuda_error_string.argtypes = [ctypes.c_int]
        bind(lib)
        BUILD_INFO.setdefault(name, {}).update(
            library=so, seconds=time.perf_counter() - t0, log=log)
        _LIBS[name] = lib
        return lib
