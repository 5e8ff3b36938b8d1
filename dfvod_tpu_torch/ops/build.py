"""Build and load the package's CUDA kernels and host libraries.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under
``dfvod_tpu_torch/build/`` (listed in ``.gitignore``) at first use and
loaded with ``ctypes``. The library's file name carries a hash of the
source and of the shared headers, so an edited source is rebuilt and a
built one is reused. A failed build raises; nothing falls back.

The data path's host code (``csrc/<name>.cpp``: the JPEG decoder and the
resize) is built the same way with the host C++ compiler
(``build_host`` / ``load_host``). ``HOST_FLAGS`` names no machine-specific
target and turns floating-point contraction off, so the resize gives the
same bits on every x86-64 machine.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path(name: str) -> str:
    """The library's path; its name hashes the source, the shared headers
    (``csrc/*.cuh``) and the target flags."""
    digest = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def find_cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler ($CXX, g++, c++): cannot "
                       "build the data path's host libraries")


def host_library_path(name: str) -> str:
    """The host library's path; its name hashes ``csrc/<name>.cpp`` and
    ``HOST_FLAGS``."""
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    with open(os.path.join(CSRC_DIR, f"{name}.cpp"), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _compile(out: str, cmd, what: str):
    """Run ``cmd`` (which writes ``out``'s temporary) unless ``out``
    exists; (out, seconds, log) as ``build`` returns them."""
    if os.path.exists(out):
        return out, 0.0, "(reused)"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, seconds, log


def build_host(name: str):
    """Compile ``csrc/<name>.cpp`` with the host compiler unless its
    library exists. Returns (library path, seconds, compiler output)."""
    return _compile(host_library_path(name),
                    [find_cxx(), *HOST_FLAGS,
                     os.path.join(CSRC_DIR, f"{name}.cpp")],
                    f"the host build of {name}.cpp")


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>.cpp``, built if needed."""
    return ctypes.CDLL(build_host(name)[0])


def build(name: str):
    """Compile ``csrc/<name>.cu`` unless the library for this source
    exists. Returns (library path, nvcc seconds, nvcc output); 0.0 and
    "(reused)" when the library existed."""
    return _compile(library_path(name),
                    [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                     "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                     os.path.join(CSRC_DIR, f"{name}.cu")],
                    f"nvcc for {name}.cu")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(build(name)[0])
