"""Build the package's CUDA sources into plain-C shared libraries.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into
`gnerf_tpu_torch/_build/lib<name>-<hash>.so` at first use and loaded with
`ctypes`. The hash covers the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import
time: the CPU tests import every module on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # one build per library, whichever thread asks first
build_log: dict[str, str] = {}  # name -> nvcc output of the last build


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build(names: Iterable[str]) -> float:
    """Compile every source in `names` that has no current library, all nvcc
    processes started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = _loaded[name] = ctypes.CDLL(library_path(name))
    return lib
