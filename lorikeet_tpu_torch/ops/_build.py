"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C entry point.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under
``lorikeet_tpu_torch/build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, and loaded with ctypes.  The build happens at
first use; importing the package never runs ``nvcc``.  A failed build
raises: the device path has no host fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

#: no --use_fast_math / -ftz=true: the kernels keep IEEE expf, log10f and
#: denormals (see csrc/pairhmm.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}
#: seconds each library took to build in this process (0.0: already built)
BUILD_SECONDS: dict = {}
#: ptxas register/spill report of each build
BUILD_LOG: dict = {}


def find_nvcc() -> str | None:
    """nvcc from CUDA_HOME / CUDA_PATH, then PATH, then torch's guess."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    exe = shutil.which("nvcc")
    if exe:
        return exe
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    return None


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    return out[-1] if out else ""


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if no library for its current source
    exists, then load it."""
    return load_all((name,))[name]


def load_all(names) -> dict:
    """``load`` for several libraries: the missing ones are compiled by one
    ``nvcc`` each, all started together.  Returns {name: CDLL}."""
    with _LOCK:
        builds = {}
        for name in names:
            if name in _LIBS:
                continue
            src = os.path.join(CSRC, f"{name}.cu")
            with open(src, "rb") as fh:
                digest = hashlib.sha256(
                    fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            so_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
            tmp = f"{so_path}.{os.getpid()}.tmp"
            proc = None
            if not os.path.exists(so_path):
                nvcc = find_nvcc()
                if nvcc is None:
                    raise RuntimeError(f"cannot build {src}: no nvcc found "
                                       "(set CUDA_HOME or put nvcc on PATH)")
                os.makedirs(BUILD_DIR, exist_ok=True)
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, src], text=True,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            builds[name] = (src, so_path, tmp, proc, time.perf_counter())
        try:
            for name, (src, so_path, tmp, proc, t0) in builds.items():
                if proc is not None:
                    _, err = proc.communicate()
                    if proc.returncode != 0:
                        raise RuntimeError(f"nvcc failed on {src}:\n{err}")
                    BUILD_LOG[name] = err
                    os.replace(tmp, so_path)
                BUILD_SECONDS[name] = time.perf_counter() - t0
                _LIBS[name] = ctypes.CDLL(so_path)
        finally:        # no nvcc outlives a failed build
            for _, _, _, proc, _ in builds.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return {name: _LIBS[name] for name in names}
