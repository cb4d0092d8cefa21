"""Native (C++) host components, compiled on demand with g++ and loaded via
ctypes.

The sources live beside this file; the libraries are built at first use
into ``lorikeet_tpu_torch/build/`` (listed in ``.gitignore``).  They are
compiled with ``-march=native``, so a library is only safe on the kind of
CPU that built it: the file name carries a hash of the sources, the flags
and this machine's CPU (model and feature flags, as ``/proc/cpuinfo`` gives
them), and a tree copied to another machine rebuilds by itself.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
#: the f64 results of pairhmm.cpp (and with them byte-identical VCFs) may
#: depend on these flags: keep them as the JAX package has them
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIBS = {}
_MACHINE = None


def machine_key() -> str:
    """What ``-march=native`` resolves to here: the architecture and the
    first CPU's model name and feature flags."""
    global _MACHINE
    if _MACHINE is None:
        parts = [platform.machine()]
        try:
            with open("/proc/cpuinfo") as fh:
                seen = set()
                for line in fh:
                    key = line.split(":", 1)[0].strip()
                    if key in ("model name", "flags", "Features") \
                            and key not in seen:
                        seen.add(key)
                        parts.append(line.strip())
        except OSError:
            parts.append(platform.processor())
        _MACHINE = "\n".join(parts)
    return _MACHINE


def _digest(srcs: list[str], link: list[str]) -> str:
    h = hashlib.sha256()
    h.update(" ".join((*CXX_FLAGS, *link)).encode())
    h.update(machine_key().encode())
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def load(name: str, sources: list[str], link: list[str] = (),
         headers: list[str] = ()) -> ctypes.CDLL:
    """Compile (if no library for these sources on this machine exists) and
    load lib<name>_host_<hash>.so from the given sources.  ``headers`` are
    the files the sources include: hashed with them, not compiled."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        srcs = [os.path.join(_DIR, s) for s in sources]
        hashed = srcs + [os.path.join(_DIR, h) for h in headers]
        so_path = os.path.join(
            BUILD_DIR, f"lib{name}_host_{_digest(hashed, list(link))}.so")
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cmd = ["g++", *CXX_FLAGS, "-o", tmp] + srcs + list(link)
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        _LIBS[name] = lib
        return lib
