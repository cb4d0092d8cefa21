"""ctypes wrapper for the native (C++) exact pair-HMM host kernel.

Same numerics as ops/pairhmm.py::pairhmm_forward_np (the conformance spec);
used by the likelihood dispatcher for batches that stay on the host
(calling/likelihoods.py::compute_pair_likelihoods) and for the f64
escalation of suspicious device results.  The reference's
equivalent layer is the Intel GKL native pair-HMM behind the Rust wrapper
(reference/src/pair_hmm/pair_hmm.rs:345-375).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_lib = None
_failed = False


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        from lorikeet_tpu_torch.native import load
        lib = load("pairhmm", ["pairhmm.cpp"])
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.POINTER(ctypes.c_int64)
        i32 = ctypes.POINTER(ctypes.c_int32)
        f64 = ctypes.POINTER(ctypes.c_double)
        lib.pairhmm_forward_batch.argtypes = [
            u8, i64, i32, u8, u8, u8, u8, u8, i64, i32,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, f64]
        lib.pairhmm_forward_batch.restype = None
        _lib = lib
    except Exception:  # noqa: BLE001 — no toolchain: fall back to numpy
        _failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def pairhmm_forward_native_batch(pairs: list, n_threads: int = None):
    """log10 likelihoods [n] for (hap, read, q, iq, dq, gcp) pairs, or None
    when the native kernel is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(pairs)
    if n == 0:
        return np.zeros(0)
    hap_len = np.fromiter((len(p[0]) for p in pairs), np.int32, n)
    read_len = np.fromiter((len(p[1]) for p in pairs), np.int32, n)
    hap_off = np.zeros(n, np.int64)
    np.cumsum(hap_len[:-1], out=hap_off[1:])
    read_off = np.zeros(n, np.int64)
    np.cumsum(read_len[:-1], out=read_off[1:])
    hap_buf = np.concatenate([np.asarray(p[0], np.uint8) for p in pairs])
    read_buf = np.concatenate([np.asarray(p[1], np.uint8) for p in pairs])
    q_buf = np.concatenate([np.asarray(p[2], np.uint8) for p in pairs])
    iq_buf = np.concatenate([np.asarray(p[3], np.uint8) for p in pairs])
    dq_buf = np.concatenate([np.asarray(p[4], np.uint8) for p in pairs])
    gcp_buf = np.concatenate([np.asarray(p[5], np.uint8) for p in pairs])
    out = np.empty(n, np.float64)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    lib.pairhmm_forward_batch(
        ptr(hap_buf, ctypes.c_uint8), ptr(hap_off, ctypes.c_int64),
        ptr(hap_len, ctypes.c_int32), ptr(read_buf, ctypes.c_uint8),
        ptr(q_buf, ctypes.c_uint8), ptr(iq_buf, ctypes.c_uint8),
        ptr(dq_buf, ctypes.c_uint8), ptr(gcp_buf, ctypes.c_uint8),
        ptr(read_off, ctypes.c_int64), ptr(read_len, ctypes.c_int32),
        n, 1, n_threads, ptr(out, ctypes.c_double))
    return out
