"""ctypes wrapper for the native tandem-repeat-length kernel.

Backs the PCR error model's per-read STR scan
(calling/likelihoods.py::repeat_lengths_vector); exact scalar semantics of
the reference's find_tandem_repeat_units
(reference/src/pair_hmm/pair_hmm_likelihood_calculation_engine.rs:528-612).
"""
from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_failed = False


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        from lorikeet_tpu_torch.native import load
        lib = load("repeats", ["repeats.cpp"])
        lib.repeat_lengths.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.repeat_lengths.restype = None
        lib.repeat_lengths_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        lib.repeat_lengths_batch.restype = None
        _lib = lib
    except Exception:  # noqa: BLE001 — no toolchain: fall back to numpy
        _failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def repeat_lengths_native(bases: np.ndarray, max_unit: int,
                          max_repeat: int):
    """int64 repeat length per offset, or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    b = np.ascontiguousarray(bases, np.uint8)
    n = len(b)
    out = np.empty(n, np.int32)
    if n:
        lib.repeat_lengths(
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
            max_unit, max_repeat,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out.astype(np.int64)


def repeat_lengths_batch_native(concat: np.ndarray, offsets: np.ndarray,
                                max_unit: int, max_repeat: int):
    """Per-offset repeat lengths for n concatenated sequences (offsets has
    n+1 entries); one native crossing for the whole batch.  None when the
    toolchain is unavailable."""
    lib = _load()
    if lib is None:
        return None
    b = np.ascontiguousarray(concat, np.uint8)
    offs = np.ascontiguousarray(offsets, np.int64)
    out = np.empty(len(b), np.int32)
    if len(offs) > 1:
        lib.repeat_lengths_batch(
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(offs) - 1, max_unit, max_repeat,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
