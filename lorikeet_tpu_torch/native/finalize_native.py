"""ctypes wrapper for the native columnar region finalizer (finalize.cpp).

Conformance spec: calling/clipping.py::finalize_region_reads — the Python
chain (revert/hard-clip soft clips, low-qual tails, adaptor, clip-to-region,
overlap qual correction) applied per read; fuzz-tested for identity.
Reference contract: assembly_based_caller_utils.rs:97-186 finalize_regions +
fragment_utils.rs:27-149.
"""
from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_failed = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        from lorikeet_tpu_torch.native import load
        lib = load("finalize", ["finalize.cpp"])
        lib.finalize_region.argtypes = [
            _u8p, _u8p, _u8p, _i32p, _u8p,
            _i64p, _i32p, _i64p, _i32p, _i64p, _i64p, _i32p, _i64p, _i64p,
            _i64p, _i32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32p, _i64p, _i32p, _i32p, _i32p,
            _u8p, _i32p, _i32p, _u8p,
            ctypes.c_int64, ctypes.c_int64, _i64p]
        lib.finalize_region.restype = ctypes.c_int
        _lib = lib
    except Exception:  # noqa: BLE001 — no toolchain: fall back to Python
        _failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def _p(a, tp):
    return a.ctypes.data_as(tp)


def finalize_region_native(c: dict, ext: dict, sel: np.ndarray,
                           padded_start: int, padded_end: int,
                           min_tail_quality: int,
                           dont_use_soft_clipped: bool,
                           soft_clip_low_qual: bool,
                           correct_overlap: bool):
    """Run the native finalizer over the selected (window-sorted-order)
    reads of one sample.  ``c`` / ``ext`` are BamReader.columnar /
    columnar_ext dicts.  Returns the raw output dict (kept order = pos
    sorted) or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    sel = np.ascontiguousarray(sel, np.int64)
    n = len(sel)
    read_off = np.ascontiguousarray(c["read_off"][sel])
    read_len = np.ascontiguousarray(c["read_len"][sel])
    cigar_off = np.ascontiguousarray(c["cigar_off"][sel])
    cigar_cnt = np.ascontiguousarray(c["cigar_cnt"][sel])
    pos = np.ascontiguousarray(c["pos"][sel])
    ends = np.ascontiguousarray(c["ends"][sel])
    flag = np.ascontiguousarray(ext["flag"][sel])
    mate_pos = np.ascontiguousarray(ext["mate_pos"][sel])
    tlen = np.ascontiguousarray(ext["tlen"][sel])
    name_off = np.ascontiguousarray(ext["name_off"][sel])
    name_len = np.ascontiguousarray(ext["name_len"][sel])

    cap_cigar = int(cigar_cnt.sum()) + 2 * n + 2
    cap_qual = int(read_len.sum()) + 1
    out_idx = np.empty(n + 1, np.int32)
    out_pos = np.empty(n + 1, np.int64)
    out_klo = np.empty(n + 1, np.int32)
    out_khi = np.empty(n + 1, np.int32)
    out_reflen = np.empty(n + 1, np.int32)
    out_cigar_ops = np.empty(cap_cigar, np.uint8)
    out_cigar_lens = np.empty(cap_cigar, np.int32)
    out_cigar_cnt = np.empty(n + 1, np.int32)
    out_qual = np.empty(cap_qual, np.uint8)
    out_counts = np.zeros(3, np.int64)

    names = ext["names"]
    names_arr = np.frombuffer(names, np.uint8) if len(names) \
        else np.zeros(1, np.uint8)
    rc = lib.finalize_region(
        _p(c["seq"], _u8p), _p(c["qual"], _u8p), _p(c["ops"], _u8p),
        _p(c["lens"], _i32p), _p(names_arr, _u8p),
        _p(read_off, _i64p), _p(read_len, _i32p), _p(cigar_off, _i64p),
        _p(cigar_cnt, _i32p), _p(pos, _i64p), _p(ends, _i64p),
        _p(flag, _i32p), _p(mate_pos, _i64p), _p(tlen, _i64p),
        _p(name_off, _i64p), _p(name_len, _i32p),
        n, padded_start, padded_end, min_tail_quality,
        1 if dont_use_soft_clipped else 0, 1 if soft_clip_low_qual else 0,
        1 if correct_overlap else 0,
        _p(out_idx, _i32p), _p(out_pos, _i64p), _p(out_klo, _i32p),
        _p(out_khi, _i32p), _p(out_reflen, _i32p),
        _p(out_cigar_ops, _u8p), _p(out_cigar_lens, _i32p),
        _p(out_cigar_cnt, _i32p), _p(out_qual, _u8p),
        cap_cigar, cap_qual, _p(out_counts, _i64p))
    if rc != 0:
        return None
    nk, tc, tq = (int(x) for x in out_counts)
    return dict(n=nk, idx=out_idx[:nk], pos=out_pos[:nk], klo=out_klo[:nk],
                khi=out_khi[:nk], reflen=out_reflen[:nk],
                cigar_ops=out_cigar_ops[:tc], cigar_lens=out_cigar_lens[:tc],
                cigar_cnt=out_cigar_cnt[:nk], qual=out_qual[:tq],
                sel=sel)
