"""ctypes wrapper for the native ref-vs-any pileup accumulator.

Conformance spec: models/activity.py::accumulate_read (parse_record walk,
haplotype_caller_engine.rs:754-899).  Packs a chunk's reads into flat
buffers and scatters GL/depth/HQ-soft-clip updates in one call.
"""
from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_failed = False

_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        from lorikeet_tpu_torch.native import load
        lib = load("pileup", ["pileup.cpp"])
        lib.pileup_accumulate.argtypes = [
            _u8p, _u8p, _i64p, _i32p,          # seq, qual, read_off, read_len
            _u8p, _i32p, _i64p, _i32p,         # cigar ops/lens/off/cnt
            _i64p, ctypes.c_int64,             # pos, n_reads
            _u8p, ctypes.c_int64, ctypes.c_int64,  # ref, chunk bounds
            ctypes.c_int, _f64p, ctypes.c_int,     # bq, table, n_gl
            _f64p, _i32p, _i32p, _i32p, _f64p, _i32p]  # outputs
        lib.pileup_accumulate.restype = None
        _lib = lib
    except Exception:  # noqa: BLE001 — no toolchain: fall back to numpy
        _failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


_OP_CODE = {op: ord(op) for op in "MIDNSHP=X"}


def accumulate_reads_columnar(profile, cols, idx, ref_seq: np.ndarray,
                              chunk_start: int, chunk_end: int, bq: int,
                              table: np.ndarray) -> bool:
    """Zero-object pileup: scatter reads straight from the BAM decoder's
    column buffers (BamReader.columnar) for the sorted-order indices
    `idx`, without materializing BamRecords."""
    lib = _load()
    if lib is None:
        return False
    idx = np.asarray(idx, np.int64)
    n = len(idx)
    if n == 0:
        return True
    read_off = np.ascontiguousarray(cols["read_off"][idx])
    read_len = np.ascontiguousarray(cols["read_len"][idx])
    cigar_off = np.ascontiguousarray(cols["cigar_off"][idx])
    cigar_cnt = np.ascontiguousarray(cols["cigar_cnt"][idx])
    pos = np.ascontiguousarray(cols["pos"][idx].astype(np.int64))
    ref = np.ascontiguousarray(ref_seq, np.uint8)
    table = np.ascontiguousarray(table, np.float64)
    n_gl = table.shape[2]
    lib.pileup_accumulate(
        cols["seq"].ctypes.data_as(_u8p), cols["qual"].ctypes.data_as(_u8p),
        read_off.ctypes.data_as(_i64p), read_len.ctypes.data_as(_i32p),
        cols["ops"].ctypes.data_as(_u8p), cols["lens"].ctypes.data_as(_i32p),
        cigar_off.ctypes.data_as(_i64p), cigar_cnt.ctypes.data_as(_i32p),
        pos.ctypes.data_as(_i64p), n,
        ref.ctypes.data_as(_u8p), chunk_start, chunk_end,
        bq, table.ctypes.data_as(_f64p), n_gl,
        profile.gl.ctypes.data_as(_f64p),
        profile.read_counts.ctypes.data_as(_i32p),
        profile.ref_depth.ctypes.data_as(_i32p),
        profile.nonref_depth.ctypes.data_as(_i32p),
        profile.hq_sc_sum.ctypes.data_as(_f64p),
        profile.hq_sc_n.ctypes.data_as(_i32p))
    return True


def accumulate_reads_native(profile, recs, ref_seq: np.ndarray,
                            chunk_start: int, chunk_end: int, bq: int,
                            table: np.ndarray) -> bool:
    """Scatter all reads' pileup contributions into `profile` in one native
    call; returns False when the native kernel is unavailable."""
    lib = _load()
    if lib is None:
        return False
    recs = list(recs)
    n = len(recs)
    if n == 0:
        return True
    read_len = np.fromiter((len(r.seq) for r in recs), np.int32, n)
    read_off = np.zeros(n, np.int64)
    np.cumsum(read_len[:-1], out=read_off[1:])
    seq_buf = np.concatenate([np.ascontiguousarray(r.seq, np.uint8)
                              for r in recs]) if n else np.zeros(0, np.uint8)
    qual_buf = np.concatenate([np.ascontiguousarray(r.qual, np.uint8)
                               for r in recs])
    cigar_cnt = np.fromiter((len(r.cigar) for r in recs), np.int32, n)
    cigar_off = np.zeros(n, np.int64)
    np.cumsum(cigar_cnt[:-1], out=cigar_off[1:])
    total_ops = int(cigar_cnt.sum())
    ops = np.empty(total_ops, np.uint8)
    lens = np.empty(total_ops, np.int32)
    k = 0
    code = _OP_CODE
    for r in recs:
        for op, ln in r.cigar:
            ops[k] = code[op]
            lens[k] = ln
            k += 1
    pos = np.fromiter((r.pos for r in recs), np.int64, n)
    ref = np.ascontiguousarray(ref_seq, np.uint8)
    table = np.ascontiguousarray(table, np.float64)
    n_gl = table.shape[2]

    lib.pileup_accumulate(
        seq_buf.ctypes.data_as(_u8p), qual_buf.ctypes.data_as(_u8p),
        read_off.ctypes.data_as(_i64p), read_len.ctypes.data_as(_i32p),
        ops.ctypes.data_as(_u8p), lens.ctypes.data_as(_i32p),
        cigar_off.ctypes.data_as(_i64p), cigar_cnt.ctypes.data_as(_i32p),
        pos.ctypes.data_as(_i64p), n,
        ref.ctypes.data_as(_u8p), chunk_start, chunk_end,
        bq, table.ctypes.data_as(_f64p), n_gl,
        profile.gl.ctypes.data_as(_f64p),
        profile.read_counts.ctypes.data_as(_i32p),
        profile.ref_depth.ctypes.data_as(_i32p),
        profile.nonref_depth.ctypes.data_as(_i32p),
        profile.hq_sc_sum.ctypes.data_as(_f64p),
        profile.hq_sc_n.ctypes.data_as(_i32p))
    return True
