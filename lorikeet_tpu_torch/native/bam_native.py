"""ctypes wrapper over the C++ BAM decoder (bam_decode.cpp): BGZF inflate +
columnar record parse.  Raises on any native failure; callers fall back to
the pure-Python decoder."""
from __future__ import annotations

import ctypes

import numpy as np

from lorikeet_tpu_torch.native import load


class _BamColumns(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("tid", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int32)),
        ("mapq", ctypes.POINTER(ctypes.c_int32)),
        ("flag", ctypes.POINTER(ctypes.c_int32)),
        ("mate_tid", ctypes.POINTER(ctypes.c_int32)),
        ("mate_pos", ctypes.POINTER(ctypes.c_int32)),
        ("tlen", ctypes.POINTER(ctypes.c_int32)),
        ("ref_len", ctypes.POINTER(ctypes.c_int32)),
        ("intrinsic", ctypes.POINTER(ctypes.c_int32)),
        ("name_off", ctypes.POINTER(ctypes.c_int64)),
        ("cigar_off", ctypes.POINTER(ctypes.c_int64)),
        ("seq_off", ctypes.POINTER(ctypes.c_int64)),
        ("tag_off", ctypes.POINTER(ctypes.c_int64)),
        ("names", ctypes.c_char_p),
        ("cigars", ctypes.POINTER(ctypes.c_uint32)),
        ("seq", ctypes.POINTER(ctypes.c_uint8)),
        ("qual", ctypes.POINTER(ctypes.c_uint8)),
        ("tags", ctypes.POINTER(ctypes.c_uint8)),
    ]


def _lib():
    lib = load("bamdecode", ["bam_decode.cpp"], link=["-lz"])
    lib.bgzf_inflate.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.bgzf_inflate.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int64)]
    lib.bam_buffer_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.bam_parse.restype = ctypes.POINTER(_BamColumns)
    lib.bam_parse.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                              ctypes.c_int64]
    lib.bam_columns_free.argtypes = [ctypes.POINTER(_BamColumns)]
    return lib


def inflate(path: str) -> np.ndarray:
    """Whole-file BGZF decompression -> uint8 array."""
    lib = _lib()
    n = ctypes.c_int64(0)
    buf = lib.bgzf_inflate(path.encode(), ctypes.byref(n))
    if not buf:
        raise IOError(f"bgzf_inflate failed for {path}")
    try:
        out = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    finally:
        lib.bam_buffer_free(buf)
    return out


def parse(buf: np.ndarray, rec_off: int) -> dict:
    """Columnar record arrays from an uncompressed BAM stream."""
    lib = _lib()
    ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    cols = lib.bam_parse(ptr, len(buf), rec_off)
    if not cols:
        raise ValueError("bam_parse failed (malformed records)")
    c = cols.contents
    n = c.n

    def arr(p, count, dtype):
        if count == 0:
            return np.zeros(0, dtype)
        return np.ctypeslib.as_array(p, shape=(count,)).astype(dtype, copy=True)

    try:
        name_off = arr(c.name_off, n + 1, np.int64)
        cigar_off = arr(c.cigar_off, n + 1, np.int64)
        seq_off = arr(c.seq_off, n + 1, np.int64)
        tag_off = arr(c.tag_off, n + 1, np.int64)
        out = {
            "tid": arr(c.tid, n, np.int32),
            "pos": arr(c.pos, n, np.int32),
            "mapq": arr(c.mapq, n, np.int32),
            "flag": arr(c.flag, n, np.int32),
            "mate_tid": arr(c.mate_tid, n, np.int32),
            "mate_pos": arr(c.mate_pos, n, np.int32),
            "tlen": arr(c.tlen, n, np.int32),
            "ref_len": arr(c.ref_len, n, np.int32),
            "intrinsic": arr(c.intrinsic, n, np.int32),
            "name_off": name_off,
            "cigar_off": cigar_off,
            "seq_off": seq_off,
            "tag_off": tag_off,
            "names": ctypes.string_at(c.names, int(name_off[-1])) if n else b"",
            "cigars": arr(c.cigars, int(cigar_off[-1]), np.uint32),
            "seq": arr(c.seq, int(seq_off[-1]), np.uint8),
            "qual": arr(c.qual, int(seq_off[-1]), np.uint8),
            "tags": arr(c.tags, int(tag_off[-1]), np.uint8),
        }
    finally:
        lib.bam_columns_free(cols)
    return out
