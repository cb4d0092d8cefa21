"""Smith-Waterman affine-gap alignment returning (CIGAR, offset).

Semantics contract: reference/src/smith_waterman/smith_waterman_aligner.rs
(:47-113 entry + exact-match shortcut, :124-263 DP, :273-442 traceback and
overhang strategies).  Parameter sets :12-25.

Primary path is the native C++ aligner (lorikeet_tpu/native/sw.cpp) via
ctypes; a pure-Python implementation (same semantics, used as cross-check and
compiler-free fallback) lives in :func:`align_py`.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SWParameters:
    match_value: int
    mismatch_penalty: int
    gap_open_penalty: int
    gap_extend_penalty: int


# smith_waterman_aligner.rs:12-25
ORIGINAL_DEFAULT = SWParameters(3, -1, -4, -3)
STANDARD_NGS = SWParameters(25, -50, -110, -6)
NEW_SW_PARAMETERS = SWParameters(200, -150, -260, -11)
ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS = SWParameters(10, -15, -30, -5)


class OverhangStrategy:
    SOFTCLIP = 0
    INDEL = 1
    LEADING_INDEL = 2
    IGNORE = 3


MATRIX_MIN_CUTOFF = -100000000
_CIGAR_OPS = "MIDNSHP=X"

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        from lorikeet_tpu_torch import native
        lib = native.load("sw", ["sw.cpp"])
        lib.sw_align.restype = ctypes.c_int
        lib.sw_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


def _to_bytes(seq) -> bytes:
    if isinstance(seq, (bytes, bytearray)):
        return bytes(seq)
    return np.asarray(seq, np.uint8).tobytes()


def align(reference, alternate, parameters: SWParameters,
          overhang_strategy: int = OverhangStrategy.SOFTCLIP):
    """Returns (cigar, offset) with cigar as [(op_char, length)].

    Applies the reference's exact-substring shortcut for SOFTCLIP/IGNORE
    (smith_waterman_aligner.rs:70-80): a full match of alternate inside
    reference short-circuits to <len>M at the last occurrence.
    """
    ref_b = _to_bytes(reference)
    alt_b = _to_bytes(alternate)
    assert ref_b and alt_b, "non-empty sequences required"
    if overhang_strategy in (OverhangStrategy.SOFTCLIP, OverhangStrategy.IGNORE):
        idx = ref_b.rfind(alt_b)
        if idx >= 0:
            return [("M", len(alt_b))], idx

    lib = _get_lib()
    cap = len(ref_b) + len(alt_b) + 4
    cigar_buf = (ctypes.c_uint32 * cap)()
    cigar_len = ctypes.c_int32()
    offset = ctypes.c_int32()
    rc = lib.sw_align(
        ref_b, len(ref_b), alt_b, len(alt_b),
        parameters.match_value, parameters.mismatch_penalty,
        parameters.gap_open_penalty, parameters.gap_extend_penalty,
        overhang_strategy, cigar_buf, cap,
        ctypes.byref(cigar_len), ctypes.byref(offset))
    if rc != 0:
        raise RuntimeError(f"sw_align failed rc={rc}")
    cigar = [(_CIGAR_OPS[cigar_buf[k] & 0xF], cigar_buf[k] >> 4)
             for k in range(cigar_len.value)]
    return cigar, offset.value


def align_py(reference, alternate, parameters: SWParameters,
             overhang_strategy: int = OverhangStrategy.SOFTCLIP):
    """Pure-Python mirror of the native aligner (no shortcut): used to
    cross-check the C++ path and as fallback without a compiler."""
    ref = np.frombuffer(_to_bytes(reference), np.uint8)
    alt = np.frombuffer(_to_bytes(alternate), np.uint8)
    nrow, ncol = len(ref) + 1, len(alt) + 1
    sw = np.zeros((nrow, ncol), np.int64)
    bt = np.zeros((nrow, ncol), np.int64)
    low = -(2 ** 30)
    best_gap_v = np.full(ncol + 1, low, np.int64)
    gap_size_v = np.zeros(ncol + 1, np.int64)
    best_gap_h = np.full(nrow + 1, low, np.int64)
    gap_size_h = np.zeros(nrow + 1, np.int64)
    w_open, w_ext = parameters.gap_open_penalty, parameters.gap_extend_penalty
    w_match, w_mis = parameters.match_value, parameters.mismatch_penalty

    if overhang_strategy in (OverhangStrategy.INDEL, OverhangStrategy.LEADING_INDEL):
        sw[0, 1:] = w_open + np.arange(ncol - 1) * w_ext
        sw[1:, 0] = w_open + np.arange(nrow - 1) * w_ext

    for i in range(1, nrow):
        a = ref[i - 1]
        for j in range(1, ncol):
            step_diag = sw[i - 1, j - 1] + (w_match if a == alt[j - 1] else w_mis)
            prev_gap = sw[i - 1, j] + w_open
            best_gap_v[j] += w_ext
            if prev_gap > best_gap_v[j]:
                best_gap_v[j] = prev_gap
                gap_size_v[j] = 1
            else:
                gap_size_v[j] += 1
            step_down, kd = best_gap_v[j], gap_size_v[j]
            prev_gap = sw[i, j - 1] + w_open
            best_gap_h[i] += w_ext
            if prev_gap > best_gap_h[i]:
                best_gap_h[i] = prev_gap
                gap_size_h[i] = 1
            else:
                gap_size_h[i] += 1
            step_right, ki = best_gap_h[i], gap_size_h[i]
            if step_diag >= step_down and step_diag >= step_right:
                sw[i, j] = max(MATRIX_MIN_CUTOFF, step_diag)
                bt[i, j] = 0
            elif step_right >= step_down:
                sw[i, j] = max(MATRIX_MIN_CUTOFF, step_right)
                bt[i, j] = -ki
            else:
                sw[i, j] = max(MATRIX_MIN_CUTOFF, step_down)
                bt[i, j] = kd

    return _traceback_py(sw, bt, overhang_strategy, len(ref), len(alt))


def _traceback_py(sw, bt, strategy, ref_length, alt_length):
    p1 = p2 = 0
    segment_length = 0
    if strategy == OverhangStrategy.INDEL:
        p1, p2 = ref_length, alt_length
    else:
        max_score = -(2 ** 62)
        p2 = alt_length
        for i in range(1, ref_length + 1):
            if sw[i, alt_length] >= max_score:
                p1, max_score = i, sw[i, alt_length]
        if strategy != OverhangStrategy.LEADING_INDEL:
            for j in range(1, alt_length + 1):
                cur = sw[ref_length, j]
                if cur > max_score or (cur == max_score and
                                       abs(ref_length - j) < abs(p1 - p2)):
                    p1, p2, max_score = ref_length, j, cur
                    segment_length = alt_length - j
    lce = []
    if segment_length > 0 and strategy == OverhangStrategy.SOFTCLIP:
        lce.append(("S", segment_length))
        segment_length = 0
    state = "M"
    while True:
        btr = bt[p1, p2]
        if btr > 0:
            new_state, step = "D", btr
        elif btr < 0:
            new_state, step = "I", -btr
        else:
            new_state, step = "M", 1
        if new_state == "M":
            p1 -= 1
            p2 -= 1
        elif new_state == "I":
            p2 -= step
        else:
            p1 -= step
        if new_state == state:
            segment_length += step
        else:
            if segment_length > 0:
                lce.append((state, segment_length))
            segment_length, state = step, new_state
        if p1 <= 0 or p2 <= 0:
            break
    if strategy == OverhangStrategy.SOFTCLIP:
        lce.append((state, segment_length))
        if p2 > 0:
            lce.append(("S", p2))
        offset = p1
    elif strategy == OverhangStrategy.IGNORE:
        lce.append((state, segment_length + p2))
        offset = p1 - p2
    else:
        lce.append((state, segment_length))
        if p1 > 0:
            lce.append(("D", p1))
        elif p2 > 0:
            lce.append(("I", p2))
        offset = 0
    lce.reverse()
    return [(op, int(n)) for op, n in lce], int(offset)
