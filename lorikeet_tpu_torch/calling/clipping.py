"""Read clipping + region finalization (host-side read preparation).

Contracts:
- ReadClipper ops (reference/src/reads/read_clipper.rs): revert /
  hard-clip soft clips, hard-clip low-quality ends, adaptor clipping, clip
  to region.  Clipped-away bases are dropped outright (the reference keeps
  H ops in the CIGAR; nothing downstream of finalization reads them).
- finalize_regions (reference/src/assembly/assembly_based_caller_utils.rs:97-186):
  revert-or-drop soft clips, hard-clip tails below min-base-quality - 1
  (:304-310), adaptor-clip mapped reads, clip to the padded region span,
  drop empties.
- overlapping mate-pair base-quality correction
  (reference/src/utils/fragment_utils.rs:27-149): matching bases in
  the fragment overlap are capped at half the PCR SNV quality, conflicting
  bases are zeroed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from lorikeet_tpu_torch.io.bam import BamRecord, CIGAR_OPS, CONSUMES_QUERY, CONSUMES_REF

HALF_PCR_SNV_QUAL = 20  # phred(1e-4) = 40, halved (fragment_utils.rs:9-14)


def _replace(rec: BamRecord, **kw) -> BamRecord:
    # ~3x faster than dataclasses.replace at clipping-path volume (tens of
    # thousands of records per contig): plain attribute-dict copy
    new = BamRecord.__new__(BamRecord)
    d = new.__dict__
    d.update(rec.__dict__)
    # the memoized reference_end must NOT survive into the copy: pos/cigar
    # usually change here (dataclasses.replace dropped it implicitly)
    d.pop("_reference_end", None)
    d.update(kw)
    return new


def query_ref_positions(rec: BamRecord) -> np.ndarray:
    """Reference position per query base; -1 for insertions, soft clips get
    projected positions (soft start + offset)."""
    out = np.full(len(rec.seq), -1, np.int64)
    q = 0
    r = rec.pos
    for i, (op, n) in enumerate(rec.cigar):
        if op == "S":
            # project: leading S counts back from pos, trailing forward
            if q == 0:
                out[q:q + n] = np.arange(r - n, r)
            else:
                out[q:q + n] = np.arange(r, r + n)
            q += n
        elif op in "M=X":
            out[q:q + n] = np.arange(r, r + n)
            q += n
            r += n
        elif op == "I":
            q += n
        elif op in "DN":
            r += n
        # H/P consume nothing
    return out


def clip_by_read_indices(rec: BamRecord, keep_lo: int, keep_hi: int) -> BamRecord:
    """Hard-clip: keep query bases [keep_lo, keep_hi); returns a new record
    with adjusted pos/cigar/seq/qual (empty seq if nothing remains)."""
    keep_lo = max(0, keep_lo)
    keep_hi = min(len(rec.seq), keep_hi)
    if keep_lo >= keep_hi:
        return _replace(rec, cigar=[], seq=rec.seq[:0], qual=rec.qual[:0])
    new_cigar = []
    q = 0
    r = rec.pos
    new_pos = None
    for op, n in rec.cigar:
        cq = CONSUMES_QUERY[CIGAR_OPS.index(op)]
        cr = CONSUMES_REF[CIGAR_OPS.index(op)]
        if cq:
            lo = max(q, keep_lo)
            hi = min(q + n, keep_hi)
            if hi > lo:
                new_cigar.append((op, hi - lo))
                if cr and new_pos is None:
                    new_pos = r + (lo - q)
                elif op == "S" and new_pos is None:
                    pass  # pos comes from the first aligned op
            q += n
            if cr:
                r += n
        elif cr:  # D/N: keep only when interior to the kept query range
            if keep_lo < q < keep_hi:
                new_cigar.append((op, n))
            r += n
        # H/P dropped
    # trim leading/trailing ref-only ops
    while new_cigar and new_cigar[0][0] in "DN":
        if new_pos is not None:
            new_pos += new_cigar[0][1]
        new_cigar.pop(0)
    while new_cigar and new_cigar[-1][0] in "DN":
        new_cigar.pop()
    merged = []
    for op, n in new_cigar:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + n)
        else:
            merged.append((op, n))
    return _replace(rec, pos=new_pos if new_pos is not None else rec.pos,
                    cigar=merged, seq=rec.seq[keep_lo:keep_hi].copy(),
                    qual=rec.qual[keep_lo:keep_hi].copy())


def revert_soft_clips(rec: BamRecord) -> BamRecord:
    """S -> M, extending the alignment (read_clipper.rs
    revert_soft_clipped_bases); alignment start moves back by the leading
    clip length (clamped at 0)."""
    if not any(op == "S" for op, _ in rec.cigar):
        return rec
    lead = rec.cigar[0][1] if rec.cigar[0][0] == "S" else 0
    new_pos = max(0, rec.pos - lead)
    if rec.pos - lead < 0:
        # cannot extend past the contig start: hard clip the excess instead
        rec = clip_by_read_indices(rec, lead - rec.pos, len(rec.seq))
        lead = rec.cigar[0][1] if rec.cigar and rec.cigar[0][0] == "S" else 0
        new_pos = rec.pos - lead
    cigar = [("M", n) if op == "S" else (op, n) for op, n in rec.cigar]
    merged = []
    for op, n in cigar:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + n)
        else:
            merged.append((op, n))
    return _replace(rec, pos=new_pos, cigar=merged)


def hard_clip_soft_clips(rec: BamRecord) -> BamRecord:
    lead = rec.cigar[0][1] if rec.cigar and rec.cigar[0][0] == "S" else 0
    tail = rec.cigar[-1][1] if len(rec.cigar) > 1 and rec.cigar[-1][0] == "S" else 0
    if lead == 0 and tail == 0:
        return rec
    return clip_by_read_indices(rec, lead, len(rec.seq) - tail)


def _low_qual_end_bounds(quals, q_threshold: int):
    hi = len(quals)
    # overwhelmingly common case: both end bases already above threshold
    if hi and quals[0] > q_threshold and quals[hi - 1] > q_threshold:
        return 0, hi
    lo = 0
    while lo < hi and quals[lo] <= q_threshold:
        lo += 1
    while hi > lo and quals[hi - 1] <= q_threshold:
        hi -= 1
    return lo, hi


def hard_clip_low_qual_ends(rec: BamRecord, q_threshold: int) -> BamRecord:
    lo, hi = _low_qual_end_bounds(rec.qual, q_threshold)
    if lo == 0 and hi == len(rec.qual):
        return rec
    return clip_by_read_indices(rec, lo, hi)


def soft_clip_low_qual_ends(rec: BamRecord, q_threshold: int) -> BamRecord:
    """--soft-clip-low-quality-ends: mark low-quality tails as soft clips
    instead of dropping them (read_clipper.rs ClippingRepresentation::
    SOFTCLIP_BASES path of clip_low_qual_ends; finalize_regions arg at
    assembly_based_caller_utils.rs:111)."""
    lo, hi = _low_qual_end_bounds(rec.qual, q_threshold)
    if lo == 0 and hi == len(rec.qual):
        return rec
    if lo >= hi:
        return _replace(rec, cigar=[], seq=rec.seq[:0], qual=rec.qual[:0])
    refpos = query_ref_positions(rec)
    new_cigar = []
    if lo:
        new_cigar.append(("S", lo))
    q = 0
    new_pos = None
    for op, n in rec.cigar:
        ci = CIGAR_OPS.index(op)
        if CONSUMES_QUERY[ci]:
            klo, khi = max(q, lo), min(q + n, hi)
            if khi > klo:
                new_cigar.append((op, khi - klo))
                if CONSUMES_REF[ci] and new_pos is None:
                    new_pos = int(refpos[klo]) if refpos[klo] >= 0 else rec.pos
            q += n
        elif lo < q < hi:   # interior D/N
            new_cigar.append((op, n))
    if len(rec.qual) - hi:
        new_cigar.append(("S", len(rec.qual) - hi))
    merged = []
    for op, n in new_cigar:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + n)
        else:
            merged.append((op, n))
    return _replace(rec, pos=new_pos if new_pos is not None else rec.pos,
                    cigar=merged)


def adaptor_boundary(rec: BamRecord):
    """ReadUtils::get_adaptor_boundary: fragment-end for forward reads,
    mate-start - 1 for reverse reads; None when undefined."""
    if (not rec.is_paired or rec.is_mate_unmapped or rec.tlen == 0
            or rec.is_reverse == rec.is_mate_reverse):
        return None
    if rec.is_reverse:
        return rec.mate_pos - 1
    return rec.pos + abs(rec.tlen)


def hard_clip_adaptor_sequence(rec: BamRecord) -> BamRecord:
    boundary = adaptor_boundary(rec)
    if boundary is None:
        return rec
    if rec.is_reverse:
        if boundary < rec.pos:
            return rec  # adaptor before the read
        return hard_clip_to_region(rec, boundary + 1, np.iinfo(np.int64).max)
    if boundary > rec.reference_end - 1:
        return rec
    return hard_clip_to_region(rec, -1, boundary - 1)


def hard_clip_to_region(rec: BamRecord, start: int, end: int) -> BamRecord:
    """Keep query bases whose reference position is within [start, end]
    (read_clipper.rs hard_clip_to_region; end inclusive).

    Insertion bases anchor to the preceding aligned/projected base (GATK
    read-index-for-reference-coordinate semantics), so the kept range is
    contiguous and boundary insertions travel with their anchor."""
    cig = rec.cigar
    if len(cig) == 1 and cig[0][0] == "M":
        # pure-match fast path (the overwhelmingly common case): the kept
        # query range is a direct arithmetic window, no per-base arrays
        n = cig[0][1]
        lo = max(0, start - rec.pos)
        hi = min(n, end + 1 - rec.pos)
        if lo <= 0 and hi >= n:
            return rec
        if lo >= hi:
            return _replace(rec, cigar=[], seq=rec.seq[:0],
                            qual=rec.qual[:0])
        return _replace(rec, pos=rec.pos + lo, cigar=[("M", hi - lo)],
                        seq=rec.seq[lo:hi], qual=rec.qual[lo:hi])
    refpos = query_ref_positions(rec)
    # forward-fill insertion positions from their left anchor; insertions
    # before any anchored base anchor just before the alignment start
    anchored = np.where(refpos >= 0, refpos, np.iinfo(np.int64).min)
    eff = np.maximum.accumulate(
        np.concatenate(([rec.pos - 1], anchored)))[1:]
    keep = (eff >= start) & (eff <= end)
    if keep.all():
        return rec
    idx = np.flatnonzero(keep)
    if idx.size == 0:
        return _replace(rec, cigar=[], seq=rec.seq[:0], qual=rec.qual[:0])
    return clip_by_read_indices(rec, int(idx[0]), int(idx[-1]) + 1)


def _has_well_defined_fragment_size(rec: BamRecord) -> bool:
    """read_utils.rs has_well_defined_fragment_size."""
    if rec.tlen == 0 or not rec.is_paired or rec.is_unmapped or rec.is_mate_unmapped:
        return False
    if rec.is_reverse == rec.is_mate_reverse:
        return False
    if rec.is_reverse:
        return rec.reference_end > rec.mate_pos
    return rec.pos <= rec.mate_pos + rec.tlen


def adjust_overlapping_pair_quals(reads: list) -> None:
    """In-place qual adjustment for overlapping mate pairs of one sample
    (fragment_utils.rs:27-149).  Matching overlap bases are capped at
    HALF_PCR_SNV_QUAL; mismatching bases are zeroed.

    Invariant: the vectorized overlap intersection requires each read's
    non-negative query_ref_positions to be strictly increasing and unique
    (intersect1d(assume_unique=True) + searchsorted below).  This holds for
    every SAM-valid cigar (S only at the ends, aligned ops advance the
    reference monotonically); a malformed interior-S record would violate
    it and make the intersection undefined."""
    by_name = {}
    for r in reads:
        if r.is_paired:
            by_name.setdefault(r.name, []).append(r)
    for name, pair in by_name.items():
        if len(pair) != 2:
            continue
        first, second = sorted(pair, key=lambda r: r.pos)
        if first.reference_end <= second.pos:
            continue
        rp1 = query_ref_positions(first)
        rp2 = query_ref_positions(second)
        # aligned ref positions are strictly increasing (insertions are -1),
        # so the overlap intersection + per-base compare vectorize directly
        i1 = np.flatnonzero(rp1 >= 0)
        i2 = np.flatnonzero(rp2 >= 0)
        common = np.intersect1d(rp1[i1], rp2[i2], assume_unique=True)
        if common.size == 0:
            continue
        i = i1[np.searchsorted(rp1[i1], common)]
        j = i2[np.searchsorted(rp2[i2], common)]
        s1 = np.asarray(first.seq)
        s2 = np.asarray(second.seq)
        eq = s1[i] == s2[j]
        im, jm = i[eq], j[eq]
        first.qual[im] = np.minimum(first.qual[im], HALF_PCR_SNV_QUAL)
        second.qual[jm] = np.minimum(second.qual[jm], HALF_PCR_SNV_QUAL)
        first.qual[i[~eq]] = 0
        second.qual[j[~eq]] = 0


def finalize_region_reads_columnar(bam, tid: int, sel, sample_index: int,
                                   padded_start: int, padded_end: int,
                                   min_base_quality: int = 10,
                                   dont_use_soft_clipped_bases: bool = False,
                                   soft_clip_low_quality_ends: bool = False,
                                   correct_overlapping_quals: bool = True):
    """Native columnar finalize: records_at + finalize_region_reads fused
    into one C++ call over the BAM's columnar buffers — each kept read is
    materialized ONCE, already clipped, with its overlap-adjusted quals.
    Returns the finalized [BamRecord] (pos-sorted) or None when the native
    path is unavailable (caller falls back to the per-record chain)."""
    from lorikeet_tpu_torch.native.finalize_native import finalize_region_native
    c = bam.columnar(tid)
    ext = bam.columnar_ext(tid) if c is not None else None
    if ext is None:
        return None
    out = finalize_region_native(
        c, ext, sel, padded_start, padded_end,
        max(min_base_quality - 1, 0), dont_use_soft_clipped_bases,
        soft_clip_low_quality_ends, correct_overlapping_quals)
    if out is None:
        return None
    n = out["n"]
    if n == 0:
        return []
    sel = out["sel"]
    src = sel[out["idx"]]                     # window sorted-order indices
    seq_buf, qual_out = c["seq"], out["qual"]
    # one vectorized gather + tolist per column (records_at pattern)
    ro = c["read_off"][src]
    seq_lo = (ro + out["klo"]).tolist()
    seq_hi = (ro + out["khi"]).tolist()
    pos_l = out["pos"].tolist()
    rend_l = (out["pos"] + out["reflen"]).tolist()
    names = ext["names"]
    no_l = ext["name_off"][src].tolist()
    nl_l = ext["name_len"][src].tolist()
    flag_l = ext["flag"][src].tolist()
    mapq_l = ext["mapq"][src].tolist()
    mtid_l = ext["mate_tid"][src].tolist()
    mpos_l = ext["mate_pos"][src].tolist()
    tlen_l = ext["tlen"][src].tolist()
    intr_l = ext["intrinsic"][src].tolist()
    to_l = ext["tag_off"][src].tolist()
    te_l = ext["tag_end"][src].tolist()
    tags_buf = ext["tags"]
    cig_cnt = out["cigar_cnt"].tolist()
    cig_bounds = np.zeros(n + 1, np.int64)
    np.cumsum(out["cigar_cnt"], out=cig_bounds[1:])
    cig_bounds = cig_bounds.tolist()
    ops_chars = out["cigar_ops"].tobytes().decode("ascii")
    lens_l = out["cigar_lens"].tolist()
    q_bounds = np.zeros(n + 1, np.int64)
    np.cumsum(out["khi"].astype(np.int64) - out["klo"], out=q_bounds[1:])
    q_bounds = q_bounds.tolist()

    from lorikeet_tpu_torch.io.bam import _LazyTags
    new = BamRecord.__new__
    recs = []
    for t in range(n):
        rec = new(BamRecord)
        d = rec.__dict__
        d["name"] = names[no_l[t]:no_l[t] + nl_l[t]].decode()
        d["flag"] = flag_l[t]
        d["tid"] = tid
        d["pos"] = pos_l[t]
        d["mapq"] = mapq_l[t]
        c0, c1 = cig_bounds[t], cig_bounds[t + 1]
        d["cigar"] = list(zip(ops_chars[c0:c1], lens_l[c0:c1]))
        d["seq"] = seq_buf[seq_lo[t]:seq_hi[t]]
        d["qual"] = qual_out[q_bounds[t]:q_bounds[t + 1]]
        d["mate_tid"] = mtid_l[t]
        d["mate_pos"] = mpos_l[t]
        d["tlen"] = tlen_l[t]
        d["tags"] = _LazyTags(tags_buf, to_l[t], te_l[t])
        d["sample_index"] = sample_index
        d["intrinsic"] = intr_l[t]
        d["_reference_end"] = rend_l[t]
        recs.append(rec)
    return recs


def finalize_region_reads(reads_by_sample: dict, padded_start: int,
                          padded_end: int, min_base_quality: int = 10,
                          dont_use_soft_clipped_bases: bool = False,
                          soft_clip_low_quality_ends: bool = False,
                          correct_overlapping_quals: bool = True) -> dict:
    """finalize_regions pipeline over {sample: [BamRecord]}; returns the
    finalized mapping (records are clipped copies, input order by position)."""
    min_tail_quality = max(min_base_quality - 1, 0)
    out = {}
    for s, reads in reads_by_sample.items():
        kept = []
        for rec in reads:
            if dont_use_soft_clipped_bases or not _has_well_defined_fragment_size(rec):
                r = hard_clip_soft_clips(rec)
            else:
                r = revert_soft_clips(rec)
            if soft_clip_low_quality_ends:
                r = soft_clip_low_qual_ends(r, min_tail_quality)
            else:
                r = hard_clip_low_qual_ends(r, min_tail_quality)
            if not len(r.seq):
                continue
            r = hard_clip_adaptor_sequence(r)
            if not len(r.seq) or not r.cigar:
                continue
            r = hard_clip_to_region(r, padded_start, padded_end)
            if len(r.seq) and r.cigar and r.pos <= padded_end \
                    and r.reference_end > padded_start:
                # the overlap correction below mutates quals in place, so
                # every kept record must OWN its qual array: clean reads
                # pass through the clippers untouched, and clipped records
                # carry qual VIEWS into the caller's (region-shared) buffer
                # — either way the original would get corrupted (the
                # reference regression at
                # assembly_based_caller_utils_unit_tests.rs:36-37)
                if r is rec:
                    r = _replace(rec, qual=rec.qual.copy())
                elif r.qual is rec.qual or r.qual.base is not None:
                    # copies can still SHARE the original's owned array
                    # (no-op clippers keep the attribute), or carry views
                    r.qual = r.qual.copy()
                kept.append(r)
        kept.sort(key=lambda r: r.pos)
        if correct_overlapping_quals:
            adjust_overlapping_pair_quals(kept)
        out[s] = kept
    return out
