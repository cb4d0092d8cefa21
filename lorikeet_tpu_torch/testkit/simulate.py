"""Read simulation with known ground-truth variants.

Plays the role of the reference's synthetic-read utilities
(reference/src/utils/artificial_read_utils.rs:96,
src/test_utils/random_dna.rs) and replaces its LFS-hosted BAM fixtures (which
are unavailable): reads are sampled from haplotypes built by applying known
variants to a real reference sequence, so end-to-end calling can be validated
against injected truth.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lorikeet_tpu_torch.io.bam import BamRecord, FLAG_PAIRED, FLAG_PROPER_PAIR, \
    FLAG_REVERSE, FLAG_MATE_REVERSE, FLAG_READ1, FLAG_READ2

BASES = np.frombuffer(b"ACGT", np.uint8)


def repeat_rich_reference(length: int, seed: int = 0,
                          feature_gap: tuple = (120, 320)) -> np.ndarray:
    """Synthetic reference with planted homopolymers (8-20 bp), STRs
    (unit 2-6 bp x 4-12 copies) and low-entropy (2-letter) segments at
    realistic densities.

    Plays the role of the reference's real human-window fixtures
    (reference/tests/read_threading_assembler_unit_tests.rs:45-225
    over Homo_sapiens_assembly19_chr1_1M.fasta, a git-lfs pointer here):
    uniform-random DNA has none of the structures that stress dangling-end
    recovery and kmer-size retry
    (read_threading_assembler.rs:419-450), so assembler tests run over
    these windows too.  Deterministic in (length, seed).  The planted
    feature spans are recorded on the array as ``.features`` via a
    companion return: use ``repeat_rich_reference_with_features`` when the
    test needs to aim a variant at a repeat."""
    ref, _ = repeat_rich_reference_with_features(length, seed, feature_gap)
    return ref


def repeat_rich_reference_with_features(length: int, seed: int = 0,
                                        feature_gap: tuple = (120, 320)):
    """(ref, features): features is [(kind, start, end)] with kind in
    {"hp", "str", "low"} covering each planted repeat span."""
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, length)]
    features = []
    pos = int(rng.integers(*feature_gap))
    while pos < length - 90:
        kind = ["hp", "str", "low"][int(rng.integers(0, 3))]
        if kind == "hp":
            run = int(rng.integers(8, 21))
            ref[pos:pos + run] = BASES[int(rng.integers(0, 4))]
            end = pos + run
        elif kind == "str":
            unit_len = int(rng.integers(2, 7))
            copies = int(rng.integers(4, 13))
            unit = BASES[rng.integers(0, 4, unit_len)]
            run = min(unit_len * copies, length - pos)
            ref[pos:pos + run] = np.tile(unit, copies)[:run]
            end = pos + run
        else:
            seg = min(int(rng.integers(30, 61)), length - pos)
            two = BASES[rng.choice(4, 2, replace=False)]
            ref[pos:pos + seg] = two[rng.integers(0, 2, seg)]
            end = pos + seg
        features.append((kind, pos, end))
        pos = end + int(rng.integers(*feature_gap))
    return ref, features


@dataclass(frozen=True)
class Variant:
    """pos is 0-based on the reference; ref/alt are byte strings.

    SNP:      ref=b"A"  alt=b"G"
    deletion: ref=b"ACG" alt=b"A"   (anchored, VCF style)
    insertion: ref=b"A"  alt=b"ACG"
    """
    pos: int
    ref: bytes
    alt: bytes


def apply_variants(ref: np.ndarray, variants) -> tuple:
    """Apply variants to a reference; returns (hap, segments).

    ``segments`` is a list of (kind, ref_start, hap_start, length) with kind
    in {"M", "I", "D"} describing the hap<->ref alignment, used to derive
    read CIGARs.
    """
    variants = sorted(variants, key=lambda v: v.pos)
    out = []
    segments = []
    rpos = 0
    hpos = 0
    for v in variants:
        if v.pos < rpos:
            raise ValueError("overlapping variants")
        # matched stretch before the variant (+1 matched anchor base)
        pre = v.pos - rpos
        assert bytes(ref[v.pos:v.pos + len(v.ref)].tobytes()) == v.ref, \
            f"variant ref mismatch at {v.pos}"
        if len(v.ref) == len(v.alt) == 1:
            # SNP: matched stretch, then a 1-base "M" with substituted base
            out.append(ref[rpos:v.pos])
            out.append(np.frombuffer(v.alt, np.uint8))
            segments.append(("M", rpos, hpos, pre + 1))
            rpos = v.pos + 1
            hpos += pre + 1
        elif len(v.ref) > len(v.alt):
            # deletion (alt is the anchor base)
            out.append(ref[rpos:v.pos + 1])
            segments.append(("M", rpos, hpos, pre + 1))
            hpos += pre + 1
            dlen = len(v.ref) - len(v.alt)
            segments.append(("D", v.pos + 1, hpos, dlen))
            rpos = v.pos + 1 + dlen
        else:
            # insertion after the anchor base
            out.append(ref[rpos:v.pos + 1])
            segments.append(("M", rpos, hpos, pre + 1))
            hpos += pre + 1
            ins = np.frombuffer(v.alt[1:], np.uint8)
            out.append(ins)
            segments.append(("I", v.pos + 1, hpos, len(ins)))
            hpos += len(ins)
            rpos = v.pos + 1
    out.append(ref[rpos:])
    segments.append(("M", rpos, hpos, len(ref) - rpos))
    hap = np.concatenate(out) if out else ref.copy()
    return hap, [s for s in segments if s[3] > 0]


def _cigar_for_read(segments, hstart: int, hend: int, seg_ends=None):
    """CIGAR + reference start for hap interval [hstart, hend).

    ``seg_ends`` (per-segment hap end, 0-length for D) lets the caller
    bisect to the first candidate segment — a linear scan is O(#variants)
    PER READ and made 10 Mbp simulations quadratic."""
    cigar = []
    ref_start = None
    if seg_ends is not None:
        import bisect
        i0 = bisect.bisect_right(seg_ends, hstart)
        segments = segments[i0:]
    for kind, rs, hs, ln in segments:
        if hs >= hend:
            break
        if kind == "D":
            # deletion sits between hap positions hs-1 and hs; include it only
            # when the read covers bases on both sides
            if ref_start is not None and hstart < hs < hend:
                cigar.append(("D", ln))
            continue
        he = hs + ln
        lo = max(hstart, hs)
        hi = min(hend, he)
        if lo >= hi:
            continue
        if kind == "M":
            if ref_start is None:
                ref_start = rs + (lo - hs)
            cigar.append(("M", hi - lo))
        else:  # insertion
            cigar.append(("I", hi - lo))
    # merge adjacent same ops
    merged = []
    for op, n in cigar:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + n)
        else:
            merged.append((op, n))
    # leading/trailing I or D are not representable — convert I to S, drop D
    while merged and merged[0][0] == "D":
        merged.pop(0)
    while merged and merged[-1][0] == "D":
        merged.pop()
    if merged and merged[0][0] == "I":
        merged[0] = ("S", merged[0][1])
    if merged and merged[-1][0] == "I":
        merged[-1] = ("S", merged[-1][1])
    return merged, ref_start


def simulate_reads(
    ref: np.ndarray,
    variants=(),
    coverage: float = 30.0,
    read_length: int = 100,
    fragment_mean: int = 300,
    fragment_sd: int = 30,
    error_rate: float = 0.001,
    base_qual: int = 30,
    seed: int = 0,
    sample: str = "sample0",
    tid: int = 0,
    allele_fraction: float = 1.0,
    name_prefix: str = "read",
):
    """Simulate coordinate-sorted paired-end reads.

    A fraction ``allele_fraction`` of fragments come from the variant
    haplotype, the rest from the unmodified reference (strain mixtures).
    Returns a list of BamRecord.
    """
    rng = np.random.default_rng(seed)
    hap, segments = apply_variants(ref, variants)
    # per-segment hap-space end (D pins to its point), for the bisect in
    # _cigar_for_read; segments are emitted in increasing hap order
    seg_ends = [hs + (ln if kind != "D" else 0)
                for kind, rs, hs, ln in segments]
    ref_segments = [("M", 0, 0, len(ref))]
    ref_seg_ends = [len(ref)]
    n_frags = int(coverage * len(ref) / (2 * read_length))
    recs = []
    for k in range(n_frags):
        from_hap = rng.random() < allele_fraction
        src = hap if from_hap else ref
        segs = segments if from_hap else ref_segments
        ends = seg_ends if from_hap else ref_seg_ends
        flen = max(2 * read_length, int(rng.normal(fragment_mean, fragment_sd)))
        fstart = int(rng.integers(0, max(1, len(src) - flen + 1)))
        r1 = (fstart, fstart + read_length)
        r2 = (fstart + flen - read_length, fstart + flen)
        pair = []
        for idx, (s, e) in enumerate((r1, r2)):
            e = min(e, len(src))
            s = max(0, min(s, e - 1))
            bases = src[s:e].copy()
            # sequencing errors
            nerr = rng.binomial(len(bases), error_rate)
            for _ in range(nerr):
                p = rng.integers(0, len(bases))
                bases[p] = BASES[rng.integers(0, 4)]
            quals = np.full(len(bases), base_qual, np.uint8)
            cigar, ref_start = _cigar_for_read(segs, s, e, ends)
            if ref_start is None:
                pair = []
                break
            pair.append((ref_start, cigar, bases, quals, idx))
        if len(pair) != 2:
            continue
        name = f"{name_prefix}{k}"
        p0, p1 = pair
        tlen = (p1[0] + sum(n for op, n in p1[1] if op in "MD")) - p0[0]
        for (ref_start, cigar, bases, quals, idx) in pair:
            flag = FLAG_PAIRED | FLAG_PROPER_PAIR
            flag |= FLAG_READ1 if idx == 0 else FLAG_READ2
            flag |= FLAG_REVERSE if idx == 1 else FLAG_MATE_REVERSE
            mate = pair[1 - idx]
            recs.append(BamRecord(
                name=name, flag=flag, tid=tid, pos=ref_start, mapq=60,
                cigar=cigar, seq=bases, qual=quals,
                mate_tid=tid, mate_pos=mate[0],
                tlen=tlen if idx == 0 else -tlen,
                tags={"RG": sample},
            ))
    recs.sort(key=lambda r: (r.tid, r.pos))
    return recs
