"""Alignment thresholding filters.

Contract: reference/src/bam_parsing/filter.rs — single reads pass when
aligned bases (M/I/D/=/X) >= min length, aligned fraction of the read >=
min percent, and 1 - NM/aligned >= min identity (:236-266); pairs use the
summed per-mate aligned lengths (M/I/=/X, no D) and combined edit distance
(:267-330).  FlagFilter (mod.rs:19-33) gates improper pairs / secondary /
supplementary alignments.  Thresholds default to 0 (inactive), as in the
CLI (cli.rs:120-170).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FlagFilter:
    """Defaults match utils.rs:606-608: improper pairs and secondary
    alignments are excluded, supplementary alignments are KEPT unless
    --exclude-supplementary is given."""
    include_improper_pairs: bool = False
    include_secondary: bool = False
    include_supplementary: bool = True

    def passes(self, rec) -> bool:
        """mod.rs:25-37 FlagFilter::passes."""
        if not self.include_secondary and rec.is_secondary:
            return False
        if not self.include_supplementary and rec.is_supplementary:
            return False
        if not self.include_improper_pairs and rec.is_paired \
                and not rec.is_proper_pair:
            return False
        return True


@dataclass
class AlignmentThresholds:
    min_aligned_length_single: int = 0
    min_percent_identity_single: float = 0.0
    min_aligned_percent_single: float = 0.0
    min_aligned_length_pair: int = 0
    min_percent_identity_pair: float = 0.0
    min_aligned_percent_pair: float = 0.0

    @property
    def filtering_single(self) -> bool:
        return (self.min_aligned_length_single > 0
                or self.min_percent_identity_single > 0
                or self.min_aligned_percent_single > 0)

    @property
    def filtering_pairs(self) -> bool:
        return (self.min_aligned_length_pair > 0
                or self.min_percent_identity_pair > 0
                or self.min_aligned_percent_pair > 0)

    @property
    def active(self) -> bool:
        return self.filtering_single or self.filtering_pairs


def _nm(rec) -> int:
    try:
        return int(rec.tags.get("NM", 0))
    except Exception:
        return 0


def _aligned_len(rec, include_del: bool) -> int:
    ops = "MID=X" if include_del else "MI=X"
    return sum(n for op, n in rec.cigar if op in ops)


def single_read_passes(rec, th: AlignmentThresholds) -> bool:
    aligned = _aligned_len(rec, include_del=True)
    if aligned == 0:
        return False
    return (aligned >= th.min_aligned_length_single
            and aligned / max(len(rec.seq), 1) >= th.min_aligned_percent_single
            and 1.0 - _nm(rec) / aligned >= th.min_percent_identity_single)


def read_pair_passes(r1, r2, th: AlignmentThresholds) -> bool:
    a1 = _aligned_len(r1, include_del=False)
    a2 = _aligned_len(r2, include_del=False)
    total = a1 + a2
    if total == 0:
        return False
    edit = _nm(r1) + _nm(r2)
    seq_total = max(len(r1.seq) + len(r2.seq), 1)
    return (total >= th.min_aligned_length_pair
            and total / seq_total >= th.min_aligned_percent_pair
            and 1.0 - edit / total >= th.min_percent_identity_pair)


def apply_alignment_thresholds(reads: list, th: AlignmentThresholds) -> list:
    """Filter a sample's reads.  No-op when all thresholds are 0.

    Pair mode mirrors the reference's pair path exactly
    (filter.rs:101-215): only PRIMARY proper-pair records participate in
    name-pairing (secondary/supplementary records are skipped outright,
    :121-123), unmatched mates and non-proper pairs are dropped, and when
    single thresholds are also active BOTH mates must pass the single
    predicate in addition to the pair predicate (:177-195)."""
    if not th.active:
        return reads
    if not th.filtering_pairs:
        return [r for r in reads if single_read_passes(r, th)]
    by_name = {}
    for r in reads:
        if (r.is_paired and r.is_proper_pair
                and not r.is_secondary and not r.is_supplementary):
            by_name.setdefault(r.name, []).append(r)
    keep = set()
    for mates in by_name.values():
        # pair sequential occurrences, as the reference's first_set does
        for i in range(0, len(mates) - 1, 2):
            r1, r2 = mates[i], mates[i + 1]
            ok = ((not th.filtering_single
                   or (single_read_passes(r1, th)
                       and single_read_passes(r2, th)))
                  and read_pair_passes(r1, r2, th))
            if ok:
                keep.add(id(r1))
                keep.add(id(r2))
    return [r for r in reads if id(r) in keep]
