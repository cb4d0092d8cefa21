"""Simulated long reads beside a short-read dataset.

Unpaired reads of 2,000-3,000 bases drawn from the variant haplotype (every
planted variant on it), with 2 % substitutions, base quality 22 and MAPQ 60,
their CIGARs from the haplotype-to-reference segments as
``simulate._cigar_for_read`` builds them.  They pass the long-read filters
of ``processing._read_passes_filters`` (length >= 1,500, mean base quality
>= 20), so ``-l`` feeds them to the caller as a sample of their own.
Deterministic in the arguments.
"""
from __future__ import annotations

import os

import numpy as np

from lorikeet_tpu_torch.io.bam import FLAG_REVERSE, BamRecord
from lorikeet_tpu_torch.testkit.simulate import (
    BASES, _cigar_for_read, apply_variants,
)

MIN_LENGTH, MAX_LENGTH = 2000, 3000
SUBSTITUTION_RATE = 0.02
BASE_QUAL = 22
MAPQ = 60


def simulate_long_reads(ref: np.ndarray, variants=(), coverage: float = 10.0,
                        seed: int = 0, sample: str = "long0", tid: int = 0,
                        name_prefix: str = "long") -> list:
    """Coordinate-sorted long-read records from ``ref`` with ``variants``
    applied, at ``coverage`` (bases read over the haplotype's length)."""
    rng = np.random.default_rng(seed)
    hap, segments = apply_variants(ref, variants)
    seg_ends = [hs + (ln if kind != "D" else 0)
                for kind, rs, hs, ln in segments]
    mean_length = (MIN_LENGTH + MAX_LENGTH) / 2
    recs = []
    for k in range(int(coverage * len(hap) / mean_length)):
        length = int(rng.integers(MIN_LENGTH, MAX_LENGTH + 1))
        start = int(rng.integers(0, max(1, len(hap) - length + 1)))
        end = min(start + length, len(hap))
        bases = hap[start:end].copy()
        subs = np.nonzero(rng.random(len(bases)) < SUBSTITUTION_RATE)[0]
        # a substitution is always another base
        idx = np.searchsorted(BASES, bases[subs])
        bases[subs] = BASES[(idx + rng.integers(1, 4, len(subs))) % 4]
        cigar, ref_start = _cigar_for_read(segments, start, end, seg_ends)
        if ref_start is None:
            continue
        recs.append(BamRecord(
            name=f"{name_prefix}{k}",
            flag=FLAG_REVERSE if rng.random() < 0.5 else 0, tid=tid,
            pos=ref_start, mapq=MAPQ, cigar=cigar, seq=bases,
            qual=np.full(len(bases), BASE_QUAL, np.uint8),
            tags={"RG": sample}))
    recs.sort(key=lambda r: (r.tid, r.pos))
    return recs


def add_long_read_bam(fasta: str, variants, path: str,
                      coverage: float = 10.0, seed: int = 0) -> tuple:
    """Write one long-read BAM (+ .bai) over the single contig of
    ``fasta`` with ``variants`` planted; returns (``path``, reads)."""
    from lorikeet_tpu_torch.io.bam_writer import write_bam
    from lorikeet_tpu_torch.io.fasta import FastaReader

    reader = FastaReader(fasta)
    (contig,) = reader.names
    ref = np.asarray(reader.fetch(contig), np.uint8)
    reader.close()
    stem = os.path.splitext(os.path.basename(path))[0]
    recs = simulate_long_reads(ref, variants, coverage=coverage, seed=seed,
                               sample=stem)
    write_bam(path, [contig], [len(ref)], recs)
    return path, len(recs)
