"""Forced-allele (feature VCF) support: `--features-vcf`.

Contracts:
- assembly_region_walker.rs:133-195,281-306 (retrieve_feature_variants):
  per-region lookup of feature-VCF records overlapping the padded span; a
  region carrying given alleles is called even when inactive
  (haplotype_caller_engine.rs:1166-1177);
- assembly_based_caller_utils.rs:376-556 (add_given_alleles): alleles not
  already produced by assembly are spliced into the highest-scoring
  assembled haplotypes (ref first, up to 5), and variation events are
  regenerated so genotyping sees the forced alleles.

Note: injection happens on host before pair packing, so forced
haplotypes ride the same batched pair-HMM dispatch as assembled ones.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from lorikeet_tpu_torch.utils.cigar import calculate_cigar

#: assembly_based_caller_utils.rs:95
NUM_HAPLOTYPES_TO_INJECT = 5


@lru_cache(maxsize=8)
def load_feature_vcf(path: str):
    """Parse a feature VCF once per process; returns
    {contig_name: [VariantContext sorted by start]}."""
    from lorikeet_tpu_torch.io.vcf import read_vcf
    contexts, contigs, _ = read_vcf(path)
    by_contig = {}
    for vc in contexts:
        name = contigs[vc.tid] if 0 <= vc.tid < len(contigs) else None
        if name is not None:
            by_contig.setdefault(name, []).append(vc)
    for lst in by_contig.values():
        lst.sort(key=lambda v: v.start)
    return by_contig


def _ref_to_hap_map(hap) -> dict:
    """window-offset -> haplotype-offset for match-aligned positions, plus
    a one-past-end anchor (the coordinate walk of
    haplotype.rs insert_allele / alignment_utils.rs)."""
    m = {}
    ref_pos = hap.alignment_start_offset
    hap_pos = 0
    for op, ln in hap.cigar:
        if op in "M=X":
            for i in range(ln):
                m[ref_pos + i] = hap_pos + i
            ref_pos += ln
            hap_pos += ln
        elif op == "D":
            ref_pos += ln
        elif op in "IS":
            hap_pos += ln
    m.setdefault(ref_pos, hap_pos)
    return m


def insert_allele(hap, window: np.ndarray, window_start: int,
                  start: int, ref_bytes: bytes, alt_bytes: bytes):
    """Splice `ref_bytes -> alt_bytes` at genome position `start` into an
    assembled haplotype; returns a new AssembledHaplotype or None when the
    splice points don't fall on match-aligned bases
    (haplotype.rs insert_allele semantics)."""
    from lorikeet_tpu_torch.assembly.graph import AssembledHaplotype
    p = start - window_start
    if p < 0 or p + len(ref_bytes) > len(window):
        return None
    m = _ref_to_hap_map(hap)
    hp = m.get(p)
    hp_end = m.get(p + len(ref_bytes))
    if hp is None or hp_end is None or hp_end < hp:
        return None
    new_bases = hap.bases[:hp] + alt_bytes + hap.bases[hp_end:]
    cigar = calculate_cigar(np.asarray(window, np.uint8),
                            np.frombuffer(new_bases, np.uint8))
    if cigar is None:
        return None
    return AssembledHaplotype(new_bases, cigar, hap.score, False,
                              hap.kmer_size)


def _remap(start: int, ref_b: bytes, alt_b: bytes, longer_len: int,
           window: np.ndarray, window_start: int):
    """Extend (ref, alt) to a longer reference span by appending the
    trailing reference bases (VariantContextUtils::remap_alleles role)."""
    if len(ref_b) >= longer_len:
        return ref_b, alt_b
    off = start - window_start + len(ref_b)
    tail = np.asarray(window[off:off + longer_len - len(ref_b)],
                      np.uint8).tobytes()
    return ref_b + tail, alt_b + tail


def add_given_haplotypes(haplotypes: list, hap_events: list,
                         window: np.ndarray, window_start: int,
                         given: list, max_mnp_distance: int = 0) -> int:
    """Inject not-yet-assembled given alleles as new haplotypes (mutates
    `haplotypes` + `hap_events` in place); returns how many were added."""
    from lorikeet_tpu_torch.calling.events import build_event_map

    if not given:
        return 0
    # assembled variation events grouped by start (alleles as raw bytes)
    assembled = {}
    for ev in hap_events:
        for loc, vc in ev.items():
            assembled.setdefault(loc, []).append(vc)

    # base haplotypes: reference first, then by assembly score
    # (assembly_based_caller_utils.rs:500-510)
    base = sorted(haplotypes,
                  key=lambda h: (not h.is_ref, -h.score))[:NUM_HAPLOTYPES_TO_INJECT]
    seen = {h.bases for h in haplotypes}
    added = 0
    for gvc in given:
        g_ref = gvc.reference.bases
        at_loc = assembled.get(gvc.start, [])
        longer = max([len(g_ref)] + [len(vc.reference.bases)
                                     for vc in at_loc])
        if gvc.start - window_start + longer > len(window):
            continue
        assembled_alts = set()
        for vc in at_loc:
            for a in vc.alternate_alleles:
                assembled_alts.add(_remap(vc.start, vc.reference.bases,
                                          a.bases, longer, window,
                                          window_start))
        for alt in gvc.alternate_alleles:
            if alt.is_symbolic or alt.bases in (b".", b"*", b""):
                continue
            r_ext, a_ext = _remap(gvc.start, g_ref, alt.bases, longer,
                                  window, window_start)
            if (r_ext, a_ext) in assembled_alts:
                continue
            for hap in base:
                idx = haplotypes.index(hap)
                if any(vc.start <= gvc.end and vc.end >= gvc.start
                       for vc in hap_events[idx].values()):
                    continue
                new_hap = insert_allele(hap, window, window_start,
                                        gvc.start, g_ref, alt.bases)
                if new_hap is None or new_hap.bases in seen:
                    continue
                seen.add(new_hap.bases)
                haplotypes.append(new_hap)
                hap_events.append(build_event_map(new_hap, window,
                                                  window_start,
                                                  max_mnp_distance))
                added += 1
    return added
