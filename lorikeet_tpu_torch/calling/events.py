"""Haplotype event extraction and per-locus allele merging.

Contracts: reference/src/haplotype/event_map.rs:86-240 (cigar walk
emitting SNP/insertion/deletion VariantContexts with VCF anchor bases),
assembly_based_caller_utils.rs:559-758 (merged VC construction with
ref-padding and the haplotype->allele mapper, spanning deletions as '*').
"""
from __future__ import annotations

import numpy as np

from lorikeet_tpu_torch.models.variants import (
    Allele, SPAN_DEL_ALLELE, VariantContext,
)

_REGULAR = frozenset(b"ACGT")


def _regular(b) -> bool:
    return b in _REGULAR


def make_block(vc1: VariantContext, vc2: VariantContext) -> VariantContext:
    """Block substitution from two same-start events of one haplotype
    (event_map.rs:274-344): SNP+insertion extends the alt, SNP+deletion
    patches the ref, insertion+deletion combine into ref-del/alt-ins."""
    assert vc1.start == vc2.start
    ref1, alt1 = vc1.alleles[0], vc1.alleles[1]
    ref2, alt2 = vc2.alleles[0], vc2.alleles[1]
    is_snp1 = len(ref1) == 1 and len(alt1) == 1
    if is_snp1:
        if ref1.bases == ref2.bases:
            # SNP + insertion: alt carries the substituted base
            reference = ref1
            alt = Allele(alt1.bases + alt2.bases[1:], False)
            end = vc1.end
        else:
            # SNP + deletion: deletion's ref with the SNP's alt base
            reference = ref2
            alt = alt1
            end = vc2.end
    else:
        ins, dele = (vc1, vc2) if len(alt1) > len(ref1) else (vc2, vc1)
        reference = dele.alleles[0]
        alt = ins.alleles[1]
        end = dele.end
    return VariantContext(vc1.tid, vc1.start, end, [reference, alt])


def _add_event(events: dict, vc: VariantContext):
    """add_vc with merge (event_map.rs:253-262): same-start events combine
    into a block substitution."""
    prev = events.get(vc.start)
    events[vc.start] = vc if prev is None else make_block(prev, vc)


def build_event_map(hap, ref: np.ndarray, ref_start: int,
                    max_mnp_distance: int = 0) -> dict:
    """Events keyed by reference start position for one assembled haplotype.

    ``hap`` is an AssembledHaplotype (bases + cigar vs the window);
    ``ref_start`` is the genomic position of window offset 0.
    Returns {genome_pos: VariantContext}.
    """
    events = {}
    ref_pos = hap.alignment_start_offset
    aln_pos = 0
    alignment = np.frombuffer(hap.bases, np.uint8)
    cigar = hap.cigar
    for ci, (op, ln) in enumerate(cigar):
        if op == "I":
            if ref_pos > 0 and 0 < ci < len(cigar) - 1:
                ref_byte = ref[ref_pos - 1]
                ins = alignment[aln_pos:aln_pos + ln]
                if _regular(ref_byte) and all(_regular(b) for b in ins):
                    start = ref_start + ref_pos - 1
                    alleles = [Allele(bytes([ref_byte]), True),
                               Allele(bytes([ref_byte]) + ins.tobytes(), False)]
                    _add_event(events, VariantContext(0, start, start,
                                                      alleles))
            aln_pos += ln
        elif op == "S":
            aln_pos += ln
        elif op == "D":
            if ref_pos > 0:
                del_bases = ref[ref_pos - 1:ref_pos + ln]
                ref_byte = ref[ref_pos - 1]
                if _regular(ref_byte) and all(_regular(b) for b in del_bases):
                    start = ref_start + ref_pos - 1
                    alleles = [Allele(del_bases.tobytes(), True),
                               Allele(bytes([ref_byte]), False)]
                    _add_event(events, VariantContext(0, start, start + ln,
                                                      alleles))
            ref_pos += ln
        elif op in "M=X":
            mismatches = [
                off for off in range(ln)
                if ref[ref_pos + off] != alignment[aln_pos + off]
                and _regular(ref[ref_pos + off]) and _regular(alignment[aln_pos + off])
            ]
            i = 0
            while i < len(mismatches):
                start_off = mismatches[i]
                end_off = start_off
                while (i + 1 < len(mismatches)
                       and mismatches[i + 1] - end_off <= max_mnp_distance):
                    i += 1
                    end_off = mismatches[i]
                i += 1
                start = ref_start + ref_pos + start_off
                alleles = [
                    Allele(ref[ref_pos + start_off:ref_pos + end_off + 1].tobytes(), True),
                    Allele(alignment[aln_pos + start_off:aln_pos + end_off + 1].tobytes(), False),
                ]
                _add_event(events, VariantContext(
                    0, start, ref_start + ref_pos + end_off, alleles))
            ref_pos += ln
            aln_pos += ln
    return events


def get_overlapping_events(loc: int, events: dict) -> list:
    """Events of ONE haplotype overlapping ``loc``, with the reference's
    deletion-vs-insertion tie rule (event_map.rs:429-464): when a deletion
    ends exactly at loc and an insertion sits at loc, the deletion is
    dropped — the insertion explains the locus."""
    overlapping = [vc for start, vc in sorted(events.items())
                   if start <= loc <= vc.end]
    has_ins_at_loc = any(
        len(vc.reference) == 1 and any(len(a) > 1
                                       for a in vc.alternate_alleles)
        for vc in overlapping)
    deletions_ending = [
        vc for vc in overlapping
        if len(vc.reference) > 1 and any(len(a) == 1
                                         for a in vc.alternate_alleles)
        and vc.end == loc]
    if has_ins_at_loc and deletions_ending:
        drop = deletions_ending[0]
        return [vc for vc in overlapping if vc is not drop]
    return overlapping


def events_at_locus(loc: int, hap_events: list, include_spanning: bool = True):
    """Per-haplotype events active at loc: the event starting there, or a
    spanning-deletion placeholder (get_variant_contexts_from_active_haplotypes)."""
    out = []
    seen_span = set()
    for events in hap_events:
        vc = events.get(loc)
        if vc is not None:
            out.append(vc)
        elif include_spanning:
            # ANY event starting before loc and overlapping it becomes a
            # '*' placeholder — deletions, MNPs and block substitutions
            # alike (replace_with_span_del_vc,
            # haplotype_caller_genotyping_engine.rs:737-752 has no
            # ref/alt-length test)
            for start, ev in events.items():
                if start < loc <= ev.end:
                    key = (ev.start, ev.end)
                    if key not in seen_span:
                        seen_span.add(key)
                        out.append("SPAN_DEL")
                    break
    return out


def merge_events(events: list, loc: int) -> VariantContext | None:
    """Merge per-haplotype events at one locus into a single multi-allelic VC
    with ref-padded alleles (make_merged_variant_context semantics)."""
    real = [e for e in events if e != "SPAN_DEL"]
    has_span = any(e == "SPAN_DEL" for e in events)
    if not real:
        # SPAN_DEL-only loci are unreachable from the engine (loc is always
        # an event start) and produce no call either way
        return None
    # the merged reference allele is the longest ref allele
    longest_ref = max((e.reference for e in real), key=len)
    alt_set = []
    for e in real:
        pad = longest_ref.bases[len(e.reference):]
        for a in e.alternate_alleles:
            padded = Allele(a.bases + pad, False)
            if padded not in alt_set and padded.bases != longest_ref.bases:
                alt_set.append(padded)
    if has_span and SPAN_DEL_ALLELE not in alt_set:
        alt_set.append(SPAN_DEL_ALLELE)
    if not alt_set:
        return None
    end = loc + len(longest_ref) - 1
    return VariantContext(real[0].tid, loc, end,
                          [Allele(longest_ref.bases, True)] + alt_set)


def create_allele_mapper(merged: VariantContext, loc: int, haplotypes: list,
                         hap_events: list,
                         emit_spanning_dels: bool = True) -> dict:
    """allele -> list of haplotype indices supporting it
    (assembly_based_caller_utils.rs:720-840).

    With ``emit_spanning_dels`` haplotypes carrying a deletion spanning loc
    map to the '*' allele when present (reference otherwise); without it
    (disable-spanning-event-genotyping) they map to reference.  A haplotype
    whose event alt is absent from the merged alleles (e.g. after GGA-mode
    subsetting) is left unassigned, as in the reference (:776-798)."""
    mapper = {a: [] for a in merged.alleles}
    ref = merged.reference
    for h, events in enumerate(hap_events):
        vc = events.get(loc)
        if vc is None:
            # any event overlapping loc from upstream counts as spanning
            # (assembly_based_caller_utils.rs:809-825, no length test)
            spanning = None
            for start, ev in events.items():
                if start < loc <= ev.end:
                    spanning = ev
                    break
            if spanning is not None:
                if emit_spanning_dels and SPAN_DEL_ALLELE in mapper:
                    mapper[SPAN_DEL_ALLELE].append(h)
                else:
                    mapper[ref].append(h)
                continue
            mapper[ref].append(h)
        else:
            pad = ref.bases[len(vc.reference):]
            alt = Allele(vc.alternate_alleles[0].bases + pad, False)
            if alt in mapper:
                mapper[alt].append(h)
            # else: unassigned (reference passes, :776-798)
    return mapper
