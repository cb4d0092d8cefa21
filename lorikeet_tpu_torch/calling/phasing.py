"""Physical phasing of called variants within an assembly region.

Contract: reference/src/assembly/assembly_based_caller_utils.rs:975-1340
phase_calls: (1) map each biallelic call to the set of alt haplotypes whose
event map carries its alt allele at the same start; (2) pair calls that
co-occur on exactly the same haplotypes (in-phase, "0|1"/"0|1") or that
partition the alt haplotypes disjointly (anti-phase, "0|1"/"1|0");
(3) annotate genotypes with PID (unique id of leftmost variant), PGT, and
PS (phase-set position).  Unphasable conflicts clear all phasing
(:1180-1186).

Deviation noted: the reference initializes
`call_haplotypes_available_for_phasing` empty (:1147, making its branch
unreachable); this port seeds it with the call's haplotypes, the upstream
GATK semantics the code transcribes.
"""
from __future__ import annotations

PHASE_01 = "0|1"
PHASE_10 = "1|0"


def construct_haplotype_mapping(calls: list, hap_events: list) -> dict:
    """call index -> set of haplotype indices carrying its alt allele."""
    mapping = {}
    for idx, call in enumerate(calls):
        alts = [a for a in call.alternate_alleles
                if not a.is_symbolic and not a.is_span_del]
        if len(alts) != 1:
            mapping[idx] = set()
            continue
        alt = alts[0]
        haps = set()
        for h_idx, events in enumerate(hap_events):
            for vc in events.values():
                if vc.start == call.start and any(
                        a.bases == alt.bases for a in vc.alternate_alleles):
                    haps.add(h_idx)
                    break
        mapping[idx] = haps
    return mapping


def construct_phase_set_mapping(calls: list, haplotype_map: dict) -> dict:
    """call index -> (group id, PGT string); empty when unphasable."""
    with_variants = set()
    for haps in haplotype_map.values():
        with_variants |= haps
    total = len(with_variants)

    mapping = {}
    counter = 0
    n = len(calls)
    for i in range(max(n - 1, 0)):
        haps_i = haplotype_map.get(i, set())
        if not haps_i:
            continue
        call_on_all = len(haps_i) == total
        available = set(haps_i)
        for j in range(i + 1, n):
            haps_j = haplotype_map.get(j, set())
            if not haps_j:
                continue
            comp_on_all = len(haps_j) == total
            same = (len(haps_i) == len(haps_j) and haps_j <= haps_i)
            if same or (call_on_all and haps_j <= available) or comp_on_all:
                if i not in mapping:
                    if j in mapping:      # unphasable conflict: abort all
                        return {}
                    mapping[i] = (counter, PHASE_01)
                    mapping[j] = (counter, PHASE_01)
                    available &= haps_j
                    counter += 1
                elif j not in mapping:
                    mapping[j] = mapping[i]
            elif len(haps_i) + len(haps_j) == total and not (haps_i & haps_j):
                if i not in mapping:
                    if j in mapping:
                        return {}
                    mapping[i] = (counter, PHASE_01)
                    mapping[j] = (counter, PHASE_10)
                    counter += 1
                elif j not in mapping:
                    gid, pgt = mapping[i]
                    mapping[j] = (gid, PHASE_10 if pgt == PHASE_01 else PHASE_01)
    return mapping


def phase_calls(calls: list, hap_events: list) -> list:
    """Annotate genotypes of phased calls with PID/PGT/PS; returns calls."""
    if len(calls) < 2:
        return calls
    hap_map = construct_haplotype_mapping(calls, hap_events)
    mapping = construct_phase_set_mapping(calls, hap_map)
    groups = {}
    for idx, (gid, _) in mapping.items():
        groups.setdefault(gid, []).append(idx)
    for gid, indexes in groups.items():
        if len(indexes) < 2:
            continue
        indexes.sort()
        first = calls[indexes[0]]
        uid = "{}_{}_{}".format(
            first.start, first.reference.bases.decode(),
            first.alternate_alleles[0].bases.decode())
        phase_set = first.start + 1      # 1-based PS, VCF convention
        for idx in indexes:
            pgt = mapping[idx][1]
            for g in calls[idx].genotypes:
                g.attributes["PID"] = uid
                g.attributes["PGT"] = pgt
                g.attributes["PS"] = phase_set
    return calls
