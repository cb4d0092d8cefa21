"""VariantContext merging — simple_merge and helpers.

Port contract: variant_context_utils.rs:379-555 (simple_merge),
:726-953 (strip_pls_and_ad, has_pl_incompatibilities, merge_genotypes,
resolve_incompatible_alleles, create_allele_mapping,
determine_reference_allele, sort_variant_contexts_by_priority) and
:555-600 (calculate_chromosome_counts).  Production role: merging
spanning events at a genotyping locus (assembly_based_caller_utils.rs:570
make_merged_variant_context) — the caller fast-path lives in
calling/events.py merge_events; this module is the full-fidelity merge
with genotype priority semantics, used by feature-VCF style merging and
pinned by the ported vectors in tests/test_variant_context_merge.py.
"""
from __future__ import annotations

from lorikeet_tpu_torch.models.variants import Allele, VariantContext

# GenotypeMergeType (variant_context_utils.rs GenotypeMergeType)
PRIORITIZE = "prioritize"
UNSORTED = "unsorted"
UNIQUIFY = "uniquify"

# FilteredRecordMergeType
KEEP_IF_ANY_UNFILTERED = "keep_if_any_unfiltered"
KEEP_UNCONDITIONAL = "keep_unconditional"

_SPAN_DEL = b"*"


def source_of(vc) -> str:
    """VCs carry their track name in .source when merging (the reference's
    VariantContext::source field; our VariantContext stores it ad hoc)."""
    return getattr(vc, "source", "")


def sort_variant_contexts_by_priority(unsorted_vcs: list,
                                      priority_list: list | None,
                                      merge_option: str) -> list:
    """:925-953 — stable sort by priority-list position of each VC's
    source; Unsorted (or no list) keeps input order."""
    if merge_option == PRIORITIZE and priority_list is None:
        raise ValueError("cannot merge calls by priority with no priority "
                         "list")
    if priority_list is None or merge_option == UNSORTED:
        return list(unsorted_vcs)
    order = {name: i for i, name in enumerate(priority_list)}
    return sorted(unsorted_vcs, key=lambda vc: order[source_of(vc)])


def determine_reference_allele(vcs: list, loc: int | None = None) -> Allele:
    """:872-915 — the longest reference allele across the VCs (equal-length
    refs must agree)."""
    ref = None
    for vc in vcs:
        if loc is not None and vc.start != loc:
            continue
        my_ref = vc.reference
        if ref is None or len(my_ref) > len(ref):
            ref = my_ref
        elif len(my_ref) == len(ref) and my_ref.bases != ref.bases:
            raise ValueError(
                f"reference alleles do not represent the same position: "
                f"{ref.bases!r} vs {my_ref.bases!r}")
    return ref


def _is_non_symbolic_extendable(allele: Allele) -> bool:
    """:855-859 — ref, symbolic and '*' alleles are never extended."""
    return not (allele.is_ref or allele.is_symbolic
                or allele.bases == _SPAN_DEL)


def create_allele_mapping(ref_allele: Allele, vc: VariantContext) -> dict:
    """:831-853 — extend every extendable alt of ``vc`` with the extra ref
    suffix so it is expressed against ``ref_allele``.  Returns
    {original Allele: extended Allele} (bases-keyed by Allele hash)."""
    assert len(ref_allele) > len(vc.reference), \
        "BUG: input ref is longer than ref_allele"
    extra = ref_allele.bases[len(vc.reference):]
    mapping = {}
    for a in vc.alternate_alleles:
        if _is_non_symbolic_extendable(a):
            mapping[a] = Allele(a.bases + extra, False)
        elif a.bases == _SPAN_DEL:
            mapping[a] = a
    return mapping


class AlleleMapper:
    """:1240-1300 — either passes a VC's alleles through unchanged or
    remaps them via an extension map."""

    def __init__(self, vc=None, mapping=None):
        self.vc = vc
        self.map = mapping

    def needs_remapping(self) -> bool:
        return self.map is not None

    def values(self) -> list:
        if self.map is not None:
            return list(self.map.values())
        return list(self.vc.alleles)

    def remap(self, allele: Allele) -> Allele:
        if self.map is not None and allele in self.map:
            return self.map[allele]
        return allele

    def remap_list(self, alleles: list) -> list:
        return [self.remap(a) for a in alleles]


def resolve_incompatible_alleles(ref_allele: Allele,
                                 vc: VariantContext) -> AlleleMapper:
    """:792-815"""
    if ref_allele.bases == vc.reference.bases:
        return AlleleMapper(vc=vc)
    mapping = create_allele_mapping(ref_allele, vc)
    mapping[vc.reference] = ref_allele
    return AlleleMapper(mapping=mapping)


def has_pl_incompatibilities(allele_set_1: list, allele_set_2: list) -> bool:
    """:733-754 — PLs survive the merge only when one allele list is a
    prefix of the other with identical ordering."""
    for a1, a2 in zip(allele_set_1, allele_set_2):
        if a1.bases != a2.bases or a1.is_ref != a2.is_ref:
            return True
    return len(allele_set_1) != len(allele_set_2)


def strip_pls_and_ad(genotypes: list) -> None:
    """:726-731"""
    for g in genotypes:
        g.log10_likelihoods = None
        g.ad = None


def merged_sample_name(track_name: str, sample_name: int,
                       uniquify: bool) -> int:
    """:780-790 — uniquified names hash track+sample (any stable hash)."""
    if uniquify:
        return hash((track_name, sample_name)) & 0x7FFFFFFFFFFFFFFF
    return sample_name


def _merge_genotypes(merged: list, seen: set, vc: VariantContext,
                     mapper: AlleleMapper, uniquify: bool) -> None:
    """:756-778 — first (highest-priority) occurrence of a sample wins."""
    import copy
    for g in vc.genotypes:
        name = merged_sample_name(source_of(vc), g.sample, uniquify)
        if name in seen:
            continue
        new_g = copy.copy(g)
        if uniquify or mapper.needs_remapping():
            if mapper.needs_remapping():
                new_g.alleles = mapper.remap_list(g.alleles)
            new_g.sample = name
        merged.append(new_g)
        seen.add(name)


def calculate_chromosome_counts(vc: VariantContext, attributes: dict,
                                remove_stale_values: bool) -> None:
    """:555-600 — recompute AN/AC/AF from called genotype alleles, or
    remove the stale values when nothing is called."""
    an = sum(1 for g in vc.genotypes for a in g.alleles if a.is_called)
    if an == 0 and remove_stale_values:
        for key in ("AC", "AF", "AN"):
            attributes.pop(key, None)
        return
    if not vc.genotypes:
        return
    attributes["AN"] = an
    alts = vc.alternate_alleles
    if alts:
        counts, freqs = [], []
        for allele in alts:
            ac = sum(1 for g in vc.genotypes for a in g.alleles
                     if a.bases == allele.bases and not a.is_ref)
            counts.append(ac)
            freqs.append(ac / an if an else 0.0)
        attributes["AC"] = counts
        attributes["AF"] = freqs
    else:
        attributes.pop("AC", None)
        attributes.pop("AF", None)


def simple_merge(unsorted_vcs: list, priority_list: list | None = None,
                 original_num_of_vcs: int | None = None,
                 filtered_record_merge_type: str = KEEP_IF_ANY_UNFILTERED,
                 genotype_merge_option: str = PRIORITIZE,
                 filtered_are_uncalled: bool = False):
    """:379-555 — merge VariantContexts at one start site into a single
    hybrid VC.  Genotypes for common samples are taken in priority order;
    alleles are unified against the longest reference allele; PLs/AD are
    stripped when the merged allele list invalidates them."""
    if not unsorted_vcs:
        return None
    if (priority_list is not None and original_num_of_vcs is not None
            and len(priority_list) != original_num_of_vcs):
        raise ValueError("the number of the original VariantContexts must "
                         "match the priority list length")

    pre_filtered = sort_variant_contexts_by_priority(
        unsorted_vcs, priority_list, genotype_merge_option)
    vcs = [vc for vc in pre_filtered
           if not filtered_are_uncalled or not vc.filters]
    if not vcs:
        return None

    ref_allele = determine_reference_allele(vcs)

    alleles: list = []          # insertion-ordered unique merged alleles
    seen_alleles: set = set()
    filters: set = set()
    attributes: dict = {}
    inconsistent: set = set()
    longest = vcs[0]
    depth = 0
    log10_p_error = 1.0
    any_filters_applied = False
    genotypes: list = []
    seen_samples: set = set()
    n_filtered = 0
    uniquify = genotype_merge_option == UNIQUIFY

    for vc in vcs:
        if vc.start != longest.start:
            raise ValueError("attempting to merge VariantContexts with "
                             "different start sites")
        if (vc.end - vc.start) > (longest.end - longest.start):
            longest = vc
        if vc.filters:
            n_filtered += 1
        mapper = resolve_incompatible_alleles(ref_allele, vc)
        for a in mapper.values():
            key = (a.bases, a.is_ref)
            if key not in seen_alleles:
                seen_alleles.add(key)
                alleles.append(a)
        _merge_genotypes(genotypes, seen_samples, vc, mapper, uniquify)
        # QUAL of the first VC with a non-missing qual wins
        if abs(log10_p_error - 1.0) < 1e-15:
            log10_p_error = vc.log10_p_error
        filters.update(vc.filters)
        any_filters_applied = any_filters_applied or bool(vc.filters)
        # DP adds up; other attributes survive only when consistent
        if "DP" in vc.attributes:
            depth += vc.attributes["DP"]
        for key, value in vc.attributes.items():
            if key in inconsistent:
                continue
            if key in attributes:
                bound = attributes[key]
                if bound is not None and bound != value:
                    inconsistent.add(key)
                    attributes.pop(key, None)
            else:
                attributes[key] = value

    # more alt alleles in the merge than in an input VC invalidate PLs/AD
    for vc in vcs:
        if vc.n_alleles == 1:
            continue
        if has_pl_incompatibilities(alleles, vc.alleles):
            strip_pls_and_ad(genotypes)
            calculate_chromosome_counts(vc, attributes, True)
            break

    if ((filtered_record_merge_type == KEEP_IF_ANY_UNFILTERED
         and n_filtered != len(vcs))
            or filtered_record_merge_type == KEEP_UNCONDITIONAL):
        filters.clear()

    if depth > 0:
        attributes["DP"] = depth

    merged = VariantContext(longest.tid, longest.start, longest.end, alleles,
                            genotypes)
    merged.log10_p_error = log10_p_error
    if any_filters_applied:
        merged.filters = sorted(filters)
    merged.attributes = attributes
    return merged
