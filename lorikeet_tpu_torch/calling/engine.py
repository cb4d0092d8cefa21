"""Per-region variant calling: assemble -> pair-HMM -> genotype -> annotate.

Counterpart of lorikeet_tpu/calling/engine.py: the same code with the
likelihood and realignment imports pointing at the port and the device knobs
renamed (use_pallas -> use_cuda, use_pallas_sw -> use_cuda_sw).

Contracts:
- haplotype_caller_engine.rs:1162-1450 call_region (assemble, filter reads,
  likelihoods, assign genotypes);
- haplotype_caller_genotyping_engine.rs:101-330 assign_genotype_likelihoods
  (event maps -> per-locus merge -> marginalize -> evidence retention window
  -> GLs -> calculate_genotypes -> annotate);
- genotyping_engine.rs:80-250 calculate_genotypes (AF calc, emit/call
  thresholds, output allele subset, MLEAC/MLEAF attributes);
- annotator/variant_annotation.rs (DP, AD, GQ, PL, QD with 45-cap, MQ, AF).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from lorikeet_tpu_torch.assembly.graph import (
    assemble_candidates, haplotypes_from_candidates,
)
from lorikeet_tpu_torch.calling.events import (
    build_event_map, create_allele_mapper, events_at_locus, merge_events,
)
from lorikeet_tpu_torch.calling.likelihoods import AlleleLikelihoods, compute_read_likelihoods
from lorikeet_tpu_torch.models.af_calc import AlleleFrequencyCalculator
from lorikeet_tpu_torch.models.genotype_alleles import (
    genotype_count_matrix, genotype_likelihoods_from_read_matrix,
)
from lorikeet_tpu_torch.models.variants import Allele, Genotype, VariantContext
from lorikeet_tpu_torch.utils import progress as _prog
from lorikeet_tpu_torch.utils.math import log10_one_minus_pow10

ALLELE_INFORMATIVE_READS_OVERLAP_MARGIN = 2
MAX_QD_BEFORE_FIXING = 45.0
IDEAL_HIGH_QD = 45.0
# assembly_based_caller_utils.rs:94
MINIMUM_READ_LENGTH_AFTER_TRIMMING = 10


@dataclass
class CallerConfig:
    ploidy: int = 2
    snp_heterozygosity: float = 0.001
    indel_heterozygosity: float = 0.000125
    heterozygosity_stdev: float = 0.01
    stand_min_conf: float = 25.0
    max_mnp_distance: int = 0
    min_base_quality: int = 10
    # PCR indel error model: none|hostile|aggressive|conservative
    # (cli.rs pcr-indel-model, pair_hmm_likelihood_calculation_engine.rs:61-90)
    pcr_indel_model: str = "conservative"
    mapq_threshold: int = 20
    # pair-HMM likelihood-engine knobs
    # (assembly_based_caller_utils.rs:926-966 create_likelihood_calculation_
    # engine; cli.rs defaults)
    pair_hmm_gcp: int = 10
    base_quality_score_threshold: int = 18
    disable_cap_base_qualities_to_map_quality: bool = False
    phred_global_read_mismapping_rate: int = 45
    disable_symmetric_hmm_normalizing: bool = False
    disable_dynamic_read_disqualification: bool = False
    dynamic_read_disqualification_threshold: float = 1.0
    expected_mismatch_rate_for_read_disqualification: float = 0.02
    # genotyping knobs (haplotype_caller_genotyping_engine.rs:101-330,
    # genotyping_engine.rs:51-250, cli.rs defaults)
    allele_informative_reads_overlap_margin: int = 2
    disable_spanning_event_genotyping: bool = False
    do_not_run_physical_phasing: bool = False
    genotype_assignment_method: str = "UsePLsToAssign"
    use_posteriors_to_calculate_qual: bool = False
    annotate_with_num_discovered_alleles: bool = False
    # QUAL component of ANI/strain site qualification
    # (cli.rs qual-threshold; lorikeet_engine.rs:447 qual_filter = q/-10)
    qual_threshold: float = 150.0
    # second mapq gate applied to reads entering per-region calling
    # (cli.rs mapping-quality-threshold-for-genotyping,
    #  haplotype_caller_engine.rs:241,1272)
    mapping_quality_threshold_for_genotyping: int = 20
    # keep processing regions with no assembled variation
    # (haplotype_caller_engine.rs:1227 disable-optimizations)
    disable_optimizations: bool = False
    # skip trimming haplotypes/reads to the variant span
    # (haplotype_caller_engine.rs:1243 trim_to; GATK dont-trim-active-regions)
    dont_trim_active_regions: bool = False
    # per-contig checkpoint/resume under {genome}/.chunks (long multi-contig
    # jobs; keys include BAM sizes/mtimes + the config fingerprint)
    checkpoint: bool = False
    # genotype-mode split filter (cli.rs min-variant-depth-for-genotyping,
    # variant_context_utils.rs:607-690)
    min_variant_depth_for_genotyping: int = 10
    kmer_sizes: tuple = (21, 33)
    # pair-HMM on the CUDA kernel (None: when a card is present; False:
    # the exact f64 host kernel)
    use_cuda: bool | None = None
    # batch realignment SW on the CUDA kernel (ops/sw_cuda.py), independent
    # of use_cuda; False: the native host aligner
    use_cuda_sw: bool = False
    max_alt_alleles: int = 6
    # mixed technologies: per-sample read type ("short" | "long"),
    # lorikeet_engine.rs ReadType + read_utils.rs:70-77 long-read filters
    read_types: list = None
    min_long_read_size: int = 1500
    min_long_read_average_base_qual: int = 20
    # alignment thresholding (filter.rs; None/inactive by default)
    alignment_thresholds: object = None
    # BAM flag gates (mod.rs:19-37 FlagFilter; utils.rs:606-608 defaults:
    # improper pairs/secondary excluded, supplementary kept). None uses
    # those defaults via io.filter.FlagFilter.
    flag_filter: object = None
    # svim structural-variant QUAL filter (cli.rs min-sv-qual)
    min_sv_qual: int = 3
    # skip the svim SV stage entirely (cli.rs do-not-call-svs,
    # lorikeet_engine.rs:370-383)
    do_not_call_svs: bool = False
    # forced-calling feature VCF (cli.rs features-vcf,
    # assembly_region_walker.rs:133-195)
    features_vcf: str = None
    # site/ANI qualification thresholds (cli.rs qual-by-depth-filter,
    # depth-per-sample-filter; variant_context_utils.rs:99-148)
    qual_by_depth_filter: float = 25.0
    depth_per_sample_filter: int = 5
    # DOT dump of per-region assembly graphs (cli.rs graph-output,
    # base_graph.rs:505)
    graph_output: str = None
    # assembly pruning (read_threading_assembler.rs:70-105 + cli.rs defaults)
    prune_factor: int = 1
    use_adaptive_pruning: bool = False
    initial_error_rate_for_pruning: float = 0.001
    pruning_log_odds_threshold: float = 1.0
    pruning_seeding_log_odds_threshold: float = 4.0
    max_unpruned_variants: int = 100
    disable_prune_factor_correction: bool = False
    # active-region extraction (cli.rs min/max-assembly-region-size,
    # assembly-region-padding, active-probability-threshold, max-input-depth)
    min_assembly_region_size: int = 50
    max_assembly_region_size: int = 300
    assembly_region_padding: int = 100
    active_prob_threshold: float = 0.002
    max_input_depth: int = 200_000
    # region trimming paddings (cli.rs:1775-1799 defaults;
    # assembly_region_trimmer.rs:61-130: indels get indel padding, or
    # str padding + longest repeat run at tandem-repeat sites)
    snp_padding_for_genotyping: int = 20
    indel_padding_for_genotyping: int = 75
    str_padding_for_genotyping: int = 75
    max_extension_into_region_padding: int = 25
    # band-pass probability propagation cap (cli.rs
    # max-prob-propagation-distance, band_pass_activity_profile.rs)
    max_prob_propagation_distance: int = 50
    # contigs shorter than this are skipped entirely
    # (cli.rs min-contig-size, haplotype_caller_engine.rs:340,418)
    min_contig_size: int = 0
    # read-threading assembly knobs (haplotype_caller_engine.rs:120-200
    # assembler construction; cli.rs:1588-1767 defaults)
    max_allowed_path_for_read_threading_assembler: int = 128
    num_pruning_samples: int = 1
    dont_increase_kmer_sizes_for_cycles: bool = False
    disable_automatic_kmer_adjustment: bool = False
    allow_non_unique_kmers_in_ref: bool = False
    recover_dangling_branches: bool = True
    recover_all_dangling_branches: bool = False
    min_dangling_branch_length: int = 1
    min_matching_bases_to_dangling_end_recovery: int = -1
    # region finalization soft-clip handling
    # (assembly_based_caller_utils.rs:295-311 finalize_regions args)
    dont_use_soft_clipped_bases: bool = False
    soft_clip_low_quality_ends: bool = False
    # host worker threads for per-contig parallelism (cli.rs --threads;
    # the rayon-pool analogue — device batches stay whole-chunk)
    threads: int = 1

    @classmethod
    def from_reference(cls, cfg) -> "CallerConfig":
        """Carry a lorikeet_tpu CallerConfig across field by field (extra
        attributes set on the instance included); its use_pallas and
        use_pallas_sw become use_cuda and use_cuda_sw."""
        renames = {"use_pallas": "use_cuda", "use_pallas_sw": "use_cuda_sw"}
        out = cls()
        for name, value in vars(cfg).items():
            setattr(out, renames.get(name, name), value)
        return out

    def apply_profile(self, profile: str):
        """Assembly presets (haplotype_caller_engine.rs:246-298)."""
        p = (profile or "").lower()
        if p == "very-fast":
            self.prune_factor = 2
            self.kmer_sizes = (33,)
        elif p == "fast":
            self.prune_factor = 2
            self.kmer_sizes = (21, 33)
        elif p == "precise":
            self.prune_factor = 2
            self.kmer_sizes = (21, 33, 45)
        elif p == "sensitive":
            self.prune_factor = 0
            self.kmer_sizes = (21, 33, 45)
        elif p == "super-sensitive":
            self.prune_factor = 0
            self.kmer_sizes = (21, 33, 45, 57)
        if p in ("very-fast", "fast", "precise", "sensitive",
                 "super-sensitive"):
            self.disable_prune_factor_correction = True
            # every preset pins these off (haplotype_caller_engine.rs:255-298)
            self.allow_non_unique_kmers_in_ref = False
            self.recover_all_dangling_branches = False


@dataclass
class RegionWork:
    """A prepared active region awaiting its pair-HMM likelihoods —
    the unit of cross-region device batching (SURVEY §2.4: region-level
    task parallelism -> bucketed batching across chips)."""
    window_start: int
    active_start: int
    active_end: int
    tid: int
    haplotypes: list
    hap_events: list
    reads_by_sample: dict
    pairs: list
    index: list
    given_alleles: list = None  # features-VCF contexts for forced calling


@dataclass
class RegionDraft:
    """An active region after its graphs and their k-best paths, before its
    haplotypes' CIGARs: a span computes the CIGARs of all its regions
    together (processing._call_span), then completes each."""
    ref_window: np.ndarray
    window_start: int
    active_start: int
    active_end: int
    tid: int
    reads_by_sample: dict
    given_alleles: list
    ref_bytes: bytes
    candidates: list            # [(score, bases, kmer size)]

    def cigar_pairs(self) -> list:
        """(window, candidate bases) for each candidate's CIGAR."""
        ref = np.frombuffer(self.ref_bytes, np.uint8)
        return [(ref, np.frombuffer(bases, np.uint8))
                for _, bases, _ in self.candidates]


# GLs summing above this are treated as non-informative -> forced no-call
# (variant_context.rs:109 SUM_GL_THRESH_NOCALL)
SUM_GL_THRESH_NOCALL = -0.1


def _subset_to_ref_only(vc: VariantContext, default_ploidy: int) -> list:
    """Hom-ref genotypes with no annotations, for ref-only output alleles
    (variant_context.rs:586-618 subset_to_ref_only)."""
    out = []
    for g in vc.genotypes:
        ploidy = g.ploidy if g.ploidy > 0 else default_ploidy
        out.append(Genotype(g.sample, ploidy, None,
                            [vc.reference] * ploidy))
    return out


def _informative_best_alleles(mat: np.ndarray):
    """Per-read best allele index + informative flag for an [A, R] likelihood
    matrix (allele_likelihoods.rs search_best_allele with the
    reference_tiebreaking_priority + BestAllele::is_informative).  Near-ties
    (within 0.2 log10) break toward the REFERENCE allele — row 0 of every
    event matrix — exactly as the reference's AD/BQ annotations do; an
    overridden read's confidence is <= 0, so it also reads as
    non-informative.  Shared by AD (DepthPerAlleleBySample) and BQ so the
    informativeness rule has one home."""
    from lorikeet_tpu_torch.calling.likelihoods import (
        LOG10_INFORMATIVE_THRESHOLD, search_best_alleles,
    )
    if not mat.shape[1]:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    priorities = np.zeros(mat.shape[0], np.int64)
    priorities[0] = 1                     # reference allele leads the matrix
    best, _, confidence = search_best_alleles(mat, priorities)
    if mat.shape[0] > 1:
        informative = confidence > LOG10_INFORMATIVE_THRESHOLD
    else:
        informative = np.ones(mat.shape[1], bool)
    return best, informative


def _gq_log10_from_posteriors(best: int, log10_posteriors) -> float:
    """log10 P(genotype != best) from normalized log10 posteriors
    (variant_context.rs:524-571 get_gq_log10_from_posteriors)."""
    from lorikeet_tpu_torch.utils.math import log10_sum_log10
    p = np.asarray(log10_posteriors, float)
    n = len(p)
    if n <= 1:
        return 1.0
    if n == 2:
        return float(p[1] if best == 0 else p[0])
    if n == 3:
        a = p[2 if best == 0 else best - 1]
        b = p[0 if best == 2 else best + 1]
        return min(0.0, float(np.logaddexp(a * _LN10, b * _LN10) / _LN10))
    if best == 0:
        return float(log10_sum_log10(p[1:]))
    if best == n - 1:
        return float(log10_sum_log10(p[:best]))
    lo = log10_sum_log10(p[:best])
    hi = log10_sum_log10(p[best + 1:])
    return min(0.0, float(np.logaddexp(lo * _LN10, hi * _LN10) / _LN10))


_LN10 = np.log(10.0)


def _read_offset_at_ref_trim(cigar, start: int) -> int:
    """Read-base offset where `trim_cigar_by_reference(cigar, start, ...)`
    begins consuming, mirroring its element-boundary rules exactly."""
    from lorikeet_tpu_torch.utils.cigar import CONSUMES_READ, CONSUMES_REF
    element_end = 0
    read = 0
    for op, n in cigar:
        element_start = element_end
        element_end = element_start + (n if op in CONSUMES_REF else 0)
        if element_end < start or (element_end == start
                                   and element_start < start):
            if op in CONSUMES_READ:
                read += n
            continue
        if (op in CONSUMES_REF and op in CONSUMES_READ
                and element_start < start):
            read += start - element_start
        return read
    return read


def trim_haplotypes_to_span(haplotypes, pad_lo, pad_hi, window_start):
    """Trim every haplotype to reference span [pad_lo, pad_hi] and dedup
    (assembly_result_set.rs trim_to + haplotype.rs trim +
    alignment_utils.rs get_bases_covering_ref_interval).  Returns the new
    haplotype list, or None when any haplotype cannot be trimmed cleanly
    (span edge inside an indel / haplotype does not cover the span) — the
    caller then keeps the untrimmed region."""
    from dataclasses import replace

    from lorikeet_tpu_torch.utils.cigar import (read_length, reference_length,
                                          trim_cigar_by_reference)

    out = []
    seen = {}
    for hap in haplotypes:
        hap_ref_start = window_start + hap.alignment_start_offset
        hap_ref_end = hap_ref_start + reference_length(hap.cigar) - 1
        if hap_ref_start > pad_lo or hap_ref_end < pad_hi:
            return None
        try:
            new_cigar, lead_del, trail_del = trim_cigar_by_reference(
                hap.cigar, pad_lo - hap_ref_start, pad_hi - hap_ref_start)
        except Exception:  # noqa: BLE001 — degenerate trim (all-insertion)
            return None
        if lead_del or trail_del:
            # a trim edge landed inside a deletion: the bases no longer
            # cover the span exactly (haplotype.rs trim /
            # get_bases_covering_ref_interval return None here)
            return None
        b0 = _read_offset_at_ref_trim(hap.cigar, pad_lo - hap_ref_start)
        # trimCigarByReference keeps boundary insertions; Haplotype.trim
        # strips them (and their bases) explicitly (haplotype.rs:184-204)
        if new_cigar and new_cigar[0][0] in "IS":
            b0 += new_cigar[0][1]
            new_cigar = new_cigar[1:]
        if new_cigar and new_cigar[-1][0] in "IS":
            new_cigar = new_cigar[:-1]
        if not new_cigar:
            return None
        new_bases = hap.bases[b0:b0 + read_length(new_cigar)]
        if len(new_bases) != read_length(new_cigar) or not new_bases:
            return None
        prev = seen.get(new_bases)
        if prev is not None:
            # identical trimmed haplotypes merge; the ref one wins
            # (assembly_result_set.rs trim_to dedup)
            if hap.is_ref and not out[prev].is_ref:
                out[prev] = replace(hap, bases=new_bases, cigar=new_cigar,
                                    alignment_start_offset=0)
            continue
        seen[new_bases] = len(out)
        out.append(replace(hap, bases=new_bases, cigar=new_cigar,
                           alignment_start_offset=0))
    return out


def compute_works_likelihoods(engine: "HaplotypeCallerEngine",
                              works: list) -> np.ndarray:
    """All regions' pair-HMM likelihoods in one device dispatch (the
    compute half of call_regions_batched; ctypes/device execution releases
    the GIL, so running this on a worker thread overlaps with host region
    preparation of the next span)."""
    from lorikeet_tpu_torch.calling.likelihoods import compute_pair_likelihoods
    all_pairs = [p for w in works for p in w.pairs]
    with _prog.global_stage("pairhmm"):
        return compute_pair_likelihoods(all_pairs, engine.cfg.use_cuda)


def call_regions_batched(engine: "HaplotypeCallerEngine",
                         works: list, lks: np.ndarray = None) -> list:
    """Compute ALL regions' pair-HMM likelihoods in one device dispatch,
    then genotype each region; returns per-region call lists.  Pass
    precomputed ``lks`` (compute_works_likelihoods) to skip the compute."""
    from lorikeet_tpu_torch.calling.likelihoods import assemble_likelihoods
    cfg = engine.cfg
    if lks is None:
        lks = compute_works_likelihoods(engine, works)
    out = []
    off = 0
    for w in works:
        n = len(w.pairs)
        likelihoods = assemble_likelihoods(
            w.haplotypes, w.reads_by_sample, lks[off:off + n], w.index,
            mismapping_cap=(cfg.phred_global_read_mismapping_rate / -10.0
                            if cfg.phred_global_read_mismapping_rate >= 0
                            else -np.inf),
            symmetric=not cfg.disable_symmetric_hmm_normalizing,
            dynamic_disqualification=
            not cfg.disable_dynamic_read_disqualification,
            dynamic_read_qual_constant=
            cfg.dynamic_read_disqualification_threshold,
            expected_error_rate=
            cfg.expected_mismatch_rate_for_read_disqualification)
        off += n
        out.append(engine.genotype_region(w, likelihoods))
    return out


class GenotypingEngine:
    """calculate_genotypes (genotyping_engine.rs:80-250, core path)."""

    def __init__(self, cfg: CallerConfig):
        self.cfg = cfg
        self.af_calc = AlleleFrequencyCalculator.make_calculator(
            cfg.snp_heterozygosity, cfg.indel_heterozygosity,
            cfg.heterozygosity_stdev, cfg.ploidy)
        # emitted upstream deletions, in traversal order
        # (genotyping_engine.rs record_deletions / upstream_deletions_loc)
        self._upstream_dels = []
        # (tid, start) of every site checked against them, when a list: a
        # span worker reports it so that the parent can tell whether the
        # deletions of the spans before would have covered a site there
        # (parallel/pool.py carry_deletions)
        self.deletion_checks = None

    def _forced_alleles(self, vc: VariantContext, given_alleles) -> set:
        """Alt alleles of vc exactly matching a given (features-VCF) context
        at the same start (get_alleles_consistent_with_given_alleles,
        assembly_based_caller_utils.rs:842-902: non-symbolic, (alt, ref)
        pair equality)."""
        if not given_alleles:
            return set()
        pairs = set()
        for gvc in given_alleles:
            if gvc.start != vc.start:
                continue
            for alt in gvc.alternate_alleles:
                if not alt.is_symbolic:
                    pairs.add((alt.bases, gvc.reference.bases))
        return {a for a in vc.alternate_alleles
                if not a.is_symbolic
                and (a.bases, vc.reference.bases) in pairs}

    def _covered_by_upstream_deletion(self, vc: VariantContext) -> bool:
        """True when an emitted deletion strictly upstream spans vc.start
        (genotyping_engine.rs is_vc_covered_by_deletion; same-start
        deletions deliberately do not count)."""
        if self.deletion_checks is not None:
            self.deletion_checks.append((vc.tid, vc.start))
        self._upstream_dels = [
            (tid, s, e) for tid, s, e in self._upstream_dels
            if tid == vc.tid and e >= vc.start]
        return any(s < vc.start <= e for _, s, e in self._upstream_dels)

    def _record_deletions(self, vc: VariantContext, out_alleles):
        """Track emitted deletions for downstream '*' suppression
        (genotyping_engine.rs:337-370 record_deletions)."""
        ref_len = len(vc.reference)
        for a in out_alleles:
            size = 0 if a.is_symbolic or a.is_span_del else ref_len - len(a)
            if size > 0:
                self._upstream_dels.append(
                    (vc.tid, vc.start, vc.start + size))

    def calculate_genotypes(self, vc: VariantContext,
                            given_alleles=None) -> VariantContext | None:
        if vc.n_samples == 0 or vc.n_alleles < 2:
            return None
        af = self.af_calc.calculate(vc, self.cfg.ploidy)
        forced = self._forced_alleles(vc, given_alleles)

        # calculate_output_allele_subset (genotyping_engine.rs:390-455,
        # GATK's GenotypingEngine): a '*' allele is spurious unless an
        # emitted upstream deletion covers the site; the site's other
        # alleles are output whether or not one does.  (The JAX package
        # suppresses every allele of a covered site, which drops one
        # strain's variant under another strain's deletion.)  Forced
        # (features-VCF) alleles are kept regardless of the AF threshold
        covered = self._covered_by_upstream_deletion(vc)
        output_alts = []
        mle_counts = []
        site_is_monomorphic = True
        for a in vc.alternate_alleles:
            plausible = af.passes_threshold(a, self.cfg.stand_min_conf)
            spurious = a.is_span_del and not covered
            site_is_monomorphic &= not (plausible and not spurious)
            if (plausible or a in forced) and not spurious:
                output_alts.append(a)
                mle_counts.append(af.get_allele_count_at_mle(a))
        log10_confidence = (af.log10_prob_only_ref_allele_exists()
                            if not site_is_monomorphic
                            else af.log10_prob_variant_present())
        phred_confidence = -10.0 * log10_confidence + 0.0
        below_threshold = (site_is_monomorphic
                           or phred_confidence < self.cfg.stand_min_conf)
        # forced-calling bypasses the emit threshold
        # (genotyping_engine.rs:162-180 `&& given_alleles_empty`)
        if below_threshold and not given_alleles:
            return None
        if not output_alts and not given_alleles:
            return None

        out_alleles = [vc.reference] + output_alts
        self._record_deletions(vc, out_alleles)
        if len(out_alleles) == 1:
            genotypes = _subset_to_ref_only(vc, self.cfg.ploidy)
        else:
            genotypes = self._subset_and_assign(vc, out_alleles)
        call = VariantContext(vc.tid, vc.start, vc.end, out_alleles, genotypes)
        call.log10_p_error = log10_confidence
        if below_threshold:
            # forced site between thresholds: emit with the LowQual filter
            # (genotyping_engine.rs:196-198 passes_call_threshold)
            call.filters.append("LowQual")
        # QUAL from genotype posteriors when present and requested
        # (genotyping_engine.rs:216-236 use-posteriors-to-calculate-qual)
        if self.cfg.use_posteriors_to_calculate_qual:
            log10_no_var = self._phred_no_variant_posterior(genotypes)
            if log10_no_var is not None and not np.isnan(log10_no_var):
                call.log10_p_error = (
                    log10_no_var if not site_is_monomorphic
                    else log10_one_minus_pow10(log10_no_var))
        an = sum(g.ploidy for g in genotypes if g.alleles)
        call.attributes["MLEAC"] = mle_counts
        call.attributes["MLEAF"] = [min(1.0, c / an) if an else 0.0
                                    for c in mle_counts]
        if self.cfg.annotate_with_num_discovered_alleles:
            # NDA = alt alleles discovered before output subsetting
            # (genotyping_engine.rs:520-526)
            call.attributes["NDA"] = vc.n_alleles - 1
        return call

    @staticmethod
    def _phred_no_variant_posterior(genotypes) -> float | None:
        """Sum over samples of log10 P(hom-ref) from GP attributes
        (genotyping_engine.rs:252-296, non-spanning-deletion arm)."""
        total = None
        for g in genotypes:
            gp = g.attributes.get("GP")
            if gp is None:
                continue
            gp = np.asarray(gp, float)
            from lorikeet_tpu_torch.utils.math import log10_sum_log10
            # the reference clamps in PHRED space (extract_p_no_alt_with
            # _posteriors: reducer = max(0, phred_sum)); for max-normalized
            # posteriors phred_sum <= 0, so the log10 mirror is min(0, sum)
            reducer = min(0.0, log10_sum_log10(gp))
            val = gp[0] - reducer
            total = val if total is None else total + val
        return total

    def _genotype_priors(self, n_alleles: int, out_alleles):
        """Cached per-allele-count log10 genotype priors from the configured
        heterozygosities (genotype_prior_calculator.rs make + assuming_hw;
        resolve_genotype_prior_calculator at
        haplotype_caller_genotyping_engine.rs:284,496)."""
        from lorikeet_tpu_torch.models.genotype_priors import GenotypePriorCalculator
        gpc = getattr(self, "_gpc", None)
        if gpc is None:
            gpc = GenotypePriorCalculator.make(self.cfg.snp_heterozygosity,
                                               self.cfg.indel_heterozygosity)
            self._gpc = gpc
        counts = genotype_count_matrix(self.cfg.ploidy, n_alleles)
        return gpc.log10_priors(counts, out_alleles)

    def _subset_and_assign(self, vc: VariantContext, out_alleles):
        """Subset GLs to the output alleles and assign GT per the configured
        genotype-assignment-method (AlleleSubsettingUtils::subset_alleles,
        genotype_builder.rs:13-31: UsePLsToAssign default; SetToNoCall /
        DoNotAssignGenotypes leave the call empty; BestMatchToOriginal keeps
        prior calls where the allele survived subsetting)."""
        old_idx = [vc.alleles.index(a) for a in out_alleles]
        counts_new = genotype_count_matrix(self.cfg.ploidy, len(out_alleles))
        counts_old = genotype_count_matrix(self.cfg.ploidy, vc.n_alleles)
        # map each new genotype to the old genotype index
        gmap = []
        for row in counts_new:
            old_row = np.zeros(vc.n_alleles, np.int32)
            for new_a, c in enumerate(row):
                old_row[old_idx[new_a]] += c
            gmap.append(int(np.nonzero((counts_old == old_row).all(axis=1))[0][0]))
        gmap = np.array(gmap)

        method = self.cfg.genotype_assignment_method
        out = []
        for g in vc.genotypes:
            gl = g.log10_likelihoods[gmap]
            gl = gl - gl.max()
            gp = None
            if method in ("SetToNoCall", "SetToNoCallNoAnnotations",
                          "DoNotAssignGenotypes"):
                alleles = []
                gq = -1
            elif method == "BestMatchToOriginal":
                # no-call alleles are preserved, everything else not in the
                # subset becomes reference (variant_context.rs:366-378)
                alleles = [a if (a in out_alleles or not a.is_called)
                           else out_alleles[0]
                           for a in g.alleles]
                gq = -1
            elif method == "UsePosteriorProbabilities":
                # GL + HW genotype priors -> normalized posteriors; call by
                # max posterior, GQ from the non-best posterior mass
                # (variant_context.rs make_genotype_call
                # UsePosteriorProbabilities arm + get_gq_log10_from_posteriors)
                priors = self._genotype_priors(len(out_alleles), out_alleles)
                post = priors + gl
                norm = post - post.max()
                best = int(np.argmax(post))
                alleles = [out_alleles[a]
                           for a in np.repeat(np.arange(len(out_alleles)),
                                              counts_new[best])]
                gq_log10 = _gq_log10_from_posteriors(best, norm)
                gq = int(min(99, round(-10.0 * gq_log10)))
                gp = norm
            elif float(gl.sum()) >= SUM_GL_THRESH_NOCALL:
                # UsePLsToAssign with uninformative (near-flat) likelihoods:
                # force a no-call with no GQ (variant_context.rs:326-328
                # is_informative gate)
                alleles = []
                gq = -1
            else:                      # UsePLsToAssign (default)
                best = int(np.argmax(gl))
                alleles = [out_alleles[a]
                           for a in np.repeat(np.arange(len(out_alleles)),
                                              counts_new[best])]
                pls = np.rint(-10.0 * (gl - gl.max())).astype(np.int64)
                sorted_pls = np.sort(pls)
                gq = int(min(99, sorted_pls[1] - sorted_pls[0])) \
                    if len(pls) > 1 else -1
            ng = Genotype(g.sample, g.ploidy, gl, alleles, gq=gq, dp=g.dp)
            if gp is not None:
                # normalized log10 posteriors (GENOTYPE_POSTERIORS_KEY);
                # _phred_no_variant_posterior consumes this convention
                ng.attributes["GP"] = gp
            # subset AD to output alleles
            if g.ad is not None:
                ng.ad = g.ad[old_idx]
            out.append(ng)
        return out


class HaplotypeCallerEngine:
    def __init__(self, cfg: CallerConfig = None):
        self.cfg = cfg or CallerConfig()
        self.genotyping = GenotypingEngine(self.cfg)

    def call_region(
        self,
        ref_window: np.ndarray,       # padded reference bases for the region
        window_start: int,            # genome position of ref_window[0]
        active_start: int,            # active span (genome, inclusive)
        active_end: int,
        reads_by_sample: dict,        # sample -> [BamRecord] overlapping window
        tid: int = 0,
    ) -> list:
        """Returns [VariantContext] called within the active span.
        Single-region wrapper over prepare/compute/genotype; the chunk
        loop batches many regions through one device dispatch
        (call_regions_batched)."""
        work = self.prepare_region(ref_window, window_start, active_start,
                                   active_end, reads_by_sample, tid)
        if work is None:
            return []
        return call_regions_batched(self, [work])[0]

    def prepare_region(
        self, ref_window, window_start, active_start, active_end,
        reads_by_sample, tid=0, given_alleles=None, activity_density=0.0,
        finalized=False,
    ):
        """Host phases up to the pair-HMM: finalize reads, assemble, event
        maps, trim.  Returns a RegionWork or None when nothing to call.
        ``given_alleles`` are feature-VCF contexts overlapping the window;
        their alleles are force-injected as haplotypes
        (assembly_based_caller_utils.rs:376-556).  With ``finalized`` the
        caller already ran the finalize_regions pipeline (the chunk loop
        uses the native columnar finalizer, clipping.py
        finalize_region_reads_columnar).  :meth:`draft_region`, the
        candidates' CIGARs on the host, :meth:`complete_region`."""
        from lorikeet_tpu_torch.utils.cigar import calculate_cigars
        draft = self.draft_region(ref_window, window_start, active_start,
                                  active_end, reads_by_sample, tid,
                                  given_alleles, activity_density, finalized)
        if draft is None:
            return None
        with _prog.substage("assemble"):
            cigars, _ = calculate_cigars(draft.cigar_pairs())
        return self.complete_region(draft, cigars)

    def draft_region(
        self, ref_window, window_start, active_start, active_end,
        reads_by_sample, tid=0, given_alleles=None, activity_density=0.0,
        finalized=False,
    ):
        """:meth:`prepare_region` up to the candidate haplotypes: finalize
        reads, the mapping-quality gate, the graphs and their k-best paths.
        Returns a RegionDraft or None when nothing to call."""
        if not any(reads_by_sample.values()):
            return None
        if not finalized:
            # finalize reads: soft-clip handling, tail/adaptor/region
            # clipping, overlapping mate-pair qual correction
            # (finalize_regions, assembly_based_caller_utils.rs:97)
            from lorikeet_tpu_torch.calling.clipping import finalize_region_reads
            with _prog.substage("finalize"):
                reads_by_sample = finalize_region_reads(
                    reads_by_sample, window_start,
                    window_start + len(ref_window) - 1,
                    min_base_quality=self.cfg.min_base_quality,
                    dont_use_soft_clipped_bases=
                    self.cfg.dont_use_soft_clipped_bases,
                    soft_clip_low_quality_ends=
                    self.cfg.soft_clip_low_quality_ends)
        # second mapq gate before assembly/genotyping
        # (haplotype_caller_engine.rs:1272 filter_non_passing_reads)
        mq_gate = self.cfg.mapping_quality_threshold_for_genotyping
        if mq_gate > 0:
            reads_by_sample = {
                s: [r for r in reads if r.mapq >= mq_gate]
                for s, reads in reads_by_sample.items()}
        if not any(reads_by_sample.values()):
            return None
        # the graph build and its k-best paths (the CIGARs: the caller's)
        with _prog.substage("assemble"):
            ref_bytes, candidates = assemble_candidates(
                ref_window, reads_by_sample,
                kmer_sizes=self.cfg.kmer_sizes,
                min_base_quality=self.cfg.min_base_quality,
                prune_factor=self.cfg.prune_factor,
                disable_prune_correction=self.cfg.disable_prune_factor_correction,
                num_pruning_samples=self.cfg.num_pruning_samples,
                max_paths=self.cfg.max_allowed_path_for_read_threading_assembler,
                use_adaptive_pruning=self.cfg.use_adaptive_pruning,
                initial_error_rate_for_pruning=self.cfg.initial_error_rate_for_pruning,
                pruning_log_odds_threshold=self.cfg.pruning_log_odds_threshold,
                pruning_seeding_log_odds_threshold=self.cfg.pruning_seeding_log_odds_threshold,
                max_unpruned_variants=self.cfg.max_unpruned_variants,
                allow_kmer_extension=not self.cfg.dont_increase_kmer_sizes_for_cycles,
                allow_non_unique_kmers_in_ref=self.cfg.allow_non_unique_kmers_in_ref,
                recover_dangling_branches=self.cfg.recover_dangling_branches,
                recover_all_dangling_branches=self.cfg.recover_all_dangling_branches,
                min_dangling_branch_length=self.cfg.min_dangling_branch_length,
                min_matching_bases=self.cfg.min_matching_bases_to_dangling_end_recovery,
                activity_density=(0.0 if self.cfg.disable_automatic_kmer_adjustment
                                  else activity_density),
                dot_path=self.cfg.graph_output,
                dot_prefix=f"tid{tid}_pos{window_start}_")
        return RegionDraft(ref_window, window_start, active_start, active_end,
                           tid, reads_by_sample, given_alleles, ref_bytes,
                           candidates)

    def complete_region(self, draft, cigars):
        """:meth:`prepare_region` from a RegionDraft and its candidates'
        CIGARs (None: dropped): event maps, trim, the pairs.  Returns a
        RegionWork or None when nothing to call."""
        ref_window, window_start = draft.ref_window, draft.window_start
        active_start, active_end = draft.active_start, draft.active_end
        tid, given_alleles = draft.tid, draft.given_alleles
        reads_by_sample = draft.reads_by_sample
        haplotypes = haplotypes_from_candidates(draft.ref_bytes,
                                                draft.candidates, cigars)
        if len(haplotypes) <= 1 and not given_alleles:
            return None

        with _prog.substage("events"):
            hap_events = [build_event_map(h, ref_window, window_start,
                                          self.cfg.max_mnp_distance)
                          for h in haplotypes]
            if given_alleles:
                from lorikeet_tpu_torch.calling.given_alleles import add_given_haplotypes
                add_given_haplotypes(haplotypes, hap_events, ref_window,
                                     window_start, given_alleles,
                                     self.cfg.max_mnp_distance)
        if given_alleles and len(haplotypes) <= 1:
            return None

        # trim to the variation span before the pair-HMM
        # (assembly_region_trimmer.rs:61-130: snp padding 20, indel 75)
        with _prog.substage("trim"):
            all_events = [vc for ev in hap_events for vc in ev.values()]
            in_active = [vc for vc in all_events
                         if vc.start <= active_end and vc.end >= active_start]
            if not in_active:
                if not self.cfg.disable_optimizations:
                    return None
                # keep the whole window live (haplotype_caller_engine.rs:1227)
                in_active = all_events
                if not in_active:
                    return None
            # per-variant padding: SNPs get snp padding; indels get indel
            # padding, or str padding + the longest tandem-repeat run when the
            # site is repeat-decomposable (assembly_region_trimmer.rs:96-117)
            from lorikeet_tpu_torch.utils.repeats import vc_tandem_repeat_units
            ref_bytes = np.asarray(ref_window, np.uint8).tobytes()

            def _padding(vc):
                if vc.start == vc.end and all(len(a.bases) == 1
                                              for a in vc.alleles
                                              if not a.is_symbolic):
                    return self.cfg.snp_padding_for_genotyping
                repeats = vc_tandem_repeat_units(vc, ref_bytes, window_start)
                if repeats is not None:
                    counts, unit = repeats
                    return (self.cfg.str_padding_for_genotyping
                            + max(counts) * len(unit))
                return self.cfg.indel_padding_for_genotyping

            pad_lo = min(vc.start - _padding(vc) for vc in in_active)
            pad_hi = max(vc.end + _padding(vc) for vc in in_active)
            pad_lo = max(pad_lo, window_start)
            pad_hi = min(pad_hi, window_start + len(ref_window) - 1)
            reads_by_sample = {
                s: [r for r in reads
                    if r.pos <= pad_hi and r.reference_end > pad_lo]
                for s, reads in reads_by_sample.items()}
            if not any(reads_by_sample.values()):
                return None

            # trim haplotypes + reads to the variant span before the pair-HMM
            # (haplotype_caller_engine.rs:1243 trim_to + read-stub removal
            # :1250-1260): shrinks the DP problem to the variation window
            if not self.cfg.dont_trim_active_regions and (
                    pad_lo > window_start
                    or pad_hi < window_start + len(ref_window) - 1):
                trimmed = trim_haplotypes_to_span(haplotypes, pad_lo, pad_hi,
                                                  window_start)
                if trimmed is not None and len(trimmed) > 1:
                    haplotypes = trimmed
                    off = pad_lo - window_start
                    ref_window = ref_window[off:pad_hi - window_start + 1]
                    window_start = pad_lo
                    hap_events = [build_event_map(h, ref_window, window_start,
                                                  self.cfg.max_mnp_distance)
                                  for h in haplotypes]
                    from lorikeet_tpu_torch.calling.clipping import hard_clip_to_region
                    reads_by_sample = {
                        s: [c for c in (hard_clip_to_region(r, pad_lo, pad_hi)
                                        for r in reads)
                            if len(c.seq) >= MINIMUM_READ_LENGTH_AFTER_TRIMMING]
                        for s, reads in reads_by_sample.items()}
                    if not any(reads_by_sample.values()):
                        return None

        from lorikeet_tpu_torch.calling.likelihoods import (PCR_INDEL_MODELS,
                                                      build_pairs)
        with _prog.substage("pairs"):
            pairs, index = build_pairs(
                haplotypes, reads_by_sample,
                pcr_rate_factor=PCR_INDEL_MODELS[self.cfg.pcr_indel_model],
                gcp_value=self.cfg.pair_hmm_gcp,
                base_quality_score_threshold=
                self.cfg.base_quality_score_threshold,
                disable_cap_to_mapq=
                self.cfg.disable_cap_base_qualities_to_map_quality)
        if not pairs:
            return None
        return RegionWork(window_start, active_start, active_end, tid,
                          haplotypes, hap_events, reads_by_sample, pairs,
                          index, given_alleles)

    def genotype_region(self, work, likelihoods) -> list:
        """Device results -> genotyped, annotated, phased calls."""
        haplotypes = work.haplotypes
        hap_events = work.hap_events
        window_start = work.window_start
        active_start, active_end = work.active_start, work.active_end
        tid = work.tid

        # realign evidence to best haplotypes so windows/annotations see
        # haplotype-consistent coordinates
        # (assembly_based_caller_utils.rs:208, haplotype_caller_engine.rs:1348)
        from lorikeet_tpu_torch.calling.realign import realign_reads_to_best_haplotype
        realign_reads_to_best_haplotype(likelihoods, haplotypes, window_start,
                                        use_cuda_sw=self.cfg.use_cuda_sw)

        start_positions = sorted({loc for ev in hap_events for loc in ev})

        emit_span = not self.cfg.disable_spanning_event_genotyping
        margin = self.cfg.allele_informative_reads_overlap_margin
        # per-sample read span arrays (post-realign coordinates): each
        # event's retention window then costs two numpy compares instead
        # of a per-read python predicate
        span_arrays = {}
        for s, reads in likelihoods.reads_by_sample.items():
            span_arrays[s] = (
                np.fromiter((r.pos for r in reads), np.int64, len(reads)),
                np.fromiter((r.reference_end for r in reads), np.int64,
                            len(reads)))
        calls = []
        for loc in start_positions:
            if loc < active_start or loc > active_end:
                continue
            events = events_at_locus(loc, hap_events,
                                     include_spanning=emit_span)
            merged = merge_events(events, loc)
            if merged is None:
                continue
            merged.tid = tid
            mapper = create_allele_mapper(merged, loc, haplotypes, hap_events,
                                          emit_spanning_dels=emit_span)
            allele_lks = likelihoods.marginalize(mapper)
            window_lo = merged.start - margin
            window_hi = merged.end + margin
            allele_lks.retain_evidence_masks(
                {s: (pos_a <= window_hi) & (end_a > window_lo)
                 for s, (pos_a, end_a) in span_arrays.items()})

            genotypes = self._genotypes_for_event(allele_lks, merged)
            merged.genotypes = genotypes
            # subset to the most-likely alts when over the cap
            # (remove_alt_alleles_if_too_many_genotypes,
            #  allele_subsetting_utils.rs:30-160)
            if merged.n_alleles - 1 > self.cfg.max_alt_alleles:
                from lorikeet_tpu_torch.models.allele_subsetting import subset_vc_alleles
                subset_vc_alleles(merged, self.cfg.ploidy,
                                  self.cfg.max_alt_alleles)
            call = self.genotyping.calculate_genotypes(merged,
                                                       work.given_alleles)
            if call is None:
                continue
            self._annotate(call, allele_lks)
            calls.append(call)
        # physical phasing over the region's calls
        # (assembly_based_caller_utils.rs:975 phase_calls;
        #  cli.rs do-not-run-physical-phasing)
        if self.cfg.do_not_run_physical_phasing:
            return calls
        from lorikeet_tpu_torch.calling.phasing import phase_calls
        return phase_calls(calls, hap_events)

    def _genotypes_for_event(self, allele_lks: AlleleLikelihoods,
                             merged: VariantContext):
        genotypes = []
        n_alleles = merged.n_alleles
        for s in allele_lks.samples:
            mat = allele_lks.values[s]            # [A, R]
            gl = genotype_likelihoods_from_read_matrix(mat.T, self.cfg.ploidy)
            # AD: count INFORMATIVE reads best-supporting each allele
            # (DepthPerAlleleBySample, variant_annotation.rs:237-294)
            ad = np.zeros(n_alleles, np.int64)
            best, informative = _informative_best_alleles(mat)
            for b, ok in zip(best, informative):
                if ok:
                    ad[b] += 1
            genotypes.append(Genotype(s, self.cfg.ploidy, gl,
                                      dp=int(mat.shape[1]), ad=ad))
        return genotypes

    def _annotate(self, call: VariantContext, allele_lks: AlleleLikelihoods):
        # retained-evidence counts, kept for the zero-AD depth fallback
        evidence_count = {g.sample: max(g.dp, 0) for g in call.genotypes}
        # per-genotype DP = sum of (informative) AD — the Format-level Depth
        # annotation overwrites dp with total AD
        # (variant_annotation.rs:101-122 Depth/Format: genotype.dp=total_ad)
        for g in call.genotypes:
            if g.ad is not None:
                g.dp = int(np.sum(g.ad))
        depth = sum(max(g.dp, 0) for g in call.genotypes)
        call.attributes["DP"] = depth
        an = sum(g.ploidy for g in call.genotypes if g.alleles)
        acs = []
        for alt in call.alternate_alleles:
            ac = sum(sum(1 for a in g.alleles if a == alt) for g in call.genotypes)
            acs.append(ac)
        call.attributes["AC"] = acs
        call.attributes["AN"] = an
        call.attributes["AF"] = [round(c / an, 4) if an else 0.0 for c in acs]
        # QD denominator (variant_annotation.rs:360-405 get_depth): over
        # CALLED genotypes, sum total AD (falling back to the retained
        # evidence count when total AD is zero); restrict to samples with
        # alt-supporting AD when any exist
        qd_depth = 0
        ad_restrict = 0
        for g in call.genotypes:
            if not g.alleles:          # no-calls are skipped
                continue
            total_ad = int(np.sum(g.ad)) if g.ad is not None else 0
            if total_ad != 0:
                if total_ad - int(g.ad[0]) > 0:
                    ad_restrict += total_ad
                qd_depth += total_ad
            else:
                qd_depth += evidence_count.get(g.sample, 0)
        if ad_restrict > 0:
            qd_depth = ad_restrict
        if qd_depth > 0:
            qd = call.phred_scaled_qual / qd_depth
            if qd >= MAX_QD_BEFORE_FIXING:
                qd = IDEAL_HIGH_QD          # deterministic (no jitter)
            call.attributes["QD"] = round(qd, 2)
        # MQ and BQ (both Number=R): per-allele MEDIAN over informative,
        # mapq!=0, best-allele-assigned reads, default 30 for alleles with
        # no usable reads (variant_annotation.rs:188-236; is_usable_read
        # :356-358; MQ value = read mapq :346, BQ value = base quality at
        # the site :347 via get_read_base_quality_at_reference_coordinate).
        # The reference's MQ header says "RMS" but the statistic it stores
        # is this median — the description string is wrong upstream.
        from lorikeet_tpu_torch.utils.cigar import read_offset_at
        quals_by_allele = {}
        mapqs_by_allele = {}
        for s in allele_lks.samples:
            mat = allele_lks.values[s]
            reads = allele_lks.reads_by_sample[s]
            if not mat.shape[1] or not reads:
                continue
            best, ok = _informative_best_alleles(mat)
            for r_idx, rec in enumerate(reads):
                if r_idx >= len(ok) or not ok[r_idx] or rec.mapq == 0:
                    continue
                mapqs_by_allele.setdefault(
                    int(best[r_idx]), []).append(int(rec.mapq))
                off = read_offset_at(call.start, rec.pos, rec.cigar)
                if off is not None and off < len(rec.qual):
                    quals_by_allele.setdefault(
                        int(best[r_idx]), []).append(int(rec.qual[off]))
        lk_alleles = list(allele_lks.alleles)
        bq, mq = [], []
        for a in call.alleles:
            try:
                a_idx = lk_alleles.index(a)
            except ValueError:
                a_idx = -1
            # upper median (math_utils.rs:41-45: sorted[len/2]), not the
            # even-length average
            q = sorted(quals_by_allele.get(a_idx, []))
            m = sorted(mapqs_by_allele.get(a_idx, []))
            bq.append(q[len(q) // 2] if q else 30)
            mq.append(m[len(m) // 2] if m else 30)
        call.attributes["BQ"] = bq
        call.attributes["MQ"] = mq
        # QF: variant qualifies for ANI analyses
        # (variant_context_utils.rs:99-148 check_thresholds: QD >= filter
        #  and QUAL >= qual-threshold, default 150 -> log10_p_error <= -15;
        #  lorikeet_engine.rs:447 qual_filter = qual-threshold / -10)
        qd_val = call.attributes.get("QD")
        qualified = (qd_val is not None
                     and float(qd_val) >= self.cfg.qual_by_depth_filter
                     and call.log10_p_error <= self.cfg.qual_threshold / -10.0)
        call.attributes["QF"] = "true" if qualified else "false"
