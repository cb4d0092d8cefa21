"""Allele-frequency calculation (GATK-style Dirichlet EM).

Numerics contract: reference/src/model/allele_frequency_calculator.rs
:198-379 (EM over effective allele counts with Dirichlet mean weights,
convergence threshold 0.01) and :77-141 (per-genotype log10 posteriors =
log10 combination count + GL + sum count*log10(freq), normalized).

All per-genotype work is dense over the [G, A] count matrix; per-sample loops
remain (samples are few), position-level vectorization lives in
models/activity.py's specialized biallelic path.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lorikeet_tpu_torch.models.genotype_alleles import (
    genotype_count_matrix, log10_combination_counts,
)
from lorikeet_tpu_torch.models.variants import SPAN_DEL_ALLELE, VariantContext
from lorikeet_tpu_torch.utils.math import log10_sum_log10, normalize_log10

THRESHOLD_FOR_ALLELE_COUNT_CONVERGENCE = 0.01
HOM_REF_GENOTYPE_INDEX = 0
TYPICAL_BASE_QUALITY = 30
PLOIDY_2_HOM_VAR_SCALE_FACTOR = int(round(TYPICAL_BASE_QUALITY / -10.0 / np.log10(0.5)))


@dataclass
class AFCalculationResult:
    """allele_frequency_calculator_result.rs: MLE alt counts + posteriors."""
    alt_allele_counts: np.ndarray          # [n_alts] int
    alleles: list                          # all alleles incl ref
    log10_p_no_variant: float
    log10_p_ref_by_allele: dict            # alt allele -> log10 p(absent)

    def log10_prob_only_ref_allele_exists(self) -> float:
        return self.log10_p_no_variant

    def log10_prob_variant_present(self) -> float:
        from lorikeet_tpu_torch.utils.math import log10_one_minus_pow10
        return log10_one_minus_pow10(min(0.0, self.log10_p_no_variant))

    EPSILON = 1.0e-10

    def passes_threshold(self, allele, phred_qual_threshold: float) -> bool:
        # allele_frequency_calculator_result.rs:115-122
        return (self.log10_p_ref_by_allele[allele] + self.EPSILON
                < phred_qual_threshold * -0.1)

    def get_allele_count_at_mle(self, allele) -> int:
        for a, c in zip([x for x in self.alleles if not x.is_ref],
                        self.alt_allele_counts):
            if a == allele:
                return int(c)
        raise KeyError(allele)


class AlleleFrequencyCalculator:
    def __init__(self, ref_pseudo_count: float, snp_pseudo_count: float,
                 indel_pseudo_count: float, default_ploidy: int):
        self.ref_pseudo_count = ref_pseudo_count
        self.snp_pseudo_count = snp_pseudo_count
        self.indel_pseudo_count = indel_pseudo_count
        self.default_ploidy = default_ploidy

    @classmethod
    def make_calculator(cls, snp_heterozygosity: float = 0.001,
                        indel_heterozygosity: float = 0.000125,
                        heterozygosity_stdev: float = 0.01,
                        ploidy: int = 2) -> "AlleleFrequencyCalculator":
        ref_pseudo = snp_heterozygosity / heterozygosity_stdev ** 2
        return cls(ref_pseudo, snp_heterozygosity * ref_pseudo,
                   indel_heterozygosity * ref_pseudo, ploidy)

    # ------------------------------------------------------------------
    def _log10_normalized_genotype_posteriors(self, g, log10_allele_frequencies):
        n_alleles = len(log10_allele_frequencies)
        ploidy = g.ploidy if g.ploidy and g.ploidy > 0 else self.default_ploidy
        if g.has_likelihoods():
            log10_likelihoods = np.asarray(g.log10_likelihoods, np.float64)
        elif ploidy == 2 and g.gq is not None and g.gq >= 0 and (
                not g.alleles or all(a.is_ref for a in g.alleles)):
            # GQ-only hom-ref/no-call: approximate PLs [0, GQ, SCALE*GQ]
            # with every alt mapped to the biallelic alt
            # (allele_frequency_calculator.rs:85-121)
            counts2 = genotype_count_matrix(2, n_alleles)
            approx = np.array([0.0, float(g.gq),
                               PLOIDY_2_HOM_VAR_SCALE_FACTOR * float(g.gq)])
            idx = (2 - counts2[:, 0]).astype(np.int64)
            log10_likelihoods = approx[idx] / -10.0
        else:
            raise ValueError("genotype lacks likelihoods for AF calculation")
        counts = genotype_count_matrix(ploidy, n_alleles)
        log10_posteriors = (
            log10_combination_counts(ploidy, n_alleles)
            + log10_likelihoods
            + counts @ np.asarray(log10_allele_frequencies)
        )
        return normalize_log10(log10_posteriors, True)

    def _effective_allele_counts(self, vc: VariantContext, log10_allele_frequencies):
        n_alleles = vc.n_alleles
        log10_result = np.full(n_alleles, -np.inf)
        for g in vc.genotypes:
            if not g.usable_for_af_calculation():
                continue
            ploidy = g.ploidy if g.ploidy and g.ploidy > 0 \
                else self.default_ploidy
            counts = genotype_count_matrix(ploidy, n_alleles)
            log10_posteriors = self._log10_normalized_genotype_posteriors(
                g, log10_allele_frequencies)
            # log10 sum over genotypes of posterior * count, per allele
            with np.errstate(divide="ignore"):
                log10_counts = np.where(counts > 0,
                                        np.log10(np.maximum(counts, 1)), -np.inf)
            terms = log10_posteriors[:, None] + log10_counts  # [G, A]
            stacked = np.concatenate([log10_result[None, :], terms], axis=0)
            m = stacked.max(axis=0)
            safe_m = np.where(np.isneginf(m), 0.0, m)
            log10_result = safe_m + np.log10(
                np.sum(10.0 ** (stacked - safe_m[None, :]), axis=0))
            log10_result = np.where(np.isneginf(m), -np.inf, log10_result)
        return 10.0 ** log10_result

    def calculate_single_sample_biallelic_non_ref_posterior(
            self, log10_genotype_likelihoods,
            return_zero_if_ref_is_max: bool = False) -> float:
        """Posterior that a single biallelic genotype is non-ref; the nth
        entry holds n copies of the alt allele
        (calculate_single_sample_biallelic_non_ref_posterior,
        allele_frequency_calculator.rs:149-189)."""
        from math import lgamma

        gl = np.asarray(log10_genotype_likelihoods, float)
        if return_zero_if_ref_is_max and int(np.argmax(gl)) == 0:
            return 0.0
        ploidy = len(gl) - 1
        n = np.arange(ploidy + 1)
        log10_binom = np.array(
            [(lgamma(ploidy + 1) - lgamma(k + 1) - lgamma(ploidy - k + 1))
             / np.log(10) for k in n])
        log10_dirichlet = np.array(
            [(lgamma(k + self.snp_pseudo_count)
              + lgamma(ploidy - k + self.ref_pseudo_count)) / np.log(10)
             for k in n])
        unnorm = gl + log10_binom + log10_dirichlet
        if return_zero_if_ref_is_max and int(np.argmax(unnorm)) == 0:
            return 0.0
        m = unnorm.max()
        lin = 10.0 ** (unnorm - m)
        return 1.0 - float(lin[0] / lin.sum())

    def calculate(self, vc: VariantContext, default_ploidy: int | None = None
                  ) -> AFCalculationResult:
        if default_ploidy is None:
            default_ploidy = self.default_ploidy
        n_alleles = vc.n_alleles
        alleles = vc.alleles
        assert n_alleles > 1
        ref_len = len(vc.reference)
        prior_pseudo = np.array([
            self.ref_pseudo_count if a.is_ref
            else (self.snp_pseudo_count if len(a) == ref_len
                  else self.indel_pseudo_count)
            for a in alleles])

        allele_counts = np.zeros(n_alleles)
        log10_af = np.full(n_alleles, -np.log10(n_alleles))
        max_diff = np.inf
        while max_diff > THRESHOLD_FOR_ALLELE_COUNT_CONVERGENCE:
            new_counts = self._effective_allele_counts(vc, log10_af)
            max_diff = np.abs(allele_counts - new_counts).max()
            allele_counts = new_counts
            posterior_pseudo = prior_pseudo + allele_counts
            log10_af = np.log10(posterior_pseudo / posterior_pseudo.sum())

        log10_p_zero_by_allele = np.zeros(n_alleles)
        log10_p_no_variant = 0.0
        spanning_del = any(a == SPAN_DEL_ALLELE for a in alleles)

        for g in vc.genotypes:
            if not g.usable_for_af_calculation():
                continue
            ploidy = g.ploidy if g.ploidy else default_ploidy
            counts = genotype_count_matrix(ploidy, n_alleles)
            log10_posteriors = self._log10_normalized_genotype_posteriors(g, log10_af)

            if not spanning_del:
                log10_p_no_variant += log10_posteriors[HOM_REF_GENOTYPE_INDEX]
            else:
                span_idx = next(i for i, a in enumerate(alleles) if a == SPAN_DEL_ALLELE)
                nonvar = (counts[:, [i for i in range(n_alleles)
                                     if i not in (0, span_idx)]].sum(axis=1) == 0)
                log10_p_no_variant += min(0.0, log10_sum_log10(log10_posteriors[nonvar]))

            if n_alleles == 2 and not spanning_del:
                continue

            absent = counts == 0  # [G, A]
            for a in range(n_alleles):
                vals = log10_posteriors[absent[:, a]]
                log10_p_zero_by_allele[a] += min(0.0, log10_sum_log10(vals)) \
                    if vals.size else 0.0

        if n_alleles == 2 and not spanning_del:
            log10_p_zero_by_allele[1] = log10_p_no_variant

        int_counts = np.rint(allele_counts).astype(np.int64)
        alt_idx = [i for i, a in enumerate(alleles) if not a.is_ref]
        return AFCalculationResult(
            alt_allele_counts=int_counts[alt_idx],
            alleles=list(alleles),
            log10_p_no_variant=log10_p_no_variant,
            log10_p_ref_by_allele={alleles[i]: log10_p_zero_by_allele[i]
                                   for i in alt_idx},
        )
