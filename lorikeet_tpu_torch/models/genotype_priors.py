"""Genotype prior probabilities from heterozygosity assumptions.

Mirrors the reference's GenotypePriorCalculator
(src/genotype/genotype_prior_calculator.rs:45-230): per-allele-type log10
het/hom prior values (SNP priors normalized by the 3 possible substitution
targets), combined per genotype over its allele counts; used by the
UsePosteriorProbabilities genotype-assignment method
(src/model/variant_context.rs make_genotype_call)."""
import math

import numpy as np

LOG10_SNP_NORMALIZATION_CONSTANT = math.log10(3.0)

REF, SNP, INDEL, OTHER = range(4)


def classify_allele_types(alleles) -> list:
    """AlleleType per allele (genotype_prior_calculator.rs:199-230:
    calculate_allele_types); symbolic alleles (spanning deletions) fall in
    OTHER rather than panicking."""
    ref = alleles[0]
    if not ref.is_ref:
        raise ValueError("the first allele must be the reference")
    out = []
    for a in alleles:
        if a.is_ref:
            out.append(REF)
        elif a.is_called and not a.is_symbolic:
            out.append(SNP if len(a) == len(ref) else INDEL)
        else:
            out.append(OTHER)
    return out


class GenotypePriorCalculator:
    def __init__(self, snp_het, snp_hom, indel_het, indel_hom,
                 other_het, other_hom):
        """All arguments are log10 heterozygosities/homozygosities
        (genotype_prior_calculator.rs:46-81)."""
        het = np.zeros(4)
        hom = np.zeros(4)
        het[SNP] = snp_het - LOG10_SNP_NORMALIZATION_CONSTANT
        hom[SNP] = snp_hom - LOG10_SNP_NORMALIZATION_CONSTANT
        het[INDEL] = indel_het
        hom[INDEL] = indel_hom
        het[OTHER] = other_het
        hom[OTHER] = other_hom
        self.het_values = het
        self.hom_values = hom
        self.diff_values = hom - het

    @classmethod
    def assuming_hw(cls, snp_het_log10: float, indel_het_log10: float,
                    other_het_log10: float = None):
        """Hardy-Weinberg: hom priors are het squared
        (genotype_prior_calculator.rs:111-140 assuming_hw)."""
        if other_het_log10 is None:
            other_het_log10 = max(snp_het_log10, indel_het_log10)
        return cls(snp_het_log10, snp_het_log10 * 2.0,
                   indel_het_log10, indel_het_log10 * 2.0,
                   other_het_log10, other_het_log10 * 2.0)

    @classmethod
    def given_het_to_hom_ratio(cls, snp_het_log10, indel_het_log10,
                               other_het_log10, het_hom_ratio):
        """(genotype_prior_calculator.rs:84-109)."""
        r = math.log10(het_hom_ratio)
        return cls(snp_het_log10, snp_het_log10 - r,
                   indel_het_log10, indel_het_log10 - r,
                   other_het_log10, other_het_log10 - r)

    @classmethod
    def make(cls, snp_heterozygosity: float, indel_heterozygosity: float):
        """From linear heterozygosities, as the CLI does
        (genotype_prior_calculator.rs:142-152 make)."""
        return cls.assuming_hw(math.log10(snp_heterozygosity),
                               math.log10(indel_heterozygosity))

    def log10_priors(self, genotype_counts: np.ndarray, alleles) -> np.ndarray:
        """Per-genotype log10 priors for the canonical genotype table
        `genotype_counts` ([G, A] allele-count rows; the hom-ref genotype
        keeps prior 0 by convention)
        (genotype_prior_calculator.rs:154-197 get_log10_priors)."""
        types = classify_allele_types(alleles)
        out = np.zeros(len(genotype_counts))
        for g in range(1, len(genotype_counts)):
            total = 0.0
            for idx, cnt in enumerate(genotype_counts[g]):
                if cnt == 0:
                    continue
                t = types[idx]
                if cnt == 2:
                    total += self.hom_values[t]
                else:
                    total += (self.het_values[t]
                              + self.diff_values[t] * (cnt - 1))
            out[g] = total
        return out
