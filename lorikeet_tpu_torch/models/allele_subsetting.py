"""Allele subsetting: reduce a site to its most-likely alt alleles.

Contract: reference/src/model/allele_subsetting_utils.rs —
calculate_likelihood_sums (:107-147: each sample's best-genotype
likelihood gap vs hom-ref is credited to the alt alleles in that
genotype), filter_to_max_number_of_alt_alleles_based_on_scores (:66-105:
keep the top-k alts, preserving allele order), and subsetted PL/AD
remapping (:161-310) via the genotype index map.  Used when a merged site
carries more alts than --max-alt-alleles
(haplotype_caller_genotyping_engine.rs:572 remove_alt_alleles_if_too_many_
genotypes role).
"""
from __future__ import annotations

import numpy as np

from lorikeet_tpu_torch.models.genotype_alleles import (
    genotype_count_matrix, genotype_index_map,
)


def calculate_likelihood_sums(genotypes, ploidy: int,
                              n_alleles: int) -> np.ndarray:
    sums = np.zeros(n_alleles)
    # a genotype WITHOUT likelihoods forces all_hom_ref false
    # (allele_subsetting_utils.rs:38-44)
    all_hom_ref = bool(genotypes) and all(
        g.has_likelihoods() and int(np.argmax(g.log10_likelihoods)) == 0
        for g in genotypes)
    counts_by_ploidy = {}
    for g in genotypes:
        if not g.has_likelihoods():
            continue
        # each genotype's own ploidy keys its allele-count table, falling
        # back to the site ploidy only when 0 (:128-139)
        p = g.ploidy if g.ploidy and g.ploidy > 0 else ploidy
        counts = counts_by_ploidy.setdefault(
            p, genotype_count_matrix(p, n_alleles))
        gls = np.asarray(g.log10_likelihoods)
        start = 1 if all_hom_ref else 0
        best = start + int(np.argmax(gls[start:]))
        if best >= len(counts):
            continue
        diff = abs(float(gls[best] - gls[0]))
        for a in range(1, n_alleles):
            if counts[best, a] > 0:
                sums[a] += diff
    return sums


def subset_vc_alleles(vc, ploidy: int, max_alt_alleles: int):
    """Returns vc mutated in place to its best `max_alt_alleles` alts with
    PLs and ADs remapped; no-op when already within the cap."""
    n = vc.n_alleles
    if n - 1 <= max_alt_alleles:
        return vc
    sums = calculate_likelihood_sums(vc.genotypes, ploidy, n)
    # keep ref + top-k alts, preserving original order
    alt_order = sorted(range(1, n), key=lambda a: -sums[a])
    keep = sorted([0] + alt_order[:max_alt_alleles])
    keep_arr = np.asarray(keep)

    gmap = genotype_index_map(ploidy, keep_arr, n)
    for g in vc.genotypes:
        if g.has_likelihoods():
            gls = np.asarray(g.log10_likelihoods)[gmap]
            g.log10_likelihoods = gls - gls.max()
        if g.ad is not None and len(g.ad) == n:
            g.ad = np.asarray(g.ad)[keep_arr]
    vc.alleles = [vc.alleles[i] for i in keep]
    return vc
