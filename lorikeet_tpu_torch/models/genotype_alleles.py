"""Canonical genotype enumeration and genotype-likelihood math.

Replaces the reference's lazy linked GenotypeAlleleCounts machinery
(reference/src/genotype/genotype_allele_counts.rs,
genotype_likelihood_calculator.rs) with dense count matrices: for a given
(ploidy, allele_count) the genotypes are a [G, A] integer matrix in VCF
canonical order, and every downstream computation (combination counts,
read-matrix GLs, allele-absence masks, subset index maps) is a vectorized
operation over it — the shape a device path can consume directly.

GL semantics contract (genotype_likelihood_calculator.rs:308-470):
  GL[g] = sum_r approx_log10_sum_log10_vec_{a in g}(L[r,a] + log10 c_{g,a})
          - R * log10(ploidy)
using the Jacobian-table approximate log10-sum in allele-index order.
"""
from __future__ import annotations

import functools
import math

import numpy as np

from lorikeet_tpu_torch.utils.math import (
    _JACOBIAN_CACHE, _JACOBIAN_INV_STEP, _JACOBIAN_MAX_TOLERANCE,
)


@functools.lru_cache(maxsize=None)
def genotype_count_matrix(ploidy: int, n_alleles: int) -> np.ndarray:
    """[G, A] allele-count matrix in VCF canonical genotype order.

    VCF order: genotype (a1<=...<=aP) sorted by aP, then recursively on the
    remainder (e.g. P=2, A=3: 0/0, 0/1, 1/1, 0/2, 1/2, 2/2).
    """
    def gen(p, a_max):
        if p == 0:
            yield ()
            return
        for top in range(a_max):
            for rest in gen(p - 1, top + 1):
                yield rest + (top,)

    genotypes = list(gen(ploidy, n_alleles))
    counts = np.zeros((len(genotypes), n_alleles), np.int32)
    for g, alleles in enumerate(genotypes):
        for a in alleles:
            counts[g, a] += 1
    counts.setflags(write=False)
    return counts


def genotype_count(ploidy: int, n_alleles: int) -> int:
    return math.comb(ploidy + n_alleles - 1, n_alleles - 1)


@functools.lru_cache(maxsize=None)
def log10_combination_counts(ploidy: int, n_alleles: int) -> np.ndarray:
    """log10(ploidy! / prod(c_i!)) per genotype (genotype_allele_counts.rs:164)."""
    counts = genotype_count_matrix(ploidy, n_alleles)
    lg_fact = np.array([math.lgamma(k + 1) for k in range(ploidy + 1)]) / np.log(10)
    out = lg_fact[ploidy] - lg_fact[counts].sum(axis=1)
    out.setflags(write=False)
    return out


def genotype_index(ploidy: int, n_alleles: int, allele_multiset) -> int:
    """Index of a genotype (iterable of allele indices) in canonical order."""
    counts = genotype_count_matrix(ploidy, n_alleles)
    target = np.zeros(n_alleles, np.int32)
    for a in allele_multiset:
        target[a] += 1
    hits = np.nonzero((counts == target).all(axis=1))[0]
    return int(hits[0])


def approx_log10_sum_log10_vec(vals: np.ndarray, axis: int = -1) -> np.ndarray:
    """Vectorized Jacobian-table anchored log10-sum (math_utils.rs:344).

    Anchors at the max element, then folds the remaining elements IN ARRAY
    ORDER into the running sum via table lookup — sequential in the reduced
    axis (small: n_alleles), vectorized everywhere else.
    """
    vals = np.asarray(vals, np.float64)
    vals = np.moveaxis(vals, axis, 0)
    n = vals.shape[0]
    max_idx = np.argmax(vals, axis=0)
    approx = np.max(vals, axis=0)
    for i in range(n):
        v = vals[i]
        skip = (max_idx == i) | np.isneginf(v)
        diff = approx - v
        in_table = (diff < _JACOBIAN_MAX_TOLERANCE) & ~skip
        idx = np.rint(np.where(in_table, diff, 0.0) * _JACOBIAN_INV_STEP).astype(np.int64)
        approx = approx + np.where(in_table, _JACOBIAN_CACHE[idx], 0.0)
    return approx


def genotype_likelihoods_from_read_matrix(L: np.ndarray, ploidy: int) -> np.ndarray:
    """GLs [G] (log10) from a read x allele log10-likelihood matrix [R, A].

    Matches genotype_likelihood_calculator.rs:308-616: per read, combine the
    alleles present in the genotype with the Jacobian-table sum of
    L[r, a] + log10(count); total = sum over reads - R*log10(ploidy).
    """
    L = np.asarray(L, np.float64)
    R, A = L.shape
    counts = genotype_count_matrix(ploidy, A)
    G = counts.shape[0]
    out = np.zeros(G)
    if R == 0:
        return out
    log10_counts = np.where(counts > 0, np.log10(np.maximum(counts, 1)), -np.inf)
    for g in range(G):
        present = np.nonzero(counts[g])[0]
        if present.size == 1:
            per_read = L[:, present[0]] + log10_counts[g, present[0]]
        else:
            comps = L[:, present] + log10_counts[g, present][None, :]
            per_read = approx_log10_sum_log10_vec(comps, axis=1)
        out[g] = per_read.sum()
    return out - R * np.log10(ploidy)


def genotype_index_map(ploidy: int, new_to_old_allele: np.ndarray, old_n_alleles: int) -> np.ndarray:
    """For allele subsetting: index into the OLD genotype array for each NEW
    genotype (genotype_likelihood_calculator.rs:683 semantics)."""
    new_n = len(new_to_old_allele)
    new_counts = genotype_count_matrix(ploidy, new_n)
    old_counts = genotype_count_matrix(ploidy, old_n_alleles)
    out = np.zeros(new_counts.shape[0], np.int64)
    for g, row in enumerate(new_counts):
        old_row = np.zeros(old_n_alleles, np.int32)
        for new_a, c in enumerate(row):
            old_row[new_to_old_allele[new_a]] += c
        hits = np.nonzero((old_counts == old_row).all(axis=1))[0]
        out[g] = hits[0]
    return out
