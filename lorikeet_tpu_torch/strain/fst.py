"""Hudson Fst between sample pairs, in-process.

Contract: reference/src/model/fst_calculator.rs:4-104 — the reference
embeds a Python script (pyo3 + scikit-allel) computing per-variant Hudson
Fst from the AD arrays of QD-qualified sites with per-sample depth >= 5,
means over variants (NaN->0, clipped to [0,1]) into a sample x sample
matrix written as {genome}_sample_fst_values.tsv.  Here the same estimator
(Bhatia et al. 2013, as in allel.hudson_fst) runs natively in numpy.
"""
from __future__ import annotations

import os

import numpy as np

from lorikeet_tpu_torch.strain.ani import site_passes

DEPTH_PER_SAMPLE_FILTER = 5


def hudson_fst_per_variant(ac1: np.ndarray, ac2: np.ndarray):
    """(num, den) per variant from allele-count matrices [variants, alleles]
    (allel.hudson_fst semantics)."""
    an1 = ac1.sum(axis=1)
    an2 = ac2.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        p1 = ac1 / an1[:, None]
        p2 = ac2 / an2[:, None]
        num = ((p1 - p2) ** 2
               - p1 * (1 - p1) / (an1[:, None] - 1)
               - p2 * (1 - p2) / (an2[:, None] - 1)).sum(axis=1)
        den = (p1 * (1 - p2) + p2 * (1 - p1)).sum(axis=1)
    return num, den


def calculate_fst(contexts, n_samples: int,
                  depth_filter: int = DEPTH_PER_SAMPLE_FILTER) -> np.ndarray:
    """Mean pairwise Hudson Fst matrix [samples, samples]."""
    qualified = [vc for vc in contexts if site_passes(vc)]
    out = np.zeros((n_samples, n_samples))
    if not qualified:
        return out
    max_alleles = max(vc.n_alleles for vc in qualified)
    ads = np.zeros((len(qualified), n_samples, max_alleles))
    dps = np.zeros((len(qualified), n_samples))
    for v, vc in enumerate(qualified):
        for s, g in enumerate(vc.genotypes[:n_samples]):
            if g.ad is not None:
                ad = np.asarray(g.ad, np.float64)
                ads[v, s, :len(ad)] = ad
            dps[v, s] = max(g.dp, 0)
    for s1 in range(n_samples):
        for s2 in range(s1 + 1, n_samples):
            include = (dps[:, s1] >= depth_filter) & (dps[:, s2] >= depth_filter)
            if not include.any():
                continue
            num, den = hudson_fst_per_variant(ads[include, s1, :],
                                              ads[include, s2, :])
            with np.errstate(invalid="ignore", divide="ignore"):
                fst = num / den
            fst = np.nan_to_num(fst, nan=0.0)
            fst = np.clip(fst, 0.0, 1.0)
            out[s1, s2] = out[s2, s1] = float(fst.mean())
    return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


def write_fst(contexts, n_samples: int, sample_names, output_dir: str,
              genome_name: str,
              depth_filter: int = DEPTH_PER_SAMPLE_FILTER) -> str:
    os.makedirs(output_dir, exist_ok=True)
    mat = calculate_fst(contexts, n_samples, depth_filter=depth_filter)
    path = os.path.join(output_dir, f"{genome_name}_sample_fst_values.tsv")
    with open(path, "w") as out:
        out.write("SampleID\t" + "\t".join(sample_names) + "\n")
        for i, name in enumerate(sample_names):
            out.write(name + "\t"
                      + "\t".join(f"{mat[i, j]:.6f}" for j in range(n_samples))
                      + "\n")
    return path
