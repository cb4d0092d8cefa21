"""`genotype` mode: strain resolution via clustering + abundance EM.

Contracts:
- variant_context_utils.rs:607 split_contexts (one context per alt allele,
  QD-qualified sites);
- haplotype_clustering_engine.rs:63-270: cluster variant depth profiles into
  variant groups, tag VariantGroup, then derive strains.  The reference
  shells out to the external Python tool `flight` (UMAP + HDBSCAN); here
  clustering runs fully in-process: a seeded UMAP embedding
  (lorikeet_tpu.strain.umap, no subprocess/file IPC) followed by HDBSCAN
  (the port's numpy counterpart of scikit-learn's, strain/hdbscan.py);
- linkage_engine.rs:73-1202 groups variant groups into strains via
  co-occurrence; round-1 strains = variant groups plus the reference strain
  heuristic (abundance_calculator_engine.rs:485);
- abundance EM: strain_abundances_calculator.rs:38-155 (centrifuge-style EM:
  variant weights <- theta-pooled reweighting, theta <- weight mass /
  total), with per-sample *_strain_coverages.tsv output
  (abundance_calculator_engine.rs:379-439).
"""
from __future__ import annotations

import os
import time

import numpy as np

from lorikeet_tpu_torch.io.fasta import FastaReader
from lorikeet_tpu_torch.io.vcf import read_vcf
from lorikeet_tpu_torch.models.variants import Allele, Genotype, VariantContext
from lorikeet_tpu_torch.strain.ani import site_passes
from lorikeet_tpu_torch.strain.consensus import _write_fasta
from lorikeet_tpu_torch.utils.progress import add_span, global_stage


def split_contexts(contexts, qual_by_depth_filter=25.0,
                   min_variant_depth: int = 10):
    """(split, filtered): one context per alt allele for qualifying sites,
    dropping alleles whose summed alt depth across samples is below
    min-variant-depth-for-genotyping; non-qualifying sites are returned in
    ``filtered`` so the genotype-mode VCF keeps every call
    (variant_context_utils.rs:607-724, lorikeet_engine.rs:628
    split_contexts.extend(filtered_contexts)).  A qualifying biallelic
    site below min-variant-depth is dropped, as there.  A qualifying
    multi-allelic site none of whose alleles is kept goes to ``filtered``
    whole: a multi-allelic site carries a sample's alt depth into its
    split only at GQ 100 or more, which the genotyper's GQ (capped at 99,
    calling/engine.py) never reaches, so without this every multi-allelic
    call vanished from the genotype-mode VCF (the JAX package drops it)."""
    out = []
    filtered = []
    for vc in contexts:
        # a site with no QD annotation at all is filtered outright
        # (variant_context_utils.rs:719-721 None => filtered)
        if "QD" not in vc.attributes and "QF" not in vc.attributes:
            filtered.append(vc)
            continue
        if not site_passes(vc, qual_by_depth_filter):
            filtered.append(vc)
            continue
        alts = vc.alternate_alleles
        if len(alts) == 1:
            # biallelic: kept whole, genotypes untouched
            # (variant_context_utils.rs:630-640)
            variant_depth = sum(
                int(g.ad[1]) for g in vc.genotypes
                if g.ad is not None and len(g.ad) > 1)
            if variant_depth >= min_variant_depth:
                vc.attributes.setdefault("_ALT_INDEX", 1)
                out.append(vc)
            continue
        n_split = len(out)
        for ai, alt in enumerate(alts, start=1):
            # multiallelic: rebuild 2-allele genotypes per alt; only
            # confident samples (GQ >= 100) carry their alt depth/PL into
            # the split, others are zeroed (variant_context_utils.rs:644-688)
            new_gts = []
            new_depth = 0
            variant_depth = 0
            for g in vc.genotypes:
                old_ad = np.asarray(g.ad) if g.ad is not None \
                    else np.zeros(vc.n_alleles, np.int64)
                gl = g.log10_likelihoods
                if g.gq is not None and g.gq >= 100 and ai < len(old_ad):
                    ad = np.array([old_ad[0], old_ad[ai]], np.int64)
                    new_gl = (np.array([gl[0], gl[ai]])
                              if gl is not None and ai < len(gl) else None)
                    new_depth += int(ad.sum())
                    variant_depth += int(ad[1])
                    ng = Genotype(g.sample, g.ploidy, new_gl,
                                  [vc.reference, alt], gq=g.gq, dp=g.dp,
                                  ad=ad)
                else:
                    ad = np.array([old_ad[0], 0], np.int64)
                    new_gl = (np.array([gl[0], 0.0])
                              if gl is not None and len(gl) else None)
                    ng = Genotype(g.sample, g.ploidy, new_gl,
                                  [vc.reference, alt], gq=-1,
                                  dp=int(old_ad[0]), ad=ad)
                new_gts.append(ng)
            if variant_depth < min_variant_depth:
                continue
            split = VariantContext(vc.tid, vc.start, vc.end,
                                   [vc.reference, alt], new_gts)
            split.log10_p_error = vc.log10_p_error
            split.attributes = dict(vc.attributes)
            split.attributes["DP"] = new_depth
            split.attributes["_ALT_INDEX"] = 1
            out.append(split)
        if len(out) == n_split:
            filtered.append(vc)
    return out, filtered


def depth_matrix(contexts) -> np.ndarray:
    """[variants, samples] alt-allele depth fractions (the clustering input
    the reference writes to .npy for flight)."""
    rows = []
    for vc in contexts:
        ai = vc.attributes.get("_ALT_INDEX", 1)
        row = []
        for g in vc.genotypes:
            ad = np.asarray(g.ad) if g.ad is not None else np.zeros(2)
            total = ad.sum()
            frac = ad[ai] / total if total > 0 and ai < len(ad) else 0.0
            row.append(frac)
        rows.append(row)
    return np.asarray(rows, np.float64)


def cluster_variants(contexts, min_cluster_size: int = 5,
                     random_state: int = 42):
    """Label each split context with a variant group (-1 = noise).

    Returns (labels [n], separations [n_groups, n_groups]) — the separation
    matrix plays the role of flight's `*_separation.npy`
    (haplotype_clustering_engine.rs:259-268): pairwise cluster-centroid
    distance scaled by mean intra-cluster spread, so values < 2.5 mean the
    clusters are not clearly separable (linkage_engine.rs:1093).
    """
    if not contexts:
        return np.zeros(0, np.int64), np.zeros((0, 0))
    X = depth_matrix(contexts)
    X_orig = X
    n = len(contexts)
    if n < 4:
        # too few points for density clustering: one group per distinct
        # depth profile (rounded to 0.1 fraction bins)
        keys = {}
        labels = np.zeros(n, np.int64)
        for i in range(n):
            key = tuple(np.round(X[i], 1))
            labels[i] = keys.setdefault(key, len(keys))
    else:
        from lorikeet_tpu_torch.strain.hdbscan import HDBSCAN
        # min cluster size scales with the variant count so dense profiles
        # aren't shattered into micro-groups
        mcs = min(max(min_cluster_size, n // 25), max(2, n // 2))
        if X.shape[1] > 8:
            # genuinely high-dimensional depth profiles (many samples):
            # embed first, as flight does (UMAP to 2-D, then density
            # clustering).  At moderate sample counts density clustering
            # runs on the raw fraction space directly — an embedding can
            # tear one noisy strain cloud into distant islands (then the
            # water-table traversal can orphan interior sub-groups), while
            # HDBSCAN up to ~8 dims separates the true profiles exactly.
            from lorikeet_tpu_torch.strain.umap import umap_embed
            with global_stage("strain.umap"):
                X = umap_embed(X, n_components=2, seed=random_state)
        with global_stage("strain.hdbscan"):
            labels = HDBSCAN(min_cluster_size=mcs, allow_single_cluster=True,
                             copy=True).fit_predict(X).astype(np.int64)
    groups = sorted(set(labels.tolist()) - {-1})
    n_groups = (max(groups) + 1) if groups else 0
    sep = np.full((n_groups, n_groups), np.inf)
    if n_groups:
        # separation is measured in the ORIGINAL depth-fraction space, not
        # the embedding: it answers "are these clusters separable in depth
        # profile space" (linkage_engine.rs:1093 `< 2.5` merge gate).  An
        # embedding can tear one noisy cloud into distant islands; in
        # depth space such islands have near-zero separation, so read
        # linkage is allowed to stitch them back, while genuinely distinct
        # strains keep large separations and stay excluded.
        #
        # The scale is the spread a sample: the mean distance of a member
        # from its centroid over the square root of the samples.  (The
        # JAX package divides by the distance itself, which grows as that
        # root with the samples for noise alike in each: at 12 samples of
        # 15x three strains HDBSCAN splits cleanly read 2.3-3.0 there, and
        # the gate merged them.)  Halves of one noisy cloud still read
        # under the gate: their centroids lie within a spread a sample.
        X = X_orig
        centroids = {g: X[labels == g].mean(axis=0) for g in groups}
        spreads = [np.linalg.norm(X[labels == g] - centroids[g], axis=1).mean()
                   for g in groups]
        scale = max(float(np.mean(spreads)) / np.sqrt(X.shape[1]), 1e-9)
        np.fill_diagonal(sep, 0.0)
        for i, gi in enumerate(groups):
            for gj in groups[i + 1:]:
                d = np.linalg.norm(centroids[gi] - centroids[gj]) / scale
                sep[gi, gj] = sep[gj, gi] = d
    return labels, sep


def abundance_em(variant_weights: np.ndarray, membership: list,
                 eps: float = 1e-4, max_iters: int = 1000) -> np.ndarray:
    """Per-sample strain abundance EM (strain_abundances_calculator.rs:38).

    variant_weights: [n_variants] depth fractions for one sample.
    membership: per variant, the list of strain indices carrying it.
    Returns theta [n_strains].  Reference-strain mass is handled by the
    caller's leftover-alt-mass estimator (run_genotype), not by
    duplicating reference fractions into the EM as the reference does
    (abundance_calculator_engine.rs:190-215) — see the deviation note at
    the call site.
    """
    n_strains = max((s for m in membership for s in m), default=-1) + 1
    if n_strains == 0:
        return np.zeros(0)
    n_vars = len(membership)
    # dense [S, V] membership (SURVEY §7.1: dense matrix form of the
    # reference's per-strain weight lists)
    M = np.zeros((n_strains, n_vars), bool)
    for v, m in enumerate(membership):
        for s in m:
            M[s, v] = True
    alt = variant_weights[None, :].astype(np.float64)
    W = np.where(M, alt, 0.0)
    has_vars = M.any(axis=1)
    theta = np.ones(n_strains)
    tiny = np.finfo(float).eps
    omega = 1.0
    iters = 0
    while omega > eps and iters < max_iters:
        iters += 1
        theta_prev = theta
        denominator = float(W.sum())
        active = (np.abs(theta) > eps) & has_vars
        pooled = np.maximum(theta @ M, tiny)            # [V]
        W_new = np.where((active[:, None]) & M,
                         W * theta[:, None] / pooled[None, :], W)
        ab = W_new.sum(axis=1) / denominator if denominator > 0 \
            else np.zeros(n_strains)
        ab = np.where(np.isfinite(ab) & (ab >= eps), ab, 0.0)
        theta = np.where(active, ab, 0.0)
        W = np.where(active[:, None], W_new, W)
        omega = float(np.abs(theta - theta_prev).sum())
    return theta


def abundance_em_reference(alt_frac: np.ndarray, ref_frac: np.ndarray,
                           membership: list, n_strains: int,
                           present: np.ndarray, eps: float = 1e-2,
                           max_iters: int = 1000) -> np.ndarray:
    """One sample's strain abundances under the REFERENCE's exact semantics
    (selectable via ``--abundance-mode reference``): ref-allele mass is
    duplicated into every strain NOT carrying the variant
    (abundance_calculator_engine.rs:190-215 — weight ``ad[0]/total_depth``
    pushed per non-carrying strain), then the centrifuge-style EM of
    strain_abundances_calculator.rs:38-160 runs over the per-strain entry
    lists.  The default ``leftover`` estimator instead scales EM thetas by
    total alt mass and assigns the residue to the reference strain (see
    run_genotype); the two agree in the single-strain-plus-reference case
    and diverge on multi-strain mixtures (tests/test_abundance_modes.py).

    alt_frac/ref_frac: [V] per-variant alt / ref depth fractions.
    membership: per variant, list of carrying strain indices (never the
      reference strain — it carries no variants by construction).
    present: [n_strains] bool, per-sample strain presence
      (determine_if_strain_is_present, abundance_calculator_engine.rs:503).
    Returns abundance weights [n_strains] (NOT normalised — the reference
    prints raw ``abundance_weight`` values).
    """
    weights = [[] for _ in range(n_strains)]     # per-strain entry weights
    gids = [[] for _ in range(n_strains)]        # per-entry pooled-strain ids
    for v, m in enumerate(membership):
        if not m:
            continue
        w_alt = float(alt_frac[v]) / len(m)
        if w_alt > 0.0:
            pooled = [t for t in m if present[t]]
            for s in m:
                if present[s]:
                    weights[s].append(w_alt)
                    gids[s].append(pooled)
        w_ref = float(ref_frac[v])
        if w_ref > 0.0:
            non_carrying = [t for t in range(n_strains) if t not in m]
            pooled = [t for t in non_carrying if present[t]]
            # pushed to every non-carrying strain regardless of its own
            # presence (abundance_calculator_engine.rs:192-271)
            for s in non_carrying:
                weights[s].append(w_ref)
                gids[s].append(pooled)
    weights = [np.asarray(w, np.float64) for w in weights]

    f64eps = np.finfo(np.float64).eps
    aw = np.ones(n_strains)
    theta = np.ones(n_strains)
    omega, iters = 1.0, 0
    while omega > eps and iters < max_iters:
        iters += 1
        theta_prev = theta.copy()
        # denominator over the PREVIOUS iteration's weights, constant within
        # an iteration (updates apply after the strain loop,
        # strain_abundances_calculator.rs:104-140)
        denominator = float(sum(w.sum() for w in weights))
        new_weights = [None] * n_strains
        updated = np.zeros(n_strains)
        for i in range(n_strains):
            if abs(aw[i] - eps) <= f64eps or np.isinf(aw[i]):
                continue
            pooled = np.array([sum(theta[g] for g in gid) or 1.0
                               for gid in gids[i]])
            pooled = np.where(pooled <= f64eps, 1.0, pooled)
            w_new = weights[i] * aw[i] / pooled
            with np.errstate(invalid="ignore", divide="ignore"):
                a = float(w_new.sum() / denominator) if denominator else np.nan
            if not np.isfinite(a) or a < eps:
                a = 0.0
            updated[i] = a
            new_weights[i] = w_new
        for i, w_new in enumerate(new_weights):
            if w_new is not None:
                weights[i] = w_new
                aw[i] = updated[i]
                theta[i] = updated[i]
        omega = float(np.abs(theta - theta_prev).sum())
    return aw


def run_abundance_reference(X: np.ndarray, R: np.ndarray, membership: list,
                            n_groups_strains: int, reference_present: bool,
                            eps: float = 1e-2):
    """Reference-parity abundance routine (run_abundance_calculator,
    abundance_calculator_engine.rs:42-365): appends the reference strain
    when present, builds per-sample strain presence, runs one EM pass per
    sample, and culls strains whose weight is <= eps in EVERY sample (the
    engine's removal loop executes once — ``something_removed`` is
    hard-false at :296, so the loop always breaks after the first pass).

    X/R: [V, S] alt / ref depth fractions; membership: [V] carrying strain
    ids.  Returns (thetas: [S][n_strains] raw weights, kept_ids, ref_index).
    """
    n_samples = X.shape[1] if X.ndim > 1 else 0
    n_strains = n_groups_strains + (1 if reference_present else 0)
    ref_index = n_strains - 1 if reference_present else None
    thetas = []
    for s in range(n_samples):
        present = np.zeros(n_strains, bool)
        for v, m in enumerate(membership):
            if X[v, s] > 0:
                for t in m:
                    present[t] = True
        if reference_present:
            present[ref_index] = True
        thetas.append(abundance_em_reference(
            X[:, s], R[:, s], membership, n_strains, present, eps=eps))
    kept_ids = [i for i in range(n_strains)
                if any(np.isfinite(th[i]) and th[i] > eps for th in thetas)]
    return thetas, kept_ids, ref_index


def run_genotype(reference: str, vcf_path: str, output_dir: str,
                 bam_paths: list = None, contigs: list = None,
                 genome_name: str = None,
                 qual_by_depth_filter: float = 25.0,
                 min_variant_depth: int = 10,
                 abundance_mode: str = "leftover") -> dict:
    """Cluster variants into variant groups, link groups into strains via
    read linkage (linkage_engine.rs:73), estimate abundances, write strain
    FASTAs + coverage tables, and rewrite the VCF with VG/ST annotations.

    With spans on (utils.progress) its parts are the spans
    ``strain.split``, ``strain.umap`` and ``strain.hdbscan``
    (cluster_variants), ``strain.linkage`` (the BAMs reopened and linked),
    ``strain.em`` and ``strain.write``.  Its outputs count the split
    contexts clustered (``n_contexts``), those given a group
    (``n_clustered``), the groups and the strains."""
    from lorikeet_tpu_torch.io.bam import open_bam
    from lorikeet_tpu_torch.strain.link_alleles import linkage_contexts
    from lorikeet_tpu_torch.strain.linkage import LinkageEngine

    os.makedirs(output_dir, exist_ok=True)
    fasta = FastaReader(reference)
    with global_stage("strain.split"):
        contexts, vcf_contigs, samples = read_vcf(vcf_path)
        if not samples:
            samples = ["sample0"]
        genome = genome_name or os.path.splitext(
            os.path.basename(reference))[0]
        contig_names = contigs if contigs is not None else (vcf_contigs
                                                           or fasta.names)

        split, filtered = split_contexts(
            contexts, qual_by_depth_filter,
            min_variant_depth=min_variant_depth)
    labels, separations = cluster_variants(split)
    groups = sorted(set(labels.tolist()) - {-1})
    for vc, lab in zip(split, labels):
        vc.attributes["VG"] = int(lab)

    outputs = {"n_variant_groups": len(groups), "n_contexts": len(split),
               "n_clustered": int((labels != -1).sum())}

    # --- link variant groups into strains via read co-occurrence ---
    grouped = {g: [vc for vc, lab in zip(split, labels) if lab == g]
               for g in groups}
    if bam_paths:
        with global_stage("strain.linkage"):
            bams = [open_bam(p) for p in bam_paths]
            # vc.tid indexes the VCF's contig list; each BAM resolves its
            # own tid by contig name inside the linkage fetch (headers may
            # differ)
            engine = LinkageEngine(
                linkage_contexts(grouped, fasta, vcf_contigs or contig_names),
                separations)
            strain_groups = engine.run_linkage(bams, vcf_contigs or None)
    else:
        # no reads available (summarise-style input): strain = variant group
        strain_groups = [[g] for g in groups]
    outputs["n_strains"] = len(strain_groups)

    # tag each context with the strains its group belongs to
    group_to_strains = {}
    for s_idx, sg in enumerate(strain_groups):
        for g in sg:
            group_to_strains.setdefault(g, []).append(s_idx)
    for vc, lab in zip(split, labels):
        st = group_to_strains.get(int(lab))
        if st:
            vc.attributes["ST"] = st if len(st) > 1 else st[0]

    # --- abundance EM per sample over strains ---
    t_em = time.perf_counter_ns()
    X = depth_matrix(split) if split else np.zeros((0, len(samples)))
    membership = [group_to_strains.get(int(lab), []) for lab in labels]
    # reference-strain heuristic (abundance_calculator_engine.rs:485-500 +
    # :48-52): when any sample shows reference-allele depth at >= 97% of
    # split sites, one extra strain carrying only reference alleles joins
    # the EM; non-carrying strains receive the ref-allele mass per variant
    # (:190-215)
    R = np.zeros_like(X)
    for v, vc in enumerate(split):
        for s, g in enumerate(vc.genotypes[:X.shape[1] if X.ndim > 1
                                           else len(samples)]):
            ad = np.asarray(g.ad) if g.ad is not None else np.zeros(2)
            total = ad.sum()
            R[v, s] = ad[0] / total if total > 0 else 0.0
    ref_counts = (R > 0).sum(axis=0) if len(split) else np.zeros(len(samples))
    reference_present = bool(len(split)) and bool(
        (ref_counts >= int(len(split) * 0.97)).any())
    coverage_path = os.path.join(output_dir, f"{genome}_strain_coverages.tsv")
    if abundance_mode == "reference" and len(split):
        # reference-parity mode: ref-mass duplication EM + one-pass culling
        # (abundance_calculator_engine.rs:42-365); raw weights, culled
        # strains omitted from the TSV like the reference's removal loop
        thetas_ref, kept_ids, ref_index = run_abundance_reference(
            X, R, membership, len(strain_groups), reference_present)
        with open(coverage_path, "w") as out:
            out.write("strainID\t" + "\t".join(samples) + "\n")
            for s_idx in kept_ids:
                name = ("strain_reference" if s_idx == ref_index
                        else f"strain_{s_idx}")
                out.write(name + "\t" + "\t".join(
                    f"{thetas_ref[s][s_idx]:.6f}"
                    for s in range(len(samples))) + "\n")
        outputs["strain_coverages"] = coverage_path
        outputs["reference_strain_present"] = bool(
            reference_present and ref_index in kept_ids)
        outputs["abundance_mode"] = "reference"
        add_span("strain.em", t_em)
        with global_stage("strain.write"):
            return _finish_genotype_outputs(
                outputs, strain_groups, grouped, contig_names, vcf_contigs,
                fasta, output_dir, genome, split, filtered, samples,
                vcf_path)
    with open(coverage_path, "w") as out:
        out.write("strainID\t" + "\t".join(samples) + "\n")
        thetas = [abundance_em(X[:, s] if len(split) else np.zeros(0),
                               membership)
                  for s in range(len(samples))]
        # reference-strain quantification: the EM thetas give the SHAPE of
        # the alt-strain mixture; the total observed per-strain alt mass
        # gives the SCALE.  Under a pure strain mixture the per-strain
        # median alt fractions sum to ~1; a true reference strain at
        # fraction r depresses the sum to ~1-r, and that leftover is the
        # reference strain's abundance.  (The reference's own EM duplicates
        # ref-allele mass into every non-carrying strain,
        # abundance_calculator_engine.rs:190-215, which mis-allocates in
        # multi-strain mixtures; this estimator agrees with it in the
        # single-strain-plus-reference case and stays exact for mixtures.)
        ref_row = np.zeros(len(samples))
        if reference_present and len(split):
            for s in range(len(samples)):
                total = 0.0
                for k in range(len(strain_groups)):
                    fr = [X[v, s] for v, m in enumerate(membership)
                          if m == [k]] or                          [X[v, s] for v, m in enumerate(membership) if k in m]
                    if fr:
                        total += float(np.median(fr))
                total = min(1.0, total)
                ref_row[s] = max(0.0, 1.0 - total)
                thetas[s] = thetas[s] * total
        # a reference strain with no meaningful abundance anywhere is
        # culled like any unsupported strain (the reference's iterative
        # strain dropping, abundance_calculator_engine.rs:42-120)
        if reference_present and ref_row.max() < 0.1:
            reference_present = False
            for s in range(len(samples)):
                total = thetas[s].sum()
                if total > 0:
                    thetas[s] = thetas[s] / total
        for s_idx in range(len(strain_groups)):
            vals = [f"{thetas[s][s_idx]:.6f}" if len(thetas[s]) > s_idx
                    else "0" for s in range(len(samples))]
            out.write(f"strain_{s_idx}\t" + "\t".join(vals) + "\n")
        if reference_present:
            out.write("strain_reference\t"
                      + "\t".join(f"{v:.6f}" for v in ref_row) + "\n")
    outputs["strain_coverages"] = coverage_path
    outputs["reference_strain_present"] = reference_present
    add_span("strain.em", t_em)
    with global_stage("strain.write"):
        return _finish_genotype_outputs(
            outputs, strain_groups, grouped, contig_names, vcf_contigs,
            fasta, output_dir, genome, split, filtered, samples, vcf_path)


def _finish_genotype_outputs(outputs, strain_groups, grouped, contig_names,
                             vcf_contigs, fasta, output_dir, genome,
                             split, filtered, samples, vcf_path):
    """Shared tail of run_genotype: strain FASTAs + annotated VCF."""
    from lorikeet_tpu_torch.io.vcf import write_vcf
    # --- strain FASTAs: apply each strain's variants to the reference
    #     (reference_writer.rs:31 generate_strains) ---
    strain_paths = []
    tid_names = vcf_contigs or contig_names
    # fetch each contig once; strains reuse the array (reads are immutable)
    ref_by_name = {name: fasta.fetch(name) for name in contig_names}
    for s_idx, sg in enumerate(strain_groups):
        vcs_in_strain = [vc for g in sg for vc in grouped.get(g, [])]
        out_contigs = {}
        for name in contig_names:
            ref = ref_by_name[name]
            vcs = [vc for vc in vcs_in_strain
                   if vc.tid < len(tid_names) and tid_names[vc.tid] == name]
            pieces = []
            cursor = 0
            for vc in sorted(vcs, key=lambda v: v.start):
                if vc.start < cursor:
                    continue
                alt = vc.alternate_alleles[0]
                if alt.is_span_del:
                    # spanning deletion: remove the spanned bases
                    # (reference_writer.rs:249-258)
                    pieces.append(ref[cursor:vc.start + 1])
                    cursor = vc.end + 1
                    continue
                if alt.is_symbolic:
                    continue
                pieces.append(ref[cursor:vc.start])
                pieces.append(np.frombuffer(alt.bases, np.uint8))
                cursor = vc.start + len(vc.reference)
            pieces.append(ref[cursor:])
            out_contigs[name] = np.concatenate(pieces)
        path = os.path.join(output_dir, f"{genome}_strain_{s_idx}.fna")
        _write_fasta(path, out_contigs)
        strain_paths.append(path)
    outputs["strain_fastas"] = strain_paths

    # --- rewrite the VCF with VG/ST annotations; filtered (non-qualified)
    # contexts stay in the file un-annotated (lorikeet_engine.rs:626-634
    # split_contexts.extend(filtered_contexts) before write_vcf) ---
    contig_lengths = [fasta.length(n) for n in tid_names]
    annotated_vcf = os.path.join(output_dir, f"{genome}.vcf")
    write_vcf(annotated_vcf,
              sorted(split + filtered, key=lambda v: (v.tid, v.start)),
              list(tid_names), contig_lengths, samples)
    outputs["vcf"] = annotated_vcf
    return outputs
