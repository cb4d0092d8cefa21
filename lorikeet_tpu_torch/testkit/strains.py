"""Simulated strain mixtures for `genotype`, and the checks of its strains.

The datasets of the JAX package's `bench.py` (`bench_genotype`: random
SNPs per strain, 2.5 kb apart; `bench_genotype_linked`: SNPs every 240 bp,
inside the fragment length, so that read linkage can join a strain's
variant groups) rebuilt from the same seeds with the port's simulator and
BAM writer, and a many-sample time series (strain fractions from a seeded
Dirichlet) that crosses `cluster_variants`' 8-sample gate to the UMAP
path.  The checks read the `VG` and `ST` tags of `genotype`'s VCF.
"""
from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from lorikeet_tpu_torch.io.bam_writer import write_bam
from lorikeet_tpu_torch.testkit.simulate import Variant, simulate_reads

BASES = np.frombuffer(b"ACGT", np.uint8)


def reference(seed: int, length: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return BASES[rng.integers(0, 4, length)]


def snp(ref: np.ndarray, pos: int) -> Variant:
    r = bytes(ref[pos:pos + 1])
    return Variant(int(pos), r, b"T" if r != b"T" else b"G")


def random_strain(ref: np.ndarray, seed: int, n: int) -> list:
    """``n`` SNPs at seeded positions 500 bases or more from either end
    (`bench.py` `bench_genotype`'s ``mkstrain``)."""
    r = np.random.default_rng(seed)
    pos = np.sort(r.choice(np.arange(500, len(ref) - 500), n, replace=False))
    return [snp(ref, int(p)) for p in pos]


def spaced_strain(ref: np.ndarray, offset: int, step: int = 240) -> list:
    """A SNP every ``step`` bases from 1000 + ``offset`` to 1000 from the
    end (`bench.py` `bench_genotype_linked`'s ``mkstrain``)."""
    return [snp(ref, p) for p in range(1000 + offset, len(ref) - 1000, step)]


def _sample_bam(path, contig, ref, strains, fracs, coverage, seed_step,
                sidx, prefix):
    recs = []
    for k, (strain, fr) in enumerate(zip(strains, fracs)):
        if fr <= 0:
            continue
        recs += simulate_reads(ref, strain, coverage=coverage * fr,
                               seed=seed_step * sidx + k,
                               name_prefix=f"{prefix}{sidx}_{k}_")
    recs.sort(key=lambda r: (r.tid, r.pos))
    write_bam(path, [contig], [len(ref)], recs)
    return path


def write_mixture(root: str, contig: str, ref: np.ndarray, strains: list,
                  mix, coverage: float, seed_step: int, prefix: str,
                  processes: int = 1):
    """FASTA ``root``/g.fna and one BAM a row of ``mix`` (each strain's
    share of the sample's ``coverage``), as `bench.py` writes them; reads of
    sample i, strain k come from seed ``seed_step`` * i + k.  Samples are
    simulated in ``processes`` spawned processes at once.  Returns (fasta,
    bams)."""
    os.makedirs(root, exist_ok=True)
    fasta = os.path.join(root, "g.fna")
    with open(fasta, "w") as fh:
        fh.write(f">{contig}\n")
        s = ref.tobytes().decode()
        for i in range(0, len(ref), 80):
            fh.write(s[i:i + 80] + "\n")
    jobs = [(os.path.join(root, f"s{sidx}.bam"), contig, ref, strains,
             [float(f) for f in fracs], coverage, seed_step, sidx, prefix)
            for sidx, fracs in enumerate(mix)]
    if processes <= 1:
        bams = [_sample_bam(*job) for job in jobs]
    else:
        import multiprocessing as mp
        with ProcessPoolExecutor(processes,
                                 mp_context=mp.get_context("spawn")) as ex:
            bams = list(ex.map(_sample_bam, *zip(*jobs)))
    return fasta, bams


def vcf_tags(vcf: str):
    """({VG: {0-based positions}}, {strain id: {0-based positions}}) of a
    `genotype` VCF."""
    groups, strains = {}, {}
    with open(vcf) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.split("\t")
            info = dict(kv.split("=", 1) for kv in f[7].split(";")
                        if "=" in kv)
            pos = int(f[1]) - 1
            if "VG" in info:
                groups.setdefault(info["VG"], set()).add(pos)
            if "ST" in info:
                for sid in info["ST"].split(","):
                    strains.setdefault(sid, set()).add(pos)
    return groups, strains


def groups_pure_complete(vcf: str, truth: list) -> dict:
    """`bench.py` `bench_genotype`'s bar: no variant group mixes strains
    (pure), every planted variant is in a group (complete), and at least as
    many groups as strains."""
    groups, _ = vcf_tags(vcf)
    pure = all(any(g <= t for t in truth) for g in groups.values())
    grouped = set().union(*groups.values()) if groups else set()
    complete = all(t <= grouped for t in truth)
    return {"pure": pure, "complete": complete,
            "pure_complete": pure and complete and len(groups) >= len(truth)}


def strains_exact(vcf: str, truth: list) -> bool:
    """`bench.py` `bench_genotype_linked`'s bar: the `ST` sets are exactly
    the planted strains."""
    _, strains = vcf_tags(vcf)
    return (len(strains) == len(truth)
            and sorted(map(sorted, strains.values()))
            == sorted(map(sorted, truth)))


def genotype_dataset(root: str, length: int = 100_000, n_snps: int = 40,
                     contig: str = "gbench~c1"):
    """`bench_genotype`'s two strains of ``n_snps`` random SNPs (seeds 41
    and 42) on a seed-17 genome, four samples mixed [[1, 0], [0, 1], [.65,
    .35], [.25, .75]] at 30x.  Returns (fasta, bams, truth positions)."""
    ref = reference(17, length)
    strains = [random_strain(ref, 41, n_snps), random_strain(ref, 42, n_snps)]
    mix = [[1.0, 0.0], [0.0, 1.0], [0.65, 0.35], [0.25, 0.75]]
    fasta, bams = write_mixture(root, contig, ref, strains, mix, 30.0, 500,
                                "g")
    return fasta, bams, [{v.pos for v in s} for s in strains]


def linked_dataset(root: str):
    """`bench_genotype_linked`'s two interleaved strains (SNPs every 240 bp
    at offsets 0 and 120) on a seed-23 genome of 40 kb, mixed [[1, 0], [0,
    1], [.7, .3], [.3, .7]] at 30x."""
    ref = reference(23, 40_000)
    strains = [spaced_strain(ref, 0), spaced_strain(ref, 120)]
    mix = [[1.0, 0.0], [0.0, 1.0], [0.7, 0.3], [0.3, 0.7]]
    fasta, bams = write_mixture(root, "glink~c1", ref, strains, mix, 30.0,
                                700, "l")
    return fasta, bams, [{v.pos for v in s} for s in strains]


def time_series_dataset(root: str, length: int, samples: int = 12,
                        spacing: int = 3000, seed: int = 0,
                        processes: int = 1):
    """Three strains, each with a SNP about every ``spacing`` bases at
    positions of its own (disjoint), in ``samples`` samples whose strain
    fractions come from a seeded Dirichlet(1, 1, 1), at 15x a sample.
    Returns (fasta, bams, truth positions)."""
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, length)]
    n_snps = max(1, (length - 1000) // spacing)
    pos = rng.choice(np.arange(500, length - 500), 3 * n_snps, replace=False)
    strains = [[snp(ref, int(p)) for p in np.sort(pos[k::3])]
               for k in range(3)]
    mix = rng.dirichlet(np.ones(3), samples)
    fasta, bams = write_mixture(root, "gseries~c1", ref, strains, mix, 15.0,
                                900, "t", processes=processes)
    return fasta, bams, [{v.pos for v in s} for s in strains]
