"""A simulated `call` dataset and its scoring: a genome with planted
variants written as FASTA + one BAM per sample, and the recall of a call
set against the planted truth.  Deterministic in its arguments."""
from __future__ import annotations

import os

import numpy as np


def simulate_dataset(tmp, kbp: int, n_samples: int, coverage: float,
                     seed: int = 0):
    """A single-contig genome of `kbp` kilobases with ~1 variant / 2 kb,
    written into ``tmp`` as FASTA + one BAM per sample.  Returns (fasta,
    bams, truth)."""
    from lorikeet_tpu_torch.testkit.simulate import Variant

    rng = np.random.default_rng(seed)
    L = kbp * 1000
    ref = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)].copy()
    fasta = os.path.join(tmp, "genome.fna")
    with open(fasta, "w") as fh:
        fh.write(">contig1\n")
        seq = ref.tobytes().decode()
        for i in range(0, L, 80):
            fh.write(seq[i:i + 80] + "\n")

    variants = []
    pos = 1000
    while pos < L - 1500:
        r = rng.random()
        if r < 0.7:                                           # SNP
            ref_idx = b"ACGT".index(ref[pos])
            alt = b"ACGT"[(ref_idx + 1 + int(rng.integers(0, 3))) % 4]
            variants.append(Variant(pos, bytes(ref[pos:pos + 1]),
                                    bytes([alt])))
        elif r < 0.85:                                        # 1-6bp del
            n = int(rng.integers(1, 7))
            variants.append(Variant(pos, bytes(ref[pos:pos + n + 1]),
                                    bytes(ref[pos:pos + 1])))
        else:                                                 # 1-6bp ins
            n = int(rng.integers(1, 7))
            ins = bytes(np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, n)])
            variants.append(Variant(pos, bytes(ref[pos:pos + 1]),
                                    bytes(ref[pos:pos + 1]) + ins))
        pos += int(rng.integers(1500, 2500))

    bams = [os.path.join(tmp, f"sample{s}.bam") for s in range(n_samples)]
    if n_samples >= 4:
        # simulation is per-sample independent: one process per sample
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                min(os.cpu_count() or 4, n_samples),
                mp_context=mp.get_context("spawn")) as pool:
            list(pool.map(_simulate_one_sample,
                          [(fasta, L, variants, coverage, seed, s, bams[s])
                           for s in range(n_samples)]))
    else:
        for s in range(n_samples):
            _simulate_one_sample((fasta, L, variants, coverage, seed, s,
                                  bams[s]))
    return fasta, bams, variants


def _simulate_one_sample(payload):
    fasta, L, variants, coverage, seed, s, bam = payload
    from lorikeet_tpu_torch.io.bam_writer import write_bam
    from lorikeet_tpu_torch.io.fasta import FastaReader
    from lorikeet_tpu_torch.testkit.simulate import simulate_reads
    ref = np.asarray(FastaReader(fasta).fetch("contig1"), np.uint8)
    recs = simulate_reads(ref, variants, coverage=coverage,
                          seed=seed + 101 * s, allele_fraction=0.5,
                          error_rate=0.001, sample=f"sample{s}")
    write_bam(bam, ["contig1"], [L],
              sorted(recs, key=lambda r: (r.tid, r.pos)),
              header_text=None)


def recall(calls, truth) -> float:
    """Share of the planted variants that a call set found."""
    called = {c.start for c in calls}
    hit = 0
    for t in truth:
        if t.pos in called:
            hit += 1
        elif len(t.ref) != len(t.alt):
            # indels may left-align a few bases upstream in the VCF
            if any(p in called for p in range(t.pos - 25, t.pos)):
                hit += 1
    return hit / max(len(truth), 1)


def write_truth_vcf(path: str, fasta: str, truth) -> str:
    """The planted variants of a single-contig dataset as a sites-only VCF
    (``--features-vcf`` input); returns ``path``."""
    from lorikeet_tpu_torch.io.fasta import FastaReader
    reader = FastaReader(fasta)
    (contig,) = reader.names
    length = reader.length(contig)
    reader.close()
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 f"##contig=<ID={contig},length={length}>\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for v in sorted(truth, key=lambda v: v.pos):
            fh.write(f"{contig}\t{v.pos + 1}\t.\t{v.ref.decode()}\t"
                     f"{v.alt.decode()}\t.\tPASS\t.\n")
    return path
