"""One cell's inputs: for genome j of a run, its reference FASTA (one record
a contig), one BAM of short reads per sample, one of long reads per sample
where the configuration has them, and the planted variants (the truth).

The configuration (``configs/<name>.json``) fixes the genome's size, its
contigs and the reads; the traffic mix (``traffic/<name>.json``) fixes the
strains and each sample's share of them.  Every number comes from the seed
and the genome's index, so one seed gives the same files on every machine.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from portbench.gen import bam, genome, reads

#: the warm-up genome: the first WARMUP_BASES of each of genome 0's first
#: WARMUP_CONTIGS contigs with the reads that lie inside them, and
#: WARMUP_PADS contigs of WARMUP_PAD bases of random sequence without
#: reads: long enough for the program to start its worker pool, and a
#: piece of real work for every worker
WARMUP_BASES = 4_000
WARMUP_CONTIGS = 8
WARMUP_PADS = 9
WARMUP_PAD = 60_000


@dataclass(frozen=True)
class Dataset:
    """A genome's files: ``fasta``, ``bams`` (short reads, one a sample),
    ``long_bams``; ``contigs`` {name: u8 sequence}; ``truth``, the planted
    variants [(contig, pos, ref, alt, strain)] of every strain (1 the
    mix's first); ``fractions``, each sample's share of each planted
    strain, as the mix gives them."""
    name: str
    fasta: str
    bams: list
    long_bams: list
    contigs: dict
    truth: list
    fractions: list

    @property
    def kbp(self) -> float:
        return sum(s.size for s in self.contigs.values()) / 1000


def rng_of(seed: int, *stream: int):
    """The generator of one stream of a seed (any integer)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *stream])


def contig_lengths(config: dict) -> list:
    return [int(config["contig_kbp"] * 1000)] * config["contigs"]


def build(root: str, config: dict, mix: dict, seed: int, index: int,
          warmup: str = None):
    """Genome ``index`` of a run of ``seed``, written under ``root``.
    With ``warmup`` the warm-up genome (see WARMUP_BASES) is written into
    that directory too, and (genome, warm-up genome) returned."""
    name = f"mag{index}"
    os.makedirs(root, exist_ok=True)
    contigs, truth, per_contig = {}, [], []
    for tid, length in enumerate(contig_lengths(config)):
        contig = f"{name}_c{tid}"
        ref = genome.random_genome(rng_of(seed, index, tid, 0), length)
        strains = [genome.reference_strain(ref)]
        for k, spec in enumerate(mix["strains"]):
            planted = genome.plant_variants(rng_of(seed, index, tid, 1, k),
                                            ref, spec, mix["margin"])
            truth.extend((contig, *v, k + 1) for v in planted)
            strains.append(genome.apply_variants(ref, planted))
        contigs[contig] = ref
        per_contig.append(strains)
    fasta = os.path.join(root, f"{name}.fna")
    bam.write_fasta(fasta, list(contigs.items()))
    header = [(c, s.size) for c, s in contigs.items()]
    sets = {"bams": [], "long_bams": []}
    for s, fractions in enumerate(mix["fractions"]):
        for kind, draw, spec in (
                ("bams", reads.short_pairs, config["short_reads"]),
                ("long_bams", reads.long_reads, config.get("long_reads"))):
            if spec is None:
                continue
            r = reads.concat([
                draw(rng_of(seed, index, tid, 2, s, kind == "bams"),
                     strains, fractions, spec, strains[0].seq.size, tid)
                for tid, strains in enumerate(per_contig)]).sorted()
            sample = f"{'sample' if kind == 'bams' else 'long'}{s}"
            path = os.path.join(root, f"{name}_{sample}.bam")
            bam.write_bam(path, header, r, sample)
            sets[kind].append((path, sample, r))
    data = Dataset(name, fasta, [p for p, _, _ in sets["bams"]],
                   [p for p, _, _ in sets["long_bams"]], contigs,
                   sorted(truth), mix["fractions"])
    if warmup is None:
        return data
    return data, _warmup(warmup, data, sets, seed)


def _warmup(root: str, data: Dataset, sets: dict, seed: int) -> Dataset:
    """The first WARMUP_BASES of genome 0's first WARMUP_CONTIGS contigs
    with the reads that lie inside them, beside WARMUP_PADS contigs of
    random sequence with none."""
    os.makedirs(root, exist_ok=True)
    contigs = {c: seq[:WARMUP_BASES] for c, seq in
               list(data.contigs.items())[:WARMUP_CONTIGS]}
    for k in range(WARMUP_PADS):
        contigs[f"warmup_pad{k}"] = genome.random_genome(
            rng_of(seed, 99, k), WARMUP_PAD)
    fasta = os.path.join(root, "warmup.fna")
    bam.write_fasta(fasta, list(contigs.items()))
    header = [(c, s.size) for c, s in contigs.items()]
    out = {"bams": [], "long_bams": []}
    for kind, entries in sets.items():
        for path, sample, r in entries:
            # a mate's span is about its length: leave out pairs whose
            # mate could reach past the piece
            inside = (r.tid < WARMUP_CONTIGS) & (
                r.pos + r.ref_len <= WARMUP_BASES) & (
                (r.mate_pos < 0)
                | (r.mate_pos + 2 * r.seq_len <= WARMUP_BASES))
            dest = os.path.join(root, os.path.basename(path))
            bam.write_bam(dest, header, r.take(inside), sample)
            out[kind].append(dest)
    return Dataset("warmup", fasta, out["bams"], out["long_bams"], contigs,
                   [], data.fractions)
