"""Consensus genome writing (`consensus` mode).

Contract: reference/src/reference/reference_writer.rs:120-315
generate_consensus — per sample, apply that sample's consensus allele
(argmax AD; qualifying sites only) to the reference and write
consensus_{sample}_{genome}.fna; splice semantics for SNP/insertion/deletion
from modify_reference_bases_based_on_variant_type (:241).
"""
from __future__ import annotations

import os

import numpy as np

from lorikeet_tpu_torch.io.fasta import FastaReader
from lorikeet_tpu_torch.io.vcf import read_vcf
from lorikeet_tpu_torch.strain.ani import site_passes


def apply_consensus_to_contig(ref: np.ndarray, contexts, sample_idx: int) -> np.ndarray:
    """Apply per-sample consensus alleles (sorted by position) to one contig."""
    pieces = []
    cursor = 0
    for vc in sorted(contexts, key=lambda v: v.start):
        if not site_passes(vc):
            continue
        if sample_idx >= len(vc.genotypes):
            continue
        g = vc.genotypes[sample_idx]
        if g.ad is None or np.max(g.ad) == 0:
            continue
        ci = int(np.argmax(g.ad))
        if ci == 0:
            continue  # consensus is reference
        allele = vc.alleles[ci]
        if vc.start < cursor:
            continue  # overlapping an applied deletion
        if allele.is_symbolic or allele.is_span_del:
            if allele.is_span_del:
                # spanning-deletion consensus: remove the spanned reference
                # bases start+1..=end (reference_writer.rs:249-258)
                pieces.append(ref[cursor:vc.start + 1])
                cursor = vc.end + 1
            continue
        pieces.append(ref[cursor:vc.start])
        pieces.append(np.frombuffer(allele.bases, np.uint8))
        cursor = vc.start + len(vc.reference)
    pieces.append(ref[cursor:])
    return np.concatenate(pieces) if pieces else ref.copy()


def _write_fasta(path: str, contigs: dict, line_width: int = 60):
    with open(path, "w") as out:
        for name, seq in contigs.items():
            out.write(f">{name}\n")
            s = seq.tobytes().decode()
            for i in range(0, len(s), line_width):
                out.write(s[i:i + line_width] + "\n")


def generate_consensus(reference: str, vcf_path: str, output_dir: str,
                       contigs: list = None, genome_name: str = None) -> list:
    """Write one consensus FASTA per sample; returns the paths.

    `contigs` restricts to a genome's contig subset (multi-genome FASTA);
    variant tids index the VCF's own contig list."""
    os.makedirs(output_dir, exist_ok=True)
    fasta = FastaReader(reference)
    contexts, vcf_contigs, samples = read_vcf(vcf_path)
    if not samples:
        samples = ["sample0"]
    names = contigs if contigs is not None else (vcf_contigs or fasta.names)
    genome = genome_name or os.path.splitext(os.path.basename(reference))[0]
    by_contig = {}
    for vc in contexts:
        cname = vcf_contigs[vc.tid] if vc.tid < len(vcf_contigs) else None
        by_contig.setdefault(cname, []).append(vc)
    ref_by_name = {name: fasta.fetch(name) for name in names}
    paths = []
    for s_idx, sample in enumerate(samples):
        out_contigs = {}
        for name in names:
            out_contigs[name] = apply_consensus_to_contig(
                ref_by_name[name], by_contig.get(name, []), s_idx)
        path = os.path.join(output_dir, f"consensus_{sample}_{genome}.fna")
        _write_fasta(path, out_contigs)
        paths.append(path)
    return paths
