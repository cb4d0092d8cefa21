"""Per-gene dN/dS from called variants + GFF gene models.

Contract: reference/src/evolve/codon_structs.rs
- NCBI translation table 11 (:50-66), per-codon expected N sites
  (1/3 per nonsynonymous single-base change, :119-141);
- find_mutations (:150-517): walk qualifying SNPs within each gene,
  accumulate per-sample mutated codons (multi-allele permutation-averaged
  N/S classification), frameshift counts from length-changing alleles,
  Jukes-Cantor corrected dN/dS with the 0.75 singularity nudge;
- driven by a GFF3 file; when none is supplied, check_for_gff reuses a
  cached *.gff in the output dir or spawns prodigal
  (lorikeet_engine.rs:1307-1358).
"""
from __future__ import annotations

import functools
import itertools
import os
from dataclasses import dataclass

import numpy as np

from lorikeet_tpu_torch.strain.ani import site_passes

_NCBI_TABLE_11 = {
    "aas":   "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    "base1": "TTTTTTTTTTTTTTTTCCCCCCCCCCCCCCCCAAAAAAAAAAAAAAAAGGGGGGGGGGGGGGGG",
    "base2": "TTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGG",
    "base3": "TCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAG",
}
_COMPLEMENT = bytes.maketrans(b"ACGTN", b"TGCAN")


@functools.lru_cache(maxsize=None)
def codon_table():
    """(aminos: codon->aa, ns_sites: codon->expected N sites)."""
    aminos = {}
    for aa, b1, b2, b3 in zip(_NCBI_TABLE_11["aas"], _NCBI_TABLE_11["base1"],
                              _NCBI_TABLE_11["base2"], _NCBI_TABLE_11["base3"]):
        aminos[(b1 + b2 + b3).encode()] = aa
    ns_sites = {}
    for codon in aminos:
        n = 0.0
        for pos in range(3):
            for nuc in b"ATCG":
                if codon[pos] == nuc:
                    continue
                shifted = codon[:pos] + bytes([nuc]) + codon[pos + 1:]
                if aminos[codon] != aminos[shifted]:
                    n += 1.0 / 3.0
        ns_sites[codon] = n
    return aminos, ns_sites


@dataclass
class GffGene:
    seqname: str
    start: int     # 1-based inclusive (GFF)
    end: int       # 1-based inclusive
    strand: str
    frame: int
    gene_id: str


def read_gff(path: str):
    genes = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 8 or f[2] not in ("CDS", "gene"):
                continue
            try:
                frame = int(f[7])
            except ValueError:
                frame = 0
            gene_id = f[8].split(";")[0].split("=")[-1] if len(f) > 8 else f"{f[0]}_{f[3]}"
            genes.append(GffGene(f[0], int(f[3]), int(f[4]), f[6], frame, gene_id))
    return genes


def get_codons(sequence: np.ndarray, frame: int, strand: str):
    seq = sequence.tobytes()
    if strand == "-":
        seq = seq.translate(_COMPLEMENT)[::-1]
    seq = seq[frame:]
    return [seq[i:i + 3] for i in range(0, len(seq), 3)]


def find_mutations(gene: GffGene, contexts, ref_seq: np.ndarray,
                   n_samples: int, depth_per_sample_filter: int = 5):
    """(snps, frameshifts, dnds) per sample for one gene
    (codon_structs.rs:150-517)."""
    aminos, ns_sites = codon_table()
    start = gene.start - 1
    end = gene.end - 1
    gene_seq = ref_seq[start:end + 1]
    codons = get_codons(gene_seq, gene.frame, gene.strand)

    big_n = 0.0
    big_s = 0.0
    for codon in codons:
        if len(codon) != 3 or b"N" in codon or codon not in ns_sites:
            continue
        big_n += ns_sites[codon]
        big_s += 3.0 - ns_sites[codon]

    big_nd = np.zeros(n_samples)
    big_sd = np.zeros(n_samples)
    snps = np.zeros(n_samples, np.int64)
    frameshifts = np.zeros(n_samples, np.int64)
    new_codons = [[] for _ in range(n_samples)]
    old_codon_idx = [None] * n_samples
    pending_codon = [None] * n_samples

    def flush(sample_idx, ref_codon):
        for new_codon in new_codons[sample_idx]:
            if len(ref_codon) != 3 or len(new_codon) != 3 or ref_codon == new_codon:
                continue
            diffs = [p for p in range(3) if ref_codon[p] != new_codon[p]]
            perms = list(itertools.permutations(diffs))
            ns = ss = 0
            for perm in perms:
                shifting = bytearray(ref_codon)
                for pos in perm:
                    old = bytes(shifting)
                    shifting[pos] = new_codon[pos]
                    if aminos.get(old) != aminos.get(bytes(shifting)):
                        ns += 1
                    else:
                        ss += 1
            big_nd[sample_idx] += ns / len(perms)
            big_sd[sample_idx] += ss / len(perms)
        new_codons[sample_idx] = []

    in_gene = [vc for vc in contexts if start <= vc.start <= end]
    for vc in sorted(in_gene, key=lambda v: v.start):
        if not site_passes(vc):
            continue
        gene_cursor = vc.start - start
        codon_idx = gene_cursor // 3
        codon_cursor = gene_cursor % 3
        if codon_idx >= len(codons):
            continue
        codon = codons[codon_idx]
        if len(codon) != 3 or b"N" in codon:
            continue
        for s_idx, g in enumerate(vc.genotypes[:n_samples]):
            ad = np.asarray(g.ad) if g.ad is not None else np.zeros(vc.n_alleles)
            present = ad >= depth_per_sample_filter
            if not present[1:].any():
                continue
            if old_codon_idx[s_idx] is not None and old_codon_idx[s_idx] != codon_idx:
                flush(s_idx, pending_codon[s_idx])
            old_codon_idx[s_idx] = codon_idx
            pending_codon[s_idx] = codon
            snp_count = 0
            ref_allele = vc.reference
            for a_idx, allele in enumerate(vc.alternate_alleles, start=1):
                if not new_codons[s_idx]:
                    new_codons[s_idx] = [bytearray(codon)]
                if len(allele) > 1 or len(allele) != len(ref_allele):
                    if a_idx < len(present) and present[a_idx]:
                        frameshifts[s_idx] += 1
                    continue
                if a_idx < len(present) and present[a_idx]:
                    snps[s_idx] += 1
                    if snp_count >= 1:
                        nc = bytearray(codon)
                        nc[codon_cursor] = allele.bases[0]
                        new_codons[s_idx].append(nc)
                    else:
                        for nc in new_codons[s_idx]:
                            nc[codon_cursor] = allele.bases[0]
                    snp_count += 1
    for s_idx in range(n_samples):
        if pending_codon[s_idx] is not None:
            flush(s_idx, pending_codon[s_idx])

    dnds = np.ones(n_samples)
    for s_idx in range(n_samples):
        pn = big_nd[s_idx] / big_n if big_n > 0 else 0.0
        ps = big_sd[s_idx] / big_s if big_s > 0 else 0.0
        if pn == 0.75:
            pn = 0.7499
        if ps == 0.75:
            ps = 0.7499
        with np.errstate(invalid="ignore", divide="ignore"):
            d_n = -(3.0 / 4.0) * np.log(1.0 - (4.0 * pn) / 3.0)
            d_s = -(3.0 / 4.0) * np.log(1.0 - (4.0 * ps) / 3.0)
            val = d_n / d_s
        if np.isnan(val) or d_s <= np.finfo(float).eps:
            val = 1.0
        elif val < 0:
            val = 0.0
        dnds[s_idx] = val
    return snps, frameshifts, dnds


def check_for_gff(reference: str, output_dir: str,
                  prodigal_params: str = "") -> str | None:
    """Locate or create the gene-model GFF for a genome
    (lorikeet_engine.rs:1307-1358): reuse a single cached ``*.gff`` in the
    output dir, otherwise run prodigal (with --prodigal-params appended)
    writing ``genes.gff``.  Returns the GFF path, or None when no cache
    exists and prodigal is unavailable."""
    import glob as _glob
    import subprocess
    from lorikeet_tpu_torch.io.mapping import check_for_external_command
    cached = sorted(_glob.glob(os.path.join(output_dir, "*.gff")))
    if len(cached) == 1:
        return cached[0]
    if len(cached) > 1:
        return None
    if not check_for_external_command("prodigal"):
        return None
    gff_path = os.path.join(output_dir, "genes.gff")
    cmd = ["prodigal", "-o", gff_path, "-i", reference, "-f", "gff"]
    if prodigal_params:
        cmd += prodigal_params.split()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"prodigal failed: {res.stderr[-2000:]}")
    return gff_path


def calculate_dnds(reference: str, vcf_path: str, gff_path: str,
                   output_dir: str) -> str:
    """Write {genome}_dnds.tsv (lorikeet_engine.rs:1360-1479 output role)."""
    from lorikeet_tpu_torch.io.fasta import FastaReader
    from lorikeet_tpu_torch.io.vcf import read_vcf
    os.makedirs(output_dir, exist_ok=True)
    fasta = FastaReader(reference)
    contexts, contigs, samples = read_vcf(vcf_path)
    if not samples:
        samples = ["sample0"]
    genes = read_gff(gff_path)
    genome = os.path.splitext(os.path.basename(reference))[0]
    path = os.path.join(output_dir, f"{genome}_dnds.tsv")
    # key by contig NAME: vc.tid indexes the VCF's own contig list, which is
    # a genome-local subset of the FASTA under multi-genome references
    tid_names = contigs or fasta.names
    by_contig = {}
    for vc in contexts:
        if vc.tid < len(tid_names):
            by_contig.setdefault(tid_names[vc.tid], []).append(vc)
    with open(path, "w") as out:
        cols = ["gene_id", "contig", "start", "end", "strand"]
        for s in samples:
            cols += [f"{s}_snps", f"{s}_frameshifts", f"{s}_dnds"]
        out.write("\t".join(cols) + "\n")
        for gene in genes:
            # contig match: exact name or suffix after the genome~ prefix
            cname = None
            for name in fasta.names:
                if name == gene.seqname or name.endswith("~" + gene.seqname):
                    cname = name
                    break
            if cname is None:
                continue
            ref_seq = fasta.fetch(cname)
            snps, fs, dnds = find_mutations(
                gene, by_contig.get(cname, []), ref_seq, len(samples))
            row = [gene.gene_id, gene.seqname, str(gene.start), str(gene.end),
                   gene.strand]
            for s_idx in range(len(samples)):
                row += [str(int(snps[s_idx])), str(int(fs[s_idx])),
                        f"{dnds[s_idx]:.4f}"]
            out.write("\t".join(row) + "\n")
    return path
