"""The alleles the read linkage of ``genotype`` matches reads against.

strain/linkage.py (a copy of the JAX package's, linkage_engine.rs
get_reads_for_groups) counts a read as carrying a split context's alt
when the read's bases at the site equal the alt allele's.  A deletion's
alt is its anchor base alone, which every read over the site shows, the
reference's reads and other strains' among them; an insertion into a
repeat is what the reference reads show too.  So before linkage each
indel's alt is extended along the alt haplotype to the first base that
tells it from the reference haplotype.  (The JAX package links with the
bare alt: its deletion groups take in the reads of every strain, and
groups of strains that share no read link.)
"""
from __future__ import annotations

from dataclasses import replace

from lorikeet_tpu_torch.models.variants import Allele

#: reference bases read past an indel to find where its haplotype leaves
#: the reference's
LINK_WINDOW = 64


def link_bases(ref: bytes, alt: bytes, after: bytes) -> bytes:
    """The bases a read shows from an indel's first base on when it carries
    the alt: the alt allele and, past it, the alt haplotype (``after``, the
    reference bases after the ref allele) on to the first base that tells
    it from the reference haplotype (an SNP's: the alt base)."""
    hap_alt, hap_ref = alt + after, ref + after
    first = next((i for i, (a, b) in enumerate(zip(hap_alt, hap_ref))
                  if a != b), len(hap_alt) - 1)
    return hap_alt[:max(len(alt), first + 1)]


def linkage_contexts(grouped: dict, fasta, contig_names: list) -> dict:
    """``grouped`` with each indel's alt allele replaced by its
    ``link_bases``, for the read linkage (strain/linkage.py matches a
    read's bases at the site against the alt allele's); ``fasta`` a
    FastaReader of the reference, ``contig_names`` the contigs ``vc.tid``
    indexes."""
    out = {}
    for g, vcs in grouped.items():
        out[g] = []
        for vc in vcs:
            ref, alt = vc.reference.bases, vc.alternate_alleles[0].bases
            if len(ref) != len(alt) and vc.tid < len(contig_names):
                after = fasta.fetch(contig_names[vc.tid], vc.end + 1,
                                    vc.end + 1 + LINK_WINDOW).tobytes()
                vc = replace(vc, alleles=[vc.reference, Allele(
                    link_bases(ref, alt, after))])
            out[g].append(vc)
    return out
