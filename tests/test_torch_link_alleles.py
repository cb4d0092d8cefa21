"""Two departures of the port's strain layer from the JAX package, each
against a plain statement of its rule.

- ``link_alleles.link_bases``: the bases a read shows from an indel's
  first base when it carries the alt.  On seeded random sequences, repeats
  among them, a read of the alt haplotype shows them and a read of the
  reference haplotype does not, and they are the shortest run from the
  site (at least the alt allele) of which that holds.  ``linkage_contexts``
  puts them in the place of each indel's alt and leaves SNPs alone.
- ``cluster_variants``' separations: centroid distance over the mean
  distance of a member from its centroid divided by the square root of
  the samples (the JAX package leaves out that root), on seeded depth
  profiles over 6 and 12 samples.
"""
import numpy as np
import pytest

from lorikeet_tpu_torch.io.fasta import FastaReader
from lorikeet_tpu_torch.models.variants import Allele, Genotype, VariantContext
from lorikeet_tpu_torch.strain import link_alleles
from lorikeet_tpu_torch.strain.genotype_mode import (cluster_variants,
                                                     depth_matrix)

BASES = np.frombuffer(b"ACGT", np.uint8)


def _sequence(rng, length=400):
    """Random bases with a homopolymer and a dinucleotide repeat in it."""
    seq = bytearray(BASES[rng.integers(0, 4, length)].tobytes())
    seq[100:112] = b"A" * 12
    seq[200:216] = b"AC" * 8
    return bytes(seq)


def _indel(rng, seq):
    """(position, ref allele, alt allele, alt haplotype) of a random
    deletion or insertion, at a random site or in a repeat."""
    p = int(rng.choice([int(rng.integers(20, 300)), 100, 101, 200, 203]))
    n = int(rng.integers(1, 7))
    if rng.random() < 0.5:
        ref, alt = seq[p:p + 1 + n], seq[p:p + 1]
        return p, ref, alt, seq[:p + 1] + seq[p + 1 + n:]
    if rng.random() < 0.5:
        ins = seq[p + 1:p + 1 + n]                 # a copy: a repeat
    else:
        ins = BASES[rng.integers(0, 4, n)].tobytes()
    return p, seq[p:p + 1], seq[p:p + 1] + ins, seq[:p + 1] + ins + seq[p + 1:]


@pytest.mark.parametrize("seed", range(6))
def test_link_bases_tell_the_alt_read_from_the_reference_read(seed):
    rng = np.random.default_rng([20261022, seed])
    seq = _sequence(rng)
    told = 0
    for _ in range(200):
        p, ref, alt, hap = _indel(rng, seq)
        if hap[p:] == seq[p:p + len(hap) - p]:
            continue                   # the indel does not change the sequence
        after = seq[p + len(ref):p + len(ref) + link_alleles.LINK_WINDOW]
        link = link_alleles.link_bases(ref, alt, after)
        assert link.startswith(alt)
        assert hap[p:p + len(link)] == link
        if hap[p:p + len(link)] != seq[p:p + len(link)]:
            told += 1
            # the shortest such run: one base less would not tell them
            if len(link) > len(alt):
                assert hap[p:p + len(link) - 1] == seq[p:p + len(link) - 1]
        else:
            # only a repeat longer than the window leaves them alike
            assert len(link) == len(alt) + len(after)
    assert told > 150
    # an SNP's bases are its alt base
    assert link_alleles.link_bases(b"A", b"T", b"GGG") == b"T"


def test_linkage_contexts_replace_only_indel_alts(tmp_path):
    rng = np.random.default_rng(20261023)
    seq = _sequence(rng)
    fasta = tmp_path / "g.fna"
    fasta.write_text(">c0\n" + seq.decode() + "\n")
    reader = FastaReader(str(fasta))
    snp = VariantContext(0, 50, 50, [Allele(seq[50:51], True),
                                     Allele(b"T" if seq[50:51] != b"T"
                                            else b"G")])
    deletion = VariantContext(0, 200, 202, [Allele(seq[200:203], True),
                                            Allele(seq[200:201])])
    insertion = VariantContext(0, 100, 100, [Allele(seq[100:101], True),
                                             Allele(b"AA")])
    out = link_alleles.linkage_contexts(
        {0: [snp, deletion], 1: [insertion]}, reader, ["c0"])
    assert out[0][0] is snp
    for given, got in ((deletion, out[0][1]), (insertion, out[1][0])):
        ref, alt = given.reference.bases, given.alternate_alleles[0].bases
        after = seq[given.end + 1:given.end + 1 + link_alleles.LINK_WINDOW]
        assert got.alternate_alleles[0].bases == link_alleles.link_bases(
            ref, alt, after)
        assert got.reference == given.reference
        assert (got.tid, got.start, got.end) == (given.tid, given.start,
                                                 given.end)
        assert got.genotypes is given.genotypes
        assert given.alternate_alleles[0].bases == alt
    # the deletion of "AC" in the repeat reads on past it; the insertion
    # of "A" into the homopolymer of 12 reads 13 A's, where the reference
    # shows the base after the homopolymer
    assert seq[112:113] != b"A"
    assert len(out[0][1].alternate_alleles[0].bases) > 1
    assert out[1][0].alternate_alleles[0].bases == b"A" * 13


def _contexts(rng, n_samples, per_profile=30, depth=15):
    """Biallelic contexts drawn from three depth profiles."""
    profiles = rng.dirichlet(np.ones(3), n_samples).T
    out = []
    for k in range(3):
        for v in range(per_profile):
            gts = []
            for s in range(n_samples):
                d = int(rng.poisson(depth)) + 1
                a = int(rng.binomial(d, profiles[k][s]))
                gts.append(Genotype(s, 2, None, dp=d,
                                    ad=np.array([d - a, a])))
            out.append(VariantContext(0, 1000 * k + v, 1000 * k + v,
                                      [Allele(b"A", True),
                                       Allele(b"T")], gts))
    return out


def _plain_separations(X, labels):
    groups = sorted(set(labels.tolist()) - {-1})
    n = (max(groups) + 1) if groups else 0
    sep = np.full((n, n), np.inf)
    np.fill_diagonal(sep, 0.0)
    centroid = {g: X[labels == g].mean(axis=0) for g in groups}
    spread = np.mean([np.linalg.norm(X[labels == g] - centroid[g],
                                     axis=1).mean() for g in groups])
    per_sample = spread / np.sqrt(X.shape[1])
    for i in groups:
        for j in groups:
            if i != j:
                sep[i, j] = np.linalg.norm(centroid[i] - centroid[j]) \
                    / per_sample
    return sep


@pytest.mark.parametrize("n_samples", [6, 12])
def test_separations_are_in_spreads_a_sample(n_samples):
    rng = np.random.default_rng([20261024, n_samples])
    contexts = _contexts(rng, n_samples)
    labels, sep = cluster_variants(contexts)
    assert len(set(labels.tolist()) - {-1}) >= 2
    want = _plain_separations(depth_matrix(contexts), labels)
    assert sep.shape == want.shape
    assert np.allclose(sep, want, rtol=1e-12, atol=0.0)
