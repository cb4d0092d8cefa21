"""The port's strain abundances and the benchmark's plain reference of them
(``portbench/reference/strain.py``: torch float64 and numpy, no program),
and the reference's group purity, on the CPU.

- ``abundance_em`` against the reference's EM on seeded random alt shares
  and strain memberships.  Both run the same float64 rounds, each a sum
  in its own order (numpy's pairwise reduction, torch's), so a round's θ
  differs by a few ulps; the EM contracts, and its thresholds (θ and a
  share against 1e-4, the summed |Δθ| against 1e-4) sit far from any θ
  the draws give, so no branch flips.  Tolerance 1e-12: four orders of
  magnitude over that rounding, eight under the 1e-4 the EM resolves.
- ``run_genotype`` on seeded hand-made VCFs (three depth profiles over
  twelve samples, the linkage skipped: strain = variant group): its
  ``*_strain_coverages.tsv`` against the reference's abundances on the
  annotated VCF.  The table prints six decimals, so the tolerance is the
  rounding's 5e-7 plus the 1e-12 above.
- ``purity`` on hand-built annotated VCFs: a pure one and a mixed one;
  ``count_gap`` and ``share_gap`` on hand-built annotated VCFs and strain
  tables, the gaps worked out by hand.
- ``split_contexts`` against a plain statement of its rule on seeded
  random sites (biallelic and multi-allelic, GQ 99 and 100, deep and
  shallow): which sites are split, which written whole and unannotated,
  which dropped.
"""
import math
import os

import numpy as np
import pytest
import torch

from lorikeet_tpu_torch.models.variants import Allele, Genotype, VariantContext
from lorikeet_tpu_torch.strain.genotype_mode import (abundance_em,
                                                     run_genotype,
                                                     split_contexts)
from portbench.reference import strain as ref_strain

EM_TOL = 1e-12
TABLE_TOL = 5e-7 + EM_TOL


def _memberships(rng, n_vars, n_strains):
    """Each record carried by no strain (noise), one, or two."""
    out = []
    for _ in range(n_vars):
        k = rng.choice(3, p=[0.1, 0.7, 0.2])
        out.append(sorted(rng.choice(n_strains, size=min(k, n_strains),
                                     replace=False).tolist()))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_abundance_em_matches_the_reference(seed):
    rng = np.random.default_rng([20261019, seed])
    n_vars = int(rng.integers(5, 300))
    n_strains = int(rng.integers(1, 6))
    members = _memberships(rng, n_vars, n_strains)
    if not any(members):
        members[0] = [0]
    alt = rng.random(n_vars) * (rng.random(n_vars) > 0.1)
    got = abundance_em(alt, members)
    carries = torch.zeros((len(got), n_vars), dtype=torch.bool)
    for v, m in enumerate(members):
        carries[m, v] = True
    want = ref_strain.em(torch.from_numpy(alt), carries).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= EM_TOL


def _write_fasta(path, name, length, rng):
    seq = "".join(rng.choice(list("ACGT"), length))
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, length, 60):
            fh.write(seq[i:i + 60] + "\n")
    return seq


def _write_vcf(path, contig, seq, rng, n_samples, profiles, per_profile,
               ref_free):
    """Biallelic SNPs at distinct sites, ``per_profile`` drawn from each
    row of ``profiles`` (each sample's alt share), depths 8-40; in
    ``ref_free`` of the sites every sample's reads all carry the alt."""
    sites = np.sort(rng.choice(np.arange(50, len(seq) - 50),
                               len(profiles) * per_profile, replace=False))
    which = rng.permutation(np.repeat(np.arange(len(profiles)),
                                      per_profile))
    lines = ["##fileformat=VCFv4.2", f"##contig=<ID={contig},"
             f"length={len(seq)}>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"s{k}" for k in range(n_samples))]
    for n, (pos, p) in enumerate(zip(sites.tolist(), which.tolist())):
        ref = seq[pos]
        alt = "ACGT"[("ACGT".index(ref) + 1) % 4]
        cells = []
        for s in range(n_samples):
            depth = int(rng.integers(8, 41))
            a = depth if n < ref_free else int(rng.binomial(
                depth, profiles[p][s]))
            cells.append(f"0/1:{depth - a},{a}:{depth}:99:100,0,100")
        lines.append(f"{contig}\t{pos + 1}\t.\t{ref}\t{alt}\t500.0\t.\t"
                     f"DP=300;QD=30.0\tGT:AD:DP:GQ:PL\t" + "\t".join(cells))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("seed,ref_free", [(0, 0), (1, 0), (2, 40),
                                           (3, 0)])
def test_run_genotype_abundances_match_the_reference(tmp_path, seed,
                                                     ref_free):
    rng = np.random.default_rng([20261020, seed])
    n_samples = 12
    profiles = rng.dirichlet(np.ones(3), n_samples).T      # [3, samples]
    fasta = str(tmp_path / "g.fna")
    seq = _write_fasta(fasta, "g~c1", 30_000, rng)
    vcf = str(tmp_path / "calls.vcf")
    _write_vcf(vcf, "g~c1", seq, rng, n_samples, profiles, 40, ref_free)
    out = run_genotype(fasta, vcf, str(tmp_path / "out"), genome_name="g")
    assert out["n_variant_groups"] >= 2
    got = ref_strain.read_coverages(out["strain_coverages"])
    want = ref_strain.abundances(out["vcf"])
    assert ref_strain.coverages_of(out["vcf"]) == out["strain_coverages"]
    assert sorted(got) == sorted(want)
    assert ("strain_reference" in want) == out["reference_strain_present"]
    gap = max(abs(a - b) for k in want for a, b in zip(got[k], want[k]))
    assert gap <= TABLE_TOL
    assert ref_strain.abundance_gap(out["vcf"]) == gap


CONTIG = "c1"
#: a reference of 60 bases, every base of it A, T, G or C
SEQ = "ACGTTGCAAC" * 6
#: planted (contig, 0-based pos, ref, alt, strain)
TRUTH = [(CONTIG, 4, b"T", b"A", 1), (CONTIG, 14, b"T", b"C", 1),
         (CONTIG, 24, b"T", b"G", 2), (CONTIG, 34, b"T", b"A", 2),
         (CONTIG, 44, b"T", b"C", 2), (CONTIG, 54, b"T", b"G", 1)]


def _annotated(path, groups, strains=None):
    """An annotated VCF with TRUTH's alleles, the record of each in the
    group ``groups`` gives it, and one unplanted allele in group 0; with
    ``strains``, each grouped record's ``ST`` (the unplanted one's last)."""
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts0"]
    records = [(p, r.decode(), a.decode()) for _, p, r, a, _ in TRUTH]
    records.append((9, "C", "G"))
    for n, ((pos, r, a), g) in enumerate(zip(records, [*groups, 0])):
        st = "" if strains is None or g == -1 else f";ST={strains[n]}"
        lines.append(f"{CONTIG}\t{pos + 1}\t.\t{r}\t{a}\t99\t.\tQD=30;VG={g}"
                     f"{st}\tGT:AD\t0/1:5,5")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


def test_purity_of_pure_and_mixed_groups(tmp_path):
    contigs = {CONTIG: np.frombuffer(SEQ.encode(), np.uint8)}
    assert SEQ[4] == SEQ[14] == "T"
    pure = _annotated(tmp_path / "pure.vcf", [0, 0, 1, 1, -1, 0])
    assert ref_strain.purity(pure, contigs, TRUTH) == (0, 5)
    # group 0 holds strains 1, 1, 2 (majority 1, one off), group 1
    # strains 2, 2, 1 (majority 2, one off); the unplanted allele counts
    # for neither
    mixed = _annotated(tmp_path / "mixed.vcf", [0, 0, 1, 0, 1, 1])
    assert ref_strain.purity(mixed, contigs, TRUTH) == (2, 6)
    # an allele two strains plant counts for both in its group's vote
    twice = TRUTH + [(CONTIG, 24, b"T", b"G", 1)]
    assert ref_strain.purity(pure, contigs, twice) == (0, 5)


def test_abundance_gap_without_a_table_is_inf(tmp_path):
    vcf = _annotated(tmp_path / "g.vcf", [0, 0, 1, 1, -1, 0])
    assert math.isinf(ref_strain.abundance_gap(vcf))
    assert not os.path.exists(ref_strain.coverages_of(vcf))


#: two samples' shares of the planted strains 1 and 2
FRACTIONS = [[0.25, 0.75], [0.6, 0.4]]


def _table(vcf, rows):
    """The strain table beside ``vcf``: (row name, two abundances)."""
    with open(ref_strain.coverages_of(vcf), "w") as fh:
        fh.write("strainID\ts0\ts1\n")
        for name, values in rows:
            fh.write(name + "\t" + "\t".join(f"{v:.6f}" for v in values)
                     + "\n")


#: (ST of each grouped record, the table's rows, count gap, share gap).
#: Strain 0 carries the planted strain 1's three alleles and the
#: unplanted one, strain 1 the strain 2's two grouped ones.
GAPS = {
    "exact": ([0, 0, 1, 1, None, 0, 0],
              [("strain_0", [0.25, 0.6]), ("strain_1", [0.75, 0.4])],
              0, 0.0),
    "off_by_a_tenth": ([0, 0, 1, 1, None, 0, 0],
                       [("strain_0", [0.35, 0.5]),
                        ("strain_1", [0.65, 0.5])], 0, 0.1),
    # every group linked into one strain: it stands for strain 1 (three
    # alleles against two), strain 2 is found in none
    "merged": ([0, 0, 0, 0, None, 0, 0], [("strain_0", [1.0, 1.0])],
               1, 0.75),
    # the reference strain, planted in no sample, is held against 0
    "reference": ([0, 0, 1, 1, None, 0, 0],
                  [("strain_0", [0.25, 0.55]), ("strain_1", [0.7, 0.4]),
                   ("strain_reference", [0.05, 0.05])], 0, 0.05),
    # a strain no record names stands for no planted strain
    "stray": ([0, 0, 1, 1, None, 0, 0],
              [("strain_0", [0.25, 0.6]), ("strain_1", [0.73, 0.4]),
               ("strain_2", [0.02, 0.0])], 1, 0.02),
    # a record carried by both strains votes for each
    "shared": ([0, 0, 1, "0,1", None, 0, 0],
               [("strain_0", [0.25, 0.6]), ("strain_1", [0.75, 0.4])],
               0, 0.0),
}


@pytest.mark.parametrize("case", sorted(GAPS))
def test_strain_count_and_share_gaps(tmp_path, case):
    strains, rows, count, share = GAPS[case]
    contigs = {CONTIG: np.frombuffer(SEQ.encode(), np.uint8)}
    vcf = _annotated(tmp_path / "g.vcf", [0, 0, 1, 1, -1, 0], strains)
    assert math.isinf(ref_strain.count_gap(vcf, FRACTIONS))
    assert math.isinf(ref_strain.share_gap(vcf, contigs, TRUTH, FRACTIONS))
    _table(vcf, rows)
    assert ref_strain.count_gap(vcf, FRACTIONS) == count
    got = ref_strain.share_gap(vcf, contigs, TRUTH, FRACTIONS)
    assert abs(got - share) <= 1e-9


def _site(rng, start, n_alts, n_samples=4):
    """A site at QD 30 or 2 with ``n_alts`` alts, each sample's GQ 99 or
    100 and AD 0-3 or 0-12 an allele (the site's depth drawn first)."""
    bases = [b"A", b"C", b"G", b"T"]
    alleles = [Allele(b"A", True)] + [Allele(b, False)
                                      for b in bases[1:1 + n_alts]]
    n_gl = (n_alts + 1) * (n_alts + 2) // 2
    top = int(rng.choice([4, 13]))
    genotypes = [Genotype(s, 2, np.zeros(n_gl), gq=int(rng.choice([99, 100])),
                          dp=20, ad=rng.integers(0, top, n_alts + 1))
                 for s in range(n_samples)]
    vc = VariantContext(0, start, start, alleles, genotypes)
    vc.attributes["QD"] = float(rng.choice([30.0, 30.0, 30.0, 2.0]))
    return vc


def _plain_split(vc, qd_filter, min_depth):
    """Where split_contexts' rule puts a site: 'filtered' (below the QD
    filter, or multi-allelic with no alt that the samples at GQ 100 or
    more carry at ``min_depth`` reads), 'dropped' (biallelic under
    ``min_depth`` alt reads), else 'split', with the alts kept."""
    if vc.attributes["QD"] < qd_filter:
        return "filtered", []
    alts = vc.alternate_alleles
    if len(alts) == 1:
        deep = sum(int(g.ad[1]) for g in vc.genotypes) >= min_depth
        return ("split", alts) if deep else ("dropped", [])
    kept = [a for i, a in enumerate(alts, start=1)
            if sum(int(g.ad[i]) for g in vc.genotypes if g.gq >= 100)
            >= min_depth]
    return ("split", kept) if kept else ("filtered", [])


@pytest.mark.parametrize("seed", range(4))
def test_split_contexts_follows_its_rule(seed):
    rng = np.random.default_rng([20261021, seed])
    sites = [_site(rng, 100 + 10 * n, int(rng.choice([1, 2, 3])))
             for n in range(60)]
    split, filtered = split_contexts(sites, 25.0, min_variant_depth=10)
    want_split, want_filtered, kinds = [], [], set()
    for vc in sites:
        kind, alts = _plain_split(vc, 25.0, 10)
        kinds.add((kind, len(vc.alternate_alleles) > 1))
        want_split += [(vc.start, a) for a in alts]
        if kind == "filtered":
            want_filtered.append(id(vc))
    # every kind of site is drawn, the GQ-99 multi-allelic one among them
    assert ("filtered", True) in kinds and ("dropped", False) in kinds
    assert ("split", True) in kinds and ("split", False) in kinds
    assert [id(vc) for vc in filtered] == want_filtered
    got_split = [(vc.start, vc.alternate_alleles[0]) for vc in split]
    assert got_split == want_split
    assert all(len(vc.alternate_alleles) == 1 for vc in split)
