"""The generator: its BAMs read back through the program's readers (whole
file and indexed), its reads lie where their CIGARs say, and its variants
and strain shares are the mix's."""
import json
import os

import numpy as np
import pytest

from portbench.gen import dataset, genome
from portbench.lib import cells


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(cells.HERE, kind, f"{name}.json")) as fh:
        return json.load(fh)


def _config(name, **changes):
    config = _load("configs", name)
    config.update(changes)
    return config


#: a long-read BAM a sample beside the short (the generator's long reads;
#: no cell of the benchmark has them yet)
LONG = {"length": [2000, 3000], "coverage": 10, "substitution_rate": 0.02,
        "base_qual": 22, "mapq": 60}


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen")
    config = _config("mag_short_pe150_2s30x", contigs=3, contig_kbp=10,
                     long_reads=LONG)
    return dataset.build(str(root), config, _load("traffic", "strains_1pct"),
                         2 ** 33 + 5, 0, warmup=str(root / "warm"))


def _records(path):
    from lorikeet_tpu_torch.io.bam import BamReader
    reader = BamReader(path)
    return {tid: list(reader.fetch(tid)) for tid in range(reader.n_references)}


def test_bams_read_back(hybrid):
    from lorikeet_tpu_torch.io.bam import StreamingBamReader
    data, warm = hybrid
    for path in [*data.bams, *data.long_bams]:
        by_tid = _records(path)
        indexed = StreamingBamReader(path)
        for tid, (contig, seq) in enumerate(data.contigs.items()):
            recs = by_tid[tid]
            assert recs and all(r.tid == tid for r in recs)
            assert [r.pos for r in recs] == sorted(r.pos for r in recs)
            for r in recs:
                assert sum(n for op, n in r.cigar if op in "MIS") \
                    == len(r.seq) == len(r.qual)
                assert r.mapq == 60
            # the index finds every record that overlaps a window
            lo, hi = len(seq) // 3, len(seq) // 3 + 500
            want = {(r.name, r.flag) for r in recs
                    if r.pos < hi and r.reference_end > lo}
            got = {(r.name, r.flag) for r in indexed.fetch(tid, lo, hi)}
            assert want == got
    assert len(warm.bams) == len(data.bams)
    assert sum(len(v) for v in _records(warm.bams[0]).values()) > 0


def test_reads_match_their_strain(hybrid):
    """Reads of the reference strain match the reference at every M base
    but for the substitution rate."""
    data, _ = hybrid
    by_tid = _records(data.bams[0])
    seq = data.contigs[next(iter(data.contigs))]
    same = total = 0
    for r in by_tid[0]:
        if r.cigar != [("M", len(r.seq))]:
            continue
        ref = seq[r.pos:r.pos + len(r.seq)]
        same += int((np.asarray(r.seq) == ref).sum())
        total += len(r.seq)
    # strain reads differ at their SNPs (about 1 a 100 bp) besides errors
    assert 0.985 < same / total < 0.9999


def test_variants_follow_the_mix(hybrid):
    data, _ = hybrid
    mix = _load("traffic", "strains_1pct")
    spec = mix["strains"][0]
    by_contig = {}
    for contig, pos, ref, alt, strain in data.truth:
        assert strain == 1
        by_contig.setdefault(contig, []).append((pos, ref, alt))
        assert data.contigs[contig][pos:pos + len(ref)].tobytes() == ref
        assert ref[:1] == alt[:1] or len(ref) == len(alt) == 1
    for contig, vs in by_contig.items():
        pos = np.array([p for p, _, _ in vs])
        gaps = np.diff(pos)
        assert gaps.min() >= spec["spacing"][0]
        assert gaps.max() <= spec["spacing"][1]
        assert pos[0] >= mix["margin"][0]
        assert pos[-1] < len(data.contigs[contig]) - mix["margin"][1]
        kinds = np.zeros(3)
        for _, r, a in vs:
            kinds[0 if len(r) == len(a) else 1 if len(r) > len(a) else 2] += 1
        want = np.array([spec["snp"], spec["deletion"], spec["insertion"]])
        assert np.abs(kinds - want * len(vs)).max() <= 1


def test_same_work_every_seed():
    """A contig gets the same variants from every seed, in another order:
    the same spacings, kinds and indel lengths."""
    spec = _load("traffic", "strains_1pct")["strains"][0]
    ref = genome.random_genome(np.random.default_rng(3), 20_000)

    def shape(seed):
        vs = genome.plant_variants(dataset.rng_of(seed, 0), ref, spec,
                                   [1000, 1000])
        pos = [p for p, _, _ in vs]
        return (sorted(np.diff(pos).tolist()),
                sorted((len(r), len(a)) for _, r, a in vs))

    assert shape(1) == shape(2 ** 40 + 7)
    assert genome.plant_variants(dataset.rng_of(1, 0), ref, spec,
                                 [1000, 1000]) != genome.plant_variants(
        dataset.rng_of(2, 0), ref, spec, [1000, 1000])


def test_errors_never_agree(hybrid):
    """No two short reads of a sample carry an error on one reference
    site: every allele on two reads is a planted one."""
    data, _ = hybrid
    planted = {(c, p) for c, p, r, a, _ in data.truth}
    names = list(data.contigs)
    for path in data.bams:
        seen = {}
        for tid, recs in _records(path).items():
            ref = data.contigs[names[tid]]
            for r in recs:
                if r.cigar != [("M", len(r.seq))]:
                    continue
                seq = np.asarray(r.seq)
                for k in np.nonzero(seq != ref[r.pos:r.pos + len(seq)])[0]:
                    site = (names[tid], r.pos + int(k))
                    if any((site[0], site[1] - d) in planted
                           for d in range(0, 8)):
                        continue              # a strain's variant nearby
                    seen[site] = seen.get(site, 0) + 1
        assert seen and max(seen.values()) == 1


def test_no_error_where_thin():
    """An error falls only on a site that MIN_ERROR_DEPTH fragments of
    the sample cover, and on such a site at most once: one error is
    never the only read, or most of the reads, there."""
    from portbench.gen import reads
    depth = np.array([1, 2, reads.MIN_ERROR_DEPTH - 1,
                      reads.MIN_ERROR_DEPTH, 9, 30])
    site = np.repeat(np.arange(depth.size), 2 * depth)
    # both mates of a fragment read each site: a fragment counts once
    fragment = np.concatenate([np.repeat(np.arange(d), 2) for d in depth])
    seq = genome.BASES[np.zeros(site.size, np.int64)]
    for seed in range(20):
        out = reads._substitute(dataset.rng_of(seed), seq, 0.5, site,
                                fragment)
        errors = np.bincount(site[out != seq], minlength=depth.size)
        assert errors.max() == 1
        assert not errors[depth < reads.MIN_ERROR_DEPTH].any()
        assert errors[depth >= reads.MIN_ERROR_DEPTH].all()


@pytest.mark.parametrize("sample", [0, 1])
def test_strain_share_per_sample(hybrid, sample):
    """At each planted SNP, the share of short reads showing the alt base
    is the mix's fraction for the sample."""
    data, _ = hybrid
    want = _load("traffic", "strains_1pct")["fractions"][sample][0]
    snps = {(c, p): a[0] for c, p, r, a, _ in data.truth
            if len(r) == len(a)}
    alt = total = 0
    names = list(data.contigs)
    for tid, recs in _records(data.bams[sample]).items():
        for r in recs:
            at, q = r.pos, 0              # walk the CIGAR
            for op, n in r.cigar:
                if op == "M":
                    for k in range(n):
                        base = snps.get((names[tid], at + k))
                        if base is not None:
                            total += 1
                            alt += int(r.seq[q + k] == base)
                if op in "MD":
                    at += n
                if op in "MIS":
                    q += n
    assert total > 500
    assert abs(alt / total - want) < 0.05


def test_seeded(tmp_path):
    config = _config("mag_short_pe150_2s30x", contigs=1, contig_kbp=8)
    mix = _load("traffic", "clonal")
    a = dataset.build(str(tmp_path / "a"), config, mix, 7, 0)
    b = dataset.build(str(tmp_path / "b"), config, mix, 7, 0)
    c = dataset.build(str(tmp_path / "c"), config, mix, 8, 0)
    read = lambda p: open(p, "rb").read()  # noqa: E731
    assert read(a.bams[0]) == read(b.bams[0])
    assert read(a.bams[0]) != read(c.bams[0])
    assert a.truth == b.truth


def test_apply_variants_alignment():
    ref = genome.BASES[np.random.default_rng(1).integers(0, 4, 200)]
    vs = [(20, bytes(ref[20:21]), b"T" if ref[20] != ord("T") else b"A"),
          (60, bytes(ref[60:64]), bytes(ref[60:61])),
          (120, bytes(ref[120:121]), bytes(ref[120:121]) + b"GGA")]
    s = genome.apply_variants(ref, vs)
    assert s.seq.size == 200 - 3 + 3
    assert s.del_after[s.ref_pos == 60] == 3
    assert (s.ref_pos == -1).sum() == 3
    kept = s.ref_pos >= 0
    same = s.seq[kept] == ref[s.ref_pos[kept]]
    assert (~same).sum() == 1                   # the SNP
