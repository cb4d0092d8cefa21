"""The goldens of tests/goldens/ through the port's `start_engine`.

The fixtures of tests/test_golden_vcf.py, test_golden_genotype.py and
test_golden_consensus.py, rebuilt with the port's own simulator and BAM
writer from the same seeds, run through lorikeet_tpu_torch's `call`,
`genotype` and `consensus` on the exact f64 host pair-HMM, at -t 1 and at
-t 2 (the span-worker pool, its size gate opened).  Every output file must
equal its golden byte for byte.  The goldens are only read here.
"""
import os

import numpy as np
import pytest

from lorikeet_tpu_torch import processing as tproc
from lorikeet_tpu_torch.calling.engine import CallerConfig
from lorikeet_tpu_torch.io.bam_writer import write_bam
from lorikeet_tpu_torch.parallel import pool as pool_mod
from lorikeet_tpu_torch.testkit.simulate import Variant, simulate_reads

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
BASES = np.frombuffer(b"ACGT", np.uint8)
THREADS = [pytest.param(1, id="t1"), pytest.param(2, id="t2")]


@pytest.fixture(autouse=True, scope="module")
def _pools_closed():
    yield
    pool_mod.shutdown_pool()


def _check_golden(path, name):
    with open(path, "rb") as fh:
        got = fh.read()
    with open(os.path.join(GOLDEN_DIR, name), "rb") as fh:
        want = fh.read()
    if got != want:
        got_l, want_l = got.splitlines(), want.splitlines()
        for i, (g, w) in enumerate(zip(got_l, want_l)):
            assert g == w, (f"{name} line {i + 1} differs:\n"
                            f"  got:  {g!r}\n  want: {w!r}")
        assert len(got_l) == len(want_l), \
            f"{name}: {len(got_l)} lines, golden {len(want_l)}"
        assert got == want, f"{name} differs"


def _run(mode, fasta, bams, out_dir, threads, **cfg_kw):
    """The port's start_engine on the f64 host pair-HMM; at -t above 1
    through the pool, whatever the genome's size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tproc, "_pool_worthwhile", lambda *a: True)
        pooled = []
        real = tproc._call_contigs_pooled
        mp.setattr(tproc, "_call_contigs_pooled",
                   lambda *a: pooled.append(a[-1]) or real(*a))
        out = tproc.start_engine(
            mode, [str(fasta)], [str(b) for b in bams], str(out_dir),
            CallerConfig(use_cuda=False, threads=threads, **cfg_kw))
    assert len(pooled) == (threads > 1)
    (res,) = out.values()
    assert "error" not in res, res
    return res


def _write_fasta(path, name, ref):
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        s = ref.tobytes().decode()
        for i in range(0, len(ref), 80):
            fh.write(s[i:i + 80] + "\n")


def _ref(seed, length):
    rng = np.random.default_rng(seed)
    return BASES[rng.integers(0, 4, length)]


def _snp(ref, pos):
    r = bytes(ref[pos:pos + 1])
    return Variant(pos, r, b"T" if r != b"T" else b"G")


def _bam(path, contig, length, recs):
    recs.sort(key=lambda r: (r.tid, r.pos))
    write_bam(str(path), [contig], [length], recs)
    return path


def _diploid(tmp):
    ref = _ref(101, 20_000)
    _write_fasta(tmp / "g.fna", "gold~c1", ref)
    vs = [_snp(ref, p) for p in (1200, 4400, 7800, 12000, 16500)]
    a = bytes(ref[9000:9001])
    vs.append(Variant(9000, a, a + b"ACCT"))                 # 4bp insertion
    d = bytes(ref[14000:14004])
    vs.append(Variant(14000, d, d[:1]))                      # 3bp deletion
    vs.sort(key=lambda v: v.pos)
    recs = simulate_reads(ref, vs, coverage=25, seed=7, name_prefix="s")
    return [_bam(tmp / "s0.bam", "gold~c1", len(ref), recs)], {}


def _multisample(tmp):
    ref = _ref(202, 15_000)
    _write_fasta(tmp / "g.fna", "gold~c1", ref)
    shared = [_snp(ref, p) for p in (2000, 6000, 10_500)]
    only_b = [_snp(ref, p) for p in (3500, 12_200)]
    bams = []
    for sidx, vs in enumerate([shared, shared + only_b]):
        recs = simulate_reads(ref, sorted(vs, key=lambda v: v.pos),
                              coverage=22 + 4 * sidx, seed=31 + sidx,
                              name_prefix=f"m{sidx}")
        bams.append(_bam(tmp / f"m{sidx}.bam", "gold~c1", len(ref), recs))
    return bams, {}


def _haploid(tmp):
    ref = _ref(303, 12_000)
    _write_fasta(tmp / "g.fna", "gold~c1", ref)
    vs = [_snp(ref, p) for p in (1800, 5200, 9100)]
    recs = simulate_reads(ref, vs, coverage=30, seed=13, name_prefix="h")
    return [_bam(tmp / "h0.bam", "gold~c1", len(ref), recs)], {"ploidy": 1}


CALL_GOLDENS = {"diploid_single.vcf": _diploid,
                "multisample.vcf": _multisample, "haploid.vcf": _haploid}


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("golden", sorted(CALL_GOLDENS))
def test_call_golden(golden, threads, tmp_path):
    bams, cfg_kw = CALL_GOLDENS[golden](tmp_path)
    res = _run("call", tmp_path / "g.fna", bams, tmp_path / "out", threads,
               **cfg_kw)
    _check_golden(res["vcf"], golden)


#: the genotype fixture's sample mixture over its two strains
MIX = np.array([[1.0, 0.0], [0.0, 1.0], [0.65, 0.35], [0.25, 0.75]])


@pytest.fixture(scope="module", params=THREADS)
def genotype_run(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("golden_geno")
    rng = np.random.default_rng(17)
    L = 24_000
    ref = BASES[rng.integers(0, 4, L)]
    _write_fasta(tmp / "g.fna", "ggold~c1", ref)

    def mkstrain(seed, n=10):
        r = np.random.default_rng(seed)
        pos = np.sort(r.choice(np.arange(500, L - 500), n, replace=False))
        return [_snp(ref, int(p)) for p in pos]

    strains = [mkstrain(41), mkstrain(42)]
    bams = []
    for sidx, fracs in enumerate(MIX):
        recs = []
        for k, (st, fr) in enumerate(zip(strains, fracs)):
            if fr <= 0:
                continue
            recs += simulate_reads(ref, st, coverage=30 * fr,
                                   seed=500 * sidx + k,
                                   name_prefix=f"g{sidx}_{k}_")
        bams.append(_bam(tmp / f"s{sidx}.bam", "ggold~c1", L, recs))
    return _run("genotype", tmp / "g.fna", bams, tmp / "out", request.param,
                qual_by_depth_filter=8.0)


GENOTYPE_GOLDENS = {
    "genotype_mode.vcf": lambda out: out["vcf"],
    "genotype_strain_coverages.tsv": lambda out: out["strain_coverages"],
    **{f"genotype_{tag}_ani.tsv": (lambda out, tag=tag: out["ani"][
        f"{tag}_ani"]) for tag in ("consensus", "population",
                                   "subpopulation")}}


@pytest.mark.parametrize("golden", sorted(GENOTYPE_GOLDENS))
def test_genotype_golden(genotype_run, golden):
    _check_golden(GENOTYPE_GOLDENS[golden](genotype_run), golden)


@pytest.fixture(scope="module", params=THREADS)
def consensus_run(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("golden_cons")
    rng = np.random.default_rng(23)
    L = 15_000
    ref = BASES[rng.integers(0, 4, L)]
    _write_fasta(tmp / "g.fna", "cgold~c1", ref)
    shared = [_snp(ref, p) for p in (2500, 7000)]
    only_b = [_snp(ref, p) for p in (4200, 11_000)]
    ins = Variant(9000, bytes(ref[9000:9001]),
                  bytes(ref[9000:9001]) + b"GG")
    dele = Variant(12_500, bytes(ref[12_500:12_504]),
                   bytes(ref[12_500:12_501]))
    bams = []
    for sidx, vs in enumerate([shared + [ins], shared + only_b + [dele]]):
        recs = simulate_reads(ref, sorted(vs, key=lambda v: v.pos),
                              coverage=28, seed=61 + sidx,
                              name_prefix=f"c{sidx}")
        bams.append(_bam(tmp / f"c{sidx}.bam", "cgold~c1", L, recs))
    return _run("consensus", tmp / "g.fna", bams, tmp / "out", request.param)


@pytest.mark.parametrize("sample", [0, 1])
def test_consensus_golden(consensus_run, sample):
    files = sorted(consensus_run["consensus"])
    assert len(files) == 2, files
    path = files[sample]
    _check_golden(path, "consensus_" + os.path.basename(path))
